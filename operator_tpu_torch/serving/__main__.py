"""Serve the port's engine over the OpenAI wire format.

    ALLOW_RANDOM_WEIGHTS=true python -m operator_tpu_torch.serving \\
        [--host 0.0.0.0] [--port 8000] [--device cuda]

Model and engine shape come from the same operator config environment
the cluster deployment uses (``serving/provider.py``,
``utils/config.py``: OPERATOR_TPU_MODEL, CHECKPOINT_DIR, WEIGHT_DTYPE,
MAX_BATCH_SIZE, KV_PAGE_SIZE, SCHED_MODE, ...), plus
OPERATOR_TPU_API_TOKEN to require a bearer token,
ENCODER_CHECKPOINT_DIR for ``/v1/embeddings``, PROFILE_ENABLED /
PROFILE_DIR for ``/profile`` and SERVING_REPLICA_ID (or POD_NAME) for
the replica's identity.  The ``tpu-native`` provider answers
``/api/v1/analysis/analyze``.  Runs on the card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default=os.environ.get("OPERATOR_TPU_HOST", "0.0.0.0"))
    parser.add_argument(
        "--port", type=int, default=int(os.environ.get("OPERATOR_TPU_PORT", "8000"))
    )
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )

    from ..patterns.semantic import build_embedder
    from ..utils.config import OperatorConfig
    from .httpserver import serve_forever
    from .provider import TPUNativeProvider, build_serving_engine

    cfg = OperatorConfig.from_env()
    engine, model_id = build_serving_engine(args.device, config=cfg)
    engine.warmup()
    analysis_backend = TPUNativeProvider(
        engine, model_id=model_id, register_template_prefixes=cfg.prefix_cache,
    )
    # /v1/embeddings: MiniLM when a checkpoint is mounted, lexical hashing
    # otherwise — the one shared ladder (patterns/semantic.py)
    embedder = build_embedder(
        os.environ.get("ENCODER_CHECKPOINT_DIR", "").strip(), device=args.device,
    )
    try:
        asyncio.run(
            serve_forever(
                engine,
                model_id=model_id,
                host=args.host,
                port=args.port,
                api_token=os.environ.get("OPERATOR_TPU_API_TOKEN") or None,
                embedder=embedder,
                analysis_backend=analysis_backend,
                replica_id=(
                    os.environ.get("SERVING_REPLICA_ID")
                    or os.environ.get("POD_NAME")
                    or None
                ),
                profile_enabled=cfg.profile_enabled,
                profile_dir=cfg.profile_dir,
            )
        )
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
