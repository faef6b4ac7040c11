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
the replica's identity.  With AOT_CACHE_PATH the kernels are built into
its ``kernels/`` directory, so a restart on the same volume runs no
``nvcc``.  The ``tpu-native`` provider answers
``/api/v1/analysis/analyze``.  Runs on the card unless ``--device cpu``
is given.  SIGTERM (the kubelet's stop) or SIGINT stops accepting, lets
the requests in flight finish within the server's drain grace, closes
the engine and exits 0.

``SERVING_MESH`` serves on a mesh of ranks.  One process (``auto`` on one
card, or ``dp=1,tp=1``) makes its own one-rank group.  Under a launcher,
every rank runs this module:

    SERVING_MESH=dp=1,tp=4 torchrun --nproc-per-node 4 \
        -m operator_tpu_torch.serving --port 8000

rank 0 serves HTTP and drives the others, which follow its calls on
their shards until it stops (``serving/meshserve.py``).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os


async def _until_signalled(serving) -> None:
    """Run ``serving`` until SIGTERM or SIGINT, then cancel it once: its
    ``finally`` stops accepting, drains the requests in flight within the
    server's grace and closes the engine, so the kubelet's SIGTERM ends
    the process with 0 after the drain, not with -15 before it."""
    import signal

    task = asyncio.ensure_future(serving)
    loop = asyncio.get_running_loop()

    def stop() -> None:
        if not task.cancelling():  # a second signal must not cut the drain short
            task.cancel()

    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop)
    try:
        await task
    except asyncio.CancelledError:
        if not task.cancelled():
            raise


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
    from ..utils.platform import enable_persistent_compilation_cache
    from .httpserver import serve_forever
    from .provider import TPUNativeProvider, build_serving_engine

    cfg = OperatorConfig.from_env()
    if cfg.aot_cache_path:
        # the kernels persist beside the AOT cache's records
        enable_persistent_compilation_cache(os.path.join(cfg.aot_cache_path, "kernels"))
    engine, model_id = build_serving_engine(args.device, config=cfg)
    from .meshserve import MeshFollower

    if isinstance(engine, MeshFollower):
        engine.run()  # a mesh rank other than 0: rank 0's calls, until it stops
        return
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
            _until_signalled(serve_forever(
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
            ))
        )
    finally:
        engine.close()  # a mesh's followers stop with rank 0


if __name__ == "__main__":
    main()
