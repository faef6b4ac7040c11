"""Serve the port's engine over the OpenAI wire format.

    ALLOW_RANDOM_WEIGHTS=true python -m operator_tpu_torch.serving \\
        [--host 0.0.0.0] [--port 8000] [--device cuda]

Model and engine shape come from the serving environment
(``serving/provider.py``: OPERATOR_TPU_MODEL, SERVING_DTYPE,
MAX_BATCH_SIZE, KV_PAGE_SIZE, SCHED_MODE, SCHED_CHUNK,
SCHED_PIPELINE_DEPTH, SPEC_DECODE, DECODE_BLOCK, PIPELINE_DEPTH, ...).
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import os
import threading


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

    from .httpserver import CompletionServer
    from .provider import build_serving_engine

    engine, model_id = build_serving_engine(args.device)
    engine.warmup()
    server = CompletionServer(
        engine, model_id=model_id, host=args.host, port=args.port,
        replica_id=os.environ.get("SERVING_REPLICA_ID") or os.environ.get("POD_NAME"),
    )
    server.start()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        engine.close()


if __name__ == "__main__":
    main()
