"""Fleet KV fabric: peer-to-peer page transfer + prefill/decode roles.

The port's own copy of ``operator_tpu/fabric``.  The single-replica KV
economy and a *passive* fleet layer (replicas advertise block-hash
inventory on ``/healthz`` and the router merely prefers holders,
``dispatch(kv_hint=...)``) become an *active* fleet tier here:

- :mod:`.wire` — the one-block wire format served by the replica's
  ``GET /kv/blocks/{hash}`` endpoint (JSON header + the raw bytes of
  two host tensors, sha256 checksummed end to end; the JAX package's
  bytes for the same arrays).
- :mod:`.index` — the fabric block index: replica -> advertised block
  set, replace-on-report semantics (staleness tombstones for free) plus
  fetch-outcome feedback (a 404 from a supposed holder evicts that
  entry immediately).
- :mod:`.fetch` — the bounded-concurrency fetch client: admission-time
  prefix misses consult the index and pull pages from a holder's host
  pool instead of recomputing, under a per-fetch deadline clamped to
  the request's residual budget.  A failed fetch must never be slower
  than the recompute it replaced.
- :mod:`.disagg` — prefill/decode disaggregation: replica roles, the
  role-aware candidate ordering the router uses, and the two-leg
  prefill->decode dispatch helper built on token-level resume.
- :mod:`.peers` — the index feeder for router-less replicas: polls peer
  ``/healthz`` inventories (``KV_FABRIC_PEERS``, DNS-expanded each
  round so one headless-Service name covers the fleet) into the local
  index with the router's replace-on-report freshness.

The engine side is ``serving/engine.py`` (``fabric``, ``fabric_poller``,
``kv_block_bytes``), the knobs ``serving/provider.py``
(``KV_FABRIC*``, ``REPLICA_ROLE``).
"""

from .disagg import DECODE, MIXED, PREFILL, VALID_ROLES, disaggregated_dispatch
from .fetch import FabricFetcher
from .index import FabricIndex
from .peers import PeerPoller
from .wire import CorruptBlock, decode_block, encode_block

__all__ = [
    "CorruptBlock",
    "DECODE",
    "FabricFetcher",
    "FabricIndex",
    "MIXED",
    "PREFILL",
    "PeerPoller",
    "VALID_ROLES",
    "decode_block",
    "disaggregated_dispatch",
    "encode_block",
]
