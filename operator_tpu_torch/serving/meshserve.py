"""Sharded serving across ranks: rank 0 drives, every other rank follows.

JAX serves a mesh from ONE process: one ``BatchedGenerator`` whose jitted
programs span every device.  Torch runs one rank per process, so the
port runs one :class:`~serving.engine.Generator` per rank, each over its
shard (``parallel/mesh.py:ServingShard``), and keeps them in lockstep:

- rank 0 runs the ``ServingEngine``, its worker thread and everything
  above it (the HTTP server, the provider, the operator).  A
  :class:`MeshDriver` wraps the generator's state-changing calls
  (:data:`MIRRORED`): before rank 0 runs one, it sends the call (name and
  arguments) to the other ranks over a CPU (gloo) side group;
- every other rank runs :class:`MeshFollower.run`: it receives each call
  and makes it on its own generator, in the same order, until rank 0
  sends ``close``.

Every rank thus makes the same host decisions (buckets, pages, slots,
stops, epochs, the chunked job, the guided tables): the calls carry the
inputs after rank 0's own host-only decisions (tokenised, truncated and
deadline-clamped prompts: ``_admit_tokens`` is mirrored, not ``admit``;
the chaos seam runs in ``step`` on rank 0 before the mirrored
``_step``).  A call nested in a mirrored one (``precompile_grid`` drives
``_admit_tokens`` and ``_step``; ``reset`` re-primes the prefixes) is
not sent again: the follower's outer call makes it.

A follower that dies or stalls leaves rank 0's next collective waiting;
the process group's timeout (:data:`FOLLOWER_TIMEOUT_S` where the
provider makes the group) turns that into an error on rank 0's worker,
which goes to the supervisor's path.  A follower's own error in a call
is logged and the follower goes on: rank 0 raised the same (the same
state and inputs) or meets it as a collective error.
"""

from __future__ import annotations

import functools
import logging
import threading
from datetime import timedelta
from typing import Any, Callable

import torch.distributed as dist

log = logging.getLogger(__name__)

__all__ = ["FOLLOWER_TIMEOUT_S", "MIRRORED", "MeshDriver", "MeshFollower", "command_group"]

#: the generator calls that change state, sent to every follower
MIRRORED = (
    "_admit_tokens",
    "_step",
    "cancel",
    "reset",
    "add_shared_prefix",
    "set_shared_prefix",
    "clear_shared_prefixes",
    "precompile_grid",
)

#: seconds a collective waits for a rank before it raises: a follower
#: that died or stalls surfaces on rank 0 as an error within this
FOLLOWER_TIMEOUT_S = 120.0

#: the side group's timeout: a follower waits this long for rank 0's
#: next call (an idle server sends none)
_IDLE_TIMEOUT = timedelta(days=7)


def command_group() -> Any:
    """The CPU (gloo) group the calls travel on.  Every rank of the
    process group must call this, in the same order."""
    return dist.new_group(backend="gloo", timeout=_IDLE_TIMEOUT)


def _send(group: Any, message: tuple) -> tuple:
    box = [message]
    dist.broadcast_object_list(box, src=0, group=group, device="cpu")
    return box[0]


class MeshDriver:
    """Rank 0's side: the generator's :data:`MIRRORED` calls are sent to
    the followers before they run here (see the module doc)."""

    def __init__(self, generator: Any, group: Any) -> None:
        self.generator = generator
        self.group = group
        self.sent = 0
        self.closed = False
        self._depth = threading.local()
        self._lock = threading.Lock()
        for name in MIRRORED:
            setattr(generator, name, self._wrap(name, getattr(generator, name)))
        generator.mirror = self

    def _wrap(self, name: str, call: Callable) -> Callable:
        @functools.wraps(call)
        def mirrored(*args: Any, **kwargs: Any) -> Any:
            depth = getattr(self._depth, "value", 0)
            if depth == 0:
                self._broadcast((name, args, kwargs))
            self._depth.value = depth + 1
            try:
                return call(*args, **kwargs)
            finally:
                self._depth.value = depth

        return mirrored

    def _broadcast(self, message: tuple) -> None:
        with self._lock:
            if self.closed:
                raise RuntimeError("the serving mesh is closed")
            _send(self.group, message)
            self.sent += 1

    def close(self) -> None:
        """End every follower's loop (once)."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
            _send(self.group, ("close", (), {}))


class MeshFollower:
    """A follower rank's loop over its generator (see the module doc):
    what ``build_serving_engine`` returns on a rank other than 0."""

    def __init__(self, generator: Any, group: Any) -> None:
        self.generator = generator
        self.group = group
        #: calls received and made
        self.calls = 0

    def run(self) -> None:
        """Make rank 0's calls until it sends ``close``."""
        while True:
            name, args, kwargs = _send(self.group, None)
            if name == "close":
                log.info("serving mesh closed by rank 0 after %d calls", self.calls)
                return
            self.calls += 1
            try:
                getattr(self.generator, name)(*args, **kwargs)
            except Exception:  # noqa: BLE001 - rank 0 raised the same, or meets it
                log.warning("follower call %s failed", name, exc_info=True)
