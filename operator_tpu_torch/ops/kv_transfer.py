"""Device<->host KV page transfer for the prefix cache's host-RAM tier.

The port's counterpart of ``operator_tpu/ops/kv_transfer.py``.  Evicted
prefix blocks (``serving/kvstore.py``) spill device->host into a pool of
pinned host tensors sized by ``KV_HOST_POOL_MB`` and come back on the next
hit with one page copy and a table write instead of a re-prefill.  The
layout is the reference's: one page of K and one of V, each
``[layers, page_size, kv_heads, head_dim]`` in the cache's dtype.

On a card the transfers keep the decode hot path free of syncs:

- :func:`gather_page` clones the page into fresh device buffers on the
  current (compute) stream.  Device order alone puts the clone before any
  later write of the re-granted page, so eviction can hand the page out at
  once.
- :func:`fetch_page` copies the gathered buffers into pinned host tensors
  on a SIDE stream that waits only on an event recorded right after the
  gather, with ``non_blocking=True``: under decode-ahead pipelining the
  compute stream already holds the next step, and a device->host copy
  queued behind it would wait a whole step.  The gathered buffers are
  marked as used by the side stream (``record_stream``), so the caching
  allocator does not reuse them under the copy.  The commit window waits
  on the fetch's own event and nothing else (:meth:`PageFetch.wait`).
- :func:`restore_page` is an in-place ``copy_`` of a pooled pinned block
  into the page, ``non_blocking=True``, on the compute stream; the next
  step reads it in order.  Pool entries come from PyTorch's caching host
  allocator, which keeps a block alive until the copies queued on it have
  run, so an entry the pool drops meanwhile is not freed under the copy.

Pinning that fails raises; nothing falls back to pageable memory.  On the
CPU every transfer is a plain copy.  No kernel is written here: in the
JAX package these are XLA slices and a donated page write, not Pallas
kernels.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Optional

import torch

__all__ = ["HostKVPool", "PageFetch", "fetch_page", "gather_page", "restore_page"]


class HostKVPool:
    """LRU host-RAM pool of offloaded KV blocks, keyed by block hash.

    Entries are (k, v) host tensors of one page each —
    ``[layers, page_size, kv_heads, head_dim]``.  ``capacity_mb`` bounds
    the pool; inserting past it drops least-recently-used blocks first.
    ``capacity_mb=0`` disables the pool (has() is always False), which
    turns eviction into plain forgetting.

    Thread-safe: every entry mutation happens under one lock, as in the
    reference (the fabric's readers share the pool with the decode
    worker).
    """

    def __init__(self, capacity_mb: int = 0) -> None:
        self.capacity_bytes = int(capacity_mb) * 1024 * 1024
        self._entries: "OrderedDict[bytes, tuple[torch.Tensor, torch.Tensor]]" = (
            OrderedDict()
        )
        self._lock = threading.Lock()
        self.bytes_used = 0
        self.dropped = 0  # blocks LRU-dropped to make room

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def has(self, h: bytes) -> bool:
        with self._lock:
            return h in self._entries

    def get(self, h: bytes) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
        with self._lock:
            entry = self._entries.get(h)
            if entry is not None:
                self._entries.move_to_end(h)
            return entry

    def put(
        self, h: bytes, k: torch.Tensor, v: torch.Tensor
    ) -> Optional[list[bytes]]:
        """Insert a block.  Returns None when the pool is disabled or the
        single block exceeds capacity (caller should forget the hash);
        otherwise the list of LRU-dropped hashes (possibly empty) — the
        caller forgets those in its index so matches cannot go stale."""
        size = k.nbytes + v.nbytes
        if self.capacity_bytes <= 0 or size > self.capacity_bytes:
            return None
        with self._lock:
            if h in self._entries:
                self._entries.move_to_end(h)
                return []
            evicted: list[bytes] = []
            while self.bytes_used + size > self.capacity_bytes and self._entries:
                old, (ok, ov) = self._entries.popitem(last=False)
                self.bytes_used -= ok.nbytes + ov.nbytes
                self.dropped += 1
                evicted.append(old)
            self._entries[h] = (k, v)
            self.bytes_used += size
            return evicted

    def drop(self, h: bytes) -> None:
        with self._lock:
            entry = self._entries.pop(h, None)
            if entry is not None:
                self.bytes_used -= entry[0].nbytes + entry[1].nbytes


def gather_page(paged: Any, page: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Clone one page out of the cache into fresh buffers on the current
    stream, with no host sync.  Shapes ``[layers, page_size, kv_heads,
    head_dim]`` each."""
    return paged.k_pages[:, page].clone(), paged.v_pages[:, page].clone()


@dataclass
class PageFetch:
    """A gathered page on its way to the host: pinned ``k`` and ``v`` that
    hold the page's bytes once ``done`` has run (``done`` is None on the
    CPU, where the copy is already complete)."""

    k: torch.Tensor
    v: torch.Tensor
    #: torch.cuda.Events: ``ready`` after the gather on the compute
    #: stream, ``done`` after the copies on the side stream
    ready: Optional[Any] = None
    done: Optional[Any] = None

    def wait(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Block until the copy has landed; returns ``(k, v)``."""
        if self.done is not None:
            self.done.synchronize()
        return self.k, self.v


_side_streams: dict = {}


def _side_stream(device: torch.device) -> Any:
    """One transfer stream per device, created on first use."""
    stream = _side_streams.get(device.index)
    if stream is None:
        stream = _side_streams[device.index] = torch.cuda.Stream(device=device)
    return stream


def fetch_page(k_dev: torch.Tensor, v_dev: torch.Tensor) -> PageFetch:
    """Start the device->host copy of a gathered page (see module doc);
    call right after :func:`gather_page`, on the same stream, so the side
    stream waits for the gather and nothing later.  On the CPU the copy
    is done at once."""
    if not k_dev.is_cuda:
        return PageFetch(k_dev.clone(), v_dev.clone())
    ready = torch.cuda.Event(enable_timing=True)
    ready.record()  # the current stream, right after the gather
    k_host = torch.empty(k_dev.shape, dtype=k_dev.dtype, pin_memory=True)
    v_host = torch.empty(v_dev.shape, dtype=v_dev.dtype, pin_memory=True)
    side = _side_stream(k_dev.device)
    with torch.cuda.stream(side):
        side.wait_event(ready)
        k_host.copy_(k_dev, non_blocking=True)
        v_host.copy_(v_dev, non_blocking=True)
        done = torch.cuda.Event(enable_timing=True)
        done.record(side)
    # the gathered buffers may be dropped (a restore took them) before the
    # side stream has read them
    k_dev.record_stream(side)
    v_dev.record_stream(side)
    return PageFetch(k_host, v_host, ready, done)


def restore_page(paged: Any, page: int, k: torch.Tensor, v: torch.Tensor) -> Any:
    """Write a block back into device page ``page`` in place, on the
    current stream (``k``/``v`` a pooled pinned block or gathered device
    buffers).  Returns ``paged``."""
    paged.k_pages[:, page].copy_(k, non_blocking=True)
    paged.v_pages[:, page].copy_(v, non_blocking=True)
    return paged
