"""Step clock: bounded per-step records for the serving decode loops.

The port's own copy of ``operator_tpu/obs/steptrace.py``.  On a card
``device_ms`` is the host's wait from dispatch until the step's CUDA
event completes (the one sync the loop pays anyway).

BENCH_r02 measured decode MFU 0.0064 — the chip is ~99% idle during
decode — and a single opaque MFU number cannot say *where* a step's wall
time goes.  Both engine loops (the wave engine's ``step()`` and the
continuous scheduler's ``Scheduler.step()``) record one
:class:`StepRecord` per dispatched step into a bounded :class:`StepRing`,
splitting the step's monotonic timeline into three attributed components:

- ``host_gap_ms``   — time between the previous step's commit and this
  step's dispatch (host think-time: scheduling, admission, Python)
- ``device_ms``     — dispatch → result ready (``block_until_ready`` on
  the already-dispatched token array; the ONE sync the loop was about to
  perform anyway, so the clock adds zero new host syncs — GL001-gated)
- ``sample_xfer_ms``— the sampled-token device→host fetch

Attribution fractions are computed over the SUM of the three components,
so they always total 1.0 by construction; the analytic flops-per-token
model (serving/perf.py) turns the same records into per-step achieved
TFLOPs and a measured, attributed decode MFU.

The ring is host-side bookkeeping only and is never reachable from a
compiled program; ``STEP_RING_CAPACITY`` bounds it (default 512 steps).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

#: record kinds: a pure-prefill step, a pure-decode step, or the
#: continuous scheduler's ragged mixed step (both phases in one program)
STEP_KINDS = ("prefill", "decode", "mixed")

_DEFAULT_CAPACITY = 512


def _env_capacity(default: int = _DEFAULT_CAPACITY) -> int:
    try:
        return int(os.environ.get("STEP_RING_CAPACITY", "") or default)
    except ValueError:  # garbage env must not fail every importer
        return default


@dataclass(frozen=True)
class StepRecord:
    """One engine step's attributed timeline (immutable once recorded)."""

    seq: int
    kind: str  # "prefill" | "decode" | "mixed"
    tokens: int  # tokens processed this step (decode rows / prefill chunk)
    slots: int  # live slots at dispatch
    occupancy: float  # slots / max_slots
    host_gap_ms: float
    device_ms: float
    sample_xfer_ms: float
    #: per-step achieved MFU when the ring's owner knows the model's
    #: flops/token (serving/perf.py StepClock); None on bare rings
    mfu: Optional[float] = None
    #: generated tokens actually COMMITTED this step — differs from
    #: ``tokens`` under speculation (a verify row is billed q_count
    #: tokens of compute but lands accept+1) and under pipelining
    #: (voided work lands zero); None on engines that don't distinguish
    accepted: Optional[int] = None
    #: prompt tokens served from the prefix KV cache by rows admitted at
    #: this step (serving/kvstore.py) — kept off the billed ``tokens``
    #: so MFU stays honest on compute actually performed; None on
    #: engines without a prefix cache
    cached_tokens: Optional[int] = None

    @property
    def total_ms(self) -> float:
        return self.host_gap_ms + self.device_ms + self.sample_xfer_ms

    def to_dict(self) -> dict:
        out = {
            "seq": self.seq,
            "kind": self.kind,
            "tokens": self.tokens,
            "slots": self.slots,
            "occupancy": round(self.occupancy, 4),
            "host_gap_ms": round(self.host_gap_ms, 4),
            "device_ms": round(self.device_ms, 4),
            "sample_xfer_ms": round(self.sample_xfer_ms, 4),
        }
        if self.mfu is not None:
            out["mfu"] = round(self.mfu, 6)
        if self.accepted is not None:
            out["accepted"] = self.accepted
        if self.cached_tokens is not None:
            out["cached_tokens"] = self.cached_tokens
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "StepRecord":
        return cls(
            seq=int(data.get("seq", 0)),
            kind=str(data.get("kind", "decode")),
            tokens=int(data.get("tokens", 0)),
            slots=int(data.get("slots", 0)),
            occupancy=float(data.get("occupancy", 0.0)),
            host_gap_ms=float(data.get("host_gap_ms", 0.0)),
            device_ms=float(data.get("device_ms", 0.0)),
            sample_xfer_ms=float(data.get("sample_xfer_ms", 0.0)),
            mfu=(float(data["mfu"]) if data.get("mfu") is not None else None),
            accepted=(
                int(data["accepted"])
                if data.get("accepted") is not None else None
            ),
            cached_tokens=(
                int(data["cached_tokens"])
                if data.get("cached_tokens") is not None else None
            ),
        )


class StepRing:
    """Bounded, thread-safe ring of step records.

    Recorded from the decode worker thread, read from the event loop
    (``/healthz`` summaries, black-box dumps) — hence the lock.  Besides
    the bounded window it keeps MONOTONIC cumulative totals per kind:
    eviction-proof running sums the engines use to derive a request's
    decode wall time from the clock itself (so span timings and step
    records can never disagree, however long the generation ran).
    """

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = (
            int(capacity) if capacity and int(capacity) > 0 else _env_capacity()
        )
        self._lock = threading.Lock()
        self._records: list[StepRecord] = []
        self._seq = 0
        self.evicted = 0
        #: cumulative attributed ms per kind since construction (never
        #: reset by eviction; reset() zeroes them with the ring)
        self.cum_ms = {kind: 0.0 for kind in STEP_KINDS}
        self.cum_tokens = {kind: 0 for kind in STEP_KINDS}

    def append(
        self,
        *,
        kind: str,
        tokens: int,
        slots: int,
        occupancy: float,
        host_gap_ms: float,
        device_ms: float,
        sample_xfer_ms: float,
        mfu: Optional[float] = None,
        accepted: Optional[int] = None,
        cached_tokens: Optional[int] = None,
    ) -> StepRecord:
        if kind not in STEP_KINDS:
            raise ValueError(f"unknown step kind {kind!r} (one of {STEP_KINDS})")
        with self._lock:
            record = StepRecord(
                seq=self._seq,
                kind=kind,
                tokens=int(tokens),
                slots=int(slots),
                occupancy=float(occupancy),
                host_gap_ms=max(0.0, float(host_gap_ms)),
                device_ms=max(0.0, float(device_ms)),
                sample_xfer_ms=max(0.0, float(sample_xfer_ms)),
                mfu=mfu,
                accepted=(int(accepted) if accepted is not None else None),
                cached_tokens=(
                    int(cached_tokens) if cached_tokens is not None else None
                ),
            )
            self._seq += 1
            self._records.append(record)
            if len(self._records) > self.capacity:
                del self._records[0]
                self.evicted += 1
            self.cum_ms[kind] += record.total_ms
            self.cum_tokens[kind] += record.tokens
            return record

    def records(self, last: Optional[int] = None) -> "list[StepRecord]":
        with self._lock:
            if last is not None and last >= 0:
                return self._records[-last:] if last else []
            return list(self._records)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    @property
    def decode_cum_ms(self) -> float:
        """Cumulative attributed wall of every decode-bearing step (pure
        decode + mixed) — the monotonic clock request decode times are
        derived from."""
        with self._lock:
            return self.cum_ms["decode"] + self.cum_ms["mixed"]

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._seq = 0
            self.evicted = 0
            for kind in STEP_KINDS:
                self.cum_ms[kind] = 0.0
                self.cum_tokens[kind] = 0


def attribution(
    records: "Sequence[StepRecord]",
    *,
    flops_per_token: Optional[float] = None,
    peak_tflops: Optional[float] = None,
) -> dict:
    """Stall-attribution summary over a window of step records.

    Fractions are shares of the summed attributed time (host_gap +
    device + sample_xfer over all records), so they total 1.0 by
    construction.  With a flops model, ``decode_mfu`` is the measured
    MFU over decode-bearing steps (pure decode + mixed): tokens they
    produced x flops/token against peak over their attributed wall."""
    host_gap = sum(r.host_gap_ms for r in records)
    device = sum(r.device_ms for r in records)
    xfer = sum(r.sample_xfer_ms for r in records)
    total = host_gap + device + xfer
    decode_records = [r for r in records if r.kind in ("decode", "mixed")]
    decode_ms = sum(r.total_ms for r in decode_records)
    decode_tokens = sum(r.tokens for r in decode_records)
    # committed generated tokens: billed tokens unless the engine
    # reported a per-step accepted count (speculation / voided work)
    accepted_tokens = sum(
        r.accepted if r.accepted is not None else r.tokens
        for r in decode_records
    )
    out = {
        "steps": len(records),
        "prefill_steps": sum(1 for r in records if r.kind == "prefill"),
        "decode_steps": sum(1 for r in records if r.kind == "decode"),
        "mixed_steps": sum(1 for r in records if r.kind == "mixed"),
        "tokens": sum(r.tokens for r in records),
        "host_gap_ms": round(host_gap, 3),
        "device_ms": round(device, 3),
        "sample_xfer_ms": round(xfer, 3),
        "accepted_tokens": accepted_tokens,
        # prompt tokens the prefix cache spared from prefill compute
        "cached_tokens": sum(r.cached_tokens or 0 for r in records),
        "occupancy_avg": (
            round(sum(r.occupancy for r in records) / len(records), 4)
            if records else None
        ),
        "fractions": {
            "host_gap": round(host_gap / total, 4) if total else None,
            "device": round(device / total, 4) if total else None,
            "sample_xfer": round(xfer / total, 4) if total else None,
        },
        "decode_mfu": None,
        "achieved_tflops": None,
    }
    if flops_per_token and peak_tflops and decode_ms > 0 and decode_tokens:
        flops = decode_tokens * flops_per_token
        achieved = flops / (decode_ms / 1e3) / 1e12  # TFLOP/s
        out["achieved_tflops"] = round(achieved, 6)
        out["decode_mfu"] = round(achieved / peak_tflops, 6)
    return out


def render_steps(records: "Iterable[StepRecord]") -> str:
    """Compact fixed-width per-step timeline table (the ``obs.view
    --steps`` rendering; also readable when pasted from a black-box
    dump)."""
    header = (
        f"{'seq':>5}  {'kind':<7} {'tok':>5} {'slots':>5} {'occ':>5} "
        f"{'gap_ms':>8} {'dev_ms':>8} {'xfer_ms':>8} {'total':>8} {'mfu':>8}"
    )
    lines = [header, "-" * len(header)]
    for r in records:
        mfu = f"{r.mfu:.4f}" if r.mfu is not None else "-"
        lines.append(
            f"{r.seq:>5}  {r.kind:<7} {r.tokens:>5} {r.slots:>5} "
            f"{r.occupancy:>5.2f} {r.host_gap_ms:>8.3f} {r.device_ms:>8.3f} "
            f"{r.sample_xfer_ms:>8.3f} {r.total_ms:>8.3f} {mfu:>8}"
        )
    return "\n".join(lines)
