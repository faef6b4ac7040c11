"""Analytic per-token flops model + the serving engines' step clock.

The port's own copy of ``operator_tpu/serving/perf.py``.  The step clock
(obs/steptrace.py) records *where* a step's wall time goes; this module
turns those records into *how fast the card ran*: an analytic
flops-per-token model derived from the model config alone (no device
counters needed), a per-dtype peak table for the NVIDIA H100, and the
:class:`StepClock` both engine loops record through.

Everything here is host-side bookkeeping: the clock's only device
interaction is timing a sync the loop was about to perform anyway.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

from ..obs.steptrace import StepRecord, StepRing, attribution
from ..utils.timing import MetricsRegistry

#: per-dtype dense peak, TFLOP/s, of one NVIDIA H100 SXM5 80GB (the
#: port's target card; NVIDIA H100 Tensor Core GPU data sheet, SXM
#: column: bf16 tensor core 1,979 and int8 3,958 with structured
#: sparsity, so 989.5 and 1,979 dense; FP32 67).  The port's int8 serving
#: keeps int8 weights in memory but ``models/quant.py:mm`` casts each to
#: bf16 before its GEMM, so its compute runs at the bf16 peak, not the
#: int8 one.  f32 GEMMs run on the CUDA cores (TF32 stays off).  ``PEAK_TFLOPS``
#: overrides the table, e.g. for a PCIe card or a power-capped one.
_PEAK_TFLOPS = {
    "bf16": 989.5,
    "bfloat16": 989.5,
    "int8": 989.5,
    "float32": 67.0,
    "f32": 67.0,
}


def matmul_param_count(config: Any) -> int:
    """Weights that participate in a matmul during one token's forward
    pass, analytically from the config (attention projections + MLP per
    layer, plus the LM head — which multiplies even when tied to the
    embedding).  Norm scales and the embedding GATHER move no MACs, so
    they are excluded; ``param_count(params)`` counts them and is the
    storage number, not the compute number."""
    h = config.hidden_size
    q = config.num_heads * config.head_dim
    kv = config.num_kv_heads * config.head_dim
    attn = h * q + 2 * h * kv + q * h  # wq, wk, wv, wo
    mlp = 3 * h * config.intermediate_size  # gate, up, down
    return config.num_layers * (attn + mlp) + h * config.vocab_size


def flops_per_token(config: Any, dtype: str = "bf16") -> float:
    """~2 FLOPs per matmul weight per generated token (multiply +
    accumulate; attention-score flops are negligible at serving sequence
    lengths).  ``dtype`` does not change the MAC count — it selects the
    peak (``peak_tflops``) the achieved number is divided by."""
    del dtype  # the MAC count is dtype-independent; kept for the API shape
    return 2.0 * matmul_param_count(config)


def peak_tflops(dtype: str = "bf16") -> float:
    """Card peak for the serving dtype (the H100 table above);
    ``PEAK_TFLOPS`` (or the bench's ``BENCH_PEAK_TFLOPS``) overrides."""
    env = os.environ.get("PEAK_TFLOPS") or os.environ.get("BENCH_PEAK_TFLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return _PEAK_TFLOPS.get(str(dtype).lower(), _PEAK_TFLOPS["bf16"])


class StepClock:
    """Per-step recorder both serving loops write through.

    Owns the bounded :class:`StepRing`, stamps host-gap boundaries
    (previous commit → next dispatch), attaches the model's analytic
    flops/token so every record carries its achieved MFU, and feeds the
    step histograms (``podmortem_step_duration_milliseconds`` /
    ``podmortem_step_host_gap_milliseconds``).  All methods run on the
    decode worker thread; reads (summary, ring) are lock-protected by
    the ring itself."""

    def __init__(
        self,
        *,
        capacity: Optional[int] = None,
        flops_per_token: Optional[float] = None,
        peak_tflops: Optional[float] = None,
        max_slots: int = 1,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.ring = StepRing(capacity)
        self.flops_per_token = flops_per_token
        self.peak_tflops = peak_tflops
        self.max_slots = max(1, int(max_slots))
        self.metrics = metrics
        #: end of the previous step's commit (perf_counter); None right
        #: after construction/reset — the first step has no host gap
        self._last_commit: Optional[float] = None

    def host_gap_ms(self, dispatch_t: float) -> float:
        """Host think-time between the previous commit and ``dispatch_t``
        (0.0 for the first step after construction or reset)."""
        if self._last_commit is None:
            return 0.0
        return max(0.0, (dispatch_t - self._last_commit) * 1e3)

    def observe(
        self,
        *,
        kind: str,
        tokens: int,
        slots: int,
        host_gap_ms: float,
        device_ms: float,
        sample_xfer_ms: float,
        commit_t: Optional[float] = None,
        accepted: Optional[int] = None,
        cached_tokens: Optional[int] = None,
    ) -> StepRecord:
        """Record one step and stamp its commit as the next step's
        host-gap origin.  ``accepted`` is the step's COMMITTED generated
        token count when it differs from the billed ``tokens``
        (speculation verify rows, pipelined voided work); MFU stays
        computed on billed tokens — the compute really ran.
        ``cached_tokens`` is the prompt-token count rows admitted at this
        step reused from the prefix cache — spared compute, so it never
        enters ``tokens`` and MFU stays honest."""
        total = max(0.0, host_gap_ms) + max(0.0, device_ms) + max(0.0, sample_xfer_ms)
        mfu = None
        if (
            self.flops_per_token
            and self.peak_tflops
            and total > 0
            and tokens
            and kind in ("decode", "mixed")
        ):
            achieved = tokens * self.flops_per_token / (total / 1e3) / 1e12
            mfu = achieved / self.peak_tflops
        record = self.ring.append(
            kind=kind,
            tokens=tokens,
            slots=slots,
            occupancy=min(1.0, slots / self.max_slots),
            host_gap_ms=host_gap_ms,
            device_ms=device_ms,
            sample_xfer_ms=sample_xfer_ms,
            mfu=mfu,
            accepted=accepted,
            cached_tokens=cached_tokens,
        )
        self._last_commit = commit_t if commit_t is not None else time.perf_counter()
        if self.metrics is not None:
            self.metrics.observe("step_duration_milliseconds", total)
            self.metrics.observe("step_host_gap_milliseconds", max(0.0, host_gap_ms))
        return record

    @property
    def decode_cum_ms(self) -> float:
        """Monotonic cumulative decode-bearing wall (see StepRing) — the
        eviction-proof base request decode times are derived from."""
        return self.ring.decode_cum_ms

    def summary(self, last: Optional[int] = None) -> dict:
        """Stall-attribution summary (+ measured decode MFU) over the
        ring's current window — what /healthz, /fleet and bench.py's
        ``step_attribution`` block all read."""
        return attribution(
            self.ring.records(last),
            flops_per_token=self.flops_per_token,
            peak_tflops=self.peak_tflops,
        )

    def reset(self) -> None:
        """Forget everything (device-state reset: the old timeline died
        with the old decode state; black-box dumps captured it first)."""
        self.ring.reset()
        self._last_commit = None
