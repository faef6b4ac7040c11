"""Seeded open-loop arrival processes.

An :class:`ArrivalProcess` turns an :class:`ArrivalSpec` + seed into a
concrete schedule of :class:`ArrivalEvent` — offsets, analysis sizes,
recall-hot flags, SLO classes — with EVERY random draw taken at build
time from one ``random.Random(seed)`` (the ``utils/faultinject.py``
``bernoulli`` discipline: no draw during the run, so two materialisations
of the same (spec, seed) are byte-identical regardless of scheduling,
wall-clock, or how far the system fell behind).  ``fingerprint()`` hashes
the materialised schedule; the bench and the CI smoke assert two-replay
equality on it.

Time-varying rates (storm bursts, diurnal ramps) use Lewis-Shedler
thinning over the peak rate: candidate gaps are exponential at the peak,
each kept with probability ``rate(t)/peak`` — exact for piecewise and
sinusoidal rate functions alike, and every accept/reject is one more
build-time draw.
"""

from __future__ import annotations

import hashlib
import json
import math
import random
from dataclasses import asdict, dataclass, field
from typing import Optional

__all__ = ["ArrivalEvent", "ArrivalProcess", "ArrivalSpec"]


@dataclass(frozen=True)
class ArrivalEvent:
    """One offered failure: fired at ``at_s`` from storm start whether or
    not anything earlier has completed (open loop)."""

    index: int
    at_s: float
    kind: str  # "short" | "long" — analysis size (log volume)
    recall_hot: bool  # repeats a known failure class (recall hit) vs cold
    slo_class: str

    def to_dict(self) -> dict:
        return {
            "index": self.index,
            "at_s": round(self.at_s, 9),
            "kind": self.kind,
            "recall_hot": self.recall_hot,
            "slo_class": self.slo_class,
        }


@dataclass(frozen=True)
class ArrivalSpec:
    """Shape of the offered load.  ``name`` picks the rate function:

    - ``poisson`` — constant ``rate_per_min``;
    - ``storm``   — baseline with ``burst_factor``x bursts of
      ``burst_len_s`` every ``burst_every_s`` (correlated fleet-wide
      failure storms, the scenario vocabulary's disconnect/409-storm
      shape applied to arrivals);
    - ``diurnal`` — sinusoidal ramp, ``amplitude`` modulation over
      ``period_s``.

    ``class_mix`` weights are normalised; mean offered rate stays
    ``rate_per_min`` for poisson/diurnal, and for storm the bursts ADD
    load on top of the baseline (offered > nominal — the overload is the
    experiment)."""

    name: str = "storm"
    rate_per_min: float = 100.0
    duration_s: float = 60.0
    burst_factor: float = 4.0
    burst_every_s: float = 20.0
    burst_len_s: float = 5.0
    period_s: float = 60.0
    amplitude: float = 0.5
    long_fraction: float = 0.25
    recall_hot_fraction: float = 0.5
    class_mix: "tuple[tuple[str, float], ...]" = (
        ("interactive", 0.5), ("standard", 0.3), ("batch", 0.2),
    )

    def to_dict(self) -> dict:
        out = asdict(self)
        out["class_mix"] = [list(pair) for pair in self.class_mix]
        return out


@dataclass
class ArrivalProcess:
    spec: ArrivalSpec
    seed: int = 0
    _events: Optional["list[ArrivalEvent]"] = field(default=None, repr=False)

    def rate_per_s(self, t: float) -> float:
        spec = self.spec
        base = spec.rate_per_min / 60.0
        if spec.name == "storm":
            in_burst = (t % spec.burst_every_s) < spec.burst_len_s
            return base * (spec.burst_factor if in_burst else 1.0)
        if spec.name == "diurnal":
            phase = 2.0 * math.pi * t / max(spec.period_s, 1e-9)
            return base * max(0.0, 1.0 + spec.amplitude * math.sin(phase))
        return base

    def _peak_rate_per_s(self) -> float:
        spec = self.spec
        base = spec.rate_per_min / 60.0
        if spec.name == "storm":
            return base * max(1.0, spec.burst_factor)
        if spec.name == "diurnal":
            return base * (1.0 + max(0.0, spec.amplitude))
        return base

    def materialize(self) -> "list[ArrivalEvent]":
        """The full schedule, every draw taken NOW from one seeded rng.
        Cached: repeated calls (the driver, the fingerprint, the report)
        see one identical list."""
        if self._events is not None:
            return self._events
        spec = self.spec
        rng = random.Random(self.seed)
        peak = self._peak_rate_per_s()
        mix = [(name, max(0.0, weight)) for name, weight in spec.class_mix]
        total_weight = sum(w for _, w in mix) or 1.0
        events: list[ArrivalEvent] = []
        t = 0.0
        index = 0
        while peak > 0.0:
            t += rng.expovariate(peak)
            if t >= spec.duration_s:
                break
            # thinning accept/reject — one build-time draw per candidate
            if rng.random() * peak > self.rate_per_s(t):
                continue
            kind = "long" if rng.random() < spec.long_fraction else "short"
            recall_hot = rng.random() < spec.recall_hot_fraction
            pick = rng.random() * total_weight
            slo_class = mix[-1][0]
            for name, weight in mix:
                pick -= weight
                if pick <= 0.0:
                    slo_class = name
                    break
            events.append(ArrivalEvent(
                index=index, at_s=t, kind=kind,
                recall_hot=recall_hot, slo_class=slo_class,
            ))
            index += 1
        self._events = events
        return events

    def offered_per_min(self) -> float:
        events = self.materialize()
        span = max(self.spec.duration_s, 1e-9)
        return len(events) * 60.0 / span

    def fingerprint(self) -> str:
        """sha256 over the spec + the materialised schedule — equal
        fingerprints mean byte-identical replays (the two-replay gate
        bench.py and the CI smoke assert)."""
        basis = {
            "spec": self.spec.to_dict(),
            "seed": self.seed,
            "events": [e.to_dict() for e in self.materialize()],
        }
        return hashlib.sha256(
            json.dumps(basis, sort_keys=True).encode()
        ).hexdigest()
