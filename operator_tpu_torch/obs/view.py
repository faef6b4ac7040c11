"""Render a flight-recorder JSONL dump as flame-style text trees.

The port's own copy of ``operator_tpu/obs/view.py``: host code, the same names and
behaviour.

    python -m operator_tpu_torch.obs.view dump.jsonl            # summary list
    python -m operator_tpu_torch.obs.view dump.jsonl <trace-id> # one full tree
    python -m operator_tpu_torch.obs.view dump.jsonl --all      # every tree
    python -m operator_tpu_torch.obs.view dump.jsonl --blackbox # black-box only
    python -m operator_tpu_torch.obs.view --steps dump.jsonl    # step timeline
    python -m operator_tpu_torch.obs.view --slo ledger.jsonl    # SLO attainment

Reads the journal written by :class:`..record.FlightRecorder` (or a
black-box dump) and renders each trace's span tree with offsets/widths
scaled to the root span — the laptop-side twin of ``GET /traces/{id}``.

``--steps`` instead renders the step-clock timeline (docs/OBSERVABILITY.md
"Step clock") as a fixed-width table: the input is either a JSONL of raw
step-record dicts, or a black-box dump whose records carry a last-N
``steps`` tail in their ``extra`` context (the engine attaches one
automatically) — both are recognised line by line.

``--slo`` renders an SLO-ledger journal (docs/OBSERVABILITY.md "SLO
ledger"): the per-class attainment/goodput table plus the worst
offenders — the biggest misses, each with its flight-recorder stage
timeline so the report shows WHERE a missed analysis spent its budget.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from .record import FlightRecorder, TraceRecord, render_tree
from .steptrace import StepRecord, attribution, render_steps


def load_steps(path: str) -> list[StepRecord]:
    """Step records from a JSONL file: raw step-record dicts (one per
    line, as ``StepRecord.to_dict`` writes them) and/or black-box trace
    records whose ``extra.steps`` carries the engine's last-N tail.
    Unparseable lines are skipped — a step view over a crashed run's
    half-written journal should show what IS there."""
    steps: list[StepRecord] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                data = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(data, dict):
                continue
            if "kind" in data and "device_ms" in data:
                steps.append(StepRecord.from_dict(data))
                continue
            extra = data.get("extra")
            if isinstance(extra, dict):
                for item in extra.get("steps") or []:
                    if isinstance(item, dict):
                        steps.append(StepRecord.from_dict(item))
    return steps


def _print_steps(path: str) -> int:
    try:
        steps = load_steps(path)
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if not steps:
        print(f"no step records in {path}")
        return 0
    print(render_steps(steps))
    summary = attribution(steps)
    fractions = summary["fractions"]
    if fractions["host_gap"] is not None:
        print(
            f"\n{summary['steps']} steps  tokens={summary['tokens']}  "
            f"host_gap={fractions['host_gap']:.1%}  "
            f"device={fractions['device']:.1%}  "
            f"sample_xfer={fractions['sample_xfer']:.1%}"
        )
    return 0


def _print_slo(path: str, *, worst: int = 5) -> int:
    """Per-class attainment table + worst-offender timelines from an
    SLO-ledger journal (obs/sloledger.py)."""
    from .sloledger import SLOLedger, summarize

    try:
        records = SLOLedger.load_records(path)
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if not records:
        print(f"no SLO records in {path}")
        return 0
    summary = summarize(records)
    header = (
        f"{'class':<14}{'target':>8}{'admit':>7}{'attain':>7}{'rate':>8}"
        f"{'shed':>6}{'dl-ex':>6}{'fail':>6}{'p50':>9}{'p95':>9}"
        f"{'goodput/min':>12}"
    )
    print(header)
    print("-" * len(header))

    def _row(name: str, row: dict, target: Optional[float]) -> None:
        rate = row.get("attainment")
        target_txt = f"{target:.0f}s" if target is not None else "-"
        rate_txt = f"{rate:.1%}" if rate is not None else "-"
        p50 = row["p50_s"]
        p95 = row["p95_s"]
        p50_txt = f"{p50:.3f}s" if p50 is not None else "-"
        p95_txt = f"{p95:.3f}s" if p95 is not None else "-"
        print(
            f"{name:<14}{target_txt:>8}"
            f"{row['admitted']:>7}{row['attained']:>7}{rate_txt:>8}"
            f"{row['shed']:>6}{row['deadline_exceeded']:>6}{row['failed']:>6}"
            f"{p50_txt:>9}{p95_txt:>9}"
            f"{row['goodput_analyses_per_min']:>12.1f}"
        )

    for cls, row in summary["classes"].items():
        _row(cls, row, row.get("target_s"))
    _row("TOTAL", summary["total"], None)

    misses = sorted(
        (r for r in records if not r.attained),
        key=lambda r: (
            (r.latency_s or 0.0) / r.target_s if r.target_s > 0 else 0.0
        ),
        reverse=True,
    )[:worst]
    if misses:
        print(f"\nworst offenders ({len(misses)} of "
              f"{sum(1 for r in records if not r.attained)} misses):")
        for record in misses:
            latency = record.latency_s or 0.0
            over = latency / record.target_s if record.target_s > 0 else 0.0
            print(
                f"  {record.trace_id}  {record.cls:<12} {record.outcome:<18}"
                f" {latency:8.3f}s / {record.target_s:.0f}s target"
                f" ({over:.1f}x)"
                + (f"  replica={record.replica}" if record.replica else "")
            )
            if record.stages:
                total = sum(record.stages.values()) or 1.0
                for name, ms in sorted(
                    record.stages.items(), key=lambda kv: -kv[1]
                ):
                    bar = "#" * max(1, round(ms / total * 30))
                    print(f"      {name:<16}{ms:>10.1f}ms  {bar}")
    return 0


def _print_record(record: TraceRecord, *, full: bool) -> None:
    if record.blackbox:
        print(f"*** BLACK BOX: {record.reason} ***")
        if record.extra:
            print(f"    context: {json.dumps(record.extra, sort_keys=True)}")
    if full:
        print(render_tree(record.trace))
    else:
        summary = record.summary()
        print(
            f"{summary['traceId']}  {summary.get('name', '?'):<20}"
            f" {float(summary.get('durationMs') or 0.0):>9.1f}ms"
            f"  spans={summary['spans']}  status={summary.get('status', '?')}"
            + ("  [blackbox]" if record.blackbox else "")
        )


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="operator_tpu_torch.obs.view",
        description="render a flight-recorder JSONL dump as span trees",
    )
    parser.add_argument("path", help="trace journal / black-box JSONL")
    parser.add_argument("trace_id", nargs="?",
                        help="render only this trace (full tree)")
    parser.add_argument("--all", action="store_true",
                        help="render every trace as a full tree")
    parser.add_argument("--blackbox", action="store_true",
                        help="only black-box records")
    parser.add_argument("--steps", action="store_true",
                        help="render the step-clock timeline instead of "
                             "span trees (raw step JSONL or black-box "
                             "dumps with a steps tail)")
    parser.add_argument("--slo", action="store_true",
                        help="render an SLO-ledger journal: per-class "
                             "attainment table + worst-offender stage "
                             "timelines")
    parser.add_argument("--worst", type=int, default=5,
                        help="worst offenders to detail with --slo "
                             "(default 5)")
    args = parser.parse_args(argv)
    if args.slo:
        return _print_slo(args.path, worst=max(0, args.worst))
    if args.steps:
        return _print_steps(args.path)
    try:
        records = FlightRecorder.load(args.path)
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if args.blackbox:
        records = [r for r in records if r.blackbox]
    if args.trace_id:
        records = [r for r in records if r.trace_id.startswith(args.trace_id)]
        if not records:
            print(f"error: no trace matching {args.trace_id!r} in {args.path}",
                  file=sys.stderr)
            return 1
    if not records:
        print(f"no traces in {args.path}")
        return 0
    full = bool(args.trace_id or args.all)
    try:
        for record in records:
            _print_record(record, full=full)
            if full:
                print()
    except BrokenPipeError:  # `... | head` closed the pipe mid-listing
        sys.stderr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
