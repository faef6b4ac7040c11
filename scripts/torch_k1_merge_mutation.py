"""K1's split-KV merge, broken on purpose, against chip_smoke.py's long-window check.

Builds ``operator_tpu_torch/ops/csrc/ragged_attention.cu`` as it is and
with each of three faults in how tile 0's splits are cut or merged, each
from its own copy of ``csrc`` into its own build directory under the
checkout's ``build/`` (the sources in the checkout are not touched), and
holds each build to the plain version on ``chip_smoke.py``'s mistral-7b
long-window cases in bf16 (32 query heads over 8 KV heads of 128, a
4,096-token window over 8,192 positions, tile 0 in 16 splits of 512,
every live row past the window).  For each case it prints the largest
abs error and the largest row-scaled error (``chip_smoke.row_scaled_err``)
and whether each of two rules passes it: the fixed tolerance ``TOL``
alone, and ``TOL`` with the row-scaled one (``ROW_TOL``), which
``chip_smoke.py`` holds these cases to.  The faults:

- ``drop_window_split``: the merge starts one split late, dropping the
  split that holds the window's start;
- ``drop_last_split``: the merge ends one split early, dropping the split
  of the newest keys;
- ``overlap_next_stage``: each split but the last also walks the next
  split's first stage of 64 keys, so those keys count twice.

Each build runs in a process of its own (a library loads once per
process).  Needs one card and ``nvcc``::

    python3 scripts/torch_k1_merge_mutation.py

The last line is one JSON object, each build's numbers by name; the exit
code is 0 when the unchanged kernel passes both rules and the row-scaled
rule fails every fault.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = ("long_window_decode", "long_window_mixed")
#: build -> (text of ragged_attention.cu, its replacement); None: unchanged
MUTATIONS = {
    "unchanged": None,
    "drop_window_split": (
        "const int s_lo = span.begin / split_keys;",
        "const int s_lo = span.begin / split_keys + 1;",
    ),
    "drop_last_split": (
        "min((span.end - 1) / split_keys, n_splits - 1) : s_lo - 1;",
        "min((span.end - 1) / split_keys, n_splits - 1) - 1 : s_lo - 1;",
    ),
    "overlap_next_stage": (
        "if (split + 1 < n_splits) kv_end = min(kv_end, (split + 1) * split_keys);",
        "if (split + 1 < n_splits) kv_end = min(kv_end, (split + 1) * split_keys + kTcKeys);",
    ),
}


def run_build(name: str) -> dict:
    """Build ``name``'s kernel from a mutated copy of ``csrc`` and hold it
    to the plain version on ``CASES``."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from operator_tpu_torch.ops import _build
    from operator_tpu_torch.ops import ragged_attention as ra

    work = ROOT / "build" / "k1_merge_mutation" / name
    shutil.rmtree(work, ignore_errors=True)
    csrc = work / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    if MUTATIONS[name] is not None:
        old, new = MUTATIONS[name]
        path = csrc / "ragged_attention.cu"
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not once in ragged_attention.cu")
        path.write_text(text.replace(old, new))
    _build.CSRC = csrc
    _build.set_build_dir(work / "lib")
    tol = chip_smoke.TOL["bfloat16"]
    row_tol = chip_smoke.ROW_TOL["bfloat16"]
    cases = {}
    try:
        for index, case in enumerate(CASES):
            args, window, _, _ = chip_smoke.long_window_case(case, torch.bfloat16, 500 + index)
            note = chip_smoke.k1_split_note(*args, sliding_window=window)
            got = ra.ragged_attention_cuda(*args, sliding_window=window)
            torch.cuda.synchronize()
            want = ra.ragged_attention_reference(*args, sliding_window=window)
            valid = torch.arange(args[0].shape[1], device="cuda")[None, :] < args[5][:, None]
            got, want = got[valid].float(), want[valid].float()
            err = (got - want).abs().max().item()
            rel = chip_smoke.row_scaled_err(got, want)
            finite = bool(torch.isfinite(got).all().item())
            fixed = finite and err <= tol
            cases[case] = {
                "max_abs_err": err, "max_row_rel_err": rel, "finite": finite,
                "max_abs_plain": want.abs().max().item(), "tol": tol, "row_rel_tol": row_tol,
                "fixed_rule_passes": fixed, "scaled_rule_passes": fixed and rel <= row_tol,
                **note,
            }
            del args, got, want
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return cases


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--build", choices=sorted(MUTATIONS), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.build:
        print(json.dumps(run_build(args.build)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_merge_mutation: no CUDA device", file=sys.stderr)
        return 2
    results = {}
    for name in MUTATIONS:
        proc = subprocess.run([sys.executable, __file__, "--build", name], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"torch_k1_merge_mutation: build {name} exited {proc.returncode}")
        results[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({name: results[name]}), flush=True)
    unchanged = all(c["scaled_rule_passes"] for c in results["unchanged"].values())
    caught = all(not all(c["scaled_rule_passes"] for c in results[name].values())
                 for name in MUTATIONS if name != "unchanged")
    print(json.dumps({"card": chip_smoke_card(), "builds": results,
                      "unchanged_passes": unchanged, "every_fault_caught": caught}))
    return 0 if unchanged and caught else 1


def chip_smoke_card() -> str:
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke.card_line()


if __name__ == "__main__":
    raise SystemExit(main())
