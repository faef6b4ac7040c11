"""Host encode time of the port's tokenizers, one checkout against another.

Loads ``operator_tpu_torch`` from each given checkout under a name of its
own, in one process, and times ``HFTokenizer.encode`` (the WordPiece
fixture through ``encode_with_special_tokens``, as the encoder reads it)
on the committed tokenizer fixtures of the first checkout
(``tests/torch_tokenizers/``: the Unigram, Script-aware, log and
WordPiece ones): over the fixture logs' lines and each fixture's
``expected_ids.json`` prompts, split into texts that hold no code point
of the normalization and lowercase overrides (``tables.NORMALIZATION_CUTS``
and ``tables.LOWERCASE`` of the first checkout, which must have them) and
texts that hold one.
Each batch is timed for every checkout back to back, in the order given
and then reversed, a few rounds, with the collector off; the median
microseconds per text of each is printed as one JSON line.  Host CPU
time only: it reads no device.

    python scripts/torch_tokenizer_host_cost.py CHANGE PARENT [--rounds N] [--repeats N]
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import statistics
import sys
import time

FIXTURES = ("xlmr_unigram", "xlmr_scripts", "onig_logs", "minilm_wordpiece")
#: texts with override code points besides the fixtures' own: Unicode
#: 12.1-15.0 compatibility characters and 16.0 capitals in log lines
OVERRIDE_TEXTS = [
    "2026-07-28 ERROR ㋿ quota \U0001F16C exceeded for pod api-7d9f",
    "warn: node Ᲊ TJE Ɤ drained \U00010D50 after 3 retries",
    "panic: \U0001E030\U0001E031 index out of range [5] with length 3 \U0001FBF0",
    "pod \U0001190C\U00011938 ok — restarted container web (exit code 137)",
]


def load(root: str, name: str):
    """``root``'s ``operator_tpu_torch`` imported as ``name``."""
    package = os.path.join(root, "operator_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(package, "__init__.py"), submodule_search_locations=[package])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.models.tokenizer")


def texts(root: str, name: str) -> "dict[str, dict[str, list]]":
    """Fixture -> {"plain": texts, "override": texts}, the overrides those
    of the package loaded as ``name`` (from ``root``)."""
    tables = sys.modules[f"{name}.models.tokenization.tables"]
    table = sys.modules[f"{name}.models.tokenization.text"].table
    overrides = {chr(c) for lo, hi in table("NORMALIZATION_CUTS") for c in range(lo, hi + 1)}
    overrides |= set(map(chr, tables.LOWERCASE))
    logs = os.path.join(root, "tests", "fixtures")
    lines = [line for log in sorted(os.listdir(logs)) if log.endswith(".log")
             for line in open(os.path.join(logs, log), encoding="utf-8").read().splitlines()]
    out = {}
    for fixture in FIXTURES:
        with open(os.path.join(root, "tests", "torch_tokenizers", fixture, "expected_ids.json"),
                  encoding="utf-8") as fh:
            prompts = json.load(fh)["prompts"]
        every = lines + prompts + OVERRIDE_TEXTS
        out[fixture] = {"plain": [t for t in every if not overrides & set(t)],
                        "override": [t for t in every if overrides & set(t)]}
    return out


def per_text_us(encode, batch: list, repeats: int) -> float:
    started = time.perf_counter()
    for _ in range(repeats):
        for text in batch:
            encode(text)
    return (time.perf_counter() - started) * 1e6 / (repeats * len(batch))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="+",
                        help="checkouts; the first (with the tables) names the fixtures")
    parser.add_argument("--rounds", type=int, default=9)
    parser.add_argument("--repeats", type=int, default=10)
    args = parser.parse_args(argv)
    modules = [load(root, f"_port{i}") for i, root in enumerate(args.roots)]
    batches = texts(args.roots[0], "_port0")
    fixture_dir = os.path.join(args.roots[0], "tests", "torch_tokenizers")
    encoders = []
    for module in modules:
        by_fixture = {}
        for fixture in FIXTURES:
            tok = module.HFTokenizer(os.path.join(fixture_dir, fixture))
            by_fixture[fixture] = (tok.encode_with_special_tokens if fixture == "minilm_wordpiece"
                                   else (lambda t, tok=tok: tok.encode(t, add_bos=False)))
        encoders.append(by_fixture)
    for by_fixture in encoders:  # warm the caches alike
        for fixture, encode in by_fixture.items():
            for kind in ("plain", "override"):
                per_text_us(encode, batches[fixture][kind], 1)
    samples = {(i, f, k): [] for i in range(len(encoders)) for f in FIXTURES
               for k in ("plain", "override")}
    order = list(range(len(encoders)))
    gc.disable()
    for round_ in range(args.rounds):
        for fixture in FIXTURES:
            for kind in ("plain", "override"):
                # each batch timed for every checkout back to back
                for i in (order if round_ % 2 == 0 else order[::-1]):
                    samples[(i, fixture, kind)].append(per_text_us(
                        encoders[i][fixture], batches[fixture][kind], args.repeats))
    gc.enable()
    result = {"roots": args.roots, "texts": {f: {k: len(v) for k, v in b.items()}
                                             for f, b in batches.items()},
              "us_per_text": {root: {f: {k: statistics.median(samples[(i, f, k)])
                                         for k in ("plain", "override")} for f in FIXTURES}
                              for i, root in enumerate(args.roots)}}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
