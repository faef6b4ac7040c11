"""Hold the port's Oniguruma reading to the ``tokenizers`` library on random expressions.

Draws seeded random expressions from a grammar of Oniguruma's constructs
(classes, properties, escapes, anchors, groups, look-arounds, repeats,
options, back references, conditionals, calls) and compares, for each:

- whether the library and the port accept it;
- the library's ``Split(Regex(p), "isolated")`` pieces and the port's over
  a fixed corpus and seeded random text of many scripts, through the
  engine the port routes the expression to (``engines`` counts them);
- where the library gives up (its retry limit, a panic), whether the port
  gives up too (``RetryLimitError``): both give up, or the library only
  (a known difference); the port giving up alone is a disagreement.

It prints each disagreement and one summary line of counts, and exits 1 if
there was a disagreement.  It needs ``tokenizers`` (this container has
it; the card does not):

    PYTHONPATH=. python scripts/torch_oniguruma_fuzz.py [--seed S] [--count N]
"""

from __future__ import annotations

import argparse
import json
import random
import sys

ATOMS = ["a", "b", "s", "ß", "K", "x", "é", "中", ".", r"\w", r"\W", r"\s", r"\d", r"\h", r"\p{L}",
         r"\p{Han}", r"\P{Lu}", r"\p{^N}", "[a-c]", "[^ab]", r"[\w&&[^a]]", "[[:alpha:]]",
         "[[:^digit:]x]", r"[\p{Greek}\d]", r"\b", r"\B", "^", "$", r"\A", r"\z", r"\Z", r"\R",
         r"\X", r"\x41", r"\x{e9}", r"ß", r"\n", r"\t", " ", r"\-", r"\.", "(?i:ss)", r"\O",
         r"\N", r"\K", r"\cA", r"\o{101}"]
QUANTS = ["", "", "", "*", "+", "?", "*?", "+?", "??", "*+", "++", "?+", "{2}", "{1,3}", "{,2}",
          "{2,}", "{2}?", "{1,2}?", "{3,1}"]
GROUPS = ["(", "(?:", "(?>", "(?=", "(?!", "(?<=", "(?<!", "(?i:", "(?m:", "(?x:", "(?W:", "(?<g>"]
TEXTS = ["", "ab&12cd", "ax\n", "xa\nby", "xSSy ß ẞ ſs sß", "ab́ ab", "a\r\nb\n\nc\rd\x85e ",
         "Hello中文abc Ελληνικά ひらがなカタカナー 123!", "ﬁ ﬃ FFI fi ﬀi", "İstanbul i̇ I ı",
         "AbC_12 ٣٤ ½² x{1,2}", "\t x  y　z", "😀‍😀 🇩🇪 👩‍💻 é क्ष 한국어"]
POOL = [*"abcxyzABSKsk_-&.,;:!?'\"()[]{}<>/\\ \t\n\r012789", "ß", "ẞ", "ſ", "K", "é", "中文",
        "ひらがな", "カタカナ", "ー", "Ελλη", "данные", "العربية", "हिन्दी", "क्ष", "한국", "😀",
        "👩‍💻", "🇩🇪", "٣", "１２", "½", "　", "\xa0", "\x85", "\U0001E5D0", "Ᲊ", "ﬁ", "İ",
        "ǰ", "Σς"]
ANCHORS = (r"\b", r"\B", "^", "$", r"\A", r"\z", r"\Z", r"\K")


def expression(rng: random.Random, depth: int = 0) -> str:
    """A random alternation of sequences of quantified atoms."""
    def atom() -> str:
        if depth < 3 and rng.random() < 0.25:
            group = rng.choice(GROUPS)
            body = expression(rng, depth + 1)
            if group == "(?<g>" and rng.random() < 0.5:
                return f"{group}{body})" + rng.choice([r"\k<g>", r"\g<g>", "(?(<g>)a|b)"])
            return f"{group}{body})"
        return rng.choice(ATOMS)

    def sequence() -> str:
        out = []
        for _ in range(rng.randrange(1, 4)):
            a = atom()
            zero_width = a in ANCHORS or a.startswith(("(?=", "(?!", "(?<=", "(?<!"))
            out.append(a + ("" if zero_width else rng.choice(QUANTS)))
        return "".join(out)

    return "|".join(sequence() for _ in range(rng.randrange(1, 3)))


def library_pieces(pattern: str, text: str):
    """The library's pieces, or None where it gives up (its retry limit, a
    panic)."""
    import tokenizers

    split = tokenizers.pre_tokenizers.Split(tokenizers.Regex(pattern), "isolated")
    try:
        return [piece for piece, _ in split.pre_tokenize_str(text)]
    except BaseException as err:  # noqa: BLE001 - a Rust panic is not an Exception
        if "Panic" in type(err).__name__:
            return None
        raise


def port_pieces(pattern: str, text: str):
    """The port's pieces, or None where its matcher gives up."""
    from operator_tpu_torch.models.tokenization import text as port_text
    from operator_tpu_torch.models.tokenization.onig_match import RetryLimitError

    expression_ = port_text.translate_regex(pattern)
    try:
        return [piece for piece, _ in port_text.split(
            text, port_text.regex_matches(expression_, text), "Isolated")]
    except RetryLimitError:
        return None


def compare(pattern: str, texts: list) -> "tuple[str, str]":
    """(outcome, detail): ``same``, ``rejected`` (both), ``both_give_up``,
    ``library_gives_up`` (the port answers), or a disagreement."""
    import tokenizers

    from operator_tpu_torch.models.tokenization.onig import OnigurumaError

    try:
        tokenizers.pre_tokenizers.Split(tokenizers.Regex(pattern), "isolated")
        library_error = None
    except Exception as err:  # noqa: BLE001 - the library's error for a pattern it rejects
        library_error = str(err)
    try:
        port_text_engine(pattern)
    except OnigurumaError as err:
        return ("rejected", "") if library_error is not None else (
            "disagree", f"the port rejects ({err}), the library reads it")
    if library_error is not None:
        return "disagree", f"the library rejects ({library_error}), the port reads it"
    for text in texts:
        want = library_pieces(pattern, text)
        got = port_pieces(pattern, text)
        if want is None:
            # the first give-up decides (each takes the port seconds)
            return ("both_give_up" if got is None else "library_gives_up"), ""
        if got is None:
            return "disagree", f"on {text!r}: the port gives up, the library {want}"
        if got != want:
            return "disagree", f"on {text!r}: the library {want}, the port {got}"
    return "same", ""


def port_text_engine(pattern: str) -> str:
    """The engine the port routes ``pattern`` to (its rejection raises)."""
    from operator_tpu_torch.models.tokenization.onig import compile_expression

    return compile_expression(pattern).engine


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--count", type=int, default=300)
    args = parser.parse_args(argv)
    rng = random.Random(args.seed)
    texts = TEXTS + ["".join(rng.choice(POOL) for _ in range(rng.randrange(0, 25)))
                     for _ in range(40)]
    counts: dict = {}
    engines: dict = {}
    for _ in range(args.count):
        pattern = ("(?i)" if rng.random() < 0.15 else "") + expression(rng)
        outcome, detail = compare(pattern, texts)
        counts[outcome] = counts.get(outcome, 0) + 1
        if outcome != "rejected" and not detail.startswith("the "):
            engine = port_text_engine(pattern)
            engines[engine] = engines.get(engine, 0) + 1
        if outcome in ("disagree", "library_gives_up"):
            print(f"{outcome} {pattern!r}: {detail}"[:600])
    print(json.dumps({"seed": args.seed, "expressions": args.count, **counts,
                      "engines": engines}))
    return 1 if counts.get("disagree") else 0


if __name__ == "__main__":
    sys.exit(main())
