"""The port's Oniguruma and ``UnicodeScripts`` against the ``tokenizers`` library.

The port reads a ``tokenizer.json``'s expressions itself
(``operator_tpu_torch/models/tokenization/onig.py``) from the Unicode data
the library's Oniguruma and Rust tables hold
(``tokenization/unicode_tables.py``, written by
``scripts/torch_unicode_tables.py``).  Every comparison here is exact:

- one case per construct: the port's ``Split`` pieces equal the library's
  over a fixed corpus and seeded random text of many scripts and Unicode
  16.0's additions, through whichever engine the port routes the
  expression to (Python's ``re`` or its own matcher,
  ``tokenization/onig_match.py``) and through the matcher forced; an
  expression the library rejects is rejected with a ``ValueError`` (and
  ``load_tokenizer`` falls back to bytes, as the JAX package's does);
- the retry limit: where the library's search gives up
  (``retry-limit-in-match over``, a panic) the matcher raises
  :class:`~operator_tpu_torch.models.tokenization.onig_match.RetryLimitError`,
  and where the library answers the port answers;
- which engine an expression takes: the named families and the committed
  fixtures stay on ``re``;
- one case per property family: every accepted name on a seeded sample of
  code points, alone and in a class, and a few names on every code point;
- case folding, ``\\X`` and ``UnicodeScripts`` on every code point;
- the committed tables are what the generator writes.
"""

import importlib.util
import json
import os
import random
import sys

import pytest

tokenizers = pytest.importorskip("tokenizers")
pytest.importorskip("regex")
pytest.importorskip("fontTools")

from operator_tpu.models import tokenizer as jax_tokenizer  # noqa: E402
from operator_tpu_torch.models import tokenizer  # noqa: E402
from operator_tpu_torch.models.tokenization import onig, onig_match, pre_tokenizers  # noqa: E402
from operator_tpu_torch.models.tokenization import text as port_text  # noqa: E402
from operator_tpu_torch.models.tokenization import unicode_tables  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_unicode_tables", os.path.join(REPO, "scripts", "torch_unicode_tables.py"))
generator = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(generator)

ALL = generator.ALL
ALL_TEXT = generator._TEXT

CORPUS = [
    "", "ab&12cd", "ax\n", "xa\nby", "xSSy ß ẞ ſs sß", "ab́ ab", "a\r\nb\n\nc\rd\x85e ",
    "Hello中文abc Ελληνικά ひらがなカタカナー 123!", "ﬁ ﬃ FFI fi ﬀi", "İstanbul i̇ I ı",
    "AbC_12 ٣٤ ½² x{1,2}", "\t x  y　z", "😀‍😀 🇩🇪🇫🇷 👩‍💻 é क्ष 한국어 각",
    "aaa bbb", "ǰ J̌ ǅ Ǆ", "Kelvin K k", "ΣΑΣ σας ς", "don't I'M we'LL 'Re",
]
#: the pieces random texts are drawn from: several scripts, case
#: foldings, line breaks, and characters Unicode 16.0 assigned
POOL = [*"abcxyzABSKsk_-&.,;:!?'\"()[]{}<>/\\ \t\n\r012789", "ß", "ẞ", "ſ", "K", "é",
        "é", "中文", "ひらがな", "カタカナ", "ー", "Ελλη", "данные", "العربية", "हिन्दी", "क्ष",
        "ไทย", "한국", "😀", "👩‍💻", "🇩🇪", "٣", "४", "１２", "½", " ", "　", "\xa0", "\x85",
        "͸", "\U0001E5D0", "\U00010D40", "Ᲊ", "Ɤ", "\U00016EA0", "\U0001CC00",
        "ࢗ", "\U00011F5A", "ﬁ", "ﬃ", "İ", "ǰ", "ǅ", "Σς", " ", "\r\n"]


def texts(seed: int, n: int = 60) -> list:
    rng = random.Random(seed)
    return CORPUS + ["".join(rng.choice(POOL) for _ in range(rng.randrange(0, 25)))
                     for _ in range(n)]


def library_pieces(pattern: str, text: str) -> list:
    split = tokenizers.pre_tokenizers.Split(tokenizers.Regex(pattern), "isolated")
    return [piece for piece, _ in split.pre_tokenize_str(text)]


def port_pieces(pattern: str, text: str, matcher: bool = False) -> list:
    expression = (onig_match.compile_matcher if matcher else onig.compile_expression)(pattern)
    return [piece for piece, _ in port_text.split(
        text, port_text.regex_matches(expression, text), "Isolated")]


def library_reads(pattern: str) -> bool:
    try:
        tokenizers.pre_tokenizers.Split(tokenizers.Regex(pattern), "isolated")
    except Exception:  # noqa: BLE001 - the library's error for a pattern it rejects
        return False
    return True


# ---------------------------------------------------------------------------
# constructs
# ---------------------------------------------------------------------------

#: name -> (pattern, texts it must be tried on besides the corpus); the
#: ``fault_`` cases are the translator's faults before Oniguruma's syntax
#: was read as such (and before the look-behind's ``\\R`` and the search's
#: start anchor were read as Oniguruma runs them)
CONSTRUCTS = {
    # faults: each read differently before
    "fault_class_intersection": (r"[\w&&\D]+", ["ab&12cd"]),
    "fault_end_before_final_newline": (r"x\Z", ["ax\n", "ax", "ax\n\n"]),
    "fault_m_is_dot_all": (r"(?m)a.b", ["xa\nby"]),
    "fault_full_case_folding": (r"(?i)ß", ["xSSy", "ſs", "ẞ"]),
    "fault_word_boundary_marks": (r"\bab\b", ["ab́ ab"]),
    "fault_lowercase_names": (r"\p{l}", ["ab1"]),
    "fault_long_names": (r"\p{letter}+", ["ab1 é"]),
    # faults of the look-behind's \R and the search's start anchor
    "fault_lookbehind_newline_tail": (r"(?<=\R)c|(?<=x\R)d|(?<=\R\R)e|(?<=\R{1,2})f",
                                      ["\r\nc \nc \rc x\nd x\r\nd \n\r\ne \r\n\ne \nf \r\nf"]),
    "fault_lookbehind_newline_atomic": (r"(?<=\R\n)c|(?<=\Rx)d|(?<=\r\R)e",
                                        ["\n\nc \r\nc \r\n\nc \nxd \r\nxd \r\re \r\r\ne"]),
    "fault_lookbehind_newline_negative": (r"(?<!\R)c|(?<!\R|ab)d|(?<!\R\b)e",
                                          ["\nc \r\nc c \nd abd \r\nd \ne \r\ne"]),
    "fault_lookbehind_divided": (r"(?<=\R|a)c|(?<=a|\R)d|(?<=\R|\Ra)e|(?<=(?:\R|a))f"
                                 r"|(?<=(\R|b))g|(?<!(?:\R|a)|xa\n)h",
                                 ["\nc ac \r\nc \nd \ne \nf af \ng x\nh \r\nh xa\nh"]),
    "fault_lookbehind_word_boundary_at_start": (r"(?<=\b|ab?)c", ["c cc c\nc abc"]),
    "fault_search_anchor_end_word": (r"$\b\O+", ["ax\n", "ab\ncd"]),
    "fault_search_anchor_word_line": (r"\b^\O+", ["-x\nby", "\nab"]),
    "fault_search_anchor_lookahead": (r"(?=x)\O+", ["-x", "ax\n", "xy"]),
    "fault_search_anchor_icase_repeat": (r"(?i)\b^\O{2,}", ["-x\nby", "\nab"]),
    "fault_search_anchor_two_starts": (r"\b\O+", ["--x", "-x\nby", "-\nab"]),
    "fault_search_anchor_class_lookahead": (r"(?=[xy])\O+", ["-xyz", "-ax"]),
    "fault_search_anchor_word_lookahead": (r"(?=\w)\O+", ["-ax", "--x"]),
    "fault_search_anchor_lines": (r"\b.*x", ["-ax", "-a\nbx", "--x\nx"]),
    "fault_search_anchor_alternatives": (r"(?<=a)\O{2,}\w|(?=-)(?<!a)\O+", ["xb- b", "\n\nx -"]),
    "search_anchor_lookbehind_keeps": (r"(?<=a)\O+", ["-\nab", "xa\nb"]),
    "search_anchor_end_keeps": (r"\b\O*\z|\b.*x(?!y)", ["--x\nx", "--x\nxy"]),
    "search_anchor_lazy_keeps": (r"\b\O+?|(?m:.)+", ["--x\nx"]),
    "fault_lowercase_short_names": (r"\p{lu}", ["aB1"]),
    "fault_dashed_names": (r"\p{uppercase-letter}", ["aB"]),
    "fault_spaced_names": (r"\p{Upper case letter}", ["aB"]),
    "fault_nested_negated_class": (r"[a-z&&[^aeiou]]+", ["abcde"]),
    "fault_posix_bracket": (r"[[:alpha:]]+", ["a1b"]),
    "fault_hex_braces": (r"\x{41}", ["xAy"]),
    "fault_general_newline": (r"\R", ["a\r\nb\x85c "]),
    "fault_grapheme_cluster": (r"\X", ["éx 👩‍💻 🇩🇪🇫🇷 한"]),
    "grapheme_cluster_started_inside": (r"\P{Lu}{,2}\X|\x{1F1E9}\X|\p{Emoji}\X", [
        "y\U0001F469\u200d\U0001F4BB \U0001F1E9\U0001F1EA\U0001F1EB\U0001F1F7\U0001F1EE"
        "\U0001F1F9 x\U0001F1E9\U0001F1EA\U0001F1EB \U0001F469\U0001F3FD\u200d\U0001F4BB"]),
    "fault_keep": (r"a\Kb", ["ab aab"]),
    "fault_any_with_newline": (r"\O", ["a\nb"]),
    "fault_search_start": (r"\Ga", ["aab", "baa"]),
    "fault_control": (r"\cA", ["x\x01y"]),
    # property names
    "script_class": (r"\p{Han}+", ["abc中文def"]),
    "script_short_name": (r"\p{Grek}+|\p{Cyrl}+", ["Ωμέγα данные"]),
    "script_common_inherited": (r"\p{Common}+|\p{Zinh}+", ["a 1!́"]),
    "block": (r"\p{In_Basic_Latin}+|\p{InCJKUnifiedIdeographs}+", ["aé中"]),
    "binary_property": (r"\p{Emoji}+|\p{White_Space}|\p{Extended_Pictographic}", ["a😀 1"]),
    "posix_name": (r"\p{Alnum}+|\p{Punct}+|\p{Word}", ["a_1 $!"]),
    "negated_names": (r"\p{^L}+|\P{^N}+", ["a1b2"]),
    "negated_names_in_class": (r"[\p{^L}\P{N}x]+", ["a1b2x"]),
    "any_assigned_unassigned": (r"\p{Assigned}+|\p{Cn}", ["a͸b"]),
    # classes
    "class_escapes": (r"[\w]+|[\W]+|[\s\d]+|\h+|\H", ["a_b 12 ff"]),
    "class_nested_union": (r"[a[bc][^\d\s]]+", ["abc1 d"]),
    "class_intersection_three": (r"[a-z&&b-y&&[^c]]+", ["abcd"]),
    "class_negated_intersection": (r"[^a-z&&[^aeiou]]+", ["ab1e"]),
    "class_posix_negated": (r"[[:^alpha:]]+|[[:punct:][:space:]]+", ["a1 !b"]),
    "class_posix_intersection": (r"[[:^space:]&&[:^punct:]]+", ["a! b"]),
    "class_leading_bracket": (r"[]a]+|[^]a]", ["a]b"]),
    "class_dashes": (r"[a-]+|[-b]|[c-e-0]", ["a-b-0d"]),
    "class_escaped_range": (r"[\x41-\x{5a}a-\o{172}]+", ["AZaz09"]),
    "class_code_point_list": (r"[\x{41 42}]+", ["AB"]),
    "class_backspace_octal": (r"[\b\101]", ["\bA"]),
    # anchors and options
    "line_anchors": (r"^a|b$", ["a\nab\nb"]),
    "line_start_not_at_the_end": (r"\n^|^\n|\n$", ["a\n", "a\nb", "a\n\n"]),
    "string_anchors": (r"\A\w|\w\z", ["ab\ncd"]),
    "end_before_newline": (r"\Z", ["ab\n"]),
    "non_word_boundary": (r"\B\w", ["abc de"]),
    "ascii_word_option": (r"(?W)\w+|(?W)\b", ["aé_ b"]),
    "ascii_digit_space_options": (r"(?D)\d+|(?S)\s+", ["1٣ \x85"]),
    "ascii_posix_option": (r"(?P)[[:alpha:]]+|(?P)\p{Alpha}", ["aé"]),
    "ascii_option_leaves_other_names": (r"(?P)\p{Alphabetic}+", ["aé"]),
    "option_scope": (r"a(?i)b|c", ["c ac aB"]),
    "option_group": (r"(?i:A)b|(?i)a(?-i)b", ["ab Ab AB"]),
    "extended": (r"(?x) a b # comment", ["ab a b"]),
    "extended_class_and_escape": (r"(?x)[ a]\ b", ["  b a b"]),
    "not_newline": (r"\N+|.+|(?m:.)", ["a\nb"]),
    "comment_group": (r"a(?#c)b", ["ab"]),
    # case folding
    "icase_class": (r"(?i)[a-z]+", ["K K ſ"]),
    "icase_negated_class": (r"(?i)[^a-z]+", ["KaB1"]),
    "icase_run": (r"(?i)ss", ["ßs sß SS"]),
    "icase_run_of_three": (r"(?i)sss", ["ßs sß"]),
    "icase_ligature": (r"(?i)ﬃ|(?i)ffi", ["ffi FFI ﬀi fﬁ ﬃ"]),
    "icase_dotted_capital": (r"(?i)İ|(?i)i", ["i̇ İ i I ı"]),
    "icase_class_multi": (r"(?i)[ß]|(?i)[^ß]", ["ss SS ſs ẞ"]),
    "icase_greek": (r"(?i)σ+|(?i)ΐ", ["ΣΑΣ σας ς ΐ ΐ"]),
    "icase_contractions": (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)", ["don't I'M we'LL 'Re"]),
    "icase_names_not_folded": (r"(?i)\p{Lu}|(?i)[\p{Lu}]", ["aB"]),
    "icase_group_breaks_run": (r"(?i)(s)s|(?i)s(?i:s)|(?i)(?:s)s", ["ß"]),
    # escapes
    "escapes_controls": (r"\e\a\v|\t\n\r\f", ["\x1b\x07\x0b \t\n\r\x0c"]),
    "escapes_octal_bytes": (r"\101\0|\303\251", ["A\x00 é"]),
    "escapes_hex_bytes": (r"\xC3\xA9|\x41", ["éA"]),
    "escapes_meta_control": (r"\M-a|\c?|\C-a", ["á\x7f\x01"]),
    "escapes_unicode": (r"A\o{102}", ["AB"]),
    "escapes_unknown_letter": (r"\q\Q", ["qQ"]),
    "escapes_out_of_range": (r"\x{110000}|a", ["a"]),
    # groups and repeats
    "named_backref": (r"(?<n>a)\k<n>|(?'m'b)\k'm'", ["aa bb"]),
    "numbered_backrefs": (r"(a)\1|(b)\k<-1>|(c)\k<3>", ["aa bb cc"]),
    "conditional_numbered": (r"(x)?(?(1)c|d)", ["xc d c"]),
    "conditional_named": (r"(?<n>x)?(?(<n>)c|d)", ["xc d c"]),
    "conditional_expression": (r"(?(a)b|c)", ["ab b c ac"]),
    "call_inlined": (r"(?<x>a|b)\g<x>", ["ab ba cc"]),
    "call_numbered": (r"(c|d)\g<1>", ["cd dd cc"]),
    "call_relative": (r"(a)\g<-1>", ["aa"]),
    "call_before_group": (r"\g<x>(?<x>[ab])", ["ab ba"]),
    "lookarounds": (r"(?=a)\w|(?!a)\w|(?<=a)b|(?<!a)c", ["ab ac bc"]),
    "lookbehind_widths": (r"(?<=a|bc)d|(?<!x|yz)w|(?<=ab?)c|(?<=a{1,3})e", ["ad bcd yzw xw aw ac abc ae"]),
    "lookbehind_newline": (r"(?<=\R)a", ["\r\na"]),
    "lookbehind_nested": (r"(?<!(?<=a)b)c|(?<=(?<=a)b)d|(?<!(?<!a)b)e", ["abc xbc abd abe xbe"]),
    "plain_group_in_negative_lookbehind_beside_names": (r"(?<n>a)(?<!(b))c", ["ac abc"]),
    "lookbehind_optional_parts": (r"(?<=x?y?z)c|(?<=a?bc?)d|(?<=a?\b)e", ["xyzc zc abd bd d e"]),
    "atomic_possessive": (r"(?>a+)a|a++b|a*+c|a?+d", ["aaa aab aac ad"]),
    "lazy": (r"a{2,3}?|b*?c|d??", ["aaaa bbc d"]),
    "fixed_repeat_then_optional": (r"xa{2}?", ["x xaa"]),
    "reversed_interval_is_possessive": (r"a{3,1}a|b{3,1}", ["aaa bbbb"]),
    "interval_forms": (r"a{,2}|b{2,}|c{2}", ["aaa bbb cc"]),
    "nested_repeats": (r"a**|b+?+|x{2}{3}|y+{2}|c{1,2}{2}", ["aaa bbb xxxxxx yyy cccc"]),
    "interval_as_literal": (r"a{|b{1,2|c{,}|d{1, 2}", ["a{ b{1,2 c{,} d{1, 2}"]),
    "fail_callout": (r"(*FAIL)|a", ["a"]),
    "grapheme_option": (r"(?y{g})\X", ["éx"]),
    "llama3": (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+"
               r"[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+", []),
    "gpt2": (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+", []),
    "o200k": (r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
              r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+"
              r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?|\p{N}{1,3}"
              r"| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+", []),
    "deepseek_cjk": (r"[一-龥぀-ゟ゠-ヿ]+|[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~][A-Za-z]+"
                     r"|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+| ?[\p{P}\p{S}]+[\r\n]*", []),
    "bloom": (r" ?[^(\s|[.,!?…。，、।۔،])]+", []),
    # what Python's re cannot express, matched by the port's own matcher
    "recursive_call": (r"(?<x>a|\(\g<x>\))", ["((a)) (a (((a)))"]),
    "absent_operator": (r"(?~ab)", ["xab xaab abab"]),
    "segment_boundary": (r"\y", ["éa👩‍💻b 🇩🇪🇫🇷 한국어"]),
    "segment_inside": (r"\Y", ["éa👩‍💻b"]),
    "callout": (r"(*SKIP)a", ["bab"]),
    "cluster_lookbehind": (r"(?<=\X)a", ["éa a 👩‍💻a"]),
    "unbounded_lookbehind": (r"(?<=a+)b", ["aab b cab"]),
    "search_start_inside": (r"a\Gb", ["ab bab"]),
    "icase_backref": (r"(?i)(ß)\1", ["ßss ßß SSß ẞß"]),
    "several_groups_one_name": (r"(?<x>a)|(?<x>b)\k<x>", ["ab bb ba"]),
    "counted_repeat_of_empty": (r"(?:\h?|\w*){2}\P{Lu}", ["abZ 12x"]),
    "call_balanced_brackets": (r"(?<p>\((?:[^()]|\g<p>)*\))", ["f(a(b)c) g((x)"]),
    "call_sets_its_capture": (r"(?<x>a|b)\g<x>\k<x>", ["aba abb aab bab baa"]),
    "call_conditional_inside": (r"(?<x>(?(<x>)b|c))\g<x>", ["cb cc"]),
    "call_referenced_recursive": (r"(?<p>a\g<p>?b)\k<p>", ["aabbaabb aabbab abab"]),
    "call_whole_pattern": (r"\((?:[^()]|\g<0>)*\)", ["f(a(b)c) ((x)"]),
    "backref_level_palindrome": (r"\A(?<a>|.|(?:(?<b>.)\g<a>\k<b+0>))\z",
                                 ["abba", "abcba", "abca", "a"]),
    "backref_level_same": (r"(?<a>x)\k<a+0>|(?<b>y)\k<b-1>", ["xx x yy"]),
    "backref_level_in_call": (r"(?<n>a|b\g<n>c)\k<n+0>", ["aa bacba bbaccbbacc"]),
    "backref_icase_ligature": (r"(?i)(ﬃ)\1|(?i)(ss)\2", ["ﬃffi ﬃﬃ ssß ßß SSß ssSS"]),
    "backref_icase_scope": (r"(k)(?i)\1|(?i:(s))\2", ["kK KK kk sS ss"]),
    "backref_shared_name_order": (r"(?<x>a)(?<x>ab)\k<x>|(?<x>c)x(?<x>ddd)\k<x>",
                                  ["aababz aabaz cxdddc"]),
    "absent_comment": (r"/\*(?~\*/)\*/", ["a /* b */ c */"]),
    "absent_expression": (r"(?~|ab|\w+)|(?~|a|b|c)", ["xxabyy zz xcab"]),
    "absent_stopper_and_clear": (r"(?~|ab)\w+(?~|)\w*|(?~|)", ["xxabyy"]),
    "segment_word_mode": (r"(?y{w})\X", ["can't 3.14 e.g. über-cool", "a1_b ア・イ 'x' x\"y\" 🇩🇪🇫🇷"]),
    "segment_word_boundary": (r"(?y{w})\y", ["can't 3.14 e.g. über-cool"]),
    "segment_word_inside": (r"(?y{w})\Y.", ["can't 3.14 e.g. über-cool"]),
    "lookbehind_unbounded_class": (r"(?<=[=:]\s*)\w+", ["k= v a:b AAa"]),
    "lookbehind_captures": (r"(?<=(aa|a))b\1|(?<=(a+))c\2", ["aaba aabaa aacaa"]),
    "lookbehind_icase_single": (r"(?<=(?i)ß)x|(?<=(?i)ss)y", ["ssx SSx ßx ẞx ßy SSy"]),
    "lookbehind_negative_unbounded": (r"(?<!a+)b|(?<!\X)c", ["aab b cb c"]),
    "search_start_anywhere": (r"\Gb|a|(?:\Gc)+", ["bab abb bb ccac"]),
    "keep_in_lookaround": (r"(?=a\Kb)\w|(?<=\Kc)d|e(?=f\K)", ["ab ab cd ef"]),
    "callout_skip": (r"xa+(*SKIP)c|ab", ["xaab ab", "xaaab yab"]),
    "callout_mismatch_error": (r"a(*MISMATCH)|a|b(*ERROR{-1})|b", ["a aa bb"]),
    "callout_max": (r"(?:a|ab)(*MAX{1})c|(?:d|de)(*MAX{1,>})f|(?:(*MAX{2})g)+", ["abc def gggg"]),
    "callout_count_cmp": (r"(?:a(*COUNT[x]))+(*CMP{x,==,2})|(?:b(*TOTAL_COUNT[y]))+"
                          r"(*CMP{y,<=,3})", ["aaa aa a bbb bb b"]),
    "callout_code": (r"(?{foo})a|(?{{b}}[t]X)b", ["ab"]),
    "repeat_of_empty_rounds": (r"(?:|a){2}x|(?:a*|b){2,}c", ["ax aax x abc bbc ac"]),
    "nested_repeat_reduced": (r"(?:a+)+b|(?:c*)*d|(?:e?)??f", ["aab cd ef f"]),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTS))
def test_a_construct_splits_as_the_library_splits(name):
    pattern, own = CONSTRUCTS[name]
    assert library_reads(pattern)
    for text in own + texts(len(name)):
        assert port_pieces(pattern, text) == library_pieces(pattern, text), (pattern, text)


@pytest.mark.parametrize("name", sorted(CONSTRUCTS))
def test_the_matcher_splits_every_construct_as_the_library(name):
    """The port's own matcher, forced whatever the routing says, holds to
    the library on every construct case."""
    pattern, own = CONSTRUCTS[name]
    assert onig_match.compile_matcher(pattern).engine == "matcher"
    for text in own + texts(len(name)):
        assert port_pieces(pattern, text, matcher=True) == library_pieces(pattern, text), (
            pattern, text)


#: the families the repo names: ``re`` runs them in linear time, so they
#: never pay for the matcher
FAMILIES_ON_RE = ("gpt2", "llama3", "o200k", "deepseek_cjk", "bloom")
#: expressions the matcher takes: constructs ``re`` cannot express, and
#: exponential ambiguity (a repeat of a body that matches one text two ways)
TO_MATCHER = {
    "nested_unbounded_repeat": r"(\w+\s?)*$",
    "overlapping_alternatives": r"(a|a)*b",
    "repeat_of_repeats": r"(?:x+x+)+y",
    "recursive_call": CONSTRUCTS["recursive_call"][0],
    "absent_operator": CONSTRUCTS["absent_operator"][0],
    "icase_backref": CONSTRUCTS["icase_backref"][0],
}
#: ambiguity that is only polynomial, and possessive or atomic nesting, stay
#: on re
TO_RE = {
    "adjacent_overlapping_repeats": r"\s*[\r\n]+",
    "possessive_inner_repeat": r"(?:\w++\s?)*$",
    "atomic_body": r"(?>a|a)*b",
    "disjoint_alternatives": r"(?:a|b)*c",
}


def _fixture_expressions() -> dict:
    """Every ``Regex`` pattern of the committed ``tokenizer.json`` files."""
    out = {}
    root = os.path.join(REPO, "tests", "torch_tokenizers")
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name, "tokenizer.json")
        if not os.path.exists(path):
            continue
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        for i, pattern in enumerate(sorted(set(
                m for m in _regexes(json.loads(text))))):
            out[f"{name}_{i}"] = pattern
    return out


def _regexes(spec):
    if isinstance(spec, dict):
        if isinstance(spec.get("pattern"), dict) and "Regex" in spec["pattern"]:
            yield spec["pattern"]["Regex"]
        for value in spec.values():
            yield from _regexes(value)
    elif isinstance(spec, list):
        for value in spec:
            yield from _regexes(value)


FIXTURES_ON_RE = {name: p for name, p in _fixture_expressions().items()
                  if not name.startswith("onig_logs")}


@pytest.mark.parametrize("name", sorted(
    [f"family_{n}" for n in FAMILIES_ON_RE] + [f"fixture_{n}" for n in FIXTURES_ON_RE]
    + [f"re_{n}" for n in TO_RE] + [f"matcher_{n}" for n in TO_MATCHER]))
def test_an_expression_takes_re_unless_only_the_matcher_runs_it(name):
    """The five named families, the committed fixtures' expressions and
    polynomial ambiguity stay on Python's ``re`` (their encode costs
    microseconds); a construct ``re`` cannot express, or exponential
    ambiguity, takes the matcher."""
    kind, _, key = name.partition("_")
    pattern = {"family": lambda k: CONSTRUCTS[k][0], "fixture": FIXTURES_ON_RE.get,
               "re": TO_RE.get, "matcher": TO_MATCHER.get}[kind](key)
    assert library_reads(pattern)
    want = "matcher" if kind == "matcher" else "re"
    assert onig.compile_expression(pattern).engine == want, pattern
    assert onig_match.compile_matcher(pattern).engine == "matcher"


# ---------------------------------------------------------------------------
# the retry limit
# ---------------------------------------------------------------------------


def _library_gives_up(pattern: str, text: str) -> bool:
    try:
        library_pieces(pattern, text)
    except BaseException as err:  # noqa: BLE001 - the library panics (not an Exception)
        assert "retry-limit-in-match over" in str(err) or "Panic" in type(err).__name__
        return True
    return False


#: (pattern, text of size n, the n at which the library first gives up):
#: the count grows 8 times a word and 2 times a letter, so one n apart
#: the library answers (at n - 1) and gives up (at n)
GIVE_UP = {
    "words": (r"\A(\w+\s?)*$", lambda n: "word " * n + "!", 7),
    "letters": (r"\A(a|a)*$", lambda n: "a" * n + "!", 22),
}


@pytest.mark.parametrize("name", sorted(GIVE_UP))
def test_the_matcher_gives_up_where_the_library_gives_up(name):
    """One n below the library's first panic both answer alike; at it, the
    port raises ``RetryLimitError`` where the library panics (the n at
    which each first gives up is in PERF.md)."""
    pattern, make, n = GIVE_UP[name]
    assert onig.compile_expression(pattern).engine == "matcher"
    assert not _library_gives_up(pattern, make(n - 1))
    assert port_pieces(pattern, make(n - 1)) == library_pieces(pattern, make(n - 1))
    assert _library_gives_up(pattern, make(n))
    with pytest.raises(onig_match.RetryLimitError, match="retry-limit-in-match over"):
        port_pieces(pattern, make(n))


def test_a_nested_repeat_gives_up_in_bounded_time_where_re_ran_on():
    """``(\\w+\\s?)*$`` on fifteen words and a ``!``: the library panics
    at once; Python's ``re`` backtracked here for longer than anyone waits
    (still running after 75 s at eight words), the matcher gives up at its
    retry limit."""
    pattern, text = r"(\w+\s?)*$", "word " * 15 + "!"
    assert _library_gives_up(pattern, text)
    expression = onig.compile_expression(pattern)
    assert expression.engine == "matcher"
    with pytest.raises(onig_match.RetryLimitError):
        list(port_text.find_iter(expression, text))
    assert issubclass(onig_match.RetryLimitError, BaseException)
    assert not issubclass(onig_match.RetryLimitError, Exception)


#: expressions the library rejects, each with the library's message
REJECTED = {
    "ampersand_category": (r"\p{L&}", "invalid character property name"),
    "script_equals": (r"\p{Script=Greek}", "invalid character property name"),
    "katakana_or_hiragana": (r"\p{Katakana_Or_Hiragana}", "invalid character property name"),
    "is_prefix": (r"\p{IsGreek}", "invalid character property name"),
    "s_option": (r"(?s)a.b", "undefined group option"),
    "ascii_option": (r"(?a)\w", "undefined group option"),
    "perl_named_group": (r"(?P<n>a)", "undefined group option"),
    "numbered_ref_beside_names": (r"(a)(?<n>b)\1", "numbered backref/call is not allowed"),
    "numbered_call_beside_names": (r"(?<x>a)(c)\g<2>", "numbered backref/call is not allowed"),
    "missing_backref": (r"\8", "invalid backref number/name"),
    "name_before_its_group": (r"\k<x>(?<x>a)", "undefined name <x> reference"),
    "whole_pattern_call": (r"\g<0>", "never ending recursion"),
    "empty_class": (r"[]", "empty char-class"),
    "empty_range": (r"[b-a]", "empty range in char class"),
    "set_at_range_end": (r"[a-\w]", "char-class value at end of range"),
    "set_at_range_start": (r"[\w-z]", "unmatched range specifier in char-class"),
    "posix_name": (r"[[:foo:]]", "invalid POSIX bracket type"),
    "repeat_without_target": (r"*a", "target of repeat operator is not specified"),
    "interval_without_target": (r"{2}", "target of repeat operator is not specified"),
    "repeated_anchor": (r"\b+a", "target of repeat operator is invalid"),
    "repeated_lookahead": (r"(?=a)*a", "target of repeat operator is invalid"),
    "lookahead_in_lookbehind": (r"(?<=a(?=b))b", "invalid pattern in look-behind"),
    "capture_in_negative_lookbehind": (r"(?<!(a))b", "invalid pattern in look-behind"),
    "end_in_lookbehind": (r"(?<=a\Z)b", "invalid pattern in look-behind"),
    "negative_in_positive_lookbehind": (r"(?<=(?<!a)b)c", "invalid pattern in look-behind"),
    "optional_parts_in_lookbehind": (r"(?<=a?b*)c", "undefined error code"),
    "call_of_a_shared_name": (r"(?<g>a)\g<g>|(?<g>b)", "multiplex definition name <g> call"),
    "repeated_anchor_group": (r"(?:\b|a)?", "target of repeat operator is invalid"),
    "huge_repeat": (r"a{100001}", "too big number for repeat range"),
    "short_utf8": (r"\xE1", "too short multibyte code string"),
    "continuation_byte": (r"\x80", "invalid code point value"),
    "short_unicode_escape": (r"\u41", "invalid code point value"),
    "control_at_end": (r"\c", "end pattern at control"),
    "unclosed_property": (r"\p{L", "end pattern with unmatched parenthesis"),
    "empty_property": (r"\p{}", "invalid character property name"),
    "unknown_callout": (r"(*b)", "undefined callout name"),
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_an_expression_the_library_rejects_is_rejected(name):
    pattern, message = REJECTED[name]
    assert not library_reads(pattern)
    with pytest.raises(onig.OnigurumaError, match=message.replace("(", r"\(")):
        port_text.translate_regex(pattern)


def _word_level(directory, pattern: str) -> str:
    """A small ``tokenizer.json`` (WordLevel) split by ``pattern``."""
    directory.mkdir()
    spec = {"version": "1.0", "added_tokens": [], "normalizer": None, "post_processor": None,
            "decoder": None, "pre_tokenizer": {
                "type": "Split", "pattern": {"Regex": pattern}, "behavior": "Isolated",
                "invert": False},
            "model": {"type": "WordLevel", "vocab": {"<unk>": 0, "a": 1, "b": 2, "ab": 3},
                      "unk_token": "<unk>"}}
    (directory / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
    (directory / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>"}), encoding="utf-8")
    return str(directory)


@pytest.mark.parametrize("pattern", [r"\p{L&}+", r"(?s)a.b", r"\p{Katakana_Or_Hiragana}"])
def test_a_rejected_expression_makes_load_tokenizer_fall_back_to_bytes(tmp_path, pattern):
    """The library rejects the expression, so the JAX package's
    ``AutoTokenizer`` fails and its ``load_tokenizer`` serves bytes: the
    port's does the same."""
    path = _word_level(tmp_path / "rejected", pattern)
    assert type(jax_tokenizer.load_tokenizer(path)).__name__ == "ByteTokenizer"
    assert type(tokenizer.load_tokenizer(path)).__name__ == "ByteTokenizer"
    with pytest.raises(ValueError):
        tokenizer.HFTokenizer(path)


def test_every_construct_the_library_reads_is_served_by_load_tokenizer(tmp_path):
    """No expression of the construct cases falls back to bytes: each
    gives the ids the JAX package's tokenizer gives."""
    for name, (pattern, own) in sorted(CONSTRUCTS.items()):
        path = _word_level(tmp_path / name, pattern)
        got, want = tokenizer.load_tokenizer(path), jax_tokenizer.load_tokenizer(path)
        assert type(got).__name__ == type(want).__name__ == "HFTokenizer", name
        for text in own + CORPUS:
            assert got.encode(text, add_bos=False) == want.encode(text, add_bos=False), name


# ---------------------------------------------------------------------------
# property families
# ---------------------------------------------------------------------------


def _families() -> dict:
    import regex
    from fontTools.unicodedata import Blocks, Scripts

    props = regex._regex.get_properties()
    yes_no = props["ALPHABETIC"][1]
    norm = generator.normalize
    accepted = set(unicode_tables.PROPERTIES)
    families = {
        "general_category": {norm(n) for n in props["GENERALCATEGORY"][1]},
        "script_long": {norm(n) for n in Scripts.NAMES.values()},
        "script_short": {norm(n) for n in Scripts.NAMES},
        "script_alias": {norm(n) for n in props["SCRIPT"][1]},
        "block": {norm("In_" + b) for b in props["BLOCK"][1]}
        | {norm("In_" + b) for b in Blocks.VALUES},
        "binary": {norm(k) for k, (_, v) in props.items() if v == yes_no},
        "posix": {norm(n) for n in (*generator.POSIX, "Any", "Assigned")},
    }
    return {name: sorted(names & accepted) for name, names in families.items()}


FAMILIES = _families()
SAMPLE = sorted(random.Random(5).sample(ALL, 3000) + list(range(0, 0x100)))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_name_of_a_family_matches_as_the_librarys(family):
    """Each accepted name, alone and in a class and negated, on a seeded
    sample of code points (Latin-1 whole, where a name alone reads its own
    table)."""
    names = FAMILIES[family]
    assert names
    text = "".join(map(chr, SAMPLE))
    for name in names:
        for pattern in (f"\\p{{{name}}}", f"[\\p{{{name}}}]", f"\\P{{{name}}}"):
            got = {a for a, _ in port_text.find_iter(port_text.translate_regex(pattern), text)}
            want = {a for a, _ in generator.matched_spans(pattern, text)}
            assert got == want, (pattern, sorted(map(hex, {ord(text[i]) for i in got ^ want}))[:8])


def test_every_accepted_name_is_in_the_table():
    """The names the library accepts among the candidates are the table's."""
    accepted = {generator.normalize(n) for n in generator.candidate_names()
                if generator._compiles(f"\\p{{{n}}}")}
    assert accepted == set(unicode_tables.PROPERTIES)


@pytest.mark.parametrize("pattern", [r"\p{Han}", r"\p{Latin}", r"[[:punct:]]", r"\p{Emoji}"])
def test_a_name_matches_as_the_librarys_on_every_code_point(pattern):
    got = {a for a, _ in port_text.find_iter(port_text.translate_regex(pattern), ALL_TEXT)}
    want = {a for a, _ in generator.matched_spans(pattern, ALL_TEXT)}
    assert got == want


def test_case_folding_matches_the_librarys():
    """``(?i)`` and one character, on every character that folds (a seeded
    sample of them as patterns), the texts each one character and the
    spellings of those that fold to several."""
    cased = sorted({c for group in unicode_tables.CASE_CLASSES for c in group}
                   | set(unicode_tables.MULTI_FOLDS))
    text = "\0".join(map(chr, cased)) + "\0" + "\0".join(
        fold for fold in unicode_tables.MULTI_FOLDS.values())
    upper = "\0".join(f.upper() for f in unicode_tables.MULTI_FOLDS.values())
    for c in random.Random(3).sample(cased, 250) + list(unicode_tables.MULTI_FOLDS):
        pattern = f"(?i)\\x{{{c:X}}}"
        for t in (text, upper):
            got = list(port_text.find_iter(port_text.translate_regex(pattern), t))
            assert got == generator.matched_spans(pattern, t), hex(c)


def test_grapheme_clusters_match_the_librarys_on_every_code_point():
    """``\\X`` over every code point in order, and over seeded texts."""
    for text in [ALL_TEXT] + texts(11, 100):
        assert port_pieces(r"\X", text) == library_pieces(r"\X", text)


# ---------------------------------------------------------------------------
# UnicodeScripts
# ---------------------------------------------------------------------------


def _library_scripts(text: str) -> list:
    return [p for p, _ in tokenizers.pre_tokenizers.UnicodeScripts().pre_tokenize_str(text)]


def _port_scripts(text: str) -> list:
    return [p for p, _ in pre_tokenizers.script_pieces(text)]


@pytest.mark.parametrize("order", ["in_order", "shuffled", "texts"])
def test_unicode_scripts_splits_as_the_library(order):
    """Every code point in order, in a seeded shuffle, and texts of many
    scripts (leading spaces, lone spaces, Hiragana and Katakana as Han)."""
    if order == "texts":
        cases = texts(13, 300) + [" abc", "  abc", "a  b", "中 文", " ", "1 a", "ー中a", "ひらカタ漢"]
    else:
        points = list(ALL)
        if order == "shuffled":
            random.Random(17).shuffle(points)
        cases = ["".join(map(chr, points[i:i + 50000])) for i in range(0, len(points), 50000)]
    for text in cases:
        assert _port_scripts(text) == _library_scripts(text)


# ---------------------------------------------------------------------------
# the committed tables
# ---------------------------------------------------------------------------


def _committed() -> dict:
    """The committed module's tables, decoded as the generator builds them."""
    t = unicode_tables

    def points(encoded):
        return frozenset(c for lo, hi in onig.decode(encoded) for c in range(lo, hi + 1)
                         if not 0xD800 <= c < 0xE000)

    with open(generator.OUT, encoding="utf-8") as fh:
        source = fh.read()
    agree = "equal on every code point" if "are\n  equal on" in source else \
        "not equal, so both are kept"
    return {
        "header": {"tokenizers": tokenizers.__version__, "scripts_agree": agree},
        "sets": [points(s) for s in t.SETS], "properties": t.PROPERTIES,
        "escapes": t.ESCAPES, "brackets": t.BRACKETS,
        "bare": {k: points(v) for k, v in t.BARE_LATIN1.items()},
        "case_classes": [tuple(g) for g in t.CASE_CLASSES], "multi_folds": t.MULTI_FOLDS,
        "clusters": {k: points(v) for k, v in t.CLUSTERS.items()},
        "word_breaks": {k: points(v) for k, v in t.WORD_BREAKS.items()},
        "script_names": list(t.SCRIPT_NAMES), "script_runs": [tuple(r) for r in t.SCRIPT_RUNS],
    }


def test_the_committed_tables_are_what_the_generator_writes():
    """The module is the generator's rendering of its tables, byte for
    byte, and a seeded sample of its sets is what the library gives now."""
    committed = _committed()
    with open(generator.OUT, encoding="utf-8") as fh:
        assert generator.render(committed) == fh.read()
    rng = random.Random(23)
    for name in rng.sample(sorted(unicode_tables.PROPERTIES), 2):
        _, points, _ = generator._probe_name(name)
        assert points == committed["sets"][unicode_tables.PROPERTIES[name]], name
    _, points, latin1 = generator._probe_escape("w")
    assert points == committed["sets"][unicode_tables.ESCAPES["w"]]
    assert latin1 == committed["bare"]["\\w"]
    assert len(open(generator.OUT, "rb").read()) < 1 << 20


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
