"""Math-answer normalization and equivalence.

Lean re-implementation of the capability of reference
``dynasor/evaluator.py`` (Qwen2.5-Math-derived): normalize LaTeX-ish
answers and decide symbolic/numeric equality, used by the certainty logic
to compare consecutive probe answers.
"""

from __future__ import annotations

import re
from typing import Optional

_LATEX_SUBS = [
    (r"\\left", ""), (r"\\right", ""),
    (r"\\!", ""), (r"\\,", ""), (r"\\;", ""), (r"\\ ", " "),
    (r"\\%", "%"), (r"\\\$", ""),
    (r"\\text\{([^{}]*)\}", r"\1"),
    (r"\\mathrm\{([^{}]*)\}", r"\1"),
    (r"\\mbox\{([^{}]*)\}", r"\1"),
    (r"\\dfrac", r"\\frac"), (r"\\tfrac", r"\\frac"),
    (r"\\cdot", "*"), (r"\\times", "*"), (r"\\div", "/"),
    (r"\\pi", "pi"), (r"\\infty", "oo"),
    (r"\\sqrt\{([^{}]*)\}", r"sqrt(\1)"),
    (r"\\sqrt(\d)", r"sqrt(\1)"),
    (r"\^\{([^{}]*)\}", r"**(\1)"),
    (r"\^(\d)", r"**\1"),
    (r"\{", "("), (r"\}", ")"),
    (r"\$", ""),
]


def normalize_answer(ans: Optional[str]) -> str:
    """Normalize an extracted answer string for comparison."""
    if ans is None:
        return ""
    s = ans.strip()
    # strip trailing period / units-ish suffixes
    s = s.rstrip(".")
    # degree markers are cosmetic for equality purposes
    s = re.sub(r"(\^\{?\\circ\}?|°)", "", s)
    # Brace-eliminating rewrites iterate to a fixpoint so nested forms
    # resolve inside-out (\frac{\sqrt{2}}{2} needs \sqrt handled before
    # the \frac braces match).
    for _ in range(8):
        prev = s
        # mixed numbers BEFORE generic \frac: 1\frac{1}{2} == 1 + 1/2
        s = re.sub(r"(\d)\\frac\{([^{}]*)\}\{([^{}]*)\}",
                   r"(\1+(\2)/(\3))", s)
        s = re.sub(r"(\d)\\frac(\d)(\d)", r"(\1+\2/\3)", s)
        s = re.sub(r"\\frac\{([^{}]*)\}\{([^{}]*)\}", r"(\1)/(\2)", s)
        s = re.sub(r"\\frac(\d)(\d)", r"\1/\2", s)
        s = re.sub(r"\\sqrt\{([^{}]*)\}", r"sqrt(\1)", s)
        s = re.sub(r"\\text\{([^{}]*)\}", r"\1", s)
        s = re.sub(r"\\mathrm\{([^{}]*)\}", r"\1", s)
        s = re.sub(r"\^\{([^{}]*)\}", r"**(\1)", s)
        if s == prev:
            break
    for pat, rep in _LATEX_SUBS:
        s = re.sub(pat, rep, s)
    s = s.replace(" ", "")
    # canonicalize thousands separators: 1,234 -> 1234
    s = re.sub(r"(?<=\d),(?=\d{3}\b)", "", s)
    # leading zeros in decimals: .5 -> 0.5
    s = re.sub(r"(?<![\d.])\.(\d)", r"0.\1", s)
    return s


def _split_top_level(s: str) -> Optional[list]:
    """Split 'a,b,c' inside one outer (...)/[...] at depth 0; None if the
    string is not a bracketed tuple/list/interval."""
    if len(s) < 2 or s[0] not in "([" or s[-1] not in ")]":
        return None
    inner = s[1:-1]
    parts, depth, cur = [], 0, []
    for c in inner:
        if c in "([":
            depth += 1
        elif c in ")]":
            depth -= 1
            if depth < 0:
                return None
        if c == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    parts.append("".join(cur))
    return parts if len(parts) > 1 else None


def _strip_equation_lhs(s: str) -> str:
    """'x=5' compares as '5' (single '=' with a short symbolic LHS)."""
    if s.count("=") == 1:
        lhs, rhs = s.split("=")
        if re.fullmatch(r"[a-zA-Z](\([a-zA-Z]\))?", lhs or ""):
            return rhs
    return s


def _num_close(fa: float, fb: float, tolerance: float) -> bool:
    """Numeric closeness with the reference's include_percentage=True
    semantics: a bare number may be the percent or fraction form."""
    close = lambda x, y: abs(x - y) <= tolerance * max(
        1.0, abs(x), abs(y))
    return (close(fa, fb) or close(fa, fb / 100.0)
            or close(fa, fb * 100.0))


def _to_number(s: str) -> Optional[float]:
    try:
        if s.endswith("%"):
            return float(s[:-1]) / 100.0
        return float(s)
    except ValueError:
        return None


def _sympy_equal(a: str, b: str) -> Optional[bool]:
    try:
        import sympy
        from sympy.parsing.sympy_parser import (parse_expr,
                                                standard_transformations,
                                                implicit_multiplication)

        tf = standard_transformations + (implicit_multiplication,)
        ea = parse_expr(a, transformations=tf, evaluate=True)
        eb = parse_expr(b, transformations=tf, evaluate=True)
        return bool(sympy.simplify(ea - eb) == 0)
    except Exception:
        return None


# -- english number words (reference uses word2number; ours is internal) --

_UNITS = {w: i for i, w in enumerate(
    ["zero", "one", "two", "three", "four", "five", "six", "seven",
     "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
     "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"])}
_TENS = {w: 10 * i for i, w in enumerate(
    ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
     "eighty", "ninety"]) if w}
_SCALES = {"hundred": 100, "thousand": 1000, "million": 10 ** 6,
           "billion": 10 ** 9}


def word_to_number(text: str) -> Optional[float]:
    """'twenty-three' -> 23, 'one hundred and five' -> 105; None if the
    text is not an english number phrase."""
    words = re.split(r"[\s\-]+", text.strip().lower())
    words = [w for w in words if w and w != "and"]
    if not words:
        return None
    total, cur = 0, 0
    for w in words:
        if w in _UNITS:
            cur += _UNITS[w]
        elif w in _TENS:
            cur += _TENS[w]
        elif w == "hundred" and cur:
            cur *= 100
        elif w in _SCALES and w != "hundred":
            total += (cur or 1) * _SCALES[w]
            cur = 0
        elif w == "point":
            return None  # decimals in words: out of scope
        else:
            return None
    return float(total + cur)


# -- matrices (reference: pmatrix/bmatrix/array element-wise equality) --

_MATRIX_RE = re.compile(
    r"\\begin\{(?:p|b|v)?matrix\}(.*?)\\end\{(?:p|b|v)?matrix\}",
    re.DOTALL)


def _parse_matrix(s: str) -> Optional[list]:
    """[[cell, ...], ...] from a LaTeX matrix (array envs normalized)."""
    t = re.sub(r"\\begin\{array\}\{[^{}]*\}", r"\\begin{pmatrix}", s)
    t = t.replace("\\end{array}", "\\end{pmatrix}")
    m = _MATRIX_RE.search(t)
    if not m:
        return None
    rows = [r for r in re.split(r"\\\\", m.group(1)) if r.strip()]
    return [[c.strip() for c in row.split("&")] for row in rows]


def math_equal(a: Optional[str], b: Optional[str],
               tolerance: float = 1e-6) -> bool:
    """True if the two answers are mathematically equivalent.

    Covers (mirroring the capability of reference
    ``dynasor/evaluator.py``'s Qwen2.5-Math-derived checker): exact
    normalized match, numeric closeness (incl. percent<->decimal and the
    reference's x ~ x/100 ~ 100x percentage variants), english number
    words, LaTeX matrices element-wise, tuples/lists/intervals
    element-wise, 'x=5' vs '5', '\\pm' expansions, case-insensitive text
    answers, and sympy symbolic equality as the fallback.
    """
    if a is None or b is None:
        return normalize_answer(a) == normalize_answer(b)
    # English number words work on the RAW strings (normalization strips
    # the spaces that separate them).
    wa, wb = word_to_number(a), word_to_number(b)
    if wa is not None or wb is not None:
        fa = wa if wa is not None else _to_number(normalize_answer(a))
        fb = wb if wb is not None else _to_number(normalize_answer(b))
        if fa is not None and fb is not None:
            return _num_close(fa, fb, tolerance)
    # Matrices compare structurally BEFORE normalization (it rewrites
    # the braces the environment markers live in).
    ma, mb = _parse_matrix(a), _parse_matrix(b)
    if ma is not None or mb is not None:
        if ma is None or mb is None:
            # vector-vs-matrix: the reference promotes '(1,2)' to a
            # pmatrix; compare against the flattened cells.
            vec = _split_top_level(normalize_answer(b if ma is not None
                                                    else a))
            cells = [c for row in (ma or mb) for c in row]
            if vec is None or len(vec) != len(cells):
                return False
            return all(math_equal(x, y, tolerance)
                       for x, y in zip(cells, vec))
        if len(ma) != len(mb) or any(len(ra) != len(rb)
                                     for ra, rb in zip(ma, mb)):
            return False
        return all(math_equal(x, y, tolerance)
                   for ra, rb in zip(ma, mb) for x, y in zip(ra, rb))
    na, nb = normalize_answer(a), normalize_answer(b)
    return _equal_normalized(na, nb, tolerance, depth=0)


def _equal_normalized(na: str, nb: str, tolerance: float,
                      depth: int) -> bool:
    if not na or not nb:
        return na == nb
    if na == nb:
        return True
    if depth > 4:
        return False
    na, nb = _strip_equation_lhs(na), _strip_equation_lhs(nb)
    if na == nb:
        return True
    # \pm expands to an unordered candidate pair.
    for s, o in ((na, nb), (nb, na)):
        if "\\pm" in s:
            lo = s.replace("\\pm", "-", 1)
            hi = s.replace("\\pm", "+", 1)
            pair = _split_top_level(o)
            if pair is not None and len(pair) == 2:
                eq = lambda x, y: _equal_normalized(x, y, tolerance,
                                                    depth + 1)
                return ((eq(lo, pair[0]) and eq(hi, pair[1]))
                        or (eq(lo, pair[1]) and eq(hi, pair[0])))
            return (_equal_normalized(lo, o, tolerance, depth + 1)
                    or _equal_normalized(hi, o, tolerance, depth + 1))
    fa, fb = _to_number(na), _to_number(nb)
    # English number words ('twenty-three' == '23').
    if fa is None:
        fa = word_to_number(na)
    if fb is None:
        fb = word_to_number(nb)
    if fa is not None and fb is not None:
        return _num_close(fa, fb, tolerance)
    # Tuples / lists / intervals: element-wise with matching brackets.
    pa, pb = _split_top_level(na), _split_top_level(nb)
    if pa is not None and pb is not None:
        return (len(pa) == len(pb) and na[0] == nb[0] and na[-1] == nb[-1]
                and all(_equal_normalized(x, y, tolerance, depth + 1)
                        for x, y in zip(pa, pb)))
    if pa is not None or pb is not None:
        return False
    # Pure text answers (Yes/No, option letters): case-insensitive.
    if na.isalpha() and nb.isalpha():
        return na.lower() == nb.lower()
    res = _sympy_equal(na, nb)
    if res is not None:
        return res
    return False


def extract_boxed(text: str) -> Optional[str]:
    """Extract the content of the last ``\\boxed{...}`` (nested braces ok)."""
    idx = text.rfind("\\boxed{")
    if idx < 0:
        return None
    i = idx + len("\\boxed{")
    depth = 1
    out = []
    while i < len(text) and depth > 0:
        c = text[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                break
        out.append(c)
        i += 1
    return "".join(out) if depth == 0 else None


def extract_answer(text: str) -> Optional[str]:
    """Extract the final answer from a (possibly truncated) completion.

    Tries \\boxed{}, then 'answer is ...' patterns, then a bare trailing
    expression after 'Final Answer'.
    """
    boxed = extract_boxed(text)
    if boxed is not None:
        return boxed
    m = re.search(
        r"(?:final answer|answer)\s*(?:is|:)?\s*([^\n.,;]+)",
        text, re.IGNORECASE)
    if m:
        return m.group(1).strip()
    return None
