"""Certainty logic for reasoning early exit.

Mirror of reference ``dynasor/entropy.py:23-250``: group consecutive probe
answers by mathematical equivalence, compute agreement/entropy, and decide
whether the model has converged (``should_early_exit``).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional, Sequence

from arcticinference_tpu_torch.dynasor.evaluator import math_equal

# Words that indicate the model is still unsure (reference keeps a similar
# list to veto early exit on hedged probe outputs).
UNCERTAIN_WORDS = ("wait", "hold on", "but", "however", "hmm", "maybe",
                   "alternatively", "verify", "think again", "?")


def is_certain_answer(probe_text: str, answer: Optional[str]) -> bool:
    """An answer counts toward certainty only if non-empty and the probe
    continuation contains no hedging language."""
    if not answer:
        return False
    low = probe_text.lower()
    return not any(w in low for w in UNCERTAIN_WORDS)


def equal_group(answers: Sequence[Optional[str]]) -> bool:
    """True if all answers in the window are mutually equivalent."""
    if not answers:
        return False
    first = answers[0]
    return all(math_equal(first, a) for a in answers[1:])


def count_not_empty(answers: Sequence[Optional[str]]) -> int:
    return sum(1 for a in answers if a)


def majority_answer(answers: Sequence[Optional[str]]) -> Optional[str]:
    """Most frequent answer by equivalence classes."""
    classes: list[tuple[str, int]] = []
    for a in answers:
        if not a:
            continue
        for i, (rep, n) in enumerate(classes):
            if math_equal(rep, a):
                classes[i] = (rep, n + 1)
                break
        else:
            classes.append((a, 1))
    if not classes:
        return None
    return max(classes, key=lambda kv: kv[1])[0]


def answer_entropy(answers: Sequence[Optional[str]]) -> float:
    """Shannon entropy over equivalence classes (nats); 0 = full agreement."""
    classes: list[tuple[str, int]] = []
    total = 0
    for a in answers:
        if not a:
            continue
        total += 1
        for i, (rep, n) in enumerate(classes):
            if math_equal(rep, a):
                classes[i] = (rep, n + 1)
                break
        else:
            classes.append((a, 1))
    if total == 0:
        return float("inf")
    ent = 0.0
    for _, n in classes:
        p = n / total
        ent -= p * math.log(p)
    return ent


def should_early_exit(
    answers: Sequence[Optional[str]],
    probe_texts: Sequence[str],
    window: int = 2,
) -> bool:
    """Converged when the last ``window`` probe answers are non-empty,
    hedge-free and mutually equivalent (reference cot.py certainty
    window)."""
    if len(answers) < window:
        return False
    recent = list(answers[-window:])
    texts = list(probe_texts[-window:])
    if count_not_empty(recent) < window:
        return False
    if not all(is_certain_answer(t, a) for t, a in zip(texts, recent)):
        return False
    return equal_group(recent)
