"""Levenshtein edit distance (replaces the reference's ``editdistance`` dep).

Band-free two-row DP; O(len(a)*len(b)) time, O(min) memory. Used by
:class:`ccd_tpu_torch.evaluation.accuracy.TextAccuracy` exactly where the reference
calls ``editdistance.eval`` (``Dino/metric/eval_acc.py:48``).
"""

from __future__ import annotations


def levenshtein(a: str, b: str) -> int:
    if a == b:
        return 0
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i]
        for j, cb in enumerate(b, start=1):
            cur.append(min(prev[j] + 1,            # deletion
                           cur[j - 1] + 1,         # insertion
                           prev[j - 1] + (ca != cb)))  # substitution
        prev = cur
    return prev[-1]
