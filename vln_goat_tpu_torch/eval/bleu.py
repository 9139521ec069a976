"""Corpus BLEU (COCO-style) for speaker validation: the port's own copy of
vln_goat_tpu/eval/bleu.py (pure Python, no framework).

Reference: map_nav_src/reverie/bleu_coco/bleu_scorer.py (used as the
speaker's quality gate, reverie/main_nav_obj.py:338-371).

Semantics: up to 4-gram clipped precision with multi-reference counts,
brevity penalty against the *closest* reference length (COCO convention),
plus the +1 smoothing variant used for short sentences.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Sequence, Tuple

import math


def _ngrams(tokens: Sequence, n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(hypotheses: List[Sequence], references: List[List[Sequence]],
                max_n: int = 4, smooth: bool = False) -> Tuple[float, List[float]]:
    """Returns (bleu4, [bleu1..bleu4])."""
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for hyp, refs in zip(hypotheses, references):
        hyp_len += len(hyp)
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            hc = _ngrams(hyp, n)
            if not hc:
                continue
            max_ref = Counter()
            for r in refs:
                rc = _ngrams(r, n)
                for g, c in rc.items():
                    if c > max_ref[g]:
                        max_ref[g] = c
            totals[n - 1] += sum(hc.values())
            clipped[n - 1] += sum(min(c, max_ref[g]) for g, c in hc.items())

    precisions = []
    for n in range(max_n):
        if totals[n] == 0:
            precisions.append(0.0)
        elif smooth:
            precisions.append((clipped[n] + 1.0) / (totals[n] + 1.0))
        else:
            precisions.append(clipped[n] / totals[n])

    if hyp_len == 0:
        return 0.0, [0.0] * max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len / max(hyp_len, 1))

    bleus = []
    logsum = 0.0
    for n in range(max_n):
        if precisions[n] > 0:
            logsum += math.log(precisions[n])
            bleus.append(bp * math.exp(logsum / (n + 1)))
        else:
            bleus.append(0.0)
            logsum += math.log(1e-12)
    return bleus[max_n - 1], bleus
