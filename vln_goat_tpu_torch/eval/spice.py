"""SPICE-style semantic-proposition F-score for speaker validation: the
port's own copy of vln_goat_tpu/eval/spice.py (pure Python, no framework).

The reference ships `reverie/spice_scorer.py` whose class (BleuScorer,
:8-28) actually computes COCO BLEU — the SPICE name survives only in the
filename and the data-preparation interface.  This module provides the
metric that filename promises: a scene-graph tuple F-score in the spirit of
SPICE (Anderson et al., ECCV 2016), implemented dependency-free in pure
Python so it runs in-image.

Divergences from the Java SPICE (documented, deliberate):
- scene graphs come from a lightweight chunking heuristic (noun phrases =
  maximal content-word runs, head = last word; relations = NP-preposition-NP
  spans) instead of a dependency parse;
- synonym matching uses a small built-in table + simple suffix stemming
  instead of WordNet synsets.

The `SpiceScorer.compute_scores(data)` interface mirrors the reference
scorer (spice_scorer.py:14-28): `data` is a list of dicts with keys
`Inference` (list of candidate strings) and `Ground Truth` (list of
reference strings); the corpus score is the mean per-item F-score, the
SPICE convention.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Set, Tuple

# function words dropped from scene graphs
_STOP = {
    "a", "an", "the", "and", "or", "then", "there", "this", "that", "these",
    "those", "is", "are", "was", "be", "been", "being", "you", "your", "it",
    "its", "will", "would", "should", "can", "could", "do", "does", "did",
    "have", "has", "had", "not", "no", "yes", "very", "just", "once", "so",
    "as", "if", "when", "where", "which", "who", "what", "how", "all",
    "both", "each", "until", "while", "again", "here", "now", "them",
    "they", "he", "she", "we", "i", "me", "my", "our", "us", "himself",
    "herself", "itself", "themselves", "'s", "'", ",", ".",
}

# prepositions/relations that join two noun phrases into a relation tuple
_RELATIONS = {
    "in", "on", "at", "near", "by", "behind", "above", "below", "under",
    "over", "into", "onto", "through", "past", "between", "beside",
    "against", "across", "around", "toward", "towards", "before", "after",
    "with", "without", "from", "of", "to", "up", "down", "inside",
    "outside", "off", "along", "left", "right",
}

# common VLN verbs: kept as relations when between NPs, else dropped
_VERBS = {
    "walk", "go", "turn", "stop", "wait", "enter", "exit", "leave", "pass",
    "continue", "head", "move", "take", "follow", "climb", "descend",
    "reach", "face", "stand", "step", "proceed", "make", "keep", "veer",
}

# tiny synonym table (WordNet stand-in) mapping variants -> canonical
_SYN = {
    "photo": "picture", "photograph": "picture", "image": "picture",
    "sofa": "couch", "stairway": "stairs", "staircase": "stairs",
    "stair": "stairs", "restroom": "bathroom", "washroom": "bathroom",
    "tv": "television", "rug": "carpet", "lamp": "light",
    "doorway": "door", "hallway": "hall", "corridor": "hall",
    "countertop": "counter", "fridge": "refrigerator",
}


def _stem(w: str) -> str:
    w = _SYN.get(w, w)
    for suf in ("ies", "es", "s"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            base = w[:-len(suf)] + ("y" if suf == "ies" else "")
            return _SYN.get(base, base)
    return w


def _tokens(sentence: str) -> List[str]:
    return re.findall(r"[a-z0-9']+", sentence.lower())


def scene_graph(sentence: str) -> Set[Tuple[str, ...]]:
    """Extract semantic tuples: (object,), (object, attribute) and
    (object, relation, object).  Noun phrases are maximal runs of content
    words; the run's last word is the head, earlier words its attributes;
    a relation word between two NPs links their heads."""
    toks = _tokens(sentence)
    tuples: Set[Tuple[str, ...]] = set()
    nps: List[Tuple[int, List[str]]] = []   # (end position, words)
    cur: List[str] = []
    rels: List[Tuple[int, str]] = []        # (position, relation word)
    for i, t in enumerate(toks):
        if t in _STOP:
            if cur:
                nps.append((i, cur))
                cur = []
        elif t in _RELATIONS or t in _VERBS:
            if cur:
                nps.append((i, cur))
                cur = []
            rels.append((i, t))
        else:
            cur.append(_stem(t))
    if cur:
        nps.append((len(toks), cur))

    for _, np_words in nps:
        head = np_words[-1]
        tuples.add((head,))
        for attr in np_words[:-1]:
            tuples.add((head, attr))

    # relations: for each relation word, link the nearest NP head on each
    # side (within a short window, like SPICE's prep_dep pattern)
    for pos, rel in rels:
        left = right = None
        for end, np_words in nps:
            if end <= pos and (left is None or end > left[0]):
                left = (end, np_words[-1])
            start = end - len(np_words)
            if start > pos and (right is None or start < right[0]):
                right = (start, np_words[-1])
        if left is not None and right is not None \
                and pos - left[0] <= 2 and right[0] - pos <= 2:
            tuples.add((left[1], _stem(rel) if rel in _VERBS else rel,
                        right[1]))
    return tuples


def spice_score(candidate: str, references: Sequence[str]
                ) -> Dict[str, float]:
    """Per-item SPICE: F1 between the candidate scene graph and the UNION
    of the reference scene graphs (SPICE merges references into one graph)."""
    cand = scene_graph(candidate)
    ref: Set[Tuple[str, ...]] = set()
    for r in references:
        ref |= scene_graph(r)
    if not cand and not ref:
        return {"spice": 1.0, "precision": 1.0, "recall": 1.0}
    matched = len(cand & ref)
    p = matched / len(cand) if cand else 0.0
    r = matched / len(ref) if ref else 0.0
    f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return {"spice": f, "precision": p, "recall": r}


class SpiceScorer:
    """Drop-in sibling of the reference BleuScorer
    (reverie/spice_scorer.py:8-28): same prepare_data contract, returns the
    corpus mean F-score and the per-item scores."""

    method = "SPICE"

    def prepare_data(self, data: List[dict]):
        reference = {}
        ground_truth = {}
        for idx, item in enumerate(data):
            reference[idx] = item["Inference"]
            ground_truth[idx] = item["Ground Truth"]
        return reference, ground_truth

    def compute_scores(self, data: List[dict]):
        reference, ground_truth = self.prepare_data(data)
        scores = []
        for idx in reference:
            cand = reference[idx][0] if reference[idx] else ""
            gts = ground_truth[idx]
            if isinstance(gts, str):
                gts = [gts]
            scores.append(spice_score(cand, gts)["spice"])
        corpus = sum(scores) / len(scores) if scores else 0.0
        return corpus, scores


def spice_from_ids(hyp_ids: Sequence[int], ref_ids: List[Sequence[int]]
                   ) -> float:
    """Token-id fallback when no vocabulary exists (synthetic runs): each id
    becomes a pseudo-word, degrading gracefully to unigram-set F1."""
    # interleave an article so each pseudo-word forms its own noun phrase
    cand = " the ".join(f"t{int(i)}" for i in hyp_ids)
    refs = [" the ".join(f"t{int(i)}" for i in r) for r in ref_ids]
    return spice_score(cand, refs)["spice"]
