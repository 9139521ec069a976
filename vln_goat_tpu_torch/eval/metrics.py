"""Navigation evaluation metrics (a copy of vln_goat_tpu/eval/metrics.py).

Reference: map_nav_src/r2r/eval_utils.py (cal_dtw :6, cal_cls :28) and
R2RNavBatch._eval_item / eval_metrics (r2r/env.py:462-520).  Implemented
over a scan distance matrix with integer (local) viewpoint ids; vectorized
numpy instead of the reference's per-cell python DP where it matters.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

ERROR_MARGIN = 3.0


def cal_dtw(dist: np.ndarray, prediction: Sequence[int],
            reference: Sequence[int], success: float = None,
            threshold: float = ERROR_MARGIN) -> Dict[str, float]:
    np_, nr = len(prediction), len(reference)
    dtw = np.full((np_ + 1, nr + 1), np.inf)
    dtw[0, 0] = 0.0
    cost = dist[np.asarray(prediction)[:, None], np.asarray(reference)[None, :]]
    for i in range(1, np_ + 1):
        for j in range(1, nr + 1):
            dtw[i, j] = cost[i - 1, j - 1] + min(dtw[i - 1, j], dtw[i, j - 1],
                                                 dtw[i - 1, j - 1])
    d = dtw[np_, nr]
    ndtw = float(np.exp(-d / (threshold * nr)))
    if success is None:
        success = float(dist[prediction[-1], reference[-1]] < threshold)
    return {"DTW": float(d), "nDTW": ndtw, "SDTW": success * ndtw}


def cal_cls(dist: np.ndarray, prediction: Sequence[int],
            reference: Sequence[int], threshold: float = ERROR_MARGIN) -> float:
    p = np.asarray(prediction)
    r = np.asarray(reference)
    coverage = float(np.mean(np.exp(-dist[r[:, None], p[None, :]].min(1)
                                    / threshold)))

    def length(nodes):
        return float(np.sum(dist[nodes[:-1], nodes[1:]])) if len(nodes) > 1 else 0.0

    expected = coverage * length(r)
    score = expected / (expected + abs(expected - length(p))) if expected > 0 else 0.0
    return coverage * score


def eval_item(dist: np.ndarray, pred_path: Sequence[int],
              gt_path: Sequence[int]) -> Dict[str, float]:
    """Single-trajectory metrics (r2r/env.py:462-490)."""
    path = list(pred_path)
    assert path[0] == gt_path[0], "trajectory must start at the gt start"
    goal = gt_path[-1]
    nearest = path[int(np.argmin(dist[np.asarray(path), goal]))]

    s = {}
    s["nav_error"] = float(dist[path[-1], goal])
    s["oracle_error"] = float(dist[nearest, goal])
    s["trajectory_steps"] = len(path) - 1
    s["trajectory_lengths"] = float(np.sum(dist[np.asarray(path[:-1]),
                                                np.asarray(path[1:])])) \
        if len(path) > 1 else 0.0
    gt_lengths = float(np.sum(dist[np.asarray(gt_path[:-1]),
                                   np.asarray(gt_path[1:])])) \
        if len(gt_path) > 1 else 0.0
    s["success"] = float(s["nav_error"] < ERROR_MARGIN)
    s["spl"] = s["success"] * gt_lengths / max(s["trajectory_lengths"],
                                               gt_lengths, 0.01)
    s["oracle_success"] = float(s["oracle_error"] < ERROR_MARGIN)
    s.update(cal_dtw(dist, path, list(gt_path), s["success"]))
    s["CLS"] = cal_cls(dist, path, list(gt_path))
    return s


def reverie_eval_item(dist: np.ndarray, pred_path: Sequence[int],
                      pred_objid, gt_path: Sequence[int],
                      goal_viewpoints: Sequence[int],
                      gt_objid) -> Dict[str, float]:
    """REVERIE metrics (reverie/env.py:530-553): success = stopping at a
    viewpoint from which the target object is visible; RGS = grounding the
    right object id; SPL/RGSPL path-length weighted."""
    path = list(pred_path)
    goals = set(int(g) for g in goal_viewpoints)
    s = {}
    s["trajectory_steps"] = len(path) - 1
    s["trajectory_lengths"] = float(np.sum(dist[np.asarray(path[:-1]),
                                                np.asarray(path[1:])])) \
        if len(path) > 1 else 0.0
    gt_lengths = float(np.sum(dist[np.asarray(gt_path[:-1]),
                                   np.asarray(gt_path[1:])])) \
        if len(gt_path) > 1 else 0.0
    s["success"] = float(path[-1] in goals)
    s["oracle_success"] = float(any(x in goals for x in path))
    s["spl"] = s["success"] * gt_lengths / max(s["trajectory_lengths"],
                                               gt_lengths, 0.01)
    # NOTE the reference scores RGS purely on the object id, independent of
    # navigation success (reverie/env.py:551)
    s["rgs"] = float(str(pred_objid) == str(gt_objid))
    s["rgspl"] = s["rgs"] * gt_lengths / max(s["trajectory_lengths"],
                                             gt_lengths, 0.01)
    return s


_SHARED_ROWS = (("steps", "trajectory_steps", 1),
                ("lengths", "trajectory_lengths", 1),
                ("sr", "success", 100),
                ("oracle_sr", "oracle_success", 100),
                ("spl", "spl", 100))


def _aggregate(per_item, extra_rows) -> Dict[str, float]:
    m = defaultdict(list)
    for s in per_item:
        for k, v in s.items():
            m[k].append(v)
    return {name: float(np.mean(m[key]) * scale)
            for name, key, scale in _SHARED_ROWS + extra_rows}


def reverie_eval_metrics(per_item: List[Dict[str, float]]) -> Dict[str, float]:
    """Aggregate (reverie/env.py:555-582)."""
    return _aggregate(per_item, (("rgs", "rgs", 100), ("rgspl", "rgspl", 100)))


def eval_metrics(per_item: List[Dict[str, float]]) -> Dict[str, float]:
    """Aggregate (r2r/env.py:492-520)."""
    return _aggregate(per_item, (
        ("nav_error", "nav_error", 1), ("oracle_error", "oracle_error", 1),
        ("nDTW", "nDTW", 100), ("SDTW", "SDTW", 100), ("CLS", "CLS", 100)))
