"""Offline CFP front-door feature extraction (counterpart of
vln_goat_tpu/tools/cfp_extract.py).

Reference: agent.extract_cfp_features (map_nav_src/r2r/agent.py:1008-1049)
and the model's 'extract_cfp_features' mode: the ground-truth trajectories
of the training set go through `GoatModel.extract_cfp` (the tim
self-encoders and heads) in batches of `pretrain.data.TrajBatchBuilder`
(task "cfp"), and the pooled vectors are written as base64 TSV rows
(path_id, txt_feats, vp_feats, gmap_feats) that the front-door k-means
picker (`tools.kmeans.FrontDoorPicker`) clusters.  The TSV is the JAX
package's format: each package reads the other's.
"""
from __future__ import annotations

import base64
import csv
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.goat import GoatModel
from ..pretrain.data import TrajBatchBuilder

TSV_FIELDS = ["path_id", "txt_feats", "vp_feats", "gmap_feats"]


def batch_tensors(batch: Dict[str, np.ndarray], device
                  ) -> Dict[str, torch.Tensor]:
    """A builder batch on `device`: integers as int64, floats as float32,
    booleans as they are."""
    out = {}
    for k, v in batch.items():
        v = np.ascontiguousarray(v)
        if v.dtype.kind in "iu":
            v = v.astype(np.int64)
        elif v.dtype.kind == "f":
            v = v.astype(np.float32)
        out[k] = torch.as_tensor(v, device=device)
    return out


@torch.no_grad()
def extract_cfp_features(model: GoatModel, builder: TrajBatchBuilder,
                         items: List[dict], batch_size: int = 64,
                         out_tsv: Optional[str] = None
                         ) -> Dict[str, np.ndarray]:
    """Ground-truth trajectories -> the pooled txt / vp / gmap feature
    banks [N, hidden] (float32 numpy), on the model's device, in eval
    mode; written to `out_tsv` when given."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    txt, vp, gmap, pids = [], [], [], []
    try:
        for i in range(0, len(items), batch_size):
            chunk = items[i:i + batch_size]
            batch = batch_tensors(builder.build_batch(chunk, task="cfp"),
                                  dev)
            out = model.extract_cfp(batch)
            txt.append(out["txt_outputs"].float().cpu().numpy())
            vp.append(out["vp_outputs"].float().cpu().numpy())
            gmap.append(out["gmap_outputs"].float().cpu().numpy())
            pids.extend([it.get("path_id", it.get("instr_id", str(i + j)))
                         for j, it in enumerate(chunk)])
    finally:
        model.train(was_training)
    feats = {"txt_feats": np.concatenate(txt, 0),
             "vp_feats": np.concatenate(vp, 0),
             "gmap_feats": np.concatenate(gmap, 0)}
    if out_tsv:
        save_cfp_tsv(out_tsv, pids, feats)
    return feats


def save_cfp_tsv(path: str, path_ids: List[str],
                 feats: Dict[str, np.ndarray]) -> None:
    """One row per trajectory: path_id, then each bank's float32 row in
    base64."""
    with open(path, "wt") as f:
        w = csv.DictWriter(f, delimiter="\t", fieldnames=TSV_FIELDS)
        for i, pid in enumerate(path_ids):
            w.writerow({"path_id": pid, **{
                k: base64.b64encode(
                    np.asarray(feats[k][i], np.float32).tobytes()).decode()
                for k in TSV_FIELDS[1:]}})


def load_cfp_tsv(path: str, dim: int = 768) -> Dict[str, np.ndarray]:
    """A CFP feature TSV -> {"path_ids": [...], "txt_feats" / "vp_feats" /
    "gmap_feats": [N, dim]} (read_tim_tsv, utils/data.py:430-449)."""
    csv.field_size_limit(sys.maxsize)
    out = {k: [] for k in TSV_FIELDS[1:]}
    ids = []
    with open(path) as f:
        for row in csv.DictReader(f, delimiter="\t", fieldnames=TSV_FIELDS):
            ids.append(row["path_id"])
            for k in out:
                out[k].append(np.frombuffer(
                    base64.b64decode(row[k]), np.float32)[:dim])
    return {"path_ids": ids, **{k: np.stack(v, 0) for k, v in out.items()}}
