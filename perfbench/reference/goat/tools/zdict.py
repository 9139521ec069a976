"""The causal banks' batch helpers (frozen from the port's
`tools/zdict.py`): each bank broadcast over a batch's episodes as views
of one copy."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def broadcast_zdict(zd: Mapping[str, np.ndarray], batch_size: int,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """Each bank over the batch: [N, D] -> [B, N, D], p(z) [N] ->
    [B, N, 1], as expanded views of one copy on `device` (the JAX
    package's broadcast_zdict)."""
    out = {}
    for k, v in zd.items():
        t = torch.as_tensor(np.asarray(v, np.float32), device=device)
        if t.dim() == 1:
            t = t[:, None]
        out[k] = t.expand((batch_size,) + tuple(t.shape))
    return out


# FrontDoorPicker bank -> (batch key, config flag that reads it)
# batch keys that hold banks shared by every episode, not per-episode rows
# (the JAX package's rollout.py `_SHARED_BANKS`): whatever slices or
# reorders a batch by episode must carry these through whole
SHARED_BANKS = frozenset({
    "img_z_features", "img_z_pzs", "instr_z_direction_features",
    "instr_z_direction_pzs", "instr_z_landmark_features",
    "instr_z_landmark_pzs", "front_txt_feats", "front_vp_feats",
    "front_gmap_feats"})


def causal_batch(banks: Mapping[str, np.ndarray],
                 batch: Mapping[str, torch.Tensor]) -> Dict[str,
                                                            torch.Tensor]:
    """A copy of the episode batch with every bank broadcast over its
    episodes on the batch's device."""
    B = batch["scan_idx"].shape[0]
    return {**batch, **broadcast_zdict(banks, B,
                                       batch["scan_idx"].device)}
