"""NavWorld: packed navigation tables of a set of scans, as tensors on one
device (counterpart of vln_goat_tpu/rollout/world.py: view features, their
EnvEdit-augmented copy, and the REVERIE / SOON object tables).

Scans are padded to Vmax viewpoints; features are flattened to a global
[Vtot, 36, Df] tensor addressed by vp_offset[scan] + local index.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve
from ..sim.graph_sim import ScanGraph

INF_DIST = 9.5e5  # sentinel for "no path yet" (FloydGraph uses 95959595)


@dataclass
class NavWorld:
    pos: torch.Tensor           # [S, Vmax, 3] f32
    cand_local: torch.Tensor    # [S, Vmax, K] int64 (-1 pad)
    cand_ptid: torch.Tensor     # [S, Vmax, K] int64
    cand_heading: torch.Tensor  # [S, Vmax, K] f32 (absolute direction)
    cand_elev: torch.Tensor     # [S, Vmax, K] f32
    cand_dist: torch.Tensor     # [S, Vmax, K] f32
    cand_mask: torch.Tensor     # [S, Vmax, K] bool
    dist: torch.Tensor          # [S, Vmax, Vmax] f32 full-graph shortest dist
    hops: torch.Tensor          # [S, Vmax, Vmax] int64
    nexthop: torch.Tensor       # [S, Vmax, Vmax] int64 full-graph first hop
    n_vps: torch.Tensor         # [S] int64
    vp_offset: torch.Tensor     # [S] int64 into feat
    feat: torch.Tensor          # [Vtot, 36, Df]
    # EnvEdit augmented features, [0, 36, Df] when absent (r2r/env.py:78-84)
    feat_aug: Optional[torch.Tensor] = None
    # objects (REVERIE / SOON), zero-width [Vtot, 0, ...] when absent
    obj_feat: Optional[torch.Tensor] = None   # [Vtot, Lo, Dobj]
    obj_loc: Optional[torch.Tensor] = None    # [Vtot, Lo, A+3] angle + box
    obj_dir: Optional[torch.Tensor] = None    # [Vtot, Lo or 0, 2] absolute
    obj_mask: Optional[torch.Tensor] = None   # [Vtot, Lo] bool
    obj_name: Optional[torch.Tensor] = None   # [Vtot, Lo] category id
    obj_id: Optional[torch.Tensor] = None     # [Vtot, Lo] dataset object id

    @property
    def has_aug(self) -> bool:
        return self.feat_aug is not None and self.feat_aug.shape[0] > 0

    @property
    def max_cands(self) -> int:
        return self.cand_local.shape[-1]

    @property
    def num_objs(self) -> int:
        return 0 if self.obj_feat is None else self.obj_feat.shape[1]

    def get_objs(self, scan, vp):
        """Object tables of (scan, vp), each [B, Lo, ...]: feat, loc, dir
        (None when the world has no raw directions), mask, name, oid."""
        g = self.vp_offset[scan] + vp
        d = self.obj_dir[g]
        return dict(feat=self.obj_feat[g], loc=self.obj_loc[g],
                    dir=d if d.shape[1] else None, mask=self.obj_mask[g],
                    name=self.obj_name[g], oid=self.obj_id[g])

    @classmethod
    def build(cls, scans: Sequence[ScanGraph],
              features: Optional[np.ndarray] = None, feat_dim: int = 768,
              seed: int = 0, device="cuda",
              feat_dtype: torch.dtype = torch.float32,
              aug_features: Optional[np.ndarray] = None,
              objects: Optional[dict] = None) -> "NavWorld":
        """Pack ScanGraphs (+ per-viewpoint 36-view features) onto `device`.

        features: [sum(V_s), 36, Df] in scan order, or None for random
        synthetic features drawn with numpy from `seed` (the same draws as
        the JAX package's NavWorld.build).  aug_features: the EnvEdit
        features in the same layout, or None.  objects: the object store
        (`data.feature_db.ObjectFeaturesDB.as_packed_arrays`, or a
        synthetic one): {feat [Vtot, Lo, Dobj], loc [Vtot, Lo, A+3],
        dir [Vtot, Lo, 2] (optional), mask, name, oid [Vtot, Lo]}, or None
        for zero-width tables."""
        device = resolve(device)
        S = len(scans)
        Vmax = max(g.num_vps for g in scans)

        def pad2(x, fill):
            out = np.full((S, Vmax) + x[0].shape[1:], fill, x[0].dtype)
            for s, a in enumerate(x):
                out[s, :a.shape[0]] = a
            return out

        dist = np.full((S, Vmax, Vmax), INF_DIST, np.float32)
        hops = np.zeros((S, Vmax, Vmax), np.int64)
        nexthop = np.full((S, Vmax, Vmax), -1, np.int64)
        for s, g in enumerate(scans):
            V = g.num_vps
            dist[s, :V, :V] = np.where(np.isinf(g.dist), INF_DIST, g.dist)
            hops[s, :V, :V] = g.hops
            nexthop[s, :V, :V] = g.nexthop

        n_vps = np.array([g.num_vps for g in scans], np.int64)
        vp_offset = np.concatenate([[0], np.cumsum(n_vps)[:-1]]).astype(np.int64)
        vtot = int(n_vps.sum())
        if features is None:
            rng = np.random.default_rng(seed)
            features = rng.standard_normal(
                (vtot, 36, feat_dim)).astype(np.float32)
        if features.shape[0] != vtot:
            raise ValueError(f"features for {features.shape[0]} viewpoints, "
                             f"scans have {vtot}")

        def t(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        if objects is not None:
            dirs = objects.get("dir")
            obj = dict(
                obj_feat=t(objects["feat"], feat_dtype),
                obj_loc=t(np.asarray(objects["loc"], np.float32)),
                obj_dir=t(np.asarray(dirs, np.float32) if dirs is not None
                          else np.zeros((vtot, 0, 2), np.float32)),
                obj_mask=t(np.asarray(objects["mask"], bool)),
                obj_name=t(objects["name"], torch.int64),
                obj_id=t(objects["oid"], torch.int64))
        else:
            obj = dict(
                obj_feat=t(np.zeros((vtot, 0, 1), np.float32), feat_dtype),
                obj_loc=t(np.zeros((vtot, 0, 7), np.float32)),
                obj_dir=t(np.zeros((vtot, 0, 2), np.float32)),
                obj_mask=t(np.zeros((vtot, 0), bool)),
                obj_name=t(np.zeros((vtot, 0), np.int64)),
                obj_id=t(np.zeros((vtot, 0), np.int64)))
        return cls(
            pos=t(pad2([g.pos for g in scans], 0.0)),
            cand_local=t(pad2([g.cand_local for g in scans], -1), torch.int64),
            cand_ptid=t(pad2([g.cand_ptid for g in scans], 0), torch.int64),
            cand_heading=t(pad2([g.cand_heading for g in scans], 0.0)),
            cand_elev=t(pad2([g.cand_elev for g in scans], 0.0)),
            cand_dist=t(pad2([g.cand_dist for g in scans], 0.0)),
            cand_mask=t(pad2([g.cand_mask for g in scans], False)),
            dist=t(dist), hops=t(hops), nexthop=t(nexthop),
            n_vps=t(n_vps), vp_offset=t(vp_offset),
            feat=t(features, feat_dtype),
            feat_aug=t(aug_features if aug_features is not None else
                       np.zeros((0, 36, features.shape[2]), np.float32),
                       feat_dtype),
            **obj,
        )

    # gathers used by the rollout (scan = [B] scan index, vp = [B] local idx)
    def get_feat(self, scan, vp, use_aug=None):
        """[B, 36, Df] view features of (scan, vp); where use_aug [B] is
        True (and the world has them) the EnvEdit features."""
        idx = self.vp_offset[scan] + vp
        base = self.feat[idx]
        if use_aug is None or not self.has_aug:
            return base
        return torch.where(use_aug[:, None, None], self.feat_aug[idx], base)

    def get_cands(self, scan, vp):
        """All candidate tables for (scan, vp): each [B, K]."""
        return dict(
            local=self.cand_local[scan, vp],
            ptid=self.cand_ptid[scan, vp],
            heading=self.cand_heading[scan, vp],
            elev=self.cand_elev[scan, vp],
            dist=self.cand_dist[scan, vp],
            mask=self.cand_mask[scan, vp],
        )
