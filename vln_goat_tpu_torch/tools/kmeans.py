"""k-means and the FACL front-door dictionary picker (counterpart of
vln_goat_tpu/tools/kmeans.py).

The reference's KMeansPicker (map_nav_src/utils/data.py:403-480) clusters
the extracted CFP features (n_clusters=24, r2r/parser.py
front_n_clusters) and at every refresh picks one random member of each
cluster to form the front-door bank.  `kmeans_fit` seeds with kmeans++ on
the host, with the numpy draws of the JAX package's, then runs Lloyd
iterations in torch on the given device.  The CFP feature file the
picker clusters is read by `tools.cfp_extract.load_cfp_tsv`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """|x - c|^2 as |x|^2 - 2 x.c + |c|^2, the JAX package's arithmetic."""
    return ((x * x).sum(1, keepdim=True) - 2.0 * x @ centers.T
            + (centers * centers).sum(1)[None])


def _lloyd(x: torch.Tensor, centers: torch.Tensor,
           n_iter: int) -> Tuple[torch.Tensor, torch.Tensor]:
    k = centers.shape[0]
    for _ in range(n_iter):
        assign = _sq_dists(x, centers).argmin(1)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
        sums = onehot.T @ x
        cnts = onehot.sum(0)[:, None]
        centers = torch.where(cnts > 0, sums / cnts.clamp(min=1.0), centers)
    return centers, _sq_dists(x, centers).argmin(1)


def kmeans_fit(x: np.ndarray, n_clusters: int, n_iter: int = 50,
               seed: int = 0, device="cpu") -> Tuple[np.ndarray, np.ndarray]:
    """(centers [k, D], assignments [N]) of x [N, D]: kmeans++ seeding
    from numpy's default_rng(seed), then n_iter Lloyd iterations on
    `device` (an empty cluster keeps its center)."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    centers = np.empty((n_clusters, x.shape[1]), x.dtype)
    centers[0] = x[rng.integers(n)]
    d2 = np.sum((x - centers[0]) ** 2, 1)
    for k in range(1, n_clusters):
        p = d2 / max(d2.sum(), 1e-12)
        centers[k] = x[rng.choice(n, p=p)]
        d2 = np.minimum(d2, np.sum((x - centers[k]) ** 2, 1))
    c, a = _lloyd(torch.as_tensor(x, device=device),
                  torch.as_tensor(centers, device=device), n_iter)
    return c.cpu().numpy(), a.cpu().numpy()


class FrontDoorPicker:
    """KMeansPicker: k-means once over each CFP feature bank, then each
    `random_pick` takes one random member of every cluster per bank."""

    def __init__(self, feats: Dict[str, np.ndarray], n_clusters: int = 24,
                 seed: int = 0, device="cpu"):
        """feats: {"txt_feats": [N, D], "vp_feats": [N, D], "gmap_feats":
        [N, D]} (any subset)."""
        self.feats = feats
        self.n_clusters = n_clusters
        self.rng = np.random.default_rng(seed)
        self.assignments = {
            key: kmeans_fit(f.astype(np.float32), n_clusters, seed=seed,
                            device=device)[1]
            for key, f in feats.items()}

    def random_pick(self) -> Dict[str, np.ndarray]:
        """{bank: [n_clusters, D]}, one random member per cluster (all
        rows when a cluster is empty)."""
        out = {}
        for key, f in self.feats.items():
            assign = self.assignments[key]
            rows = []
            for k in range(self.n_clusters):
                members = np.nonzero(assign == k)[0]
                if len(members) == 0:
                    members = np.arange(len(f))
                rows.append(f[self.rng.choice(members)])
            out[key] = np.stack(rows, 0).astype(np.float32)
        return out
