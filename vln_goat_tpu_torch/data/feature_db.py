"""Image feature stores (counterpart of vln_goat_tpu/data/feature_db.py:
`ImageFeaturesDB` and `TsvFeaturesDB`; the REVERIE object store waits for
the object branch).

Reference: ImageFeaturesDB (map_nav_src/utils/data.py:25-74) — HDF5 keyed
'{scan}_{vp}' -> (36, Df) with an in-RAM cache, plus a base64-TSV path, and
EnvEdit augmented-feature alternation (r2r/env.py:78-84).

TPU-native difference: rather than per-step lookups, `as_packed_array`
materializes the whole store as one [Vtot, 36, Df] array in scan order for
NavWorld residency (the rollout then never touches the host).
"""
from __future__ import annotations

import base64
import csv
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np


class ImageFeaturesDB:
    def __init__(self, img_ft_file: str, image_feat_size: int = 768):
        self.path = img_ft_file
        self.dim = image_feat_size
        self._cache: Dict[str, np.ndarray] = {}
        self._h5 = None

    def _file(self):
        if self._h5 is None:
            try:
                import h5py
            except ImportError as e:
                raise ImportError(
                    f"reading the HDF5 feature file {self.path} needs h5py, "
                    "which is not installed") from e
            self._h5 = h5py.File(self.path, "r")
        return self._h5

    def get_image_feature(self, scan: str, viewpoint: str) -> np.ndarray:
        key = f"{scan}_{viewpoint}"
        if key not in self._cache:
            ft = self._file()[key][...][:, :self.dim].astype(np.float32)
            self._cache[key] = ft
        return self._cache[key]

    def as_packed_array(self, scan_graphs, scan_order: Sequence[str]
                        ) -> np.ndarray:
        """[sum V_s, 36, Df] in (scan, local-vp) order for NavWorld.build."""
        chunks = []
        for s in scan_order:
            g = scan_graphs[s]
            chunks.append(np.stack(
                [self.get_image_feature(s, vp) for vp in g.vp_ids], 0))
        return np.concatenate(chunks, 0)

    def as_packed_probs(self, scan_graphs, scan_order: Sequence[str],
                        prob_size: int) -> np.ndarray:
        """[sum V_s, 36, P] softmaxed CLIP-class probabilities from the
        columns AFTER the image features — the reference stores MRC soft
        labels appended to each view's feature row and softmaxes them at
        sample time (pretrain_src/data/dataset.py:245,420-422)."""
        chunks = []
        for s in scan_order:
            g = scan_graphs[s]
            rows = []
            for vp in g.vp_ids:
                key = f"{s}_{vp}"
                ft = self._file()[key][...]
                logits = ft[:, self.dim:self.dim + prob_size] \
                    .astype(np.float32)
                e = np.exp(logits - logits.max(-1, keepdims=True))
                rows.append(e / e.sum(-1, keepdims=True))
            chunks.append(np.stack(rows, 0))
        return np.concatenate(chunks, 0)


class TsvFeaturesDB:
    """base64 TSV features (utils/data.py:48-74 path)."""

    def __init__(self, tsv_file: str, image_feat_size: int = 768):
        csv.field_size_limit(sys.maxsize)
        self.dim = image_feat_size
        self._store: Dict[str, np.ndarray] = {}
        fields = ["scanId", "viewpointId", "features"]
        with open(tsv_file) as f:
            for row in csv.DictReader(f, delimiter="\t", fieldnames=fields):
                ft = np.frombuffer(base64.b64decode(row["features"]),
                                   np.float32).reshape(36, -1)[:, :self.dim]
                self._store[f"{row['scanId']}_{row['viewpointId']}"] = ft

    def get_image_feature(self, scan: str, viewpoint: str) -> np.ndarray:
        return self._store[f"{scan}_{viewpoint}"]
