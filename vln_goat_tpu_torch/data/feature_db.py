"""Image and object feature stores (counterpart of
vln_goat_tpu/data/feature_db.py: `ImageFeaturesDB`, `TsvFeaturesDB` and
the REVERIE / SOON object store `ObjectFeaturesDB`).  h5py is imported
only when a file is read.

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


class ObjectFeaturesDB:
    """REVERIE object store (reverie ObjectFeatureDB, reverie/env.py:46+,
    452-457): HDF5 keyed '{scan}_{vp}' -> [n_obj, Dobj] features with the
    attributes 'directions' [n_obj, 2], 'sizes' [n_obj, 2], 'obj_ids' and
    'names'; at most `max_objects` a viewpoint."""

    def __init__(self, obj_ft_file: str, obj_feat_size: int = 768,
                 angle_feat_size: int = 4, max_objects: int = 20,
                 image_w: int = 640, image_h: int = 480):
        self.path = obj_ft_file
        self.dim = obj_feat_size
        self.afs = angle_feat_size
        self.max_objects = max_objects
        self.image_w, self.image_h = image_w, image_h
        self._h5 = None

    _file = ImageFeaturesDB._file

    def as_packed_arrays(self, scan_graphs, scan_order: Sequence[str]
                         ) -> dict:
        """-> the `objects` dict of NavWorld.build, [Vtot, Lo, ...] arrays
        in scan order, Lo = max_objects: feat, loc (angle features of the
        absolute direction, then the box [h/H, w/W, hw/HW]), dir (the raw
        absolute (heading, elevation), from which the rollout computes the
        camera-relative angles each step), mask, name, oid (-1 pad)."""
        from ..core.geometry import angle_feature_np

        f = self._file()
        Lo = self.max_objects
        vtot = sum(scan_graphs[s].num_vps for s in scan_order)
        out = dict(
            feat=np.zeros((vtot, Lo, self.dim), np.float32),
            loc=np.zeros((vtot, Lo, self.afs + 3), np.float32),
            dir=np.zeros((vtot, Lo, 2), np.float32),
            mask=np.zeros((vtot, Lo), bool),
            name=np.zeros((vtot, Lo), np.int32),
            oid=np.full((vtot, Lo), -1, np.int32),
        )
        row = 0
        area = self.image_w * self.image_h
        for s in scan_order:
            for vp in scan_graphs[s].vp_ids:
                key = f"{s}_{vp}"
                if key in f:
                    ds = f[key]
                    n = min(ds.shape[0], Lo)
                    out["feat"][row, :n] = ds[...][:n, :self.dim]
                    att = dict(ds.attrs)
                    dirs = np.asarray(att.get("directions",
                                              np.zeros((n, 2))))[:n]
                    sizes = np.asarray(att.get("sizes",
                                               np.zeros((n, 2))))[:n]
                    out["loc"][row, :n, :self.afs] = angle_feature_np(
                        dirs[:, 0], dirs[:, 1], self.afs)
                    out["dir"][row, :n] = dirs
                    a = self.afs
                    out["loc"][row, :n, a] = sizes[:, 1] / self.image_h
                    out["loc"][row, :n, a + 1] = sizes[:, 0] / self.image_w
                    out["loc"][row, :n, a + 2] = \
                        sizes[:, 0] * sizes[:, 1] / area
                    out["mask"][row, :n] = True
                    names = np.asarray(att.get("names", np.zeros(n)))[:n]
                    out["name"][row, :n] = names.astype(np.int32)
                    oids = np.asarray(att.get("obj_ids", np.arange(n)))[:n]
                    out["oid"][row, :n] = oids.astype(np.int32)
                row += 1
        return out
