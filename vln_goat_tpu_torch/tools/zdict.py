"""BACL back-door dictionaries and the causal banks of a batch: the TSV
loaders, the broadcast over a batch, and the bank names the rollout reads
(counterpart of the numpy half of vln_goat_tpu/tools/zdict.py and of the
bank half of the JAX package's cli.py `_load_causal_banks`,
`_refresh_front_dict` and `causal_batch`).

The TSVs are the reference's LoadZdict files (map_nav_src/r2r/
data_utils.py:44-122): tab-separated, no header, each feature a base64
float32 vector.  The online z-dict update and `WordPicker` are not ported.
"""
from __future__ import annotations

import base64
import csv
import sys
from typing import Dict, Mapping

import numpy as np
import torch

# the reference's direction/action word list (utils/data.py:204-210): the
# rows of the instruction direction bank
DIRECTION_WORDS = [
    "right", "left", "down", "up", "forward", "around", "straight",
    "into", "front", "behind", "exit", "enter", "besides", "through",
    "stop", "out", "wait", "passed", "climb", "leave", "past", "before",
    "after", "between", "in", "along", "cross", "end", "head", "inside",
    "outside", "across", "towards", "face", "ahead", "toward",
]

# landmark nouns used when no category mapping is given: the rows of the
# instruction landmark bank
FALLBACK_LANDMARKS = [
    "door", "stairs", "stair", "room", "table", "chair", "kitchen",
    "bathroom", "bedroom", "hallway", "hall", "window", "couch", "sofa",
    "bed", "desk", "counter", "sink", "mirror", "lamp", "rug", "plant",
    "picture", "painting", "shelf", "cabinet", "closet", "fireplace",
    "television", "tv", "toilet", "shower", "bathtub", "refrigerator",
    "oven", "stove", "wall", "floor", "ceiling", "railing", "balcony",
    "garage", "office", "living", "dining", "entrance", "doorway",
]

IMG_TSV_FIELDS = ["roomtype", "feature", "pz"]
TXT_TSV_FIELDS = ["token_type", "token", "feature", "pz"]


def _feature(field: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(field), np.float32)


def load_instr_zdict_tsv(path: str) -> Dict[str, np.ndarray]:
    """Instruction z-dict TSV (token_type, token, feature, pz) ->
    {"instr_landmark_features" [N, D], "instr_landmark_pzs" [N], and, when
    the file has direction rows, "instr_direction_features" /
    "instr_direction_pzs"}."""
    csv.field_size_limit(sys.maxsize)
    rows: Dict[str, tuple] = {"direction": ([], []), "landmark": ([], [])}
    with open(path) as f:
        for it in csv.DictReader(f, delimiter="\t",
                                 fieldnames=TXT_TSV_FIELDS):
            if it["token_type"] in rows:
                feats, pzs = rows[it["token_type"]]
                feats.append(_feature(it["feature"]))
                pzs.append(float(it["pz"]))
    out = {}
    for kind in ("landmark", "direction"):
        feats, pzs = rows[kind]
        if feats or kind == "landmark":
            out[f"instr_{kind}_features"] = np.stack(feats, 0)
            out[f"instr_{kind}_pzs"] = np.asarray(pzs, np.float32)
    return out


def load_img_zdict_tsv(path: str) -> Dict[str, np.ndarray]:
    """Image z-dict TSV (roomtype, feature, pz) -> {"img_features" [N, D],
    "img_pzs" [N]}."""
    csv.field_size_limit(sys.maxsize)
    feats, pzs = [], []
    with open(path) as f:
        for it in csv.DictReader(f, delimiter="\t",
                                 fieldnames=IMG_TSV_FIELDS):
            feats.append(_feature(it["feature"]))
            pzs.append(float(it["pz"]))
    return {"img_features": np.stack(feats, 0),
            "img_pzs": np.asarray(pzs, np.float32)}


def instr_bank_names(zd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The loader's instr_* keys under the names the rollout reads,
    instr_z_* (the JAX package's cli.py:421-426)."""
    return {k.replace("instr_", "instr_z_", 1): v for k, v in zd.items()}


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
FRONT_BANKS = {"txt_feats": ("front_txt_feats", "do_front_txt"),
               "vp_feats": ("front_vp_feats", "do_front_img"),
               "gmap_feats": ("front_gmap_feats", "do_front_his")}

# batch keys that hold banks shared by every episode, not per-episode rows
# (the JAX package's rollout.py `_SHARED_BANKS`): whatever slices or
# reorders a batch by episode must carry these through whole
SHARED_BANKS = frozenset({
    "img_z_features", "img_z_pzs", "instr_z_direction_features",
    "instr_z_direction_pzs", "instr_z_landmark_features",
    "instr_z_landmark_pzs", "front_txt_feats", "front_vp_feats",
    "front_gmap_feats"})


def front_banks(pick: Mapping[str, np.ndarray], cfg) -> Dict[str,
                                                            np.ndarray]:
    """The front-door banks of one `FrontDoorPicker.random_pick` under
    their batch keys, for the front-door flags `cfg` sets."""
    return {dst: pick[src] for src, (dst, flag) in FRONT_BANKS.items()
            if getattr(cfg, flag) and src in pick}


def causal_batch(banks: Mapping[str, np.ndarray],
                 batch: Mapping[str, torch.Tensor]) -> Dict[str,
                                                            torch.Tensor]:
    """A copy of the episode batch with every bank broadcast over its
    episodes on the batch's device."""
    B = batch["scan_idx"].shape[0]
    return {**batch, **broadcast_zdict(banks, B,
                                       batch["scan_idx"].device)}
