"""BACL back-door dictionaries and the causal banks of a batch: the TSV
loaders and writers, the broadcast over a batch, the bank names the
rollout reads, and the online instruction z-dict update (counterpart of
vln_goat_tpu/tools/zdict.py and of the bank half of the JAX package's
cli.py `_load_causal_banks`, `_refresh_front_dict` and `causal_batch`).

The TSVs are the reference's LoadZdict files (map_nav_src/r2r/
data_utils.py:44-122): tab-separated, no header, each feature a base64
float32 vector.

The online update (agent.update_z_dict, r2r/agent.py:713-848): the
instructions go through the plain language tower (`GoatModel.forward_text`
without banks), the embeddings of the landmark and direction words that
`WordPicker` finds are harvested at their first subword, and each key's
mean embedding and empirical p(z) make the new bank.  spaCy and WordNet
are not used, as in the JAX package: `WordPicker` is a gazetteer over
`category_mapping.tsv` (or a built-in noun list) with plural stripping.
Every dict keeps first-seen insertion order: that order is the row order
of the banks and of the TSV.
"""
from __future__ import annotations

import base64
import csv
import re
import sys
from collections import defaultdict
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

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

# landmark nouns used when no category mapping is given
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


def _lemma(word: str) -> str:
    """Noun lemmatisation without WordNet (the reference's
    WordNetLemmatizer, utils/data.py:214): English plural stripping."""
    if len(word) > 3 and word.endswith("ies"):
        return word[:-3] + "y"
    if len(word) > 3 and word.endswith(("ches", "shes", "sses", "xes",
                                        "zes")):
        return word[:-2]
    if len(word) > 2 and word.endswith("s") and not word.endswith("ss"):
        return word[:-1]
    return word


def word_tokenize(instr: str) -> List[str]:
    """Words and punctuation as separate tokens: the index space of
    PickSpecificWords (utils/data.py:263-288)."""
    return re.findall(r"\w+|[^\w\s]", instr)


class WordPicker:
    """pick_action_object_words_with_index (utils/data.py:263-288):
    `pick(instr)` -> (landmarks, directions), each [(token index, key)]
    over word_tokenize(instr).  A landmark key is the CATEGORY its noun
    maps to in `cat_file` (category_mapping.tsv: a header line, then the
    source noun in column 2 and the category in the last), or the noun
    itself from FALLBACK_LANDMARKS; a direction key is the lowered word."""

    def __init__(self, cat_file: Optional[str] = None):
        self.landmark_map: Dict[str, str] = {}
        if cat_file:
            with open(cat_file, encoding="utf-8") as f:
                next(f)
                for line in f:
                    parts = line.strip("\n").split("\t")
                    self.landmark_map[parts[1]] = parts[-1]
        else:
            for w in FALLBACK_LANDMARKS:
                self.landmark_map[w] = w
        self.direction_set = set(DIRECTION_WORDS)

    def pick(self, instr: str) -> Tuple[List[Tuple[int, str]],
                                        List[Tuple[int, str]]]:
        landmarks, directions = [], []
        for i, raw in enumerate(word_tokenize(instr)):
            low = raw.lower()
            # the landmark normalisation (utils/data.py:211-215): strip
            # punctuation, lemmatise, drop digits
            name = _lemma(re.sub(r"[^\w\s]", " ", low).strip())
            name = "".join(c for c in name if not c.isdigit())
            if name in self.landmark_map:
                landmarks.append((i, self.landmark_map[name]))
            if low in self.direction_set:
                directions.append((i, low))
        return landmarks, directions


def subword_tokens_of(enc: Sequence[int], id_to_token: Dict[int, str],
                      special_ids: Sequence[int] = (0, 1, 2)) -> List[str]:
    """convert_ids_to_tokens(enc, skip_special_tokens=True) from an
    id -> token vocabulary (agent.py:781): token j is row j + 1 of the
    language tower's output (one leading special token)."""
    sp = set(special_ids)
    return [id_to_token[int(t)] for t in enc if int(t) not in sp]


def align_word_embeddings(tokens: List[str], embeds: np.ndarray,
                          picks: List[Tuple[int, str]],
                          is_continuation: Callable[[str], bool],
                          cls_offset: int = 1
                          ) -> List[Tuple[str, np.ndarray]]:
    """Word picks -> (key, embedding of the word's first subword)
    (agent.py:778-799: continuations skipped, +1 for the leading token)."""
    out = []
    word_idx = -1
    pick_map = defaultdict(list)
    for i, key in picks:
        pick_map[i].append(key)
    for j, tok in enumerate(tokens):
        if is_continuation(tok):
            continue
        word_idx += 1
        for key in pick_map.get(word_idx, []):
            if j + cls_offset < len(embeds):
                out.append((key, embeds[j + cls_offset]))
    return out


def _summarize(d: Dict[str, list]):
    total = sum(len(v) for v in d.values()) or 1
    feats = {k: np.mean(np.stack(v, 0), 0) for k, v in d.items()}
    return feats, {k: len(v) / total for k, v in d.items()}


@torch.no_grad()
def update_instr_zdict(model, instr_data: Sequence[dict],
                       word_picker: WordPicker,
                       tokens_of: Callable[[dict], List[str]],
                       is_continuation: Callable[[str], bool],
                       batch_size: int = 64, max_len: int = 200):
    """agent.update_z_dict: `model` (a GoatModel) encodes the items'
    `instr_encoding` in chunks of `batch_size` at the one width `max_len`
    (one shape for the fused attention), in eval mode and without
    gradients, on its own device.  Returns ({"instr_zdict": the new
    banks}, landmark features, direction features, landmark p(z),
    direction p(z)), the dicts in first-seen order."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    landmark_dict, direction_dict = defaultdict(list), defaultdict(list)
    try:
        for i in range(0, len(instr_data), batch_size):
            chunk = list(instr_data[i:i + batch_size])
            ids = np.zeros((len(chunk), max_len), np.int64)
            mask = np.zeros((len(chunk), max_len), bool)
            for b, d in enumerate(chunk):
                enc = list(d["instr_encoding"])[:max_len]
                ids[b, :len(enc)] = enc
                mask[b, :len(enc)] = True
            out = model.forward_text(torch.as_tensor(ids, device=dev),
                                     torch.as_tensor(mask, device=dev))
            out = out.float().cpu().numpy()
            for b, d in enumerate(chunk):
                landmarks, directions = word_picker.pick(d["instruction"])
                toks = tokens_of(d)
                for picks, into in ((landmarks, landmark_dict),
                                    (directions, direction_dict)):
                    for key, emb in align_word_embeddings(
                            toks, out[b], picks, is_continuation):
                        into[key].append(emb)
    finally:
        model.train(was_training)
    lm_feats, lm_pz = _summarize(landmark_dict)
    dr_feats, dr_pz = _summarize(direction_dict)

    def bank(feats):
        return np.stack(list(feats.values()), 0) if feats \
            else np.zeros((0, 768), np.float32)

    new = {"instr_direction_features": bank(dr_feats),
           "instr_direction_pzs": np.asarray(list(dr_pz.values()),
                                             np.float32),
           "instr_landmark_features": bank(lm_feats),
           "instr_landmark_pzs": np.asarray(list(lm_pz.values()),
                                            np.float32)}
    return {"instr_zdict": new}, lm_feats, dr_feats, lm_pz, dr_pz


def _b64(val: np.ndarray) -> str:
    return base64.b64encode(val.astype(np.float32)).decode()


def save_instr_zdict_tsv(path: str, landmark_feats: Dict[str, np.ndarray],
                         direction_feats: Dict[str, np.ndarray],
                         landmark_pz: Dict[str, float],
                         direction_pz: Dict[str, float]) -> None:
    """save_backdoor_z_dict (agent.py:850-871): the landmark rows, then the
    direction rows, in the dicts' order."""
    with open(path, "wt") as f:
        w = csv.DictWriter(f, delimiter="\t", fieldnames=TXT_TSV_FIELDS)
        for kind, feats, pzs in (("landmark", landmark_feats, landmark_pz),
                                 ("direction", direction_feats,
                                  direction_pz)):
            for key, val in feats.items():
                w.writerow({"token_type": kind, "token": key,
                            "feature": _b64(val), "pz": pzs[key]})


def save_img_zdict_tsv(path: str, feats: Dict[str, np.ndarray],
                       pzs: Dict[str, float]) -> None:
    """The image z-dict TSV (roomtype, feature, pz), in the dict's order."""
    with open(path, "wt") as f:
        w = csv.DictWriter(f, delimiter="\t", fieldnames=IMG_TSV_FIELDS)
        for key, val in feats.items():
            w.writerow({"roomtype": key, "feature": _b64(val),
                        "pz": pzs[key]})


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
