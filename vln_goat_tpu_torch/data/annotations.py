"""Annotation loading: R2R/RxR/REVERIE instruction datasets (a copy of
vln_goat_tpu/data/annotations.py, which imports nothing of JAX).

Reference: construct_instrs (map_nav_src/r2r/data_utils.py:160-191) —
expands the ~3 instructions per path into separate items, filters RxR to
English when requested, builds `val_train_seen` as a 50-item train subset
(:149-151), and `--for_debug` truncation (:176,188).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence


def load_instr_datasets(anno_dir: str, dataset: str, splits: Sequence[str],
                        tokenizer: str = "roberta") -> Dict[str, list]:
    out = {}
    for split in splits:
        if dataset == "rxr":
            path = os.path.join(anno_dir, f"rxr_{split}_guide_enc_xlmr.jsonl")
            data = [json.loads(line) for line in open(path)]
        elif dataset == "soon":
            # SOON pseudo-obj-label jsonl (the filename the reference's
            # offline tooling reads, do_utils/do_intervention.py:343; the
            # reference never shipped its soon/ env — this loader defines
            # the schema our framework accepts: DUET-style items with
            # `instructions` as dicts carrying 'full')
            path = os.path.join(anno_dir,
                                f"{split}_enc_pseudo_obj_label.jsonl")
            data = [json.loads(line) for line in open(path)]
        else:
            name = {"r2r": "R2R", "reverie": "REVERIE"}[dataset]
            # reference filename scheme (data_utils.py:136-144)
            enc = {"roberta": "roberta_enc", "xlm": "enc_xlmr",
                   "bert": "enc"}[tokenizer]
            path = os.path.join(anno_dir, f"{name}_{split}_{enc}.json")
            with open(path) as f:
                data = json.load(f)
            if split == "val_train_seen":
                # 50 raw paths BEFORE instruction expansion
                # (data_utils.py:149-151)
                data = data[:50]
        out[split] = data
    return out


def construct_instrs(anno_dir: str, dataset: str, splits: Sequence[str],
                     tokenizer: str = "roberta", max_instr_len: int = 200,
                     for_debug: bool = False,
                     english_only: bool = True) -> Dict[str, List[dict]]:
    """split -> flat items {instr_id, scan, path, heading, instruction,
    instr_encoding, (objId for REVERIE)}."""
    raw = load_instr_datasets(anno_dir, dataset, splits, tokenizer)
    out: Dict[str, List[dict]] = {}
    for split, data in raw.items():
        out[split] = _expand_items(data, dataset, max_instr_len,
                                   english_only, for_debug)

    # val_train_seen comes from its own annotation file, 50 raw paths
    # sliced pre-expansion in load_instr_datasets — no synthesis from train
    return out


def _expand_items(data: list, dataset: str, max_instr_len: int,
                  english_only: bool, for_debug: bool) -> List[dict]:
    items = []
    for item in data:
        if dataset == "rxr":
            if english_only and "en" not in item.get("language", "en"):
                continue
            items.append(dict(
                instr_id=f"{item['path_id']}_{item.get('instruction_id', 0)}",
                path_id=item["path_id"], scan=item["scan"],
                path=item["path"], heading=item.get("heading", 0.0),
                instruction=item.get("instruction", ""),
                instr_encoding=item["instr_encoding"][:max_instr_len],
            ))
        else:
            for j, instr in enumerate(item.get("instructions", [""])):
                if isinstance(instr, dict):
                    # SOON: instruction entries are dicts; 'full' is the
                    # complete instruction (do_intervention.py:166-170)
                    instr = instr.get("full", "")
                encs = item.get("instr_encodings", [[]] * (j + 1))
                new = dict(
                    instr_id=f"{item['path_id']}_{j}",
                    path_id=item["path_id"], scan=item["scan"],
                    path=item["path"], heading=item.get("heading", 0.0),
                    instruction=instr,
                    instr_encoding=encs[j][:max_instr_len],
                )
                if "objId" in item:
                    new["objId"] = item["objId"]
                    new["instr_id"] = \
                        f"{item['path_id']}_{item['objId']}_{j}"
                elif "obj_pseudo_label" in item:
                    # SOON pseudo object label: keep the object id for the
                    # grounding head (use_obj_name=False preset)
                    new["objId"] = item["obj_pseudo_label"].get("obj_id", 0)
                    new["instr_id"] = \
                        f"{item['path_id']}_{new['objId']}_{j}"
                items.append(new)
    if for_debug:
        items = items[:50]
    return items


def load_annotation_file(path: str, dataset: str, tokenizer: str = "roberta",
                         max_instr_len: int = 200, for_debug: bool = False,
                         english_only: bool = True) -> List[dict]:
    """Load one explicit annotation file (json list or jsonl) into flat
    items — used for the --aug trajectory dataset (main_nav.py:82-97 builds
    an R2RNavBatch directly over args.aug)."""
    if path.endswith(".jsonl"):
        data = [json.loads(line) for line in open(path)]
    else:
        with open(path) as f:
            data = json.load(f)
    return _expand_items(data, dataset, max_instr_len, english_only,
                         for_debug)


def load_obj2vps(bbox_file: str) -> Dict[tuple, List[str]]:
    """REVERIE object -> goal-viewpoints mapping from the BBoxes JSON
    (reverie/data_utils.py:226-237): (scan, objid) -> [viewpoints where the
    object is visible]."""
    import json as _json

    obj2vps: Dict[tuple, List[str]] = {}
    with open(bbox_file) as f:
        data = _json.load(f)
    for scanvp, objs in data.items():
        scan, vp = scanvp.split("_")
        for objid, info in objs.items():
            if info.get("visible_pos"):
                obj2vps.setdefault((scan, str(objid)), []).append(vp)
    return obj2vps
