"""Offline confounder-dictionary tooling (counterpart of
vln_goat_tpu/tools/do_utils.py; numpy and the standard library, the TSVs
through the port's own tools/zdict.py writers).

Reference: map_nav_src/do_utils/
- extract_room_type.py (:67-156): renders 36 views per viewpoint and asks
  BLIP-VQA "What kind of room is this?" -> pano_roomtypes.tsv.  Rendering
  is a MatterSim-only capability; here the VQA step is a pluggable callable
  over user-provided view images (the precomputed-features live path never
  needs rendering, SURVEY.md section 2.3), and the rest of the pipeline —
  per-view answers -> per-viewpoint room-type rows -> TSV — is complete.
- do_intervention.py: ImageReader.build_zdict_and_pz (:118-148): top-K room
  types over seen scans, mean CLIP view feature + empirical p(z) ->
  image_z_dict TSV; TextReader.build_zdict_and_pz (:196-269): mean token
  embeddings of landmark/direction words -> instruction z-dict TSV.
"""
from __future__ import annotations

import csv
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .zdict import save_img_zdict_tsv, save_instr_zdict_tsv

ROOMTYPE_TSV_FIELDS = ["scan", "viewpoint", "roomtypes"]
VQA_QUESTION = "What kind of room is this?"


def extract_room_types(scan_vps: Sequence[tuple],
                       vqa_fn: Callable[[np.ndarray, str], str],
                       render_fn: Callable[[str, str, int], np.ndarray],
                       out_tsv: str):
    """For each (scan, viewpoint): VQA over the 36 rendered views ->
    per-view room-type answers (extract_room_type.py:90-156).

    render_fn(scan, vp, view_ix) -> HxWx3 uint8; vqa_fn(image, question)
    -> answer string.  Both are injected: rendering needs scan meshes and
    VQA needs BLIP weights, neither of which this framework requires for
    train/eval.
    """
    with open(out_tsv, "wt") as f:
        w = csv.DictWriter(f, delimiter="\t", fieldnames=ROOMTYPE_TSV_FIELDS)
        for scan, vp in scan_vps:
            answers = [vqa_fn(render_fn(scan, vp, ix), VQA_QUESTION)
                       for ix in range(36)]
            w.writerow({"scan": scan, "viewpoint": vp,
                        "roomtypes": ",".join(answers)})


def make_blip_vqa(model_path: str, device="cuda"
                  ) -> Callable[[np.ndarray, str], str]:
    """In-repo BLIP-VQA adapter (extract_room_type.py:77,96-100
    build_feature_extractor + generate): loads BlipForQuestionAnswering +
    BlipProcessor from a LOCAL path (e.g. a Salesforce/blip-vqa-base
    snapshot; this framework ships no weights and downloads nothing) and
    returns the vqa_fn plugged into extract_room_types, the model on
    `device` (the card unless asked).  Raises RuntimeError with a clear
    message when the device, transformers or the weights are absent."""
    import os

    import torch

    from ..device import resolve

    device = resolve(device)
    if not os.path.isdir(model_path):
        raise RuntimeError(f"BLIP weights not found: {model_path!r} is not "
                           "a local Salesforce/blip-vqa-base snapshot")
    try:
        from transformers import BlipForQuestionAnswering, BlipProcessor
    except Exception as e:
        raise RuntimeError(f"BLIP-VQA needs the transformers package, "
                           f"which is not installed: {e}")
    try:
        processor = BlipProcessor.from_pretrained(model_path,
                                                  local_files_only=True)
        model = BlipForQuestionAnswering.from_pretrained(
            model_path, local_files_only=True)
    except Exception as e:
        raise RuntimeError(
            f"BLIP weights not loadable from {model_path!r} "
            f"(download Salesforce/blip-vqa-base there): {e}")
    model = model.to(device).eval()

    def vqa_fn(image: np.ndarray, question: str) -> str:
        from PIL import Image

        with torch.no_grad():
            pil = Image.fromarray(np.asarray(image, np.uint8))
            inputs = processor(images=pil, text=question,
                               return_tensors="pt").to(device)
            out = model.generate(**inputs)
        return processor.decode(out[0], skip_special_tokens=True)

    return vqa_fn


def _pool_worker(proc_id: int, out_q, scan_vps: Sequence[tuple],
                 make_vqa_fn, make_render_fn, batch_size: int):
    """One extraction worker (extract_room_type.process_features,
    :67-106): builds its own renderer + VQA model (neither is picklable —
    the factories are), sweeps the 36 discretized views per viewpoint,
    answers in batches, and streams (scan, vp, answers) rows to the
    writer.  A trailing None marks worker exit, also when a factory or a
    call raises (the parent then finds the worker's exit code non-zero)."""
    try:
        vqa_fn = make_vqa_fn()
        render_fn = make_render_fn()
        for scan, vp in scan_vps:
            images = [render_fn(scan, vp, ix) for ix in range(36)]
            answers: List[str] = []
            for k in range(0, 36, batch_size):
                # the reference decodes only the first answer per batch
                # (extract_room_type.py:100-101 decode(outputs[0])) — a
                # quirk we do NOT reproduce: answer every view
                answers.extend(vqa_fn(img, VQA_QUESTION)
                               for img in images[k: k + batch_size])
            out_q.put((scan, vp, answers))
    finally:
        out_q.put(None)


def extract_room_types_pooled(scan_vps: Sequence[tuple],
                              make_vqa_fn: Callable[[], Callable],
                              make_render_fn: Callable[[], Callable],
                              out_tsv: str, num_workers: int = 4,
                              batch_size: int = 8, resume: bool = True,
                              progress: Optional[Callable[[int], None]] = None
                              ) -> int:
    """Multi-process room-type extraction
    (extract_room_type.build_feature_file, :109-156): contiguous chunks of
    the viewpoint list per worker, a shared result queue, and a single
    TSV writer in the parent.  Improvements over the reference: `resume`
    skips viewpoints already present in `out_tsv` (the reference always
    restarts from scratch), and rows are flushed as they arrive so a
    killed run loses nothing.  Returns the number of rows written; raises
    RuntimeError, after the other workers end, when a worker failed.

    make_vqa_fn/make_render_fn are zero-arg factories evaluated INSIDE
    each worker (e.g. ``partial(make_blip_vqa, path)``) because the models
    themselves don't pickle."""
    import multiprocessing as mp
    import os

    scan_vps = list(scan_vps)
    mode = "wt"
    if resume and os.path.exists(out_tsv):
        done = set(load_room_types(out_tsv))
        scan_vps = [sv for sv in scan_vps if tuple(sv) not in done]
        mode = "at"
    if not scan_vps:
        return 0
    ctx = mp.get_context("spawn")  # torch (maybe CUDA) in the parent
    nw = max(1, min(num_workers, len(scan_vps)))
    per = len(scan_vps) // nw
    out_q = ctx.Queue()
    procs = []
    for p in range(nw):
        lo = p * per
        hi = None if p == nw - 1 else lo + per
        proc = ctx.Process(target=_pool_worker,
                           args=(p, out_q, scan_vps[lo:hi], make_vqa_fn,
                                 make_render_fn, batch_size))
        proc.start()
        procs.append(proc)
    written = 0
    finished = 0
    with open(out_tsv, mode) as f:
        w = csv.DictWriter(f, delimiter="\t", fieldnames=ROOMTYPE_TSV_FIELDS)
        while finished < nw:
            res = out_q.get()
            if res is None:
                finished += 1
                continue
            scan, vp, answers = res
            w.writerow({"scan": scan, "viewpoint": vp,
                        "roomtypes": ",".join(answers)})
            f.flush()
            written += 1
            if progress is not None:
                progress(written)
    for proc in procs:
        proc.join()
    failed = [p for p, proc in enumerate(procs) if proc.exitcode != 0]
    if failed:
        raise RuntimeError(f"room-type workers {failed} failed (exit codes "
                           f"{[procs[p].exitcode for p in failed]}); the "
                           f"rows they wrote before are in {out_tsv}")
    return written


def load_room_types(tsv_path: str) -> Dict[tuple, List[str]]:
    out = {}
    with open(tsv_path) as f:
        for row in csv.DictReader(f, delimiter="\t",
                                  fieldnames=ROOMTYPE_TSV_FIELDS):
            out[(row["scan"], row["viewpoint"])] = row["roomtypes"].split(",")
    return out


def build_image_zdict(room_types: Dict[tuple, List[str]],
                      view_features: Callable[[str, str], np.ndarray],
                      seen_scans: Sequence[str], top_k: int = 50,
                      out_tsv: Optional[str] = None):
    """Image back-door dictionary (do_intervention.py:118-148): for the
    top_k room types over seen scans, the mean CLIP view feature of every
    view labeled with that type, plus empirical p(z)."""
    counts = Counter()
    for (scan, vp), types in room_types.items():
        if scan not in seen_scans:
            continue
        counts.update(types)
    keep = [t for t, _ in counts.most_common(top_k)]
    keep_set = set(keep)

    sums: Dict[str, np.ndarray] = {}
    ns: Dict[str, int] = defaultdict(int)
    for (scan, vp), types in room_types.items():
        if scan not in seen_scans:
            continue
        feats = view_features(scan, vp)          # [36, Df]
        for ix, t in enumerate(types[:36]):
            if t not in keep_set:
                continue
            if t not in sums:
                sums[t] = np.zeros(feats.shape[-1], np.float64)
            sums[t] += feats[ix]
            ns[t] += 1

    total = sum(ns.values()) or 1
    feats_out = {t: (sums[t] / ns[t]).astype(np.float32) for t in sums}
    pz = {t: ns[t] / total for t in sums}
    if out_tsv:
        save_img_zdict_tsv(out_tsv, feats_out, pz)
    return feats_out, pz


def build_text_zdict(landmark_words: Dict[str, int],
                     direction_words: Dict[str, int],
                     embed_fn: Callable[[str], np.ndarray],
                     out_tsv: Optional[str] = None):
    """Instruction back-door dictionary from word embeddings + corpus
    frequencies (do_intervention.py:196-269): key -> (embedding, p(z))."""
    def summarize(words: Dict[str, int]):
        total = sum(words.values()) or 1
        feats = {w: embed_fn(w).astype(np.float32) for w in words}
        pz = {w: c / total for w, c in words.items()}
        return feats, pz

    lm_f, lm_p = summarize(landmark_words)
    dr_f, dr_p = summarize(direction_words)
    if out_tsv:
        save_instr_zdict_tsv(out_tsv, lm_f, dr_f, lm_p, dr_p)
    return (lm_f, lm_p), (dr_f, dr_p)


def count_corpus_words(instructions: Sequence[str], picker) -> tuple:
    """Corpus landmark/direction frequencies via the WordPicker."""
    lm, dr = Counter(), Counter()
    for instr in instructions:
        landmarks, directions = picker.pick(instr)
        lm.update(k for _, k in landmarks)
        dr.update(k for _, k in directions)
    return dict(lm), dict(dr)
