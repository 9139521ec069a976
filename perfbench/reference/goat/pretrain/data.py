"""Host-side trajectory batches of the port (its own copy of
vln_goat_tpu/pretrain/data.py, numpy only, on the port's `core.geometry`
and `sim.graph_sim`): trajectory sampling + static-shape batch building.
Given the same seed its batches equal the JAX package's bit for bit.
Pretraining (`pretrain.cli`, every task) and CFP extraction
(`tools.cfp_extract`, `build_batch(items, task="cfp")`) build their
batches here.

Reference: pretrain_src/data/dataset.py (R2RTextPathData :582,
ReverieTextPathData :133) and the task collates in data/tasks.py.  One
`TrajBatchBuilder.build` call replaces get_input + the per-task collate:
it emits every tensor the GoatPretrainModel tasks need, in fixed shapes,
including the aggregation index maps (gmap_visited_step / cand_to_gmap)
that replace the reference's dict-keyed gmap feature aggregation.

Sampling semantics preserved:
- end viewpoint: 'pos' (trajectory endpoint) / 'neg_in_gt_path' (random mid
  node) / 'neg_others' (random non-path node); ratios per task
  (tasks.py:206-211, 344-350);
- trajectory truncation at TRAIN_MAX_STEP (dataset.py:371-373);
- pano token order [cand views | noncand views] with angles relative to
  view 12 (+ optional cur-heading correction) (dataset.py:439-505);
- act labels: stop=0 at goal else the slot of the gt next node
  (dataset.py:616-632);
- MLM 80/10/10 masking (tasks.py:11-52); MRC view masking with soft
  CLIP-prob targets (tasks.py:189-324).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core import geometry as G
from ..sim.graph_sim import ScanGraph

TRAIN_MAX_STEP = 20


@dataclass
class PretrainShapes:
    max_txt_len: int = 80
    max_steps: int = 10          # T (reference truncates at 20)
    max_cands: int = 16          # K
    max_gmap: int = 64           # G tokens incl [stop]
    max_mlm: int = 16            # M masked positions
    mrc_prob_dim: int = 64       # P soft-label classes (1000 for real CLIP)
    max_objs: int = 0            # Lo (REVERIE)

    @property
    def pano_len(self):
        return self.max_cands + 36


class TrajBatchBuilder:
    def __init__(self, scan_graphs: Dict[str, ScanGraph],
                 scan_order: Sequence[str], features: np.ndarray,
                 shapes: PretrainShapes, angle_feat_size: int = 4,
                 correct_heading: bool = True,
                 view_probs: Optional[np.ndarray] = None,
                 mask_token_id: Optional[int] = None, vocab_size: int = 50265,
                 mlm_prob: float = 0.15, mrc_prob: float = 0.15,
                 objnav: bool = False, zdicts: Optional[dict] = None,
                 aug_features: Optional[np.ndarray] = None,
                 objects: Optional[dict] = None,
                 obj_prob_logits: Optional[np.ndarray] = None,
                 seed: int = 0):
        self.graphs = scan_graphs
        self.scan_order = list(scan_order)
        self.scan_index = {s: i for i, s in enumerate(scan_order)}
        offs, total = {}, 0
        for s in scan_order:
            offs[s] = total
            total += scan_graphs[s].num_vps
        self.offsets = offs
        self.features = features          # [Vtot, 36, Df]
        # EnvEdit augmented features, sampled 50/50 per example
        # (pretrain_src/data/dataset.py:226-233)
        self.aug_features = aug_features
        self._use_aug_now = False
        self.view_probs = view_probs      # [Vtot, 36, P] or None
        self.sh = shapes
        self.afs = angle_feat_size
        self.correct_heading = correct_heading
        # RoBERTa <mask> is the last vocab id (50264 of 50265)
        self.mask_token_id = (vocab_size - 1 if mask_token_id is None
                              else mask_token_id)
        self.vocab_size = vocab_size
        self.mlm_prob = mlm_prob
        self.mrc_prob = mrc_prob
        self.objnav = objnav
        # batch step-dim bucketing: stack per-batch arrays only up to the
        # batch's longest trajectory (rounded up to step_bucket) instead of
        # max_steps — the dense [B, max_steps, Lp, Df] copy dominates host
        # batch-build time (profiled: the builder, not the device step, is
        # the pretrain throughput ceiling).  A few jit shape buckets trade
        # for ~2x less host bytes.  0 disables (always max_steps).
        self.step_bucket = 2
        # REVERIE object store, same [Vtot, Lo, ...] layout as
        # rollout.world.NavWorld: feat / loc (angle+box) / dir (absolute
        # heading+elev) / mask / name / oid.  Pretrain obj angle features
        # are ABSOLUTE directions (dataset.py:483-487), unlike the
        # camera-relative fine-tune path.
        self.objects = objects
        # optional [Vtot, Lo, P] CLIP-class logits for MRC object targets
        # (reference: obj_ft columns obj_feat_size:, dataset.py:422)
        self.obj_prob_logits = obj_prob_logits
        if objects is not None and shapes.max_objs == 0:
            shapes.max_objs = int(objects["feat"].shape[1])
        # optional BACL banks replicated into every batch (the pretrain
        # reference broadcasts z-dicts in the task collates, tasks.py:110+):
        # keys instr_z_{direction,landmark}_{features,pzs}, img_z_*
        self.zdicts = dict(zdicts) if zdicts else {}
        self.rng = np.random.default_rng(seed)
        # precomputed noncand view angle features relative to view 12
        rel12_h = G.VIEW_HEADINGS - G.VIEW_HEADINGS[12]
        rel12_e = G.VIEW_ELEVATIONS - G.VIEW_ELEVATIONS[12]
        self._rel12_ang = G.angle_feature_np(rel12_h, rel12_e, angle_feat_size)

    # ------------------------------------------------------------------
    def _feat(self, scan: str, vp: int) -> np.ndarray:
        src = self.features
        if self._use_aug_now and self.aug_features is not None:
            src = self.aug_features
        return src[self.offsets[scan] + vp]

    def _probs(self, scan: str, vp: int) -> np.ndarray:
        P = self.sh.mrc_prob_dim
        if self.view_probs is not None:
            vpb = self.view_probs[self.offsets[scan] + vp]
            assert vpb.shape[-1] == P, (vpb.shape, P)
            return vpb
        # synthetic: deterministic pseudo-probs from features (padded with
        # zeros when the feature width is below mrc_prob_dim)
        f = self._feat(scan, vp)[:, :P]
        e = np.exp(f - f.max(-1, keepdims=True))
        p = (e / e.sum(-1, keepdims=True)).astype(np.float32)
        if p.shape[-1] < P:
            p = np.pad(p, ((0, 0), (0, P - p.shape[-1])))
        return p

    def _cur_angle(self, g: ScanGraph, path: List[int], start_heading: float):
        """get_cur_angle (dataset.py:429-436)."""
        if len(path) < 2:
            return start_heading, 0.0
        prev, cur = path[-2], path[-1]
        k = int(np.argmax((g.cand_local[prev] == cur) & g.cand_mask[prev]))
        viewidx = int(g.cand_ptid[prev, k])
        return (viewidx % 12) * math.radians(30), \
            (viewidx // 12 - 1) * math.radians(30)

    def _pos7(self, g: ScanGraph, cur: int, tgts: List[Optional[int]],
              heading: float, elevation: float) -> np.ndarray:
        """Vectorized 7-dim position features; None entries (the [stop]
        token) get angle_fts(0,0) + zero dists."""
        out = np.zeros((len(tgts), self.afs + 3), np.float32)
        none_mask = np.asarray([t is None for t in tgts])
        out[none_mask, :self.afs] = G.angle_feature_np(0.0, 0.0, self.afs)
        idx = np.asarray([t for t in tgts if t is not None], np.int64)
        if len(idx):
            h, e, d = G.rel_heading_elevation_np(
                g.pos[cur][None], g.pos[idx], heading, elevation)
            rows = ~none_mask
            out[rows, :self.afs] = G.angle_feature_np(h, e, self.afs)
            out[rows, self.afs + 0] = d / G.MAX_DIST
            out[rows, self.afs + 1] = g.dist[cur, idx] / G.MAX_DIST
            out[rows, self.afs + 2] = g.hops[cur, idx] / G.MAX_STEP
        return out

    # ------------------------------------------------------------------
    def sample_end(self, item: dict, end_vp_type: str,
                   objnav: bool = False) -> int:
        g = self.graphs[item["scan"]]
        path = item["path_local"]
        if end_vp_type == "pos":
            return path[-1]
        if end_vp_type == "neg_in_gt_path" or len(path) <= 1 or not objnav:
            # R2R collapses neg_others onto mid-gt nodes
            # (dataset.py:646-650: end_vps = gt_path[:-1] for both types)
            cands = path[:-1] if len(path) > 1 else path
            return cands[self.rng.integers(len(cands))]
        # neg_others (REVERIE only: any non-path node, dataset.py:362-366)
        others = [v for v in range(g.num_vps) if v not in set(path)
                  and np.isfinite(g.dist[path[0], v])
                  and g.dist[path[0], v] < G.MAX_DIST * 30]
        if not others:
            return path[-1]
        return others[self.rng.integers(len(others))]

    # ------------------------------------------------------------------
    def build_one(self, item: dict, end_vp_type: str = "pos") -> dict:
        # EnvEdit feature alternation: 50/50 original vs augmented features
        # per EXAMPLE (pretrain_src/data/dataset.py:226-233)
        self._use_aug_now = (self.aug_features is not None
                             and self.rng.random() < 0.5)
        sh = self.sh
        scan = item["scan"]
        g = self.graphs[scan]
        gt_path = item["path_local"]
        start = gt_path[0]
        end_vp = self.sample_end(item, end_vp_type, objnav=self.objnav)
        end_idx = gt_path.index(end_vp) if end_vp in gt_path else None

        # R2R/RxR trajectories are the GT-path prefix (dataset.py:657-662;
        # RxR paths are deliberately non-shortest); only REVERIE rebuilds a
        # shortest path to the sampled end (dataset.py:368-370)
        if end_idx is not None and not self.objnav:
            traj = gt_path[:end_idx + 1]
        else:
            traj = [start] + g.shortest_path(start, end_vp)
        if len(traj) > min(TRAIN_MAX_STEP, sh.max_steps - 1):
            traj = traj[:min(TRAIN_MAX_STEP, sh.max_steps - 1)] + [end_vp]
        T = len(traj)
        heading, elevation = self._cur_angle(g, traj, item.get("heading", 0.0))

        K, Lp = sh.max_cands, sh.pano_len
        Lo = sh.max_objs if self.objects is not None else 0
        Df = self.features.shape[-1]
        view_img = np.zeros((sh.max_steps, Lp, Df), np.float32)
        loc_fts = np.zeros((sh.max_steps, Lp + Lo, self.afs + 3), np.float32)
        nav_types = np.zeros((sh.max_steps, Lp + Lo), np.int32)
        view_masks = np.zeros((sh.max_steps, Lp), bool)
        step_masks = np.zeros((sh.max_steps,), bool)
        if Lo:
            Dobj = self.objects["feat"].shape[-1]
            obj_img = np.zeros((sh.max_steps, Lo, Dobj), np.float32)
            obj_masks = np.zeros((sh.max_steps, Lo), bool)
            obj_names = np.zeros((sh.max_steps, Lo), np.int32)

        # ---- vectorized pano packing over all T steps at once (the
        # per-step python loop was the pretrain host-throughput ceiling;
        # semantics identical to the loop it replaces) ----
        tv = np.asarray(traj, np.int64)
        feats_T = np.stack([self._feat(scan, int(vp)) for vp in tv], 0)
        cmask_T = g.cand_mask[tv]                      # [T, Kg]
        Kg = cmask_T.shape[1]
        assert Kg <= K, (Kg, K)
        ptid_T = np.where(cmask_T, g.cand_ptid[tv], 0).astype(np.int64)
        step_masks[:T] = True

        # candidate slots (packed: mask True is a prefix per row)
        cand_img = np.take_along_axis(feats_T, ptid_T[:, :, None], axis=1)
        view_img[:T, :Kg] = np.where(cmask_T[:, :, None], cand_img, 0.0)
        ch = g.cand_heading[tv]
        ce = g.cand_elev[tv]
        if self.correct_heading:
            ch, ce = ch - heading, ce - elevation
        ang = G.angle_feature_np(ch, ce, self.afs)     # [T, Kg, A]
        loc_fts[:T, :Kg, :self.afs] = np.where(cmask_T[:, :, None], ang, 0.0)
        loc_fts[:T, :Kg, self.afs:self.afs + 3] = cmask_T[:, :, None]
        nav_types[:T, :Kg] = cmask_T
        view_masks[:T, :Kg] = cmask_T

        # non-candidate views: slot K+ix maps one-to-one to view ix
        used = np.zeros((T, 36), bool)
        np.put_along_axis(used, ptid_T, cmask_T, axis=1)
        unused = ~used
        view_img[:T, K:K + 36] = feats_T * unused[:, :, None]
        loc_fts[:T, K:K + 36, :self.afs] = self._rel12_ang * unused[:, :, None]
        loc_fts[:T, K:K + 36, self.afs:self.afs + 3] = unused[:, :, None]
        view_masks[:T, K:K + 36] = unused

        cand_lists = [[int(x) for x in g.cand_local[int(vp)][:int(
            g.cand_mask[int(vp)].sum())]] for vp in tv]
        for t, vp in enumerate(traj):
            if Lo:
                # object tokens [cand | views | objs] (dataset.py:439-505);
                # absolute obj directions, box fts from the stored loc tail
                gi = self.offsets[scan] + vp
                om = np.asarray(self.objects["mask"][gi], bool)
                obj_img[t] = self.objects["feat"][gi]
                obj_masks[t] = om
                obj_names[t] = self.objects["name"][gi]
                odir = self.objects.get("dir")
                if odir is not None:
                    loc_fts[t, Lp:, :self.afs] = G.angle_feature_np(
                        np.asarray(odir[gi])[:, 0],
                        np.asarray(odir[gi])[:, 1], self.afs)
                    loc_fts[t, Lp:, self.afs:] = \
                        np.asarray(self.objects["loc"][gi])[:, self.afs:]
                else:
                    loc_fts[t, Lp:] = self.objects["loc"][gi]
                loc_fts[t, Lp:][~om] = 0.0
                nav_types[t, Lp:][om] = 2

        # ---- gmap (get_gmap_inputs, dataset.py:511-537) ----
        visited_step: Dict[int, int] = {}
        unvisited: Dict[int, bool] = {}
        for t, vp in enumerate(traj):
            visited_step[vp] = t
            unvisited.pop(vp, None)
            for w in cand_lists[t]:
                if w not in visited_step:
                    unvisited[w] = True
        gmap_vps = [None] + list(visited_step.keys()) + list(unvisited.keys())
        Gm = sh.max_gmap
        if len(gmap_vps) > Gm:
            gmap_vps = gmap_vps[:Gm]
        ng = len(gmap_vps)
        gmap_slot = {vp: i for i, vp in enumerate(gmap_vps) if vp is not None}

        gmap_step_ids = np.zeros((Gm,), np.int32)
        gmap_visited = np.zeros((Gm,), bool)
        gmap_visited_step = np.full((Gm,), -1, np.int32)
        for vp, t in visited_step.items():
            if vp in gmap_slot:
                i = gmap_slot[vp]
                gmap_step_ids[i] = t + 1
                gmap_visited[i] = True
                gmap_visited_step[i] = t
        gmap_masks = np.zeros((Gm,), bool)
        gmap_masks[:ng] = True
        gmap_pos = np.zeros((Gm, self.afs + 3), np.float32)
        gmap_pos[:ng] = self._pos7(g, traj[-1], gmap_vps, heading, elevation)
        pair = np.zeros((Gm, Gm), np.float32)
        real_vps = np.asarray([v for v in gmap_vps if v is not None],
                              np.int64)
        if len(real_vps):
            pair[1:ng, 1:ng] = g.dist[np.ix_(real_vps, real_vps)]

        cand_to_gmap = np.full((sh.max_steps, K), -1, np.int32)
        for t in range(T):
            for k, w in enumerate(cand_lists[t]):
                if w not in visited_step and w in gmap_slot:
                    cand_to_gmap[t, k] = gmap_slot[w]

        # ---- local branch ----
        L = 1 + Lp + Lo
        vp_pos = np.zeros((L, 2 * (self.afs + 3)), np.float32)
        start_ft = self._pos7(g, traj[-1], [start], heading, elevation)[0]
        vp_pos[:, :self.afs + 3] = start_ft
        last_cands = cand_lists[-1]
        cand_ft = self._pos7(g, traj[-1], last_cands, heading, elevation)
        vp_pos[1:1 + len(last_cands), self.afs + 3:] = cand_ft

        local_to_gmap = np.full((L,), -1, np.int32)
        for k, w in enumerate(last_cands):
            if w in gmap_slot:
                local_to_gmap[1 + k] = gmap_slot[w]

        # ---- act labels (dataset.py:616-632) ----
        goal = item["path_local"][-1]
        if traj[-1] == goal:
            gl = ll = 0
        else:
            gl = ll = -100
            if end_idx is not None and end_idx + 1 < len(item["path_local"]):
                nxt = item["path_local"][end_idx + 1]
            else:
                # off-path end: expert = first hop toward the goal
                nh = g.nexthop[traj[-1], goal]
                nxt = int(nh) if nh >= 0 else None
            if nxt is not None:
                if nxt in gmap_slot:
                    gl = gmap_slot[nxt]
                    # the reference expert only targets UNVISITED gmap nodes
                    # (dataset.py:327-333); a visited target would sit at an
                    # -inf-masked logit -> infinite CE
                    if gmap_visited[gl]:
                        gl = -100
                if nxt in last_cands:
                    ll = last_cands.index(nxt) + 1

        # ---- text ----
        enc = list(item["instr_encoding"])[:sh.max_txt_len]
        txt_ids = np.zeros((sh.max_txt_len,), np.int64)
        txt_ids[:len(enc)] = enc
        txt_masks = np.zeros((sh.max_txt_len,), bool)
        txt_masks[:len(enc)] = True

        out = dict(
            end_vp=np.int32(traj[-1]),
            scan_idx=np.int32(self.scan_index[scan]),
            txt_ids=txt_ids.astype(np.int32), txt_masks=txt_masks,
            traj_view_img_fts=view_img, traj_loc_fts=loc_fts,
            traj_nav_types=nav_types, traj_view_masks=view_masks,
            step_masks=step_masks, traj_len=np.int32(T),
            gmap_step_ids=gmap_step_ids, gmap_pos_fts=gmap_pos,
            gmap_masks=gmap_masks, gmap_pair_dists=pair,
            gmap_visited_masks=gmap_visited,
            gmap_visited_step=gmap_visited_step, cand_to_gmap=cand_to_gmap,
            vp_pos_fts=vp_pos, local_to_gmap=local_to_gmap,
            global_act_labels=np.int32(gl), local_act_labels=np.int32(ll),
        )
        if Lo:
            out["traj_obj_img_fts"] = obj_img
            out["traj_obj_masks"] = obj_masks
            out["traj_obj_names"] = obj_names
            # local-token layout [stop | Lp | objs]; masks/labels for OG
            end_gi = self.offsets[scan] + traj[-1]
            end_om = np.asarray(self.objects["mask"][end_gi], bool)
            vp_obj_masks = np.zeros((L,), bool)
            vp_obj_masks[1 + Lp:] = end_om
            out["vp_obj_masks"] = vp_obj_masks
            # OG label: slot of the gt object at the end viewpoint
            # (dataset.py:303-316: index among end-vp obj ids, -100 if
            # absent), lifted into the full local layout
            obj_label = np.int32(-100)
            gt_oid = item.get("objid")
            if gt_oid is not None:
                oids = np.asarray(self.objects["oid"][end_gi])
                hits = np.nonzero((oids == gt_oid) & end_om)[0]
                if len(hits):
                    obj_label = np.int32(1 + Lp + int(hits[0]))
            out["obj_labels"] = obj_label
        return out

    # ------------------------------------------------------------------
    def add_mlm(self, ex: dict) -> dict:
        """BERT 80/10/10 masking (tasks.py:11-52) with static positions."""
        sh = self.sh
        ids = ex["txt_ids"].copy()
        n = int(ex["txt_masks"].sum())
        # skip [CLS]=slot0 and final [SEP] like the reference (tokens 1..n-2)
        body = np.arange(1, max(n - 1, 1))
        sel = body[self.rng.random(len(body)) < self.mlm_prob][:sh.max_mlm]
        if len(sel) == 0:                      # force at least one mask
            sel = np.asarray([int(self.rng.integers(1, max(n - 1, 2)))])
        tgt_list = ids[sel].tolist()
        r = self.rng.random(len(sel))
        ids[sel[r < 0.8]] = self.mask_token_id
        rand_rows = sel[(r >= 0.8) & (r < 0.9)]
        ids[rand_rows] = self.rng.integers(0, self.vocab_size,
                                           len(rand_rows))
        pos_list = sel.tolist()
        mlm_pos = np.full((sh.max_mlm,), -1, np.int32)
        mlm_tgt = np.zeros((sh.max_mlm,), np.int32)
        mlm_pos[:len(pos_list)] = pos_list
        mlm_tgt[:len(tgt_list)] = tgt_list
        ex = dict(ex)
        ex["txt_ids"] = ids
        ex["mlm_pos"] = mlm_pos
        ex["mlm_tgt"] = mlm_tgt
        return ex

    def add_mrc(self, ex: dict, scan: str, end_vp: int) -> dict:
        """Mask views (and REVERIE objects) of the end viewpoint, zero
        their inputs, attach soft targets (tasks.py:189-324)."""
        sh = self.sh
        ex = dict(ex)
        t = int(ex["traj_len"]) - 1
        Lp = sh.pano_len
        Lo = sh.max_objs if self.objects is not None else 0
        vm = ex["traj_view_masks"][t]
        mask = (self.rng.random(Lp) < self.mrc_prob) & vm
        if not mask.any():
            first = int(np.argmax(vm))
            mask[first] = True
        # build_one returns freshly allocated arrays; mutate in place
        ex["traj_view_img_fts"][t][mask] = 0.0

        probs = self._probs(scan, end_vp)       # [36, P]
        g = self.graphs[scan]
        tgt = np.zeros((Lp + Lo, sh.mrc_prob_dim), np.float32)
        n_cand = int(g.cand_mask[end_vp].sum())
        for k in range(n_cand):
            tgt[k] = probs[int(g.cand_ptid[end_vp, k])]
        for ix in range(36):
            tgt[sh.max_cands + ix] = probs[ix]
        if Lo:
            # object MRC (tasks.py:243-250): mask end-vp objects too; soft
            # labels = softmax of the trailing CLIP-class logits
            gi = self.offsets[scan] + end_vp
            om = np.asarray(self.objects["mask"][gi], bool)
            omask = (self.rng.random(Lo) < self.mrc_prob) & om
            ex["traj_obj_img_fts"][t][omask] = 0.0
            if self.obj_prob_logits is not None:
                ol = np.asarray(self.obj_prob_logits[gi], np.float32)
                e = np.exp(ol - ol.max(-1, keepdims=True))
                tgt[Lp:, :ol.shape[-1]] = e / e.sum(-1, keepdims=True)
            mask = np.concatenate([mask, omask])
        ex["mrc_masks"] = mask  # view(+obj)-token slots of end vp
        ex["mrc_targets"] = tgt
        return ex

    # ------------------------------------------------------------------
    def _sample_evt(self, rng, task: str, end_vp_pos_ratio: float) -> str:
        """Per-example end-vp-type draw (ratios: tasks.py:206-211,344-350).
        Consumes exactly one rng.random() — the CFP override happens after
        the draw, like the slow path always did."""
        r = rng.random()
        if task in ("mlm", "mrc"):
            evt = "pos" if r < end_vp_pos_ratio else "neg_in_gt_path"
        elif task in ("sap", "og", "cfp"):
            evt = "pos" if r < end_vp_pos_ratio else \
                ("neg_in_gt_path" if r < 0.6 else "neg_others")
        else:
            evt = "pos"
        if task == "cfp":
            evt = "pos"     # CFP pairs instruction with the full gt path
        return evt

    def build_batch(self, items: List[dict], task: str,
                    end_vp_pos_ratio: float = 0.2,
                    rng: Optional[np.random.Generator] = None,
                    ) -> Dict[str, np.ndarray]:
        """Build one task batch.

        ``rng=None`` uses the builder's sequential stream (legacy).  Passing
        a Generator makes the batch a PURE function of that Generator's
        state — the contract the multi-process worker pool relies on (the
        same (seed, step)-derived rng produces the same batch regardless of
        which worker builds it, or how many workers exist).

        Dispatches to the vectorized fast path (bit-identical output,
        tests/test_pretrain_fastpath.py) except for REVERIE object batches.
        """
        if rng is None:
            rng = self.rng
        if self.objects is None and not self.objnav \
                and task in ("mlm", "mrc", "sap", "cfp"):
            return self._build_batch_fast(items, task, end_vp_pos_ratio, rng)
        return self._build_batch_slow(items, task, end_vp_pos_ratio, rng)

    def _build_batch_slow(self, items: List[dict], task: str,
                          end_vp_pos_ratio: float,
                          rng: np.random.Generator) -> Dict[str, np.ndarray]:
        old_rng, self.rng = self.rng, rng
        try:
            return self._build_batch_slow_inner(items, task, end_vp_pos_ratio)
        finally:
            self.rng = old_rng

    def _build_batch_slow_inner(self, items: List[dict], task: str,
                                end_vp_pos_ratio: float = 0.2,
                                ) -> Dict[str, np.ndarray]:
        exs = []
        for it in items:
            r = self.rng.random()
            if task in ("mlm", "mrc"):
                evt = "pos" if r < end_vp_pos_ratio else "neg_in_gt_path"
            elif task in ("sap", "og", "cfp"):
                if r < end_vp_pos_ratio:
                    evt = "pos"
                elif r < 0.6:
                    evt = "neg_in_gt_path"
                else:
                    evt = "neg_others"
            else:
                evt = "pos"
            if task == "cfp":
                evt = "pos"     # CFP pairs instruction with the full gt path
            ex = self.build_one(it, evt)
            if task == "mlm":
                ex = self.add_mlm(ex)
            elif task == "mrc":
                ex = self.add_mrc(ex, it["scan"], int(ex["end_vp"]))
            exs.append(ex)
        keys = exs[0].keys()
        # step-dim bucket: slice before stacking so padding steps are
        # never copied (see __init__.step_bucket)
        cap = self.sh.max_steps
        if self.step_bucket:
            t_max = max(int(e["traj_len"]) for e in exs)
            cap = min(self.sh.max_steps,
                      -(-t_max // self.step_bucket) * self.step_bucket)
        step_keys = {"traj_view_img_fts", "traj_loc_fts", "traj_nav_types",
                     "traj_view_masks", "step_masks", "cand_to_gmap",
                     "traj_obj_img_fts", "traj_obj_masks", "traj_obj_names"}
        out = {k: np.stack([e[k][:cap] if k in step_keys else e[k]
                            for e in exs], 0) for k in keys}
        B = len(exs)
        for k, v in self.zdicts.items():
            v = np.asarray(v, np.float32)
            if v.ndim == 1:
                v = v[:, None]
            out[k] = np.broadcast_to(v[None], (B,) + v.shape).copy()
        return out


    # ------------------------------------------------------------------
    # Vectorized fast path.  Same outputs, bit-for-bit, as the per-example
    # slow path (tests/test_pretrain_fastpath.py) but packs the whole batch
    # with flat [sum-of-steps] numpy ops: the per-example dense
    # [max_steps, Lp, Df] zeros + np.stack copies were the pretrain host
    # throughput ceiling (BASELINE.md "Pretrain baseline").
    # ------------------------------------------------------------------
    def _cat_tables(self):
        """Per-scan candidate/pos tables concatenated into global-vp index
        space (cached).  Candidate widths are right-padded to the max."""
        cat = getattr(self, "_cat", None)
        if cat is not None:
            return cat
        Kg = max(self.graphs[s].cand_mask.shape[1] for s in self.scan_order)

        def pad(a, fill):
            if a.shape[1] == Kg:
                return a
            return np.concatenate(
                [a, np.full((a.shape[0], Kg - a.shape[1]), fill, a.dtype)], 1)

        gs = [self.graphs[s] for s in self.scan_order]
        cat = (np.concatenate([pad(g.cand_mask, False) for g in gs]),
               np.concatenate([pad(g.cand_ptid, 0) for g in gs]),
               np.concatenate([pad(g.cand_heading, 0.0) for g in gs]),
               np.concatenate([pad(g.cand_elev, 0.0) for g in gs]),
               np.concatenate([pad(g.cand_local, -1) for g in gs]),
               np.concatenate([g.pos for g in gs]))
        self._cat = cat
        return cat

    def _build_batch_fast(self, items: List[dict], task: str,
                          end_vp_pos_ratio: float,
                          rng: np.random.Generator) -> Dict[str, np.ndarray]:
        sh = self.sh
        B = len(items)
        K, Lp, Gm, A = sh.max_cands, sh.pano_len, sh.max_gmap, self.afs
        Df = self.features.shape[-1]
        L = 1 + Lp
        cm_cat, ptid_cat, ch_cat, ce_cat, cl_cat, pos_cat = self._cat_tables()
        Kg = cm_cat.shape[1]
        assert Kg <= K, (Kg, K)
        max_T = min(TRAIN_MAX_STEP, sh.max_steps - 1)

        old_rng, self.rng = self.rng, rng
        try:
            # ---- stage 1: every rng draw, in the slow path's exact
            # per-example order: [evt, aug, end-sample] then mlm/mrc ----
            trajs, use_aug, heads, elevs, end_idxs = [], [], [], [], []
            txt_exs, mrc_rand = [], []
            for it in items:
                evt = self._sample_evt(rng, task, end_vp_pos_ratio)
                aug = self.aug_features is not None and rng.random() < 0.5
                use_aug.append(aug)
                g = self.graphs[it["scan"]]
                gt_path = it["path_local"]
                end_vp = self.sample_end(it, evt, objnav=False)
                end_idx = gt_path.index(end_vp) if end_vp in gt_path else None
                if end_idx is not None:
                    traj = gt_path[:end_idx + 1]
                else:
                    traj = [gt_path[0]] + g.shortest_path(gt_path[0], end_vp)
                if len(traj) > max_T:
                    traj = traj[:max_T] + [end_vp]
                trajs.append(traj)
                end_idxs.append(end_idx)
                h, e = self._cur_angle(g, traj, it.get("heading", 0.0))
                heads.append(h)
                elevs.append(e)
                # text (+ MLM mutation draws, same order as add_mlm)
                enc = list(it["instr_encoding"])[:sh.max_txt_len]
                txt_ids = np.zeros((sh.max_txt_len,), np.int64)
                txt_ids[:len(enc)] = enc
                txt_masks = np.zeros((sh.max_txt_len,), bool)
                txt_masks[:len(enc)] = True
                ex = {"txt_ids": txt_ids, "txt_masks": txt_masks}
                if task == "mlm":
                    ex = self.add_mlm(ex)
                txt_exs.append(ex)
                if task == "mrc":
                    mrc_rand.append(rng.random(Lp))

            # ---- stage 2: flat pano packing over all steps of all
            # examples at once ----
            T = np.asarray([len(t) for t in trajs], np.int64)
            cap = sh.max_steps
            if self.step_bucket:
                cap = min(sh.max_steps,
                          -(-int(T.max()) // self.step_bucket)
                          * self.step_bucket)
            S = int(T.sum())
            ex_of = np.repeat(np.arange(B), T)
            st_of = np.concatenate([np.arange(t) for t in T])
            row = ex_of * cap + st_of
            offs = np.asarray([self.offsets[it["scan"]] for it in items],
                              np.int64)
            gvp = offs[ex_of] + np.concatenate(
                [np.asarray(t, np.int64) for t in trajs])

            ua = np.asarray(use_aug, bool)[ex_of]
            if self.aug_features is not None and ua.any():
                f_flat = np.empty((S, 36, Df), np.float32)
                f_flat[ua] = self.aug_features[gvp[ua]]
                f_flat[~ua] = self.features[gvp[~ua]]
            else:
                f_flat = self.features[gvp]

            cm = cm_cat[gvp]                               # [S, Kg]
            ptid = np.where(cm, ptid_cat[gvp], 0).astype(np.int64)
            cand_img = np.take_along_axis(f_flat, ptid[:, :, None], axis=1)

            view_img = np.zeros((B * cap, Lp, Df), np.float32)
            loc_fts = np.zeros((B * cap, Lp, A + 3), np.float32)
            nav_types = np.zeros((B * cap, Lp), np.int32)
            view_masks = np.zeros((B * cap, Lp), bool)

            view_img[row, :Kg] = np.where(cm[:, :, None], cand_img, 0.0)
            ch = ch_cat[gvp]
            ce = ce_cat[gvp]
            if self.correct_heading:
                hb = np.asarray(heads, np.float32)[ex_of, None]
                eb = np.asarray(elevs, np.float32)[ex_of, None]
                ch, ce = ch - hb, ce - eb
            ang = G.angle_feature_np(ch, ce, A)            # [S, Kg, A]
            loc_fts[row, :Kg, :A] = np.where(cm[:, :, None], ang, 0.0)
            loc_fts[row, :Kg, A:A + 3] = cm[:, :, None]
            nav_types[row, :Kg] = cm
            view_masks[row, :Kg] = cm

            used = np.zeros((S, 36), bool)
            np.put_along_axis(used, ptid, cm, axis=1)
            unused = ~used
            view_img[row, K:K + 36] = f_flat * unused[:, :, None]
            loc_fts[row, K:K + 36, :A] = self._rel12_ang * unused[:, :, None]
            loc_fts[row, K:K + 36, A:A + 3] = unused[:, :, None]
            view_masks[row, K:K + 36] = unused

            step_masks = np.arange(cap)[None, :] < T[:, None]

            # ---- stage 3: gmap bookkeeping (python dicts, per example —
            # small) + ONE flat geometry call for every position feature ----
            ncand = cm.sum(1)
            gmap_step_ids = np.zeros((B, Gm), np.int32)
            gmap_visited = np.zeros((B, Gm), bool)
            gmap_visited_step = np.full((B, Gm), -1, np.int32)
            gmap_masks = np.zeros((B, Gm), bool)
            gmap_pos = np.zeros((B, Gm, A + 3), np.float32)
            pair = np.zeros((B, Gm, Gm), np.float32)
            cand_to_gmap = np.full((B, cap, K), -1, np.int32)
            vp_pos = np.zeros((B, L, 2 * (A + 3)), np.float32)
            local_to_gmap = np.full((B, L), -1, np.int32)
            global_act = np.zeros((B,), np.int32)
            local_act = np.zeros((B,), np.int32)

            stop_ang = G.angle_feature_np(0.0, 0.0, A)
            # flat geometry request: (example, kind, dest-slot) per target
            fl_cur, fl_tgt, fl_bh, fl_be = [], [], [], []
            fl_dist, fl_hops = [], []
            fl_dst = []            # (which array, b, slot)
            srow = np.concatenate([[0], np.cumsum(T)])
            for b, it in enumerate(items):
                g = self.graphs[it["scan"]]
                traj = trajs[b]
                Tb = len(traj)
                cls_b = cl_cat[gvp[srow[b]:srow[b + 1]]]
                ncs_b = ncand[srow[b]:srow[b + 1]]
                cand_lists = [cls_b[t, :ncs_b[t]].tolist()
                              for t in range(Tb)]
                visited_step: Dict[int, int] = {}
                unvisited: Dict[int, bool] = {}
                for t, vp in enumerate(traj):
                    visited_step[vp] = t
                    unvisited.pop(vp, None)
                    for w in cand_lists[t]:
                        if w not in visited_step:
                            unvisited[w] = True
                gmap_vps = [None] + list(visited_step.keys()) \
                    + list(unvisited.keys())
                if len(gmap_vps) > Gm:
                    gmap_vps = gmap_vps[:Gm]
                ng = len(gmap_vps)
                gmap_slot = {vp: i for i, vp in enumerate(gmap_vps)
                             if vp is not None}
                for vp, t in visited_step.items():
                    if vp in gmap_slot:
                        i = gmap_slot[vp]
                        gmap_step_ids[b, i] = t + 1
                        gmap_visited[b, i] = True
                        gmap_visited_step[b, i] = t
                gmap_masks[b, :ng] = True
                cur = traj[-1]
                h, e = heads[b], elevs[b]
                real_vps = [v for v in gmap_vps if v is not None]
                gmap_pos[b, 0, :A] = stop_ang
                dr = g.dist[cur]
                hr = g.hops[cur]
                for i, v in enumerate(real_vps):
                    fl_cur.append(offs[b] + cur)
                    fl_tgt.append(offs[b] + v)
                    fl_bh.append(h)
                    fl_be.append(e)
                    fl_dist.append(dr[v])
                    fl_hops.append(hr[v])
                    fl_dst.append((0, b, 1 + i))
                rv = np.asarray(real_vps, np.int64)
                if len(rv):
                    pair[b, 1:ng, 1:ng] = g.dist[np.ix_(rv, rv)]
                for t in range(Tb):
                    for k, w in enumerate(cand_lists[t]):
                        if w not in visited_step and w in gmap_slot:
                            cand_to_gmap[b, t, k] = gmap_slot[w]
                # local branch: start feature broadcast + last-step cands
                start = traj[0]
                fl_cur.append(offs[b] + cur)
                fl_tgt.append(offs[b] + start)
                fl_bh.append(h)
                fl_be.append(e)
                fl_dist.append(dr[start])
                fl_hops.append(hr[start])
                fl_dst.append((1, b, 0))
                last_cands = cand_lists[-1]
                for k, w in enumerate(last_cands):
                    fl_cur.append(offs[b] + cur)
                    fl_tgt.append(offs[b] + w)
                    fl_bh.append(h)
                    fl_be.append(e)
                    fl_dist.append(dr[w])
                    fl_hops.append(hr[w])
                    fl_dst.append((2, b, 1 + k))
                    if w in gmap_slot:
                        local_to_gmap[b, 1 + k] = gmap_slot[w]
                # act labels (dataset.py:616-632)
                goal = it["path_local"][-1]
                if cur == goal:
                    gl = ll = 0
                else:
                    gl = ll = -100
                    ei = end_idxs[b]
                    if ei is not None and ei + 1 < len(it["path_local"]):
                        nxt = it["path_local"][ei + 1]
                    else:
                        nh = g.nexthop[cur, goal]
                        nxt = int(nh) if nh >= 0 else None
                    if nxt is not None:
                        if nxt in gmap_slot:
                            gl = gmap_slot[nxt]
                            if gmap_visited[b, gl]:
                                gl = -100
                        if nxt in last_cands:
                            ll = last_cands.index(nxt) + 1
                global_act[b] = gl
                local_act[b] = ll

            if fl_tgt:
                cur_g = np.asarray(fl_cur, np.int64)
                tgt_g = np.asarray(fl_tgt, np.int64)
                hh, ee, dd = G.rel_heading_elevation_np(
                    pos_cat[cur_g], pos_cat[tgt_g],
                    np.asarray(fl_bh, np.float64),
                    np.asarray(fl_be, np.float64))
                aflat = G.angle_feature_np(hh, ee, A)      # [M, A]
                feat7 = np.concatenate([
                    aflat,
                    (dd / G.MAX_DIST)[:, None],
                    (np.asarray(fl_dist, np.float32) / G.MAX_DIST)[:, None],
                    (np.asarray(fl_hops, np.float32) / G.MAX_STEP)[:, None],
                ], 1).astype(np.float32)
                kind = np.asarray([d[0] for d in fl_dst])
                db = np.asarray([d[1] for d in fl_dst])
                ds = np.asarray([d[2] for d in fl_dst])
                m0 = kind == 0
                gmap_pos[db[m0], ds[m0]] = feat7[m0]
                m1 = kind == 1                 # start: broadcast to all L
                vp_pos[db[m1], :, :A + 3] = feat7[m1][:, None, :]
                m2 = kind == 2
                vp_pos[db[m2], ds[m2], A + 3:] = feat7[m2]
            # examples whose m1 row was missing (never happens: every
            # example emits exactly one start row) keep zeros

            out = dict(
                end_vp=np.asarray([t[-1] for t in trajs], np.int32),
                scan_idx=np.asarray(
                    [self.scan_index[it["scan"]] for it in items], np.int32),
                txt_ids=np.stack(
                    [e["txt_ids"] for e in txt_exs]).astype(np.int32),
                txt_masks=np.stack([e["txt_masks"] for e in txt_exs]),
                traj_view_img_fts=view_img.reshape(B, cap, Lp, Df),
                traj_loc_fts=loc_fts.reshape(B, cap, Lp, A + 3),
                traj_nav_types=nav_types.reshape(B, cap, Lp),
                traj_view_masks=view_masks.reshape(B, cap, Lp),
                step_masks=step_masks, traj_len=T.astype(np.int32),
                gmap_step_ids=gmap_step_ids, gmap_pos_fts=gmap_pos,
                gmap_masks=gmap_masks, gmap_pair_dists=pair,
                gmap_visited_masks=gmap_visited,
                gmap_visited_step=gmap_visited_step,
                cand_to_gmap=cand_to_gmap,
                vp_pos_fts=vp_pos, local_to_gmap=local_to_gmap,
                global_act_labels=global_act, local_act_labels=local_act,
            )
            if task == "mlm":
                out["mlm_pos"] = np.stack([e["mlm_pos"] for e in txt_exs])
                out["mlm_tgt"] = np.stack([e["mlm_tgt"] for e in txt_exs])
            elif task == "mrc":
                vi4 = out["traj_view_img_fts"]
                mrc_masks = np.zeros((B, Lp), bool)
                mrc_tgt = np.zeros((B, Lp, sh.mrc_prob_dim), np.float32)
                for b, it in enumerate(items):
                    t = int(T[b]) - 1
                    vm = out["traj_view_masks"][b, t]
                    mask = (mrc_rand[b] < self.mrc_prob) & vm
                    if not mask.any():
                        mask[int(np.argmax(vm))] = True
                    vi4[b, t][mask] = 0.0
                    g = self.graphs[it["scan"]]
                    end_vp = trajs[b][-1]
                    # _probs' synthetic fallback reads the per-example
                    # EnvEdit alternation through _feat
                    self._use_aug_now = use_aug[b]
                    probs = self._probs(it["scan"], end_vp)
                    n_cand = int(g.cand_mask[end_vp].sum())
                    for k in range(n_cand):
                        mrc_tgt[b, k] = probs[int(g.cand_ptid[end_vp, k])]
                    mrc_tgt[b, K:K + 36] = probs
                    mrc_masks[b] = mask
                out["mrc_masks"] = mrc_masks
                out["mrc_targets"] = mrc_tgt
        finally:
            self.rng = old_rng

        for k, v in self.zdicts.items():
            v = np.asarray(v, np.float32)
            if v.ndim == 1:
                v = v[:, None]
            out[k] = np.broadcast_to(v[None], (B,) + v.shape).copy()
        return out


def items_from_dataset(data: List[dict], scan_graphs: Dict[str, ScanGraph]
                       ) -> List[dict]:
    """Attach local-index paths to dataset items."""
    out = []
    for it in data:
        g = scan_graphs[it["scan"]]
        idx = g.index
        out.append({**it, "path_local": [idx[v] for v in it["path"]]})
    return out
