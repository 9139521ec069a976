"""Episodic rollouts (counterpart of vln_goat_tpu/rollout/rollout.py
`build_rollout` and `build_teacher_rollout_vec`): greedy decode
(`feedback="argmax"`) and the training feedbacks of the DAgger step
(`train_ml=True`): teacher forcing, sampling, the reference's
`--expl_sample` exploration and the fused DAgger batch
(`feedback in {"teacher", "sample", "expl_sample", "fused_dagger"}`), and
the vectorized teacher (`NavRollout.teacher_rollout_vec`).

The JAX package compiles the episode into one `lax.while_loop` (decode) or
`lax.scan` (training); here it is a Python loop over the horizon that
leaves as soon as every episode has stopped, as the reference does
(agent.py:693-694).  An ended episode changes nothing and adds nothing to
the loss, so leaving early is loss-identical to the JAX scan.  Each step
encodes the panorama, maintains the topological map (node table, running
node embeddings, episodic Floyd-Warshall tables), runs the navigation
forward, picks the action (argmax, the expert's, or a Gumbel-max sample),
records the path segment and updates the camera.  The final stop-backtrack
follows.

State layout (fixed capacity; N = node capacity, slot N is a write
trash-can for masked scatters):
  node_vp   [B, N+1]      local viewpoint index of node i (-1 empty)
  visited   [B, N+1]      True once the agent has stood on the node
  step_id   [B, N+1]      1 + step of (latest) visit
  embed_sum [B, N+1, D], embed_cnt [B, N+1]   running node embeddings
  stop_prob [B, N+1]      per-node stop probability (for backtrack)
  edist/ehops/enext [B, N+1, N+1]  episodic shortest-path tables
Token layout of the global map: [stop, MEM, node_0..node_{N-1}] (G = N+2);
slot 1 is the [MEM] token carrying the previous step's fused CLS embedding
and is masked from attention.

Every update builds new tensors rather than writing in place, so a
recorded tensor never changes under a later step and autograd can carry
the imitation loss back across steps through the node-embedding tables
(embed_sum, last_embeds), as the JAX scan does.  Gathers and scatters are
plain indexing; the JAX package's one-hot contractions compute the same
values exactly.

Training rollouts take a rematerialisation policy (`ops.remat.POLICIES`,
the JAX package's `remat=`): "none" keeps every step's activations for the
backward; "model", "model_probs" and "model_wide" checkpoint each step's
`forward_panorama` and `forward_navigation` call (`ops.dropout.checkpoint`,
the JAX package's per-call `jax.checkpoint`, rollout.py:1006-1040); "full",
"dots", "bounds", "probs" and "wide" checkpoint the whole decision step
`_step` (rollout.py:1419-1468), which therefore writes nothing in place of
its inputs; "ffn" checkpoints each FFN sublayer of the step's model calls
(`ops.remat` says why).  The text encoding is not checkpointed, as in the JAX
package.

The vectorized teacher splits the teacher-forced rollout as the JAX
package's `build_teacher_rollout_vec` does (rollout.py:1602-1932): under
teacher forcing the path, and with it every geometric model input, does
not depend on the parameters, so (A) a loop without any model call
records each step's geometry, targets and node-table indices, (B) one
`forward_panorama` encodes the panoramas of all its steps at once, over
the steps x episodes rows, and (C) a loop of `forward_navigation` calls
rebuilds the running node embeddings from the recorded indices and sums
the cross-entropy.  Without dropout it is loss-identical to the per-step
teacher; with dropout (B) draws one mask for all steps, the JAX package's
documented divergence.

REVERIE / SOON (`is_objnav` with a world that has objects): the object
tokens follow the 36 views in the local branch, their angle features
camera-relative at every step (the JAX package's rollout.py:654-670);
`forward_navigation`'s `obj_logits` over them pick each step's object
(`og_oid` of the current node, `pred_obj_id` of the stop node in the
decode's output), and under training with `gt_obj_slot` in the batch the
object-grounding cross-entropy at the goal joins the step's loss
(rollout.py:1194-1226), on all three training paths.

The nDTW expert (`RolloutConfig.expert_policy="ndtw"`, RxR): the sampled
feedbacks' target is the unvisited node whose path, the episode's
trajectory so far plus the full-graph shortest path to the node (up to
`ndtw_future_len` hops), scores the best nDTW against the gt path,
exp(-dtw / (3 gt_len)); the trajectory's DTW row is kept in the state and
extended over every move (`dtw_extend_row`, rollout.py:67-92, :856-897,
:1320-1335).  The teacher-forced rollouts, the vectorized teacher's
geometry loop among them, take the gt path's next node as the JAX
package's do, so the expert policy does not change them.

The causal banks (`tools.zdict.SHARED_BANKS`) ride the batch as [B, N, ...]
views of one copy, shared by every episode; nothing here slices or
reorders a batch by episode, so they reach the model whole.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..core import geometry as G
from ..models.goat import GoatModel
from ..ops.dropout import checkpoint
from ..ops.remat import (STEP_POLICIES, call_policy, check as check_remat,
                         ffn_region, vec_call_policy)
from .world import INF_DIST, NavWorld

IGNORE_ID = -100           # target of a step without supervision
# salts of the action draws (vln_goat_tpu/rollout/rollout.py:1251-1283):
# the sampled action's Gumbel noise; expl_sample's explore draw (uniform)
# and its random move's Gumbel noise
SAMPLE_SALT, EXPLORE_SALT, RANDOM_MOVE_SALT = 7, 11, 13
# training feedbacks (`train_rollout`) and the sampled half of the fused
# DAgger batch
TRAIN_FEEDBACKS = ("teacher", "sample", "expl_sample", "fused_dagger")
SAMPLE_FEEDBACKS = ("sample", "expl_sample")
# batch keys of the causal banks -> the model argument each feeds
_TEXT_BANKS = (("instr_z_direction_features", "z_direc_embeds"),
               ("instr_z_direction_pzs", "z_direc_pzs"),
               ("instr_z_landmark_features", "z_landm_embeds"),
               ("instr_z_landmark_pzs", "z_landm_pzs"),
               ("front_txt_feats", "front_txt_embeds"))
_PANO_BANKS = (("img_z_features", "z_img_features"),
               ("img_z_pzs", "z_img_pzs"))
_NAV_BANKS = (("front_vp_feats", "front_vp_feats"),
              ("front_gmap_feats", "front_gmap_feats"))


@dataclass(frozen=True)
class RolloutConfig:
    num_nodes: int = 48        # episodic graph capacity (gmap tokens = +2)
    horizon: int = 15          # max_action_len (r2r parser default)
    seg_len: int = 12          # max hops recorded per move
    back_len: int = 16         # max hops of the final stop-backtrack
    expert_policy: str = "spl"  # spl | ndtw (RxR, agent.py:333-342)
    ndtw_future_len: int = 10  # DTW lookahead hops per candidate
    feat_dim: int = 768
    angle_feat_size: int = 4


# the DTW table's "no alignment yet"
DTW_BIG = 1e9


def dtw_extend_row(row, cost, valid=None):
    """One DTW row update (the JAX package's `dtw_extend_row`): for the
    appended path node with distances `cost` [..., Tg] to the reference
    nodes, dp[j] = cost[j] + min(prev[j], prev[j-1], dp[j-1]), written as
    dp = C + cummin(min(prev[j], prev[j-1]) - C[j-1]) with C the cumulative
    sum of the costs.  row [..., Tg+1] (entry 0 the empty prefix); where
    `valid` (broadcast over the leading dims) is False the row is kept."""
    a = torch.minimum(row[..., 1:], row[..., :-1])
    C = torch.cumsum(cost, dim=-1)
    Cs = torch.cat([torch.zeros_like(C[..., :1]), C[..., :-1]], dim=-1)
    dp = C + torch.cummin(a - Cs, dim=-1).values
    new = torch.cat([torch.full_like(row[..., :1], DTW_BIG), dp], dim=-1)
    if valid is None:
        return new
    return torch.where(valid[..., None], new, row)


def dtw_init_row(shape_prefix, Tg1: int, device=None) -> torch.Tensor:
    """The DTW row of the empty path: 0, then DTW_BIG."""
    row = torch.full(tuple(shape_prefix) + (Tg1,), DTW_BIG, device=device)
    row[..., 0] = 0.0
    return row


def pano_angle_table(angle_feat_size: int, device) -> torch.Tensor:
    """[36, 36, A]: angle features of view v relative to base view b."""
    rel_h = G.VIEW_HEADINGS[None, :] - G.VIEW_HEADINGS[:, None]
    rel_e = G.VIEW_ELEVATIONS[None, :] - G.VIEW_ELEVATIONS[:, None]
    return torch.as_tensor(G.angle_feature_np(rel_h, rel_e, angle_feat_size),
                           device=device)


def _row(x, idx):
    """x[b, idx[b]] for x [B, N, ...], idx [B]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _col(x, idx):
    """x[b, :, idx[b]] for x [B, M, N], idx [B] -> [B, M]."""
    return x[torch.arange(x.shape[0], device=x.device), :, idx]


def _set_row(x, idx, val, act):
    """Copy of x with x[b, idx[b]] = val[b] where act[b]."""
    b = torch.arange(x.shape[0], device=x.device)
    old = x[b, idx]
    m = act.view((-1,) + (1,) * (old.dim() - 1))
    return x.index_put((b, idx), torch.where(m, val.to(x.dtype), old))


def _take(x, idx):
    """x[b, idx[b, k]] for x [B, N], idx [B, K] -> [B, K]."""
    return torch.gather(x, 1, idx)


def gumbel_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise of `shape` from `generator`: the sampled
    action is argmax(logits + noise), a categorical draw from the policy
    (the trick jax.random.categorical uses)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def uniform_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform [0, 1) draws of `shape` from `generator`."""
    return torch.rand(shape, generator=generator, device=device)


def _nav_embed_assemble(embed_sum, embed_cnt, last_embeds, pano_embeds,
                        N: int):
    """The parameter-dependent navigation inputs (the JAX package's
    `_nav_embed_assemble`, rollout.py:94): the map tokens' embeddings
    [stop, MEM, node_0..N-1] from the running node sums and counts, and
    the local branch's [stop, MEM, pano...]."""
    B, D = embed_sum.shape[0], embed_sum.shape[2]
    zeros_d = torch.zeros(B, 1, D, device=embed_sum.device)
    last = last_embeds[:, None, :]
    cnt = embed_cnt[:, :N].clamp(min=1.0)
    node_embeds = embed_sum[:, :N] / cnt[:, :, None]
    return (torch.cat([zeros_d, last, node_embeds], dim=1),
            torch.cat([zeros_d, last, pano_embeds], dim=1))


def _obj_kw(pano) -> dict:
    """forward_panorama's object arguments from `_pano_inputs`' tables
    (none without objects)."""
    objs = pano.get("objs")
    if objs is None:
        return {}
    return dict(obj_fts=objs["feat"], obj_masks=objs["mask"],
                obj_names=objs["name"])


def _feat_noise(img, batch):
    """Back-translation's shared feature noise (`batch["feat_noise"]`
    [Df]) multiplied into the panorama's image features, which then skip
    the model's own feature dropout (agent.py:459-474, the JAX package's
    rollout.py:1098-1102 and :1805-1806) -> (features, forward_panorama's
    keyword)."""
    if "feat_noise" not in batch:
        return img, {}
    return img * batch["feat_noise"][None, None, :], \
        {"already_dropout": True}


def og_cross_entropy(obj_logits, gt_slot, at_goal):
    """The object-grounding loss per episode (the JAX package's
    rollout.py:1212-1226): -log_softmax(obj_logits)[gt_slot] where the
    episode is at its goal with a gt slot and some object, else 0.  A row
    without any object is replaced by zeros before the log_softmax, whose
    gradient would be NaN there."""
    has_obj = torch.isfinite(obj_logits).any(dim=1)
    ok = at_goal & (gt_slot >= 0) & has_obj
    safe = torch.where(has_obj[:, None], obj_logits,
                       torch.zeros_like(obj_logits))
    oli = torch.log_softmax(safe, dim=1).gather(
        1, gt_slot.clamp(min=0)[:, None].long())[:, 0]
    return -torch.where(ok, oli, torch.zeros_like(oli))


def _tile(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [B, ...] repeated n times along a new leading axis, flattened to
    [n B, ...] (the JAX package's `tile`): a view where x is one bank
    broadcast over its episodes (stride 0), a copy otherwise."""
    return x.unsqueeze(0).expand(n, *x.shape).reshape(n * x.shape[0],
                                                      *x.shape[1:])


class NavRollout:
    """Decode and training rollouts of a (model, world, config) triple."""

    def __init__(self, model: GoatModel, world: NavWorld,
                 rcfg: RolloutConfig):
        self.model = model
        self.world = world
        self.rcfg = rcfg
        self.mcfg = model.config
        self.device = world.pos.device
        self._ang_tab = pano_angle_table(rcfg.angle_feat_size, self.device)

    # ------------------------------------------------------------------
    def init_state(self, batch, need_dtw: bool = False
                   ) -> Dict[str, torch.Tensor]:
        """The episode's state at its start node.  need_dtw: keep the nDTW
        expert's row (with expert_policy "ndtw"); REVERIE / SOON worlds
        add each node's chosen object id `og_oid` (-1 none)."""
        r, dev = self.rcfg, self.device
        B = batch["scan_idx"].shape[0]
        N1 = r.num_nodes + 1
        D = self.mcfg.hidden_size
        eye = torch.eye(N1, device=dev, dtype=torch.bool)
        jidx = torch.arange(N1, device=dev)
        node_vp = torch.full((B, N1), -1, dtype=torch.int64, device=dev)
        node_vp[:, 0] = batch["start_vp"]
        st = dict(
            node_vp=node_vp,
            n_nodes=torch.ones(B, dtype=torch.int64, device=dev),
            visited=torch.zeros(B, N1, dtype=torch.bool, device=dev),
            step_id=torch.zeros(B, N1, dtype=torch.int64, device=dev),
            embed_sum=torch.zeros(B, N1, D, device=dev),
            embed_cnt=torch.zeros(B, N1, device=dev),
            stop_prob=torch.full((B, N1), -math.inf, device=dev),
            edist=torch.where(eye, 0.0, INF_DIST).float()
                       .expand(B, N1, N1).clone(),
            ehops=torch.zeros(B, N1, N1, device=dev),
            enext=torch.where(eye, jidx[None, :], -1).expand(B, N1, N1)
                       .clone(),
            cur=torch.zeros(B, dtype=torch.int64, device=dev),
            view_ix=batch["start_view"].clone(),
            ended=torch.zeros(B, dtype=torch.bool, device=dev),
            last_embeds=torch.zeros(B, D, device=dev),
            uid=torch.arange(B, device=dev),
            overflow_n=torch.zeros(B, dtype=torch.int64, device=dev),
            spilled_n=torch.zeros(B, dtype=torch.int64, device=dev),
        )
        if self.objnav:
            st["og_oid"] = torch.full((B, N1), -1, dtype=torch.int64,
                                      device=dev)
        if r.expert_policy == "ndtw" and need_dtw:
            row = dtw_init_row((B,), batch["gt_path"].shape[1] + 1, dev)
            st["dtw_row"] = dtw_extend_row(
                row, self._gt_cost(batch, batch["start_vp"]))
        return self._arrive(st, batch, st["cur"],
                            torch.zeros(B, dtype=torch.bool, device=dev))

    def _gt_cost(self, batch, vp):
        """Distances of viewpoints vp [B] or [B, N] (local ids) to each gt
        path node: [B, Tg] or [B, N, Tg] (a -1 pad reads node 0's, which
        no DTW entry it feeds is read at)."""
        gt = batch["gt_path"].clamp(min=0)
        scan = batch["scan_idx"]
        d = self.world.dist
        if vp.dim() == 1:
            return d[scan[:, None], vp[:, None], gt]
        return d[scan[:, None, None], vp[..., None], gt[:, None, :]]

    @property
    def objnav(self) -> bool:
        """Whether the episodes see object tokens: a REVERIE / SOON model
        on a world with objects."""
        return self.world.num_objs > 0 and self.mcfg.is_objnav

    def rcfg_obj_offset(self) -> int:
        """Local-token slot where the object tokens start, after the stop
        and MEM tokens' 2 (added by the caller): K candidate slots + 36
        views."""
        return self.world.max_cands + 36

    # ------------------------------------------------------------------
    def _spill(self, st, arr, exists, idx_exist, need, cidx):
        """Give candidates that do not fit the node table the slots of the
        farthest-from-arrival evictable nodes (unvisited first), and clear
        the evicted slots' routes.  Never evicted: the start node, the
        arrival node, and slots matched by this step's candidates."""
        r, dev = self.rcfg, self.device
        N, N1, TRASH = r.num_nodes, r.num_nodes + 1, r.num_nodes
        B = arr.shape[0]
        bcol = torch.arange(B, device=dev)[:, None]
        nslot = torch.arange(N, device=dev)[None, :]
        matched = torch.zeros(B, N1, dtype=torch.bool, device=dev).index_put(
            (bcol, torch.where(exists, idx_exist, TRASH)),
            torch.ones((), dtype=torch.bool, device=dev))[:, :N]
        evictable = (nslot < st["n_nodes"][:, None]) & (nslot != 0) \
            & (nslot != arr[:, None]) & ~matched
        d_arr = _row(st["edist"], arr)[:, :N]
        vis = st["visited"][:, :N]
        score = torch.where(
            evictable, torch.where(vis, d_arr - 2.0 * INF_DIST, d_arr),
            -math.inf)
        order = torch.argsort(-score, dim=1, stable=True)
        ov_rank = torch.cumsum(need, dim=1) - 1
        n_evict = evictable.sum(dim=1)
        slot_for = torch.gather(order, 1, ov_rank.clamp(0, N - 1))
        ok_spill = need & (ov_rank < n_evict[:, None])
        cidx = torch.where(ok_spill, slot_for, cidx)
        need = need & ~ok_spill
        spilled = ok_spill.sum(dim=1)

        tgt_e = torch.where(ok_spill, slot_for, TRASH)
        # the trash slot only receives False (tgt_e is TRASH where no
        # spill is); nothing is written in place, for remat's recompute
        er = torch.zeros(B, N1, dtype=torch.bool, device=dev).index_put(
            (bcol, tgt_e), ok_spill)
        thru = torch.gather(er, 1, st["enext"].clamp(0, N1 - 1)
                            .view(B, N1 * N1)).view(B, N1, N1)
        cm = er[:, None, :] | er[:, :, None] | thru
        eye = torch.eye(N1, device=dev, dtype=torch.bool)
        jidx = torch.arange(N1, device=dev)
        edist = torch.where(cm, torch.where(eye, 0.0, INF_DIST).float(),
                            st["edist"])
        ehops = torch.where(cm, 0.0, st["ehops"])
        enext = torch.where(cm, torch.where(eye, jidx[None, :], -1),
                            st["enext"])
        return cidx, need, spilled, edist, ehops, enext, er

    def _arrive(self, st, batch, arr, skip):
        """Graph update on arrival at node `arr` (GraphMap.update_graph):
        insert unseen candidates, add arr<->candidate edges when shorter,
        one Floyd-Warshall relaxation through arr.  A candidate that finds
        the node table full takes an evicted slot (the JAX package's
        default 'spill' policy); one that finds nothing to evict is
        dropped and counted in overflow_n.  The slots a spill clears come
        back as `emb_clear` [B, N+1] (absent when nothing spilled), for the
        vectorized teacher to replay on its node embeddings."""
        w, r, dev = self.world, self.rcfg, self.device
        B = arr.shape[0]
        N1, TRASH = r.num_nodes + 1, r.num_nodes
        scan = batch["scan_idx"]
        act = ~skip

        cands = w.get_cands(scan, _row(st["node_vp"], arr))
        cmask = cands["mask"] & act[:, None]

        # --- insert unseen candidate nodes into the node table
        slot_valid = torch.arange(N1, device=dev)[None, :] \
            < st["n_nodes"][:, None]
        known = torch.where(slot_valid, st["node_vp"], -2)
        match = known[:, None, :] == cands["local"][:, :, None]   # [B,K,N1]
        exists = match.any(-1) & cmask
        idx_exist = match.int().argmax(-1)
        isnew = cmask & ~exists
        rank = torch.cumsum(isnew, dim=1) - 1
        idx_new = st["n_nodes"][:, None] + rank
        overflow = idx_new >= r.num_nodes
        cidx = torch.where(exists, idx_exist,
                           torch.where(isnew & ~overflow, idx_new, TRASH))

        edist, ehops, enext = st["edist"], st["ehops"], st["enext"]
        spilled = torch.zeros(B, dtype=torch.int64, device=dev)
        emb_clear = None
        need = isnew & overflow
        if bool(need.any()):
            cidx, need, spilled, edist, ehops, enext, emb_clear = \
                self._spill(st, arr, exists, idx_exist, need, cidx)

        write = cmask & (cidx != TRASH)
        n_nodes = st["n_nodes"] + (isnew & ~overflow).sum(dim=1)
        d_k = cands["dist"]
        # at most one candidate writes each live slot; the trash slot only
        # ever receives unwritten (old or zero) values
        node_vp = st["node_vp"].scatter(
            1, cidx, torch.where(write, cands["local"],
                                 _take(st["node_vp"], cidx)))

        # --- add edges arr<->cand (FloydGraph.add_edge: keep if shorter)
        row_d = _row(edist, arr)
        upd = write & (d_k < _take(row_d, cidx))
        zb = torch.zeros(B, N1, dtype=torch.bool, device=dev)
        m_row = zb.scatter(1, cidx, upd)
        val_row = torch.zeros(B, N1, device=dev).scatter(
            1, cidx, torch.where(upd, d_k, 0.0))
        oh_arr = zb.scatter(1, arr[:, None], True)
        upd3 = oh_arr[:, :, None] & m_row[:, None, :]       # (arr, j)
        upd3t = m_row[:, :, None] & oh_arr[:, None, :]      # (j, arr)
        edist = torch.where(upd3, val_row[:, None, :], edist)
        edist = torch.where(upd3t, val_row[:, :, None], edist)
        ehops = torch.where(upd3 | upd3t, 1.0, ehops)
        jidx = torch.arange(N1, device=dev)
        enext = torch.where(upd3, jidx[None, None, :], enext)
        enext = torch.where(upd3t, arr[:, None, None], enext)

        # --- one Floyd-Warshall relaxation through arr (FloydGraph.update)
        dxc, dcy = _col(edist, arr), _row(edist, arr)
        cand_d = dxc[:, :, None] + dcy[:, None, :]
        better = (cand_d < edist) & act[:, None, None]
        hxc, hcy = _col(ehops, arr), _row(ehops, arr)
        nxc = _col(enext, arr)
        edist = torch.where(better, cand_d, edist)
        ehops = torch.where(better, hxc[:, :, None] + hcy[:, None, :], ehops)
        enext = torch.where(better, nxc[:, :, None], enext)
        visited = st["visited"] | (oh_arr & act[:, None])

        out = {**st, "node_vp": node_vp,
               "n_nodes": torch.where(act, n_nodes, st["n_nodes"]),
               "visited": visited, "edist": edist, "ehops": ehops,
               "enext": enext,
               "overflow_n": st["overflow_n"] + need.sum(dim=1),
               "spilled_n": st["spilled_n"] + spilled}
        out.pop("emb_clear", None)
        if emb_clear is not None:
            # evicted slots start fresh: no inherited embeddings/bookkeeping
            # (the vectorized teacher's geometry state has no embeddings)
            keep = ~emb_clear
            out["emb_clear"] = emb_clear
            if "embed_sum" in st:
                out["embed_sum"] = st["embed_sum"] * keep[..., None]
                out["embed_cnt"] = st["embed_cnt"] * keep
                out["stop_prob"] = torch.where(emb_clear, -math.inf,
                                               st["stop_prob"])
            out["step_id"] = st["step_id"] * keep
            out["visited"] = out["visited"] & keep
            if "og_oid" in st:
                out["og_oid"] = torch.where(emb_clear, -1, st["og_oid"])
        return out

    # ------------------------------------------------------------------
    def encode_text(self, batch):
        """Instruction encoding + the hoisted per-layer cross-attention
        K/V of both branches, computed once per rollout.  The BACL / FACL
        text banks ride the batch when the config uses them
        (`tools.zdict.causal_batch`)."""
        tkw = {dst: batch[src] for src, dst in _TEXT_BANKS if src in batch}
        embeds = self.model.forward_text(batch["txt_ids"], batch["txt_masks"],
                                         **tkw)
        return dict(embeds=embeds, kv=self.model.forward_text_kv(embeds))

    # ------------------------------------------------------------------
    def _pano_inputs(self, st, batch, cur_vp=None, view_ix=None,
                     scan=None, images: bool = True, use_aug=None):
        """Padded panorama tokens: [K candidate slots | 36 view slots].
        A function of (scan, cur_vp, view_ix, use_aug) alone, taken from
        the state and batch unless given (the vectorized teacher's
        flattened steps give them); use_aug picks each episode's EnvEdit
        features (`NavWorld.get_feat`); `images=False` leaves out the image
        features (`img`), for the geometry alone."""
        w, r = self.world, self.rcfg
        if scan is None:
            scan = batch["scan_idx"]
        if cur_vp is None:
            cur_vp = _row(st["node_vp"], st["cur"])
        vi = st["view_ix"] if view_ix is None else view_ix
        if use_aug is None:
            use_aug = batch.get("use_aug")
        cands = w.get_cands(scan, cur_vp)
        B, K = cands["local"].shape
        cam_h = float(G.VIEW_HEADINGS[0]) \
            + (vi % 12).float() * (math.pi / 6)
        cam_e = ((vi // 12).float() - 1.0) * (math.pi / 6)

        img = None
        if images:
            feats = w.get_feat(scan, cur_vp, use_aug)      # [B, 36, Df]
            cand_img = torch.gather(
                feats, 1,
                cands["ptid"][:, :, None].expand(B, K, feats.shape[2]))
            img = torch.cat([cand_img, feats], dim=1).float()
        cand_ang = G.angle_feature_t(cands["heading"] - cam_h[:, None],
                                     cands["elev"] - cam_e[:, None],
                                     r.angle_feat_size)
        view_ang = self._ang_tab[vi]                       # [B, 36, A]
        ang = torch.cat([cand_ang, view_ang], dim=1)
        loc = torch.cat([ang, torch.ones(ang.shape[:-1] + (3,),
                                         device=ang.device)], dim=-1)
        # mask out the views claimed by candidates (used_viewidxs)
        used = torch.zeros(B, 36, device=ang.device).scatter_add(
            1, cands["ptid"], cands["mask"].float()) > 0
        view_mask = torch.cat([cands["mask"], ~used], dim=1)
        nav_types = torch.cat(
            [cands["mask"].long(),
             torch.zeros(B, 36, dtype=torch.int64, device=ang.device)], dim=1)
        objs = None
        if self.objnav:
            # REVERIE object tokens (reverie/env.py:452-457), their angle
            # features relative to the camera at every step
            # (reverie/data_utils.py:90-93); the stored loc keeps the box
            objs = w.get_objs(scan, cur_vp)
            Lo = objs["feat"].shape[1]
            obj_loc = objs["loc"]
            if objs["dir"] is not None:
                A = r.angle_feat_size
                oang = G.angle_feature_t(
                    objs["dir"][..., 0] - cam_h[:, None],
                    objs["dir"][..., 1] - cam_e[:, None], A)
                obj_loc = torch.cat([oang, obj_loc[..., A:]], dim=-1)
            loc = torch.cat([loc, obj_loc], dim=1)
            nav_types = torch.cat(
                [nav_types, torch.full((B, Lo), 2, dtype=torch.int64,
                                       device=ang.device)], dim=1)
        return dict(img=img, loc=loc, nav_types=nav_types, mask=view_mask,
                    objs=objs, cands=cands, cam_h=cam_h, cam_e=cam_e,
                    cur_vp=cur_vp)

    # ------------------------------------------------------------------
    def _nav_inputs(self, st, batch, pano, pano_embeds, cnode, has,
                    embeds: bool = True):
        """Global-map + local-branch tensors (agent.py:151-304).
        `embeds=False` leaves out the two that depend on the parameters
        (gmap_img_embeds, vp_img_embeds: `_nav_embed_assemble`), for the
        vectorized teacher's geometry loop."""
        w, r = self.world, self.rcfg
        B, dev = st["cur"].shape[0], self.device
        N = r.num_nodes
        A = r.angle_feat_size
        scan = batch["scan_idx"]

        real = torch.arange(N, device=dev)[None, :] < st["n_nodes"][:, None]
        node_vp = st["node_vp"][:, :N]
        visited = st["visited"][:, :N] & real
        cur_vp = pano["cur_vp"]

        # positions & episodic metrics relative to the current node; `% V`
        # keeps the -1 pad slots in range, as the JAX package's lookups do
        V = w.pos.shape[1]
        pos_scan = w.pos[scan]                             # [B, V, 3]
        npos = torch.gather(pos_scan, 1,
                            (node_vp % V)[:, :, None].expand(B, N, 3))
        ed_row = _row(st["edist"], st["cur"])             # [B, N1]
        eh_row = _row(st["ehops"], st["cur"])
        cpos = w.pos[scan, cur_vp]
        cam_h, cam_e = pano["cam_h"], pano["cam_e"]
        node_pos_fts = G.pos_features_t(
            cpos[:, None, :], npos, cam_h[:, None], cam_e[:, None],
            ed_row[:, :N], eh_row[:, :N], A)
        # None-token features: angle fts of (0,0), zero dists
        null_ft = torch.tensor([0., 1., 0., 1., 0., 0., 0.],
                               device=dev).expand(B, 2, 7)
        gmap_pos_fts = torch.cat([null_ft, node_pos_fts], dim=1)

        zl = torch.zeros(B, 2, dtype=torch.int64, device=dev)
        ones1 = torch.ones(B, 1, dtype=torch.bool, device=dev)
        gmap_step_ids = torch.cat([zl, st["step_id"][:, :N] * real], dim=1)
        gmap_masks = torch.cat([ones1, ~ones1, real], dim=1)
        gmap_visited = torch.cat([~ones1, ones1, visited], dim=1)

        pair = st["edist"][:, :N, :N]
        pair = torch.where(real[:, :, None] & real[:, None, :]
                           & (pair < INF_DIST * 0.5), pair, 0.0)
        gmap_pair_dists = torch.zeros(B, N + 2, N + 2, device=dev)
        gmap_pair_dists[:, 2:, 2:] = pair

        # ---- local branch ----
        cands = pano["cands"]
        K = cands["local"].shape[1]
        objs = pano.get("objs")
        Lo = 0 if objs is None else objs["feat"].shape[1]
        L = 2 + pano["mask"].shape[1] + Lo
        local_to_gmap = torch.full((B, L), -1, dtype=torch.int64, device=dev)
        local_to_gmap[:, 2:2 + K] = torch.where(has, cnode + 2, -1)

        # vp_pos_fts: [:, :7] start-node relative, [2:2+K, 7:] candidates
        start_pos = w.pos[scan, batch["start_vp"]]
        start_ft = G.pos_features_t(cpos, start_pos, cam_h, cam_e,
                                    ed_row[:, 0], eh_row[:, 0], A)
        cand_pos = torch.gather(
            pos_scan, 1, (cands["local"] % V)[:, :, None].expand(B, K, 3))
        cand_ft = G.pos_features_t(
            cpos[:, None], cand_pos, cam_h[:, None], cam_e[:, None],
            _take(ed_row, cnode), _take(eh_row, cnode), A)
        cand_ft = torch.where(cands["mask"][..., None], cand_ft, 0.0)
        A7 = A + 3
        vp_pos_fts = torch.zeros(B, L, 2 * A7, device=dev)
        vp_pos_fts[:, :, :A7] = start_ft[:, None, :]
        vp_pos_fts[:, 2:2 + K, A7:] = cand_ft

        vp_masks = torch.cat([ones1, ones1, pano["mask"]]
                             + ([] if objs is None else [objs["mask"]]),
                             dim=1)
        vp_nav_masks = torch.cat(
            [ones1, ~ones1, cands["mask"],
             torch.zeros(B, 36 + Lo, dtype=torch.bool, device=dev)], dim=1)
        no_vp_left = ~torch.any(real & ~visited, dim=1)

        nav_in = dict(
            gmap_step_ids=gmap_step_ids,
            gmap_pos_fts=gmap_pos_fts, gmap_masks=gmap_masks,
            gmap_pair_dists=gmap_pair_dists,
            gmap_visited_masks=gmap_visited,
            vp_pos_fts=vp_pos_fts,
            vp_masks=vp_masks, vp_nav_masks=vp_nav_masks,
            local_to_gmap=local_to_gmap,
        )
        if Lo > 0:
            nav_in["vp_obj_masks"] = torch.cat(
                [torch.zeros(B, 2 + K + 36, dtype=torch.bool, device=dev),
                 objs["mask"]], dim=1)
        if embeds:
            nav_in["gmap_img_embeds"], nav_in["vp_img_embeds"] = \
                _nav_embed_assemble(st["embed_sum"], st["embed_cnt"],
                                    st["last_embeds"], pano_embeds, N)
        return nav_in, dict(no_vp_left=no_vp_left, node_vp=node_vp,
                            visited=visited, real=real)

    # ------------------------------------------------------------------
    def _teacher(self, st, batch, aux, t, imitation):
        """Expert action in gmap-token space (agent.py:306-349; the JAX
        package's `_teacher` :835-925): with `imitation` the next node of
        the gt path (stop at its end); else the expert of
        `rcfg.expert_policy`: "spl", the unvisited node nearest to the goal
        by dist(cur, node) + dist(node, goal) over the full scan graph, or
        "ndtw", the unvisited node with the best nDTW of the trajectory
        extended by the shortest path to it (`_ndtw_scores`); stop at the
        goal.  IGNORE_ID where nothing qualifies and for ended
        episodes."""
        w = self.world
        B = st["cur"].shape[0]
        bidx = torch.arange(B, device=self.device)
        cur_vp = _row(st["node_vp"], st["cur"])
        gl = batch["gt_len"]
        goal = batch["gt_path"][bidx, gl - 1]
        ignore = torch.full_like(st["cur"], IGNORE_ID)
        if imitation:
            is_last = t >= gl - 1
            nxt = batch["gt_path"][bidx, (gl - 1).clamp(max=t + 1)]
            match = (aux["node_vp"] == nxt[:, None]) & aux["real"]
            slot = match.int().argmax(dim=1) + 2
            a = torch.where(is_last, 0,
                            torch.where(match.any(dim=1), slot, ignore))
        elif self.rcfg.expert_policy == "ndtw":
            cand = aux["real"] & ~aux["visited"]
            score = torch.where(cand, self._ndtw_scores(st, batch, aux,
                                                        cur_vp), -math.inf)
            best = score.argmax(dim=1) + 2
            any_cand = torch.isfinite(score).any(dim=1)
            a = torch.where(cur_vp == goal, 0,
                            torch.where(any_cand, best, ignore))
        else:
            scan = batch["scan_idx"][:, None]
            node = aux["node_vp"] % w.dist.shape[1]
            d_goal = w.dist[scan, node, goal[:, None]]
            d_cur = w.dist[scan, cur_vp[:, None], node]
            cand = aux["real"] & ~aux["visited"]
            cost = torch.where(cand, d_goal + d_cur, math.inf)
            best = cost.argmin(dim=1) + 2
            any_cand = torch.isfinite(cost).any(dim=1)
            a = torch.where(cur_vp == goal, 0,
                            torch.where(any_cand, best, ignore))
        return torch.where(st["ended"], ignore, a)

    def _ndtw_scores(self, st, batch, aux, cur_vp):
        """nDTW of each node-table slot [B, N] (agent.py:333-340, the JAX
        package's rollout.py:856-897): the trajectory's DTW row extended
        hop by hop along the full-graph shortest path from cur_vp to the
        slot's node (at most ndtw_future_len hops, the path's own length
        where shorter), then exp(-dtw / (3 gt_len)) at the gt path's
        end."""
        w, r = self.world, self.rcfg
        node_vp = aux["node_vp"] % w.dist.shape[1]         # [B, N]
        B, N = node_vp.shape
        scan = batch["scan_idx"][:, None]
        hops = w.hops[scan, cur_vp[:, None], node_vp]
        row = st["dtw_row"][:, None, :].expand(B, N, -1)
        p = cur_vp[:, None].expand(B, N)
        for k in range(r.ndtw_future_len):
            nxt = w.nexthop[scan, p, node_vp]
            nxt = torch.where(nxt < 0, p, nxt)
            row = dtw_extend_row(row, self._gt_cost(batch, nxt),
                                 valid=k < hops)
            p = nxt
        gl = batch["gt_len"]
        dtw = row.gather(2, gl[:, None, None].expand(B, N, 1))[..., 0]
        return torch.exp(-dtw / (3.0 * gl[:, None].float()))

    # ------------------------------------------------------------------
    def _expand_path(self, st, tgt_node, max_len):
        """Follow episodic next-hop pointers cur -> tgt (FloydGraph.path).
        Returns the hop nodes [B, max_len] and the last-but-one node."""
        ncol = _col(st["enext"], tgt_node)                 # [B, N1]
        p = prev = st["cur"]
        hops = []
        for _ in range(max_len):
            nxt = _take(ncol, p[:, None])[:, 0]
            nxt = torch.where(nxt < 0, p, nxt)
            hops.append(nxt)
            prev = torch.where(nxt != p, p, prev)
            p = nxt
        return torch.stack(hops, dim=1), prev

    # ------------------------------------------------------------------
    def _call(self, fn, policy, *args, **kwargs):
        """A model call of a training rollout: through
        `ops.dropout.checkpoint` under the checkpoint policy `policy`
        (recomputed in the backward), or as it is when `policy` is None."""
        if policy is None:
            return fn(*args, **kwargs)
        return checkpoint(self.model, fn, *args, policy=policy, **kwargs)

    def _draw(self, noise_key, t, salt, sampler, shape):
        """Draws of `sampler` over the episode uid space (`shape`'s first
        axis) from a generator seeded by (rollout key, step, salt); the
        caller gathers them by uid, as the JAX package's `uid_rows`."""
        g = torch.Generator(device=self.device).manual_seed(
            (noise_key * 1000003 + t * 1009 + salt) % 2 ** 63)
        return sampler(g, shape, self.device)

    def _sampled_action(self, mode, logits, uid, t, noise_key,
                        expl_max_ratio):
        """The action of a sampled feedback (vln_goat_tpu/rollout/
        rollout.py:1262-1284): "sample", a Gumbel-max draw from the policy
        (salt 7); "expl_sample", the argmax, except where a uniform draw
        (salt 11) exceeds expl_max_ratio, which moves to a uniformly random
        action among the finite logits (Gumbel-max over them, salt 13)."""
        B0, G = logits.shape
        if mode == "sample":
            noise = self._draw(noise_key, t, SAMPLE_SALT, gumbel_noise,
                               (B0, G))
            return (logits + noise[uid]).argmax(dim=1)
        explore = self._draw(noise_key, t, EXPLORE_SALT, uniform_noise,
                             (B0,))[uid] > expl_max_ratio
        noise = self._draw(noise_key, t, RANDOM_MOVE_SALT, gumbel_noise,
                           (B0, G))
        finite = torch.where(torch.isfinite(logits), 0.0, -math.inf)
        rnd = (finite + noise[uid]).argmax(dim=1)
        return torch.where(explore, rnd, logits.argmax(dim=1))

    def _step(self, st, batch, txt, t, feedback, horizon, noise_key,
              remat="none", sample_feedback="sample", expl_max_ratio=0.6):
        """One decision step for every episode; returns (state, record).
        Every feedback but "argmax" trains: the record's `loss` is then the
        step's imitation loss per episode (zero in decode)."""
        model, w, r = self.model, self.world, self.rcfg
        train_ml = feedback != "argmax"

        def call(fn, *args, **kwargs):
            return self._call(fn, call_policy(remat) if train_ml else None,
                              *args, **kwargs)
        N = r.num_nodes
        act = ~st["ended"]
        st = {**st, "step_id": _set_row(
            st["step_id"], st["cur"],
            torch.full_like(st["cur"], t + 1), act)}

        pano = self._pano_inputs(st, batch)
        img, noise_kw = _feat_noise(pano["img"], batch)
        pano_embeds, pano_masks, pano_fused = call(
            model.forward_panorama, img, pano["loc"],
            pano["nav_types"], pano["mask"], **_obj_kw(pano), **noise_kw,
            **{dst: batch[src] for src, dst in _PANO_BANKS if src in batch})
        if pano_fused is None:  # average fallback (agent.py:550-552)
            m = pano_masks[..., None].to(pano_embeds.dtype)
            pano_fused = (pano_embeds * m).sum(1) / m.sum(1).clamp(min=1.0)

        # node embedding updates: the current node takes the fused
        # panorama embedding, unvisited candidates accumulate theirs
        cands = pano["cands"]
        K = cands["local"].shape[1]
        st = {**st,
              "embed_sum": _set_row(st["embed_sum"], st["cur"], pano_fused,
                                    act),
              "embed_cnt": _set_row(st["embed_cnt"], st["cur"],
                                    torch.ones_like(pano_fused[:, 0]), act)}
        known = torch.where(
            torch.arange(N, device=self.device)[None, :]
            < st["n_nodes"][:, None], st["node_vp"][:, :N], -2)
        cmatch = known[:, None, :] == cands["local"][:, :, None]  # [B,K,N]
        cnode = cmatch.int().argmax(-1)
        found = cmatch.any(-1)
        chas = found & cands["mask"]
        add = chas & ~_take(st["visited"], cnode) & act[:, None]
        tgt = torch.where(add, cnode, N)
        # accumulated in the table's float32, as the JAX package's one-hot
        # contractions do for a bf16 model (rollout.py:191-210, :445-460)
        addf = add.to(st["embed_sum"].dtype)
        st = {**st,
              "embed_sum": st["embed_sum"].scatter_add(
                  1, tgt[:, :, None].expand(-1, -1, pano_embeds.shape[2]),
                  pano_embeds[:, :K] * addf[..., None]),
              "embed_cnt": st["embed_cnt"].scatter_add(1, tgt, addf)}

        nav_in, aux = self._nav_inputs(st, batch, pano, pano_embeds,
                                       cnode, chas)
        nav_in.update({dst: batch[src] for src, dst in _NAV_BANKS
                       if src in batch})
        outs = call(model.forward_navigation, txt["embeds"],
                    batch["txt_masks"], txt_kv=txt["kv"], **nav_in)
        logits = outs["fused_logits"]
        st = {**st, "last_embeds": torch.where(
            act[:, None], outs["cls_embeds"], st["last_embeds"])}
        probs = torch.softmax(logits.detach(), dim=1)
        st = {**st, "stop_prob": _set_row(st["stop_prob"], st["cur"],
                                          probs[:, 0], act)}
        B0 = logits.shape[0]
        goal = batch["gt_path"][torch.arange(B0, device=self.device),
                                batch["gt_len"] - 1]

        # object grounding (agent_obj_goat.py:676-690): the current node
        # keeps the id of the object its step picks; training adds the
        # object cross-entropy at the goal
        og_loss = None
        obj_logits = outs.get("obj_logits")
        if obj_logits is not None:
            oids = pano["objs"]["oid"]
            k_obj = (obj_logits.detach().argmax(dim=1)
                     - 2 - self.rcfg_obj_offset()).clamp(0, oids.shape[1] - 1)
            st = {**st, "og_oid": _set_row(st["og_oid"], st["cur"],
                                           _row(oids, k_obj), act)}
            if train_ml and "gt_obj_slot" in batch:
                og_loss = og_cross_entropy(
                    obj_logits, batch["gt_obj_slot"],
                    act & (pano["cur_vp"] == goal))

        # supervision: expert target and f32 cross-entropy
        # (vln_goat_tpu/rollout/rollout.py:1230-1248): the gt path's next
        # node for "teacher", the expert of rcfg.expert_policy (SPL or
        # nDTW) for the sampled feedbacks, and per episode by
        # batch["is_teacher"] for "fused_dagger"; plus the og loss
        target = torch.full_like(st["cur"], IGNORE_ID)
        step_loss = torch.zeros(B0, device=logits.device)
        is_t = batch.get("is_teacher") if feedback == "fused_dagger" \
            else None
        if train_ml:
            if is_t is not None:
                target = torch.where(
                    is_t, self._teacher(st, batch, aux, t, imitation=True),
                    self._teacher(st, batch, aux, t, imitation=False))
            else:
                target = self._teacher(st, batch, aux, t,
                                       imitation=(feedback == "teacher"))
            logp = torch.log_softmax(logits.float(), dim=1)
            li = logp.gather(1, target.clamp(min=0)[:, None])[:, 0]
            step_loss = -torch.where(target >= 0, li, torch.zeros_like(li))
            if og_loss is not None:
                step_loss = step_loss + og_loss

        # action selection (vln_goat_tpu/rollout/rollout.py:1251-1295):
        # draws for every episode uid, gathered by uid
        lg = logits.detach()
        if feedback == "teacher":
            a = target.clamp(min=0)
        elif feedback in SAMPLE_FEEDBACKS:
            a = self._sampled_action(feedback, lg, st["uid"], t, noise_key,
                                     expl_max_ratio)
        elif is_t is not None:
            a = torch.where(is_t, target.clamp(min=0),
                            self._sampled_action(sample_feedback, lg,
                                                 st["uid"], t, noise_key,
                                                 expl_max_ratio))
        else:
            a = logits.argmax(dim=1)

        # stop (agent.py:649-662): teacher and sample also stop at the
        # goal; argmax and expl_sample on the stop action only
        a_stop = a == 0
        if train_ml:
            at_goal = pano["cur_vp"] == goal
            if is_t is not None:
                at_goal = at_goal & (is_t | (sample_feedback == "sample"))
            elif feedback == "expl_sample":
                at_goal = torch.zeros_like(at_goal)
            a_stop = a_stop | at_goal
        just_ended = act & (a_stop | aux["no_vp_left"]
                            | (t == horizon - 1))
        moves = act & ~just_ended
        tgt_node = (a - 2).clamp(0, N - 1)

        # record the trajectory segment (episodic path cur -> action)
        seg, prev = self._expand_path(st, tgt_node, r.seg_len)
        seg = torch.where(moves[:, None], seg, -1)
        seg_hops = torch.where(
            moves, _take(_row(st["ehops"], st["cur"]), tgt_node[:, None])[:, 0],
            0.0)

        # camera update: view index of the arrival edge prev -> action;
        # prev comes from the reverse next-hop so it holds even when the
        # path is longer than seg_len
        rev = _take(_row(st["enext"], tgt_node), st["cur"][:, None])[:, 0]
        prev = torch.where(rev >= 0, rev, prev)
        prev_vp = _row(st["node_vp"], prev)
        tgt_vp = _row(st["node_vp"], tgt_node)
        pc = w.get_cands(batch["scan_idx"], prev_vp)
        pk = ((pc["local"] == tgt_vp[:, None]) & pc["mask"]).int().argmax(1)
        new_view = _row(pc["ptid"], pk)
        # segments record viewpoint ids resolved before the arrival update
        # (a spilled slot may be reused by it)
        seg_vp = torch.where(seg >= 0, _take(st["node_vp"], seg.clamp(0, N)),
                             -1)
        act_vp = torch.where(moves, tgt_vp, -1)
        if "dtw_row" in st:
            # the nDTW expert's row follows the traversed segment
            row = st["dtw_row"]
            for k in range(r.seg_len):
                row = dtw_extend_row(
                    row, self._gt_cost(batch, seg_vp[:, k].clamp(min=0)),
                    valid=seg[:, k] >= 0)
            st = {**st, "dtw_row": row}

        st = {**st,
              "view_ix": torch.where(moves, new_view, st["view_ix"]),
              "cur": torch.where(moves, tgt_node, st["cur"]),
              "ended": st["ended"] | just_ended}
        st = self._arrive(st, batch, st["cur"], skip=~moves)
        rec = dict(action_node=act_vp, seg=seg_vp, seg_hops=seg_hops,
                   logits=logits.detach(), active=act, target=target,
                   node_vp_t=aux["node_vp"], visited_t=aux["visited"],
                   loss=step_loss)
        return st, rec

    # ------------------------------------------------------------------
    def _run(self, batch, txt, feedback, horizon, noise_key,
             remat="none", **sampling):
        """The step loop and the final stop-backtrack; records are kept
        detached, the per-step losses as they are.  `sampling`: _step's
        sample_feedback and expl_max_ratio."""
        r = self.rcfg
        B = batch["scan_idx"].shape[0]
        T, G = horizon or r.horizon, r.num_nodes + 2
        dev = self.device
        recs = dict(
            action_node=torch.full((T, B), -1, dtype=torch.int64, device=dev),
            seg=torch.full((T, B, r.seg_len), -1, dtype=torch.int64,
                           device=dev),
            seg_hops=torch.zeros(T, B, device=dev),
            logits=torch.full((T, B, G), -math.inf, device=dev),
            active=torch.zeros(T, B, dtype=torch.bool, device=dev),
            target=torch.full((T, B), IGNORE_ID, dtype=torch.int64,
                              device=dev),
            node_vp_t=torch.full((T, B, r.num_nodes), -1, dtype=torch.int64,
                                 device=dev),
            visited_t=torch.zeros(T, B, r.num_nodes, dtype=torch.bool,
                                  device=dev),
        )
        losses = []
        t = 0
        st = self.init_state(batch, need_dtw=feedback not in ("argmax",
                                                              "teacher"))
        while t < T and not bool(st["ended"].all()):
            if remat == "ffn" and feedback != "argmax":
                with ffn_region():
                    st, rec = self._step(st, batch, txt, t, feedback, T,
                                         noise_key, "none", **sampling)
            elif remat in STEP_POLICIES and feedback != "argmax":
                st, rec = checkpoint(self.model, self._step, st, batch, txt,
                                     t, feedback, T, noise_key, "none",
                                     policy=remat, **sampling)
            else:
                st, rec = self._step(st, batch, txt, t, feedback, T,
                                     noise_key, remat, **sampling)
            losses.append(rec.pop("loss"))
            for k, v in rec.items():
                recs[k][t] = v
            t += 1

        # final stop-node backtrack (agent.py:666-681)
        best_stop = st["stop_prob"][:, :r.num_nodes].argmax(dim=1)
        back, _ = self._expand_path(st, best_stop, r.back_len)
        back = torch.where((best_stop != st["cur"])[:, None], back, -1)
        loss_per_ep = torch.stack(losses).sum(dim=0) if losses \
            else torch.zeros(B, device=dev)
        extra = {}
        if "og_oid" in st:
            # the object picked at the chosen stop node
            extra["pred_obj_id"] = _row(st["og_oid"], best_stop)
        return dict(
            extra, ml_loss=loss_per_ep.sum() / B, loss_per_ep=loss_per_ep,
            actions=recs["action_node"], segs=recs["seg"],
            seg_hops=recs["seg_hops"], logits=recs["logits"],
            active=recs["active"], targets=recs["target"],
            node_vp_t=recs["node_vp_t"], visited_t=recs["visited_t"],
            node_vp=st["node_vp"], stop_node=best_stop, back_seg=back,
            back_hops=_take(_row(st["ehops"], st["cur"]),
                            best_stop[:, None])[:, 0],
            final_cur=st["cur"], n_nodes=st["n_nodes"],
            overflow_n=st["overflow_n"], spilled_n=st["spilled_n"],
            steps=torch.tensor(t),
        )

    @torch.no_grad()
    def rollout(self, batch) -> Dict[str, torch.Tensor]:
        """Greedy decode of one batch; outputs as the JAX package's
        `build_rollout(feedback="argmax", record_logits=True)`, plus
        `steps`, the number of decision steps run."""
        return self._run(batch, self.encode_text(batch), "argmax", None, 0)

    @staticmethod
    def _noise_key(generator: torch.Generator) -> int:
        """The rollout's key of its action draws, from `generator`."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device))

    def train_rollout(self, batch, feedback: str,
                      generator: torch.Generator,
                      txt: Optional[dict] = None,
                      horizon: Optional[int] = None,
                      remat: str = "none", sample_feedback: str = "sample",
                      expl_max_ratio: float = 0.6
                      ) -> Dict[str, torch.Tensor]:
        """Training rollout with the imitation loss (the JAX package's
        `build_rollout(feedback, train_ml=True, deterministic=False)`):
        `feedback="teacher"` follows the gt path; `"sample"` samples from
        the policy and `"expl_sample"` explores (`_sampled_action`), both
        with the SPL expert as target; `"fused_dagger"` runs a batch of
        `trainer.fuse_dagger_batches`, whose episodes where
        batch["is_teacher"] follow the gt path and the rest take
        `sample_feedback`.  `ml_loss` is the summed cross-entropy over
        steps and episodes divided by B (JAX :1574), `loss_per_ep` each
        episode's sum, differentiable in the model's parameters.  `txt` is
        an `encode_text` result to share between rollouts on one batch;
        `horizon` shortens the scan (the trainer's teacher_horizon);
        `remat` is one of `ops.remat.POLICIES`.  Dropout draws come from
        the generator
        the caller gave the model (`set_generator`); the sampled actions'
        noise from `generator`."""
        check_remat(remat)
        if feedback not in TRAIN_FEEDBACKS:
            raise ValueError(f"training feedback {feedback!r}: one of "
                             f"{TRAIN_FEEDBACKS}")
        if sample_feedback not in SAMPLE_FEEDBACKS:
            raise ValueError(f"sample_feedback {sample_feedback!r}: one of "
                             f"{SAMPLE_FEEDBACKS}")
        if feedback == "fused_dagger" and "is_teacher" not in batch:
            raise ValueError("fused_dagger needs batch['is_teacher'] "
                             "(trainer.fuse_dagger_batches)")
        if txt is None:
            txt = self.encode_text(batch)
        return self._run(batch, txt, feedback, horizon,
                         self._noise_key(generator), remat,
                         sample_feedback=sample_feedback,
                         expl_max_ratio=expl_max_ratio)

    # ------------------------------------------------------------------
    def _geo_step(self, st, batch, t, T):
        """Phase A of the vectorized teacher: one teacher-forced step
        without any model call (the JAX package's `geo_step`,
        rollout.py:1694-1777).  Returns the state after the step and its
        record: the step's current viewpoint, view and slot, the active
        episodes, the candidates' embedding scatter (add, tgt), the slots
        the arrival's spill keeps (None: all), the gt target, the
        navigation geometry and the action taken (-1 if none)."""
        r, w = self.rcfg, self.world
        N = r.num_nodes
        act = ~st["ended"]
        st = {**st, "step_id": _set_row(
            st["step_id"], st["cur"], torch.full_like(st["cur"], t + 1),
            act)}
        cur_slot, vi = st["cur"], st["view_ix"]
        pano = self._pano_inputs(st, batch, images=False)
        cands = pano["cands"]
        known = torch.where(
            torch.arange(N, device=self.device)[None, :]
            < st["n_nodes"][:, None], st["node_vp"][:, :N], -2)
        cmatch = known[:, None, :] == cands["local"][:, :, None]  # [B,K,N]
        cnode = cmatch.int().argmax(-1)
        chas = cmatch.any(-1) & cands["mask"]
        add = chas & ~_take(st["visited"], cnode) & act[:, None]
        tgt = torch.where(add, cnode, N)
        geo, aux = self._nav_inputs(st, batch, pano, None, cnode, chas,
                                    embeds=False)
        target = self._teacher(st, batch, aux, t, imitation=True)
        a = target.clamp(min=0)
        B = a.shape[0]
        goal = batch["gt_path"][torch.arange(B, device=self.device),
                                batch["gt_len"] - 1]
        a_stop = (pano["cur_vp"] == goal) | (a == 0)
        just_ended = act & (a_stop | aux["no_vp_left"] | (t == T - 1))
        moves = act & ~just_ended
        tgt_node = (a - 2).clamp(0, N - 1)
        # camera update (arrival-edge view of prev -> action), as _step
        _, prev = self._expand_path(st, tgt_node, r.seg_len)
        rev = _take(_row(st["enext"], tgt_node), st["cur"][:, None])[:, 0]
        prev = torch.where(rev >= 0, rev, prev)
        tgt_vp = _row(st["node_vp"], tgt_node)
        pc = w.get_cands(batch["scan_idx"], _row(st["node_vp"], prev))
        pk = ((pc["local"] == tgt_vp[:, None]) & pc["mask"]).int().argmax(1)
        st = {**st,
              "view_ix": torch.where(moves, _row(pc["ptid"], pk),
                                     st["view_ix"]),
              "cur": torch.where(moves, tgt_node, st["cur"]),
              "ended": st["ended"] | just_ended}
        st = self._arrive(st, batch, st["cur"], skip=~moves)
        clear = st.pop("emb_clear", None)
        rec = dict(cur_vp=pano["cur_vp"], view_ix=vi, act=act,
                   cur_slot=cur_slot, add=add, tgt=tgt,
                   keep=None if clear is None else ~clear, target=target,
                   geo=geo, action=torch.where(moves, tgt_vp, -1),
                   at_goal=pano["cur_vp"] == goal)
        return st, rec

    def teacher_rollout_vec(self, batch, generator: torch.Generator,
                            txt: Optional[dict] = None,
                            horizon: Optional[int] = None,
                            remat: str = "none") -> Dict[str, torch.Tensor]:
        """The teacher-forced training rollout with the panorama encoder
        run once over all its steps (the JAX package's
        `build_teacher_rollout_vec`, rollout.py:1602-1932; the module
        docstring gives the three phases).  Arguments as `train_rollout`'s
        (the generator's draw of the action key is taken, and left unused,
        so that the generator moves on as under the per-step teacher).
        Returns ml_loss, loss_per_ep, targets and actions [T, B], n_nodes,
        overflow_n, spilled_n and `steps`, the steps phase A ran: it stops
        once every episode has ended (a later step adds nothing to the
        loss).  Under every remat policy but "none" both model calls go
        through `ops.dropout.checkpoint` (`ops.remat.vec_call_policy`: the
        names of "probs" / "wide" kept, as in the JAX package,
        rollout.py:1636-1663)."""
        check_remat(remat)
        if txt is None:
            txt = self.encode_text(batch)
        self._noise_key(generator)
        r, model = self.rcfg, self.model
        B = batch["scan_idx"].shape[0]
        T, N, dev = horizon or r.horizon, r.num_nodes, self.device

        # ---- phase A: the geometry, no model call
        st = self.init_state(batch)
        for k in ("embed_sum", "embed_cnt", "stop_prob", "last_embeds"):
            st.pop(k)
        recs = []
        with torch.no_grad():
            while len(recs) < T and not bool(st["ended"].all()):
                st, rec = self._geo_step(st, batch, len(recs), T)
                recs.append(rec)
        n = len(recs)
        targets = torch.full((T, B), IGNORE_ID, dtype=torch.int64,
                             device=dev)
        actions = torch.full((T, B), -1, dtype=torch.int64, device=dev)
        out = dict(targets=targets, actions=actions, n_nodes=st["n_nodes"],
                   overflow_n=st["overflow_n"], spilled_n=st["spilled_n"],
                   steps=torch.tensor(n))
        if n == 0:
            zero = torch.zeros(B, device=dev)
            return dict(out, ml_loss=zero.sum(), loss_per_ep=zero)
        for t, rec in enumerate(recs):
            targets[t], actions[t] = rec["target"], rec["action"]

        # ---- phase B: one panorama encoding over the n B flattened steps
        pano = self._pano_inputs(
            None, batch, cur_vp=torch.cat([x["cur_vp"] for x in recs]),
            view_ix=torch.cat([x["view_ix"] for x in recs]),
            scan=_tile(batch["scan_idx"], n),
            use_aug=_tile(batch["use_aug"], n) if "use_aug" in batch
            else None)
        policy = vec_call_policy(remat)
        img, noise_kw = _feat_noise(pano["img"], batch)
        pe, pm, pf = self._call(
            model.forward_panorama, policy, img, pano["loc"],
            pano["nav_types"], pano["mask"], **_obj_kw(pano), **noise_kw,
            **{dst: _tile(batch[src], n) for src, dst in _PANO_BANKS
               if src in batch})
        if pf is None:  # average fallback (agent.py:550-552)
            m = pm[..., None].to(pe.dtype)
            pf = (pe * m).sum(1) / m.sum(1).clamp(min=1.0)
        pe = pe.reshape(n, B, *pe.shape[1:])
        pf = pf.reshape(n, B, *pf.shape[1:])
        K = pano["cands"]["local"].shape[1]

        # ---- phase C: the navigation calls, step by step
        D = self.mcfg.hidden_size
        es = torch.zeros(B, N + 1, D, device=dev)
        ec = torch.zeros(B, N + 1, device=dev)
        last = torch.zeros(B, D, device=dev)
        nav_banks = {dst: batch[src] for src, dst in _NAV_BANKS
                     if src in batch}
        losses = []
        for t, rec in enumerate(recs):
            act = rec["act"]
            es = _set_row(es, rec["cur_slot"], pf[t], act)
            ec = _set_row(ec, rec["cur_slot"], torch.ones_like(ec[:, 0]),
                          act)
            addf = rec["add"].to(es.dtype)
            es = es.scatter_add(
                1, rec["tgt"][:, :, None].expand(-1, -1, D),
                pe[t, :, :K] * addf[..., None])
            ec = ec.scatter_add(1, rec["tgt"], addf)
            gmap, vp = _nav_embed_assemble(es, ec, last, pe[t], N)
            outs = self._call(model.forward_navigation, policy,
                              txt["embeds"], batch["txt_masks"],
                              txt_kv=txt["kv"], gmap_img_embeds=gmap,
                              vp_img_embeds=vp, **rec["geo"], **nav_banks)
            last = torch.where(act[:, None], outs["cls_embeds"], last)
            logp = torch.log_softmax(outs["fused_logits"].float(), dim=1)
            target = rec["target"]
            li = logp.gather(1, target.clamp(min=0)[:, None])[:, 0]
            step_loss = -torch.where(target >= 0, li, torch.zeros_like(li))
            if outs.get("obj_logits") is not None and \
                    "gt_obj_slot" in batch:
                step_loss = step_loss + og_cross_entropy(
                    outs["obj_logits"], batch["gt_obj_slot"],
                    act & rec["at_goal"])
            losses.append(step_loss)
            if rec["keep"] is not None:
                es = es * rec["keep"][..., None]
                ec = ec * rec["keep"]
        loss_per_ep = torch.stack(losses).sum(dim=0)
        return dict(out, ml_loss=loss_per_ep.sum() / B,
                    loss_per_ep=loss_per_ep)


def to_numpy(tree: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}
