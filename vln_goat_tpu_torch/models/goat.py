"""GOAT dual-scale cross-modal navigation model (counterpart of
vln_goat_tpu/models/goat.py): the modes the rollouts run, `forward_text`,
`forward_panorama`, `forward_text_kv` and `forward_navigation`, with the
BACL back-door and FACL front-door modules of the causal configuration
and, for REVERIE / SOON, the object tokens and the object-grounding head
(`og_head`, `obj_logits`); and the `extract_cfp_features` mode,
`extract_cfp` / `cfp_pool` over the tim self-encoders and heads.  `Critic`
is the value head the reference builds and never trains.  In train() mode
every dropout of the JAX package is on, drawing from the generator that
`ops.dropout.set_generator` hands the model.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..config import GoatConfig
from ..ops.dropout import Dropout
from ..ops.masks import extend_neg_masks
from .backbone import LanguageEncoder, LanguageEncoderDo, RobertaEmbeddings
from .layers import (BertAttention, BertPooler,
                     BertPredictionHeadTransform, ClsPrediction,
                     CrossmodalEncoder, Embedding, LayerNorm, Linear,
                     cast_dtype)
from .panorama import CausalImageEmbeddings
from .traj import aggregate_gmap_features

NEG_INF = float("-inf")


class LocalVPEncoder(nn.Module):
    """The local branch's position embedding and cross-modal encoder
    (`cross=False` leaves the encoder out: pretraining's CFP-only task
    sets never run it) and, in the `extract_cfp_features` mode, its tim
    self-encoder."""

    def __init__(self, c: GoatConfig, cross: bool = True):
        super().__init__()
        dt = cast_dtype(c)
        self.vp_pos_embeddings = nn.Sequential(
            Linear(2 * (c.angle_feat_size + 3), c.hidden_size, dt),
            LayerNorm(c.hidden_size, 1e-12, dt))
        self.encoder = CrossmodalEncoder(c) if cross else None
        if c.mode == "extract_cfp_features":
            self.tim_self_encoder = BertAttention(c)

    def pos_embed(self, vp_pos_fts):
        return self.vp_pos_embeddings(vp_pos_fts)


class GlobalMapEncoder(nn.Module):
    """The map branch's input embeddings, cross-modal encoder and graph
    bias (`cross=False` / `sprels=False` leave them out: pretraining's
    task sets that never run them) and, in the `extract_cfp_features`
    mode, its tim self-encoder."""

    def __init__(self, c: GoatConfig, cross: bool = True,
                 sprels: bool = True):
        super().__init__()
        dt = cast_dtype(c)
        self.gmap_pos_embeddings = nn.Sequential(
            Linear(c.angle_feat_size + 3, c.hidden_size, dt),
            LayerNorm(c.hidden_size, 1e-12, dt))
        self.gmap_step_embeddings = Embedding(c.max_action_steps,
                                              c.hidden_size, dt)
        self.encoder = CrossmodalEncoder(c) if cross else None
        self.sprel_linear = Linear(1, 1, dt) \
            if c.graph_sprels and sprels else None
        if c.mode == "extract_cfp_features":
            self.tim_self_encoder = BertAttention(c)

    def input_embed(self, gmap_img_embeds, gmap_step_ids, gmap_pos_fts):
        return (gmap_img_embeds
                + self.gmap_step_embeddings(gmap_step_ids)
                + self.gmap_pos_embeddings(gmap_pos_fts))

    def sprel_bias(self, gmap_pair_dists):
        """graph_sprels additive attention bias [B, 1, G, G]."""
        if self.sprel_linear is None:
            return None
        return self.sprel_linear(gmap_pair_dists[..., None]).squeeze(-1)[:, None]


def fuse_logits(global_logits, local_logits, gmap_masks, gmap_visited_masks,
                vp_nav_masks, local_to_gmap, first_cand_slot: int = 2,
                first_gmap_slot: int = 2):
    """Fuse the local branch's candidate scores into the global map's
    (the JAX package's `fuse_logits`).  Each local candidate adds its score
    to its gmap slot; a visited candidate's score goes to the backtrack sum
    that every unvisited slot without a direct candidate receives.  The
    scatter adds each value to zeros only, so it is exact in float32.
    Candidates start at local slot `first_cand_slot` and map nodes at gmap
    slot `first_gmap_slot`: 2 in fine-tuning (stop, [MEM]), 1 in
    pretraining, whose map has no [MEM] token.

    Returns (fused [B, G], masked_global [B, G], masked_local [B, L])."""
    B, G = global_logits.shape
    L = local_logits.shape[1]
    dev = global_logits.device
    slot = torch.arange(G, device=dev)[None, :]
    lslot = torch.arange(L, device=dev)[None, :]
    # a fill, not a copy from pageable memory (which waits for the card)
    ninf = torch.full((), NEG_INF, device=dev)

    masked_global = torch.where(gmap_visited_masks, ninf, global_logits)
    masked_global = torch.where(gmap_masks, masked_global, ninf)
    masked_local = torch.where(vp_nav_masks, local_logits, ninf)

    is_cand = (lslot >= first_cand_slot) & (local_to_gmap >= 0) \
        & vp_nav_masks
    zero = torch.zeros_like(local_logits)
    lv = torch.where(is_cand, local_logits, zero)
    tgt = local_to_gmap.clamp(0, G - 1).long()
    cand_visited = torch.gather(gmap_visited_masks, 1, tgt) & is_cand
    bw = torch.where(cand_visited, lv, zero).sum(dim=1)
    direct = torch.zeros_like(global_logits).scatter_add_(
        1, tgt, torch.where(cand_visited, zero, lv))
    has_direct = torch.zeros_like(global_logits).scatter_add_(
        1, tgt, (is_cand & ~cand_visited).to(lv.dtype)) > 0

    unvis = (slot >= first_gmap_slot) & ~gmap_visited_masks & gmap_masks
    fused = masked_global + torch.where(
        unvis, torch.where(has_direct, direct, bw[:, None]),
        torch.zeros_like(masked_global))
    # the stop slot takes the local stop logit (no write in place: remat
    # policies may keep `fused`'s first value)
    fused = torch.cat([fused[:, :1] + local_logits[:, :1], fused[:, 1:]], 1)
    return fused, masked_global, masked_local


class FrontDoorEncoder(nn.Module):
    """FACL front-door encoder (the JAX package's goat.py:427-448):
    self-attention over the tokens under their key mask, cross-attention
    from them to the cluster bank, LayerNorm(1e-12) of the sum, and a
    per-token sigmoid gate of Dense(1) on it and on the input that mixes
    the two."""

    def __init__(self, c: GoatConfig):
        super().__init__()
        dt = cast_dtype(c)
        D = c.hidden_size
        self.ll_self_attn = BertAttention(c)
        self.lg_cross_attn = BertAttention(c)
        self.ln = LayerNorm(D, 1e-12, dt)
        self.aug_linear = Linear(D, 1, dt)
        self.ori_linear = Linear(D, 1, dt)

    def forward(self, local_feats, global_feats, local_feats_masks=None):
        bias = None if local_feats_masks is None \
            else extend_neg_masks(local_feats_masks)
        ll = self.ll_self_attn(local_feats, None, bias)
        lg = self.lg_cross_attn(local_feats, global_feats)
        out = self.ln(ll + lg)
        w = torch.sigmoid(self.aug_linear(out)
                          + self.ori_linear(local_feats))
        return w * out + (1.0 - w) * local_feats


# the raw parameters of the CFP pooling, [hidden, 1] each (the JAX
# package's goat.py:203-205; its checkpoint.py RAW_PARAMS)
TIM_ATTN = ("tim_global_attn", "tim_local_attn", "tim_txt_attn")


class GoatModel(nn.Module):
    """GlocalTextPathNavCMT equivalent, the modes of the decode and
    training rollouts and of CFP extraction."""

    def __init__(self, c: GoatConfig):
        super().__init__()
        dt = cast_dtype(c)
        self.config = c
        self.embeddings = RobertaEmbeddings(c)
        self.lang_encoder = LanguageEncoderDo(c) \
            if c.do_back_txt or c.do_front_txt else LanguageEncoder(c)
        self.img_embeddings = CausalImageEmbeddings(c)
        self.local_encoder = LocalVPEncoder(c)
        self.global_encoder = GlobalMapEncoder(c)
        self.global_sap_head = ClsPrediction(c)
        self.local_sap_head = ClsPrediction(c)
        self.sap_fuse_linear = ClsPrediction(
            c, input_size=c.hidden_size * 2) if c.glocal_fuse else None
        # object grounding (REVERIE / SOON)
        self.og_head = ClsPrediction(c) if c.obj_feat_size > 0 else None
        self.gmap_pooler = BertPooler(c)
        self.vp_pooler = BertPooler(c)
        self.txt_pooler = BertPooler(c)
        self.local_his_map = Linear(3 * c.hidden_size, c.hidden_size, dt)
        self.local_his_ln = LayerNorm(c.hidden_size, c.layer_norm_eps, dt)
        # env-feature dropout on the raw view features
        # (vln_goat_tpu/models/goat.py:195, :245)
        self.drop_env = Dropout(c.feat_dropout)
        if c.mode == "extract_cfp_features":
            self.tim_global_head = BertPredictionHeadTransform(c)
            self.tim_local_head = BertPredictionHeadTransform(c)
            self.tim_txt_head = BertPredictionHeadTransform(c)
            for name in TIM_ATTN:
                self.register_parameter(
                    name, nn.Parameter(torch.empty(c.hidden_size, 1)))
        # FACL front-door encoders (goat.py:211-219).  front_txt_encoder is
        # built as the reference builds it, and like it never called: the
        # text's front-door bank goes to the language encoder's
        # z_front_cross_attn.  Its parameters get no gradient; AdamW decays
        # them, as optax decays leaves whose gradient is zero.
        if c.do_front_img:
            self.front_local_encoder = FrontDoorEncoder(c)
        if c.do_front_his:
            self.front_global_encoder = FrontDoorEncoder(c)
        if c.do_front_txt:
            self.front_txt_encoder = FrontDoorEncoder(c)

    def forward_text(self, txt_ids, txt_masks, z_direc_embeds=None,
                     z_direc_pzs=None, z_landm_embeds=None, z_landm_pzs=None,
                     front_txt_embeds=None):
        """Instruction encoding [B, Lt, D]; with the causal text flags the
        banks (each [B, N, D], p(z) [B, N, 1]) go to LanguageEncoderDo."""
        h = self.embeddings(txt_ids)
        if isinstance(self.lang_encoder, LanguageEncoderDo):
            return self.lang_encoder(h, txt_masks, z_direc_embeds,
                                     z_direc_pzs, z_landm_embeds,
                                     z_landm_pzs, front_txt_embeds)
        return self.lang_encoder(h, txt_masks)

    def forward_panorama(self, view_img_fts, loc_fts, nav_types, view_masks,
                         z_img_features=None, z_img_pzs=None, obj_fts=None,
                         obj_masks=None, obj_names=None,
                         already_dropout: bool = False):
        """The per-step panorama encoding (CausalImageEmbeddings) of the
        raw view features after the env-feature dropout, which the object
        features take too (the JAX package's goat.py:240-251); with
        `already_dropout` (back-translation's shared noise is already in
        the view features) neither takes it."""
        if not already_dropout:
            view_img_fts = self.drop_env(view_img_fts)
            if obj_fts is not None:
                obj_fts = self.drop_env(obj_fts)
        return self.img_embeddings(view_img_fts, loc_fts,
                                   nav_types, view_masks, z_img_features,
                                   z_img_pzs, obj_fts, obj_masks, obj_names)

    def forward_text_kv(self, txt_embeds):
        """Per-layer cross-attention K/V projections of the instruction,
        computed once per episode and fed to forward_navigation(txt_kv=)."""
        return {"global": self.global_encoder.encoder.kv(txt_embeds),
                "local": self.local_encoder.encoder.kv(txt_embeds)}

    def forward_navigation(
        self, txt_embeds, txt_masks,
        gmap_img_embeds, gmap_step_ids, gmap_pos_fts, gmap_masks,
        gmap_pair_dists, gmap_visited_masks,
        vp_img_embeds, vp_pos_fts, vp_masks, vp_nav_masks,
        local_to_gmap, vp_obj_masks=None, front_vp_feats=None,
        front_gmap_feats=None, txt_kv=None,
    ) -> Dict[str, torch.Tensor]:
        """The navigation step's logits; with `vp_obj_masks` [B, L] (True
        at the object tokens of the local branch) and an object head, the
        object-grounding logits `obj_logits` [B, L], -inf outside the mask
        (None otherwise)."""
        ge, le = self.global_encoder, self.local_encoder
        gmap_embeds = ge.input_embed(gmap_img_embeds, gmap_step_ids,
                                     gmap_pos_fts)
        graph_sprels = ge.sprel_bias(gmap_pair_dists)
        if front_gmap_feats is not None:
            gmap_embeds = self.front_global_encoder(
                gmap_embeds, front_gmap_feats, gmap_masks)
        vp_embeds = vp_img_embeds + le.pos_embed(vp_pos_fts)
        if front_vp_feats is not None:
            vp_embeds = self.front_local_encoder(vp_embeds, front_vp_feats,
                                                 vp_masks)

        gmap_embeds = ge.encoder(
            gmap_embeds, gmap_masks, txt_embeds, txt_masks,
            graph_sprels=graph_sprels,
            kv_caches=None if txt_kv is None else txt_kv["global"])
        vp_embeds = le.encoder(
            vp_embeds, vp_masks, txt_embeds, txt_masks,
            kv_caches=None if txt_kv is None else txt_kv["local"])

        if self.sap_fuse_linear is not None:
            fuse_weights = torch.sigmoid(self.sap_fuse_linear(
                torch.cat([gmap_embeds[:, 0], vp_embeds[:, 0]], dim=1)))
        else:
            fuse_weights = 0.5
        global_logits = self.global_sap_head(gmap_embeds).squeeze(-1) \
            * fuse_weights
        local_logits = self.local_sap_head(vp_embeds).squeeze(-1) \
            * (1.0 - fuse_weights)
        fused_logits, global_logits, local_logits = fuse_logits(
            global_logits, local_logits, gmap_masks, gmap_visited_masks,
            vp_nav_masks, local_to_gmap)

        obj_logits = None
        if vp_obj_masks is not None and self.og_head is not None:
            obj_logits = self.og_head(vp_embeds).squeeze(-1)
            obj_logits = torch.where(vp_obj_masks, obj_logits,
                                     torch.full_like(obj_logits, NEG_INF))

        cls_embeds = self.local_his_ln(self.local_his_map(torch.cat([
            self.gmap_pooler(gmap_embeds), self.vp_pooler(vp_embeds),
            self.txt_pooler(txt_embeds)], dim=-1)))
        return {
            "gmap_embeds": gmap_embeds,
            "vp_embeds": vp_embeds,
            "global_logits": global_logits,
            "local_logits": local_logits,
            "fused_logits": fused_logits,
            "obj_logits": obj_logits,
            "cls_embeds": cls_embeds,
        }

    def extract_cfp(self, batch) -> Dict[str, torch.Tensor]:
        """The `extract_cfp_features` mode (the JAX package's goat.py:
        346-394): a batch of `pretrain.data.TrajBatchBuilder(task="cfp")`
        (tensors) -> the attention-pooled txt / vp / gmap vectors
        (`cfp_pool`).  The trajectory's panoramas go through the
        panorama encoder's trajectory path, the map tokens take
        `traj.aggregate_gmap_features` of them and run through the global
        branch's tim self-encoder, the last viewpoint's panorama through
        the local branch's."""
        txt_embeds = self.forward_text(batch["txt_ids"], batch["txt_masks"])
        v = batch["traj_view_img_fts"]
        B, T, Lp = v.shape[:3]

        def flat(x):
            return x.reshape((B * T,) + tuple(x.shape[2:]))

        embeds, masks, fused = self.img_embeddings(
            flat(v), flat(batch["traj_loc_fts"]),
            flat(batch["traj_nav_types"]), flat(batch["traj_view_masks"]),
            per_step=False)
        D = embeds.shape[-1]
        embeds = embeds.reshape(B, T, Lp, D)
        masks = masks.reshape(B, T, Lp)
        if fused is None:
            m = masks[..., None].to(embeds.dtype)
            fused = (embeds * m).sum(2) / m.sum(2).clamp(min=1.0)
        else:
            fused = fused.reshape(B, T, D)
        stepm = batch["step_masks"].to(embeds.dtype)
        embeds = embeds * stepm[..., None, None]
        fused = fused * stepm[..., None]

        ge, le = self.global_encoder, self.local_encoder
        gmap_img = aggregate_gmap_features(
            embeds, fused, batch["gmap_visited_step"], batch["cand_to_gmap"],
            batch["gmap_step_ids"].shape[1])
        gmap_embeds = ge.input_embed(gmap_img, batch["gmap_step_ids"],
                                     batch["gmap_pos_fts"])
        gmap_embeds = ge.tim_self_encoder(
            gmap_embeds, None, extend_neg_masks(batch["gmap_masks"]))

        bidx = torch.arange(B, device=v.device)
        last = batch["traj_len"].long() - 1
        vp_img = torch.cat([torch.zeros(B, 1, D, device=v.device),
                            embeds[bidx, last].float()], dim=1)
        vp_masks = torch.cat(
            [torch.ones(B, 1, dtype=torch.bool, device=v.device),
             masks[bidx, last]], dim=1)
        vp_embeds = vp_img + le.pos_embed(batch["vp_pos_fts"])
        vp_embeds = le.tim_self_encoder(vp_embeds, None,
                                        extend_neg_masks(vp_masks))
        return self.cfp_pool(gmap_embeds, vp_embeds, txt_embeds)

    def cfp_pool(self, gmap_embeds, vp_embeds, txt_embeds
                 ) -> Dict[str, torch.Tensor]:
        """tanh of the attention-pooled head transform of each sequence:
        softmax over the tokens of tanh(h) a, a the tim_*_attn vector."""
        def pool(x, head, attn):
            h = head(x)
            a = torch.softmax(torch.tanh(h) @ attn.to(h.dtype), dim=1)
            return torch.tanh((h * a).sum(dim=1))

        return {
            "gmap_outputs": pool(gmap_embeds, self.tim_global_head,
                                 self.tim_global_attn),
            "vp_outputs": pool(vp_embeds, self.tim_local_head,
                               self.tim_local_attn),
            "txt_outputs": pool(txt_embeds, self.tim_txt_head,
                                self.tim_txt_attn),
        }


class Critic(nn.Module):
    """Value head 768 -> 512 -> 1 (the JAX package's goat.py:409-424, torch
    names state2value.0 / .3): built and optimized by the reference but
    never trained (no RL loss is computed), ported for checkpoint parity."""

    def __init__(self, c: GoatConfig):
        super().__init__()
        dt = cast_dtype(c)
        self.state2value = nn.Sequential(
            Linear(c.hidden_size, 512, dt), nn.ReLU(),
            Dropout(c.hidden_dropout_prob), Linear(512, 1, dt))

    def forward(self, state):
        return self.state2value(state).squeeze(-1)
