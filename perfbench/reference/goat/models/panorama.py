"""Panorama branch (counterpart of vln_goat_tpu/models/panorama.py): the
per-step path of the rollouts and the trajectory path of CFP extraction,
for the view-only datasets (R2R/RxR) and, with object tokens appended
after the views, REVERIE / SOON (`is_objnav`), with the BACL back-door
image intervention (`do_back_img`).  The two paths order it as the
reference does: per step, image projection -> intervention -> (+ location
features); on a trajectory, (+ location features) -> intervention.

The adaptive-fusion softmax is masked to valid views, the JAX package's
deliberate divergence from the reference (README "Numerics parity notes").
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import GoatConfig
from ..ops.dropout import Dropout
from .layers import (BertAttention, Embedding, LayerNorm, Linear,
                     PanoEncoder, cast_dtype)

_NEG = -1e9


def masked_adaptive_fusion(x, weights_logit, mask):
    """softmax(tanh(w))-weighted pooling over valid slots."""
    act = torch.tanh(weights_logit)
    act = torch.where(mask[..., None], act, torch.full_like(act, _NEG))
    w = torch.softmax(act, dim=1)
    return torch.sum(x * w, dim=1)


class CausalImageEmbeddings(nn.Module):
    """Image (and object) embedding + location features + pano
    self-encoder."""

    def __init__(self, c: GoatConfig):
        super().__init__()
        dt = cast_dtype(c)
        D = c.hidden_size
        self.objnav = c.is_objnav
        self.img_linear = Linear(c.image_feat_size, D, dt)
        self.img_layer_norm = LayerNorm(D, 1e-12, dt)
        self.loc_linear = Linear(c.angle_feat_size + 3, D, dt)
        self.loc_layer_norm = LayerNorm(D, 1e-12, dt)
        self.dropout = Dropout(c.hidden_dropout_prob)
        if self.objnav:
            # REVERIE / SOON object tokens (the JAX package's
            # panorama.py:112-140)
            self.obj_reverie_linear = Linear(c.obj_feat_size, D, dt)
            self.obj_name_linear = Embedding(c.obj_name_vocab_size, D, dt) \
                if c.use_obj_name else None
            self.obj_reverie_layer_norm = LayerNorm(D, 1e-12, dt)
            self.nav_type_embedding = Embedding(3, D, dt)
            self.layer_norm = LayerNorm(D, 1e-12, dt)
            self.pano_encoder = PanoEncoder(c)
        else:
            self.img_self_encoder = PanoEncoder(c)
        self.adaptive_pano_attn = Linear(D, 1, dt) \
            if c.adaptive_pano_fusion else None
        self.back = c.do_back_img
        if self.back:
            self.back_type, self.add_method = c.do_back_img_type, \
                c.do_add_method
            if self.back_type not in ("type_1", "type_2") or \
                    self.add_method not in ("door", "add", "concat"):
                raise ValueError(f"do_back_img_type {self.back_type!r} / "
                                 f"do_add_method {self.add_method!r}")
            self.do_img_before_linear = Linear(c.image_feat_size, D, dt)
            self.do_img_layer_norm = LayerNorm(D, 1e-12, dt)
            if self.back_type == "type_2":
                self.do_img_attn = BertAttention(c)
            if self.back_type == "type_1" or self.add_method == "door":
                self.img_after_linear = Linear(D, D, dt)
                self.do_img_after_linear = Linear(D, D, dt)
            elif self.add_method == "concat":
                self.do_concat_img_linear = Linear(2 * D, D, dt)
            self.do_img_concat_layernorm = LayerNorm(D, 1e-12, dt)

    def _backdoor(self, view, z_img_features, z_img_pzs):
        """Back-door image adjustment (the JAX package's panorama.py:49-73)
        of the projected views [B, Lv, D] with the room-type bank
        z_img_features [B, N, Dimg] and its p(z) [B, N, 1].  type_1: a
        p(z)-weighted sum of the projected bank added through two Linears;
        type_2: cross-attention from the views to the projected bank,
        merged by a sigmoid gate of Dense(D) ("door"), a sum ("add") or a
        Linear over the concatenation ("concat").  LayerNorms at 1e-12."""
        z = self.do_img_layer_norm(self.do_img_before_linear(z_img_features))
        if self.back_type == "type_1":
            sum_z = (z * z_img_pzs.float()).sum(1, keepdim=True)
            view = self.img_after_linear(view) \
                + self.do_img_after_linear(sum_z)
        else:
            z = self.do_img_attn(view, z)
            if self.add_method == "door":
                w = torch.sigmoid(self.img_after_linear(view)
                                  + self.do_img_after_linear(z))
                view = w * view + (1.0 - w) * z
            elif self.add_method == "add":
                view = view + z
            else:
                view = self.do_concat_img_linear(torch.cat([view, z], -1))
        return self.do_img_concat_layernorm(view)

    def forward(self, view_img_fts, loc_fts, nav_types, view_masks,
                z_img_features=None, z_img_pzs=None, obj_fts=None,
                obj_masks=None, obj_names=None, per_step: bool = True,
                pretrain: bool = False):
        """view_img_fts [B, Lv, Dimg], loc_fts [B, Lv, angle+3] (with
        objects [B, Lv+Lo, angle+3]), nav_types [B, Lv(+Lo)] (0 view, 1
        candidate, 2 object; read with objects only), view_masks [B, Lv]
        bool, with `do_back_img` the room-type bank z_img_features
        [B, N, Dimg] and p(z) z_img_pzs [B, N, 1]; with objects (REVERIE /
        SOON) obj_fts [B, Lo, Dobj], obj_masks [B, Lo] and, under
        use_obj_name, obj_names [B, Lo] -> (embeds [B, L, D], masks [B, L],
        fused [B, D] or None).  per_step=False is the trajectory path
        (location features added before the intervention); `pretrain` keeps
        the objects' final LayerNorm on it (the JAX package's
        panorama.py:130-134)."""
        view = self.img_layer_norm(self.img_linear(view_img_fts))
        loc = None
        if not self.objnav:
            loc = self.loc_layer_norm(self.loc_linear(loc_fts))
            if not per_step:
                view = view + loc
        if self.back and z_img_features is not None:
            view = self._backdoor(view, z_img_features, z_img_pzs)
        if not self.objnav:
            if per_step:
                view = view + loc
            view = self.dropout(view)
            embeds = self.img_self_encoder(view,
                                           key_padding_mask=~view_masks)
            masks = view_masks
        else:
            obj = self.obj_reverie_linear(obj_fts)
            if self.obj_name_linear is not None and obj_names is not None:
                obj = obj + self.obj_name_linear(obj_names)
            obj = self.obj_reverie_layer_norm(obj)
            embeds = torch.cat([view, obj], dim=1)
            masks = torch.cat([view_masks, obj_masks], dim=1)
            embeds = embeds + self.loc_layer_norm(self.loc_linear(loc_fts)) \
                + self.nav_type_embedding(nav_types)
            if per_step or pretrain:
                embeds = self.layer_norm(embeds)
            embeds = self.pano_encoder(self.dropout(embeds),
                                       key_padding_mask=~masks)
        fused = None
        if self.adaptive_pano_attn is not None:
            fused = masked_adaptive_fusion(
                embeds, self.adaptive_pano_attn(embeds), masks)
        return embeds, masks, fused
