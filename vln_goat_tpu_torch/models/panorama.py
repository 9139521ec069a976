"""Panorama branch (counterpart of vln_goat_tpu/models/panorama.py), per-step
path for the view-only datasets (R2R/RxR), with the BACL back-door image
intervention (`do_back_img`) between the image projection and the
location features, as the reference's per-step path orders them.

The adaptive-fusion softmax is masked to valid views, the JAX package's
deliberate divergence from the reference (README "Numerics parity notes").
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import GoatConfig
from ..ops.dropout import Dropout
from .layers import (BertAttention, LayerNorm, Linear, PanoEncoder,
                     cast_dtype)

_NEG = -1e9


def masked_adaptive_fusion(x, weights_logit, mask):
    """softmax(tanh(w))-weighted pooling over valid slots."""
    act = torch.tanh(weights_logit)
    act = torch.where(mask[..., None], act, torch.full_like(act, _NEG))
    w = torch.softmax(act, dim=1)
    return torch.sum(x * w, dim=1)


class CausalImageEmbeddings(nn.Module):
    """Image embedding + location features + pano self-encoder."""

    def __init__(self, c: GoatConfig):
        super().__init__()
        dt = cast_dtype(c)
        if c.is_objnav:
            raise NotImplementedError("object tokens are not ported yet")
        D = c.hidden_size
        self.img_linear = Linear(c.image_feat_size, D, dt)
        self.img_layer_norm = LayerNorm(D, 1e-12, dt)
        self.loc_linear = Linear(c.angle_feat_size + 3, D, dt)
        self.loc_layer_norm = LayerNorm(D, 1e-12, dt)
        self.dropout = Dropout(c.hidden_dropout_prob)
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
                z_img_features=None, z_img_pzs=None):
        """view_img_fts [B, Lv, Dimg], loc_fts [B, Lv, angle+3],
        view_masks [B, Lv] bool, with `do_back_img` the room-type bank
        z_img_features [B, N, Dimg] and p(z) z_img_pzs [B, N, 1] ->
        (embeds [B, Lv, D], masks, fused [B, D] or None).  nav_types is
        unused on the view-only path."""
        view = self.img_layer_norm(self.img_linear(view_img_fts))
        if self.back and z_img_features is not None:
            view = self._backdoor(view, z_img_features, z_img_pzs)
        view = view + self.loc_layer_norm(self.loc_linear(loc_fts))
        view = self.dropout(view)
        embeds = self.img_self_encoder(view,
                                       key_padding_mask=~view_masks)
        fused = None
        if self.adaptive_pano_attn is not None:
            fused = masked_adaptive_fusion(
                embeds, self.adaptive_pano_attn(embeds), view_masks)
        return embeds, view_masks, fused
