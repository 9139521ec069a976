"""Panorama branch (counterpart of vln_goat_tpu/models/panorama.py), per-step
path for the view-only datasets (R2R/RxR) with the back-door image
intervention off.

The adaptive-fusion softmax is masked to valid views, the JAX package's
deliberate divergence from the reference (README "Numerics parity notes").
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import GoatConfig
from ..ops.dropout import Dropout
from .layers import PanoEncoder

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
        if c.is_objnav or c.do_back_img:
            raise NotImplementedError(
                "object tokens and the back-door image intervention are "
                "not ported yet")
        D = c.hidden_size
        self.img_linear = nn.Linear(c.image_feat_size, D)
        self.img_layer_norm = nn.LayerNorm(D, eps=1e-12)
        self.loc_linear = nn.Linear(c.angle_feat_size + 3, D)
        self.loc_layer_norm = nn.LayerNorm(D, eps=1e-12)
        self.dropout = Dropout(c.hidden_dropout_prob)
        self.img_self_encoder = PanoEncoder(c)
        self.adaptive_pano_attn = nn.Linear(D, 1) \
            if c.adaptive_pano_fusion else None

    def forward(self, view_img_fts, loc_fts, nav_types, view_masks):
        """view_img_fts [B, Lv, Dimg], loc_fts [B, Lv, angle+3],
        view_masks [B, Lv] bool -> (embeds [B, Lv, D], masks, fused [B, D]
        or None).  nav_types is unused on the view-only path."""
        view = self.img_layer_norm(self.img_linear(view_img_fts))
        view = view + self.loc_layer_norm(self.loc_linear(loc_fts))
        view = self.dropout(view)
        embeds = self.img_self_encoder(view,
                                       key_padding_mask=~view_masks)
        fused = None
        if self.adaptive_pano_attn is not None:
            fused = masked_adaptive_fusion(
                embeds, self.adaptive_pano_attn(embeds), view_masks)
        return embeds, view_masks, fused
