"""Text side of GOAT (counterpart of vln_goat_tpu/models/backbone.py):
RoBERTa embeddings, the plain language encoder, and `LanguageEncoderDo`,
the encoder with the BACL back-door (direction / landmark z-dictionaries)
and FACL front-door (cluster bank) text interventions.

As in the JAX package's fine-tune path, position ids are a plain arange
(the reference's padding-offset helper exists but is not called there).
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import GoatConfig
from ..ops.dropout import Dropout
from ..ops.masks import extend_neg_masks
from .layers import (BertAttention, BertLayer, Embedding, LayerNorm, Linear,
                     cast_dtype)


class RobertaEmbeddings(nn.Module):
    def __init__(self, c: GoatConfig):
        super().__init__()
        dt = cast_dtype(c)
        D = c.hidden_size
        self.word_embeddings = Embedding(c.vocab_size, D, dt)
        self.position_embeddings = Embedding(c.max_position_embeddings, D,
                                             dt)
        self.token_type_embeddings = Embedding(c.type_vocab_size, D, dt)
        self.LayerNorm = LayerNorm(D, c.layer_norm_eps, dt)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids):
        B, L = input_ids.shape
        position_ids = torch.arange(
            L, device=input_ids.device)[None, :].expand(B, L)
        h = (self.word_embeddings(input_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids))
             + self.position_embeddings(position_ids))
        return self.dropout(self.LayerNorm(h))


class LanguageEncoder(nn.Module):
    """Plain N-layer RoBERTa stack under an additive -10000 mask."""

    def __init__(self, c: GoatConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c) for _ in range(c.num_l_layers))
        self.update_lang_bert = c.update_lang_bert

    def forward(self, txt_embeds, txt_masks):
        bias = extend_neg_masks(txt_masks)
        h = txt_embeds
        for layer in self.layer:
            h = layer(h, bias)
        return h if self.update_lang_bert else h.detach()


class LanguageEncoderDo(LanguageEncoder):
    """LanguageEncoder's stack + BACL/FACL text interventions (the JAX
    package's backbone.py:85-170).

    type_1: h = z_txt_linear(h) + z_direct_linear(sum_z p(z) z_direc)
    + z_landm_linear(sum_z p(z) z_landm), plus the front-door branch, then
    z_concat_layernorm.  type_2: cross-attention branches to the direction
    and landmark banks (back door) and to the front-door bank, merged by
    `do_add_method`: "door" (a per-token sigmoid gate of Dense(1) on the
    branch sum and on h), "add" or "concat"; then z_concat_layernorm.
    Every LayerNorm here takes layer_norm_eps.  Banks are [B, N, D] (may be
    expanded views), p(z) [B, N, 1]."""

    def __init__(self, c: GoatConfig):
        super().__init__(c)
        dt = cast_dtype(c)
        self.back, self.front = c.do_back_txt, c.do_front_txt
        self.type = c.do_back_txt_type
        self.add_method = c.do_add_method
        D, eps = c.hidden_size, c.layer_norm_eps
        if self.type not in ("type_1", "type_2"):
            raise ValueError(f"do_back_txt_type {self.type!r}")
        if self.add_method not in ("door", "add", "concat"):
            raise ValueError(f"do_add_method {self.add_method!r}")
        if self.type == "type_2" and self.add_method == "concat" \
                and not self.back:
            raise ValueError("the concat merge needs do_back_txt")
        if self.back:
            if self.type == "type_1":
                self.z_txt_linear = Linear(D, D, dt)
            else:
                self.z_direc_cross_attn = BertAttention(c)
                self.z_direct_ln = LayerNorm(D, eps, dt)
                self.z_landm_cross_attn = BertAttention(c)
                self.z_landm_ln = LayerNorm(D, eps, dt)
            self.z_direct_linear = Linear(D, D, dt)
            self.z_landm_linear = Linear(D, D, dt)
        if self.front:
            self.z_front_cross_attn = BertAttention(c)
            self.z_front_linear = Linear(D, D, dt)
            self.z_front_ln = LayerNorm(D, eps, dt)
        if self.type == "type_2":
            if self.add_method == "door":
                self.instr_aug_linear = Linear(D, 1, dt)
                self.instr_ori_linear = Linear(D, 1, dt)
            elif self.add_method == "concat":
                self.concat_linear = Linear(3 * D, D, dt)
        self.z_concat_layernorm = LayerNorm(D, eps, dt)

    @staticmethod
    def _branch(attn, linear, ln, h, bank):
        """Cross-attention from the text to one bank, Linear, LayerNorm."""
        return ln(linear(attn(h, bank)))

    def forward(self, txt_embeds, txt_masks, z_direc_embeds=None,
                z_direc_pzs=None, z_landm_embeds=None, z_landm_pzs=None,
                front_txt_embeds=None):
        h = super().forward(txt_embeds, txt_masks)
        front = self.front and front_txt_embeds is not None
        if self.type == "type_1":
            if self.back:
                sum_direc = (z_direc_embeds * z_direc_pzs.float()).sum(
                    1, keepdim=True)
                sum_landm = (z_landm_embeds * z_landm_pzs.float()).sum(
                    1, keepdim=True)
                h = (self.z_txt_linear(h) + self.z_direct_linear(sum_direc)
                     + self.z_landm_linear(sum_landm))
            if front:
                h = h + self._branch(self.z_front_cross_attn,
                                     self.z_front_linear, self.z_front_ln,
                                     h, front_txt_embeds)
            return self.z_concat_layernorm(h)

        zd = zl = zf = None
        if self.back:
            zd = self._branch(self.z_direc_cross_attn, self.z_direct_linear,
                              self.z_direct_ln, h, z_direc_embeds)
            if z_landm_embeds is not None:
                zl = self._branch(self.z_landm_cross_attn,
                                  self.z_landm_linear, self.z_landm_ln, h,
                                  z_landm_embeds)
        if front:
            zf = self._branch(self.z_front_cross_attn, self.z_front_linear,
                              self.z_front_ln, h, front_txt_embeds)

        if self.add_method == "door":
            if self.back:
                aug = zd
                if zl is not None:
                    aug = aug + zl
                if zf is not None:
                    aug = aug + zf
            else:
                aug = zf
            w = torch.sigmoid(self.instr_aug_linear(aug)
                              + self.instr_ori_linear(h))
            h = w * aug + (1.0 - w) * h
        elif self.add_method == "add":
            if self.back:
                h = h + zd + zl
            if zf is not None:
                h = h + zf
        else:
            h = self.concat_linear(torch.cat([h, zd, zl], dim=-1))
        return self.z_concat_layernorm(h)
