"""Text side of GOAT (counterpart of vln_goat_tpu/models/backbone.py):
RoBERTa embeddings and the plain language encoder.

As in the JAX package's fine-tune path, position ids are a plain arange
(the reference's padding-offset helper exists but is not called there).
The BACL/FACL text interventions (`LanguageEncoderDo`) are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import GoatConfig
from ..ops.dropout import Dropout
from ..ops.masks import extend_neg_masks
from .layers import BertLayer


class RobertaEmbeddings(nn.Module):
    def __init__(self, c: GoatConfig):
        super().__init__()
        D = c.hidden_size
        self.word_embeddings = nn.Embedding(c.vocab_size, D)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, D)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, D)
        self.LayerNorm = nn.LayerNorm(D, eps=c.layer_norm_eps)
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
