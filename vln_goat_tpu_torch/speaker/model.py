"""Transpeaker: the encoder-decoder transformer speaker of back-translation
(counterpart of vln_goat_tpu/speaker/model.py), as torch modules under the
reference's own names (map_nav_src/models/transpeaker_model.py), so a
reference Transpeaker state dict loads without renaming.

Kept from the reference and the JAX package:
- the attention's inner width is num_heads * head_dim (4 * 64 = 256), not
  the hidden size (:11-17);
- the post-attention and FFN LayerNorms are made afresh every forward in
  the reference, so they have no parameters: `_norm`, eps 1e-5;
- every projection is bias-free (:93-96); `encoder.down_size` has a bias;
- masks are True where masked, filled with -1e9 (not -inf and not the
  float32 minimum), and the softmax runs in float32 (JAX :94);
- dropout on the attention probabilities and on each attention block's
  output; the feature dropout on the image columns only (JAX :156-164);
- the sinusoidal position table built in numpy float32 (:32-47).

Hyper-parameters (r2r/parser.py:103-118): hidden 512, word 256, heads 4 of
64, FFN 1024, 3 layers, angle features 128.  The speaker reaches no TPU
kernel in the JAX package (its attention is einsum and softmax), so its
attention here is plain PyTorch too.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.dropout import Dropout

MASK_FILL = -1e9


@dataclass
class SpeakerConfig:
    vocab_size: int = 1000
    feature_size: int = 768 + 128   # image + angle (128)
    image_feat_size: int = 768
    hidden_size: int = 512          # h_dim
    word_size: int = 256            # wemb
    head_dim: int = 64              # aemb
    num_heads: int = 4
    num_layers: int = 3
    ff_dim: int = 1024              # proj_hidden
    dropout: float = 0.2            # speaker_dropout
    feat_dropout: float = 0.3       # featdropout
    max_decode: int = 120
    pad_id: int = 0
    # the legacy vocabulary [<PAD>, <UNK>, <EOS>, ...words..., <BOS>]:
    # <BOS> is the last slot (utils/data.py:308), <EOS> index 2
    bos_id: Optional[int] = None
    eos_id: int = 2

    def __post_init__(self):
        if self.bos_id is None:
            self.bos_id = self.vocab_size - 1


def _norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The parameterless LayerNorm (the reference's untrained per-call
    LayerNorm): the biased variance, as the JAX package computes it."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def sinusoid_table(max_len: int, d: int) -> np.ndarray:
    pe = np.zeros((max_len, d), np.float32)
    pos = np.arange(max_len)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, d, 2).astype(np.float32) * (-math.log(1e4) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _pe(n: int, d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(sinusoid_table(n, d)).to(like.device, like.dtype)


class SpeakerMHA(nn.Module):
    """MultiHeadAttention (transpeaker_model.py:88-115): bias-free W_Q /
    W_K / W_V to heads * head_dim and `fc` back to the query width, the
    residual and the parameterless LayerNorm."""

    def __init__(self, c: SpeakerConfig, q_dim: int,
                 kv_dim: Optional[int] = None):
        super().__init__()
        d, kv_dim = c.num_heads * c.head_dim, kv_dim or q_dim
        self.h, self.dh = c.num_heads, c.head_dim
        self.W_Q = nn.Linear(q_dim, d, bias=False)
        self.W_K = nn.Linear(kv_dim, d, bias=False)
        self.W_V = nn.Linear(kv_dim, d, bias=False)
        self.fc = nn.Linear(d, q_dim, bias=False)
        self.dropout = Dropout(c.dropout)

    def forward(self, q_in, k_in, v_in, mask=None):
        B, Lq, Lk = q_in.shape[0], q_in.shape[1], k_in.shape[1]
        q = self.W_Q(q_in).view(B, Lq, self.h, self.dh)
        k = self.W_K(k_in).view(B, Lk, self.h, self.dh)
        v = self.W_V(v_in).view(B, Lk, self.h, self.dh)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.dh)
        if mask is not None:                      # True = masked
            s = s.masked_fill(mask[:, None], MASK_FILL)
        p = torch.softmax(s.float(), -1).to(q.dtype)
        p = self.dropout(p)
        ctx = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, Lq, -1)
        return self.dropout(_norm(self.fc(ctx) + q_in)), p


class SpeakerFFN(nn.Module):
    """PoswiseFeedForwardNet: fc.0, ReLU, dropout, fc.3 (bias-free), the
    residual and the parameterless LayerNorm."""

    def __init__(self, c: SpeakerConfig, dim: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(dim, c.ff_dim, bias=False),
                                nn.ReLU(), Dropout(c.dropout),
                                nn.Linear(c.ff_dim, dim, bias=False))

    def forward(self, x):
        return _norm(self.fc(x) + x)


class EncoderLayer(nn.Module):
    def __init__(self, c: SpeakerConfig):
        super().__init__()
        self.enc_self_attn = SpeakerMHA(c, c.hidden_size)
        self.pos_ffn = SpeakerFFN(c, c.hidden_size)

    def forward(self, h, mask):
        return self.pos_ffn(self.enc_self_attn(h, h, h, mask)[0])


class DecoderLayer(nn.Module):
    def __init__(self, c: SpeakerConfig):
        super().__init__()
        self.dec_self_attn = SpeakerMHA(c, c.word_size)
        self.dec_enc_attn = SpeakerMHA(c, c.word_size, c.hidden_size)
        self.pos_ffn = SpeakerFFN(c, c.word_size)

    def forward(self, x, enc, self_mask, cross_mask):
        x = self.dec_self_attn(x, x, x, self_mask)[0]
        x = self.dec_enc_attn(x, enc, enc, cross_mask)[0]
        return self.pos_ffn(x)


class SpeakerEncoder(nn.Module):
    def __init__(self, c: SpeakerConfig):
        super().__init__()
        self.down_size = nn.Linear(c.feature_size, c.hidden_size)
        self.image_self_attn = SpeakerMHA(c, c.hidden_size, c.feature_size)
        self.layers = nn.ModuleList(EncoderLayer(c)
                                    for _ in range(c.num_layers))


class SpeakerDecoder(nn.Module):
    def __init__(self, c: SpeakerConfig):
        super().__init__()
        self.embedding = nn.Embedding(c.vocab_size, c.word_size)
        self.layers = nn.ModuleList(DecoderLayer(c)
                                    for _ in range(c.num_layers))


class TranspeakerModel(nn.Module):
    """The whole encoder-decoder (transpeaker_model.py:238-256)."""

    def __init__(self, cfg: SpeakerConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = SpeakerEncoder(cfg)
        self.decoder = SpeakerDecoder(cfg)
        self.projection = nn.Linear(cfg.word_size, cfg.vocab_size,
                                    bias=False)
        self.drop_feat = Dropout(cfg.feat_dropout)
        self.drop = Dropout(cfg.dropout)

    def _drop_image(self, x):
        n = self.cfg.image_feat_size
        return torch.cat([self.drop_feat(x[..., :n]), x[..., n:]], -1)

    def encode(self, action_inputs, feature_inputs, step_masks,
               already_dropfeat: bool = False):
        """action_inputs [B, T, F], feature_inputs [B, T, 36, F],
        step_masks [B, T] (True on valid steps) -> (the image attention's
        step embeddings [B, T, H], the encoder's output [B, T, H])."""
        c = self.cfg
        B, T, F = action_inputs.shape
        if not already_dropfeat:
            action_inputs = self._drop_image(action_inputs)
            feature_inputs = self._drop_image(feature_inputs)
        e = self.encoder
        ctx = e.down_size(action_inputs).reshape(B * T, 1, c.hidden_size)
        feats = feature_inputs.reshape(B * T, 36, F)
        enc_inputs = e.image_self_attn(ctx, feats, feats)[0].reshape(
            B, T, c.hidden_size)
        h = self.drop(enc_inputs + _pe(T, c.hidden_size, enc_inputs)[None])
        mask = (~step_masks)[:, None, :].expand(B, T, T)
        for layer in e.layers:
            h = layer(h, mask)
        return enc_inputs, h

    def decode_hidden(self, dec_inputs, enc_outputs, step_masks):
        """dec_inputs [B, L] token ids (pad 0) -> the decoder's last hidden
        states [B, L, word_size], before the projection."""
        c = self.cfg
        B, L = dec_inputs.shape
        x = self.decoder.embedding(dec_inputs)
        x = x + _pe(L, c.word_size, x)[None]
        causal = torch.ones(L, L, dtype=torch.bool,
                            device=x.device).triu(1)
        self_mask = (dec_inputs == c.pad_id)[:, None, :] | causal[None]
        cross_mask = (~step_masks)[:, None, :].expand(
            B, L, enc_outputs.shape[1])
        for layer in self.decoder.layers:
            x = layer(x, enc_outputs, self_mask, cross_mask)
        return x

    def decode(self, dec_inputs, enc_outputs, step_masks):
        """-> logits [B, L, vocab]."""
        return self.projection(self.decode_hidden(dec_inputs, enc_outputs,
                                                  step_masks))

    def forward(self, action_inputs, feature_inputs, step_masks, dec_inputs,
                already_dropfeat: bool = False):
        _, enc = self.encode(action_inputs, feature_inputs, step_masks,
                             already_dropfeat)
        return self.decode(dec_inputs, enc, step_masks)
