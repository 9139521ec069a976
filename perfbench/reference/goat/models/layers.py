"""Transformer building blocks (counterpart of vln_goat_tpu/models/layers.py).

Float32, or bfloat16 compute with float32 parameters (the config's
`compute_dtype`, as Flax's `dtype=`): `Linear`, `LayerNorm` and
`Embedding` cast per call, so autograd hands the float32 parameters their
gradients through the casts; LayerNorm statistics and every softmax are
taken in float32.  In float32 they are torch's own layers, unchanged.
The tensors the JAX package's remat policies name carry the same
checkpoint names (`ops.remat.checkpoint_name`: `blk` at each sublayer's
output, `attn_probs`, `ffn_wide`; `drop_mask` in `ops.dropout.dropout`).
Dropout sits at every site of the JAX package (attention
probabilities, hidden states, the DETR pano encoder's residual and FFN
branches); it is active in train() mode and draws from the generator that
`ops.dropout.set_generator` gives the model.  Parity rules kept from the
JAX package:
- additive -10000 masks (ops/masks.py), softmax in float32;
- erf GELU;
- LayerNorm eps: config.layer_norm_eps inside BERT blocks, 1e-12 where the
  reference hard-codes it, 1e-5 in the DETR pano encoder;
- attribute names give the reference torch state-dict keys, so a JAX
  parameter tree maps onto `state_dict()` mechanically
  (train/checkpoint.py).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..config import GoatConfig
from ..ops.activations import ACT2FN
from ..ops.attention import fused_qkv_mha
from ..ops.dropout import Dropout
from ..ops.remat import checkpoint_name, ffn_sublayer
from ..ops.masks import extend_neg_masks


def cast_dtype(c: GoatConfig) -> Optional[torch.dtype]:
    """The dtype the layers of config `c` cast to per call: None in float32,
    where they cast nothing (so a float64 copy of a model stays float64)."""
    dt = c.torch_dtype
    return None if dt == torch.float32 else dt


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype` (Flax's Dense(dtype=...), the
    JAX package's `_ProjWeights`, layers.py:67-80): input, weight and bias
    cast per call, the parameters float32.  None: nn.Linear itself."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm; with `compute_dtype` Flax's LayerNorm(dtype=...) and
    the JAX package's `_LNWeights` (layers.py:170-184): statistics in
    float32 with the one-pass variance max(E[x^2] - E[x]^2, 0), the output
    cast to the dtype."""

    def __init__(self, normalized_shape: int, eps: float,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(normalized_shape, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        y = (x32 - mu) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
        return y.to(self.compute_dtype)


class Embedding(nn.Embedding):
    """nn.Embedding whose rows come in `compute_dtype` (Flax's
    Embed(dtype=...)); None: nn.Embedding itself."""

    def __init__(self, num: int, dim: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(num, dim)
        self.compute_dtype = compute_dtype

    def forward(self, ids):
        out = super().forward(ids)
        return out if self.compute_dtype is None \
            else out.to(self.compute_dtype)


class AttentionCore(nn.Module):
    """Scaled dot-product attention with q/k/v projections
    (BertSelfAttention).  bias is an additive float mask broadcastable to
    [B, H, Lq, Lk]; softmax in float32.

    With `use_fused` the fused q/k/v + attention kernel serves query blocks
    of at least `min_lq` tokens, as the JAX package's gate does
    (layers.py:110-137); hoisted text K/V (`kv_cache`) stays on the eager
    path.  In training the fused kernel applies the probability dropout
    itself, from int32 per-row seeds drawn from the dropout generator
    (layers.py:127-133); the eager path drops the probabilities with
    `prob_dropout`.  With `compute_dtype` the fused call takes its inputs,
    weights and biases cast to it (layers.py:134-137)."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 use_fused: bool = False, min_lq: int = 32,
                 dropout_rate: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.use_fused, self.min_lq = use_fused, min_lq
        self.compute_dtype = compute_dtype
        self.query = Linear(hidden_size, d, compute_dtype)
        self.key = Linear(hidden_size, d, compute_dtype)
        self.value = Linear(hidden_size, d, compute_dtype)
        self.prob_dropout = Dropout(dropout_rate)

    def kv(self, kv_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """K/V projections alone (the hoisted text cache)."""
        return self.key(kv_in), self.value(kv_in)

    def forward(self, q_in, kv_in, bias=None, kv_cache=None):
        if (self.use_fused and kv_cache is None
                and q_in.shape[1] >= self.min_lq):
            drop = self.prob_dropout
            rate = drop.rate if drop.training else 0.0
            seed = None
            if rate > 0.0:
                if drop.generator is None:
                    raise ValueError("attention dropout needs a generator: "
                                     "call set_generator(model, g)")
                seed = torch.randint(
                    0, torch.iinfo(torch.int32).max, (q_in.shape[0],),
                    generator=drop.generator, device=q_in.device,
                    dtype=torch.int32)
            dt = self.compute_dtype

            def cast(t):
                return t if dt is None else t.to(dt)

            return fused_qkv_mha(
                cast(q_in).contiguous(), cast(kv_in).contiguous(),
                cast(self.query.weight).t(), cast(self.query.bias),
                cast(self.key.weight).t(), cast(self.key.bias),
                cast(self.value.weight).t(), cast(self.value.bias), bias,
                num_heads=self.num_heads, dropout_rate=rate, seed=seed)
        q = self.query(q_in)
        k, v = kv_cache if kv_cache is not None else self.kv(kv_in)
        B, Lq, Lk = q.shape[0], q.shape[1], k.shape[1]
        H, dh = self.num_heads, self.head_dim
        q = q.view(B, Lq, H, dh)
        k = k.view(B, Lk, H, dh)
        v = v.view(B, Lk, H, dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
        if bias is not None:
            scores = scores + bias.to(scores.dtype)
        probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        probs = self.prob_dropout(checkpoint_name(probs, "attn_probs"))
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return ctx.reshape(B, Lq, H * dh)


class BertSelfOutput(nn.Module):
    def __init__(self, c: GoatConfig):
        super().__init__()
        dt = cast_dtype(c)
        self.dense = Linear(c.hidden_size, c.hidden_size, dt)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps, dt)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, hidden, residual):
        # the layer boundary: all that remat "bounds" keeps
        return checkpoint_name(
            self.LayerNorm(self.dropout(self.dense(hidden)) + residual),
            "blk")


class BertAttention(nn.Module):
    """Self- or cross-attention block with post-LN output."""

    def __init__(self, c: GoatConfig):
        super().__init__()
        self.self = AttentionCore(c.hidden_size, c.num_attention_heads,
                                  c.head_dim, c.use_fused_attention,
                                  c.fused_attn_min_lq,
                                  c.attention_probs_dropout_prob,
                                  cast_dtype(c))
        self.output = BertSelfOutput(c)

    def kv(self, kv_in):
        return self.self.kv(kv_in)

    def forward(self, hidden, kv=None, bias=None, kv_cache=None):
        kv_in = hidden if kv is None else kv
        ctx = self.self(hidden, kv_in, bias, kv_cache=kv_cache)
        return self.output(ctx, hidden)


class BertIntermediate(nn.Module):
    def __init__(self, c: GoatConfig):
        super().__init__()
        self.dense = Linear(c.hidden_size, c.intermediate_size,
                            cast_dtype(c))
        self.act = ACT2FN[c.hidden_act]

    def forward(self, hidden):
        h = checkpoint_name(self.dense(hidden), "ffn_wide")
        return checkpoint_name(self.act(h), "ffn_wide")


class BertOutput(nn.Module):
    def __init__(self, c: GoatConfig):
        super().__init__()
        dt = cast_dtype(c)
        self.dense = Linear(c.intermediate_size, c.hidden_size, dt)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps, dt)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, hidden, residual):
        return checkpoint_name(
            self.LayerNorm(self.dropout(self.dense(hidden)) + residual),
            "blk")


class BertLayer(nn.Module):
    """RobertaLayer: self-attention -> FFN."""

    def __init__(self, c: GoatConfig):
        super().__init__()
        self.attention = BertAttention(c)
        self.intermediate = BertIntermediate(c)
        self.output = BertOutput(c)

    def forward(self, hidden, bias=None):
        h = self.attention(hidden, None, bias)
        return ffn_sublayer(self, self.ffn, h)

    def ffn(self, h):
        return self.output(self.intermediate(h), h)


class BertCrossLayer(nn.Module):
    """Self-attention (graph_sprels added to its bias) -> cross-attention
    -> FFN."""

    def __init__(self, c: GoatConfig):
        super().__init__()
        self.attention = BertAttention(c)
        self.crossattention = BertAttention(c)
        self.intermediate = BertIntermediate(c)
        self.output = BertOutput(c)

    def kv(self, enc_hidden):
        return self.crossattention.kv(enc_hidden)

    def forward(self, hidden, enc_hidden, self_bias=None, cross_bias=None,
                graph_sprels=None, kv_cache=None):
        if graph_sprels is not None:
            self_bias = graph_sprels if self_bias is None \
                else self_bias + graph_sprels
        h = self.attention(hidden, None, self_bias)
        h = self.crossattention(h, enc_hidden, cross_bias, kv_cache=kv_cache)
        return ffn_sublayer(self, self.ffn, h)

    def ffn(self, h):
        return self.output(self.intermediate(h), h)


class CrossmodalEncoder(nn.Module):
    """Stack of BertCrossLayer; queries first, as the reference's
    forward(q, q_masks, kv, kv_masks)."""

    def __init__(self, c: GoatConfig):
        super().__init__()
        self.crossattention = nn.ModuleList(
            BertCrossLayer(c) for _ in range(c.num_x_layers))

    def kv(self, kv_embeds) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per-layer (k, v) projections of kv_embeds (the `kv_only` call
        of the JAX package), computed once per episode."""
        return [layer.kv(kv_embeds) for layer in self.crossattention]

    def forward(self, q_embeds, q_masks, kv_embeds, kv_masks,
                graph_sprels=None, kv_caches=None):
        self_bias = extend_neg_masks(q_masks) if q_masks is not None else None
        cross_bias = extend_neg_masks(kv_masks) \
            if kv_masks is not None else None
        h = q_embeds
        for i, layer in enumerate(self.crossattention):
            h = layer(h, kv_embeds, self_bias, cross_bias, graph_sprels,
                      kv_cache=None if kv_caches is None else kv_caches[i])
        return h


class TorchMultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed in_proj) with the
    JAX package's arithmetic: key padding by float32 min (the scores
    promoted to at least float32 there, as the JAX package's numpy float32
    constant promotes them), f32 softmax."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 dropout_rate: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.compute_dtype = compute_dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, hidden_size))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = Linear(d, d, compute_dtype)
        self.prob_dropout = Dropout(dropout_rate)

    def forward(self, q_in, k_in, v_in, key_padding_mask=None):
        d = self.num_heads * self.head_dim
        w, b = self.in_proj_weight, self.in_proj_bias
        dt = self.compute_dtype
        if dt is not None:
            w, b = w.to(dt), b.to(dt)
            q_in, k_in, v_in = q_in.to(dt), k_in.to(dt), v_in.to(dt)
        q = nn.functional.linear(q_in, w[:d], b[:d])
        k = nn.functional.linear(k_in, w[d:2 * d], b[d:2 * d])
        v = nn.functional.linear(v_in, w[2 * d:], b[2 * d:])
        B, Lq, Lk = q.shape[0], q.shape[1], k.shape[1]
        H, dh = self.num_heads, self.head_dim
        q = q.view(B, Lq, H, dh)
        k = k.view(B, Lk, H, dh)
        v = v.view(B, Lk, H, dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
        if key_padding_mask is not None:
            scores = scores.to(torch.promote_types(
                scores.dtype, torch.float32)).masked_fill(
                    key_padding_mask[:, None, None, :],
                    torch.finfo(torch.float32).min)
        probs = self.prob_dropout(checkpoint_name(
            torch.softmax(scores.float(), dim=-1).to(v.dtype), "attn_probs"))
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, Lq, d)
        return self.out_proj(ctx)


class PanoEncoderLayer(nn.Module):
    """DETR pre-norm encoder layer: x += MHA(LN1(x)); x += FFN(LN2(x)),
    with dropout on the attention probabilities, both residual branches
    and the FFN's hidden layer (all at hidden_dropout_prob)."""

    def __init__(self, c: GoatConfig):
        super().__init__()
        D = c.hidden_size
        p = c.hidden_dropout_prob
        dt = cast_dtype(c)
        self.norm1 = LayerNorm(D, 1e-5, dt)
        self.self_attn = TorchMultiheadAttention(D, c.num_attention_heads,
                                                 c.head_dim, p, dt)
        self.norm2 = LayerNorm(D, 1e-5, dt)
        self.linear1 = Linear(D, c.intermediate_size, dt)
        self.linear2 = Linear(c.intermediate_size, D, dt)
        self.act = ACT2FN[c.hidden_act]
        self.dropout1 = Dropout(p)
        self.dropout = Dropout(p)
        self.dropout2 = Dropout(p)

    def forward(self, src, key_padding_mask=None):
        h = self.norm1(src)
        src = src + self.dropout1(self.self_attn(h, h, h, key_padding_mask))
        return src + ffn_sublayer(self, self.ffn, src)

    def ffn(self, src):
        h = checkpoint_name(self.linear1(self.norm2(src)), "ffn_wide")
        h = checkpoint_name(self.act(h), "ffn_wide")
        h = checkpoint_name(self.dropout(h), "ffn_wide")
        return self.dropout2(self.linear2(h))


class PanoEncoder(nn.Module):
    """Pre-norm DETR encoder stack + final LayerNorm(eps=1e-12)."""

    def __init__(self, c: GoatConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            PanoEncoderLayer(c) for _ in range(c.num_pano_layers))
        self.norm = LayerNorm(c.hidden_size, 1e-12, cast_dtype(c))

    def forward(self, src, key_padding_mask=None):
        h = src
        for layer in self.layers:
            h = layer(h, key_padding_mask)
        return self.norm(h)


class BertPooler(nn.Module):
    """dense + tanh on one token."""

    def __init__(self, c: GoatConfig):
        super().__init__()
        self.dense = Linear(c.hidden_size, c.hidden_size, cast_dtype(c))

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertPredictionHeadTransform(nn.Module):
    """dense -> act -> LayerNorm."""

    def __init__(self, c: GoatConfig):
        super().__init__()
        dt = cast_dtype(c)
        self.dense = Linear(c.hidden_size, c.hidden_size, dt)
        self.act = ACT2FN[c.hidden_act]
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps, dt)

    def forward(self, hidden):
        return self.LayerNorm(self.act(self.dense(hidden)))


class ClsPrediction(nn.Module):
    """Linear -> ReLU -> LN(1e-12) -> Linear (torch names net.0/.2/.3)."""

    def __init__(self, c: GoatConfig, input_size: Optional[int] = None,
                 output_size: int = 1):
        super().__init__()
        D = c.hidden_size
        dt = cast_dtype(c)
        self.net = nn.Sequential(
            Linear(input_size or D, D, dt), nn.ReLU(),
            LayerNorm(D, 1e-12, dt), Linear(D, output_size, dt))

    def forward(self, x):
        return self.net(x)
