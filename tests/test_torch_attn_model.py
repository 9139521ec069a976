"""A numpy model of the arithmetic of the bf16 attention cores written for
Hopper, `ops/csrc/attn_fwd_sm90.cuh` (the forward core, K1 bf16's
attention) and `ops/csrc/attn_bwd_sm90.cuh` (the backward core, K2 (a)
bf16's), in their stated order, held against the JAX package's Pallas
kernel `pallas_fused_qkv_mha(..., interpret=True)` and its custom VJP on
bf16 arrays, dropout off.

The model reads its tile size and head width out of the headers and does
what the kernels do, in float32 where they do:

- the projections as the bf16 GEMM core leaves them: bf16 products summed
  in float32 plus the bias, rounded to bf16;
- the forward core: per 64-row query tile, 64-key tiles in order;
  s = q k^T * scale + bias; the running max m and sum l (l rescaled by
  exp(m_old - m_new)); e = exp(s - m) rounded to bf16 before e v, the
  output accumulator rescaled with l; the output o / l rounded to bf16;
- the backward core: with one key tile the row statistics from the tile
  itself, with more a first sweep keeping them online; per (key tile,
  query tile) p = exp(s - m) / l, ds = p (dp - rowsum(p dp)), p and ds
  rounded to bf16 as they enter dv += p^T dO, dk += ds^T q and
  dq += ds k; dk and dv summed over the query tiles, dq over the key
  tiles in float32 and rounded once; then the projection backward on the
  bf16 dq, dk, dv.

Gate, as tests/test_torch_bf16_attention.py states it: each result's
distance from the JAX kernel in float32 on the same values, scaled by its
largest magnitude (the key bias's gradient at its weight's), at most twice
the JAX bf16 kernel's distance plus 1e-3 (a quarter bf16 ulp).  The key
lengths cross one, several and a ragged last key tile (24, 60, 200, 300,
520); 70 queries make two query tiles."""
import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vln_goat_tpu.ops.attention import pallas_fused_qkv_mha

CSRC = (Path(__file__).resolve().parent.parent / "vln_goat_tpu_torch" / "ops"
        / "csrc")
HEADERS = ("attn_sm90.cuh", "attn_fwd_sm90.cuh", "attn_bwd_sm90.cuh")


def _constants():
    """The headers' namespace-level `constexpr int`s, evaluated in order."""
    env = {}
    for name in HEADERS:
        text = re.sub(r"//[^\n]*", "", (CSRC / name).read_text())
        for decl in re.findall(r"^constexpr int ([^;]+);", text, re.M):
            for part in decl.split(","):
                key, expr = (s.strip() for s in part.split("=", 1))
                env[key] = int(eval(expr, {}, dict(env)))  # noqa: S307
    return env


C = _constants()
# the model runs at head width 64, one tile's 64 head columns (TW)
TILE, DH = C["TILE"], C["TW"]
ATOL = 1e-3
B, H, Lq = 2, 2, 70
D = H * DH
F = np.float32
NAMES = ("x", "y", "wq", "bq", "wk", "bk", "wv", "bv", "bias")


def bf16(a):
    """a rounded to bf16 (to nearest, ties to even), as float32."""
    u = np.ascontiguousarray(a, F).view(np.uint32)
    u = (u + (((u >> 16) & 1) + 0x7FFF)) & 0xFFFF0000
    return u.view(F)


def project(x, w, b):
    return bf16(x.astype(F) @ w.astype(F) + b)


def heads(t):
    return t.reshape(t.shape[0], t.shape[1], H, DH)


def forward_model(q, k, v, bias, scale):
    """The forward core over q [B, Lq, H, dh], k, v [B, Lk, H, dh], bias
    [B, Hb, Lq, Lk]."""
    Lk = k.shape[1]
    out = np.zeros(q.shape, F)
    for b in range(B):
        for h in range(H):
            hb = h if bias.shape[1] == H else 0
            for q0 in range(0, Lq, TILE):
                qt = q[b, q0:q0 + TILE, h]
                m = np.full(len(qt), -np.inf, F)
                l = np.zeros(len(qt), F)
                o = np.zeros((len(qt), DH), F)
                for k0 in range(0, Lk, TILE):
                    s = (qt @ k[b, k0:k0 + TILE, h].T) * F(scale) \
                        + bias[b, hb, q0:q0 + TILE, k0:k0 + TILE]
                    m_new = np.maximum(m, s.max(1))
                    alpha = np.where(m == -np.inf, F(0), np.exp(m - m_new))
                    e = np.exp(s - m_new[:, None])
                    l = l * alpha + e.sum(1, dtype=F)
                    o = o * alpha[:, None] + bf16(e) @ v[b, k0:k0 + TILE, h]
                    m = m_new
                out[b, q0:q0 + TILE, h] = bf16(o / l[:, None])
    return out


def backward_model(q, k, v, dO, bias, scale):
    """The backward core: dq, dk, dv (bf16 values) and ds (float32)
    [B, H, Lq, Lk]."""
    Lk = k.shape[1]
    dq, dk, dv = (np.zeros(t.shape, F) for t in (q, k, v))
    ds_all = np.zeros((B, H, Lq, Lk), F)
    for b in range(B):
        for h in range(H):
            hb = h if bias.shape[1] == H else 0

            def tiles(q0, k0):
                qt, ot = q[b, q0:q0 + TILE, h], dO[b, q0:q0 + TILE, h]
                kt, vt = k[b, k0:k0 + TILE, h], v[b, k0:k0 + TILE, h]
                s = (qt @ kt.T) * F(scale) \
                    + bias[b, hb, q0:q0 + TILE, k0:k0 + TILE]
                return qt, ot, kt, vt, s, ot @ vt.T

            stats = {}
            for q0 in range(0, Lq, TILE):
                m = l = d = None
                for k0 in range(0, Lk, TILE):
                    *_, s, dp = tiles(q0, k0)
                    if m is None:
                        m = np.full(len(s), -np.inf, F)
                        l, d = np.zeros(len(s), F), np.zeros(len(s), F)
                    m_new = np.maximum(m, s.max(1))
                    alpha = np.where(m == -np.inf, F(0), np.exp(m - m_new))
                    e = np.exp(s - m_new[:, None])
                    l = l * alpha + e.sum(1, dtype=F)
                    d = d * alpha + (e * dp).sum(1, dtype=F)
                    m = m_new
                stats[q0] = (m, l, d / l)
            dq_run = np.zeros((Lq, DH), F)
            for k0 in range(0, Lk, TILE):
                dka = np.zeros((min(TILE, Lk - k0), DH), F)
                dva = np.zeros_like(dka)
                for q0 in range(0, Lq, TILE):
                    qt, ot, kt, vt, s, dp = tiles(q0, k0)
                    m, l, dsum = stats[q0]
                    p = np.exp(s - m[:, None]) / l[:, None]
                    ds = p * (dp - dsum[:, None])
                    ds_all[b, h, q0:q0 + TILE, k0:k0 + TILE] = ds
                    dq_run[q0:q0 + TILE] += (bf16(ds) @ kt) * F(scale)
                    dva += bf16(p).T @ ot
                    dka += bf16(ds).T @ qt
                dk[b, k0:k0 + TILE, h] = bf16(dka * F(scale))
                dv[b, k0:k0 + TILE, h] = bf16(dva)
            dq[b, :, h] = bf16(dq_run)
    return dq, dk, dv, ds_all


def model(args, dout):
    """Output and the gradients of every input, in NAMES order."""
    x, y, wq, bq, wk, bk, wv, bv, bias = args
    scale = 1.0 / np.sqrt(DH)
    q, k, v = (heads(project(s, w, b_)) for s, w, b_ in
               ((x, wq, bq), (y, wk, bk), (y, wv, bv)))
    out = forward_model(q, k, v, bias, scale).reshape(B, Lq, D)
    dq, dk, dv, ds = backward_model(q, k, v, heads(dout), bias, scale)
    dq, dk, dv = (t.reshape(t.shape[0], t.shape[1], D) for t in (dq, dk, dv))
    flat = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    grads = [bf16(dq @ wq.T), bf16(dk @ wk.T + dv @ wv.T),
             bf16(flat(x).T @ flat(dq)), bf16(flat(dq).sum(0)),
             bf16(flat(y).T @ flat(dk)), bf16(flat(dk).sum(0)),
             bf16(flat(y).T @ flat(dv)), bf16(flat(dv).sum(0)),
             bf16(ds if bias.shape[1] == H else ds.sum(1, keepdims=True))]
    return out, grads


def _jax(args, dout, dtype):
    def loss(*a):
        o = pallas_fused_qkv_mha(*a[:8], a[8], num_heads=H, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * dout), o

    a = [jnp.asarray(t, dtype) for t in args]
    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(a))), has_aux=True)(*a)
    f64 = lambda t: np.asarray(t.astype(jnp.float32), np.float64)  # noqa
    return f64(out), [f64(g) for g in grads]


def _case(rng, Lk, kind):
    args = [bf16(rng.standard_normal((B, Lq, D))),
            bf16(rng.standard_normal((B, Lk, D)))]
    for _ in range(3):
        args += [bf16(rng.standard_normal((D, D)) / np.sqrt(D)),
                 bf16(rng.standard_normal(D) * 0.1)]
    mask = rng.random((B, Lk)) < 0.8
    mask[:, 0] = True
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :] \
        + np.zeros((B, 1, Lq, 1))
    if kind != "key":
        bias = bias + rng.standard_normal(
            (B, 1 if kind == "full" else H, Lq, Lk))
    args.append(bf16(bias))
    return args, bf16(rng.standard_normal((B, Lq, D)))


def test_model_reads_the_kernels_tiles():
    assert TILE == 64 and DH == 64
    assert C["TILE_BYTES"] == TILE * DH * 2


@pytest.mark.parametrize("Lk,kind", [(24, "key"), (60, "full"),
                                     (200, "heads"), (300, "full"),
                                     (520, "key")])
def test_model_matches_pallas_bf16(rng, Lk, kind):
    args, dout = _case(rng, Lk, kind)
    ref_out, ref = _jax(args, dout, jnp.float32)
    j16_out, j16 = _jax(args, dout, jnp.bfloat16)
    out, grads = model(args, dout)

    def gate(name, got, j, r, scale):
        err = np.abs(got - r).max() / scale
        err_j = np.abs(j - r).max() / scale
        assert err <= 2 * err_j + ATOL, (name, err, err_j)

    gate("out", out, j16_out, ref_out, np.abs(ref_out).max())
    for i, (name, g) in enumerate(zip(NAMES, grads)):
        assert g.shape == ref[i].shape, name
        gate(name, g, j16[i], ref[i],
             np.abs(ref[4 if name == "bk" else i]).max())


@pytest.mark.parametrize("Lk", [60, 200, 520])
def test_model_dq_rounds_once(rng, Lk):
    """The backward core's dq is one rounding of its float32 sum over every
    key tile: within one bf16 ulp plus 2^-16 of the absolute sum of the float64
    product of its own bf16 ds and k (a dq added up in bf16 tile by tile
    rounds once per tile and lands beyond that)."""
    args, dout = _case(rng, Lk, "full")
    x, y, wq, bq, wk, bk, wv, bv, bias = args
    q, k, v = (heads(project(s, w, b_)) for s, w, b_ in
               ((x, wq, bq), (y, wk, bk), (y, wv, bv)))
    scale = 1.0 / np.sqrt(DH)
    dq, _, _, ds = backward_model(q, k, v, heads(dout), bias, scale)
    d = bf16(ds).astype(np.float64)
    ref = np.einsum("bhqk,bkhd->bqhd", d, k) * scale
    mag = np.einsum("bhqk,bkhd->bqhd", np.abs(d), np.abs(k)) * scale
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                  - 7)
    assert (np.abs(dq - ref) <= ulp + 2.0 ** -16 * mag).all()
