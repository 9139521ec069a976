"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes (chip_smoke.py checks the rollout's and the train
step's shapes).  Needs an NVIDIA card and nvcc; run there with

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda

float32 without TF32; atol 1e-4 / rtol 1e-3 (sums in another order), the
gradients at atol 1e-4 times each gradient's largest magnitude.  A
projection bias's gradient is the column sum of the same rows whose
products make its weight's gradient, so it is held at its weight's scale:
the key bias's gradient is zero up to rounding (softmax ignores a constant
added to a row of scores), which no scale of its own would bound.  The
bf16 builds (the `test_bf16_*` and `test_gemm_bf16_*` cases) are held to
float64 beside the plain bf16 version, as their section says."""
import math

import pytest
import torch

from vln_goat_tpu_torch.ops import attention as attention_mod
from vln_goat_tpu_torch.ops.attention import (attend_plain,
                                              attention_backward,
                                              bf16_core_routes,
                                              forward_projection,
                                              fused_qkv_mha,
                                              fused_qkv_mha_plain,
                                              gemm_bf16, gemm_tf32x3, mha,
                                              mha_plain, project_plain,
                                              projection_backward)
from vln_goat_tpu_torch.ops.bwd_plan import TILE_K_BF16, split_depth
from vln_goat_tpu_torch.ops.dropout import keep_mask

pytestmark = pytest.mark.cuda

D, H = 768, 12


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _assert_grads(got, ref):
    """got/ref: gradients of (x, y, wq, bq, wk, bk, wv, bv[, bias])."""
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape
        scale = float(r.abs().max())
        if i == 5:
            # the key bias's gradient is zero up to rounding (softmax
            # ignores a constant added to a row): held at dWk's scale
            scale = max(scale, float(ref[4].abs().max()))
        torch.testing.assert_close(g, r, atol=1e-4 * scale, rtol=1e-3)


def _case(g, B, Lq, Lk, hb, linear, grad=False):
    dev = "cuda"
    x = torch.randn(B, Lq, D, generator=g, device=dev)
    y = torch.randn(B, Lk, D, generator=g, device=dev)
    ws, bs = [], []
    for _ in range(3):
        w = torch.randn(D, D, generator=g, device=dev) / D ** 0.5
        w = w.requires_grad_(grad)
        ws.append(w.t() if linear else w.t().contiguous().detach()
                  .requires_grad_(grad))
        bs.append((torch.randn(D, generator=g, device=dev) * 0.02)
                  .requires_grad_(grad))
    bias = None if hb is None else \
        torch.randn(B, hb, Lq, Lk, generator=g, device=dev) \
        .requires_grad_(grad)
    x.requires_grad_(grad)
    y.requires_grad_(grad)
    seed = torch.randint(0, 2 ** 31 - 1, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    return (x, y, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], bias), seed


@pytest.mark.parametrize("Lq,Lk,hb,linear", [
    (1, 1, None, True), (40, 40, 1, True), (70, 130, 1, False),
    (64, 256, 12, True), (33, 17, 12, False), (1, 200, 1, True),
    (63, 255, None, False), (65, 200, 12, True), (130, 64, 1, True),
    (40, 257, 1, True), (70, 300, 12, False), (33, 520, None, True)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_qkv_mha_matches_plain(card, Lq, Lk, hb, linear, rate):
    args, seed = _case(card, 3, Lq, Lk, hb, linear)
    before = fused_qkv_mha.launches
    with torch.no_grad():
        out = fused_qkv_mha(*args, num_heads=H, dropout_rate=rate, seed=seed)
    torch.cuda.synchronize()
    assert fused_qkv_mha.launches == before + 1
    ref = fused_qkv_mha_plain(*args, num_heads=H, dropout_rate=rate,
                              seed=seed)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("Lq,Lk,hb,linear", [
    (40, 40, None, True), (50, 50, 1, True), (70, 130, 1, False),
    (33, 200, 12, True), (60, 60, 12, False), (40, 300, 1, True),
    (33, 520, 12, False)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_matches_plain_autograd(card, Lq, Lk, hb, linear, rate):
    args, seed = _case(card, 2, Lq, Lk, hb, linear, grad=True)
    leaves = [a for a in args if a is not None]
    dout = torch.randn(2, Lq, D, generator=card, device="cuda")
    out = fused_qkv_mha(*args, num_heads=H, dropout_rate=rate, seed=seed)
    got = torch.autograd.grad(out, leaves, dout)
    ref = torch.autograd.grad(
        fused_qkv_mha_plain(*args, num_heads=H, dropout_rate=rate,
                            seed=seed), leaves, dout)
    _assert_grads(got, ref)


def test_self_attention_grad_reaches_every_input(card):
    """x == y (self-attention through `lin.weight.t()` weights) and a
    [B,1,Lq,Lk] graph bias: the output has a grad_fn and the backward
    kernels give x, all six weight/bias tensors and the bias a gradient."""
    args, seed = _case(card, 2, 50, 50, 1, True, grad=True)
    x, _, wq, bq, wk, bk, wv, bv, bias = args
    out = fused_qkv_mha(x, x, wq, bq, wk, bk, wv, bv, bias, num_heads=H,
                        dropout_rate=0.1, seed=seed)
    assert out.grad_fn is not None
    n_attn, n_proj = attention_backward.launches, projection_backward.launches
    leaves = (x, wq, bq, wk, bk, wv, bv, bias)
    got = torch.autograd.grad(out.square().sum(), leaves)
    assert attention_backward.launches == n_attn + 1
    assert projection_backward.launches == n_proj + 1
    ref = torch.autograd.grad(
        fused_qkv_mha_plain(x, x, wq, bq, wk, bk, wv, bv, bias, num_heads=H,
                            dropout_rate=0.1, seed=seed).square().sum(),
        leaves)
    assert all(float(g.abs().max()) > 0 for g in got)
    # x stands for both x and y here
    _assert_grads(got[:1] + got[:1] + got[1:], ref[:1] + ref[:1] + ref[1:])


def test_backward_is_bitwise_repeatable(card):
    args, seed = _case(card, 4, 60, 60, 1, True)
    dout = torch.randn(4, 60, D, generator=card, device="cuda")
    runs = []
    for _ in range(2):
        dq, dk, dv, ds = attention_backward(*args, seed, dout, H, 0.1,
                                            need_ds=True)
        x, y, wq, _, wk, _, wv, _, _ = args
        runs.append((dq, dk, dv, ds) + tuple(
            t for part in projection_backward(x, y, wq, wk, wv, dq, dk, dv,
                                              ds, H)
            for t in (part if isinstance(part, list) else [part])))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_dropout_keep_share(card):
    """Share of probabilities the kernel keeps at rate 0.1, from a value
    matrix of ones per key: out = sum of the kept, rescaled probabilities."""
    B, L = 8, 60
    args, seed = _case(card, B, L, L, None, True)
    x, y = args[0], args[1]
    zeros = torch.zeros(D, device="cuda")
    eye = torch.eye(D, device="cuda")
    wv = torch.zeros(D, D, device="cuda")
    wq = torch.zeros(D, D, device="cuda")        # uniform probabilities
    with torch.no_grad():
        out = fused_qkv_mha(x, y, wq, zeros, eye, zeros, wv, zeros + 1.0,
                            None, num_heads=H, dropout_rate=0.1, seed=seed)
    kept = out[..., ::64] * 0.9                  # share kept per row/head
    share = float(kept.mean())
    n = B * H * L * L
    assert abs(share - 0.9) < 4 * math.sqrt(0.9 * 0.1 / n)


def test_forward_is_bitwise_repeatable(card):
    """Two launches of each forward on the same inputs give the same bits
    (no atomics, a fixed order of sums), with dropout for the fused one."""
    args, seed = _case(card, 4, 65, 200, 1, True)
    with torch.no_grad():
        runs = [fused_qkv_mha(*args, num_heads=H, dropout_rate=0.1,
                              seed=seed) for _ in range(2)]
    assert torch.equal(*runs)
    q, k, v, bias = _mha_case(card, 3, 70, 130, "full")
    assert torch.equal(mha(q, k, v, bias), mha(q, k, v, bias))


def test_forward_parts_compose(card):
    """The forward's projection launched alone and `mha` over its q, k
    and v (as the smoke test times the forward's two parts) give what one
    forward call without dropout gives, bit for bit (the same attention
    core), and the projection holds q, k and v within the GEMM core's
    bound against a float64 product (test_gemm_core_matches_float64's:
    1e-5 of the largest sum of absolute products)."""
    args, _ = _case(card, 3, 50, 60, 1, True)
    x, y, wq, bq, wk, bk, wv, bv, bias = args
    whole = attention_mod.forward_kernel(*args, num_heads=H)
    q, k, v = attention_mod.forward_projection(*args[:8], num_heads=H)
    assert torch.equal(whole, mha(q, k, v, bias))
    for t, src, w, b in zip((q, k, v), (x, y, y), (wq, wk, wv),
                            (bq, bk, bv)):
        src = src.reshape(-1, D).double()
        ref = src @ w.double() + b.double()
        scale = float((src.abs() @ w.double().abs()).max())
        assert float((t.reshape(-1, D).double() - ref).abs().max()) \
            <= 1e-5 * scale


@pytest.mark.parametrize("Lq,Lk", [(60, 60), (65, 40), (1, 64)])
def test_forward_drops_what_the_plain_version_drops(card, Lq, Lk):
    """With one-hot values (v[k] = e_k in every head) the forward's output
    is the dropped probability matrix itself: its zeros lie exactly where
    the plain version's keep mask drops, and the kept entries match."""
    B = 3
    g = card
    x = torch.randn(B, Lq, D, generator=g, device="cuda")
    y = torch.zeros(B, Lk, D, device="cuda")
    y[:, torch.arange(Lk), torch.arange(Lk)] = 1.0
    wq = torch.randn(D, D, generator=g, device="cuda") / D ** 0.5
    wk = torch.randn(D, D, generator=g, device="cuda")
    wv = torch.zeros(D, D, device="cuda")
    for h in range(H):
        wv[torch.arange(Lk), h * 64 + torch.arange(Lk)] = 1.0
    zeros = torch.zeros(D, device="cuda")
    seed = torch.randint(0, 2 ** 31 - 1, (B,), generator=g, device="cuda",
                         dtype=torch.int32)
    args = (x, y, wq, zeros, wk, zeros, wv, zeros)
    with torch.no_grad():
        out = fused_qkv_mha(*args, num_heads=H, dropout_rate=0.1, seed=seed)
    ref = fused_qkv_mha_plain(*args, num_heads=H, dropout_rate=0.1,
                              seed=seed)
    pd = out.view(B, Lq, H, 64)[..., :Lk].transpose(1, 2)
    pd_ref = ref.view(B, Lq, H, 64)[..., :Lk].transpose(1, 2)
    keep = keep_mask(seed, (B, H, Lq, Lk), 0.1)
    assert torch.equal(pd == 0, ~keep)
    assert torch.equal(pd_ref == 0, ~keep)
    torch.testing.assert_close(pd, pd_ref, atol=1e-4, rtol=1e-3)


def test_fused_qkv_mha_takes_long_keys(card):
    """Both builds take any key length (the float32 attention forward past
    256 keys in key blocks); any head width and any D (768 / 16 = 48 and
    D = 784 zero-padded to the widths the kernels take, 768 / 4 = 192 on
    the wide-head core as it is, each launching the kernels, with no
    fallback to the plain version)."""
    x = torch.zeros(1, 4, 768, device="cuda")
    y = torch.zeros(1, 257, 768, device="cuda")
    w, b = torch.zeros(768, 768, device="cuda"), torch.zeros(768, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        a = [t.to(dt) for t in (x, y, w, b)]
        before = fused_qkv_mha.launches
        out = fused_qkv_mha(a[0], a[1], a[2], a[3], a[2], a[3], a[2], a[3],
                            num_heads=12)
        torch.cuda.synchronize()
        assert fused_qkv_mha.launches == before + 1
        assert out.dtype == dt and bool((out == 0).all())
    before = fused_qkv_mha.launches
    out = fused_qkv_mha(x, y, w, b, w, b, w, b, num_heads=4)
    torch.cuda.synchronize()
    assert fused_qkv_mha.launches == before + 1
    assert out.shape == (1, 4, 768) and bool((out == 0).all())
    x2, y2 = torch.zeros(1, 4, 784, device="cuda"), \
        torch.zeros(1, 40, 784, device="cuda")
    w2, b2 = torch.zeros(784, 768, device="cuda"), b
    for args, heads in (((x, y, w, b), 16), ((x2, y2, w2, b2), 12)):
        before = fused_qkv_mha.launches
        xx, yy, ww, bb = args
        out = fused_qkv_mha(xx, yy, ww, bb, ww, bb, ww, bb, num_heads=heads)
        torch.cuda.synchronize()
        assert fused_qkv_mha.launches == before + 1
        assert out.shape == (1, 4, 768) and bool((out == 0).all())


# the causal configuration's attention shapes: text cross-attention to the
# direction (36), landmark (47) and front-door (24) banks, map and local
# front-door cross-attention (24 rows), all without a bias; the map's
# front-door self-attention under its key mask alone
CAUSAL_SHAPES = [(60, 36, False), (60, 47, False), (60, 24, False),
                 (50, 24, False), (54, 24, False), (50, 50, True)]


@pytest.mark.parametrize("Lq,Lk,masked", CAUSAL_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_causal_shapes_match_plain(card, Lq, Lk, masked, rate):
    """Forward, and both backward kernels through autograd, against the
    plain version at Lq != Lk < 32 keys and with no bias."""
    args, seed = _case(card, 8, Lq, Lk, None, True, grad=True)
    if masked:
        keep = torch.rand(8, Lk, generator=card, device="cuda") < 0.85
        keep[:, 0] = True
        args = args[:8] + ((1.0 - keep.float())[:, None, None, :]
                           * -10000.0,)
    leaves = [a for a in args if a is not None and a.requires_grad]
    out = fused_qkv_mha(*args, num_heads=H, dropout_rate=rate, seed=seed)
    ref = fused_qkv_mha_plain(*args, num_heads=H, dropout_rate=rate,
                              seed=seed)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-3)
    dout = torch.randn(8, Lq, D, generator=card, device="cuda")
    _assert_grads(torch.autograd.grad(out, leaves, dout),
                  torch.autograd.grad(ref, leaves, dout))


def _mha_case(g, B, Lq, Lk, bias_kind):
    q, k, v = (torch.randn(B, L, H, 64, generator=g, device="cuda")
               for L in (Lq, Lk, Lk))
    if bias_kind is None:
        return q, k, v, None
    if bias_kind == "key":
        keep = torch.rand(B, Lk, generator=g, device="cuda") < 0.8
        keep[:, 0] = True
        return q, k, v, (1.0 - keep.float())[:, None, None, :] * -10000.0
    return q, k, v, torch.randn(B, H, Lq, Lk, generator=g, device="cuda")


@pytest.mark.parametrize("Lq,Lk,bias_kind", [
    (16, 16, None), (24, 40, "key"), (12, 12, "full"), (50, 60, "key"),
    (130, 256, "full"), (1, 200, "key"), (65, 63, None), (63, 255, "key"),
    (63, 300, "key"), (40, 520, "full")])
def test_mha_matches_plain(card, Lq, Lk, bias_kind):
    args = _mha_case(card, 3, Lq, Lk, bias_kind)
    before = mha.launches
    out = mha(*args)
    torch.cuda.synchronize()
    assert mha.launches == before + 1
    torch.testing.assert_close(out, mha_plain(*args), atol=1e-4, rtol=1e-3)
    # and against the same function in float64, which shares no rounding
    # with either float32 version
    ref64 = mha_plain(*(None if a is None else a.double() for a in args))
    torch.testing.assert_close(out.double(), ref64, atol=1e-5, rtol=1e-4)


def test_mha_reads_strided_views(card):
    """Heads sliced out of a packed [B, L, 3, H, dh] tensor, as views."""
    qkv = torch.randn(2, 40, 3, H, 64, generator=card, device="cuda")
    q, k, v = qkv.unbind(2)
    torch.testing.assert_close(mha(q, k, v), mha_plain(q, k, v),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("Lk", [40, 200])
def test_mha_reads_transposed_views(card, Lk):
    """q, k, v as views whose column stride is not 1 ([B, H, dh, L]
    permuted) and at an odd offset: the kernel takes them through 4-byte
    copies."""
    def view(L):
        t = torch.randn(2, H, 64, L + 1, generator=card, device="cuda")
        return t[..., 1:].permute(0, 3, 1, 2)
    q, k, v = view(70), view(Lk), view(Lk)
    assert q.stride(3) != 1
    bias = torch.randn(2, 1, 70, Lk, generator=card, device="cuda")
    torch.testing.assert_close(mha(q, k, v, bias), mha_plain(q, k, v, bias),
                               atol=1e-4, rtol=1e-3)


def test_mha_refuses_what_it_does_not_take(card):
    """Any head width (48 zero-padded to 64, 192 on the wide-head core,
    160 zero-padded to 192); float16 and mixed dtypes are refused; both
    builds take any Lk."""
    q = torch.zeros(1, 4, H, 48, device="cuda")
    assert mha(q, q, q).shape == (1, 4, H * 48)
    for dh in (192, 160):
        q = torch.randn(1, 4, H, dh, device="cuda")
        torch.testing.assert_close(mha(q, q, q), mha_plain(q, q, q),
                                   atol=1e-4, rtol=1e-3)
    q = torch.zeros(1, 4, H, 64, device="cuda")
    k = torch.zeros(1, 257, H, 64, device="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mha(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="like q"):
        mha(q.to(torch.bfloat16), k, k)
    for dt in (torch.float32, torch.bfloat16):
        out = mha(q.to(dt), k.to(dt), k.to(dt))
        torch.cuda.synchronize()
        assert out.dtype == dt and bool((out == 0).all())


def _operand(g, rows, cols, how):
    """A [rows, cols] float32 operand: contiguous, a transposed view, or a
    column slice of a wider matrix (row stride above its width, an odd
    offset, so 4-byte copies)."""
    if how == "t":
        return torch.randn(cols, rows, generator=g, device="cuda").t()
    if how == "slice":
        return torch.randn(rows, cols + 7, generator=g,
                           device="cuda")[:, 3:3 + cols]
    return torch.randn(rows, cols, generator=g, device="cuda")


@pytest.mark.parametrize("M,N,K,a_how,b_how,splits", [
    (1, 1, 1, "c", "c", 1), (130, 70, 45, "c", "c", 1),
    (257, 131, 99, "t", "c", 1), (100, 64, 200, "c", "t", 3),
    (77, 50, 33, "slice", "slice", 2), (768, 768, 3840, "t", "c", 2),
    (200, 768, 3840, "t", "t", 5)])
def test_gemm_core_matches_float64(card, M, N, K, a_how, b_how, splits):
    """The 3xTF32 GEMM core against a float64 matmul: each slice, the sum
    of the slices, the bias in the epilogue and the column sums of B, at
    ragged M, N and K, with strided and transposed operands, and split-K
    over 3840 rows as the weight gradients take it; float32 accuracy
    (the bound of a float32 sum over K terms, 1e-5 relative)."""
    a, b = _operand(card, M, K, a_how), _operand(card, K, N, b_how)
    bias = torch.randn(N, generator=card, device="cuda")
    before = gemm_tf32x3.launches
    c, colsum = gemm_tf32x3(a, b, bias, splits)
    torch.cuda.synchronize()
    assert gemm_tf32x3.launches == before + 1
    S, kc = split_depth(K, splits)
    assert c.shape == (S, M, N) and colsum.shape == (S, N)
    a64, b64 = a.double(), b.double()
    scale = float((a64.abs() @ b64.abs()).max())
    for s in range(S):
        ref = a64[:, s * kc:(s + 1) * kc] @ b64[s * kc:(s + 1) * kc] \
            + bias.double()
        assert float((c[s].double() - ref).abs().max()) <= 1e-5 * scale
        torch.testing.assert_close(
            colsum[s].double(), b64[s * kc:(s + 1) * kc].sum(0),
            atol=1e-5 * float(b64.abs().sum(0).max()), rtol=0)
    total = (c.double() - bias.double()).sum(0)
    assert float((total - a64 @ b64).abs().max()) <= 1e-5 * scale
    again = gemm_tf32x3(a, b, bias, splits)
    assert torch.equal(c, again[0]) and torch.equal(colsum, again[1])


@pytest.mark.parametrize("need_x", [True, False])
def test_backward_skips_unasked_input_grads(card, monkeypatch, need_x):
    """A key/value side that needs no gradient (a causal bank) gets no dy
    job: FusedQKVMHA's backward asks projection_backward for none, which
    returns None for it; likewise x.  Every other gradient still matches
    the plain autograd."""
    args, seed = _case(card, 4, 60, 24, None, True, grad=True)
    args = (args[0].detach().requires_grad_(need_x), args[1].detach()) \
        + args[2:]
    asked = []

    def spy(*a, **kw):
        out = projection_backward(*a, **kw)
        asked.append((kw["need_dx"], kw["need_dy"], out[0], out[1]))
        return out

    spy.launches = 0    # the wrapper counts through its module-level name
    monkeypatch.setattr(attention_mod, "projection_backward", spy)
    names = [n for n, a in zip(("x", "y", "wq", "bq", "wk", "bk", "wv",
                                "bv"), args) if a.requires_grad]
    leaves = [a for a in args if a is not None and a.requires_grad]
    dout = torch.randn(4, 60, D, generator=card, device="cuda")
    out = fused_qkv_mha(*args, num_heads=H, dropout_rate=0.1, seed=seed)
    got = torch.autograd.grad(out, leaves, dout)
    ((nx, ny, dx, dy),) = asked
    assert (nx, ny) == (need_x, False)
    assert dy is None and (dx is not None) == need_x
    ref = torch.autograd.grad(
        fused_qkv_mha_plain(*args, num_heads=H, dropout_rate=0.1,
                            seed=seed), leaves, dout)
    for n, g_, r in zip(names, got, ref):
        scale = float(r.abs().max())
        if n == "bk":   # zero up to rounding: held at dWk's scale
            scale = max(scale, float(ref[names.index("wk")].abs().max()))
        torch.testing.assert_close(g_, r, atol=1e-4 * scale, rtol=1e-3)


# ---------------------------------------------------------------------------
# bf16: the kernels against a float64 evaluation of the same bf16 inputs,
# beside the plain version's bf16 arithmetic (both round where the JAX
# package's bf16 kernel casts).  Gate, for the output and every gradient
# scaled by its largest magnitude: the kernel's error is at most twice the
# plain bf16 version's plus 1e-3.  The plain version rounds fewer
# intermediates (its autograd keeps ds unrounded), so it sets the scale of
# bf16 rounding; 1e-3 absorbs the chance of a small plain error.


def _bf16_case(g, B, Lq, Lk, hb, linear, grad=False):
    args, seed = _case(g, B, Lq, Lk, hb, linear)
    out = []
    for a in args:
        if a is None:
            out.append(None)
            continue
        t = a.detach().to(torch.bfloat16)
        if a.dim() == 2 and linear:      # keep the lin.weight.t() layout
            t = a.detach().t().contiguous().to(torch.bfloat16).t()
        out.append(t.requires_grad_(grad))
    return tuple(out), seed


def _rel(got, ref):
    return float((got.double() - ref).abs().max()) \
        / max(float(ref.abs().max()), 1e-30)


def _assert_bf16_gate(got, plain, ref, scale_ref=None):
    """got, plain: kernel and plain bf16 results; ref: float64."""
    scale = float(ref.abs().max() if scale_ref is None
                  else max(ref.abs().max(), scale_ref.abs().max()))
    err = float((got.double() - ref).abs().max()) / scale
    err_plain = float((plain.double() - ref).abs().max()) / scale
    assert err <= 2 * err_plain + 1e-3, (err, err_plain)


def _operand_bf16(g, rows, cols, how):
    """_operand's three layouts in bf16 (the slice at an offset of 3
    elements, so element loads)."""
    if how == "t":
        return torch.randn(cols, rows, generator=g, device="cuda").to(
            torch.bfloat16).t()
    if how == "slice":
        return torch.randn(rows, cols + 7, generator=g, device="cuda").to(
            torch.bfloat16)[:, 3:3 + cols]
    return torch.randn(rows, cols, generator=g, device="cuda").to(
        torch.bfloat16)


def _tma_describes(sr, sk, t):
    """Whether the bf16 core's TMA route takes an operand with element
    strides (sr, sk) (r its row of A or column of B, k the depth): one
    unit stride, the other a multiple of 8 elements (16 bytes), a 16-byte
    aligned base."""
    other = sr if sk == 1 else (sk if sr == 1 else 0)
    return t.data_ptr() % 16 == 0 and other > 0 and other % 8 == 0


@pytest.mark.parametrize("M,N,K,a_how,b_how,splits", [
    (1, 1, 1, "c", "c", 1), (130, 70, 45, "c", "c", 1),
    (257, 131, 99, "t", "c", 1), (100, 64, 200, "c", "t", 3),
    (77, 50, 33, "slice", "slice", 2), (768, 768, 3840, "t", "c", 2),
    (200, 768, 3840, "t", "t", 5),
    # the TMA route in its four layouts, across tile, chunk and split
    # edges: A K-major / B MN-major, ragged M and N, a last chunk of 8,
    # slices of 128 then 8; both MN-major; A MN-major / B K-major
    (300, 200, 640, "c", "c", 2), (129, 257, 136, "c", "t", 2),
    (256, 136, 200, "t", "c", 3), (64, 128, 1000, "t", "t", 4)])
def test_gemm_bf16_core_matches_float64(card, M, N, K, a_how, b_how,
                                        splits):
    """The bf16 GEMM core against a float64 matmul of the same bf16
    values, at the float32 core's cases and at cases of its TMA route:
    bf16 products are exact in float32, so the bound is the float32 sum's
    (1e-5 of the largest sum of absolute products), and the column sums of
    B likewise.  The depth is cut in whole 64-deep chunks, and the launch
    is counted under the route its operands take (TMA where both can be
    described, else direct)."""
    a, b = _operand_bf16(card, M, K, a_how), _operand_bf16(card, K, N, b_how)
    bias = torch.randn(N, generator=card, device="cuda").to(torch.bfloat16)
    before = gemm_bf16.launches
    route = "tma" if (_tma_describes(a.stride(0), a.stride(1), a) and
                      _tma_describes(b.stride(1), b.stride(0), b)) \
        else "direct"
    routes = dict(bf16_core_routes)
    c, colsum = gemm_bf16(a, b, bias, splits)
    torch.cuda.synchronize()
    assert gemm_bf16.launches == before + 1
    assert bf16_core_routes[route] == routes[route] + 1
    assert sum(bf16_core_routes.values()) == sum(routes.values()) + 1
    S, kc = split_depth(K, splits, TILE_K_BF16)
    assert c.shape == (S, M, N) and c.dtype == torch.float32
    a64, b64 = a.double(), b.double()
    scale = float((a64.abs() @ b64.abs()).max())
    for s in range(S):
        ref = a64[:, s * kc:(s + 1) * kc] @ b64[s * kc:(s + 1) * kc] \
            + bias.double()
        assert float((c[s].double() - ref).abs().max()) <= 1e-5 * scale
        torch.testing.assert_close(
            colsum[s].double(), b64[s * kc:(s + 1) * kc].sum(0),
            atol=1e-5 * float(b64.abs().sum(0).max()), rtol=0)
    again = gemm_bf16(a, b, bias, splits)
    assert torch.equal(c, again[0]) and torch.equal(colsum, again[1])


@pytest.mark.parametrize("Lq,Lk,hb,linear", [
    (1, 1, None, True), (40, 40, 1, True), (70, 130, 1, False),
    (33, 17, 12, False), (63, 255, None, True), (60, 24, None, True)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_forward_matches_plain(card, Lq, Lk, hb, linear, rate):
    """K1 in bf16: bf16 output, within the gate of the float64 value."""
    args, seed = _bf16_case(card, 3, Lq, Lk, hb, linear)
    before = fused_qkv_mha.launches
    with torch.no_grad():
        out = fused_qkv_mha(*args, num_heads=H, dropout_rate=rate, seed=seed)
        plain = fused_qkv_mha_plain(*args, num_heads=H, dropout_rate=rate,
                                    seed=seed)
        ref = fused_qkv_mha_plain(
            *(None if a is None else a.double() for a in args), num_heads=H,
            dropout_rate=rate, seed=seed)
    torch.cuda.synchronize()
    assert fused_qkv_mha.launches == before + 1
    assert out.dtype == torch.bfloat16 and plain.dtype == torch.bfloat16
    _assert_bf16_gate(out, plain, ref)


# K2 (a)'s dq past 64 keys (several key chunks), where the kernel sums dq
# in float32 over the chunks and rounds once: its error against float64
# at most this many times the plain bf16 version's: the largest ratio the
# one-chunk shapes (Lk <= 64) show on the card, 1.345 (chip_smoke.py phase
# 3 bf16, decode shapes), and 11.5% more
DQ_LONG_RATIO = 1.5


def _dq_rounding_excess(dq, ds, k, scale):
    """The bf16 kernel's dq against one rounding of its exact sum over all
    keys, the float64 product of the kernel's own ds (rounded to bf16, as
    it enters the product) and the projected k [B, Lk, H, dh], times
    `scale`: the largest |dq - ref| over one bf16 ulp of ref plus 2^-16 of
    the product's absolute sum (the float32 sum's own error).  A dq added
    up in bf16 chunk by chunk rounds several times and lands beyond 1."""
    B, _, Lq, _ = ds.shape
    d, kk = ds.to(torch.bfloat16).double(), k.double()
    ref = torch.einsum("bhqk,bkhd->bqhd", d, kk).reshape(B, Lq, -1) * scale
    mag = torch.einsum("bhqk,bkhd->bqhd", d.abs(), kk.abs()).reshape(
        B, Lq, -1) * scale
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126)))
                     - 7)
    return float(((dq.double() - ref).abs() / (ulp + 2.0 ** -16 * mag)).max())


@pytest.mark.parametrize("Lq,Lk,hb,linear", [
    (40, 40, None, True), (50, 50, 1, True), (70, 130, 1, False),
    (60, 60, 12, False), (60, 47, None, True), (60, 200, 1, True)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_backward_matches_plain(card, Lq, Lk, hb, linear, rate):
    """K2 (a) and (b) in bf16 through autograd: every gradient in its
    input's dtype (bf16), within the gate of the float64 gradient; the key
    bias's gradient (zero up to rounding) at dWk's scale.  K2 (a)'s dq
    against the plain attention's autograd over the plain projections,
    both against float64 (printed), past 64 keys within DQ_LONG_RATIO of
    the plain version's error."""
    args, seed = _bf16_case(card, 2, Lq, Lk, hb, linear, grad=True)
    leaves = [a for a in args if a is not None]
    dout = torch.randn(2, Lq, D, generator=card, device="cuda").to(
        torch.bfloat16)
    n_attn, n_proj = attention_backward.launches, projection_backward.launches
    got = torch.autograd.grad(
        fused_qkv_mha(*args, num_heads=H, dropout_rate=rate, seed=seed),
        leaves, dout)
    assert attention_backward.launches == n_attn + 1
    assert projection_backward.launches == n_proj + 1
    plain = torch.autograd.grad(
        fused_qkv_mha_plain(*args, num_heads=H, dropout_rate=rate,
                            seed=seed), leaves, dout)
    leaves64 = [a.detach().double().requires_grad_() for a in leaves]
    it = iter(leaves64)
    args64 = [None if a is None else next(it) for a in args]
    ref = torch.autograd.grad(
        fused_qkv_mha_plain(*args64, num_heads=H, dropout_rate=rate,
                            seed=seed), leaves64, dout.double())
    for i, (g_, p_, r) in enumerate(zip(got, plain, ref)):
        assert g_.dtype == torch.bfloat16 and g_.shape == r.shape
        _assert_bf16_gate(g_, p_, r, ref[4] if i == 5 else None)

    det = [None if a is None else a.detach() for a in args]
    dq, _, _, ds = attention_backward(*det, seed, dout, H, rate,
                                      need_ds=True)
    excess = _dq_rounding_excess(
        dq, ds, forward_projection(*det[:8], num_heads=H)[1], (D // H) ** -0.5)
    errs = []
    for dt in (torch.bfloat16, torch.float64):
        src = det if dt == torch.bfloat16 else \
            [None if a is None else a.double() for a in det]
        qkv = [t.detach().requires_grad_() for t in project_plain(*src[:8])]
        (g,) = torch.autograd.grad(
            attend_plain(*qkv, src[8], H, rate, seed, dtype=src[0].dtype),
            qkv[:1], dout.to(dt))
        errs.append(g)
    plain_dq, ref_dq = errs
    err, err_plain = _rel(dq, ref_dq), _rel(plain_dq, ref_dq)
    print(f"dq against float64 at Lq {Lq}, Lk {Lk}, rate {rate}: kernel "
          f"{err:.3e}, plain {err_plain:.3e} (ratio {err / err_plain:.3f}); "
          f"from one rounding of its own ds k: {excess:.3f} of the "
          f"allowance")
    assert excess <= 1, excess
    _assert_bf16_gate(dq, plain_dq, ref_dq)
    if Lk > 64:
        assert err <= DQ_LONG_RATIO * err_plain, (err, err_plain)


def test_bf16_backward_is_bitwise_repeatable(card):
    args, seed = _bf16_case(card, 4, 60, 60, 1, True)
    dout = torch.randn(4, 60, D, generator=card, device="cuda").to(
        torch.bfloat16)
    runs = []
    for _ in range(2):
        dq, dk, dv, ds = attention_backward(*args, seed, dout, H, 0.1,
                                            need_ds=True)
        x, y, wq, _, wk, _, wv, _, _ = args
        runs.append((dq, dk, dv, ds) + tuple(
            t for part in projection_backward(x, y, wq, wk, wv, dq, dk, dv,
                                              ds, H)
            for t in (part if isinstance(part, list) else [part])))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_bf16_keep_share(card):
    """The bf16 forward keeps the float32 forward's share at rate 0.1."""
    B, L = 8, 60
    args, seed = _bf16_case(card, B, L, L, None, True)
    x, y = args[0], args[1]
    bf = dict(device="cuda", dtype=torch.bfloat16)
    zeros = torch.zeros(D, **bf)
    eye = torch.eye(D, **bf)
    wv = torch.zeros(D, D, **bf)
    wq = torch.zeros(D, D, **bf)                 # uniform probabilities
    with torch.no_grad():
        out = fused_qkv_mha(x, y, wq, zeros, eye, zeros, wv, zeros + 1.0,
                            None, num_heads=H, dropout_rate=0.1, seed=seed)
    # the kernel rounds e = exp(s - max) = 1 (exact in bf16) before p v
    # and divides by the row sum L after it: one kept key adds the float32
    # value 1 / (L 0.9)
    unit = float((torch.tensor(1.0) / L) * torch.tensor(1.0 / 0.9))
    share = float(out[..., ::64].float().mean()) / (L * unit)
    n = B * H * L * L
    assert abs(share - 0.9) < 4 * math.sqrt(0.9 * 0.1 / n)


def test_kernels_refuse_mixed_dtypes(card):
    """One call's tensors share one dtype: a bf16 x with float32 weights
    raises on the card; nothing falls back to the plain version."""
    args, seed = _case(card, 2, 40, 40, None, True)
    x = args[0].to(torch.bfloat16)
    with pytest.raises(ValueError, match="like x"):
        fused_qkv_mha(x, x, *args[2:], num_heads=H)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_qkv_mha(*(a.half() if a is not None else None for a in args),
                      num_heads=H)


# key lengths on both sides of one 64-key tile and of 256 keys
LONG_KEYS = [64, 65, 256, 257, 300, 520]


@pytest.mark.parametrize("Lk", LONG_KEYS)
def test_bf16_forward_long_keys_match_plain(card, Lk):
    """K1 bf16 (the Hopper attention core) across key tiles: the output
    within the bf16 gate of float64, launched and counted by TMA."""
    args, seed = _bf16_case(card, 2, 40, Lk, 1, True)
    routes = dict(attention_mod.attn_core_routes)
    with torch.no_grad():
        out = fused_qkv_mha(*args, num_heads=H, dropout_rate=0.1, seed=seed)
        plain = fused_qkv_mha_plain(*args, num_heads=H, dropout_rate=0.1,
                                    seed=seed)
        ref = fused_qkv_mha_plain(
            *(None if a is None else a.double() for a in args), num_heads=H,
            dropout_rate=0.1, seed=seed)
    torch.cuda.synchronize()
    assert attention_mod.attn_core_routes["tma"] == routes["tma"] + 1
    _assert_bf16_gate(out, plain, ref)


@pytest.mark.parametrize("Lk", LONG_KEYS)
def test_bf16_backward_long_keys_match_plain(card, Lk):
    """K2 (a) and (b) bf16 across key tiles through autograd: every
    gradient within the bf16 gate of float64; dq within one rounding of
    the float64 sum of the kernel's own ds times k; two launches of K2 (a)
    bitwise equal."""
    args, seed = _bf16_case(card, 2, 40, Lk, 1, False, grad=True)
    leaves = [a for a in args if a is not None]
    dout = torch.randn(2, 40, D, generator=card, device="cuda").to(
        torch.bfloat16)
    kw = dict(num_heads=H, dropout_rate=0.1, seed=seed)
    got = torch.autograd.grad(fused_qkv_mha(*args, **kw), leaves, dout)
    plain = torch.autograd.grad(fused_qkv_mha_plain(*args, **kw), leaves,
                                dout)
    leaves64 = [a.detach().double().requires_grad_() for a in leaves]
    ref = torch.autograd.grad(fused_qkv_mha_plain(*leaves64, **kw), leaves64,
                              dout.double())
    for i, (g_, p_, r) in enumerate(zip(got, plain, ref)):
        assert g_.dtype == torch.bfloat16 and g_.shape == r.shape
        _assert_bf16_gate(g_, p_, r, ref[4] if i == 5 else None)
    det = [None if a is None else a.detach() for a in args]
    first = attention_backward(*det, seed, dout, H, 0.1, need_ds=True)
    again = attention_backward(*det, seed, dout, H, 0.1, need_ds=True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    dq, ds = first[0], first[3]
    assert _dq_rounding_excess(
        dq, ds, forward_projection(*det[:8], num_heads=H)[1],
        (D // H) ** -0.5) <= 1


@pytest.mark.parametrize("Lq,Lk,bias_kind", [
    (16, 16, None), (24, 40, "key"), (12, 12, "full"), (50, 60, "key"),
    (130, 256, "full"), (1, 200, "key"), (65, 63, None), (63, 300, "key"),
    (40, 520, "full")])
def test_mha_bf16_matches_float64(card, Lq, Lk, bias_kind):
    """The bf16 K3 (scores, softmax and p v in float32 on the Hopper core,
    p in two bf16 terms): within the bf16 gate of float64, beside the
    plain version (float32 throughout, the output rounded once)."""
    q, k, v, bias = _mha_case(card, 3, Lq, Lk, bias_kind)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    routes = dict(attention_mod.attn_core_routes)
    out = mha(q, k, v, bias)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert attention_mod.attn_core_routes["tma"] == routes["tma"] + 1
    ref = mha_plain(*(None if a is None else a.double()
                      for a in (q, k, v, bias)))
    _assert_bf16_gate(out, mha_plain(q, k, v, bias), ref)


def _rounding_excess(out, q, k, v, bias):
    """|out - ref| over one output rounding of the float64 function plus
    2^-14 of sum_k p |v| (chip_smoke.py `mha_rounding_excess`), largest."""
    q, k, v = (t.double() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 64 ** -0.5
    if bias is not None:
        s = s + bias.double()
    p = torch.softmax(s, dim=-1)
    ref = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(out.shape)
    mag = torch.einsum("bhqk,bkhd->bqhd", p, v.abs()).reshape(out.shape)
    return float(((out.double() - ref).abs()
                  / (2.0 ** -8 * ref.abs() + 2.0 ** -14 * mag)).max())


@pytest.mark.parametrize("Lq,Lk,bias_kind", [
    (24, 40, "key"), (50, 60, "key"), (40, 520, "full")])
def test_mha_bf16_rounds_once(card, Lq, Lk, bias_kind):
    """The bf16 K3 is one output rounding of float64, as the TPU kernel
    (p in float32); its control with p v on one bf16 rounding of p
    (`mha_fwd_bf16_one_term`) is not."""
    q, k, v, bias = _mha_case(card, 3, Lq, Lk, bias_kind)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    assert _rounding_excess(mha(q, k, v, bias), q, k, v, bias) <= 1
    b4 = bias.expand(3, H, Lq, Lk)
    out = torch.empty(3, Lq, H * 64, device="cuda", dtype=torch.bfloat16)
    rc = attention_mod._mha_lib().mha_fwd_bf16_one_term(
        q.data_ptr(), *q.stride(), k.data_ptr(), *k.stride(), v.data_ptr(),
        *v.stride(), b4.data_ptr(), *b4.stride(), out.data_ptr(), 3, Lq, Lk,
        H, 64, 64 ** -0.5, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    assert _rounding_excess(out, q, k, v, bias) > 1


def test_mha_bf16_reads_transposed_views(card):
    """Views whose head dimension is not the unit stride: TMA cannot
    describe them, and the producer warp loads them directly (counted)."""
    def view(L):
        t = torch.randn(2, H, 64, L + 1, generator=card, device="cuda")
        return t.to(torch.bfloat16)[..., 1:].permute(0, 3, 1, 2)
    q, k, v = view(70), view(130), view(130)
    routes = dict(attention_mod.attn_core_routes)
    out = mha(q, k, v)
    torch.cuda.synchronize()
    assert attention_mod.attn_core_routes["direct"] == routes["direct"] + 1
    ref = mha_plain(q.double(), k.double(), v.double())
    _assert_bf16_gate(out, mha_plain(q, k, v), ref)


def test_bf16_keep_share_long_keys(card):
    """The bf16 forward core keeps the float32 share at rate 0.1 across
    four key tiles."""
    B, Lq, Lk = 4, 64, 200
    bf = dict(device="cuda", dtype=torch.bfloat16)
    x = torch.randn(B, Lq, D, generator=card, device="cuda").to(
        torch.bfloat16)
    y = torch.randn(B, Lk, D, generator=card, device="cuda").to(
        torch.bfloat16)
    zeros, w0 = torch.zeros(D, **bf), torch.zeros(D, D, **bf)
    seed = torch.randint(0, 2 ** 31 - 1, (B,), generator=card,
                         device="cuda", dtype=torch.int32)
    with torch.no_grad():
        out = fused_qkv_mha(x, y, w0, zeros, w0, zeros, w0, zeros + 1.0,
                            None, num_heads=H, dropout_rate=0.1, seed=seed)
    unit = float((torch.tensor(1.0) / Lk) * torch.tensor(1.0 / 0.9))
    share = float(out[..., ::64].float().mean()) / (Lk * unit)
    assert abs(share - 0.9) < 4 * math.sqrt(0.9 * 0.1 / (B * H * Lq * Lk))


# ---------------------------------------------------------------------------
# Head widths 32 and 128 at D = 768 (24 heads of 32, 6 of 128): every
# attention kernel of both builds against its plain version, through the
# gates of the 64-wide cases above, with one and several key tiles

WIDTH_CASES = [(24, 54, 54, 1), (6, 54, 54, None), (24, 70, 130, "h"),
               (6, 33, 200, "h")]


def _hb(hb, heads):
    return heads if hb == "h" else hb


@pytest.mark.parametrize("heads,Lq,Lk,hb", WIDTH_CASES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_head_widths_match_plain(card, heads, Lq, Lk, hb, rate):
    """float32 K1 and K2 (a) + (b) through autograd at head width
    768 / heads."""
    args, seed = _case(card, 2, Lq, Lk, _hb(hb, heads), True, grad=True)
    leaves = [a for a in args if a is not None]
    before = fused_qkv_mha.launches
    out = fused_qkv_mha(*args, num_heads=heads, dropout_rate=rate, seed=seed)
    ref = fused_qkv_mha_plain(*args, num_heads=heads, dropout_rate=rate,
                              seed=seed)
    torch.cuda.synchronize()
    assert fused_qkv_mha.launches == before + 1
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-3)
    dout = torch.randn(2, Lq, D, generator=card, device="cuda")
    _assert_grads(torch.autograd.grad(out, leaves, dout),
                  torch.autograd.grad(ref, leaves, dout))


@pytest.mark.parametrize("heads,Lq,Lk,hb", WIDTH_CASES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_head_widths_match_float64(card, heads, Lq, Lk, hb, rate):
    """bf16 K1 and K2 (a) + (b) at head width 768 / heads, within the bf16
    gate of float64, every attention launch by TMA."""
    args, seed = _bf16_case(card, 2, Lq, Lk, _hb(hb, heads), True,
                            grad=True)
    leaves = [a for a in args if a is not None]
    routes = dict(attention_mod.attn_core_routes)
    out = fused_qkv_mha(*args, num_heads=heads, dropout_rate=rate, seed=seed)
    dout = torch.randn(2, Lq, D, generator=card, device="cuda").to(
        torch.bfloat16)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert attention_mod.attn_core_routes == {
        "tma": routes["tma"] + 2, "direct": routes["direct"]}
    plain_out = fused_qkv_mha_plain(*args, num_heads=heads,
                                    dropout_rate=rate, seed=seed)
    plain = torch.autograd.grad(plain_out, leaves, dout)
    leaves64 = [a.detach().double().requires_grad_() for a in leaves]
    it = iter(leaves64)
    args64 = [None if a is None else next(it) for a in args]
    ref_out = fused_qkv_mha_plain(*args64, num_heads=heads,
                                  dropout_rate=rate, seed=seed)
    ref = torch.autograd.grad(ref_out, leaves64, dout.double())
    _assert_bf16_gate(out, plain_out, ref_out)
    for i, (g_, p_, r) in enumerate(zip(got, plain, ref)):
        assert g_.dtype == torch.bfloat16 and g_.shape == r.shape
        _assert_bf16_gate(g_, p_, r, ref[4] if i == 5 else None)


@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("Lq,Lk", [(54, 60), (63, 300)])
def test_mha_head_widths(card, dh, Lq, Lk):
    """K3 in float32 (against the plain version) and bf16 (within the bf16
    gate of float64) at head width dh, 768 / dh heads, under a key mask."""
    heads = D // dh
    q, k, v = (torch.randn(2, L, heads, dh, generator=card, device="cuda")
               for L in (Lq, Lk, Lk))
    keep = torch.rand(2, Lk, generator=card, device="cuda") < 0.8
    keep[:, 0] = True
    bias = (1.0 - keep.float())[:, None, None, :] * -10000.0
    torch.testing.assert_close(mha(q, k, v, bias), mha_plain(q, k, v, bias),
                               atol=1e-4, rtol=1e-3)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    out = mha(qb, kb, vb, bias)
    ref = mha_plain(*(t.double() for t in (qb, kb, vb, bias)))
    _assert_bf16_gate(out, mha_plain(qb, kb, vb, bias), ref)


# pretraining's attention shapes (chip_smoke.py phase 3 (o)): the text's
# self-attention (80 tokens) under its key mask; MLM's text over the map
# (64 slots, no [MEM]) and over the viewpoint (53: stop + 16 candidates +
# 36 views); the map's self-attention under the key mask and the graph
# bias; the map over the text; the viewpoint's self-attention
PRETRAIN_SHAPES = [(80, 80, "key"), (80, 64, "key"), (80, 53, "key"),
                   (64, 64, "graph"), (64, 80, "key"), (53, 53, "key")]


@pytest.mark.parametrize("Lq,Lk,bias_kind", PRETRAIN_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_pretrain_shapes_match_plain(card, Lq, Lk, bias_kind, rate):
    """Forward, and both backward kernels through autograd, against the
    plain version at pretraining's shapes (batch 4)."""
    args, seed = _case(card, 4, Lq, Lk, None, True, grad=True)
    keep = torch.rand(4, Lk, generator=card, device="cuda") < 0.85
    keep[:, 0] = True
    bias = (1.0 - keep.float())[:, None, None, :] * -10000.0
    if bias_kind == "graph":
        bias = (bias + torch.randn(4, 1, Lq, Lk, generator=card,
                                   device="cuda")).requires_grad_()
    args = args[:8] + (bias,)
    leaves = [a for a in args if a is not None and a.requires_grad]
    out = fused_qkv_mha(*args, num_heads=H, dropout_rate=rate, seed=seed)
    ref = fused_qkv_mha_plain(*args, num_heads=H, dropout_rate=rate,
                              seed=seed)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-3)
    dout = torch.randn(4, Lq, D, generator=card, device="cuda")
    got = torch.autograd.grad(out, leaves, dout)
    want = torch.autograd.grad(ref, leaves, dout)
    _assert_grads(got[:8], want[:8])
    if bias_kind == "graph":
        torch.testing.assert_close(got[8], want[8],
                                   atol=1e-4 * float(want[8].abs().max()),
                                   rtol=1e-3)
