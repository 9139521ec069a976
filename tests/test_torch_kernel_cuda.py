"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes (chip_smoke.py checks the rollout's shapes).  Needs
an NVIDIA card and nvcc; run there with

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda

float32 without TF32; atol 1e-4 / rtol 1e-3 (sums in another order)."""
import pytest
import torch

from vln_goat_tpu_torch.ops.attention import (fused_qkv_mha,
                                              fused_qkv_mha_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("Lq,Lk,hb,linear", [
    (1, 1, None, True), (40, 40, 1, True), (70, 130, 1, False),
    (64, 256, 12, True), (33, 17, 12, False)])
def test_fused_qkv_mha_matches_plain(card, Lq, Lk, hb, linear):
    B, D, H = 3, 768, 12
    dev = "cuda"
    x = torch.randn(B, Lq, D, generator=card, device=dev)
    y = torch.randn(B, Lk, D, generator=card, device=dev)
    ws, bs = [], []
    for _ in range(3):
        w = torch.randn(D * 1, D, generator=card, device=dev) / D ** 0.5
        ws.append(w.t() if linear else w.t().contiguous())
        bs.append(torch.randn(D, generator=card, device=dev) * 0.02)
    bias = None if hb is None else \
        torch.randn(B, hb, Lq, Lk, generator=card, device=dev)
    args = (x, y, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], bias)
    before = fused_qkv_mha.launches
    out = fused_qkv_mha(*args, num_heads=H)
    torch.cuda.synchronize()
    assert fused_qkv_mha.launches == before + 1
    ref = fused_qkv_mha_plain(*args, num_heads=H)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-3)


def test_fused_qkv_mha_refuses_long_keys(card):
    x = torch.zeros(1, 4, 768, device="cuda")
    y = torch.zeros(1, 257, 768, device="cuda")
    w, b = torch.zeros(768, 768, device="cuda"), torch.zeros(768, device="cuda")
    with pytest.raises(ValueError, match="Lk <="):
        fused_qkv_mha(x, y, w, b, w, b, w, b, num_heads=12)
