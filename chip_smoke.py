"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing a flushed line as it ends:
  1. device: the card's `name, power.limit` (as nvidia-smi prints them),
     torch and CUDA versions;
  2. build: every CUDA kernel of the port compiled with nvcc, with seconds
     and the ptxas register/spill report;
  3. kernel check: each kernel against its plain PyTorch version on the
     card at the shapes the R2R rollout gives it, with its time, the plain
     version's, one PyTorch library call's, and the least time the card
     could take (float32 matmuls without TF32);
  4. full run: the full-width R2R greedy-decode rollout through the
     kernels (launch counts reset just before, read just after), then the
     same batch with every attention on the eager PyTorch path; actions
     must be identical and the logits' masks as the model defines them.
The line before the last is one JSON object with every kernel's numbers;
the last is {"ok": true, "device": {...}}.  Any failure raises: there is
no CPU fallback, and without a card the script exits non-zero before
printing a result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from vln_goat_tpu_torch.entry import build_flagship, greedy_rollout
from vln_goat_tpu_torch.ops import _build
from vln_goat_tpu_torch.ops.attention import (fused_qkv_mha,
                                              fused_qkv_mha_plain)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and dense
# float32 outside the tensor cores, the type these kernels compute in
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
ATOL, RTOL = 1e-4, 1e-3   # float32, sums taken in another order than cuBLAS

D, H, DH, B = 768, 12, 64, 8
# Seed of the random weights.  With seed 0 (build_flagship's default)
# every episode of the first batch stops at its first step, which leaves
# the per-step path (moves, path expansion, arrivals) idle; with seed 4
# every episode of the batch moves for the whole 15-step horizon.
WEIGHT_SEED = 4
# (name, Lq, Lk, bias kind, weight layout) at the rollout's shapes:
# text self-attention over a 60-token instruction (200 is R2R's cap),
# global-map self-attention (48 nodes + stop + MEM) with the key mask plus
# the graph-distance bias, local self-attention (16 candidates + 36 views
# + stop + MEM) with a key mask; the per-head bias case takes the weights
# as contiguous [D, H*dh] matrices instead of transposed Linear weights
SHAPES = (("text60", 60, 60, "key", "linear"),
          ("text200", 200, 200, "key", "linear"),
          ("gmap50", 50, 50, "full", "linear"),
          ("local54", 54, 54, "key", "linear"),
          ("gmap50_per_head_bias", 50, 50, "heads", "dense"))


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_case(g, Lq, Lk, bias_kind, layout):
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x, y = randn(B, Lq, D), randn(B, Lk, D)
    ws, bs = [], []
    for _ in range(3):
        w = randn(H * DH, D, scale=1.0 / math.sqrt(D))  # Linear [out, in]
        ws.append(w.t() if layout == "linear" else w.t().contiguous())
        bs.append(randn(H * DH, scale=0.02))
    keep = torch.rand(B, Lk, generator=g, device=dev) < 0.85
    keep[:, 0] = True
    key = (1.0 - keep.float())[:, None, None, :] * -10000.0
    if bias_kind == "key":
        bias = key
    elif bias_kind == "full":
        bias = key + randn(B, 1, Lq, Lk)
    else:
        bias = key + randn(B, H, Lq, Lk)
    args = (x, y, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], bias)
    return args


def bound(args):
    """(ms by operations, ms by bytes): float32 operations over the float32
    peak, and bytes over the memory rate with each input read once and the
    output written once."""
    x, y, wq, _, _, _, _, _, bias = args
    Bx, Lq, Dx = x.shape
    Lk, HD = y.shape[1], wq.shape[1]
    nbytes = 4 * (x.numel() + y.numel() + 3 * (Dx * HD + HD)
                  + bias.numel() + Bx * Lq * HD)
    flops = 2 * Bx * (Lq + 2 * Lk) * Dx * HD + 2 * 2 * Bx * Lq * Lk * HD
    return (flops / PEAK_F32_FLOP_PER_S * 1e3,
            nbytes / PEAK_BYTES_PER_S * 1e3)


def library_call(args):
    """Linear projections + scaled_dot_product_attention: a yardstick
    timed here only; the port never calls it."""
    x, y, wq, bq, wk, bk, wv, bv, bias = args
    Bx, Lq, _ = x.shape
    Lk = y.shape[1]
    q = torch.addmm(bq, x.view(-1, D), wq).view(Bx, Lq, H, DH).transpose(1, 2)
    k = torch.addmm(bk, y.view(-1, D), wk).view(Bx, Lk, H, DH).transpose(1, 2)
    v = torch.addmm(bv, y.view(-1, D), wv).view(Bx, Lk, H, DH).transpose(1, 2)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    return o.transpose(1, 2).reshape(Bx, Lq, H * DH)


def check_kernel():
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, Lq, Lk, bias_kind, layout in SHAPES:
        args = make_case(g, Lq, Lk, bias_kind, layout)
        out = fused_qkv_mha(*args, num_heads=H)
        torch.cuda.synchronize()
        ref = fused_qkv_mha_plain(*args, num_heads=H)
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
        row = dict(
            max_abs_err=float((out - ref).abs().max()),
            library_err=float((library_call(args) - ref).abs().max()),
            ms=cuda_ms(lambda: fused_qkv_mha(*args, num_heads=H)),
            plain_ms=cuda_ms(lambda: fused_qkv_mha_plain(*args,
                                                         num_heads=H)),
            library_ms=cuda_ms(lambda: library_call(args)))
        row["ops_ms"], row["bytes_ms"] = bound(args)
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        row["bound_by"] = "operations" \
            if row["ops_ms"] >= row["bytes_ms"] else "bytes"
        rows[name] = row
        say(f"kernel fused_qkv_mha {name}: B={B} Lq={Lq} Lk={Lk} "
            f"bias={bias_kind} weights={layout} "
            f"max_abs_err={row['max_abs_err']:.3e} ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} "
            f"(library max_abs_err={row['library_err']:.3e}) "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
    return rows


def check_logit_masks(out):
    """MEM slot and visited / empty node slots -inf, stop finite, and every
    real unvisited node finite, at every step an episode was active."""
    logits, active = out["fused_logits"], out["active"]
    if not bool(active.any()):
        raise AssertionError("no episode ever acted")
    lg = logits[active]                                  # [n, G]
    legal = (out["node_vp_t"][active] >= 0) & ~out["visited_t"][active]
    if not bool(torch.isfinite(lg[:, 0]).all()):
        raise AssertionError("stop logit not finite")
    if not bool(torch.isneginf(lg[:, 1]).all()):
        raise AssertionError("MEM slot logit not -inf")
    nodes = lg[:, 2:]
    if not bool(torch.isfinite(nodes[legal]).all()):
        raise AssertionError("a legal node logit is not finite")
    if not bool(torch.isneginf(nodes[~legal]).all()):
        raise AssertionError("a visited or empty node logit is not -inf")


def run_rollouts(card):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, ro, batcher = build_flagship("cuda", seed=WEIGHT_SEED)
    _, batch = batcher.next_batch()
    greedy_rollout(ro, batch)                            # warm-up
    torch.cuda.synchronize()

    fused_qkv_mha.launches = 0
    t0 = time.perf_counter()
    out = greedy_rollout(ro, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fused_qkv_mha.launches
    steps = int(out["steps"])
    mix = launch_mix(model.config, steps)
    expect = sum(mix.values())
    if launches != expect:
        raise AssertionError(f"fused_qkv_mha launched {launches} times, "
                             f"expected {expect} ({steps} steps)")
    check_logit_masks(out)
    moves = int((out["actions"] >= 0).sum())
    say(f"rollout fused: {steps} steps, {moves} moves, "
        f"{int(out['spilled_n'].sum())} spilled nodes, "
        f"fused_qkv_mha launches={launches}, "
        f"{B / dt:.2f} episodes/s ({dt * 1e3:.1f} ms per batch of {B}) "
        f"on {card}")

    p_model, p_ro, _ = build_flagship("cuda", use_fused_attention=False,
                                      seed=WEIGHT_SEED)
    p_model.load_state_dict(model.state_dict())
    greedy_rollout(p_ro, batch)                          # warm-up
    fused_qkv_mha.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = greedy_rollout(p_ro, batch)
    torch.cuda.synchronize()
    p_dt = time.perf_counter() - t0
    if fused_qkv_mha.launches != 0:
        raise AssertionError("the eager run launched the fused kernel")
    if not torch.equal(out["actions"], ref["actions"]):
        raise AssertionError(f"actions differ:\n{out['actions']}\n"
                             f"{ref['actions']}")
    if out["trajectories"] != ref["trajectories"]:
        raise AssertionError("trajectories differ")
    fin = torch.isfinite(ref["fused_logits"])
    if not torch.equal(fin, torch.isfinite(out["fused_logits"])):
        raise AssertionError("finite-logit pattern differs")
    dmax = float((out["fused_logits"][fin] - ref["fused_logits"][fin])
                 .abs().max())
    if dmax > 1e-3:
        raise AssertionError(f"fused logits differ by {dmax}")
    say(f"rollout eager: {int(ref['steps'])} steps, {B / p_dt:.2f} "
        f"episodes/s ({p_dt * 1e3:.1f} ms per batch); actions and "
        f"trajectories identical, fused logits max |diff| {dmax:.3e}")
    return mix, launches


def launch_mix(cfg, steps):
    """Launches of the fused kernel in one rollout, by shape: the text call
    once per language layer, the global-map and local calls once per cross
    layer and step."""
    return {"text60": cfg.num_l_layers, "gmap50": cfg.num_x_layers * steps,
            "local54": cfg.num_x_layers * steps}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    say(card)
    say(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    for name in _build.KERNELS:
        _build.load(name)
    say(f"build: {', '.join(_build.KERNELS)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rec in _build.build_log.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = check_kernel()
    mix, launches = run_rollouts(card)

    # one row per kernel, its times weighted by the rollout's launch mix
    n = sum(mix.values())

    def avg(key):
        return sum(rows[s][key] * w for s, w in mix.items()) / n

    kernels = [dict(
        name="fused_qkv_mha", route="cuda",
        source="vln_goat_tpu_torch/ops/csrc/fused_qkv_mha.cu",
        replaces="vln_goat_tpu/ops/attention.py:169",
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows.values()),
        ms=avg("ms"), plain_ms=avg("plain_ms"), bound_ms=avg("bound_ms"),
        bound_by="operations" if avg("ops_ms") >= avg("bytes_ms")
        else "bytes",
        library_ms=avg("library_ms"))]
    say(f"wall: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
