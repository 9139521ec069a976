"""Peaks of the card, the least time of a fused attention launch, and the
launches of an update by shape.

Frozen from `chip_smoke.py`: `least_ms` is its `bound` (:476) with
`tf32x3=True`, taken over shapes instead of tensors; `text_mix`,
`step_mix` (:1958-1982) and `pretrain_plan` (:3898) give the forward
launches of an update by shape; `K_F32_PARTS` (:2713) names the float32
K1 / K2 kernels by part.  Every forward launch (K1) has one K2 (a) and one
K2 (b) launch in its backward.
"""
from __future__ import annotations

from typing import Dict, Tuple

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth and
# TF32 on the tensor cores.  The kernels compute float32 products as three
# TF32 products (3xTF32), so float32 work runs at most at a third of the
# TF32 peak: 165 TFLOP/s, the peak `mfu` is taken against too.
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_F32_WORK_FLOP_PER_S = PEAK_TF32_FLOP_PER_S / 3

# the float32 K1 / K2 kernels by part (a substring of the kernel's name):
# the 3xTF32 GEMM jobs (K1's projections, K2 (a)'s recompute, K2 (b)'s
# products), the attention cores, K2 (b)'s split-K reduction
K_F32_PARTS = (("GEMM jobs", "gemm_jobs_kernel"),
               ("K1 attention", "attn_fwd_kernel"),
               ("K2 (a) attention", "attn_bwd_kernel"),
               ("K2 (b) reduce", "splitk_reduce_kernel<float"))

# (Lq, Lk, bias kind) of a shape: a key mask [B, 1, 1, Lk], a full bias
# [B, 1, Lq, Lk] (with its gradient), or none
Shape = Tuple[int, int, str]


def least_ms(kind: str, B: int, shape: Shape, D: int = 768, H: int = 12,
             dh: int = 64, es: int = 4) -> float:
    """The least time (ms) of one float32 launch of `kind` ("fwd": K1,
    "attn": K2 (a), "proj": K2 (b)) at batch B: the larger of its
    operations as three TF32 products at the TF32 peak and its bytes at the
    memory rate, each input read once and each output written once."""
    Lq, Lk, bias_kind = shape
    HD = H * dh
    x, y = B * Lq * D * es, B * Lk * D * es
    bias = {"key": B * Lk, "full": B * Lq * Lk, "none": 0}[bias_kind] * 4
    weights = 3 * (D * HD + HD) * es
    proj = 2 * B * (Lq + 2 * Lk) * D * HD
    att = 2 * B * Lq * Lk * HD
    out_q, out_k = B * Lq * HD, B * Lk * HD
    ds = B * H * Lq * Lk if bias_kind == "full" else 0
    if kind == "fwd":
        flops = proj + 2 * att
        nbytes = x + y + bias + weights + es * out_q
    elif kind == "attn":
        flops = proj + 5 * att
        nbytes = x + y + bias + weights + es * (2 * out_q + 2 * out_k) \
            + 4 * ds
    else:
        flops = 2 * proj
        nbytes = 2 * (x + y + weights) + es * (out_q + 2 * out_k) \
            + 4 * (ds + ds // H)
    return max(3 * flops / PEAK_TF32_FLOP_PER_S,
               nbytes / PEAK_BYTES_PER_S) * 1e3


def launch_least_ms(mix: Dict[Shape, int], B: int, D: int, H: int,
                    dh: int) -> float:
    """Least time (ms) of the forward launches `mix` and their backward
    launches."""
    return sum(n * sum(least_ms(k, B, s, D, H, dh)
                       for k in ("fwd", "attn", "proj"))
               for s, n in mix.items())


def add(*mixes: Dict[Shape, int]) -> Dict[Shape, int]:
    out: Dict[Shape, int] = {}
    for m in mixes:
        for k, v in m.items():
            out[k] = out.get(k, 0) + v
    return out


def text_mix(m: dict, text_len: int, banks: dict) -> Dict[Shape, int]:
    """Forward launches of one instruction encoding: every language
    layer's self-attention under the key mask, and with the causal text
    flags the cross-attention to each bank (type_2 back door: direction
    and landmark; front door: the text bank)."""
    L = text_len
    mix = {(L, L, "key"): m["num_l_layers"]}
    if m.get("do_back_txt") and m.get("do_back_txt_type") == "type_2":
        mix = add(mix, {(L, banks["instr_direction_rows"], "none"): 1,
                        (L, banks["instr_landmark_rows"], "none"): 1})
    if m.get("do_front_txt"):
        mix = add(mix, {(L, banks["front_clusters"], "none"): 1})
    return mix


def step_mix(m: dict, steps: int, gmap: int, local: int,
             banks: dict) -> Dict[Shape, int]:
    """Forward launches of `steps` rollout steps: the global map's
    self-attention under the graph bias and the local branch's under the
    key mask in every cross layer (the text cross-attention reads the
    hoisted text K/V and stays off the kernel), and with the front-door
    flags each front-door encoder's self-attention under the key mask and
    its cross-attention to its bank."""
    c = banks["front_clusters"]
    mix = {(gmap, gmap, "full"): m["num_x_layers"] * steps,
           (local, local, "key"): m["num_x_layers"] * steps}
    if m.get("do_front_his"):
        mix = add(mix, {(gmap, gmap, "key"): steps,
                        (gmap, c, "none"): steps})
    if m.get("do_front_img"):
        mix = add(mix, {(local, local, "key"): steps,
                        (local, c, "none"): steps})
    return mix


def pretrain_plan(task: str, m: dict, text_len: int, gmap: int, vp: int,
                  vp_obj: int) -> Dict[Shape, int]:
    """Forward launches of one pretraining update of `task`: every
    attention of pretraining has more queries than the gate's 32, so every
    one is a kernel launch."""
    layers, cross = m["num_l_layers"], m["num_x_layers"]
    T, v = text_len, (vp_obj if task == "og" else vp)
    plan = {(T, T, "key"): layers}
    if task == "mlm":
        plan = {(T, T, "key"): layers + 2 * cross, (T, gmap, "key"): cross,
                (T, vp, "key"): cross}
    elif task == "sap":
        plan.update({(gmap, gmap, "full"): cross, (gmap, T, "key"): cross,
                     (vp, vp, "key"): cross, (vp, T, "key"): cross})
    elif task in ("mrc", "og"):
        plan.update({(v, v, "key"): cross, (v, T, "key"): cross})
    elif task == "cfp":
        plan = add(plan, {(gmap, gmap, "key"): 1, (vp, vp, "key"): 1})
    return plan
