"""A float64 witness for the train step's gradient comparison.

`chip_smoke.py` phase 5 holds one DAgger step through the kernels (batch
8, dropout 0) to the same step on the eager path: every gradient within
1e-3 of its largest magnitude (`worst_grad`), the kernel step's ReLU
decisions within 1e-4 of a kink taken from the eager step
(`pin_relus`).  A ReLU pre-activation
within float32 rounding of 0 may fall on either side of the kink in two
float32 computations, and the side it falls on moves that unit's whole
gradient.  This script runs the step from the same weights, batch and
generator four ways and compares their gradients as the gate does:

- ``kernels``: the fused route through the CUDA kernels;
- ``plain``: the fused route with `fused_qkv_mha_plain` in place of the
  kernels (the same function the kernels are checked against);
- ``eager``: the gate's reference, every attention through the eager
  layers;
- ``float64``: the eager model in float64, as a witness of which side of
  each kink is right.  GoatModel's entry points take their inputs cast up
  and give their outputs cast back to float32, so the rollout and the
  losses around the model run as in the others.

Each step is run twice, so that a step which does not repeat itself bit
for bit shows.  Each route is also run once with the ReLU decisions of
its `ClsPrediction` heads (the model's only kinks) pinned to the eager
step's (`record_relus` / `pin_relus`, as phase 5 gates on them): the
largest |z - z_eager| over the ReLUs' inputs, the count of units whose
decision differed and the largest |z - z_eager| among them, and the
gradients against eager's.  On the card, from the repo root:

    python -m vln_goat_tpu_torch.tools.gate_witness [--causal]

`--device cpu --tiny` runs the plain, eager and float64 steps on the
CPU at the test configuration (there is no kernel there)."""
from __future__ import annotations

import argparse
import math

import torch

from ..entry import build_train_flagship
from ..models import layers
from ..models.layers import ClsPrediction
from ..ops.attention import fused_qkv_mha, fused_qkv_mha_plain

# parameters whose gradient is analytically zero: a key projection's bias
# and the graph bias's bias add one constant to a whole row of attention
# scores; the global head's LayerNorm bias and last bias add one constant
# (times the row's fuse weight) to every finite fused logit
NOISE_GRAD_BIASES = (".key.bias", "sprel_linear.bias",
                     "global_sap_head.net.2.bias",
                     "global_sap_head.net.3.bias")
ENTRY_POINTS = ("forward_text", "forward_text_kv", "forward_panorama",
                "forward_navigation")


def worst_grad(got, ref):
    """(largest |got - ref| over each gradient's scale, its name): the
    scale is the gradient's largest magnitude, for NOISE_GRAD_BIASES their
    weight's."""
    worst = (0.0, "")
    for name, ge in ref.items():
        scale = float(ge.abs().max())
        if name.endswith(NOISE_GRAD_BIASES):
            # zero up to rounding: each adds one constant to a whole row
            # of scores or to every finite fused logit, which softmax
            # ignores; held at the scale of its weight's gradient, as
            # phase 3 holds the key bias
            scale = max(scale, float(ref[name[:-4] + "weight"]
                                     .abs().max()))
        err = float((got[name] - ge).abs().max())
        ratio = err / scale if scale else (math.inf if err else 0.0)
        worst = max(worst, (ratio, name))
    return worst


def _relus(model):
    """{head name: its ReLU} over the `ClsPrediction` heads of model (the
    only ReLUs of GoatModel; its FFNs take erf-GELU)."""
    return {name: m.net[1] for name, m in model.named_modules()
            if isinstance(m, ClsPrediction)}


def record_relus(model):
    """Hooks every `ClsPrediction` ReLU of model to keep its input z, call
    by call.  Returns ({head: [z, ...]}, hook handles); the step runs as
    without the hooks."""
    seen, handles = {}, []
    for name, relu in _relus(model).items():
        calls = seen.setdefault(name, [])
        handles.append(relu.register_forward_hook(
            lambda mod, inp, out, calls=calls:
                calls.append(inp[0].detach().clone())))
    return seen, handles


def pin_relus(model, seen):
    """Hooks every `ClsPrediction` ReLU of model to keep, at its n-th call,
    the units the n-th call of `seen` (record_relus of another step of the
    same calls) kept: out = z * (z_seen > 0), its gradient gated as the
    ReLU of that step gates it.  Returns (stats, hook handles): stats
    counts the calls and the units whose own decision differs ("flips"),
    and keeps the largest |z - z_seen| among those ("dist") and over every
    unit ("dev"); a call past the recorded ones, or of another shape,
    raises."""
    stats = {"calls": 0, "flips": 0, "dist": 0.0, "dev": 0.0}
    handles = []
    for name, relu in _relus(model).items():
        calls, at = seen[name], [0]

        def hook(mod, inp, out, calls=calls, at=at, name=name):
            z = inp[0]
            if at[0] >= len(calls) or calls[at[0]].shape != z.shape:
                raise AssertionError(f"{name}: call {at[0]} of shape "
                                     f"{tuple(z.shape)} was not recorded")
            ref = calls[at[0]].to(z.dtype)
            at[0] += 1
            keep = ref > 0
            flip = keep != (z > 0)
            stats["calls"] += 1
            diff = (z.detach() - ref).abs()
            stats["dev"] = max(stats["dev"], float(diff.max()))
            n = int(flip.sum())
            if n:
                stats["flips"] += n
                stats["dist"] = max(stats["dist"], float(diff[flip].max()))
            return z * keep.to(z.dtype)
        handles.append(relu.register_forward_hook(hook))
    return stats, handles


def _cast(obj, dtype):
    if torch.is_tensor(obj):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, dict):
        return {k: _cast(v, dtype) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        items = [_cast(v, dtype) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else \
            type(obj)(items)
    return obj


def in_float64(model):
    """Makes `model` compute in float64 behind float32 entry points."""
    model.double()
    for name in ENTRY_POINTS:
        method = getattr(model, name)

        def wrapped(*args, _method=method, **kwargs):
            out = _method(*_cast(args, torch.float64),
                          **_cast(kwargs, torch.float64))
            return _cast(out, torch.float32)
        setattr(model, name, wrapped)


def plain_route(x, y, wq, bq, wk, bk, wv, bv, bias=None,
                num_heads: int = 12, dropout_rate: float = 0.0, seed=None):
    return fused_qkv_mha_plain(x, y, wq, bq, wk, bk, wv, bv, bias,
                               num_heads, dropout_rate, seed)


def compare_routes(device: str = "cuda", causal: bool = False,
                   tiny: bool = False):
    """Runs the batch-8 step (dropout 0) from one set of weights, one batch
    and one generator seed twice on each route (`kernels` only on the
    card), and once more with its ReLU decisions pinned to the eager
    step's, and returns {route: (loss, actions identical to eager's, worst
    gradient of the second run against the first, against eager, against
    float64, (flips, dist, dev, worst) of the pinned run)}, each worst a
    (ratio, name) pair as `worst_grad` gives it, flips, dist and dev as
    `pin_relus` counts them."""
    build = dict(batch_size=8, dropout=False, causal=causal, tiny=tiny)
    k_state, batcher = build_train_flagship(device, **build)
    e_state, _ = build_train_flagship(device, use_fused_attention=False,
                                      **build)
    w_state, _ = build_train_flagship(device, use_fused_attention=False,
                                      **build)
    start = {k: v.clone() for k, v in k_state.model.state_dict().items()}
    w_state.model.load_state_dict(start)
    in_float64(w_state.model)
    _, batch = batcher.next_batch()

    def step(state, hooks=None):
        state.model.load_state_dict(start)
        stats, handles = hooks(state.model) if hooks else (None, [])
        try:
            gen = torch.Generator(device=device).manual_seed(0)
            m, grads, outs = state.step_fn(state, batch, gen, keep=True)
        finally:
            for h in handles:
                h.remove()
        return float(m["loss"]), grads, [outs[r]["actions"]
                                         for r in ("teacher", "sample")], \
            stats

    def pinned(model):
        return pin_relus(model, seen)

    runs = {"eager": [step(e_state, record_relus)]}
    seen = runs["eager"][0][3]
    runs["eager"] += [step(e_state), step(e_state, pinned)]
    if device != "cpu":
        runs["kernels"] = [step(k_state), step(k_state),
                           step(k_state, pinned)]
    layers.fused_qkv_mha = plain_route
    try:
        runs["plain"] = [step(k_state), step(k_state), step(k_state, pinned)]
    finally:
        layers.fused_qkv_mha = fused_qkv_mha
    runs["float64"] = [step(w_state), step(w_state), step(w_state, pinned)]
    ref, wit = runs["eager"][0], runs["float64"][0]
    return {name: (r1[0],
                   all(torch.equal(a, b) for a, b in zip(r1[2], ref[2])),
                   worst_grad(r2[1], r1[1]), worst_grad(r1[1], ref[1]),
                   worst_grad(r1[1], wit[1]),
                   (rp[3]["flips"], rp[3]["dist"], rp[3]["dev"],
                    worst_grad(rp[1], ref[1])))
            for name, (r1, r2, rp) in runs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the test configuration (hidden 32), for the CPU")
    a = ap.parse_args(argv)
    rows = compare_routes(a.device, a.causal, a.tiny)
    print(f"{'causal' if a.causal else 'plain'} configuration, batch 8, "
          f"{a.device}: gradients compared as chip_smoke.py phase 5 "
          "compares them (worst |diff| over the gradient's largest "
          "magnitude; the gate is 1e-3)")
    for name, (loss, same, again, eager, f64, pin) in rows.items():
        print(f"  {name}: loss {loss:.6f}, actions "
              f"{'identical to' if same else 'differ from'} eager's; run "
              f"twice: {again[0]:.2e}; against eager: {eager[0]:.2e} "
              f"{eager[1]}; against float64: {f64[0]:.2e} {f64[1]}; "
              f"ReLUs pinned to eager's: inputs within {pin[2]:.2e} of "
              f"eager's, {pin[0]} decisions differed, each within "
              f"{pin[1]:.2e} of its kink, against eager: {pin[3][0]:.2e} "
              f"{pin[3][1]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
