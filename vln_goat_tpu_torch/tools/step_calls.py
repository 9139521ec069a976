"""Counts the PyTorch operator calls of one DAgger train step, by compute
dtype and rematerialisation policy: how much host work each setting adds
to a step whose rollout runs one Python loop of small operations.

    python -m vln_goat_tpu_torch.tools.step_calls [--device cpu --tiny]

On the card it builds the bench's R2R configuration at batch 8 (dropout
on); `--tiny` builds the small test configuration.  For float32 "none",
bf16 "none" and bf16 "model" (each with the vectorized teacher), and bf16
"model" with the per-step teacher, it runs one warm-up step and then one
step under `torch.profiler`, and prints the aten calls of that step, the
rollout steps it ran and the calls per rollout step.  A count, not a
time: the call count is what a launch-bound step's host time follows.
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile

from ..entry import build_train_flagship

SETTINGS = (("float32", "none"), ("bfloat16", "none"), ("bfloat16", "model"))


def step_calls(device: str = "cuda", tiny: bool = False,
               compute_dtype: str = "float32", remat: str = "none",
               vectorized_teacher: bool = True) -> Dict[str, int]:
    """{"aten_calls": ..., "rollout_steps": ...} of one train step."""
    state, batcher = build_train_flagship(
        device, tiny=tiny, batch_size=4 if tiny else 8,
        compute_dtype=compute_dtype, remat=remat,
        vectorized_teacher=vectorized_teacher)
    g = torch.Generator(device=device).manual_seed(0)
    batch = batcher.next_batch()[1]
    state.step_fn(state, batch, g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m = state.step_fn(state, batch, g)
    calls = sum(e.count for e in prof.key_averages()
                if e.key.startswith("aten::"))
    return {"aten_calls": calls,
            "rollout_steps": int(m["teacher_steps"])
            + int(m["sample_steps"])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()
    for dtype, remat, vec in [s + (True,) for s in SETTINGS] \
            + [SETTINGS[-1] + (False,)]:
        r = step_calls(args.device, args.tiny, dtype, remat, vec)
        teacher = "vectorized" if vec else "per-step"
        print(f"{dtype} remat {remat}, {teacher} teacher: "
              f"{r['aten_calls']} aten calls in one train step of "
              f"{r['rollout_steps']} rollout steps "
              f"({r['aten_calls'] / r['rollout_steps']:.0f} a rollout "
              f"step)", flush=True)


if __name__ == "__main__":
    main()
