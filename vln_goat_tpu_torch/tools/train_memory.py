"""Peak device memory of the bench's train build's warm-up, for any compute
dtype and rematerialisation policy.

    python -m vln_goat_tpu_torch.tools.train_memory [--causal]
        [--compute-dtype bfloat16] [--remat none]

Builds `build_train_flagship` (batch 64, dropout on) on the card, runs one
DAgger step per gt-length bucket (the warm-up of `chip_smoke.py` phase 5,
whose gt-cap-8 step sets the peak) and prints the peak of
`torch.cuda.max_memory_allocated` over it and the warm-up's seconds.
Card only: the CPU has no peak counter.
"""
from __future__ import annotations

import argparse
import gc
import time

import torch

from ..entry import build_train_flagship


def warmup_peak(causal: bool = False, compute_dtype: str = "float32",
                remat: str = "none", batch_size: int = 64):
    """(peak GiB, seconds) of one step per bucket of the train build."""
    gc.collect()
    torch.cuda.empty_cache()
    state, batcher = build_train_flagship(
        "cuda", batch_size=batch_size, causal=causal,
        compute_dtype=compute_dtype, remat=remat)
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for cap in batcher.bucket_caps:
        state.step_fn(state, batcher.make_batch(batcher.next_minibatch(),
                                                gt_cap=cap), g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, batcher
    gc.collect()
    torch.cuda.empty_cache()
    return peak, seconds


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--compute-dtype", default="float32")
    ap.add_argument("--remat", default="none")
    args = ap.parse_args()
    peak, seconds = warmup_peak(args.causal, args.compute_dtype, args.remat)
    print(f"{'causal' if args.causal else 'plain'} {args.compute_dtype} "
          f"remat {args.remat}: warm-up peak {peak:.2f} GiB, "
          f"{seconds:.1f} s for one step per bucket on "
          f"{torch.cuda.get_device_name(0)}", flush=True)


if __name__ == "__main__":
    main()
