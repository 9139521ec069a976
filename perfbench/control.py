"""Readings that the limits of a cell's `correct` are set from.

    python3 perfbench/control.py --workload <name> --seeds <n> ... \
        [--control-seeds <n> ...] [--fault <name>]

For every seed, in one process: the program's checked updates
(driven as a run drives them, without the window) against the plain
float32 reference: the numbers a run compares, its lower reading.  For
every control seed also the control: the reference with its float32
products in TF32 (the nearest precision below the configuration's),
put in the program's place and following the program's sampled actions,
against the float32 reference: its upper reading.  One JSON line a seed.
`--fault` plants one of `perfbench/faults.py`'s faults
in the program first, whose readings are then the program's.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import judge  # noqa: E402
from perfbench.faults import BY_NAME  # noqa: E402
from perfbench.jobs import common  # noqa: E402
from perfbench.run import cache_env, load_cell  # noqa: E402


def readings(cell: dict, seed: int, control: bool, device: str = "cuda",
             tiny: bool = False) -> dict:
    """{"program": numbers, "control": numbers or None} of one seed."""
    job = importlib.import_module(
        f"perfbench.jobs.{cell['traffic']['job']}")
    su = job.setup(cell, seed, device, tiny)
    if "close" in su:
        su.pop("close")()
    for k in ("state", "batcher", "next_update"):
        su.pop(k, None)
    common.free()
    cfg, tr, dev = su["cfg"], su["tr"], su["dev"]
    if cell["traffic"]["job"] == "finetune":
        ref = job.reference(su["R"], cfg, tr, seed, su["inp"], dev,
                            su["init"], su["checked"])
        ok, prog = job.judge_numbers(su, ref)
        ctl = None
        if control:
            c = job.reference(su["R"], cfg, tr, seed, su["inp"], dev,
                              su["init"], su["checked"], tf32=True,
                              follow_logits=ref["logits"])
            ctl = judge.training_numbers(c, ref)
            ctl.update({k: c[k] for k in ("first_logit_gap",
                                          "later_logit_gap")})
    else:
        ref = job.reference(su["R"], cfg, tr, su["inp"], dev, su["snaps"],
                            su["checked"])
        ok, prog = job.judge_numbers(su, ref)
        ctl = None
        if control:
            c = job.reference(su["R"], cfg, tr, su["inp"], dev, su["snaps"],
                              su["checked"], tf32=True)
            ctl = judge.pretrain_numbers(c, ref, tr["checked_updates"])
    common.free()
    return dict(seed=seed, leaves_agree=ok, program=prog, control=ctl,
                tasks=[c.get("task") for c in su["checked"]])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", default=None, choices=sorted(BY_NAME))
    args = p.parse_args(argv)
    cache_env()
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    if args.fault:
        BY_NAME[args.fault](setattr)
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds))
    for s in seeds:
        r = readings(cell, s, s in args.control_seeds)
        print(json.dumps(dict(r, fault=args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
