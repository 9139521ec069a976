"""Runs one cell of the benchmark once and prints its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic mix and its per-layer metrics are
found by name: the cell's entry in `BENCHMARK.json` names its
configuration (whose `file` is read) and its traffic mix
(`perfbench/traffic/<traffic>.json`, whose `job` picks the job module in
`perfbench/jobs/`); `perfbench/workloads/<name>.json` holds the cell's
limits; each per-layer metric that lists the cell, or lists no cell, is
read by `perfbench/metrics/<metric>.py`.  A cell, a configuration, a mix
or a metric is added by adding files and entries, without an edit here.

With `--trace 0` the line's metrics are the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics.  The run needs as many CUDA devices as
the cell asks for; without them it exits 3 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vln_goat_tpu")


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    no library loads JAX by itself."""
    cache = ROOT / ".perfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json",
              here: Path = HERE) -> dict:
    """The cell `name`: its BENCHMARK.json entry, configuration, traffic
    mix, workload file and the end-to-end and per-layer metrics it
    reports."""
    bench = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {bench_file.name}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def reports(m):
        return name in m.get("workloads", [name])

    return dict(
        name=name, entry=w, chips=w["chips"],
        config=json.loads((bench_file.parent / conf["file"]).read_text()),
        traffic=json.loads((here / "traffic" /
                            f"{w['traffic']}.json").read_text()),
        workload=json.loads((here / "workloads" /
                             f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)],
        metrics_dir=here / "metrics")


def read_metric(path: Path, ctx) -> object:
    """The value the reader at `path` finds in `ctx`, or None."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run(cell: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", tiny: bool = False,
        t_start: float = T_START) -> dict:
    """One run of `cell`: the job's result with the metrics of the line
    (end-to-end without trace, per-layer with) and the checks."""
    job = importlib.import_module(f"perfbench.jobs.{cell['traffic']['job']}")
    res = job.run(cell, seed=seed, seconds=seconds, trace=trace,
                  device=device, tiny=tiny, t_start=t_start)
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            v = read_metric(cell["metrics_dir"] / f"{m['name']}.py",
                            res["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            v = res["end_to_end"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    res["metrics"] = metrics
    return res


def result_line(res: dict, trace: bool) -> dict:
    checks = res["checks"]
    correct = bool(res["ok"]) and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)
    line = dict(correct=correct, attempted=res["attempted"],
                failed=res["failed"], metrics=res["metrics"],
                device=res["device"])
    if trace and res.get("breakdown"):
        line["breakdown"] = res["breakdown"]
    # a number that could not be read (inf, nan) is written as null
    line["checks"] = {name: {"value": v if math.isfinite(v) else None,
                             "limit": lim} for name, v, lim in checks}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env()
    cell = load_cell(args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    res = run(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 4
    line = result_line(res, bool(args.trace))
    for name, v, lim in res["checks"]:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
