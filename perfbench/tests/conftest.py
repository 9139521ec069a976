"""Fixtures of the benchmark's tests: whether a card is there is decided
inside a fixture, never while a module is imported."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's CUDA kernels and "
                    "TF32 exist only there")
    return torch.device("cuda")


# a cell whose configuration the benchmark keeps but does not run (PERF.md,
# Open questions): its tests load it through a BENCHMARK.json of their own,
# with the limits of the cell named by `limits_of` (limits are read on the
# card; these tests read only whether `correct` holds)
KEPT_CELLS = {"goat-reverie.pretrain": dict(
    config="goat-reverie", traffic="pretrain",
    file="perfbench/configs/goat-reverie.json",
    limits_of="goat-r2r.pretrain")}


def load_cell(name, tmp_path):
    """The cell `name` as the harness loads it, from BENCHMARK.json or,
    for a kept cell, from a copy with its entries and workload file
    added."""
    import json
    import shutil

    from perfbench import run as R
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = R.HERE
    if name in KEPT_CELLS:
        k = KEPT_CELLS[name]
        bench["configs"].append(dict(name=k["config"], source="",
                                     file=k["file"], reduced=[], why=""))
        bench["workloads"].append(dict(name=name, config=k["config"],
                                       traffic=k["traffic"], chips=1,
                                       why=""))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if k["limits_of"] in m.get("workloads", []):
                m["workloads"].append(name)
        here = tmp_path / "perfbench"
        for d in ("traffic", "metrics", "workloads"):
            shutil.copytree(R.HERE / d, here / d)
        shutil.copy(here / "workloads" / f"{k['limits_of']}.json",
                    here / "workloads" / f"{name}.json")
    for c in bench["configs"]:
        c["file"] = str(ROOT / c["file"])
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return R.load_cell(name, bench_file=path, here=here)
