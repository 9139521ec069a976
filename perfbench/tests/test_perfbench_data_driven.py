"""The harness finds a cell, its traffic mix and a per-layer metric by
name: a copy of the benchmark with a new workload file, a new traffic file
and a new metric file, and their entries in BENCHMARK.json, runs the new
cell and reads the new metric without an edit to any file that was
there."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

DRIVER = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from perfbench import run as R
R.cache_env()
cell = R.load_cell("goat-r2r.finetune-long-text")
res = R.run(cell, 77, 0.2, True, device="cpu", tiny=True)
line = R.result_line(res, True)
print(json.dumps(dict(line=line, traffic=cell["traffic"],
                      metrics=[m["name"] for m in cell["per_layer"]])))
"""


def test_new_cell_and_metric_by_files_alone(tmp_path):
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copytree(ROOT / "perfbench", copy / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}

    bench = json.loads((copy / "BENCHMARK.json").read_text())
    traffic = json.loads(
        (copy / "perfbench/traffic/finetune.json").read_text())
    traffic["instr_len"] = 80
    (copy / "perfbench/traffic/finetune-long-text.json").write_text(
        json.dumps(traffic))
    (copy / "perfbench/workloads/goat-r2r.finetune-long-text.json"
     ).write_text(json.dumps(json.loads(
         (copy / "perfbench/workloads/goat-r2r.finetune.json").read_text())))
    (copy / "perfbench/metrics/updates_in_window.finetune.py").write_text(
        "def read(ctx):\n"
        "    return ctx.window.updates if ctx.job == 'finetune' else None\n")
    bench["workloads"].append(dict(
        name="goat-r2r.finetune-long-text", config="goat-r2r",
        traffic="finetune-long-text", chips=1, why="a test cell"))
    bench["per_layer"].append(dict(
        name="updates_in_window.finetune", unit="updates", better="higher",
        source="host_clock", layer="whole update",
        moves="finetune_episodes_per_s",
        workloads=["goat-r2r.finetune-long-text"]))
    for m in bench["end_to_end"]:
        if "goat-r2r.finetune" in m.get("workloads", []):
            m["workloads"].append("goat-r2r.finetune-long-text")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run(
        [sys.executable, "-c", DRIVER, str(copy), str(ROOT)],
        capture_output=True, text=True, timeout=600, cwd=copy)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["line"]["correct"], got["line"]["checks"]
    assert got["line"]["metrics"]["updates_in_window.finetune"]["value"] >= 1
    assert "updates_in_window.finetune" in got["metrics"]
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, f"{p} was edited"
