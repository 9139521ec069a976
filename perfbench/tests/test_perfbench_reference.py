"""The plain reference against the port at the test widths on the CPU,
through the harness's own run: the port's CPU path is its plain version,
so every compared number is exactly 0 (but the program's later
pretraining gradients, which come from its first moment before and after
each update and so round), and the reference judged the sampled rollouts'
free decisions and every pretraining task's update."""
import pytest
import torch

from perfbench import run as R
from perfbench.tests.conftest import load_cell
from perfbench.jobs import finetune, pretrain

CELLS = ("goat-r2r.finetune", "goat-reverie.pretrain", "goat-r2r.pretrain")


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_port(name, tmp_path):
    R.cache_env()
    res = R.run(load_cell(name, tmp_path), 2 ** 31 + 12345, 0.2, False,
                device="cpu", tiny=True)
    line = R.result_line(res, False)
    assert line["correct"], line["checks"]
    rounded = {"grad_gap": 1e-6} if "pretrain" in name else {}
    assert all(v <= rounded.get(k, 0.0) for k, v, _ in res["checks"]), \
        res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(line["metrics"]) >= {"setup_s", "peak_mem_gib"}


def test_reference_judges_decisions(tmp_path):
    R.cache_env()
    cell = load_cell("goat-r2r.finetune", tmp_path)
    su = finetune.setup(cell, 31, "cpu", tiny=True)
    moved = sum(int((c["actions"] >= 0).sum()) for c in su["checked"])
    assert moved > 0
    ref = finetune.reference(su["R"], su["cfg"], su["tr"], 31, su["inp"],
                             su["dev"], su["init"], su["checked"])
    assert len(ref["losses"]) == len(su["checked"])
    assert ref["losses"] == [c["loss"] for c in su["checked"]]
    assert all(torch.isfinite(torch.tensor(ref["losses"])))


@pytest.mark.parametrize("name", ("goat-reverie.pretrain",
                                  "goat-r2r.pretrain"))
def test_checked_updates_cover_every_task(name, tmp_path):
    R.cache_env()
    cell = load_cell(name, tmp_path)
    su = pretrain.setup(cell, 2 ** 31 + 99, "cpu", tiny=True)
    su["close"]()
    tasks = [c["task"] for c in su["checked"]]
    assert set(tasks) == set(cell["config"]["pretrain"]["tasks"])
    assert len(tasks) >= cell["traffic"]["checked_updates"]
    assert len(su["grads"]) == len(tasks)
    assert len(su["snaps"]) == len(tasks) + 1
