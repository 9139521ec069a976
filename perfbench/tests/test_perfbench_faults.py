"""The harness's run with the timed path broken underneath, at the test
widths on the CPU (the look for a card skipped): each fault a training
cell can have (`perfbench.faults`) turns `correct` false.  One chip, so
there is no exchange between chips to leave out."""
import pytest

from perfbench import faults
from perfbench import run as R
from perfbench.tests.conftest import load_cell

CASES = [(cell, f) for cell, job in (("goat-r2r.finetune", "finetune"),
                                     ("goat-r2r.pretrain", "pretrain"),
                                     ("goat-reverie.pretrain", "pretrain"))
         for f in faults.FAULTS[job]]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f.__name__}" for n, f in CASES])
def test_fault_is_not_correct(monkeypatch, tmp_path, name, fault):
    fault(monkeypatch.setattr)
    R.cache_env()
    res = R.run(load_cell(name, tmp_path), 4242, 0.2, False, device="cpu",
                tiny=True)
    line = R.result_line(res, False)
    assert line["correct"] is False, line["checks"]


def last_task(cell):
    """The task whose first update comes last in the cell's seeded mix:
    the last one the checked updates reach."""
    from perfbench.reference.goat.pretrain.train import MetaTaskSampler
    pt = cell["config"]["pretrain"]
    sampler = MetaTaskSampler(pt["tasks"], pt["mix_ratio"],
                              seed=cell["traffic"]["sampler_seed"])
    first = {}
    for s in range(64):
        first.setdefault(sampler.task_at(s), s)
    return max(first, key=first.get)


@pytest.mark.parametrize("name", ("goat-r2r.pretrain",
                                  "goat-reverie.pretrain"))
def test_fault_in_last_task_is_not_correct(monkeypatch, tmp_path, name):
    """Half the batch left out in the one task that the mix draws last:
    the comparison reaches each task's loss through its head."""
    from vln_goat_tpu_torch.pretrain.model import GoatPretrainModel
    cell = load_cell(name, tmp_path)
    task = last_task(cell)
    orig = GoatPretrainModel.forward

    def half(self, batch, t):
        if t != task:
            return orig(self, batch, t)
        B = batch["txt_ids"].shape[0]
        return orig(self, {k: v[:B // 2] if v.dim() and v.shape[0] == B
                           else v for k, v in batch.items()}, t)

    monkeypatch.setattr(GoatPretrainModel, "forward", half)
    R.cache_env()
    res = R.run(cell, 4243, 0.2, False, device="cpu", tiny=True)
    line = R.result_line(res, False)
    assert line["correct"] is False, line["checks"]
