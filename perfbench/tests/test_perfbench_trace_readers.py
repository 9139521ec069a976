"""The per-layer metrics that read the port's own spans and reads
(`vln_goat_tpu_torch.utils.logger.records`): a traced run of each cell at
the test widths on the CPU returns a finite value from every one of them,
and the update spans in the window cover the benchmark's own update
time."""
import math

import pytest

from perfbench import run as R
from perfbench.tests.conftest import load_cell

READERS = {
    "goat-r2r.finetune": [
        "forward_host_ms.finetune", "step_host_ms.finetune",
        "backward_host_ms.finetune", "optimizer_host_ms.finetune",
        "read_wait_ms.finetune", "reads_per_update.finetune"],
    "goat-r2r.pretrain": [
        "forward_host_ms.pretrain", "backward_host_ms.pretrain",
        "optimizer_host_ms.pretrain", "read_wait_ms.pretrain",
        "reads_per_update.pretrain", "feed_build_ms.pretrain"]}


@pytest.mark.parametrize("name", sorted(READERS))
def test_every_span_reader_is_finite(tmp_path, name):
    from vln_goat_tpu_torch.utils.logger import records
    R.cache_env()
    cell = load_cell(name, tmp_path)
    assert set(READERS[name]) <= {m["name"] for m in cell["per_layer"]}
    res = R.run(cell, 2 ** 33 + 5, 0.5, True, device="cpu", tiny=True)
    got = res["metrics"]
    for m in READERS[name]:
        assert m in got and math.isfinite(got[m]["value"]), (m, got)
    job = name.split(".")[1]
    assert got[f"reads_per_update.{job}"]["value"] >= 1
    ctx = res["ctx"]
    n, tail = ctx.window.updates, ctx.traced_updates + \
        ctx.host_traced_updates
    recs = list(records())[-tail - n:-tail]
    for rec, u in zip(recs, ctx.window.per_update):
        assert rec["update"][1] == 1
        assert rec["update"][0] / 1e9 <= u["s"]
