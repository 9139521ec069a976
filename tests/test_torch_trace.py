"""The port's spans and reads (`utils.logger`: `span`, `read`, the update
records) on the CPU:

- the tracer alone: paths, counts and self time, the bounded deque, a
  span closed on a second thread landing in the update open at that
  moment, spans closed between updates landing in the next record, the
  list folded in a process that runs no update;
- no `RecordFunction` outside a profiler, and the `goat.*` ranges in a CPU
  `torch.profiler` trace of one tiny fine-tune update and one tiny
  pretraining update of each task;
- one record per update; the sampled rollout's `step` spans as many as the
  update's `sample_steps`; the reads of two identical updates equal and at
  least the steps; losses, gradients and actions bit-equal with the
  profiler on and off;
- the pretrain feed's `feed.build` / `feed.copy` on its prefetch thread;
- both CLIs write the interval's spans under `trace/`.
The card's sync check is test_torch_trace_cuda.py."""
import json
import os
import threading

import torch

from vln_goat_tpu_torch import cli
from vln_goat_tpu_torch.pretrain import cli as pcli
from vln_goat_tpu_torch.pretrain.train import MetaTaskSampler
from vln_goat_tpu_torch.utils import logger as L
from vln_goat_tpu_torch.utils.logger import Tracer, records, summary
import torch_trace_rig as rig
from test_torch_cli import COMMON, tiny
from test_torch_gate_witness import one_thread  # noqa: F401


def self_ns(rec, path):
    """A span's ns less those of the paths one level below it."""
    depth = path.count("/") + 1
    return rec[path][0] - sum(
        ns for p, (ns, _) in rec.items()
        if p.startswith(path + "/") and p.count("/") == depth)


def test_paths_counts_and_self_time():
    tr = Tracer()
    with tr.span("update"):
        with tr.span("sample"):
            for _ in range(3):
                with tr.span("step"):
                    tr.read(torch.tensor(True))
        with tr.span("backward"):
            pass
    (rec,) = tr.records()
    assert {p: n for p, (_, n) in rec.items()} == {
        "update": 1, "update/sample": 1, "update/sample/step": 3,
        "update/sample/step/read": 3, "update/backward": 1}
    for p, (ns, _) in rec.items():
        assert ns >= 0
        assert 0 <= self_ns(rec, p) <= ns
    assert self_ns(rec, "update") == rec["update"][0] - \
        rec["update/sample"][0] - rec["update/backward"][0]
    assert tr.read(torch.tensor(3)) == 3
    assert tr.read(torch.tensor(2.5)) == 2.5


def test_deque_is_bounded_and_one_record_per_update():
    tr = Tracer(maxlen=4)
    for i in range(7):
        with tr.span("update"):
            with tr.span("x"):
                pass
    assert len(tr.records()) == 4
    assert all(r["update"][1] == 1 and r["update/x"][1] == 1
               for r in tr.records())


def test_span_on_another_thread_lands_in_the_open_record():
    tr = Tracer()
    opened, closed = threading.Event(), threading.Event()

    def worker():
        opened.wait(10)
        with tr.span("feed.build"):
            pass
        closed.set()

    th = threading.Thread(target=worker)
    th.start()
    with tr.span("update"):
        opened.set()
        assert closed.wait(10)
    th.join(10)
    assert not th.is_alive()
    assert tr.records()[-1]["feed.build"][1] == 1
    # closed while no update is open: the next record
    with tr.span("read"):
        pass
    with tr.span("update"):
        pass
    assert tr.records()[-1]["read"][1] == 1
    assert "feed.build" not in tr.records()[-1]


def test_fold_keeps_a_bounded_list(monkeypatch):
    monkeypatch.setattr(L, "_FOLD_AT", 8)
    tr = Tracer()
    for _ in range(50):
        with tr.span("step"):
            pass
    assert len(tr._closed) <= 9
    with tr.span("update"):
        pass
    assert tr.records()[-1]["step"][1] == 50


def test_summary_is_per_update():
    recs = [{"update": [2_000_000, 1], "update/sample": [1_000_000, 1],
             "update/sample/read": [500_000, 4], "feed.build": [0, 1]},
            {"update": [4_000_000, 1], "update/sample": [3_000_000, 1],
             "update/sample/read": [500_000, 6]}]
    s = summary(recs)
    assert s["update_ms"] == 3.0 and s["update/sample_ms"] == 2.0
    assert s["reads"] == 5.0 and s["read_ms"] == 0.5
    assert "update/sample/read_ms" not in s


def test_no_record_function_outside_a_profiler(monkeypatch, one_thread):
    made = []
    orig = torch.autograd.profiler.record_function

    def counted(name, *a, **k):
        made.append(name)
        return orig(name, *a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    state, batch, gen = rig.finetune("cpu")
    records().clear()
    state.step_fn(state, batch, gen)
    assert len(records()) == 1
    assert not [m for m in made if m.startswith("goat.")]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with L.span("update"):
            pass
    assert made[-1] == "goat.update"


def finetune_update(profiled: bool):
    state, batch, gen = rig.finetune("cpu")
    records().clear()
    if profiled:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            m, grads, outs = state.step_fn(state, batch, gen, keep=True)
        names = {e.name for e in prof.events()}
    else:
        m, grads, outs = state.step_fn(state, batch, gen, keep=True)
        names = set()
    assert len(records()) == 1
    return m, grads, outs, records()[-1], names


def test_finetune_update_records(one_thread):
    runs = [finetune_update(profiled) for profiled in (False, True)]
    (m0, g0, o0, r0, _), (m1, g1, o1, r1, names) = runs
    assert {"goat.update", "goat.text", "goat.teacher", "goat.sample",
            "goat.step", "goat.read", "goat.backward",
            "goat.optimizer"} <= names
    assert torch.equal(m0["loss"], m1["loss"])
    assert g0.keys() == g1.keys()
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert torch.equal(o0["sample"]["actions"], o1["sample"]["actions"])
    for rec, m in ((r0, m0), (r1, m1)):
        assert rec["update"][1] == 1
        assert rec["update/sample/step"][1] == int(m["sample_steps"])
        kids = sum(rec[f"update/{k}"][0] for k in
                   ("text", "teacher", "sample", "backward", "optimizer"))
        assert kids <= rec["update"][0]
    reads = [sum(n for p, (_, n) in r.items() if L.is_read(p))
             for r in (r0, r1)]
    assert reads[0] == reads[1]
    assert reads[0] >= int(m0["sample_steps"]) + int(m0["teacher_steps"])


def test_pretrain_updates_records(tmp_path, one_thread):
    runs = []
    for profiled in (False, True):
        state, steps, batches, _ = rig.pretrain(tmp_path, "cpu")
        out, names = [], set()
        for task in rig.TASKS:
            gen = torch.Generator().manual_seed(3)
            records().clear()
            if profiled:
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU]) as prof:
                    m, kept = steps[task](state, batches[task], gen,
                                          keep=True)
                names |= {e.name for e in prof.events()}
            else:
                m, kept = steps[task](state, batches[task], gen, keep=True)
            assert len(records()) == 1
            rec = records()[-1]
            assert rec["update/optimizer/read"][1] == 1
            assert sum(rec[f"update/{k}"][0] for k in
                       ("forward", "backward", "optimizer")) \
                <= rec["update"][0]
            out.append((m["loss"], kept))
        runs.append(out)
        if profiled:
            assert {"goat.update", "goat.forward", "goat.backward",
                    "goat.optimizer", "goat.read"} <= names
    for (l0, k0), (l1, k1) in zip(*runs):
        assert torch.equal(l0, l1)
        assert k0.keys() == k1.keys()
        assert all(torch.equal(k0[k], k1[k]) for k in k0)


def test_pretrain_feed_spans_on_its_thread(tmp_path, one_thread):
    state, steps, _, rt = rig.pretrain(tmp_path, "cpu")
    args = rig.pretrain_args(tmp_path, "cpu", "--num_train_steps", "3")
    sampler = MetaTaskSampler(rig.TASKS, (1, 1, 1), seed=0)
    stream, close = pcli.batch_stream(args, rt["builder"], rt["items"],
                                      sampler, rt["device"])
    records().clear()
    try:
        for step, task, batch in stream:
            steps[task](state, batch, torch.Generator().manual_seed(step))
    finally:
        close()
        stream._thread.join(10)
    assert not stream._thread.is_alive()
    recs = list(records())
    assert len(recs) == 3
    for k in ("feed.build", "feed.copy"):
        assert sum(r[k][1] for r in recs if k in r) >= 3


def trace_lines(out):
    return [json.loads(line) for line in
            open(os.path.join(out, "metrics.jsonl"))
            if '"trace/' in line]


def test_finetune_cli_writes_trace(tmp_path, monkeypatch, one_thread):
    tiny(monkeypatch)
    out = str(tmp_path / "run")
    cli.main(["--mode", "train", "--synthetic", "--output_dir", out,
              "--iters", "2", "--log_every", "1"] + COMMON)
    lines = trace_lines(out)
    assert [d["step"] for d in lines] == [1, 2]
    for d in lines:
        assert d["trace/update_ms"] > 0
        assert 0 < d["trace/update/teacher_ms"] < d["trace/update_ms"]
        assert d["trace/update/backward_ms"] > 0
        assert d["trace/update/optimizer_ms"] > 0
        assert d["trace/reads"] >= 1 and d["trace/read_ms"] >= 0


def test_pretrain_cli_writes_trace(tmp_path, one_thread):
    out = str(tmp_path / "run")
    args = rig.pretrain_args(tmp_path, "cpu", "--num_train_steps", "2",
                             "--log_steps", "1", "--output_dir", out)
    pcli.train(args)
    lines = trace_lines(out)
    assert [d["step"] for d in lines] == [1, 2]
    for d in lines:
        assert d["trace/update_ms"] > 0
        assert 0 < d["trace/update/forward_ms"] < d["trace/update_ms"]
        assert d["trace/update/optimizer_ms"] > 0
        assert d["trace/reads"] >= 1
    assert lines[0]["trace/feed.build_ms"] > 0
