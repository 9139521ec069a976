"""The port's pretrain CLI against the JAX package's, both run in this
process on the same command line: `--synthetic`, a tiny `--model_config`
with every dropout at 0, tasks MLM / SAP / CFP, batch 6 (not a multiple of
the 8 virtual JAX devices tests/conftest.py sets, so the JAX CLI keeps
one device), 4 steps with validation at steps 2 and 4, and `--init_from` one
pretrain .pt of the port's seeded weights (`--init_format goat`), which
both load whole (the JAX CLI's own init is replaced by the shapes of its
parameter tree, whose every leaf the .pt then overwrites).

Held: the same task at every step, each step's loss within 1e-4, every
validation score (each task's loss and metrics on val_seen / val_unseen)
within 1e-4, the same best-checkpoint steps, and the port's checkpoint
directories (`ckpt_latest`, `ckpt_best_<step>`) loadable."""
import json
import os

import numpy as np
import pytest
import jax

import vln_goat_tpu.pretrain.train as jtrain
from vln_goat_tpu.pretrain import cli as jcli
from vln_goat_tpu_torch.pretrain import cli
import vln_goat_tpu_torch.pretrain.train as ptrain
from vln_goat_tpu_torch.pretrain.model import build_pretrain_model
from vln_goat_tpu_torch.train import checkpoint as ck
from torch_pretrain_rig import TINY

TASKS = ("mlm", "sap", "cfp")


def recording(make_steps, log):
    """make_pretrain_steps whose steps append (task, loss) to `log`."""
    def make(*args, **kw):
        steps = make_steps(*args, **kw)

        def wrap(task, fn):
            def step(*a, **k):
                out = fn(*a, **k)
                # the JAX step returns (state, metrics), the port's metrics
                m = out[1] if isinstance(out, tuple) else out
                log.append((task, float(m["loss"])))
                return out
            return step

        return {t: wrap(t, f) for t, f in steps.items()}
    return make


def shapes_only(model, rng, batches):
    """The JAX CLI's init, as zeros of its parameter tree's shapes."""
    from vln_goat_tpu.train.params import _merge

    params = {}
    for i, (task, batch) in enumerate(batches.items()):
        v = jax.eval_shape(lambda b, t=task: model.init(
            jax.random.fold_in(rng, i), b, t), batch)
        params = _merge(params, v["params"])
    return {"params": jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), params)}


def scores(out_dir):
    rows = [json.loads(line) for line in
            open(os.path.join(out_dir, "metrics.jsonl"))]
    return [{k: v for k, v in r.items() if k.startswith("val_")}
            for r in rows if any(k.startswith("val_") for k in r)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrain_cli")
    model_json = root / "tiny.json"
    model_json.write_text(json.dumps(dict(TINY,
                                          max_position_embeddings=128)))
    args = ["--synthetic", "--model_config", str(model_json), "--tasks",
            *TASKS, "--train_batch_size", "6", "--max_txt_len", "32",
            "--max_steps_traj", "6", "--max_gmap", "32",
            "--num_train_steps", "4", "--valid_steps", "2", "--log_steps",
            "1", "--learning_rate", "1e-4", "--warmup_steps", "2"]
    pargs = cli.parse_args(args + ["--device", "cpu"])
    model = build_pretrain_model(cli.model_config(pargs), TASKS, 1000,
                                 "cpu", seed=11)
    pt = str(root / "init.pt")
    ck.save_pretrain_checkpoint(model.state_dict(), pt)
    args += ["--init_from", pt, "--init_format", "goat"]
    logs = {"port": [], "jax": []}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ptrain, "make_pretrain_steps",
                   recording(ptrain.make_pretrain_steps, logs["port"]))
        mp.setattr(jtrain, "make_pretrain_steps",
                   recording(jtrain.make_pretrain_steps, logs["jax"]))
        mp.setattr(jtrain, "init_pretrain_params", shapes_only)
        cli.main(args + ["--device", "cpu", "--output_dir",
                         str(root / "port")])
        jcli.main(args + ["--output_dir", str(root / "jax")])
    finally:
        mp.undo()
    return dict(root=root, logs=logs)


def test_same_tasks_and_losses(runs):
    port, ref = runs["logs"]["port"], runs["logs"]["jax"]
    sampler = ptrain.MetaTaskSampler(TASKS, (1, 1, 1), seed=0)
    assert [t for t, _ in port] == [t for t, _ in ref] == \
        [sampler.task_at(s) for s in range(4)]
    for (t, a), (_, b) in zip(port, ref):
        assert abs(a - b) <= 1e-4, (t, a, b)


def test_same_validation(runs):
    port = scores(runs["root"] / "port")
    ref = scores(runs["root"] / "jax")
    assert len(port) == len(ref) == 4       # two splits at steps 2 and 4
    for p, r in zip(port, ref):
        assert set(p) == set(r)
        for k, v in r.items():
            assert abs(p[k] - v) <= 1e-4, (k, p[k], v)


def test_init_and_checkpoints(runs):
    for side in ("port", "jax"):
        log = open(runs["root"] / side / "pretrain.log").read()
        assert "(goat): 0 missing, 0 unused keys" in log, side
        best = sorted(d for d in os.listdir(runs["root"] / side)
                      if d.startswith("ckpt_best_"))
        assert best, side
    port_best = sorted(d for d in os.listdir(runs["root"] / "port")
                       if d.startswith("ckpt_best_"))
    jax_best = sorted(d for d in os.listdir(runs["root"] / "jax")
                      if d.startswith("ckpt_best_"))
    assert port_best == jax_best
    for d in ["ckpt_latest"] + port_best:
        sd = ck.load_params(str(runs["root"] / "port" / d))
        assert all(np.isfinite(v.numpy()).all() for v in sd.values())
