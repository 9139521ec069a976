"""Shared rig of the port's multi-process tests (tests/test_torch_dist_*,
tests/test_torch_parallel.py): the ranks run in spawned processes over
gloo on the CPU, and what each runs is a function of this module, which
imports torch and the port only (no JAX: a spawned child imports the
module of its function, and JAX would cost it seconds and memory).

`run_ranks(fn, world, payload)` starts `world` children, each with one
torch thread, joined to one process group on a free local port (from
bind(0)) with a 60 s timeout; each calls fn(rank, world, payload) and
hands back its result.  The children are joined with a timeout and
killed after it; an error in any of them fails the caller with the
child's traceback."""
from __future__ import annotations

import contextlib
import io
import multiprocessing as mp
import os
import queue
import socket
import traceback

import numpy as np
import torch

JOIN_TIMEOUT_S = 240
GROUP_TIMEOUT_S = 60
LR, WD = 2e-5, 0.01


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(fn, rank, world, port, payload, out, group):
    torch.set_num_threads(1)
    from vln_goat_tpu_torch.parallel import distributed as pdist

    pdist.DEFAULT_TIMEOUT_S = GROUP_TIMEOUT_S
    try:
        if group:
            pdist.init_distributed(f"localhost:{port}", world, rank,
                                   device="cpu", always=True,
                                   timeout_s=GROUP_TIMEOUT_S)
        out.put((rank, None, fn(rank, world, payload)))
    except BaseException:
        out.put((rank, traceback.format_exc(), None))
    finally:
        pdist.shutdown()


def run_ranks(fn, world: int, payload=None, group: bool = True,
              timeout: float = JOIN_TIMEOUT_S) -> list:
    """[fn(rank, world, payload) for each rank], each run in a spawned
    process of a `world`-process gloo group (`group=False`: no group)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, port, payload, out, group))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, err, res = out.get(timeout=timeout)
            if err:
                errors.append(f"rank {rank}:\n{err}")
            results[rank] = res
    except queue.Empty:
        errors.append(f"no result from ranks "
                      f"{sorted(set(range(world)) - set(results))} in "
                      f"{timeout} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert not errors, "\n".join(errors)
    return [results[r] for r in range(world)]


def tolerance_scales(ref, noise=()):
    """Each gradient's tolerance scale: its largest magnitude, at least
    1e-4 of the model's largest gradient (below that a gradient is zero up
    to float32 rounding; test_torch_causal_train.py `_grad_scales`), and
    for the biases `noise` names (zero up to rounding, as
    tools/gate_witness.py's NOISE_GRAD_BIASES) at least their weight's
    -> ({name: scale}, floor)."""
    floor = 1e-4 * max(float(np.abs(g).max()) for g in ref.values())
    scales = {n: max(float(np.abs(g).max()), floor) for n, g in ref.items()}
    for name in scales:
        if name.endswith(tuple(noise)):
            scales[name] = max(scales[name],
                               float(np.abs(ref[name[:-4] + "weight"]).max()))
    return scales, floor


def check_grads(got, ref, noise=(), what=""):
    """Every gradient of `ref` (a missing one in `got` as zero) within
    1e-4 of its `tolerance_scales` scale; no gradient `ref` lacks."""
    assert set(got) <= set(ref), set(got) - set(ref)
    for name, scale in tolerance_scales(ref, noise)[0].items():
        g = got.get(name, np.zeros_like(ref[name]))
        assert float(np.abs(g - ref[name]).max()) <= 1e-4 * scale, \
            (what, name)


def check_params(got, ref, ref_grads, got_grads, lr, noise=()):
    """test_torch_causal_train.py's rule for the parameters after one
    update: within 1e-6 of each tensor's largest magnitude, and 2 lr more
    where the gradient is nonzero but under the gradient tolerance's reach
    (an element under 1e-4 of its tensor's scale, or a whole tensor under
    the floor: AdamW's first step divides it by its own size, so it may
    move either way by up to the step size)."""
    scales, floor = tolerance_scales(ref_grads, noise)
    for name, r in ref.items():
        g = ref_grads.get(name, np.zeros_like(r))
        tol = np.full(r.shape, 1e-6 * float(np.abs(r).max()))
        nonzero = (g != 0) | (got_grads[name] != 0 if name in got_grads
                              else False)
        noisy = nonzero & ((np.abs(g) < 1e-4 * scales.get(name, floor))
                           | (float(np.abs(g).max()) < floor))
        tol[noisy] += 2 * lr
        assert (np.abs(got[name] - r) <= tol).all(), name


def numpy_tree(d):
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else v for k, v in d.items()}


def tensors(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            if isinstance(v, np.ndarray) else v for k, v in d.items()}


# ----------------------------------------------------------------------
# the collectives of parallel/ (tests/test_torch_parallel.py)
def collectives(rank, world, _):
    """Each collective of `parallel.distributed` and `parallel.mesh` on
    this rank, on inputs that differ by rank -> {name: result}."""
    from vln_goat_tpu_torch.parallel import distributed as pdist
    from vln_goat_tpu_torch.parallel.mesh import make_mesh, replicate_tree

    out = {"count": pdist.process_count(), "index": pdist.process_index()}
    out["gather"] = pdist.merge_dist_results(
        pdist.all_gather_objects([{"rank": rank}] * (rank + 1)))
    out["sum"] = pdist.all_reduce_sum(
        torch.tensor([rank + 1.0, 10.0 * rank])).tolist()
    out["metrics"] = {k: float(v) for k, v in pdist.reduce_metrics(
        {"loss": torch.tensor(2.0 + rank), "node_overflow": torch.tensor(
            rank + 3), "steps": torch.tensor(4 + rank)},
        sums=("node_overflow",), maxes=("steps",)).items()}
    # rank 0 has no gradient for `b`, rank 1 one of its own
    a = torch.nn.Parameter(torch.zeros(3))
    b = torch.nn.Parameter(torch.zeros(2, dtype=torch.float64))
    a.grad = torch.full((3,), float(rank + 1))
    if rank:
        b.grad = torch.full((2,), 4.0, dtype=torch.float64)
    pdist.all_reduce_grads([a, b])
    out["grads"] = (a.grad.tolist(), b.grad.tolist())
    # the differentiable gather: rows of every rank, the gradient of a
    # rank's rows the sum over ranks of the gathered one's
    x = torch.full((2, 3), float(rank), requires_grad=True)
    y = pdist.gather_rows(x)
    (y * (rank + 1)).sum().backward()
    out["gather_rows"] = (y.detach().tolist(), x.grad.tolist())
    out["broadcast"] = pdist.broadcast_object({"from": rank})
    lin = torch.nn.Linear(2, 2)
    torch.nn.init.constant_(lin.weight, float(rank))
    replicate_tree(lin)
    out["replicated"] = lin.weight.tolist()
    mesh = make_mesh("cpu")
    out["mesh"] = (mesh.rank, mesh.size, str(mesh.device))
    return out


# ----------------------------------------------------------------------
# the fine-tune train step (tests/test_torch_dist_train.py)
def train_case(rank, world, case):
    """One train case on this rank: the tiny train build from `case["sd"]`,
    its updates on the rank's rows of each global batch (dagger_fused: of
    each half), the Gumbel draws the rank's rows of `case["noise"]` ->
    (metrics and gradients before clipping of each update, parameters
    after)."""
    from vln_goat_tpu_torch.config import TrainConfig
    from vln_goat_tpu_torch.entry import build_train_flagship
    from vln_goat_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from vln_goat_tpu_torch.rollout import rollout as port_rollout
    from vln_goat_tpu_torch.train.trainer import (GradAccumulator,
                                                  fused_dagger_rank_batch)

    alg, B = case["alg"], case["B"]
    state, _ = build_train_flagship(
        "cpu", tiny=True, batch_size=B, dropout=False,
        tcfg=TrainConfig(train_alg=alg, lr=LR, weight_decay=WD))
    state.model.load_state_dict(tensors(case["sd"]))
    if case.get("accumulate", 1) > 1:
        state.optimizer.accumulator = GradAccumulator(
            state.optimizer.params(), case["accumulate"])
    mesh = make_mesh("cpu")
    state.mesh = mesh
    noise = case.get("noise")
    # the draw fixed below is the rollout module's, so it is put back on
    # the way out: an in-process call (the one-process reference) would
    # otherwise leave it in place for whatever runs after it
    drawn = port_rollout.gumbel_noise
    try:
        if noise is not None:
            # the rows of the rank's episodes: of each half when fused
            halves = np.split(noise, 2) if alg == "dagger_fused" else [noise]
            mine = np.concatenate([np.split(h, world)[rank] for h in halves])
            port_rollout.gumbel_noise = \
                lambda g, shape, device: torch.from_numpy(mine)
        metrics, grads = [], []
        for batch in case["batches"]:
            if alg == "dagger_fused":
                local = fused_dagger_rank_batch(tensors(batch[0]),
                                                tensors(batch[1]), mesh)
            else:
                local = shard_batch(tensors(batch), mesh)
            m, g, _ = state.step_fn(state, local,
                                    torch.Generator().manual_seed(0),
                                    keep=True)
            metrics.append({k: float(v) for k, v in m.items()})
            grads.append(numpy_tree(g))
    finally:
        port_rollout.gumbel_noise = drawn
    return dict(metrics=metrics, grads=grads,
                params=numpy_tree(dict(state.model.named_parameters())))


def train_cases(rank, world, cases):
    """{name: train_case(...)} of every case of `cases`."""
    return {name: train_case(rank, world, case)
            for name, case in cases.items()}


# ----------------------------------------------------------------------
# the pretraining step (tests/test_torch_dist_pretrain.py)
def pretrain_case(rank, world, case):
    """One update per task of the tiny pretrain model from `case["sd"]`
    on the rank's rows of each task's global batch (`case["mesh"]`: with
    the steps' all-reduce; `case["share"]`: with the model's loss shares)
    ->
    {task: (metrics, gradients before the clip, parameters after)}."""
    from vln_goat_tpu_torch.config import GoatConfig, PretrainConfig
    from vln_goat_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from vln_goat_tpu_torch.pretrain.model import build_pretrain_model
    from vln_goat_tpu_torch.pretrain.train import (PretrainState,
                                                   make_pretrain_optimizer,
                                                   make_pretrain_steps)

    cfg = GoatConfig(**case["cfg"])
    mesh = make_mesh("cpu") if case["mesh"] else None
    out = {}
    for task, batch in case["batches"].items():
        model = build_pretrain_model(cfg, case["tasks"], case["probs"],
                                     "cpu")
        model.load_state_dict(tensors(case["sd"]))
        model.mesh = mesh if case["share"] else None
        pcfg = PretrainConfig(tasks=tuple(case["tasks"]),
                              learning_rate=case["lr"],
                              num_train_steps=10, warmup_steps=0)
        state = PretrainState(model, make_pretrain_optimizer(pcfg, model))
        step = make_pretrain_steps(model, [task], mesh)[task]
        m, grads = step(state, shard_batch(tensors(batch), mesh),
                        torch.Generator().manual_seed(0), keep=True)
        out[task] = ({k: float(v) for k, v in m.items()},
                     numpy_tree(grads),
                     numpy_tree(dict(model.named_parameters())))
    return out


def pretrain_cases(rank, world, cases):
    """{name: pretrain_case(...)} of every case of `cases`."""
    return {name: pretrain_case(rank, world, case)
            for name, case in cases.items()}


# ----------------------------------------------------------------------
# the fine-tune CLI (tests/test_torch_dist_cli.py)
@contextlib.contextmanager
def tiny_cli():
    """GoatConfig.for_dataset at the fine-tune CLI tests' widths
    (test_torch_cli.py `tiny`) while the context lasts."""
    from vln_goat_tpu_torch.config import GoatConfig

    saved = GoatConfig.__dict__["for_dataset"]
    orig = saved.__func__

    def small(cls, dataset, **kw):
        kw.update(hidden_size=32, num_attention_heads=2,
                  intermediate_size=64, vocab_size=64,
                  max_position_embeddings=64)
        return orig(cls, dataset, **kw)

    GoatConfig.for_dataset = classmethod(small)
    try:
        yield
    finally:
        GoatConfig.for_dataset = saved


def cli_runs(rank, world, runs):
    """The fine-tune (`cli`) or the pretraining (`pretrain`) CLI's main on
    this rank for each (which, argv, port) of `runs`, "{rank}" in argv
    the rank -> the standard output of each run."""
    from vln_goat_tpu_torch import cli
    from vln_goat_tpu_torch.pretrain import cli as pretrain_cli

    mains = {"cli": cli.main, "pretrain": pretrain_cli.main}
    outs = []
    for which, argv, port in runs:
        argv = [a.format(rank=rank) for a in argv]
        buf = io.StringIO()
        # the fine-tune CLI at its tests' widths; the pretraining CLI
        # takes its own from --model_config
        with contextlib.redirect_stdout(buf), \
                (tiny_cli() if which == "cli" else contextlib.nullcontext()):
            mains[which](argv + ["--num_processes", str(world),
                                 "--process_id", str(rank), "--coordinator",
                                 f"localhost:{port}"])
        outs.append(buf.getvalue())
    return outs


def listing(path):
    """Every file under `path`, relative to it."""
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)

