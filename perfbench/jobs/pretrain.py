"""The pretrain job: GOAT's proxy-task updates (MLM, SAP, CFP and, for
REVERIE, OG, in `MetaTaskSampler`'s seeded order; loss, backward,
global-norm clip, the pretrain AdamW) on the port, in a closed loop over
the pretrain CLI's own feed: `pretrain/cli.py` `batch_stream` with no
workers, one prefetch thread of depth 2 building each batch
(`TrajBatchBuilder`) and copying it to the card from pinned memory.  The
loss of every update is fetched, as the CLI fetches it.

Set-up builds the port's model, optimizer, steps, sampler and feed
(`GoatPretrainModel`, `PretrainState`, `make_pretrain_optimizer`,
`make_pretrain_steps`, `MetaTaskSampler`, `TrajBatchBuilder`) on the
benchmark's inputs, draws the weights, and drives the first
`checked_updates` updates through the window's own steps and feed, and
more until every task has had one: the checked updates.  After the window
the plain reference rebuilds each checked batch from the same (seed,
task, step) with its frozen builder, takes each checked update from the
program's weights before it, and follows the first `checked_updates` from
the first weights on its own (`perfbench.judge`).
"""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from .. import judge, roofline, world
from . import common
from .tiny import shrink


def _ports():
    from vln_goat_tpu_torch.config import GoatConfig, PretrainConfig
    from vln_goat_tpu_torch.ops import attention
    from vln_goat_tpu_torch.pretrain.cli import batch_stream
    from vln_goat_tpu_torch.pretrain.data import (PretrainShapes,
                                                  TrajBatchBuilder,
                                                  items_from_dataset)
    from vln_goat_tpu_torch.pretrain.model import GoatPretrainModel
    from vln_goat_tpu_torch.pretrain.train import (MetaTaskSampler,
                                                   PretrainState,
                                                   make_pretrain_optimizer,
                                                   make_pretrain_steps)
    from vln_goat_tpu_torch.sim.graph_sim import build_scan_graph
    return dict(locals())


def _references():
    from ..reference.goat.config import GoatConfig, PretrainConfig
    from ..reference.goat.pretrain.data import (PretrainShapes,
                                                TrajBatchBuilder,
                                                items_from_dataset)
    from ..reference.goat.pretrain.feed import batch_to_device, make_batch_np
    from ..reference.goat.pretrain.model import GoatPretrainModel
    from ..reference.goat.pretrain.train import (MetaTaskSampler,
                                                 PretrainState,
                                                 make_pretrain_optimizer,
                                                 make_pretrain_steps)
    from ..reference.goat.sim.graph_sim import build_scan_graph
    return dict(locals())


def inputs(cfg: dict, tr: dict, seed: int, build_ref_graph) -> dict:
    geos = world.geometries(cfg, tr["world_seed"])
    ref_graphs = world.build_graphs(build_ref_graph, geos,
                                    cfg["world"]["max_cands"])
    items = world.episodes(ref_graphs, tr["episodes"],
                           cfg["model"]["vocab_size"], tr["instr_len"],
                           tr["path_hops"], tr["world_seed"], seed)
    objects = None
    if cfg["world"]["objects_per_viewpoint"]:
        objects = world.reverie_objects(cfg, ref_graphs, seed, [items])
    return dict(seed=seed, geos=geos, ref_graphs=ref_graphs, items=items,
                objects=objects, feats=world.view_features(cfg, seed),
                order=[g[0] for g in geos],
                feed_seed=tr["feed_seed"],
                sampler_seed=tr["sampler_seed"])


def build(mods: dict, cfg: dict, tr: dict, inp: dict, graphs,
          dev: torch.device):
    """(state, steps, builder, items, sampler) of either side on `dev`,
    weights not drawn yet."""
    m, pt = cfg["model"], cfg["pretrain"]
    gcfg = mods["GoatConfig"].for_dataset(cfg["dataset"], **m)
    objects = inp["objects"]
    shapes = mods["PretrainShapes"](
        max_txt_len=tr["instr_len"], max_steps=tr["max_steps"],
        max_cands=cfg["world"]["max_cands"], max_gmap=tr["max_gmap"],
        mrc_prob_dim=pt["mrc_prob_dim"],
        max_objs=cfg["world"]["objects_per_viewpoint"])
    builder = mods["TrajBatchBuilder"](
        graphs, inp["order"], inp["feats"], shapes,
        vocab_size=m["vocab_size"], objnav=objects is not None,
        objects=objects, seed=inp["feed_seed"] % 2 ** 32)
    items = mods["items_from_dataset"](inp["items"], graphs)
    with torch.device("meta"):
        model = mods["GoatPretrainModel"](gcfg, tuple(pt["tasks"]),
                                          pt["mrc_prob_dim"])
    model = model.to_empty(device=dev)
    pcfg = mods["PretrainConfig"](
        tasks=tuple(pt["tasks"]), mix_ratio=tuple(pt["mix_ratio"]),
        train_batch_size=tr["batch_size"], learning_rate=pt["learning_rate"],
        num_train_steps=pt["num_train_steps"],
        warmup_steps=pt["warmup_steps"], grad_norm=pt["grad_norm"],
        optim=pt["optim"], betas=tuple(pt["betas"]),
        weight_decay=pt["weight_decay"])
    state = mods["PretrainState"](model,
                                  mods["make_pretrain_optimizer"](pcfg, model))
    steps = mods["make_pretrain_steps"](model, pt["tasks"])
    sampler = mods["MetaTaskSampler"](pt["tasks"], pt["mix_ratio"],
                                      seed=inp["sampler_seed"])
    return state, steps, builder, items, sampler


def leaf_names(model) -> List[str]:
    """Names of the pretrain optimizer's leaves, in the order of
    `pretrain.train.jax_leaves` (an in_proj matrix split into q, k, v)."""
    out = []
    for mname, mod in model.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            full = f"{mname}.{name}" if mname else name
            if name in ("in_proj_weight", "in_proj_bias"):
                out += [f"{full}.{p}" for p in "qkv"]
            else:
                out.append(full)
    return out


# checked updates at most, should a task not come up in the mix
MAX_CHECKED = 32


def last_grads(mu_after, mu_before, b1: float) -> List[torch.Tensor]:
    """The gradient the optimizer got in its last update, from its first
    moment after and before it (None: a fresh state's zeros)."""
    if mu_before is None:
        return [(a / (1 - b1)).to("cpu") for a in mu_after]
    return [((a - b1 * b) / (1 - b1)).to("cpu")
            for a, b in zip(mu_after, mu_before)]


def setup(cell, seed: int, device: str = "cuda", tiny: bool = False
          ) -> dict:
    """The program built on the run's inputs with the weights drawn and
    its feed started, its checked updates driven through the window's own
    steps and feed, and what the reference needs of them: the leaves
    before each and after the last (`snaps`), each update's step, task,
    loss and gradient as the optimizer got it.  `next_update` runs the next update on
    the feed's next batch; `close` stops the feed and waits for its
    thread."""
    cfg, tr = cell["config"], cell["traffic"]
    if tiny:
        cfg, tr = shrink(cfg, tr)
    dev = common.resolve(device)
    common.full_precision()
    P, R = _ports(), _references()
    inp = inputs(cfg, tr, seed, R["build_scan_graph"])
    graphs = world.build_graphs(P["build_scan_graph"], inp["geos"],
                                cfg["world"]["max_cands"])
    state, steps, builder, items, sampler = build(P, cfg, tr, inp, graphs,
                                                  dev)
    world.draw_weights(state.model, seed)
    names = leaf_names(state.model)
    init = common.cpu_copy(state.params())
    feed_args = SimpleNamespace(num_workers=0, num_train_steps=2 ** 40,
                                train_batch_size=tr["batch_size"],
                                seed=inp["feed_seed"])
    stream, stop = P["batch_stream"](feed_args, builder, {"train": items},
                                     sampler, dev)
    gen = torch.Generator(device=dev)

    def next_update():
        t0 = time.perf_counter()
        with torch.profiler.record_function("perfbench.feed"):
            step, task, batch = next(stream)
        wait = time.perf_counter() - t0
        gen.manual_seed(world.torch_seed(seed, "step", step))
        with torch.profiler.record_function("perfbench.update"):
            m = steps[task](state, batch, gen)
            loss = float(m["loss"])
        sig = (task,) + tuple((k, tuple(v.shape))
                              for k, v in sorted(batch.items()))
        return step, task, loss, wait, sig

    def close():
        stop()
        stream._thread.join(timeout=60)

    su = dict(cfg=cfg, tr=tr, dev=dev, P=P, R=R, inp=inp, names=names,
              next_update=next_update, close=close)
    try:
        b1, tasks = cfg["pretrain"]["betas"][0], set(cfg["pretrain"]["tasks"])
        checked, grads, snaps, mu = [], [], [init], None
        while len(checked) < MAX_CHECKED and (
                len(checked) < tr["checked_updates"]
                or {c["task"] for c in checked} != tasks):
            step, task, loss, _, _ = next_update()
            checked.append(dict(step=step, task=task, loss=loss))
            mu_after = common.find_first_moment(state.opt_state)
            grads.append(last_grads(mu_after, mu, b1))
            mu = [t.clone() for t in mu_after]
            snaps.append(common.cpu_copy(state.params()))
        del mu
        su.update(checked=checked, grads=grads, snaps=snaps)
    except BaseException:
        close()
        raise
    return su


def judge_numbers(su: dict, ref: dict) -> tuple:
    """(leaves and tasks agree, the compared numbers) of the program's
    checked updates against a reference pass."""
    ok = ref["names"] == su["names"] and ref["tasks_agree"]
    nums = {}
    if ok:
        snaps, chain = su["snaps"], su["tr"]["checked_updates"]
        prog = dict(losses=[c["loss"] for c in su["checked"]],
                    grads=su["grads"],
                    change=[a - b for a, b in zip(snaps[chain], snaps[0])])
        nums = judge.pretrain_numbers(prog, ref, chain)
    return ok, nums


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        tiny: bool = False, t_start: float = None) -> dict:
    su = setup(cell, seed, device, tiny)
    cfg, tr, dev = su["cfg"], su["tr"], su["dev"]
    next_update, checked, B = su["next_update"], su["checked"], \
        tr["batch_size"]
    try:
        win = common.Window()
        common.reset_peak(dev)
        clock = common.Clock(dev, seconds)
        setup_s = clock.t0 - (t_start if t_start is not None else clock.t0)
        while True:
            t0 = time.perf_counter()
            step, task, loss, wait, sig = next_update()
            win.updates += 1
            win.examples += B
            win.failed += 0 if np.isfinite(loss) else 1
            win.feed_s.append(wait)
            win.per_update.append(dict(step=step, task=task, sig=sig,
                                       s=time.perf_counter() - t0))
            if clock.done():
                break
        win.seconds = clock.stop()
        peak = common.peak_bytes(dev)
        by_task = {t: [u["s"] for u in win.per_update if u["task"] == t]
                   for t in cfg["pretrain"]["tasks"]}
        print(f"window: {win.updates} updates in {win.seconds:.3f} s, "
              f"{sum(win.feed_s):.3f} s of it waiting on the feed; "
              + ", ".join(f"{t} {len(v)} in {sum(v):.3f} s"
                          for t, v in by_task.items()), file=sys.stderr)
        print(clock.host(), file=sys.stderr)
        ctx = common.Context(job="pretrain", window=win)
        if trace:
            ctx = traced(ctx, next_update, su["P"]["attention"], cfg, tr)
    finally:
        su["close"]()
    del next_update
    su.pop("next_update"), su.pop("close")
    common.free()

    ref = reference(su["R"], cfg, tr, su["inp"], dev, su["snaps"], checked,
                    win.per_update if trace else None)
    ok, nums = judge_numbers(su, ref)
    if trace and ref["flops"]:
        ctx.window_flops = sum(ref["flops"][u["sig"]]
                               for u in win.per_update)
    return common.outcome(cell, ok, nums, win, peak, dev, ctx, dict(
        pretrain_examples_per_s=win.examples / win.seconds,
        peak_mem_gib=peak / 2 ** 30, setup_s=setup_s))


def traced(ctx, next_update, attention, cfg, tr):
    """`trace_updates` updates traced on the device alone, then as many
    with the host's calls (`trace.stretches`): the traces, the first
    stretch's launches against the pretraining plan of their tasks, and
    the least time of those launches."""
    from .. import trace as trace_mod
    before = common.launches(attention)
    ctx.trace, tasks, ctx.host_trace, host = trace_mod.stretches(
        lambda: next_update()[1], tr["trace_updates"])
    ctx.traced_updates, ctx.host_traced_updates = len(tasks), len(host)
    after = common.launches(attention)
    m, w = cfg["model"], cfg["world"]
    vp = w["max_cands"] + 36 + 1

    def mix_of(ts):
        return roofline.add(*[roofline.pretrain_plan(
            t, m, tr["instr_len"], tr["max_gmap"], vp,
            vp + w["objects_per_viewpoint"]) for t in ts])

    mix = mix_of(tasks)
    ctx.launches = {k: after[k] - before[k] for k in after}
    ctx.expected_launches = sum(mix_of(tasks + host).values())
    if all(v == ctx.expected_launches for v in ctx.launches.values()):
        H = m["num_attention_heads"]
        ctx.least_s = roofline.launch_least_ms(
            mix, tr["batch_size"], m["hidden_size"], H,
            m["hidden_size"] // H) / 1e3
    k1 = ctx.trace.count_of(lambda n: "attn_fwd_kernel" in n) \
        if ctx.trace else 0
    print(f"traced {len(tasks)} + {len(host)} updates ({', '.join(tasks)}; "
          f"{', '.join(host)}): launches by the port's counters "
          f"{ctx.launches}, by the tasks' plan {ctx.expected_launches}; K1 "
          f"attention kernels in the device trace {k1}, called for "
          f"{sum(mix.values())}", file=sys.stderr)
    return ctx


def reference(R, cfg, tr, inp, dev, snaps, checked, window=None,
              tf32=False) -> dict:
    """The reference's loss and gradient of each checked update, on
    batches it builds itself, each from the program's weights before it
    (`snaps[i]`) with a fresh optimizer state, and its own change over the
    first `checked_updates` of them from `snaps[0]`; with the window's
    updates, the FLOPs of one update of each (task, batch shapes) among
    them.  `tf32`: its float32 products in TF32, the control of the
    comparison."""
    state, steps, builder, items, sampler = build(
        R, cfg, tr, inp, inp["ref_graphs"], dev)
    names = leaf_names(state.model)

    def load(vals):
        with torch.no_grad():
            for p, v in zip(state.params(), vals):
                p.copy_(v)
        state.opt_state = state.tx.init(state.params())

    B, seed = tr["batch_size"], inp["feed_seed"]
    gen = torch.Generator(device=dev)

    def batch_of(task, step):
        return R["batch_to_device"](R["make_batch_np"](
            builder, items, B, seed, "train", task, step), dev)

    def update(c):
        gen.manual_seed(world.torch_seed(inp["seed"], "step", c["step"]))
        m = steps[c["task"]](state, batch_of(c["task"], c["step"]), gen)
        return float(m["loss"])

    b1, chain = cfg["pretrain"]["betas"][0], tr["checked_updates"]
    common.full_precision(tf32)
    agree = all(sampler.task_at(c["step"]) == c["task"] for c in checked)
    load(snaps[0])
    losses, grads = [update(checked[0])], [last_grads(
        common.find_first_moment(state.opt_state), None, b1)]
    for c in checked[1:chain]:
        update(c)
    change = [a.to("cpu") - b for a, b in zip(state.params(), snaps[0])]
    for i, c in enumerate(checked[1:], 1):
        load(snaps[i])
        losses.append(update(c))
        grads.append(last_grads(common.find_first_moment(state.opt_state),
                                None, b1))
    common.full_precision()
    flops = {}
    if window:
        from torch.utils.flop_counter import FlopCounterMode
        for u in window:
            if u["sig"] in flops:
                continue
            counter = FlopCounterMode(display=False)
            with counter:
                steps[u["task"]](state, batch_of(u["task"], u["step"]), gen)
            flops[u["sig"]] = float(counter.get_total_flops())
    out = dict(names=names, losses=losses, grads=grads, change=change,
               tasks_agree=agree, flops=flops)
    del state, steps, builder
    common.free()
    return out
