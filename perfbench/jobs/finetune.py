"""The fine-tune job: GOAT's DAgger update (teacher rollout at ml_weight
plus a sampled rollout, imitation loss, backward, global-norm clip, AdamW)
on the port, in a closed loop over the port's `EpisodeBatcher`.

Set-up builds the port's world, model, rollout, batcher and train state
(`NavWorld.build`, `GoatModel`, `NavRollout`, `EpisodeBatcher`,
`init_train_state`) on the benchmark's inputs (`perfbench.world`), draws
the weights, and drives the first `checked_updates` updates through the
state's own step call on the batcher's batches, keeping what the reference
needs; then one update more for each gt-length bucket not yet run.  The
window runs whole updates until `seconds` have passed.  After it the
program is freed and the plain reference (`perfbench.reference.goat`)
follows the checked updates from the same weights, batches and generators,
taking the program's sampled actions and judging them (`perfbench.judge`).
"""
from __future__ import annotations

import sys
import time
from typing import Dict

import numpy as np
import torch

from .. import judge, roofline, world
from . import common
from .tiny import shrink

B1 = 0.9   # AdamW's first-moment decay: the gradient is mu / (1 - B1)


def _ports():
    from vln_goat_tpu_torch.config import GoatConfig
    from vln_goat_tpu_torch.models.goat import GoatModel
    from vln_goat_tpu_torch.ops import attention
    from vln_goat_tpu_torch.rollout.env import EpisodeBatcher
    from vln_goat_tpu_torch.rollout.rollout import NavRollout, RolloutConfig
    from vln_goat_tpu_torch.rollout.world import NavWorld
    from vln_goat_tpu_torch.sim.graph_sim import build_scan_graph
    from vln_goat_tpu_torch.train.trainer import init_train_state
    return dict(GoatConfig=GoatConfig, GoatModel=GoatModel,
                attention=attention, EpisodeBatcher=EpisodeBatcher,
                NavRollout=NavRollout, RolloutConfig=RolloutConfig,
                NavWorld=NavWorld, build_scan_graph=build_scan_graph,
                init_train_state=init_train_state)


def _references():
    from ..reference.goat.config import GoatConfig
    from ..reference.goat.models.goat import GoatModel
    from ..reference.goat.rollout.env import EpisodeBatcher
    from ..reference.goat.rollout.rollout import NavRollout, RolloutConfig
    from ..reference.goat.rollout.world import NavWorld
    from ..reference.goat.sim.graph_sim import build_scan_graph
    from ..reference.goat.train.trainer import init_train_state
    return dict(GoatConfig=GoatConfig, GoatModel=GoatModel,
                EpisodeBatcher=EpisodeBatcher, NavRollout=NavRollout,
                RolloutConfig=RolloutConfig, NavWorld=NavWorld,
                build_scan_graph=build_scan_graph,
                init_train_state=init_train_state)


def inputs(cfg: dict, tr: dict, seed: int, build_ref_graph) -> dict:
    """The run's inputs: scan geometry, the reference's graphs, view
    features, episodes and banks."""
    geos = world.geometries(cfg, tr["world_seed"])
    ref_graphs = world.build_graphs(build_ref_graph, geos,
                                    cfg["world"]["max_cands"])
    m = dict(cfg["model"], **cfg["finetune_flags"])
    items = world.episodes(ref_graphs, tr["episodes"], m["vocab_size"],
                           tr["instr_len"], tr["path_hops"],
                           tr["world_seed"], seed)
    return dict(geos=geos, ref_graphs=ref_graphs,
                feats=world.view_features(cfg, seed), items=items,
                banks=world.causal_banks(dict(cfg, model=m), seed),
                order=[g[0] for g in geos])


def build(mods: dict, cfg: dict, tr: dict, seed: int, inp: dict, graphs,
          dev: torch.device, fused: bool):
    """(train state, batcher) of either side on `dev`, weights not drawn
    yet."""
    m, ft = cfg["model"], cfg["finetune"]
    gcfg = mods["GoatConfig"].for_dataset(
        cfg["dataset"], **dict(m, use_fused_attention=fused),
        **cfg["finetune_flags"])
    rcfg = mods["RolloutConfig"](num_nodes=cfg["world"]["num_nodes"],
                                 horizon=m["max_action_len"],
                                 feat_dim=m["image_feat_size"])
    nav = mods["NavWorld"].build([graphs[s] for s in inp["order"]],
                                 features=inp["feats"], device=dev)
    with torch.device("meta"):
        model = mods["GoatModel"](gcfg)
    model = model.to_empty(device=dev)
    ro = mods["NavRollout"](model, nav, rcfg)
    batcher = mods["EpisodeBatcher"](
        inp["items"], graphs, inp["order"], batch_size=tr["batch_size"],
        max_instr_len=tr["instr_len"], max_gt_len=tr["gt_cap"],
        bucket_caps=tr["bucket_caps"], device=dev,
        seed=tr["batcher_seed"], banks=inp["banks"])
    state = mods["init_train_state"](
        model, ro, lr=ft["lr"], weight_decay=ft["weight_decay"],
        grad_clip=ft["grad_clip"], train_alg=ft["train_alg"],
        ml_weight=ft["ml_weight"], teacher_horizon="auto",
        remat=ft["remat"], vectorized_teacher=ft["vectorized_teacher"],
        sample_feedback=ft["feedback"])
    return state, batcher


def leaves(model) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def named_copy(model) -> Dict[str, torch.Tensor]:
    return {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}


def first_grads(state) -> Dict[str, torch.Tensor]:
    """The first gradient as the optimizer got it, from its state after one
    update."""
    st = state.optimizer.state
    return {n: (st[p]["mu"] / (1 - B1)).to("cpu") if "mu" in st.get(p, {})
            else torch.zeros(p.shape)
            for n, p in leaves(state.model).items()}


def setup(cell, seed: int, device: str = "cuda", tiny: bool = False
          ) -> dict:
    """The program built on the run's inputs with the weights drawn, its
    first `checked_updates` updates driven through the window's own call
    and feed, and what the reference needs of them: the weights before,
    each update's episodes, gt cap, loss, sampled actions and fused logits,
    the first gradient and the weights after.  `next_update` runs the
    next update of the same state on the batcher's next batch."""
    cfg, tr = cell["config"], cell["traffic"]
    if tiny:
        cfg, tr = shrink(cfg, tr)
    dev = common.resolve(device)
    common.full_precision()
    P, R = _ports(), _references()
    inp = inputs(cfg, tr, seed, R["build_scan_graph"])
    graphs = world.build_graphs(P["build_scan_graph"], inp["geos"],
                                cfg["world"]["max_cands"])
    state, batcher = build(P, cfg, tr, seed, inp, graphs, dev, fused=True)
    world.draw_weights(state.model, seed)
    init = named_copy(state.model)
    gen = torch.Generator(device=dev)
    n_step = 0

    def next_update(keep=False):
        nonlocal n_step
        gen.manual_seed(world.torch_seed(seed, "step", n_step))
        n_step += 1
        t0 = time.perf_counter()
        with torch.profiler.record_function("perfbench.feed"):
            items, batch = batcher.next_batch()
        wait = time.perf_counter() - t0
        with torch.profiler.record_function("perfbench.update"):
            out = state.step_fn(state, batch, gen, keep=keep)
        return items, out, wait

    checked, grad1 = [], None
    for i in range(tr["checked_updates"]):
        items, (m, grads, outs), _ = next_update(keep=True)
        del grads
        s = outs["sample"]
        checked.append(dict(
            ids=[it["instr_id"] for it in items], cap=batcher._gt_cap,
            loss=float(m["loss"]), actions=s["actions"].to("cpu"),
            logits=s["logits"].to("cpu")))
        del outs, s
        if i == 0:
            grad1 = first_grads(state)
    return dict(cfg=cfg, tr=tr, dev=dev, P=P, R=R, inp=inp, state=state,
                batcher=batcher, init=init, checked=checked, grad1=grad1,
                after=named_copy(state.model), next_update=next_update,
                n_step=lambda: n_step)


def judge_numbers(su: dict, ref: dict) -> tuple:
    """(leaves agree, the compared numbers) of the program's checked
    updates against a reference pass."""
    names = ref["names"]
    ok = set(su["grad1"]) == set(names) and \
        set(su["init"]) == set(ref["param_names"])
    nums = {}
    if ok:
        prog = dict(losses=[c["loss"] for c in su["checked"]],
                    grad1=[su["grad1"][n] for n in names],
                    change=[su["after"][n] - su["init"][n] for n in names])
        nums = judge.training_numbers(prog, ref)
    nums.update({k: ref[k] for k in ("first_logit_gap", "first_action_gap",
                                      "later_logit_gap", "later_action_gap")})
    return ok, nums


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        tiny: bool = False, t_start: float = None) -> dict:
    su = setup(cell, seed, device, tiny)
    cfg, tr, dev, batcher = su["cfg"], su["tr"], su["dev"], su["batcher"]
    next_update, checked = su["next_update"], su["checked"]
    caps_seen = {c["cap"] for c in checked}
    while len(caps_seen) < len(tr["bucket_caps"]) and \
            su["n_step"]() < tr["checked_updates"] + 8:
        next_update()
        caps_seen.add(batcher._gt_cap)

    # the window
    win = common.Window()
    common.reset_peak(dev)
    clock = common.Clock(dev, seconds)
    setup_s = clock.t0 - (t_start if t_start is not None else clock.t0)
    while True:
        t0 = time.perf_counter()
        _, m, wait = next_update()
        loss = float(m["loss"])
        win.updates += 1
        win.examples += tr["batch_size"]
        win.failed += 0 if np.isfinite(loss) else 1
        win.feed_s.append(wait)
        win.per_update.append(dict(
            steps=int(m["teacher_steps"]) + int(m["sample_steps"]),
            sample=int(m["sample_steps"]), cap=batcher._gt_cap,
            s=time.perf_counter() - t0))
        if clock.done():
            break
    win.seconds = clock.stop()
    peak = common.peak_bytes(dev)
    print(f"window: {win.updates} updates in {win.seconds:.3f} s; gt caps "
          f"{[u['cap'] for u in win.per_update]}; rollout steps "
          f"{[u['steps'] for u in win.per_update]} (sampled "
          f"{[u['sample'] for u in win.per_update]}); seconds "
          f"{[round(u['s'], 4) for u in win.per_update]}", file=sys.stderr)
    print(clock.host(), file=sys.stderr)

    ctx = common.Context(job="finetune", window=win)
    if trace:
        ctx = traced(ctx, next_update, su["P"]["attention"], cfg, tr)
    del batcher, next_update
    su.pop("state"), su.pop("batcher"), su.pop("next_update")
    common.free()

    ref = reference(su["R"], cfg, tr, seed, su["inp"], dev, su["init"],
                    checked, flops=trace)
    if trace and ref["flops_text"] is not None:
        per_step = (ref["flops1"] - ref["flops_text"]) / ref["steps1"]
        ctx.window_flops = sum(ref["flops_text"] + per_step * u["steps"]
                               for u in win.per_update)
    ok, nums = judge_numbers(su, ref)
    return common.outcome(cell, ok, nums, win, peak, dev, ctx, dict(
        finetune_episodes_per_s=win.examples / win.seconds,
        peak_mem_gib=peak / 2 ** 30, setup_s=setup_s))


def traced(ctx, next_update, attention, cfg, tr):
    """`trace_updates` updates traced on the device alone, then as many
    with the host's calls (`trace.stretches`): the traces, the first
    stretch's launches against the launches its rollout steps call for,
    and the least time of those."""
    from .. import trace as trace_mod

    def one():
        _, m, _ = next_update()
        return int(m["teacher_steps"]) + int(m["sample_steps"])

    before = common.launches(attention)
    ctx.trace, steps, ctx.host_trace, host = trace_mod.stretches(
        one, tr["trace_updates"])
    ctx.traced_updates, ctx.host_traced_updates = len(steps), len(host)
    after = common.launches(attention)
    # the counters also counted the host stretch's launches
    total = sum(steps) + sum(host)
    m = dict(cfg["model"], **cfg["finetune_flags"])
    w, banks = cfg["world"], cfg["banks"]

    def mix_of(stp):
        return roofline.add(*([roofline.text_mix(m, tr["instr_len"], banks)]
                              * len(stp)),
                            roofline.step_mix(m, sum(stp), w["num_nodes"] + 2,
                                              w["max_cands"] + 38, banks))

    mix = mix_of(steps)
    ctx.launches = {k: after[k] - before[k] for k in after}
    ctx.expected_launches = sum(mix_of(steps + host).values())
    if all(v == ctx.expected_launches for v in ctx.launches.values()):
        H = m["num_attention_heads"]
        ctx.least_s = roofline.launch_least_ms(
            mix, tr["batch_size"], m["hidden_size"], H,
            m["hidden_size"] // H) / 1e3
    k1 = ctx.trace.count_of(lambda n: "attn_fwd_kernel" in n) \
        if ctx.trace else 0
    print(f"traced {len(steps)} + {len(host)} updates ({total} rollout "
          f"steps): launches by the port's counters {ctx.launches}, by the "
          f"rollout steps {ctx.expected_launches}; K1 attention kernels in "
          f"the device trace {k1}, called for {sum(mix.values())}",
          file=sys.stderr)
    return ctx


def reference(R, cfg, tr, seed, inp, dev, init, checked,
              flops=False, tf32=False, follow_logits=None) -> dict:
    """The reference's losses, first gradient, change over the checked
    updates and its judgement of the program's sampled rollouts
    (`action_gap`, and `logit_gap` against the program's fused logits or
    `follow_logits`, one [T, B, G] a checked update), with its own fused
    logits (`logits`); with `flops`, the FLOPs of its first update and of
    its text encoding.  `tf32`: its float32 products in TF32, the control
    of the comparison."""
    from torch.utils.flop_counter import FlopCounterMode
    state, batcher = build(R, cfg, tr, seed, inp, inp["ref_graphs"], dev,
                           fused=True)
    model = state.model
    param_names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    by_id = {it["instr_id"]: it for it in inp["items"]}
    gen = torch.Generator(device=dev)
    ro = state.rollout
    losses, judged, grad1, seen = [], [], None, []
    out = dict(flops_text=None, flops1=None, steps1=None)
    common.full_precision(tf32)
    for i, rec in enumerate(checked):
        gen.manual_seed(world.torch_seed(seed, "step", i))
        batch = batcher.make_batch([by_id[k] for k in rec["ids"]],
                                   gt_cap=rec["cap"])
        ro.follow(rec["actions"], rec["logits"] if follow_logits is None
                  else follow_logits[i])
        if flops and i == 0:
            counter = FlopCounterMode(display=False)
            with counter:
                m = state.step_fn(state, batch, gen)
            out["flops1"] = float(counter.get_total_flops())
            out["steps1"] = int(m["teacher_steps"]) + int(m["sample_steps"])
        else:
            m = state.step_fn(state, batch, gen)
        losses.append(float(m["loss"]))
        judged.append(ro.judged)
        seen.append(torch.stack(ro.seen_logits) if ro.seen_logits else None)
        if i == 0:
            grad1 = first_grads(state)
    ro.follow(None)
    common.full_precision()
    if flops:
        out["flops_text"] = text_flops(state, batcher, by_id, checked[0])
    ref_names = list(leaves(model))
    after = named_copy(model)
    out.update(
        names=ref_names, param_names=param_names, losses=losses,
        logits=seen, judged=judged,
        grad1=[grad1[n] for n in ref_names],
        change=[after[n] - init[n] for n in ref_names],
        **gaps("first", judged[:1]), **gaps("later", judged[1:]))
    del state, batcher, model, ro
    common.free()
    return out


def gaps(which: str, judged) -> Dict[str, float]:
    """The action and logit gaps of the judged steps of some updates."""
    steps = [j for upd in judged for j in upd]
    return {f"{which}_action_gap": max((j[0] for j in steps), default=0.0),
            f"{which}_logit_gap": max((j[1] / max(j[2], 1.0) for j in steps),
                                      default=0.0)}


def text_flops(state, batcher, by_id, rec) -> float:
    """FLOPs of one instruction encoding, forward and backward, on the
    reference at the cell's shapes."""
    from torch.utils.flop_counter import FlopCounterMode
    batch = batcher.make_batch([by_id[k] for k in rec["ids"]],
                               gt_cap=rec["cap"])
    state.model.train()
    counter = FlopCounterMode(display=False)
    with counter:
        txt = state.rollout.encode_text(batch)
        outs = [t for t in _tensors(txt) if t.requires_grad]
        if outs:
            torch.autograd.backward(outs, [torch.ones_like(t) for t in outs])
    state.model.zero_grad(set_to_none=True)
    return float(counter.get_total_flops())


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
