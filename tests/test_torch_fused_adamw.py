"""The fused AdamW (`ops.optim`) on the CPU, where it computes its plain
version `clip_adamw_plain`, against the loops it replaced, bit for bit,
over several updates:

- the fine-tune update (`trainer.apply_update`, `AdamW.step`) against the
  loop it had (global norm, clip in place, AdamW leaf by leaf; kept below
  as `old_finetune_update`), with a parameter without a gradient, the
  weight decay, and the clip engaged on some updates or on none; with the
  finite guard too;
- the pretraining chains that take it (`PretrainState.apply`,
  `optimizers.apply_updates`: adamw with its decay mask and adam, after
  the global-norm clip, and the speaker's Adam without it) against the
  chain's own loop (`Transform.update`, then p + u), on a module with
  packed attention (in_proj: three leaves each), unused leaves and the
  clip engaged on some updates or on none;
- the other chains (adamax, radam, ralamb, rangerlars) keep their loops;
- the state the benchmark and the checkpoint read: `find_first_moment`
  and `last_grads` (pretraining), `first_grads` (fine-tuning), and a
  train-state checkpoint round trip;
- CPU tensors never launch a kernel nor open the span `fused_adamw`;
- the kernels' table (`optim.table_rows`): each leaf's items, flags and
  pointers, and the kernels' walks over the items, which cover every
  element of every leaf once (the norm's: of every leaf with a
  gradient).
"""
import numpy as np
import pytest
import torch
from torch import nn

from perfbench.jobs import common as bench_common
from perfbench.jobs import finetune as bench_finetune
from perfbench.jobs import pretrain as bench_pretrain
from vln_goat_tpu_torch.config import PretrainConfig
from vln_goat_tpu_torch.models.layers import TorchMultiheadAttention
from vln_goat_tpu_torch.ops import optim
from vln_goat_tpu_torch.pretrain import optimizers as O
from vln_goat_tpu_torch.pretrain.train import (PretrainState,
                                               make_pretrain_optimizer)
from vln_goat_tpu_torch.train import trainer as T
from vln_goat_tpu_torch.train.checkpoint import (load_train_state,
                                                 save_train_state)
from vln_goat_tpu_torch.utils.logger import records, span

STEPS = 5


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.lin = nn.Linear(6, 5)
        self.LayerNorm = nn.LayerNorm(5)
        self.self_attn = TorchMultiheadAttention(4, 2, 2)
        self.raw = nn.Parameter(torch.empty(4, 1))
        self.unused = nn.Linear(3, 2)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))


def grads_at(model, step):
    """Seeded gradients of every parameter but `unused` (None); every
    other step a hundredth as large, under the clip's 2.0."""
    r = np.random.default_rng(step)
    scale = 0.01 if step % 2 else 1.0
    return {n: None if n.startswith("unused") else
            (scale * r.standard_normal(tuple(p.shape))).astype(np.float32)
            for n, p in model.named_parameters()}


def set_grads(model, g):
    for n, p in model.named_parameters():
        p.grad = None if g[n] is None else torch.from_numpy(g[n].copy())


def old_finetune_update(params, state, lr, wd, max_norm, b1=0.9, b2=0.999,
                        eps=1e-8):
    """The fine-tune update as it was before the fused AdamW: the global
    norm, the clip of the gradients in place, then AdamW leaf by leaf."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    if norm.item() > max_norm:
        for g in grads:
            g.copy_((g / norm) * max_norm)
    for p in params:
        st = state.setdefault(p, {})
        if not st:
            st["step"] = 0
            st["mu"] = torch.zeros_like(p)
            st["nu"] = torch.zeros_like(p)
        st["step"] += 1
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        st["mu"] = (1 - b1) * g + b1 * st["mu"]
        st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
        one = torch.ones((), dtype=p.dtype, device=p.device)
        bc1 = one - (one * b1) ** st["step"]
        bc2 = one - (one * b2) ** st["step"]
        u = (st["mu"] / bc1) / (torch.sqrt(st["nu"] / bc2) + eps)
        with torch.no_grad():
            p.add_((-lr) * (u + wd * p))
    return norm


def finetune_state(model, max_norm, **kw):
    opt, sched = T.make_optimizer(list(model.parameters()), lr=1e-2,
                                  weight_decay=0.1, **kw)
    return T.TrainState(model, opt, sched, max_norm)


@pytest.mark.parametrize("max_norm,guard", [(2.0, False), (1e3, False),
                                            (2.0, True)])
def test_finetune_equals_old_loop(max_norm, guard):
    net, ref = Net(), Net()
    state = finetune_state(net, max_norm, finite_guard=guard)
    ref_params, ref_state = list(ref.parameters()), {}
    engaged = []
    for step in range(STEPS):
        g = grads_at(net, step)
        set_grads(net, g)
        set_grads(ref, g)
        lr = state.optimizer.param_groups[0]["lr"]
        norm = T.apply_update(state)
        want = old_finetune_update(ref_params, ref_state, lr, 0.1, max_norm)
        engaged.append(want.item() > max_norm)
        assert torch.equal(norm, want), step
        for p, q in zip(net.parameters(), ref_params):
            st, rs = state.optimizer.state[p], ref_state[q]
            assert torch.equal(p, q), step
            assert torch.equal(st["mu"], rs["mu"]), step
            assert torch.equal(st["nu"], rs["nu"]), step
            assert st["step"] == rs["step"] == step + 1
    assert engaged == ([True, False] * 3)[:STEPS] if max_norm == 2.0 \
        else not any(engaged)
    assert state.step == STEPS


def loop_apply(state: PretrainState) -> None:
    """PretrainState.apply as it was: the chain's own loop."""
    params = state.params()
    updates, state.opt_state = state.tx.update(state.grads(),
                                               state.opt_state, params)
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)
    state.step += 1


def pretrain_state(model, optim_name, grad_norm=2.0):
    cfg = PretrainConfig(learning_rate=1e-2, warmup_steps=2,
                         num_train_steps=10, grad_norm=grad_norm,
                         optim=optim_name, weight_decay=0.1)
    return PretrainState(model, make_pretrain_optimizer(cfg, model))


def assert_same_state(a, b):
    fa = O._flat_states(a.tx, a.opt_state)
    fb = O._flat_states(b.tx, b.opt_state)
    for x, y in zip(fa, fb):
        if isinstance(x, dict):
            assert x["count"] == y["count"]
            for k in ("mu", "nu"):
                assert all(torch.equal(s, t) for s, t in zip(x[k], y[k]))
        else:
            assert x == y


@pytest.mark.parametrize("optim_name,grad_norm", [
    ("adamw", 2.0), ("adamw", 1e3), ("adam", 2.0)])
def test_pretrain_equals_chain_loop(optim_name, grad_norm):
    net, ref = Net(), Net()
    state = pretrain_state(net, optim_name, grad_norm)
    rstate = pretrain_state(ref, optim_name, grad_norm)
    assert O.fused_parts(state.tx) is not None
    assert len(state.leaves) == 15            # in_proj: three leaves each
    for step in range(STEPS):
        g = grads_at(net, step)
        set_grads(net, g)
        set_grads(ref, g)
        state.apply(state.leaf_grads())
        loop_apply(rstate)
        for p, q in zip(net.parameters(), ref.parameters()):
            assert torch.equal(p, q), (step, p.shape)
        assert_same_state(state, rstate)
    assert state.step == STEPS


def test_speaker_adam_equals_chain_loop():
    """The speaker's Adam (no clip, no decay) through `apply_updates`."""
    net, ref = Net(), Net()
    tx = O.chain(O.scale_by_adam(), O.scale_by_learning_rate(lambda n: 1e-2))
    assert O.fused_parts(tx) is not None
    params = [p.detach() for p in net.parameters()]
    rparams = [p.detach() for p in ref.parameters()]
    st, rst = tx.init(params), tx.init(rparams)
    for step in range(STEPS):
        g = grads_at(net, step)
        grads = [None if v is None else torch.from_numpy(v)
                 for v in g.values()]
        st = O.apply_updates(tx, st, params, grads)
        updates, rst = tx.update([torch.zeros_like(p) if v is None else v
                                  for p, v in zip(rparams, grads)],
                                 rst, rparams)
        for p, u in zip(rparams, updates):
            p.add_(u)
        assert all(torch.equal(p, q) for p, q in zip(params, rparams))
        assert st[0]["count"] == rst[0]["count"] and st[1] == rst[1]


@pytest.mark.parametrize("optim_name", ["adamax", "radam", "ralamb",
                                        "rangerlars"])
def test_other_chains_keep_their_loops(optim_name, monkeypatch):
    net, ref = Net(), Net()
    state = pretrain_state(net, optim_name)
    rstate = pretrain_state(ref, optim_name)
    assert O.fused_parts(state.tx) is None

    def fail(*a, **k):
        raise AssertionError("a loop chain took the fused update")

    monkeypatch.setattr(optim, "clip_adamw_", fail)
    for step in range(3):
        g = grads_at(net, step)
        set_grads(net, g)
        set_grads(ref, g)
        state.apply(state.leaf_grads())
        loop_apply(rstate)
        for p, q in zip(net.parameters(), ref.parameters()):
            assert torch.equal(p, q), (step, p.shape)


def test_pretrain_first_moment_read_back():
    """perfbench's pretrain job finds `mu` in the state and recovers each
    update's (unclipped) gradient from it."""
    net = Net()
    state = pretrain_state(net, "adamw", grad_norm=1e3)
    mu_before = None
    for step in range(2):
        g = grads_at(net, step)
        set_grads(net, g)
        want = [None if v is None else v.clone() for v in state.leaf_grads()]
        state.apply(state.leaf_grads())
        mu = bench_common.find_first_moment(state.opt_state)
        assert len(mu) == len(state.leaves)
        got = bench_pretrain.last_grads(mu, mu_before, 0.9)
        for x, w in zip(got, want):
            torch.testing.assert_close(
                x, torch.zeros_like(x) if w is None else w,
                rtol=1e-5, atol=1e-6)
        mu_before = [t.clone() for t in mu]


def test_finetune_first_grads_read_back():
    net = Net()
    state = finetune_state(net, 1e3)
    g = grads_at(net, 0)
    set_grads(net, g)
    T.apply_update(state)
    got = bench_finetune.first_grads(state)
    for n, p in net.named_parameters():
        want = torch.zeros(p.shape) if g[n] is None else \
            torch.from_numpy(g[n])
        torch.testing.assert_close(got[n], want, rtol=1e-5, atol=1e-6)


def test_train_state_checkpoint_round_trip(tmp_path):
    net = Net()
    state = finetune_state(net, 2.0)
    for step in range(2):
        set_grads(net, grads_at(net, step))
        T.apply_update(state)
    save_train_state(str(tmp_path / "ckpt"), state, torch.Generator(), 2)
    other = finetune_state(Net(), 2.0)
    assert load_train_state(str(tmp_path / "ckpt"), other) == 2
    for step in range(2, 4):
        for s in (state, other):
            set_grads(s.model, grads_at(s.model, step))
            T.apply_update(s)
    for p, q in zip(net.parameters(), other.model.parameters()):
        assert torch.equal(p, q)
        for k in ("mu", "nu"):
            assert torch.equal(state.optimizer.state[p][k],
                               other.optimizer.state[q][k])


def test_cpu_takes_the_plain_version():
    before = dict(optim.launches)
    net = Net()
    state = finetune_state(net, 2.0)
    pstate = pretrain_state(Net(), "adamw")
    records().clear()
    for _ in range(2):
        with span("update"):
            set_grads(net, grads_at(net, 0))
            with span("optimizer"):
                T.apply_update(state)
        with span("update"):
            set_grads(pstate.model, grads_at(pstate.model, 0))
            with span("optimizer"):
                pstate.apply(pstate.leaf_grads())
    assert optim.launches == before
    assert len(records()) == 4
    for rec in records():
        assert "update/optimizer/fused_adamw" not in rec
        assert rec["update/optimizer/read"][1] == 1      # the clip's


def test_table_rows_and_the_kernels_walk(monkeypatch):
    """The table of two groups (float32 leaves with and without a
    gradient, float64 leaves), and the kernels' walk: item i lies in the
    last leaf whose first item is at or below it, `CHUNK` elements from
    (i - first) * CHUNK; every element of every leaf is taken once."""
    monkeypatch.setattr(optim, "_check", lambda *a: None)
    sizes = [(3, 5), (optim.CHUNK + 4,), (0,), (2 * optim.CHUNK,), (7,)]
    ps = [torch.zeros(s) for s in sizes]
    gs = [torch.zeros(s) if i != 1 else None for i, s in enumerate(sizes)]
    ds = [torch.zeros(4, dtype=torch.float64)]
    groups = [optim.Group(ps, gs, [torch.zeros(s) for s in sizes],
                          [torch.zeros(s) for s in sizes], 0.9, 0.999, 1e-8,
                          0.01, -1e-3, 0.1, 0.001,
                          [True, False, True, False, True]),
              optim.Group(ds, [None], [torch.zeros(4, dtype=torch.float64)],
                          [torch.zeros(4, dtype=torch.float64)], 0.9, 0.999,
                          1e-8, 0.0, -1e-3, 0.1, 0.001)]
    rows, spans, gitems = optim.table_rows(groups)
    tab = np.asarray(rows, np.int64).reshape(-1, optim.COLS)
    assert spans == [(0, 5, 0, 1 + 2 + 0 + 2 + 1), (5, 6, 6, 7)]
    assert list(tab[:, 4]) == [15, optim.CHUNK + 4, 0, 2 * optim.CHUNK, 7, 4]
    assert list(tab[:, 5]) == [0, 1, 3, 3, 5, 6]
    assert list(tab[:, 6]) == [1, 0, 1, 0, 1, optim.DECAY | optim.F64]
    # the norm's items: the leaves with a gradient only
    assert list(tab[:, 7]) == [0, 1, 1, 1, 3, 4] and gitems == 4
    assert tab[1, 1] == 0 and tab[5, 1] == 0
    assert tab[0, 0] == ps[0].data_ptr() and tab[3, 2] == \
        groups[0].mus[3].data_ptr()
    for l0, l1, w0, w1 in spans:
        seen = {}
        for it in range(w0, w1):
            leaf = max(i for i in range(l0, l1) if tab[i, 5] <= it)
            start = (it - tab[leaf, 5]) * optim.CHUNK
            n = min(optim.CHUNK, tab[leaf, 4] - start)
            assert n > 0
            seen.setdefault(leaf, []).append((start, n))
        for leaf in range(l0, l1):
            cover = sum(n for _, n in seen.get(leaf, []))
            assert cover == tab[leaf, 4]
    # the norm's walk: gradient item i in the last leaf whose first
    # gradient item is at or below it, always one with a gradient
    cover = {}
    for it in range(gitems):
        leaf = max(i for i in range(len(tab)) if tab[i, 7] <= it)
        assert tab[leaf, 1] != 0
        start = (it - tab[leaf, 7]) * optim.CHUNK
        cover[leaf] = cover.get(leaf, 0) + min(optim.CHUNK,
                                               tab[leaf, 4] - start)
    assert cover == {i: tab[i, 4] for i in range(len(tab))
                     if tab[i, 1] != 0 and tab[i, 4]}
