"""The port's pretraining optimizers, schedule and task sampler against
the JAX package's (optax):

- every variant of `build_optimizer` (adam, adamax, adamw with its decay
  mask, radam, ralamb, rangerlars) inside `make_pretrain_optimizer` (the
  global-norm clip first) for 7 updates, past one lookahead sync (k 6)
  and RAdam's rectification threshold (b2 0.98 crosses it at update 6),
  on a module with Linear, LayerNorm, embedding, packed attention
  (in_proj: three JAX leaves), raw and unused (zero-gradient) leaves,
  from the same gradients: the parameters within 1e-6 of their largest
  magnitude after each update;
- the schedule at 0, 1, warm-up - 1, warm-up, warm-up + 1, the total and
  the total + 5, as float32 values, exactly;
- the sampler's first 200 tasks."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from torch import nn

from vln_goat_tpu.config import PretrainConfig as JaxPretrainConfig
from vln_goat_tpu.pretrain.train import MetaTaskSampler as JaxSampler
from vln_goat_tpu.pretrain.train import get_lr_schedule as jax_schedule
from vln_goat_tpu.pretrain.train import \
    make_pretrain_optimizer as jax_optimizer
from vln_goat_tpu.train.checkpoint import torch_to_flax
from vln_goat_tpu_torch.config import PretrainConfig
from vln_goat_tpu_torch.models.layers import TorchMultiheadAttention
from vln_goat_tpu_torch.pretrain.optimizers import OPTIMIZERS
from vln_goat_tpu_torch.pretrain.train import (MetaTaskSampler,
                                               PretrainState, get_lr_schedule,
                                               jax_leaves,
                                               make_pretrain_optimizer)
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax

STEPS = 7


class Leaves(nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.lin = nn.Linear(5, 4)
        self.LayerNorm = nn.LayerNorm(4)
        self.word_embeddings = nn.Embedding(7, 4)
        self.self_attn = TorchMultiheadAttention(4, 2, 2)
        self.tim_txt_attn = nn.Parameter(torch.empty(4, 1))
        self.unused = nn.Linear(3, 2)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))


def grads_at(model, step):
    """Seeded gradients of every parameter but `unused` (None); every
    other step small enough to pass the clip unscaled."""
    r = np.random.default_rng(step)
    scale = 0.05 if step % 2 else 1.0
    return {n: None if n.startswith("unused") else
            (scale * r.standard_normal(tuple(p.shape))).astype(np.float32)
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("optim", OPTIMIZERS)
def test_optimizer_matches_optax(optim):
    kw = dict(learning_rate=1e-2, warmup_steps=2, num_train_steps=10,
              grad_norm=1.0, optim=optim)
    model = Leaves()
    state = PretrainState(model, make_pretrain_optimizer(
        PretrainConfig(**kw), model))
    params = torch_to_flax({k: v.detach().numpy()
                            for k, v in model.state_dict().items()})["params"]
    tx = jax_optimizer(JaxPretrainConfig(**kw))
    opt_state = tx.init(params)
    for step in range(STEPS):
        g = grads_at(model, step)
        jg = torch_to_flax({k: np.zeros(tuple(model.get_parameter(k).shape),
                                        np.float32) if v is None else v
                            for k, v in g.items()})["params"]
        updates, opt_state = tx.update(jg, opt_state, params)
        params = optax.apply_updates(params, updates)
        for n, p in model.named_parameters():
            p.grad = None if g[n] is None else torch.from_numpy(g[n])
        state.apply(state.grads())
        ref = params_from_flax(flatten(jax.device_get(params)))
        for n, p in model.named_parameters():
            scale = float(ref[n].abs().max())
            err = float((p.detach() - ref[n]).abs().max())
            assert err <= 1e-6 * scale, (optim, step, n, err, scale)
    assert state.step == STEPS


def test_leaves_and_decay_mask():
    leaves = jax_leaves(Leaves())
    # in_proj_weight and in_proj_bias as three leaves each
    assert len(leaves) == 16
    decayed = [tuple(leaf.view(leaf.param).shape) for leaf in leaves
               if leaf.decay]
    # kernels (lin, q / k / v, out_proj, unused), the embedding and the
    # raw pooling vector; every bias and the LayerNorm spared
    assert sorted(decayed) == sorted([(4, 5), (4, 4), (4, 4), (4, 4), (4, 4),
                                      (2, 3), (7, 4), (4, 1)])


@pytest.mark.parametrize("warmup,total", [(10, 30), (0, 8), (1, 1)])
def test_schedule_matches_jax(warmup, total):
    ours = get_lr_schedule(5e-5, warmup, total)
    ref = jax_schedule(5e-5, warmup, total)
    for step in sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1, total,
                        total + 5}):
        got = ours(step)
        want = np.asarray(ref(jnp.asarray(step, jnp.int32)))
        assert got.dtype == np.float32 and want.dtype == np.float32
        assert got == want, (step, got, want)
    if warmup:
        assert ours(0) == np.float32(1e-8)


@pytest.mark.parametrize("seed,ratio", [(0, (1, 1, 1)), (3, (2, 1, 1, 3))])
def test_sampler_matches_jax(seed, ratio):
    tasks = ("mlm", "sap", "cfp", "mrc")[:len(ratio)]
    ours = MetaTaskSampler(tasks, ratio, seed=seed)
    ref = JaxSampler(tasks, ratio, seed=seed)
    seq = [ours.task_at(s) for s in range(200)]
    assert seq == [ref.task_at(s) for s in range(200)]
    assert set(seq) == set(tasks)
