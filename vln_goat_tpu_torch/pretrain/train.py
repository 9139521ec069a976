"""Pre-training loop pieces of the port (counterpart of
vln_goat_tpu/pretrain/train.py): the seeded multi-task sampler, the
learning-rate schedule, the optimizer chain, one train and one eval step
per task, and the state they advance.

- `MetaTaskSampler.task_at(step)` draws from np.random.default_rng((seed,
  step)) exactly as the JAX package does, so both packages pick the same
  task at every step.
- `get_lr_schedule`: linear warm-up, then linear decay with a 1e-8 floor,
  read at optax's update count (0 for the first update, which therefore
  takes 1e-8 when there is a warm-up), in float32.
- `make_pretrain_optimizer`: the global-norm clip, then the optimizer of
  `PretrainConfig.optim` (`optimizers.build_optimizer`), whose decay mask
  spares the leaves the JAX package names `bias` and `scale`: every bias
  and every LayerNorm parameter, found by the module type (a LayerNorm's
  scale is `weight` in torch, as a Linear's kernel is).
- The train step's dropout draws come from an explicit torch.Generator,
  `step_generator(seed, step)`, in place of the JAX package's
  PRNGKey(step); on a rank other than 0 of a process group the rank is
  folded in, so that the ranks draw different masks.
- Data parallelism: the steps of a `mesh` average the gradients over its
  ranks between the backward and the update (`distributed.all_reduce_grads`)
  and the metrics before they are returned.  Where each rank runs its
  rows of the batch, the model's own `mesh` makes each loss the rank's
  share of the global one (`pretrain.model`); where every rank runs the
  whole batch (one that does not divide), the model has none.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import PretrainConfig
from ..ops.dropout import set_generator
from ..parallel.distributed import (all_reduce_grads, process_index,
                                    reduce_metrics)
from .optimizers import Transform, build_optimizer, chain, clip_by_global_norm


class MetaTaskSampler:
    """Seeded multinomial task choice per step (the reference MetaLoader's
    broadcast choice, the same on every process)."""

    def __init__(self, tasks: Sequence[str], mix_ratio: Sequence[int],
                 seed: int = 0):
        self.tasks = list(tasks)
        p = np.asarray(mix_ratio, np.float64)
        self.p = p / p.sum()
        self.seed = seed

    def task_at(self, step: int) -> str:
        rng = np.random.default_rng((self.seed, step))
        return self.tasks[rng.choice(len(self.tasks), p=self.p)]


def get_lr_schedule(lr: float, warmup_steps: int, total_steps: int
                    ) -> Callable[[int], np.float32]:
    """Linear warm-up then linear decay with a 1e-8 floor
    (optim/sched.py:24-30), as a float32 function of the update count."""
    f32 = np.float32

    def fn(step: int) -> np.float32:
        if step < warmup_steps:
            out = f32(lr) * f32(min(step, warmup_steps)) \
                / f32(max(warmup_steps, 1))
        else:
            out = f32(lr) * f32(total_steps - step) \
                / f32(max(total_steps - warmup_steps, 1))
        return max(out, f32(1e-8))

    return fn


@dataclass
class Leaf:
    """One leaf of the JAX package's parameter tree: a parameter, or one of
    the q / k / v row blocks of a packed `in_proj_weight` / `in_proj_bias`
    (the JAX tree keeps them apart, and per-leaf norms see them apart);
    `decay`: False for the leaves the JAX package names `bias` or
    `scale`."""

    param: torch.Tensor
    rows: Optional[slice]
    decay: bool

    def view(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.rows is None else t[self.rows]


def jax_leaves(model: nn.Module) -> List[Leaf]:
    """`model`'s parameters as the JAX package's leaves, with the decay
    mask of its make_pretrain_optimizer: every bias (Linear, attention,
    the MLM head's) and every LayerNorm parameter spared."""
    out = []
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            decay = not (isinstance(mod, nn.LayerNorm)
                         or name in ("bias", "in_proj_bias"))
            if name in ("in_proj_weight", "in_proj_bias"):
                d = p.shape[0] // 3
                out += [Leaf(p, slice(i * d, (i + 1) * d), decay)
                        for i in range(3)]
            else:
                out.append(Leaf(p, None, decay))
    return out


def make_pretrain_optimizer(cfg: PretrainConfig, model: nn.Module
                            ) -> Transform:
    """clip_by_global_norm(grad_norm), then `cfg.optim` at the schedule
    (betas, eps 1e-8, weight_decay, the decay mask of `model`'s
    `jax_leaves`, the order the optimizer takes them in)."""
    sched = get_lr_schedule(cfg.learning_rate, cfg.warmup_steps,
                            cfg.num_train_steps)
    return chain(clip_by_global_norm(cfg.grad_norm),
                 build_optimizer(cfg.optim, sched, b1=cfg.betas[0],
                                 b2=cfg.betas[1], eps=1e-8,
                                 weight_decay=cfg.weight_decay,
                                 decay_mask=[leaf.decay for leaf in
                                             jax_leaves(model)]))


@dataclass
class PretrainState:
    """The model, the optimizer chain over its `jax_leaves` and its state,
    and the number of updates taken."""

    model: nn.Module
    tx: Transform
    opt_state: Any = None
    step: int = 0
    leaves: List[Leaf] = field(default_factory=list, repr=False)

    def __post_init__(self):
        self.leaves = jax_leaves(self.model)
        if self.opt_state is None:
            self.opt_state = self.tx.init(self.params())

    def params(self) -> List[torch.Tensor]:
        """The leaves' current values (views of the parameters)."""
        return [leaf.view(leaf.param.detach()) for leaf in self.leaves]

    def grads(self) -> List[torch.Tensor]:
        """The leaves' gradients, zero where a parameter has none (a task
        that leaves it unused: JAX's gradient there is zero)."""
        return [torch.zeros_like(leaf.view(leaf.param))
                if leaf.param.grad is None else leaf.view(leaf.param.grad)
                for leaf in self.leaves]

    @torch.no_grad()
    def apply(self, grads: List[torch.Tensor]) -> None:
        """One optimizer update from the leaves' gradients, added to the
        parameters in place (optax.apply_updates)."""
        params = self.params()
        updates, self.opt_state = self.tx.update(grads, self.opt_state,
                                                 params)
        for p, u in zip(params, updates):
            p.add_(u)
        self.step += 1


def step_generator(seed: int, step: int, device,
                   rank: Optional[int] = None) -> torch.Generator:
    """The dropout generator of train step `step` of a run seeded `seed`
    on rank `rank` (this process's by default): (seed, step) on rank 0,
    (seed, step, rank) on the others."""
    rank = process_index() if rank is None else rank
    key = (seed, step) if rank == 0 else (seed, step, rank)
    s = int(np.random.SeedSequence(key).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def make_pretrain_steps(model: nn.Module, tasks: Sequence[str],
                        mesh=None) -> Dict[str, Callable]:
    """{task: step(state, batch, generator, keep=False) -> metrics}: one
    update of state's model on `task`'s loss (dropout on, drawn from
    `generator`), gradients zero where a task leaves a parameter unused,
    as JAX's are.  keep=True returns (metrics, {name: gradient before the
    clip} of the parameters that got one).  With `mesh` (a
    `parallel.mesh.Mesh`), the gradients are averaged over its ranks before
    they are kept and applied and the metrics averaged over them."""
    params = [p for p in model.parameters() if p.requires_grad]

    def make(task):
        def step_fn(state: PretrainState, batch, generator, keep=False):
            model.train()
            set_generator(model, generator)
            model.zero_grad(set_to_none=True)
            loss, metrics = model(batch, task)
            loss.backward()
            if mesh is not None:
                all_reduce_grads(params)
            kept = {n: p.grad.clone() for n, p in model.named_parameters()
                    if p.grad is not None} if keep else None
            state.apply(state.grads())
            model.zero_grad(set_to_none=True)
            out = {k: v.detach() for k, v in metrics.items()}
            out["loss"] = loss.detach()
            if mesh is not None:
                out = reduce_metrics(out)
            return (out, kept) if keep else out

        return step_fn

    return {t: make(t) for t in tasks}


def make_eval_steps(model: nn.Module, tasks: Sequence[str],
                    mesh=None) -> Dict[str, Callable]:
    """{task: eval(batch) -> metrics with "loss"}, dropout off; with
    `mesh`, averaged over its ranks."""
    def make(task):
        @torch.no_grad()
        def eval_fn(batch):
            model.eval()
            loss, metrics = model(batch, task)
            out = dict(metrics)
            out["loss"] = loss
            if mesh is not None:
                out = reduce_metrics(out)
            return out

        return eval_fn

    return {t: make(t) for t in tasks}
