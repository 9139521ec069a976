"""Fine-tuning train step: IL / DAgger over the port's rollouts
(counterpart of vln_goat_tpu/train/trainer.py).

Reference semantics (map_nav_src/r2r/agent.py:422-445,
agent_base.py:154-203):
- 'imitation': one teacher-forced rollout, weight 1;
- 'dagger': the teacher rollout at ml_weight (0.2) plus the on-policy
  sampled rollout at weight 1, both imitation loss only, on the same
  minibatch, sharing one instruction encoding (as the JAX package does);
- 'dagger_fused': the two rollouts of the reference's DAgger step, each on
  a minibatch of its own, as one rollout over both
  (`fuse_dagger_batches`; the rollout's "fused_dagger" feedback): each
  half's summed cross-entropy is divided by its own size, and the loss is
  ml_weight l_t + l_s (the JAX package's trainer.py:195-205);
- the sampled rollouts' feedback `sample_feedback`: "sample", or
  "expl_sample" (the reference's --expl_sample: argmax, but a random move
  with probability 1 - expl_max_ratio);
- loss: summed cross-entropy over steps and episodes divided by B;
- global-norm clip 40, AdamW (optax's update: clip_by_global_norm, then
  adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay), in optax's arithmetic),
  which decays every parameter, including one that got no gradient;
- optionally, as the JAX package's `make_optimizer` orders them
  (MultiSteps(apply_if_finite(chain(clip, adamw)))): the mean of k
  mini-batch gradients taken as one update (`accumulate_steps`, optax's
  MultiSteps) and a guard that skips an update with a non-finite gradient
  (`finite_guard`, optax's apply_if_finite);
- the rollouts' rematerialisation policy `remat` (`ops.remat.POLICIES`;
  "full" by default, as the JAX package's make_train_step).

Data parallelism (`parallel.mesh`): with `TrainState.mesh` set, each rank
runs the step on its rows of the global batch (`mesh.shard_batch`; for
"dagger_fused" `fused_dagger_rank_batch`, the rank's rows of each half),
and the gradients are averaged over the ranks between the backward and the
update (`distributed.all_reduce_grads`), so the guard, the clip, the
accumulation and AdamW see the global batch's gradient and `grad_norm` is
its norm; the metrics are reduced over the ranks before they are returned.
Every loss here is a mean over the rank's episodes, or over each half's,
so with equal rows per rank the mean over ranks is the global loss.

The teacher is the vectorized teacher (`NavRollout.teacher_rollout_vec`,
`vectorized_teacher=True`, the JAX package's default), or the per-step
rollout (`vectorized_teacher=False`); without dropout the two are
loss-identical.  The backward is autograd's through the whole rollout;
the fused attention calls on the card run the backward kernels of
ops/attention.py.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Union

import torch

from ..ops.dropout import set_generator
from ..parallel.distributed import all_reduce_grads, reduce_metrics
from ..parallel.mesh import Mesh, shard_batch
from ..ops.remat import check as check_remat
from ..rollout.rollout import NavRollout, SAMPLE_FEEDBACKS
from ..tools.zdict import SHARED_BANKS
from ..utils.guard import FiniteGuard

TRAIN_ALGS = ("imitation", "dagger", "dagger_fused")


def make_lr_schedule(name: str, lr: float, warmup_steps: int,
                     total_steps: int, lr_end: float = 1e-8
                     ) -> Callable[[int], float]:
    """The reference's --lr_sch options as a function of the update count
    (the JAX package's optax schedules: linear warm-up from 0, then
    'constant_with_warmup', 'linear' to 0, 'polynomial' (power 1) to
    lr_end or 'cosine' to 0 over total_steps - warmup_steps)."""
    if name not in ("constant", "constant_with_warmup", "linear",
                    "polynomial", "cosine"):
        raise ValueError(f"unknown lr_sch {name!r}")
    decay = max(1, total_steps - warmup_steps)

    def tail(n: int) -> float:
        n = min(max(n, 0), decay)
        if name == "linear":
            return lr * (1.0 - n / decay)
        if name == "polynomial":
            return (lr - lr_end) * (1.0 - n / decay) + lr_end
        if name == "cosine":
            return lr * 0.5 * (1.0 + math.cos(math.pi * n / decay))
        return lr

    def sched(count: int) -> float:
        if name == "constant":
            return lr
        if warmup_steps and count < warmup_steps:
            return lr * count / warmup_steps
        return tail(count - warmup_steps)

    return sched


def warmup_cosine_schedule(lr: float, warmup_steps: int, total_steps: int
                           ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup_steps, total_steps,
    end_value=lr * 0.01): linear from 0 to lr over warmup_steps, then a
    cosine from lr to lr * 0.01 over the remaining total_steps -
    warmup_steps updates, and lr * 0.01 after them."""
    decay = total_steps - warmup_steps
    if decay <= 0:
        raise ValueError(f"total_steps {total_steps} must exceed "
                         f"warmup_steps {warmup_steps}")
    alpha = 0.01

    def sched(count: int) -> float:
        if count < warmup_steps:
            return lr * count / warmup_steps
        n = min(count - warmup_steps, decay)
        cos = 0.5 * (1.0 + math.cos(math.pi * n / decay))
        return lr * ((1.0 - alpha) * cos + alpha)

    return sched


class AdamW(torch.optim.Optimizer):
    """optax.adamw(lr, b1, b2, eps, weight_decay) in optax's arithmetic
    order, in the parameters' dtype:

        mu = (1 - b1) g + b1 mu            nu = (1 - b2) g^2 + b2 nu
        u = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)
        p = p + (-lr) (u + weight_decay p)

    torch.optim.AdamW takes the same step in exact arithmetic but applies
    the decay as a separate multiply, which rounds differently: its
    parameters drift from optax's by a unit in the last place per step.

    A parameter without a gradient (`grad` None: detached, as the frozen
    language tower is, or never used, as `front_txt_encoder` is) steps
    with a zero gradient, as optax steps a leaf whose JAX gradient is
    zero: its moments decay and the weight decay shrinks it.
    torch.optim.AdamW would skip it.

    `accumulator` and `guard` (None unless `make_optimizer` asks for them)
    are the accumulation and the finite guard that `apply_update` runs
    before the clip and this step."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.accumulator: Optional[GradAccumulator] = None
        self.guard: Optional[FiniteGuard] = None

    def params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, b1, b2 = group["lr"], group["b1"], group["b2"]
            eps, wd = group["eps"], group["weight_decay"]
            for p in group["params"]:
                st = self.state[p]
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
                p.add_((-lr) * (u + wd * p))


class GradAccumulator:
    """optax.MultiSteps(every_k_schedule=k, use_grad_mean=True) over the
    optimizer's parameters: the running mean acc + (g - acc) / (n + 1) of
    k mini-batch gradients (a missing gradient counts as zero), handed on
    at the k-th.  After it the mean is reset as optax resets it,
    (1 - emit) * acc: a non-finite entry stays non-finite."""

    def __init__(self, params: List[torch.Tensor], k: int):
        if k < 2:
            raise ValueError(f"accumulate_steps {k}: accumulation needs 2 "
                             "or more")
        self.k, self.mini_step = k, 0
        self.acc = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def add(self, params: List[torch.Tensor]) -> bool:
        """Adds the parameters' gradients to the mean; True at the k-th,
        when their .grad now holds the mean of the k and the mean restarts."""
        n = self.mini_step
        for a, p in zip(self.acc, params):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            a.copy_(a + (g - a) / (n + 1))
        self.mini_step = (n + 1) % self.k
        if n != self.k - 1:
            return False
        for a, p in zip(self.acc, params):
            p.grad = a.clone()
            a.mul_(0)
        return True


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 2e-5,
                   weight_decay: float = 0.01,
                   lr_sch: Optional[str] = None, warmup_steps: int = 0,
                   total_steps: Optional[int] = None,
                   accumulate_steps: int = 1, finite_guard: bool = False):
    """(AdamW, LambdaLR): optax's adamw(b1=0.9, b2=0.999, eps=1e-8,
    weight_decay) at the named schedule; without one, at
    `warmup_cosine_schedule` when both warmup_steps and total_steps are
    given, else at the constant `lr` (the JAX package's make_optimizer,
    trainer.py:74-100).  Counted in updates as optax counts them.  The
    global-norm clip is the train step's (`clip_by_global_norm`).
    accumulate_steps > 1: the mean of that many mini-batch gradients makes
    one update (`GradAccumulator`, MultiSteps); finite_guard: an update
    with a non-finite gradient is skipped (`FiniteGuard`,
    apply_if_finite(max_consecutive_errors=10)); `apply_update` runs them
    in the JAX package's order, accumulation, guard, clip, AdamW."""
    opt = AdamW(params, lr=lr, weight_decay=weight_decay)
    if accumulate_steps > 1:
        opt.accumulator = GradAccumulator(opt.params(), accumulate_steps)
    if finite_guard:
        opt.guard = FiniteGuard()
    if lr_sch is not None:
        sched = make_lr_schedule(lr_sch, lr, warmup_steps, total_steps or 1)
    elif warmup_steps and total_steps:
        sched = warmup_cosine_schedule(lr, warmup_steps, total_steps)
    else:
        sched = lambda count: lr  # noqa: E731
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: sched(count) / lr)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: g * (max / |g|) when |g| > max
    (torch's clip_grad_norm_ adds 1e-6 to the norm; optax does not)."""
    if float(norm) > max_norm:
        for g in grads:
            g.copy_((g / norm) * max_norm)


@dataclass
class TrainState:
    """The model, its optimizer and schedule, the update count, the step
    function that advances them (`make_train_step`), its train_alg (whose
    batches `entry.train_steps` draws), the rollout it runs and the
    data-parallel group whose gradients it averages (None: no
    collective)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    grad_clip: float = 40.0
    step: int = 0
    step_fn: Optional[Callable] = field(default=None, repr=False)
    train_alg: str = "dagger"
    rollout: Optional[NavRollout] = field(default=None, repr=False)
    mesh: Optional[Mesh] = None


def apply_update(state: TrainState) -> torch.Tensor:
    """Clip the gradients in `state.model`'s .grad by their global norm,
    take one optimizer and schedule step, count it; returns the norm of
    the gradients before clipping.  With the optimizer's accumulator the
    gradients join the mean, and the update (of the mean, clipped by its
    own norm) comes at every k-th call only; with its guard a non-finite
    update is skipped.  Skipped or not yet due, the parameters, the
    optimizer, the schedule and `state.step` stay as they were."""
    opt = state.optimizer
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    norm = global_norm(grads)
    clip_norm = norm
    if opt.accumulator is not None:
        if not opt.accumulator.add(opt.params()):
            return norm
        grads = [p.grad for p in opt.params()]
        clip_norm = global_norm(grads)
    if opt.guard is not None and not opt.guard.allow(grads):
        return norm
    clip_by_global_norm(grads, state.grad_clip, clip_norm)
    opt.step()
    state.scheduler.step()
    state.step += 1
    return norm


def fuse_dagger_batches(batch_t: Dict[str, torch.Tensor],
                        batch_s: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """One fused-DAgger batch from a teacher minibatch and a sample
    minibatch (the JAX package's trainer.py:226): the episodes of batch_t,
    then those of batch_s, and `is_teacher` marking the first; gt paths of
    length-bucketed halves padded with -1 to the wider cap.  feat_noise is
    the teacher batch's, shared; a causal bank (one bank broadcast over
    the episodes of either half, `tools.zdict.causal_batch`) is broadcast
    over the fused episodes."""
    b_t, b_s = batch_t["scan_idx"].shape[0], batch_s["scan_idx"].shape[0]
    out = {}
    for k, v in batch_t.items():
        if k == "feat_noise" or k not in batch_s:
            out[k] = v
        elif k in SHARED_BANKS:
            out[k] = v[:1].expand(b_t + b_s, *v.shape[1:])
        else:
            a, b = v, batch_s[k]
            if k == "gt_path" and a.shape[1] != b.shape[1]:
                width = max(a.shape[1], b.shape[1])
                a, b = (torch.nn.functional.pad(x, (0, width - x.shape[1]),
                                                value=-1) for x in (a, b))
            out[k] = torch.cat([a, b], dim=0)
    dev = batch_t["scan_idx"].device
    out["is_teacher"] = torch.cat(
        [torch.ones(b_t, dtype=torch.bool, device=dev),
         torch.zeros(b_s, dtype=torch.bool, device=dev)])
    return out


def fused_dagger_rank_batch(batch_t: Dict[str, torch.Tensor],
                            batch_s: Dict[str, torch.Tensor],
                            mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The rank's fused-DAgger batch: its rows of the teacher minibatch,
    then its rows of the sample minibatch (`shard_batch` of each half,
    then `fuse_dagger_batches`), so that every rank holds as many teacher
    and sampled episodes and the mean over ranks of the halves' losses is
    the global batch's.  Without a mesh of two or more, the fused batch."""
    return fuse_dagger_batches(shard_batch(batch_t, mesh),
                               shard_batch(batch_s, mesh))


# the metrics summed over the ranks (counts) and those taken at their
# largest (the decision steps a rollout ran); the others are means
SUMMED_METRICS = ("node_overflow", "node_spilled")
MAX_METRICS = ("teacher_steps", "sample_steps", "fused_steps")


def make_loss_fn(rollout: NavRollout, train_alg: str = "dagger",
                 ml_weight: float = 0.2,
                 teacher_horizon: Union[int, str, None] = None,
                 remat: str = "full", vectorized_teacher: bool = True,
                 sample_feedback: str = "sample",
                 expl_max_ratio: float = 0.6):
    """loss_fn(batch, generator) -> (loss, metrics, outs): the imitation
    loss of `train_alg` (TRAIN_ALGS) and its rollouts' outputs, under the
    rollouts' rematerialisation policy `remat`.  teacher_horizon: None
    keeps the rollout's horizon, an int caps the teacher scan, "auto"
    takes min(gt_path width, horizon) per batch (JAX :150-156): teacher
    episodes end once their gt path is exhausted, so the cap is
    loss-identical while skipping the dead tail.  vectorized_teacher: the
    teacher rollout is `teacher_rollout_vec` (else the per-step one);
    sample_feedback ("sample" or "expl_sample") and expl_max_ratio: the
    sampled rollouts' feedback ("dagger" and the sampled half of
    "dagger_fused")."""
    if train_alg not in TRAIN_ALGS:
        raise ValueError(f"train_alg {train_alg!r}: one of {TRAIN_ALGS}")
    if sample_feedback not in SAMPLE_FEEDBACKS:
        raise ValueError(f"sample_feedback {sample_feedback!r}: one of "
                         f"{SAMPLE_FEEDBACKS}")
    check_remat(remat)
    full = rollout.rcfg.horizon
    sampling = dict(sample_feedback=sample_feedback,
                    expl_max_ratio=expl_max_ratio)

    def teacher(batch, generator, txt=None):
        if vectorized_teacher:
            return rollout.teacher_rollout_vec(
                batch, generator, txt=txt, horizon=teacher_h(batch),
                remat=remat)
        return rollout.train_rollout(batch, "teacher", generator, txt=txt,
                                     horizon=teacher_h(batch), remat=remat)

    def teacher_h(batch) -> int:
        h = teacher_horizon
        if h == "auto":
            h = min(int(batch["gt_path"].shape[1]), full)
        return full if h is None else min(int(h), full)

    def loss_fn(batch, generator: torch.Generator):
        metrics: Dict[str, torch.Tensor] = {}
        outs: Dict[str, dict] = {}
        if train_alg == "imitation":
            out = teacher(batch, generator)
            loss = out["ml_loss"]
            metrics["il_loss"] = out["ml_loss"]
            metrics["node_overflow"] = out["overflow_n"].sum()
            outs["teacher"] = out
        elif train_alg == "dagger_fused":
            out = rollout.train_rollout(batch, "fused_dagger", generator,
                                        remat=remat, **sampling)
            is_t = batch["is_teacher"]
            n_t = is_t.sum().clamp(min=1)
            n_s = (~is_t).sum().clamp(min=1)
            zero = torch.zeros_like(out["loss_per_ep"])
            l_t = torch.where(is_t, out["loss_per_ep"], zero).sum() / n_t
            l_s = torch.where(is_t, zero, out["loss_per_ep"]).sum() / n_s
            loss = ml_weight * l_t + l_s
            metrics["il_loss"] = l_t
            metrics["sample_loss"] = l_s
            metrics["node_overflow"] = out["overflow_n"].sum()
            outs["fused"] = out
        else:
            txt = rollout.encode_text(batch)
            loss = torch.zeros((), device=rollout.device)
            if ml_weight != 0:
                out_t = teacher(batch, generator, txt)
                loss = loss + ml_weight * out_t["ml_loss"]
                metrics["il_loss"] = out_t["ml_loss"]
                outs["teacher"] = out_t
            out_s = rollout.train_rollout(batch, sample_feedback, generator,
                                          txt=txt, remat=remat, **sampling)
            loss = loss + out_s["ml_loss"]
            metrics["sample_loss"] = out_s["ml_loss"]
            metrics["node_overflow"] = out_s["overflow_n"].sum()
            metrics["node_spilled"] = out_s["spilled_n"].sum()
            outs["sample"] = out_s
        return loss, metrics, outs

    return loss_fn


def make_train_step(rollout: NavRollout, train_alg: str = "dagger",
                    ml_weight: float = 0.2,
                    teacher_horizon: Union[int, str, None] = None,
                    remat: str = "full", vectorized_teacher: bool = True,
                    sample_feedback: str = "sample",
                    expl_max_ratio: float = 0.6):
    """train_step(state, batch, generator) -> metrics: one update of
    state.model (for "dagger_fused" on a `fuse_dagger_batches` batch).
    Dropout and the sampled actions draw from `generator` (on the model's
    device).  Metrics: loss, il_loss / sample_loss, grad_norm (before
    clipping), node_overflow, node_spilled, and the decision steps each
    rollout ran (teacher_steps, sample_steps; fused_steps).  keep=True
    returns (metrics, grads, outs) instead, to compare two steps: grads
    {name: gradient before clipping}, outs the rollouts' outputs by name
    ("teacher", "sample", "fused").  `remat`: the rollouts'
    rematerialisation policy (`ops.remat.POLICIES`, "full" by default as
    in the JAX package); vectorized_teacher, sample_feedback, expl_max_ratio: as
    `make_loss_fn`'s.  With `state.mesh` the gradients are averaged over
    the ranks after the backward (before `grads` is kept) and the metrics
    reduced over them (`SUMMED_METRICS` summed, `MAX_METRICS` at their
    largest, the rest averaged)."""
    loss_fn = make_loss_fn(rollout, train_alg, ml_weight, teacher_horizon,
                           remat, vectorized_teacher, sample_feedback,
                           expl_max_ratio)

    def train_step(state: TrainState, batch, generator: torch.Generator,
                   keep: bool = False):
        model = state.model
        model.train()
        set_generator(model, generator)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics, outs = loss_fn(batch, generator)
        loss.backward()
        if state.mesh is not None:
            all_reduce_grads(state.optimizer.params())
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None} if keep else None
        norm = apply_update(state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        for name, out in outs.items():
            metrics[f"{name}_steps"] = out["steps"]
        if state.mesh is not None:
            metrics = reduce_metrics(metrics, SUMMED_METRICS, MAX_METRICS)
        metrics["grad_norm"] = norm.detach()
        return (metrics, grads, outs) if keep else metrics

    return train_step


def init_train_state(model: torch.nn.Module, rollout: NavRollout,
                     lr: float = 2e-5, weight_decay: float = 0.01,
                     grad_clip: float = 40.0, train_alg: str = "dagger",
                     ml_weight: float = 0.2,
                     teacher_horizon: Union[int, str, None] = None,
                     remat: str = "full", accumulate_steps: int = 1,
                     finite_guard: bool = False,
                     vectorized_teacher: bool = True,
                     sample_feedback: str = "sample",
                     expl_max_ratio: float = 0.6,
                     mesh: Optional[Mesh] = None, **sched) -> TrainState:
    """TrainState of `model` with AdamW (make_optimizer, with its
    accumulation and finite guard) and the step function of `train_alg`
    over `rollout` under the rematerialisation policy `remat`, with
    `make_train_step`'s teacher and sampling options; `mesh`: the
    data-parallel group whose gradients each step averages."""
    opt, scheduler = make_optimizer(
        [p for p in model.parameters() if p.requires_grad], lr,
        weight_decay, accumulate_steps=accumulate_steps,
        finite_guard=finite_guard, **sched)
    return TrainState(model, opt, scheduler, grad_clip, 0,
                      make_train_step(rollout, train_alg, ml_weight,
                                      teacher_horizon, remat,
                                      vectorized_teacher, sample_feedback,
                                      expl_max_ratio), train_alg, rollout,
                      mesh)
