"""The numbers that decide `correct` in a training cell.

Set-up drives the program's first updates through the window's own step
call and feed; after the window the plain reference follows them from the
same weights, batches and dropout generators.  A leaf's gradient or change
is compared by its norm: the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger (some gradients are all but zero); the worst leaf
counts.  Leaves whose reference gradient is under a thousandth of the
median leaf's, of those the update trains (zero for the frozen language tower or for a task's head in
another task's update, round-off for a bias under a softmax) move by the
decay and round-off alone and are left out.

Fine-tuning (`training_numbers`), over its first three updates:
- `first_loss_gap`: the relative gap of the first update's loss.  The
  later updates start from weights that differ already: AdamW moves every
  element whose gradient is at the round-off level by about its rate, in
  the direction of that round-off, so their losses and logits differ by
  what those moves make of it (1e-3 to 1e-2 of the logits after one
  update, 1e-2 after two, on the card), not by the update's own error;
  their gaps are kept apart as `later_loss_gap` and not compared;
- `grad_gap`: the first gradient as the optimizer got it (its first moment
  after one update over 1 - b1);
- `update_gap`: each leaf's change over the three updates;
- also `first_logit_gap`, the largest distance of the program's fused
  logits from the reference's over the first update's sampled rollout's
  active episodes, over the largest reference logit (at least 1), and
  `first_action_gap`, how far the score of an action the program sampled
  there lies below the best score the reference gives the same draw (the
  later updates' are kept apart, as their losses are).

Pretraining (`pretrain_numbers`), over the first updates until every task
has had one: the reference takes each update from the program's weights
before it, with a fresh optimizer state, so that each task's loss and
gradient through its head is compared at the same weights:
- `loss_gap`: the worst relative gap of the updates' losses;
- `grad_gap`: the worst leaf of any update's gradient as the optimizer got
  it (the program's from its first moment before and after the update,
  the reference's from its fresh state's after it);
- `update_gap`: each leaf's change over the first three updates, the
  reference following them from the first weights on its own.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

SMALL_LEAF = 1e-3


def norms(ts: Sequence[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in ts]


def median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def kept_leaves(ref_grad_norms: Sequence[float]) -> List[int]:
    """Leaves whose reference gradient is at least SMALL_LEAF of the
    median leaf's, the median taken over the leaves the update trains
    (those with a gradient that is not zero)."""
    trained = [n for n in ref_grad_norms if n > 0]
    if not trained:
        return []
    med = median(trained)
    return [i for i, n in enumerate(ref_grad_norms) if n >= SMALL_LEAF * med]


def leaf_gap(prog: Sequence[float], ref: Sequence[float],
             keep: Sequence[int]) -> float:
    """Worst leaf's |prog norm - ref norm| / max(ref norm, median ref
    norm) over the kept leaves."""
    if not keep:
        return math.inf
    med = median([ref[i] for i in keep])
    gaps = [abs(prog[i] - ref[i]) / max(ref[i], med) for i in keep]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    out = 0.0
    for a, b in zip(prog, ref):
        g = abs(a - b) / max(abs(b), 1e-12)
        out = max(out, g if math.isfinite(g) else math.inf)
    return out


def grad_gap(prog: Sequence[Sequence[torch.Tensor]],
             ref: Sequence[Sequence[torch.Tensor]]) -> float:
    """Worst leaf over the compared updates' gradients (one leaf list an
    update on each side), each update's leaves kept by its reference
    gradient.  Where that is zero throughout (a task with nothing to learn
    from its batch), the program's has to be zero too: 0, else 1."""
    out = 0.0
    for p, r in zip(prog, ref):
        rn, pn = norms(r), norms(p)
        keep = kept_leaves(rn)
        gap = leaf_gap(pn, rn, keep) if keep else float(any(pn))
        out = max(out, gap)
    return out


def update_gap(prog_change: Sequence[torch.Tensor],
               ref_change: Sequence[torch.Tensor],
               ref_grads: Sequence[Sequence[torch.Tensor]]) -> float:
    """Worst leaf of the change, over the leaves that any of `ref_grads`
    (the updates the change spans) keeps."""
    keep = sorted({i for g in ref_grads for i in kept_leaves(norms(g))})
    return leaf_gap(norms(prog_change), norms(ref_change), keep)


def training_numbers(prog: Dict[str, list], ref: Dict[str, list]
                     ) -> Dict[str, float]:
    """first_loss_gap, later_loss_gap, grad_gap, update_gap from each
    side's `losses`, `grad1` (leaf tensors) and `change` (leaf
    tensors)."""
    return dict(
        first_loss_gap=loss_gap(prog["losses"][:1], ref["losses"][:1]),
        later_loss_gap=loss_gap(prog["losses"][1:], ref["losses"][1:]),
        grad_gap=grad_gap([prog["grad1"]], [ref["grad1"]]),
        update_gap=update_gap(prog["change"], ref["change"],
                              [ref["grad1"]]))


def pretrain_numbers(prog: Dict[str, list], ref: Dict[str, list],
                     chain: int) -> Dict[str, float]:
    """loss_gap, grad_gap, update_gap from each side's `losses` and
    `grads` (one leaf list an update) of every compared update and
    `change` over the first `chain` of them."""
    return dict(
        loss_gap=loss_gap(prog["losses"], ref["losses"]),
        grad_gap=grad_gap(prog["grads"], ref["grads"]),
        update_gap=update_gap(prog["change"], ref["change"],
                              ref["grads"][:chain]))
