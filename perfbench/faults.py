"""Faults a training cell can have, planted in the program under test:
each turns a run's `correct` false (`tests/test_perfbench_faults.py`), and
`control.py --fault` reads what each gives at a cell's own size.  A fault
is applied through a `setattr(obj, name, value)` callable, such as
pytest's monkeypatch, so that it can be taken out again."""
from __future__ import annotations

import torch


def unchanged_finetune(setattr):
    """The update leaves the weights and the optimizer as they were."""
    from vln_goat_tpu_torch.train import trainer
    setattr(trainer, "apply_update",
            lambda state: torch.zeros((), device=state.rollout.device))


def half_batch_finetune(setattr):
    """The loss is the mean over the first half of the episodes."""
    from vln_goat_tpu_torch.rollout.rollout import NavRollout
    orig = NavRollout.train_rollout

    def half(self, batch, *a, **k):
        out = orig(self, batch, *a, **k)
        h = max(1, out["loss_per_ep"].shape[0] // 2)
        out["ml_loss"] = out["loss_per_ep"][:h].sum() / h
        return out

    setattr(NavRollout, "train_rollout", half)


def altered_action_finetune(setattr):
    """The first episode of every sampled step takes the finite action the
    policy likes least."""
    from vln_goat_tpu_torch.rollout.rollout import NavRollout
    orig = NavRollout._sampled_action

    def altered(self, mode, logits, uid, t, key, ratio):
        a = orig(self, mode, logits, uid, t, key, ratio).clone()
        least = torch.where(torch.isfinite(logits), -logits, -float("inf"))
        a[0] = least[0].argmax()
        return a

    setattr(NavRollout, "_sampled_action", altered)


def unchanged_pretrain(setattr):
    """The update leaves the weights and the optimizer as they were."""
    from vln_goat_tpu_torch.pretrain import train
    setattr(train.PretrainState, "apply", lambda self, grads: None)


def half_batch_pretrain(setattr):
    """The loss is taken over the first half of the batch."""
    from vln_goat_tpu_torch.pretrain.model import GoatPretrainModel
    orig = GoatPretrainModel.forward

    def half(self, batch, task):
        B = batch["txt_ids"].shape[0]
        return orig(self, {k: v[:B // 2] if v.dim() and v.shape[0] == B
                           else v for k, v in batch.items()}, task)

    setattr(GoatPretrainModel, "forward", half)


# the faults of each job
FAULTS = {"finetune": (unchanged_finetune, half_batch_finetune,
                       altered_action_finetune),
          "pretrain": (unchanged_pretrain, half_batch_pretrain)}
BY_NAME = {f.__name__: f for fs in FAULTS.values() for f in fs}
