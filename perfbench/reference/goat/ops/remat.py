"""The names of the port's rematerialisation policies, without the
policies: the reference keeps every activation (remat "none"), so a
checkpoint name is its argument and an FFN sublayer is a plain call."""
from __future__ import annotations

import contextlib

CALL_POLICIES = ("model", "model_probs", "model_wide")
STEP_POLICIES = ()
POLICIES = ("none",)


def check(policy: str) -> None:
    if policy != "none":
        raise ValueError(f"the reference runs remat 'none', not {policy!r}")


def checkpoint_name(x, name: str):
    return x


def ffn_sublayer(module, fn, *args):
    return fn(*args)


@contextlib.contextmanager
def ffn_region():
    yield


def call_policy(policy: str):
    return None


def vec_call_policy(policy: str):
    return None
