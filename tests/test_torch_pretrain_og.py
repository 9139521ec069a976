"""The port's object-grounding pretraining task against the JAX package's,
on a REVERIE configuration at test_torch_pretrain_model.py's width (object
features of 12, names, 5 object slots a viewpoint from a seeded store
whose goal viewpoints show each episode's object), plain and causal, with
that file's gates; and the modules of the og task set (with and without
MRC and SAP) against the JAX parameter tree."""
import pytest

from test_torch_pretrain_model import NOISE, compare_task, task_batches
from torch_pretrain_rig import (builders, configs, jax_batch, jax_model,
                                jax_params, jax_tree, port_model, port_names)

TASKS = ("og", "mrc", "sap")
# the og head's last two biases add one constant to every object logit,
# which the softmax over them ignores: zero up to rounding
OG_NOISE = NOISE + ("og_head.net.2.bias", "og_head.net.3.bias")


def rig_for(causal):
    (_, _), (pb, pitems) = builders(causal=causal, objnav=True)
    jcfg, cfg = configs(causal=causal, objnav=True)
    tm = port_model(cfg, TASKS, seed=3)
    return dict(jcfg=jcfg, cfg=cfg, tm=tm, jm=jax_model(jcfg, TASKS),
                params=jax_params(tm),
                batches=task_batches(pb, pitems, TASKS))


@pytest.fixture(scope="module")
def rigs():
    return {c: rig_for(c) for c in (False, True)}


@pytest.mark.parametrize("causal", [False, True])
def test_og_matches_jax(rigs, causal):
    r = rigs[causal]
    b = r["batches"]["og"]
    assert b["vp_obj_masks"].any(1).all() and (b["obj_labels"] >= 0).any()
    compare_task(r["tm"], r["jm"], r["params"], b, "og", OG_NOISE)
    g = dict(r["tm"].named_parameters())
    assert float(g["og_head.net.3.weight"].grad.abs().max()) > 0


@pytest.mark.parametrize("tasks", [("og",), TASKS])
def test_og_keys_equal_jax_tree(rigs, tasks):
    r = rigs[False]
    tm = port_model(r["cfg"], tasks)
    tree = jax_tree(jax_model(r["jcfg"], tasks),
                    {t: jax_batch(r["batches"][t]) for t in tasks})
    assert set(tm.state_dict()) ^ port_names(tree) == set()
