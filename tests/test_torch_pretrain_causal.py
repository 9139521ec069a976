"""The port's pretraining model against the JAX package's in GOAT's causal
configuration (BACL back doors on the text, type_2 door, and the image,
type_1, with seeded z-dictionaries that the builders attach to every
batch), at test_torch_pretrain_model.py's width and gates: MLM, MRC, SAP
and CFP, and the modules per task set against the JAX parameter tree.
The JAX model gets the image bank repeated over each example's steps
(torch_pretrain_rig.py)."""
import pytest

from test_torch_pretrain_model import compare_task, task_batches
from torch_pretrain_rig import (R2R_TASKS, builders, configs, jax_batch,
                                jax_model, jax_params, jax_tree, port_model,
                                port_names)


@pytest.fixture(scope="module")
def rig():
    (_, _), (pb, pitems) = builders(causal=True)
    jcfg, cfg = configs(causal=True)
    tm = port_model(cfg, R2R_TASKS, seed=2)
    batches = task_batches(pb, pitems, R2R_TASKS)
    assert batches["mlm"]["img_z_features"].shape[:2] == (6, 6)
    return dict(jcfg=jcfg, cfg=cfg, tm=tm, jm=jax_model(jcfg, R2R_TASKS),
                params=jax_params(tm), batches=batches)


@pytest.mark.parametrize("task", R2R_TASKS)
def test_causal_task_matches_jax(rig, task):
    compare_task(rig["tm"], rig["jm"], rig["params"], rig["batches"][task],
                 task)
    # the back-door modules took part
    g = dict(rig["tm"].named_parameters())
    for name in ("lang_encoder.z_direc_cross_attn.self.query.weight",
                 "img_embeddings.do_img_before_linear.weight"):
        assert float(g[name].grad.abs().max()) > 0, name


@pytest.mark.parametrize("tasks", [R2R_TASKS, ("cfp",)])
def test_causal_keys_equal_jax_tree(rig, tasks):
    tm = port_model(rig["cfg"], tasks)
    tree = jax_tree(jax_model(rig["jcfg"], tasks),
                    {t: jax_batch(rig["batches"][t]) for t in tasks})
    assert set(tm.state_dict()) ^ port_names(tree) == set()
