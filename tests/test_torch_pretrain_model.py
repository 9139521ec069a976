"""The port's pretraining model against the JAX package's at a tiny width
(1 layer per stack, hidden 32, 2 heads), R2R configuration, dropout off:
MLM, MRC, SAP and CFP each on one batch of the port's builder, from the
same weights (the port's seeded ones carried to the JAX tree by the
reference torch names).  Per task: the loss within 1e-5 (relative, at
least 1e-5 absolute), the accuracies equal, every gradient within 1e-4 of
its largest magnitude (the biases whose gradients are zero up to
rounding, `NOISE`, at their weight's).

Also: the modules per task set equal the JAX model's parameter tree after
`params_from_flax` (the pinned difference is empty); a pretrain .pt of
the port (`save_pretrain_checkpoint`) loads into the port's fine-tune
GoatModel with the same keys missing as the JAX package's
flax_to_torch_pretrain + merge_loaded leave missing in its GoatModel, and
no encoder key among them; `fuse_logits` with the pretraining's first
slots equals the JAX function."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.models.goat import GoatModel as JaxGoat
from vln_goat_tpu.models.goat import fuse_logits as jax_fuse
from vln_goat_tpu.train.checkpoint import (flax_to_torch_pretrain,
                                           merge_loaded as jax_merge)
from vln_goat_tpu.train.params import init_goat_params as jax_init
from vln_goat_tpu_torch.entry import build_model
from vln_goat_tpu_torch.models.goat import fuse_logits
from vln_goat_tpu_torch.tools.gate_witness import (NOISE_GRAD_BIASES,
                                                    TEACHER_NOISE_BIASES,
                                                    worst_grad)
from vln_goat_tpu_torch.train.checkpoint import (flatten, load_reference,
                                                 params_from_flax,
                                                 save_pretrain_checkpoint)
from torch_pretrain_rig import (B, R2R_TASKS, builders, configs, jax_batch,
                                jax_model, jax_params, jax_tree, port_batch,
                                port_model, port_names)

# zero up to rounding (tools/gate_witness.py): the key biases and the
# graph-bias Linear's bias (one constant added to a row of scores), the
# global SAP head's last two biases (one constant added to every finite
# global and fused logit), which softmax ignores, and, SAP being taken
# along the gt path as a teacher-forced step is, the local head's
NOISE = NOISE_GRAD_BIASES + TEACHER_NOISE_BIASES
ENCODER = ("embeddings", "lang_encoder", "img_embeddings", "local_encoder",
           "global_encoder")


def task_batches(pb, pitems, tasks):
    return {t: pb.build_batch(pitems[:B], t, rng=np.random.default_rng(i))
            for i, t in enumerate(tasks)}


def compare_task(tm, jm, params, batch, task, noise=NOISE):
    """The port's loss, metrics and gradients against the JAX model's eval
    (value_and_grad, deterministic) on one batch; returns the worst
    gradient ratio."""
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jm.apply({"params": p}, b, task, deterministic=True),
        has_aux=True))
    (jl, jmet), jg = fn(params, jax_batch(batch))
    tm.eval()
    tm.zero_grad(set_to_none=True)
    loss, met = tm(port_batch(batch), task)
    loss.backward()
    jl = float(jl)
    assert abs(loss.item() - jl) <= 1e-5 * max(1.0, abs(jl)), \
        (loss.item(), jl)
    assert set(met) == set(jmet)
    for k, v in jmet.items():
        if k.endswith("acc"):
            assert met[k].item() == float(v), (k, met[k].item(), float(v))
        else:
            assert abs(met[k].item() - float(v)) <= 1e-5 * max(
                1.0, abs(float(v))), k
    ref = params_from_flax(flatten(jax.device_get(jg)))
    named = dict(tm.named_parameters())
    assert set(ref) == set(named)
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in named.items()}
    worst, name = worst_grad(got, ref, noise)
    assert worst <= 1e-4, (name, worst)
    assert any(float(g.abs().max()) > 0 for g in got.values())
    return worst


@pytest.fixture(scope="module")
def rig():
    (_, _), (pb, pitems) = builders()
    jcfg, cfg = configs()
    tm = port_model(cfg, R2R_TASKS)
    return dict(pb=pb, pitems=pitems, jcfg=jcfg, cfg=cfg, tm=tm,
                jm=jax_model(jcfg, R2R_TASKS), params=jax_params(tm),
                batches=task_batches(pb, pitems, R2R_TASKS))


@pytest.mark.parametrize("task", R2R_TASKS)
def test_task_matches_jax(rig, task):
    compare_task(rig["tm"], rig["jm"], rig["params"], rig["batches"][task],
                 task)


@pytest.mark.parametrize("tasks", [R2R_TASKS, ("mlm",), ("mrc",), ("sap",),
                                   ("cfp",), ("mlm", "sap", "cfp")])
def test_keys_equal_jax_tree(rig, tasks):
    """Flax makes a parameter only where a task calls its module; the
    port builds those modules only: the difference is pinned empty."""
    tm = port_model(rig["cfg"], tasks)
    tree = jax_tree(jax_model(rig["jcfg"], tasks),
                    {t: jax_batch(rig["batches"][t]) for t in tasks})
    assert set(tm.state_dict()) ^ port_names(tree) == set()


def test_pretrain_pt_initialises_finetune_model(rig, tmp_path):
    tm = rig["tm"]
    pt = str(tmp_path / "pretrain.pt")
    save_pretrain_checkpoint(tm.state_dict(), pt)
    sd = torch.load(pt, weights_only=True)
    # the JAX package's layout for the same weights
    assert set(sd) == set(flax_to_torch_pretrain({"params": rig["params"]}))
    ft = build_model(rig["cfg"], "cpu", seed=5)
    missing, extra = load_reference(ft, pt)
    assert not [k for k in missing if k.split(".")[0] in ENCODER]
    for k, v in tm.state_dict().items():
        if k in ft.state_dict():
            assert torch.equal(ft.state_dict()[k], v), k
    # the JAX package's GoatModel left missing the same leaves
    jm = JaxGoat(rig["jcfg"])
    init = jax.eval_shape(lambda: jax_init(jm, jax.random.PRNGKey(0),
                                           max_cands=16, num_nodes=32))
    init = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), init)
    from vln_goat_tpu.train.checkpoint import (load_reference_checkpoint,
                                               torch_to_flax)
    _, jmissing, _ = jax_merge(init, torch_to_flax(
        load_reference_checkpoint(pt)))
    roots = {m.split("/")[0] for m in jmissing}
    assert roots == {k.split(".")[0] for k in missing}
    assert roots <= {"gmap_pooler", "vp_pooler", "txt_pooler",
                     "local_his_map", "local_his_ln"}


@pytest.mark.parametrize("first", [1, 2])
def test_fuse_logits_first_slots(first):
    r = np.random.default_rng(first)
    Bn, G, L = 5, 9, 11
    gl = r.standard_normal((Bn, G)).astype(np.float32)
    ll = r.standard_normal((Bn, L)).astype(np.float32)
    gm = r.random((Bn, G)) < 0.8
    gm[:, 0] = True
    gv = (r.random((Bn, G)) < 0.3) & gm
    gv[:, 0] = False
    nav = r.random((Bn, L)) < 0.7
    nav[:, 0] = True
    l2g = np.where(r.random((Bn, L)) < 0.7, r.integers(0, G, (Bn, L)), -1)
    l2g[:, 0] = -1
    ref = jax_fuse(*(jnp.asarray(a) for a in (gl, ll, gm, gv, nav, l2g)),
                   first_cand_slot=first, first_gmap_slot=first)
    got = fuse_logits(*(torch.from_numpy(a) for a in (gl, ll, gm, gv, nav,
                                                        l2g)),
                      first_cand_slot=first, first_gmap_slot=first)
    for a, b_ in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
