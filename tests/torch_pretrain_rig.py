"""Shared rig of the pretraining parity tests (tests/test_torch_pretrain_*):
both packages' batch builders on the same synthetic scans and features,
the port's pretrain model at a tiny width, and the JAX parameters made
from the port's seeded weights through the reference torch names (JAX
`torch_to_flax`), so no flax init runs; `jax_tree` holds that tree's
structure to the JAX model's own (`jax.eval_shape` of its init).

The causal configuration is BACL's back doors on the text (type_2, door)
and the image (type_1) with seeded z-dictionaries.  The JAX model hands
the image bank to the panorama encoder of the flattened B·T steps
unrepeated, which its own builder's [B, N, D] bank cannot broadcast
against; `jax_batch` repeats the bank over each example's steps, as the
port's model does itself."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.config import GoatConfig as JaxConfig
from vln_goat_tpu.pretrain import data as jdata
from vln_goat_tpu.pretrain.model import GoatPretrainModel as JaxPretrain
from vln_goat_tpu.rollout.env import make_synthetic_dataset as jax_dataset
from vln_goat_tpu.sim.graph_sim import make_synthetic_scan as jax_scan
from vln_goat_tpu.train.checkpoint import torch_to_flax
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.pretrain import data as pdata
from vln_goat_tpu_torch.pretrain.model import build_pretrain_model
from vln_goat_tpu_torch.rollout.env import make_synthetic_dataset
from vln_goat_tpu_torch.sim.graph_sim import make_synthetic_scan
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax

TINY = dict(num_l_layers=1, num_x_layers=1, num_pano_layers=1,
            hidden_size=32, num_attention_heads=2, intermediate_size=64,
            vocab_size=64, max_position_embeddings=64, image_feat_size=16,
            feat_dropout=0.0, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
CAUSAL = dict(do_back_txt=True, do_back_img=True, do_back_txt_type="type_2",
              do_back_img_type="type_1", do_add_method="door")
REVERIE = dict(dataset="reverie", name="REVERIE", obj_feat_size=12,
               use_obj_name=True)
R2R_TASKS = ("mlm", "mrc", "sap", "cfp")
PROBS, LO, B = 16, 5, 6


def zdicts(D=32, Dimg=16, seed=3):
    r = np.random.default_rng(seed)
    return dict(
        instr_z_direction_features=r.standard_normal((5, D)).astype(
            np.float32),
        instr_z_direction_pzs=r.dirichlet(np.ones(5)).astype(np.float32),
        instr_z_landmark_features=r.standard_normal((7, D)).astype(
            np.float32),
        instr_z_landmark_pzs=r.dirichlet(np.ones(7)).astype(np.float32),
        img_z_features=r.standard_normal((6, Dimg)).astype(np.float32),
        img_z_pzs=r.dirichlet(np.ones(6)).astype(np.float32))


def objects_store(vtot, seed=7):
    r = np.random.default_rng(seed)
    return dict(
        feat=r.standard_normal((vtot, LO, 12)).astype(np.float32),
        loc=np.concatenate([r.standard_normal((vtot, LO, 4)),
                            r.random((vtot, LO, 3))], -1).astype(np.float32),
        dir=r.uniform(-3, 3, (vtot, LO, 2)).astype(np.float32),
        mask=r.random((vtot, LO)) < 0.7,
        name=r.integers(0, 45, (vtot, LO)).astype(np.int32),
        oid=r.integers(0, 50, (vtot, LO)).astype(np.int32))


def builders(causal=False, objnav=False):
    """[(jax builder, jax items), (port builder, port items)] on the same
    two synthetic scans, features, z-dictionaries and object store."""
    feats = np.random.default_rng(0).standard_normal(
        (24, 36, 16)).astype(np.float32)
    objects = objects_store(24) if objnav else None
    kw = dict(mask_token_id=63, vocab_size=64, seed=0,
              zdicts=zdicts() if causal else None, objnav=objnav,
              objects=objects)
    out = []
    for mod, scan, ds in ((jdata, jax_scan, jax_dataset),
                          (pdata, make_synthetic_scan,
                           make_synthetic_dataset)):
        scans = [scan(f"p{i}", num_vps=12, seed=10 + i) for i in range(2)]
        graphs = {g.scan_id: g for g in scans}
        shapes = mod.PretrainShapes(max_txt_len=24, max_steps=6,
                                    max_cands=16, max_gmap=32, max_mlm=6,
                                    mrc_prob_dim=PROBS,
                                    max_objs=LO if objnav else 0)
        b = mod.TrajBatchBuilder(graphs, list(graphs), feats, shapes, **kw)
        data = ds(graphs, 16, vocab_size=63, path_len=(3, 5),
                  max_instr_len=20, seed=2)
        if objnav:
            row0 = {g.scan_id: 12 * i for i, g in enumerate(scans)}
            for it in data:
                row = row0[it["scan"]] + \
                    graphs[it["scan"]].index[it["path"][-1]]
                k = int(np.argmax(objects["mask"][row]))
                it["objid"] = int(objects["oid"][row, k])
        out.append((b, mod.items_from_dataset(data, graphs)))
    return out


def configs(causal=False, objnav=False):
    kw = dict(TINY, **(CAUSAL if causal else {}), **(REVERIE if objnav
                                                      else {}))
    return JaxConfig(**kw), GoatConfig(**kw)


def port_model(cfg, tasks, seed=0):
    return build_pretrain_model(cfg, tasks, PROBS, "cpu", seed=seed)


def jax_params(model):
    """The port model's weights as the JAX package's parameter tree."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return torch_to_flax(sd)["params"]


def jax_tree(jm, batches):
    """The JAX model's parameter structure over the tasks of `batches`
    ({task: jax batch}), as init_pretrain_params merges it, without
    running its init."""
    from vln_goat_tpu.train.params import _merge

    params = {}
    for i, (task, batch) in enumerate(batches.items()):
        v = jax.eval_shape(lambda b, t=task: jm.init(
            jax.random.PRNGKey(i), b, t), batch)
        params = _merge(params, v["params"])
    return params


def port_names(tree):
    """The port's state-dict names of a JAX tree's leaves."""
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    return set(params_from_flax(flatten(zeros)))


def jax_batch(batch):
    """A port-builder batch for the JAX model: the image bank repeated
    over each example's steps (see the module docstring)."""
    out = dict(batch)
    T = batch["traj_view_img_fts"].shape[1]
    for k in ("img_z_features", "img_z_pzs"):
        if k in batch:
            out[k] = np.repeat(batch[k], T, axis=0)
    return jax.tree.map(jnp.asarray, out)


def port_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def jax_model(jcfg, tasks):
    return JaxPretrain(jcfg, tasks=tuple(tasks), image_prob_size=PROBS)
