"""CFP feature extraction in the port against the JAX package's, at the
small configuration of test_torch_reverie_model.py in the
`extract_cfp_features` mode (dropout off, eval):

- `pretrain.data.TrajBatchBuilder` (the port's own copy) gives the JAX
  package's batches bit for bit for one seed, on the vectorized path, the
  per-example path and the dispatch of `build_batch(items, "cfp")`;
- `models.traj.aggregate_gmap_features` against the JAX function (float32
  sums of at most a few rows: 1e-6);
- `GoatModel.extract_cfp` on one batch against the JAX model's
  (txt / vp / gmap outputs, atol 1e-4 / rtol 1e-4 as test_torch_model.py);
- `tools.cfp_extract.extract_cfp_features` over several batches, its TSV
  read by the JAX package's `load_cfp_tsv` and a TSV of the JAX package's
  read by the port's, each equal to what was written."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vln_goat_tpu.config import GoatConfig as JaxConfig
from vln_goat_tpu.models.goat import GoatModel as JaxModel
from vln_goat_tpu.models.traj import aggregate_gmap_features as jax_agg
from vln_goat_tpu.pretrain import data as jdata
from vln_goat_tpu.rollout.env import make_synthetic_dataset as jax_dataset
from vln_goat_tpu.sim.graph_sim import make_synthetic_scan as jax_scan
from vln_goat_tpu.tools import cfp_extract as jcfp
from vln_goat_tpu.train.params import init_goat_params as jax_init
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import build_model
from vln_goat_tpu_torch.models.traj import aggregate_gmap_features
from vln_goat_tpu_torch.pretrain import data as pdata
from vln_goat_tpu_torch.rollout.env import make_synthetic_dataset
from vln_goat_tpu_torch.sim.graph_sim import make_synthetic_scan
from vln_goat_tpu_torch.tools import cfp_extract as pcfp
from vln_goat_tpu_torch.train.checkpoint import flatten, params_from_flax
from test_torch_reverie_model import SMALL

CFP = dict(SMALL, mode="extract_cfp_features", feat_dropout=0.0,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
TOL = dict(atol=1e-4, rtol=1e-4)


def _builders():
    jg = jax_scan("c0", num_vps=12, seed=5)
    tg = make_synthetic_scan("c0", num_vps=12, seed=5)
    feats = np.random.default_rng(1).standard_normal(
        (tg.num_vps, 36, 16)).astype(np.float32)
    kw = dict(mask_token_id=63, vocab_size=64, seed=0)
    out = []
    for mod, g, ds in ((jdata, jg, jax_dataset),
                       (pdata, tg, make_synthetic_dataset)):
        shapes = mod.PretrainShapes(max_txt_len=24, max_steps=6,
                                    max_cands=16, max_gmap=32,
                                    mrc_prob_dim=16)
        b = mod.TrajBatchBuilder({"c0": g}, ["c0"], feats, shapes, **kw)
        data = ds({"c0": g}, 10, vocab_size=63, path_len=(3, 5),
                  max_instr_len=20, seed=3)
        out.append((b, mod.items_from_dataset(data, {"c0": g})))
    return out


@pytest.fixture(scope="module")
def setup():
    (jb, jitems), (pb, pitems) = _builders()
    jm = JaxModel(JaxConfig(**CFP))
    params = jax_init(jm, jax.random.PRNGKey(0), max_cands=16, num_nodes=30)
    tm = build_model(GoatConfig(**CFP), "cpu")
    tm.load_state_dict(params_from_flax(flatten(params["params"])),
                       strict=True)
    return dict(jb=jb, jitems=jitems, pb=pb, pitems=pitems, jm=jm,
                params=params, tm=tm)


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("path", ["fast", "slow", "build_batch"])
def test_batches_equal_jax(path):
    (jb, jitems), (pb, pitems) = _builders()
    assert jitems == pitems
    for start in (0, 4):
        chunk_j, chunk_p = jitems[start:start + 4], pitems[start:start + 4]
        if path == "build_batch":
            _same(jb.build_batch(chunk_j, "cfp"),
                  pb.build_batch(chunk_p, "cfp"))
            continue
        fn = "_build_batch_fast" if path == "fast" else "_build_batch_slow"
        _same(getattr(jb, fn)(chunk_j, "cfp", 0.2,
                              np.random.default_rng(start)),
              getattr(pb, fn)(chunk_p, "cfp", 0.2,
                              np.random.default_rng(start)))


def test_aggregate_gmap_features(rng):
    B, T, Lp, D, K, G = 3, 4, 10, 8, 5, 7
    pe = rng.standard_normal((B, T, Lp, D)).astype(np.float32)
    pf = rng.standard_normal((B, T, D)).astype(np.float32)
    vstep = rng.integers(-1, T, (B, G))
    c2g = np.where(rng.random((B, T, K)) < 0.6, rng.integers(1, G, (B, T, K)),
                   -1)
    ref = jax_agg(jnp.asarray(pe), jnp.asarray(pf), jnp.asarray(vstep),
                  jnp.asarray(c2g), G)
    got = aggregate_gmap_features(torch.from_numpy(pe), torch.from_numpy(pf),
                                  torch.from_numpy(vstep),
                                  torch.from_numpy(c2g), G)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    assert bool((got[:, 0] == 0).all())


def test_extract_cfp_matches_jax(setup):
    s = setup
    batch = s["jb"].build_batch(s["jitems"][:4], "cfp")
    ref = jax.jit(lambda p, b: s["jm"].apply(
        p, b, method=JaxModel.extract_cfp))(
        s["params"], jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        out = s["tm"].extract_cfp(pcfp.batch_tensors(batch, "cpu"))
    for k in ("txt_outputs", "vp_outputs", "gmap_outputs"):
        assert out[k].shape == (4, 32)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)


def test_features_and_tsv_across_packages(setup, tmp_path):
    s = setup
    n = len(s["pitems"])
    port_tsv, jax_tsv = str(tmp_path / "port.tsv"), str(tmp_path / "jax.tsv")
    feats = pcfp.extract_cfp_features(s["tm"], s["pb"], s["pitems"],
                                      batch_size=4, out_tsv=port_tsv)
    assert feats["txt_feats"].shape == (n, 32)
    assert np.abs(feats["gmap_feats"]).max() <= 1.0
    read = jcfp.load_cfp_tsv(port_tsv, dim=32)
    assert read["path_ids"] == [it["instr_id"] for it in s["pitems"]]
    for k in ("txt_feats", "vp_feats", "gmap_feats"):
        assert np.array_equal(read[k], feats[k]), k
    jfeats = {k: np.random.default_rng(2).standard_normal((3, 32))
              .astype(np.float32) for k in feats}
    jcfp.save_cfp_tsv(jax_tsv, ["a", "b", "c"], jfeats)
    back = pcfp.load_cfp_tsv(jax_tsv, dim=32)
    assert back["path_ids"] == ["a", "b", "c"]
    for k, v in jfeats.items():
        assert np.array_equal(back[k], v), k
