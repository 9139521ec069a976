"""The port's offline causal tools against the JAX package's:
`kmeans_fit` (same kmeans++ draws from the seed, then Lloyd iterations)
gives the same assignments and centers within 1e-5; `FrontDoorPicker`
picks the same rows; the z-dict TSV loaders read a file written here into
the same arrays; and `broadcast_zdict` / `causal_batch` give the shapes
and values of the JAX package's broadcast, as views of one copy."""
import base64
import csv

import numpy as np
import pytest
import torch

from vln_goat_tpu.tools import kmeans as jk
from vln_goat_tpu.tools import zdict as jz
from vln_goat_tpu_torch.tools import kmeans as pk
from vln_goat_tpu_torch.tools import zdict as pz
# torch on one thread: under xdist the workers share the cores
from test_torch_gate_witness import one_thread  # noqa: F401


def _clustered(rng, n=300, d=16, k=6):
    centers = rng.standard_normal((k, d)) * 3
    return (centers[rng.integers(0, k, n)]
            + rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_fit_matches_jax(rng, seed):
    x = _clustered(rng)
    jc, ja = jk.kmeans_fit(x, 6, n_iter=20, seed=seed)
    pc, pa = pk.kmeans_fit(x, 6, n_iter=20, seed=seed)
    assert np.array_equal(pa, np.asarray(ja))
    np.testing.assert_allclose(pc, np.asarray(jc), atol=1e-5, rtol=1e-5)


def test_front_door_picker_matches_jax(rng):
    feats = {k: _clustered(rng, n=200, k=5) for k in
             ("txt_feats", "vp_feats", "gmap_feats")}
    jp = jk.FrontDoorPicker(feats, n_clusters=5, seed=2)
    pp = pk.FrontDoorPicker(feats, n_clusters=5, seed=2)
    for _ in range(2):
        a, b = jp.random_pick(), pp.random_pick()
        assert set(a) == set(b)
        for k in a:
            assert b[k].shape == (5, 16)
            assert np.array_equal(a[k], b[k]), k


def _b64(v):
    return base64.b64encode(v.astype(np.float32)).decode()


def test_zdict_loaders_match_jax(rng, tmp_path):
    D = 8
    instr, img = tmp_path / "instr.tsv", tmp_path / "img.tsv"
    with open(instr, "w") as f:
        w = csv.writer(f, delimiter="\t")
        for kind, words in (("landmark", ["door", "table", "sofa"]),
                            ("direction", ["left", "right"])):
            for word in words:
                w.writerow([kind, word, _b64(rng.standard_normal(D)),
                            rng.random()])
    with open(img, "w") as f:
        w = csv.writer(f, delimiter="\t")
        for room in ("kitchen", "hall", "office", "bath"):
            w.writerow([room, _b64(rng.standard_normal(D)), rng.random()])
    for jfn, pfn, path in ((jz.load_instr_zdict_tsv,
                            pz.load_instr_zdict_tsv, instr),
                           (jz.load_img_zdict_tsv, pz.load_img_zdict_tsv,
                            img)):
        a, b = jfn(str(path)), pfn(str(path))
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    banks = pz.instr_bank_names(pz.load_instr_zdict_tsv(str(instr)))
    assert set(banks) == {"instr_z_landmark_features", "instr_z_landmark_pzs",
                          "instr_z_direction_features",
                          "instr_z_direction_pzs"}


def test_broadcast_and_causal_batch(rng):
    zd = {"img_z_features": rng.standard_normal((5, 4)).astype(np.float32),
          "img_z_pzs": rng.random(5).astype(np.float32)}
    ref = jz.broadcast_zdict(zd, 3)
    got = pz.broadcast_zdict(zd, 3)
    for k in zd:
        assert got[k].shape == tuple(ref[k].shape)
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
        assert got[k].stride(0) == 0          # one copy, shared
    batch = {"scan_idx": torch.zeros(3, dtype=torch.int64),
             "txt_ids": torch.ones(3, 7, dtype=torch.int64)}
    out = pz.causal_batch(zd, batch)
    assert set(out) == set(batch) | set(zd)
    assert out["txt_ids"] is batch["txt_ids"]
    assert out["img_z_pzs"].shape == (3, 5, 1)
    assert set(zd) <= pz.SHARED_BANKS


def test_step_calls_count_the_host_work_of_each_setting():
    """tools.step_calls on the CPU test configuration: bf16 adds calls
    (the per-call casts) and remat "model" adds more (the recompute)."""
    from vln_goat_tpu_torch.tools.step_calls import SETTINGS, step_calls
    counts = [step_calls("cpu", True, dtype, remat)
              for dtype, remat in SETTINGS]
    assert len({c["rollout_steps"] for c in counts}) == 1
    calls = [c["aten_calls"] for c in counts]
    assert calls[0] < calls[1] < calls[2]
