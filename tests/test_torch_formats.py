"""The port's readers of the reference file formats and its scoring, each
against its JAX counterpart on the same fixture files, written in tmp_path
in the reference formats (the writers of tests/test_real_formats.py):

- annotations (`construct_instrs`, `load_annotation_file`): equal items;
- Matterport connectivity JSONs (`load_connectivity`) and the reference's
  candidate cache (`load_scanvp_cands`): equal tables, exactly;
- HDF5 and base64-TSV view features (`ImageFeaturesDB`, `TsvFeaturesDB`):
  equal arrays, exactly;
- `eval_item` / `eval_metrics` over the fixture scans: equal scores
  (float64 numpy on both sides, atol 0);
- the TensorBoard writer: the same events, read back by the JAX package's
  reader.

h5py is needed by the HDF5 case only, as the JAX package's own tests
import it.
"""
import base64
import json
import os

import numpy as np
import pytest

from vln_goat_tpu.data import annotations as jann
from vln_goat_tpu.data.feature_db import ImageFeaturesDB as JaxImageDB
from vln_goat_tpu.data.feature_db import TsvFeaturesDB as JaxTsvDB
from vln_goat_tpu.eval import metrics as jmet
from vln_goat_tpu.sim import graph_sim as jgs
from vln_goat_tpu.utils.tb import TensorBoardWriter as JaxTensorBoardWriter
from vln_goat_tpu.utils.tb import read_events
from vln_goat_tpu_torch.data import annotations as pann
from vln_goat_tpu_torch.data.feature_db import ImageFeaturesDB, TsvFeaturesDB
from vln_goat_tpu_torch.eval import metrics as pmet
from vln_goat_tpu_torch.sim import graph_sim as pgs
from vln_goat_tpu_torch.utils.logger import MetricsLogger
from vln_goat_tpu_torch.utils.tb import TensorBoardWriter

DF = 16
SCANS = ("fx0", "fx1")
SPLITS = (("train", 8, 1), ("val_train_seen", 3, 2), ("val_seen", 3, 3),
          ("val_unseen", 3, 4), ("test", 3, 5))


def write_connectivity(graphs, out_dir):
    """Matterport schema (utils/data.py:76-101): pose 4x4 row-major with
    translation at 3/7/11, included, unobstructed adjacency row, height
    (tests/test_real_formats.py's writer)."""
    os.makedirs(out_dir, exist_ok=True)
    for scan, g in graphs.items():
        V = g.num_vps
        adj = np.zeros((V, V), bool)
        for v in range(V):
            for w in g.cand_local[v]:
                if w >= 0:
                    adj[v, int(w)] = adj[int(w), v] = True
        items = []
        for v in range(V):
            pose = [0.0] * 16
            pose[0] = pose[5] = pose[10] = pose[15] = 1.0
            pose[3], pose[7], pose[11] = map(float, g.pos[v])
            items.append(dict(image_id=g.vp_ids[v], pose=pose, included=True,
                              unobstructed=[bool(x) for x in adj[v]],
                              height=1.5))
        with open(os.path.join(out_dir, f"{scan}_connectivity.json"),
                  "w") as f:
            json.dump(items, f)


def write_fixture(root, h5=True):
    """Reference-format files of two 10-viewpoint scans: connectivity,
    annotations (R2R_{split}_roberta_enc.json), HDF5 features keyed
    '{scan}_{vp}' (if h5), the same features as base64 TSV, and the
    candidate cache; -> dict of paths and the scans' ScanGraphs."""
    rng = np.random.default_rng(0)
    scans = {s: jgs.make_synthetic_scan(s, num_vps=10, seed=40 + i)
             for i, s in enumerate(SCANS)}
    conn = os.path.join(root, "connectivity")
    write_connectivity(scans, conn)
    feats = {f"{s}_{vp}": rng.standard_normal((36, DF)).astype(np.float32)
             for s, g in scans.items() for vp in g.vp_ids}
    out = dict(root=str(root), conn=conn, graphs=scans, feats=feats)
    if h5:
        import h5py
        out["h5"] = os.path.join(root, "feats.h5")
        with h5py.File(out["h5"], "w") as f:
            for k, v in feats.items():
                f.create_dataset(k, data=v)
    out["tsv"] = os.path.join(root, "feats.tsv")
    with open(out["tsv"], "w") as f:
        for k, v in feats.items():
            scan, vp = k.split("_", 1)
            f.write(f"{scan}\t{vp}\t"
                    f"{base64.b64encode(v.tobytes()).decode()}\n")
    anno = os.path.join(root, "annotations")
    os.makedirs(anno)
    pid = 0
    for split, n, seed in SPLITS:
        r = np.random.default_rng(seed)
        items = []
        for _ in range(n):
            s = SCANS[int(r.integers(0, 2))]
            g = scans[s]
            # a shortest path of 2-4 hops, as the reference's paths are
            while True:
                a, z = (int(v) for v in r.integers(0, g.num_vps, 2))
                if 2 <= g.hops[a, z] <= 4:
                    break
            path = [a] + g.shortest_path(a, z)
            items.append(dict(
                path_id=pid, scan=s, path=[g.vp_ids[v] for v in path],
                heading=float(r.uniform(0, 6.28)), distance=5.0,
                instructions=["walk on", "turn and stop"],
                instr_encodings=[
                    [0] + [int(x) for x in r.integers(4, 60, 8)] + [2],
                    [0] + [int(x) for x in r.integers(4, 60, 6)] + [2]]))
            pid += 1
        with open(os.path.join(anno, f"R2R_{split}_roberta_enc.json"),
                  "w") as f:
            json.dump(items, f)
    out["anno"] = anno
    out["cands"] = os.path.join(root, "scanvp_candview_relangles.json")
    with open(out["cands"], "w") as f:
        json.dump(jgs.dump_scanvp_cands(scans), f)
    return out


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    pytest.importorskip("h5py")
    return write_fixture(tmp_path_factory.mktemp("fmt"))


def test_annotations_match(fx):
    names = [s for s, _, _ in SPLITS]
    got = pann.construct_instrs(fx["anno"], "r2r", names, max_instr_len=12)
    ref = jann.construct_instrs(fx["anno"], "r2r", names, max_instr_len=12)
    assert got == ref and len(got["train"]) == 16
    path = os.path.join(fx["anno"], "R2R_val_seen_roberta_enc.json")
    assert pann.load_annotation_file(path, "r2r", max_instr_len=12) == \
        jann.load_annotation_file(path, "r2r", max_instr_len=12)


def _same_graphs(got, ref):
    assert list(got) == list(ref)
    for s in ref:
        a, b = got[s], ref[s]
        assert a.vp_ids == b.vp_ids
        for k in ("pos", "cand_local", "cand_ptid", "cand_heading",
                  "cand_elev", "cand_dist", "cand_mask", "dist", "hops",
                  "nexthop"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), (s, k)


@pytest.mark.parametrize("sweep", [False, True])
def test_connectivity_matches(fx, sweep):
    _same_graphs(pgs.load_connectivity(fx["conn"], SCANS,
                                       sweep_visibility=sweep),
                 jgs.load_connectivity(fx["conn"], SCANS,
                                       sweep_visibility=sweep))


def test_candidate_cache_matches(fx):
    got = pgs.load_connectivity(fx["conn"], SCANS)
    ref = jgs.load_connectivity(fx["conn"], SCANS)
    n = pgs.load_scanvp_cands(fx["cands"], got)
    assert n == jgs.load_scanvp_cands(fx["cands"], ref) == 20
    _same_graphs(got, ref)


def test_feature_stores_match(fx):
    graphs = pgs.load_connectivity(fx["conn"], SCANS)
    got = ImageFeaturesDB(fx["h5"], DF).as_packed_array(graphs, SCANS)
    ref = JaxImageDB(fx["h5"], DF).as_packed_array(graphs, SCANS)
    assert got.shape == (20, 36, DF) and np.array_equal(got, ref)
    tsv, jtsv = TsvFeaturesDB(fx["tsv"], DF), JaxTsvDB(fx["tsv"], DF)
    for k, v in fx["feats"].items():
        scan, vp = k.split("_", 1)
        assert np.array_equal(tsv.get_image_feature(scan, vp), v)
        assert np.array_equal(jtsv.get_image_feature(scan, vp), v)


def test_missing_h5py_is_named(fx, monkeypatch):
    import builtins
    real = builtins.__import__

    def block(name, *a, **k):
        if name == "h5py":
            raise ImportError("no h5py")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", block)
    with pytest.raises(ImportError, match="needs h5py"):
        ImageFeaturesDB(fx["h5"], DF).get_image_feature("fx0", "x")


def test_eval_matches(fx):
    rng = np.random.default_rng(3)
    g = jgs.load_connectivity(fx["conn"], SCANS)["fx0"]
    got, ref = [], []
    for _ in range(12):
        gt = [int(v) for v in rng.integers(0, 10, int(rng.integers(2, 6)))]
        pred = gt[:1] + [int(v) for v in
                         rng.integers(0, 10, int(rng.integers(0, 7)))]
        a, b = pmet.eval_item(g.dist, pred, gt), jmet.eval_item(g.dist,
                                                                 pred, gt)
        assert a == b
        got.append(a)
        ref.append(b)
    assert pmet.eval_metrics(got) == jmet.eval_metrics(ref)


def test_tb_writer_matches(tmp_path):
    paths = []
    for name, cls in (("port", TensorBoardWriter),
                      ("jax", JaxTensorBoardWriter)):
        with cls(str(tmp_path / name)) as w:
            w.add_scalar("loss", 1.5, step=10, wall_time=5.0)
            w.add_scalars({"a": 1.0, "b": 2.0}, step=11)
            paths.append(w.path)
    events, ref = (read_events(p) for p in paths)
    assert [(e[1], e[2]) for e in events] == [(e[1], e[2]) for e in ref]
    assert [(e[1], e[2]) for e in events[1:]] == [
        (10, {"loss": 1.5}), (11, {"a": 1.0}), (11, {"b": 2.0})]
    assert events[1][0] == ref[1][0] == 5.0
    log = MetricsLogger(str(tmp_path / "m.jsonl"), tb_dir=str(tmp_path / "t"))
    log.set_step(3)
    log.log_scalar_dict({"sr": 0.5}, prefix="val")
    assert json.loads(open(tmp_path / "m.jsonl").read()) == \
        {"step": 3, "val/sr": 0.5}
