"""The port's native library (`vln_goat_tpu_torch.native`, its own copy of
the JAX package's csrc/goat_native.cpp built with g++ into
`vln_goat_tpu_torch/build/`): its nine bindings against the port's Python
counterparts, as tests/test_native.py holds the JAX package's (the numpy
APSP of `sim/graph_sim.py`, `core/geometry.py`'s nearest view,
`eval/bleu.py`, `tools/kmeans.py`, a Levenshtein and a bucketing written
here, the token blocks' numpy path); `available()` True where g++ is on
the PATH; the build writes only under `vln_goat_tpu_torch/build/` and
never into the JAX package's `csrc/`."""
import math
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from vln_goat_tpu_torch import native
from vln_goat_tpu_torch.core.geometry import nearest_view_index_np
from vln_goat_tpu_torch.data import token_block as ptb
from vln_goat_tpu_torch.native import lib
from vln_goat_tpu_torch.ops._build import BUILD_DIR
from vln_goat_tpu_torch.sim.graph_sim import make_synthetic_scan

HAVE_GXX = shutil.which("g++") is not None
needs_gxx = pytest.mark.skipif(not HAVE_GXX, reason="no g++ on the PATH")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_available_where_gxx():
    assert native.available() == HAVE_GXX


@needs_gxx
def test_build_only_under_the_port_build_dir():
    path = lib.build()
    assert path.parent == BUILD_DIR == \
        lib.SOURCE.parent.parent.parent / "build"
    assert path.name.startswith("libgoat_native_") and path.exists()
    assert not os.path.exists(os.path.join(REPO, "csrc", path.name))
    assert lib.SOURCE.parent != Path(REPO) / "csrc"


@needs_gxx
def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "goat_native.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(lib, "SOURCE", bad)
    monkeypatch.setattr(lib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        lib.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_no_compiler_means_unavailable(tmp_path, monkeypatch):
    monkeypatch.setattr(lib, "_lib", None)
    monkeypatch.setattr(lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(lib, "compiler", lambda: None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.bucket_by_size(np.array([1, 2], np.int32), 4)


@needs_gxx
@pytest.mark.parametrize("seed", [1, 2])
def test_apsp_matches_numpy(seed):
    g = make_synthetic_scan("n0", num_vps=25, seed=seed)
    edges, weights = [], []
    for v in range(g.num_vps):
        for k in range(int(g.cand_mask[v].sum())):
            w = int(g.cand_local[v, k])
            if v < w:
                edges.append((v, w))
                weights.append(float(g.cand_dist[v, k]))
    dist, hops, nexthop = native.apsp(g.num_vps, np.asarray(edges),
                                      np.asarray(weights))
    np.testing.assert_allclose(dist, g.dist, atol=1e-4)
    np.testing.assert_array_equal(hops, g.hops)
    for a in range(g.num_vps):
        for b in range(g.num_vps):
            cur, n = a, 0
            while cur != b and n <= g.num_vps:
                cur = int(nexthop[cur, b])
                n += 1
            assert cur == b and n == g.hops[a, b]


@needs_gxx
def test_nearest_view_matches_python():
    rng = np.random.default_rng(0)
    h = rng.uniform(-2 * math.pi, 2 * math.pi, (20, 10)).astype(np.float32)
    e = rng.uniform(-0.9, 0.9, (20, 10)).astype(np.float32)
    got = native.nearest_view(h, e)
    assert got.shape == (20, 10)
    np.testing.assert_array_equal(got, nearest_view_index_np(h, e))


@needs_gxx
def test_bleu_stats_match_python():
    from vln_goat_tpu_torch.eval.bleu import corpus_bleu

    rng = np.random.default_rng(1)
    hyps = [list(rng.integers(0, 20, rng.integers(5, 15))) for _ in range(8)]
    refs = [[list(rng.integers(0, 20, rng.integers(5, 15)))
             for _ in range(2)] for _ in range(8)]
    clipped = np.zeros(4, np.int64)
    totals = np.zeros(4, np.int64)
    hyp_len = ref_len = 0
    for h, rs in zip(hyps, refs):
        c, t, cl = native.bleu_stats(np.asarray(h, np.int32), rs)
        clipped += c
        totals += t
        hyp_len += len(h)
        ref_len += cl
    prec = [clipped[n] / totals[n] if totals[n] else 0.0 for n in range(4)]
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / hyp_len)
    bleu = 0.0 if prec[3] == 0 else \
        bp * math.exp(sum(math.log(p) for p in prec) / 4)
    py_bleu, py_prec = corpus_bleu(hyps, refs)
    assert abs(bleu - py_bleu) < 1e-9
    assert abs(prec[0] * bp - py_prec[0]) < 1e-9


def _levenshtein(a, b):
    d = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, d[0] = d[0], i
        for j, y in enumerate(b, 1):
            prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1, prev + (x != y))
    return d[-1]


@needs_gxx
def test_edit_distance_matches_python():
    rng = np.random.default_rng(3)
    a = [list(rng.integers(0, 5, rng.integers(0, 9))) for _ in range(12)]
    b = [list(rng.integers(0, 5, rng.integers(0, 9))) for _ in range(12)]
    np.testing.assert_array_equal(native.edit_distance_batch(a, b),
                                  [_levenshtein(x, y) for x, y in zip(a, b)])


def _buckets(sizes, max_tokens, max_items):
    """Greedy batch-by-size ids in the given order."""
    out, bid, n, big = [], 0, 0, 0
    for s in sizes:
        if n and ((n + 1) * max(big, s) > max_tokens or n + 1 > max_items):
            bid, n, big = bid + 1, 0, 0
        n, big = n + 1, max(big, s)
        out.append(bid)
    return out


@needs_gxx
@pytest.mark.parametrize("max_tokens,max_items", [(30, 1 << 30), (40, 3)])
def test_bucket_by_size_matches_python(max_tokens, max_items):
    sizes = np.array([10, 10, 10, 50, 10, 3, 7, 12, 1, 9], np.int32)
    got = native.bucket_by_size(sizes, max_tokens, max_items)
    np.testing.assert_array_equal(got, _buckets(sizes, max_tokens,
                                                max_items))
    if max_items > 100:
        assert got[:5].tolist() == [0, 0, 0, 1, 2]


@needs_gxx
def test_kmeans_lloyd_matches_torch():
    from vln_goat_tpu_torch.tools.kmeans import kmeans_fit

    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(0, .1, (20, 4)),
                        rng.normal(4, .1, (20, 4))]).astype(np.float32)
    centers, assign = native.kmeans_lloyd(x, np.stack([x[0], x[-1]]), 20)
    np.testing.assert_allclose(centers, [x[:20].mean(0), x[20:].mean(0)],
                               atol=1e-5)
    _, ref = kmeans_fit(x, 2, seed=0, device="cpu")
    assert (assign == ref).all() or (assign == 1 - ref).all()


@needs_gxx
@pytest.mark.parametrize("mode", ["none", "eos", "complete", "complete_doc"])
def test_token_blocks_match_numpy(mode):
    sizes = np.random.default_rng(0).integers(1, 12, 64)
    ref = ptb.token_block_slices(sizes, 16, mode, use_native=False)
    np.testing.assert_array_equal(native.token_block_slices(sizes, 16, mode),
                                  ref)
    np.testing.assert_array_equal(
        native.block_to_dataset_index(sizes, ref),
        ptb.block_to_dataset_index(sizes, ref, use_native=False))
