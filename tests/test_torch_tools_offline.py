"""The port's offline tools against the JAX package's, on the CPU:

- `tools/efficiency.py`: the parameter count of the tiny model equals the
  JAX package's `count_params`; the GFLOPs of the three modes (torch's
  FlopCounterMode, the attention on its plain version) are recorded, not
  compared: the JAX package reads XLA's cost analysis, which counts other
  operations;
- `tools/do_utils.py` with stub renderer and VQA functions: the room-type
  TSV (one process and the spawned pool, with resume), `load_room_types`,
  `build_image_zdict`, `build_text_zdict` and `count_corpus_words` give
  the JAX package's numbers and TSV bytes; a worker whose factory raises
  ends the pool with RuntimeError;
- `make_blip_vqa` raises RuntimeError naming BLIP where the weights are
  absent (nothing is downloaded).
"""
import numpy as np
import pytest
import jax

from vln_goat_tpu.config import GoatConfig as JaxConfig
from vln_goat_tpu.models.goat import GoatModel as JaxModel
from vln_goat_tpu.tools import do_utils as jdo
from vln_goat_tpu.tools.zdict import WordPicker as JaxPicker
from vln_goat_tpu.train.params import count_params, init_goat_params
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import TINY
from vln_goat_tpu_torch.tools import do_utils as pdo
from vln_goat_tpu_torch.tools.efficiency import efficiency_count
from vln_goat_tpu_torch.tools.zdict import WordPicker
from torch_tools_stubs import failing_vqa, fake_render, fake_vqa

SCAN_VPS = [(f"s{i % 2}", f"vp{i}") for i in range(6)]


@pytest.mark.parametrize("extra", [{}, dict(num_l_layers=2, num_x_layers=2,
                                             num_pano_layers=2)],
                         ids=["tiny", "two_layers"])
def test_efficiency_params_match_jax(extra):
    """R2R's configuration at the test widths, as the JAX tool counts
    it.  (The causal configuration is left out: the port builds the
    reference's front_txt_encoder, which no forward calls and the JAX
    package's lazy init does not create; REVERIE's panorama needs object
    inputs, which neither package's canonical inputs hold.)"""
    kw = dict(TINY, **extra)
    got = efficiency_count(GoatConfig(**kw), bs=2, txt_len=12,
                           device="cpu")
    jm = JaxModel(JaxConfig(**kw))
    ref = count_params(init_goat_params(jm, jax.random.PRNGKey(0)))
    assert got["params_m"] == ref / 1e6
    for mode in ("language", "panorama", "navigation"):
        assert got[f"{mode}_gflops"] > 0
    assert "plain" in got["counter"]


def test_room_types_and_image_zdict(tmp_path):
    out = {}
    for mod, tag in ((pdo, "port"), (jdo, "jax")):
        path = str(tmp_path / f"rooms_{tag}.tsv")
        mod.extract_room_types(SCAN_VPS, fake_vqa(), fake_render(), path)
        out[tag] = path
    assert open(out["port"], "rb").read() == open(out["jax"], "rb").read()
    rooms = pdo.load_room_types(out["port"])
    assert rooms == jdo.load_room_types(out["jax"])
    feats = np.random.default_rng(0).standard_normal((6, 36, 8)).astype(
        np.float32)
    index = {sv: i for i, sv in enumerate(SCAN_VPS)}

    def view_features(scan, vp):
        return feats[index[(scan, vp)]]

    for k in (2, 50):
        got = pdo.build_image_zdict(rooms, view_features, ["s0"], top_k=k,
                                    out_tsv=str(tmp_path / "img_p.tsv"))
        ref = jdo.build_image_zdict(rooms, view_features, ["s0"], top_k=k,
                                    out_tsv=str(tmp_path / "img_j.tsv"))
        assert list(got[0]) == list(ref[0]) and got[1] == ref[1]
        for t, v in ref[0].items():
            np.testing.assert_array_equal(got[0][t], v)
        assert (tmp_path / "img_p.tsv").read_bytes() == \
            (tmp_path / "img_j.tsv").read_bytes()


def test_room_type_pool_and_resume(tmp_path):
    path = str(tmp_path / "pano_roomtypes.tsv")
    n = pdo.extract_room_types_pooled(SCAN_VPS, fake_vqa, fake_render, path,
                                      num_workers=2, batch_size=8)
    assert n == len(SCAN_VPS)
    ref = str(tmp_path / "ref.tsv")
    jdo.extract_room_types(SCAN_VPS, fake_vqa(), fake_render(), ref)
    assert pdo.load_room_types(path) == jdo.load_room_types(ref)
    more = SCAN_VPS + [("s9", "new0")]
    assert pdo.extract_room_types_pooled(more, fake_vqa, fake_render, path,
                                         num_workers=2) == 1
    assert set(pdo.load_room_types(path)) == set(more)


def test_room_type_pool_worker_failure_raises(tmp_path):
    # a factory that raises inside a worker ends the pool with an error
    # instead of leaving the parent waiting for the worker's rows
    with pytest.raises(RuntimeError, match="workers"):
        pdo.extract_room_types_pooled(SCAN_VPS, failing_vqa, fake_render,
                                      str(tmp_path / "rt.tsv"),
                                      num_workers=2)


def test_text_zdict_and_corpus_words(tmp_path):
    instrs = ["Walk past the tables and turn left at the door.",
              "Go up the stairs, then right into the kitchen.",
              "Stop in front of the couch by the windows."]
    got = pdo.count_corpus_words(instrs, WordPicker())
    ref = jdo.count_corpus_words(instrs, JaxPicker())
    assert got == ref and got[0] and got[1]
    rng = np.random.default_rng(1)
    table = {w: rng.standard_normal(8).astype(np.float64)
             for w in list(got[0]) + list(got[1])}
    p = pdo.build_text_zdict(*got, table.__getitem__,
                             out_tsv=str(tmp_path / "t_p.tsv"))
    j = jdo.build_text_zdict(*ref, table.__getitem__,
                             out_tsv=str(tmp_path / "t_j.tsv"))
    assert [list(x[1].items()) for x in p] == \
        [list(x[1].items()) for x in j]
    assert (tmp_path / "t_p.tsv").read_bytes() == \
        (tmp_path / "t_j.tsv").read_bytes()


def test_make_blip_vqa_without_weights(tmp_path):
    with pytest.raises(RuntimeError, match="BLIP"):
        pdo.make_blip_vqa(str(tmp_path / "no-blip-here"), device="cpu")
