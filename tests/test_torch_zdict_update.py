"""The port's online instruction z-dict update (`tools/zdict.py`) and the
CLI's `--z_instr_update` against the JAX package, on the CPU:

- `word_tokenize`, `WordPicker.pick` (the fallback nouns and a
  category_mapping.tsv), `subword_tokens_of` and `align_word_embeddings`
  equal to JAX's;
- `update_instr_zdict` on a tiny GoatModel whose weights the JAX model
  takes too (JAX `torch_to_flax`): the same keys in the same order, p(z)
  equal, each key's feature within 1e-5 of JAX's (float32 on both sides,
  one language layer; the sums run in another order);
- the two TSV writers give JAX's bytes, and the loaders read them back;
- a short causal `cli train --z_instr_update --update_iter 1`: the banks
  after each refresh are what JAX's update_instr_zdict gives on the same
  weights and items, and the TSV holds them.
"""
import json

import numpy as np
import pytest

from vln_goat_tpu.config import GoatConfig as JaxConfig
from vln_goat_tpu.models.goat import GoatModel as JaxModel
from vln_goat_tpu.tools import zdict as jz
from vln_goat_tpu.train.checkpoint import torch_to_flax
from vln_goat_tpu_torch import cli
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import TINY, build_model
from vln_goat_tpu_torch.rollout import env as penv
from vln_goat_tpu_torch.tools import zdict as pz
from test_torch_cli import COMMON, tiny
from test_torch_gate_witness import one_thread  # noqa: F401

FEAT_ATOL = 1e-5
INSTRS = [
    "Walk past the tables, then turn left into the kitchen.",
    "Go up the stairs and wait by the 2nd doorway on your right.",
    "Exit the bedroom; head towards the couches and stop in front of "
    "the TV.",
    "Climb the staircase, pass the railing and enter the bathroom ahead.",
    "Don't stop at the sink - continue straight through the hallways.",
]
WORDS = ("walk past the table then turn left into kitchen go up stairs "
         "and wait by door on your right exit bedroom head towards couch "
         "stop in front of tv climb pass railing enter bathroom ahead sink "
         "continue straight through hallway chairs lamps windows").split()


def _cat_file(tmp_path):
    rows = [("1", "tables", "table"), ("2", "couch", "sofa"),
            ("3", "stair", "stairs"), ("4", "doorway", "door"),
            ("5", "tv", "television"), ("6", "hallway", "hall")]
    path = tmp_path / "category_mapping.tsv"
    path.write_text("index\traw_category\tcategory\n" + "".join(
        "\t".join(r) + "\n" for r in rows))
    return str(path)


def _items(n, vocab, seed):
    """Items whose instructions draw words from WORDS and whose encodings
    have one id per word between the leading and trailing specials."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        words = list(rng.choice(WORDS, int(rng.integers(4, 12))))
        out.append(dict(instruction=" ".join(words), instr_encoding=[0] + [
            int(t) for t in rng.integers(3, vocab, len(words))] + [2]))
    return out


def test_word_picker_and_alignment(tmp_path):
    cat = _cat_file(tmp_path)
    for instr in INSTRS:
        assert pz.word_tokenize(instr) == jz.word_tokenize(instr)
        for f in (None, cat):
            assert pz.WordPicker(f).pick(instr) == jz.WordPicker(f).pick(
                instr), (instr, f)
    vocab = {i: w for i, w in enumerate(
        ["<s>", "<pad>", "</s>", "walk", "##ing", "past", "the", "tab",
         "##les", "left"])}
    enc = [0, 3, 4, 5, 6, 7, 8, 9, 2]
    toks = pz.subword_tokens_of(enc, vocab)
    assert toks == jz.subword_tokens_of(enc, vocab)
    emb = np.arange(12 * 3, dtype=np.float32).reshape(12, 3)
    picks = [(0, "walk"), (3, "table"), (3, "tab2"), (4, "left")]

    def cont(t):
        return t.startswith("#")
    got = pz.align_word_embeddings(toks, emb, picks, cont)
    ref = jz.align_word_embeddings(toks, emb, picks, cont)
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def tiny_models():
    cfg = dict(TINY, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    tm = build_model(GoatConfig(**cfg), "cpu", seed=3)
    return JaxModel(JaxConfig(**cfg)), tm


def _jax_params(model):
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return torch_to_flax(sd)


def _assert_same(got, ref):
    """(feats, p(z)) dict pairs of the port and JAX: keys in order, p(z)
    equal, features within FEAT_ATOL."""
    for g, r in zip(got, ref):
        assert list(g) == list(r)
    for k, r in ref[0].items():
        assert got[0][k].shape == r.shape
        np.testing.assert_allclose(got[0][k], r, atol=FEAT_ATOL, rtol=0,
                                   err_msg=k)
    assert got[1] == ref[1]


@pytest.mark.parametrize("subword", [False, True])
def test_update_instr_zdict_matches_jax(tiny_models, subword, tmp_path):
    jm, tm = tiny_models
    data = _items(11, TINY["vocab_size"], seed=5)
    picker_file = _cat_file(tmp_path) if subword else None
    if subword:
        # every other word split into a head and a '##' continuation
        id_to_token = {i: f"w{i}" for i in range(TINY["vocab_size"])}
        for i in range(3, TINY["vocab_size"], 2):
            id_to_token[i] = f"##w{i}"

        def tokens_of(d):
            return jz.subword_tokens_of(d["instr_encoding"], id_to_token)

        def is_cont(t):
            return t.startswith("#")
    else:
        def tokens_of(d):
            return d["instruction"].split()

        def is_cont(t):
            return False
    tm.train()
    zd, *got = pz.update_instr_zdict(
        tm, data, pz.WordPicker(picker_file), tokens_of, is_cont,
        batch_size=4, max_len=16)
    assert tm.training                      # the mode is given back
    jzd, *ref = jz.update_instr_zdict(
        jm, _jax_params(tm), data, jz.WordPicker(picker_file), tokens_of,
        is_cont, batch_size=4, max_len=16)
    lm_f, dr_f, lm_pz, dr_pz = got
    assert lm_f and dr_f
    _assert_same((lm_f, lm_pz), (ref[0], ref[2]))
    _assert_same((dr_f, dr_pz), (ref[1], ref[3]))
    for k, v in jzd["instr_zdict"].items():
        np.testing.assert_allclose(zd["instr_zdict"][k], np.asarray(v),
                                   atol=FEAT_ATOL, rtol=0, err_msg=k)


def test_tsv_writers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    lm = {k: rng.standard_normal(8).astype(np.float32)
          for k in ("door", "table", "stairs")}
    dr = {k: rng.standard_normal(8).astype(np.float32)
          for k in ("left", "up")}
    lm_p = {"door": 0.5, "table": 0.25, "stairs": 0.25}
    dr_p = {"left": 2 / 3, "up": 1 / 3}
    img = {f"room{i}": rng.standard_normal(8).astype(np.float32)
           for i in range(4)}
    img_p = {k: 0.1 * (i + 1) for i, k in enumerate(img)}
    for mod, tag in ((pz, "port"), (jz, "jax")):
        mod.save_instr_zdict_tsv(str(tmp_path / f"i_{tag}.tsv"), lm, dr,
                                 lm_p, dr_p)
        mod.save_img_zdict_tsv(str(tmp_path / f"m_{tag}.tsv"), img, img_p)
    for kind in ("i", "m"):
        assert (tmp_path / f"{kind}_port.tsv").read_bytes() == \
            (tmp_path / f"{kind}_jax.tsv").read_bytes()
    back = pz.load_instr_zdict_tsv(str(tmp_path / "i_port.tsv"))
    np.testing.assert_array_equal(back["instr_landmark_features"],
                                  np.stack(list(lm.values())))
    np.testing.assert_array_equal(back["instr_direction_pzs"],
                                  np.float32(list(dr_p.values())))
    back = pz.load_img_zdict_tsv(str(tmp_path / "m_port.tsv"))
    np.testing.assert_array_equal(back["img_features"],
                                  np.stack(list(img.values())))


def test_cli_refresh_matches_jax(tmp_path, monkeypatch):
    """`--do_back_txt --z_instr_update --update_iter 1` for 2 iterations:
    two refreshes, the second cycle decoding and training with the first's
    banks; the last refresh's banks against JAX's on its weights."""
    tiny(monkeypatch)
    orig = penv.make_synthetic_dataset

    def worded(graphs, n, vocab_size=1000, max_instr_len=48, path_len=(4, 7),
               seed=0):
        items = orig(graphs, n, vocab_size=vocab_size,
                     max_instr_len=max_instr_len, path_len=path_len,
                     seed=seed)
        for it, w in zip(items, _items(n, vocab_size, seed + 100)):
            it.update(w)
        return items

    monkeypatch.setattr(penv, "make_synthetic_dataset", worded)
    seen = []
    update = cli._update_zdict

    def spy(args, rt, model, record_file):
        update(args, rt, model, record_file)
        seen.append(({k: v for k, v in rt["banks"].items()},
                     {k: v.clone() for k, v in model.state_dict().items()},
                     list(rt["batchers"]["train"].data[:512])))

    monkeypatch.setattr(cli, "_update_zdict", spy)
    out = str(tmp_path / "z")
    cli.main(["--mode", "train", "--synthetic", "--output_dir", out,
              "--iters", "2", "--log_every", "1", "--do_back_txt",
              "--z_instr_update", "--update_iter", "1", "--remat", "none",
              "--dropout", "0"] + COMMON)
    assert len(seen) == 2
    banks, sd, data = seen[-1]
    jcfg = JaxConfig.for_dataset(
        "r2r", num_l_layers=1, num_pano_layers=1, num_x_layers=1,
        image_feat_size=16, do_back_txt=True, hidden_size=32,
        num_attention_heads=2, intermediate_size=64, vocab_size=64,
        max_position_embeddings=64, hidden_dropout_prob=0.0)
    params = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    _, lm_f, dr_f, lm_p, dr_p = jz.update_instr_zdict(
        JaxModel(jcfg), params, data, jz.WordPicker(),
        lambda d: d["instruction"].split(), lambda t: False, max_len=16)
    assert lm_f and dr_f
    for kind, feats, pzs in (("landmark", lm_f, lm_p),
                             ("direction", dr_f, dr_p)):
        np.testing.assert_allclose(
            banks[f"instr_z_{kind}_features"], np.stack(list(feats.values())),
            atol=FEAT_ATOL, rtol=0)
        np.testing.assert_array_equal(banks[f"instr_z_{kind}_pzs"],
                                      np.float32(list(pzs.values())))
    back = pz.load_instr_zdict_tsv(f"{out}/backdoor_update_features.tsv")
    for k, v in pz.instr_bank_names(back).items():
        np.testing.assert_array_equal(v, banks[k])
    log = open(f"{out}/train.log").read()
    assert log.count("z-dict refreshed") == 2
    json.load(open(f"{out}/args.json"))
