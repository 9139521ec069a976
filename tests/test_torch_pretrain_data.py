"""The pretrain CLI's batch stream and the pretraining key surgery against
the JAX package's:

- `pretrain.cli.batch_stream` (the train loop's batches, on the CPU) with
  0 workers (the prefetch thread) and 2 spawned workers
  (`data.worker_pool`) gives the same batches, each equal bit for bit to
  the JAX CLI's `make_batch_np` on its own `build` of the same command
  line (R2R with MLM / SAP / CFP / MRC, REVERIE with OG); the pool
  raises a worker's error, and raises at once when a worker dies
  without a result instead of waiting for it;
- `train.checkpoint.surgery_init_keys` on made-up METER / LXMERT / BERT /
  GOAT state dicts equals the JAX function, key for key and value for
  value, and `init_pretrain_from` overlays a METER-style .pt as the JAX
  one does (the same missing and unused keys, the same merged values)."""
import json
import os

import numpy as np
import pytest
import torch

from vln_goat_tpu.pretrain import cli as jcli
from vln_goat_tpu.train import checkpoint as jck
from vln_goat_tpu_torch.data.worker_pool import BatchWorkerPool
from vln_goat_tpu_torch.pretrain import cli
from vln_goat_tpu_torch.pretrain.train import MetaTaskSampler
from vln_goat_tpu_torch.train import checkpoint as ck
from torch_pretrain_rig import TINY

STEPS = 6


@pytest.fixture(scope="module")
def model_json(tmp_path_factory):
    path = tmp_path_factory.mktemp("pretrain_data") / "tiny.json"
    path.write_text(json.dumps(dict(TINY, max_position_embeddings=128)))
    return str(path)


def argv(model_json, dataset, tasks, workers):
    """The command line both CLIs take (the port's adds --device cpu)."""
    return ["--synthetic", "--model_config", model_json,
            "--dataset", dataset, "--tasks", *tasks, "--mix_ratio",
            *["1"] * len(tasks), "--train_batch_size", "4",
            "--max_txt_len", "32", "--max_steps_traj", "6", "--max_gmap",
            "32", "--num_train_steps", str(STEPS), "--num_workers",
            str(workers), "--max_objects", "5", "--obj_feat_size", "12"]


def stream(args):
    rt = cli.build(args)
    sampler = MetaTaskSampler(args.tasks, args.mix_ratio, seed=args.seed)
    it, close = cli.batch_stream(args, rt["builder"], rt["items"], sampler,
                                 rt["device"])
    try:
        return [(s, t, {k: v.numpy() for k, v in b.items()})
                for s, t, b in it]
    finally:
        close()


@pytest.mark.parametrize("dataset,tasks", [
    ("r2r", ("mlm", "sap", "cfp", "mrc")), ("reverie", ("og", "sap"))])
def test_stream_independent_of_workers_and_equal_to_jax(model_json, dataset,
                                                        tasks):
    runs = {w: stream(cli.parse_args(argv(model_json, dataset, tasks, w)
                                     + ["--device", "cpu"]))
            for w in (0, 2)}
    jargs = jcli.parse_args(argv(model_json, dataset, tasks, 0))
    jrt = jcli.build(jargs)
    assert [(s, t) for s, t, _ in runs[0]] == [(s, t) for s, t, _ in runs[2]]
    assert [s for s, _, _ in runs[0]] == list(range(STEPS))
    for (s, t, b0), (_, _, b2) in zip(runs[0], runs[2]):
        ref = jcli.make_batch_np(jrt["builder"], jrt["items"]["train"], 4,
                                 jargs.seed, "train", t, s)
        assert set(b0) == set(b2) == set(ref)
        for k, v in ref.items():
            assert b0[k].dtype == v.dtype and np.array_equal(b0[k], v), k
            assert np.array_equal(b2[k], v), k


def _no_state():
    return {}


def _dies():
    os._exit(3)


def _build_or_raise(state, desc):
    if desc == 3:
        raise ValueError("intentional")
    return desc


def test_pool_raises_a_worker_error():
    with BatchWorkerPool(_no_state, _build_or_raise, num_workers=2) as pool:
        with pytest.raises(RuntimeError, match="intentional"):
            list(pool.imap(range(6)))


def test_pool_raises_when_a_worker_dies():
    pool = BatchWorkerPool(_dies, _build_or_raise, num_workers=2)
    with pytest.raises(RuntimeError, match="exited with code 3"):
        list(pool.imap(range(4)))


def made_up(fmt):
    r = np.random.default_rng(len(fmt))
    keys = {
        "meter": ["module.text_transformer.embeddings.word_embeddings.weight",
                  "text_transformer.encoder.layer.0.output.dense.weight",
                  "cross_modal_image_layers.1.attention.self.query.bias",
                  "vit_model.visual.proj"],
        "lxmert": ["module.bert.encoder.layer.0.attention.self.key.weight",
                   "bert.encoder.x_layers.2.visual_attention.att.value.bias",
                   "cls.predictions.transform.dense.weight",
                   "bert.embeddings.LayerNorm.weight", "obj_predict_head.w"],
        "bert": ["embeddings.word_embeddings.weight",
                 "encoder.layer.0.attention.output.dense.bias",
                 "module.pooler.dense.weight"],
        "goat": ["bert.embeddings.word_embeddings.weight",
                 "mlm_head.predictions.bias"],
    }[fmt]
    return {k: r.standard_normal((3, 2)).astype(np.float32) for k in keys}


@pytest.mark.parametrize("fmt", ["meter", "lxmert", "bert", "goat"])
def test_surgery_matches_jax(fmt):
    sd = made_up(fmt)
    ref = jck.surgery_init_keys(dict(sd), fmt)
    got = ck.surgery_init_keys({k: torch.from_numpy(v)
                                for k, v in sd.items()}, fmt)
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert np.array_equal(got[k].numpy(), v), k
    with pytest.raises(ValueError):
        ck.surgery_init_keys(sd, "clip")


def test_init_pretrain_from_matches_jax(tmp_path):
    from torch_pretrain_rig import configs, jax_params, port_model

    _, cfg = configs()
    src = port_model(cfg, ("mlm", "sap"), seed=7)
    init = port_model(cfg, ("mlm", "sap"), seed=8)
    # the source's text tower and cross-attention under METER's names
    meter = {}
    for k, v in ck.pretrain_state_dict(src.state_dict()).items():
        if k.startswith("bert.embeddings."):
            meter["module." + k.replace("bert.", "text_transformer.")] = v
        elif k.startswith("bert.lang_encoder."):
            meter[k.replace("bert.lang_encoder", "text_transformer.encoder")] \
                = v
        elif k.startswith("bert.local_encoder.encoder.crossattention."):
            meter[k.replace("bert.local_encoder.encoder.crossattention",
                            "cross_modal_image_layers")] = v
    meter["vit_model.visual.proj"] = torch.ones(2)
    pt = str(tmp_path / "meter.pt")
    torch.save(meter, pt)

    merged, missing, extra = ck.init_pretrain_from(pt, "meter",
                                                   init.state_dict())
    jmerged, jmissing, jextra = jck.init_pretrain_from(
        pt, "meter", {"params": jax_params(init)})
    # the JAX package names an unused subtree by its first unknown node
    assert extra == ["vit_model.visual.proj"] and jextra == ["vit_model"]
    assert len(missing) > 0
    ref = ck.params_from_flax(ck.flatten(jmerged["params"]))
    assert set(ref) == set(merged)
    for k, v in ref.items():
        assert torch.equal(merged[k], v), k
    # every loaded tensor is the source's, both cross encoders took it
    sd = src.state_dict()
    for k in ("embeddings.word_embeddings.weight",
              "lang_encoder.layer.0.attention.self.query.weight",
              "global_encoder.encoder.crossattention.0.crossattention.self."
              "key.weight"):
        assert torch.equal(merged[k], sd[k.replace("global_encoder",
                                                   "local_encoder")]), k
    assert {m.split(".")[0] for m in missing} == {
        jm.split("/")[0] for jm in jmissing}
