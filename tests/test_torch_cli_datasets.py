"""The port's CLI on the datasets and the mode of Queue 1 items 5 and 6,
at the real command surface on the CPU (`--device cpu`), at the CLI
tests' widths (test_torch_cli.py `tiny`), on `--synthetic`:

- `--dataset reverie` and `soon` (the synthetic object store: each
  episode's object visible at its goal): train two iterations, then
  `--mode valid --submit`; REVERIE / SOON validate with the grounding
  metrics (rgs, rgspl) and submit `pred_objid` from the store;
- `--dataset rxr --expert_policy ndtw`: train and validate (nDTW, SDTW);
- `--mode extract_cfp_features`: the TSV of the training set's
  trajectories, read back by `tools.cfp_extract.load_cfp_tsv` with finite
  values in [-1, 1] (tanh-pooled)."""
import json
import os

import numpy as np
import pytest

from vln_goat_tpu_torch import cli
from vln_goat_tpu_torch.tools.cfp_extract import load_cfp_tsv
from test_torch_cli import COMMON, tiny
from test_torch_gate_witness import one_thread  # noqa: F401


def _metrics(out):
    return [json.loads(line) for line in
            open(os.path.join(out, "metrics.jsonl"))]


@pytest.mark.parametrize("dataset", ["reverie", "soon"])
def test_objnav_train_valid_submit(tmp_path, monkeypatch, dataset):
    tiny(monkeypatch)
    out = str(tmp_path / dataset)
    flags = ["--dataset", dataset, "--obj_feat_size", "12"] + COMMON
    cli.main(["--mode", "train", "--synthetic", "--output_dir", out,
              "--iters", "2", "--log_every", "2", "--train_alg", "dagger"]
             + flags)
    lines = _metrics(out)
    assert np.isfinite(lines[0]["train/loss"])
    assert any("val_unseen/rgs" in d for d in lines)
    cli.main(["--mode", "valid", "--synthetic", "--output_dir", out,
              "--submit", "--resume_file",
              os.path.join(out, "ckpt_latest")] + flags)
    sub = json.load(open(os.path.join(out, "submit_val_unseen.json")))
    assert sub and all("pred_objid" in p for p in sub)
    args = cli.parse_args(["--mode", "valid", "--synthetic",
                           "--output_dir", out] + flags)
    rt = cli.build_runtime(args)
    oids = set(rt["objects"]["oid"][rt["objects"]["mask"]].tolist())
    assert {p["pred_objid"] for p in sub} <= oids | {-1}
    m, _ = cli.run_validation(rt, "val_seen")
    assert {"rgs", "rgspl", "sr", "spl"} <= set(m)


def test_rxr_ndtw_train_valid(tmp_path, monkeypatch):
    tiny(monkeypatch)
    out = str(tmp_path / "rxr")
    cli.main(["--mode", "train", "--synthetic", "--output_dir", out,
              "--iters", "2", "--log_every", "2", "--dataset", "rxr",
              "--expert_policy", "ndtw", "--train_alg", "dagger"] + COMMON)
    lines = _metrics(out)
    assert np.isfinite(lines[0]["train/loss"])
    val = [d for d in lines if "val_unseen/nDTW" in d]
    assert val and 0 <= val[0]["val_unseen/nDTW"] <= 100
    assert os.path.exists(os.path.join(out, "ckpt_best_val_unseen"))


def test_extract_cfp_features(tmp_path, monkeypatch):
    tiny(monkeypatch)
    out = str(tmp_path / "cfp")
    feats = cli.main(["--mode", "extract_cfp_features", "--synthetic",
                      "--output_dir", out] + COMMON)
    tsv = os.path.join(out, "r2r_cfp_features.tsv")
    read = load_cfp_tsv(tsv, dim=32)
    assert len(read["path_ids"]) == 64
    for k in ("txt_feats", "vp_feats", "gmap_feats"):
        assert read[k].shape == (64, 32)
        assert np.isfinite(read[k]).all() and np.abs(read[k]).max() <= 1
        assert np.array_equal(read[k], feats[k])
