"""Validation through the port's CLI against the JAX package's CLI: both
build their runtime from the same command line (`--synthetic`, the CLI
tests' widths, `--bert_ckpt_file` naming one reference .pt that the port
wrote from its seeded weights) and score the same splits with their own
`run_validation`.  Every greedy path is identical and the metrics agree to
1e-6 (float32 on the CPU on both sides; the metrics are float64 numpy over
the same paths)."""
import numpy as np
import pytest

import vln_goat_tpu.config as jconfig
from vln_goat_tpu import cli as jcli
from vln_goat_tpu_torch import cli
from vln_goat_tpu_torch.config import GoatConfig
from vln_goat_tpu_torch.entry import build_model
from vln_goat_tpu_torch.train.checkpoint import save_reference_checkpoint
from test_torch_cli import COMMON, tiny
from test_torch_gate_witness import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        tiny(mp)
        tiny(mp, jconfig.GoatConfig)
        root = tmp_path_factory.mktemp("cli_jax")
        argv = ["--mode", "valid", "--synthetic", "--output_dir",
                str(root)] + COMMON
        model = build_model(GoatConfig.for_dataset(
            "r2r", num_l_layers=1, num_pano_layers=1, num_x_layers=1,
            image_feat_size=16), "cpu", seed=4)
        pt = str(root / "ref.pt")
        save_reference_checkpoint(model, pt, 1)
        argv += ["--bert_ckpt_file", pt]
        rt = cli.build_runtime(cli.parse_args(argv))
        jrt = jcli.build_runtime(jcli.parse_args(argv[:-4] + argv[-2:]))
        out = {}
        for split in ("val_seen", "val_unseen"):
            out[split] = (cli.run_validation(rt, split),
                          jcli.run_validation(jrt, split))
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("split", ["val_seen", "val_unseen"])
def test_validation_matches_jax_cli(runs, split):
    (m, preds), (jm, jpreds) = runs[split]
    assert len(preds) == len(jpreds) == 16
    assert preds == jpreds
    assert set(m) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(m[k], v, rtol=0, atol=1e-6, err_msg=k)
