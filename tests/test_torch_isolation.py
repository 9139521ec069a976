"""The port stands alone: no module of `vln_goat_tpu_torch`, and not
`chip_smoke.py`, imports jax, jaxlib, flax, optax or the JAX package; and
the entry points default to the card rather than running on the CPU
unasked."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import vln_goat_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A meta-path finder that refuses the JAX stack and the JAX package, first
# evicting anything of them that is already imported.
BLOCKER = r"""
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "vln_goat_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Blocker())
"""


def _port_modules():
    names = [vln_goat_tpu_torch.__name__]
    for m in pkgutil.walk_packages(vln_goat_tpu_torch.__path__,
                                   vln_goat_tpu_torch.__name__ + "."):
        names.append(m.name)
    return names


def _run(code):
    return subprocess.run([sys.executable, "-c", BLOCKER + code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_blocker_blocks():
    proc = _run("import vln_goat_tpu.config\n")
    assert proc.returncode != 0 and "blocked import" in proc.stderr


def test_port_and_smoke_import_without_jax():
    mods = _port_modules()
    assert len(mods) > 15
    # the training and causal slices' modules are among those imported
    assert {"vln_goat_tpu_torch.ops.dropout",
            "vln_goat_tpu_torch.train.trainer",
            "vln_goat_tpu_torch.tools.kmeans",
            "vln_goat_tpu_torch.tools.zdict",
            "vln_goat_tpu_torch.utils.guard",
            # the fine-tune CLI's slice
            "vln_goat_tpu_torch.cli", "vln_goat_tpu_torch.ops.remat",
            "vln_goat_tpu_torch.data.annotations",
            "vln_goat_tpu_torch.data.feature_db",
            "vln_goat_tpu_torch.eval.metrics",
            "vln_goat_tpu_torch.utils.logger",
            "vln_goat_tpu_torch.utils.misc",
            "vln_goat_tpu_torch.utils.tb",
            # the object branch, the nDTW expert and CFP extraction
            "vln_goat_tpu_torch.models.traj",
            "vln_goat_tpu_torch.pretrain.data",
            "vln_goat_tpu_torch.tools.cfp_extract",
            # pretraining
            "vln_goat_tpu_torch.pretrain.model",
            "vln_goat_tpu_torch.pretrain.train",
            "vln_goat_tpu_torch.pretrain.optimizers",
            "vln_goat_tpu_torch.pretrain.cli",
            "vln_goat_tpu_torch.data.prefetch",
            "vln_goat_tpu_torch.data.worker_pool",
            # the speaker, back-translation, the text metrics and the
            # offline tools
            "vln_goat_tpu_torch.speaker.model",
            "vln_goat_tpu_torch.speaker.speaker",
            "vln_goat_tpu_torch.speaker.backtranslate",
            "vln_goat_tpu_torch.speaker.vocab",
            "vln_goat_tpu_torch.eval.bleu",
            "vln_goat_tpu_torch.eval.spice",
            "vln_goat_tpu_torch.tools.efficiency",
            "vln_goat_tpu_torch.tools.do_utils",
            # more than one process and the native token blocks
            "vln_goat_tpu_torch.parallel",
            "vln_goat_tpu_torch.parallel.distributed",
            "vln_goat_tpu_torch.parallel.mesh",
            "vln_goat_tpu_torch.data.token_block",
            "vln_goat_tpu_torch.native",
            "vln_goat_tpu_torch.native.lib"} <= set(mods)
    code = "import importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in mods) + \
        "import chip_smoke\nprint('ok')\n"
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_smoke_without_card_fails_and_prints_no_result():
    """Run as a user runs it, under the blocker: without a card it
    exits non-zero before printing anything."""
    proc = _run("import runpy\nrunpy.run_path('chip_smoke.py', "
                "run_name='__main__')\n")
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA is not available" in proc.stderr


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_entry_points_default_to_cuda(no_card, tmp_path):
    from vln_goat_tpu_torch.entry import (build_flagship, build_model,
                                          build_train_flagship,
                                          make_causal_banks)
    from vln_goat_tpu_torch.config import GoatConfig
    from vln_goat_tpu_torch.rollout.world import NavWorld
    from vln_goat_tpu_torch.sim.graph_sim import make_synthetic_scan

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_flagship(tiny=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_train_flagship(tiny=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_flagship(tiny=True, causal=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_train_flagship(tiny=True, causal=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(GoatConfig(num_l_layers=1, hidden_size=32,
                               num_attention_heads=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NavWorld.build([make_synthetic_scan("s", num_vps=6)], feat_dim=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_causal_banks(GoatConfig(hidden_size=32, num_attention_heads=2,
                                     do_front_txt=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_train_flagship(tiny=True, compute_dtype="bfloat16",
                             remat="model")
    from vln_goat_tpu_torch import cli
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.build_runtime(cli.parse_args(["--mode", "valid", "--synthetic"]))
    from vln_goat_tpu_torch.pretrain import cli as pretrain_cli
    from vln_goat_tpu_torch.pretrain.model import build_pretrain_model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain_cli.build(pretrain_cli.parse_args(["--synthetic"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pretrain_model(GoatConfig(num_l_layers=1, hidden_size=32,
                                        num_attention_heads=2), ("mlm",))
    from vln_goat_tpu_torch.parallel.distributed import init_distributed
    from vln_goat_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    # raised before any rendezvous is tried
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed("localhost:1", 2, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--mode", "valid", "--synthetic", "--num_processes", "2",
                  "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain_cli.main(["--synthetic", "--num_processes", "2",
                           "--output_dir", str(tmp_path)])
    from vln_goat_tpu_torch.speaker.model import SpeakerConfig
    from vln_goat_tpu_torch.speaker.speaker import Speaker
    from vln_goat_tpu_torch.tools.do_utils import make_blip_vqa
    from vln_goat_tpu_torch.tools.efficiency import efficiency_count
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Speaker(SpeakerConfig(vocab_size=32, feature_size=24,
                              image_feat_size=16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        efficiency_count(GoatConfig(num_l_layers=1, hidden_size=32,
                                    num_attention_heads=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_blip_vqa("no-blip-here")
