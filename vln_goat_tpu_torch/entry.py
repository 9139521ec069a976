"""Entry points of the port: the R2R greedy-decode rollout that the JAX
package's `__graft_entry__.entry()` compiles, built and run with PyTorch.

    model, ro, batcher = build_flagship("cuda")
    out = greedy_rollout(ro, batcher.next_batch()[1])

`build_flagship` mirrors `__graft_entry__._flagship`: a 60-viewpoint
synthetic scan, RolloutConfig(num_nodes=48, horizon=15, feat_dim=768),
batches of 8 episodes with instructions of 60 tokens, the full-width R2R
model with seeded random weights (`tiny=True`: the small test config).
"""
from __future__ import annotations

from typing import Dict

import torch

from .config import GoatConfig
from .device import resolve
from .models.goat import GoatModel
from .rollout.env import EpisodeBatcher, make_synthetic_dataset
from .rollout.rollout import NavRollout, RolloutConfig, to_numpy
from .rollout.trajectory import assemble_trajectories
from .rollout.world import NavWorld
from .sim.graph_sim import make_synthetic_scan
from .train.params import init_goat_params

TINY = dict(num_l_layers=1, num_x_layers=1, num_pano_layers=1,
            hidden_size=32, num_attention_heads=2, intermediate_size=64,
            vocab_size=64, max_position_embeddings=64, image_feat_size=16)


def build_model(cfg: GoatConfig, device="cuda", seed: int = 0) -> GoatModel:
    """GoatModel with seeded random weights, allocated and drawn on
    `device`, in eval mode."""
    dev = resolve(device)
    with torch.device("meta"):
        model = GoatModel(cfg)
    model = model.to_empty(device=dev)
    return init_goat_params(model, seed).eval()


def build_flagship(device="cuda", tiny: bool = False,
                   use_fused_attention: bool = True, seed: int = 0):
    """(model, rollout, batcher) of the flagship R2R configuration.
    use_fused_attention=False routes every attention to the eager PyTorch
    path instead of the fused kernel."""
    dev = resolve(device)
    if tiny:
        cfg = GoatConfig(use_fused_attention=use_fused_attention, **TINY)
        rcfg = RolloutConfig(num_nodes=12, horizon=3, feat_dim=16)
        n_vps, n_items, instr = 10, 16, 16
    else:
        cfg = GoatConfig.for_dataset(
            "r2r", use_fused_attention=use_fused_attention)
        rcfg = RolloutConfig(num_nodes=48, horizon=15, feat_dim=768)
        n_vps, n_items, instr = 60, 16, 60

    scans = [make_synthetic_scan("s0", num_vps=n_vps, seed=0)]
    world = NavWorld.build(scans, feat_dim=rcfg.feat_dim, seed=0, device=dev)
    model = build_model(cfg, dev, seed)
    ro = NavRollout(model, world, rcfg)
    graphs = {g.scan_id: g for g in scans}
    data = make_synthetic_dataset(graphs, n_items, vocab_size=cfg.vocab_size,
                                  path_len=(3, min(6, rcfg.horizon)), seed=1)
    batcher = EpisodeBatcher(data, graphs, ["s0"], batch_size=8,
                             max_instr_len=instr,
                             max_gt_len=rcfg.horizon + 1, device=dev)
    return model, ro, batcher


def greedy_rollout(ro: NavRollout, batch: Dict[str, torch.Tensor]) -> dict:
    """Greedy decode of one batch: the rollout's outputs (tensors on the
    rollout's device, `fused_logits` [T, B, G] per step) plus
    `trajectories`, each episode's path of local viewpoint ids."""
    out = ro.rollout(batch)
    out["fused_logits"] = out["logits"]
    out["trajectories"] = assemble_trajectories(
        to_numpy({k: batch[k] for k in ("start_vp",)}),
        to_numpy({k: out[k] for k in ("segs", "seg_hops", "node_vp",
                                      "back_seg", "back_hops")}))
    return out
