"""A cell's configuration and traffic cut to the port's test widths, for
the benchmark's CPU tests: every size small, every switch as the cell has
it."""
from __future__ import annotations

import copy

TINY_MODEL = dict(num_l_layers=1, num_x_layers=1, num_pano_layers=1,
                  hidden_size=32, num_attention_heads=2,
                  intermediate_size=64, vocab_size=64,
                  max_position_embeddings=96, image_feat_size=16,
                  max_action_len=6)


def shrink(cfg: dict, traffic: dict):
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["model"].update(TINY_MODEL)
    if cfg["model"]["obj_feat_size"]:
        cfg["model"]["obj_feat_size"] = 16
    cfg["world"].update(scans=2, viewpoints=14, degree=3, num_nodes=16,
                        objects_per_viewpoint=min(
                            3, cfg["world"]["objects_per_viewpoint"]))
    cfg["banks"] = dict(instr_direction_rows=4, instr_landmark_rows=5,
                        img_rows=6, front_clusters=3)
    cfg.setdefault("pretrain", {})["mrc_prob_dim"] = 8
    traffic.update(batch_size=4, episodes=24, path_hops=[3, 4],
                   trace_updates=1)
    if traffic["job"] == "finetune":
        traffic.update(instr_len=24, gt_cap=6, bucket_caps=[4, 6])
    else:
        traffic.update(instr_len=24, max_steps=6, max_gmap=16)
    return cfg, traffic
