"""Model cost accounting: the parameter count and the GFLOPs of each forward
mode at the reference's canonical inputs (counterpart of
vln_goat_tpu/tools/efficiency.py; the reference's utils/efficiency_count.py
profiles batch 8, 44 text tokens, 36 views, 6 map nodes, :120-138).

    python -m vln_goat_tpu_torch.tools.efficiency [--device cpu]

The operations are counted by torch.utils.flop_counter.FlopCounterMode,
which sees aten operators: it cannot see inside a ctypes kernel launch, so
the count runs the attention on its plain PyTorch version (the model's
fused attention turned off), and the output says so.  The JAX package
reads XLA's cost analysis of the compiled program instead, which counts
other operations (elementwise work, for one), so the two GFLOPs differ by
definition; the parameter count is the same.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..config import GoatConfig
from ..device import resolve
from ..entry import build_model

COUNTER = ("torch.utils.flop_counter.FlopCounterMode (matmul, bmm, "
           "addmm, convolution: 2 per multiply-add); attention on its plain "
           "PyTorch version, as the counter cannot see a ctypes kernel")


def canonical_inputs(cfg: GoatConfig, bs: int = 8, txt_len: int = 44,
                     views: int = 36, gmap: int = 6, device="cpu"):
    """The three modes' keyword inputs, zeros (masks all on), on
    `device`."""
    D, A = cfg.hidden_size, cfg.angle_feat_size

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bool, device=device)

    lang = dict(txt_ids=z(bs, txt_len, dtype=torch.int64),
                txt_masks=ones(bs, txt_len))
    pano = dict(view_img_fts=z(bs, views, cfg.image_feat_size),
                loc_fts=z(bs, views, A + 3),
                nav_types=z(bs, views, dtype=torch.int64),
                view_masks=ones(bs, views))
    L = views + 2
    nav = dict(
        txt_embeds=z(bs, txt_len, D), txt_masks=lang["txt_masks"],
        gmap_img_embeds=z(bs, gmap, D),
        gmap_step_ids=z(bs, gmap, dtype=torch.int64),
        gmap_pos_fts=z(bs, gmap, A + 3), gmap_masks=ones(bs, gmap),
        gmap_pair_dists=z(bs, gmap, gmap),
        gmap_visited_masks=z(bs, gmap, dtype=torch.bool),
        vp_img_embeds=z(bs, L, D), vp_pos_fts=z(bs, L, 2 * (A + 3)),
        vp_masks=ones(bs, L), vp_nav_masks=ones(bs, L),
        local_to_gmap=torch.full((bs, L), -1, dtype=torch.int64,
                                 device=device))
    return lang, pano, nav


@torch.no_grad()
def efficiency_count(cfg: Optional[GoatConfig] = None, bs: int = 8,
                     txt_len: int = 44, device="cuda") -> Dict[str, object]:
    """-> {params_m, language_gflops, panorama_gflops, navigation_gflops,
    counter}: the model of `cfg` (R2R's by default) with seeded weights,
    in eval mode, on `device`."""
    cfg = (cfg or GoatConfig.for_dataset("r2r")).replace(
        use_fused_attention=False)
    dev = resolve(device)
    model = build_model(cfg, dev).eval()
    out: Dict[str, object] = {
        "params_m": sum(p.numel() for p in model.parameters()) / 1e6}
    lang, pano, nav = canonical_inputs(cfg, bs=bs, txt_len=txt_len,
                                       device=dev)
    for key, fn, kw in (("language", model.forward_text, lang),
                        ("panorama", model.forward_panorama, pano),
                        ("navigation", model.forward_navigation, nav)):
        counter = FlopCounterMode(display=False)
        with counter:
            fn(**kw)
        out[f"{key}_gflops"] = counter.get_total_flops() / 1e9
    out["counter"] = COUNTER
    return out


def main(argv=None):
    p = argparse.ArgumentParser("vln_goat_tpu_torch.tools.efficiency")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(efficiency_count(device=args.device), indent=2))


if __name__ == "__main__":
    main()
