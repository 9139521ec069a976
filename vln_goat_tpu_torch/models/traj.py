"""Trajectory-level helpers shared by CFP extraction and pretraining
(counterpart of vln_goat_tpu/models/traj.py)."""
from __future__ import annotations

import torch


def aggregate_gmap_features(pano_embeds, pano_fused, gmap_visited_step,
                            cand_to_gmap, num_gmap_tokens: int):
    """The map tokens' image embeddings of a trajectory (the JAX package's
    `aggregate_gmap_features`): a visited node takes the fused panorama
    embedding of the step that represents it, a never-visited node the mean
    of the candidate-slot embeddings that saw it, slot 0 ([stop]) zeros.

    pano_embeds [B, T, Lp, D]; pano_fused [B, T, D]; gmap_visited_step
    [B, G]: the step of a visited-node token (-1 otherwise); cand_to_gmap
    [B, T, K]: the gmap slot that candidate occurrence (t, k) of a
    never-visited node feeds (-1 otherwise).  The sums are scatter-adds
    into a trash slot G, as the JAX package's."""
    B, T, Lp, D = pano_embeds.shape
    K = cand_to_gmap.shape[2]
    G = num_gmap_tokens
    dev = pano_embeds.device
    bidx = torch.arange(B, device=dev)

    vstep = gmap_visited_step.long()
    seen = (vstep >= 0)[..., None]
    visited_part = pano_fused[bidx[:, None], vstep.clamp(min=0)]
    visited_part = torch.where(seen, visited_part,
                               torch.zeros_like(visited_part))

    c2g = cand_to_gmap.reshape(B, T * K).long()
    valid = c2g >= 0
    tgt = torch.where(valid, c2g, G)
    contrib = pano_embeds[:, :, :K, :].reshape(B, T * K, D).float()
    contrib = torch.where(valid[..., None], contrib,
                          torch.zeros_like(contrib))
    acc = torch.zeros(B, G + 1, D, device=dev).scatter_add(
        1, tgt[..., None].expand(B, T * K, D), contrib)[:, :G]
    cnt = torch.zeros(B, G + 1, device=dev).scatter_add(
        1, tgt, valid.float())[:, :G]
    unvisited_part = acc / cnt.clamp(min=1.0)[..., None]

    gmap_img = torch.where(seen, visited_part.float(), unvisited_part)
    return torch.cat([torch.zeros_like(gmap_img[:, :1]), gmap_img[:, 1:]],
                     dim=1)
