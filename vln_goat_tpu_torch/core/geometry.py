"""Geometry of the Matterport viewpoint graph: discretized 36-view panorama
angles and relative-position features.

Reference semantics:
- angle_feature / get_angle_fts (map_nav_src/utils/data.py:124-131, 174-181):
  [sin h, cos h, sin e, cos e] tiled to angle_feat_size.
- calculate_vp_rel_pos_fts (utils/data.py:155-172): heading measured with the
  simulator's transposed x-y convention: heading = arcsin(dx/xy_dist),
  flipped through pi when dy < 0.
- view grid: view ix in [0,36); heading (ix%12)*30deg, elevation
  ((ix//12)-1)*30deg ([0-11] down, [12-23] horizon, [24-35] up;
  r2r/env.py:72, get_view_rel_angles utils/data.py:183-198).

A copy of vln_goat_tpu/core/geometry.py: the numpy functions (host
packing) verbatim, and torch counterparts of its jnp ones (device rollout),
shape-polymorphic over leading batch dims.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MAX_DIST = 30.0  # normalisation (models/graph_utils.py:4)
MAX_STEP = 10.0

VIEW_HEADINGS = np.array([(ix % 12) * math.radians(30) for ix in range(36)],
                         np.float32)
VIEW_ELEVATIONS = np.array([((ix // 12) - 1) * math.radians(30) for ix in range(36)],
                           np.float32)


def view_index(heading: float, elevation: float) -> int:
    """Discretize an absolute camera pose to the 36-view grid index."""
    col = int(round(heading / math.radians(30))) % 12
    row = int(round(elevation / math.radians(30))) + 1
    row = min(max(row, 0), 2)
    return row * 12 + col


def angle_feature_np(headings, elevations, angle_feat_size: int = 4):
    """[...]-shaped headings/elevations -> [..., angle_feat_size]."""
    h = np.asarray(headings, np.float32)
    e = np.asarray(elevations, np.float32)
    base = np.stack([np.sin(h), np.cos(h), np.sin(e), np.cos(e)], axis=-1)
    reps = angle_feat_size // 4
    return np.concatenate([base] * reps, axis=-1) if reps > 1 else base


def rel_heading_elevation_np(a_pos, b_pos, base_heading=0.0, base_elevation=0.0):
    """Direction a->b in simulator convention. Inputs [..., 3]."""
    a = np.asarray(a_pos, np.float64)
    b = np.asarray(b_pos, np.float64)
    d = b - a
    xy = np.maximum(np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2), 1e-8)
    xyz = np.maximum(np.sqrt((d ** 2).sum(-1)), 1e-8)
    heading = np.arcsin(np.clip(d[..., 0] / xy, -1, 1))
    heading = np.where(d[..., 1] < 0, np.pi - heading, heading) - base_heading
    elevation = np.arcsin(np.clip(d[..., 2] / xyz, -1, 1)) - base_elevation
    return heading.astype(np.float32), elevation.astype(np.float32), \
        xyz.astype(np.float32)


def pano_view_angles_np(base_view: int):
    """Relative (heading, elevation) of each of the 36 views w.r.t. the
    base view's center (get_view_rel_angles, utils/data.py:183-198)."""
    return (VIEW_HEADINGS - VIEW_HEADINGS[base_view],
            VIEW_ELEVATIONS - VIEW_ELEVATIONS[base_view])


def nearest_view_index_np(heading, elevation):
    """Best discretized view for a direction: the view center minimizing
    angular distance sqrt(dh^2+de^2) — the net effect of the reference's
    36-view candidate sweep (r2r/env.py:249-314)."""
    h = np.asarray(heading, np.float32)[..., None]
    e = np.asarray(elevation, np.float32)[..., None]
    dh = np.arctan2(np.sin(h - VIEW_HEADINGS), np.cos(h - VIEW_HEADINGS))
    de = e - VIEW_ELEVATIONS
    return np.argmin(dh ** 2 + de ** 2, axis=-1).astype(np.int32)


def angle_feature_t(headings, elevations, angle_feat_size: int = 4):
    base = torch.stack([torch.sin(headings), torch.cos(headings),
                        torch.sin(elevations), torch.cos(elevations)], dim=-1)
    reps = angle_feat_size // 4
    return torch.cat([base] * reps, dim=-1) if reps > 1 else base


def rel_heading_elevation_t(a_pos, b_pos, base_heading=0.0,
                            base_elevation=0.0):
    d = b_pos - a_pos
    xy = torch.clamp(torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2), min=1e-8)
    xyz = torch.clamp(torch.sqrt(torch.sum(d ** 2, -1)), min=1e-8)
    heading = torch.arcsin(torch.clamp(d[..., 0] / xy, -1, 1))
    heading = torch.where(d[..., 1] < 0, math.pi - heading, heading) \
        - base_heading
    elevation = torch.arcsin(torch.clamp(d[..., 2] / xyz, -1, 1)) \
        - base_elevation
    return heading, elevation, xyz


def pos_features_t(cur_pos, tgt_pos, base_heading, base_elevation,
                   shortest_dist, shortest_steps, angle_feat_size: int = 4):
    """7-dim position features: [angle_fts(rel_h, rel_e), line_dist/30,
    shortest_dist/30, steps/10].  cur_pos [..., 3] broadcasts against
    tgt_pos [..., 3]."""
    h, e, dist = rel_heading_elevation_t(cur_pos, tgt_pos,
                                         base_heading, base_elevation)
    ang = angle_feature_t(h, e, angle_feat_size)
    extra = torch.stack([dist / MAX_DIST, shortest_dist / MAX_DIST,
                         shortest_steps / MAX_STEP], dim=-1)
    return torch.cat([ang, extra], dim=-1)
