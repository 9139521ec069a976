"""Rendering-free graph simulator (counterpart of
vln_goat_tpu/sim/graph_sim.py): per-scan dense tables of the Matterport
connectivity graph -- discretized 30-degree views, per-view navigable
neighbours, candidate enumeration, all-pairs shortest paths -- built once
on the host so the episode loop runs as tensor lookups.

A copy of the JAX package's module with the all-pairs shortest paths
computed here in numpy, without that package's native library.
`load_connectivity` reads Matterport connectivity JSONs and
`load_scanvp_cands` the reference's candidate cache; `make_synthetic_scan`
stands in for a scan.
"""
from __future__ import annotations

import heapq
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from ..core import geometry as G


@dataclass
class ScanGraph:
    """Per-scan packed tables (host, numpy)."""

    scan_id: str
    vp_ids: List[str]              # local index -> viewpoint id
    pos: np.ndarray                # [V, 3] float32
    cand_local: np.ndarray         # [V, K] int32 neighbor local idx, -1 pad
    cand_ptid: np.ndarray          # [V, K] int32 best discretized view
    cand_heading: np.ndarray       # [V, K] float32 absolute direction heading
    cand_elev: np.ndarray          # [V, K] float32 absolute direction elevation
    cand_dist: np.ndarray          # [V, K] float32 euclidean edge length
    cand_mask: np.ndarray          # [V, K] bool
    dist: np.ndarray               # [V, V] float32 all-pairs shortest dist
    hops: np.ndarray               # [V, V] int32 all-pairs shortest #edges
    nexthop: np.ndarray            # [V, V] int32 first hop on shortest path

    @property
    def num_vps(self) -> int:
        return len(self.vp_ids)

    @property
    def index(self) -> Dict[str, int]:
        # cached: this sits in the per-item eval loop
        idx = getattr(self, "_index", None)
        if idx is None:
            idx = {v: i for i, v in enumerate(self.vp_ids)}
            object.__setattr__(self, "_index", idx)
        return idx

    def shortest_path(self, a: int, b: int) -> List[int]:
        """Local-index path a -> b (exclusive of a), like FloydGraph.path."""
        path, cur = [], a
        while cur != b:
            cur = int(self.nexthop[cur, b])
            if cur < 0:
                return []
            path.append(cur)
            if len(path) > self.num_vps:
                raise RuntimeError("nexthop cycle")
        return path


def _all_pairs(pos: np.ndarray, edges: Sequence[tuple]) -> tuple:
    """Dijkstra from every source over euclidean edge weights, mirroring
    nx.all_pairs_dijkstra (r2r/env.py:184-188) with the arithmetic of the
    JAX package's native `apsp` (csrc/goat_native.cpp): float32 sums, a
    relaxation only when strictly shorter, the heap ordered by (distance,
    node).  Returns dist [V, V] float32 (inf when unreachable), hops
    [V, V] int32 and nexthop [V, V] int32 (first node after the source,
    -1 when unreachable, the node itself on the diagonal)."""
    V = len(pos)
    adj: List[List[tuple]] = [[] for _ in range(V)]
    if edges:
        e = np.asarray(edges, np.int64)
        p = np.asarray(pos, np.float32)
        ws = np.linalg.norm(p[e[:, 0]] - p[e[:, 1]], axis=1).astype(np.float32)
        for (a, b), w in zip(e.tolist(), ws):
            adj[a].append((b, w))
            adj[b].append((a, w))
    dist = np.full((V, V), np.inf, np.float32)
    hops = np.zeros((V, V), np.int32)
    nexthop = np.full((V, V), -1, np.int32)
    for s in range(V):
        d = [np.float32(np.inf)] * V
        h = [0] * V
        pred = [-1] * V
        d[s] = np.float32(0.0)
        heap = [(0.0, s)]
        while heap:
            du, u = heapq.heappop(heap)
            if du > d[u]:
                continue
            for v, w in adj[u]:
                nd = np.float32(du) + w
                if nd < d[v]:
                    d[v] = nd
                    h[v] = h[u] + 1
                    pred[v] = u
                    heapq.heappush(heap, (float(nd), v))
        dist[s] = d
        hops[s] = h
        for t in range(V):
            if t == s:
                nexthop[s, t] = t
            elif pred[t] >= 0:
                cur = t
                while pred[cur] != s:
                    cur = pred[cur]
                nexthop[s, t] = cur
    return dist, hops, nexthop


# MatterSim camera defaults (r2r/env.py:43-55): 640x480, VFOV 60 degrees.
# HFOV follows from the aspect ratio.
SWEEP_VFOV = math.radians(60.0)
SWEEP_HFOV = 2.0 * math.atan(math.tan(SWEEP_VFOV / 2.0) * 640.0 / 480.0)


def sweep_view_for(heading: float, elevation: float,
                   hfov: float = SWEEP_HFOV, vfov: float = SWEEP_VFOV):
    """Replicate the reference's 36-view candidate sweep for one direction
    (make_candidate, r2r/env.py:249-314): among the discretized views whose
    camera frustum contains the direction, pick the one minimizing
    sqrt(rel_h^2 + rel_e^2); first (lowest view index) wins ties (the sweep
    keeps a view only when strictly closer).  Returns (view_ix, rel_h,
    rel_e) or None when no view sees the direction (MatterSim would drop
    such a neighbor from every navigableLocations list)."""
    best = None
    for ix in range(36):
        cam_h = float(G.VIEW_HEADINGS[ix])
        cam_e = float(G.VIEW_ELEVATIONS[ix])
        dh = math.atan2(math.sin(heading - cam_h), math.cos(heading - cam_h))
        de = elevation - cam_e
        if abs(dh) > hfov / 2.0 or abs(de) > vfov / 2.0:
            continue
        d = math.sqrt(dh * dh + de * de)
        if best is None or d < best[0]:
            best = (d, ix, dh, de)
    if best is None:
        return None
    return best[1], best[2], best[3]


def build_scan_graph(scan_id: str, vp_ids: List[str], pos: np.ndarray,
                     edges: Sequence[tuple], max_cands: int = 16,
                     sweep_visibility: bool = False) -> ScanGraph:
    """sweep_visibility=True applies the MatterSim view-frustum rule when
    assigning candidate views: a neighbor outside every view's frustum is
    dropped (exactly what the reference's 36-view sweep over
    `navigableLocations` does); otherwise the nearest view is chosen by
    angular distance like the sweep's argmin.  False (default) keeps the
    graph-adjacency approximation: every neighbor is a candidate with the
    globally nearest view."""
    V = len(vp_ids)
    K = max_cands
    cand_local = np.full((V, K), -1, np.int32)
    cand_ptid = np.zeros((V, K), np.int32)
    cand_heading = np.zeros((V, K), np.float32)
    cand_elev = np.zeros((V, K), np.float32)
    cand_dist = np.zeros((V, K), np.float32)
    cand_mask = np.zeros((V, K), bool)

    nbrs: Dict[int, List[int]] = {i: [] for i in range(V)}
    for a, b in edges:
        nbrs[a].append(b)
        nbrs[b].append(a)

    for v in range(V):
        ns = sorted(set(nbrs[v]))
        j = 0
        for w in ns:
            h, e, d = G.rel_heading_elevation_np(pos[v], pos[w])
            if sweep_visibility:
                hit = sweep_view_for(float(h), float(e))
                if hit is None:
                    continue            # invisible from every view: dropped
                ptid = hit[0]
            else:
                ptid = G.nearest_view_index_np(h, e)
            if j >= K:
                raise ValueError(
                    f"scan {scan_id} vp {v} has >{K} candidates")
            cand_local[v, j] = w
            cand_ptid[v, j] = ptid
            cand_heading[v, j] = h
            cand_elev[v, j] = e
            cand_dist[v, j] = d
            cand_mask[v, j] = True
            j += 1

    dist, hops, nexthop = _all_pairs(pos, list(edges))
    return ScanGraph(scan_id, vp_ids, pos.astype(np.float32), cand_local,
                     cand_ptid, cand_heading, cand_elev, cand_dist, cand_mask,
                     dist, hops, nexthop)


# ----------------------------------------------------------------------
# Reference candidate-cache interop: scanvp_candview_relangles.json maps
# '{scan}_{vp}' -> {next_vp: [pointId, _, rel_h, rel_e]} where rel_h/rel_e
# are offsets from the chosen view's center (consumers: r2r/env.py:244,
# pretrain dataset.py:452-462 `heading = view_angle[0] + v[2]`; index 1 is
# read by nothing).
def load_scanvp_cands(path: str, graphs: Dict[str, ScanGraph]) -> int:
    """Overwrite candidate tables from the reference's precomputed
    candidate cache — the exact per-view-sweep candidate sets the authors
    ship — so the real-data path does not depend on the graph-adjacency
    approximation.  Returns the number of (scan, vp) entries applied."""
    with open(path) as f:
        cache = json.load(f)
    applied = 0
    for g in graphs.values():
        K = g.cand_local.shape[1]
        for v, vp_id in enumerate(g.vp_ids):
            entry = cache.get(f"{g.scan_id}_{vp_id}")
            if entry is None:
                continue
            g.cand_local[v] = -1
            g.cand_ptid[v] = 0
            g.cand_heading[v] = 0.0
            g.cand_elev[v] = 0.0
            g.cand_dist[v] = 0.0
            g.cand_mask[v] = False
            j = 0
            for nxt, rec in entry.items():
                if nxt not in g.index:
                    continue
                if j >= K:
                    raise ValueError(
                        f"{g.scan_id}_{vp_id}: >{K} cached candidates")
                w = g.index[nxt]
                ptid = int(rec[0])
                g.cand_local[v, j] = w
                g.cand_ptid[v, j] = ptid
                g.cand_heading[v, j] = float(G.VIEW_HEADINGS[ptid]) + \
                    float(rec[2])
                g.cand_elev[v, j] = float(G.VIEW_ELEVATIONS[ptid]) + \
                    float(rec[3])
                g.cand_dist[v, j] = float(np.linalg.norm(g.pos[v] - g.pos[w]))
                g.cand_mask[v, j] = True
                j += 1
            applied += 1
    return applied


def load_connectivity(connectivity_dir: str, scans: Sequence[str],
                      max_cands: int = 16,
                      sweep_visibility: bool = False) -> Dict[str, ScanGraph]:
    """Load Matterport connectivity JSONs (utils/data.py:76-101 semantics:
    only `included` nodes, edge iff both endpoints included and
    `unobstructed` both ways is not required — the reference keeps an edge
    when item['unobstructed'][j] and the target is included)."""
    out = {}
    for scan in scans:
        with open(os.path.join(connectivity_dir, f"{scan}_connectivity.json")) as f:
            data = json.load(f)
        included = [bool(item["included"]) for item in data]
        vp_ids, pos, remap = [], [], {}
        for i, item in enumerate(data):
            if not included[i]:
                continue
            remap[i] = len(vp_ids)
            vp_ids.append(item["image_id"])
            p = item["pose"]
            # camera z is pose[11] alone — the reference's edge weights and
            # eval distances do NOT add the node height field
            # (utils/data.py:79-83)
            pos.append([p[3], p[7], p[11]])
        edges = set()
        for i, item in enumerate(data):
            if not included[i]:
                continue
            for j, un in enumerate(item["unobstructed"]):
                if un and j < len(included) and included[j]:
                    a, b = remap[i], remap[j]
                    if a != b:
                        edges.add((min(a, b), max(a, b)))
        out[scan] = build_scan_graph(scan, vp_ids, np.asarray(pos, np.float32),
                                     sorted(edges), max_cands,
                                     sweep_visibility=sweep_visibility)
    return out


def make_synthetic_scan(scan_id: str = "synth", num_vps: int = 24,
                        degree: int = 3, seed: int = 0,
                        max_cands: int = 16,
                        sweep_visibility: bool = False) -> ScanGraph:
    """Random geometric connected graph standing in for a Matterport scan
    (test fixture; SURVEY.md section 4 test plan)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((num_vps, 3), np.float32)
    pos[:, :2] = rng.uniform(0, 18.0, (num_vps, 2))
    pos[:, 2] = rng.uniform(0, 1.2, num_vps)
    # connect each node to its `degree` nearest neighbors -> then force
    # connectivity with a spanning chain over nearest unconnected components
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    edges = set()
    for v in range(num_vps):
        for w in np.argsort(d2[v])[:degree]:
            edges.add((min(v, int(w)), max(v, int(w))))
    # union-find to connect components
    parent = list(range(num_vps))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        parent[find(a)] = find(b)
    for v in range(1, num_vps):
        if find(v) != find(0):
            # connect v to the nearest node in the root component
            root_nodes = [u for u in range(num_vps) if find(u) == find(0)]
            w = min(root_nodes, key=lambda u: d2[v, u])
            edges.add((min(v, w), max(v, w)))
            parent[find(v)] = find(0)
    return build_scan_graph(scan_id, [f"{scan_id}_{i:04d}" for i in range(num_vps)],
                            pos, sorted(edges), max_cands,
                            sweep_visibility=sweep_visibility)
