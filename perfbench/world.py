"""The benchmark's inputs, made from `--seed`: scans, view features,
episodes, REVERIE objects, the causal banks and the weights.

The generators are frozen copies, so that a change to the program cannot
change the traffic it is measured on:
- `scan_geometry` is `vln_goat_tpu_torch/sim/graph_sim.py`
  `make_synthetic_scan` up to its call of `build_scan_graph` (random
  viewpoints over an 18 x 18 m floor, each joined to its `degree` nearest
  neighbours, components joined to the first);
- `episodes` is `vln_goat_tpu_torch/rollout/env.py`
  `make_synthetic_dataset` (shortest paths between random endpoints, random
  token instructions), with the same set of path lengths for every seed;
- `reverie_objects` is the object store of
  `vln_goat_tpu_torch/pretrain/cli.py` `synthetic_world` (768-wide
  features, boxes, directions, names, ids, a share of empty slots) and its
  goal objects;
- `causal_banks` draws the banks of `vln_goat_tpu_torch/entry.py`
  `make_causal_banks` at its sizes; each front-door bank is one member of
  each of its 24 clusters, drawn directly (the entry picks them with
  k-means from 2048 such rows).

Every draw takes a generator keyed on (seed, tag), so each input has a
stream of its own.  What decides how much work a window holds takes the
traffic file's own seeds: the scans' geometry and the episodes' paths
(`world_seed`), the batcher's gt-length buckets (`batcher_seed`), the
pretraining task mix (`sampler_seed`) and the pretraining batches'
episodes and end points (`feed_seed`).  Every run seed then has the same
sizes in the same order, with its own view features, instructions,
objects, banks, weights and dropout.  Graphs are built twice
from one geometry: by the program's `build_scan_graph` for the program and
by the reference's frozen copy for the reference and for the episodes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

_TAGS = {"scan": 1, "feat": 2, "episodes": 3, "objects": 4, "banks": 5,
         "weights": 6, "step": 9}


def rng(seed: int, tag: str, *more: int) -> np.random.Generator:
    """numpy generator of stream `tag` of run `seed`."""
    return np.random.default_rng([_TAGS[tag], int(seed), *more])


def torch_seed(seed: int, tag: str, *more: int) -> int:
    """A 63-bit torch seed of stream `tag` of run `seed`."""
    return int(np.random.SeedSequence(
        [_TAGS[tag], int(seed), *more]).generate_state(2, np.uint64)[0]
        >> np.uint64(1))


def scan_geometry(scan_id: str, num_vps: int, degree: int,
                  g: np.random.Generator):
    """(vp_ids, pos [V, 3] float32, sorted edges) of a synthetic scan."""
    pos = np.zeros((num_vps, 3), np.float32)
    pos[:, :2] = g.uniform(0, 18.0, (num_vps, 2))
    pos[:, 2] = g.uniform(0, 1.2, num_vps)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    edges = set()
    for v in range(num_vps):
        for w in np.argsort(d2[v])[:degree]:
            edges.add((min(v, int(w)), max(v, int(w))))
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
            root_nodes = [u for u in range(num_vps) if find(u) == find(0)]
            w = min(root_nodes, key=lambda u: d2[v, u])
            edges.add((min(v, w), max(v, w)))
            parent[find(v)] = find(0)
    return ([f"{scan_id}_{i:04d}" for i in range(num_vps)], pos,
            sorted(edges))


def geometries(cfg: dict, world_seed: int) -> List[tuple]:
    """(scan_id, vp_ids, pos, edges) of every scan of the configuration."""
    w = cfg["world"]
    out = []
    for i in range(w["scans"]):
        sid = f"s{i}"
        out.append((sid,) + scan_geometry(sid, w["viewpoints"], w["degree"],
                                          rng(world_seed, "scan", i)))
    return out


def build_graphs(build_scan_graph, geos, max_cands: int) -> Dict[str, object]:
    """{scan_id: graph} by the given `build_scan_graph`."""
    return {sid: build_scan_graph(sid, vps, pos, edges, max_cands)
            for sid, vps, pos, edges in geos}


def view_features(cfg: dict, seed: int) -> np.ndarray:
    """[scans x viewpoints, 36, image_feat_size] float32 view features."""
    w = cfg["world"]
    vtot = w["scans"] * w["viewpoints"]
    return rng(seed, "feat").standard_normal(
        (vtot, 36, cfg["model"]["image_feat_size"]), np.float32)


def episodes(graphs, n_items: int, vocab_size: int, max_instr_len: int,
             path_hops: Sequence[int], world_seed: int,
             seed: int) -> List[dict]:
    """Shortest-path episodes with random token instructions: as many
    episodes of each hop count from path_hops[0] to path_hops[1] (the
    frozen generator draws a cap and accepts any path up to it), their
    scans and paths drawn from `world_seed`, their headings and
    instructions from the run's `seed`."""
    g_ = rng(world_seed, "episodes")
    t_ = rng(seed, "episodes")
    scans = list(graphs)
    lengths = [path_hops[0] + i % (path_hops[1] - path_hops[0] + 1)
               for i in range(n_items)]
    g_.shuffle(lengths)
    items = []
    for i, L in enumerate(lengths):
        for j in g_.permutation(len(scans)):
            scan = scans[j]
            g = graphs[scan]
            pairs = np.argwhere(g.hops == L)
            if len(pairs):
                break
        else:
            raise ValueError(f"no scan has a path of {L} hops")
        a, b = (int(v) for v in pairs[g_.integers(len(pairs))])
        path_local = [a] + g.shortest_path(a, b)
        items.append(dict(
            instr_id=f"{i}_0", scan=scan,
            path=[g.vp_ids[v] for v in path_local],
            heading=float(t_.uniform(0, 2 * math.pi)),
            instruction="synthetic",
            instr_encoding=[0] + list(t_.integers(
                4, vocab_size, int(t_.integers(8, max_instr_len - 2))))
            + [2]))
    return items


def reverie_objects(cfg: dict, graphs, seed: int, splits: List[list]):
    """The object store [Vtot, Lo, ...] of the configuration's world, and
    each item's `objid`: the first object at its goal viewpoint."""
    m, w = cfg["model"], cfg["world"]
    g = rng(seed, "objects")
    vtot = w["scans"] * w["viewpoints"]
    Lo, F = w["objects_per_viewpoint"], m["obj_feat_size"]
    objects = dict(
        feat=g.standard_normal((vtot, Lo, F), np.float32),
        loc=np.concatenate([
            g.standard_normal((vtot, Lo, 4), np.float32),
            g.random((vtot, Lo, 3), np.float32)], -1),
        dir=g.uniform(-3, 3, (vtot, Lo, 2)).astype(np.float32),
        mask=g.random((vtot, Lo)) < 0.7,
        name=g.integers(0, m["obj_name_vocab_size"],
                        (vtot, Lo)).astype(np.int32),
        oid=g.integers(0, 50, (vtot, Lo)).astype(np.int32))
    offs, tot = {}, 0
    for sid, gr in graphs.items():
        offs[sid] = tot
        tot += gr.num_vps
    for items in splits:
        for it in items:
            row = offs[it["scan"]] + graphs[it["scan"]].index[it["path"][-1]]
            if objects["mask"][row].any():
                k = int(np.argmax(objects["mask"][row]))
                it["objid"] = int(objects["oid"][row, k])
    return objects


def causal_banks(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    """The banks the configuration's causal flags read, under their batch
    keys: instruction direction and landmark banks at the hidden width,
    the image room-type bank at the image width (each with p(z) summing
    to 1), and each front-door bank one member of each of its clusters."""
    m, b = cfg["model"], cfg["banks"]
    g = rng(seed, "banks")
    D = m["hidden_size"]

    def bank(n, width):
        return (g.standard_normal((n, width), np.float32),
                g.dirichlet(np.ones(n)).astype(np.float32))

    out: Dict[str, np.ndarray] = {}
    if m.get("do_back_txt"):
        for kind in ("direction", "landmark"):
            out[f"instr_z_{kind}_features"], out[f"instr_z_{kind}_pzs"] = \
                bank(b[f"instr_{kind}_rows"], D)
    if m.get("do_back_img"):
        out["img_z_features"], out["img_z_pzs"] = \
            bank(b["img_rows"], m["image_feat_size"])
    n = b["front_clusters"]
    for key, flag in (("front_txt_feats", "do_front_txt"),
                      ("front_vp_feats", "do_front_img"),
                      ("front_gmap_feats", "do_front_his")):
        if m.get(flag):
            centers = g.standard_normal((n, D))
            out[key] = np.tanh(centers + 0.5 * g.standard_normal(
                (n, D))).astype(np.float32)
    return out


@torch.no_grad()
def draw_weights(model: torch.nn.Module, seed: int) -> None:
    """Every parameter of `model` drawn in place from `seed` on its own
    device, in one normal draw: a LayerNorm's weight 1 and bias 0, every
    other bias 0, every matrix normal with std sqrt(1 / its last width)
    (a Linear's fan-in, an embedding's width), every other vector normal
    with std 0.02."""
    params = list(model.named_parameters())
    dev = params[0][1].device
    norms = {id(p) for mod in model.modules()
             if isinstance(mod, torch.nn.LayerNorm)
             for p in mod.parameters(recurse=False)}
    total = sum(p.numel() for _, p in params)
    g = torch.Generator(device=dev).manual_seed(torch_seed(seed, "weights"))
    flat = torch.randn(total, generator=g, device=dev, dtype=torch.float32)
    off = 0
    for name, p in params:
        n = p.numel()
        src = flat[off:off + n].view(p.shape)
        off += n
        if id(p) in norms:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        elif p.dim() >= 2:
            p.copy_(src * math.sqrt(1.0 / p.shape[-1]))
        else:
            p.copy_(src * 0.02)
    del flat
