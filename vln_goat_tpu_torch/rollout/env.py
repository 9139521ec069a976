"""Host-side episode batching: dataset items -> fixed-shape device batches
(counterpart of vln_goat_tpu/rollout/env.py; batches are torch tensors on
the batcher's device, index tensors int64).

Replaces R2RNavBatch's minibatch iterator + obs assembly
(map_nav_src/r2r/env.py:97-449) — but where the reference rebuilds obs dicts
per *step*, here everything episode-constant is packed once per *batch* and
the per-step work happens on device (rollout.py).

Dataset item schema (mirrors construct_instrs output, r2r/data_utils.py:160):
  {instr_id, scan, path: [vp ids], heading, instruction, instr_encoding}
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.geometry import view_index
from ..device import resolve
from ..sim.graph_sim import ScanGraph
from ..tools.zdict import causal_batch


class EpisodeBatcher:
    """Shuffled minibatch iterator (r2r/env.py:190-211) producing device
    batches for NavRollout."""

    def __init__(self, data: List[dict], scan_graphs: Dict[str, ScanGraph],
                 scan_order: Sequence[str], batch_size: int,
                 max_instr_len: int = 200, max_gt_len: int = 20,
                 env_edit: bool = False, seed: int = 0,
                 bucket_caps: Optional[Sequence[int]] = None,
                 device="cuda",
                 banks: Optional[Dict[str, np.ndarray]] = None):
        """bucket_caps: optional increasing gt-length caps (e.g. (5, 8)).
        When set, minibatches are length-homogeneous — each item goes to
        the smallest cap >= its gt length (longer paths to the largest cap,
        truncated like max_gt_len) and gt arrays are padded to that CAP
        instead of max_gt_len.  The teacher-forced scan is loss-identical
        at any horizon >= the batch's max gt length (trainer.py
        teacher_horizon), so short buckets run a proportionally shorter
        teacher scan; one compile per cap.  Batches are drawn from a
        bucket chosen ~ proportional to its pending count, so epoch order
        stays shuffled across buckets.

        env_edit: every batch carries `use_aug`, True on its even
        episodes, which then read the world's EnvEdit features
        (r2r/env.py:78-84; `NavWorld.feat_aug`).

        banks: the causal configuration's banks ({batch key: [N, D] or
        p(z) [N]}, `tools.zdict`), attached to every batch as views shared
        by its episodes (`causal_batch`)."""
        self.data = list(data)
        self.scan_graphs = scan_graphs
        self.scan_index = {s: i for i, s in enumerate(scan_order)}
        self.batch_size = batch_size
        self.max_instr_len = max_instr_len
        self.max_gt_len = max_gt_len
        self.env_edit = env_edit
        self.device = resolve(device)
        self.rng = random.Random(seed)
        self.rng.shuffle(self.data)
        self.ix = 0
        self.bucket_caps = tuple(sorted(bucket_caps)) if bucket_caps else None
        self._queues: Optional[Dict[int, List[dict]]] = None
        self._gt_cap = max_gt_len  # cap used by the LAST make_batch
        self.banks = banks

    def size(self) -> int:
        return len(self.data)

    def reset_epoch(self, shuffle: bool = False):
        if shuffle:
            self.rng.shuffle(self.data)
        self.ix = 0
        self._queues = None

    def next_minibatch(self, batch_size: Optional[int] = None) -> List[dict]:
        bs = batch_size or self.batch_size
        if self.bucket_caps:
            return self._next_bucketed(bs)
        self._gt_cap = self.max_gt_len
        batch = self.data[self.ix: self.ix + bs]
        if len(batch) < bs:
            self.rng.shuffle(self.data)
            self.ix = bs - len(batch)
            batch = batch + self.data[:self.ix]
        else:
            self.ix += bs
        self.batch = batch
        return batch

    def _bucket_of(self, item: dict) -> int:
        n = len(item["path"])
        for cap in self.bucket_caps:
            if n <= cap:
                return cap
        return self.bucket_caps[-1]

    def _refill(self):
        self.rng.shuffle(self.data)
        for it in self.data:
            self._queues[self._bucket_of(it)].append(it)

    def _next_bucketed(self, bs: int) -> List[dict]:
        if self._queues is None:
            self._queues = {cap: [] for cap in self.bucket_caps}
            self._refill()
        # draw a bucket ~ pending count among those that can fill a batch
        # (refill all queues when none can — keeps batches homogeneous
        # without starving rare lengths)
        full = [c for c in self.bucket_caps if len(self._queues[c]) >= bs]
        if not full:
            self._refill()
            full = [c for c in self.bucket_caps if len(self._queues[c]) >= bs]
            if not full:  # dataset smaller than a batch per bucket
                full = [max(self.bucket_caps,
                            key=lambda c: len(self._queues[c]))]
                while len(self._queues[full[0]]) < bs:
                    self._refill()
        weights = [len(self._queues[c]) for c in full]
        cap = self.rng.choices(full, weights=weights)[0]
        q = self._queues[cap]
        batch, self._queues[cap] = q[:bs], q[bs:]
        self._gt_cap = cap
        self.batch = batch
        return batch

    # ------------------------------------------------------------------
    def make_batch(self, items: List[dict],
                   gt_cap: Optional[int] = None) -> Dict[str, torch.Tensor]:
        B = len(items)
        Lt = self.max_instr_len
        Tg = gt_cap or (self._gt_cap if self.bucket_caps else self.max_gt_len)

        scan_idx = np.zeros((B,), np.int32)
        start_vp = np.zeros((B,), np.int32)
        start_view = np.zeros((B,), np.int32)
        gt_path = np.full((B, Tg), -1, np.int32)
        gt_len = np.ones((B,), np.int32)
        txt_ids = np.zeros((B, Lt), np.int64)
        txt_masks = np.zeros((B, Lt), bool)

        for i, it in enumerate(items):
            g = self.scan_graphs[it["scan"]]
            index = g.index
            scan_idx[i] = self.scan_index[it["scan"]]
            path = [index[v] for v in it["path"]][:Tg]
            gt_path[i, :len(path)] = path
            gt_len[i] = len(path)
            start_vp[i] = path[0]
            start_view[i] = view_index(it.get("heading", 0.0), 0.0)
            enc = list(it["instr_encoding"])[:Lt]
            txt_ids[i, :len(enc)] = enc
            txt_masks[i, :len(enc)] = True

        def t(a):
            return torch.as_tensor(a, device=self.device)

        batch = dict(
            scan_idx=t(scan_idx.astype(np.int64)),
            start_vp=t(start_vp.astype(np.int64)),
            start_view=t(start_view.astype(np.int64)),
            gt_path=t(gt_path.astype(np.int64)),
            gt_len=t(gt_len.astype(np.int64)),
            txt_ids=t(txt_ids), txt_masks=t(txt_masks),
        )
        if self.env_edit:
            # alternate original/EnvEdit-augmented features across the batch
            # (r2r/env.py:78-84)
            batch["use_aug"] = t(np.arange(B) % 2 == 0)
        return causal_batch(self.banks, batch) if self.banks else batch

    def next_batch(self) -> tuple:
        items = self.next_minibatch()
        return items, self.make_batch(items)


def make_synthetic_dataset(scan_graphs: Dict[str, ScanGraph], n_items: int,
                           vocab_size: int = 1000, max_instr_len: int = 48,
                           path_len=(4, 7), seed: int = 0) -> List[dict]:
    """Random-walk trajectories + random token instructions (test fixture)."""
    rng = np.random.default_rng(seed)
    scans = list(scan_graphs)
    items = []
    for i in range(n_items):
        scan = scans[rng.integers(len(scans))]
        g = scan_graphs[scan]
        L = int(rng.integers(path_len[0], path_len[1] + 1))
        # random shortest-path trajectory: pick endpoints with hops in range
        for _ in range(50):
            a, b = rng.integers(0, g.num_vps, 2)
            if a != b and 2 <= g.hops[a, b] <= L:
                break
        path_local = [int(a)] + g.shortest_path(int(a), int(b))
        items.append(dict(
            instr_id=f"{i}_0", scan=scan,
            path=[g.vp_ids[v] for v in path_local],
            heading=float(rng.uniform(0, 2 * math.pi)),
            instruction="synthetic",
            instr_encoding=[0] + list(rng.integers(4, vocab_size,
                                                   int(rng.integers(8, max_instr_len - 2)))) + [2],
        ))
    return items
