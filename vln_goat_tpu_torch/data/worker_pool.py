"""Multi-process batch building (the port's copy of
vln_goat_tpu/data/worker_pool.py).

Reference: `build_dataloader(num_workers)` + `PrefetchLoader`
(pretrain_src/data/loader.py:90-164) get host parallelism from torch
DataLoader worker processes.  This pool builds FULL batches (not single
examples: the batch packer is vectorized, so example-granular workers
would only add IPC):

- **Deterministic for any worker count.**  Each work descriptor carries
  everything needed to derive its rng (`build_batch(..., rng=...)` is a
  pure function of the descriptor), so the output stream is identical for
  0, 1 or N workers.
- **Spawn, not fork.**  The parent holds a CUDA context, which a forked
  child cannot use safely.  Workers are spawned with an empty
  ``CUDA_VISIBLE_DEVICES`` and build numpy batches only (the batch builder
  of `pretrain/data.py`); the parent copies them to the card.
- **Shared memory for the big arrays.**  Feature tables are copied once
  into POSIX shared memory (`ShmArray`); workers attach read-only views
  instead of pickling gigabytes per worker.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import traceback
from multiprocessing import shared_memory
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import numpy as np


class ShmArray:
    """Picklable handle to a shared-memory numpy array.

    Parent: ``h = ShmArray.create(arr)`` (one copy into shm).  Workers
    unpickle the handle and call ``.array()`` for a zero-copy view.  The
    creator must keep the handle alive and call ``.unlink()`` when done.
    """

    def __init__(self, name: str, shape, dtype_str: str):
        self.name = name
        self.shape = tuple(shape)
        self.dtype_str = dtype_str
        self._shm: Optional[shared_memory.SharedMemory] = None
        self._owner = False

    @classmethod
    def create(cls, arr: np.ndarray) -> "ShmArray":
        arr = np.ascontiguousarray(arr)
        shm = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
        view = np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)
        view[...] = arr
        h = cls(shm.name, arr.shape, arr.dtype.str)
        h._shm = shm
        h._owner = True
        return h

    def array(self) -> np.ndarray:
        if self._shm is None:
            self._shm = shared_memory.SharedMemory(name=self.name)
        return np.ndarray(self.shape, np.dtype(self.dtype_str),
                          buffer=self._shm.buf)

    def close(self):
        if self._shm is not None:
            self._shm.close()
            self._shm = None

    def unlink(self):
        if self._owner and self._shm is not None:
            name = self.name
            self.close()
            try:
                shared_memory.SharedMemory(name=name).unlink()
            except FileNotFoundError:
                pass

    def __getstate__(self):
        return {"name": self.name, "shape": self.shape,
                "dtype_str": self.dtype_str}

    def __setstate__(self, st):
        self.__dict__.update(st)
        self._shm = None
        self._owner = False


def share_tree(tree):
    """Replace every numpy array in a (possibly nested) dict with a
    ShmArray handle; returns (handles_tree, owners list for unlink)."""
    owners = []

    def rec(x):
        if isinstance(x, np.ndarray):
            h = ShmArray.create(x)
            owners.append(h)
            return h
        if isinstance(x, dict):
            return {k: rec(v) for k, v in x.items()}
        return x

    return rec(tree), owners


def resolve_tree(tree):
    """Inverse of share_tree inside a worker: handles -> array views."""
    if isinstance(tree, ShmArray):
        return tree.array()
    if isinstance(tree, dict):
        return {k: resolve_tree(v) for k, v in tree.items()}
    return tree


def _worker_main(init_q, task_q, result_q):
    try:
        init_fn, build_fn = init_q.get()
        state = init_fn()
    except BaseException:
        result_q.put((-1, ("__error__", traceback.format_exc())))
        return
    while True:
        job = task_q.get()
        if job is None:
            return
        idx, desc = job
        try:
            result_q.put((idx, ("__ok__", build_fn(state, desc))))
        except BaseException:
            result_q.put((idx, ("__error__", traceback.format_exc())))
            return


class BatchWorkerPool:
    """Ordered parallel map over work descriptors.

    ``init_fn`` (picklable, zero-arg -> state) runs once per worker;
    ``build_fn`` (picklable, (state, desc) -> batch) builds one batch.
    ``imap(descs)`` yields results in descriptor order with up to
    ``depth`` batches in flight per worker.  ``num_workers=0`` runs
    everything inline (identical results — see determinism note above).
    """

    def __init__(self, init_fn: Callable[[], Any],
                 build_fn: Callable[[Any, Any], Any],
                 num_workers: int, depth: int = 2):
        self.init_fn = init_fn
        self.build_fn = build_fn
        self.num_workers = int(num_workers)
        self.depth = depth
        self._procs = []
        self._init_qs = []
        self._task_q = None
        self._result_q = None
        if self.num_workers > 0:
            ctx = mp.get_context("spawn")
            self._task_q = ctx.Queue()
            self._result_q = ctx.Queue()
            # children must never touch the card: none is visible to them
            old = os.environ.get("CUDA_VISIBLE_DEVICES")
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
            try:
                for _ in range(self.num_workers):
                    # the functions (and the tables' handles they carry)
                    # go through a queue, not the spawn arguments: a
                    # spawn start blocks on arguments past the pipe's
                    # buffer until its child has imported the main module,
                    # which would start the workers one after another
                    init_q = ctx.Queue()
                    # a worker that dies before reading its message must
                    # not hold this process's exit on the queue's feeder
                    init_q.cancel_join_thread()
                    p = ctx.Process(
                        target=_worker_main,
                        args=(init_q, self._task_q, self._result_q),
                        daemon=True)
                    p.start()
                    init_q.put((init_fn, build_fn))
                    self._init_qs.append(init_q)
                    self._procs.append(p)
            finally:
                if old is None:
                    os.environ.pop("CUDA_VISIBLE_DEVICES", None)
                else:
                    os.environ["CUDA_VISIBLE_DEVICES"] = old

    def imap(self, descs: Iterable[Any]) -> Iterator[Tuple[Any, Any]]:
        """Yield (desc, batch) in input order."""
        if self.num_workers == 0:
            state = self.init_fn()
            for d in descs:
                yield d, self.build_fn(state, d)
            return
        it = enumerate(descs)
        sent = {}
        done = {}
        next_out = 0
        submitted = 0
        exhausted = False
        cap = self.depth * self.num_workers

        def pump():
            nonlocal submitted, exhausted
            while not exhausted and submitted - next_out < cap:
                try:
                    idx, d = next(it)
                except StopIteration:
                    exhausted = True
                    return
                sent[idx] = d
                self._task_q.put((idx, d))
                submitted += 1

        pump()
        while next_out < submitted or not exhausted:
            if next_out in done:
                batch = done.pop(next_out)
                d = sent.pop(next_out)
                next_out += 1
                pump()
                yield d, batch
                continue
            idx, (tag, payload) = self._next_result()
            if tag == "__error__":
                self.close()
                raise RuntimeError(f"batch worker failed:\n{payload}")
            done[idx] = payload

    def _next_result(self):
        """The next (index, (tag, payload)) a worker put; raises, after
        closing the pool, once a worker has exited without one (a crash
        in its start-up or an out-of-memory kill would leave the queue
        empty for ever)."""
        while True:
            try:
                return self._result_q.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in self._procs if not p.is_alive()]
                if dead:
                    self.close()
                    raise RuntimeError(f"a batch worker exited with code "
                                       f"{dead[0]} and no result")

    def close(self):
        for _ in self._procs:
            try:
                self._task_q.put(None)
            except Exception:
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        self._procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
