"""Pre-training CLI of the port (counterpart of vln_goat_tpu/pretrain/cli.py).

  python -m vln_goat_tpu_torch.pretrain.cli --synthetic --model_config m.json
  python -m vln_goat_tpu_torch.pretrain.cli --config cfg.json --anno_dir ... \
      --img_ft_file ... --connectivity_dir ...

The flags and defaults are the JAX CLI's, with the JSON overlay of
`--config` where the command line wins, plus `--device` (default cuda):
nothing falls back to the CPU unasked.  `--model_config` takes any
GoatConfig field, the JAX package's `use_pallas_attention` as the port's
`use_fused_attention` (the fused attention kernels, with in-kernel dropout
in training).

Orchestration as the JAX CLI's (train_r2r_goat.py): the seeded task mix
(`train.MetaTaskSampler`), warm-up + linear decay, the grad-norm clip,
every batch a pure function of (seed, split, task, step) (`make_batch_np`)
built by a background thread or, with `--num_workers`, by spawned worker
processes (`data.worker_pool`), the same stream either way; the copies to
the card from pinned memory, on the thread that builds or receives the
batch; validation of every task on val_seen / val_unseen every
`valid_steps`, `ckpt_latest` and the best on val_unseen SAP fused accuracy
(`ckpt_best_<step>`; without SAP the negative sum of the losses) as the
port's parameter directories (`train.checkpoint.save_params`).  Each train
step's dropout draws from `train.step_generator(seed, step)`.  A pretrain directory
becomes the fine-tune CLI's `--bert_ckpt_file` through
`train.checkpoint.save_pretrain_checkpoint`.

More than one process: the JAX CLI spreads each batch over every device of
its host; the port's counterpart of a device is a process, so this CLI
takes the fine-tune CLI's `--num_processes / --process_id /
--coordinator` (one process per card, `cuda:<process_id % cards>`; nccl
on the card, gloo with `--device cpu`).  Every rank builds each step's
batch (a pure function of (seed, task, step)) and keeps its rows
(`parallel.mesh.shard_batch`); the losses are the ranks' shares of the
global batch's (`pretrain.model`), the gradients are averaged over the
ranks after the backward, and dropout draws differ by rank
(`step_generator`).  A batch that does not divide over the processes runs
whole on every rank.  Rank 0 writes the log, the metrics and the
checkpoints; the model starts from rank 0's weights.

  python -m vln_goat_tpu_torch.pretrain.cli --synthetic --device cpu \
      --num_processes 2 --process_id 0 --coordinator localhost:12391 &
  python -m vln_goat_tpu_torch.pretrain.cli --synthetic --device cpu \
      --num_processes 2 --process_id 1 --coordinator localhost:12391
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser("vln_goat_tpu_torch.pretrain")
    p.add_argument("--config", default=None, help="JSON run config overlay")
    p.add_argument("--model_config", default=None, help="JSON model config")
    p.add_argument("--output_dir", default="out_pretrain")
    p.add_argument("--dataset", default="r2r",
                   choices=["r2r", "rxr", "reverie"])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--anno_dir", default=None)
    p.add_argument("--img_ft_file", default=None)
    p.add_argument("--aug_img_ft_file", default=None,
                   help="EnvEdit augmented features; when set, each example "
                        "samples original/augmented 50/50 "
                        "(pretrain dataset.py:226-233)")
    p.add_argument("--connectivity_dir", default=None)
    p.add_argument("--scanvp_cands_file", default=None,
                   help="reference scanvp_candview_relangles.json cache "
                        "(pretrain dataset.py:171); overrides computed "
                        "candidate tables")
    p.add_argument("--tasks", nargs="+", default=["mlm", "sap", "cfp"])
    p.add_argument("--mix_ratio", nargs="+", type=int, default=[1, 1, 1])
    p.add_argument("--train_batch_size", type=int, default=48)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--num_train_steps", type=int, default=200000)
    p.add_argument("--warmup_steps", type=int, default=10000)
    p.add_argument("--grad_norm", type=float, default=5.0)
    p.add_argument("--log_steps", type=int, default=1500)
    p.add_argument("--valid_steps", type=int, default=3000)
    p.add_argument("--seed", type=int, default=0)
    # reference TRAIN_MAX_STEP=20 (pretrain_src/data/dataset.py:371-373)
    p.add_argument("--max_steps_traj", type=int, default=20)
    p.add_argument("--init_from", default=None,
                   help="torch .pt/.ckpt to initialize the encoder from")
    p.add_argument("--init_format", default="goat",
                   choices=["goat", "meter", "lxmert", "bert"],
                   help="key space of --init_from (goat = reference "
                        "pretrain/fine-tune .pt, no rename)")
    p.add_argument("--image_prob_size", type=int, default=0,
                   help="CLIP-class logit columns appended to each view "
                        "row of --img_ft_file (reference image_prob_size, "
                        "dataset.py:420-422); enables real MRC targets")
    p.add_argument("--mrc_prob_file", default=None,
                   help="separate HDF5 of per-view class logits keyed "
                        "'{scan}_{vp}' -> [36, P] (alternative to in-file "
                        "prob columns)")
    p.add_argument("--obj_ft_file", default=None,
                   help="REVERIE object feature HDF5 (enables the og task)")
    p.add_argument("--obj_feat_size", type=int, default=768)
    p.add_argument("--max_objects", type=int, default=20)
    p.add_argument("--max_txt_len", type=int, default=80)
    p.add_argument("--max_gmap", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=0,
                   help="batch-builder worker processes (reference "
                        "build_dataloader(num_workers), loader.py:127-164). "
                        "0 = single background prefetch thread.  The batch "
                        "stream is identical for any value (each batch is "
                        "a pure function of (seed, task, step)).")
    p.add_argument("--device", default="cuda",
                   help="where the model runs (cuda or cpu)")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--coordinator", default="localhost:12391")
    args = p.parse_args(argv)
    # JSON overlay where CLI wins (parser.py:144-155): only fill values the
    # user left at their defaults
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
        defaults = {a.dest: a.default for a in p._actions}
        for k, v in cfg.items():
            if hasattr(args, k) and getattr(args, k) == defaults.get(k):
                setattr(args, k, v)
    return args


def model_config(args):
    """GoatConfig.for_dataset(args.dataset) with the fields of
    `--model_config` (`use_pallas_attention` read as
    `use_fused_attention`)."""
    from ..config import GoatConfig

    mkw = {}
    if args.model_config:
        with open(args.model_config) as f:
            mj = json.load(f)
        if "use_pallas_attention" in mj:
            mj.setdefault("use_fused_attention",
                          mj.pop("use_pallas_attention"))
        known = GoatConfig.__dataclass_fields__
        mkw = {k: v for k, v in mj.items() if k in known}
    return GoatConfig.for_dataset(args.dataset, **mkw)


def synthetic_world(args, cfg):
    """The JAX CLI's `--synthetic` world: two 30-viewpoint scans, seeded
    view features, 64 / 16 / 16 synthetic episodes and, with "og" or
    REVERIE, a seeded object store whose goal viewpoints carry each
    episode's object -> (cfg, graphs, feats, data, objects)."""
    from ..rollout.env import make_synthetic_dataset
    from ..sim.graph_sim import make_synthetic_scan

    scans = [make_synthetic_scan(f"t{i}", num_vps=30, seed=i)
             for i in range(2)]
    graphs = {g.scan_id: g for g in scans}
    vtot = sum(g.num_vps for g in scans)
    feats = np.random.default_rng(0).standard_normal(
        (vtot, 36, cfg.image_feat_size)).astype(np.float32)
    data = {
        "train": make_synthetic_dataset(graphs, 64, cfg.vocab_size,
                                        path_len=(3, 6), seed=1),
        "val_seen": make_synthetic_dataset(graphs, 16, cfg.vocab_size,
                                           path_len=(3, 6), seed=2),
        "val_unseen": make_synthetic_dataset(graphs, 16, cfg.vocab_size,
                                             path_len=(3, 6), seed=3),
    }
    objects = None
    if "og" in args.tasks or args.dataset == "reverie":
        orng = np.random.default_rng(7)
        Lo = args.max_objects
        cfg = cfg.replace(obj_feat_size=args.obj_feat_size or 768)
        objects = dict(
            feat=orng.standard_normal(
                (vtot, Lo, cfg.obj_feat_size)).astype(np.float32),
            loc=np.concatenate([
                orng.standard_normal((vtot, Lo, 4)).astype(np.float32),
                orng.random((vtot, Lo, 3)).astype(np.float32)], -1),
            dir=orng.uniform(-3, 3, (vtot, Lo, 2)).astype(np.float32),
            mask=orng.random((vtot, Lo)) < 0.7,
            name=orng.integers(0, cfg.obj_name_vocab_size,
                               (vtot, Lo)).astype(np.int32),
            oid=orng.integers(0, 50, (vtot, Lo)).astype(np.int32),
        )
        offs, tot = {}, 0
        for g in scans:
            offs[g.scan_id] = tot
            tot += g.num_vps
        for split in data.values():
            for it in split:
                row = offs[it["scan"]] + \
                    graphs[it["scan"]].index[it["path"][-1]]
                if objects["mask"][row].any():
                    k = int(np.argmax(objects["mask"][row]))
                    it["objid"] = int(objects["oid"][row, k])
    return cfg, graphs, feats, data, objects


def real_world(args, cfg):
    """Annotations, connectivity, features, MRC probabilities and objects
    from files -> (cfg, graphs, feats, data, objects, aug_feats,
    view_probs)."""
    from ..data.annotations import construct_instrs
    from ..data.feature_db import ImageFeaturesDB, ObjectFeaturesDB
    from ..sim.graph_sim import load_connectivity, load_scanvp_cands

    data = construct_instrs(args.anno_dir, args.dataset,
                            ["train", "val_seen", "val_unseen"])
    scan_ids = sorted({it["scan"] for s in data.values() for it in s})
    graphs = load_connectivity(args.connectivity_dir, scan_ids)
    if args.scanvp_cands_file:
        load_scanvp_cands(args.scanvp_cands_file, graphs)
    db = ImageFeaturesDB(args.img_ft_file, cfg.image_feat_size)
    feats = db.as_packed_array(graphs, scan_ids)
    aug_feats = None
    if args.aug_img_ft_file:
        # EnvEdit 50/50 feature alternation (dataset.py:226-233)
        aug_feats = ImageFeaturesDB(
            args.aug_img_ft_file, cfg.image_feat_size) \
            .as_packed_array(graphs, scan_ids)
    view_probs = None
    if args.image_prob_size > 0:
        view_probs = db.as_packed_probs(graphs, scan_ids,
                                        args.image_prob_size)
    elif args.mrc_prob_file:
        logits = ImageFeaturesDB(args.mrc_prob_file, 10 ** 9) \
            .as_packed_array(graphs, scan_ids)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        view_probs = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    objects = None
    if args.obj_ft_file:
        cfg = cfg.replace(obj_feat_size=args.obj_feat_size)
        objects = ObjectFeaturesDB(
            args.obj_ft_file, args.obj_feat_size,
            max_objects=args.max_objects).as_packed_arrays(graphs, scan_ids)
    return cfg, graphs, feats, data, objects, aug_feats, view_probs


def build(args):
    """The model (seeded random weights on `args.device`), the batch
    builder and the items of every split (the JAX CLI's build)."""
    from ..device import resolve
    from ..parallel.distributed import rank_device
    from .data import PretrainShapes, TrajBatchBuilder, items_from_dataset
    from .model import build_pretrain_model

    dev = resolve(rank_device(args.device, args.process_id))
    cfg = model_config(args)
    aug_feats = view_probs = None
    if args.synthetic:
        cfg, graphs, feats, data, objects = synthetic_world(args, cfg)
    else:
        cfg, graphs, feats, data, objects, aug_feats, view_probs = \
            real_world(args, cfg)
    prob_dim = (args.image_prob_size or
                (view_probs.shape[-1] if view_probs is not None else 1000))
    shapes = PretrainShapes(max_txt_len=args.max_txt_len,
                            max_steps=args.max_steps_traj,
                            max_gmap=args.max_gmap, mrc_prob_dim=prob_dim,
                            max_objs=(args.max_objects
                                      if objects is not None else 0))
    builder = TrajBatchBuilder(graphs, list(graphs), feats, shapes,
                               vocab_size=cfg.vocab_size,
                               view_probs=view_probs,
                               objnav=objects is not None, objects=objects,
                               aug_features=aug_feats, seed=args.seed)
    items = {k: items_from_dataset(v, graphs) for k, v in data.items()}
    model = build_pretrain_model(cfg, tuple(args.tasks), prob_dim, dev,
                                 seed=args.seed)
    return dict(cfg=cfg, model=model, builder=builder, items=items,
                device=dev)


def make_batch_np(builder, pool_items, B: int, seed: int,
                  split: str, task: str, step: int):
    """One batch as numpy, a pure function of (seed, split, task, step):
    item selection and every stochastic choice inside the builder derive
    from one rng keyed on the tuple, so the batches are the same on rerun,
    from any worker process, and as the JAX CLI's.  crc32, not hash():
    python string hashing is salted per process."""
    import zlib

    rng = np.random.default_rng(
        (seed, zlib.crc32(split.encode()), zlib.crc32(task.encode()), step))
    chunk = [pool_items[i] for i in rng.integers(0, len(pool_items), B)]
    return builder.build_batch(chunk, task, rng=rng)


def batch_to_device(batch, device):
    """numpy batch -> tensors on `device`; to the card through pinned
    memory, without waiting for the copy."""
    import torch

    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def _pool_init(spec):
    """Worker-side state: the TrajBatchBuilder rebuilt on shared-memory
    feature views (numpy only; a worker never sees the card)."""
    from ..data.worker_pool import resolve_tree
    from .data import TrajBatchBuilder

    arrs = resolve_tree(spec["arrays"])
    builder = TrajBatchBuilder(
        spec["graphs"], spec["order"], arrs["features"], spec["shapes"],
        view_probs=arrs["view_probs"], aug_features=arrs["aug_features"],
        objects=arrs["objects"], **spec["kw"])
    return dict(builder=builder, items=spec["items"], B=spec["B"],
                seed=spec["seed"])


def _pool_build(state, desc):
    split, task, step = desc
    return make_batch_np(state["builder"], state["items"][split],
                         state["B"], state["seed"], split, task, step)


def batch_pool(args, builder, items):
    """A BatchWorkerPool of `args.num_workers` spawned processes, each with
    the builder on shared-memory views of its tables, building train
    batches by (split, task, step) -> (pool, close)."""
    from functools import partial

    from ..data.worker_pool import BatchWorkerPool, share_tree

    arrays, owners = share_tree(dict(
        features=builder.features, aug_features=builder.aug_features,
        view_probs=builder.view_probs, objects=builder.objects))
    spec = dict(
        arrays=arrays, graphs=builder.graphs, order=builder.scan_order,
        shapes=builder.sh, items={"train": items["train"]},
        B=args.train_batch_size, seed=args.seed,
        kw=dict(vocab_size=builder.vocab_size, objnav=builder.objnav,
                angle_feat_size=builder.afs,
                correct_heading=builder.correct_heading,
                mask_token_id=builder.mask_token_id,
                mlm_prob=builder.mlm_prob, mrc_prob=builder.mrc_prob,
                zdicts=builder.zdicts or None,
                obj_prob_logits=builder.obj_prob_logits))
    pool = BatchWorkerPool(partial(_pool_init, spec), _pool_build,
                           num_workers=args.num_workers)

    def close():
        pool.close()
        for h in owners:
            h.unlink()

    return pool, close


def batch_stream(args, builder, items, sampler, device, rows=None):
    """(step, task, batch on `device`) for every train step, built by
    `batch_pool`'s workers or, with --num_workers 0, by one prefetch
    thread -> (iterator, close); with `rows` (a mesh), the rank's rows of
    each batch (`shard_batch`)."""
    from ..parallel.mesh import shard_batch

    if args.num_workers > 0:
        pool, close = batch_pool(args, builder, items)
        descs = (("train", sampler.task_at(s), s)
                 for s in range(args.num_train_steps))

        def stream():
            for (_, t, s), nb in pool.imap(descs):
                yield s, t, batch_to_device(shard_batch(nb, rows), device)

        return stream(), close

    from ..data.prefetch import PrefetchIterator

    step_iter = iter(range(args.num_train_steps))

    def produce():
        s = next(step_iter)          # StopIteration ends the stream
        t = sampler.task_at(s)
        return s, t, batch_to_device(shard_batch(make_batch_np(
            builder, items["train"], args.train_batch_size, args.seed,
            "train", t, s), rows), device)

    it = PrefetchIterator(produce, depth=2)
    return it, it.close


def train(args):
    from ..config import PretrainConfig
    from ..parallel.distributed import process_count, process_index
    from ..parallel.mesh import make_mesh, replicate_tree, shard_batch
    from ..train.checkpoint import init_pretrain_from, save_params
    from ..utils.logger import (MetricsLogger, RunningMeter,
                                write_to_record_file)
    from .train import (MetaTaskSampler, PretrainState, make_eval_steps,
                        make_pretrain_optimizer, make_pretrain_steps,
                        step_generator)

    os.makedirs(args.output_dir, exist_ok=True)
    main_rank = process_index() == 0
    # rank 0 writes the run's files; the others print only
    record = os.path.join(args.output_dir, "pretrain.log") \
        if main_rank else None
    mlog = MetricsLogger(
        os.path.join(args.output_dir, "metrics.jsonl") if main_rank
        else None,
        tb_dir=os.path.join(args.output_dir, "tb") if main_rank else None)

    rt = build(args)
    model, builder, items, dev = (rt["model"], rt["builder"], rt["items"],
                                  rt["device"])
    B = args.train_batch_size
    # data-parallel over the processes when the batch divides them
    # (`mesh`: the gradient all-reduce; `rows`: the rank's rows)
    mesh = rows = None
    n_proc = process_count()
    if n_proc > 1:
        mesh = make_mesh(dev)
        if B % n_proc == 0:
            rows = mesh
        else:
            print(f"[pretrain] {n_proc} processes but train_batch_size {B} "
                  f"not divisible; every process runs the whole batch")
    model.mesh = rows
    if len(args.mix_ratio) < len(args.tasks):   # pad to uniform
        args.mix_ratio = list(args.mix_ratio) + \
            [1] * (len(args.tasks) - len(args.mix_ratio))

    def sample_batch(split, task, step=0):
        return batch_to_device(shard_batch(make_batch_np(
            builder, items[split], B, args.seed, split, task, step), rows),
            dev)

    if args.init_from:
        # the reference pretrain entry's init: load, key surgery, tolerant
        # overlay (train_r2r_goat.py:113-172)
        merged, missing, extra = init_pretrain_from(
            args.init_from, args.init_format, model.state_dict())
        model.load_state_dict(merged)
        write_to_record_file(
            f"init_from {args.init_from} ({args.init_format}): "
            f"{len(missing)} missing, {len(extra)} unused keys", record)
    pcfg = PretrainConfig(
        tasks=tuple(args.tasks), mix_ratio=tuple(args.mix_ratio),
        train_batch_size=B, learning_rate=args.learning_rate,
        num_train_steps=args.num_train_steps, warmup_steps=args.warmup_steps,
        grad_norm=args.grad_norm)
    replicate_tree(model)
    state = PretrainState(model, make_pretrain_optimizer(pcfg, model))
    steps = make_pretrain_steps(model, args.tasks, mesh)
    evals = make_eval_steps(model, args.tasks, mesh)
    sampler = MetaTaskSampler(args.tasks, args.mix_ratio, seed=args.seed)
    meters = {t: RunningMeter(t) for t in args.tasks}
    best_facc = -1.0

    batch_iter, close = batch_stream(args, builder, items, sampler, dev,
                                     rows)
    t0 = time.time()
    try:
        for step, task, batch in batch_iter:
            m = steps[task](state, batch, step_generator(args.seed, step,
                                                         dev))
            meters[task](float(m["loss"]))
            if (step + 1) % args.log_steps == 0:
                msg = f"step {step+1}: " + " ".join(
                    f"{t}={meters[t].val:.4f}" for t in args.tasks)
                msg += f" ({(step+1)/(time.time()-t0):.2f} it/s)"
                write_to_record_file(msg, record)
                mlog.set_step(step + 1)
                mlog.log_scalar_dict({t: meters[t].val for t in args.tasks},
                                     prefix="train")
            if (step + 1) % args.valid_steps == 0:
                facc = None
                for split in ("val_seen", "val_unseen"):
                    scores = {}
                    for t in args.tasks:
                        em = evals[t](sample_batch(split, t, step + 1))
                        scores.update({f"{t}_{k}": float(v)
                                       for k, v in em.items()})
                    write_to_record_file(f"  {split}: {scores}", record)
                    mlog.log_scalar_dict(scores, prefix=split)
                    if split == "val_unseen":
                        # model selection on unseen SAP fused accuracy
                        # (train_r2r_goat.py:389-399); without a sap task
                        # the negative total loss (higher = better)
                        facc = scores.get("sap_sap_facc")
                        if facc is None:
                            facc = -sum(v for k, v in scores.items()
                                        if k.endswith("_loss"))
                if main_rank:
                    save_params(os.path.join(args.output_dir, "ckpt_latest"),
                                model)
                if facc is not None and facc > best_facc:
                    best_facc = facc
                    if main_rank:
                        save_params(os.path.join(args.output_dir,
                                                 f"ckpt_best_{step+1}"),
                                    model)
                    write_to_record_file(
                        f"  best facc {facc:.4f} @ {step+1}", record)
    finally:
        close()
    return state


def main(argv=None):
    from ..parallel.distributed import (init_distributed, rank_device,
                                        shutdown)

    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    joined = init_distributed(
        args.coordinator, args.num_processes, args.process_id,
        device=rank_device(args.device, args.process_id))
    try:
        if args.process_id == 0:
            with open(os.path.join(args.output_dir, "args.json"), "w") as f:
                json.dump(vars(args), f, indent=2)
        train(args)
    finally:
        if joined:
            shutdown()


if __name__ == "__main__":
    main()
