"""Fine-tuning / validation / CFP-extraction CLI of the port (counterpart
of vln_goat_tpu/cli.py) for R2R, RxR, REVERIE and SOON.

  python -m vln_goat_tpu_torch.cli --mode train --dataset r2r \
      --connectivity_dir ... --anno_dir ... --img_ft_file ... --output_dir out
  python -m vln_goat_tpu_torch.cli --mode valid --resume_file out/ckpt_latest \
      --submit ...
  python -m vln_goat_tpu_torch.cli --mode train --synthetic   # no datasets
  python -m vln_goat_tpu_torch.cli --mode train --dataset reverie --synthetic
  python -m vln_goat_tpu_torch.cli --mode train --dataset rxr \
      --expert_policy ndtw --synthetic
  python -m vln_goat_tpu_torch.cli --mode extract_cfp_features --synthetic
  python -m vln_goat_tpu_torch.cli --mode speaker --synthetic
  python -m vln_goat_tpu_torch.cli --mode train --synthetic --aug synthetic \
      --use_transpeaker --speaker_ckpt_file out/speaker_best \
      --z_instr_update --update_iter 3000

The flags and defaults are the JAX package's; `--use_pallas` routes the
attention through the fused kernels (`use_fused_attention`), and
`--device` (default cuda) picks where everything runs: nothing falls back
to the CPU unasked.  `--prng` is accepted and has no effect (every draw
comes from a torch.Generator seeded by `--seed`).

Orchestration as the JAX CLI's (main_nav.py:140-401): `log_every` train
cycles, each ending with greedy validation of every split, the latest
parameters (`ckpt_latest`), the full train state (`train_state_latest`,
which `--resume_file` continues bit for bit, the batch iterators
fast-forwarded), the best on val_unseen by SPL + SR
(`ckpt_best_val_unseen`) and, with `--save_torch_ckpt`, the reference .pt
(`latest_dict.pt`); per-cycle front-door resampling; submission JSONs.
RxR selects the best on val_unseen by nDTW + SDTW; REVERIE / SOON
validate with the object-grounding metrics (RGS, RGSPL) and submit each
episode's `pred_objid`.  The object store is `--obj_ft_file`'s
(`data.feature_db.ObjectFeaturesDB`) or, with `--synthetic`, a seeded one
whose goal viewpoints show each episode's object; `--bbox_file` maps
objects to the viewpoints that see them.  `--mode extract_cfp_features`
writes the training set's CFP features
(`<output_dir>/<dataset>_cfp_features.tsv`, `tools.cfp_extract`).
`ckpt_latest` and `ckpt_best_val_unseen` are directories of the port's
own parameter file; `--resume_file` / `--bert_ckpt_file` take one of
those, a train-state directory, or a reference .pt, through which the
port and the JAX package exchange weights.

GOAT's online z-dict refresh (`--z_instr_update`): at every crossed
`--update_iter` boundary the first 512 training instructions go through
the language tower (`tools.zdict.update_instr_zdict`), the instruction
banks are replaced and `backdoor_update_features.tsv` is written.
`--mode speaker` trains the speaker (BLEU-4 and SPICE on 32 items of each
validation split, `speaker_best` kept whenever BLEU improves);
`--use_transpeaker` re-captions every aug update's paths with the speaker
of `--speaker_ckpt_file` (a reference Transpeaker .pt or the port's own
`speaker_best`; a seeded one without it) under one shared feature-noise
vector, which the navigator's panorama features take too
(back-translation).

More than one process (`--num_processes N --process_id i --coordinator
host:port`, one process per card, `cuda:<i % cards>`; nccl on the card,
gloo with `--device cpu`): data parallelism as the JAX CLI's, which
shards each batch over its devices.  Every rank draws the same global
batches from the same seeded batchers and trains on its rows of each
(`parallel.mesh.shard_batch`; fused DAgger, its rows of each half), the
gradients averaged over the ranks after the backward
(`train.trainer.make_train_step`); a batch that does not divide runs
whole on every rank.  The model starts from rank 0's weights.  Validation
splits other than train / aug are sharded over the ranks and their
results gathered, so every rank holds the global metrics and
predictions.  Back-translation re-captions the same global items on every
rank from the same seed, the noise vector broadcast from rank 0.  Rank 0
alone writes the checkpoints, the train state, the logs, the metrics and
the submissions.

  python -m vln_goat_tpu_torch.cli --mode train --synthetic --device cpu \
      --num_processes 2 --process_id 0 --coordinator localhost:12391 &
  python -m vln_goat_tpu_torch.cli --mode train --synthetic --device cpu \
      --num_processes 2 --process_id 1 --coordinator localhost:12391
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser("vln_goat_tpu_torch")
    p.add_argument("--mode", required=True,
                   choices=["train", "valid", "extract_cfp_features",
                            "speaker"])
    p.add_argument("--speaker_iters", type=int, default=2000)
    p.add_argument("--speaker_lr", type=float, default=1e-4)
    p.add_argument("--speaker_angle_size", type=int, default=128)
    p.add_argument("--dataset", default="r2r",
                   choices=["r2r", "rxr", "reverie", "soon"])
    p.add_argument("--output_dir", default="out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="run on the synthetic fixture world (no datasets)")
    p.add_argument("--device", default="cuda",
                   help="torch device the run uses (cuda or cpu)")

    # data paths (r2r/parser.py:159-217)
    p.add_argument("--connectivity_dir", default=None)
    p.add_argument("--scanvp_cands_file", default=None,
                   help="reference scanvp_candview_relangles.json candidate "
                        "cache; overrides computed candidate tables")
    p.add_argument("--sweep_visibility", action="store_true",
                   help="apply the MatterSim view-frustum rule when "
                        "computing candidates (36-view sweep semantics)")
    p.add_argument("--anno_dir", default=None)
    p.add_argument("--img_ft_file", default=None)
    p.add_argument("--aug_ft_file", default=None,
                   help="EnvEdit features: alternated with the originals "
                        "across each training batch")
    p.add_argument("--aug", default=None,
                   help="aug trajectory annotation file; 'synthetic' builds "
                        "a fixture aug split on the synthetic world")
    p.add_argument("--aug_times", type=int, default=1,
                   help="aug updates per GT update in the interleave")
    p.add_argument("--accumulate_grad", action="store_true",
                   help="one optimizer step per GT+aug group "
                        "(--accumulateGrad, agent.py:407-445)")
    p.add_argument("--use_transpeaker", action="store_true",
                   help="re-caption aug paths with the speaker "
                        "(back-translation, agent.py:459-474)")
    p.add_argument("--speaker_ckpt_file", default=None,
                   help="the speaker's weights: a reference Transpeaker .pt "
                        "or a `--mode speaker` run's speaker_best")
    p.add_argument("--obj_ft_file", default=None)
    p.add_argument("--bbox_file", default=None)
    p.add_argument("--img_zdict_file", default=None)
    p.add_argument("--instr_zdict_file", default=None)
    p.add_argument("--front_feat_file", default=None)
    p.add_argument("--resume_file", default=None)
    p.add_argument("--bert_ckpt_file", default=None,
                   help="reference .pt to initialize from (key surgery)")

    # model
    p.add_argument("--num_l_layers", type=int, default=6)
    p.add_argument("--num_pano_layers", type=int, default=2)
    p.add_argument("--num_x_layers", type=int, default=3)
    p.add_argument("--hidden_size", type=int, default=None)
    p.add_argument("--num_attention_heads", type=int, default=None)
    p.add_argument("--intermediate_size", type=int, default=None)
    p.add_argument("--image_feat_size", type=int, default=768)
    p.add_argument("--obj_feat_size", type=int, default=0)
    p.add_argument("--angle_feat_size", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--feat_dropout", type=float, default=None,
                   help="None keeps the dataset preset (0.4 r2r)")
    p.add_argument("--fusion", default="dynamic",
                   choices=["global", "local", "avg", "dynamic"])
    p.add_argument("--expert_policy", default="spl", choices=["spl", "ndtw"])
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--use_pallas", action="store_true",
                   help="the fused attention kernels (ops/attention.py)")

    # causal flags
    p.add_argument("--do_back_img", action="store_true")
    p.add_argument("--do_back_txt", action="store_true")
    p.add_argument("--do_front_img", action="store_true")
    p.add_argument("--do_front_his", action="store_true")
    p.add_argument("--do_front_txt", action="store_true")
    p.add_argument("--do_back_txt_type", default="type_2")
    p.add_argument("--do_back_img_type", default="type_1")
    p.add_argument("--do_add_method", default="door")
    p.add_argument("--z_instr_update", action="store_true")
    p.add_argument("--update_iter", type=int, default=3000)
    p.add_argument("--front_n_clusters", type=int, default=24)
    p.add_argument("--expl_sample", action="store_true")
    p.add_argument("--expl_max_ratio", type=float, default=0.6)
    p.add_argument("--cat_file", default=None)
    p.add_argument("--tokenizer_vocab", default=None)
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--coordinator", default="localhost:12391")

    # training
    p.add_argument("--iters", type=int, default=150000)
    p.add_argument("--log_every", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--bucket_caps", default="",
                   help="comma-separated gt-length caps (e.g. '5,8'): "
                        "length-homogeneous train minibatches whose teacher "
                        "runs at the bucket cap.  Empty = off")
    p.add_argument("--train_alg", default="dagger",
                   choices=["imitation", "dagger", "dagger_fused"])
    p.add_argument("--remat", default="full",
                   choices=["full", "dots", "ffn", "bounds", "none", "model",
                            "probs", "wide"],
                   help="rollout rematerialisation policy for training "
                        "(ops/remat.py)")
    p.add_argument("--prng", default="rbg",
                   choices=["rbg", "threefry2x32"],
                   help="the JAX package's PRNG choice; no effect here")
    p.add_argument("--ml_weight", type=float, default=0.2)
    p.add_argument("--grad_clip", type=float, default=40.0)
    p.add_argument("--use_lr_sch", action="store_true")
    p.add_argument("--lr_sch", default="polynomial",
                   choices=["constant", "constant_with_warmup", "linear",
                            "polynomial", "cosine"])
    p.add_argument("--warmup_steps", type=int, default=3000)
    p.add_argument("--max_action_len", type=int, default=None)
    p.add_argument("--max_instr_len", type=int, default=None)
    p.add_argument("--num_nodes", type=int, default=48)
    p.add_argument("--max_cands", type=int, default=16)
    p.add_argument("--eval_first", action="store_true")
    p.add_argument("--submit", action="store_true")
    p.add_argument("--save_torch_ckpt", action="store_true",
                   help="also write reference-format .pt checkpoints")
    p.add_argument("--for_debug", action="store_true")
    p.add_argument("--tokenizer", default="roberta")
    return p.parse_args(argv)


# ----------------------------------------------------------------------
def build_runtime(args):
    """The model, world, rollout, per-split batchers and object store of a
    run, on `args.device` (the JAX CLI's build_runtime)."""
    from .config import GoatConfig
    from .device import resolve
    from .entry import build_model
    from .parallel.distributed import (process_count, rank_device,
                                       shard_data_for_process)
    from .rollout.env import EpisodeBatcher, make_synthetic_dataset
    from .rollout.rollout import NavRollout, RolloutConfig
    from .rollout.world import NavWorld
    from .train import checkpoint as ck

    dev = resolve(rank_device(args.device, args.process_id))
    cfg = GoatConfig.for_dataset(
        args.dataset,
        num_l_layers=args.num_l_layers, num_pano_layers=args.num_pano_layers,
        num_x_layers=args.num_x_layers, image_feat_size=args.image_feat_size,
        angle_feat_size=args.angle_feat_size,
        hidden_dropout_prob=args.dropout,
        glocal_fuse=args.fusion == "dynamic", fusion=args.fusion,
        do_back_img=args.do_back_img, do_back_txt=args.do_back_txt,
        do_front_img=args.do_front_img, do_front_his=args.do_front_his,
        do_front_txt=args.do_front_txt,
        do_back_txt_type=args.do_back_txt_type,
        do_back_img_type=args.do_back_img_type,
        do_add_method=args.do_add_method, mode=args.mode,
        use_fused_attention=args.use_pallas,
        compute_dtype=args.compute_dtype)
    over = dict(hidden_size=args.hidden_size,
                num_attention_heads=args.num_attention_heads,
                intermediate_size=args.intermediate_size,
                obj_feat_size=args.obj_feat_size,
                feat_dropout=args.feat_dropout,
                max_action_len=args.max_action_len,
                max_instr_len=args.max_instr_len)
    cfg = cfg.replace(**{k: v for k, v in over.items()
                         if v is not None and (v or k == "feat_dropout")})

    objects = None
    if args.synthetic:
        from .sim.graph_sim import make_synthetic_scan

        scans = [make_synthetic_scan(f"s{i}", num_vps=40, seed=i)
                 for i in range(3)]
        graphs = {g.scan_id: g for g in scans}
        if cfg.is_objnav:
            objects = synthetic_objects(
                sum(g.num_vps for g in scans), cfg)
        world = NavWorld.build(scans, feat_dim=cfg.image_feat_size, seed=0,
                               objects=objects, device=dev)
        splits = {}
        for name, n, seed in [("train", 64, 1), ("val_seen", 16, 2),
                              ("val_unseen", 16, 3)]:
            splits[name] = make_synthetic_dataset(
                graphs, n, vocab_size=cfg.vocab_size,
                max_instr_len=min(cfg.max_instr_len, 48),
                path_len=(3, 6), seed=seed)
        # val_train_seen = slice of train (r2r/data_utils.py:149-151)
        splits["val_train_seen"] = splits["train"][:16]
        if args.aug:
            splits["aug"] = make_synthetic_dataset(
                graphs, 64, vocab_size=cfg.vocab_size,
                max_instr_len=min(cfg.max_instr_len, 48),
                path_len=(3, 6), seed=11)
        if objects is not None:
            # each episode's object: one visible at its goal viewpoint
            offs = _vp_offsets(graphs, list(graphs))
            for data in splits.values():
                for it in data:
                    row = offs[it["scan"]] + \
                        graphs[it["scan"]].index[it["path"][-1]]
                    k = int(np.argmax(objects["mask"][row]))
                    it["objId"] = int(objects["oid"][row, k])
    else:
        from .data.annotations import construct_instrs, load_annotation_file
        from .data.feature_db import ImageFeaturesDB
        from .sim.graph_sim import load_connectivity, load_scanvp_cands

        # split roster per dataset (main_nav.py:113-120)
        split_names = ["train", "val_train_seen", "val_seen", "val_unseen"]
        if args.dataset == "rxr":
            split_names.remove("val_train_seen")
            if not args.submit:
                split_names.remove("val_seen")
        if args.submit and args.dataset != "rxr":
            split_names.append("test")
        splits = construct_instrs(args.anno_dir, args.dataset, split_names,
                                  tokenizer=args.tokenizer,
                                  max_instr_len=cfg.max_instr_len,
                                  for_debug=args.for_debug)
        if args.aug and args.aug != "synthetic":
            splits["aug"] = load_annotation_file(
                args.aug, args.dataset, tokenizer=args.tokenizer,
                max_instr_len=cfg.max_instr_len, for_debug=args.for_debug)
        scan_ids = sorted({it["scan"] for s in splits.values() for it in s})
        graphs = load_connectivity(args.connectivity_dir, scan_ids,
                                   max_cands=args.max_cands,
                                   sweep_visibility=args.sweep_visibility)
        if args.scanvp_cands_file:
            load_scanvp_cands(args.scanvp_cands_file, graphs)
        features = ImageFeaturesDB(args.img_ft_file, cfg.image_feat_size) \
            .as_packed_array(graphs, scan_ids)
        aug_features = None
        if args.aug_ft_file:
            aug_features = ImageFeaturesDB(
                args.aug_ft_file, cfg.image_feat_size
            ).as_packed_array(graphs, scan_ids)
        if cfg.is_objnav and args.obj_ft_file:
            from .data.feature_db import ObjectFeaturesDB

            objects = ObjectFeaturesDB(
                args.obj_ft_file, cfg.obj_feat_size,
                cfg.angle_feat_size).as_packed_arrays(graphs, scan_ids)
        world = NavWorld.build([graphs[s] for s in scan_ids],
                               features=features, aug_features=aug_features,
                               objects=objects,
                               feat_dim=cfg.image_feat_size, device=dev)

    # rank-sharded validation (sel_data_idxs, r2r/env.py:126-134)
    if process_count() > 1:
        for name in list(splits):
            if name not in ("train", "aug"):
                splits[name] = shard_data_for_process(splits[name])

    scan_order = list(graphs)
    model = build_model(cfg, dev, seed=args.seed)
    path = args.resume_file or args.bert_ckpt_file
    if path:
        if ck.is_train_state_dir(path):
            if args.mode != "train":    # train() restores the whole state
                model.load_state_dict(ck.load_train_state_params(path))
        elif os.path.isdir(path):
            model.load_state_dict(ck.load_params(path))
        else:
            missing, extra = ck.load_reference(model, path)
            print(f"loaded {path}: {len(missing)} missing, "
                  f"{len(extra)} extra keys")

    rcfg = RolloutConfig(num_nodes=args.num_nodes, horizon=cfg.max_action_len,
                         expert_policy=args.expert_policy,
                         feat_dim=cfg.image_feat_size,
                         angle_feat_size=cfg.angle_feat_size)
    rollout = NavRollout(model, world, rcfg)

    # gt paths padded to the datasets' true maximum (bounded by the
    # horizon); one cap across splits keeps one shape per batch
    gt_cap = max((len(it["path"]) for data in splits.values()
                  for it in data), default=2)
    gt_cap = min(max(gt_cap, 2), cfg.max_action_len + 1)
    caps = sorted({min(int(c), gt_cap)
                   for c in args.bucket_caps.split(",") if c.strip()})
    batchers = {
        name: EpisodeBatcher(
            data, graphs, scan_order, args.batch_size,
            max_instr_len=min(cfg.max_instr_len, 64 if args.synthetic
                              else 512),
            max_gt_len=gt_cap,
            bucket_caps=(caps if caps and name in ("train", "aug")
                         else None),
            # EnvEdit alternation on the training envs only
            # (r2r/env.py:78-84)
            env_edit=(name in ("train", "aug") and world.has_aug),
            seed=args.seed + i, device=dev)
        for i, (name, data) in enumerate(splits.items())
    }
    rt = dict(cfg=cfg, model=model, world=world, rollout=rollout,
              batchers=batchers, graphs=graphs, scan_order=scan_order,
              objects=objects, args=args, device=dev)
    if args.bbox_file:
        from .data.annotations import load_obj2vps

        rt["obj2vps"] = {
            (scan, oid): [graphs[scan].index[vp] for vp in vps
                          if vp in graphs[scan].index]
            for (scan, oid), vps in load_obj2vps(args.bbox_file).items()
            if scan in graphs}
    _load_causal_banks(args, rt)
    return rt


def synthetic_objects(vtot: int, cfg, num_objs: int = 8,
                      seed: int = 7) -> dict:
    """The synthetic object store (the JAX CLI's REVERIE fixture, the same
    numpy draws): `num_objs` objects a viewpoint with features, location
    and absolute direction, about 80% of them present."""
    rng = np.random.default_rng(seed)
    return dict(
        feat=rng.standard_normal(
            (vtot, num_objs, cfg.obj_feat_size)).astype(np.float32),
        loc=rng.standard_normal(
            (vtot, num_objs, cfg.angle_feat_size + 3)).astype(np.float32),
        dir=rng.uniform(-np.pi, np.pi, (vtot, num_objs, 2)).astype(
            np.float32),
        mask=rng.random((vtot, num_objs)) < 0.8,
        name=rng.integers(0, cfg.obj_name_vocab_size, (vtot, num_objs)),
        oid=np.arange(vtot * num_objs).reshape(vtot, num_objs),
    )


def _vp_offsets(graphs, scan_order):
    """Each scan's first row in the world's packed viewpoint tables."""
    offs, total = {}, 0
    for s in scan_order:
        offs[s] = total
        total += graphs[s].num_vps
    return offs


def run_batch(rt, batch, items=None):
    """An episode batch as the rollouts take it: the causal banks attached
    and, for an object store and items that name their object, each
    episode's gt object slot `gt_obj_slot` (its object among the goal
    viewpoint's tokens after the 2 + K + 36 local ones, -1 if not there;
    the JAX CLI's causal_batch)."""
    from .tools.zdict import causal_batch

    out = causal_batch(rt["banks"], batch)
    objects = rt.get("objects")
    if items is None or objects is None or \
            not all("objId" in it for it in items):
        return out
    off = 2 + rt["world"].max_cands + 36
    offs = _vp_offsets(rt["graphs"], rt["scan_order"])
    slot = np.full(len(items), -1, np.int64)
    for b, it in enumerate(items):
        g = rt["graphs"][it["scan"]]
        row = objects["oid"][offs[it["scan"]] + g.index[it["path"][-1]]]
        hit = np.nonzero(row == int(it["objId"]))[0]
        if len(hit):
            slot[b] = off + int(hit[0])
    out["gt_obj_slot"] = torch.as_tensor(slot, device=rt["device"])
    return out


def _load_causal_banks(args, rt):
    """BACL z-dict TSVs and the FACL front-door picker (main_nav.py:31-137
    build_dataset)."""
    from .tools.zdict import (instr_bank_names, load_img_zdict_tsv,
                              load_instr_zdict_tsv)

    banks = {}
    if args.instr_zdict_file and (args.do_back_txt or args.do_front_txt):
        banks.update(instr_bank_names(
            load_instr_zdict_tsv(args.instr_zdict_file)))
    if args.img_zdict_file and args.do_back_img:
        img = load_img_zdict_tsv(args.img_zdict_file)
        banks["img_z_features"] = img["img_features"]
        banks["img_z_pzs"] = img["img_pzs"]
    rt["banks"] = banks
    rt["front_picker"] = None
    if args.front_feat_file and (args.do_front_txt or args.do_front_img
                                 or args.do_front_his):
        from .tools.kmeans import FrontDoorPicker, load_cfp_tsv

        feats = load_cfp_tsv(args.front_feat_file,
                             dim=rt["cfg"].hidden_size)
        rt["front_picker"] = FrontDoorPicker(
            {k: feats[k] for k in ("txt_feats", "vp_feats", "gmap_feats")},
            n_clusters=args.front_n_clusters, seed=args.seed,
            device=rt["device"])
    _refresh_front_dict(args, rt)


def _refresh_front_dict(args, rt):
    """Per-cycle front-door resampling (utils/data.py:450-480)."""
    from .tools.zdict import front_banks

    if rt.get("front_picker") is not None:
        rt["banks"].update(front_banks(rt["front_picker"].random_pick(),
                                       rt["cfg"]))


# ----------------------------------------------------------------------
def run_validation(rt, split: str, max_batches: Optional[int] = None):
    """Greedy decode of a whole split -> (metrics, per-item predictions)
    (main_nav.py:338-391 / agent_base.py:44-67).  With more than one
    process each rank decodes its shard of the split, and the per-item
    results and predictions of every rank are gathered
    (`all_gather_objects`, `merge_dist_results`): every rank returns the
    whole split's metrics and predictions."""
    from .entry import greedy_rollout
    from .eval.metrics import (eval_item, eval_metrics, reverie_eval_item,
                               reverie_eval_metrics)
    from .parallel.distributed import all_gather_objects, merge_dist_results

    batcher = rt["batchers"][split]
    batcher.reset_epoch(shuffle=False)
    rt["model"].eval()
    objnav = rt["cfg"].is_objnav and rt.get("objects") is not None
    obj2vps = rt.get("obj2vps") or {}
    seen, per_item, preds = set(), [], []
    n_batches = int(np.ceil(batcher.size() / batcher.batch_size))
    if max_batches:
        n_batches = min(n_batches, max_batches)
    for _ in range(n_batches):
        items, batch = batcher.next_batch()
        out = greedy_rollout(rt["rollout"], run_batch(rt, batch, items))
        paths = out["trajectories"]
        pred_oid = out["pred_obj_id"].cpu().numpy() \
            if "pred_obj_id" in out else None
        for b, it in enumerate(items):
            if it["instr_id"] in seen:
                continue
            seen.add(it["instr_id"])
            g = rt["graphs"][it["scan"]]
            gt_local = [g.index[v] for v in it["path"]]
            pred = {"instr_id": it["instr_id"],
                    "trajectory": [[g.vp_ids[v]] for v in paths[b]]}
            if objnav and "objId" in it:
                # REVERIE metrics (reverie/env.py:530-553); without obj2vps
                # the goal viewpoint is the object's only one
                goals = obj2vps.get((it["scan"], str(it["objId"])),
                                    [gt_local[-1]])
                oid = -1 if pred_oid is None else int(pred_oid[b])
                per_item.append(reverie_eval_item(
                    g.dist, paths[b], oid, gt_local, goals, it["objId"]))
                pred["pred_objid"] = oid
            else:
                per_item.append(eval_item(g.dist, paths[b], gt_local))
            preds.append(pred)
    per_item, preds = (merge_dist_results(r) for r in zip(
        *all_gather_objects((per_item, preds))))
    if objnav and per_item and "rgs" in per_item[0]:
        return reverie_eval_metrics(per_item), preds
    return eval_metrics(per_item), preds


def _main_rank() -> bool:
    from .parallel.distributed import process_index

    return process_index() == 0


def _record_file(args, name: str) -> Optional[str]:
    """The run's record file `name` on rank 0; None (print only) on the
    other ranks."""
    return os.path.join(args.output_dir, name) if _main_rank() else None


def train(args, rt):
    from .parallel.distributed import (broadcast_object, process_count,
                                       process_index, rank_seed)
    from .parallel.mesh import make_mesh, replicate_tree, shard_batch
    from .train import checkpoint as ck
    from .train.trainer import fused_dagger_rank_batch, init_train_state
    from .utils.logger import MetricsLogger, RunningMeter, write_to_record_file

    os.makedirs(args.output_dir, exist_ok=True)
    main_rank = _main_rank()
    record_file = _record_file(args, "train.log")
    mlog = MetricsLogger(_record_file(args, "metrics.jsonl"),
                         tb_dir=_record_file(args, "tb"))
    # data-parallel over the processes (the gradients averaged by `mesh`),
    # each rank on its rows of every batch (`rows`) when the batch divides
    mesh = rows = None
    n_proc = process_count()
    if n_proc > 1:
        mesh = make_mesh(rt["device"])
        if args.batch_size % n_proc == 0:
            rows = mesh
        else:
            print(f"[train] {n_proc} devices but batch_size "
                  f"{args.batch_size} not divisible; running on one device "
                  "(the whole batch on every process)")
    batchers = rt["batchers"]
    batcher, aug_batcher = batchers["train"], batchers.get("aug")
    # --accumulate_grad: one optimizer step per GT+aug group
    accum = (args.aug_times + 1) if (args.accumulate_grad
                                     and aug_batcher is not None) else 1
    sched = dict(lr_sch=args.lr_sch, warmup_steps=args.warmup_steps,
                 total_steps=args.iters) if args.use_lr_sch else {}
    # teacher episodes end within max_gt_len steps: the shortened teacher
    # is loss-identical; with --bucket_caps it follows each batch's cap
    th = "auto" if args.bucket_caps.strip() else max(
        (b.max_gt_len for k, b in batchers.items() if k in ("train", "aug")),
        default=None)
    state = init_train_state(
        rt["model"], rt["rollout"], lr=args.lr, grad_clip=args.grad_clip,
        train_alg=args.train_alg, ml_weight=args.ml_weight,
        teacher_horizon=th, remat=args.remat, accumulate_steps=accum,
        sample_feedback="expl_sample" if args.expl_sample else "sample",
        expl_max_ratio=args.expl_max_ratio, mesh=mesh, **sched)
    fused = args.train_alg == "dagger_fused"
    # the train loop's draws (dropout, sampled actions) come from one
    # generator, saved with the train state (rank 0's); the other ranks'
    # are seeded apart (`rank_seed`)
    gen = torch.Generator(device=rt["device"]).manual_seed(
        rank_seed(args.seed))

    start_iter = 0
    if args.resume_file and ck.is_train_state_dir(args.resume_file):
        start_iter = ck.load_train_state(args.resume_file, state, gen)
        if process_index() > 0:
            gen.manual_seed(rank_seed(args.seed + start_iter))
        write_to_record_file(f"resumed train state from {args.resume_file} "
                             f"@ iter {start_iter}", record_file)
    replicate_tree(state.model)

    meter = RunningMeter("loss")
    # model selection (main_nav.py:296-308)
    sel = (lambda m: m["nDTW"] + m["SDTW"]) if args.dataset == "rxr" \
        else (lambda m: m["spl"] + m["sr"])
    best = {"score": -1.0, "iter": 0}
    if args.eval_first:
        for split in ("val_train_seen", "val_seen", "val_unseen"):
            if split in batchers:
                m, _ = run_validation(rt, split, max_batches=4)
                write_to_record_file(f"[eval_first] {split}: {m}",
                                     record_file)

    speaker = _load_speaker(args, rt) \
        if args.use_transpeaker and aug_batcher is not None else None

    def update(items, batch):
        batch = run_batch(rt, batch, items)
        if fused:
            # the reference's two DAgger rollouts take two minibatches;
            # the fused step takes both, the first half teacher-forced
            items2, batch2 = batcher.next_batch()
            batch = fused_dagger_rank_batch(
                batch, run_batch(rt, batch2, items2), rows)
        else:
            batch = shard_batch(batch, rows)
        return state.step_fn(state, batch, gen)

    def aug_update(bt_seed: int):
        """One aug update (`aug_batch`); fused, both DAgger halves come
        from the aug batcher."""
        items = aug_batcher.next_minibatch()
        if fused:
            items = items + aug_batcher.next_minibatch()
        return state.step_fn(state, aug_batch(rt, aug_batcher, speaker,
                                              items, bt_seed, fused, rows),
                             gen)

    per = args.aug_times + 1
    # fast-forward the seeded batch iterators so that a resumed run sees
    # the uninterrupted run's batches
    pulls = 2 if fused else 1
    if start_iter:
        if aug_batcher is None:
            for _ in range(start_iter * pulls):
                batcher.next_minibatch()
        else:
            for _ in range(start_iter // per):
                for _ in range(pulls):
                    batcher.next_minibatch()
                for _ in range(args.aug_times * pulls):
                    aug_batcher.next_minibatch()

    t0 = time.time()
    it = start_iter
    while it < args.iters:
        interval = min(args.log_every, args.iters - it)
        losses = []
        if aug_batcher is None:
            consumed = interval
            for _ in range(interval):
                metrics = update(*batcher.next_batch())
                losses.append(metrics["loss"])
        else:
            # GT/aug interleave: 1 train update + aug_times aug updates per
            # group (main_nav.py:220-252), each one iteration
            groups = max(interval // per, 1)
            consumed = groups * per
            for j in range(groups):
                base = it + j * per
                metrics = update(*batcher.next_batch())
                losses.append(metrics["loss"])
                for k in range(args.aug_times):
                    metrics = aug_update(7_000_003 + base + k)
                    losses.append(metrics["loss"])
        for v in losses:
            meter(float(v))
        step = it + consumed
        mlog.set_step(step)
        mlog.log_scalar_dict({"loss": meter.val,
                              "grad_norm": float(metrics["grad_norm"]),
                              "node_overflow":
                                  float(metrics.get("node_overflow", 0))},
                             prefix="train")
        write_to_record_file(
            f"iter {step}: loss {meter.val:.4f} "
            f"({(time.time() - t0) / max(step - start_iter, 1) * 1000:.0f} "
            f"ms/iter)", record_file)
        scores = {}
        for split in ("val_train_seen", "val_seen", "val_unseen"):
            if split in batchers:
                m, _ = run_validation(rt, split)
                scores[split] = m
                mlog.log_scalar_dict(m, prefix=split)
                write_to_record_file(f"  {split}: {m}", record_file)
        out = args.output_dir
        if main_rank:
            ck.save_params(os.path.join(out, "ckpt_latest"), state.model)
            ck.save_train_state(os.path.join(out, "train_state_latest"),
                                state, gen, step)
            if args.save_torch_ckpt:
                ck.save_reference_checkpoint(
                    state.model, os.path.join(out, "latest_dict.pt"), step)
        if "val_unseen" in scores:
            score = sel(scores["val_unseen"])
            # chosen on rank 0, so that no two ranks disagree
            if broadcast_object(score > best["score"]):
                best = {"score": score, "iter": step}
                if main_rank:
                    ck.save_params(os.path.join(out, "ckpt_best_val_unseen"),
                                   state.model)
                write_to_record_file(f"  new best @ {step}: {score:.2f}",
                                     record_file)
        _refresh_front_dict(args, rt)    # per-cycle FACL resampling
        # every update_iter boundary crossed within this cycle
        if args.z_instr_update and \
                step // args.update_iter > it // args.update_iter:
            _update_zdict(args, rt, state.model, record_file)
        it = step
    return state


def _update_zdict(args, rt, model, record_file):
    """The online BACL instruction z-dict refresh (main_nav.py:192,
    311-324, agent.update_z_dict; the JAX CLI's cli.py:815-851): the first
    512 training items through `model`'s language tower, the instruction
    banks replaced, `backdoor_update_features.tsv` written.  With
    `--tokenizer_vocab` (a vocab.json, token -> id) the harvest walks the
    encoding's subword tokens, skipping the '#'-led continuations (BERT's
    '##'; RoBERTa's 'G'-led tokens never match, as in the reference);
    without it, whitespace words."""
    from .tools.zdict import (WordPicker, instr_bank_names,
                              save_instr_zdict_tsv, subword_tokens_of,
                              update_instr_zdict)
    from .utils.logger import write_to_record_file

    data = rt["batchers"]["train"].data
    if not data or "instruction" not in data[0]:
        return
    if args.tokenizer_vocab:
        with open(args.tokenizer_vocab, encoding="utf-8") as f:
            id_to_token = {int(v): k for k, v in json.load(f).items()}

        def tokens_of(d):
            return subword_tokens_of(d["instr_encoding"], id_to_token)

        def is_cont(t):
            return t.startswith("#")
    else:
        def tokens_of(d):
            return d["instruction"].split()

        def is_cont(t):
            return False
    zd, lm_f, dr_f, lm_pz, dr_pz = update_instr_zdict(
        model, data[:512], WordPicker(cat_file=args.cat_file),
        tokens_of=tokens_of, is_continuation=is_cont,
        max_len=min(rt["cfg"].max_instr_len, 64))
    rt["banks"].update(instr_bank_names(
        {k: v for k, v in zd["instr_zdict"].items() if len(v)}))
    out = os.path.join(args.output_dir, "backdoor_update_features.tsv")
    if _main_rank():
        save_instr_zdict_tsv(out, lm_f, dr_f, lm_pz, dr_pz)
    write_to_record_file(f"  z-dict refreshed: {len(lm_f)} landmarks, "
                         f"{len(dr_f)} directions -> {out}", record_file)


def speaker_config(args, cfg):
    """The speaker's configuration for the navigator's `cfg` (the JAX
    CLI's): the model's vocabulary, image features plus
    `--speaker_angle_size` angle features, decodes of at most 120."""
    from .speaker.model import SpeakerConfig

    return SpeakerConfig(
        vocab_size=cfg.vocab_size,
        feature_size=cfg.image_feat_size + args.speaker_angle_size,
        image_feat_size=cfg.image_feat_size,
        max_decode=min(120, cfg.max_instr_len))


def _load_speaker(args, rt):
    """The speaker of back-translation (main_nav.py:194-198; the JAX
    CLI's cli.py:545-580), seeded by `--seed` + 7 and loaded from
    `--speaker_ckpt_file`: a reference Transpeaker .pt (every parameter
    must be covered) or the port's own `speaker_best` directory."""
    from .speaker.speaker import Speaker
    from .train import checkpoint as ck

    sp = Speaker(speaker_config(args, rt["cfg"]), rt["device"],
                 seed=args.seed + 7)
    path = args.speaker_ckpt_file
    if path:
        if path.endswith((".pt", ".pth")):
            merged, missing, _ = ck.merge_loaded(
                sp.model.state_dict(), ck.load_reference_speaker(path))
            if missing:
                raise ValueError(
                    f"speaker ckpt left params uncovered: {missing[:5]}")
        else:
            merged = ck.load_params(path)
        sp.model.load_state_dict(merged)
    return sp


def recaption(rt, speaker, items, seed: int):
    """Back-translation of aug items: their gt paths through the speaker
    under one shared noise vector drawn from a generator seeded by `seed`
    -> (the items with the speaker's instructions, the noise [Df])."""
    from .speaker.backtranslate import backtranslate, swap_instructions

    graphs, cfg, sc = rt["graphs"], rt["cfg"], speaker.cfg
    gen = torch.Generator(device=speaker.device).manual_seed(seed)
    toks, noise = backtranslate(
        speaker, graphs, _features(rt), _vp_offsets(graphs, rt["scan_order"]),
        items, max_steps=cfg.max_action_len, generator=gen,
        feat_drop=cfg.feat_dropout)
    return swap_instructions(items, toks, eos_id=sc.eos_id,
                             bos_id=sc.bos_id), noise


def aug_batch(rt, batcher, speaker, items, seed: int, fused: bool,
              rows=None):
    """The batch of one aug update (agent.py:459-474): with a speaker the
    items re-captioned under one shared noise vector (`recaption` with
    `seed`), the noise in `feat_noise`; fused, the items' two halves are
    the two DAgger halves (re-captioned in one speaker pass), each built
    at the batcher's widest gt cap so that neither half's gt paths are
    cut to the other's bucket.  With `rows` (a mesh), the rank's rows of
    the batch (of each half, fused), the noise as rank 0 drew it."""
    from .parallel.distributed import broadcast_tensor
    from .parallel.mesh import shard_batch
    from .train.trainer import fused_dagger_rank_batch

    noise = None
    if speaker is not None:
        items, noise = recaption(rt, speaker, items, seed)
        if rows is not None:
            noise = broadcast_tensor(noise.contiguous())
    if fused:
        half = len(items) // 2
        cap = batcher.bucket_caps[-1] if batcher.bucket_caps else None
        batch = fused_dagger_rank_batch(*(
            run_batch(rt, batcher.make_batch(part, gt_cap=cap), part)
            for part in (items[:half], items[half:])), rows)
    else:
        batch = shard_batch(run_batch(rt, batcher.make_batch(items), items),
                            rows)
    if noise is not None:
        batch["feat_noise"] = noise
    return batch


def _features(rt):
    """The world's view features [V, 36, Df] as float32 numpy, read once."""
    if "features_np" not in rt:
        rt["features_np"] = rt["world"].feat.float().cpu().numpy()
    return rt["features_np"]


def valid(args, rt):
    from .utils.logger import write_to_record_file

    os.makedirs(args.output_dir, exist_ok=True)
    record_file = _record_file(args, "valid.log")
    for split in ("val_train_seen", "val_seen", "val_unseen", "test"):
        if split not in rt["batchers"]:
            continue
        t0 = time.time()
        m, preds = run_validation(rt, split)
        # no gt paths on the test split: predictions only
        write_to_record_file(
            f"{split} ({time.time() - t0:.1f}s): "
            f"{'predictions only' if split == 'test' else m}", record_file)
        if args.submit and _main_rank():
            out = os.path.join(args.output_dir, f"submit_{split}.json")
            with open(out, "w") as f:
                json.dump(preds, f)
            write_to_record_file(f"wrote {out}", record_file)


def extract_cfp(args, rt):
    """--mode extract_cfp_features: the training set's gt trajectories
    through `GoatModel.extract_cfp` into
    `<output_dir>/<dataset>_cfp_features.tsv` (the JAX CLI's extract_cfp,
    cli.py:898-917)."""
    from .pretrain.data import (PretrainShapes, TrajBatchBuilder,
                                items_from_dataset)
    from .tools.cfp_extract import extract_cfp_features

    cfg = rt["cfg"]
    shapes = PretrainShapes(
        max_txt_len=min(cfg.max_instr_len, 64),
        max_steps=min(cfg.max_action_len + 1, 12),
        max_cands=args.max_cands, max_gmap=args.num_nodes)
    builder = TrajBatchBuilder(rt["graphs"], rt["scan_order"], _features(rt),
                               shapes, seed=args.seed)
    items = items_from_dataset(rt["batchers"]["train"].data, rt["graphs"])
    out_tsv = os.path.join(args.output_dir,
                           f"{args.dataset}_cfp_features.tsv")
    os.makedirs(args.output_dir, exist_ok=True)
    feats = extract_cfp_features(rt["model"], builder, items,
                                 out_tsv=out_tsv if _main_rank() else None)
    print(f"wrote {out_tsv}: {feats['txt_feats'].shape[0]} trajectories")
    return feats


def train_speaker(args, rt):
    """--mode speaker: teacher-forced speaker training on the training
    split's gt paths (batches drawn by np.random.default_rng(--seed)),
    gated every max(log_every // 10, 1) iterations by BLEU-4 and SPICE of
    greedy decodes of 32 items of val_seen and val_unseen; `speaker_best`
    (the port's parameter file) written whenever BLEU improves
    (reverie/main_nav_obj.py:258-404; the JAX CLI's cli.py:919-1024).
    Returns the Speaker."""
    from .eval.bleu import corpus_bleu
    from .eval.spice import SpiceScorer, spice_from_ids
    from .speaker.speaker import Speaker, speaker_batch
    from .train import checkpoint as ck
    from .utils.logger import write_to_record_file

    cfg, graphs, dev = rt["cfg"], rt["graphs"], rt["device"]
    os.makedirs(args.output_dir, exist_ok=True)
    record = _record_file(args, "speaker.log")
    scfg = speaker_config(args, cfg)
    sp = Speaker(scfg, dev, seed=args.seed)
    step_fn, _ = sp.make_train_step(lr=args.speaker_lr)
    offsets = _vp_offsets(graphs, rt["scan_order"])

    def make_batch(items, max_len=None):
        return speaker_batch(sp, graphs, _features(rt), offsets, items,
                             cfg.max_action_len, max_len)

    train_items = list(rt["batchers"]["train"].data)
    L = min(cfg.max_instr_len, 60)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # id -> surface token for text-level SPICE (--tokenizer_vocab)
    id2tok = None
    if args.tokenizer_vocab:
        with open(args.tokenizer_vocab, encoding="utf-8") as f:
            id2tok = {v: k for k, v in json.load(f).items()}

    def words(ids):
        return "".join(id2tok.get(int(i), "").replace("\u0120", " ")
                       for i in ids).strip()

    best_bleu = -1.0
    for it in range(args.speaker_iters):
        idx = rng.integers(0, len(train_items), args.batch_size)
        loss = step_fn(make_batch([train_items[i] for i in idx], L), gen)
        if (it + 1) % max(args.log_every // 10, 1):
            continue
        hyps, refs = [], []
        for split in ("val_seen", "val_unseen"):
            if split not in rt["batchers"]:
                continue
            v_items = rt["batchers"][split].data[:32]
            toks = sp.infer(make_batch(v_items)).cpu().numpy()
            for row, item in zip(toks, v_items):
                seq = [int(t) for t in row]
                if scfg.eos_id in seq:
                    seq = seq[:seq.index(scfg.eos_id)]
                hyps.append(seq)
                refs.append([list(item["instr_encoding"])])
        bleu4, _ = corpus_bleu(hyps, refs, smooth=True)
        if id2tok is not None:
            spice, _ = SpiceScorer().compute_scores(
                [{"Inference": [words(h)], "Ground Truth": [words(r[0])]}
                 for h, r in zip(hyps, refs)])
        else:
            spice = float(np.mean([spice_from_ids(h, r)
                                   for h, r in zip(hyps, refs)])) \
                if hyps else 0.0
        write_to_record_file(f"speaker iter {it + 1}: loss {float(loss):.4f}"
                             f" bleu4 {bleu4:.4f} spice {spice:.4f}", record)
        if bleu4 > best_bleu:
            best_bleu = bleu4
            if _main_rank():
                ck.save_params(os.path.join(args.output_dir, "speaker_best"),
                               sp.model)
    return sp


def main(argv=None):
    args = parse_args(argv)
    from .parallel.distributed import init_distributed, rank_device, shutdown
    from .utils.misc import set_seed

    # multi-process rendezvous (replaces the reference's file:// NCCL
    # init, utils/distributed.py:56-61); validation splits shard per rank
    joined = init_distributed(
        args.coordinator, args.num_processes, args.process_id,
        device=rank_device(args.device, args.process_id))
    try:
        set_seed(args.seed)
        os.makedirs(args.output_dir, exist_ok=True)
        # snapshot the config like the reference run dirs
        # (utils/save.py:12-20)
        if _main_rank():
            with open(os.path.join(args.output_dir, "args.json"), "w") as f:
                json.dump(vars(args), f, indent=2)
        rt = build_runtime(args)
        if args.mode == "train":
            return train(args, rt)
        if args.mode == "extract_cfp_features":
            return extract_cfp(args, rt)
        if args.mode == "speaker":
            return train_speaker(args, rt)
        valid(args, rt)
    finally:
        if joined:
            shutdown()


if __name__ == "__main__":
    main()
