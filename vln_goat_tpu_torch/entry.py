"""Entry points of the port, built and run with PyTorch.

Greedy decode, the R2R rollout that the JAX package's
`__graft_entry__.entry()` compiles:

    model, ro, batcher = build_flagship("cuda")
    out = greedy_rollout(ro, batcher.next_batch()[1])

`build_flagship` mirrors `__graft_entry__._flagship`: a 60-viewpoint
synthetic scan, RolloutConfig(num_nodes=48, horizon=15, feat_dim=768),
batches of 8 episodes with instructions of 60 tokens, the full-width R2R
model with seeded random weights (`tiny=True`: the small test config).

Training, the R2R DAgger step that the JAX package's `bench.py
bench_train` times:

    state, batcher = build_train_flagship("cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    metrics = train_steps(state, batcher, 3, g)

`compute_dtype="bfloat16"` builds either in bf16 compute (float32
parameters; the fused kernels' bf16 builds), and `remat="model"` has the
train step's rollouts recompute each model call in the backward:
`build_train_flagship(compute_dtype="bfloat16", remat="model")` is
`bench.py`'s train build for R2R (`bench.py:78`, `:123`, `:200`), with
its vectorized teacher (`vectorized_teacher=True`, the default;
`GOAT_VEC_TEACHER=0` there is `vectorized_teacher=False` here).
`tcfg=TrainConfig(train_alg="dagger_fused")` is its `GOAT_BENCH_ALG=
dagger_fused` build, whose steps `train_steps` feeds with two batches
fused into one (`trainer.fuse_dagger_batches`); `sample_feedback=
"expl_sample"` has the sampled rollouts explore as the reference's
`--expl_sample`.

`causal=True` builds either with GOAT's causal configuration (`CAUSAL`:
BACL back-door text type_2 and image type_1, FACL front-door on text,
panorama and map, "door" merges; the set the JAX package's key audit
checks, tests/test_ckpt_audit.py) and its banks made from a seed
(`make_causal_banks`), which the batcher attaches to every batch.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .config import GoatConfig, TrainConfig
from .device import resolve
from .models.goat import GoatModel
from .rollout.env import EpisodeBatcher, make_synthetic_dataset
from .rollout.rollout import NavRollout, RolloutConfig, to_numpy
from .rollout.trajectory import assemble_trajectories
from .rollout.world import NavWorld
from .sim.graph_sim import make_synthetic_scan
from .tools.kmeans import FrontDoorPicker
from .tools.zdict import (DIRECTION_WORDS, FALLBACK_LANDMARKS, front_banks,
                          instr_bank_names)
from .train.params import init_goat_params
from .train.trainer import TrainState, fuse_dagger_batches, init_train_state

TINY = dict(num_l_layers=1, num_x_layers=1, num_pano_layers=1,
            hidden_size=32, num_attention_heads=2, intermediate_size=64,
            vocab_size=64, max_position_embeddings=64, image_feat_size=16)

# GOAT's causal configuration (the JAX package's key audit,
# tests/test_ckpt_audit.py:40-44)
CAUSAL = dict(do_back_txt=True, do_back_img=True, do_back_txt_type="type_2",
              do_back_img_type="type_1", do_add_method="door",
              do_front_txt=True, do_front_img=True, do_front_his=True)
# rows of the image room-type bank (the reference's image_z_dict_clip_50),
# of each front-door bank (front_n_clusters) and of the CFP feature pool
# each front-door bank is picked from
IMG_Z_ROWS, FRONT_CLUSTERS, CFP_ROWS = 50, 24, 2048


def make_causal_banks(cfg: GoatConfig, seed: int = 0,
                      device="cuda") -> Dict[str, np.ndarray]:
    """Seeded banks of the causal configuration at the sizes a real run
    holds, under their batch keys: the instruction direction bank
    (len(DIRECTION_WORDS) = 36 rows) and landmark bank
    (len(FALLBACK_LANDMARKS) = 47 rows) at the hidden width, the image
    room-type bank (50 rows at the image feature width), each with p(z)
    summing to 1; and the front-door banks, each picked by FrontDoorPicker
    (k-means on `device`) from 2048 CFP-like rows (tanh of a mixture of 24
    Gaussian clusters) into 24 rows.  Only the banks `cfg` reads.  Runs
    on the card unless `device` says otherwise."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    D = cfg.hidden_size

    def bank(n, width):
        return (rng.standard_normal((n, width)).astype(np.float32),
                rng.dirichlet(np.ones(n)).astype(np.float32))

    banks: Dict[str, np.ndarray] = {}
    if cfg.do_back_txt:
        instr = {}
        for kind, n in (("direction", len(DIRECTION_WORDS)),
                        ("landmark", len(FALLBACK_LANDMARKS))):
            instr[f"instr_{kind}_features"], instr[f"instr_{kind}_pzs"] = \
                bank(n, D)
        banks.update(instr_bank_names(instr))
    if cfg.do_back_img:
        banks["img_z_features"], banks["img_z_pzs"] = \
            bank(IMG_Z_ROWS, cfg.image_feat_size)
    if cfg.do_front_txt or cfg.do_front_img or cfg.do_front_his:
        pools = {}
        for key in ("txt_feats", "vp_feats", "gmap_feats"):
            centers = rng.standard_normal((FRONT_CLUSTERS, D))
            member = rng.integers(0, FRONT_CLUSTERS, CFP_ROWS)
            pools[key] = np.tanh(
                centers[member] + 0.5 * rng.standard_normal((CFP_ROWS, D))
            ).astype(np.float32)
        picker = FrontDoorPicker(pools, FRONT_CLUSTERS, seed=seed,
                                 device=device)
        banks.update(front_banks(picker.random_pick(), cfg))
    return banks


def build_model(cfg: GoatConfig, device="cuda", seed: int = 0) -> GoatModel:
    """GoatModel with seeded random weights, allocated and drawn on
    `device`, in eval mode."""
    dev = resolve(device)
    with torch.device("meta"):
        model = GoatModel(cfg)
    model = model.to_empty(device=dev)
    return init_goat_params(model, seed).eval()


def build_flagship(device="cuda", tiny: bool = False,
                   use_fused_attention: bool = True, seed: int = 0,
                   causal: bool = False, compute_dtype: str = "float32"):
    """(model, rollout, batcher) of the flagship R2R configuration.
    use_fused_attention=False routes every attention to the eager PyTorch
    path instead of the fused kernel.  causal=True: the CAUSAL flags, and
    the batcher attaches make_causal_banks(cfg, seed 0) to every batch.
    compute_dtype: "float32" or "bfloat16" (GoatConfig.compute_dtype)."""
    dev = resolve(device)
    flags = dict(CAUSAL if causal else {}, compute_dtype=compute_dtype)
    if tiny:
        cfg = GoatConfig(use_fused_attention=use_fused_attention, **TINY,
                         **flags)
        rcfg = RolloutConfig(num_nodes=12, horizon=3, feat_dim=16)
        n_vps, n_items, instr = 10, 16, 16
    else:
        cfg = GoatConfig.for_dataset(
            "r2r", use_fused_attention=use_fused_attention, **flags)
        rcfg = RolloutConfig(num_nodes=48, horizon=15, feat_dim=768)
        n_vps, n_items, instr = 60, 16, 60

    scans = [make_synthetic_scan("s0", num_vps=n_vps, seed=0)]
    world = NavWorld.build(scans, feat_dim=rcfg.feat_dim, seed=0, device=dev)
    model = build_model(cfg, dev, seed)
    ro = NavRollout(model, world, rcfg)
    graphs = {g.scan_id: g for g in scans}
    data = make_synthetic_dataset(graphs, n_items, vocab_size=cfg.vocab_size,
                                  path_len=(3, min(6, rcfg.horizon)), seed=1)
    batcher = EpisodeBatcher(data, graphs, ["s0"], batch_size=8,
                             max_instr_len=instr,
                             max_gt_len=rcfg.horizon + 1, device=dev,
                             banks=make_causal_banks(cfg, 0, dev)
                             if causal else None)
    return model, ro, batcher


def greedy_rollout(ro: NavRollout, batch: Dict[str, torch.Tensor]) -> dict:
    """Greedy decode of one batch: the rollout's outputs (tensors on the
    rollout's device, `fused_logits` [T, B, G] per step) plus
    `trajectories`, each episode's path of local viewpoint ids."""
    out = ro.rollout(batch)
    out["fused_logits"] = out["logits"]
    out["trajectories"] = assemble_trajectories(
        to_numpy({k: batch[k] for k in ("start_vp",)}),
        to_numpy({k: out[k] for k in ("segs", "seg_hops", "node_vp",
                                      "back_seg", "back_hops")}))
    return out


def build_train_flagship(device="cuda", tiny: bool = False,
                         batch_size: int = 64,
                         use_fused_attention: bool = True,
                         dropout: bool = True,
                         tcfg: Optional[TrainConfig] = None,
                         teacher_horizon="auto", causal: bool = False,
                         compute_dtype: str = "float32",
                         remat: str = "none",
                         vectorized_teacher: bool = True,
                         sample_feedback: str = "sample",
                         expl_max_ratio: float = 0.6):
    """(TrainState, batcher) of the R2R DAgger step of `bench.py`
    `bench_train` (its `build` for R2R, :78-140): the full-width R2R model
    in float32 with seeded random weights, 4 synthetic scans of 120
    viewpoints at degree 4, RolloutConfig(num_nodes=48, horizon=15,
    feat_dim=768), 512 episodes with 60-token instructions and gt paths of
    4-7 hops capped at 8, gt-length buckets (5, 8); AdamW at lr 2e-5 and
    weight decay 0.01 (`make_optimizer`'s defaults), global-norm clip 40;
    train_alg 'dagger', ml_weight 0.2 (tcfg's), teacher_horizon 'auto'.
    Weights drawn from seed 0.  `dropout=False` sets every dropout
    probability to 0.  compute_dtype: "float32" or "bfloat16" (bench.py
    trains in bf16); remat: the rollouts' rematerialisation policy, "none"
    or "model" (bench.py's GOAT_BENCH_REMAT default); vectorized_teacher,
    sample_feedback and expl_max_ratio: the train step's
    (`trainer.make_train_step`; tcfg.train_alg may be "imitation",
    "dagger" or "dagger_fused").  `tiny=True`: the
    JAX package's train-step test configuration (one 12-viewpoint scan,
    hidden 32, 16 node slots, horizon 6, buckets (4, 6)).  causal=True:
    the CAUSAL flags, and the batcher attaches make_causal_banks(cfg,
    seed 0) to every batch."""
    dev = resolve(device)
    tcfg = tcfg or TrainConfig(weight_decay=0.01)
    over = dict(CAUSAL if causal else {}, compute_dtype=compute_dtype)
    if not dropout:
        over.update(hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0, feat_dropout=0.0)
    if tiny:
        cfg = GoatConfig(use_fused_attention=use_fused_attention,
                         **{**TINY, "feat_dropout": 0.1, **over})
        rcfg = RolloutConfig(num_nodes=16, horizon=6, feat_dim=16)
        scans = [make_synthetic_scan("s0", num_vps=12, seed=0)]
        n_items, instr, plen, gt_cap, caps = 16, 24, (3, 4), 6, (4, 6)
    else:
        cfg = GoatConfig.for_dataset(
            "r2r", use_fused_attention=use_fused_attention, **over)
        rcfg = RolloutConfig(num_nodes=48, horizon=15, feat_dim=768)
        scans = [make_synthetic_scan(f"s{i}", num_vps=120, degree=4, seed=i)
                 for i in range(4)]
        n_items, instr, plen, gt_cap, caps = 512, 60, (4, 7), 8, (5, 8)
    world = NavWorld.build(scans, feat_dim=rcfg.feat_dim, seed=0, device=dev)
    model = build_model(cfg, dev)
    ro = NavRollout(model, world, rcfg)
    graphs = {g.scan_id: g for g in scans}
    data = make_synthetic_dataset(graphs, n_items, vocab_size=cfg.vocab_size,
                                  path_len=plen, seed=1,
                                  max_instr_len=instr)
    batcher = EpisodeBatcher(data, graphs, [g.scan_id for g in scans],
                             batch_size=batch_size, max_instr_len=instr,
                             max_gt_len=gt_cap, bucket_caps=caps,
                             device=dev,
                             banks=make_causal_banks(cfg, 0, dev)
                             if causal else None)
    state = init_train_state(model, ro, lr=tcfg.lr,
                             weight_decay=tcfg.weight_decay,
                             grad_clip=tcfg.grad_clip,
                             train_alg=tcfg.train_alg,
                             ml_weight=tcfg.ml_weight,
                             teacher_horizon=teacher_horizon, remat=remat,
                             vectorized_teacher=vectorized_teacher,
                             sample_feedback=sample_feedback,
                             expl_max_ratio=expl_max_ratio)
    return state, batcher


def next_train_batch(state: TrainState, batcher: EpisodeBatcher) -> dict:
    """The batch of state's next step: the batcher's next one, or for
    "dagger_fused" its next two fused (`fuse_dagger_batches`, as
    `bench.py`'s `nb()`)."""
    if state.train_alg == "dagger_fused":
        b_t = batcher.next_batch()[1]
        return fuse_dagger_batches(b_t, batcher.next_batch()[1])
    return batcher.next_batch()[1]


def train_steps(state: TrainState, batcher: EpisodeBatcher, n: int,
                generator: torch.Generator) -> List[dict]:
    """n updates of state on the batcher's next batches
    (`next_train_batch`); the metrics of each step (tensors on the
    model's device)."""
    return [state.step_fn(state, next_train_batch(state, batcher), generator)
            for _ in range(n)]
