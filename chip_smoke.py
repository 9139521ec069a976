"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing a flushed line as it ends:
  1. device: the card's `name, power.limit` (as nvidia-smi prints them),
     torch and CUDA versions;
  2. build: every CUDA kernel of the port compiled with nvcc, one process
     per source, all at once, with seconds and the ptxas register/spill
     report;
  3. kernel check: each kernel against its plain PyTorch version on the
     card, with its time, the plain version's, one PyTorch library call's,
     and the least time the card could take (every kernel computes on the
     tensor cores in the 3xTF32 split, so its bound is at that rate, with
     the float32 CUDA-core bound beside it), the forward's time by part
     (projection GEMM, attention) and the projection backward's (dx / dy
     GEMMs, split-K weight gradients, the pass adding their slices, head
     sum):
     the forward at the decode rollout's five shapes (batch 8) without and
     with dropout 0.1 (same seeds; the kernel's keep share within 4
     binomial standard deviations of 0.9), the two backward kernels against
     autograd of the plain version at the same shapes at dropout 0 and 0.1
     (two launches bitwise equal), and all three at the train step's shapes
     (batch 64, dropout 0.1), whose times make the kernel line; the same
     for the causal configuration's shapes (cross-attention to 36, 47 and
     24 bank rows with no bias, the front-door self-attention under a key
     mask); and the attention-only kernel (`mha`, forward only) against
     its plain version at the cases of the JAX package's test and at the
     cross-attention over hoisted text it is kept to compare with (batch 8
     and 64), beside scaled_dot_product_attention as a yardstick;
  4. decode: the full-width R2R greedy-decode rollout through the kernels
     (launch counts reset just before, read just after), then the same
     batch with every attention on the eager PyTorch path; actions must be
     identical and the logits' masks as the model defines them; then the
     same for GOAT's causal configuration with its seeded banks;
  5. train: (a) one R2R DAgger step at batch 8, every dropout probability
     0, through the eager path and through the kernels from the same
     weights, batch and generator: sampled actions identical, losses to a
     relative 1e-4, every parameter's gradient within 1e-3 of its largest
     magnitude (the biases of gate_witness.NOISE_GRAD_BIASES, whose
     gradients are zero up to rounding, within 1e-3 of their weight's).
     A ReLU of a ClsPrediction head whose input lies within KINK_BAND
     (the forward's ATOL) of 0 may decide either way within the kernels'
     tolerated error, and its decision moves that unit's whole gradient:
     the kernel step takes the eager step's decision at every unit where
     its own differs (gate_witness.pin_relus), and fails if one of those
     lies farther from the kink;
     (b) the bench's step
     (batch 64, dropout 0.1 / 0.1 / features 0.4): one warm-up step per
     gt-length bucket, then EARLIER_STEPS timed steps (2; 3 before the
     bf16 phases came), loss and grad norm finite,
     the parameters moved, and the kernels' launches equal to the count
     the config and the steps each rollout ran give; peak memory of the
     warm-up and of the timed steps, with what earlier phases left
     allocated freed first (and printed); then the same on the eager path,
     timed for comparison; (c) and (d):
     (a) and (b) for the causal configuration (the eager timing is left
     out, and a line says so, when its predicted peak would pass 76 GiB).
bf16 (the JAX package's bench trains its model in bf16 with remat
"model"):
  3 (bf16): the kernels' bf16 builds against the plain version in bf16
     and both against float64 on the same bf16-rounded inputs (output and
     every gradient scaled by its largest float64 magnitude: the kernel's
     error at most 2x the plain version's + 1e-3), at the decode shapes
     (batch 8, dropout 0; keep share within 4 binomial sd of 0.9), past
     256 keys (Lk 256, 257, 300, 520: the bf16 cores take any Lk) and
     at the train shapes (batch 64,
     dropout 0.1, timed beside the plain version, `addmm` x3 + SDPA in
     bf16 with their autograd, and the bound at 989 TFLOP/s / 3.35 TB/s;
     K1 and K2 (a), (b) and their library calls also by device time, from
     CUDA graphs; K1 and K2 (a), (b) by part: the two attention cores
     (attn_fwd_sm90, attn_bwd_sm90, their own C calls, also from CUDA
     graphs) beside their bytes bounds and SDPA,
     each GEMM part's TFLOP/s, the host time of one C call); two backward
     launches bitwise equal; K2 (a)'s dq past 64 keys (Lk 130, 200, 300,
     520) within one rounding of its exact sum over all keys, and at Lk
     130 and 200 within DQ_LONG_RATIO of the plain version's error; the
     bf16 attention-only kernel (`mha`) against float64 beside its plain
     version at MHA_CASES and at 300 and 520 keys, and within one output
     rounding of float64 (its control, p v on one bf16 rounding of p,
     must fail that check); the float32 builds past 256 keys (Lk 257, 300,
     520: the attention forward's key blocks) against the plain version
     with phase 3's float32 gates, and a float32 block over 257 keys
     through the fused gate launches the kernels;
  3 (head widths): K1, K2 (a), K2 (b) and K3 at head widths 32 and 128
     (24 heads of 32, 6 of 128 over D = 768), float32 and bf16, at the
     local shape (Lq = Lk = 54, key mask), batch 64, dropout 0.1, under
     the gates above and timed as the train shapes (K3 over 60 text keys,
     bf16 within one output rounding of float64); then K1 and K2 at the
     vectorized teacher's phase B row count (512 x 52, float32 gated at
     dropout 0 and 0.1, bf16 gated and timed);
  4 (bf16): greedy decode in bf16 through the kernels and on the eager
     path from the same weights, against the float32 kernel route's first
     step (each route's logits, the kernels' distance at most 2x the
     eager route's + 1e-3; in the plain configuration the two bf16 routes
     within 3e-2 of each other), masks as the model defines them;
  5 (e): remat "model" against "none" through the kernels, two batch-8
     DAgger steps at dropout 0.1: actions, losses, gradients (1e-6 of
     their scale) and the generator's state equal;
  5 (f): one batch-8 imitation step without dropout on float32 eager,
     bf16 eager and bf16 kernels: each bf16 route's loss and global
     gradient error against float32, the kernels' at most 2x eager's +
     1e-3 (plain and causal);
  5 (h): the vectorized teacher against the per-step teacher through the
     kernels (float32, batch 8, dropout 0, one imitation step each):
     targets and actions identical, losses to a relative 1e-4, every
     gradient within 1e-3 of its largest magnitude, the same launches;
     then the vectorized step on eager against the kernels under (a)'s
     gates, with its ReLU pinning;
  5 (i): (a)'s gates for the DAgger step with sample_feedback
     "expl_sample" and for the dagger_fused step on a batch whose halves
     come from different buckets;
  5 (j): the dagger_fused bench build (bf16, remat "model", two
     minibatches of 64 a step): one warm-up per bucket, 2 timed steps,
     loss and grad norm finite, parameters moved, launches as the config
     gives them (the text encoding once per fused step), peak memory;
  5 (g): the bench build (bf16, remat "model", batch 64, dropout on,
     the vectorized teacher), causal then plain, one warm-up per bucket
     and 2 timed steps, and a float32 remat "model" warm-up whose peak
     must be under half of (b) / (d)'s; before the plain one, the
     vectorized and the per-step teacher in one call, 2 steps each on the
     same batches, alternating; then one more plain step under
     torch.profiler (the device-busy share, the ten kernels with the most
     device time, the bf16 K1 / K2 kernels' share), after every timed
     step.
  3 (m): F6's widths through the wrappers' zero pad: K1, K2 (a) + (b)
     (autograd) and K3 at head widths 16, 48 and 96 over D = 768 and at
     D = 200 as 5 heads of 40 (Lq = Lk = 54 under a key mask, batch 64,
     dropout 0.1), float32 under phase 3's gates and bf16 under phase 3
     (bf16)'s, each call launching the kernels; timed beside head width
     64 at D = 768 (unpadded) and beside the plain version and the
     library calls;
  5 (k): every remat policy (ops/remat.py) on the bench build (bf16,
     batch 64, the kernels, dropout on): one DAgger step each from the
     same weights, batch and generator seed; the loss equal to "none"'s,
     every gradient within 1e-6 of its largest magnitude of "none"'s;
     step ms, peak GiB, the GiB the loss forward keeps for the backward
     and launches per policy; "full"'s peak and kept GiB below
     "model"'s;
  5 (l): the fine-tune CLI (`python -m vln_goat_tpu_torch.cli`) at full
     R2R width on `--synthetic` with `--use_pallas --compute_dtype
     bfloat16`, batch 8, its default remat ("full"): train 2 iterations
     (validation every 2), resume from `train_state_latest` to 4, `--mode
     valid --submit` from the saved state; K1 and K2 launched, metrics
     and submissions written, losses finite, the `--save_torch_ckpt` .pt
     read back by the port's loader bit for bit.
  5 (w): the same CLI at head widths 256 (`--num_attention_heads 3`,
     bf16, remat "model") and 192 (4 heads, float32), batch 8, 2
     iterations, every dropout 0, through the kernels and on the eager
     path (the bf16 case in float32 eager too): ms an iteration, launches
     by route, no wide-head core launch, losses under 5 (a)'s and 5 (f)'s
     gates.
  3 (n): F6 past 128: K1, K2 (autograd) and K3 in both builds at 3 heads
     of 256 and 4 of 192 over D = 768 (their tensor-core instances), 5 of
     160 over D = 800 and 7 of 224 over D = 1568 (zero-padded to 192 and
     256) and 5 of 320 over D = 1600 (the wide-head core), phase 3 (m)'s
     gates, wide-head core launches only at 320, times and device times,
     beside head width 128; then K1, K2 (a), (b) at
     the new paths' shapes (the REVERIE local branch, 74 tokens at batch
     32; the RxR instruction, 250 at batch 16; the CFP tim self-encoders,
     48 and 53 at batch 64) under phase 3's and 3 (bf16)'s gates, timed;
  5 (m): REVERIE at R2R width with 20 synthetic objects a viewpoint, batch
     32: the greedy decode through the kernels and on the eager path
     (actions, trajectories, pred_obj_id identical, logits within 1e-3),
     then one DAgger step with remat "full" and the og loss on float32
     eager, bf16 eager and bf16 kernels (dropout 0, the sampled actions
     forced by scaled Gumbel draws): the kernels' loss and gradient error
     against float32 at most 2x eager bf16's + 1e-3;
  5 (n): RxR at R2R width, 250-token instructions, horizon 28, the nDTW
     expert, batch 16: one DAgger step through the kernels in float32
     (loss to a relative 1e-4 of the eager step's) and in bf16;
  5 (o): CFP extraction over 64 trajectories through the kernels and on
     the eager path (outputs within 1e-4);
  5 (p): the CLI on the card: `--dataset reverie` train and valid
     --submit, `--dataset rxr --expert_policy ndtw` train, `--mode
     extract_cfp_features`.
  3 (o): K1, K2 (a) and K2 (b) in float32 at every attention shape of
     pretraining at R2R width, batch 48 (the text's 80 tokens, MLM's text
     over the 64 map slots and the 53 viewpoint tokens, the map's
     self-attention with and without the graph bias, the map and the
     viewpoint over the text, the viewpoint's self-attention, REVERIE's
     73-token viewpoint), dropout 0.1, phase 3's gates, timed;
  5 (q): pretraining at R2R width through the pretrain CLI's `--synthetic`
     build, batch 48, trajectories of 20 steps: one update per task (MLM,
     SAP, CFP, MRC with 1000 classes; OG on the REVERIE rig, 20 objects a
     viewpoint) through the kernels against the eager path, every dropout
     at 0 (loss to a relative 1e-4, gradients within 1e-3 of their scale,
     phase 5 (a)'s ReLU pinning within KINK_BAND, K1 / K2 launches equal to
     the task's plan: every attention on the kernels); then each task's
     examples per second and peak memory with dropout on, fed by the CLI's
     worker pool (2 warm-up and 2 timed updates), and one more update
     under torch.profiler (device-busy share, the float32 K1 / K2
     kernels' device time);
  5 (r): the pretrain CLI (MLM / SAP / CFP, use_pallas_attention, batch
     48, 4 updates, one validation) writing `ckpt_latest` and a
     `ckpt_best_*`, whose pretrain .pt initialises the fine-tune model with
     no encoder key missing and runs 2 iterations of the fine-tune CLI
     through `--bert_ckpt_file`.
  3 (s): K1 float32 and bf16 at the z-dict refresh's shape (64 x 64 under
     the key mask, batch 64) under phase 3's and 3 (bf16)'s gates, timed at
     dropout 0 as the refresh calls it;
  5 (s): the online z-dict refresh (`tools.zdict.update_instr_zdict`) of
     512 synthetic instructions at width 64 on the R2R model, through the
     kernels and on the eager path from the same weights: keys and p(z)
     equal, features within 1e-4 of their scale, K1 launched chunks x text
     layers times; time and peak memory;
  5 (t): the speaker at its published width (hidden 512, word 256, 4 heads
     of 64, 3 layers, FFN 1024) over the R2R vocabulary: its deterministic
     loss on one batch of 64 within 1e-4 of the same computation on the
     CPU (TF32 off), 20 Adam steps at batch 64 with the loss falling, a
     greedy decode of 64 paths to 120 tokens; ms a step, decode seconds,
     peak memory;
  5 (u): one back-translated dagger_fused update (two minibatches of 32
     re-captioned by 5 (t)'s speaker in one pass under one shared noise
     vector) through the kernels against eager under 5 (a)'s gates and
     launch plan, every dropout 0; then the CLI: `--mode speaker` 4
     iterations and `train --use_transpeaker --speaker_ckpt_file <its
     speaker_best> --aug synthetic --z_instr_update --update_iter 1`, 2
     iterations, at R2R width.
  5 (v): more than one process (`parallel/`) and the native library:
     (iii) the port's native library built by g++ from nothing (timed, in
     a directory of its own), its token blocks equal to the numpy path in
     200 cases over the four break modes; (i) 3 DAgger updates of the
     bench's step (R2R width, batch 64, float32, the kernels, dropout on)
     in a process group of one over nccl, through `shard_batch`,
     `all_reduce_grads` and `reduce_metrics`, against the same updates
     with no group, under torch's deterministic algorithms: losses and
     parameters bit for bit, ms per update of both, K1 / K2 launched
     (their launches are the kernel line's `dp_train`); (ii) two spawned
     ranks on the one card over gloo (nccl takes one rank a card): an
     imitation update at R2R width, dropout 0, on 8 rows each of a batch
     of 16, and the pretraining MLM (the global counts) and CFP (the
     gathered negatives) updates on 4 rows each of a batch of 8, each
     against one process on the whole batch from the same weights: the
     loss within 1e-6 relative, the gradients within 5 (a)'s gate, the
     parameters by `params_rule`, the two ranks' parameters equal, K1 / K2
     launched on each rank; ms per update (gloo stages every collective
     through the host: no yardstick);
  5 (x): the fused AdamW (`ops/csrc/adamw.cu`) at the benchmark's two
     leaf sets (the goat-r2r fine-tune and pretraining models): its two
     launches' device ms against the bytes bound, the call's host us and
     synchronised ms, the plain loop's ms, and torch's fused AdamW after
     a foreach clip as the library's yardstick; the kernels held against
     the plain version there, clip engaged and not (bit-equal, the norm
     within 1.5e-7 of float64); 5 (g), (q) and (t) check that each of
     their updates launched them.
The train steps run the vectorized teacher unless a phase says otherwise.
Every bf16 decode and train path's launches of the bf16 GEMM core and of
the bf16 attention cores must all have taken their TMA routes
(`ops.attention.bf16_core_routes`, `attn_core_routes`).
Every path is driven with the launch counts set to 0 just before it and
read just after.
The line before the last is one JSON object with every kernel's numbers
(the bf16 builds as rows of their own); the last is {"ok": true,
"device": {...}}.  Any failure raises, but for the comparisons of phases
4 (bf16) and 5 (a), (c), (e)-(v): each prints its failure, the
later phases run and print their numbers, and the script then prints the
failures instead of the last two lines and exits non-zero.  An error
raised in any phase is printed with the phase's name and its traceback,
then the failure summary, and the script exits non-zero.  There is no
CPU fallback, and without a card the script exits non-zero before
printing a result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from vln_goat_tpu_torch.config import TrainConfig
from vln_goat_tpu_torch.entry import (build_flagship, build_train_flagship,
                                      greedy_rollout, train_steps)
from vln_goat_tpu_torch.ops.remat import POLICIES as REMAT_POLICIES
from vln_goat_tpu_torch.ops.dropout import set_generator
from vln_goat_tpu_torch.train.trainer import (fuse_dagger_batches,
                                              init_train_state, make_loss_fn)
from vln_goat_tpu_torch.models.layers import AttentionCore
from vln_goat_tpu_torch.ops import _build, optim
from vln_goat_tpu_torch.ops.attention import (_bwd_call, _bwd_lib,
                                              _fwd_call, _mha_lib,
                                              ATTN_KEY_CHUNK, HEAD_DIMS,
                                              attend_plain,
                                              attention_backward,
                                              attn_core_routes,
                                              bf16_core_routes,
                                              forward_projection,
                                              fused_qkv_mha,
                                              fused_qkv_mha_plain, mha,
                                              mha_plain, padded_widths,
                                              project_plain,
                                              projection_backward,
                                              PROJ_PARTS, ProjectionBackward,
                                              wide_core_launches)
from vln_goat_tpu_torch.tools.gate_witness import (NOISE_GRAD_BIASES,
                                                    TEACHER_NOISE_BIASES,
                                                    pin_relus,
                                                    record_relus,
                                                    worst_grad)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, dense
# float32 outside the tensor cores (the bound printed beside) and dense
# TF32 on the tensor cores (every kernel computes there in the 3xTF32
# split: three TF32 products per float32-accurate one)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
# dense bf16 on the tensor cores: the bf16 builds of the kernels' rate
PEAK_BF16_FLOP_PER_S = 989e12
ATOL, RTOL = 1e-4, 1e-3   # float32, sums taken in another order than cuBLAS
# Phase 5 (a) / (c): a ReLU pre-activation of a ClsPrediction head within
# this of 0 may fall on either side of the kink within the forward's
# tolerated error (ATOL); the kernel step takes the eager step's decision
# there, and a decision that differs farther from the kink fails
KINK_BAND = ATOL

D, H, DH, B = 768, 12, 64, 8
B_TRAIN = 64              # bench_train's default batch
# timed steps of the float32 train paths 5 (b) and (d), cut from 3 to keep
# the script's time with the bf16 phases; the bench build 5 (g) times 3
EARLIER_STEPS = 2
# timed steps of the bench build 5(g) (and its causal run), cut from 3 to
# keep the script's time with phase 5 (w)
BENCH_STEPS = 2
RATE = 0.1                # attention_probs_dropout_prob of the R2R config
# Seed of the random weights.  With seed 0 (build_flagship's default)
# every episode of the first batch stops at its first step, which leaves
# the per-step path (moves, path expansion, arrivals) idle; with seed 4
# every episode of the batch moves for the whole 15-step horizon.
WEIGHT_SEED = 4
# the eager train step's peak over the kernel path's in the plain
# configuration, whose rollout step makes 6 attention calls (chip run,
# H100 80GB HBM3), and the most the causal eager step may be predicted
# to take before its timing is left out
EAGER_EXCESS_GIB, EAGER_LIMIT_GIB = 6.7, 76.0
# (name, Lq, Lk, bias kind, weight layout) at the rollout's shapes:
# text self-attention over a 60-token instruction (200 is R2R's cap),
# global-map self-attention (48 nodes + stop + MEM) with the key mask plus
# the graph-distance bias, local self-attention (16 candidates + 36 views
# + stop + MEM) with a key mask; the per-head bias case takes the weights
# as contiguous [D, H*dh] matrices instead of transposed Linear weights
SHAPES = (("text60", 60, 60, "key", "linear"),
          ("text200", 200, 200, "key", "linear"),
          ("gmap50", 50, 50, "full", "linear"),
          ("local54", 54, 54, "key", "linear"),
          ("gmap50_per_head_bias", 50, 50, "heads", "dense"))
# the causal configuration's: text cross-attention to the direction (36),
# landmark (47) and front-door (24) banks, map and local cross-attention
# to their front-door banks (24), all without a bias, and the map's
# front-door self-attention under its key mask alone
CAUSAL_SHAPES = (("text60x36", 60, 36, "none", "linear"),
                 ("text60x47", 60, 47, "none", "linear"),
                 ("text60x24", 60, 24, "none", "linear"),
                 ("gmap50x24", 50, 24, "none", "linear"),
                 ("local54x24", 54, 24, "none", "linear"),
                 ("gmap50_front_self", 50, 50, "key", "linear"))
TRAIN_SHAPES = ("text60", "gmap50", "local54") + tuple(
    s[0] for s in CAUSAL_SHAPES)
# the attention-only kernel: the three cases of the JAX package's
# tests/test_pallas_attention.py, then the cross-attention over the
# hoisted text K/V it is kept to compare with (map and local queries
# against a 60-token instruction under its key mask), at batch 8 and 64
MHA_CASES = (("case16x16", 16, 16, "none", B),
             ("case24x40_key", 24, 40, "key", B),
             ("case12x12_full", 12, 12, "heads", B),
             ("gmap50xtext60", 50, 60, "key", B),
             ("local54xtext60", 54, 60, "key", B),
             ("gmap50xtext60_b64", 50, 60, "key", B_TRAIN),
             ("local54xtext60_b64", 54, 60, "key", B_TRAIN))
MHA_LINE = ("gmap50xtext60_b64", "local54xtext60_b64")
# names of the grads that the backward returns, in argument order
GRADS = ("dx", "dy", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dbias")


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 10) -> float:
    """Device time of one call of fn: `reps` calls captured in a CUDA
    graph and the graph timed by cuda_ms, so no host work sits between the
    launches (a part of a kernel can take less time than its launch)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay) / reps


def grad_graph_ms(forward, cotangents, reps: int = 10) -> float:
    """graph_ms of `torch.autograd.grad(out, inputs, cotangents)` for
    (out, inputs) = forward(), built once, on the capture stream, inputs
    leaves made there: autograd runs a backward op, and accumulates a
    leaf's gradient, on the stream of its forward op or leaf, which must
    be the one capturing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out, inputs = forward()
        torch.autograd.grad(out, inputs, cotangents, retain_graph=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            torch.autograd.grad(out, inputs, cotangents, retain_graph=True)
    torch.cuda.current_stream().wait_stream(side)
    return cuda_ms(graph.replay) / reps


def make_case(g, Lq, Lk, bias_kind, layout, batch=B):
    """(args, seed): inputs of one fused attention call; the weights and
    a graph or per-head bias require grad, a key mask does not."""
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x, y = randn(batch, Lq, D), randn(batch, Lk, D)
    ws, bs = [], []
    for _ in range(3):
        w = randn(H * DH, D, scale=1.0 / math.sqrt(D))  # Linear [out, in]
        w = w.requires_grad_() if layout == "linear" \
            else w.t().contiguous().requires_grad_()
        ws.append(w.t() if layout == "linear" else w)
        bs.append(randn(H * DH, scale=0.02).requires_grad_())
    keep = torch.rand(batch, Lk, generator=g, device=dev) < 0.85
    keep[:, 0] = True
    key = (1.0 - keep.float())[:, None, None, :] * -10000.0
    if bias_kind == "none":
        bias = None
    elif bias_kind == "key":
        bias = key
    elif bias_kind == "full":
        bias = (key + randn(batch, 1, Lq, Lk)).requires_grad_()
    else:
        bias = (key + randn(batch, H, Lq, Lk)).requires_grad_()
    x.requires_grad_()
    y.requires_grad_()
    seed = torch.randint(0, 2 ** 31 - 1, (batch,), generator=g, device=dev,
                         dtype=torch.int32)
    return (x, y, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], bias), seed


def _bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(args, kind="fwd", with_ds=False, tf32x3=False):
    """(ms by operations, ms by bytes) of one kernel call: the operations
    over the float32 peak, or with `tf32x3` three times the operations over
    the TF32 tensor-core peak (the float32-accurate rate of the 3xTF32
    split), or for bf16 arguments the operations over the bf16
    tensor-core peak; and bytes over the memory rate with each input read
    once and each output written once (in the arguments' dtype, ds in
    float32).  fwd: projections and the two attention products; attn
    (backward (a)): the recomputed projections and scores plus dp, dq, dk
    and dv; proj (backward (b)): dx, dy and the three weight gradients."""
    x, y, wq, bq, wk, bk, wv, bv, bias = args
    Bx, Lq, Dx = x.shape
    Lk, HD = y.shape[1], wq.shape[1]
    es = x.element_size()
    proj = 2 * Bx * (Lq + 2 * Lk) * Dx * HD
    att = 2 * Bx * Lq * Lk * HD                 # one [Lq x Lk x dh] product
    out_q, out_k = Bx * Lq * HD, Bx * Lk * HD
    ds = Bx * H * Lq * Lk if with_ds else 0
    weights = _bytes(wq, bq, wk, bk, wv, bv)
    if kind == "fwd":
        flops = proj + 2 * att
        nbytes = _bytes(x, y, bias) + weights + es * out_q
    elif kind == "attn":
        flops = proj + 5 * att
        nbytes = _bytes(x, y, bias) + weights \
            + es * (2 * out_q + 2 * out_k) + 4 * ds
    else:
        flops = 2 * proj
        nbytes = 2 * (_bytes(x, y) + weights) + es * (out_q + 2 * out_k) \
            + 4 * (ds + ds // H)
    if x.dtype == torch.bfloat16:
        ops_ms = flops / PEAK_BF16_FLOP_PER_S
    elif tf32x3:
        ops_ms = 3 * flops / PEAK_TF32_FLOP_PER_S
    else:
        ops_ms = flops / PEAK_F32_FLOP_PER_S
    return ops_ms * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3


def library_call(args):
    """Linear projections + scaled_dot_product_attention: a yardstick
    timed here only; the port never calls it."""
    x, y, wq, bq, wk, bk, wv, bv, bias = args
    Bx, Lq, _ = x.shape
    Lk = y.shape[1]
    q = torch.addmm(bq, x.view(-1, D), wq).view(Bx, Lq, H, DH).transpose(1, 2)
    k = torch.addmm(bk, y.view(-1, D), wk).view(Bx, Lk, H, DH).transpose(1, 2)
    v = torch.addmm(bv, y.view(-1, D), wv).view(Bx, Lk, H, DH).transpose(1, 2)
    o = F.scaled_dot_product_attention(
        q, k, v, attn_mask=None if bias is None else bias.to(x.dtype))
    return o.transpose(1, 2).reshape(Bx, Lq, H * DH)


def grad_scales(ref):
    """Tolerance scale of each gradient: its largest magnitude; the key
    bias's is at least its weight's (its gradient is zero up to rounding:
    softmax ignores a constant added to a row of scores)."""
    scales = []
    for i, r in enumerate(ref):
        s = 0.0 if r is None else float(r.abs().max())
        if GRADS[i] == "dbk":
            s = max(s, scales[-1])
        scales.append(s)
    return scales


def check_grads(got, ref, what):
    """Largest |got - ref| over the gradients; raises beyond atol 1e-4 /
    rtol 1e-3 scaled by each gradient's largest magnitude."""
    worst = 0.0
    for name, g, r, s in zip(GRADS, got, ref, grad_scales(ref)):
        if r is None:
            if g is not None:
                raise AssertionError(f"{what}: {name} should be None")
            continue
        torch.testing.assert_close(g, r, atol=ATOL * s, rtol=RTOL,
                                   msg=lambda m: f"{what} {name}: {m}")
        worst = max(worst, float((g - r).abs().max()))
    return worst


def leaves(args):
    return [a if a is not None and a.requires_grad else None for a in args]


def grads_of(out, args, dout):
    """Gradients of <out, dout> for every argument that requires grad
    (None for the others)."""
    lv = leaves(args)
    got = torch.autograd.grad(out, [a for a in lv if a is not None], dout)
    it = iter(got)
    return [None if a is None else next(it) for a in lv]


def kept_unit(Lk):
    """The value one kept uniform probability adds to an output column
    of values one: 1 / (Lk (1 - RATE)) as the kernels compute it in
    float32.  The bf16 build rounds e = exp(s - max) = 1, exact in bf16,
    before p v and divides by the row sum after it, so no bf16 rounding
    enters the unit."""
    f32 = torch.float32
    unit = (torch.tensor(1.0, dtype=f32) / Lk) \
        * torch.tensor(1.0 / (1.0 - RATE), dtype=f32)
    return float(unit)


def keep_share(Lq, Lk, dtype=torch.float32):
    """Share of the probabilities the forward kernel keeps at RATE: with
    zero query weights the probabilities are uniform, and with values of
    one every output column is kept count x kept_unit(Lk)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(B, Lq, D, generator=g, device="cuda").to(dtype)
    y = torch.randn(B, Lk, D, generator=g, device="cuda").to(dtype)
    zeros = torch.zeros(D, device="cuda", dtype=dtype)
    w0 = torch.zeros(D, D, device="cuda", dtype=dtype)
    seed = torch.randint(0, 2 ** 31 - 1, (B,), generator=g, device="cuda",
                         dtype=torch.int32)
    with torch.no_grad():
        out = fused_qkv_mha(x, y, w0, zeros, w0, zeros, w0, zeros + 1.0,
                            None, num_heads=H, dropout_rate=RATE, seed=seed)
    share = float(out[..., ::DH].float().mean()) / (Lk * kept_unit(Lk))
    sd = math.sqrt(RATE * (1.0 - RATE) / (B * H * Lq * Lk))
    if abs(share - (1.0 - RATE)) > 4 * sd:
        raise AssertionError(f"keep share {share} at {Lq}x{Lk}: more than "
                             f"4 sd ({sd:.2e}) from {1 - RATE}")
    return share, sd


def backward_kernels(args, seed, dout, rate):
    """Both backward kernels on one call's inputs, as FusedQKVMHA runs
    them: ((dq, dk, dv, ds), (dx, dy, dW*, db*, dbias) in GRADS order)."""
    x, y, wq, bq, wk, bk, wv, bv, bias = args
    need_ds = bias is not None and bias.requires_grad
    det = [None if a is None else a.detach() for a in args]
    dq, dk, dv, ds = attention_backward(*det, seed, dout, H, rate,
                                        need_ds=need_ds)
    per_head = need_ds and bias.shape[1] == H
    dx, dy, dws, dbs, dbias = projection_backward(
        det[0], det[1], det[2], det[4], det[6], dq, dk, dv,
        ds if need_ds and not per_head else None, H)
    if per_head:
        dbias = ds
    return (dq, dk, dv, ds), [dx, dy, dws[0], dbs[0], dws[1], dbs[1],
                              dws[2], dbs[2], dbias]


def check_shape(g, name, Lq, Lk, bias_kind, layout, batch, timed):
    """Phase 3 for one shape; returns its row of numbers."""
    row = {}
    args, seed = make_case(g, Lq, Lk, bias_kind, layout, batch)
    det = [None if a is None else a.detach() for a in args]
    rates = (0.0, RATE) if not timed else (RATE,)
    for rate in rates:
        with torch.no_grad():
            out = fused_qkv_mha(*det, num_heads=H, dropout_rate=rate,
                                seed=seed)
        torch.cuda.synchronize()
        ref = fused_qkv_mha_plain(*det, num_heads=H, dropout_rate=rate,
                                  seed=seed)
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
        row[f"fwd_err_{rate}"] = float((out - ref).abs().max())

        # backward: FusedQKVMHA's gradients against the plain autograd
        dout = torch.randn(batch, Lq, H * DH, generator=g, device="cuda")
        got = grads_of(fused_qkv_mha(*args, num_heads=H, dropout_rate=rate,
                                     seed=seed), args, dout)
        plain = grads_of(fused_qkv_mha_plain(*args, num_heads=H,
                                             dropout_rate=rate, seed=seed),
                         args, dout)
        row[f"proj_err_{rate}"] = check_grads(got, plain,
                                              f"{name} rate {rate}")
        # backward (a) alone: dq, dk, dv against autograd of the plain
        # attention over the plain projections
        qkv = [t.detach().requires_grad_()
               for t in project_plain(*det[:8])]
        att = attend_plain(*qkv, det[8], H, rate, seed)
        pq = torch.autograd.grad(att, qkv, dout)
        (dq, dk, dv, _), first = backward_kernels(args, seed, dout, rate)
        for a, b_, n in zip((dq, dk, dv), pq, ("dq", "dk", "dv")):
            torch.testing.assert_close(
                a, b_, atol=ATOL * float(b_.abs().max()), rtol=RTOL,
                msg=lambda m: f"{name} rate {rate} {n}: {m}")
        row[f"attn_err_{rate}"] = max(float((a - b_).abs().max())
                                      for a, b_ in zip((dq, dk, dv), pq))
        # two launches on the same inputs: bitwise equal
        again = backward_kernels(args, seed, dout, rate)
        pairs = list(zip((dq, dk, dv), again[0][:3])) + \
            list(zip(first, again[1]))
        if not all(a is None and b_ is None or torch.equal(a, b_)
                   for a, b_ in pairs):
            raise AssertionError(f"{name}: two backward launches differ")
    if bias_kind == "key" and not timed:
        row["keep_share"], row["keep_sd"] = keep_share(Lq, Lk)

    rate = RATE if timed else 0.0
    dout = torch.randn(batch, Lq, H * DH, generator=g, device="cuda")
    row["ms"] = cuda_ms(lambda: fused_qkv_mha(*det, num_heads=H,
                                              dropout_rate=rate, seed=seed))
    row["plain_ms"] = cuda_ms(lambda: fused_qkv_mha_plain(
        *det, num_heads=H, dropout_rate=rate, seed=seed))
    row["library_ms"] = cuda_ms(lambda: library_call(det))
    row["library_err"] = float((library_call(det) - fused_qkv_mha_plain(
        *det, num_heads=H)).abs().max())
    fb = bound(det, tf32x3=True)
    row["bound_ms"], row["bound_by"] = max(fb), \
        "operations" if fb[0] >= fb[1] else "bytes"
    row["bound_f32_ms"] = max(bound(det))
    if not timed:
        return row

    # by device time: K1 and its library call, each from a CUDA graph of
    # ten calls
    row["device_ms"] = graph_ms(lambda: fused_qkv_mha(
        *det, num_heads=H, dropout_rate=rate, seed=seed))
    row["library_device_ms"] = graph_ms(lambda: library_call(det))
    # the forward by part: its q / k / v projection GEMM alone, and the
    # attention core over that GEMM's output through `mha` (the same core,
    # without dropout)
    qkv = forward_projection(*det[:8], num_heads=H)
    row["fwd_proj_ms"] = graph_ms(
        lambda: forward_projection(*det[:8], num_heads=H))
    row["fwd_attn_ms"] = graph_ms(lambda: mha(*qkv, det[8]))
    del qkv

    time_backward(row, args, det, seed, dout, batch, rate, parts=True)
    return row


def time_backward(row, args, det, seed, dout, batch, rate, parts):
    """Times of both backward kernels at one call's inputs (float32 or
    bf16), beside the plain version's and the library's backward and their
    bounds, into `row`; with `parts`, the projection backward by part."""
    # backward times: each kernel alone, against the backward of the
    # matching part of the plain version and of the library call
    need_ds = args[8] is not None and args[8].requires_grad
    x, y, wq, bq, wk, bk, wv, bv, bias = det
    dq, dk, dv, ds = attention_backward(*det, seed, dout, H, rate,
                                        need_ds=need_ds)
    row["attn_ms"] = cuda_ms(lambda: attention_backward(
        *det, seed, dout, H, rate, need_ds=need_ds))
    hsum = ds if need_ds and bias.shape[1] == 1 else None
    row["projb_ms"] = cuda_ms(lambda: projection_backward(
        x, y, wq, wk, wv, dq, dk, dv, hsum, H))
    # (a)'s yardsticks recompute the projections, as the kernel does:
    # the plain projections (no grad) then the plain attention's forward and
    # its backward to q, k, v (and the bias); three addmm then SDPA's
    # forward and its backward to q, k, v

    def attn_plain():
        with torch.no_grad():
            qkv = project_plain(*det[:8])
        qkv = [t.requires_grad_() for t in qkv]
        att = attend_plain(*qkv, args[8], H, rate, seed, dtype=x.dtype)
        return torch.autograd.grad(att, qkv + ([args[8]] if need_ds
                                               else []), dout)

    row["attn_plain_ms"] = cuda_ms(attn_plain)
    lv = [a for a in leaves(args)[:8] if a is not None]
    pq = project_plain(*args[:8])
    # in bf16 the plain projections are float32 (bf16 products summed in
    # float32), so their cotangents are too
    dqkv = [t.to(p_.dtype) for t, p_ in zip((dq, dk, dv), pq)]
    row["projb_plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
        pq, lv, dqkv, retain_graph=True))
    do4 = dout.view(batch, -1, H, DH).transpose(1, 2)
    mask = None if bias is None else bias.to(x.dtype)

    def attn_library():
        with torch.no_grad():
            q4, k4, v4 = (torch.addmm(b_, s_.view(-1, D), w_)
                          .view(batch, -1, H, DH).transpose(1, 2)
                          for s_, w_, b_ in ((x, wq, bq), (y, wk, bk),
                                             (y, wv, bv)))
        qkv = [t.requires_grad_() for t in (q4, k4, v4)]
        lo = F.scaled_dot_product_attention(*qkv, attn_mask=mask)
        return torch.autograd.grad(lo, qkv, do4)

    row["attn_library_ms"] = cuda_ms(attn_library)
    lq = (torch.addmm(args[3], args[0].view(-1, D), args[2]),
          torch.addmm(args[5], args[1].view(-1, D), args[4]),
          torch.addmm(args[7], args[1].view(-1, D), args[6]))
    row["projb_library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        lq, lv, (dq.view(-1, H * DH), dk.view(-1, H * DH),
                 dv.view(-1, H * DH)), retain_graph=True))
    if parts:
        # K2 (a) by device time, and both library calls' (CUDA graphs; the
        # projections' backward from a graph of its forward built on the
        # capture stream)
        row["need_ds"] = need_ds
        row["attn_device_ms"] = graph_ms(lambda: attention_backward(
            *det, seed, dout, H, rate, need_ds=need_ds))
        row["attn_library_device_ms"] = graph_ms(attn_library)
        def projections():
            a = [t.detach().requires_grad_() for t in args[:8]]
            return (torch.addmm(a[3], a[0].view(-1, D), a[2]),
                    torch.addmm(a[5], a[1].view(-1, D), a[4]),
                    torch.addmm(a[7], a[1].view(-1, D), a[6])), a

        row["projb_library_device_ms"] = grad_graph_ms(
            projections, (dq.view(-1, H * DH), dk.view(-1, H * DH),
                          dv.view(-1, H * DH)))
    if parts:
        # (b) by part: the dx and dy GEMMs, the split-K weight gradients,
        # the pass that adds their slices, and the head sum of ds
        call = ProjectionBackward(x, y, wq, wk, wv, dq, dk, dv, hsum, H)
        row["projb_device_ms"] = graph_ms(call.launch)
        for part in PROJ_PARTS:
            if part != "hsum" or hsum is not None:
                row[f"projb_{part}_ms"] = graph_ms(lambda: call.launch(part))
    for kind, key in (("attn", "attn"), ("proj", "projb")):
        ob = bound(det, kind, with_ds=need_ds, tf32x3=True)
        row[f"{key}_bound_ms"] = max(ob)
        row[f"{key}_bound_by"] = "operations" if ob[0] >= ob[1] \
            else "bytes"
        if det[0].dtype == torch.float32:
            row[f"{key}_bound_f32_ms"] = max(bound(det, kind,
                                                   with_ds=need_ds))


def check_kernels():
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, train_rows = {}, {}
    for name, Lq, Lk, bias_kind, layout in SHAPES + CAUSAL_SHAPES:
        row = rows[name] = check_shape(g, name, Lq, Lk, bias_kind, layout,
                                       B, timed=False)
        say(f"kernel fused_qkv_mha {name}: B={B} Lq={Lq} Lk={Lk} "
            f"bias={bias_kind} weights={layout} "
            f"max_abs_err={row['fwd_err_0.0']:.3e} "
            f"(dropout {RATE}: {row[f'fwd_err_{RATE}']:.3e}"
            + (f", keep share {row['keep_share']:.5f} sd "
               f"{row['keep_sd']:.1e}" if "keep_share" in row else "")
            + f") ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} "
            f"(library max_abs_err={row['library_err']:.3e}) "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; float32 "
            f"{row['bound_f32_ms']:.4f}); backward max_abs_err attn "
            f"{row['attn_err_0.0']:.3e} / "
            f"{row[f'attn_err_{RATE}']:.3e}, grads "
            f"{row['proj_err_0.0']:.3e} / {row[f'proj_err_{RATE}']:.3e} "
            f"(dropout 0 / {RATE}), two launches bitwise equal")
    for name, Lq, Lk, bias_kind, layout in SHAPES + CAUSAL_SHAPES:
        if name not in TRAIN_SHAPES:
            continue
        row = train_rows[name] = check_shape(g, name, Lq, Lk, bias_kind,
                                             layout, B_TRAIN, timed=True)
        say(f"train {name}: B={B_TRAIN} Lq={Lq} Lk={Lk} bias={bias_kind} "
            f"dropout {RATE}; forward max_abs_err="
            f"{row[f'fwd_err_{RATE}']:.3e} ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; float32 "
            f"{row['bound_f32_ms']:.4f}), by part proj "
            f"{row['fwd_proj_ms']:.4f}, attn (no dropout) "
            f"{row['fwd_attn_ms']:.4f}; attention backward max_abs_err="
            f"{row[f'attn_err_{RATE}']:.3e} "
            f"ms={row['attn_ms']:.4f} plain_ms={row['attn_plain_ms']:.4f} "
            f"library_ms={row['attn_library_ms']:.4f} "
            f"bound_ms={row['attn_bound_ms']:.4f} "
            f"({row['attn_bound_by']}; float32 "
            f"{row['attn_bound_f32_ms']:.4f}); projection backward "
            f"max_abs_err={row[f'proj_err_{RATE}']:.3e} "
            f"ms={row['projb_ms']:.4f} "
            f"plain_ms={row['projb_plain_ms']:.4f} "
            f"library_ms={row['projb_library_ms']:.4f} "
            f"bound_ms={row['projb_bound_ms']:.4f} "
            f"({row['projb_bound_by']}; float32 "
            f"{row['projb_bound_f32_ms']:.4f}), by part "
            + ", ".join(f"{p} {row[f'projb_{p}_ms']:.4f}"
                        for p in PROJ_PARTS if f"projb_{p}_ms" in row))
    return rows, train_rows

# ---------------------------------------------------------------------------
# Phase 3 in bf16: the bf16 builds of K1, K2 (a) and K2 (b) against the
# plain version in bf16 (the JAX kernel's cast points), both held to a
# float64 evaluation of the same bf16-rounded inputs.  Gate, for the
# output and every gradient scaled by its largest float64 magnitude (the
# key bias's at its weight's): the kernel's error at most twice the plain
# bf16 version's plus BF16_ATOL.
BF16_ATOL = 1e-3
BF16 = torch.bfloat16


def to_bf16(args):
    """The inputs of one call in bf16, each in its own layout (a
    `lin.weight.t()` view stays a view of a contiguous [H*dh, D]), with
    the float32 inputs' requires_grad."""
    out = []
    for a in args:
        if a is None:
            out.append(None)
            continue
        t = a.detach()
        t = t.t().to(BF16).t() if t.dim() == 2 and t.stride(0) == 1 \
            else t.to(BF16)
        out.append(t.requires_grad_(a.requires_grad))
    return tuple(out)


def in_float64(args):
    return tuple(None if a is None else
                 a.detach().double().requires_grad_(a.requires_grad)
                 for a in args)


def bf16_gate(what, got, plain, ref, scale=None):
    """(kernel error, plain error) against the float64 ref, scaled by
    the ref's largest magnitude (or `scale`); raises past the gate."""
    scale = float(ref.abs().max()) if scale is None else scale
    scale = scale if scale > 0 else 1.0
    err = float((got.double() - ref).abs().max()) / scale
    err_plain = float((plain.double() - ref).abs().max()) / scale
    if err > 2 * err_plain + BF16_ATOL:
        raise AssertionError(f"{what}: bf16 kernel error {err:.3e} of the "
                             f"scale > 2 x plain {err_plain:.3e} + "
                             f"{BF16_ATOL}")
    return err, err_plain


def check_shape_bf16(g, name, Lq, Lk, bias_kind, layout, batch, timed):
    """Phase 3 (bf16) for one shape: gates, and with `timed` the times of
    the three kernels; returns its row."""
    args32, seed = make_case(g, Lq, Lk, bias_kind, layout, batch)
    args, args64 = to_bf16(args32), in_float64(to_bf16(args32))
    del args32
    det = [None if a is None else a.detach() for a in args]
    det64 = [None if a is None else a.detach() for a in args64]
    rate = RATE if timed else 0.0
    kw = dict(num_heads=H, dropout_rate=rate, seed=seed)
    row = {}
    with torch.no_grad():
        out = fused_qkv_mha(*det, **kw)
        plain = fused_qkv_mha_plain(*det, **kw)
        ref = fused_qkv_mha_plain(*det64, **kw)
    torch.cuda.synchronize()
    if out.dtype != BF16:
        raise AssertionError(f"{name}: bf16 forward returned {out.dtype}")
    gates = {"out": bf16_gate(f"{name} forward", out, plain, ref)}
    del ref

    # FusedQKVMHA's gradients (K2 a + b) against the plain bf16 autograd,
    # both against the float64 autograd
    dout = torch.randn(batch, Lq, H * DH, generator=g, device="cuda").to(BF16)
    got = grads_of(fused_qkv_mha(*args, **kw), args, dout)
    pl = grads_of(fused_qkv_mha_plain(*args, **kw), args, dout)
    r64 = grads_of(fused_qkv_mha_plain(*args64, **kw), args64,
                   dout.double())
    scales = grad_scales(r64)
    for n_, a, p_, r, sc in zip(GRADS, got, pl, r64, scales):
        if r is None:
            continue
        if a.dtype != BF16:
            raise AssertionError(f"{name} {n_}: {a.dtype}, not bf16")
        gates[n_] = bf16_gate(f"{name} {n_}", a, p_, r, sc)
    del got, pl, r64
    # K2 (a) alone: dq, dk, dv against the plain attention's autograd
    # over the plain projections, both against float64
    qkv = [t.detach().requires_grad_() for t in project_plain(*det[:8])]
    pq = torch.autograd.grad(
        attend_plain(*qkv, det[8], H, rate, seed, dtype=BF16), qkv, dout)
    qkv64 = [t.detach().requires_grad_() for t in project_plain(*det64[:8])]
    pq64 = torch.autograd.grad(attend_plain(*qkv64, det64[8], H, rate, seed),
                               qkv64, dout.double())
    (dq, dk, dv, _), first = backward_kernels(args, seed, dout, rate)
    for n_, a, p_, r in zip(("dq", "dk", "dv"), (dq, dk, dv), pq, pq64):
        gates[n_] = bf16_gate(f"{name} {n_}", a, p_, r)
    # the rows' errors: the kernel's against float64, of each result's
    # scale (bf16 rounds relative to the magnitude)
    row["fwd_err"] = gates["out"][0]
    row["attn_err"] = max(gates[n_][0] for n_ in ("dq", "dk", "dv"))
    row["proj_err"] = max(v[0] for k, v in gates.items()
                          if k in GRADS)
    again = backward_kernels(args, seed, dout, rate)
    pairs = list(zip((dq, dk, dv), again[0][:3])) + \
        list(zip(first, again[1]))
    if not all(a is None and b_ is None or torch.equal(a, b_)
               for a, b_ in pairs):
        raise AssertionError(f"{name}: two bf16 backward launches differ")
    del qkv, qkv64, pq, pq64, again, first
    row["gates"] = gates
    if bias_kind == "key" and not timed:
        row["keep_share"], row["keep_sd"] = keep_share(Lq, Lk, BF16)
    if not timed:
        return row

    row["ms"] = cuda_ms(lambda: fused_qkv_mha(*det, **kw))
    row["plain_ms"] = cuda_ms(lambda: fused_qkv_mha_plain(*det, **kw))
    row["library_ms"] = cuda_ms(lambda: library_call(det))
    fb = bound(det)
    row["bound_ms"], row["bound_by"] = max(fb), \
        "operations" if fb[0] >= fb[1] else "bytes"
    time_backward(row, args, det, seed, dout, batch, rate, parts=True)
    bf16_parts(row, det, kw, dout)
    return row


def gemm_flops(det):
    """Operations of each GEMM part of K1 and K2 (b) at one call's inputs:
    the forward's q / k / v projection, dx, dy and the weight gradients."""
    x, y, wq = det[0], det[1], det[2]
    Bx, Lq, Dx = x.shape
    Lk, HD = y.shape[1], wq.shape[1]
    return dict(proj=2 * Bx * (Lq + 2 * Lk) * Dx * HD,
                dx=2 * Bx * Lq * HD * Dx, dy=2 * Bx * Lk * 2 * HD * Dx,
                dw=2 * Dx * HD * Bx * (Lq + 2 * Lk))


def host_us(fn, n=200):
    """Host microseconds of one call of fn (enqueue only: no synchronise
    inside the loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def part_bound(det, kind, with_ds):
    """(ms, "bytes" or "operations") of the least time of an attention
    part over projected heads at one call's inputs: the forward's ("fwd":
    q, k, v and the bias read, the output written; two products) or K2
    (a)'s ("bwd": q, k, v, dO and the bias read, dq, dk, dv and, with_ds,
    the float32 ds written; five products), at the bf16 peak."""
    x, y, bias = det[0], det[1], det[8]
    Bx, Lq = x.shape[:2]
    Lk = y.shape[1]
    qo, kv = Bx * Lq * H * DH * 2, Bx * Lk * H * DH * 2
    att = 2 * Bx * Lq * Lk * H * DH
    if kind == "fwd":
        nbytes, flops = 2 * qo + 2 * kv + _bytes(bias), 2 * att
    else:
        nbytes = 3 * qo + 4 * kv + _bytes(bias) \
            + (4 * Bx * H * Lq * Lk if with_ds else 0)
        flops = 5 * att
    t = (flops / PEAK_BF16_FLOP_PER_S * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3)
    return max(t), "operations" if t[0] >= t[1] else "bytes"


def attn_cores(det, kw, dout, need_ds):
    """C calls that launch the two bf16 attention cores alone, over one
    projection scratch as the forward and K2 (a)'s recompute fill it
    (`fused_qkv_mha_attn_bf16`, `fused_qkv_mha_bwd_core_bf16`)."""
    q = forward_projection(*det[:8], num_heads=H)[0]
    c = _fwd_call(*det[:8], det[8], kw["seed"], H, kw["dropout_rate"])
    cb = _bwd_call(*det[:8], det[8], kw["seed"], H, kw["dropout_rate"])
    like = dict(device="cuda", dtype=BF16)
    f32 = dict(device="cuda", dtype=torch.float32)
    out = torch.empty((c.B, c.Lq, c.HD), **like)
    dq, dk, dv = (torch.empty((c.B, n, c.HD), **like)
                  for n in (c.Lq, c.Lk, c.Lk))
    ds = torch.empty((c.B, H, c.Lq, c.Lk), **f32) if need_ds else None
    several = c.Lk > ATTN_KEY_CHUNK
    stats = torch.empty(c.B * H * c.Lq * 3, **f32) if several else None
    dq_acc = torch.empty(dq.numel(), **f32) if several else None
    hold = (q, out, dq, dk, dv, ds, stats, dq_acc)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fa = (q.data_ptr(), *c.bias_args(), out.data_ptr(), c.B, c.Lq, c.Lk,
          H, c.dh, c.scale, *c.seed_args())
    ba = (q.data_ptr(), *cb.bias_args(), *cb.seed_args(), dout.data_ptr(),
          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ptr(ds), ptr(stats),
          ptr(dq_acc), c.B, c.Lq, c.Lk, H, c.dh, c.scale)

    # the stream is the current one at each call (a CUDA graph's capture)
    def fwd():
        if c.lib.fused_qkv_mha_attn_bf16(*fa, c.stream()) != 0:
            raise RuntimeError("fused_qkv_mha_attn_bf16 failed")
        return hold

    def bwd():
        if cb.lib.fused_qkv_mha_bwd_core_bf16(*ba, c.stream()) != 0:
            raise RuntimeError("fused_qkv_mha_bwd_core_bf16 failed")
        return hold

    return fwd, bwd


def named_kernel_ms(fn, name, n=20, tries=3):
    """fn() n times under torch.profiler -> (events whose name holds
    `name`, n, their mean device ms), the profile taken again, up to
    `tries` in all, while it holds fewer than n such events: the mean is
    over the events found, so a profile that lost some reads neither low
    nor high, and the count shows the loss.  A cross-check only: no
    number of the kernel line comes from it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        spans = [e_ - s_ for k, s_, e_ in
                 device_work(prof.profiler.kineto_results.events())
                 if name in k]
        if len(spans) >= n:
            break
    return len(spans), n, (sum(spans) / len(spans) / 1e6 if spans
                           else float("nan"))


def bf16_parts(row, det, kw, dout):
    """K1 bf16's device time and its library call's (each from a CUDA
    graph of ten calls, so no host work sits between them), K1 by part
    (the projection GEMM alone by device time; the attention core's own
    C call by ms, as every row's ms, and by device time from a CUDA graph
    of ten of its calls) and K2 (a) by part (its
    recompute runs the projection's jobs; the attention core the same way
    as the forward's), each attention part beside its bound, the plain
    attention over the projected heads and the library's (SDPA, by device
    time), each GEMM part's TFLOP/s, and the host time of one call of the
    projection (C), of the projection backward, and of the K1 and K2 (a)
    wrappers."""
    proj = forward_projection(*det[:8], num_heads=H)
    del proj
    row["fwd_proj_ms"] = graph_ms(
        lambda: forward_projection(*det[:8], num_heads=H))
    row["device_ms"] = graph_ms(lambda: fused_qkv_mha(*det, **kw))
    row["library_device_ms"] = graph_ms(lambda: library_call(det))
    need_ds = row["need_ds"]
    fwd_core, bwd_core = attn_cores(det, kw, dout, need_ds)
    row["fwd_attn_ms"] = cuda_ms(fwd_core)
    row["bwd_attn_ms"] = cuda_ms(bwd_core)
    row["fwd_attn_device_ms"] = graph_ms(fwd_core)
    row["bwd_attn_device_ms"] = graph_ms(bwd_core)
    del fwd_core, bwd_core

    # the core's graph reading checked against the whole K2 (a) call (its
    # graph reading is `attn_device_ms`; its recompute runs the forward
    # projection's jobs): the core inside it by name under the profiler,
    # with the count of its events
    row["bwd_core_named"] = named_kernel_ms(
        lambda: attention_backward(*det, kw["seed"], dout, H,
                                   kw["dropout_rate"], need_ds=need_ds),
        "attn_bwd_sm90_kernel")
    for part in ("fwd", "bwd"):
        row[f"{part}_attn_bound_ms"], row[f"{part}_attn_bound_by"] = \
            part_bound(det, part, row["need_ds"])
    bias, rate, seed = det[8], kw["dropout_rate"], kw["seed"]
    with torch.no_grad():
        qkv0 = project_plain(*det[:8])
    heads4 = [t.to(BF16).view(t.shape[0], t.shape[1], H, DH).transpose(1, 2)
              for t in qkv0]
    do4 = dout.view(dout.shape[0], -1, H, DH).transpose(1, 2)
    mask = None if bias is None else bias.detach()

    def fwd_plain():
        with torch.no_grad():
            return attend_plain(*qkv0, bias, H, rate, seed, dtype=BF16)

    def bwd_plain():
        qkv = [t.detach().requires_grad_() for t in qkv0]
        return torch.autograd.grad(attend_plain(*qkv, bias, H, rate, seed,
                                                dtype=BF16), qkv, dout)

    def bwd_library():
        qkv = [t.detach().requires_grad_() for t in heads4]
        lo = F.scaled_dot_product_attention(*qkv, attn_mask=mask)
        return torch.autograd.grad(lo, qkv, do4)

    def fwd_library():
        return F.scaled_dot_product_attention(*heads4, attn_mask=mask)

    row["fwd_attn_plain_ms"] = cuda_ms(fwd_plain)
    row["bwd_attn_plain_ms"] = cuda_ms(bwd_plain)
    row["fwd_attn_library_ms"] = cuda_ms(fwd_library)
    row["bwd_attn_library_ms"] = cuda_ms(bwd_library)
    row["fwd_attn_library_device_ms"] = graph_ms(fwd_library)
    row["bwd_attn_library_device_ms"] = graph_ms(bwd_library)
    del qkv0, heads4
    flops = gemm_flops(det)
    row["tflops"] = {p: flops[p] / (row[key] * 1e-3) / 1e12
                     for p, key in (("proj", "fwd_proj_ms"),
                                    ("dx", "projb_dx_ms"),
                                    ("dy", "projb_dy_ms"),
                                    ("dw", "projb_dw_ms"))}
    c = _fwd_call(*det[:8], None, None, H, 0.0)
    qkv = torch.empty(c.B * (c.Lq + 2 * c.Lk) * c.HD, device=c.dev,
                      dtype=c.dtype)
    fn = c.entry("fused_qkv_mha_proj")
    cargs = [det[0].data_ptr(), det[1].data_ptr(), *c.weight_args(),
             qkv.data_ptr(), c.B, c.Lq, c.Lk, c.D, c.H, c.dh, c.stream()]
    row["proj_host_us"] = host_us(lambda: fn(*cargs))
    with torch.no_grad():
        row["fwd_host_us"] = host_us(lambda: fused_qkv_mha(*det, **kw))
    row["attn_host_us"] = host_us(lambda: attention_backward(
        *det, kw["seed"], dout, H, kw["dropout_rate"], need_ds=need_ds))
    x, y, wq, _, wk, _, wv, _, _ = det
    dq, dk, dv = (torch.randn(t.shape[0], t.shape[1], H * DH, device="cuda")
                  .to(BF16) for t in (x, y, y))
    call = ProjectionBackward(x, y, wq, wk, wv, dq, dk, dv, None, H)
    row["projb_host_us"] = host_us(call.launch)
    del qkv


# K2 (a)'s dq past 64 keys: its error against float64 at most this many
# times the plain bf16 version's: the largest ratio the one-chunk shapes
# (Lk <= 64) show, 1.345 (phase 3 bf16 at the decode shapes, NVIDIA H100
# 80GB HBM3, 700 W), and 11.5% more
DQ_LONG_RATIO = 1.5


def dq_rounding_excess(dq, ds, k, scale):
    """How far the bf16 kernel's dq lies from one rounding of its exact
    sum over all keys: the reference is the float64 product of the
    kernel's own ds (rounded to bf16, as it enters the product) with the
    projected k [B, Lk, H, dh], times `scale`; each element may differ from
    it by one bf16 ulp of the reference plus 2^-16 of the product's
    absolute sum (the float32 sum's own error).  Returns (the largest
    |dq - ref| over that allowance, the elements beyond it).  A dq added
    up in bf16 chunk by chunk rounds several times and lands beyond it."""
    B, _, Lq, _ = ds.shape
    d, kk = ds.to(BF16).double(), k.double()
    ref = torch.einsum("bhqk,bkhd->bqhd", d, kk).reshape(B, Lq, -1) * scale
    mag = torch.einsum("bhqk,bkhd->bqhd", d.abs(), kk.abs()).reshape(
        B, Lq, -1) * scale
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126)))
                     - 7)
    excess = (dq.double() - ref).abs() / (ulp + 2.0 ** -16 * mag)
    return float(excess.max()), int((excess > 1).sum())


def check_dq_long(g, rows):
    """K2 (a)'s dq at Lk 130, 200, 300 and 520 (batch 8, several key
    tiles): within one rounding of the float64 sum of its own ds times k
    (`dq_rounding_excess` at most 1), and against the plain attention's
    autograd over the plain projections, both held to float64: the bf16
    gate, and at Lk 130 and 200 the kernel's error at most DQ_LONG_RATIO
    times the plain version's; printed beside the largest kernel / plain
    ratio of the one-chunk decode shapes in `rows`."""
    res = []
    for Lq, Lk in ((70, 130), (60, 200), (60, 300), (40, 520)):
        args32, seed = make_case(g, Lq, Lk, "key", "linear", B)
        det = [None if a is None else a.detach() for a in to_bf16(args32)]
        det64 = [None if a is None else a.double() for a in det]
        dout = torch.randn(B, Lq, H * DH, generator=g, device="cuda").to(BF16)
        dq, _, _, ds = attention_backward(*det, seed, dout, H, 0.0,
                                          need_ds=True)
        k = forward_projection(*det[:8], num_heads=H)[1]
        excess, over = dq_rounding_excess(dq, ds, k, DH ** -0.5)
        del ds, k
        if excess > 1:
            raise AssertionError(
                f"dq at Lk {Lk}: {over} elements beyond one rounding of the "
                f"sum over all keys (largest {excess:.2f} x the allowance)")
        grads = []
        for src, do in ((det, dout), (det64, dout.double())):
            qkv = [t.detach().requires_grad_()
                   for t in project_plain(*src[:8])]
            grads += torch.autograd.grad(
                attend_plain(*qkv, src[8], H, 0.0, seed,
                             dtype=src[0].dtype), qkv[:1], do)
        err, plain = bf16_gate(f"dq at Lk {Lk}", dq, grads[0], grads[1])
        if Lk <= 200 and err > DQ_LONG_RATIO * plain:
            raise AssertionError(f"dq at Lk {Lk}: bf16 kernel error {err:.3e}"
                                 f" > {DQ_LONG_RATIO} x plain {plain:.3e}")
        res.append((Lq, Lk, err, plain, excess))
    one = max(rows[name]["gates"]["dq"][0] / rows[name]["gates"]["dq"][1]
              for name, Lq, Lk, _, _ in SHAPES + CAUSAL_SHAPES if Lk <= 64)
    say("bf16 dq past 64 keys (batch 8, against float64, kernel / plain): "
        + ", ".join(f"Lq {lq} Lk {lk} {e:.3e} / {p:.3e} (ratio {e / p:.3f}"
                    f"; from one rounding of its own ds k: {x:.3f} of the "
                    f"allowance)" for lq, lk, e, p, x in res)
        + f"; the one-chunk decode shapes' largest ratio {one:.3f}; limit "
        f"{DQ_LONG_RATIO} at Lk 130 and 200")


def bf16_part_line(train_rows, mix):
    """K1 bf16 and K2 (b) bf16 by part over a launch mix: each part's
    ms, each GEMM part's TFLOP/s (its operations over its time, both
    summed over the mix) against the 989 TFLOP/s peak, and the host time
    of one C call."""
    total = sum(mix.values())

    def avg(key):
        return sum(train_rows[s][key] * w for s, w in mix.items()) / total

    keys = ["fwd_proj_ms", "fwd_attn_device_ms"] + [
        f"projb_{p}_ms" for p in PROJ_PARTS if p != "hsum"]
    rates = []
    for p, key in (("proj", "fwd_proj_ms"), ("dx", "projb_dx_ms"),
                   ("dy", "projb_dy_ms"), ("dw", "projb_dw_ms")):
        ops = sum(train_rows[s]["tflops"][p] * train_rows[s][key] * w
                  for s, w in mix.items())
        ms = sum(train_rows[s][key] * w for s, w in mix.items())
        rates.append(f"{p} {ops / ms:.1f} ({ops / ms / 989 * 100:.1f}%)")
    hsum = [r["projb_hsum_ms"] for r in train_rows.values()
            if "projb_hsum_ms" in r]
    return ("bf16 by part by device time over the bench build's mix: "
            + ", ".join(f"{k[:-3].replace('_device', '')} {avg(k):.4f} ms"
                        for k in keys)
            + (f", hsum {sum(hsum) / len(hsum):.4f} ms (shapes with a "
               f"summed bias)" if hsum else "")
            + "; TFLOP/s of 989: " + ", ".join(rates)
            + f"; host us per C call: proj {avg('proj_host_us'):.1f}, "
            f"projection backward launch() {avg('projb_host_us'):.1f}; "
            f"host us per wrapper call: K1 (no grad) "
            f"{avg('fwd_host_us'):.1f}, K2 (a) {avg('attn_host_us'):.1f}")


def bf16_attn_line(train_rows, mix):
    """The two bf16 attention cores over a launch mix: each core's device
    time (its own C call, from a CUDA graph) beside its bound
    (and the share of it reached) and SDPA's device time over the same
    heads, and the ms of the core's own C call; K2 (a) and (b) whole
    beside their library calls' device time."""
    total = sum(mix.values())

    def avg(key):
        return sum(train_rows[s][key] * w for s, w in mix.items()) / total

    parts = []
    for part, what in (("fwd", "K1 attention"), ("bwd", "K2 (a) attention")):
        ms = avg(f"{part}_attn_device_ms")
        bnd = avg(f"{part}_attn_bound_ms")
        parts.append(f"{what} {ms:.4f} ms, bound {bnd:.4f} "
                     f"({bnd / ms * 100:.1f}% of it), SDPA "
                     f"{avg(f'{part}_attn_library_device_ms'):.4f}; its own "
                     f"C call {avg(f'{part}_attn_ms'):.4f} ms")
    return ("bf16 attention cores by device time over the bench build's "
            "mix: " + "; ".join(parts)
            + f"; K2 (a) recompute {avg('fwd_proj_ms'):.4f}; K2 (a) "
            f"{avg('attn_device_ms'):.4f} against its library call "
            f"{avg('attn_library_device_ms'):.4f}; K2 (b) "
            f"{avg('projb_device_ms'):.4f} against its library call "
            f"{avg('projb_library_device_ms'):.4f}")


def check_kernels_bf16():
    """Phase 3 (bf16): the decode shapes at batch 8 without dropout, then
    the train shapes at batch 64 with dropout (timed); rows by shape."""
    g = torch.Generator(device="cuda").manual_seed(2)
    rows, train_rows = {}, {}
    for name, Lq, Lk, bias_kind, layout in SHAPES + CAUSAL_SHAPES:
        row = rows[name] = check_shape_bf16(g, name, Lq, Lk, bias_kind,
                                            layout, B, timed=False)
        say(f"bf16 kernel {name}: B={B} Lq={Lq} Lk={Lk} bias={bias_kind} "
            f"dropout 0; against float64 (kernel / plain bf16, of the "
            f"scale): " + ", ".join(f"{k} {a:.2e}/{p:.2e}" for k, (a, p)
                                    in row["gates"].items())
            + (f"; keep share {row['keep_share']:.5f} sd "
               f"{row['keep_sd']:.1e}" if "keep_share" in row else "")
            + "; two backward launches bitwise equal")
    for name, Lq, Lk, bias_kind, layout in LONG_SHAPES:
        row = check_shape_bf16(g, name, Lq, Lk, bias_kind, layout, B,
                               timed=False)
        say(f"long-key bf16 kernel {name}: B={B} Lq={Lq} Lk={Lk} "
            f"bias={bias_kind} dropout 0; against float64 (kernel / plain "
            f"bf16, of the scale): " + ", ".join(
                f"{k} {a:.2e}/{p:.2e}" for k, (a, p) in row["gates"].items())
            + (f"; keep share {row['keep_share']:.5f} sd "
               f"{row['keep_sd']:.1e}" if "keep_share" in row else "")
            + "; two backward launches bitwise equal")
    check_dq_long(g, rows)
    for name, Lq, Lk, bias_kind, layout in SHAPES + CAUSAL_SHAPES:
        if name not in TRAIN_SHAPES:
            continue
        row = train_rows[name] = check_shape_bf16(
            g, name, Lq, Lk, bias_kind, layout, B_TRAIN, timed=True)
        worst = max(row["gates"].items(), key=lambda kv: kv[1][0])
        say(f"bf16 train {name}: B={B_TRAIN} dropout {RATE}; worst gate "
            f"{worst[0]} {worst[1][0]:.2e} (plain {worst[1][1]:.2e}); "
            f"forward ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}); "
            f"attention backward ms={row['attn_ms']:.4f} "
            f"plain_ms={row['attn_plain_ms']:.4f} "
            f"library_ms={row['attn_library_ms']:.4f} "
            f"bound_ms={row['attn_bound_ms']:.4f} "
            f"({row['attn_bound_by']}); projection backward "
            f"ms={row['projb_ms']:.4f} "
            f"plain_ms={row['projb_plain_ms']:.4f} "
            f"library_ms={row['projb_library_ms']:.4f} "
            f"bound_ms={row['projb_bound_ms']:.4f} "
            f"({row['projb_bound_by']})")
        say(f"bf16 train {name} device time (CUDA graphs): forward "
            f"{row['device_ms']:.4f} ms, its library call "
            f"{row['library_device_ms']:.4f} "
            f"({row['device_ms'] / row['library_device_ms']:.2f}x); "
            f"projection backward {row['projb_device_ms']:.4f} ms")
        say(f"bf16 train {name} by part (device time): forward proj "
            f"{row['fwd_proj_ms']:.4f} ms, attention kernel "
            f"{row['fwd_attn_device_ms']:.4f}; K2 (a) attention kernel "
            f"{row['bwd_attn_device_ms']:.4f} (cross-check: the whole "
            f"K2 (a) call {row['attn_device_ms']:.4f}, less the "
            f"projection's jobs "
            f"{row['attn_device_ms'] - row['fwd_proj_ms']:.4f}"
            f"; the core by name inside it {row['bwd_core_named'][2]:.4f} "
            f"over {row['bwd_core_named'][0]} of {row['bwd_core_named'][1]} "
            f"events); projection backward "
            + ", ".join(f"{p} {row[f'projb_{p}_ms']:.4f}"
                        for p in PROJ_PARTS if f"projb_{p}_ms" in row)
            + "; TFLOP/s (of 989) "
            + ", ".join(f"{p} {v:.1f} ({v / 989 * 100:.1f}%)"
                        for p, v in row["tflops"].items())
            + f"; host us per C call: proj {row['proj_host_us']:.1f}, "
            f"whole forward wrapper {row['fwd_host_us']:.1f}, K2 (a) "
            f"wrapper {row['attn_host_us']:.1f}, "
            f"projection backward launch() (GEMM + reduce) "
            f"{row['projb_host_us']:.1f}")
    return rows, train_rows


def mha_case(g, Lq, Lk, bias_kind, batch):
    """q [B, Lq, H, dh], and k / v [B, Lk, H, dh] as views of one packed
    [B, Lk, H, 3, dh] tensor (the kernel reads them through their
    strides), and a key mask or a per-head bias."""
    qkv = torch.randn(batch, Lk, H, 3, DH, generator=g, device="cuda")
    q = torch.randn(batch, Lq, H, DH, generator=g, device="cuda")
    k, v = qkv[..., 1, :], qkv[..., 2, :]
    if bias_kind == "none":
        return q, k, v, None
    if bias_kind == "key":
        keep = torch.rand(batch, Lk, generator=g, device="cuda") < 0.85
        keep[:, 0] = True
        return q, k, v, (1.0 - keep.float())[:, None, None, :] * -10000.0
    return q, k, v, torch.randn(batch, H, Lq, Lk, generator=g,
                                device="cuda")


def mha_library(q, k, v, bias):
    """scaled_dot_product_attention over the same heads: a yardstick timed
    here only; the port never calls it."""
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=bias)
    return o.transpose(1, 2).reshape(q.shape[0], q.shape[1], H * DH)


def check_mha(cases=MHA_CASES):
    """Phase 3 for the attention-only kernel: rows of numbers by case."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for name, Lq, Lk, bias_kind, batch in cases:
        q, k, v, bias = mha_case(g, Lq, Lk, bias_kind, batch)
        out = mha(q, k, v, bias)
        torch.cuda.synchronize()
        ref = mha_plain(q, k, v, bias)
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
        lib_err = float((mha_library(q, k, v, bias) - ref).abs().max())
        # both float32 versions against the function in float64
        ref64 = mha_plain(*(None if a is None else a.double()
                            for a in (q, k, v, bias)))
        err64 = float((out.double() - ref64).abs().max())
        plain64 = float((ref.double() - ref64).abs().max())
        ops = 4 * batch * H * Lq * Lk * DH
        nbytes = _bytes(q, k, v, bias) + 4 * out.numel()
        fb = (3 * ops / PEAK_TF32_FLOP_PER_S * 1e3,
              nbytes / PEAK_BYTES_PER_S * 1e3)
        row = rows[name] = dict(
            err=float((out - ref).abs().max()),
            ms=cuda_ms(lambda: mha(q, k, v, bias)),
            device_ms=graph_ms(lambda: mha(q, k, v, bias)),
            plain_ms=cuda_ms(lambda: mha_plain(q, k, v, bias)),
            library_ms=cuda_ms(lambda: mha_library(q, k, v, bias)),
            library_device_ms=graph_ms(lambda: mha_library(q, k, v, bias)),
            bound_ms=max(fb),
            bound_by="operations" if fb[0] >= fb[1] else "bytes",
            bound_f32_ms=max(ops / PEAK_F32_FLOP_PER_S * 1e3, fb[1]))
        say(f"kernel mha {name}: B={batch} Lq={Lq} Lk={Lk} bias={bias_kind} "
            f"max_abs_err={row['err']:.3e} (against float64: kernel "
            f"{err64:.3e}, plain {plain64:.3e}) ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} (library max_abs_err="
            f"{lib_err:.3e}) bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']}; float32 {row['bound_f32_ms']:.4f})")
    return rows


def mha_rounding_excess(out, q, k, v, bias):
    """How far a bf16 attention output lies from one rounding of the
    float64 function of the same q, k, v [B, L, H, dh] and bias: each
    element may differ from the float64 value by 2^-8 of it (one bf16
    rounding) plus 2^-14 of sum_k p |v| (the float32 sums' own error, with
    room).  Returns the largest |out - ref| over that allowance.  The
    TPU kernel keeps p in float32 and rounds only its output; a kernel
    that rounds p to bf16 before p v lands beyond it
    (tests/test_torch_attn_f32_model.py models both)."""
    q, k, v = (t.double() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(DH))
    if bias is not None:
        s = s + bias.double()
    p = torch.softmax(s, dim=-1)
    shape = out.shape
    ref = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(shape)
    mag = torch.einsum("bhqk,bkhd->bqhd", p, v.abs()).reshape(shape)
    return float(((out.double() - ref).abs()
                  / (2.0 ** -8 * ref.abs() + 2.0 ** -14 * mag)).max())


def mha_one_term(q, k, v, bias):
    """The bf16 `mha` kernel with p v as one product of p rounded to bf16
    (C entry `mha_fwd_bf16_one_term`): the control of the one-rounding
    check, launched here only."""
    Bq, Lq, Hq, dh = q.shape
    Lk = k.shape[1]
    bias4, bst = None, (0, 0, 0, 0)
    if bias is not None:
        bias4 = bias.to(torch.float32).expand(Bq, Hq, Lq, Lk)
        bst = bias4.stride()
    out = torch.empty((Bq, Lq, Hq * dh), device="cuda", dtype=BF16)
    rc = _mha_lib().mha_fwd_bf16_one_term(
        q.data_ptr(), *q.stride(), k.data_ptr(), *k.stride(), v.data_ptr(),
        *v.stride(), None if bias4 is None else bias4.data_ptr(), *bst,
        out.data_ptr(), Bq, Lq, Lk, Hq, dh, 1.0 / math.sqrt(dh),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mha_fwd_bf16_one_term: CUDA error {rc}")
    return out


# the attention-only kernel in bf16 (the Hopper core with p v in two bf16
# terms): MHA_CASES, then past the float32 build's 256 keys
MHA_BF16_CASES = MHA_CASES + (("case20x300_key", 20, 300, "key", B),
                              ("case40x520_heads", 40, 520, "heads", B))


def check_mha_bf16(cases=MHA_BF16_CASES):
    """Phase 3 (bf16) for the attention-only kernel: bf16 q, k, v (a
    float32 bias, which the TPU kernel upcasts as it is), the kernel and
    the plain version (float32 throughout, the output rounded once) both
    against float64, the kernel held to the bf16 gate and to one output
    rounding of float64 (`mha_rounding_excess` at most 1), which its
    one-term control must exceed; rows by case."""
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for name, Lq, Lk, bias_kind, batch in cases:
        q, k, v, bias = mha_case(g, Lq, Lk, bias_kind, batch)
        q, k, v = (t.to(BF16) for t in (q, k, v))
        before = dict(attn_core_routes)
        out = mha(q, k, v, bias)
        torch.cuda.synchronize()
        if out.dtype != BF16 or attn_core_routes["tma"] != before["tma"] + 1:
            raise AssertionError(f"mha bf16 {name}: {out.dtype}, routes "
                                 f"{attn_core_routes}")
        plain = mha_plain(q, k, v, bias)
        ref = mha_plain(*(None if a is None else a.double()
                          for a in (q, k, v, bias)))
        err, err_plain = bf16_gate(f"mha bf16 {name}", out, plain, ref)
        excess = mha_rounding_excess(out, q, k, v, bias)
        control = mha_rounding_excess(mha_one_term(q, k, v, bias), q, k, v,
                                      bias)
        if excess > 1 or control <= 1:
            raise AssertionError(
                f"mha bf16 {name}: {excess:.3f} of one output rounding's "
                f"allowance (at most 1), its one-term control {control:.3f} "
                f"(more than 1)")
        ops = 4 * batch * H * Lq * Lk * DH
        nbytes = _bytes(q, k, v, bias) + 2 * out.numel()
        fb = (ops / PEAK_BF16_FLOP_PER_S * 1e3,
              nbytes / PEAK_BYTES_PER_S * 1e3)
        mask = None if bias is None else bias.to(BF16)
        row = rows[name] = dict(
            err=err, err_plain=err_plain, excess=excess, control=control,
            ms=cuda_ms(lambda: mha(q, k, v, bias)),
            device_ms=graph_ms(lambda: mha(q, k, v, bias)),
            plain_ms=cuda_ms(lambda: mha_plain(q, k, v, bias)),
            library_ms=cuda_ms(lambda: mha_library(q, k, v, mask)),
            library_device_ms=graph_ms(lambda: mha_library(q, k, v, mask)),
            bound_ms=max(fb),
            bound_by="operations" if fb[0] >= fb[1] else "bytes")
        say(f"kernel mha bf16 {name}: B={batch} Lq={Lq} Lk={Lk} "
            f"bias={bias_kind}; against float64 (of the scale): kernel "
            f"{err:.3e}, plain {err_plain:.3e}; of one output rounding's "
            f"allowance: {excess:.3f} (one-term control {control:.3f}); "
            f"ms={row['ms']:.4f} (device "
            f"{row['device_ms']:.4f}) plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} (device "
            f"{row['library_device_ms']:.4f}) bound_ms="
            f"{row['bound_ms']:.4f} ({row['bound_by']})")
    return rows


# Query blocks past 256 keys, at the decode batch.  bf16: the kernels
# against the plain bf16 version and float64, with check_shape_bf16's
# gates; float32 (the attention forward's key blocks of 256 with an online
# softmax): against the plain version with check_shape's gates
LONG_SHAPES = (("long256", 60, 256, "key", "linear"),
               ("long257", 60, 257, "full", "linear"),
               ("long300", 50, 300, "heads", "dense"),
               ("long520", 40, 520, "key", "linear"))


def check_long_f32(g):
    """The float32 builds past 256 keys: check_shape's forward (dropout
    off and on), gradients, attention backward and bitwise repeat at
    LONG_SHAPES; then a 60-query block over 257 keys through the card's
    AttentionCore gate launches the fused kernel once and matches the
    eager path within the forward's gate."""
    errs = {}
    for name, Lq, Lk, bias_kind, layout in LONG_SHAPES:
        row = check_shape(g, name, Lq, Lk, bias_kind, layout, B,
                          timed=False)
        errs[name] = (row["fwd_err_0.0"], row["fwd_err_0.1"],
                      row["attn_err_0.0"], row["proj_err_0.0"])
    core = AttentionCore(D, H, DH, use_fused=True, min_lq=32).cuda()
    eager = AttentionCore(D, H, DH).cuda()
    eager.load_state_dict(core.state_dict())
    x = torch.randn(B, 60, D, generator=g, device="cuda")
    y = torch.randn(B, 257, D, generator=g, device="cuda")
    reset_counts()
    with torch.no_grad():
        out, ref = core(x, y), eager(x, y)
    torch.cuda.synchronize()
    if fused_qkv_mha.launches != 1:
        raise AssertionError(f"float32 at 257 keys through the gate: "
                             f"{fused_qkv_mha.launches} launches")
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    say("long keys in float32 (batch 8; max abs error against the plain "
        "version: forward dropout 0 / 0.1, attention backward, gradients): "
        + ", ".join(f"{n} Lk {lk} {e[0]:.2e} / {e[1]:.2e}, {e[2]:.2e}, "
                    f"{e[3]:.2e}" for (n, _, lk, _, _), e
                    in zip(LONG_SHAPES, errs.values()))
        + f"; two backward launches bitwise equal; Lq 60 Lk 257 through the "
        f"gate: 1 launch, {float((out - ref).abs().max()):.2e} from eager")


# ---------------------------------------------------------------------------
# Phase 3 (head widths): every attention kernel at head widths 32 and 128
# (GOAT's D = 768 as 24 heads of 32 and as 6 of 128), float32 and bf16: K1,
# K2 (a) and K2 (b) at the local branch's shape (Lq = Lk = 54, key mask),
# batch 64, dropout 0.1, under phase 3's and phase 3 (bf16)'s gates and
# timed as the train shapes are; K3 over the hoisted text (54 queries, 60
# keys) under phase 3's gate and, in bf16, within one output rounding of
# float64.  No path of either package runs these widths (GOAT's is 64).
WIDTHS = (32, 128)
WIDTH_SHAPE = ("local54", 54, 54, "key", "linear")
# The vectorized teacher's phase B encodes the panoramas of all its steps
# at once (8 steps x 64 episodes at the bench's wide bucket); its encoder's
# self-attention is the plain DETR attention in both packages, so no fused
# kernel runs there.  K1 and K2 are held at that row count all the same,
# 512 rows of 52 tokens under a key mask: the per-row dropout seeds and
# the kernels' index products at the largest batch a step could give them.
PHASE_B_SHAPE = ("pano52", 52, 52, "key", "linear")
PHASE_B_BATCH = 8 * B_TRAIN


@contextlib.contextmanager
def model_width(d, dh):
    """The module's D, H and DH at model width d split into heads of dh,
    which every phase 3 helper reads, for the body."""
    global D, H, DH
    saved = D, H, DH
    D, H, DH = d, d // dh, dh
    try:
        yield
    finally:
        D, H, DH = saved


def head_width(dh):
    """The module's head split at head width dh over D, for the body."""
    return model_width(D, dh)


def check_head_widths():
    """Phase 3 (head widths): rows {dh: {f32, bf16, mha, mha_bf16}}."""
    rows = {}
    name, Lq, Lk, bias_kind, layout = WIDTH_SHAPE
    for dh in WIDTHS:
        with head_width(dh):
            g = torch.Generator(device="cuda").manual_seed(11)
            tag = f"{name}_dh{dh}"
            case = ((f"{name}xtext60_dh{dh}", Lq, 60, "key", B_TRAIN),)
            r = rows[dh] = dict(
                f32=check_shape(g, tag, Lq, Lk, bias_kind, layout, B_TRAIN,
                                timed=True),
                bf16=check_shape_bf16(g, tag, Lq, Lk, bias_kind, layout,
                                      B_TRAIN, timed=True),
                mha=check_mha(case)[case[0][0]],
                mha_bf16=check_mha_bf16(case)[case[0][0]])
        f, b = r["f32"], r["bf16"]
        say(f"head width {dh} ({D // dh} heads), B={B_TRAIN} Lq={Lq} "
            f"Lk={Lk} key mask, dropout {RATE}: float32 max_abs_err forward "
            f"{f[f'fwd_err_{RATE}']:.3e}, attention backward "
            f"{f[f'attn_err_{RATE}']:.3e}, grads {f[f'proj_err_{RATE}']:.3e};"
            f" ms K1 {f['ms']:.4f} (device {f['device_ms']:.4f}, bound "
            f"{f['bound_ms']:.4f}, plain {f['plain_ms']:.4f}, library "
            f"{f['library_ms']:.4f}), K2 (a) {f['attn_ms']:.4f} (device "
            f"{f['attn_device_ms']:.4f}, bound {f['attn_bound_ms']:.4f}), "
            f"K2 (b) {f['projb_ms']:.4f} (device {f['projb_device_ms']:.4f}"
            f", bound {f['projb_bound_ms']:.4f}); bf16 against float64 "
            f"forward {b['fwd_err']:.3e}, K2 (a) {b['attn_err']:.3e}, K2 (b) "
            f"{b['proj_err']:.3e}; ms K1 {b['ms']:.4f} (device "
            f"{b['device_ms']:.4f}, bound {b['bound_ms']:.4f}, library "
            f"device {b['library_device_ms']:.4f}), K2 (a) "
            f"{b['attn_ms']:.4f} (device {b['attn_device_ms']:.4f}), K2 (b) "
            f"{b['projb_ms']:.4f} (device {b['projb_device_ms']:.4f}); "
            f"attention cores by device time {b['fwd_attn_device_ms']:.4f} / "
            f"{b['bwd_attn_device_ms']:.4f} ms (bytes bounds "
            f"{b['fwd_attn_bound_ms']:.4f} / {b['bwd_attn_bound_ms']:.4f});"
            f" K3 float32 {r['mha']['ms']:.4f} ms, bf16 "
            f"{r['mha_bf16']['ms']:.4f} ms at "
            f"{r['mha_bf16']['excess']:.3f} of one output rounding")
    return rows


def check_phase_b():
    """K1 and K2 at phase B's row count (PHASE_B_SHAPE at PHASE_B_BATCH):
    float32 under phase 3's gates (dropout 0 and 0.1, two backward launches
    bitwise equal), bf16 under phase 3 (bf16)'s and timed.  Returns the
    bf16 row."""
    g = torch.Generator(device="cuda").manual_seed(13)
    name, Lq, Lk, bias_kind, layout = PHASE_B_SHAPE
    f = check_shape(g, name, Lq, Lk, bias_kind, layout, PHASE_B_BATCH,
                    timed=False)
    b = check_shape_bf16(g, name, Lq, Lk, bias_kind, layout, PHASE_B_BATCH,
                         timed=True)
    say(f"phase B rows: B={PHASE_B_BATCH} Lq={Lq} Lk={Lk} key mask; float32 "
        f"max_abs_err forward {f['fwd_err_0.0']:.3e} / "
        f"{f[f'fwd_err_{RATE}']:.3e}, attention backward "
        f"{f['attn_err_0.0']:.3e} / {f[f'attn_err_{RATE}']:.3e}, grads "
        f"{f['proj_err_0.0']:.3e} / {f[f'proj_err_{RATE}']:.3e} (dropout 0 "
        f"/ {RATE}), two backward launches bitwise equal; bf16 dropout "
        f"{RATE} against float64 forward {b['fwd_err']:.3e}, K2 (a) "
        f"{b['attn_err']:.3e}, K2 (b) {b['proj_err']:.3e}; ms K1 "
        f"{b['ms']:.4f} (device {b['device_ms']:.4f}, bound "
        f"{b['bound_ms']:.4f}, library device "
        f"{b['library_device_ms']:.4f}), K2 (a) {b['attn_ms']:.4f} (device "
        f"{b['attn_device_ms']:.4f}, bound {b['attn_bound_ms']:.4f}), K2 (b)"
        f" {b['projb_ms']:.4f} (device {b['projb_device_ms']:.4f}, bound "
        f"{b['projb_bound_ms']:.4f})")
    return b


def width_kernel_rows(tag, row, mrow, bf16, launches=(0, 0, 0),
                      by_path=None):
    """The kernel line's rows of one K1 / K2 (a) / K2 (b) / K3 check: `row`
    a timed check_shape(_bf16) row, mrow a check_mha(_bf16) row; launches
    of K1, K2 (a), K2 (b) on the path that runs the shape (0: no path runs
    it), by_path their split by path (K1's; K2's the same paths)."""
    src = "vln_goat_tpu_torch/ops/csrc/"
    sfx = "_bf16" if bf16 else ""
    zero = dict(decode=0, train=0, causal_decode=0, causal_train=0)
    errs = (("fwd_err", "attn_err", "proj_err") if bf16 else
            (f"fwd_err_{RATE}", f"attn_err_{RATE}", f"proj_err_{RATE}"))
    out = []
    for i, (name, file, line, key, err) in enumerate((
            ("fused_qkv_mha", "fused_qkv_mha.cu", 169, "", errs[0]),
            ("fused_qkv_mha_bwd_attn", "fused_qkv_mha_bwd.cu", 181, "attn_",
             errs[1]),
            ("fused_qkv_mha_bwd_proj", "fused_qkv_mha_bwd.cu", 181,
             "projb_", errs[2]))):
        paths = zero if by_path is None else \
            {k: v if i == 0 else launches[i] for k, v in by_path.items()}
        out.append(dict(
            name=f"{name}{sfx}_{tag}", route="cuda", source=src + file,
            replaces=f"vln_goat_tpu/ops/attention.py:{line}",
            launches=launches[i], launches_by_path=paths,
            max_abs_err=row[err], ms=row[key + "ms"],
            plain_ms=row[key + "plain_ms"], bound_ms=row[key + "bound_ms"],
            bound_by=row[key + "bound_by"],
            library_ms=row[key + "library_ms"],
            device_ms=row[key + "device_ms"],
            library_device_ms=row.get(key + "library_device_ms")))
    if mrow is not None:
        out.append(dict(
            name=f"mha{sfx}_{tag}", route="cuda", source=src + "mha.cu",
            replaces="vln_goat_tpu/ops/attention.py:49", launches=0,
            launches_by_path=zero, max_abs_err=mrow["err"], ms=mrow["ms"],
            plain_ms=mrow["plain_ms"], bound_ms=mrow["bound_ms"],
            bound_by=mrow["bound_by"], library_ms=mrow["library_ms"],
            device_ms=mrow["device_ms"],
            library_device_ms=mrow["library_device_ms"]))
    return out

def check_logit_masks(out):
    """MEM slot and visited / empty node slots -inf, stop finite, and every
    real unvisited node finite, at every step an episode was active."""
    logits, active = out["fused_logits"], out["active"]
    if not bool(active.any()):
        raise AssertionError("no episode ever acted")
    lg = logits[active]                                  # [n, G]
    legal = (out["node_vp_t"][active] >= 0) & ~out["visited_t"][active]
    if not bool(torch.isfinite(lg[:, 0]).all()):
        raise AssertionError("stop logit not finite")
    if not bool(torch.isneginf(lg[:, 1]).all()):
        raise AssertionError("MEM slot logit not -inf")
    nodes = lg[:, 2:]
    if not bool(torch.isfinite(nodes[legal]).all()):
        raise AssertionError("a legal node logit is not finite")
    if not bool(torch.isneginf(nodes[~legal]).all()):
        raise AssertionError("a visited or empty node logit is not -inf")


def reset_counts():
    fused_qkv_mha.launches = 0
    attention_backward.launches = 0
    projection_backward.launches = 0
    mha.launches = 0
    bf16_core_routes.update(tma=0, direct=0)
    attn_core_routes.update(tma=0, direct=0)
    for k in wide_core_launches:
        wide_core_launches[k] = 0
    optim.launches.update(norm=0, update=0)


# the fused AdamW's launches on the main train paths, by path: 5 (g)'s
# timed steps ("train", "causal_train"), 5 (q)'s updates
# ("pretrain_<task>") and 5 (t)'s speaker steps ("speaker_train"); the
# kernel line's `adamw_*` rows
ADAMW_LAUNCHES = {}


def adamw_check(path, got, updates, clipped=True):
    """Records `got`, the fused AdamW's launches (`optim.launches`) since
    the last `reset_counts`, under `path`; raises AssertionError unless
    each of `updates` updates made one norm launch (none without a clip)
    and one update launch."""
    ADAMW_LAUNCHES[path] = dict(got)
    want = dict(norm=updates if clipped else 0, update=updates)
    if got != want:
        raise AssertionError(f"fused AdamW launches {got} over {updates} "
                             f"updates, expected {want}")


def routes_now():
    """The bf16 launches so far by route: the GEMM core's ("core") and the
    attention cores' ("attn")."""
    return dict(core=dict(bf16_core_routes), attn=dict(attn_core_routes))


def check_routes(routes, want, attn_want):
    """Every bf16 GEMM core launch of a path (`want` of them) and every
    bf16 attention core launch (`attn_want`) took the TMA route; raises
    AssertionError."""
    if routes != dict(core={"tma": want, "direct": 0},
                      attn={"tma": attn_want, "direct": 0}):
        raise AssertionError(f"bf16 launches by route {routes}, expected "
                             f"{want} GEMM core and {attn_want} attention "
                             f"core launches by TMA and none direct")


def counts():
    """Launches (forward, backward a, backward b, attention-only)."""
    return (fused_qkv_mha.launches, attention_backward.launches,
            projection_backward.launches, mha.launches)


def run_rollouts(card, causal=False):
    """Phase 4 for the plain or the causal configuration; returns the
    forward kernel's launches in the run through the kernels."""
    what = "causal " if causal else ""
    model, ro, batcher = build_flagship("cuda", seed=WEIGHT_SEED,
                                        causal=causal)
    _, batch = batcher.next_batch()
    greedy_rollout(ro, batch)                            # warm-up
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    out = greedy_rollout(ro, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fused_qkv_mha.launches
    steps = int(out["steps"])
    mix = launch_mix(model.config, steps)
    expect = sum(mix.values())
    if counts() != (expect, 0, 0, 0):
        raise AssertionError(f"{what}decode launched {counts()} (forward, "
                             f"backward a, b, attention-only), expected "
                             f"({expect}, 0, 0, 0) ({steps} steps)")
    check_logit_masks(out)
    moves = int((out["actions"] >= 0).sum())
    say(f"{what}rollout fused: {steps} steps, {moves} moves, "
        f"{int(out['spilled_n'].sum())} spilled nodes, "
        f"fused_qkv_mha launches={launches} ({mix_text(mix)}), mha "
        f"launches=0, {B / dt:.2f} episodes/s ({dt * 1e3:.1f} ms per "
        f"batch of {B}) on {card}")

    p_model, p_ro, _ = build_flagship("cuda", use_fused_attention=False,
                                      seed=WEIGHT_SEED, causal=causal)
    p_model.load_state_dict(model.state_dict())
    greedy_rollout(p_ro, batch)                          # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = greedy_rollout(p_ro, batch)
    torch.cuda.synchronize()
    p_dt = time.perf_counter() - t0
    if counts() != (0, 0, 0, 0):
        raise AssertionError("the eager run launched a kernel")
    if not torch.equal(out["actions"], ref["actions"]):
        raise AssertionError(f"actions differ:\n{out['actions']}\n"
                             f"{ref['actions']}")
    if out["trajectories"] != ref["trajectories"]:
        raise AssertionError("trajectories differ")
    fin = torch.isfinite(ref["fused_logits"])
    if not torch.equal(fin, torch.isfinite(out["fused_logits"])):
        raise AssertionError("finite-logit pattern differs")
    dmax = float((out["fused_logits"][fin] - ref["fused_logits"][fin])
                 .abs().max())
    if dmax > 1e-3:
        raise AssertionError(f"fused logits differ by {dmax}")
    say(f"{what}rollout eager: {int(ref['steps'])} steps, "
        f"{B / p_dt:.2f} episodes/s ({p_dt * 1e3:.1f} ms per batch); "
        f"actions and trajectories identical, fused logits max |diff| "
        f"{dmax:.3e}")
    del model, ro, p_model, p_ro, out, ref
    torch.cuda.empty_cache()
    return launches


def run_rollouts_bf16(card, causal=False):
    """Phase 4 (bf16): greedy decode at batch 8 in bf16 compute through
    the kernels and on the eager path from the same weights: launches as
    the config gives them, the logits' masks as the model defines them on
    both; the first step's logits of both routes against the float32
    kernel route's on the same weights, the kernels' distance at most
    twice the eager bf16 route's plus 1e-3, and in the plain
    configuration the two bf16 routes within 3e-2 of the scale of each
    other (in the causal one both routes sit 4-6e-2 from float32, so
    their distance from each other is printed, not held to 3e-2).  The
    actions' agreement is printed.  Returns the forward kernel's launches
    and the failure of the comparison, or None."""
    what = "causal " if causal else ""
    model, ro, batcher = build_flagship("cuda", seed=WEIGHT_SEED,
                                        causal=causal,
                                        compute_dtype="bfloat16")
    e_model, e_ro, _ = build_flagship("cuda", use_fused_attention=False,
                                      seed=WEIGHT_SEED, causal=causal,
                                      compute_dtype="bfloat16")
    e_model.load_state_dict(model.state_dict())
    f_model, f_ro, _ = build_flagship("cuda", seed=WEIGHT_SEED,
                                      causal=causal)
    f_model.load_state_dict(model.state_dict())
    _, batch = batcher.next_batch()
    greedy_rollout(ro, batch)                            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = greedy_rollout(ro, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fused_qkv_mha.launches
    steps = int(out["steps"])
    mix = launch_mix(model.config, steps)
    if counts() != (sum(mix.values()), 0, 0, 0):
        raise AssertionError(f"{what}bf16 decode launched {counts()}, "
                             f"expected ({sum(mix.values())}, 0, 0, 0)")
    routes = routes_now()
    check_routes(routes, launches, launches)
    reset_counts()
    ref = greedy_rollout(e_ro, batch)
    torch.cuda.synchronize()
    if counts() != (0, 0, 0, 0):
        raise AssertionError("the eager bf16 run launched a kernel")
    check_routes(routes_now(), 0, 0)
    check_logit_masks(out)
    check_logit_masks(ref)
    first, first_ref = out["fused_logits"][0], ref["fused_logits"][0]
    fin = torch.isfinite(first_ref)
    if not torch.equal(fin, torch.isfinite(first)):
        raise AssertionError(f"{what}bf16 first-step finite pattern differs")
    scale = float(first_ref[fin].abs().max())
    diff = float((first[fin] - first_ref[fin]).abs().max()) / scale
    f32 = greedy_rollout(f_ro, batch)["fused_logits"][0]
    if not torch.equal(fin, torch.isfinite(f32)):
        raise AssertionError(f"{what}float32 first-step finite pattern "
                             "differs from bf16's")
    f_scale = float(f32[fin].abs().max())
    to32 = [float((t[fin] - f32[fin]).abs().max()) / f_scale
            for t in (first, first_ref)]
    say(f"{what}rollout bf16: first-step logits against float32's on the "
        f"same weights (of their scale): kernels {to32[0]:.3e}, eager "
        f"{to32[1]:.3e}; kernels against eager {diff:.3e}")
    failed = None
    if to32[0] > 2 * to32[1] + 1e-3:
        failed = (f"{what}bf16 decode: the kernels' first-step logits "
                  f"{to32[0]:.3e} from float32's, more than 2 x the eager "
                  f"bf16 route's {to32[1]:.3e} + 1e-3")
    elif not causal and diff > 3e-2:
        failed = (f"{what}bf16 decode: first-step logits differ by "
                  f"{diff:.3e} of their scale (limit 3e-2)")
    if failed:
        say(f"{what}rollout bf16: FAILED: {failed} (the script goes on, "
            f"and fails at its end)")
    acted = out["active"] & ref["active"]
    traj_same = out["trajectories"] == ref["trajectories"]
    same = int((out["actions"] == ref["actions"])[acted].sum())
    say(f"{what}rollout bf16: kernels {steps} steps, fused_qkv_mha "
        f"launches={launches} ({mix_text(mix)}; bf16 core launches by "
        f"route {routes}), {B / dt:.2f} episodes/s "
        f"({dt * 1e3:.1f} ms per batch); eager {int(ref['steps'])} steps; "
        f"logit masks as defined on both, first-step logits within "
        f"{diff:.2e} of each other's scale"
        f"{'' if causal else ' (limit 3e-2)'}; actions identical at "
        f"{same} of {int(acted.sum())} steps both paths acted, "
        f"trajectories {'identical' if traj_same else 'differ'} on {card}")
    del model, ro, e_model, e_ro, f_model, f_ro, out, ref
    torch.cuda.empty_cache()
    return launches, failed


def mix_text(mix):
    return ", ".join(f"{k} {v}" for k, v in mix.items() if v)


def text_mix(cfg):
    """Forward-kernel launches of one instruction encoding, by shape: the
    self-attention of every language layer, and with the causal text
    flags the cross-attention to each bank (type_2 back door: direction
    and landmark; front door: the text bank)."""
    mix = {"text60": cfg.num_l_layers}
    if cfg.do_back_txt and cfg.do_back_txt_type == "type_2":
        mix["text60x36"] = mix["text60x47"] = 1
    if cfg.do_front_txt:
        mix["text60x24"] = 1
    return mix


def step_mix(cfg, steps):
    """Forward-kernel launches of `steps` rollout steps, by shape: the
    global-map and local self-attention of every cross layer (the text
    cross-attention reads the hoisted K/V and stays off the kernel), and
    with the front-door flags each FrontDoorEncoder's self-attention under
    the key mask and cross-attention to its bank."""
    mix = {"gmap50": cfg.num_x_layers * steps,
           "local54": cfg.num_x_layers * steps}
    if cfg.do_front_his:
        mix["gmap50_front_self"] = mix["gmap50x24"] = steps
    if cfg.do_front_img:
        mix["local54"] += steps
        mix["local54x24"] = steps
    return mix


def add_mix(*mixes):
    out = {}
    for m in mixes:
        for k, v in m.items():
            out[k] = out.get(k, 0) + v
    return out


def launch_mix(cfg, steps):
    """Launches of the forward kernel in one decode rollout, by shape."""
    return add_mix(text_mix(cfg), step_mix(cfg, steps))


def train_mix(cfg, metrics):
    """Forward launches of the fused kernel in the train steps whose
    metrics are given: the instruction encoding once per step (shared by
    the teacher and the sampled rollout, or of the fused batch), and every
    rollout step's navigation (teacher_steps, sample_steps or
    fused_steps).  The vectorized teacher runs as many navigation calls as
    the per-step teacher, and its one panorama call over all steps holds
    no fused attention (the panorama encoder's self-attention is the plain
    DETR attention in both packages), so it launches what the per-step
    teacher launches.  Each forward has its two backward launches."""
    return add_mix(*([text_mix(cfg)] * len(metrics)),
                   step_mix(cfg, sum(rollout_steps(metrics, flat=True))))


def compare_steps(k, e, pinned, noise=NOISE_GRAD_BIASES):
    """Phase 5 (a) / (c): the kernel step k and the eager step e, each
    (metrics, grads, rollouts), agree: every ReLU decision of the kernel
    step that differed from the eager step's (`pinned`, as
    gate_witness.pin_relus counts them) within KINK_BAND of its kink,
    actions identical, the rollout moved, losses to a relative 1e-4,
    every gradient within 1e-3 of its largest magnitude, sprel_linear's
    nonzero.  Returns the worst gradient's (ratio, name); raises
    AssertionError."""
    (k_m, k_grads, k_outs), (e_m, e_grads, e_outs) = k, e
    if pinned["dist"] > KINK_BAND:
        raise AssertionError(
            f"a ReLU decision differs from the eager step's with |z - "
            f"z_eager| {pinned['dist']:.3e} > {KINK_BAND}")
    if set(k_outs) != set(e_outs):
        raise AssertionError(f"rollouts {set(k_outs)} vs {set(e_outs)}")
    for r in e_outs:
        if not torch.equal(k_outs[r]["actions"], e_outs[r]["actions"]):
            raise AssertionError(f"{r} actions differ")
        if not bool((k_outs[r]["actions"] >= 0).any()):
            raise AssertionError(f"the {r} rollout never moved")
    for key in ("loss", "il_loss", "sample_loss"):
        if key not in e_m:
            continue
        a, b_ = float(k_m[key]), float(e_m[key])
        if abs(a - b_) > 1e-4 * abs(b_):
            raise AssertionError(f"{key}: {a} vs {b_}")
    if set(k_grads) != set(e_grads):
        raise AssertionError("the two steps give different parameters a "
                             "gradient")
    worst, name = worst_grad(k_grads, e_grads, noise)
    if worst > 1e-3:
        raise AssertionError(f"grad {name}: |diff| {worst:.3e} of its "
                             f"scale > 1e-3")
    if float(k_grads["global_encoder.sprel_linear.weight"].abs().max()) == 0:
        raise AssertionError("sprel_linear got no gradient")
    return worst, name


def kernel_vs_eager(head, what, build_kw, batch_fn=None,
                    noise=NOISE_GRAD_BIASES, batch_size=B, record=None):
    """One train step at batch `batch_size` (8), every dropout at 0, of the
    build `build_train_flagship("cuda", batch_size=batch_size,
    dropout=False, **build_kw)` through the eager path and through the
    kernels, from the same weights, batch (`batch_fn(state, batcher)`,
    default the batcher's next one) and generator seed (`record`, a dict,
    takes the kernel step's launches as "counts"): the eager step first, keeping the inputs
    of its ClsPrediction heads' ReLUs (the model's only kinks); the kernel
    step takes its decisions where its own differ, within KINK_BAND of the
    kink; then compare_steps' gates (`noise`: the biases held at their
    weight's scale) and the launches the config gives.  Prints a line;
    returns the failure of the comparison, or None."""
    k_state, batcher = build_train_flagship("cuda", batch_size=batch_size,
                                            dropout=False, remat="none",
                                            **build_kw)
    e_state, _ = build_train_flagship("cuda", batch_size=batch_size,
                                      dropout=False,
                                      use_fused_attention=False,
                                      remat="none", **build_kw)
    e_state.model.load_state_dict(k_state.model.state_dict())
    batch = batch_fn(k_state, batcher) if batch_fn is not None \
        else batcher.next_batch()[1]
    seen, hooks = record_relus(e_state.model)
    reset_counts()
    e_m, e_grads, e_outs = e_state.step_fn(
        e_state, batch, torch.Generator(device="cuda").manual_seed(0),
        keep=True)
    for h in hooks:
        h.remove()
    if counts() != (0, 0, 0, 0):
        raise AssertionError("the eager step launched a kernel")
    pinned, hooks = pin_relus(k_state.model, seen)
    reset_counts()
    k_m, k_grads, k_outs = k_state.step_fn(
        k_state, batch, torch.Generator(device="cuda").manual_seed(0),
        keep=True)
    torch.cuda.synchronize()
    k_counts = counts()
    if record is not None:
        record["counts"] = k_counts
    for h in hooks:
        h.remove()
    if pinned["calls"] != sum(len(c) for c in seen.values()):
        raise AssertionError(f"{head}: kernel step made {pinned['calls']} "
                             "ReLU calls, the eager step "
                             f"{sum(len(c) for c in seen.values())}")
    del seen
    mix = train_mix(k_state.model.config, [k_m])
    n = sum(mix.values())
    if k_counts != (n, n, n, 0):
        raise AssertionError(f"{head}: kernel step launched {k_counts}, "
                             f"expected {(n, n, n, 0)}")
    head_line = (f"{head} batch {batch_size}, dropout 0: kernel vs eager "
                 f"{what}")
    try:
        worst, name = compare_steps((k_m, k_grads, k_outs),
                                    (e_m, e_grads, e_outs), pinned, noise)
    except AssertionError as exc:
        say(f"{head_line}: FAILED: {exc} (the script goes on, and fails at "
            f"its end)")
        return f"{head}: {exc}"
    say(f"{head_line}: "
        + " + ".join(f"{r} {int(o['steps'])}" for r, o in k_outs.items())
        + f" steps, actions identical, loss {float(k_m['loss']):.6f} vs "
        f"{float(e_m['loss']):.6f}, {len(e_grads)} gradients within "
        f"{worst:.2e} of their max (limit 1e-3), launches {k_counts} "
        f"(forward, backward a, backward b, attention-only; "
        f"{mix_text(mix)}); worst {name}; the heads' ReLU inputs within "
        f"{pinned['dev']:.2e} of eager's, {pinned['flips']} of the kernel "
        f"step's ReLU decisions differed from eager's, each within "
        f"{pinned['dist']:.2e} of its kink (limit {KINK_BAND}), and took "
        f"eager's")
    return None


def vec_teacher_gate(card):
    """Phase 5 (h): the vectorized teacher against the per-step teacher
    through the kernels, float32, batch 8, every dropout at 0: one
    imitation step each from the same weights and batch, losses to a
    relative 1e-4, the targets and actions identical, every gradient
    within 1e-3 of its largest magnitude, the launches as the config gives
    them (the same on both); then the vectorized step through the eager
    path against the kernels under kernel_vs_eager's gates.  Returns a
    failure or None."""
    tcfg = TrainConfig(train_alg="imitation", weight_decay=0.01)
    res, sd, batch = {}, None, None
    for vec in (True, False):
        state, batcher = build_train_flagship(
            "cuda", batch_size=B, dropout=False, tcfg=tcfg,
            vectorized_teacher=vec, remat="none")
        if sd is None:
            sd = {k: v.clone() for k, v in state.model.state_dict().items()}
            batch = batcher.next_batch()[1]
        else:
            state.model.load_state_dict(sd)
        reset_counts()
        t0 = time.perf_counter()
        m, grads, outs = state.step_fn(
            state, batch, torch.Generator(device="cuda").manual_seed(0),
            keep=True)
        torch.cuda.synchronize()
        res[vec] = dict(m=m, grads=grads, out=outs["teacher"],
                        counts=counts(), s=time.perf_counter() - t0)
        cfg = state.model.config
        del state, batcher
    torch.cuda.empty_cache()
    v, p = res[True], res[False]
    n = sum(train_mix(cfg, [v["m"]]).values())
    try:
        for k in ("targets", "actions", "steps"):
            if not torch.equal(v["out"][k].cpu(), p["out"][k].cpu()):
                raise AssertionError(f"{k} differ")
        a, b_ = float(v["m"]["loss"]), float(p["m"]["loss"])
        if abs(a - b_) > 1e-4 * abs(b_):
            raise AssertionError(f"loss {a} vs {b_}")
        if set(v["grads"]) != set(p["grads"]):
            raise AssertionError("other parameters have a gradient")
        worst, name = worst_grad(v["grads"], p["grads"])
        if worst > 1e-3:
            raise AssertionError(f"grad {name}: |diff| {worst:.3e} of its "
                                 f"scale > 1e-3")
        if v["counts"] != (n, n, n, 0) or p["counts"] != v["counts"]:
            raise AssertionError(f"launches {v['counts']} (vectorized), "
                                 f"{p['counts']} (per step), expected "
                                 f"{(n, n, n, 0)}")
    except AssertionError as exc:
        say(f"train (h) vectorized teacher: FAILED: {exc} (the script goes "
            f"on, and fails at its end)")
        return f"train (h): {exc}"
    say(f"train (h) batch {B}, dropout 0, kernels: vectorized against "
        f"per-step teacher, imitation ({int(v['out']['steps'])} steps): "
        f"targets and actions identical, loss {a:.6f} vs {b_:.6f}, "
        f"{len(p['grads'])} gradients within {worst:.2e} of their max "
        f"(limit 1e-3), worst {name}; launches {v['counts']} on both; "
        f"{v['s'] * 1e3:.1f} / {p['s'] * 1e3:.1f} ms a step (first step, "
        f"not a measurement) on {card}")
    # a teacher-forced step: the local head's last two biases get
    # gradients that are zero up to rounding (TEACHER_NOISE_BIASES)
    return kernel_vs_eager("train (h)", "vectorized imitation step",
                           dict(tcfg=tcfg),
                           noise=NOISE_GRAD_BIASES + TEACHER_NOISE_BIASES)


def two_buckets(state, batcher):
    """A fused-DAgger batch whose halves come from different gt-length
    buckets (the narrower gt paths padded)."""
    caps = batcher.bucket_caps
    return fuse_dagger_batches(
        batcher.make_batch(batcher.next_minibatch(), gt_cap=caps[0]),
        batcher.make_batch(batcher.next_minibatch(), gt_cap=caps[-1]))


def sampled_gates():
    """Phase 5 (i): kernel_vs_eager's gates for the DAgger step with
    sample_feedback "expl_sample" and for the dagger_fused step on a
    batch whose halves come from different buckets.  Returns the
    failures."""
    return [f for f in (
        kernel_vs_eager("train (i)", "DAgger step, expl_sample",
                        dict(sample_feedback="expl_sample")),
        kernel_vs_eager("train (i)", "dagger_fused step, halves of two "
                        "buckets", dict(tcfg=TrainConfig(
                            train_alg="dagger_fused", weight_decay=0.01)),
                        batch_fn=two_buckets)) if f is not None]


def run_train(card, causal=False):
    """Phase 5: (a) and (b), or (c) and (d) for the causal
    configuration.  Returns the timed steps' launch mix and counts, the
    failure of (a) / (c)'s comparison (None when it passed), which (b) /
    (d) do not wait on, and the warm-up's peak memory (GiB) of (b) / (d)
    through the kernels."""
    what = "causal " if causal else ""
    pa, pb = ("c", "d") if causal else ("a", "b")
    # (a) kernel path against the eager path, dropout off, batch 8
    failed = kernel_vs_eager(f"{what}train ({pa})", "DAgger step",
                             dict(causal=causal))
    torch.cuda.empty_cache()

    # (b) the bench's step: batch 64, dropout on, EARLIER_STEPS timed
    # steps, through the kernels and then through the eager path
    n_steps = EARLIER_STEPS
    state, metrics, got, dt, warm_peak, peak, before, left, _ = bench_steps(
        True, causal, n=n_steps)
    cfg = state.model.config
    mix = train_mix(cfg, metrics)
    n = sum(mix.values())
    if got != (n, n, n, 0):
        raise AssertionError(f"{what}train steps launched {got}, expected "
                             f"{(n, n, n, 0)}")
    for m in metrics:
        if not (math.isfinite(float(m["loss"]))
                and math.isfinite(float(m["grad_norm"]))):
            raise AssertionError(f"non-finite step: {m}")
    moved = sum(not torch.equal(p.detach(), before[n_])
                for n_, p in state.model.named_parameters())
    if moved < 0.9 * len(before):
        raise AssertionError(f"only {moved} of {len(before)} parameters "
                             "moved")
    say(f"{what}train ({pb}) batch {B_TRAIN}, dropout {RATE}/{RATE}/feat "
        f"0.4, kernels: {n_steps} DAgger steps (teacher, sample steps "
        f"{rollout_steps(metrics)}), loss "
        f"{[round(float(m['loss']), 4) for m in metrics]}, grad_norm "
        f"{[round(float(m['grad_norm']), 3) for m in metrics]}, "
        f"{moved}/{len(before)} parameters moved, launches {got} "
        f"({mix_text(mix)}), peak "
        f"memory {warm_peak:.2f} GiB in the warm-up (one step per bucket), "
        f"{peak:.2f} GiB in the timed steps ({left:.2f} GiB left by earlier "
        f"phases, freed first); {B_TRAIN * n_steps / dt:.2f} "
        f"episodes/s ({dt / n_steps * 1e3:.1f} ms per step) on {card}")
    del state, metrics, before
    torch.cuda.empty_cache()
    # the eager path keeps every call's probabilities and mask: its excess
    # over the kernel path, scaled from the plain configuration's by the
    # attention calls per rollout step
    calls = sum(step_mix(cfg, 1).values())
    excess = EAGER_EXCESS_GIB * calls / 6
    if causal and warm_peak + excess > EAGER_LIMIT_GIB:
        say(f"{what}train ({pb}) eager path not timed: the kernel path's "
            f"warm-up peak {warm_peak:.2f} GiB plus the eager path's "
            f"predicted excess of {excess:.2f} GiB ({calls} attention "
            f"calls per rollout step) passes {EAGER_LIMIT_GIB} GiB")
        return mix, got, failed, warm_peak
    _, e_metrics, e_got, e_dt, e_warm, e_peak, _, e_left, _ = bench_steps(
        False, causal, n=n_steps)
    if e_got != (0, 0, 0, 0):
        raise AssertionError("the eager step launched a kernel")
    if not all(math.isfinite(float(m["loss"])) for m in e_metrics):
        raise AssertionError(f"non-finite eager step: {e_metrics}")
    say(f"{what}train ({pb}) eager path, same settings: {n_steps} DAgger "
        f"steps (teacher, sample steps {rollout_steps(e_metrics)}), peak "
        f"memory {e_warm:.2f} GiB in the warm-up, {e_peak:.2f} GiB in the "
        f"timed steps ({e_left:.2f} GiB left by earlier phases, freed "
        f"first); {B_TRAIN * n_steps / e_dt:.2f} episodes/s "
        f"({e_dt / n_steps * 1e3:.1f} ms per step) on {card}")
    torch.cuda.empty_cache()
    return mix, got, failed, warm_peak


def grad_vector(grads, ref):
    """The gradients of every parameter `ref` has one for (zeros where
    `grads` has none), in one float64 vector."""
    return torch.cat([grads.get(n_, torch.zeros_like(r)).double().flatten()
                      for n_, r in sorted(ref.items())])


def remat_gate(card):
    """Phase 5 (e): two consecutive batch-8 DAgger steps at dropout 0.1
    through the kernels, from one set of weights, the same batches and one
    generator seed, under remat "model" and then "none": sampled actions
    identical, losses equal, every gradient within 1e-6 of its largest
    magnitude (bitwise expected), the generator in the same state after
    each step; the forward kernel's launches exceed "none"'s by the
    recomputed rollout steps' (the text encoding is not checkpointed), the
    backward kernels' equal.  Returns a failure or None."""
    runs, sd = {}, None
    for remat in ("model", "none"):
        state, batcher = build_train_flagship("cuda", batch_size=B,
                                              remat=remat)
        if sd is None:
            sd = {k: v.clone() for k, v in state.model.state_dict().items()}
        else:
            state.model.load_state_dict(sd)
        g = torch.Generator(device="cuda").manual_seed(0)
        steps = []
        for _ in range(2):
            batch = batcher.next_batch()[1]
            reset_counts()
            m, grads, outs = state.step_fn(state, batch, g, keep=True)
            torch.cuda.synchronize()
            steps.append(dict(
                loss=float(m["loss"]), grads=grads, counts=counts(),
                actions={r: o["actions"] for r, o in outs.items()},
                n_steps=rollout_steps([m], flat=True)[0],
                gen=g.get_state()))
        runs[remat] = steps
        cfg = state.model.config
        del state, batcher
    torch.cuda.empty_cache()
    try:
        worst, bitwise = 0.0, True
        for i, (a, b_) in enumerate(zip(runs["model"], runs["none"])):
            for r in a["actions"]:
                if not torch.equal(a["actions"][r], b_["actions"][r]):
                    raise AssertionError(f"step {i}: {r} actions differ")
            if a["loss"] != b_["loss"]:
                raise AssertionError(f"step {i}: loss {a['loss']} vs "
                                     f"{b_['loss']}")
            if set(a["grads"]) != set(b_["grads"]):
                raise AssertionError(f"step {i}: other parameters have "
                                     "a gradient")
            for n_, r in b_["grads"].items():
                d = float((a["grads"][n_] - r).abs().max())
                sc = float(r.abs().max())
                bitwise &= d == 0.0
                if d > 1e-6 * sc:
                    raise AssertionError(f"step {i}: grad {n_} |diff| "
                                         f"{d:.3e} > 1e-6 x {sc:.3e}")
                worst = max(worst, d / sc if sc else 0.0)
            if not torch.equal(a["gen"], b_["gen"]):
                raise AssertionError(f"step {i}: generator states differ")
            rec = sum(step_mix(cfg, a["n_steps"]).values())
            want = (b_["counts"][0] + rec,) + b_["counts"][1:]
            if a["counts"] != want:
                raise AssertionError(f"step {i}: remat launched "
                                     f"{a['counts']}, expected {want}")
    except AssertionError as exc:
        say(f"train (e) remat gate: FAILED: {exc} (the script goes on, and "
            f"fails at its end)")
        return f"train (e): {exc}"
    grads_text = "bitwise equal" if bitwise \
        else f"within {worst:.2e} of their max"
    say(f"train (e) batch {B}, dropout {RATE}/{RATE}/feat 0.4, kernels: two "
        f"consecutive DAgger steps under remat model vs none: actions "
        f"identical, losses equal ({runs['model'][0]['loss']:.6f}, "
        f"{runs['model'][1]['loss']:.6f}), gradients "
        f"{grads_text}, generator states equal; launches model "
        f"{runs['model'][0]['counts']} / none {runs['none'][0]['counts']} "
        f"(step 1) on {card}")
    return None


def bf16_gate_step(card, causal=False):
    """Phase 5 (f): one batch-8 imitation step, every dropout at 0, from
    one set of weights and one batch on three routes: float32 eager (the
    reference), bf16 eager, bf16 through the kernels.  Teacher forcing
    fixes the trajectory, so the actions are identical.  Each bf16 route's
    relative loss error and global gradient error |g - g32| / |g32|; the
    kernels' at most twice the eager bf16 route's plus 1e-3.  Returns a
    failure or None."""
    what = "causal " if causal else ""
    tcfg = TrainConfig(train_alg="imitation", weight_decay=0.01)
    kw = dict(batch_size=B, dropout=False, tcfg=tcfg, causal=causal)
    res, sd, batch = {}, None, None
    for route, fused, dtype in (("float32 eager", False, "float32"),
                                ("bf16 eager", False, "bfloat16"),
                                ("bf16 kernels", True, "bfloat16")):
        state, batcher = build_train_flagship(
            "cuda", use_fused_attention=fused, compute_dtype=dtype,
            remat="none", **kw)
        if sd is None:
            sd = {k: v.clone() for k, v in state.model.state_dict().items()}
            batch = batcher.next_batch()[1]
        else:
            state.model.load_state_dict(sd)
        reset_counts()
        m, grads, outs = state.step_fn(
            state, batch, torch.Generator(device="cuda").manual_seed(0),
            keep=True)
        torch.cuda.synchronize()
        res[route] = dict(loss=float(m["loss"]), grads=grads,
                          counts=counts(), routes=routes_now(),
                          actions=outs["teacher"]["actions"],
                          steps=int(m["teacher_steps"]))
        cfg = state.model.config
        del state, batcher
    torch.cuda.empty_cache()
    ref = res["float32 eager"]
    g32 = grad_vector(ref["grads"], ref["grads"])
    errs = {}
    for route in ("bf16 eager", "bf16 kernels"):
        r = res[route]
        errs[route] = (abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
                       float((grad_vector(r["grads"], ref["grads"]) - g32)
                             .norm()
                             / g32.norm()))
    k_n = sum(add_mix(text_mix(cfg), step_mix(cfg, ref["steps"])).values())
    try:
        for route, r in res.items():
            if not torch.equal(r["actions"], ref["actions"]):
                raise AssertionError(f"{route} actions differ")
        if res["bf16 kernels"]["counts"] != (k_n, k_n, k_n, 0) or \
                res["bf16 eager"]["counts"] != (0, 0, 0, 0):
            raise AssertionError(
                f"launches {res['bf16 kernels']['counts']} (kernels), "
                f"{res['bf16 eager']['counts']} (eager), expected "
                f"{(k_n, k_n, k_n, 0)} and none")
        check_routes(res["bf16 kernels"]["routes"], 3 * k_n, 2 * k_n)
        check_routes(res["bf16 eager"]["routes"], 0, 0)
        for i, what_err in enumerate(("loss", "gradient")):
            k_e, e_e = errs["bf16 kernels"][i], errs["bf16 eager"][i]
            if k_e > 2 * e_e + 1e-3:
                raise AssertionError(f"{what_err} error {k_e:.3e} > 2 x "
                                     f"eager bf16 {e_e:.3e} + 1e-3")
    except AssertionError as exc:
        say(f"{what}train (f) bf16 gate: FAILED: {exc} (the script goes "
            f"on, and fails at its end)")
        return f"{what}train (f): {exc}"
    say(f"{what}train (f) batch {B}, dropout 0, imitation "
        f"({ref['steps']} steps), actions identical on the three routes; "
        f"against float32 eager (loss {ref['loss']:.6f}): bf16 eager loss "
        f"{errs['bf16 eager'][0]:.3e}, gradients "
        f"{errs['bf16 eager'][1]:.3e}; bf16 kernels loss "
        f"{errs['bf16 kernels'][0]:.3e}, gradients "
        f"{errs['bf16 kernels'][1]:.3e} (limit 2 x eager + 1e-3); kernel "
        f"launches {res['bf16 kernels']['counts']}, bf16 core launches by "
        f"route {res['bf16 kernels']['routes']} on {card}")
    return None


def bench_config(card, causal, none_peak):
    """Phase 5 (g): the bench's train build, bf16 compute with remat
    "model" (`build_train_flagship(compute_dtype="bfloat16",
    remat="model")`), batch 64, dropout 0.1 / 0.1 / features 0.4: one
    warm-up per bucket, BENCH_STEPS timed steps; loss and grad norm finite,
    parameters moved, launches as the config gives them (the recomputed
    rollout steps' forwards on top); then one float32 remat "model"
    warm-up, whose peak must be under half of `none_peak`, (b) / (d)'s.
    The plain build also profiles one more step (`trace_step`) after its
    timed ones.  Returns (forward launch mix, launch counts, failure or
    None, the profile or None)."""
    what = "causal " if causal else ""
    state, metrics, got, dt, warm_peak, peak, before, left, extra = \
        bench_steps(True, causal, n=BENCH_STEPS, compute_dtype="bfloat16",
                    remat="model", trace=not causal)
    cfg = state.model.config
    mix = train_mix(cfg, metrics)
    n = sum(mix.values())
    rec = sum(step_mix(cfg, sum(rollout_steps(metrics, flat=True)))
              .values())
    failed = None
    try:
        if got != (n + rec, n, n, 0):
            raise AssertionError(f"launched {got}, expected "
                                 f"{(n + rec, n, n, 0)}")
        check_routes(extra["routes"], sum(got[:3]), got[0] + got[1])
        adamw_check("causal_train" if causal else "train", extra["adamw"],
                    len(metrics))
        for m in metrics:
            if not (math.isfinite(float(m["loss"]))
                    and math.isfinite(float(m["grad_norm"]))):
                raise AssertionError(f"non-finite step: {m}")
        moved = sum(not torch.equal(p.detach(), before[n_])
                    for n_, p in state.model.named_parameters())
        if moved < 0.9 * len(before):
            raise AssertionError(f"only {moved} of {len(before)} "
                                 "parameters moved")
    except AssertionError as exc:
        failed = f"{what}train (g): {exc}"
        say(f"{what}train (g): FAILED: {exc} (the script goes on, and "
            f"fails at its end)")
        moved = -1
    say(f"{what}train (g) bench build, bf16 compute, remat model, batch "
        f"{B_TRAIN}, dropout {RATE}/{RATE}/feat 0.4, kernels: 3 DAgger steps "
        f"(teacher, sample steps {rollout_steps(metrics)}), loss "
        f"{[round(float(m['loss']), 4) for m in metrics]}, grad_norm "
        f"{[round(float(m['grad_norm']), 3) for m in metrics]}, "
        f"{moved}/{len(before)} parameters moved, launches {got} "
        f"({mix_text(mix)}; {rec} recomputed; bf16 core launches by route "
        f"{extra['routes']}; fused AdamW {extra['adamw']}), peak memory "
        f"{warm_peak:.2f} GiB in the warm-up, {peak:.2f} GiB in the timed "
        f"steps ({left:.2f} GiB left by earlier phases, freed first); "
        f"{B_TRAIN * 3 / dt:.2f} episodes/s ({dt / 3 * 1e3:.1f} ms per "
        f"step) on {card}")
    if "trace" in extra:
        say(trace_line(extra["trace"]))
    del state, metrics, before
    torch.cuda.empty_cache()
    _, _, _, _, f32_peak, _, _, _, _ = bench_steps(True, causal, n=0,
                                                remat="model")
    torch.cuda.empty_cache()
    ok = f32_peak < 0.5 * none_peak
    say(f"{what}train (g) float32, remat model: warm-up peak "
        f"{f32_peak:.2f} GiB against {none_peak:.2f} GiB under remat none "
        f"({'under' if ok else 'NOT under'} half)")
    if not ok and failed is None:
        failed = (f"{what}train (g): float32 remat model peak "
                  f"{f32_peak:.2f} GiB not under half of {none_peak:.2f}")
    return mix, got, failed, extra.get("trace")


def teacher_ab(card, n=2):
    """Phase 5 (g)'s same-call comparison of the two teachers: the bench
    build (bf16, remat "model", batch 64, dropout on) with the vectorized
    teacher and with the per-step one (`vectorized_teacher=False`), from
    the same weights and generator seed, one warm-up per bucket each, then
    n steps each on the same batches, the two alternating (the first of
    each pair alternates too).  Host clock around synchronised steps.
    Prints the line; returns {teacher: [ms of each step]}."""
    gc.collect()
    torch.cuda.empty_cache()
    states, sd, batcher = {}, None, None
    for name, vec in (("vectorized", True), ("per-step", False)):
        st, b_ = build_train_flagship("cuda", batch_size=B_TRAIN,
                                      compute_dtype="bfloat16",
                                      remat="model", vectorized_teacher=vec)
        if sd is None:
            sd, batcher = {k: v.clone() for k, v
                           in st.model.state_dict().items()}, b_
        else:
            st.model.load_state_dict(sd)
        states[name] = (st, torch.Generator(device="cuda").manual_seed(0))
    del sd
    for cap in batcher.bucket_caps:
        bb = batcher.make_batch(batcher.next_minibatch(), gt_cap=cap)
        for st, g in states.values():
            st.step_fn(st, bb, g)
    ms = {name: [] for name in states}
    steps = {name: [] for name in states}
    for i in range(n):
        batch = batcher.next_batch()[1]
        order = list(states) if i % 2 == 0 else list(states)[::-1]
        for name in order:
            st, g = states[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = st.step_fn(st, batch, g)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            steps[name].append(rollout_steps([m])[0])
    say("train (g) teachers in one call, bench build, same batches, "
        "alternating: " + "; ".join(
            f"{name} teacher {[round(t, 1) for t in v]} ms (mean "
            f"{sum(v) / len(v):.1f}; teacher, sample steps {steps[name]})"
            for name, v in ms.items()) + f" on {card}")
    del states
    gc.collect()
    torch.cuda.empty_cache()
    return ms


def fused_bench(card):
    """Phase 5 (j): the GOAT_BENCH_ALG=dagger_fused build (bf16, remat
    "model", sample feedback "sample"): each step one batch of two fused
    minibatches of 64; one warm-up per bucket, then 2 timed steps; loss
    and grad norm finite, parameters moved, launches as the config gives
    them (the instruction encoding once per fused step, the recomputed
    rollout steps' forwards on top), every bf16 launch by TMA, and the
    peak memory.  Returns (forward launch mix, launch counts, failure or
    None)."""
    n_steps = 2
    state, metrics, got, dt, warm_peak, peak, before, left, extra = \
        bench_steps(True, False, n=n_steps, compute_dtype="bfloat16",
                    remat="model", tcfg=TrainConfig(
                        train_alg="dagger_fused", weight_decay=0.01))
    cfg = state.model.config
    mix = train_mix(cfg, metrics)
    n = sum(mix.values())
    rec = sum(step_mix(cfg, sum(rollout_steps(metrics, flat=True)))
              .values())
    failed, moved = None, -1
    try:
        if got != (n + rec, n, n, 0):
            raise AssertionError(f"launched {got}, expected "
                                 f"{(n + rec, n, n, 0)}")
        check_routes(extra["routes"], sum(got[:3]), got[0] + got[1])
        for m in metrics:
            if not (math.isfinite(float(m["loss"]))
                    and math.isfinite(float(m["grad_norm"]))):
                raise AssertionError(f"non-finite step: {m}")
        moved = sum(not torch.equal(p.detach(), before[n_])
                    for n_, p in state.model.named_parameters())
        if moved < 0.9 * len(before):
            raise AssertionError(f"only {moved} of {len(before)} "
                                 "parameters moved")
    except AssertionError as exc:
        failed = f"train (j): {exc}"
        say(f"train (j): FAILED: {exc} (the script goes on, and fails at "
            f"its end)")
    say(f"train (j) dagger_fused build, bf16 compute, remat model, two "
        f"minibatches of {B_TRAIN} a step, dropout {RATE}/{RATE}/feat 0.4, "
        f"kernels: {n_steps} steps (fused steps "
        f"{rollout_steps(metrics, flat=True)}), loss "
        f"{[round(float(m['loss']), 4) for m in metrics]} (il "
        f"{[round(float(m['il_loss']), 4) for m in metrics]}, sample "
        f"{[round(float(m['sample_loss']), 4) for m in metrics]}), "
        f"grad_norm {[round(float(m['grad_norm']), 3) for m in metrics]}, "
        f"{moved}/{len(before)} parameters moved, launches {got} "
        f"({mix_text(mix)}; {rec} recomputed; bf16 core launches by route "
        f"{extra['routes']}), peak memory {warm_peak:.2f} GiB in the "
        f"warm-up, {peak:.2f} GiB in the timed steps ({left:.2f} GiB left "
        f"by earlier phases, freed first); {2 * B_TRAIN * n_steps / dt:.2f}"
        f" episodes/s ({dt / n_steps * 1e3:.1f} ms per step) on {card}")
    del state, metrics, before
    torch.cuda.empty_cache()
    return mix, got, failed


def rollout_steps(metrics, flat=False):
    """Each step's rollout steps by rollout (teacher, sample; or fused), or
    with `flat` each step's total."""
    steps = [tuple(int(v) for k, v in m.items() if k.endswith("_steps"))
             for m in metrics]
    return [sum(t) for t in steps] if flat else steps


def bench_steps(fused: bool, causal: bool = False, n: int = 3,
                compute_dtype: str = "float32", remat: str = "none",
                trace: bool = False, **build_kw):
    """The bench's DAgger step (batch 64, dropout on) through the kernels
    or the eager path, in the plain or the causal configuration, in
    `compute_dtype` under the rollouts' `remat` policy: one warm-up step
    per gt-length bucket, then n timed steps with the launch counts reset
    just before.  Returns the state, the timed steps'
    metrics, their launch counts and seconds, the peak memory (GiB) of the
    warm-up and of the timed steps, the parameters before the timed steps,
    and the memory (GiB) earlier phases had left allocated, which is freed
    first (a train state holds reference cycles, which only the cyclic
    collector frees), so that the peaks are this step's own; and a dict
    with the timed steps' bf16 core launches by route and, with `trace`,
    the profile of one more step (`trace_step`).  build_kw: more of
    build_train_flagship's arguments; a dagger_fused build warms up on
    batches whose halves are of one bucket."""
    left = torch.cuda.memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    state, batcher = build_train_flagship("cuda", batch_size=B_TRAIN,
                                          use_fused_attention=fused,
                                          causal=causal,
                                          compute_dtype=compute_dtype,
                                          remat=remat, **build_kw)
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for cap in batcher.bucket_caps:
        bb = batcher.make_batch(batcher.next_minibatch(), gt_cap=cap)
        if state.train_alg == "dagger_fused":
            bb = fuse_dagger_batches(bb, batcher.make_batch(
                batcher.next_minibatch(), gt_cap=cap))
        state.step_fn(state, bb, g)
    torch.cuda.synchronize()
    warm_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    before = {n_: p.detach().clone()
              for n_, p in state.model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    metrics = train_steps(state, batcher, n, g)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = counts()
    extra = dict(routes=routes_now(), adamw=dict(optim.launches))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if trace:
        extra["trace"] = trace_step(state, batcher, g)
    return state, metrics, got, dt, warm_peak, peak, before, left, extra


# kernels of the bf16 builds by name, for the profile's shares: the bf16
# GEMM core (K1's projection, K2 (a)'s recompute, K2 (b)'s jobs), K1's
# attention, K2 (a)'s attention, K2 (b)'s reduction
K_BF16_PARTS = (("gemm core", "gemm_kernel"),
                ("K1 attention", "attn_fwd_sm90_kernel"),
                ("K2 (a) attention", "attn_bwd_sm90_kernel"),
                ("K2 (b) reduce", "splitk_reduce_kernel<__nv_bfloat16"))


def device_work(events):
    """(name, start ns, end ns) of the device's kernels, copies and sets
    among a profile's events; a device event named as a host one is an
    annotation the profiler mirrors onto the device timeline
    (`Optimizer.step#AdamW.step`), not device work."""
    cuda = torch.autograd.DeviceType.CUDA
    host = {e.name() for e in events if e.device_type() != cuda}
    return [(e.name(), e.start_ns(), e.end_ns()) for e in events
            if e.device_type() == cuda and e.name() not in host]


# the float32 K1 / K2 kernels by part: the 3xTF32 GEMM jobs (the q / k / v
# projections, their recompute and K2 (b)'s products), the attention cores
# and K2 (b)'s split-K reduction
K_F32_PARTS = (("GEMM jobs", "gemm_jobs_kernel"),
               ("K1 attention", "attn_fwd_kernel"),
               ("K2 (a) attention", "attn_bwd_kernel"),
               ("K2 (b) reduce", "splitk_reduce_kernel<float"))


def trace_step(state, batcher, g):
    """One more DAgger step under torch.profiler: `trace_call`'s numbers
    with the bf16 K1 / K2 kernels' share."""
    return trace_call(lambda: train_steps(state, batcher, 1, g),
                      K_BF16_PARTS)


def trace_call(fn, parts):
    """fn() under torch.profiler (CPU and CUDA activities): the window
    (first to last event), the device-busy share of it (the union of the
    device's kernel, copy and set intervals; the host ranges the profiler
    mirrors onto the device are left out), the ten kernels with the most
    device time, and the device time of the kernels `parts` names ((label,
    name substring) pairs).  None for the device numbers when the trace
    holds no device event."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    t_parse = time.perf_counter()
    lo = min(e.start_ns() for e in events)
    hi = max(e.end_ns() for e in events)
    spans, by_name = [], {}
    for name, s_, e_ in device_work(events):
        spans.append((s_, e_))
        by_name[name] = by_name.get(name, 0) + (e_ - s_)
    out = dict(wall_ms=wall * 1e3, events=len(events), device_events=
               len(spans), profiler_s=t_parse - t_all,
               summary_s=time.perf_counter() - t_parse)
    if not spans:
        return out
    spans.sort()
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    total = sum(by_name.values())
    out.update(window_ms=(hi - lo) / 1e6, busy_ms=busy / 1e6,
               busy_share=busy / (hi - lo), device_ms=total / 1e6,
               top=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
               parts={p: sum(v for k, v in by_name.items() if key in k)
                      / 1e6 for p, key in parts})
    return out


def trace_line(tr):
    """The profile's line (`trace_step`)."""
    head = (f"train (g) profile of one more step: {tr['wall_ms']:.1f} ms "
            f"under the profiler, {tr['events']} events (profiler "
            f"{tr['profiler_s']:.1f} s, summary {tr['summary_s']:.1f} s)")
    if "busy_share" not in tr:
        return head + "; device busy share not measured (no device events)"
    k = sum(tr["parts"].values())
    return (head + f"; window {tr['window_ms']:.1f} ms, device busy "
            f"{tr['busy_ms']:.1f} ms ({tr['busy_share'] * 100:.1f}%), "
            f"device time {tr['device_ms']:.1f} ms; bf16 K1 / K2 kernels "
            f"{k:.1f} ms ({k / tr['device_ms'] * 100:.1f}% of device time: "
            + ", ".join(f"{p} {v:.2f}" for p, v in tr["parts"].items())
            + "); top 10 by device time: "
            + "; ".join(f"{name[:70]} {ns / 1e6:.2f} ms"
                        for name, ns in tr["top"]))

# ---------------------------------------------------------------------------
# Phase 3 (m): F6's widths.  A head width outside HEAD_DIMS or a model width
# that is not a multiple of 32 goes through the wrappers' zero pad
# (`ops.attention.padded_call`, `mha_padded`); (D, head width) pairs, and
# head width 64 at D = 768 (no pad) timed beside them.
F6_WIDTHS = ((768, 16), (768, 48), (768, 96), (200, 40))
F6_SHAPE = ("local54", 54, 54)


def autograd_ms(fn, args, dout):
    """ms of the backward alone of fn(*args): autograd.grad over a graph
    kept between calls."""
    lv = [a for a in leaves(args) if a is not None]
    out = fn(*args)
    return cuda_ms(lambda: torch.autograd.grad(out, lv, dout,
                                               retain_graph=True))


def f6_case(g, d, dh, bf16, device=False):
    """One (d, dh) case in float32 or bf16: gates, launches and times (with
    `device`, device times too); returns its row (K1, K2 by autograd,
    K3)."""
    name, Lq, Lk = F6_SHAPE
    tag = f"{name}_d{d}_dh{dh}{'_bf16' if bf16 else ''}"
    batch = B_TRAIN
    t0 = time.perf_counter()
    with model_width(d, dh):
        args32, seed = make_case(g, Lq, Lk, "key", "linear", batch)
        args = to_bf16(args32) if bf16 else args32
        det = [None if a is None else a.detach() for a in args]
        kw = dict(num_heads=H, dropout_rate=RATE, seed=seed)
        dout = torch.randn(batch, Lq, H * DH, generator=g, device="cuda")
        dout = dout.to(BF16) if bf16 else dout
        reset_counts()
        with torch.no_grad():
            out = fused_qkv_mha(*det, **kw)
        got = grads_of(fused_qkv_mha(*args, **kw), args, dout)
        q, k, v, bias = mha_case(g, Lq, 60, "key", batch)
        if bf16:
            q, k, v = (t.to(BF16) for t in (q, k, v))
        mo = mha(q, k, v, bias)
        torch.cuda.synchronize()
        launched = counts()
        if launched != (2, 1, 1, 1):
            raise AssertionError(f"{tag}: launches {launched}, expected "
                                 "(2, 1, 1, 1): the padded calls must run "
                                 "the kernels")
        # the wide-head core takes the widths past HEAD_DIMS and no other
        wide = dict(wide_core_launches)
        want = 2 if padded_widths(d, dh)[1] > HEAD_DIMS[-1] else 0
        if wide != dict(fused_qkv_mha=want, attention_backward=want // 2,
                        mha=want // 2):
            raise AssertionError(f"{tag}: wide-head core launches {wide}, "
                                 f"expected {want} forward")
        plain = fused_qkv_mha_plain(*det, **kw)
        pgrads = grads_of(fused_qkv_mha_plain(*args, **kw), args, dout)
        mref = mha_plain(q, k, v, bias)
        row = {}
        if bf16:
            a64 = in_float64(args)
            ref = fused_qkv_mha_plain(*[None if a is None else a.detach()
                                        for a in a64], **kw)
            row["fwd_err"] = bf16_gate(f"{tag} forward", out, plain, ref)[0]
            r64 = grads_of(fused_qkv_mha_plain(*a64, **kw), a64,
                           dout.double())
            row["bwd_err"] = max(
                bf16_gate(f"{tag} {n_}", a, p_, r, sc)[0]
                for n_, a, p_, r, sc in zip(GRADS, got, pgrads, r64,
                                            grad_scales(r64))
                if r is not None)
            m64 = mha_plain(*(t.double() for t in (q, k, v)), bias.double())
            row["mha_err"] = bf16_gate(f"{tag} mha", mo, mref, m64)[0]
        else:
            torch.testing.assert_close(out, plain, atol=ATOL, rtol=RTOL)
            row["fwd_err"] = float((out - plain).abs().max())
            row["bwd_err"] = check_grads(got, pgrads, tag)
            torch.testing.assert_close(mo, mref, atol=ATOL, rtol=RTOL)
            row["mha_err"] = float((mo - mref).abs().max())
        del got, pgrads
        row["wide_launches"] = sum(wide.values())
        row["ms"] = cuda_ms(lambda: fused_qkv_mha(*det, **kw))
        row["plain_ms"] = cuda_ms(lambda: fused_qkv_mha_plain(*det, **kw))
        row["library_ms"] = cuda_ms(lambda: library_call(det))
        if device:
            # device times: CUDA graphs of ten calls, K2 of autograd's
            # backward over a forward built on the capture stream
            row["device_ms"] = graph_ms(lambda: fused_qkv_mha(*det, **kw))
            row["library_device_ms"] = graph_ms(lambda: library_call(det))

            def forward_of(fn):
                def forward():
                    a = [None if t is None else t.detach().requires_grad_(
                        t.requires_grad) for t in args]
                    return fn(*a), [t for t in a
                                    if t is not None and t.requires_grad]
                return forward

            row["bwd_device_ms"] = grad_graph_ms(
                forward_of(lambda *a: fused_qkv_mha(*a, **kw)), dout)
            row["bwd_library_device_ms"] = grad_graph_ms(
                forward_of(lambda *a: library_call(a)), dout)
        fb = bound(det, tf32x3=not bf16)
        row["bound_ms"], row["bound_by"] = max(fb), \
            "operations" if fb[0] >= fb[1] else "bytes"
        row["bwd_ms"] = autograd_ms(lambda *a: fused_qkv_mha(*a, **kw),
                                    args, dout)
        row["bwd_plain_ms"] = autograd_ms(
            lambda *a: fused_qkv_mha_plain(*a, **kw), args, dout)
        row["bwd_library_ms"] = autograd_ms(lambda *a: library_call(a),
                                            args, dout)
        ba = bound(det, "attn", tf32x3=not bf16)
        bp = bound(det, "proj", tf32x3=not bf16)
        row["bwd_bound_ms"] = max(ba) + max(bp)
        row["bwd_bound_by"] = "operations" if ba[0] + bp[0] >= \
            ba[1] + bp[1] else "bytes"
        row["mha_ms"] = cuda_ms(lambda: mha(q, k, v, bias))
        row["mha_plain_ms"] = cuda_ms(lambda: mha_plain(q, k, v, bias))
        row["mha_library_ms"] = cuda_ms(
            lambda: mha_library(q, k, v, bias.to(q.dtype)))
        if device:
            row["mha_device_ms"] = graph_ms(lambda: mha(q, k, v, bias))
            row["mha_library_device_ms"] = graph_ms(
                lambda: mha_library(q, k, v, bias.to(q.dtype)))
        ops = 4 * batch * H * Lq * 60 * DH
        mb = (ops / (PEAK_BF16_FLOP_PER_S if bf16 else
                     PEAK_TF32_FLOP_PER_S / 3) * 1e3,
              (_bytes(q, k, v, bias) + mo.numel() * mo.element_size())
              / PEAK_BYTES_PER_S * 1e3)
        row["mha_bound_ms"], row["mha_bound_by"] = max(mb), \
            "operations" if mb[0] >= mb[1] else "bytes"
    row["s"] = time.perf_counter() - t0
    return tag, row


def check_f6_widths():
    """Phase 3 (m): rows {tag: row} of every F6_WIDTHS case and of head
    width 64 at D = 768, float32 and bf16."""
    rows = {}
    g = torch.Generator(device="cuda").manual_seed(17)
    for d, dh in F6_WIDTHS + ((768, 64),):
        for bf16 in (False, True):
            tag, r = f6_case(g, d, dh, bf16)
            rows[tag] = r
            say(f6_line(tag, d, dh, r))
    return rows


def f6_kernel_rows(rows, launched=None):
    """The kernel line's rows of phase 3 (m) or (n): launches 0 (no path of
    either package runs these widths) but for the tags of `launched`
    ({tag: (K1, K2) launches}: 5 (w)'s CLI runs through the kernels)."""
    src = "vln_goat_tpu_torch/ops/csrc/"
    zero = dict(decode=0, train=0, causal_decode=0, causal_train=0)
    out = []
    for tag, r in rows.items():
        n = (launched or {}).get(tag, (0, 0))
        for name, file, line, key, err in (
                ("fused_qkv_mha", "fused_qkv_mha.cu", 169, "", "fwd_err"),
                ("fused_qkv_mha_bwd", "fused_qkv_mha_bwd.cu", 181, "bwd_",
                 "bwd_err"),
                ("mha", "mha.cu", 49, "mha_", "mha_err")):
            k = n[0] if name == "fused_qkv_mha" else \
                n[1] if name == "fused_qkv_mha_bwd" else 0
            out.append(dict(
                name=f"{name}_{tag}", route="cuda", source=src + file,
                replaces=f"vln_goat_tpu/ops/attention.py:{line}",
                launches=k, launches_by_path=dict(zero, wide_cli=k),
                max_abs_err=r[err],
                ms=r[key + "ms"], plain_ms=r[key + "plain_ms"],
                bound_ms=r[key + "bound_ms"], bound_by=r[key + "bound_by"],
                library_ms=r[key + "library_ms"],
                device_ms=r.get(key + "device_ms"),
                library_device_ms=r.get(key + "library_device_ms")))
    return out


# ---------------------------------------------------------------------------
# Phase 5 (k): the remat policies on the bench build
def remat_policies(card):
    """One bf16 DAgger step at batch 64 through the kernels under every
    policy of ops/remat.py, from the same weights, batch and generator
    seed (after one untimed warm-up step), and before it the step's loss
    forward alone, whose graph's memory (allocated after it, less before)
    is what the policy keeps for the backward: the vectorized teacher
    checkpoints its calls under every policy but "none", and its
    recomputed panorama pass sets the step's peak, so the peaks of the
    policies that differ only in the sampled rollout differ little;
    returns (rows, failure or None)."""
    gc.collect()
    torch.cuda.empty_cache()
    state, batcher = build_train_flagship("cuda", batch_size=B_TRAIN,
                                          compute_dtype="bfloat16",
                                          remat="model")
    model, ro = state.model, state.rollout
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batch = batcher.next_batch()[1]
    state.step_fn(state, batch, torch.Generator(device="cuda").manual_seed(0))
    rows, ref, failure = {}, None, None
    worst, bitwise = 0.0, True
    for policy in REMAT_POLICIES:
        model.load_state_dict(sd)
        model.train()
        g = torch.Generator(device="cuda").manual_seed(0)
        set_generator(model, g)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        loss = make_loss_fn(ro, teacher_horizon="auto", remat=policy)(
            batch, g)[0]
        torch.cuda.synchronize()
        held = (torch.cuda.memory_allocated() - base) / 2 ** 30
        del loss
        st = init_train_state(model, ro, teacher_horizon="auto",
                              remat=policy)
        g = torch.Generator(device="cuda").manual_seed(0)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        m, grads, _ = st.step_fn(st, batch, g, keep=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rows[policy] = dict(ms=dt * 1e3, loss=float(m["loss"]),
                            peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                            held=held, counts=counts())
        if ref is None:
            ref = (rows[policy]["loss"], grads)
            continue
        try:
            if rows[policy]["loss"] != ref[0]:
                raise AssertionError(f"{policy}: loss "
                                     f"{rows[policy]['loss']} vs none "
                                     f"{ref[0]}")
            for n_, r in ref[1].items():
                d = float((grads[n_].float() - r.float()).abs().max())
                sc = float(r.abs().max())
                bitwise &= d == 0.0
                if d > 1e-6 * sc:
                    raise AssertionError(f"{policy}: grad {n_} |diff| "
                                         f"{d:.3e} > 1e-6 x {sc:.3e}")
                worst = max(worst, d / sc if sc else 0.0)
        except AssertionError as exc:
            failure = failure or f"train (k): {exc}"
        del grads, m, st
    del state, batcher, model, ro, sd, ref
    gc.collect()
    torch.cuda.empty_cache()
    for key in ("peak", "held"):
        if rows["full"][key] >= rows["model"][key]:
            failure = failure or (
                f"train (k): full's {key} {rows['full'][key]:.4f} GiB not "
                f"below model's {rows['model'][key]:.4f}")
    say(f"train (k) remat policies, bench build (bf16, batch {B_TRAIN}, "
        f"kernels, dropout on), one DAgger step each from the same weights, "
        f"batch and seed: losses "
        + ("equal" if failure is None else "see FAILED")
        + f" to none's ({rows['none']['loss']:.6f}), gradients "
        + ("bitwise equal" if bitwise else f"within {worst:.2e} of their "
           "max") + f" on {card}; "
        + "; ".join(f"{p_} {r['ms']:.1f} ms, peak {r['peak']:.4f} GiB, "
                    f"forward keeps {r['held']:.4f} GiB, launches "
                    f"{r['counts'][:3]}" for p_, r in rows.items()))
    if failure is not None:
        say(f"train (k): FAILED: {failure} (the script goes on, and fails "
            "at its end)")
    return rows, failure


# ---------------------------------------------------------------------------
# Phase 5 (l): the fine-tune CLI at full R2R width
def cli_phase(card):
    """Train / resume / valid --submit through `vln_goat_tpu_torch.cli` in
    this process; returns (numbers, failure or None)."""
    from vln_goat_tpu_torch import cli
    from vln_goat_tpu_torch.train import checkpoint as ck

    out = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    common = ["--synthetic", "--use_pallas", "--compute_dtype", "bfloat16",
              "--batch_size", "8", "--device", "cuda", "--output_dir", out,
              "--log_every", "2", "--save_torch_ckpt"]
    state_dir = os.path.join(out, "train_state_latest")
    nums = {}
    try:
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        cli.main(["--mode", "train", "--iters", "2"] + common)
        nums["train_s"] = time.perf_counter() - t0
        nums["train_counts"] = counts()
        reset_counts()
        t0 = time.perf_counter()
        cli.main(["--mode", "train", "--iters", "4", "--resume_file",
                  state_dir] + common)
        nums["resume_s"] = time.perf_counter() - t0
        nums["resume_counts"] = counts()
        reset_counts()
        t0 = time.perf_counter()
        cli.main(["--mode", "valid", "--submit", "--resume_file",
                  state_dir] + common)
        nums["valid_s"] = time.perf_counter() - t0
        nums["valid_counts"] = counts()
        lines = [json.loads(line) for line in
                 open(os.path.join(out, "metrics.jsonl"))]
        train = [d for d in lines if "train/loss" in d]
        nums["losses"] = [d["train/loss"] for d in train]
        nums["val_unseen"] = [d for d in lines if "val_unseen/spl" in d][-1]
        nums["log"] = [line.strip() for line in
                       open(os.path.join(out, "train.log"))
                       if line.startswith("iter")]
        if [d["step"] for d in train] != [2, 4]:
            raise AssertionError(f"train steps {[d['step'] for d in train]}"
                                 ", expected [2, 4]")
        if not all(math.isfinite(v) for v in nums["losses"]):
            raise AssertionError(f"losses {nums['losses']}")
        for key in ("train_counts", "resume_counts"):
            if min(nums[key][:3]) <= 0:
                raise AssertionError(f"{key} {nums[key]}: K1 and K2 must "
                                     "launch")
        if nums["valid_counts"][0] <= 0:
            raise AssertionError(f"valid launches {nums['valid_counts']}")
        for split in ("val_train_seen", "val_seen", "val_unseen"):
            subs = json.load(open(os.path.join(out,
                                               f"submit_{split}.json")))
            if len(subs) != 16 or not all(s["trajectory"] for s in subs):
                raise AssertionError(f"submit_{split}.json: {len(subs)} "
                                     "predictions")
        params = ck.load_params(os.path.join(out, "ckpt_latest"))
        merged, missing, extra = ck.merge_loaded(
            params, ck.load_reference_checkpoint(
                os.path.join(out, "latest_dict.pt")))
        if missing or extra or not all(torch.equal(merged[k], v)
                                       for k, v in params.items()):
            raise AssertionError(f"the .pt round trip differs (missing "
                                 f"{missing[:3]}, extra {extra[:3]})")
        failure = None
    except AssertionError as exc:
        failure = f"train (l): {exc}"
    finally:
        shutil.rmtree(out, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    say(f"train (l) CLI at R2R width (--synthetic --use_pallas "
        f"--compute_dtype bfloat16, batch 8, remat full): train 2 iters "
        f"{nums.get('train_s', 0):.1f} s (launches "
        f"{nums.get('train_counts')}), resume to 4 "
        f"{nums.get('resume_s', 0):.1f} s (launches "
        f"{nums.get('resume_counts')}), valid --submit "
        f"{nums.get('valid_s', 0):.1f} s (launches "
        f"{nums.get('valid_counts')}); losses {nums.get('losses')}; "
        f"train.log {nums.get('log')}; val_unseen "
        f"{nums.get('val_unseen')}; .pt round trip "
        f"{'bitwise' if failure is None else 'see FAILED'} on {card}")
    if failure is not None:
        say(f"train (l): FAILED: {failure} (the script goes on, and fails "
            "at its end)")
    return nums, failure


# ---------------------------------------------------------------------------
# Phase 5 (w): the fine-tune CLI at head widths 256 and 192.  R2R's hidden
# 768 split into 3 heads of 256 (bf16, remat "model") and 4 of 192
# (float32) through `--num_attention_heads`, batch 8, 2 iterations and one
# validation each, every dropout probability 0 so that the kernel route
# and the eager one (no --use_pallas) draw the same Gumbel noise: their
# losses under phase 5's gates (float32: 5 (a)'s relative 1e-4; bf16:
# 5 (f)'s, the kernels' error against the float32 eager run at most twice
# the bf16 eager run's + 1e-3), every K1 / K2 (a) launch on an instanced
# core (no wide-head core launch; in bf16 every attention core launch
# counted by route, all TMA).
WIDE_CLI = (("3x256_bf16", ["--num_attention_heads", "3", "--compute_dtype",
                            "bfloat16", "--remat", "model"]),
            ("4x192_f32", ["--num_attention_heads", "4"]))


@contextlib.contextmanager
def no_dropout_config():
    """GoatConfig.for_dataset with every dropout probability 0 for the
    body (the CLI's flags set the hidden and feature dropout only)."""
    from vln_goat_tpu_torch.config import GoatConfig

    orig = GoatConfig.for_dataset

    def for_dataset(*a, **k):
        return orig(*a, **k).replace(
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            pred_head_dropout_prob=0.0, feat_dropout=0.0)

    GoatConfig.for_dataset = for_dataset
    try:
        yield
    finally:
        GoatConfig.for_dataset = orig


def wide_cli_run(flags):
    """One `cli.main` train run (2 iterations, one validation) in a
    temporary directory -> {its logged loss, ms an iteration (train.log),
    seconds, launches, routes, wide-head core launches}."""
    from vln_goat_tpu_torch import cli

    out = tempfile.mkdtemp(prefix="chip_smoke_wide_")
    try:
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        with no_dropout_config():
            cli.main(["--mode", "train", "--synthetic", "--batch_size", "8",
                      "--device", "cuda", "--output_dir", out, "--iters",
                      "2", "--log_every", "2", "--dropout", "0",
                      "--feat_dropout", "0"] + flags)
        secs = time.perf_counter() - t0
        lines = [json.loads(line) for line in
                 open(os.path.join(out, "metrics.jsonl"))]
        log = [line.strip() for line in open(os.path.join(out, "train.log"))
               if line.startswith("iter")]
        return dict(loss=[d for d in lines if "train/loss" in d][-1][
            "train/loss"], ms=float(log[-1].split("(")[1].split()[0]),
            s=secs, counts=counts(), routes=routes_now(),
            wide=dict(wide_core_launches))
    finally:
        shutil.rmtree(out, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def wide_cli_phase(card):
    """Phase 5 (w): WIDE_CLI's two cases through the kernels and eager
    (and the bf16 case in float32 eager, 5 (f)'s reference); returns
    (numbers, failure or None)."""
    nums, failure = {}, None
    try:
        for tag, flags in WIDE_CLI:
            r = nums[tag] = dict(
                kernels=wide_cli_run(["--use_pallas"] + flags),
                eager=wide_cli_run(flags))
            k, e = r["kernels"], r["eager"]
            bf16 = "bfloat16" in flags
            if bf16:
                r["f32"] = wide_cli_run(flags[:2] + flags[4:])
            if not all(math.isfinite(x["loss"]) for x in r.values()):
                raise AssertionError(f"{tag}: losses "
                                     f"{[x['loss'] for x in r.values()]}")
            n = k["counts"]
            if min(n[:3]) <= 0 or n[1] != n[2] or n[3] != 0:
                raise AssertionError(f"{tag}: kernel launches {n}")
            if any(x["counts"] != (0, 0, 0, 0) for x in r.values()
                   if x is not k):
                raise AssertionError(f"{tag}: an eager run launched a "
                                     "kernel")
            if any(sum(x["wide"].values()) for x in r.values()):
                raise AssertionError(f"{tag}: wide-head core launches "
                                     f"{k['wide']}")
            if bf16:
                check_routes(k["routes"], k["routes"]["core"]["tma"],
                             n[0] + n[1])
                ref = r["f32"]["loss"]
                r["err"] = {w: abs(r[w]["loss"] - ref) / abs(ref)
                            for w in ("kernels", "eager")}
                if r["err"]["kernels"] > 2 * r["err"]["eager"] + 1e-3:
                    raise AssertionError(
                        f"{tag}: loss error {r['err']['kernels']:.3e} > 2 x "
                        f"eager bf16 {r['err']['eager']:.3e} + 1e-3")
            else:
                r["err"] = {"kernels": abs(k["loss"] - e["loss"])
                            / abs(e["loss"])}
                if r["err"]["kernels"] > 1e-4:
                    raise AssertionError(
                        f"{tag}: loss {k['loss']} vs eager {e['loss']}")
    except AssertionError as exc:
        failure = f"train (w): {exc}"
    for tag, r in nums.items():
        say(f"train (w) CLI at {tag} (R2R width 768, --synthetic, batch 8, "
            "2 iterations, dropout 0): "
            + "; ".join(f"{w} loss {x['loss']:.6f}, {x['ms']:.0f} ms/iter, "
                        f"{x['s']:.1f} s, launches {x['counts']}, routes "
                        f"{x['routes']}, wide-head core {x['wide']}"
                        for w, x in r.items() if isinstance(x, dict)
                        and "loss" in x)
            + f"; loss error {r.get('err')} on {card}")
    if failure is not None:
        say(f"train (w): FAILED: {failure} (the script goes on, and fails "
            "at its end)")
    return nums, failure


# ---------------------------------------------------------------------------
# Phase 3 (n): F6 past 128.  Head widths 192 and 256 run on tensor-core
# instances of every attention core; 160 and 224 are zero-padded to them,
# and only a width past 256 (320) runs on the wide-head core
# (ops/csrc/attn_wide.cuh): 3 heads of 256 and 4 of 192 over D = 768, 5 of
# 160 over D = 800, 5 of 320 over D = 1600 and 7 of 224 over D = 1568,
# each in both builds through f6_case (K1, K2 by autograd, K3, by ms and
# by device time), timed beside head width 128 at D = 768.
F6_WIDE = ((768, 256), (768, 192), (800, 160), (1600, 320), (1568, 224))


def f6_line(tag, d, dh, r):
    def dev(key):
        v = r.get(key)
        return "not measured" if v is None else f"{v:.4f}"

    return (f"width {tag} ({d // dh} heads of {dh}, B={B_TRAIN}, key "
            f"mask, dropout {RATE}; {'against float64: ' if 'bf16' in tag else ''}"
            f"err forward {r['fwd_err']:.3e}, gradients "
            f"{r['bwd_err']:.3e}, mha {r['mha_err']:.3e}; wide-head core "
            f"launches {r['wide_launches']}; {r['s']:.1f} s): K1 "
            f"{r['ms']:.4f} ms (device {dev('device_ms')}; plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, device "
            f"{dev('library_device_ms')}, bound {r['bound_ms']:.4f}), K2 "
            f"by autograd {r['bwd_ms']:.4f} ms (device "
            f"{dev('bwd_device_ms')}; plain {r['bwd_plain_ms']:.4f}, "
            f"library {r['bwd_library_ms']:.4f}, device "
            f"{dev('bwd_library_device_ms')}, bound "
            f"{r['bwd_bound_ms']:.4f}), K3 {r['mha_ms']:.4f} ms (device "
            f"{dev('mha_device_ms')}; plain {r['mha_plain_ms']:.4f}, "
            f"library {r['mha_library_ms']:.4f}, device "
            f"{dev('mha_library_device_ms')}, bound "
            f"{r['mha_bound_ms']:.4f})")


def check_f6_wide():
    """Phase 3 (n): rows {tag: row} of every F6_WIDE case and of head
    width 128 at D = 768, float32 and bf16; only 320 reaches the wide-head
    core (f6_case checks the count)."""
    rows = {}
    g = torch.Generator(device="cuda").manual_seed(19)
    for d, dh in F6_WIDE + ((768, 128),):
        for bf16 in (False, True):
            tag, r = f6_case(g, d, dh, bf16, device=True)
            rows[tag] = r
            say(f6_line(tag, d, dh, r))
    return rows


# ---------------------------------------------------------------------------
# Phases 5 (m)-(p): the REVERIE object branch, the RxR nDTW expert and CFP
# extraction at R2R width (768, 12 heads of 64), and the kernels at their
# new shapes: the REVERIE local branch (stop + MEM + 16 candidates + 36
# views + 20 objects = 74 tokens under a key mask, batch 32), the RxR
# instruction (250 tokens, batch 16), the CFP tim self-encoders over the
# map (48 tokens) and the last viewpoint (53), batch 64.
REVERIE_OBJS, REVERIE_BATCH, RXR_BATCH, CFP_TRAJ = 20, 32, 16, 64
NEW_SHAPES = (("reverie_local74", 74, 74, REVERIE_BATCH),
              ("rxr_text250", 250, 250, RXR_BATCH))
CFP_SHAPES = (("cfp_gmap48", 48, 48, CFP_TRAJ), ("cfp_vp53", 53, 53,
                                                 CFP_TRAJ))


def bench_scans():
    from vln_goat_tpu_torch.sim.graph_sim import make_synthetic_scan

    return [make_synthetic_scan(f"s{i}", num_vps=120, degree=4, seed=i)
            for i in range(4)]


def dataset_rig(dataset, compute_dtype="float32", fused=True, batch=8,
                dropout=False, objects=None, scans=None, **over):
    """(model, rollout, batcher, rt) of `dataset` at R2R width on the bench's
    four synthetic scans; REVERIE gets a synthetic store of REVERIE_OBJS
    objects a viewpoint (the CLI's, each episode's object visible at its
    goal), and the batcher's batches go through the CLI's run_batch
    (gt_obj_slot)."""
    from vln_goat_tpu_torch import cli
    from vln_goat_tpu_torch.config import GoatConfig
    from vln_goat_tpu_torch.entry import build_model
    from vln_goat_tpu_torch.rollout.env import (EpisodeBatcher,
                                                make_synthetic_dataset)
    from vln_goat_tpu_torch.rollout.rollout import NavRollout, RolloutConfig
    from vln_goat_tpu_torch.rollout.world import NavWorld

    kw = dict(use_fused_attention=fused, compute_dtype=compute_dtype, **over)
    if not dropout:
        kw.update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  feat_dropout=0.0)
    cfg = GoatConfig.for_dataset(dataset, **kw)
    scans = scans or bench_scans()
    graphs = {g_.scan_id: g_ for g_ in scans}
    order = list(graphs)
    world = NavWorld.build(scans, feat_dim=768, seed=0, objects=objects,
                           device="cuda")
    model = build_model(cfg, "cuda", seed=WEIGHT_SEED)
    rxr = dataset == "rxr"
    ro = NavRollout(model, world, RolloutConfig(
        num_nodes=48, horizon=cfg.max_action_len, feat_dim=768,
        expert_policy="ndtw" if rxr else "spl"))
    instr = cfg.max_instr_len if rxr else 60
    data = make_synthetic_dataset(graphs, 64, vocab_size=cfg.vocab_size,
                                  path_len=(6, 12) if rxr else (4, 7),
                                  seed=1, max_instr_len=instr)
    if objects is not None:
        offs = cli._vp_offsets(graphs, order)
        for it in data:
            row = offs[it["scan"]] + graphs[it["scan"]].index[it["path"][-1]]
            it["objId"] = int(objects["oid"][row,
                                             int(objects["mask"][row].argmax())])
    batcher = EpisodeBatcher(data, graphs, order, batch_size=batch,
                             max_instr_len=instr,
                             max_gt_len=13 if rxr else 8, device="cuda")
    rt = dict(banks={}, objects=objects, world=world, graphs=graphs,
              scan_order=order, device="cuda")
    return model, ro, batcher, rt


def forced_noise():
    """Gumbel draws scaled by 1e4: a sampled action is the argmax of the
    noise over the legal actions, the same on every route whatever the
    logits' rounding (a comparison of two routes' DAgger steps needs the
    same sampled trajectory)."""
    from vln_goat_tpu_torch.rollout import rollout as port_rollout

    orig = port_rollout.gumbel_noise

    @contextlib.contextmanager
    def ctx():
        port_rollout.gumbel_noise = \
            lambda g_, shape, device: 1e4 * orig(g_, shape, device)
        try:
            yield
        finally:
            port_rollout.gumbel_noise = orig
    return ctx()


def step_routes(build, routes, batch, alg="dagger", remat="full"):
    """One train step of each route (name, fused, dtype) from one set of
    weights and one batch under forced_noise(); {route: numbers}."""
    res, sd = {}, None
    for route, fused, dtype in routes:
        model, ro, _, _ = build(fused, dtype)
        if sd is None:
            sd = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(sd)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        st = init_train_state(model, ro, train_alg=alg, remat=remat,
                              teacher_horizon="auto")
        with forced_noise():
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            m, grads, outs = st.step_fn(
                st, batch, torch.Generator(device="cuda").manual_seed(0),
                keep=True)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        moved = any(not torch.equal(v, before[k])
                    for k, v in model.state_dict().items())
        res[route] = dict(loss=float(m["loss"]), grads=grads, ms=dt * 1e3,
                          counts=counts(), routes=routes_now(), moved=moved,
                          peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                          actions={k: o["actions"] for k, o in outs.items()})
        del model, ro, st, m, outs
    gc.collect()
    torch.cuda.empty_cache()
    return res


def check_step_routes(res, ref_route, kernel_routes, eager_routes, tag):
    """Actions identical on every route, every loss finite, the parameters
    moved, the kernel routes launching K1 and K2 (a), (b), the eager ones
    nothing, every bf16 launch by TMA; raises AssertionError."""
    ref = res[ref_route]
    for route, r in res.items():
        for k, a in ref["actions"].items():
            if not torch.equal(r["actions"][k], a):
                raise AssertionError(f"{tag} {route}: {k} actions differ")
        if not (math.isfinite(r["loss"]) and r["moved"]):
            raise AssertionError(f"{tag} {route}: loss {r['loss']}, "
                                 f"parameters moved {r['moved']}")
        if route in kernel_routes and min(r["counts"][:3]) <= 0:
            raise AssertionError(f"{tag} {route}: launches {r['counts']}")
        if route in eager_routes and r["counts"] != (0, 0, 0, 0):
            raise AssertionError(f"{tag} {route}: eager launched "
                                 f"{r['counts']}")
        if route in kernel_routes and "bf16" in route and (
                r["routes"]["core"]["direct"] or r["routes"]["attn"]["direct"]
                or not r["routes"]["core"]["tma"]):
            raise AssertionError(f"{tag} {route}: bf16 launches by route "
                                 f"{r['routes']}")


def reverie_phase(card):
    """Phase 5 (m): REVERIE at R2R width with REVERIE_OBJS synthetic objects
    a viewpoint, batch REVERIE_BATCH.  The greedy decode through the
    kernels and on the eager path (float32, same weights): actions,
    trajectories and pred_obj_id identical, the logits' masks as the model
    defines them and within 1e-3 (phase 4's gates).  Then one DAgger step
    with remat "full" and the og loss on float32 eager, bf16 eager and bf16
    kernels (dropout 0, forced sampling): actions identical, each bf16
    route's loss and global gradient error against float32, the kernels'
    at most 2x eager's + 1e-3, the kernels launched, by TMA.  Returns
    (numbers, failure or None)."""
    from vln_goat_tpu_torch import cli
    from vln_goat_tpu_torch.config import GoatConfig

    scans = bench_scans()
    objects = cli.synthetic_objects(
        sum(s.num_vps for s in scans), GoatConfig.for_dataset("reverie"),
        num_objs=REVERIE_OBJS)

    def build(fused, dtype):
        return dataset_rig("reverie", dtype, fused, REVERIE_BATCH,
                           objects=objects, scans=scans)

    nums, failure = {}, None
    try:
        model, ro, batcher, rt = build(True, "float32")
        items, raw = batcher.next_batch()
        batch = cli.run_batch(rt, raw, items)
        if not bool((batch["gt_obj_slot"] >= 0).all()):
            raise AssertionError("an episode's object is not at its goal")
        greedy_rollout(ro, batch)                      # warm-up
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = greedy_rollout(ro, batch)
        torch.cuda.synchronize()
        nums["decode_ms"] = (time.perf_counter() - t0) * 1e3
        nums["decode_counts"] = counts()
        e_model, e_ro, _, _ = build(False, "float32")
        e_model.load_state_dict(model.state_dict())
        reset_counts()
        t0 = time.perf_counter()
        ref = greedy_rollout(e_ro, batch)
        torch.cuda.synchronize()
        nums["eager_decode_ms"] = (time.perf_counter() - t0) * 1e3
        if counts() != (0, 0, 0, 0):
            raise AssertionError("the eager decode launched a kernel")
        if nums["decode_counts"][0] <= 0 or \
                nums["decode_counts"][1:] != (0, 0, 0):
            raise AssertionError(f"decode launches {nums['decode_counts']}")
        for key in ("actions", "pred_obj_id"):
            if not torch.equal(out[key], ref[key]):
                raise AssertionError(f"decode {key} differ")
        if out["trajectories"] != ref["trajectories"]:
            raise AssertionError("decode trajectories differ")
        check_logit_masks(out)
        fin = torch.isfinite(ref["fused_logits"])
        if not torch.equal(fin, torch.isfinite(out["fused_logits"])):
            raise AssertionError("finite-logit pattern differs")
        nums["logit_diff"] = float((out["fused_logits"][fin]
                                    - ref["fused_logits"][fin]).abs().max())
        if nums["logit_diff"] > 1e-3:
            raise AssertionError(f"fused logits differ by "
                                 f"{nums['logit_diff']}")
        nums["steps"] = int(out["steps"])
        nums["picked"] = int((out["pred_obj_id"] >= 0).sum())
        del model, ro, e_model, e_ro, out, ref
        gc.collect()
        torch.cuda.empty_cache()

        res = step_routes(build, (("float32 eager", False, "float32"),
                                  ("bf16 eager", False, "bfloat16"),
                                  ("bf16 kernels", True, "bfloat16")),
                          batch)
        check_step_routes(res, "float32 eager", ("bf16 kernels",),
                          ("float32 eager", "bf16 eager"), "train (m)")
        r32 = res["float32 eager"]
        g32 = grad_vector(r32["grads"], r32["grads"])
        errs = {}
        for route in ("bf16 eager", "bf16 kernels"):
            r = res[route]
            errs[route] = (abs(r["loss"] - r32["loss"]) / abs(r32["loss"]),
                           float((grad_vector(r["grads"], r32["grads"])
                                  - g32).norm() / g32.norm()))
        for i, what in enumerate(("loss", "gradient")):
            k_e, e_e = errs["bf16 kernels"][i], errs["bf16 eager"][i]
            if k_e > 2 * e_e + 1e-3:
                raise AssertionError(f"train (m) {what} error {k_e:.3e} > 2"
                                     f" x eager bf16 {e_e:.3e} + 1e-3")
        if float(r32["grads"]["og_head.net.3.weight"].abs().sum()) == 0:
            raise AssertionError("og_head got no gradient")
        nums.update(errs=errs, loss=r32["loss"],
                    step={k: dict(ms=v["ms"], counts=v["counts"],
                                  peak=v["peak"], routes=v["routes"])
                          for k, v in res.items()})
    except AssertionError as exc:
        failure = f"train (m): {exc}"
    gc.collect()
    torch.cuda.empty_cache()
    e = nums.get("errs", {})
    say(f"train (m) REVERIE at R2R width ({REVERIE_OBJS} objects a "
        f"viewpoint, batch {REVERIE_BATCH}): decode through the kernels "
        f"{nums.get('decode_ms', 0):.1f} ms ({nums.get('steps')} steps, "
        f"launches {nums.get('decode_counts')}), eager "
        f"{nums.get('eager_decode_ms', 0):.1f} ms; actions, trajectories and"
        f" pred_obj_id identical ({nums.get('picked')} episodes picked an "
        f"object), fused logits max |diff| {nums.get('logit_diff', 0):.3e};"
        f" DAgger step, remat full, og loss, dropout 0, forced sampling: "
        f"float32 eager loss {nums.get('loss', 0):.6f}; "
        + "; ".join(f"{k} loss {v[0]:.3e}, gradients {v[1]:.3e}"
                    for k, v in e.items())
        + " (kernels: limit 2 x eager + 1e-3); "
        + "; ".join(f"{k} {v['ms']:.1f} ms, peak {v['peak']:.2f} GiB, "
                    f"launches {v['counts'][:3]}"
                    for k, v in nums.get("step", {}).items())
        + f" on {card}")
    if failure is not None:
        say(f"train (m): FAILED: {failure} (the script goes on, and fails "
            "at its end)")
    return nums, failure


def rxr_phase(card):
    """Phase 5 (n): RxR at R2R width, max_instr_len 250, horizon 28, the
    nDTW expert, batch RXR_BATCH: one DAgger step (remat "full", dropout 0,
    forced sampling) through the kernels in float32, on the eager path in
    float32 (losses to a relative 1e-4), and through the kernels in bf16;
    actions identical, losses finite, parameters moved, the kernels
    launched.  Returns (numbers, failure or None)."""
    from vln_goat_tpu_torch import cli

    scans = bench_scans()

    def build(fused, dtype):
        return dataset_rig("rxr", dtype, fused, RXR_BATCH, scans=scans)

    nums, failure = {}, None
    try:
        _, _, batcher, rt = build(True, "float32")
        items, raw = batcher.next_batch()
        batch = cli.run_batch(rt, raw, items)
        nums["text"] = tuple(batch["txt_ids"].shape)
        res = step_routes(build, (("float32 kernels", True, "float32"),
                                  ("float32 eager", False, "float32"),
                                  ("bf16 kernels", True, "bfloat16")),
                          batch)
        check_step_routes(res, "float32 eager",
                          ("float32 kernels", "bf16 kernels"),
                          ("float32 eager",), "train (n)")
        a, b_ = res["float32 kernels"]["loss"], res["float32 eager"]["loss"]
        if abs(a - b_) > 1e-4 * abs(b_):
            raise AssertionError(f"train (n) float32 loss {a} vs eager {b_}")
        nums["res"] = {k: dict(loss=v["loss"], ms=v["ms"], peak=v["peak"],
                               counts=v["counts"])
                       for k, v in res.items()}
        nums["moves"] = int((res["float32 eager"]["actions"]["sample"] >= 0)
                            .sum())
    except AssertionError as exc:
        failure = f"train (n): {exc}"
    gc.collect()
    torch.cuda.empty_cache()
    say(f"train (n) RxR at R2R width (instructions {nums.get('text')}, "
        f"horizon 28, nDTW expert, batch {RXR_BATCH}), one DAgger step per "
        f"route, remat full, dropout 0, forced sampling "
        f"({nums.get('moves')} sampled moves): "
        + "; ".join(f"{k} loss {v['loss']:.6f}, {v['ms']:.1f} ms, peak "
                    f"{v['peak']:.2f} GiB, launches {v['counts'][:3]}"
                    for k, v in nums.get("res", {}).items())
        + f" on {card}")
    if failure is not None:
        say(f"train (n): FAILED: {failure} (the script goes on, and fails "
            "at its end)")
    return nums, failure


def cfp_phase(card):
    """Phase 5 (o): `tools.cfp_extract.extract_cfp_features` over CFP_TRAJ
    gt trajectories at R2R width in one batch, through the kernels and on
    the eager path from the same weights (float32): the pooled outputs
    finite, tanh-bounded and within 1e-4, K1 launched (forward only).
    Returns (numbers, failure or None)."""
    from vln_goat_tpu_torch.pretrain.data import (PretrainShapes,
                                                  TrajBatchBuilder,
                                                  items_from_dataset)
    from vln_goat_tpu_torch.tools.cfp_extract import extract_cfp_features

    scans = bench_scans()
    nums, failure, outs = {}, None, {}
    try:
        for route, fused in (("kernels", True), ("eager", False)):
            model, _, batcher, rt = dataset_rig(
                "r2r", fused=fused, scans=scans,
                mode="extract_cfp_features")
            if outs:
                model.load_state_dict(sd)
            else:
                sd = {k: v.clone() for k, v in model.state_dict().items()}
            builder = TrajBatchBuilder(
                rt["graphs"], rt["scan_order"],
                rt["world"].feat.cpu().numpy(),
                PretrainShapes(max_txt_len=64, max_steps=12, max_cands=16,
                               max_gmap=48), seed=0)
            items = items_from_dataset(batcher.data[:CFP_TRAJ],
                                       rt["graphs"])
            extract_cfp_features(model, builder, items[:8], batch_size=8)
            builder.rng = np.random.default_rng(0)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[route] = extract_cfp_features(model, builder, items,
                                               batch_size=CFP_TRAJ)
            torch.cuda.synchronize()
            nums[f"{route}_ms"] = (time.perf_counter() - t0) * 1e3
            nums[f"{route}_counts"] = counts()
            del model, builder
        if nums["kernels_counts"][0] <= 0 or \
                nums["kernels_counts"][1:] != (0, 0, 0) or \
                nums["eager_counts"] != (0, 0, 0, 0):
            raise AssertionError(f"launches {nums['kernels_counts']} "
                                 f"(kernels), {nums['eager_counts']} (eager)")
        diff = 0.0
        for k, v in outs["kernels"].items():
            if v.shape != (CFP_TRAJ, 768) or not np.isfinite(v).all() or \
                    np.abs(v).max() > 1.0:
                raise AssertionError(f"{k}: shape {v.shape}, finite "
                                     f"{np.isfinite(v).all()}")
            diff = max(diff, float(np.abs(v - outs["eager"][k]).max()))
        nums["diff"] = diff
        if diff > 1e-4:
            raise AssertionError(f"kernel and eager outputs differ by {diff}")
    except AssertionError as exc:
        failure = f"cfp (o): {exc}"
    gc.collect()
    torch.cuda.empty_cache()
    say(f"cfp (o) extract_cfp_features over {CFP_TRAJ} trajectories at R2R "
        f"width: kernels {nums.get('kernels_ms', 0):.1f} ms (launches "
        f"{nums.get('kernels_counts')}), eager "
        f"{nums.get('eager_ms', 0):.1f} ms; txt / vp / gmap outputs max "
        f"|diff| {nums.get('diff', float('nan')):.3e} on {card}")
    if failure is not None:
        say(f"cfp (o): FAILED: {failure} (the script goes on, and fails at "
            "its end)")
    return nums, failure


def cli_datasets_phase(card):
    """Phase 5 (p): the CLI on the card at R2R width (`--synthetic
    --use_pallas`, batch 8): `--dataset reverie` train 2 iterations (bf16)
    and `--mode valid --submit` (RGS metrics, pred_objid), `--dataset rxr
    --expert_policy ndtw` train 2 iterations (bf16; nDTW), `--mode
    extract_cfp_features` (float32; 64 rows); K1 launched by each, K2 by
    the trains.  Returns (numbers, failure or None)."""
    from vln_goat_tpu_torch import cli
    from vln_goat_tpu_torch.tools.cfp_extract import load_cfp_tsv

    out = tempfile.mkdtemp(prefix="chip_smoke_cli_datasets_")
    nums, failure = {}, None
    common = ["--synthetic", "--use_pallas", "--batch_size", "8",
              "--device", "cuda", "--log_every", "2"]
    try:
        for name, argv in (
                ("reverie train", ["--mode", "train", "--dataset",
                                   "reverie", "--iters", "2",
                                   "--compute_dtype", "bfloat16"]),
                ("reverie valid", ["--mode", "valid", "--dataset",
                                   "reverie", "--submit", "--resume_file",
                                   os.path.join(out, "reverie",
                                                "ckpt_latest")]),
                ("rxr train", ["--mode", "train", "--dataset", "rxr",
                               "--expert_policy", "ndtw", "--iters", "2",
                               "--compute_dtype", "bfloat16"]),
                ("cfp", ["--mode", "extract_cfp_features"])):
            d = os.path.join(out, name.split()[0])
            gc.collect()
            torch.cuda.empty_cache()
            reset_counts()
            t0 = time.perf_counter()
            cli.main(argv + common + ["--output_dir", d])
            torch.cuda.synchronize()
            nums[name] = dict(s=time.perf_counter() - t0, counts=counts())
            c = nums[name]["counts"]
            if c[0] <= 0 or ("train" in name and min(c[1:3]) <= 0):
                raise AssertionError(f"{name}: launches {c}")
        lines = [json.loads(line) for line in
                 open(os.path.join(out, "reverie", "metrics.jsonl"))]
        nums["reverie"] = [d_ for d_ in lines if "val_unseen/rgs" in d_][-1]
        subs = json.load(open(os.path.join(out, "reverie",
                                           "submit_val_unseen.json")))
        if not subs or not all("pred_objid" in s for s in subs):
            raise AssertionError("the REVERIE submission lacks pred_objid")
        nums["picked"] = sum(s["pred_objid"] >= 0 for s in subs)
        lines = [json.loads(line) for line in
                 open(os.path.join(out, "rxr", "metrics.jsonl"))]
        nums["rxr"] = [d_ for d_ in lines if "val_unseen/nDTW" in d_][-1]
        if not all(math.isfinite(d_["train/loss"]) for d_ in lines
                   if "train/loss" in d_):
            raise AssertionError("an RxR loss is not finite")
        feats = load_cfp_tsv(os.path.join(out, "cfp",
                                          "r2r_cfp_features.tsv"))
        nums["cfp_rows"] = len(feats["path_ids"])
        if nums["cfp_rows"] != 64 or not all(
                np.isfinite(feats[k]).all() for k in
                ("txt_feats", "vp_feats", "gmap_feats")):
            raise AssertionError(f"CFP TSV: {nums['cfp_rows']} rows")
    except AssertionError as exc:
        failure = f"cli (p): {exc}"
    finally:
        shutil.rmtree(out, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    say("cli (p) at R2R width (--synthetic --use_pallas, batch 8): "
        + "; ".join(f"{k} {v['s']:.1f} s (launches {v['counts'][:3]})"
                    for k, v in nums.items() if isinstance(v, dict)
                    and "s" in v)
        + f"; REVERIE val_unseen {nums.get('reverie')}, "
        f"{nums.get('picked')} submitted objects; RxR val_unseen "
        f"{nums.get('rxr')}; CFP TSV {nums.get('cfp_rows')} rows on {card}")
    if failure is not None:
        say(f"cli (p): FAILED: {failure} (the script goes on, and fails at "
            "its end)")
    return nums, failure


def new_shape_rows():
    """K1, K2 (a), K2 (b) at the new paths' shapes (NEW_SHAPES, key mask,
    dropout 0.1) and K1 at the CFP tim shapes, float32 under phase 3's
    gates and bf16 under phase 3 (bf16)'s, timed as the train shapes:
    {tag: {"f32", "bf16"}}."""
    rows = {}
    g = torch.Generator(device="cuda").manual_seed(23)
    for name, Lq, Lk, batch in NEW_SHAPES + CFP_SHAPES:
        r = rows[name] = dict(
            f32=check_shape(g, name, Lq, Lk, "key", "linear", batch,
                            timed=True),
            bf16=check_shape_bf16(g, name, Lq, Lk, "key", "linear", batch,
                                  timed=True))
        f, b = r["f32"], r["bf16"]
        say(f"shape {name}: B={batch} Lq={Lq} Lk={Lk} key mask, dropout "
            f"{RATE}; float32 max_abs_err forward {f[f'fwd_err_{RATE}']:.3e}"
            f", attention backward {f[f'attn_err_{RATE}']:.3e}, grads "
            f"{f[f'proj_err_{RATE}']:.3e}; ms K1 {f['ms']:.4f} (device "
            f"{f['device_ms']:.4f}, bound {f['bound_ms']:.4f}, plain "
            f"{f['plain_ms']:.4f}, library {f['library_ms']:.4f}), K2 (a) "
            f"{f['attn_ms']:.4f} (bound {f['attn_bound_ms']:.4f}, library "
            f"{f['attn_library_ms']:.4f}), K2 (b) {f['projb_ms']:.4f} (bound"
            f" {f['projb_bound_ms']:.4f}, library "
            f"{f['projb_library_ms']:.4f}); bf16 against float64 forward "
            f"{b['fwd_err']:.3e}, K2 (a) {b['attn_err']:.3e}, K2 (b) "
            f"{b['proj_err']:.3e}; ms K1 {b['ms']:.4f} (device "
            f"{b['device_ms']:.4f}, bound {b['bound_ms']:.4f}, library "
            f"{b['library_ms']:.4f}), K2 (a) {b['attn_ms']:.4f} (bound "
            f"{b['attn_bound_ms']:.4f}, library {b['attn_library_ms']:.4f}),"
            f" K2 (b) {b['projb_ms']:.4f} (bound {b['projb_bound_ms']:.4f}, "
            f"library {b['projb_library_ms']:.4f})")
    return rows


def new_kernel_rows(rows, m, n, o):
    """The kernel line's rows of the new shapes, with the launches their
    paths counted: the REVERIE local rows those of 5 (m) (float32 decode,
    bf16 kernel step), the RxR text rows 5 (n)'s steps, the CFP rows 5
    (o)'s extraction (K1 only)."""
    out = []
    step = m.get("step", {}).get("bf16 kernels", {}).get("counts",
                                                        (0, 0, 0, 0))
    dec = m.get("decode_counts", (0, 0, 0, 0))
    res = n.get("res", {})
    rx32 = res.get("float32 kernels", {}).get("counts", (0, 0, 0, 0))
    rx16 = res.get("bf16 kernels", {}).get("counts", (0, 0, 0, 0))
    cfp = o.get("kernels_counts", (0, 0, 0, 0))
    launches = {
        "reverie_local74": ((dec[0], 0, 0), dict(reverie_decode=dec[0]),
                            step[:3], dict(reverie_train=step[0])),
        "rxr_text250": (rx32[:3], dict(rxr_train=rx32[0]), rx16[:3],
                        dict(rxr_train=rx16[0])),
        "cfp_gmap48": ((cfp[0], 0, 0), dict(cfp_extract=cfp[0]), (0, 0, 0),
                       dict(cfp_extract=0)),
        "cfp_vp53": ((cfp[0], 0, 0), dict(cfp_extract=cfp[0]), (0, 0, 0),
                     dict(cfp_extract=0)),
    }
    for tag, r in rows.items():
        l32, p32, l16, p16 = launches[tag]
        k = 1 if tag.startswith("cfp") else 3
        out += width_kernel_rows(tag, r["f32"], None, False, l32, p32)[:k]
        out += width_kernel_rows(tag, r["bf16"], None, True, l16, p16)[:k]
    return out


# ---------------------------------------------------------------------------
# Phases 3 (o), 5 (q), 5 (r): pretraining at R2R width (hidden 768, 12 heads
# of 64, 6 text / 2 pano / 3 cross layers, vocab 50265), the pretrain CLI's
# `--synthetic` rig: batch 48, trajectories of up to 20 steps, 80-token
# instructions, 64 map slots ([stop] + nodes, no [MEM]), 53 viewpoint
# tokens ([stop] + 16 candidates + 36 views; 73 with REVERIE's 20 objects
# a viewpoint).  Every module in float32, as the JAX pretrain model.
PT_BATCH, PT_WARM, PT_TIMED = 48, 2, 2
PT_TASKS, PT_OG = ("mlm", "sap", "cfp", "mrc"), ("og",)
# (tag, Lq, Lk, bias kind) of every pretraining attention: the text's
# self-attention (the language encoder, and MLM's cross encoders' own
# self-attention); MLM's text over the map and the viewpoint; the map's
# self-attention under the key mask and the graph bias (SAP) or the key
# mask alone (CFP's tim self-encoder); the map over the text; the
# viewpoint's self-attention (SAP, MRC, CFP's tim self-encoder) and the
# viewpoint over the text; REVERIE's viewpoint with objects (OG)
PT_SHAPES = (("pt_text80", 80, 80, "key"),
             ("pt_text80xgmap64", 80, 64, "key"),
             ("pt_text80xvp53", 80, 53, "key"),
             ("pt_gmap64_graph", 64, 64, "full"),
             ("pt_gmap64", 64, 64, "key"),
             ("pt_gmap64xtext80", 64, 80, "key"),
             ("pt_vp53", 53, 53, "key"),
             ("pt_vp53xtext80", 53, 80, "key"),
             ("pt_vp73", 73, 73, "key"),
             ("pt_vp73xtext80", 73, 80, "key"))
# the gradients zero up to rounding in a pretraining step: NOISE_GRAD_BIASES
# and, SAP being teacher-forced, TEACHER_NOISE_BIASES (gate_witness), and
# the og head's last two biases (one constant on every object logit)
PT_NOISE = NOISE_GRAD_BIASES + TEACHER_NOISE_BIASES + (
    "og_head.net.2.bias", "og_head.net.3.bias")


def pretrain_plan(task, layers=6, cross=3):
    """{shape tag: fused attention calls} of one forward of `task` (each
    also one K2 (a) and one K2 (b) launch in its backward): every
    attention of pretraining has at least 53 queries, over the gate's 32,
    so every one is a kernel launch."""
    vp = "pt_vp73" if task == "og" else "pt_vp53"
    plan = {"pt_text80": layers}
    if task == "mlm":
        plan.update(pt_text80=layers + 2 * cross, pt_text80xgmap64=cross,
                    pt_text80xvp53=cross)
    elif task == "sap":
        plan.update(pt_gmap64_graph=cross, pt_gmap64xtext80=cross,
                    pt_vp53=cross, pt_vp53xtext80=cross)
    elif task in ("mrc", "og"):
        plan.update({vp: cross, vp + "xtext80": cross})
    elif task == "cfp":
        plan.update(pt_gmap64=1, pt_vp53=1)
    return plan


def pretrain_shape_rows():
    """Phase 3 (o): K1, K2 (a), K2 (b) in float32 at every PT_SHAPES shape,
    batch 48, dropout 0.1, under phase 3's gates and timed as the train
    shapes: {tag: row}."""
    rows = {}
    g = torch.Generator(device="cuda").manual_seed(29)
    for name, Lq, Lk, bias_kind in PT_SHAPES:
        f = rows[name] = check_shape(g, name, Lq, Lk, bias_kind, "linear",
                                     PT_BATCH, timed=True)
        say(f"shape {name}: B={PT_BATCH} Lq={Lq} Lk={Lk} {bias_kind} bias, "
            f"dropout {RATE}; float32 max_abs_err forward "
            f"{f[f'fwd_err_{RATE}']:.3e}, attention backward "
            f"{f[f'attn_err_{RATE}']:.3e}, grads {f[f'proj_err_{RATE}']:.3e}"
            f"; ms K1 {f['ms']:.4f} (device {f['device_ms']:.4f}, bound "
            f"{f['bound_ms']:.4f}, plain {f['plain_ms']:.4f}, library "
            f"{f['library_ms']:.4f}), K2 (a) {f['attn_ms']:.4f} (bound "
            f"{f['attn_bound_ms']:.4f}, plain {f['attn_plain_ms']:.4f}, "
            f"library {f['attn_library_ms']:.4f}), K2 (b) "
            f"{f['projb_ms']:.4f} (bound {f['projb_bound_ms']:.4f}, plain "
            f"{f['projb_plain_ms']:.4f}, library "
            f"{f['projb_library_ms']:.4f})")
    return rows


def pretrain_rig(dataset, tasks, fused, dropout, workers=0,
                 batch=PT_BATCH):
    """(args, runtime) of the pretrain CLI's `--synthetic` build at R2R
    width on the card: batch 48 (or `batch`), the CLI's defaults otherwise (its
    weights from seed 0), the fused kernels or the eager path, every
    dropout at 0 unless `dropout`."""
    from vln_goat_tpu_torch.pretrain import cli as pcli

    mc = dict(use_pallas_attention=fused)
    if not dropout:
        mc.update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="chip_smoke_pt_")
    with os.fdopen(fd, "w") as f:
        json.dump(mc, f)
    try:
        args = pcli.parse_args(
            ["--synthetic", "--device", "cuda", "--dataset", dataset,
             "--tasks", *tasks, "--mix_ratio", *["1"] * len(tasks),
             "--train_batch_size", str(batch), "--model_config", path,
             "--num_workers", str(workers)])
        return args, pcli.build(args)
    finally:
        os.unlink(path)


def pretrain_step(model, task, batch):
    """One pretraining update of `model` on `batch` (AdamW as the CLI
    builds it), the dropout generator seeded 0; (metrics, gradients,
    launches)."""
    from vln_goat_tpu_torch.config import PretrainConfig
    from vln_goat_tpu_torch.pretrain.train import (PretrainState,
                                                   make_pretrain_optimizer,
                                                   make_pretrain_steps)

    state = PretrainState(model, make_pretrain_optimizer(PretrainConfig(),
                                                         model))
    step = make_pretrain_steps(model, (task,))[task]
    reset_counts()
    m, grads = step(state, batch, torch.Generator(device="cuda").manual_seed(0),
                    keep=True)
    torch.cuda.synchronize()
    return m, grads, counts()


def pretrain_gates(card):
    """Phase 5 (q), correctness: each task's update at R2R width, batch 48,
    every dropout at 0, through the kernels against the eager path from the
    same weights and batch: the loss to a relative 1e-4, every gradient
    within 1e-3 of its largest magnitude (PT_NOISE at their weight's), the
    ClsPrediction ReLU decisions of the kernel step that differ from
    eager's within KINK_BAND of the kink (and given eager's, as phase 5
    (a) gives them), and the launches of K1, K2 (a), K2 (b) each equal to
    the task's plan (every attention on the kernels).  MLM, SAP, CFP and
    MRC (1000 classes) on the R2R rig, OG on the REVERIE rig.  Returns
    ({task: numbers}, failure or None)."""
    from vln_goat_tpu_torch.pretrain.cli import batch_to_device, make_batch_np

    nums, failure = {}, None
    try:
        for dataset, tasks in (("r2r", PT_TASKS), ("reverie", PT_OG)):
            _, e_rt = pretrain_rig(dataset, tasks, False, False)
            _, k_rt = pretrain_rig(dataset, tasks, True, False)
            sd0 = {k: v.clone() for k, v in e_rt["model"].state_dict().items()}
            for task in tasks:
                e_rt["model"].load_state_dict(sd0)
                k_rt["model"].load_state_dict(sd0)
                batch = batch_to_device(make_batch_np(
                    e_rt["builder"], e_rt["items"]["train"], PT_BATCH, 0,
                    "train", task, 0), e_rt["device"])
                seen, hooks = record_relus(e_rt["model"])
                e_m, e_grads, e_counts = pretrain_step(e_rt["model"], task,
                                                       batch)
                for h in hooks:
                    h.remove()
                pinned, hooks = pin_relus(k_rt["model"], seen)
                t0 = time.perf_counter()
                k_m, k_grads, k_counts = pretrain_step(k_rt["model"], task,
                                                       batch)
                ms = (time.perf_counter() - t0) * 1e3
                for h in hooks:
                    h.remove()
                n = sum(pretrain_plan(task).values())
                r = nums[task] = dict(
                    loss=float(k_m["loss"]), eager_loss=float(e_m["loss"]),
                    counts=k_counts, plan=n, flips=pinned["flips"],
                    dist=pinned["dist"], dev=pinned["dev"], ms=ms,
                    metrics={k: float(v) for k, v in k_m.items()})
                if e_counts != (0, 0, 0, 0):
                    raise AssertionError(f"{task}: the eager step launched "
                                         f"{e_counts}")
                if k_counts != (n, n, n, 0):
                    raise AssertionError(f"{task}: the kernel step launched "
                                         f"{k_counts}, the plan {n}")
                if not math.isfinite(r["loss"]) or abs(
                        r["loss"] - r["eager_loss"]) > 1e-4 * abs(
                            r["eager_loss"]):
                    raise AssertionError(f"{task}: loss {r['loss']} vs eager "
                                         f"{r['eager_loss']}")
                if pinned["dist"] > KINK_BAND:
                    raise AssertionError(
                        f"{task}: a ReLU decision differs from eager's with "
                        f"|z - z_eager| {pinned['dist']:.3e} > {KINK_BAND}")
                if set(k_grads) != set(e_grads):
                    raise AssertionError(f"{task}: other parameters got a "
                                         "gradient")
                r["grad_ratio"], r["grad_name"] = worst_grad(
                    k_grads, e_grads, PT_NOISE)
                if r["grad_ratio"] > 1e-3:
                    raise AssertionError(
                        f"{task}: gradient {r['grad_name']} differs by "
                        f"{r['grad_ratio']:.3e} of its scale > 1e-3")
                del seen, e_grads, k_grads, batch
            del e_rt, k_rt, sd0
            gc.collect()
            torch.cuda.empty_cache()
    except AssertionError as exc:
        failure = f"pretrain (q): {exc}"
    gc.collect()
    torch.cuda.empty_cache()
    say(f"pretrain (q) R2R width, batch {PT_BATCH}, dropout 0, kernels vs "
        "eager, one update per task: "
        + "; ".join(f"{t} loss {r['loss']:.6f} vs {r['eager_loss']:.6f}, "
                    f"gradients within {r.get('grad_ratio', float('nan')):.2e}"
                    f" of their max ({r.get('grad_name')}), launches "
                    f"{r['counts'][:3]} (plan {r['plan']}), {r['flips']} ReLU "
                    f"decisions given eager's (within {r['dist']:.2e} of the "
                    f"kink), kernel step {r['ms']:.1f} ms"
                    for t, r in nums.items())
        + f" on {card}")
    if failure is not None:
        say(f"pretrain (q): FAILED: {failure} (the script goes on, and fails "
            "at its end)")
    return nums, failure


def pretrain_timing(card):
    """Phase 5 (q), throughput: each task's updates at R2R width, batch 48,
    dropout on (0.1), through the kernels, fed by the CLI's worker pool
    (`pretrain.cli.batch_pool`, 6 spawned workers on shared-memory
    tables; copies to the card from pinned memory) as bench.py's
    bench_pretrain feeds its steps: PT_WARM warm-up updates, then PT_TIMED
    timed ones, the loss fetched every step as the CLI fetches it;
    examples per second, ms per update, peak memory and the launches over
    all the task's updates (each its plan); then one more update under
    torch.profiler (`trace_call`: the device-busy share, the float32 K1 /
    K2 kernels' device time).  Returns ({task: numbers}, failure or
    None)."""
    from vln_goat_tpu_torch.config import PretrainConfig
    from vln_goat_tpu_torch.pretrain import cli as pcli
    from vln_goat_tpu_torch.pretrain.train import (PretrainState,
                                                   make_pretrain_optimizer,
                                                   make_pretrain_steps,
                                                   step_generator)

    nums, failure, setup = {}, None, {}
    try:
        for dataset, tasks in (("r2r", PT_TASKS), ("reverie", PT_OG)):
            t0 = time.perf_counter()
            args, rt = pretrain_rig(dataset, tasks, True, True, workers=6)
            setup[dataset] = time.perf_counter() - t0
            model, dev = rt["model"], rt["device"]
            state = PretrainState(model, make_pretrain_optimizer(
                PretrainConfig(tasks=tasks), model))
            steps = make_pretrain_steps(model, tasks)
            pool, close = pcli.batch_pool(args, rt["builder"], rt["items"])
            try:
                for task in tasks:
                    # the warm-up and timed updates, then one more under
                    # the profiler
                    descs = [("train", task, s)
                             for s in range(PT_WARM + PT_TIMED + 1)]
                    gc.collect()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    reset_counts()
                    t_first = time.perf_counter()
                    for i, (_, nb) in enumerate(pool.imap(iter(descs))):
                        if i == 0:
                            t_first = time.perf_counter() - t_first
                        if i == PT_WARM:
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                        batch = pcli.batch_to_device(nb, dev)
                        gen = step_generator(0, i, dev)
                        if i < PT_WARM + PT_TIMED:
                            loss = float(steps[task](state, batch,
                                                     gen)["loss"])
                            if i == PT_WARM + PT_TIMED - 1:
                                torch.cuda.synchronize()
                                dt = time.perf_counter() - t0
                            continue
                        trace = trace_call(lambda: float(steps[task](
                            state, batch, gen)["loss"]), K_F32_PARTS)
                    n = sum(pretrain_plan(task).values()) * len(descs)
                    r = nums[task] = dict(
                        ex_s=PT_BATCH * PT_TIMED / dt,
                        ms=dt / PT_TIMED * 1e3, loss=loss,
                        peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                        counts=counts(), plan=n, steps=len(descs),
                        first_batch_s=t_first, trace=trace,
                        adamw=dict(optim.launches))
                    if not math.isfinite(loss):
                        raise AssertionError(f"{task}: loss {loss}")
                    adamw_check(f"pretrain_{task}", r["adamw"], len(descs))
                    if r["counts"] != (n, n, n, 0):
                        raise AssertionError(f"{task}: launched "
                                             f"{r['counts']}, the plan {n}")
            finally:
                close()
            del state, steps, model, rt
            gc.collect()
            torch.cuda.empty_cache()
    except AssertionError as exc:
        failure = f"pretrain (q) timing: {exc}"
    gc.collect()
    torch.cuda.empty_cache()
    say(f"pretrain (q) R2R width, batch {PT_BATCH}, dropout 0.1, kernels, "
        f"6 batch workers, {PT_WARM} warm-up + {PT_TIMED} timed updates per "
        "task: "
        + "; ".join(f"{t} {r['ex_s']:.1f} examples/s ({r['ms']:.1f} ms an "
                    f"update, peak {r['peak']:.2f} GiB, launches "
                    f"{r['counts'][:3]} over {r['steps']} updates, fused "
                    f"AdamW {r['adamw']}, first "
                    f"batch after {r['first_batch_s']:.1f} s)"
                    for t, r in nums.items())
        + "; rig builds " + ", ".join(f"{k} {v:.1f} s"
                                      for k, v in setup.items())
        + f" on {card}")
    for t, r in nums.items():
        tr = r["trace"]
        if "busy_share" not in tr:
            say(f"pretrain (q) {t}: profile of one more update "
                f"{tr['wall_ms']:.1f} ms, no device events")
            continue
        k = sum(tr["parts"].values())
        say(f"pretrain (q) {t}: profile of one more update "
            f"{tr['wall_ms']:.1f} ms, {tr['events']} events; device busy "
            f"{tr['busy_ms']:.1f} ms ({tr['busy_share'] * 100:.1f}% of "
            f"{tr['window_ms']:.1f} ms), device time {tr['device_ms']:.1f} "
            f"ms; float32 K1 / K2 kernels {k:.1f} ms "
            f"({k / tr['device_ms'] * 100:.1f}%: "
            + ", ".join(f"{p} {v:.2f}" for p, v in tr["parts"].items())
            + "); top 5: " + "; ".join(f"{name[:60]} {ns / 1e6:.2f} ms"
                                       for name, ns in tr["top"][:5]))
    if failure is not None:
        say(f"pretrain (q) timing: FAILED: {failure} (the script goes on, "
            "and fails at its end)")
    return nums, failure


def pretrain_cli_phase(card):
    """Phase 5 (r): `python -m vln_goat_tpu_torch.pretrain.cli --synthetic`
    (in this process) with a `--model_config` setting use_pallas_attention,
    R2R width, MLM / SAP / CFP at batch 48, 2 batch workers, 4 updates and
    one validation: K1 and K2 launched, `ckpt_latest` and a `ckpt_best_*`
    written, the losses logged finite.  Then the best directory as a
    pretrain .pt (`save_pretrain_checkpoint`) initialises the fine-tune
    GoatModel with no encoder key missing, and the fine-tune CLI runs 2
    iterations from it through `--bert_ckpt_file` (`--use_pallas`, batch
    8).  Returns (numbers, failure or None)."""
    from vln_goat_tpu_torch import cli
    from vln_goat_tpu_torch.config import GoatConfig
    from vln_goat_tpu_torch.entry import build_model
    from vln_goat_tpu_torch.pretrain import cli as pcli
    from vln_goat_tpu_torch.train import checkpoint as ck

    out = tempfile.mkdtemp(prefix="chip_smoke_pretrain_")
    nums, failure = {}, None
    try:
        mc = os.path.join(out, "model.json")
        with open(mc, "w") as f:
            json.dump({"use_pallas_attention": True}, f)
        pdir = os.path.join(out, "pretrain")
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        pcli.main(["--synthetic", "--model_config", mc, "--output_dir", pdir,
                   "--num_train_steps", "4", "--valid_steps", "4",
                   "--log_steps", "2", "--num_workers", "2"])
        torch.cuda.synchronize()
        nums["pretrain_s"] = time.perf_counter() - t0
        nums["pretrain_counts"] = counts()
        if min(nums["pretrain_counts"][:3]) <= 0:
            raise AssertionError(f"pretrain launches "
                                 f"{nums['pretrain_counts']}")
        best = sorted(d for d in os.listdir(pdir)
                      if d.startswith("ckpt_best_"))
        if not best or not os.path.isdir(os.path.join(pdir, "ckpt_latest")):
            raise AssertionError(f"checkpoints {sorted(os.listdir(pdir))}")
        nums["best"] = best
        lines = [json.loads(line) for line in
                 open(os.path.join(pdir, "metrics.jsonl"))]
        nums["train"] = [d for d in lines if "train/mlm" in d]
        nums["val_unseen"] = [d for d in lines if any(
            k.startswith("val_unseen/") for k in d)]
        if not nums["train"] or not all(
                math.isfinite(v) for d in nums["train"] for k, v in d.items()
                if k.startswith("train/")):
            raise AssertionError(f"train losses {nums['train']}")
        pt = os.path.join(out, "pretrain.pt")
        ck.save_pretrain_checkpoint(
            ck.load_params(os.path.join(pdir, best[-1])), pt)
        ft = build_model(GoatConfig.for_dataset("r2r"), "cuda")
        missing, extra = ck.load_reference(ft, pt)
        nums["missing"], nums["extra"] = missing, extra
        enc = [k for k in missing if k.split(".")[0] in (
            "embeddings", "lang_encoder", "img_embeddings", "local_encoder",
            "global_encoder")]
        if enc:
            raise AssertionError(f"encoder keys missing: {enc[:5]}")
        del ft
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        fdir = os.path.join(out, "finetune")
        cli.main(["--mode", "train", "--synthetic", "--use_pallas",
                  "--bert_ckpt_file", pt, "--iters", "2", "--log_every", "2",
                  "--batch_size", "8", "--device", "cuda", "--output_dir",
                  fdir])
        torch.cuda.synchronize()
        nums["finetune_s"] = time.perf_counter() - t0
        nums["finetune_counts"] = counts()
        lines = [json.loads(line) for line in
                 open(os.path.join(fdir, "metrics.jsonl"))]
        losses = [d["train/loss"] for d in lines if "train/loss" in d]
        nums["finetune_losses"] = losses
        if not losses or not all(math.isfinite(v) for v in losses) or \
                min(nums["finetune_counts"][:3]) <= 0:
            raise AssertionError(f"fine-tune losses {losses}, launches "
                                 f"{nums['finetune_counts']}")
    except AssertionError as exc:
        failure = f"pretrain (r): {exc}"
    finally:
        shutil.rmtree(out, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    say(f"pretrain (r) the pretrain CLI at R2R width (--synthetic, "
        f"use_pallas_attention, batch 48, 4 updates, validation at 4): "
        f"{nums.get('pretrain_s', 0):.1f} s (launches "
        f"{nums.get('pretrain_counts')}), checkpoints {nums.get('best')}, "
        f"train {nums.get('train')}, val_unseen {nums.get('val_unseen')}; "
        f"its .pt into the fine-tune model: missing {nums.get('missing')}, "
        f"extra {len(nums.get('extra', []))} keys; the fine-tune CLI from it "
        f"(--bert_ckpt_file, 2 iterations) {nums.get('finetune_s', 0):.1f} s"
        f" (launches {nums.get('finetune_counts')}), losses "
        f"{nums.get('finetune_losses')} on {card}")
    if failure is not None:
        say(f"pretrain (r): FAILED: {failure} (the script goes on, and fails "
            "at its end)")
    return nums, failure


def pretrain_kernel_rows(rows, timing):
    """The kernel line's rows of PT_SHAPES: K1, K2 (a), K2 (b) each, with
    the launches 5 (q)'s timed updates made at that shape (the plan's
    count per update times the task's updates, by task)."""
    out = []
    for tag, row in rows.items():
        by_task = {f"pretrain_{t}": pretrain_plan(t).get(tag, 0) * r["steps"]
                   for t, r in timing.items()}
        n = sum(by_task.values())
        for r in width_kernel_rows(tag, row, None, False, (n, n, n)):
            # each forward call has its backward: K2 splits as K1 does
            r["launches_by_path"] = dict(by_task)
            out.append(r)
    return out


# ---------------------------------------------------------------------------
# Phases 3 (s), 5 (s)-(u): GOAT's online z-dict refresh, the speaker and
# back-translation.  The refresh encodes 512 training instructions at the
# fixed width 64 in chunks of 64 (the JAX CLI's cli.py:815-851): every text
# self-attention of it is K1 at 64 x 64 under the key mask, dropout 0.  The
# speaker runs at its published width (hidden 512, word 256, 4 heads of 64,
# 3 layers, FFN 1024, angle features 128) over the R2R model's vocabulary;
# it reaches no TPU kernel in either package (plain PyTorch).
REFRESH_SHAPE, REFRESH_ITEMS, REFRESH_LEN = ("refresh64", 64, 64), 512, 64
SPK_BATCH, SPK_STEPS, SPK_LR, SPK_LEN = 64, 20, 1e-4, 60
BT_HALF = 32          # the back-translated fused update: 2 x 32 episodes
SPK_STEPS_MAX = 15    # the speaker's path steps: R2R's max_action_len
# words of the synthetic instructions: the picker's direction words and
# fallback landmarks among filler words
REFRESH_FILLER = ("the", "and", "then", "a", "of", "walk", "go", "turn",
                  "wait", "near", "by", "to", "at", "with")


def worded_items(data, vocab, seed):
    """`data` (synthetic items) with instructions of 8-40 words drawn from
    the picker's direction words, its fallback landmarks and filler words,
    and encodings of one id a word (a Zipf-like choice among 2000 ids)
    between the leading and trailing specials, cut at REFRESH_LEN."""
    from vln_goat_tpu_torch.tools.zdict import (DIRECTION_WORDS,
                                                FALLBACK_LANDMARKS)
    rng = np.random.default_rng(seed)
    words = list(DIRECTION_WORDS) + list(FALLBACK_LANDMARKS) + \
        list(REFRESH_FILLER)
    ids = np.arange(3, 2003)
    p = 1.0 / np.arange(1, len(ids) + 1)
    p /= p.sum()
    out = []
    for it in data:
        n = int(rng.integers(8, 41))
        enc = [0] + [int(t) for t in rng.choice(ids, n, p=p)
                     if t < vocab] + [2]
        out.append(dict(it, instruction=" ".join(rng.choice(words, n)),
                        instr_encoding=enc[:REFRESH_LEN]))
    return out


def refresh_shape_rows():
    """Phase 3 (s): K1 float32 and bf16 at the refresh shape (64 x 64 under
    the key mask, batch 64): phase 3's and 3 (bf16)'s gates (dropout 0 and
    0.1, the backward included), then K1 timed at dropout 0 as the refresh
    calls it, beside the plain version, the library call and the bound,
    by device time from CUDA graphs.  {"f32": row, "bf16": row}."""
    name, Lq, Lk = REFRESH_SHAPE
    g = torch.Generator(device="cuda").manual_seed(31)
    rows = dict(f32=check_shape(g, name, Lq, Lk, "key", "linear", B_TRAIN,
                                timed=False),
                bf16=check_shape_bf16(g, name, Lq, Lk, "key", "linear",
                                      B_TRAIN, timed=False))
    args, seed = make_case(g, Lq, Lk, "key", "linear", B_TRAIN)
    for key, det in (("f32", [None if a is None else a.detach()
                              for a in args]),
                     ("bf16", [None if a is None else a.detach()
                               for a in to_bf16(args)])):
        row, kw = rows[key], dict(num_heads=H, dropout_rate=0.0, seed=seed)
        with torch.no_grad():
            row["ms"] = cuda_ms(lambda: fused_qkv_mha(*det, **kw))
            row["plain_ms"] = cuda_ms(lambda: fused_qkv_mha_plain(*det,
                                                                  **kw))
            row["library_ms"] = cuda_ms(lambda: library_call(det))
            row["device_ms"] = graph_ms(lambda: fused_qkv_mha(*det, **kw))
            row["library_device_ms"] = graph_ms(lambda: library_call(det))
        fb = bound(det, tf32x3=key == "f32")
        row["bound_ms"], row["bound_by"] = max(fb), \
            "operations" if fb[0] >= fb[1] else "bytes"
        row["err"] = row["fwd_err_0.0"] if key == "f32" else row["fwd_err"]
    f, b = rows["f32"], rows["bf16"]
    say(f"shape {name}: B={B_TRAIN} Lq={Lq} Lk={Lk} key mask, dropout 0 "
        f"(the z-dict refresh's text self-attention); float32 max_abs_err "
        f"forward {f['err']:.3e} (dropout 0.1: {f[f'fwd_err_{RATE}']:.3e}),"
        f" attention backward {f['attn_err_0.0']:.3e}, grads "
        f"{f['proj_err_0.0']:.3e}; bf16 against float64 forward "
        f"{b['fwd_err']:.3e}, K2 (a) {b['attn_err']:.3e}, K2 (b) "
        f"{b['proj_err']:.3e}; K1 ms float32 {f['ms']:.4f} (device "
        f"{f['device_ms']:.4f}, bound {f['bound_ms']:.4f} by "
        f"{f['bound_by']}, plain {f['plain_ms']:.4f}, library "
        f"{f['library_ms']:.4f}, library device "
        f"{f['library_device_ms']:.4f}), bf16 {b['ms']:.4f} (device "
        f"{b['device_ms']:.4f}, bound {b['bound_ms']:.4f} by "
        f"{b['bound_by']}, plain {b['plain_ms']:.4f}, library "
        f"{b['library_ms']:.4f}, library device "
        f"{b['library_device_ms']:.4f})")
    return rows


def refresh_kernel_rows(rows, launches):
    """The kernel line's rows of the refresh shape: K1 float32 (launched
    `launches` times by 5 (s)'s refresh) and bf16 (on no path)."""
    src = "vln_goat_tpu_torch/ops/csrc/fused_qkv_mha.cu"
    out = []
    for key, sfx, n in (("f32", "", launches), ("bf16", "_bf16", 0)):
        r = rows[key]
        out.append(dict(
            name=f"fused_qkv_mha{sfx}_{REFRESH_SHAPE[0]}", route="cuda",
            source=src, replaces="vln_goat_tpu/ops/attention.py:169",
            launches=n, launches_by_path=dict(zdict_refresh=n),
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], device_ms=r["device_ms"],
            library_device_ms=r["library_device_ms"]))
    return out


def zdict_phase(card):
    """Phase 5 (s): `tools.zdict.update_instr_zdict` over 512 synthetic
    instructions (worded_items) on the R2R model at full width (seed
    WEIGHT_SEED), through the kernels and on the eager path from the same
    weights: keys in the same order, p(z) equal, every feature within 1e-4
    of the eager features' largest magnitude; K1 launched chunks x text
    layers times and nothing else; time and peak memory.  Returns (numbers,
    failure or None)."""
    from vln_goat_tpu_torch.config import GoatConfig
    from vln_goat_tpu_torch.entry import build_model
    from vln_goat_tpu_torch.rollout.env import make_synthetic_dataset
    from vln_goat_tpu_torch.tools.zdict import (WordPicker,
                                                update_instr_zdict)

    cfg = GoatConfig.for_dataset("r2r", use_fused_attention=True)
    graphs = {g.scan_id: g for g in bench_scans()}
    data = worded_items(make_synthetic_dataset(
        graphs, REFRESH_ITEMS, vocab_size=cfg.vocab_size, seed=5),
        cfg.vocab_size, seed=6)
    kmodel = build_model(cfg, "cuda", seed=WEIGHT_SEED)
    emodel = build_model(cfg.replace(use_fused_attention=False), "cuda",
                         seed=WEIGHT_SEED)
    emodel.load_state_dict(kmodel.state_dict())
    nums, res = {}, {}
    chunks = -(-REFRESH_ITEMS // 64)
    for tag, model in (("kernels", kmodel), ("eager", emodel)):
        def refresh():
            return update_instr_zdict(
                model, data, WordPicker(), lambda d: d["instruction"].split(),
                lambda t: False, max_len=REFRESH_LEN)
        refresh()                                    # warm-up
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res[tag] = refresh()
        torch.cuda.synchronize()
        nums[f"{tag}_s"] = time.perf_counter() - t0
        nums[f"{tag}_counts"] = counts()
        nums[f"{tag}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    want = (chunks * cfg.num_l_layers, 0, 0, 0)
    failure = None
    try:
        if nums["kernels_counts"] != want:
            raise AssertionError(f"kernel refresh launched "
                                 f"{nums['kernels_counts']}, expected {want}")
        if nums["eager_counts"] != (0, 0, 0, 0):
            raise AssertionError("the eager refresh launched a kernel")
        (_, klm, kdr, klp, kdp), (_, elm, edr, elp, edp) = \
            res["kernels"], res["eager"]
        if not elm or not edr:
            raise AssertionError("the refresh picked no landmark or no "
                                 "direction")
        worst = 0.0
        for got, ref, gp, rp in ((klm, elm, klp, elp), (kdr, edr, kdp, edp)):
            if list(got) != list(ref) or gp != rp:
                raise AssertionError("keys or p(z) differ from eager's")
            scale = max(float(np.abs(v).max()) for v in ref.values())
            worst = max(worst, max(float(np.abs(got[k] - v).max()) / scale
                                   for k, v in ref.items()))
        nums["worst"], nums["keys"] = worst, (len(elm), len(edr))
        if worst > 1e-4:
            raise AssertionError(f"features |diff| {worst:.3e} of their "
                                 f"scale > 1e-4")
    except AssertionError as exc:
        failure = f"zdict (s): {exc}"
    del kmodel, emodel, res
    gc.collect()
    torch.cuda.empty_cache()
    say(f"zdict (s) refresh of {REFRESH_ITEMS} instructions at width "
        f"{REFRESH_LEN}, {chunks} chunks of 64, R2R model: kernels "
        f"{nums['kernels_s']:.3f} s (launches {nums['kernels_counts']}, "
        f"expected {want}; peak {nums['kernels_peak_gib']:.2f} GiB), eager "
        f"{nums['eager_s']:.3f} s (peak {nums['eager_peak_gib']:.2f} GiB); "
        f"{nums.get('keys')} landmark / direction keys, features within "
        f"{nums.get('worst', float('nan')):.2e} of their scale (limit 1e-4),"
        f" keys and p(z) {'equal' if failure is None else 'see FAILED'} on "
        f"{card}")
    if failure is not None:
        say(f"zdict (s): FAILED: {failure} (the script goes on, and fails at "
            "its end)")
    return nums, failure


def speaker_rig(seed=8):
    """The speaker at its published width over the R2R vocabulary, on the
    card, with the bench's scans, seeded features and worded synthetic
    items: (speaker, graphs, features, offsets, items, vocab)."""
    from vln_goat_tpu_torch import cli
    from vln_goat_tpu_torch.config import GoatConfig
    from vln_goat_tpu_torch.rollout.env import make_synthetic_dataset
    from vln_goat_tpu_torch.speaker.model import SpeakerConfig
    from vln_goat_tpu_torch.speaker.speaker import Speaker

    vocab = GoatConfig.for_dataset("r2r").vocab_size
    graphs = {g.scan_id: g for g in bench_scans()}
    offsets = cli._vp_offsets(graphs, list(graphs))
    feats = np.random.default_rng(seed).standard_normal(
        (sum(g.num_vps for g in graphs.values()), 36, 768)).astype(
            np.float32)
    items = worded_items(make_synthetic_dataset(
        graphs, 4 * SPK_BATCH, vocab_size=vocab, path_len=(4, 7),
        seed=seed), vocab, seed + 1)
    sp = Speaker(SpeakerConfig(vocab_size=vocab, max_decode=120), "cuda",
                 seed=seed)
    return sp, graphs, feats, offsets, items, vocab


def speaker_train_batch(sp, graphs, feats, offsets, items):
    """The CLI's speaker training batch (`speaker_batch` at R2R's 15 path
    steps and 60 tokens) on the speaker's device."""
    from vln_goat_tpu_torch.speaker.speaker import speaker_batch

    return speaker_batch(sp, graphs, feats, offsets, items, SPK_STEPS_MAX,
                         SPK_LEN)


def speaker_phase(card):
    """Phase 5 (t): the speaker on the card at its published width: the
    deterministic loss of one batch of 64 against the same computation on
    the CPU (TF32 off, within 1e-4 relative); SPK_STEPS Adam steps at batch
    64 (the loss falling: the mean of the last five under the first
    five's); a greedy decode of 64 paths to 120 tokens; ms a step, decode
    seconds, peak memory.  Returns (numbers, failure or None, the trained
    speaker's rig)."""
    from vln_goat_tpu_torch.speaker.speaker import Speaker

    rig = speaker_rig()
    sp, graphs, feats, offsets, items, vocab = rig
    nums, failure = {}, None
    try:
        batch = speaker_train_batch(sp, graphs, feats, offsets,
                                    items[:SPK_BATCH])
        with torch.no_grad():
            loss = float(sp.loss_fn(batch))
            cpu = Speaker(sp.cfg, "cpu")
            cpu.model.load_state_dict({k: v.cpu() for k, v in
                                       sp.model.state_dict().items()})
            ref = float(cpu.loss_fn({k: v.cpu() for k, v in batch.items()}))
        del cpu
        nums["loss"], nums["cpu_loss"] = loss, ref
        if abs(loss - ref) > 1e-4 * abs(ref):
            raise AssertionError(f"card loss {loss} vs CPU {ref}")
        step, _ = sp.make_train_step(lr=SPK_LR)
        gen = torch.Generator(device="cuda").manual_seed(0)
        rng = np.random.default_rng(0)
        batches = [speaker_train_batch(sp, graphs, feats, offsets,
                                       [items[i] for i in rng.integers(
                                           0, len(items), SPK_BATCH)])
                   for _ in range(SPK_STEPS)]
        step(batches[0], gen)                       # warm-up (one step)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses = []
        t0 = time.perf_counter()
        for b in batches:
            losses.append(step(b, gen))
        torch.cuda.synchronize()
        nums["step_ms"] = (time.perf_counter() - t0) / SPK_STEPS * 1e3
        # optax.adam: no clip, so the update's launch alone
        adamw_check("speaker_train", optim.launches, SPK_STEPS,
                    clipped=False)
        nums["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        nums["losses"] = [float(v) for v in losses]
        if not all(math.isfinite(v) for v in nums["losses"]) or \
                np.mean(nums["losses"][-5:]) >= np.mean(nums["losses"][:5]):
            raise AssertionError(f"losses {nums['losses']} did not fall")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        toks = sp.infer(batch, max_decode=120)
        torch.cuda.synchronize()
        nums["decode_s"] = time.perf_counter() - t0
        nums["decode_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        toks = toks.cpu().numpy()
        ends = [int(np.argmax(r == sp.cfg.eos_id)) + 1
                if (r == sp.cfg.eos_id).any() else 120 for r in toks]
        nums["decoded_len"] = (min(ends), max(ends))
        if toks.shape != (SPK_BATCH, 120) or toks.min() < 0 or \
                toks.max() >= vocab:
            raise AssertionError(f"decode {toks.shape}, ids "
                                 f"{toks.min()}..{toks.max()}")
    except AssertionError as exc:
        failure = f"speaker (t): {exc}"
    say(f"speaker (t) at hidden 512 / word 256 / 4 x 64 heads / 3 layers / "
        f"FFN 1024, vocabulary {vocab}, batch {SPK_BATCH}: loss "
        f"{nums.get('loss', float('nan')):.6f} vs CPU "
        f"{nums.get('cpu_loss', float('nan')):.6f}; {SPK_STEPS} Adam steps "
        f"(lr {SPK_LR}) {nums.get('step_ms', float('nan')):.1f} ms a step, "
        f"peak {nums.get('train_peak_gib', float('nan')):.2f} GiB, losses "
        f"{[round(v, 4) for v in nums.get('losses', [])]}; greedy decode of "
        f"{SPK_BATCH} paths to 120 tokens {nums.get('decode_s', float('nan')):.3f}"
        f" s (lengths to <EOS> {nums.get('decoded_len')}, peak "
        f"{nums.get('decode_peak_gib', float('nan')):.2f} GiB) on {card}")
    if failure is not None:
        say(f"speaker (t): FAILED: {failure} (the script goes on, and fails "
            "at its end)")
    return nums, failure, rig


def backtranslated_batch(rig):
    """batch_fn for kernel_vs_eager: the CLI's fused aug batch
    (`cli.aug_batch`): two minibatches of BT_HALF items from the train
    batcher re-captioned by the speaker in one pass under one shared
    noise vector at R2R's feature dropout 0.4 (the build's own dropouts
    stay 0), fused, the noise in `feat_noise`."""
    from vln_goat_tpu_torch import cli

    sp = rig[0]

    def batch_fn(state, batcher):
        graphs = batcher.scan_graphs
        rt = dict(graphs=graphs, banks={}, world=state.rollout.world,
                  scan_order=sorted(batcher.scan_index,
                                    key=batcher.scan_index.get),
                  cfg=state.model.config.replace(feat_dropout=0.4))
        items = batcher.next_minibatch() + batcher.next_minibatch()
        return cli.aug_batch(rt, batcher, sp, items, 7_000_003, fused=True)

    return batch_fn


def backtranslation_phase(card, rig):
    """Phase 5 (u): one back-translated dagger_fused update (two minibatches
    of BT_HALF, re-captioned, the shared noise in the batch) through the
    kernels against eager under phase 5 (a)'s gates (kernel_vs_eager,
    dropout 0, the ReLU pinning, the launches of the plan); then the CLI:
    `--mode speaker` for 4 iterations at R2R width and `train
    --use_transpeaker --speaker_ckpt_file <its speaker_best> --aug
    synthetic --z_instr_update --update_iter 1` for 2 iterations (worded
    synthetic instructions, so the refresh picks words).  Returns
    (numbers, failures)."""
    from vln_goat_tpu_torch import cli
    from vln_goat_tpu_torch.rollout import env as penv

    step = {}
    failures = [kernel_vs_eager(
        "train (u)", "back-translated dagger_fused step (2 x "
        f"{BT_HALF}, shared feature noise)",
        dict(tcfg=TrainConfig(train_alg="dagger_fused", weight_decay=0.01)),
        batch_fn=backtranslated_batch(rig), batch_size=BT_HALF,
        record=step)]
    gc.collect()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="chip_smoke_bt_")
    orig = penv.make_synthetic_dataset
    nums = dict(step_counts=step.get("counts", (0, 0, 0, 0)))

    def worded(graphs, n, vocab_size=1000, **kw):
        return worded_items(orig(graphs, n, vocab_size=vocab_size, **kw),
                            vocab_size, seed=kw.get("seed", 0) + 100)

    common = ["--synthetic", "--use_pallas", "--batch_size", "8",
              "--device", "cuda", "--output_dir", out]
    try:
        penv.make_synthetic_dataset = worded
        reset_counts()
        t0 = time.perf_counter()
        cli.main(["--mode", "speaker", "--speaker_iters", "4",
                  "--log_every", "20"] + common)
        nums["speaker_s"] = time.perf_counter() - t0
        nums["speaker_log"] = [line.strip() for line in
                               open(os.path.join(out, "speaker.log"))]
        reset_counts()
        t0 = time.perf_counter()
        cli.main(["--mode", "train", "--iters", "2", "--log_every", "2",
                  "--aug", "synthetic", "--use_transpeaker",
                  "--speaker_ckpt_file", os.path.join(out, "speaker_best"),
                  "--z_instr_update", "--update_iter", "1"] + common)
        nums["train_s"] = time.perf_counter() - t0
        nums["train_counts"] = counts()
        log = open(os.path.join(out, "train.log")).read()
        nums["log"] = [line.strip() for line in log.splitlines()
                       if "iter" in line or "z-dict" in line]
        losses = [json.loads(line)["train/loss"] for line in
                  open(os.path.join(out, "metrics.jsonl"))
                  if "train/loss" in line]
        nums["losses"] = losses
        if len(nums["speaker_log"]) != 2:
            raise AssertionError(f"speaker.log {nums['speaker_log']}")
        if not os.path.exists(os.path.join(out, "speaker_best",
                                           "params.pt")):
            raise AssertionError("no speaker_best")
        if not losses or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"losses {losses}")
        if min(nums["train_counts"][:3]) <= 0:
            raise AssertionError(f"launches {nums['train_counts']}: K1 and "
                                 "K2 must launch")
        if "z-dict refreshed" not in log or \
                "z-dict refreshed: 0 landmarks" in log or not os.path.exists(
                    os.path.join(out, "backdoor_update_features.tsv")):
            raise AssertionError("the z-dict refresh picked nothing")
    except AssertionError as exc:
        failures.append(f"train (u) CLI: {exc}")
        say(f"train (u) CLI: FAILED: {exc} (the script goes on, and fails "
            "at its end)")
    finally:
        penv.make_synthetic_dataset = orig
        shutil.rmtree(out, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    say(f"train (u) CLI at R2R width (--synthetic --use_pallas, batch 8): "
        f"--mode speaker 4 iterations {nums.get('speaker_s', 0):.1f} s "
        f"({nums.get('speaker_log')}); train --use_transpeaker --aug "
        f"synthetic --z_instr_update --update_iter 1, 2 iterations "
        f"{nums.get('train_s', 0):.1f} s (launches "
        f"{nums.get('train_counts')}; losses {nums.get('losses')}; "
        f"{nums.get('log')}) on {card}")
    return nums, [f for f in failures if f is not None]


# ----------------------------------------------------------------------
# phase 5 (v): more than one process (parallel/) and the native library
DP_STEPS = 3           # (i): updates of each run
DP_GLOBAL = 16         # (ii): the global batch of the two ranks, 8 each
DP_PT_BATCH = 8        # (ii): the pretraining batch, 4 each
DP_TIMEOUT_S = 300     # (ii): the spawned ranks' limit


def native_phase(card):
    """Phase 5 (v) (iii): the port's native library built with g++ here,
    its token blocks equal to the numpy path in every break mode (random
    sentence lengths, block sizes and parameters).  Returns (numbers,
    failure or None)."""
    from vln_goat_tpu_torch.data import token_block as tb
    from vln_goat_tpu_torch.native import lib

    # a build from nothing, timed, into a directory of its own; the path
    # below loads the library of the port's build directory
    with tempfile.TemporaryDirectory() as fresh:
        t0 = time.perf_counter()
        path = lib.build(fresh)
        built = time.perf_counter() - t0
    try:
        if not lib.available():
            raise AssertionError("the native library did not load")
        rng = np.random.default_rng(0)
        cases = 0
        for mode in ("none", "eos", "complete", "complete_doc"):
            for trial in range(50):
                sizes = rng.integers(0, 40, int(rng.integers(0, 2000)))
                mx = int(rng.integers(1, 4))
                kw = dict(document_sep_len=int(rng.integers(1, 3)),
                          block_multiple_min=int(rng.integers(1, 3)),
                          block_multiple_max=mx,
                          block_sizes=rng.integers(1, 600, len(sizes) + 2)
                          if mx > 1 else None)
                bs = int(rng.integers(1, 512))
                ref = tb.token_block_slices(sizes, bs, mode,
                                            use_native=False, **kw)
                got = tb.token_block_slices(sizes, bs, mode,
                                            use_native=True, **kw)
                if not np.array_equal(got, ref):
                    raise AssertionError(f"{mode}: token_block_slices "
                                         f"differs (trial {trial})")
                if not np.array_equal(
                        tb.block_to_dataset_index(sizes, ref, True),
                        tb.block_to_dataset_index(sizes, ref, False)):
                    raise AssertionError(f"{mode}: block_to_dataset_index "
                                         f"differs (trial {trial})")
                cases += 1
    except AssertionError as exc:
        say(f"native (v iii): FAILED: {exc}")
        return {}, f"native (v iii): {exc}"
    say(f"native (v iii): {path.name} built by g++ in {built:.1f} s; "
        f"token_block_slices and block_to_dataset_index equal to the numpy "
        f"path in {cases} cases over the four break modes, on {card}")
    return dict(build_s=built, cases=cases), None


def dp_updates(state, batches, mesh):
    """DP_STEPS updates of `state` on `batches` (each the rank's rows by
    `shard_batch` of `mesh`), the generator seeded 0 -> (losses, ms of
    each update by the host clock around a synchronised update)."""
    from vln_goat_tpu_torch.parallel.mesh import shard_batch

    g = torch.Generator(device="cuda").manual_seed(0)
    losses, ms = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = state.step_fn(state, shard_batch(batch, mesh), g)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    return losses, ms


def world_of_one(card):
    """Phase 5 (v) (i): DP_STEPS DAgger updates of the bench's step (R2R
    width, batch 64, float32, the kernels, dropout on) in a process group
    of one over nccl, through `shard_batch` and `all_reduce_grads`,
    against the same updates with no group from the same weights, batches
    and generator seed, under torch's deterministic algorithms: losses
    and every parameter bit for bit.  Where they differ, a third run
    without a group tells a change made by the group (the plain path
    repeats itself bit for bit: a failure) from a plain path that does not
    repeat itself (then the group's distance is held to twice the plain
    path's own, and the line says so).  The kernels' launches of the
    group's updates are counted.  Returns (numbers, failure or None)."""
    import socket
    from vln_goat_tpu_torch.parallel import distributed as pdist
    from vln_goat_tpu_torch.parallel.mesh import make_mesh

    state, batcher = build_train_flagship("cuda")
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    batches = [batcher.next_batch()[1] for _ in range(DP_STEPS)]

    def run(group):
        state.model.load_state_dict(sd)
        fresh = init_train_state(
            state.model, state.rollout, weight_decay=0.01,
            teacher_horizon="auto", remat="none",
            mesh=make_mesh("cuda") if group else None)
        out = dp_updates(fresh, batches, fresh.mesh)
        params = {k: v.detach().clone()
                  for k, v in state.model.named_parameters()}
        return out, params

    # scatter_add / index_put with accumulate (the rollout's) take their
    # deterministic CUDA algorithms, so that two runs can agree bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    (plain_l, plain_ms), plain_p = run(False)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    pdist.init_distributed(f"localhost:{port}", 1, 0, device="cuda",
                           always=True, timeout_s=120)
    try:
        backend = torch.distributed.get_backend()
        reset_counts()
        (dp_l, dp_ms), dp_p = run(True)
        torch.cuda.synchronize()
        launches = counts()
    finally:
        pdist.shutdown()
    failure, note = None, "bit for bit"
    try:
        if backend != "nccl":
            raise AssertionError(f"backend {backend}, not nccl")
        if min(launches[:3]) == 0:
            raise AssertionError(f"the kernels were not launched: "
                                 f"{launches}")
        diff = max(float((dp_p[k] - v).abs().max())
                   for k, v in plain_p.items())
        if dp_l != plain_l or diff:
            # a second run without a group: does the plain path repeat?
            (again_l, _), again_p = run(False)
            spread = max(float((again_p[k] - v).abs().max())
                         for k, v in plain_p.items())
            if again_l == plain_l and spread == 0.0:
                raise AssertionError(
                    f"the group of one changed the result: losses {dp_l} "
                    f"vs {plain_l}, parameters up to {diff:.3e}")
            l_diff = max(abs(a - b) for a, b in zip(dp_l, plain_l))
            l_spread = max(abs(a - b) for a, b in zip(again_l, plain_l))
            # not bit for bit on either side: the group's distance held
            # to twice the plain path's own
            if diff > 2 * spread or l_diff > 2 * l_spread:
                raise AssertionError(
                    f"beyond twice the plain path's own spread: "
                    f"parameters {diff:.3e} vs {spread:.3e}, losses "
                    f"{l_diff:.3e} vs {l_spread:.3e}")
            note = (f"not bit for bit: {diff:.3e} (losses {l_diff:.3e}), "
                    f"where the plain path differs from itself by "
                    f"{spread:.3e} ({l_spread:.3e})")
    except AssertionError as exc:
        failure = f"world of one (v i): {exc}"
        say(f"world of one (v i): FAILED: {exc}")
    finally:
        torch.use_deterministic_algorithms(False)
    del state, batcher, sd
    gc.collect()
    torch.cuda.empty_cache()
    say(f"world of one (v i): {DP_STEPS} DAgger updates at R2R width, batch "
        f"{B_TRAIN}, float32, kernels, dropout on: a group of one over "
        f"{backend} (shard_batch, all_reduce_grads, reduce_metrics) against "
        f"no group: losses {['%.6f' % x for x in dp_l]}, parameters "
        f"{note}; ms per update (host clock, synchronised) group "
        f"{['%.1f' % x for x in dp_ms]} / no group "
        f"{['%.1f' % x for x in plain_ms]}; launches {launches} on {card}")
    return dict(counts=launches, ms=dp_ms, plain_ms=plain_ms), failure


def params_rule(got, ref, ref_grads, got_grads, lr, eps):
    """test_torch_causal_train.py's rule for the parameters after one
    update, its slack derived from the gradients' measured difference on
    the card: each parameter within 1e-6 of its tensor's largest
    magnitude, plus lr times how far that difference d (the tensor's
    largest) can move AdamW's first step, which divides a gradient by its
    own size plus `eps` (eps over the clip's factor where the clip acts):
    2 where |g| <= d (the sign not fixed, the CPU rule's 2 lr), else at
    most eps d / (|g| - d + eps)^2.  Returns None, or what fell outside:
    the parameter, the element's distance, its tolerance, its two
    gradients."""
    for name, r in ref.items():
        g = ref_grads.get(name)
        g = torch.zeros_like(r) if g is None else g
        gg = got_grads.get(name)
        gg = torch.zeros_like(r) if gg is None else gg
        d = float((gg - g).abs().max())
        a = g.abs()
        step = torch.where(a <= d, torch.full_like(a, 2.0),
                           (eps * d / (a - d + eps) ** 2).clamp(max=2.0))
        tol = 1e-6 * float(r.abs().max()) + lr * step
        dist = (got[name].detach() - r).abs()
        if not bool((dist <= tol).all()):
            k = int((dist - tol).argmax())
            return (f"{name}[{k}]: {float(dist.flatten()[k]):.3e} > "
                    f"{float(tol.flatten()[k]):.3e}, gradients "
                    f"{float(g.flatten()[k]):.3e} / "
                    f"{float(gg.flatten()[k]):.3e} (d {d:.3e})")
    return None


def _dp_compare(ref, got, lr, clip, noise, what):
    """The rank's update against the one-process one: the loss within 1e-6
    relative, the gradients within phase 5 (a)'s gate (1e-3 of their
    scale, `noise` at their weight's), the parameters by `params_rule`
    (AdamW's eps 1e-8 over the global-norm clip's factor at `clip`).
    Raises AssertionError; returns the worst gradient's ratio."""
    (r_loss, r_grads, r_params), (g_loss, g_grads, g_params) = ref, got
    if abs(g_loss - r_loss) > 1e-6 * abs(r_loss):
        raise AssertionError(f"{what}: loss {g_loss} vs {r_loss}")
    full = {n: g_grads.get(n, torch.zeros_like(v)) for n, v in r_grads.items()}
    worst, name = worst_grad(full, r_grads, noise)
    if worst > 1e-3:
        raise AssertionError(f"{what}: grad {name} {worst:.3e} of its scale")
    norm = math.sqrt(sum(float((g.double() ** 2).sum())
                         for g in r_grads.values()))
    eps = 1e-8 * max(1.0, norm / clip)
    bad = params_rule(g_params, r_params, r_grads, g_grads, lr, eps)
    if bad:
        raise AssertionError(f"{what}: parameter {bad} outside the rule")
    return worst


def dp_rank(rank, world, port, out):
    """Phase 5 (v) (ii), one rank of two on the one card over gloo: the
    imitation update (R2R width, dropout 0) on its 8 rows of a batch of 16
    and the MLM and CFP pretraining updates on its 4 rows of a batch of 8,
    each after rank 0 ran it in one process on the whole batch from the
    same weights; rank 0 holds its update to that one, every rank its
    parameters to rank 0's.  Puts (rank, numbers or None, error or None)
    on `out`."""
    import traceback
    from vln_goat_tpu_torch.parallel import distributed as pdist
    from vln_goat_tpu_torch.parallel.mesh import (make_mesh, replicate_tree,
                                                  shard_batch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        pdist.init_distributed(f"localhost:{port}", world, rank,
                               backend="gloo", device="cuda", timeout_s=240)
        mesh = make_mesh("cuda")
        nums = {}

        def same_as_rank0(model):
            for p in model.parameters():
                t = p.detach().clone()
                pdist.broadcast_tensor(t, src=0)
                if not torch.equal(t, p.detach()):
                    return False
            return True

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return r, (time.perf_counter() - t0) * 1e3

        # the fine-tune imitation update
        state, batcher = build_train_flagship(
            "cuda", batch_size=DP_GLOBAL, dropout=False,
            tcfg=TrainConfig(train_alg="imitation", weight_decay=0.01))
        replicate_tree(state.model)
        sd = {k: v.clone() for k, v in state.model.state_dict().items()}
        batch = batcher.next_batch()[1]
        lr = state.optimizer.param_groups[0]["lr"]
        g = torch.Generator(device="cuda")
        ref = None
        if rank == 0:
            (m, grads, _), ms = timed(lambda: state.step_fn(
                state, batch, g.manual_seed(0), keep=True))
            ref = (float(m["loss"]), grads,
                   {k: v.detach().clone()
                    for k, v in state.model.named_parameters()})
            nums["ft_one_ms"] = ms
            state.model.load_state_dict(sd)
        state = init_train_state(
            state.model, state.rollout, lr=lr, weight_decay=0.01,
            train_alg="imitation", teacher_horizon="auto", remat="none",
            mesh=mesh)
        torch.distributed.barrier()
        reset_counts()
        (m, grads, _), ms = timed(lambda: state.step_fn(
            state, shard_batch(batch, mesh), g.manual_seed(0), keep=True))
        nums["ft_counts"] = counts()
        nums["ft_ms"] = ms
        nums["ft_loss"] = float(m["loss"])
        if rank == 0:
            nums["ft_worst"] = _dp_compare(
                ref, (float(m["loss"]), grads,
                      dict(state.model.named_parameters())),
                lr, state.grad_clip,
                NOISE_GRAD_BIASES + TEACHER_NOISE_BIASES, "fine-tune")
        nums["ft_replicas_equal"] = same_as_rank0(state.model)
        del state, batcher, sd, ref, grads
        gc.collect()
        torch.cuda.empty_cache()

        # MLM (the global counts) and CFP (the gathered negatives)
        from vln_goat_tpu_torch.pretrain.cli import (batch_to_device,
                                                     make_batch_np)
        from vln_goat_tpu_torch.config import PretrainConfig
        from vln_goat_tpu_torch.pretrain.train import (
            PretrainState, make_pretrain_optimizer, make_pretrain_steps)

        args, rt = pretrain_rig("r2r", ("mlm", "cfp"), True, False,
                                batch=DP_PT_BATCH)
        model = rt["model"]
        replicate_tree(model)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        # no warm-up: the first update at the full rate (5e-5), so that
        # the parameters' rule sees it move them
        pcfg = PretrainConfig(warmup_steps=0)
        for task in ("mlm", "cfp"):
            nb = make_batch_np(rt["builder"], rt["items"]["train"],
                               DP_PT_BATCH, args.seed, "train", task, 0)
            if rank == 0:
                model.load_state_dict(sd)
                model.mesh = None
                st = PretrainState(model, make_pretrain_optimizer(pcfg,
                                                                  model))
                step = make_pretrain_steps(model, (task,))[task]
                (m, grads), ms = timed(lambda: step(
                    st, batch_to_device(nb, torch.device("cuda")),
                    g.manual_seed(0), keep=True))
                ref = (float(m["loss"]), grads,
                       {k: v.detach().clone()
                        for k, v in model.named_parameters()})
                nums[f"{task}_one_ms"] = ms
            model.load_state_dict(sd)
            model.mesh = mesh
            st = PretrainState(model, make_pretrain_optimizer(pcfg, model))
            step = make_pretrain_steps(model, (task,), mesh)[task]
            torch.distributed.barrier()
            reset_counts()
            (m, grads), ms = timed(lambda: step(
                st, batch_to_device(shard_batch(nb, mesh),
                                    torch.device("cuda")),
                g.manual_seed(0), keep=True))
            nums[f"{task}_counts"] = counts()
            nums[f"{task}_ms"] = ms
            nums[f"{task}_loss"] = float(m["loss"])
            if rank == 0:
                nums[f"{task}_worst"] = _dp_compare(
                    ref, (float(m["loss"]), grads,
                          dict(model.named_parameters())),
                    float(pcfg.learning_rate), pcfg.grad_norm, PT_NOISE,
                    task)
            nums[f"{task}_replicas_equal"] = same_as_rank0(model)
        out.put((rank, nums, None))
    except BaseException:
        out.put((rank, None, traceback.format_exc()))
    finally:
        pdist.shutdown()


def two_ranks(card):
    """Phase 5 (v) (ii): `dp_rank` in two spawned processes on the one
    card over gloo (nccl takes one rank a card), joined within
    DP_TIMEOUT_S and killed after it.  Returns (numbers, failure or
    None)."""
    import multiprocessing
    import queue
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=dp_rank, args=(r, 2, port, out))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    res, errors = {}, []
    try:
        for _ in procs:
            rank, nums, err = out.get(timeout=DP_TIMEOUT_S)
            res[rank] = nums
            if err:
                errors.append(f"rank {rank}: {err}")
    except queue.Empty:
        errors.append(f"no result within {DP_TIMEOUT_S} s from ranks "
                      f"{sorted(set(range(2)) - set(res))}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    failure = None
    if not errors:
        for rank, nums in res.items():
            for key in ("ft", "mlm", "cfp"):
                if min(nums[f"{key}_counts"][:3]) == 0:
                    errors.append(f"rank {rank} {key}: kernels not "
                                  f"launched {nums[f'{key}_counts']}")
                if not nums[f"{key}_replicas_equal"]:
                    errors.append(f"rank {rank} {key}: parameters differ "
                                  "from rank 0's")
    if errors:
        for e in errors:
            for line in str(e).splitlines():
                say(f"two ranks (v ii): {line}")
        failure = "two ranks (v ii): " + str(errors[0]).splitlines()[-1]
        say(f"two ranks (v ii): FAILED: {failure}")
        return {}, failure
    r0, r1 = res[0], res[1]
    say(f"two ranks (v ii), gloo on the one card, spawned ({wall:.1f} s): "
        f"imitation update at R2R width, dropout 0, batch {DP_GLOBAL} (8 a "
        f"rank) against one process at {DP_GLOBAL}: loss "
        f"{r0['ft_loss']:.6f} within 1e-6, gradients within "
        f"{r0['ft_worst']:.2e} of their scale, parameters by the causal "
        f"rule, replicas equal; ms per update {r0['ft_ms']:.1f} / "
        f"{r1['ft_ms']:.1f} (ranks) vs {r0['ft_one_ms']:.1f} (one process);"
        f" launches {r0['ft_counts']} on {card}")
    for task in ("mlm", "cfp"):
        say(f"two ranks (v ii): pretraining {task} at R2R width, batch "
            f"{DP_PT_BATCH} (4 a rank) against one process: loss "
            f"{r0[task + '_loss']:.6f} within 1e-6, gradients within "
            f"{r0[task + '_worst']:.2e} of their scale, parameters by the "
            f"rule, replicas equal; ms per update "
            f"{r0[task + '_ms']:.1f} / {r1[task + '_ms']:.1f} vs "
            f"{r0[task + '_one_ms']:.1f}; launches {r0[task + '_counts']} "
            f"(gloo stages every collective through the host: no "
            f"yardstick) on {card}")
    return dict(rank0=r0, rank1=r1, wall_s=wall), None


def multiprocess_phase(card):
    """Phase 5 (v): (iii) the native library, (i) a group of one over nccl,
    (ii) two ranks over gloo.  Returns (numbers, [failures])."""
    n_nums, n_failed = native_phase(card)
    i_nums, i_failed = world_of_one(card)
    ii_nums, ii_failed = two_ranks(card)
    return (dict(native=n_nums, counts=i_nums.get("counts", (0, 0, 0, 0)),
                 one=i_nums, two=ii_nums),
            [n_failed, i_failed, ii_failed])


def goat_r2r_models(dev):
    """(fine-tune model, pretraining model) of the benchmark's goat-r2r
    configuration (`perfbench/configs/goat-r2r.json`), weights N(0, 0.05)."""
    from vln_goat_tpu_torch.config import GoatConfig
    from vln_goat_tpu_torch.models.goat import GoatModel
    from vln_goat_tpu_torch.pretrain.model import GoatPretrainModel
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "perfbench", "configs", "goat-r2r.json")) as f:
        cfg = json.load(f)
    pt = cfg["pretrain"]
    with torch.device("meta"):
        ft = GoatModel(GoatConfig.for_dataset(
            cfg["dataset"], **cfg["model"], **cfg["finetune_flags"]))
        pm = GoatPretrainModel(
            GoatConfig.for_dataset(cfg["dataset"], **cfg["model"]),
            tuple(pt["tasks"]), pt["mrc_prob_dim"])
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for model in (ft, pm):
        model = model.to_empty(device=dev)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(0.05 * torch.randn(p.shape, generator=g,
                                           device=dev))
        out.append(model)
    return out, cfg


def adamw_rows(card):
    """Phase 5 (x): the fused AdamW (`ops/csrc/adamw.cu`, `ops.optim`) at
    both cells' leaf sets: the fine-tune AdamW over the causal R2R model's
    trainable parameters (clip 40) and the pretraining adamw chain over
    the pretraining model's leaves (in_proj split, decay mask, clip 5),
    every leaf with a gradient.  Per update: the two launches' device ms
    (CUDA events over 20 updates of one table), the call's host us (20
    calls, one synchronise after them) and its ms with a synchronise;
    the bytes bound (32 bytes an element at 3.35 TB/s); the plain loop on
    the card (`clip_adamw_plain`, the loops the kernels replaced): ms with
    its read of the norm, and device ms without the clip, from a CUDA graph
    (no host gaps); torch.optim.AdamW(fused=True) after
    clip_grad_norm_(foreach=True) as the library's yardstick (events over
    20 updates), which the port never calls.  Before that yardstick, the
    kernels held against the plain version (`adamw_held`) with the clip
    engaged (the seeded gradients as they are) and not (scaled by 1e-6).
    Returns
    ({set: numbers}, [failures])."""
    from vln_goat_tpu_torch.config import PretrainConfig
    from vln_goat_tpu_torch.pretrain.train import (PretrainState,
                                                   make_pretrain_optimizer)
    from vln_goat_tpu_torch.train.trainer import make_optimizer
    dev = "cuda"
    (ft, pm), cfg = goat_r2r_models(dev)
    pt = cfg["pretrain"]
    g = torch.Generator(device=dev).manual_seed(1)
    nums, failures = {}, []
    for name, model in (("finetune", ft), ("pretrain", pm)):
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = torch.randn(p.shape, generator=g, device=dev)
        if name == "finetune":
            opt, _ = make_optimizer(params, lr=2e-5, weight_decay=0.01)
            step = lambda: opt.step(max_norm=40.0)  # noqa: E731
        else:
            state = PretrainState(model, make_pretrain_optimizer(
                PretrainConfig(tasks=tuple(pt["tasks"]),
                               learning_rate=pt["learning_rate"],
                               warmup_steps=0, grad_norm=pt["grad_norm"],
                               optim=pt["optim"], betas=tuple(pt["betas"]),
                               weight_decay=pt["weight_decay"]), model))
            step = lambda: state.apply(state.leaf_grads())  # noqa: E731
        # the groups as the call builds them, for the raw launches and the
        # plain loop
        seen = []
        real = optim.clip_adamw_
        optim.clip_adamw_ = lambda groups, *a, **k: seen.append(
            (groups, a, k))
        step()
        optim.clip_adamw_ = real
        groups, a, k = seen[0]
        max_norm = a[0] if a else k.get("max_norm")
        at_max = k.get("clip_at_max", False)
        n = sum(p.numel() for grp in groups for p in grp.params)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        lib = optim._lib()
        rows, spans, gitems = optim.table_rows(groups)
        tab = torch.tensor(rows, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        norm = torch.empty((), device=dev)

        def launches():
            parts = optim._norm_launch(lib, tab, len(rows) // optim.COLS,
                                       gitems, dev, stream)
            for grp, sp in zip(groups, spans):
                optim._update_launch(lib, grp.params[0].dtype, tab, sp, parts,
                                     norm, grp, 2 if at_max else 1, max_norm,
                                     stream)

        dev_ms = cuda_ms(launches)
        before = dict(optim.launches)
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        per = {k: (optim.launches[k] - before[k]) / 20 for k in before}

        def synced():
            step()
            torch.cuda.synchronize()

        call_ms = cuda_ms(synced, iters=10)
        plain_ms = cuda_ms(lambda: optim.clip_adamw_plain(
            groups, max_norm, at_max), iters=3, warmup=1)
        plain_dev_ms = graph_ms(lambda: optim.clip_adamw_plain(groups),
                                reps=2)
        # before the library's clip, which scales the gradients in place
        held = {}
        for scale in (1.0, 1e-6):
            if scale != 1.0:
                with torch.no_grad():
                    for gr in (gr for grp in groups for gr in grp.grads):
                        gr.mul_(scale)
            h = held[scale] = adamw_held(groups, max_norm, at_max)
            if h["clipped"] != (scale == 1.0) and not h["failure"]:
                h["failure"] = ("the clip " + ("did not engage" if scale
                                               == 1.0 else "engaged")
                                + f" at norm {h['norm']}")
            if h["failure"]:
                failures.append(f"adamw (x) {name} x{scale}: {h['failure']}")
        lib_opt = torch.optim.AdamW(params, lr=2e-5, weight_decay=0.01,
                                    fused=True)

        def library():
            torch.nn.utils.clip_grad_norm_(params, 40.0, foreach=True)
            lib_opt.step()

        lib_ms = cuda_ms(library)
        bound_ms = 32 * n / 3.35e12 * 1e3
        nums[name] = dict(leaves=sum(len(grp.params) for grp in groups),
                          elements=n, device_ms=dev_ms, host_us=host_us,
                          call_ms=call_ms, bound_ms=bound_ms,
                          plain_ms=plain_ms, plain_device_ms=plain_dev_ms,
                          library_ms=lib_ms, launches=per,
                          max_abs_err=max(max(h["err"].values())
                                          for h in held.values()),
                          norm_rel=max(h["norm_rel"] for h in held.values()),
                          held=held)
        say(f"adamw {name}: {nums[name]['leaves']} leaves, {n} elements; "
            f"kernel device {dev_ms:.4f} ms (bound {bound_ms:.4f}, bytes, "
            f"{100 * bound_ms / dev_ms:.1f}%), call {call_ms:.3f} ms "
            f"synchronised, host {host_us:.0f} us, launches {per}; plain "
            f"{plain_ms:.2f} ms, its device {plain_dev_ms:.3f} ms without "
            f"the clip; library (clip_grad_norm_ foreach + AdamW fused) "
            f"{lib_ms:.4f} ms; against the plain version: "
            + "; ".join(f"x{sc} norm {h['norm']:.6g} (clip "
                        f"{'engaged' if h['clipped'] else 'not engaged'}, "
                        f"{h['norm_rel']:.3e} from float64), max abs err "
                        + ", ".join(f"{k} {v:.3e}"
                                    for k, v in h["err"].items())
                        for sc, h in held.items()) + f" on {card}")
        del lib_opt, groups, seen
        for p in params:
            p.grad = None
    del ft, pm
    torch.cuda.empty_cache()
    for f in failures:
        say(f"{f} (the script goes on, and fails at its end)")
    return nums, failures


@torch.no_grad()
def adamw_held(groups, max_norm, at_max):
    """One update of `groups` by the kernels (`optim.clip_adamw_`) and one
    by the plain version (`clip_adamw_plain`, clipping by the kernels'
    norm) on copies of the same leaves and moments: {"err": the largest
    abs difference of p / mu / nu (0: bit-equal, as the kernels are built
    to be), "norm", "norm_rel": its distance from the float64 norm of the
    same gradients over that norm, "clipped", "failure": None, or what
    failed: an error above 0, or norm_rel above 1.5e-7 (the bound
    tests/test_torch_fused_adamw_cuda.py derives)}."""
    twins = [dataclasses.replace(
        grp, params=[p.clone() for p in grp.params],
        mus=[m.clone() for m in grp.mus], nus=[v.clone() for v in grp.nus])
        for grp in groups]
    norm = optim.clip_adamw_(groups, max_norm, at_max)
    optim.clip_adamw_plain(twins, max_norm, at_max, norm)
    err = {k: max(float((a.double() - b.double()).abs().max())
                  for grp, tw in zip(groups, twins)
                  for a, b in zip(getattr(grp, key), getattr(tw, key)))
           for k, key in (("p", "params"), ("mu", "mus"), ("nu", "nus"))}
    exact = float(torch.sqrt(sum(gr.double().square().sum()
                                 for grp in groups for gr in grp.grads
                                 if gr is not None)))
    nf = float(norm)
    out = dict(err=err, norm=nf, norm_rel=abs(nf - exact) / exact,
               clipped=(not nf < max_norm) if at_max else nf > max_norm,
               failure=None)
    if any(not v == 0 for v in err.values()):
        out["failure"] = f"kernels differ from the plain version: {err}"
    elif not out["norm_rel"] <= 1.5e-7:
        out["failure"] = (f"norm {nf} is {out['norm_rel']:.3e} from the "
                          f"float64 norm {exact}")
    return out


def adamw_kernel_rows(nums):
    """The kernel line's rows of the fused AdamW (`PERF.md` row A1), one a
    leaf set: the launches the main train paths made (`ADAMW_LAUNCHES`:
    fine-tuning and the speaker at the fine-tune row, pretraining's tasks
    at the pretraining row), the largest error against the plain version,
    and 5 (x)'s times: ms the two launches' device time (CUDA events),
    plain the loop with its read of the norm, library clip_grad_norm_ +
    AdamW(fused=True), bound 32 bytes an element at 3.35 TB/s."""
    rows = []
    for name, r in nums.items():
        by_path = {k: sum(v.values()) for k, v in ADAMW_LAUNCHES.items()
                   if k.startswith("pretrain_") == (name == "pretrain")}
        rows.append(dict(
            name=f"adamw_{name}", route="cuda",
            source="vln_goat_tpu_torch/ops/csrc/adamw.cu",
            replaces=("vln_goat_tpu/pretrain/train.py:57 "
                      "make_pretrain_optimizer" if name == "pretrain" else
                      "vln_goat_tpu/train/trainer.py:74 make_optimizer")
            + " (optax clip_by_global_norm + adamw, left to XLA)",
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=r["max_abs_err"], norm_rel_err=r["norm_rel"],
            ms=r["device_ms"], call_ms=r["call_ms"], plain_ms=r["plain_ms"],
            plain_device_ms=r["plain_device_ms"], bound_ms=r["bound_ms"],
            bound_by="bytes", library_ms=r["library_ms"],
            leaves=r["leaves"], elements=r["elements"]))
    return rows


# the phase running now (`start_phase`), named with the error of a phase
# that raises (`run`)
CURRENT_PHASE = ["1 (device)"]


def start_phase(name: str) -> float:
    """Marks the start of phase `name`; returns its start time."""
    CURRENT_PHASE[0] = name
    return time.perf_counter()


def run() -> int:
    """main(), and an error that leaves it printed with the phase that
    raised it (its name, the error and the traceback, on the standard
    output) before the failure summary; exits non-zero."""
    try:
        return main()
    except BaseException as exc:
        if isinstance(exc, SystemExit):
            raise
        import traceback
        say(f"phase {CURRENT_PHASE[0]} raised {type(exc).__name__}: {exc}")
        traceback.print_exc(file=sys.stdout)
        say(f"FAILED: phase {CURRENT_PHASE[0]}: {type(exc).__name__}: "
            f"{exc}")
        return 1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    say(card)
    say(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = start_phase("2 (build)")
    _build.load_all()
    say(f"build: {', '.join(_build.KERNELS)} in "
        f"{time.perf_counter() - t0:.1f} s (in parallel)")
    for name, rec in _build.build_log.items():
        for line in rec["log"].splitlines():
            if ("registers" in line or "spill" in line or "entry" in line) \
                    and "C7519" not in line:
                say(f"  ptxas {name}: {line.strip()}")
    _bwd_lib()
    lib = _build.load("fused_qkv_mha_bwd")
    smem = (ctypes.c_int * 4)()
    for dh in HEAD_DIMS:
        lib.fused_qkv_mha_bwd_smem(dh, smem)
        say(f"  fused_qkv_mha_bwd dynamic shared memory at head width {dh}: "
            f"GEMM jobs {smem[0]} bytes, attn_bwd_kernel {smem[1]} bytes a "
            f"block; bf16 builds {smem[2]} and {smem[3]} bytes")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = start_phase("phase 3 (float32)")
    rows, train_rows = check_kernels()
    mha_rows = check_mha()
    check_long_f32(torch.Generator(device="cuda").manual_seed(5))
    say(f"wall: phase 3 (float32) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 3 (bf16)")
    b_rows, b_train_rows = check_kernels_bf16()
    b_mha_rows = check_mha_bf16()
    say(f"wall: phase 3 (bf16) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 3 (head widths, phase B rows)")
    w_rows = check_head_widths()
    pb_bf16 = check_phase_b()
    say(f"wall: phase 3 (head widths, phase B rows) "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 3 (m)")
    f6_rows = check_f6_widths()
    say(f"wall: phase 3 (m) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 3 (n)")
    wide_rows = check_f6_wide()
    say(f"wall: phase 3 (n) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 3 (new paths' shapes)")
    shape_rows = new_shape_rows()
    say(f"wall: phase 3 (new paths' shapes) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 3 (o)")
    pt_rows = pretrain_shape_rows()
    say(f"wall: phase 3 (o) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 3 (s)")
    refresh_rows = refresh_shape_rows()
    say(f"wall: phase 3 (s) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 4")
    decode = run_rollouts(card)
    b_decode, d_failed = run_rollouts_bf16(card)
    say(f"wall: phase 4 {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (a, b)")
    mix, train, failed, none_peak = run_train(card)
    say(f"wall: phase 5 (a, b) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (e, f)")
    e_failed = remat_gate(card)
    f_failed = bf16_gate_step(card)
    say(f"wall: phase 5 (e, f) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (h, i)")
    h_failed = vec_teacher_gate(card)
    i_failed = sampled_gates()
    say(f"wall: phase 5 (h, i) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("causal phase 4")
    c_decode = run_rollouts(card, causal=True)
    c_b_decode, cd_failed = run_rollouts_bf16(card, causal=True)
    say(f"wall: causal phase 4 {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (c, d)")
    c_mix, c_train, c_failed, c_none_peak = run_train(card, causal=True)
    say(f"wall: phase 5 (c, d) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (f causal, g causal)")
    cf_failed = bf16_gate_step(card, causal=True)
    cg_mix, cg_train, cg_failed, _ = bench_config(card, True, c_none_peak)
    say(f"wall: phase 5 (f causal, g causal) "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (j)")
    j_mix, j_train, j_failed = fused_bench(card)
    say(f"wall: phase 5 (j) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (k)")
    _, k_failed = remat_policies(card)
    say(f"wall: phase 5 (k) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (l)")
    _, l_failed = cli_phase(card)
    say(f"wall: phase 5 (l) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (w)")
    w_nums, w_failed = wide_cli_phase(card)
    say(f"wall: phase 5 (w) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (m)")
    m_nums, m_failed = reverie_phase(card)
    say(f"wall: phase 5 (m) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (n)")
    n_nums, n_failed = rxr_phase(card)
    say(f"wall: phase 5 (n) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (o)")
    o_nums, o_failed = cfp_phase(card)
    say(f"wall: phase 5 (o) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (p)")
    _, p_failed = cli_datasets_phase(card)
    say(f"wall: phase 5 (p) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (q)")
    _, q_failed = pretrain_gates(card)
    q_timing, qt_failed = pretrain_timing(card)
    say(f"wall: phase 5 (q) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (r)")
    _, r_failed = pretrain_cli_phase(card)
    say(f"wall: phase 5 (r) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (s)")
    s_nums, s_failed = zdict_phase(card)
    say(f"wall: phase 5 (s) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (t)")
    _, t_failed, spk_rig = speaker_phase(card)
    say(f"wall: phase 5 (t) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (u)")
    u_nums, u_failed = backtranslation_phase(card, spk_rig)
    del spk_rig
    say(f"wall: phase 5 (u) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (v)")
    v_nums, v_failed = multiprocess_phase(card)
    say(f"wall: phase 5 (v) {time.perf_counter() - t0:.1f} s")
    t0 = start_phase("phase 5 (x)")
    x_nums, x_failed = adamw_rows(card)
    say(f"wall: phase 5 (x) {time.perf_counter() - t0:.1f} s")
    # the plain bench build last: its profiled step comes after every timed
    # step of the script
    t0 = start_phase("phase 5 (g)")
    teacher_ab(card)
    g_mix, g_train, g_failed, _ = bench_config(card, False, none_peak)
    say(f"wall: phase 5 (g) {time.perf_counter() - t0:.1f} s")

    # one row per kernel: launches by path (decode counts the forward
    # only), and times weighted by the launch mix of both train paths
    mix = add_mix(mix, c_mix)
    total = sum(mix.values())
    by_path = [dict(decode=decode, train=train[i], causal_decode=c_decode,
                    causal_train=c_train[i],
                    backtranslated_train=u_nums["step_counts"][i],
                    dp_train=v_nums["counts"][i])
               for i in range(3)]
    for i in (1, 2):
        by_path[i].update(decode=0, causal_decode=0)

    def avg(key):
        return sum(train_rows[s][key] * w for s, w in mix.items()) / total

    def by(key):
        return "operations" if all(train_rows[s][key] == "operations"
                                   for s in mix) else "bytes"

    def err(key):
        return max([r[f"{key}_{rate}"] for r in rows.values()
                    for rate in (0.0, RATE)]
                   + [r[f"{key}_{RATE}"] for r in train_rows.values()])

    def mha_avg(key):
        return sum(mha_rows[s][key] for s in MHA_LINE) / len(MHA_LINE)

    def b_mha_avg(key):
        return sum(b_mha_rows[s][key] for s in MHA_LINE) / len(MHA_LINE)

    # the bf16 rows: launches by bf16 path (decode counts the forward
    # only; the bench build's forward count includes the recomputed
    # rollout steps' launches), times weighted by the bench build's launch
    # mix, errors against float64 of each result's scale (phase 3 bf16)
    b_mix = add_mix(g_mix, cg_mix)
    b_total = sum(b_mix.values())
    b_by_path = [dict(decode=b_decode, train=g_train[i],
                      causal_decode=c_b_decode, causal_train=cg_train[i],
                      fused_train=j_train[i])
                 for i in range(3)]
    for i in (1, 2):
        b_by_path[i].update(decode=0, causal_decode=0)

    def b_avg(key):
        return sum(b_train_rows[s][key] * w for s, w in b_mix.items()) \
            / b_total

    def b_by(key):
        return "operations" if all(b_train_rows[s][key] == "operations"
                                   for s in b_mix) else "bytes"

    def b_err(key):
        return max(r[key] for r in list(b_rows.values())
                   + list(b_train_rows.values()))

    src = "vln_goat_tpu_torch/ops/csrc/"
    kernels = [
        dict(name="fused_qkv_mha", route="cuda", source=src + "fused_qkv_mha.cu",
             replaces="vln_goat_tpu/ops/attention.py:169",
             launches=sum(by_path[0].values()),
             launches_by_path=by_path[0],
             max_abs_err=err("fwd_err"),
             ms=avg("ms"), plain_ms=avg("plain_ms"),
             bound_ms=avg("bound_ms"), bound_by=by("bound_by"),
             library_ms=avg("library_ms"), device_ms=avg("device_ms"),
             library_device_ms=avg("library_device_ms")),
        dict(name="fused_qkv_mha_bwd_attn", route="cuda",
             source=src + "fused_qkv_mha_bwd.cu",
             replaces="vln_goat_tpu/ops/attention.py:181",
             launches=sum(by_path[1].values()),
             launches_by_path=by_path[1], max_abs_err=err("attn_err"),
             ms=avg("attn_ms"), plain_ms=avg("attn_plain_ms"),
             bound_ms=avg("attn_bound_ms"), bound_by=by("attn_bound_by"),
             library_ms=avg("attn_library_ms"),
             device_ms=avg("attn_device_ms"),
             library_device_ms=avg("attn_library_device_ms")),
        dict(name="fused_qkv_mha_bwd_proj", route="cuda",
             source=src + "fused_qkv_mha_bwd.cu",
             replaces="vln_goat_tpu/ops/attention.py:181",
             launches=sum(by_path[2].values()),
             launches_by_path=by_path[2], max_abs_err=err("proj_err"),
             ms=avg("projb_ms"), plain_ms=avg("projb_plain_ms"),
             bound_ms=avg("projb_bound_ms"), bound_by=by("projb_bound_by"),
             library_ms=avg("projb_library_ms"),
             device_ms=avg("projb_device_ms"),
             library_device_ms=avg("projb_library_device_ms")),
        # on no path, in either package: the JAX package keeps pallas_mha
        # for A/B comparisons; times at the hoisted-text cross-attention
        dict(name="mha", route="cuda", source=src + "mha.cu",
             replaces="vln_goat_tpu/ops/attention.py:49", launches=0,
             launches_by_path=dict(decode=0, train=0, causal_decode=0,
                                   causal_train=0),
             max_abs_err=max(r["err"] for r in mha_rows.values()),
             ms=mha_avg("ms"), plain_ms=mha_avg("plain_ms"),
             bound_ms=mha_avg("bound_ms"),
             bound_by=mha_rows[MHA_LINE[0]]["bound_by"],
             library_ms=mha_avg("library_ms"), device_ms=mha_avg("device_ms"),
             library_device_ms=mha_avg("library_device_ms")),
        dict(name="fused_qkv_mha_bf16", route="cuda",
             source=src + "fused_qkv_mha.cu",
             replaces="vln_goat_tpu/ops/attention.py:169",
             launches=sum(b_by_path[0].values()),
             launches_by_path=b_by_path[0], max_abs_err=b_err("fwd_err"),
             ms=b_avg("ms"), plain_ms=b_avg("plain_ms"),
             bound_ms=b_avg("bound_ms"), bound_by=b_by("bound_by"),
             library_ms=b_avg("library_ms"), device_ms=b_avg("device_ms"),
             library_device_ms=b_avg("library_device_ms")),
        dict(name="fused_qkv_mha_bwd_attn_bf16", route="cuda",
             source=src + "fused_qkv_mha_bwd.cu",
             replaces="vln_goat_tpu/ops/attention.py:181",
             launches=sum(b_by_path[1].values()),
             launches_by_path=b_by_path[1], max_abs_err=b_err("attn_err"),
             ms=b_avg("attn_ms"), plain_ms=b_avg("attn_plain_ms"),
             bound_ms=b_avg("attn_bound_ms"), bound_by=b_by("attn_bound_by"),
             library_ms=b_avg("attn_library_ms"),
             device_ms=b_avg("attn_device_ms"),
             library_device_ms=b_avg("attn_library_device_ms")),
        dict(name="fused_qkv_mha_bwd_proj_bf16", route="cuda",
             source=src + "fused_qkv_mha_bwd.cu",
             replaces="vln_goat_tpu/ops/attention.py:181",
             launches=sum(b_by_path[2].values()),
             launches_by_path=b_by_path[2], max_abs_err=b_err("proj_err"),
             ms=b_avg("projb_ms"), plain_ms=b_avg("projb_plain_ms"),
             bound_ms=b_avg("projb_bound_ms"),
             bound_by=b_by("projb_bound_by"),
             library_ms=b_avg("projb_library_ms"),
             device_ms=b_avg("projb_device_ms"),
             library_device_ms=b_avg("projb_library_device_ms")),
        # the two bf16 attention cores inside K1 bf16 and K2 (a) bf16
        # (their launches): ms of the core's own C call and its device time
        # (a CUDA graph of ten); plain: the plain attention
        # over projected heads (its autograd for K2 (a)); library: SDPA
        dict(name="attn_fwd_sm90", route="cuda",
             source=src + "attn_fwd_sm90.cuh",
             replaces="vln_goat_tpu/ops/attention.py:169",
             launches=sum(b_by_path[0].values()),
             launches_by_path=b_by_path[0], max_abs_err=b_err("fwd_err"),
             ms=b_avg("fwd_attn_ms"), plain_ms=b_avg("fwd_attn_plain_ms"),
             bound_ms=b_avg("fwd_attn_bound_ms"),
             bound_by=b_by("fwd_attn_bound_by"),
             library_ms=b_avg("fwd_attn_library_ms"),
             device_ms=b_avg("fwd_attn_device_ms"),
             library_device_ms=b_avg("fwd_attn_library_device_ms")),
        dict(name="attn_bwd_sm90", route="cuda",
             source=src + "attn_bwd_sm90.cuh",
             replaces="vln_goat_tpu/ops/attention.py:181",
             launches=sum(b_by_path[1].values()),
             launches_by_path=b_by_path[1], max_abs_err=b_err("attn_err"),
             ms=b_avg("bwd_attn_ms"), plain_ms=b_avg("bwd_attn_plain_ms"),
             bound_ms=b_avg("bwd_attn_bound_ms"),
             bound_by=b_by("bwd_attn_bound_by"),
             library_ms=b_avg("bwd_attn_library_ms"),
             device_ms=b_avg("bwd_attn_device_ms"),
             library_device_ms=b_avg("bwd_attn_library_device_ms")),
        dict(name="mha_bf16", route="cuda", source=src + "mha.cu",
             replaces="vln_goat_tpu/ops/attention.py:49", launches=0,
             launches_by_path=dict(decode=0, train=0, causal_decode=0,
                                   causal_train=0),
             max_abs_err=max(r["err"] for r in b_mha_rows.values()),
             ms=b_mha_avg("ms"), plain_ms=b_mha_avg("plain_ms"),
             bound_ms=b_mha_avg("bound_ms"),
             bound_by=b_mha_rows[MHA_LINE[0]]["bound_by"],
             library_ms=b_mha_avg("library_ms"),
             device_ms=b_mha_avg("device_ms"),
             library_device_ms=b_mha_avg("library_device_ms")),
    ]
    # head widths 32 and 128 and the phase B row count: on no path
    for dh, r in w_rows.items():
        kernels += width_kernel_rows(f"dh{dh}", r["f32"], r["mha"], False)
        kernels += width_kernel_rows(f"dh{dh}", r["bf16"], r["mha_bf16"],
                                     True)
    kernels += width_kernel_rows(f"b{PHASE_B_BATCH}", pb_bf16, None, True)
    kernels += f6_kernel_rows(f6_rows)
    # the DH 256 / 192 instances' launches: 5 (w)'s CLI runs
    kernels += f6_kernel_rows(wide_rows, {
        tag: w_nums[case]["kernels"]["counts"][:2]
        for tag, case in (("local54_d768_dh256_bf16", "3x256_bf16"),
                          ("local54_d768_dh192", "4x192_f32"))
        if case in w_nums})
    kernels += new_kernel_rows(shape_rows, m_nums, n_nums, o_nums)
    kernels += pretrain_kernel_rows(pt_rows, q_timing)
    kernels += refresh_kernel_rows(refresh_rows,
                                   s_nums["kernels_counts"][0])
    kernels += adamw_kernel_rows(x_nums)
    # the float32 CUDA-core bounds, beside the 3xTF32 ones
    # the kernels line carries, and the forward by part
    say(f"float32 CUDA-core bound over the train mix: forward "
        f"{avg('bound_f32_ms'):.4f} ms, attention backward "
        f"{avg('attn_bound_f32_ms'):.4f} ms, projection backward "
        f"{avg('projb_bound_f32_ms'):.4f} ms; attention-only "
        f"{mha_avg('bound_f32_ms'):.4f} ms")
    say(f"forward by part over the train mix: proj "
        f"{avg('fwd_proj_ms'):.4f} ms, attn (no dropout) "
        f"{avg('fwd_attn_ms'):.4f} ms")
    say(bf16_part_line(b_train_rows, b_mix))
    say(bf16_attn_line(b_train_rows, b_mix))
    say(f"bf16 over the bench build's mix: K1 {b_avg('ms'):.4f} ms, "
        f"{b_avg('ms') / b_avg('library_ms'):.2f}x its library call "
        f"{b_avg('library_ms'):.4f} (device time, CUDA graphs: "
        f"{b_avg('device_ms'):.4f} against {b_avg('library_device_ms'):.4f}"
        f", {b_avg('device_ms') / b_avg('library_device_ms'):.2f}x); K2 (b) "
        f"{b_avg('projb_ms'):.4f} ms, "
        f"{b_avg('projb_ms') / b_avg('projb_library_ms'):.2f}x its library "
        f"call {b_avg('projb_library_ms'):.4f} (device time "
        f"{b_avg('projb_device_ms'):.4f}); K2 (a) {b_avg('attn_ms'):.4f} "
        f"ms, {b_avg('attn_ms') / b_avg('attn_library_ms'):.2f}x")
    say(f"wall: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    failures = [f for f in (d_failed, cd_failed, failed, c_failed, e_failed,
                            f_failed, cf_failed, g_failed, cg_failed,
                            h_failed, j_failed, k_failed, l_failed,
                            m_failed, n_failed, o_failed, p_failed,
                            q_failed, qt_failed, r_failed, s_failed,
                            t_failed, w_failed, *i_failed, *u_failed,
                            *v_failed, *x_failed)
                if f is not None]
    if failures:
        say("FAILED: " + "; ".join(failures))
        return 1
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
