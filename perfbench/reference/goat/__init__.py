"""Plain float32 PyTorch reference of VLN-GOAT's fine-tuning and
pretraining, frozen from `vln_goat_tpu_torch` (the port under test) with
its imports kept inside this package, so that a later change to the port
leaves the yardstick as it is.

What differs from the port's files:
- `ops/attention.py` is the port's plain version alone (`fused_qkv_mha`
  is `fused_qkv_mha_plain`): projections, softmax in float32, the
  attention dropout's counter-based keep mask (`ops/dropout.keep_mask`),
  no CUDA kernel.
- `ops/remat.py` keeps nothing but the names: the reference runs every
  rollout with remat "none".
- `parallel/` is one process: no collective.
- `tools/zdict.py` holds only the banks' batch helpers.
- `rollout/rollout.py` can follow the sampled actions of another run
  (`NavRollout.follow`) and judge them against its own scores.

Nothing here imports the port, JAX or anything outside this package but
numpy and torch.
"""
