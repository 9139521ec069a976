"""Checkpoints of the port (counterpart of vln_goat_tpu/train/checkpoint.py).

- Train state: `save_train_state` / `load_train_state` write and read a
  directory (marked as the JAX package marks its own, `is_train_state_dir`)
  holding one `torch.save` file: the parameters, AdamW's exp_avg /
  exp_avg_sq / step per parameter, the update and schedule counts, the
  optimizer's accumulation and finite-guard state, the train loop's
  generator state and the iteration, so that a resumed run continues bit
  for bit.  The port's train states are its own files.
- Reference `.pt` files, the interchange with the JAX package and the
  reference code: `load_reference_checkpoint` reads a fine-tune wrapper
  ({"vln_bert": {"epoch", "state_dict"}}) or a flat state dict,
  `strip_prefixes` maps its keys to the port's (the reference torch names,
  which the port's modules carry), `merge_loaded` overlays them on a
  state_dict, counting missing and extra keys as the JAX package counts
  its leaves; `save_reference_checkpoint` writes the CLI's
  `--save_torch_ckpt` format (JAX cli.py:860-867), the exact inverse.
- Pretraining: `pretrain_state_dict` / `save_pretrain_checkpoint` write a
  pretrain model's weights in the reference pretrain layout (`bert.` before
  the encoder's modules), which the fine-tune model loads; the pretrain
  entry's key surgery from METER / LXMERT / BERT checkpoints is
  `surgery_init_keys`, and `init_pretrain_from` overlays a checkpoint on a
  pretrain model's state dict.

Weights carried across from the JAX package in memory:
`params_from_flax` takes the JAX package's parameters as a flat
{"a/b/kernel": array} dict (or the nested tree) and returns the port's
state_dict.  The naming follows the JAX package's `flax_to_torch`
(vln_goat_tpu/train/checkpoint.py:132), rewritten here:
- a path segment ending in _<n> is a list index: `layer_0` -> `layer.0`;
- Dense kernel [in, out] -> Linear weight [out, in]; bias -> bias;
- LayerNorm scale -> weight; Embed embedding -> weight;
- the pano encoder's q_proj/k_proj/v_proj pack into torch
  MultiheadAttention's in_proj_weight / in_proj_bias;
- a raw parameter (the CFP pooling's tim_*_attn, the JAX package's
  RAW_PARAMS) keeps its name and layout.
These cover every parameter of every configuration: the object tokens
(obj_reverie_linear, obj_name_linear, nav_type_embedding, layer_norm,
pano_encoder), og_head, the tim_* modules of the `extract_cfp_features`
mode, and `Critic` (state2value.0 / .3) as a tree of its own.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

_QKV = ("q_proj", "k_proj", "v_proj")


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested parameter tree -> {"a/b/leaf": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameters (flat "a/b/kernel" keys, or the nested tree, with or
    without its top-level "params") -> the port's state_dict.

    Every rule is a transpose, a copy or a concatenation, so the same call
    maps a JAX gradient tree (the same structure as the parameters) onto
    the port's parameter names and layouts, which is how the train-step
    tests compare gradients."""
    if any(isinstance(v, Mapping) for v in params.values()):
        params = flatten(params)
    out: Dict[str, torch.Tensor] = {}
    qkv: Dict[str, Dict[str, np.ndarray]] = {}
    for path, val in params.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        parts = [re.sub(r"_(\d+)$", r".\1", p) for p in parts]
        val = np.asarray(val, np.float32)
        if len(parts) == 1:
            out[parts[0]] = torch.from_numpy(val.copy())
            continue
        leaf, mod = parts[-1], parts[-2]
        base = ".".join(parts[:-1])
        if mod in _QKV:
            owner = ".".join(parts[:-2])
            qkv.setdefault(owner, {})[f"{mod}/{leaf}"] = val
            continue
        if leaf == "kernel":
            out[base + ".weight"] = torch.from_numpy(val.T.copy())
        elif leaf in ("scale", "embedding"):
            out[base + ".weight"] = torch.from_numpy(val.copy())
        elif leaf == "bias":
            out[base + ".bias"] = torch.from_numpy(val.copy())
        else:
            raise KeyError(f"unrecognised parameter {path}")
    for owner, d in qkv.items():
        out[owner + ".in_proj_weight"] = torch.from_numpy(np.concatenate(
            [d[f"{n}/kernel"].T for n in _QKV], 0))
        out[owner + ".in_proj_bias"] = torch.from_numpy(np.concatenate(
            [d[f"{n}/bias"] for n in _QKV], 0))
    return out


def strip_prefixes(key: str) -> Optional[str]:
    """A reference key without its wrapper prefixes (agent_base.py:232-246,
    vlnbert_init.py:56-69): `module.`, `vln_bert.bert.`, `vln_bert.`,
    `bert.`; None for the keys that are buffers, not parameters."""
    if key.startswith("module."):
        key = key[len("module."):]
    for pre in ("vln_bert.bert.", "vln_bert.", "bert."):
        if key.startswith(pre):
            key = key[len(pre):]
            break
    if key in ("embeddings.position_ids", "embeddings.token_type_ids"):
        return None
    if key.startswith("drop_env"):
        return None
    return key


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference .pt (the fine-tune wrapper {"vln_bert": {"epoch",
    "state_dict"}}, {"state_dict": ...}, or a flat state dict) -> its state
    dict, on the CPU, keys as written."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and isinstance(ckpt.get("vln_bert"), dict) \
            and "state_dict" in ckpt["vln_bert"]:
        sd = ckpt["vln_bert"]["state_dict"]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
    else:
        sd = ckpt
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def merge_loaded(init: Mapping[str, torch.Tensor],
                 loaded: Mapping[str, torch.Tensor], strict: bool = False
                 ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """Overlay a loaded reference state dict (keys through
    `strip_prefixes`) on `init` (a state_dict) -> (merged, missing, extra):
    missing, the keys of `init` the file lacks; extra, the file's keys
    `init` lacks and those of another shape (named with both shapes), as
    the JAX package's merge_loaded counts them; the reference tolerates
    both at load (agent_base.py:238-253) unless `strict`."""
    out = dict(init)
    seen, extra = set(), []
    for key, val in loaded.items():
        k = strip_prefixes(key)
        if k is None:
            continue
        if k not in init:
            extra.append(k)
        elif tuple(init[k].shape) != tuple(val.shape):
            extra.append(f"{k} (shape {tuple(val.shape)} != "
                         f"{tuple(init[k].shape)})")
        else:
            out[k] = val.to(init[k].dtype)
            seen.add(k)
    missing = [k for k in init if k not in seen
               and not any(e.startswith(k + " (") for e in extra)]
    if strict and (missing or extra):
        raise ValueError(f"missing={missing}, extra={extra}")
    return out, missing, extra


def load_reference(model: torch.nn.Module, path: str, strict: bool = False
                   ) -> Tuple[List[str], List[str]]:
    """Loads a reference .pt into `model` (`merge_loaded` over its
    state_dict) -> (missing, extra)."""
    merged, missing, extra = merge_loaded(
        model.state_dict(), load_reference_checkpoint(path), strict)
    model.load_state_dict(merged)
    return missing, extra


def reference_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """`model`'s state dict under the reference fine-tune keys (every key
    under `vln_bert.`, as the JAX package's flax_to_torch writes them)."""
    return {"vln_bert." + k: v.detach() for k, v in model.state_dict().items()}


def save_reference_checkpoint(model: torch.nn.Module, path: str,
                              epoch: int) -> None:
    """`model`'s state dict in the reference fine-tune format (the JAX CLI's
    `_save_torch`): {"vln_bert": {"epoch", "state_dict"}}, keys as
    `reference_state_dict`, tensors on the CPU; `load_reference_checkpoint`
    + `merge_loaded` give back the same tensors."""
    sd = {k: v.cpu().clone() for k, v in reference_state_dict(model).items()}
    torch.save({"vln_bert": {"epoch": epoch, "state_dict": sd}}, path)


# encoder modules that live under the `bert.` prefix in a reference
# PRETRAIN state dict (GlocalTextPathCMTPreTraining: self.bert holds the
# encoder, the task heads sit on the wrapper; the JAX package's
# _PRETRAIN_BERT_MODULES)
PRETRAIN_BERT_MODULES = ("embeddings", "lang_encoder", "img_embeddings",
                         "local_encoder", "global_encoder")


def pretrain_state_dict(state_dict: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A pretrain model's state dict in the reference pretrain layout (the
    JAX package's flax_to_torch_pretrain): the encoder's keys under
    `bert.`, the heads' at the top, tensors on the CPU.  `load_reference`
    (through `strip_prefixes`) loads it into the fine-tune GoatModel, whose
    encoder and SAP heads carry the same names."""
    out = {}
    for k, v in state_dict.items():
        top = k.split(".", 1)[0]
        out[("bert." + k) if top in PRETRAIN_BERT_MODULES else k] = \
            v.detach().cpu()
    return out


def save_pretrain_checkpoint(state_dict: Mapping[str, torch.Tensor],
                             path: str) -> None:
    """`pretrain_state_dict(state_dict)` as a flat .pt (the reference
    pretraining's ModelSaver format), which the fine-tune CLI's
    `--bert_ckpt_file` takes."""
    torch.save(pretrain_state_dict(state_dict), path)


def surgery_init_keys(state_dict: Mapping[str, torch.Tensor], fmt: str
                      ) -> Dict[str, torch.Tensor]:
    """The pretrain entry's key surgery (the JAX package's
    surgery_init_keys; train_r2r_goat.py:113-172), from a third-party key
    space into the reference's `bert.*` pretrain namespace.  fmt: 'goat'
    (a reference .pt, no rename), 'meter' (text_transformer.embeddings ->
    bert.embeddings, text_transformer.encoder -> bert.lang_encoder,
    cross_modal_image_layers -> both bert.{local,global}_encoder.encoder
    .crossattention), 'lxmert' (bert.encoder.layer ->
    bert.lang_encoder.layer, bert.encoder.x_layers -> both cross encoders,
    cls.predictions -> mlm_head.predictions) or 'bert' (keys as they are:
    only the embeddings find a module).  `module.` is dropped first."""
    if fmt == "goat":
        return dict(state_dict)
    if fmt not in ("meter", "lxmert", "bert"):
        raise ValueError(f"unknown init format {fmt!r}")
    rules = {
        "meter": (("text_transformer.embeddings",
                   ("text_transformer.", "bert.")),
                  ("text_transformer.encoder",
                   ("text_transformer.encoder", "bert.lang_encoder")),
                  ("cross_modal_image_layers",
                   ("cross_modal_image_layers",
                    "bert.local_encoder.encoder.crossattention"),
                   ("cross_modal_image_layers",
                    "bert.global_encoder.encoder.crossattention"))),
        "lxmert": (("bert.encoder.layer",
                    ("bert.encoder.layer", "bert.lang_encoder.layer")),
                   ("bert.encoder.x_layers",
                    ("bert.encoder.x_layers",
                     "bert.local_encoder.encoder.x_layers"),
                    ("bert.encoder.x_layers",
                     "bert.global_encoder.encoder.x_layers")),
                   ("cls.predictions",
                    ("cls.predictions", "mlm_head.predictions"))),
        "bert": (),
    }[fmt]
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        key = key.replace("module.", "")
        for match, *renames in rules:
            if match in key:
                for old, new in renames:
                    out[key.replace(old, new)] = val
                break
        else:
            out[key] = val
    return out


def init_pretrain_from(path: str, fmt: str,
                       init: Mapping[str, torch.Tensor]
                       ) -> Tuple[Dict[str, torch.Tensor], List[str],
                                  List[str]]:
    """A torch checkpoint through `surgery_init_keys` overlaid on a
    pretrain model's state dict `init` -> (merged, missing, extra), as
    `merge_loaded` counts them (the JAX package's init_pretrain_from)."""
    sd = surgery_init_keys(load_reference_checkpoint(path), fmt)
    return merge_loaded(init, sd)


PARAMS_FILE = "params.pt"


def save_params(path: str, model: torch.nn.Module) -> None:
    """`model`'s state dict (on the CPU) into directory `path`, the port's
    parameters-only checkpoint (the JAX CLI's orbax `ckpt_*`)."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, PARAMS_FILE + ".tmp")
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               tmp)
    os.replace(tmp, os.path.join(path, PARAMS_FILE))


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a `save_params` directory."""
    return torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu",
                      weights_only=True)


# the marker file of a train-state directory (the JAX package's)
TRAIN_STATE_MARKER = "GOAT_TRAIN_STATE"
TRAIN_STATE_FILE = "train_state.pt"


def is_train_state_dir(path: str) -> bool:
    return os.path.isdir(path) and \
        os.path.exists(os.path.join(path, TRAIN_STATE_MARKER))


def save_train_state(path: str, state, generator: torch.Generator,
                     iteration: int) -> None:
    """Writes `state` (a trainer.TrainState), the train loop's generator
    state and the iteration into directory `path` (made if missing)."""
    opt = state.optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    adam = {}
    for p in opt.params():
        st = opt.state.get(p)
        if st:
            adam[names[id(p)]] = {"step": st["step"],
                                  "exp_avg": st["mu"].detach().cpu(),
                                  "exp_avg_sq": st["nu"].detach().cpu()}
    extra = {}
    if opt.accumulator is not None:
        extra["accumulator"] = {"mini_step": opt.accumulator.mini_step,
                                "acc": [a.cpu() for a in opt.accumulator.acc]}
    if opt.guard is not None:
        extra["guard"] = dict(vars(opt.guard))
    blob = {"params": {k: v.detach().cpu() for k, v in
                       state.model.state_dict().items()},
            "adamw": adam, "step": state.step,
            "schedule_count": state.scheduler.last_epoch,
            "generator": generator.get_state(), "iteration": int(iteration),
            **extra}
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, TRAIN_STATE_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, TRAIN_STATE_FILE))
    with open(os.path.join(path, TRAIN_STATE_MARKER), "w") as f:
        f.write("1\n")


def _read_train_state(path: str) -> dict:
    if not is_train_state_dir(path):
        raise ValueError(f"{path} is not a train-state directory (no "
                         f"{TRAIN_STATE_MARKER})")
    return torch.load(os.path.join(path, TRAIN_STATE_FILE),
                      map_location="cpu", weights_only=False)


def load_train_state_params(path: str) -> Dict[str, torch.Tensor]:
    """The parameters alone of a train-state directory (valid mode)."""
    return _read_train_state(path)["params"]


@torch.no_grad()
def load_train_state(path: str, state,
                     generator: Optional[torch.Generator] = None) -> int:
    """Restores a `save_train_state` directory into `state` (built with the
    same model and optimizer flags as the saved run) and `generator`, in
    place -> the iteration to continue from."""
    blob = _read_train_state(path)
    state.model.load_state_dict(blob["params"])
    opt = state.optimizer
    params = dict(state.model.named_parameters())
    for name, st in blob["adamw"].items():
        p = params[name]
        opt.state[p] = {"step": st["step"],
                        "mu": st["exp_avg"].to(p.device),
                        "nu": st["exp_avg_sq"].to(p.device)}
    if "accumulator" in blob:
        acc = opt.accumulator
        acc.mini_step = blob["accumulator"]["mini_step"]
        for a, v in zip(acc.acc, blob["accumulator"]["acc"]):
            a.copy_(v)
    if "guard" in blob:
        vars(opt.guard).update(blob["guard"])
    state.step = blob["step"]
    sched = state.scheduler
    sched.last_epoch = blob["schedule_count"]
    sched._last_lr = [base * lam(sched.last_epoch) for base, lam in
                      zip(sched.base_lrs, sched.lr_lambdas)]
    for group, lr in zip(opt.param_groups, sched._last_lr):
        group["lr"] = lr
    if generator is not None:
        generator.set_state(blob["generator"])
    return blob["iteration"]
