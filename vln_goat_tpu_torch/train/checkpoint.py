"""Weights carried across from the JAX package.

`params_from_flax` takes the JAX package's parameters as a flat
{"a/b/kernel": array} dict (or the nested tree) and returns the port's
state_dict.  The naming follows the JAX package's `flax_to_torch`
(vln_goat_tpu/train/checkpoint.py:132), rewritten here:
- a path segment ending in _<n> is a list index: `layer_0` -> `layer.0`;
- Dense kernel [in, out] -> Linear weight [out, in]; bias -> bias;
- LayerNorm scale -> weight; Embed embedding -> weight;
- the pano encoder's q_proj/k_proj/v_proj pack into torch
  MultiheadAttention's in_proj_weight / in_proj_bias.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

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
        leaf, mod = parts[-1], parts[-2]
        base = ".".join(parts[:-1])
        val = np.asarray(val, np.float32)
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
