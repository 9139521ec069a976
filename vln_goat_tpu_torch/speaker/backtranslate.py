"""Back-translation: re-caption augmented paths with the speaker and feed
them to the navigator under one shared feature-dropout noise (counterpart
of vln_goat_tpu/speaker/backtranslate.py).

Reference: r2r/agent.py:459-474.  In self-train mode one feature-dropout
mask is drawn per episode batch, speaker.infer_batch runs under it, the
instructions are swapped for its decodes, and the navigator's panorama
features take the SAME mask (`batch["feat_noise"]`, the rollout's
already_dropout).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..sim.graph_sim import ScanGraph
from .speaker import Speaker, speaker_batch


def shared_drop_mask(generator: torch.Generator, feat_dim: int, rate: float,
                     device="cpu") -> torch.Tensor:
    """One inverted-dropout mask [feat_dim] shared by an episode batch
    (vln_bert.drop_env(torch.ones(...)), agent.py:460): 1 / (1 - rate)
    with probability 1 - rate, else 0, drawn from `generator` on its
    device."""
    keep = torch.rand(feat_dim, generator=generator, device=device) \
        < 1.0 - rate
    return keep.float() / (1.0 - rate)


def backtranslate(speaker: Speaker, graphs: Dict[str, ScanGraph],
                  features: np.ndarray, offsets: Dict[str, int],
                  items: Sequence[dict], max_steps: int,
                  generator: torch.Generator, feat_drop: float = 0.4,
                  sample: bool = False):
    """-> (decoded tokens [B, L] as numpy, the shared noise over the
    speaker's image features, on its device) for the items' gt paths."""
    batch = speaker_batch(speaker, graphs, features, offsets, items,
                          max_steps)
    noise = shared_drop_mask(generator, speaker.cfg.image_feat_size,
                             feat_drop, speaker.device)
    toks = speaker.infer(batch, generator=generator, sample=sample,
                         featdropmask=noise)
    return toks.cpu().numpy(), noise


def swap_instructions(items: List[dict], tokens: np.ndarray, eos_id: int,
                      bos_id: int = None) -> List[dict]:
    """Each item with its instr_encoding replaced by the speaker's decode,
    cut after <EOS> and led by <BOS> when given (agent.py:465-471)."""
    out = []
    for it, row in zip(items, tokens):
        seq = [int(t) for t in row]
        if eos_id in seq:
            seq = seq[:seq.index(eos_id) + 1]
        new = dict(it)
        new["instr_encoding"] = ([bos_id] if bos_id is not None else []) \
            + seq
        out.append(new)
    return out
