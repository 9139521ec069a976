"""The speaker: gt-path features, teacher-forced training and greedy or
sampled decoding for back-translation (counterpart of
vln_goat_tpu/speaker/speaker.py).

Reference: map_nav_src/r2r/transpeaker.py (Speaker :13, train :214,
infer_batch :259-327, from_shortest_path :166).  Token conventions are the
caller's vocabulary's: pad 0, <BOS> and <EOS> ids from `SpeakerConfig`.

Decoding: the JAX package reruns the decoder over the whole token buffer
at each of the L steps and reads row i.  The causal mask makes row i a
function of the tokens up to i alone, so here the decoder runs over the
buffer as JAX's does but only row i's hidden state is projected to the
vocabulary (the full logits of a step are B x L x vocab floats).  A
sampled step is argmax(logits + Gumbel noise), which is what
jax.random.categorical computes, the noise drawn from an explicit
torch.Generator.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import geometry as G
from ..device import resolve
from ..ops.dropout import set_generator
from ..pretrain.optimizers import chain, scale_by_adam, scale_by_learning_rate
from ..rollout.rollout import gumbel_noise
from ..sim.graph_sim import ScanGraph
from ..train.params import _lecun_
from .model import SpeakerConfig, TranspeakerModel


def build_path_batch(graphs: Dict[str, ScanGraph], features: np.ndarray,
                     offsets: Dict[str, int], items: Sequence[dict],
                     max_steps: int, angle_feat_size: int = 128,
                     image_feat_size: int = 768) -> Dict[str, np.ndarray]:
    """from_shortest_path: each step's action feature (the chosen
    candidate's view and direction) and its 36 panorama views with angles
    relative to the camera, along each item's gt `path` (viewpoint ids,
    as the datasets give them), as numpy arrays: action [B, T, F], pano
    [B, T, 36, F], step_masks [B, T]."""
    B = len(items)
    F = image_feat_size + angle_feat_size
    action = np.zeros((B, max_steps, F), np.float32)
    pano = np.zeros((B, max_steps, 36, F), np.float32)
    step_masks = np.zeros((B, max_steps), bool)
    for b, it in enumerate(items):
        g = graphs[it["scan"]]
        path = [g.index[v] for v in it["path"]]
        vi = G.view_index(it.get("heading", 0.0), 0.0)
        for t in range(min(len(path) - 1, max_steps)):
            vp, nxt = path[t], path[t + 1]
            feats = features[offsets[it["scan"]] + vp]
            cam_h = (vi % 12) * math.radians(30)
            cam_e = (vi // 12 - 1) * math.radians(30)
            ang = G.angle_feature_np(G.VIEW_HEADINGS - cam_h,
                                     G.VIEW_ELEVATIONS - cam_e,
                                     angle_feat_size)
            pano[b, t] = np.concatenate([feats, ang], -1)
            k = int(np.argmax((g.cand_local[vp] == nxt) & g.cand_mask[vp]))
            pt = int(g.cand_ptid[vp, k])
            a_ang = G.angle_feature_np(g.cand_heading[vp, k] - cam_h,
                                       g.cand_elev[vp, k] - cam_e,
                                       angle_feat_size)
            action[b, t] = np.concatenate([feats[pt], a_ang], -1)
            step_masks[b, t] = True
            vi = pt
    return dict(action=action, pano=pano, step_masks=step_masks)


def speaker_batch(speaker: "Speaker", graphs: Dict[str, ScanGraph],
                  features: np.ndarray, offsets: Dict[str, int],
                  items: Sequence[dict], max_steps: int,
                  max_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """build_path_batch at the speaker's feature widths, on its device;
    with `max_len`, also the items' instructions as teacher-forcing
    `tokens` [B, max_len + 1]: <BOS>, at most max_len - 1 ids, <EOS>,
    then pad (the speaker's training batches)."""
    c = speaker.cfg
    batch = build_path_batch(
        graphs, features, offsets, items, max_steps,
        angle_feat_size=c.feature_size - c.image_feat_size,
        image_feat_size=c.image_feat_size)
    if max_len is not None:
        toks = np.zeros((len(items), max_len + 1), np.int64)
        for i, it in enumerate(items):
            enc = [c.bos_id] + list(it["instr_encoding"])[:max_len - 1] \
                + [c.eos_id]
            toks[i, :len(enc)] = enc
        batch["tokens"] = toks
    return to_device(batch, speaker.device)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                            torch.Tensor]:
    """A numpy speaker batch on `device` (token ids as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if t.dtype in (torch.int32, torch.int16, torch.uint8):
            t = t.long()
        out[k] = t.to(device)
    return out


@torch.no_grad()
def init_speaker_params(model: TranspeakerModel, seed: int = 0
                        ) -> TranspeakerModel:
    """Seeded initialisation in the JAX package's distributions: Dense
    kernels lecun-normal, biases zero, the embedding normal with std
    sqrt(1 / width); drawn on the model's device (the draws differ from
    JAX's)."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            _lecun_(m.weight, m.in_features, g)
            if m.bias is not None:
                torch.nn.init.zeros_(m.bias)
        elif isinstance(m, torch.nn.Embedding):
            torch.nn.init.normal_(m.weight, 0.0,
                                  math.sqrt(1.0 / m.embedding_dim),
                                  generator=g)
    return model


class Speaker:
    """The speaker model on `device` (cuda unless asked) with seeded
    weights, its teacher-forced loss, an Adam train step and decoding."""

    def __init__(self, cfg: SpeakerConfig, device="cuda", seed: int = 0):
        self.cfg = cfg
        self.device = resolve(device)
        self.model = init_speaker_params(
            TranspeakerModel(cfg).to(self.device), seed)

    # ------------------------------------------------------------------
    def loss_fn(self, batch, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Teacher forcing: tokens[1:] from tokens[:-1] (transpeaker.py:
        214-257), the cross-entropy over non-pad targets.  With a
        generator the model is in training mode and every dropout draws
        from it; without one the loss is deterministic (eval mode)."""
        m = self.model
        m.train(generator is not None)
        set_generator(m, generator)
        logits = m(batch["action"], batch["pano"], batch["step_masks"],
                   batch["tokens"][:, :-1])
        tgt = batch["tokens"][:, 1:]
        ok = tgt != self.cfg.pad_id
        logp = torch.log_softmax(logits.float(), -1)
        nll = -logp.gather(-1, tgt[..., None])[..., 0]
        return torch.where(ok, nll, torch.zeros_like(nll)).sum() \
            / ok.sum().clamp(min=1)

    def make_train_step(self, lr: float = 1e-4
                        ) -> Tuple[Callable, list]:
        """optax.adam(lr) in optax's arithmetic (the pretraining
        optimizers' scale_by_adam chain) -> (step(batch, generator) ->
        loss, optimizer state)."""
        tx = chain(scale_by_adam(), scale_by_learning_rate(lambda n: lr))
        params = list(self.model.parameters())
        holder = [tx.init([p.detach() for p in params])]

        def step(batch, generator: torch.Generator) -> torch.Tensor:
            loss = self.loss_fn(batch, generator)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            updates, holder[0] = tx.update(grads, holder[0],
                                           [p.detach() for p in params])
            with torch.no_grad():
                for p, u in zip(params, updates):
                    p.add_(u)
            return loss.detach()

        return step, holder

    # ------------------------------------------------------------------
    @torch.no_grad()
    def infer(self, batch, generator: Optional[torch.Generator] = None,
              sample: bool = False, max_decode: Optional[int] = None,
              featdropmask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Greedy or sampled decode (infer_batch, transpeaker.py:259-327)
        -> tokens [B, L], pad after each episode's <EOS>.  `featdropmask`
        [image_feat_size] is back-translation's shared feature noise
        (agent.py:459-464), multiplied into the image columns; a sampled
        decode draws Gumbel noise from `generator`."""
        c, m = self.cfg, self.model
        L = max_decode or c.max_decode
        m.eval()
        action, pano = batch["action"], batch["pano"]
        if featdropmask is not None:
            n = c.image_feat_size
            action = torch.cat([action[..., :n] * featdropmask,
                                action[..., n:]], -1)
            pano = torch.cat([pano[..., :n] * featdropmask, pano[..., n:]],
                             -1)
        steps = batch["step_masks"]
        _, enc = m.encode(action, pano, steps)
        B = action.shape[0]
        dev = action.device
        toks = torch.full((B, L + 1), c.pad_id, dtype=torch.int64,
                          device=dev)
        toks[:, 0] = c.bos_id
        ended = torch.zeros(B, dtype=torch.bool, device=dev)
        for i in range(L):
            hid = m.decode_hidden(toks[:, :L], enc, steps)[:, i]
            logits = m.projection(hid).float()
            if sample:
                logits = logits + gumbel_noise(generator, logits.shape, dev)
            nxt = logits.argmax(-1)
            nxt = torch.where(ended, torch.full_like(nxt, c.pad_id), nxt)
            toks[:, i + 1] = nxt
            ended |= nxt == c.eos_id
            if bool(ended.all()):    # the rest is pad, as JAX's would be
                break
        return toks[:, 1:]
