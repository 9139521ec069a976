"""GOAT pre-training model of the port (counterpart of
vln_goat_tpu/pretrain/model.py): the trajectory-level dual-scale encoder
and the heads of the five proxy tasks, MLM, MRC, SAP, OG and CFP.

The submodule names are the JAX package's, so its parameter tree maps onto
`state_dict()` through `train.checkpoint.params_from_flax`, and the
reference pretrain layout (`bert.*` for the encoder, the heads at the top)
through `train.checkpoint.pretrain_state_dict`.  The modules are those the
JAX package's tasks create parameters for: Flax makes a parameter only
when a task calls its module, so with a given task set the cross-modal
encoders, the graph bias, the SAP heads and the tim heads are present
only where one of the tasks runs them (`GoatPretrainModel.__init__`).

As in the JAX package:
- the map tokens are [stop] + nodes, with no [MEM] token, so SAP fuses its
  logits from slot 1 (`fuse_logits(first_cand_slot=1, first_gmap_slot=1)`);
- MLM runs the two cross-modal encoders with the text as the query over
  the map and viewpoint tokens (no graph bias) and sums the two streams;
  its decoder is the word-embedding table;
- CFP runs the tim self-encoders (the encoders are built in the
  `extract_cfp_features` mode when "cfp" is a task) and pools each
  sequence by a softmax masked to its valid tokens;
- every module computes in float32: the JAX pretrain model builds them at
  float32 whatever `compute_dtype` says.
One difference: the JAX package hands the image back-door bank, one per
example ([B, N, D]), to the panorama encoder of every step of the
flattened trajectories ([B·T, ...]), which fails to broadcast for B > 1;
the port repeats each example's bank over its T steps.

In train() mode the dropout sites draw from the generator that
`ops.dropout.set_generator` hands the model.

Data parallelism: with `mesh` set (`parallel.mesh.Mesh`), the batch is the
rank's rows of the global one (`mesh.shard_batch`) and each loss and
accuracy is the rank's share of the global batch's times the world size,
so that their mean over the ranks is the global value (the JAX package
computes over the global batch under its sharding):
- MLM, MRC and OG divide their sums by the global count of masked tokens,
  masked views or valid targets (`all_reduce_sum`) over the world size;
- SAP divides by the rank's batch, which is right with an even split (its
  accuracies by the global counts, as above);
- CFP scores the rank's rows against the whole global batch, gathered
  over the ranks with a differentiable gather (`gather_rows`), its targets
  offset by rank x B_local, and averages over its own rows.
Without a mesh every loss is the one-process arithmetic; with a mesh of
one, the same values bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..config import GoatConfig
from ..device import resolve
from ..models.backbone import (BertOnlyMLMHead, LanguageEncoder,
                               LanguageEncoderDo, RobertaEmbeddings)
from ..models.goat import GlobalMapEncoder, LocalVPEncoder, fuse_logits
from ..models.layers import BertPredictionHeadTransform, ClsPrediction
from ..models.panorama import CausalImageEmbeddings
from ..models.traj import aggregate_gmap_features
from ..ops.masks import extend_neg_masks
from ..parallel.distributed import all_reduce_sum, gather_rows
from ..parallel.mesh import Mesh
from ..train.params import init_goat_params

NEG_INF = float("-inf")
TASKS = ("mlm", "mrc", "sap", "og", "cfp")
# the CFP pooling vectors, [hidden, 1] each (JAX pretrain/model.py:105-117)
TIM_POOL = ("tim_txt_attn", "tim_global_attn", "tim_local_attn",
            "tim_fused_attn")


def _ce(logits, labels):
    """Per-row cross-entropy with ignore_index semantics (labels < 0 give
    0) and the rows' validity."""
    ok = labels >= 0
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.clamp(min=0).long()[:, None])[:, 0]
    return torch.where(ok, nll, torch.zeros_like(nll)), ok


def _acc(logits, labels, ok, n):
    return ((logits.argmax(-1) == labels) & ok).sum() / n


class GoatPretrainModel(nn.Module):
    """GlocalTextPathCMTPreTraining equivalent; `forward(batch, task)` ->
    (loss, metrics) for a batch of `pretrain.data.TrajBatchBuilder` as
    tensors.  `mesh`: the data-parallel group the batch is a rank's share
    of (None: the batch is the whole one)."""

    mesh: Optional[Mesh] = None

    def __init__(self, config: GoatConfig,
                 tasks: Sequence[str] = ("mlm", "sap", "cfp"),
                 image_prob_size: int = 1000):
        super().__init__()
        c = config.replace(compute_dtype="float32")
        self.config = c
        self.tasks = tuple(tasks)
        t = set(self.tasks)
        self.embeddings = RobertaEmbeddings(c)
        # the text front door is never run here: no bank reaches it
        self.lang_encoder = LanguageEncoderDo(c.replace(do_front_txt=False)) \
            if c.do_back_txt else LanguageEncoder(c)
        self.img_embeddings = CausalImageEmbeddings(c)
        enc_cfg = c.replace(mode="extract_cfp_features") if "cfp" in t else c
        self.local_encoder = LocalVPEncoder(
            enc_cfg, cross=bool(t & {"mlm", "mrc", "sap", "og"}))
        self.global_encoder = GlobalMapEncoder(
            enc_cfg, cross=bool(t & {"mlm", "sap"}), sprels="sap" in t) \
            if t & {"mlm", "sap", "cfp"} else None

        self.mlm_head = BertOnlyMLMHead(c) if "mlm" in t else None
        self.image_classifier = ClsPrediction(
            c, output_size=image_prob_size) if "mrc" in t else None
        sap = "sap" in t
        self.global_sap_head = ClsPrediction(c) if sap else None
        self.local_sap_head = ClsPrediction(c) if sap else None
        self.sap_fuse_linear = ClsPrediction(c, input_size=2 * c.hidden_size) \
            if c.glocal_fuse and t & {"sap", "cfp"} else None
        self.og_head = ClsPrediction(c) if "og" in t else None
        cfp_heads = "cfp" in t and c.cfp_extra_head
        for name in ("tim_txt_head", "tim_global_head", "tim_local_head"):
            setattr(self, name,
                    BertPredictionHeadTransform(c) if cfp_heads else None)
        if "cfp" in t:
            for name in TIM_POOL:
                self.register_parameter(
                    name, nn.Parameter(torch.empty(c.hidden_size, 1)))

    # ------------------------------------------------------------------
    def _count(self, ok: torch.Tensor) -> torch.Tensor:
        """The denominator of a mean over the rows where `ok` holds: their
        count, at least 1; with a mesh the global batch's count over the
        world size, so that a rank's sum over its rows divided by it is its
        share of the global mean times the world size."""
        n = ok.sum()
        if self.mesh is None:
            return n.clamp(min=1)
        return all_reduce_sum(n.detach().clone()).clamp(min=1) \
            / self.mesh.size

    def encode_text(self, batch):
        txt = self.embeddings(batch["txt_ids"])
        if isinstance(self.lang_encoder, LanguageEncoderDo):
            return self.lang_encoder(
                txt, batch["txt_masks"],
                batch.get("instr_z_direction_features"),
                batch.get("instr_z_direction_pzs"),
                batch.get("instr_z_landmark_features"),
                batch.get("instr_z_landmark_pzs"))
        return self.lang_encoder(txt, batch["txt_masks"])

    def encode_traj(self, batch):
        """[B, T, Lp, ...] -> (pano embeds [B, T, L, D], masks [B, T, L],
        fused [B, T, D]), padded steps zeroed."""
        c = self.config
        v = batch["traj_view_img_fts"]
        B, T = v.shape[:2]

        def flat(x):
            return x.reshape((B * T,) + tuple(x.shape[2:]))

        def per_step(x):
            # one bank per example, for each of its T steps
            return None if x is None else \
                x[:, None].expand(B, T, *x.shape[1:]).reshape(
                    (B * T,) + tuple(x.shape[1:]))

        obj_kw = {}
        if c.is_objnav and batch.get("traj_obj_img_fts") is not None:
            names = batch.get("traj_obj_names")
            obj_kw = dict(obj_fts=flat(batch["traj_obj_img_fts"]),
                          obj_masks=flat(batch["traj_obj_masks"]),
                          obj_names=None if names is None else flat(names))
        embeds, masks, fused = self.img_embeddings(
            flat(v), flat(batch["traj_loc_fts"]),
            flat(batch["traj_nav_types"]), flat(batch["traj_view_masks"]),
            per_step(batch.get("img_z_features")),
            per_step(batch.get("img_z_pzs")), per_step=False, pretrain=True,
            **obj_kw)
        L, D = embeds.shape[1:]
        embeds = embeds.reshape(B, T, L, D)
        masks = masks.reshape(B, T, L)
        if fused is None:
            m = masks[..., None].to(embeds.dtype)
            fused = (embeds * m).sum(2) / m.sum(2).clamp(min=1.0)
        else:
            fused = fused.reshape(B, T, D)
        stepm = batch["step_masks"].to(embeds.dtype)
        return embeds * stepm[..., None, None], masks, fused * stepm[..., None]

    def _gmap_in(self, pano_embeds, pano_fused, batch):
        ge = self.global_encoder
        gmap_img = aggregate_gmap_features(
            pano_embeds, pano_fused, batch["gmap_visited_step"],
            batch["cand_to_gmap"], batch["gmap_step_ids"].shape[1])
        return ge.input_embed(gmap_img, batch["gmap_step_ids"],
                              batch["gmap_pos_fts"])

    def _vp_in(self, pano_embeds, pano_masks, batch):
        """[stop] + the last step's panorama tokens, with their position
        embedding -> (vp embeds [B, 1 + L, D], vp masks)."""
        B, _, _, D = pano_embeds.shape
        bidx = torch.arange(B, device=pano_embeds.device)
        last = batch["traj_len"].long() - 1
        vp_img = torch.cat([pano_embeds.new_zeros(B, 1, D),
                            pano_embeds[bidx, last]], dim=1)
        vp_masks = torch.cat(
            [torch.ones(B, 1, dtype=torch.bool, device=vp_img.device),
             pano_masks[bidx, last]], dim=1)
        return vp_img + self.local_encoder.pos_embed(batch["vp_pos_fts"]), \
            vp_masks

    def encode(self, batch, return_gmap: bool = True, cfp_self: bool = False):
        """bert.forward -> (gmap embeds or None, vp embeds, vp masks, text
        embeds): the cross-modal encoders, or with `cfp_self` the tim
        self-encoders under each sequence's key mask."""
        txt = self.encode_text(batch)
        pano_embeds, pano_masks, pano_fused = self.encode_traj(batch)
        ge, le = self.global_encoder, self.local_encoder
        gmap_embeds = None
        if return_gmap:
            gmap_embeds = self._gmap_in(pano_embeds, pano_fused, batch)
            if cfp_self:
                gmap_embeds = ge.tim_self_encoder(
                    gmap_embeds, None, extend_neg_masks(batch["gmap_masks"]))
            else:
                gmap_embeds = ge.encoder(
                    gmap_embeds, batch["gmap_masks"], txt, batch["txt_masks"],
                    graph_sprels=ge.sprel_bias(batch["gmap_pair_dists"]))
        vp_embeds, vp_masks = self._vp_in(pano_embeds, pano_masks, batch)
        if cfp_self:
            vp_embeds = le.tim_self_encoder(vp_embeds, None,
                                            extend_neg_masks(vp_masks))
        else:
            vp_embeds = le.encoder(vp_embeds, vp_masks, txt,
                                   batch["txt_masks"])
        return gmap_embeds, vp_embeds, vp_masks, txt

    def _fuse_weights(self, gmap_embeds, vp_embeds):
        if self.sap_fuse_linear is None:
            return 0.5
        return torch.sigmoid(self.sap_fuse_linear(
            torch.cat([gmap_embeds[:, 0], vp_embeds[:, 0]], dim=1)))

    # ------------------------------------------------------------------
    def mlm_loss(self, batch) -> Tuple[torch.Tensor, Dict]:
        """Masked-token prediction from the text after both cross-modal
        encoders (text as the query), decoder tied to the word table."""
        txt = self.encode_text(batch)
        pano_embeds, pano_masks, pano_fused = self.encode_traj(batch)
        gmap_in = self._gmap_in(pano_embeds, pano_fused, batch)
        txt_masks = batch["txt_masks"]
        gmap_txt = self.global_encoder.encoder(txt, txt_masks, gmap_in,
                                               batch["gmap_masks"])
        vp_in, vp_masks = self._vp_in(pano_embeds, pano_masks, batch)
        vp_txt = self.local_encoder.encoder(txt, txt_masks, vp_in, vp_masks)
        txt_embeds = gmap_txt + vp_txt
        pos = batch["mlm_pos"].long()
        bidx = torch.arange(pos.shape[0], device=pos.device)
        hidden = txt_embeds[bidx[:, None], pos.clamp(min=0)]
        logits = self.mlm_head(hidden,
                               self.embeddings.word_embeddings.weight)
        tgt = batch["mlm_tgt"].long()
        ok = pos >= 0
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, tgt.clamp(min=0)[..., None])[..., 0]
        n = self._count(ok)
        loss = torch.where(ok, nll, torch.zeros_like(nll)).sum() / n
        acc = ((logits.argmax(-1) == tgt) & ok).sum() / n
        return loss, {"mlm_acc": acc}

    def mrc_loss(self, batch):
        """KL to the soft class probabilities of the masked views of the
        end viewpoint."""
        _, vp_embeds, _, _ = self.encode(batch, return_gmap=False)
        logits = self.image_classifier(vp_embeds[:, 1:])
        m = batch["mrc_masks"]
        probs = batch["mrc_targets"]
        logp = torch.log_softmax(logits.float(), dim=-1)
        kl = (probs * (torch.log(probs.clamp(min=1e-12)) - logp)).sum(-1)
        loss = torch.where(m, kl, torch.zeros_like(kl)).sum() \
            / self._count(m)
        return loss, {"mrc_kl": loss}

    def sap_loss(self, batch):
        """Single-step action prediction: the global, local and fused
        cross-entropies summed and divided by the batch (ignored rows kept
        in the denominator)."""
        gmap_embeds, vp_embeds, _, _ = self.encode(batch)
        fw = self._fuse_weights(gmap_embeds, vp_embeds)
        global_logits = self.global_sap_head(gmap_embeds).squeeze(-1) * fw
        local_logits = self.local_sap_head(vp_embeds).squeeze(-1) * (1 - fw)
        B = vp_embeds.shape[0]
        bidx = torch.arange(B, device=vp_embeds.device)
        last = batch["traj_len"].long() - 1
        vp_nav_masks = torch.cat(
            [torch.ones(B, 1, dtype=torch.bool, device=vp_embeds.device),
             batch["traj_nav_types"][bidx, last] == 1], dim=1)
        fused, gl, ll = fuse_logits(
            global_logits, local_logits, batch["gmap_masks"],
            batch["gmap_visited_masks"], vp_nav_masks,
            batch["local_to_gmap"], first_cand_slot=1, first_gmap_slot=1)
        g = batch["global_act_labels"].long()
        lab = batch["local_act_labels"].long()
        lg, okg = _ce(gl, g)
        lll, okl = _ce(ll, lab)
        lf, _ = _ce(fused, g)
        loss = (lg + lf + lll).sum() / B
        ng, nl = self._count(okg), self._count(okl)
        return loss, {"sap_facc": _acc(fused, g, okg, ng),
                      "sap_gacc": _acc(gl, g, okg, ng),
                      "sap_lacc": _acc(ll, lab, okl, nl)}

    def og_loss(self, batch):
        """Object grounding over the end viewpoint's object tokens; a row
        without objects has its logits replaced by 0 before the
        log-softmax."""
        _, vp_embeds, _, _ = self.encode(batch, return_gmap=False)
        logits = self.og_head(vp_embeds).squeeze(-1)
        obj = batch["vp_obj_masks"]
        logits = torch.where(obj, logits, torch.full_like(logits, NEG_INF))
        labels = batch["obj_labels"].long()
        has_obj = obj.any(dim=1)
        safe = torch.where(has_obj[:, None], logits,
                           torch.zeros_like(logits))
        nll, _ = _ce(safe, labels.clamp(min=0))
        ok = has_obj & (labels >= 0)
        n = self._count(ok)
        loss = torch.where(ok, nll, torch.zeros_like(nll)).sum() / n
        return loss, {"og_acc": _acc(logits, labels, ok, n)}

    def forward_cfp(self, batch):
        """(gmap, vp, fused, txt) pooled outputs of the tim self-encoders,
        each [B, D]."""
        gmap_embeds, vp_embeds, vp_masks, txt_embeds = self.encode(
            batch, cfp_self=True)
        if self.tim_global_head is not None:
            gmap_embeds = self.tim_global_head(gmap_embeds)
            vp_embeds = self.tim_local_head(vp_embeds)
            txt_embeds = self.tim_txt_head(txt_embeds)
        fw = self._fuse_weights(gmap_embeds, vp_embeds)

        def pool(x, attn, mask):
            a = torch.tanh(x) @ attn.to(x.dtype)
            a = torch.where(mask[..., None], a, torch.full_like(a, -1e9))
            return torch.tanh((x * torch.softmax(a, dim=1)).sum(dim=1))

        gmap_out = pool(gmap_embeds, self.tim_global_attn,
                        batch["gmap_masks"])
        vp_out = pool(vp_embeds, self.tim_local_attn, vp_masks)
        txt_out = pool(txt_embeds, self.tim_txt_attn, batch["txt_masks"])
        return gmap_out, vp_out, gmap_out * fw + vp_out * (1 - fw), txt_out

    def cfp_loss(self, batch):
        """Contrastive feature pretraining: symmetric InfoNCE of the map,
        viewpoint and fused vectors against the text's, in-batch negatives
        (with a mesh, the global batch's: each rank's rows against every
        rank's, gathered)."""
        gmap_out, vp_out, fused_out, txt_out = self.forward_cfp(batch)
        B = txt_out.shape[0]
        # a mesh of one has no other rows: its arithmetic is the plain one
        spread = self.mesh is not None and self.mesh.size > 1
        off = self.mesh.rank * B if spread else 0
        tgt = torch.arange(off, off + B, device=txt_out.device)
        temp = self.config.cfp_temperature
        txt_all = gather_rows(txt_out) if spread else txt_out

        def nce(a, b):
            # the rank's rows of the global similarity (its a against every
            # text) and of its transpose (its texts against every a)
            sim = (a @ txt_all.t()).float() / temp
            sim_t = ((gather_rows(a) @ b.t()).float() / temp).t() \
                if spread else sim.t()
            l1 = F.cross_entropy(sim, tgt, reduction="none")
            l2 = F.cross_entropy(sim_t, tgt, reduction="none")
            return (l1 + l2) / 2.0, sim

        lg, _ = nce(gmap_out, txt_out)
        lv, _ = nce(vp_out, txt_out)
        lf, sim_f = nce(fused_out, txt_out)
        loss = (lg + lv + lf).mean()
        acc = (sim_f.argmax(-1) == tgt).float().mean()
        return loss, {"cfp_acc": acc}

    def forward(self, batch, task: str):
        for name in TASKS:
            if task.startswith(name):
                return getattr(self, f"{name}_loss")(batch)
        raise ValueError(f"invalid task {task}")


@torch.no_grad()
def init_pretrain_params(model: GoatPretrainModel, seed: int = 0
                         ) -> GoatPretrainModel:
    """Seeded initialisation on the model's device: `init_goat_params`'
    distributions for the blocks, the MLM bias zero and the CFP pooling
    vectors uniform in [-0.1, 0.1] (the JAX package's pretrain init)."""
    init_goat_params(model, seed)
    if model.mlm_head is not None:
        model.mlm_head.predictions.bias.zero_()
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    for name in TIM_POOL:
        p = getattr(model, name, None)
        if p is not None:
            p.uniform_(-0.1, 0.1, generator=g)
    return model


def build_pretrain_model(cfg: GoatConfig, tasks: Sequence[str],
                         image_prob_size: int = 1000, device="cuda",
                         seed: int = 0) -> GoatPretrainModel:
    """GoatPretrainModel with seeded random weights, allocated and drawn on
    `device` (the card unless told otherwise), in eval mode."""
    dev = resolve(device)
    with torch.device("meta"):
        model = GoatPretrainModel(cfg, tasks, image_prob_size)
    model = model.to_empty(device=dev)
    return init_pretrain_params(model, seed).eval()
