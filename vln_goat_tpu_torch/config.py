"""Model configuration of the PyTorch port.

A copy of the JAX package's `GoatConfig` and of the fields of its
`TrainConfig` that the train step uses (vln_goat_tpu/config.py), kept here
so the port imports nothing of that package.  Two fields differ:
`use_pallas_attention` is `use_fused_attention`, and the query-length gate
that the JAX package reads from the GOAT_PALLAS_MIN_LQ environment
variable is the field `fused_attn_min_lq`.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class GoatConfig:
    """Model hyper-parameters (reference: vlnbert_init.py:89-155)."""

    # dataset / mode
    dataset: str = "r2r"  # r2r | rxr | reverie | soon
    name: str = "R2R"     # R2R | RxR | REVERIE | SOON (reference config.name)
    mode: str = "train"   # train | valid | extract_cfp_features

    # transformer dims (METER-style, vlnbert_init.py:127-146)
    vocab_size: int = 50265
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"  # erf-gelu (Bert_backbone.py:40-46)
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1

    # stack depths (vlnbert_init.py:97-99)
    num_l_layers: int = 6
    num_pano_layers: int = 2
    num_x_layers: int = 3

    # feature sizes
    image_feat_size: int = 768
    angle_feat_size: int = 4
    obj_feat_size: int = 0        # 768 for REVERIE
    obj_loc_size: int = 3
    obj_name_vocab_size: int = 45
    use_obj_name: bool = False

    # navigation
    max_action_steps: int = 100   # gmap step embedding table size
    max_action_len: int = 15      # rollout horizon (r2r parser default)
    max_instr_len: int = 200

    # fusion / graph
    fusion: str = "dynamic"       # global | local | avg | dynamic
    glocal_fuse: bool = True      # fusion == 'dynamic'
    graph_sprels: bool = True
    adaptive_pano_fusion: bool = True
    enc_full_graph: bool = True
    act_visited_nodes: bool = False

    # causal intervention flags (vlnbert_init.py:115-125)
    do_back_img: bool = False
    do_back_txt: bool = False
    do_front_img: bool = False
    do_front_his: bool = False
    do_front_txt: bool = False
    do_back_txt_type: str = "type_2"   # type_1 | type_2
    do_back_img_type: str = "type_1"   # type_1 | type_2
    do_add_method: str = "door"        # door | add | concat
    cfp_temperature: float = 1.0

    # dropout on raw env features (models/model.py:19)
    feat_dropout: float = 0.4

    # freezing
    fix_lang_embedding: bool = False
    fix_pano_embedding: bool = False
    fix_local_branch: bool = False
    update_lang_bert: bool = True

    # pretraining heads
    cfp_extra_head: bool = True
    mrc_mask_prob: float = 0.15
    mlm_prob: float = 0.15
    pred_head_dropout_prob: float = 0.1

    # compute dtype ("float32" | "bfloat16"); params stay fp32
    compute_dtype: str = "float32"
    # fused q/k/v + attention kernel (deterministic calls only;
    # ops/attention.py), taken for query blocks of at least
    # fused_attn_min_lq tokens
    use_fused_attention: bool = False
    fused_attn_min_lq: int = 32

    @property
    def torch_dtype(self) -> torch.dtype:
        """`compute_dtype` as a torch dtype."""
        dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        if self.compute_dtype not in dtypes:
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: one of "
                             f"{sorted(dtypes)}")
        return dtypes[self.compute_dtype]

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def is_objnav(self) -> bool:
        return self.name in ("REVERIE", "SOON")

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "GoatConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, path_or_str: str) -> "GoatConfig":
        if path_or_str.lstrip().startswith("{"):
            d = json.loads(path_or_str)
        else:
            with open(path_or_str) as f:
                d = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def for_dataset(cls, dataset: str, **kw) -> "GoatConfig":
        """Reference per-dataset presets (scripts/run_*_goat.sh)."""
        d = dataset.lower()
        base = dict(dataset=d)
        if d == "r2r":
            base.update(name="R2R", max_instr_len=200, max_action_len=15)
        elif d == "rxr":
            base.update(name="RxR", max_instr_len=250, max_action_len=28)
        elif d == "reverie":
            base.update(
                name="REVERIE", obj_feat_size=768, use_obj_name=True,
                max_instr_len=200, max_action_len=15, feat_dropout=0.6,
            )
        elif d == "soon":
            base.update(name="SOON", obj_feat_size=768, use_obj_name=False)
        else:
            raise ValueError(f"unknown dataset {dataset}")
        base.update(kw)
        return cls(**base)


@dataclass
class TrainConfig:
    """Fine-tuning recipe (reference: map_nav_src/r2r/parser.py + run
    scripts): the fields of the JAX package's TrainConfig
    (vln_goat_tpu/config.py:148-169) that the port's train step reads."""

    lr: float = 2e-5
    weight_decay: float = 0.0
    train_alg: str = "dagger"      # imitation | dagger
    ml_weight: float = 0.2
    grad_clip: float = 40.0
