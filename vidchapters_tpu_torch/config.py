"""Unified dataclass configuration (the PyTorch port's own copy).

Field for field the same tree as ``vidchapters_tpu/config.py``, so an
``ExperimentConfig`` JSON written by the JAX package loads here unchanged.
Fields that only steer the JAX package's parameter layout
(``scan_layers``, ``fused_qkv``) are kept for that round trip and do not
change the port's modules: a JAX checkpoint saved in those layouts imports
into them (``models/weights.from_jax_params``); ``remat`` checkpoints each
T5 block in training, as there (``models/t5.REMAT_BLOCKS``). The mesh
is a ``(data, model)`` grid of ranks (``runtime/mesh.py``); the model axis
must divide every width it shards (``MeshConfig.check_widths``).

Replaces the reference's three coexisting config systems (flat argparse in
args.py:4-357, PDVC argparse+chained-YAML in PDVC/opts.py, and the class-based
option snapshotting in moment_detr/moment_detr/config.py:9-244) with one typed
dataclass tree plus a dataset registry equivalent to ``name2folder``
(args.py:9-14).

Configs are plain dataclasses so they are hashable-free pytree-friendly static
arguments: pass them as Python objects outside jit, and only array data crosses
the jit boundary.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# Dataset registry (reference: args.py:9-14 `name2folder`)
# ---------------------------------------------------------------------------

DATASET_REGISTRY: Dict[str, str] = {
    "chapters": "AllChapters",
    "htm": "howto100m",
    "youcook": "YouCook2",
    "vitt": "ViTT",
}


@dataclass
class PathsConfig:
    """Root paths (reference: args.py:4-8 PRESAVE_DIR/MODEL_DIR/DATA_DIR/SSD_DIR)."""

    presave_dir: str = ""
    model_dir: str = ""
    data_dir: str = ""
    ssd_dir: str = ""

    def dataset_dir(self, name: str) -> Path:
        return Path(self.data_dir) / DATASET_REGISTRY[name]


def default_dataset_paths(paths: "PathsConfig", name: str) -> "DatasetPaths":
    """Standard file locations under the configured roots, reproducing the
    reference's per-dataset argparse defaults (args.py:34-103): annotation
    jsons under DATA_DIR/<folder>, bulk features/ASR under SSD_DIR for the
    large datasets (chapters/howto100m) and under DATA_DIR otherwise.

    Used by ``dvc_main`` when ``ExperimentConfig.datasets`` has no explicit
    entry for a combined dataset name."""
    d = paths.dataset_dir(name)
    ssd = Path(paths.ssd_dir or paths.data_dir)
    if name == "htm":
        return DatasetPaths(
            train_json_path=str(d / "htm_vid2seq.csv"),
            features_path=str(ssd / "howto100m_clip_features"),
            subtitles_path=str(ssd / "htm_sentences"))
    if name == "chapters":
        return DatasetPaths(
            train_json_path=str(d / "chapters_dvc_train.json"),
            val_json_path=str(d / "chapters_dvc_val.json"),
            test_json_path=str(d / "chapters_dvc_test.json"),
            features_path=str(ssd / "chapters_clipvitl14_features"),
            subtitles_path=str(ssd / "allchapters_asr"))
    if name == "youcook":
        return DatasetPaths(
            train_json_path=str(d / "train.json"),
            val_json_path=str(d / "val.json"),
            features_path=str(d / "clipvitl14.pth"),
            subtitles_path=str(d / "youcook2_asr_align_proc.pkl"))
    if name == "vitt":
        return DatasetPaths(
            train_json_path=str(d / "train.json"),
            val_json_path=str(d / "dev.json"),
            test_json_path=str(d / "test.json"),
            features_path=str(d / "clipvitl14.pth"),
            subtitles_path=str(d / "subtitles_align_proc.pkl"))
    raise KeyError(f"no default paths for dataset {name!r}")


@dataclass
class DatasetPaths:
    """Per-dataset file locations (reference: args.py dataset path args)."""

    train_json_path: str = ""
    val_json_path: str = ""
    test_json_path: str = ""
    features_path: str = ""
    subtitles_path: str = ""
    # moment-retrieval style jsonl (grounding task)
    train_jsonl_path: str = ""
    val_jsonl_path: str = ""
    test_jsonl_path: str = ""


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class T5Config:
    """T5 encoder-decoder hyperparameters.

    Matches t5-base semantics used by the reference fork
    (model/modeling_t5.py:1497-1560): RMSNorm, relative attention bias on the
    first layer of each stack, tied embeddings with rescaled logits, optional
    gated-GELU feed-forward (t5-v1_1) vs ReLU (t5-base), label smoothing.
    """

    vocab_size: int = 32200  # 32100 text tokens + 100 time tokens
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12
    num_decoder_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    encoder_dropout: float = 0.1
    decoder_dropout: float = 0.1
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # "relu" (t5-base) | "gated-gelu" (t5-v1_1)
    tie_word_embeddings: bool = True
    label_smoothing: float = 0.1
    dtype: str = "bfloat16"  # compute dtype; params kept in float32
    # per-block rematerialisation in training: None follows
    # models/t5.REMAT_BLOCKS (on); False keeps every block's activations
    # (more memory, no recomputed forward)
    remat: Optional[bool] = None
    # store a stack's blocks as ONE scanned block with layer-stacked
    # [L, ...] params (flax nn.scan). Same math; collapses the optimizer /
    # grad pytree from ~250 per-layer leaves to ~20 stacked ones (XLA
    # memory-space staging around the big tree was ~8 ms/step in the
    # round-2 profile) and shrinks the unrolled 24-block HLO the remote
    # TPU compiler chews on for 25-40 min. True | False | "encoder" |
    # "decoder" (per-stack): scanning the L=1024 encoder WITHOUT remat
    # OOMs v5e HBM (the stacked per-layer residuals fragment badly) and
    # WITH remat costs more recompute than the tail win (44.5 -> 32.9
    # videos/s measured), so the throughput recipe scans decoder-only
    scan_layers: Any = False
    # pack each attention's projections into single params (self-attn
    # qkv [d_model, heads, 3, d_kv]; cross-attn kv [d_model, heads, 2,
    # d_kv]): one matmul + one optimizer leaf per group instead of 3/2.
    # Head-major packing keeps the Megatron column-sharding rule exact.
    # Checkpoints migrate between layouts via utils/migrate_ckpt
    # (torch_import fuses released .pth weights on load automatically).
    fused_qkv: bool = False

    @property
    def is_gated_act(self) -> bool:
        return "gated" in self.feed_forward_proj


@dataclass(frozen=True)
class TemporalViTConfig:
    """Temporal visual transformer over per-frame CLIP features.

    Reference: model/vit.py:79-133 — 12-layer post-embed transformer over 100
    frame features with learned temporal position embeddings (interpolated on
    length mismatch), pre-norm blocks, GELU MLP (hidden 2048), LayerNorm final.
    """

    num_features: int = 100  # max frames (reference max_feats, args.py:241-245)
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_dim: int = 2048
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    dtype: str = "bfloat16"
    # layer-stacked nn.scan blocks ([depth, ...] params) — see
    # T5Config.scan_layers
    scan_layers: bool = False


@dataclass(frozen=True)
class Vid2SeqConfig:
    """Full Vid2Seq model (reference: model/vid2seq.py:20-57)."""

    t5: T5Config = field(default_factory=T5Config)
    vit: TemporalViTConfig = field(default_factory=TemporalViTConfig)
    use_speech: bool = True
    use_video: bool = True
    num_bins: int = 100  # time-token quantization bins (args.py:276-281)

    @property
    def num_text_tokens(self) -> int:
        return self.t5.vocab_size - self.num_bins


@dataclass(frozen=True)
class GroundingConfig:
    """Moment-DETR-equivalent chapter grounding model.

    Reference: moment_detr/moment_detr/model.py:19-107 + config.py:92-95 —
    2-layer encoder + 2-layer decoder transformer, 10 learned moment queries,
    span head (center,width sigmoid), fg/bg class head, saliency head, frozen
    CLIP ViT-L/14 text encoder, optional BERT speech branch.
    """

    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 2
    dec_layers: int = 2
    dim_feedforward: int = 1024
    num_queries: int = 10
    dropout: float = 0.1
    input_dropout: float = 0.5
    v_feat_dim: int = 770  # 768 + 2 TEF dims (config.py:222-227)
    t_feat_dim: int = 768  # CLIP ViT-L/14 text width (token-level features)
    s_feat_dim: int = 768  # BERT speech width (speech tower hidden size)
    use_speech: bool = False
    # BERT-tokenized ASR length cap for the speech stream
    # (moment_detr --max_speech_l, start_end_dataset.py:122)
    speech_max_l: int = 512
    use_tef: bool = True
    max_v_l: int = 1200
    clip_length: int = 3
    span_loss_type: str = "l1"  # "l1" (cxw regression) | "ce" (classification)
    contrastive_align_loss: bool = False
    contrastive_hdim: int = 64
    aux_loss: bool = True
    # precomputed-query-feature truncation/padding length; the live CLIP
    # tokens path uses the full 77-token context like the reference
    # (start_end_dataset.py:234 vs model.py:95-107)
    max_q_l: int = 32
    # loss coefficients (moment_detr config.py defaults / chapters.sh)
    span_loss_coef: float = 10.0
    giou_loss_coef: float = 1.0
    label_loss_coef: float = 4.0
    eos_coef: float = 0.1
    saliency_margin: float = 0.2
    lw_saliency: float = 1.0
    set_cost_span: float = 10.0
    set_cost_giou: float = 1.0
    set_cost_class: float = 4.0
    # matmul compute dtype (params/norms/softmax/losses stay float32).
    # float32 matches the reference bit-for-bit-ish; "bfloat16" is the TPU
    # production recipe (configs/chapters_momentdetr.json) — the fp32
    # d_head=32 attention matmuls were 10 of the 18.7 ms/step round-3
    # profile (bench_profile_aux.py)
    dtype: str = "float32"


@dataclass(frozen=True)
class PDVCConfig:
    """PDVC-equivalent deformable set-prediction dense captioner.

    Reference: PDVC/pdvc/pdvc.py:35-651 + deformable_transformer.py — conv1d
    multi-scale pyramid, 1-D multi-scale deformable attention encoder/decoder,
    event queries with iterative box refinement, class/count/box/caption heads.
    """

    hidden_dim: int = 512
    nheads: int = 8
    enc_layers: int = 2
    dec_layers: int = 2
    dim_feedforward: int = 2048
    num_queries: int = 100
    num_feature_levels: int = 4
    dec_n_points: int = 4
    enc_n_points: int = 4
    feature_dim: int = 768  # input (CLIP) feature dim
    frame_embedding_num: int = 100
    max_eseq_length: int = 10  # max predicted event count bins
    dropout: float = 0.1
    with_box_refine: bool = True
    # caption-head dispatch (PDVC/pdvc/CaptioningHead/__init__.py:6-24 +
    # the gpt2 branch at PDVC/pdvc/pdvc.py:56-57): "light" = LSTM,
    # "standard" (alias "dsa") = LSTM w/ deformable soft attention,
    # "gpt2" = prefix-conditioned GPT-2, "none" = localization-only puppet
    caption_decoder_type: str = "light"
    vocab_size: int = 1111  # word-level vocab (dataset-dependent)
    max_caption_len: int = 30
    rnn_size: int = 512
    cap_nheads: int = 8
    cap_dec_n_points: int = 4
    cap_num_feature_levels: int = 4
    # gpt2 caption-head geometry (defaults = HF gpt2, the reference's choice)
    cap_gpt2_n_layer: int = 12
    cap_gpt2_n_head: int = 12
    cap_gpt2_n_embd: int = 768
    cap_gpt2_vocab: int = 50257
    cap_gpt2_eos: int = 50256
    # loss coefficients (PDVC/opts.py defaults)
    cls_loss_coef: float = 2.0
    count_loss_coef: float = 0.1
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    caption_loss_coef: float = 1.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    temperature: float = 2.0  # event-count gaussian smear
    dtype: str = "float32"


# ---------------------------------------------------------------------------
# Data / training / generation / runtime configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DataConfig:
    """Dense-video-captioning data pipeline knobs.

    Reference: dataset/dvc_dataset.py:10-49 + args.py:241-299.
    """

    max_feats: int = 100
    features_dim: int = 768
    num_bins: int = 100
    max_input_tokens: int = 1000
    max_output_tokens: int = 256
    noise_density: float = 0.25
    mean_noise_span_length: float = 5.0
    # static-shape bucketing for XLA: pad token lengths up to these buckets
    # (eval-time collate; output side also applies to VC training targets,
    # where titles run far shorter than max_output_tokens)
    input_buckets: Tuple[int, ...] = (128, 256, 512, 1000)
    output_buckets: Tuple[int, ...] = (64, 128, 256)


@dataclass(frozen=True)
class GenerationConfig:
    """Decode-time parameters (reference: model/vid2seq.py:100-162)."""

    num_beams: int = 4
    max_length: int = 256
    min_length: int = 1
    top_p: float = 0.9
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0
    temperature: float = 1.0
    use_nucleus_sampling: bool = False
    # decode-time parameter dtype. Measured on v5e (beam-4/256 steps/bs16):
    # bfloat16 weights gave no speedup (5.31 vs 5.32 videos/s — the loop is
    # latency-bound, not weight-bandwidth-bound), so the default stays
    # float32 for bit-exact parity with the training forward.
    param_dtype: str = "float32"


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer + schedule (reference: dvc.py:346-351, util/misc.py:15-42)."""

    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    clip_max_norm: float = 0.1
    schedule: str = "cosine_with_warmup"  # "" | "linear_with_warmup" | cosine
    fraction_warmup_steps: float = 0.01
    # run clip+adam over ONE flattened parameter vector (optax.flatten).
    # MEASURED NEGATIVE on v5e at the bs8 recipe (round 3): the flat
    # concat/unravel adds ~2.4 GB of transient HBM (OOM: 16.23 of
    # 15.75 GB) and its bandwidth arithmetic (~13.7 ms concat + flat adam
    # + unravel + per-leaf apply_updates) is a wash against the ~15 ms
    # per-leaf tail it replaces. Kept as an option for smaller models.
    fused_flat: bool = False
    # Adam first-moment storage dtype ("float32" | "bfloat16"): bf16 mu
    # halves its HBM residency + optimizer read traffic; nu/params stay
    # f32. The reference recipe is f32 (torch Adam), so this defaults off.
    mu_dtype: str = "float32"


@dataclass(frozen=True)
class MeshConfig:
    """The mesh of ranks: a data axis (gradients summed over it,
    ``parallel/sharding.py``) and a model axis (Megatron tensor parallelism
    with the T5 encoder's residual stream sharded over the sequence,
    ``parallel/tensor_parallel.py``). Rank ``r`` sits at ``(r // mp, r %
    mp)``."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1  # 1 = pure DP

    def axis_shapes(self, n_devices: int) -> Tuple[int, int]:
        mp = max(1, self.model_parallel_size)
        if n_devices % mp:
            raise ValueError(f"a world of {n_devices} rank(s) does not tile a grid with "
                             f"model axis {mp}")
        return (n_devices // mp, mp)

    def check_widths(self, model: "Vid2SeqConfig") -> None:
        """Raise, naming the sizes, when the model axis does not divide a
        width it shards: GSPMD pads an uneven shard, the port refuses it."""
        mp = max(1, self.model_parallel_size)
        bad = {k: v for k, v in model_axis_widths(model).items() if v % mp}
        if bad:
            raise ValueError(f"model_parallel_size={mp} does not divide {bad}")


def model_axis_widths(model: "Vid2SeqConfig") -> Dict[str, int]:
    """Every width of Vid2Seq that the model axis splits: the T5 heads,
    ``d_ff`` and vocabulary (text + time tokens), the ViT heads and
    ``mlp_dim``, and the block the T5 encoder pads its sequence to (the
    residual stream is sharded over that length)."""
    t5, vit = model.t5, model.vit
    widths = {"t5.num_heads": t5.num_heads, "t5.d_ff": t5.d_ff,
              "t5.vocab_size": t5.vocab_size,
              # models/t5.SEQ_PAD_BLOCK: the encoder's padded length is a multiple
              "t5 encoder length block": 128}
    if model.use_video:
        widths.update({"vit.num_heads": vit.num_heads, "vit.mlp_dim": vit.mlp_dim})
    return widths


@dataclass
class CheckpointConfig:
    """Best/last/periodic checkpoint policy (reference: dvc.py:402-441,
    moment_detr/moment_detr/train.py:160-208, PDVC/train.py:264-347)."""

    save_dir: str = ""
    keep_last: int = 1
    keep_best: int = 1
    save_every_epochs: int = 0  # 0 = only best/last
    # cadence of the rolling ``last`` (resume) save; the reference writes
    # ckpt.pth every epoch (dvc.py:429-441) but at recipe scale a full
    # save moves GBs — raise to trade resume granularity for step time
    save_last_every_epochs: int = 1
    best_metric: str = "CIDEr"  # chapter-gen selects on CIDEr (dvc.py:402)
    best_mode: str = "max"


@dataclass
class TrainConfig:
    epochs: int = 10
    batch_size: int = 64  # rows of one rank (a process; reference: 8/GPU x 8 GPUs)
    eval_batch_size: int = 32
    seed: int = 42
    print_freq: int = 100
    generative: float = 1.0  # loss weight (args.py)
    denoising: float = 1.0
    genasr: bool = False  # HowTo100M pretrain objective (dvc.py:59-68)
    eval_every_epochs: int = 1
    # capture an XLA profile of steps [profile_start, profile_start +
    # profile_steps) in epoch 0 into profile_dir ("" = disabled)
    profile_dir: str = ""
    profile_start: int = 5
    profile_steps: int = 3
    optim: OptimConfig = field(default_factory=OptimConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


@dataclass
class ExperimentConfig:
    """Top-level experiment description for DVC / chapter-gen tasks."""

    task: str = "dvc"  # dvc | vc | grounding | pdvc
    combine_datasets: List[str] = field(default_factory=lambda: ["chapters"])
    paths: PathsConfig = field(default_factory=PathsConfig)
    datasets: Dict[str, DatasetPaths] = field(default_factory=dict)
    data: DataConfig = field(default_factory=DataConfig)
    model: Vid2SeqConfig = field(default_factory=Vid2SeqConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    tokenizer_path: str = ""  # path to spiece.model; "" = byte fallback


# ---------------------------------------------------------------------------
# (De)serialization — configs snapshot to JSON like the reference persists
# opt.json (moment_detr config.py:204-211) / info.json (PDVC/train.py:46-60).
# ---------------------------------------------------------------------------


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def save_config(cfg: Any, path: str) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def _from_dict(cls: type, d: Any) -> Any:
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    # PEP 563 (``from __future__ import annotations``) makes field.type a
    # string — resolve to real types so nested dataclasses rebuild.
    resolved = typing.get_type_hints(cls)
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in hints:
            continue
        ftype = resolved.get(k)
        origin = typing.get_origin(ftype)
        if dataclasses.is_dataclass(ftype):
            kwargs[k] = _from_dict(ftype, v)
        elif (origin is dict and isinstance(v, dict)
              and dataclasses.is_dataclass(typing.get_args(ftype)[1])):
            vcls = typing.get_args(ftype)[1]
            kwargs[k] = {kk: _from_dict(vcls, vv) for kk, vv in v.items()}
        elif origin is tuple and isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def load_config(cls: type, path: str) -> Any:
    with open(path) as f:
        return _from_dict(cls, json.load(f))
