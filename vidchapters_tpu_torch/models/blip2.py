"""BLIP-2 (ViT-g + Q-Former + Flan-T5): the zero-shot visual captioner.

Counterpart of ``vidchapters_tpu/models/blip2.py``. The reference loads
``Salesforce/blip2-flan-t5-xl`` to caption the midpoint frame of each shot
in zero-shot visual VCG (zs_visualvcg.py:249-260, prompt at 256,
``max_new_tokens=20``) and the first frame of each ground-truth clip in the
VC evaluation (vc.py:268-272, eval at vc.py:109-131). Three towers:

- vision: a pre-LN ViT with a class token, learned positions, fused qkv and
  a final post-layernorm (``patch_kernel`` is ``[d, 3*p*p]`` in the
  ``(c, ph, pw)`` flattening);
- Q-Former: a BERT-style stack over ``num_query_tokens`` learned queries,
  cross-attending into the image every ``cross_attention_frequency``
  layers;
- language model: the port's T5 (``models/t5``, gated-GELU, untied head),
  fed with the projected queries before the prompt's token embeddings.

Products run in each tower's ``dtype``; layer norms take their fp32 scale
and bias in fp32 (Flax's ``LayerNorm(dtype=...)``). ``store_in_compute_dtype``
keeps the weights that are rounded to the compute dtype before use (dense
kernels and biases, embeddings, patch weights, query tokens) in that dtype,
which gives the same numbers; norms and T5's relative-position table stay
fp32. The attentions of ViT-g and the Q-Former are plain PyTorch, as in the
JAX module. ``blip2_generate`` decodes through ``ops/decoding.
make_decode_fns`` (the standard cached decode: on the card its self- and
cross-attention kernels, and the top-k at ``num_beams > 1``).

``build_blip2_captioner`` loads an HF checkpoint directory without
``transformers``: ``config.json``, ``pytorch_model.bin`` (or its shards)
through ``models/weights.blip2_from_hf_state_dict``, and ``spiece.model``
through the port's SentencePiece reader.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vidchapters_tpu_torch.config import T5Config
from vidchapters_tpu_torch.models.t5 import RMSNorm, T5ForConditionalGeneration, _linear
from vidchapters_tpu_torch.models.vit import _layer_norm

# CLIP normalization used by the HF Blip2Processor (OPENAI_CLIP_MEAN/STD)
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclass(frozen=True)
class Blip2VisionConfig:
    hidden_size: int = 1408
    intermediate_size: int = 6144
    num_layers: int = 39
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    dtype: str = "float32"


@dataclass(frozen=True)
class QFormerConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    cross_attention_frequency: int = 2
    encoder_hidden_size: int = 1408
    layer_norm_eps: float = 1e-12
    dtype: str = "float32"


@dataclass(frozen=True)
class Blip2Config:
    vision: Blip2VisionConfig = field(default_factory=Blip2VisionConfig)
    qformer: QFormerConfig = field(default_factory=QFormerConfig)
    # flan-t5-xl: d_model 2048, gated act, untied lm head
    t5: T5Config = field(default_factory=lambda: T5Config(
        vocab_size=32128, d_model=2048, d_kv=64, d_ff=5120, num_layers=24,
        num_decoder_layers=24, num_heads=32, feed_forward_proj="gated-gelu",
        tie_word_embeddings=False, label_smoothing=0.0, dropout_rate=0.0,
        encoder_dropout=0.0, decoder_dropout=0.0))
    num_query_tokens: int = 32


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
            dt: torch.dtype) -> torch.Tensor:
    """Unmasked multi-head attention of ``[b, lq, d]`` over ``[b, lk, d]``:
    scores and softmax in fp32, p.v in ``dt``."""
    b, lq, d = q.shape
    dh = d // heads
    q, k, v = (t.reshape(b, -1, heads, dh).transpose(1, 2) for t in (q, k, v))
    scores = torch.matmul(q, k.transpose(-1, -2)).float()
    probs = torch.softmax(scores / float(np.sqrt(dh)), dim=-1)
    return torch.matmul(probs.to(dt), v).transpose(1, 2).reshape(b, lq, d)


class VisionLayer(nn.Module):
    def __init__(self, cfg: Blip2VisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, d)


class Blip2VisionModel(nn.Module):
    """Pre-LN ViT over (image_size/patch)^2 patches + class token (HF
    Blip2VisionModel; qkv fused, its k bias zero in the released weights)."""

    def __init__(self, cfg: Blip2VisionConfig):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_size, cfg.patch_size
        n = (cfg.image_size // p) ** 2
        self.patch_kernel = nn.Parameter(torch.empty(d, 3 * p * p))
        self.patch_bias = nn.Parameter(torch.zeros(d))
        self.class_embedding = nn.Parameter(torch.empty(1, 1, d))
        self.position_embedding = nn.Parameter(torch.empty(1, n + 1, d))
        self.layers = nn.ModuleList(VisionLayer(cfg) for _ in range(cfg.num_layers))
        self.post_layernorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, 3, H, W] (processor layout) -> [B, N+1, D]."""
        cfg = self.cfg
        dt = _dt(cfg)
        b = pixel_values.shape[0]
        p, d = cfg.patch_size, cfg.hidden_size
        n_side = cfg.image_size // p
        x = pixel_values.reshape(b, 3, n_side, p, n_side, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b, n_side * n_side, 3 * p * p).to(dt)
        x = torch.matmul(x, self.patch_kernel.to(dt).t()) + self.patch_bias.to(dt)
        x = torch.cat([self.class_embedding.to(dt).expand(b, 1, d), x], dim=1)
        x = x + self.position_embedding.to(dt)
        l = x.shape[1]
        for layer in self.layers:
            h = _layer_norm(x, layer.norm1, dt)
            q, k, v = _linear(h, layer.qkv, dt).view(b, l, 3, d).unbind(2)
            x = x + _linear(_attend(q, k, v, cfg.num_heads, dt), layer.proj, dt)
            h = F.gelu(_linear(_layer_norm(x, layer.norm2, dt), layer.fc1, dt))
            x = x + _linear(h, layer.fc2, dt)
        return _layer_norm(x, self.post_layernorm, dt)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross: bool):
        super().__init__()
        self.cfg = cfg
        self.has_cross = has_cross
        d = cfg.hidden_size
        parts = ("self", "cross") if has_cross else ("self",)
        for prefix in parts:
            kv_in = cfg.encoder_hidden_size if prefix == "cross" else d
            setattr(self, f"{prefix}_q", nn.Linear(d, d))
            setattr(self, f"{prefix}_k", nn.Linear(kv_in, d))
            setattr(self, f"{prefix}_v", nn.Linear(kv_in, d))
            setattr(self, f"{prefix}_out", nn.Linear(d, d))
            setattr(self, f"{prefix}_norm", nn.LayerNorm(d, eps=cfg.layer_norm_eps))
        self.intermediate_query = nn.Linear(d, cfg.intermediate_size)
        self.output_query = nn.Linear(cfg.intermediate_size, d)
        self.ff_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def _mha(self, q_in: torch.Tensor, kv_in: torch.Tensor, prefix: str) -> torch.Tensor:
        dt = _dt(self.cfg)
        lin = lambda name: getattr(self, f"{prefix}_{name}")  # noqa: E731
        attn = _attend(_linear(q_in, lin("q"), dt), _linear(kv_in, lin("k"), dt),
                       _linear(kv_in, lin("v"), dt), self.cfg.num_heads, dt)
        return _layer_norm(_linear(attn, lin("out"), dt) + q_in, lin("norm"), dt)

    def forward(self, x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        dt = _dt(self.cfg)
        x = self._mha(x, x, "self")
        if self.has_cross:
            x = self._mha(x, enc.to(dt), "cross")
        h = F.gelu(_linear(x, self.intermediate_query, dt))
        return _layer_norm(_linear(h, self.output_query, dt) + x, self.ff_norm, dt)


class QFormer(nn.Module):
    """Query-only Q-Former (the captioning path feeds no text; HF
    Blip2QFormerModel with ``query_embeds`` only)."""

    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            QFormerLayer(cfg, i % cfg.cross_attention_frequency == 0)
            for i in range(cfg.num_layers))

    def forward(self, query_embeds: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        dt = _dt(self.cfg)
        x = _layer_norm(query_embeds.to(dt), self.embed_norm, dt)
        for layer in self.layers:
            x = layer(x, enc)
        return x


class Blip2(nn.Module):
    """HF ``Blip2ForConditionalGeneration`` with a Flan-T5 language model
    (the reference's blip2-flan-t5-xl, vc.py:268-272)."""

    def __init__(self, cfg: Blip2Config):
        super().__init__()
        self.cfg = cfg
        self.vision = Blip2VisionModel(cfg.vision)
        self.qformer = QFormer(cfg.qformer)
        self.query_tokens = nn.Parameter(
            torch.empty(1, cfg.num_query_tokens, cfg.qformer.hidden_size))
        self.language_projection = nn.Linear(cfg.qformer.hidden_size, cfg.t5.d_model)
        self.t5 = T5ForConditionalGeneration(cfg.t5)

    def encode_image(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """-> projected query embeddings [B, Q, d_model]."""
        image_embeds = self.vision(pixel_values)
        queries = self.query_tokens.expand(pixel_values.shape[0], -1, -1)
        return _linear(self.qformer(queries, image_embeds), self.language_projection,
                       _dt(self.cfg.t5))

    def encode(self, pixel_values: torch.Tensor, input_ids: torch.Tensor,
               attn_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """T5-encode [image queries ; prompt tokens] -> (enc_out, enc_mask)."""
        lang = self.encode_image(pixel_values)
        embeds = torch.cat([lang, self.t5.embed(input_ids).to(lang.dtype)], dim=1)
        mask = torch.cat([torch.ones(lang.shape[:2], dtype=attn_mask.dtype,
                                     device=attn_mask.device), attn_mask], dim=1)
        return self.t5.encode(inputs_embeds=embeds, attention_mask=mask), mask

    def forward(self, pixel_values: torch.Tensor, input_ids: torch.Tensor,
                attn_mask: torch.Tensor, decoder_input_ids: torch.Tensor,
                decoder_attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        enc_out, enc_mask = self.encode(pixel_values, input_ids, attn_mask)
        if decoder_attn_mask is None:
            decoder_attn_mask = torch.ones_like(decoder_input_ids)
        return self.t5.decode(decoder_input_ids, decoder_attn_mask, enc_out, enc_mask)

    def store_in_compute_dtype(self) -> "Blip2":
        """Hold each weight that is rounded to its tower's compute dtype
        before use (dense kernels and biases, embeddings, patch weights,
        class token, positions, query tokens) in that dtype: the numbers do
        not change. The norms and T5's relative-position table stay fp32."""
        cfg, v = self.cfg, self.vision
        towers = ((self.vision, cfg.vision), (self.qformer, cfg.qformer),
                  (self.language_projection, cfg.t5), (self.t5, cfg.t5))
        params = [(p, _dt(tcfg)) for tower, tcfg in towers for mod in tower.modules()
                  if isinstance(mod, (nn.Linear, nn.Embedding))
                  for p in mod.parameters(recurse=False)]
        params += [(p, _dt(cfg.vision)) for p in (v.patch_kernel, v.patch_bias,
                                                   v.class_embedding, v.position_embedding)]
        params.append((self.query_tokens, _dt(cfg.qformer)))
        for p, dt in params:
            p.data = p.data.to(dt)
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Blip2":
        """Seeded random weights in place, drawn on ``generator``'s device:
        embeddings, patch weights, class token, positions and query tokens
        N(0, 0.02); dense kernels N(0, 1/fan_in), biases 0; norms 1 / 0; the
        T5 by ``T5ForConditionalGeneration.init_weights`` (the JAX module's
        laws, not its numbers)."""
        v = self.vision
        for p in (v.patch_kernel, v.class_embedding, v.position_embedding, self.query_tokens):
            p.normal_(0.0, 0.02, generator=generator)
        v.patch_bias.zero_()
        for tower in (self.vision, self.qformer, self.language_projection):
            for mod in tower.modules():
                if isinstance(mod, nn.Linear):
                    mod.weight.normal_(0.0, mod.in_features ** -0.5, generator=generator)
                    mod.bias.zero_()
                elif isinstance(mod, nn.LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
        self.t5.init_weights(generator)
        for mod in self.t5.modules():
            if isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
        return self


def init_blip2(cfg: Blip2Config, device="cuda", seed: int = 0) -> Blip2:
    """A ``Blip2`` of seeded random weights, allocated once on ``device``
    with its weights in their compute dtypes (``store_in_compute_dtype``;
    blip2-flan-t5-xl in bfloat16: 7.9 GB)."""
    with torch.device("meta"):
        model = Blip2(cfg).store_in_compute_dtype()
    model = model.to_empty(device=device)
    return model.init_weights(torch.Generator(device=device).manual_seed(seed)).eval()


@torch.no_grad()
def blip2_generate(model: Blip2, pixel_values: torch.Tensor, input_ids: torch.Tensor,
                   attn_mask: torch.Tensor, max_new_tokens: int = 20, num_beams: int = 1,
                   eos_token_id: int = 1) -> torch.Tensor:
    """Greedy (or beam) caption generation, the reference's
    ``model.generate(**inputs, max_new_tokens=20)`` (zs_visualvcg.py:264,
    vc.py:118), on the standard cached decode. Returns [B, max_new_tokens]
    int32 token ids, 0-padded after EOS."""
    from vidchapters_tpu_torch.ops import decoding

    enc_out, enc_mask = model.encode(pixel_values, input_ids, attn_mask)
    fns = decoding.make_decode_fns(model.t5, max_new_tokens)
    if num_beams > 1:
        return decoding.beam_search(fns, enc_out, enc_mask, max_new_tokens,
                                    num_beams=num_beams, eos_token_id=eos_token_id)
    return decoding.greedy_decode(fns, enc_out, enc_mask, max_new_tokens,
                                  eos_token_id=eos_token_id)


def preprocess_frames(frames: np.ndarray) -> np.ndarray:
    """uint8 [B, H, W, 3] (decoded video frames, 224x224) -> normalized
    [B, 3, H, W] float32, matching Blip2Processor's CLIP normalization."""
    x = frames.astype(np.float32) / 255.0
    x = (x - IMAGE_MEAN) / IMAGE_STD
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# An HF checkpoint directory, without transformers
# ---------------------------------------------------------------------------


def config_from_hf(hf: dict, dtype: str = "bfloat16") -> Blip2Config:
    """``Blip2Config`` from an HF ``config.json`` dict, the fields the JAX
    module's builder reads (vidchapters_tpu/models/blip2.py:389-418); a
    field that the file leaves out takes HF's default."""
    v, q, t = (hf.get(k, {}) for k in ("vision_config", "qformer_config", "text_config"))
    n_layers = t.get("num_layers", 6)
    return Blip2Config(
        vision=Blip2VisionConfig(
            hidden_size=v.get("hidden_size", 1408),
            intermediate_size=v.get("intermediate_size", 6144),
            num_layers=v.get("num_hidden_layers", 39),
            num_heads=v.get("num_attention_heads", 16),
            image_size=v.get("image_size", 224), patch_size=v.get("patch_size", 14),
            dtype=dtype),
        qformer=QFormerConfig(
            hidden_size=q.get("hidden_size", 768),
            num_layers=q.get("num_hidden_layers", 12),
            num_heads=q.get("num_attention_heads", 12),
            intermediate_size=q.get("intermediate_size", 3072),
            cross_attention_frequency=q.get("cross_attention_frequency", 2),
            encoder_hidden_size=q.get("encoder_hidden_size", 1408), dtype=dtype),
        t5=T5Config(
            vocab_size=t.get("vocab_size", 32128), d_model=t.get("d_model", 512),
            d_kv=t.get("d_kv", 64), d_ff=t.get("d_ff", 2048), num_layers=n_layers,
            num_decoder_layers=t.get("num_decoder_layers") or n_layers,
            num_heads=t.get("num_heads", 8), feed_forward_proj="gated-gelu",
            tie_word_embeddings=t.get("tie_word_embeddings", True),
            label_smoothing=0.0, dropout_rate=0.0, encoder_dropout=0.0,
            decoder_dropout=0.0, dtype=dtype),
        num_query_tokens=hf.get("num_query_tokens", 32))


def load_hf_state_dict(model_dir: str) -> dict:
    """The state dict of ``pytorch_model.bin``, or of the shards that
    ``pytorch_model.bin.index.json`` lists, read by ``torch.load`` on the
    CPU. A directory of safetensors only raises, naming what is missing."""
    root = Path(model_dir)
    index = root / "pytorch_model.bin.index.json"
    if index.exists():
        shards = sorted(set(json.loads(index.read_text())["weight_map"].values()))
    elif (root / "pytorch_model.bin").exists():
        shards = ["pytorch_model.bin"]
    else:
        found = sorted(p.name for p in root.glob("*.safetensors"))
        raise FileNotFoundError(
            f"{model_dir}: no pytorch_model.bin and no pytorch_model.bin.index.json"
            + (f" (found {found}: safetensors are not read, as the port does not "
               "depend on the safetensors package)" if found else ""))
    sd = {}
    for name in shards:
        sd.update(torch.load(root / name, map_location="cpu", weights_only=True))
    return sd


def encode_prompts(tokenizer, prompts) -> Tuple[np.ndarray, np.ndarray]:
    """HF ``T5TokenizerFast(prompts, padding=True)``: each prompt's ids and
    ``</s>``, padded on the right with 0 to the longest; (ids, mask) int64."""
    rows = [tokenizer.encode(p, add_special_tokens=True) for p in prompts]
    width = max(len(r) for r in rows)
    ids = np.zeros((len(rows), width), np.int64)
    mask = np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return ids, mask


def make_blip2_caption_fn(model: Blip2, tokenizer, max_new_tokens: int = 20):
    """``caption_fn(frames_uint8 [B, H, W, 3], prompt) -> list[str]`` over
    ``model`` (on its device): the frames through ``preprocess_frames``, the
    prompt through ``encode_prompts``, greedy ``blip2_generate``, and the
    tokens decoded without special tokens."""
    device = model.query_tokens.device

    def caption_fn(frames: np.ndarray, prompt: str) -> list:
        px = torch.from_numpy(preprocess_frames(frames)).to(device)
        ids, mask = encode_prompts(tokenizer, [prompt] * frames.shape[0])
        toks = blip2_generate(model, px, torch.from_numpy(ids).to(device),
                              torch.from_numpy(mask).to(device),
                              max_new_tokens=max_new_tokens)
        return tokenizer.batch_decode(toks.cpu().numpy(), skip_special_tokens=True)

    return caption_fn


def build_blip2_captioner(model_dir: str, max_new_tokens: int = 20, device=None,
                          dtype: str = "bfloat16"):
    """The reference's BLIP-2 captioner from an HF checkpoint directory
    (``config.json``, ``pytorch_model.bin`` or its shards, ``spiece.model``):
    ``make_blip2_caption_fn`` of the model, greedy, on ``device`` (the card
    unless the caller asks for the CPU) in ``dtype``."""
    from vidchapters_tpu_torch import resolve_device
    from vidchapters_tpu_torch.data.tokenizer import SentencePieceUnigramTokenizer
    from vidchapters_tpu_torch.models.weights import blip2_from_hf_state_dict

    device = resolve_device(device)
    root = Path(model_dir)
    cfg = config_from_hf(json.loads((root / "config.json").read_text()), dtype)
    tok = SentencePieceUnigramTokenizer(str(root / "spiece.model"), num_bins=0)
    with torch.device("meta"):
        model = Blip2(cfg)
    model.load_state_dict(blip2_from_hf_state_dict(load_hf_state_dict(model_dir), model),
                          assign=True)
    model = model.store_in_compute_dtype().to(device).eval()
    return make_blip2_caption_fn(model, tok, max_new_tokens)
