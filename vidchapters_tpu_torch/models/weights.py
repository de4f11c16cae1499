"""Import the JAX package's parameters into the port's modules.

Both importers take the JAX parameter tree as nested dicts of numpy arrays
(``jax.device_get(params)``) and return a ``state_dict`` of the port's
model. Dense kernels ``[in, out]`` become ``nn.Linear`` weights
``[out, in]``, Flax ``Conv`` kernels ``[k, in, out]`` become ``Conv1d``
weights ``[out, in, k]`` and ``[kh, kw, in, out]`` become ``Conv2d`` weights
``[out, in, kh, kw]``, and norm ``scale`` leaves become ``weight``. A leaf
the port has no place for, or a port parameter that no leaf fills, raises.

- ``from_jax_params``: Vid2Seq in every layout the JAX package saves:
  ``block_{i}`` -> ``blocks.{i}``, ``nn.Embed``'s ``embedding`` becomes
  ``weight``. A scanned stack (``T5Config.scan_layers`` True, "encoder" or
  "decoder", ``TemporalViTConfig.scan_layers``: one ``blocks`` subtree
  whose leaves carry a leading layer axis) is unstacked first, and the
  packed projections of ``T5Config.fused_qkv`` (self-attention ``qkv``
  ``[..., d, heads, 3, d_kv]``, cross-attention ``kv`` ``[..., d, heads, 2,
  d_kv]``) are split into q / k / v: the migration of the JAX package's
  ``utils/migrate_ckpt.py`` to its unrolled, unfused layout, done here in
  numpy (``unrolled_vid2seq_params``).
- ``pdvc_from_jax_params``: PDVC; the lists ``enc_{i}``, ``dec_{i}``,
  ``proj_{l}``, ``class_head_{i}``, ``count_head_{i}`` and ``bbox_head_{i}``
  map to ``enc_layers.{i}``, ``dec_layers.{i}``, ``proj.{l}``,
  ``class_heads.{i}``, ... The caption heads' explicit matrices
  (``embedding``, ``w_x``, ``logit_w``, ...) keep their names and their
  ``[in, out]`` orientation; the GPT-2 head's ``captioner/gpt2/block_{i}``
  maps to ``captioner.gpt2.blocks.{i}``, its ``wte`` / ``wpe`` keep their
  names.
- ``grounding_from_jax_params``: Moment-DETR; ``enc_{i}`` / ``dec_{i}`` map to
  ``enc_layers.{i}`` / ``dec_layers.{i}`` as PDVC's do; ``query_embed``
  keeps its name.
- ``clip_text_from_jax_params``: CLIP's text tower (``block_{i}`` ->
  ``blocks.{i}``); the raw ``token_embedding``, ``positional_embedding``
  and ``text_projection`` (``[width, output_dim]``, as there) keep names
  and orientation.
- ``clip_vision_from_jax_params``: CLIP's image tower, named as the text
  tower's (``patch_embed``, ``class_embedding``, ``proj``, ...).
- ``bert_from_jax_params``: BERT (``layer_{i}`` -> ``layers.{i}``); the
  three embedding tables keep their names.
- ``llama_from_jax_params``: LLaMA (``layer_{i}`` -> ``layers.{i}``); the
  embedding, the norms and the ``[vocab, d]`` head keep their names.
- ``blip2_from_jax_params``: BLIP-2; ViT-g's ``layer_{i}_{part}`` and the
  Q-Former's ``layer_{i}`` map to ``layers.{i}.{part}`` / ``layers.{i}``,
  the T5 under ``t5`` as ``from_jax_params`` maps Vid2Seq's.

Three importers read HF state dicts instead, through the JAX package's HF
converters' names (each a port copy), and raise on any name they read
nothing from: ``llama_from_hf_state_dict`` (``convert_hf_llama``; a
``rotary_emb.inv_freq`` buffer passes when it equals the model's),
``blip2_from_hf_state_dict`` (``convert_hf_blip2``; the T5's tied
``embed_tokens`` copies pass when they equal ``shared``) and
``gpt2_from_hf_state_dict`` (``convert_hf_gpt2``; the tied ``lm_head``
passes when it equals ``wte``, the attention's mask buffers when they are
the causal mask).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn

from vidchapters_tpu_torch.parallel.sharding import full_shape

_BLOCK = re.compile(r"^block_(\d+)$")
_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_LAYER = re.compile(r"^layer_(\d+)$")
_PDVC_LISTS = re.compile(r"^(enc|dec|proj|class_head|count_head|bbox_head|block)_(\d+)$")
_PDVC_LIST_NAMES = {"enc": "enc_layers", "dec": "dec_layers", "proj": "proj",
                    "class_head": "class_heads", "count_head": "count_heads",
                    "bbox_head": "bbox_heads", "block": "blocks"}


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _port_name(path: tuple) -> str:
    parts = []
    for p in path[:-1]:
        m = _BLOCK.match(p)
        parts += ["blocks", m.group(1)] if m else [p]
    return ".".join(parts + [_RENAME.get(path[-1], path[-1])])


def _pdvc_port_name(path: tuple) -> str:
    parts = []
    for p in path[:-1]:
        m = _PDVC_LISTS.match(p)
        parts += [_PDVC_LIST_NAMES[m.group(1)], m.group(2)] if m else [p]
    leaf = path[-1]
    return ".".join(parts + ["weight" if leaf in ("kernel", "scale") else leaf])


def _whisper_port_name(path: tuple) -> str:
    parts = []
    for p in path[:-1]:
        m = _LAYER.match(p)
        parts += ["layers", m.group(1)] if m else [p]
    return ".".join(parts + [_RENAME.get(path[-1], path[-1])])


def _import(params: Mapping[str, Any], model: nn.Module, name_of: Callable[[tuple], str],
            what: str) -> Dict[str, torch.Tensor]:
    # whole shapes: a model sharded over the model axis gets the whole state
    # dict, which parallel/sharding.load_full_state_dict cuts
    target = {n: torch.empty(full_shape(t), device="meta")
              for n, t in model.state_dict(keep_vars=True).items()}
    out: Dict[str, torch.Tensor] = {}
    leftover = []
    for path, arr in _flatten(params).items():
        name = name_of(path)
        if name not in target:
            leftover.append("/".join(path))
            continue
        if path[-1] == "kernel":
            if arr.ndim not in (2, 3, 4):
                leftover.append("/".join(path))
                continue
            # Dense [in, out], Conv1d [k, in, out], Conv2d [kh, kw, in, out]
            arr = arr.transpose({2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}[arr.ndim])
        t = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
        if tuple(t.shape) != tuple(target[name].shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} does not "
                             f"fit {name} {tuple(target[name].shape)}")
        out[name] = t
    missing = sorted(set(target) - set(out))
    if leftover or missing:
        raise ValueError(f"{what}: JAX leaves without a port parameter: "
                         f"{leftover}; port parameters without a JAX leaf: {missing}")
    return out


def _unstack_trees(tree) -> list:
    if isinstance(tree, Mapping):
        per_key = {k: _unstack_trees(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    arr = np.asarray(tree)
    return [arr[i] for i in range(arr.shape[0])]


def unscan_stacked_layers(stack: Mapping[str, Any]) -> Dict[str, Any]:
    """A scanned stack's ``blocks`` subtree (leading [n_layers] axis) ->
    ``block_{i}`` children; the JAX package's
    ``models/torch_import.unscan_stacked_layers``."""
    out = {k: v for k, v in stack.items() if k != "blocks"}
    for i, blk in enumerate(_unstack_trees(stack["blocks"])):
        out[f"block_{i}"] = blk
    return out


def unfuse_attention(attn: Mapping[str, Any]) -> Dict[str, Any]:
    """A packed ``qkv`` (self) or ``kv`` (cross) kernel ``[..., d, heads, P,
    d_kv]`` -> separate ``q`` / ``k`` / ``v`` kernels ``[..., d, heads *
    d_kv]``; the JAX package's ``models/torch_import._unfuse_attn``. An
    attention without a packed kernel comes back as it is."""
    key = "qkv" if "qkv" in attn else ("kv" if "kv" in attn else None)
    if key is None:
        return dict(attn)
    packed = attn[key]
    if set(packed) != {"kernel"} or np.ndim(packed["kernel"]) < 4:
        raise ValueError(f"a packed '{key}' holds {sorted(packed)} "
                         f"{[np.shape(v) for v in packed.values()]}: expected one kernel "
                         f"[..., d, heads, {3 if key == 'qkv' else 2}, d_kv]")
    fused = np.asarray(packed["kernel"])
    names = ("q", "k", "v") if key == "qkv" else ("k", "v")
    if fused.shape[-2] != len(names):
        raise ValueError(f"a packed '{key}' kernel {fused.shape} does not hold "
                         f"{len(names)} projections on its axis -2")
    flat = fused.shape[:-3] + (fused.shape[-3] * fused.shape[-1],)
    out = {k: v for k, v in attn.items() if k != key}
    for i, name in enumerate(names):
        out[name] = {"kernel": np.ascontiguousarray(fused[..., i, :]).reshape(flat)}
    return out


def _unfuse_stack(stack: Mapping[str, Any]) -> Dict[str, Any]:
    out = dict(stack)
    for key, blk in stack.items():
        if key.startswith("block_") and isinstance(blk, Mapping):
            out[key] = {k: (unfuse_attention(v) if k in ("self_attn", "cross_attn") else v)
                        for k, v in blk.items()}
    return out


def unrolled_vid2seq_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX ``Vid2Seq`` param tree in any layout the JAX package saves ->
    its default layout (``block_{i}``, separate q / k / v): each T5 stack and
    the ViT unstacked where they hold ``blocks``, then every T5 attention's
    packed kernel split. What ``utils/migrate_ckpt.migrate_params(tree,
    "unrolled", fuse="unfuse")`` gives there."""
    out = dict(params)
    if isinstance(params.get("t5"), Mapping):
        t5 = dict(params["t5"])
        for name in ("encoder", "decoder"):
            stack = t5.get(name)
            if isinstance(stack, Mapping):
                if "blocks" in stack:
                    stack = unscan_stacked_layers(stack)
                t5[name] = _unfuse_stack(stack)
        out["t5"] = t5
    vit = params.get("visual_encoder")
    if isinstance(vit, Mapping) and "blocks" in vit:
        out["visual_encoder"] = unscan_stacked_layers(vit)
    return out


def from_jax_params(params: Mapping[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX ``Vid2Seq`` params, in any layout the JAX package saves (scanned
    stacks, packed projections: ``unrolled_vid2seq_params``) -> ``model``'s
    state_dict (float32 tensors on the CPU, shapes checked against
    ``model``). For a model sharded over the model axis the whole state
    dict, for ``parallel/sharding.load_full_state_dict``."""
    return _import(unrolled_vid2seq_params(params), model, _port_name, "from_jax_params")


def pdvc_from_jax_params(params: Mapping[str, Any], model: nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """JAX ``PDVC`` params (an ``init_all`` init or a checkpoint) ->
    ``model``'s state_dict."""
    return _import(params, model, _pdvc_port_name, "pdvc_from_jax_params")


def whisper_from_jax_params(params: Mapping[str, Any], model: nn.Module
                            ) -> Dict[str, torch.Tensor]:
    """JAX ``Whisper`` params -> the port's ``Whisper`` ``model``'s
    state_dict."""
    return _import(params, model, _whisper_port_name, "whisper_from_jax_params")


_HF_LAYER = re.compile(r"^(encoder|decoder)\.layers\.(\d+)\.(.+)$")
_HF_SUBLAYER = {"self_attn.": "self_attn.", "encoder_attn.": "cross_attn.",
                "self_attn_layer_norm.": "self_attn_norm.",
                "encoder_attn_layer_norm.": "cross_attn_norm.",
                "final_layer_norm.": "ff_norm.", "fc1.": "fc1.", "fc2.": "fc2."}
_HF_PROJ = {"q_proj.": "q.", "k_proj.": "k.", "v_proj.": "v.", "out_proj.": "out."}
_HF_TOP = {"encoder.conv1.weight": "encoder.conv1.weight",
           "encoder.conv1.bias": "encoder.conv1.bias",
           "encoder.conv2.weight": "encoder.conv2.weight",
           "encoder.conv2.bias": "encoder.conv2.bias",
           "encoder.layer_norm.weight": "encoder.ln_post.weight",
           "encoder.layer_norm.bias": "encoder.ln_post.bias",
           "decoder.embed_tokens.weight": "decoder.embed_tokens.weight",
           "decoder.embed_positions.weight": "decoder.embed_positions",
           "decoder.layer_norm.weight": "decoder.ln.weight",
           "decoder.layer_norm.bias": "decoder.ln.bias"}


def _hf_port_name(name: str):
    if name in _HF_TOP:
        return _HF_TOP[name]
    m = _HF_LAYER.match(name)
    if m is None:
        return None
    side, i, rest = m.groups()
    for hf, port in _HF_SUBLAYER.items():
        if rest.startswith(hf):
            rest = port + rest[len(hf):]
            if port.endswith("attn."):
                head, tail = rest.split(".", 1)
                for hp, pp in _HF_PROJ.items():
                    if tail.startswith(hp):
                        return f"{side}.layers.{i}.{head}.{pp}{tail[len(hp):]}"
                return None
            return f"{side}.layers.{i}.{rest}"
    return None


def whisper_from_hf_state_dict(sd: Mapping[str, Any], model: nn.Module
                               ) -> Dict[str, torch.Tensor]:
    """HF ``WhisperForConditionalGeneration`` state dict (``model.`` prefix
    optional) -> the port's ``Whisper`` ``model``'s state_dict. torch's
    ``[out, in]`` and ``[out, in, k]`` layouts are the port's own, so no
    leaf is transposed. The stored encoder positions must be Whisper's
    sinusoids to the rounding of their stored dtype (fp16 and bf16
    checkpoints round them)."""
    if any(k.startswith("model.") for k in sd):
        sd = {k.removeprefix("model."): v for k, v in sd.items()}
    pos = sd.get("encoder.embed_positions.weight")
    pos_tol = max(1e-4, float(torch.finfo(pos.dtype).eps)) if isinstance(
        pos, torch.Tensor) and pos.dtype.is_floating_point else 1e-4
    arr = {k: np.asarray(v.detach().cpu().float() if isinstance(v, torch.Tensor) else v,
                         dtype=np.float32) for k, v in sd.items()}
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    leftover = []
    for name, a in arr.items():
        if name == "encoder.embed_positions.weight":
            ref = model.encoder.positions.cpu().numpy()
            if a.shape != ref.shape or not np.allclose(a, ref, atol=pos_tol, rtol=0):
                raise ValueError("whisper_from_hf_state_dict: encoder.embed_positions "
                                 "differ from Whisper's sinusoids")
            continue
        if name == "proj_out.weight":
            if not np.array_equal(a, arr.get("decoder.embed_tokens.weight")):
                raise ValueError("whisper_from_hf_state_dict: proj_out is not tied to "
                                 "decoder.embed_tokens")
            continue
        port = _hf_port_name(name)
        if port is None or port not in target:
            leftover.append(name)
            continue
        t = torch.from_numpy(np.ascontiguousarray(a))
        if tuple(t.shape) != tuple(target[port].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} does not fit {port} "
                             f"{tuple(target[port].shape)}")
        out[port] = t
    missing = sorted(set(target) - set(out))
    if leftover or missing:
        raise ValueError(f"whisper_from_hf_state_dict: HF names without a port parameter: "
                         f"{leftover}; port parameters without an HF name: {missing}")
    return out


def grounding_from_jax_params(params: Mapping[str, Any], model: nn.Module
                              ) -> Dict[str, torch.Tensor]:
    """JAX ``MomentDETR`` params -> the port's ``MomentDETR`` ``model``'s
    state_dict."""
    return _import(params, model, _pdvc_port_name, "grounding_from_jax_params")


def clip_text_from_jax_params(params: Mapping[str, Any], model: nn.Module
                              ) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPTextEncoder`` params -> the port's ``CLIPTextEncoder``
    ``model``'s state_dict."""
    return _import(params, model, _port_name, "clip_text_from_jax_params")


def clip_vision_from_jax_params(params: Mapping[str, Any], model: nn.Module
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPImageEncoder`` params -> the port's ``CLIPImageEncoder``
    ``model``'s state_dict (the patch embedding's Flax kernel [kh, kw, in,
    out] becomes the torch layout [out, in, kh, kw])."""
    return _import(params, model, _port_name, "clip_vision_from_jax_params")


def bert_from_jax_params(params: Mapping[str, Any], model: nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """JAX ``BertModel`` params -> the port's ``BertModel`` ``model``'s
    state_dict."""
    return _import(params, model, _whisper_port_name, "bert_from_jax_params")


def llama_from_jax_params(params: Mapping[str, Any], model: nn.Module
                          ) -> Dict[str, torch.Tensor]:
    """JAX ``LlamaForCausalLM`` params -> the port's ``LlamaForCausalLM``
    ``model``'s state_dict."""
    return _import(params, model, _whisper_port_name, "llama_from_jax_params")


_BLIP2_LAYER = re.compile(r"^layer_(\d+)(?:_(\w+))?$")


def _blip2_port_name(path: tuple) -> str:
    if path[0] == "t5":
        return "t5." + _port_name(path[1:])
    parts = []
    for p in path[:-1]:
        m = _BLIP2_LAYER.match(p)
        parts += (["layers", m.group(1)] + [m.group(2)] * bool(m.group(2))) if m else [p]
    return ".".join(parts + [_RENAME.get(path[-1], path[-1])])


def blip2_from_jax_params(params: Mapping[str, Any], model: nn.Module
                          ) -> Dict[str, torch.Tensor]:
    """JAX ``Blip2`` params -> the port's ``Blip2`` ``model``'s state_dict."""
    return _import(params, model, _blip2_port_name, "blip2_from_jax_params")


def _float_arrays(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v.detach().cpu().float() if isinstance(v, torch.Tensor) else v,
                          dtype=np.float32) for k, v in sd.items()}


def _all_read(reader, what: str) -> None:
    unread = sorted(set(reader.sd) - reader.read)
    if unread:
        raise ValueError(f"{what}: HF names without a port parameter: {unread}")


def llama_from_hf_state_dict(sd: Mapping[str, Any], model: nn.Module
                             ) -> Dict[str, torch.Tensor]:
    """HF ``LlamaForCausalLM`` state dict -> the port's ``LlamaForCausalLM``
    ``model``'s state_dict, through ``convert_hf_llama``'s names."""
    from vidchapters_tpu_torch.models.llama import rope_inv_freq
    from vidchapters_tpu_torch.models.torch_import import _Reader, _t

    arr = _float_arrays(sd)
    if any(k.startswith("model.model.") for k in arr):
        arr = {k.removeprefix("model."): v for k, v in arr.items()}
    r = _Reader(arr)
    tree: Dict[str, Any] = {"embed_tokens": r["model.embed_tokens.weight"],
                            "final_norm": r["model.norm.weight"],
                            "lm_head": r["lm_head.weight"]}
    parts = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
             "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
             "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
             "down_proj": "mlp.down_proj"}
    inv = rope_inv_freq(model.cfg.head_dim, model.cfg.rope_theta)
    i = 0
    while f"model.layers.{i}.input_layernorm.weight" in arr:
        lp = f"model.layers.{i}."
        tree[f"layer_{i}"] = {
            "input_norm": r[lp + "input_layernorm.weight"],
            "post_attn_norm": r[lp + "post_attention_layernorm.weight"],
            **{ours: {"kernel": _t(r[lp + hf + ".weight"])} for ours, hf in parts.items()}}
        rotary = lp + "self_attn.rotary_emb.inv_freq"
        if rotary in arr:
            if not np.allclose(r[rotary], inv, rtol=1e-6, atol=0):
                raise ValueError(f"llama_from_hf_state_dict: {rotary} differs from the "
                                 f"model's rope_theta {model.cfg.rope_theta}")
        i += 1
    _all_read(r, "llama_from_hf_state_dict")
    return llama_from_jax_params(tree, model)


def blip2_from_hf_state_dict(sd: Mapping[str, Any], model: nn.Module
                             ) -> Dict[str, torch.Tensor]:
    """HF ``Blip2ForConditionalGeneration`` (Flan-T5 variant) state dict ->
    the port's ``Blip2`` ``model``'s state_dict, through
    ``convert_hf_blip2``'s names."""
    from vidchapters_tpu_torch.models.torch_import import _Reader, _t, convert_t5_state_dict

    arr = _float_arrays(sd)
    r = _Reader(arr)
    patch = r["vision_model.embeddings.patch_embedding.weight"]            # [D, 3, p, p]

    def dense(name: str) -> Dict[str, np.ndarray]:
        return {"kernel": _t(r[name + ".weight"]), "bias": r[name + ".bias"]}

    def norm(name: str) -> Dict[str, np.ndarray]:
        return {"scale": r[name + ".weight"], "bias": r[name + ".bias"]}

    vision: Dict[str, Any] = {
        "patch_kernel": patch.reshape(patch.shape[0], -1),
        "patch_bias": r["vision_model.embeddings.patch_embedding.bias"],
        "class_embedding": r["vision_model.embeddings.class_embedding"].reshape(1, 1, -1),
        "position_embedding": r["vision_model.embeddings.position_embedding"],
        "post_layernorm": norm("vision_model.post_layernorm"),
    }
    i = 0
    while f"vision_model.encoder.layers.{i}.layer_norm1.weight" in arr:
        lp = f"vision_model.encoder.layers.{i}."
        vision.update({f"layer_{i}_norm1": norm(lp + "layer_norm1"),
                       f"layer_{i}_norm2": norm(lp + "layer_norm2"),
                       f"layer_{i}_qkv": dense(lp + "self_attn.qkv"),
                       f"layer_{i}_proj": dense(lp + "self_attn.projection"),
                       f"layer_{i}_fc1": dense(lp + "mlp.fc1"),
                       f"layer_{i}_fc2": dense(lp + "mlp.fc2")})
        i += 1

    def attention(lp: str, prefix: str) -> Dict[str, Any]:
        return {f"{prefix}_q": dense(lp + "attention.query"),
                f"{prefix}_k": dense(lp + "attention.key"),
                f"{prefix}_v": dense(lp + "attention.value"),
                f"{prefix}_out": dense(lp + "output.dense"),
                f"{prefix}_norm": norm(lp + "output.LayerNorm")}

    qformer: Dict[str, Any] = {"embed_norm": norm("qformer.layernorm")}
    i = 0
    while f"qformer.encoder.layer.{i}.attention.attention.query.weight" in arr:
        lp = f"qformer.encoder.layer.{i}."
        layer = attention(lp + "attention.", "self")
        if lp + "crossattention.attention.query.weight" in arr:
            layer.update(attention(lp + "crossattention.", "cross"))
        layer.update({"intermediate_query": dense(lp + "intermediate_query.dense"),
                      "output_query": dense(lp + "output_query.dense"),
                      "ff_norm": norm(lp + "output_query.LayerNorm")})
        qformer[f"layer_{i}"] = layer
        i += 1

    tree = {"vision": vision, "qformer": qformer, "query_tokens": r["query_tokens"],
            "language_projection": dense("language_projection"),
            "t5": convert_t5_state_dict(r, prefix="language_model.", gated=True)}
    shared = arr["language_model.shared.weight"]
    for stack in ("encoder", "decoder"):
        key = f"language_model.{stack}.embed_tokens.weight"
        if key in arr and np.array_equal(arr[key], shared):
            r.read.add(key)
    _all_read(r, "blip2_from_hf_state_dict")
    return blip2_from_jax_params(tree, model)


def gpt2_from_hf_state_dict(sd: Mapping[str, Any], model: nn.Module
                            ) -> Dict[str, torch.Tensor]:
    """HF ``GPT2Model`` / ``GPT2LMHeadModel`` state dict (``transformer.``
    prefix optional) -> the port's ``GPT2`` ``model``'s state_dict, through
    ``convert_hf_gpt2``'s names. HF's ``Conv1D`` stores ``[in, out]``, the
    JAX tree's kernel layout, which ``nn.Linear`` transposes to
    ``[out, in]``."""
    from vidchapters_tpu_torch.models.torch_import import _Reader

    arr = _float_arrays(sd)
    if any(k.startswith("transformer.") for k in arr):
        arr = {k.removeprefix("transformer."): v for k, v in arr.items()}
    r = _Reader(arr)

    def norm(name: str) -> Dict[str, np.ndarray]:
        return {"scale": r[name + ".weight"], "bias": r[name + ".bias"]}

    def conv1d(name: str) -> Dict[str, np.ndarray]:
        return {"kernel": r[name + ".weight"], "bias": r[name + ".bias"]}

    tree: Dict[str, Any] = {"wte": r["wte.weight"], "wpe": r["wpe.weight"],
                            "ln_f": norm("ln_f")}
    i = 0
    while f"h.{i}.ln_1.weight" in arr:
        lp = f"h.{i}."
        tree[f"block_{i}"] = {"ln_1": norm(lp + "ln_1"), "ln_2": norm(lp + "ln_2"),
                              "c_attn": conv1d(lp + "attn.c_attn"),
                              "c_proj": conv1d(lp + "attn.c_proj"),
                              "mlp_fc": conv1d(lp + "mlp.c_fc"),
                              "mlp_proj": conv1d(lp + "mlp.c_proj")}
        for buf in (lp + "attn.bias", lp + "attn.masked_bias"):
            if buf in arr:
                a = arr[buf]
                causal = (a.ndim == 4 and a.shape[-1] == a.shape[-2]
                          and np.array_equal(a[0, 0], np.tril(np.ones(a.shape[-2:]))))
                if not (causal or a.ndim == 0):
                    raise ValueError(f"gpt2_from_hf_state_dict: {buf} is not the causal mask")
                r.read.add(buf)
        i += 1
    if "lm_head.weight" in arr:
        if not np.array_equal(arr["lm_head.weight"], arr["wte.weight"]):
            raise ValueError("gpt2_from_hf_state_dict: lm_head is not tied to wte")
        r.read.add("lm_head.weight")
    _all_read(r, "gpt2_from_hf_state_dict")
    return _import(tree, model, _port_name, "gpt2_from_hf_state_dict")
