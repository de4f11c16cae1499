"""Shared set-up of the PyTorch port's parity tests: one small Vid2Seq
config, the JAX package's random init of it, and the port's model holding
the same weights (through ``from_jax_params``); one small BLIP-2 config;
synthetic HF checkpoint directories of seeded weights for BLIP-2, BERT
(with a WordPiece ``vocab.txt``) and LLaMA (with a SentencePiece BPE
``tokenizer.model``), as ``.bin`` or safetensors, one file or shards,
written without ``transformers`` or ``safetensors`` (``chip_smoke.py``
writes them too). Nothing here imports jax until a function that needs it
is called."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def small_cfgs(num_decoder_layers: int = 2, feed_forward_proj: str = "relu",
               dtype: str = "float32"):
    """(JAX Vid2SeqConfig, port Vid2SeqConfig) at d 128, 2+2 layers, 4
    heads, compute in ``dtype`` (fp32 by default): the same fields in both
    packages."""
    from vidchapters_tpu import config as jc
    from vidchapters_tpu_torch import config as tc

    def make(m):
        t5 = m.T5Config(vocab_size=32200, d_model=128, d_kv=32, d_ff=256,
                        num_layers=2, num_decoder_layers=num_decoder_layers,
                        num_heads=4, dropout_rate=0.0, encoder_dropout=0.0,
                        decoder_dropout=0.0, dtype=dtype,
                        feed_forward_proj=feed_forward_proj)
        vit = m.TemporalViTConfig(num_features=16, embed_dim=128, depth=2,
                                  num_heads=4, mlp_dim=256, dtype=dtype)
        return m.Vid2SeqConfig(t5=t5, vit=vit, num_bins=100)

    return make(jc), make(tc)


def jax_params(jcfg, seed: int = 0):
    """The JAX package's Vid2Seq and its random init as numpy arrays."""
    import jax
    import jax.numpy as jnp

    from vidchapters_tpu.models.vid2seq import Vid2Seq

    model = Vid2Seq(jcfg)
    rng = jax.random.PRNGKey(seed)
    toks = jnp.ones((1, 8), jnp.int32)
    params = model.init({"params": rng, "dropout": rng},
                        jnp.zeros((1, jcfg.vit.num_features, jcfg.vit.embed_dim)),
                        toks, toks, toks)["params"]
    return model, jax.device_get(params)


def port_model(tcfg, params):
    """The port's Vid2Seq on the CPU, loaded with the JAX params."""
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.models.weights import from_jax_params

    model = Vid2Seq(tcfg)
    model.load_state_dict(from_jax_params(params, model))
    return model.eval()


def batch(rng: np.random.Generator, b: int = 2, t: int = 16, d: int = 128,
          s: int = 20, out: int = 12):
    """Random video features, input tokens with padding, output labels."""
    video = rng.normal(size=(b, t, d)).astype(np.float32)
    tokens = rng.integers(3, 32200, size=(b, s)).astype(np.int32)
    tokens[0, s - 5:] = 0
    labels = rng.integers(3, 32200, size=(b, out)).astype(np.int32)
    labels[1, out - 3:] = 0
    return video, tokens, labels


def blip2_small_cfgs(vocab: int = 120, dtype: str = "float32"):
    """(JAX Blip2Config, port Blip2Config) of the same small sizes: ViT 2 x
    32 over 28-pixel images in 14-pixel patches, Q-Former 2 x 32, T5 2+2 x 32
    gated-GELU, 4 query tokens."""
    from vidchapters_tpu import config as jc
    from vidchapters_tpu.models import blip2 as jb
    from vidchapters_tpu_torch import config as tc
    from vidchapters_tpu_torch.models import blip2 as tb

    def make(m, c):
        return m.Blip2Config(
            vision=m.Blip2VisionConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                                       num_heads=4, image_size=28, patch_size=14, dtype=dtype),
            qformer=m.QFormerConfig(hidden_size=32, num_layers=2, num_heads=4,
                                    intermediate_size=48, cross_attention_frequency=2,
                                    encoder_hidden_size=32, dtype=dtype),
            t5=c.T5Config(vocab_size=vocab, d_model=32, d_kv=8, d_ff=48, num_layers=2,
                          num_decoder_layers=2, num_heads=4, feed_forward_proj="gated-gelu",
                          tie_word_embeddings=False, label_smoothing=0.0, dropout_rate=0.0,
                          encoder_dropout=0.0, decoder_dropout=0.0, dtype=dtype),
            num_query_tokens=4)

    return make(jb, jc), make(tb, tc)


def blip2_hf_state_dict(cfg, seed: int = 0):
    """A state dict of ``cfg``'s BLIP-2 (a ``models.blip2.Blip2Config``)
    under HF ``Blip2ForConditionalGeneration``'s names, seeded random float32
    tensors: N(0, 1/fan_in) matrices, T5's ``shared`` N(0, 1), the other
    tensors N(0, 0.02), norm scales 1 + N(0, 0.1); the T5's tied
    ``embed_tokens`` copies equal ``shared``."""
    import numpy as np
    import torch

    v, q, t = cfg.vision, cfg.qformer, cfg.t5
    d, p, dq = v.hidden_size, v.patch_size, q.hidden_size
    lm = "language_model."
    shapes = {"query_tokens": (1, cfg.num_query_tokens, dq),
              "vision_model.embeddings.class_embedding": (1, 1, d),
              "vision_model.embeddings.position_embedding": (1, (v.image_size // p) ** 2 + 1, d),
              "vision_model.embeddings.patch_embedding.weight": (d, 3, p, p),
              "vision_model.embeddings.patch_embedding.bias": (d,)}
    scales = set()

    def dense(name, n_out, n_in, bias=True):
        shapes[name + ".weight"] = (n_out, n_in)
        if bias:
            shapes[name + ".bias"] = (n_out,)

    def norm(name, n, bias=True):
        shapes[name + ".weight"] = (n,)
        scales.add(name + ".weight")
        if bias:
            shapes[name + ".bias"] = (n,)

    norm("vision_model.post_layernorm", d)
    for i in range(v.num_layers):
        lp = f"vision_model.encoder.layers.{i}."
        norm(lp + "layer_norm1", d)
        norm(lp + "layer_norm2", d)
        dense(lp + "self_attn.qkv", 3 * d, d)
        dense(lp + "self_attn.projection", d, d)
        dense(lp + "mlp.fc1", v.intermediate_size, d)
        dense(lp + "mlp.fc2", d, v.intermediate_size)
    norm("qformer.layernorm", dq)
    for i in range(q.num_layers):
        lp = f"qformer.encoder.layer.{i}."
        parts = ["attention."] + ["crossattention."] * (i % q.cross_attention_frequency == 0)
        for part in parts:
            n_kv = q.encoder_hidden_size if part == "crossattention." else dq
            dense(lp + part + "attention.query", dq, dq)
            dense(lp + part + "attention.key", dq, n_kv)
            dense(lp + part + "attention.value", dq, n_kv)
            dense(lp + part + "output.dense", dq, dq)
            norm(lp + part + "output.LayerNorm", dq)
        dense(lp + "intermediate_query.dense", q.intermediate_size, dq)
        dense(lp + "output_query.dense", dq, q.intermediate_size)
        norm(lp + "output_query.LayerNorm", dq)
    dense("language_projection", t.d_model, dq)
    inner = t.num_heads * t.d_kv
    shapes[lm + "shared.weight"] = (t.vocab_size, t.d_model)
    dense(lm + "lm_head", t.vocab_size, t.d_model, bias=False)
    for stack, n in (("encoder", t.num_layers), ("decoder", t.num_decoder_layers)):
        norm(f"{lm}{stack}.final_layer_norm", t.d_model, bias=False)
        shapes[f"{lm}{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
            t.relative_attention_num_buckets, t.num_heads)
        for i in range(n):
            bp = f"{lm}{stack}.block.{i}.layer."
            for a in ["0.SelfAttention"] + ["1.EncDecAttention"] * (stack == "decoder"):
                for w in "qkv":
                    dense(f"{bp}{a}.{w}", inner, t.d_model, bias=False)
                dense(f"{bp}{a}.o", t.d_model, inner, bias=False)
                norm(bp + a[:2] + "layer_norm", t.d_model, bias=False)
            ff = bp + ("2." if stack == "decoder" else "1.")
            dense(ff + "DenseReluDense.wi_0", t.d_ff, t.d_model, bias=False)
            dense(ff + "DenseReluDense.wi_1", t.d_ff, t.d_model, bias=False)
            dense(ff + "DenseReluDense.wo", t.d_model, t.d_ff, bias=False)
            norm(ff + "layer_norm", t.d_model, bias=False)
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in shapes.items():
        x = rng.standard_normal(shape)
        if name in scales:
            x = 1.0 + 0.1 * x
        elif name == lm + "shared.weight":
            pass
        elif len(shape) == 2:
            x = x * shape[1] ** -0.5
        else:
            x = 0.02 * x
        sd[name] = torch.from_numpy(x.astype(np.float32))
    for stack in ("encoder", "decoder"):
        sd[f"{lm}{stack}.embed_tokens.weight"] = sd[lm + "shared.weight"].clone()
    return sd


def blip2_hf_config(cfg) -> dict:
    """``config.json`` of an HF BLIP-2 checkpoint of ``cfg``'s sizes."""
    v, q, t = cfg.vision, cfg.qformer, cfg.t5
    return {"model_type": "blip-2", "num_query_tokens": cfg.num_query_tokens,
            "vision_config": {"hidden_size": v.hidden_size,
                              "intermediate_size": v.intermediate_size,
                              "num_hidden_layers": v.num_layers,
                              "num_attention_heads": v.num_heads,
                              "image_size": v.image_size, "patch_size": v.patch_size},
            "qformer_config": {"hidden_size": q.hidden_size, "num_hidden_layers": q.num_layers,
                               "num_attention_heads": q.num_heads,
                               "intermediate_size": q.intermediate_size,
                               "cross_attention_frequency": q.cross_attention_frequency,
                               "encoder_hidden_size": q.encoder_hidden_size},
            "text_config": {"model_type": "t5", "vocab_size": t.vocab_size,
                            "d_model": t.d_model, "d_kv": t.d_kv, "d_ff": t.d_ff,
                            "num_layers": t.num_layers,
                            "num_decoder_layers": t.num_decoder_layers,
                            "num_heads": t.num_heads, "feed_forward_proj": "gated-gelu",
                            "tie_word_embeddings": False}}


def write_blip2_dir(root: Path, cfg, seed: int = 0, shards: int = 1) -> Path:
    """An HF BLIP-2 checkpoint directory of seeded random weights:
    ``config.json``, ``pytorch_model.bin`` (or ``shards`` files and their
    ``pytorch_model.bin.index.json``) and a synthetic ``spiece.model`` of
    T5's 32,000 pieces (``chip_smoke._write_spm_model``)."""
    import torch

    from chip_smoke import _write_spm_model

    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(blip2_hf_config(cfg)))
    sd = blip2_hf_state_dict(cfg, seed)
    if shards == 1:
        torch.save(sd, root / "pytorch_model.bin")
    else:
        names = sorted(sd)
        weight_map = {}
        for k in range(shards):
            fname = f"pytorch_model-{k + 1:05d}-of-{shards:05d}.bin"
            part = names[k::shards]
            torch.save({n: sd[n] for n in part}, root / fname)
            weight_map.update({n: fname for n in part})
        (root / "pytorch_model.bin.index.json").write_text(
            json.dumps({"metadata": {}, "weight_map": weight_map}))
    _write_spm_model(root / "spiece.model")
    return root


_SAFETENSORS_NAMES = {"float64": "F64", "float32": "F32", "float16": "F16",
                      "bfloat16": "BF16", "int64": "I64", "int32": "I32", "int16": "I16",
                      "int8": "I8", "uint8": "U8", "bool": "BOOL"}


def write_safetensors(path: Path, tensors) -> Path:
    """``tensors`` (a dict of torch tensors) as one ``.safetensors`` file,
    written without the ``safetensors`` package: the 8-byte little-endian
    header length, the JSON header (``__metadata__`` ``{"format": "pt"}``,
    each tensor's dtype, shape and byte range), padded with spaces to 8
    bytes, then the raw data, the widest dtypes first so every tensor is
    aligned."""
    import struct

    import torch

    order = sorted(tensors, key=lambda n: (-tensors[n].element_size(), n))
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name in order:
        t = tensors[name]
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _SAFETENSORS_NAMES[str(t.dtype).removeprefix("torch.")],
                        "shape": list(t.shape), "data_offsets": [offset, offset + size]}
        offset += size
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:  # tensor by tensor: no copy of the whole file in memory
        f.write(struct.pack("<Q", len(head)) + head)
        for name in order:
            t = tensors[name].detach().cpu().contiguous()
            if t.numel():
                f.write(t.view(-1).view(torch.uint8).numpy().data)
    return path


def _save_weights(root: Path, sd, fmt: str, shards: int) -> None:
    """``sd`` as ``pytorch_model.bin`` or ``model.safetensors`` (``fmt``
    "bin" / "safetensors"), or as ``shards`` files and their index."""
    import torch

    single = {"bin": "pytorch_model.bin", "safetensors": "model.safetensors"}[fmt]
    save = (lambda part, path: torch.save(part, path)) if fmt == "bin" else (
        lambda part, path: write_safetensors(path, part))
    if shards == 1:
        save(sd, root / single)
        return
    stem, ext = single.split(".")
    names, weight_map = sorted(sd), {}
    for k in range(shards):
        fname = f"{stem}-{k + 1:05d}-of-{shards:05d}.{ext}"
        part = names[k::shards]
        save({n: sd[n] for n in part}, root / fname)
        weight_map.update({n: fname for n in part})
    (root / f"{single}.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))


def _seeded(shapes, scales, seed: int, dtype=None):
    """Seeded random float32 tensors (cast to ``dtype``): N(0, 1/fan_in)
    matrices, N(0, 0.02) other tensors, norm scales 1 + N(0, 0.1)."""
    import torch

    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in shapes.items():
        x = rng.standard_normal(shape, dtype=np.float32)
        if name in scales:
            x = 1.0 + 0.1 * x
        elif len(shape) == 2 and "embed" not in name:
            x *= shape[1] ** -0.5
        else:
            x *= 0.02
        sd[name] = torch.from_numpy(x).to(dtype or torch.float32)
    return sd


# ---------------------------------------------------------------------------
# BERT: a synthetic WordPiece vocab.txt and HF BertModel /
# BertForSequenceClassification directories
# ---------------------------------------------------------------------------


BERT_WORDS = ("the this video is great awful terrible nice content hello world cook bake "
              "bread dough oven mix flour sugar salt water butter slice serve knead rest "
              "minutes eggs whisk fold let it we in of and then step add").split()


def write_wordpiece_vocab(path: Path, size: int = 0) -> Path:
    """A BERT ``vocab.txt``: ``[PAD]``, 99 ``[unused]``, ``[UNK]``, ``[CLS]``,
    ``[SEP]``, ``[MASK]`` at bert-base-uncased's ids 0-103, then every
    printable ASCII character, ``##`` + each letter and digit, BERT_WORDS,
    their prefixes of 3+ letters and ``##`` suffixes of 2+ letters, a few
    accented and CJK characters, then ``[unused]`` filler up to ``size``."""
    import string

    tokens = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                                "[MASK]"]
    seen = set(tokens)

    def add(t):
        if t not in seen:
            seen.add(t)
            tokens.append(t)

    for c in string.printable.strip():
        add(c.lower())
    for c in string.ascii_lowercase + string.digits:
        add("##" + c)
    for w in BERT_WORDS:
        add(w)
    for w in BERT_WORDS:
        for k in range(3, len(w)):
            add(w[:k])
            add("##" + w[len(w) - k + 1:])
    for c in "éèàüöñç中文字":
        add(c)
    i = 99
    while len(tokens) < size:
        add(f"[unused{i}]")
        i += 1
    path.write_text("\n".join(tokens) + "\n", encoding="utf-8")
    return path


def bert_hf_config(cfg, num_labels: int = 0) -> dict:
    """``config.json`` of an HF BERT checkpoint of ``cfg``'s sizes (a
    ``models.bert.BertConfig``); ``num_labels`` > 0: a sequence
    classifier."""
    out = {"model_type": "bert", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
           "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
           "intermediate_size": cfg.intermediate_size,
           "max_position_embeddings": cfg.max_position_embeddings,
           "type_vocab_size": cfg.type_vocab_size, "layer_norm_eps": cfg.layer_norm_eps,
           "hidden_act": "gelu", "hidden_dropout_prob": 0.0,
           "attention_probs_dropout_prob": 0.0, "pad_token_id": 0,
           "architectures": ["BertModel"]}
    if num_labels:
        out.update(architectures=["BertForSequenceClassification"],
                   id2label={str(i): f"LABEL_{i}" for i in range(num_labels)},
                   label2id={f"LABEL_{i}": i for i in range(num_labels)},
                   problem_type="multi_label_classification")
    return out


def bert_hf_state_dict(cfg, seed: int = 0, num_labels: int = 0, dtype=None):
    """A state dict of ``cfg``'s BERT under HF's names, seeded: ``BertModel``'s
    (with its pooler) or, with ``num_labels``, ``BertForSequenceClassification``'s
    (``bert.`` prefix, ``classifier``)."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    pre = "bert." if num_labels else ""
    shapes = {pre + "embeddings.word_embeddings.weight": (cfg.vocab_size, d),
              pre + "embeddings.position_embeddings.weight": (cfg.max_position_embeddings, d),
              pre + "embeddings.token_type_embeddings.weight": (cfg.type_vocab_size, d)}
    scales = set()

    def dense(name, n_out, n_in):
        shapes[name + ".weight"] = (n_out, n_in)
        shapes[name + ".bias"] = (n_out,)

    def norm(name):
        shapes[name + ".weight"] = (d,)
        shapes[name + ".bias"] = (d,)
        scales.add(name + ".weight")

    norm(pre + "embeddings.LayerNorm")
    for i in range(cfg.num_layers):
        lp = f"{pre}encoder.layer.{i}."
        for part in ("query", "key", "value"):
            dense(lp + "attention.self." + part, d, d)
        dense(lp + "attention.output.dense", d, d)
        norm(lp + "attention.output.LayerNorm")
        dense(lp + "intermediate.dense", f, d)
        dense(lp + "output.dense", d, f)
        norm(lp + "output.LayerNorm")
    dense(pre + "pooler.dense", d, d)
    if num_labels:
        dense("classifier", num_labels, d)
    return _seeded(shapes, scales, seed, dtype)


def write_bert_dir(root: Path, cfg, seed: int = 0, num_labels: int = 0, fmt: str = "bin",
                   shards: int = 1, do_lower_case: bool = True) -> Path:
    """An HF BERT checkpoint directory of seeded weights: ``config.json``,
    ``vocab.txt`` (``write_wordpiece_vocab`` at ``cfg.vocab_size``),
    ``tokenizer_config.json`` and the weights (``_save_weights``)."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(bert_hf_config(cfg, num_labels)))
    write_wordpiece_vocab(root / "vocab.txt", cfg.vocab_size)
    (root / "tokenizer_config.json").write_text(json.dumps(
        {"do_lower_case": do_lower_case, "tokenizer_class": "BertTokenizer",
         "model_max_length": cfg.max_position_embeddings}))
    _save_weights(root, bert_hf_state_dict(cfg, seed, num_labels), fmt, shards)
    return root


# ---------------------------------------------------------------------------
# LLaMA: a synthetic SentencePiece BPE tokenizer.model and HF directories
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b, n = n & 0x7F, n >> 7
        if not n:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _proto_field(field: int, value) -> bytes:
    """One protobuf field: an int as a varint, bytes / str length-delimited."""
    if isinstance(value, int):
        return _varint(field << 3) + _varint(value)
    data = value.encode("utf-8") if isinstance(value, str) else value
    return _varint(field << 3 | 2) + _varint(len(data)) + data


def bpe_merges(words, n_merges: int):
    """The pieces a BPE trainer makes from ``words`` (each ``▁`` + the
    word), in order: each round merges the most frequent adjacent pair (the
    smallest on a tie)."""
    from collections import Counter

    corpus = Counter(tuple("▁" + w) for w in words)
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for word, n in corpus.items():
            for a, b in zip(word, word[1:]):
                pairs[a, b] += n
        if not pairs:
            break
        best = max(pairs.values())
        a, b = min(p for p, n in pairs.items() if n == best)
        merges.append(a + b)
        new = Counter()
        for word, n in corpus.items():
            out, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            new[tuple(out)] += n
        corpus = new
    return merges


BPE_WORDS = BERT_WORDS + ("chapter title video recipe cooking part one two three intro "
                          "outro summary final tips").split()


def bpe_model_pieces(words=BPE_WORDS, vocab_size: int = 0, n_merges: int = 400,
                     extra=()):
    """LLaMA's piece layout: ``<unk>``, ``<s>``, ``</s>``, the 256 ``<0xXX>``
    byte pieces, the merges of ``bpe_merges(words)`` and then ``extra``
    pieces, scored 0, -1, -2, ... in that order, the single characters (the
    words' and printable ASCII) below them, then private-use characters as
    filler up to ``vocab_size``."""
    import string

    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    seen = {p for p, _, _ in pieces}
    chars = sorted({c for w in words for c in w} | set(string.printable.strip()) | {"▁"})
    score = 0.0
    for p in list(bpe_merges(words, n_merges)) + list(extra):
        if p not in seen:
            seen.add(p)
            pieces.append((p, score, 1))
            score -= 1.0
    for c in chars:
        if c not in seen:
            seen.add(c)
            pieces.append((c, score, 1))
            score -= 1.0
    k = 0
    while len(pieces) < vocab_size:
        pieces.append((chr(0xE000 + k), score - k, 1))
        k += 1
    return pieces


def write_bpe_model(path: Path, pieces, byte_fallback: bool = True,
                    add_dummy_prefix: bool = True, normalizer: str = "identity",
                    remove_extra_whitespaces: bool = False) -> Path:
    """A sentencepiece ``ModelProto`` of ``pieces`` ((piece, score, type))
    with ``trainer_spec.model_type`` BPE and LLaMA's specs by default."""
    import struct

    body = b""
    for piece, score, ptype in pieces:
        sub = (_proto_field(1, piece) + _varint(2 << 3 | 5) + struct.pack("<f", score)
               + _proto_field(3, ptype))
        body += _proto_field(1, sub)
    trainer = (_proto_field(3, 2) + _proto_field(4, len(pieces))
               + _proto_field(35, int(byte_fallback)) + _proto_field(40, 0)
               + _proto_field(41, 1) + _proto_field(42, 2))
    norm = (_proto_field(1, normalizer) + _proto_field(3, int(add_dummy_prefix))
            + _proto_field(4, int(remove_extra_whitespaces)) + _proto_field(5, 1))
    path.write_bytes(body + _proto_field(2, trainer) + _proto_field(3, norm))
    return path


def llama_hf_config(cfg) -> dict:
    """``config.json`` of an HF LLaMA checkpoint of ``cfg``'s sizes."""
    return {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
            "bos_token_id": cfg.bos_id, "eos_token_id": cfg.eos_id,
            "tie_word_embeddings": False, "hidden_act": "silu"}


def llama_hf_state_dict(cfg, seed: int = 0, dtype=None):
    """A state dict of ``cfg``'s LLaMA under HF ``LlamaForCausalLM``'s
    names, seeded (``_seeded``), in ``dtype`` (float32 by default)."""
    d, f, kv = cfg.hidden_size, cfg.intermediate_size, cfg.num_kv_heads * cfg.head_dim
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, d), "model.norm.weight": (d,),
              "lm_head.weight": (cfg.vocab_size, d)}
    scales = {"model.norm.weight"}
    for i in range(cfg.num_layers):
        lp = f"model.layers.{i}."
        shapes.update({lp + "self_attn.q_proj.weight": (d, d),
                       lp + "self_attn.k_proj.weight": (kv, d),
                       lp + "self_attn.v_proj.weight": (kv, d),
                       lp + "self_attn.o_proj.weight": (d, d),
                       lp + "mlp.gate_proj.weight": (f, d), lp + "mlp.up_proj.weight": (f, d),
                       lp + "mlp.down_proj.weight": (d, f),
                       lp + "input_layernorm.weight": (d,),
                       lp + "post_attention_layernorm.weight": (d,)})
        scales |= {lp + "input_layernorm.weight", lp + "post_attention_layernorm.weight"}
    return _seeded(shapes, scales, seed, dtype)


def write_llama_dir(root: Path, cfg, seed: int = 0, fmt: str = "safetensors", shards: int = 1,
                    dtype=None, pieces=None) -> Path:
    """An HF LLaMA checkpoint directory of seeded weights: ``config.json``,
    the weights (``_save_weights``, in ``dtype``) and a synthetic BPE
    ``tokenizer.model`` (``bpe_model_pieces`` at ``cfg.vocab_size`` unless
    ``pieces`` is given)."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(llama_hf_config(cfg)))
    _save_weights(root, llama_hf_state_dict(cfg, seed, dtype), fmt, shards)
    write_bpe_model(root / "tokenizer.model",
                    pieces or bpe_model_pieces(vocab_size=cfg.vocab_size))
    return root


# -- Whisper: the byte-level BPE tokenizer and the HF checkpoint directory ---------

WHISPER_TEXTS = ("We whisk the eggs, then fold in 250 g of flour. Don't over-mix it; "
                 "it'll be tough!\nCafé crème brûlée à la française, déjà vu.\n"
                 "今日は料理をします。鶏肉と野菜を切ります。 🍳🥚 emoji 👍🏽\n"
                 "Numbers: 3.14, 2024, ½ and ²; tabs\there   and  runs    of spaces.\n"
                 "I'm sure you've seen it, they're here, we'd go, she's done, I'll try.\n"
                 "Приготовим борщ. Ελληνικά γράμματα. עברית. العربية.\n")


def whisper_special_tokens():
    """Whisper's added tokens in id order from 50257: ``<|endoftext|>``,
    ``<|startoftranscript|>``, the 99 language tokens, the task and control
    tokens, then the 1501 timestamps ``<|0.00|>`` .. ``<|30.00|>``."""
    from vidchapters_tpu_torch.factory.whisper_transcribe import WHISPER_LANGUAGES

    return (["<|endoftext|>", "<|startoftranscript|>"] + [f"<|{c}|>" for c in WHISPER_LANGUAGES]
            + ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
               "<|nocaptions|>", "<|notimestamps|>"]
            + [f"<|{i * 0.02:.2f}|>" for i in range(1501)])


WHISPER_N_SPECIAL = 107  # <|endoftext|> .. <|notimestamps|>; the timestamps are not special


def byte_bpe_merges(texts, n_merges: int):
    """Byte-level BPE merges trained on ``texts`` without ``tokenizers``: the
    port's GPT-2 pre-tokenizer, each piece's bytes through the byte-to-
    unicode table, then rounds that merge the most frequent adjacent pair
    (the smallest on a tie). Returns [(a, b)] in rank order."""
    from collections import Counter

    from vidchapters_tpu_torch.data.clip_tokenizer import bpe_merge, bytes_to_unicode
    from vidchapters_tpu_torch.data.whisper_tokenizer import pretokenize

    enc = bytes_to_unicode()
    corpus = Counter(tuple(enc[b] for b in piece.encode("utf-8"))
                     for text in texts for piece in pretokenize(text))
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for word, n in corpus.items():
            for a, b in zip(word, word[1:]):
                pairs[a, b] += n
        if not pairs:
            break
        best = max(pairs.values())
        a, b = min(p for p, n in pairs.items() if n == best)
        merges.append((a, b))
        new = Counter()
        for word, n in corpus.items():
            new[tuple(bpe_merge(word, {(a, b): 0}))] += n
        corpus = new
    return merges


def whisper_vocab(merges, size: int = 50257, base=None):
    """A ``vocab.json`` dict of ``size`` entries: ``base`` (a trained
    vocabulary) or GPT-2's 256 byte symbols and each merge's result, then
    two-symbol filler pieces (no merge makes them; most decode to invalid
    UTF-8) up to ``size``."""
    from vidchapters_tpu_torch.data.clip_tokenizer import bytes_to_unicode

    symbols = list(bytes_to_unicode().values())
    vocab = dict(sorted(base.items(), key=lambda kv: kv[1])) if base else {}
    assert list(vocab.values()) == list(range(len(vocab))), "base ids must be 0 .. n-1"
    for tok in [] if base else symbols + [a + b for a, b in merges]:
        vocab.setdefault(tok, len(vocab))
    for a in symbols:
        for b in symbols:
            if len(vocab) >= size:
                return vocab
            vocab.setdefault(a + b, len(vocab))
    return vocab


def write_whisper_tokenizer(root: Path, vocab, merges, layout: str = "config") -> Path:
    """Whisper's tokenizer files in ``root``: ``vocab.json`` and
    ``merges.txt`` (``#version: 0.2`` and one ``a b`` line a merge), with
    the added tokens of ``whisper_special_tokens`` from id ``len(vocab)``
    either in ``tokenizer_config.json``'s ``added_tokens_decoder`` (``layout``
    "config", as ``save_pretrained`` writes them now) or in
    ``added_tokens.json`` + ``special_tokens_map.json`` ("added_tokens", the
    older layout). The first ``WHISPER_N_SPECIAL`` are special."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (root / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges), encoding="utf-8")
    tokens = whisper_special_tokens()
    special = tokens[:WHISPER_N_SPECIAL]
    conf = {"tokenizer_class": "WhisperTokenizer", "errors": "replace",
            "bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
            "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>",
            "add_prefix_space": False, "model_max_length": 1024,
            "clean_up_tokenization_spaces": True}  # as OpenAI's; the slow tokenizer ignores it
    if layout == "config":
        conf["added_tokens_decoder"] = {
            str(len(vocab) + k): {"content": t, "lstrip": False, "rstrip": False,
                                  "normalized": False, "single_word": False,
                                  "special": k < WHISPER_N_SPECIAL}
            for k, t in enumerate(tokens)}
        conf["additional_special_tokens"] = special
    else:
        (root / "added_tokens.json").write_text(
            json.dumps({t: len(vocab) + k for k, t in enumerate(tokens)}))
        (root / "special_tokens_map.json").write_text(json.dumps(
            {"bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
             "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>",
             "additional_special_tokens": special}))
    (root / "tokenizer_config.json").write_text(json.dumps(conf))
    return root


def whisper_hf_config(cfg) -> dict:
    """The ``config.json`` of an HF ``WhisperForConditionalGeneration`` at
    the port's ``WhisperConfig`` ``cfg`` (the fields both loaders read, and
    the token ids of the multilingual vocabulary)."""
    return {"architectures": ["WhisperForConditionalGeneration"], "model_type": "whisper",
            "vocab_size": cfg.vocab_size, "num_mel_bins": cfg.num_mel_bins,
            "max_source_positions": cfg.max_source_positions,
            "max_target_positions": cfg.max_target_positions, "d_model": cfg.d_model,
            "encoder_layers": cfg.encoder_layers, "decoder_layers": cfg.decoder_layers,
            "encoder_attention_heads": cfg.num_heads, "decoder_attention_heads": cfg.num_heads,
            "encoder_ffn_dim": cfg.d_ff, "decoder_ffn_dim": cfg.d_ff,
            "activation_function": "gelu", "scale_embedding": False,
            "pad_token_id": 50257, "bos_token_id": 50257, "eos_token_id": 50257,
            "decoder_start_token_id": 50258, "torch_dtype": "float16"}


def whisper_hf_state_dict(model, dtype=None):
    """The port's ``Whisper`` ``model``'s weights under HF's names
    (``model.`` prefix, ``encoder.embed_positions.weight`` the sinusoids,
    no tied ``proj_out.weight``, as ``save_pretrained`` leaves it out), on
    the CPU in ``dtype``; names found through the import's own map."""
    from vidchapters_tpu_torch.models.weights import _hf_port_name

    cfg = model.cfg
    parts = {"self_attn.": ("q_proj.", "k_proj.", "v_proj.", "out_proj."),
             "encoder_attn.": ("q_proj.", "k_proj.", "v_proj.", "out_proj.")}
    norms = ("self_attn_layer_norm.", "encoder_attn_layer_norm.", "final_layer_norm.")
    names = ["encoder.conv1.", "encoder.conv2.", "encoder.layer_norm.", "decoder.layer_norm.",
             "decoder.embed_tokens.", "decoder.embed_positions."]
    for side, n in (("encoder", cfg.encoder_layers), ("decoder", cfg.decoder_layers)):
        for i in range(n):
            lp = f"{side}.layers.{i}."
            names += [lp + a + p for a, ps in parts.items() for p in ps]
            names += [lp + x for x in norms + ("fc1.", "fc2.")]
    port = model.state_dict()
    sd = {}
    for stem in names:
        for leaf in ("weight", "bias"):
            target = _hf_port_name(stem + leaf)
            if target in port:
                sd["model." + stem + leaf] = port[target].detach().to("cpu", dtype)
    sd["model.encoder.embed_positions.weight"] = model.encoder.positions.detach().to("cpu", dtype)
    return sd


def write_whisper_dir(root: Path, model, dtype=None, fmt: str = "safetensors",
                      shards: int = 1, n_merges: int = 400, layout: str = "config") -> Path:
    """An HF Whisper checkpoint directory of the port's ``model``:
    ``config.json``, the weights (``whisper_hf_state_dict`` in ``dtype``,
    through ``_save_weights``), and a byte-level BPE tokenizer trained by
    ``byte_bpe_merges`` on ``WHISPER_TEXTS`` and padded to 50257 entries,
    with Whisper's added tokens from 50257."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(whisper_hf_config(model.cfg)))
    _save_weights(root, whisper_hf_state_dict(model, dtype), fmt, shards)
    merges = byte_bpe_merges(WHISPER_TEXTS.splitlines(), n_merges)
    write_whisper_tokenizer(root, whisper_vocab(merges), merges, layout)
    return root
