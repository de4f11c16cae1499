"""The port's own tokenizers for HF checkpoint directories, on the CPU:

- ``data/wordpiece.WordPieceTokenizer``: ids, token types and attention
  masks identical to ``transformers.BertTokenizer``'s on a synthetic
  ``vocab.txt`` (accents, CJK, punctuation, controls, long words,
  ``[UNK]``, truncation, padding; lower-cased and cased);
- ``data/tokenizer.SentencePieceBPETokenizer``: the proto fields it reads
  equal what protobuf's own reader (``transformers``' copy of
  ``sentencepiece_model.proto``) finds; ids identical to an independent BPE
  built here with the ``tokenizers`` package (byte fallback, the ``▁``
  dummy prefix and space replacement, merges ranked by the merged piece's
  score) on random text, and to tokenizations written out by hand, a tie
  among them; ``decode`` round-trips; ``load_sentencepiece`` picks the
  encoder by model type; unimplemented models raise;
- ``models/llama.build_llama_titler`` from a synthetic HF directory: its
  tokens equal JAX's ``llama_greedy_generate`` over the same ids with
  ``convert_hf_llama`` of the same weights, in fp32.
"""

import json

import numpy as np
import pytest

import torch

from tests._torch_helpers import (
    bpe_model_pieces,
    write_bpe_model,
    write_llama_dir,
    write_wordpiece_vocab,
)

WP_TEXTS = ["Hello, World!! this video is GREAT.", "Café crème: brûlée à la carte",
            "我们 cook 中文字 bread", "tab\there\nnew line\x07bell � gone",
            "unknownword жжж bakery cooking", "a" * 101 + " nice", "",
            "the oven... (hot) [really]? #1 $5 @home", "ÉCOLE naïve façade", "   spaced   out  "]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_wordpiece_vocab(tmp_path_factory.mktemp("wp") / "vocab.txt", 400)


@pytest.mark.parametrize("lower", [True, False])
def test_wordpiece_matches_bert_tokenizer(vocab, lower):
    transformers = pytest.importorskip("transformers")
    from vidchapters_tpu_torch.data.wordpiece import WordPieceTokenizer

    hf = transformers.BertTokenizer(str(vocab), do_lower_case=lower)
    ours = WordPieceTokenizer(str(vocab), do_lower_case=lower)
    for text in WP_TEXTS:
        assert ours.tokenize(text) == hf.tokenize(text), text
    assert "[UNK]" in ours.tokenize(WP_TEXTS[4]) and "[UNK]" in ours.tokenize(WP_TEXTS[5])
    for max_length in (6, 16, 64):
        ref = hf(WP_TEXTS, max_length=max_length, truncation=True, padding="max_length",
                 return_tensors="np")
        got = ours(WP_TEXTS, max_length=max_length, truncation=True, padding="max_length")
        for key in ("input_ids", "token_type_ids", "attention_mask"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{key} {max_length}")
    ref = hf(WP_TEXTS, padding="longest", return_tensors="np")
    np.testing.assert_array_equal(ours(WP_TEXTS, padding="longest")["input_ids"],
                                  ref["input_ids"])


def test_wordpiece_reads_tokenizer_config(vocab, tmp_path):
    from vidchapters_tpu_torch.data.wordpiece import WordPieceTokenizer

    root = tmp_path / "dir"
    root.mkdir()
    (root / "vocab.txt").write_bytes(vocab.read_bytes())
    assert WordPieceTokenizer.from_pretrained(str(root)).do_lower_case
    (root / "tokenizer_config.json").write_text(json.dumps({"do_lower_case": False}))
    tok = WordPieceTokenizer.from_pretrained(str(root))
    assert not tok.do_lower_case and tok.tokenize("Hello") == ["[UNK]"]


# ---------------------------------------------------------------------------
# SentencePiece BPE
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    root = tmp_path_factory.mktemp("bpe")
    pieces = bpe_model_pieces(vocab_size=700, n_merges=300)
    return write_bpe_model(root / "tokenizer.model", pieces), pieces


def _hf_bpe(pieces):
    """An independent BPE with the ``tokenizers`` package, built as HF's
    LLaMA converter builds one: every split of a piece into two pieces is a
    merge, ranked by the merged piece's score (then by the halves' ids)."""
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import decoders, normalizers

    vocab = {p: i for i, (p, _, _) in enumerate(pieces)}
    normal = {p: (s, i) for i, (p, s, t) in enumerate(pieces) if t == 1}
    merges = []
    for piece, (score, _) in normal.items():
        for k in range(1, len(piece)):
            a, b = piece[:k], piece[k:]
            if a in normal and b in normal:
                merges.append((-score, vocab[a], vocab[b], a, b))
    merges = [(a, b) for *_, a, b in sorted(merges)]
    tok = tokenizers.Tokenizer(tokenizers.models.BPE(vocab, merges, unk_token="<unk>",
                                                     byte_fallback=True, fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    return tok


def _random_texts(n: int, seed: int = 0):
    from tests._torch_helpers import BPE_WORDS

    rng = np.random.default_rng(seed)
    odd = ["é", "中", "🙂", "ß", "x", "Q", "!", "  ", "\t", "’"]
    out = []
    for _ in range(n):
        words = []
        for _ in range(int(rng.integers(1, 9))):
            w = str(rng.choice(BPE_WORDS))
            if rng.uniform() < 0.3:
                k = int(rng.integers(0, len(w) + 1))
                w = w[:k] + str(rng.choice(odd)) + w[k:]
            words.append(w)
        out.append(" ".join(words))
    return out


def test_bpe_proto_fields_match_protobuf(bpe):
    pytest.importorskip("google.protobuf")
    import os

    os.environ.setdefault("PROTOCOL_BUFFERS_PYTHON_IMPLEMENTATION", "python")
    pb2 = pytest.importorskip("transformers.utils.sentencepiece_model_pb2_new")
    from vidchapters_tpu_torch.data.tokenizer import SpmModel, SpmSpecs

    path, pieces = bpe
    ref = pb2.ModelProto()
    ref.ParseFromString(path.read_bytes())
    model = SpmModel(path.read_bytes())
    got = SpmSpecs.parse(model)
    assert model.pieces == [(p.piece, p.score, p.type) for p in ref.pieces] == pieces
    assert (got.model_type, got.byte_fallback) == (ref.trainer_spec.model_type,
                                                  ref.trainer_spec.byte_fallback) == (2, True)
    assert (got.unk_id, got.bos_id, got.eos_id) == (ref.trainer_spec.unk_id,
                                                    ref.trainer_spec.bos_id,
                                                    ref.trainer_spec.eos_id) == (0, 1, 2)
    n = ref.normalizer_spec
    assert (got.normalizer, got.add_dummy_prefix, got.remove_extra_whitespaces,
            got.escape_whitespaces) == (n.name, n.add_dummy_prefix, n.remove_extra_whitespaces,
                                        n.escape_whitespaces) == ("identity", True, False, True)


def test_bpe_matches_independent_tokenizers_bpe(bpe):
    from vidchapters_tpu_torch.data.tokenizer import SentencePieceBPETokenizer

    path, pieces = bpe
    ours, ref = SentencePieceBPETokenizer(str(path)), _hf_bpe(pieces)
    texts = _random_texts(300)
    n_bytes = 0
    for text in texts:
        ids = ours.encode(text)
        assert ids == ref.encode(text).ids, text
        n_bytes += sum(pieces[i][2] == 6 for i in ids)
        assert ours.decode(ids) == text == ref.decode(ids)
    assert n_bytes > 50  # byte fallback ran
    assert ours.encode("bread", add_special_tokens=True)[0] == 1


def test_bpe_hand_written_tokenizations(tmp_path):
    """Tiny models whose merges are read off by hand: the highest-scored
    pair first, the leftmost of equal scores, a repeated pair left to right,
    and a character no piece holds as its UTF-8 bytes."""
    from vidchapters_tpu_torch.data.tokenizer import SentencePieceBPETokenizer

    base = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    base += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    chars = [(c, -10.0, 1) for c in "▁abc"]

    def tok(extra, name):
        return SentencePieceBPETokenizer(str(write_bpe_model(tmp_path / name,
                                                             base + extra + chars)))

    def pieces_of(t, text):
        return [t.pieces[i][0] for i in t.encode(text)]

    tie = tok([("ab", -1.0, 1), ("bc", -1.0, 1)], "tie.model")
    assert pieces_of(tie, "abc") == ["▁", "ab", "c"]          # equal scores: leftmost
    high = tok([("ab", -2.0, 1), ("bc", -1.0, 1)], "high.model")
    assert pieces_of(high, "abc") == ["▁", "a", "bc"]         # the higher score first
    rep = tok([("aa", -1.0, 1), ("▁aa", -2.0, 1)], "rep.model")
    assert pieces_of(rep, "aaaaa") == ["▁aa", "aa", "a"]       # "aa" left to right, then "▁aa"
    assert pieces_of(rep, "a é") == ["▁", "a", "▁", "<0xC3>", "<0xA9>"]
    assert rep.decode(rep.encode("a é")) == "a é"
    assert rep.decode([1] + rep.encode("aa") + [2]) == "aa"
    assert rep.decode([1] + rep.encode("aa"), skip_special_tokens=False) == "<s> aa"


def test_load_sentencepiece_picks_the_encoder_and_raises(bpe, tmp_path):
    import chip_smoke
    from vidchapters_tpu_torch.data.tokenizer import (
        SentencePieceBPETokenizer,
        SentencePieceUnigramTokenizer,
        load_sentencepiece,
    )

    path, pieces = bpe
    assert isinstance(load_sentencepiece(str(path)), SentencePieceBPETokenizer)
    chip_smoke._write_spm_model(tmp_path / "spiece.model")
    uni = load_sentencepiece(str(tmp_path / "spiece.model"), num_bins=0, use_native=False)
    assert isinstance(uni, SentencePieceUnigramTokenizer)
    # a spec field that is not a message: the unigram encoder reads the
    # pieces alone, whatever reads the specs raises
    spm = (tmp_path / "spiece.model").read_bytes()
    (tmp_path / "junk.model").write_bytes(spm + b"\x12\x07trainer")
    junk = SentencePieceUnigramTokenizer(str(tmp_path / "junk.model"), num_bins=0,
                                         use_native=False)
    assert junk.pieces == uni.pieces
    with pytest.raises(ValueError, match="not a message"):
        load_sentencepiece(str(tmp_path / "junk.model"))
    with pytest.raises(ValueError, match="not BPE"):
        SentencePieceBPETokenizer(str(tmp_path / "spiece.model"))
    write_bpe_model(tmp_path / "nfkc.model", pieces, normalizer="nmt_nfkc")
    with pytest.raises(ValueError, match="normalizer 'nmt_nfkc'"):
        SentencePieceBPETokenizer(str(tmp_path / "nfkc.model"))
    write_bpe_model(tmp_path / "unused.model", pieces + [("zz", -999.0, 5)])
    with pytest.raises(ValueError, match="UNUSED"):
        load_sentencepiece(str(tmp_path / "unused.model"))


# ---------------------------------------------------------------------------
# build_llama_titler from an HF directory
# ---------------------------------------------------------------------------


def test_build_llama_titler_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from tests._torch_helpers import llama_hf_state_dict
    from vidchapters_tpu.models import llama as jl
    from vidchapters_tpu_torch.data.tokenizer import SentencePieceBPETokenizer
    from vidchapters_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig(vocab_size=700, hidden_size=64, intermediate_size=128, num_layers=2,
                         num_heads=8, num_kv_heads=2, max_position_embeddings=64)
    root = write_llama_dir(tmp_path / "llama", cfg, seed=3, fmt="bin", shards=2)
    titler = tl.build_llama_titler(str(root), max_new_tokens=6, max_length=24, device="cpu",
                                   dtype="float32")
    tok = SentencePieceBPETokenizer(str(root / "tokenizer.model"))
    jcfg = jl.LlamaConfig(**{f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
        "num_kv_heads", "max_position_embeddings", "rms_norm_eps", "rope_theta", "bos_id",
        "eos_id")}, dtype="float32")
    params = jax.tree_util.tree_map(jnp.asarray, jl.convert_hf_llama(
        {k: v.numpy() for k, v in llama_hf_state_dict(cfg, seed=3).items()}))
    jmodel = jl.LlamaForCausalLM(jcfg)
    prompts = ["bake the bread", "Summarize: we whisk eggs and fold flour. Chapter title:",
               "é " * 30]
    n_words = 0
    for prompt in prompts:
        ids = ([1] + tok.encode(prompt))[:24]
        pad = 24 - len(ids)
        toks = np.asarray(jl.llama_greedy_generate(
            jmodel, params, jnp.asarray([[1] * pad + ids], jnp.int32),
            jnp.asarray([[0] * pad + [1] * len(ids)], jnp.int32), 6))[0].tolist()
        if 2 in toks:
            toks = toks[:toks.index(2)]
        want = tok.decode(toks, skip_special_tokens=True)
        assert titler(prompt) == want
        n_words += len(want.split())
    assert n_words > 0
    model = tl.load_llama(str(root), device="cpu")
    assert model.embed_tokens.dtype == torch.bfloat16 and model.cfg.num_layers == 2
