"""The port's Whisper tokenizer (``data/whisper_tokenizer.py``) against HF's
``WhisperTokenizer`` (slow, the one the JAX demo uses) and
``WhisperTokenizerFast`` on synthetic directories.

A byte-level BPE is trained with ``tokenizers.ByteLevelBPETokenizer`` on a
seeded corpus (ASCII, accents, CJK, emoji, digits, contractions, runs of
spaces and newlines), padded to 50257 entries with filler pieces (most of
which decode to invalid UTF-8), and given Whisper's 1608 added tokens at
50257-51864. It is saved in four layouts: ``vocab.json`` + ``merges.txt``
with ``tokenizer_config.json``'s ``added_tokens_decoder``; the same with
``added_tokens.json`` + ``special_tokens_map.json``; ``tokenizer.json``
alone with merges as ``[a, b]`` pairs; and with merges as ``"a b"``
strings. The slow tokenizer reads the first directory; the fast one and
the port read each layout.

The ``tokenizer_config.json`` layouts say ``clean_up_tokenization_spaces:
true``, as OpenAI's do.
The slow tokenizer never applies it and the port follows the slow one, so
the fast one is called with ``clean_up_tokenization_spaces=False``."""

import json
import warnings
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests._torch_helpers import (
    WHISPER_N_SPECIAL,
    whisper_special_tokens,
    whisper_vocab,
    write_whisper_tokenizer,
)
from vidchapters_tpu_torch.data.whisper_tokenizer import (
    WHISPER_SPECIAL_IDS,
    check_whisper_special_ids,
    load_whisper_tokenizer,
    pretokenize,
)

WORDS = {
    "ascii": "we whisk the eggs then fold in flour and knead dough oven bread salt".split(),
    "accents": "café crème brûlée déjà naïve façade über straße São Paulo Ångström".split(),
    "cjk": "今日 料理 鶏肉 野菜 切ります 中文 测试 한국어 東京 です。".split(),
    "emoji": "🍳 🥚 👍🏽 🇫🇷 ❤️ 🎉🎉 👩‍🍳".split(),
    "digits": "3.14 2024 1,000 42 ½ ² 0.5 100% 7th".split(),
    "contractions": "don't I'm you've they're we'd she's I'll IT'S isn't 'tis".split(),
}
SEPARATORS = (" ", " ", " ", "  ", "   ", "\n", "\n\n", "\t", ", ", ". ", " \n ", "!")
LAYOUTS = ("config", "added_tokens", "tokenizer_json_pairs", "tokenizer_json_strings")
N_IDS = 50257 + 1608


def corpus(n_lines: int = 400, seed: int = 0):
    rng = np.random.default_rng(seed)
    letters = list("aeioustnrlmdkpgbhéèàüöçñ") + list("料理野菜鶏肉")
    made = ["".join(rng.choice(letters, int(rng.integers(2, 9)))) for _ in range(400)]
    pools = list(WORDS.values()) + [made, made]
    lines = []
    for _ in range(n_lines):
        parts = []
        for _ in range(int(rng.integers(4, 14))):
            pool = pools[int(rng.integers(len(pools)))]
            parts += [pool[int(rng.integers(len(pool)))],
                      SEPARATORS[int(rng.integers(len(SEPARATORS)))]]
        lines.append("".join(parts))
    return lines


def _quiet():
    warnings.filterwarnings("ignore")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{layout: directory} of one trained tokenizer."""
    from tokenizers import AddedToken, ByteLevelBPETokenizer, Tokenizer, decoders, models
    from tokenizers import pre_tokenizers

    root = tmp_path_factory.mktemp("whisper_tok")
    bpe = ByteLevelBPETokenizer()
    bpe.train_from_iterator(corpus(), vocab_size=2000, min_frequency=2, show_progress=False)
    bpe.save_model(str(root))
    lines = (root / "merges.txt").read_text(encoding="utf-8").split("\n")[1:-1]
    merges = [tuple(m.split()) for m in lines]
    vocab = whisper_vocab(merges, base=json.loads((root / "vocab.json").read_text("utf-8")))
    assert len(vocab) == 50257 and len(merges) > 1000, len(merges)
    out = {layout: write_whisper_tokenizer(root / layout, vocab, merges, layout)
           for layout in LAYOUTS[:2]}
    fast = Tokenizer(models.BPE(vocab=vocab, merges=merges))
    fast.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    fast.decoder = decoders.ByteLevel()
    tokens = whisper_special_tokens()
    fast.add_special_tokens([AddedToken(t, normalized=False)
                             for t in tokens[:WHISPER_N_SPECIAL]])
    fast.add_tokens([AddedToken(t, normalized=False, special=False)
                     for t in tokens[WHISPER_N_SPECIAL:]])
    for layout in LAYOUTS[2:]:
        (root / layout).mkdir()
        fast.save(str(root / layout / "tokenizer.json"))
        out[layout] = root / layout
    full = json.loads((out["tokenizer_json_strings"] / "tokenizer.json").read_text("utf-8"))
    assert isinstance(full["model"]["merges"][0], list)
    full["model"]["merges"] = [" ".join(m) for m in full["model"]["merges"]]
    (out["tokenizer_json_strings"] / "tokenizer.json").write_text(
        json.dumps(full, ensure_ascii=False), encoding="utf-8")
    return out


@pytest.fixture(scope="module")
def slow(dirs):
    from transformers import WhisperTokenizer

    _quiet()
    return WhisperTokenizer.from_pretrained(str(dirs["config"]))


@pytest.fixture(scope="module")
def slow_singles(slow):
    return [slow.decode([t]) for t in range(N_IDS)]


@pytest.fixture(scope="module")
def slow_cases(slow):
    """(text, ids) of ``_texts`` by the slow tokenizer, and its decodes
    (plain, skip-special) of those ids wrapped in a prompt and timestamps
    and of seeded random id sequences: the same for every layout."""
    encoded = [(text, slow.encode(text, add_special_tokens=False)) for text in _texts()]
    rng = np.random.default_rng(3)
    sequences = []
    for _, ids in encoded:
        sequences += [ids, [50361] + ids[:3] + [50258, 50259, 50359, 50364] + ids + [50400, 50257]]
    sequences += [rng.integers(0, N_IDS, int(rng.integers(1, 40))).tolist() for _ in range(200)]
    decoded = [(ids, skip, slow.decode(ids, skip_special_tokens=skip))
               for ids in sequences for skip in (False, True)]
    return encoded, decoded


def _fast(path: Path):
    from transformers import WhisperTokenizerFast

    _quiet()
    return WhisperTokenizerFast.from_pretrained(str(path))


def _texts():
    tokens = whisper_special_tokens()
    return corpus(60, seed=1) + [
        "", " ", "  leading and trailing  ", "\n\n\n", "a　b c d\x85e",
        "<|startoftranscript|><|en|><|transcribe|> hello<|0.00|> world<|1.24|><|endoftext|>",
        "x<|notimestamps|>y <|startofprev|> prompt", "<|endoftext|><|endoftext|>",
        "a , b . c ! don 't  ? I 'm", "<|en", "<|0.00|>ok" + tokens[-1] + "|>",
        "'S 'Ll 'LL 's's''s", "ﬁ ℌ ① Ⅻ ٣ ߀", "\U0001f600\U0001f3fd‍♀️"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_whisper_tokenizer_matches_hf(dirs, slow, slow_singles, slow_cases, layout):
    """Per layout: ``encode`` id for id, ``decode`` and the skip-special
    decode string for string (on the encoded texts, the encodings wrapped in
    a prompt and timestamps, and seeded random id sequences), every
    single-token ``decode([t])`` over all 51865 ids, and special tokens
    written in the text at their ids, against the slow and fast tokenizers."""
    port = load_whisper_tokenizer(str(dirs[layout]))
    fast = _fast(dirs[layout])
    assert len(port) == len(slow) == len(fast) == N_IDS
    check_whisper_special_ids(port)
    encoded, decoded = slow_cases
    for text, ids in encoded:
        assert port.encode(text, add_special_tokens=False) == ids, text
        assert fast.encode(text, add_special_tokens=False) == ids, text
        assert port.encode(text) == ids, text
    for ids, skip, want in decoded:
        assert port.decode(ids, skip_special_tokens=skip) == want, (ids, skip)
        assert (port.decode(ids, skip_special_tokens=skip)
                == fast.decode(ids, skip_special_tokens=skip, clean_up_tokenization_spaces=False)
                ), (ids, skip)
    singles = [port.decode([t]) for t in range(N_IDS)]
    assert singles == slow_singles
    assert singles == fast.batch_decode([[t] for t in range(N_IDS)])
    assert sum("�" in s for s in singles) > 10000  # split UTF-8 pieces decode as U+FFFD
    for k, tok in enumerate(whisper_special_tokens()):
        assert port.encode(f"a{tok} b", add_special_tokens=False)[1] == 50257 + k
    assert {t: port.convert_tokens_to_ids(t) for t in WHISPER_SPECIAL_IDS} == WHISPER_SPECIAL_IDS


_ASSIGNED = st.characters(blacklist_categories=("Cs", "Cn"))


@settings(max_examples=150, deadline=None, suppress_health_check=list(HealthCheck))
@given(text=st.text(_ASSIGNED, max_size=40)
       | st.lists(st.sampled_from([" ", "  ", "\n", "'s", "'", "a", "7", "é", "中", "🍳", "<|en|>",
                                   "<|0.02|>", ",", "\t", "　"]), max_size=20).map("".join))
def test_whisper_tokenizer_property(dirs, slow, text):
    """Any text of assigned code points (the ``regex`` module's tables are
    newer than Python's ``unicodedata``: code points they assign and it
    does not get other classes) encodes id for id as the slow tokenizer
    does, and decodes back to the slow tokenizer's string."""
    port = _PORT.setdefault("config", load_whisper_tokenizer(str(dirs["config"])))
    ids = port.encode(text, add_special_tokens=False)
    assert ids == slow.encode(text, add_special_tokens=False)
    for skip in (False, True):
        assert port.decode(ids, skip_special_tokens=skip) == slow.decode(
            ids, skip_special_tokens=skip)


_PORT = {}


@pytest.mark.parametrize("text,pieces", [
    ("Hello world", ["Hello", " world"]),
    ("I'm  here\n\nnow ", ["I", "'m", " ", " here", "\n", "\n", "now", " "]),
    ("it's 2024!! ok", ["it", "'s", " 2024", "!!", " ok"]),
    (" \n a", [" \n", " a"]),
    ("a\xa0b", ["a", "\xa0", "b"]),
])
def test_pretokenize_cases(text, pieces):
    """Hand-checked splits of GPT-2's pattern: contractions, a run of white
    space leaving its last character to the next piece (alone when it is
    not the pattern's optional ' '), and a no-break space that is white
    space but not that ' '."""
    assert pretokenize(text) == pieces


def test_whisper_tokenizer_load_errors(tmp_path, dirs):
    """A directory with no tokenizer files, a vocab.json without merges.txt
    and an unreadable tokenizer.json each raise, naming the file."""
    with pytest.raises(FileNotFoundError, match="no vocab.json"):
        load_whisper_tokenizer(str(tmp_path))
    (tmp_path / "vocab.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="merges.txt"):
        load_whisper_tokenizer(str(tmp_path))
    (tmp_path / "vocab.json").unlink()
    (tmp_path / "tokenizer.json").write_text("{not json")
    with pytest.raises(ValueError, match="tokenizer.json"):
        load_whisper_tokenizer(str(tmp_path))
    (tmp_path / "tokenizer.json").write_text(json.dumps({"model": {"type": "Unigram"}}))
    with pytest.raises(ValueError, match="tokenizer.json"):
        load_whisper_tokenizer(str(tmp_path))
    english = load_whisper_tokenizer(str(dirs["config"]))
    english.added_ids["<|startoftranscript|>"] = 50257
    with pytest.raises(ValueError, match="startoftranscript"):
        check_whisper_special_ids(english)
