"""PDVC data pipeline: word-level vocabulary and dense fixed-size batches.

The port's own copy of ``vidchapters_tpu/data/pdvc_dataset.py`` (the
reference's PDVC/data/video_dataset.py): annotations in the DVC json
schema, features linearly resized to ``frame_embedding_num`` steps,
captions through a word-level vocabulary (``Translator``: sentence -> [0,
w1..wk, 0], unknown words to the UNK entry), boxes as normalized (center,
length), padded to ``max_events`` with validity masks.
"""

from __future__ import annotations

import json
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from vidchapters_tpu_torch.config import PDVCConfig
from vidchapters_tpu_torch.data.features import FeatureSource
from vidchapters_tpu_torch.utils.io import load_json

_PUNCT = [",", ":", "!", "_", ";", "-", ".", "?", "/", '"', "\\n", "\\"]


def tokenize_caption(sentence: str) -> List[str]:
    for tok in _PUNCT:
        sentence = sentence.replace(tok, " ")
    return sentence.lower().split()


class Translator:
    """Word <-> id mapping; id 0 is BOS / EOS / pad, an unknown word maps to
    UNK, which ``build`` appends as a real last vocab entry (the reference's
    build_vocab.py:52)."""

    def __init__(self, word_to_ix: Dict[str, int]):
        self.vocab_size = len(word_to_ix)
        # a mapping without an UNK entry falls back to one id past the largest
        self.unk_id = word_to_ix.get("UNK", max(word_to_ix.values(), default=0) + 1)
        self.word_to_ix = defaultdict(lambda: self.unk_id, word_to_ix)
        self.ix_to_word = {v: k for k, v in word_to_ix.items()}
        self.ix_to_word.setdefault(self.unk_id, "UNK")

    @classmethod
    def build(cls, sentences: Sequence[str], min_count: int = 1,
              max_vocab: Optional[int] = None) -> "Translator":
        counts = Counter(w for s in sentences for w in tokenize_caption(s))
        words = [w for w, c in counts.most_common(max_vocab) if c >= min_count]
        words.append("UNK")
        return cls({w: i + 1 for i, w in enumerate(words)})  # id 0 is BOS / EOS

    @classmethod
    def from_json(cls, path: str) -> "Translator":
        vocab = load_json(path)
        return cls({k: int(v) for k, v in vocab["word_to_ix"].items()})

    def to_json(self, path) -> None:
        """Write the vocab from ``ix_to_word`` (lookups of unseen words add
        keys to the defaultdict ``word_to_ix``; they must not be saved)."""
        words = {w: i for i, w in self.ix_to_word.items()}
        Path(path).write_text(json.dumps({"word_to_ix": words}))

    def __len__(self) -> int:
        return self.vocab_size

    def translate(self, sentence: str, max_len: int) -> np.ndarray:
        ids = [self.word_to_ix[w] for w in tokenize_caption(sentence)]
        return np.array([0] + ids[: max_len - 2] + [0], dtype=np.int64)

    def rtranslate(self, ids: Sequence[int]) -> str:
        words = []
        for i in ids:
            if i == 0:
                break
            words.append(self.ix_to_word.get(int(i), "UNK"))
        return " ".join(words) + "." if words else ""


def resize_features(feats: np.ndarray, target_len: int) -> np.ndarray:
    """Linear interpolation along time to a fixed length."""
    t = feats.shape[0]
    if t == target_len:
        return feats
    src_pos = np.linspace(0, t - 1, target_len)
    lo = np.floor(src_pos).astype(np.int64)
    hi = np.minimum(lo + 1, t - 1)
    w = (src_pos - lo)[:, None]
    return (1 - w) * feats[lo] + w * feats[hi]


class PDVCDataset:
    """One example = one video with padded dense targets."""

    def __init__(self, anno, features_path, translator: Translator,
                 cfg: PDVCConfig = PDVCConfig(), max_events: int = 10):
        self.data = load_json(anno) if isinstance(anno, str) else anno
        self.vids = list(self.data.keys())
        self.features = FeatureSource(features_path, cfg.frame_embedding_num, cfg.feature_dim)
        self.translator = translator
        self.cfg = cfg
        self.max_events = max_events

    def __len__(self) -> int:
        return len(self.vids)

    def __getitem__(self, idx: int) -> dict:
        cfg = self.cfg
        vid = self.vids[idx]
        ann = self.data[vid]
        duration = float(ann["duration"])
        feats = resize_features(self.features.raw(vid[-11:]),
                                cfg.frame_embedding_num).astype(np.float32)
        t = self.max_events
        boxes = np.zeros((t, 2), np.float32)
        valid = np.zeros(t, np.int32)
        captions = np.zeros((t, cfg.max_caption_len), np.int64)
        for i, ((st, ed), sent) in enumerate(zip(ann["timestamps"][:t], ann["sentences"][:t])):
            boxes[i] = [(st + ed) / 2.0 / duration, (ed - st) / duration]
            valid[i] = 1
            ids = self.translator.translate(sent, cfg.max_caption_len)
            captions[i, :len(ids)] = ids[:cfg.max_caption_len]
        return {"video_id": vid, "duration": duration, "video": feats,
                "video_mask": np.ones(cfg.frame_embedding_num, np.int32), "boxes": boxes,
                "valid": valid, "captions": captions}


def pdvc_collate(examples: List[dict]) -> Dict[str, np.ndarray]:
    batch = {k: np.stack([e[k] for e in examples])
             for k in ("video", "video_mask", "boxes", "valid", "captions")}
    batch["duration"] = np.array([e["duration"] for e in examples], np.float32)
    batch["video_id"] = [e["video_id"] for e in examples]
    return batch
