"""Dense-video-captioning / chapter-generation dataset (host side, numpy).

The port's own copy of ``vidchapters_tpu/data/dvc_dataset.py``: the
reference's example construction (dataset/dvc_dataset.py) from an
annotation json ``{vid: {duration, timestamps, sentences}}`` and an ASR
pickle ``{vid: {text[], start[], end[]}}`` (or per-video pickles):
time-token input sequences, span-corruption denoising pairs and output
sequences, collated to fixed lengths (the reference pads per batch,
dvc_dataset.py:168-208); and the HowTo100M pretraining set
``YTPretrainDataset`` (dataset/yt_dataset.py) over a csv of videos.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from vidchapters_tpu_torch.config import DataConfig
from vidchapters_tpu_torch.data.features import FeatureSource, subsample_or_pad
from vidchapters_tpu_torch.data.span_corruption import span_corrupt
from vidchapters_tpu_torch.data.time_tokens import build_time_text_sequence
from vidchapters_tpu_torch.utils.io import load_json


class SubtitleSource:
    """ASR pickle accessor: consolidated dict or per-video pickle dir
    (dvc_dataset.py:36-43,100-104). Video ids are keyed on the trailing 11
    chars (YouTube id convention)."""

    def __init__(self, subtitles_path: Optional[str]):
        self.subs: Optional[dict] = None
        self.dir_path: Optional[str] = None
        if subtitles_path and os.path.isdir(subtitles_path):
            self.dir_path = subtitles_path
        elif subtitles_path and os.path.exists(subtitles_path):
            with open(subtitles_path, "rb") as f:
                self.subs = pickle.load(f)

    def get(self, video_id: str) -> Optional[dict]:
        key = video_id[-11:]
        if self.subs is not None and key in self.subs:
            return self.subs[key]
        if self.dir_path is not None:
            path = os.path.join(self.dir_path, key + ".pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    return pickle.load(f)
        return None


class DenseVideoCaptioningDataset:
    """One example = one video; yields numpy dict with variable-length token
    arrays (collated to static shapes by ``collate``)."""

    def __init__(self, json_path, features_path, tokenizer,
                 cfg: DataConfig = DataConfig(),
                 subtitles_path: Optional[str] = None,
                 subtitles: Optional[SubtitleSource] = None):
        self.data = load_json(json_path) if isinstance(json_path, str) else json_path
        self.vids = list(self.data.keys())
        self.features = FeatureSource(features_path, cfg.max_feats, cfg.features_dim)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.subs = subtitles if subtitles is not None else SubtitleSource(subtitles_path)

    def __len__(self) -> int:
        return len(self.vids)

    def _input_tokens(self, video_id: str, duration: float) -> np.ndarray:
        sub = self.subs.get(video_id)
        if sub is None:
            return np.array([self.tokenizer.eos_token_id], dtype=np.int64)
        ids = build_time_text_sequence(
            sub["start"], sub["end"], sub["text"], duration, self.tokenizer,
            self.cfg.num_bins, self.cfg.max_input_tokens, filter_to_duration=True)
        return np.asarray(ids, dtype=np.int64)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> dict:
        video_id = self.vids[idx]
        ann = self.data[video_id]
        duration = float(ann["duration"])
        video = self.features(video_id[-11:])

        input_tokens = self._input_tokens(video_id, duration)
        if len(input_tokens) > 1:
            den_in, den_out = span_corrupt(
                input_tokens, self.tokenizer, self.cfg.noise_density,
                self.cfg.mean_noise_span_length, rng)
        else:
            den_in = np.array([0], dtype=np.int64)
            den_out = input_tokens

        starts = [t[0] for t in ann["timestamps"]]
        ends = [t[1] for t in ann["timestamps"]]
        output_tokens = np.asarray(build_time_text_sequence(
            starts, ends, ann["sentences"], duration, self.tokenizer,
            self.cfg.num_bins, self.cfg.max_output_tokens), dtype=np.int64)

        return {
            "video_id": video_id,
            "duration": duration,
            "video": video,
            "input_tokens": input_tokens,
            "output_tokens": output_tokens,
            "denoising_input_tokens": den_in,
            "denoising_output_tokens": den_out,
        }


class YTPretrainDataset:
    """HowTo100M-style pretraining (dataset/yt_dataset.py): the generative
    target is the ASR's time+text sequence (the video alone generates its
    speech, ``genasr``, dvc.py:59-68), plus the denoising pair drawn from
    the epoch's generator. Examples are the JAX package's for the same
    seed."""

    def __init__(self, csv_rows: Sequence[dict], features_path, tokenizer,
                 subtitles_path: Optional[str] = None,
                 cfg: DataConfig = DataConfig()):
        # csv rows: {"video_id": ..., "video_path": ...}
        self.rows = list(csv_rows)
        self.features = FeatureSource(features_path, cfg.max_feats, cfg.features_dim)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.subs = SubtitleSource(subtitles_path)

    @classmethod
    def from_csv(cls, csv_path: str, features_path, tokenizer, subtitles_path=None,
                 cfg: DataConfig = DataConfig()):
        with open(csv_path) as f:
            rows = list(csv.DictReader(f))
        return cls(rows, features_path, tokenizer, subtitles_path, cfg)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> dict:
        row = self.rows[idx]
        video_id = row["video_id"]
        # a csv video_path is joined under features_path with its
        # subdirectories kept (yt_dataset.py:49): HowTo100M shards features
        # into subdirectories. Only the feature suffix goes, since
        # FeatureSource appends .mp4.npy / .npy itself.
        if self.features.dir_path and row.get("video_path"):
            key = row["video_path"]
            for suffix in (".mp4.npy", ".npy", ".mp4"):
                if key.endswith(suffix):
                    key = key[: -len(suffix)]
                    break
        else:
            key = video_id
        raw = self.features.raw(key)
        sub = self.subs.get(video_id) or {"text": [], "start": [], "end": []}
        duration = float(sub.get("duration", len(raw) + 1))
        video = subsample_or_pad(raw, self.cfg.max_feats, self.cfg.features_dim)
        # subtitles inside [0, duration] only, their times clamped into it
        # (yt_dataset.py:55-59)
        keep = [(s >= 0 and e <= duration) for s, e in zip(sub["start"], sub["end"])]
        starts = [max(s, 0) for i, s in enumerate(sub["start"]) if keep[i]]
        ends = [min(e, duration) for i, e in enumerate(sub["end"]) if keep[i]]
        texts = [t for i, t in enumerate(sub["text"]) if keep[i]]

        if texts:
            seq = np.asarray(build_time_text_sequence(
                starts, ends, texts, duration, self.tokenizer,
                self.cfg.num_bins, self.cfg.max_input_tokens), dtype=np.int64)
            den_in, den_out = span_corrupt(
                seq, self.tokenizer, self.cfg.noise_density,
                self.cfg.mean_noise_span_length, rng)
        else:
            seq = np.array([self.tokenizer.eos_token_id], dtype=np.int64)
            den_in = np.array([0], dtype=np.int64)
            den_out = seq

        return {
            "video_id": video_id,
            "duration": duration,
            "video": video,
            "output_tokens": seq,  # the generative target is the ASR sequence
            "denoising_input_tokens": den_in,
            "denoising_output_tokens": den_out,
        }


# ---------------------------------------------------------------------------
# Static-shape collation
# ---------------------------------------------------------------------------


def pad_to(arr: np.ndarray, length: int) -> np.ndarray:
    out = np.zeros(length, dtype=arr.dtype)
    n = min(len(arr), length)
    out[:n] = arr[:n]
    return out


def denoise_length_bounds(max_input: int, noise_density: float = 0.25,
                          mean_span: float = 5.0) -> tuple:
    """Static worst-case lengths of span-corrupted sequences.

    corrupted input = L - noise + spans + 1 <= (1 - d + d/m) L + 3;
    target = noise + spans + 1 <= (d + d/m) L + 3 (rounding slack included).
    """
    frac_in = 1.0 - noise_density + noise_density / mean_span
    frac_out = noise_density + noise_density / mean_span
    return int(frac_in * max_input) + 4, int(frac_out * max_input) + 4


def pick_bucket(n: int, buckets: Sequence[int], cap: int) -> int:
    """Smallest bucket >= n (clamped to <= cap); cap when none fits."""
    for b in sorted(b for b in buckets if b <= cap):
        if n <= b:
            return b
    return cap


def collate(examples: List[dict], max_input: int, max_output: int,
            max_denoise_out: Optional[int] = None,
            input_buckets: Optional[Sequence[int]] = None,
            output_buckets: Optional[Sequence[int]] = None
            ) -> Dict[str, np.ndarray]:
    """Zero-pad every token field to static lengths; stack video features.

    Denoising fields pad to their analytic worst case (~0.8L inputs, ~0.3L
    targets), shorter than the raw maxima and never truncating.
    ``input_buckets`` / ``output_buckets`` (eval time) pad to the smallest
    bucket covering the batch instead of the maxima.
    """
    if input_buckets and "input_tokens" in examples[0]:
        longest = max(len(e["input_tokens"]) for e in examples)
        max_input = pick_bucket(longest, input_buckets, max_input)
    if output_buckets:
        longest = max(len(e["output_tokens"]) for e in examples)
        max_output = pick_bucket(longest, output_buckets, max_output)
    den_in_len, den_out_len = denoise_length_bounds(max_input)
    max_denoise_out = max_denoise_out or den_out_len
    batch: Dict[str, np.ndarray] = {
        "video": np.stack([e["video"] for e in examples]).astype(np.float32),
        "duration": np.array([e["duration"] for e in examples], np.float32),
    }
    if "input_tokens" in examples[0]:
        batch["input_tokens"] = np.stack(
            [pad_to(e["input_tokens"], max_input) for e in examples])
    batch["output_tokens"] = np.stack(
        [pad_to(e["output_tokens"], max_output) for e in examples])
    if "denoising_input_tokens" in examples[0]:
        batch["denoising_input_tokens"] = np.stack(
            [pad_to(e["denoising_input_tokens"], den_in_len)
             for e in examples])
        batch["denoising_output_tokens"] = np.stack(
            [pad_to(e["denoising_output_tokens"], max_denoise_out)
             for e in examples])
    batch["video_id"] = [e["video_id"] for e in examples]
    return batch


class EpochIterator:
    """Shuffled, per-host-sharded batch iterator (replaces DataLoader +
    DistributedSampler, dvc.py:280-324). One numpy generator per epoch,
    seeded ``seed + epoch``, shuffles the order and draws the span
    corruption."""

    def __init__(self, dataset, batch_size: int, cfg: DataConfig,
                 shuffle: bool = True, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0,
                 drop_last: bool = True,
                 max_denoise_out: Optional[int] = None,
                 bucket_inputs: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.cfg = cfg
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_last = drop_last
        self.max_denoise_out = max_denoise_out
        # eval time: pad inputs per batch to the smallest covering bucket;
        # training keeps one padded shape
        self.bucket_inputs = bucket_inputs

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _prefetch(self, idxs) -> None:
        """Warm the native feature cache for the next batch, so its disk reads
        overlap this step. Only datasets keyed by ``vids`` (the DVC set) are
        warmed; a prefetch that fails is ignored, since the load reads the
        file again."""
        features = getattr(self.dataset, "features", None)
        vids = getattr(self.dataset, "vids", None)
        if features is None or vids is None or not hasattr(features, "prefetch"):
            return
        try:
            features.prefetch([vids[int(i)][-11:] for i in idxs])
        except (OSError, RuntimeError):
            pass

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.shuffle:
            rng.shuffle(order)
        order = order[self.shard_index::self.num_shards]
        for b in range(len(self)):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            if len(idxs) == 0:
                break
            self._prefetch(order[(b + 1) * self.batch_size:(b + 2) * self.batch_size])
            examples = [self.dataset.__getitem__(int(i), rng=rng) for i in idxs]
            yield collate(examples, self.cfg.max_input_tokens,
                          self.cfg.max_output_tokens, self.max_denoise_out,
                          input_buckets=(self.cfg.input_buckets
                                         if self.bucket_inputs else None),
                          output_buckets=(self.cfg.output_buckets
                                          if self.bucket_inputs else None))
