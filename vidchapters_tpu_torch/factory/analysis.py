"""Dataset analysis: language / gender / toxicity statistics.

Counterpart of ``vidchapters_tpu/factory/analysis.py`` (the reference's
analysis/: language.py:55-74, gender.py:8-21, nsfw.py:60-121). Language ID
runs the char n-gram model in factory/langid.py (the langdetect model
family); gender metrics the GenBit implementation in factory/genbit.py;
toxicity the port's BERT (``models/bert.py``) with the pooler and the
classification head, from an HF ``BertForSequenceClassification``
directory read by ``utils/hf.py`` and ``data/wordpiece.py``; NSFW a small
MLP over CLIP image embeddings. The two classifiers run on the card unless
the caller passes ``device="cpu"``. All fully offline.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Iterable, Optional


def detect_language(text: str) -> str:
    """Char n-gram language id (factory/langid.py — the langdetect-model
    equivalent of analysis/language.py:8,67); 'unknown' on empty or
    featureless text."""
    from vidchapters_tpu_torch.factory import langid

    try:
        return langid.detect(text)
    except ValueError:
        return "unknown"


def language_stats(asr: Dict[str, dict],
                   detector: Optional[Callable[[str], str]] = None
                   ) -> Dict[str, float]:
    """Fraction of videos per detected ASR language (language.py:55-74).
    Pass ``detector=langdetect.detect`` for the reference behavior when the
    package is installed."""
    detector = detector or detect_language
    counts: Counter = Counter()
    for vid, sub in asr.items():
        text = " ".join(sub.get("text", []))[:2000]
        if not text.strip():
            counts["empty"] += 1
            continue
        try:
            counts[detector(text)] += 1
        except Exception:
            counts["unknown"] += 1
    total = max(sum(counts.values()), 1)
    return {lang: n / total for lang, n in counts.most_common()}


_GENDERED = {
    "female": {"she", "her", "hers", "herself", "woman", "women", "girl",
               "girls", "mother", "mom", "sister", "daughter", "wife",
               "queen", "lady", "ladies", "actress"},
    "male": {"he", "him", "his", "himself", "man", "men", "boy", "boys",
             "father", "dad", "brother", "son", "husband", "king",
             "gentleman", "gentlemen", "actor"},
}


def gender_stats(texts: Iterable[str]) -> Dict[str, float]:
    """Gendered-term frequencies (GenBit-style aggregate, gender.py:8-21)."""
    counts = {"female": 0, "male": 0, "total_words": 0}
    for text in texts:
        words = text.lower().split()
        counts["total_words"] += len(words)
        for w in words:
            if w in _GENDERED["female"]:
                counts["female"] += 1
            elif w in _GENDERED["male"]:
                counts["male"] += 1
    total_gendered = counts["female"] + counts["male"]
    return {
        "female_fraction": counts["female"] / max(total_gendered, 1),
        "male_fraction": counts["male"] / max(total_gendered, 1),
        "gendered_word_rate": total_gendered / max(counts["total_words"], 1),
    }


def toxicity_stats(texts: Iterable[str],
                   scorer: Optional[Callable[[str], float]] = None,
                   threshold: float = 0.5) -> Dict[str, float]:
    """Fraction of texts flagged toxic; ``scorer`` wraps Detoxify when
    installed (nsfw.py:60-121); without one, a minimal blocklist heuristic."""
    if scorer is None:
        blocklist = {"fuck", "shit", "bitch", "asshole", "bastard", "dick"}

        def scorer(t: str) -> float:
            words = set(t.lower().split())
            return 1.0 if words & blocklist else 0.0

    scores = [scorer(t) for t in texts]
    n = max(len(scores), 1)
    return {
        "toxic_fraction": sum(s > threshold for s in scores) / n,
        "mean_score": sum(scores) / n,
    }


def build_toxicity_scorer(model_dir: str, max_length: int = 256, device=None):
    """Detoxify-equivalent scorer: an HF ``BertForSequenceClassification``
    checkpoint directory (e.g. unitary/toxic-bert, what Detoxify wraps,
    analysis/nsfw.py:60-121; ``config.json``, ``vocab.txt``, the weights as
    safetensors or ``pytorch_model.bin``) run through the port's BERT with
    the pooler and the classification head on ``device`` (the card unless
    the caller asks for the CPU), in fp32. Returns ``scorer(text) -> float``:
    the sigmoid of the first (toxic) label, of the text padded to
    ``max_length``. The tower takes the JAX loader's config fields
    (vocab, widths, layers, heads, positions, token types) and the JAX
    module's defaults for the rest."""
    import torch

    from vidchapters_tpu_torch import resolve_device
    from vidchapters_tpu_torch.data.wordpiece import WordPieceTokenizer
    from vidchapters_tpu_torch.models.bert import BertConfig, BertModel, convert_hf_bert
    from vidchapters_tpu_torch.utils.hf import load_hf_config, load_hf_state_dict

    device = resolve_device(device)
    tok = WordPieceTokenizer.from_pretrained(model_dir)
    hf_cfg = load_hf_config(model_dir)
    sd = {k: v.float() for k, v in load_hf_state_dict(model_dir).items()}
    cfg = BertConfig(
        vocab_size=hf_cfg["vocab_size"], hidden_size=hf_cfg["hidden_size"],
        num_layers=hf_cfg["num_hidden_layers"], num_heads=hf_cfg["num_attention_heads"],
        intermediate_size=hf_cfg["intermediate_size"],
        max_position_embeddings=hf_cfg["max_position_embeddings"],
        type_vocab_size=hf_cfg["type_vocab_size"])
    model = BertModel(cfg)
    model.load_state_dict(convert_hf_bert({k: v for k, v in sd.items()
                                           if k.startswith("bert.")}))
    model = model.to(device).eval()
    wp, bp = sd["bert.pooler.dense.weight"].to(device), sd["bert.pooler.dense.bias"].to(device)
    wc, bc = sd["classifier.weight"].to(device), sd["classifier.bias"].to(device)

    @torch.no_grad()
    def scorer(text: str) -> float:
        enc = tok([text], truncation=True, max_length=max_length, padding="max_length")
        h = model(torch.from_numpy(enc["input_ids"]).to(device),
                  torch.from_numpy(enc["attention_mask"]).to(device))
        pooled = torch.tanh(h[:, 0].float() @ wp.T + bp)
        return float(torch.sigmoid(pooled @ wc.T + bc)[0, 0])  # first label = toxic

    return scorer


def build_nsfw_scorer(weights_npz: str, device=None):
    """CLIP-NSFW head (analysis/nsfw.py:60-93): a small MLP over
    L2-normalized CLIP image embeddings, on ``device`` (the card unless the
    caller asks for the CPU) in fp32. ``weights_npz`` holds the LAION
    detector's dense layers converted to ``w0, b0, w1, b1, ...`` (ReLU
    between layers, sigmoid output). Returns ``scorer(embeddings [B, D]) ->
    [B] scores`` as a numpy array."""
    import numpy as np
    import torch

    from vidchapters_tpu_torch import resolve_device

    device = resolve_device(device)
    data = np.load(weights_npz)
    layers = []
    i = 0
    while f"w{i}" in data:
        layers.append(tuple(torch.from_numpy(np.asarray(data[k], np.float32)).to(device)
                            for k in (f"w{i}", f"b{i}")))
        i += 1
    if not layers:
        raise ValueError(f"no dense layers (w0/b0...) in {weights_npz}")

    @torch.no_grad()
    def scorer(embeddings) -> "np.ndarray":
        x = torch.as_tensor(np.asarray(embeddings, np.float32)).to(device)
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)
        for j, (w, b) in enumerate(layers):
            x = x @ w + b
            if j < len(layers) - 1:
                x = torch.clamp(x, min=0.0)
        return torch.sigmoid(x[..., 0]).cpu().numpy()

    return scorer


# ---------------------------------------------------------------------------
# Idempotent sharded analysis jobs + CLI (the reference's standalone
# analysis scripts, run manually per README)
# ---------------------------------------------------------------------------


def analyze_language_job(asr_dir: str, out_dir: str, shuffle_seed: int = 0
                         ) -> int:
    """Per-video ASR language detection (analysis/language.py:55-74):
    reads ``<vid>.pkl`` ASR files, writes ``{"asr_lang": code}`` pickles,
    skips existing outputs so concurrent shards cooperate (the reference's
    idempotent-resumable job pattern). Returns videos processed."""
    import pickle
    import random
    from pathlib import Path

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    files = sorted(Path(asr_dir).glob("*.pkl"))
    random.Random(shuffle_seed).shuffle(files)
    done = 0
    for f in files:
        target = out / f.name
        if target.exists():
            continue
        with open(f, "rb") as fh:
            asr = pickle.load(fh)
        text = " ".join(t for t in asr.get("text", []) if t.strip())
        if not text:
            lang = None
        else:
            try:
                lang = detect_language(text)
            except Exception:
                lang = "error"  # language.py:68-69
        with open(target, "wb") as fh:
            pickle.dump({"asr_lang": lang}, fh)
        done += 1
    return done


def analyze_gender_job(chapters_pkl: str, out_json: str,
                       context_window: int = 5, distance_weight: float = 0.95,
                       percentile_cutoff: int = 80) -> dict:
    """GenBit-style gender metrics over all chapter titles
    (analysis/gender.py:8-21); writes the metrics json and returns it."""
    import json
    import pickle

    from vidchapters_tpu_torch.factory.genbit import GenBitMetrics

    with open(chapters_pkl, "rb") as f:
        data = pickle.load(f)
    titles = [c["label"] for vid in sorted(data)
              for c in data[vid].get("chapters", [])]
    g = GenBitMetrics("en", context_window=context_window,
                      distance_weight=distance_weight,
                      percentile_cutoff=percentile_cutoff)
    g.add_data(titles, tokenized=False)
    metrics = g.get_metrics(output_statistics=True, output_word_list=True)
    with open(out_json, "w") as f:
        json.dump(metrics, f, default=float)
    return metrics


def _main() -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(
        description="dataset analysis jobs (language / gender)")
    sub = p.add_subparsers(dest="job", required=True)
    pl_ = sub.add_parser("language")
    pl_.add_argument("--asr-dir", required=True)
    pl_.add_argument("--out-dir", required=True)
    pg = sub.add_parser("gender")
    pg.add_argument("--chapters-pkl", required=True)
    pg.add_argument("--out-json", required=True)
    a = p.parse_args()
    if a.job == "language":
        n = analyze_language_job(a.asr_dir, a.out_dir)
        print(json.dumps({"processed": n}))
    else:
        m = analyze_gender_job(a.chapters_pkl, a.out_json)
        print(json.dumps({k: m[k] for k in (
            "genbit_score",
            "percentage_of_male_gender_definition_words",
            "percentage_of_female_gender_definition_words",
            "percentage_of_non_binary_gender_definition_words")}))


if __name__ == "__main__":
    _main()
