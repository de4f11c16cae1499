"""The learning proof: Vid2Seq at the full recipe memorises a synthetic
chapter set through ``train/dvc_main``, is evaluated with the production
beam-4 decode and the whole eval stack, and its ``best`` is served.

Counterpart of the JAX package's root ``tpu_overfit.py``: the same data
(8 videos of 120 x 768 normal features from ``default_rng(0)``, 3 chapters
of a 90 s video each, one ASR segment), the same ``ExperimentConfig``
(T5-base + the 12-layer temporal ViT, batch 8, 100 frames, 1000 input and
256 output tokens, beam 4 / 256, ``best_metric`` soda_c, ``last`` saved
once) and the same record keys. Training runs at the recipe's dropout 0.1,
each T5 block rematerialised; the evals run on the standard cached decode
(``models.t5.USE_MEGA_DECODE`` False, the decode-attention kernels).

Label smoothing puts a floor under the generative loss: at eps 0.1 over
the 32,200-token vocabulary the optimum assigns the target 1 - eps + eps/V
and every other token eps/V, about 1.363 nats. SODA_c cannot pass about
0.516 on this set: its per-pair METEOR penalises the fragmentation of an
identical 3-word caption, and the reference's time quantisation
int(99 t / duration) shaves the IoU; the record carries that ceiling,
scored as the GT against itself.

After training, ``best`` is loaded through ``serve.load_serving_params``
and the 8 videos are served by ``serve.ChapterGenerator`` on the decode
kernel's route (``USE_MEGA_DECODE`` True): once a video at a time, then
all 8 at once. The record holds each video's served chapters beside the
eval's, and the decode steps each serving call ran (a memorised model ends
at EOS long before ``max_length``).

    python -m vidchapters_tpu_torch.train.overfit [--epochs N] [--videos 8]
        [--lr 3e-4] [--smoke] [--device cuda|cpu] [--workdir DIR] [--out PATH]

Runs on the card unless ``--device cpu`` is given. Without ``--smoke`` it
writes the record to ``--out`` (``OVERFIT_H100.json`` at the repo root),
with the card's name and power limit (``nvidia-smi``) and the epochs, steps
and wall seconds; it prints the record as one JSON line. ``--smoke`` is a
tiny model at CPU-friendly shapes that checks the plumbing and writes no
record.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

RECORD = Path(__file__).resolve().parents[2] / "OVERFIT_H100.json"
NOUNS = ("pasta", "engine", "garden", "piano", "laptop", "tent", "camera", "bread", "rocket",
         "guitar", "mural", "kite")
VERBS = ("prepping", "fixing", "planting", "tuning", "building", "pitching", "testing",
         "baking", "launching", "strumming", "painting", "flying")
DURATION = 90.0
TIMESTAMPS = [[0.0, 30.0], [30.0, 62.0], [62.0, 90.0]]


def build_dataset(root: Path, n_videos: int, rng: np.random.Generator
                  ) -> Tuple[Path, Path, Path]:
    """The synthetic chapters under ``root``: ``feats/{vid}.npy`` (a
    distinctive [120, 768] normal pattern a video, which the captions are
    keyed on), ``ann.json`` and ``asr.pkl``. Returns their paths."""
    from vidchapters_tpu_torch.utils.io import save_pickle

    feat_dir = root / "feats"
    feat_dir.mkdir(parents=True, exist_ok=True)
    ann, asr = {}, {}
    for i in range(n_videos):
        vid = f"overfitvid{i:02d}"[-11:]
        np.save(feat_dir / f"{vid}.npy", rng.normal(size=(120, 768)).astype(np.float32))
        noun, verb = NOUNS[i % len(NOUNS)], VERBS[i % len(VERBS)]
        ann[vid] = {"duration": DURATION, "timestamps": TIMESTAMPS,
                    "sentences": [f"{verb} the {noun}", f"{noun} close up",
                                  f"final {noun} reveal"]}
        asr[vid] = {"text": [f"today we are {verb} a {noun}"], "start": [1.0], "end": [8.0]}
    ann_path = root / "ann.json"
    ann_path.write_text(json.dumps(ann))
    asr_path = root / "asr.pkl"
    save_pickle(asr, asr_path)
    return ann_path, asr_path, feat_dir


def experiment_config(root: Path, ann_path: Path, asr_path: Path, feat_dir: Path,
                      epochs: int, videos: int, lr: float, smoke: bool):
    """``tpu_overfit.py``'s ``ExperimentConfig``: the full recipe (or the
    smoke's tiny model), one epoch of one batch of every video."""
    from vidchapters_tpu_torch.config import (
        CheckpointConfig, DataConfig, DatasetPaths, ExperimentConfig, GenerationConfig,
        MeshConfig, OptimConfig, T5Config, TemporalViTConfig, TrainConfig, Vid2SeqConfig)

    if smoke:  # tpu_overfit.py's, at 2 heads of 32 (not 4 of 16): the decode kernel
        # takes head widths 32, 64, 96 and 128
        model = Vid2SeqConfig(
            t5=T5Config(vocab_size=32200, d_model=64, d_kv=32, d_ff=128, num_layers=2,
                        num_decoder_layers=2, num_heads=2, dtype="float32",
                        dropout_rate=0.0, encoder_dropout=0.0, decoder_dropout=0.0),
            vit=TemporalViTConfig(num_features=16, embed_dim=768, depth=2, num_heads=4,
                                  mlp_dim=128, dtype="float32"))
        data = DataConfig(max_feats=16, features_dim=768, max_input_tokens=64,
                          max_output_tokens=64)
        generation = GenerationConfig(num_beams=1, max_length=48)
    else:  # the reference recipe (README.md:179-185)
        model = Vid2SeqConfig()
        data = DataConfig(max_feats=100, features_dim=768, max_input_tokens=1000,
                          max_output_tokens=256)
        generation = GenerationConfig(num_beams=4, max_length=256)
    paths = DatasetPaths(train_json_path=str(ann_path), val_json_path=str(ann_path),
                         test_json_path=str(ann_path), features_path=str(feat_dir),
                         subtitles_path=str(asr_path))
    return ExperimentConfig(
        combine_datasets=["chapters"], datasets={"chapters": paths}, data=data,
        model=model, generation=generation,
        train=TrainConfig(
            epochs=epochs, batch_size=videos, eval_batch_size=videos, print_freq=50,
            eval_every_epochs=max(1, epochs // 3),
            optim=OptimConfig(lr=lr, clip_max_norm=1.0, fraction_warmup_steps=0.05),
            checkpoint=CheckpointConfig(save_dir=str(root / "ckpt"), best_metric="soda_c",
                                        save_last_every_epochs=epochs),
            mesh=MeshConfig()))


def label_smoothing_floor(eps: float, vocab: int) -> float:
    """The least label-smoothed cross entropy: the entropy of the smoothed
    target, p_t = 1 - eps + eps / V on the target, eps / V elsewhere."""
    p_t, p_o = 1.0 - eps + eps / vocab, eps / vocab
    return float(-(p_t * np.log(p_t) + (vocab - 1) * p_o * np.log(p_o)))


def soda_c_ceiling(ann_path: Path) -> float:
    """SODA_c of the GT against itself, its times quantised as the
    reference quantises them (int(99 t / duration) / 99 * duration)."""
    from vidchapters_tpu_torch.evals import eval_soda

    ann = json.loads(Path(ann_path).read_text())

    def quantised(t: float, duration: float) -> float:
        return int(99 * t / duration) / 99 * duration

    sub = {"results": {
        vid: [{"sentence": s, "timestamp": [quantised(t0, a["duration"]),
                                            quantised(t1, a["duration"])]}
              for s, (t0, t1) in zip(a["sentences"], a["timestamps"])]
        for vid, a in ann.items()}}
    return float(eval_soda(sub, [str(ann_path)])["soda_c"])


def read_losses(log_path: Path) -> Tuple[List[float], List[float]]:
    """(total, generative) train losses of each epoch of ``log.txt``, read
    as ``tpu_overfit.py`` reads them."""
    losses, gen_losses = [], []
    for line in Path(log_path).read_text().splitlines():
        row = json.loads(line)
        for key in ("train_total_loss", "total_loss", "train_loss"):
            if key in row:
                losses.append(float(row[key]))
                break
        if "train_loss" in row:
            gen_losses.append(float(row["train_loss"]))
    return losses, gen_losses


def card_line() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def serve_best(cfg, save_dir: Path, ann: Dict, feat_dir: Path, asr: Dict, device: str
               ) -> Dict:
    """Serve every video from ``best`` on the decode kernel's route: one
    request at a time, then all at once. Returns each video's chapters of
    both rounds and the decode steps of each device call."""
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
    from vidchapters_tpu_torch.models import t5 as t5_mod
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.serve import ChapterGenerator, load_serving_params

    model = load_serving_params(Vid2Seq(cfg.model), str(save_dir))
    tokenizer = build_tokenizer(cfg.tokenizer_path, num_bins=cfg.model.num_bins)
    requests = {vid: (np.load(feat_dir / f"{vid}.npy"), a["duration"], asr[vid])
                for vid, a in ann.items()}
    together: Dict[str, list] = {}
    errors: List[Exception] = []
    was = t5_mod.USE_MEGA_DECODE
    t5_mod.USE_MEGA_DECODE = True
    engine = ChapterGenerator(model, tokenizer, cfg.data, cfg.generation, cfg.model.num_bins,
                              device=device, max_batch=max(1, len(ann)))

    def ask(vid):
        try:
            together[vid] = engine.generate_chapters(*requests[vid])
        except Exception as e:  # raised in the calling thread below
            errors.append(e)

    try:
        t0 = time.time()
        one_by_one = {vid: engine.generate_chapters(*req) for vid, req in requests.items()}
        one_s = time.time() - t0
        calls_one = list(engine.decode_steps)
        threads = [threading.Thread(target=ask, args=(vid,)) for vid in requests]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        together_s = time.time() - t0
    finally:
        engine.close()
        t5_mod.USE_MEGA_DECODE = was
    if errors:
        raise errors[0]
    steps = list(engine.decode_steps)
    return {"route": "decode kernel (USE_MEGA_DECODE)", "one_by_one": one_by_one,
            "together": dict(sorted(together.items())), "decode_steps_one_by_one": calls_one,
            "decode_steps_together": steps[len(calls_one):], "device_calls": engine.device_calls,
            "one_by_one_s": one_s, "together_s": together_s}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--videos", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--smoke", action="store_true",
                   help="tiny model at CPU-friendly shapes: checks the plumbing, writes no "
                        "record")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--workdir", default="",
                   help="where the data, checkpoints and log go (a new temporary directory "
                        "by default)")
    p.add_argument("--out", default=str(RECORD), help="the record's path (not with --smoke)")
    a = p.parse_args(argv)

    from vidchapters_tpu_torch.models import t5 as t5_mod
    from vidchapters_tpu_torch.train.dvc_main import main as dvc_main
    from vidchapters_tpu_torch.utils.io import load_pickle

    root = Path(a.workdir or tempfile.mkdtemp(prefix="overfit_"))
    root.mkdir(parents=True, exist_ok=True)
    ann_path, asr_path, feat_dir = build_dataset(root, a.videos, np.random.default_rng(0))
    cfg = experiment_config(root, ann_path, asr_path, feat_dir, a.epochs, a.videos, a.lr,
                            a.smoke)
    card = card_line() if a.device != "cpu" else None
    was = t5_mod.USE_MEGA_DECODE
    t5_mod.USE_MEGA_DECODE = False  # the evals on the standard decode
    t0 = time.time()
    try:
        metrics = dvc_main(cfg, device=a.device)
    finally:
        t5_mod.USE_MEGA_DECODE = was
    train_eval_s = time.time() - t0

    save_dir = root / "ckpt"
    losses, gen_losses = read_losses(save_dir / "log.txt")
    floor = label_smoothing_floor(cfg.model.t5.label_smoothing, cfg.model.t5.vocab_size)
    ceiling = soda_c_ceiling(ann_path)
    ann = json.loads(ann_path.read_text())
    served = serve_best(cfg, save_dir, ann, feat_dir, load_pickle(asr_path), a.device)
    best_epoch = json.loads((save_dir / "best.meta.json").read_text())["epoch"] \
        if (save_dir / "best.meta.json").exists() else None
    eval_preds = json.loads((save_dir / f"chapters_val_preds_e{best_epoch}.json")
                            .read_text())["results"] if best_epoch is not None else {}
    max_length = cfg.generation.max_length
    calls = served["decode_steps_one_by_one"] + served["decode_steps_together"]
    soda = float(metrics.get("chapters_soda_c", 0.0))
    out = {
        "metric": "h100_overfit_recipe_scale",
        "loss_first_epoch": losses[0] if losses else None,
        "loss_last_epoch": losses[-1] if losses else None,
        "generative_loss_first": gen_losses[0] if gen_losses else None,
        "generative_loss_last": gen_losses[-1] if gen_losses else None,
        "label_smoothing_floor": floor,
        "cider": float(metrics.get("chapters_CIDEr", 0.0)),
        "soda_c": soda,
        "soda_c_ceiling": ceiling,
        "f1": float(metrics.get("chapters_F1", 0.0)),
        "epochs": a.epochs,
        "videos": a.videos,
        "scan_layers": False,
        "workdir": str(root),
        "generative_loss_over_floor": (gen_losses[-1] / floor) if gen_losses else None,
        "soda_c_pct_of_ceiling": soda / ceiling if ceiling else None,
        "metrics": metrics,
        "steps": a.epochs,  # one batch of every video an epoch
        "train_and_eval_wall_s": train_eval_s,
        "lr": a.lr,
        "device": a.device,
        "card": card,
        "best_epoch": best_epoch,
        "eval_chapters_of_best": eval_preds,
        "serving": served,
        "served_equal_eval": all(served[k].get(vid) == eval_preds.get(vid)
                                 for k in ("one_by_one", "together") for vid in ann),
        "serving_calls_end_before_max_length": bool(calls) and max(calls) < max_length,
        "max_length": max_length,
    }
    if not a.smoke:
        Path(a.out).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
