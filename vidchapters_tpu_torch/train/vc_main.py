"""VC (chapter titles with GT boundaries) training and evaluation entry point.

Counterpart of ``vidchapters_tpu/train/vc_main.py`` (the reference's
vc.py:178-330) on one GPU: per-epoch clip-level training with tokenization
in the loop, the COCO-captioning eval of every val clip after each epoch,
``best`` on CIDEr, ``last`` and ``log.txt`` every epoch, and a final eval
with the ``best`` weights.

    python -m vidchapters_tpu_torch.train.vc_main --train-json T --val-json V \\
        --features-path F --save-dir D [--device cuda|cpu]
    python -m vidchapters_tpu_torch.train.vc_main --eval --model-type random \\
        --val-json V --features-path F --save-dir D
    python -m vidchapters_tpu_torch.train.vc_main --eval --model-type blip2 \\
        --blip2-dir B --videos-path videos.json --val-json V --features-path F --save-dir D

The optimizer is the JAX module's ``optax.chain(clip_by_global_norm(0.1),
adam(lr))``: ``ClipAdamW`` with no weight decay and a constant lr. The
examples come from the epoch's numpy generator in the JAX module's order,
so the batches are the same for the same seed. ``--eval --model-type
random`` scores each clip's ASR as its title (vc.py:109); ``blip2`` captions
each clip's first raw frame with the BLIP-2 checkpoint directory of
``--blip2-dir`` (``--videos-path`` maps video ids to raw videos); ``llama``
reaches ``models.llama.build_llama_titler``, which raises until the port
has LLaMA's SentencePiece-BPE encoder.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from vidchapters_tpu_torch import resolve_device
from vidchapters_tpu_torch.config import DataConfig, GenerationConfig, Vid2SeqConfig
from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
from vidchapters_tpu_torch.data.vc_dataset import VideoCaptioningDataset, vc_collate
from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
from vidchapters_tpu_torch.runtime.checkpoint import CheckpointManager
from vidchapters_tpu_torch.runtime.meters import MetricLogger
from vidchapters_tpu_torch.train.dvc_train import TrainState
from vidchapters_tpu_torch.train.schedules import ClipAdamW
from vidchapters_tpu_torch.train.vc_train import (
    evaluate_vc,
    evaluate_vc_blip2,
    evaluate_vc_llama,
    evaluate_vc_with_captioner,
    make_vc_train_step,
    tokenize_batch,
)


def main(train_json: str, val_json: str, features_path, model_cfg: Vid2SeqConfig,
         data_cfg: DataConfig, save_dir: str, subtitles_path: Optional[str] = None,
         tokenizer_path: str = "", n_epochs: int = 20, batch_size: int = 16,
         lr: float = 3e-4, seed: int = 0,
         init_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
         generation: GenerationConfig = GenerationConfig(num_beams=4, max_length=32),
         device: "str | torch.device | None" = None) -> Dict[str, float]:
    """Train ``n_epochs`` from ``init_state_dict`` (else the seeded init),
    evaluating on val after each; returns the final eval's metrics, with the
    ``best`` weights."""
    device = resolve_device(device)
    tokenizer = build_tokenizer(tokenizer_path, num_bins=model_cfg.num_bins)
    train_ds = VideoCaptioningDataset(train_json, features_path, training=True, cfg=data_cfg,
                                      subtitles_path=subtitles_path)
    val_ds = VideoCaptioningDataset(val_json, features_path, training=False, cfg=data_cfg,
                                    subtitles_path=subtitles_path)

    model = Vid2Seq(model_cfg)
    if init_state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(init_state_dict)
    model.to(device)
    print(f"number of params: {sum(p.numel() for p in model.parameters())}")
    optimizer = ClipAdamW(model.parameters(), lambda count: lr, clip_max_norm=0.1)
    state = TrainState(model, optimizer)
    train_step = make_vc_train_step(model)
    ckpt = CheckpointManager(save_dir, best_metric="CIDEr")
    log_path = Path(save_dir) / "log.txt"
    d = data_cfg

    def val_eval():
        return evaluate_vc(model, val_ds, tokenizer, generation,
                           max_input_tokens=d.max_input_tokens)[1]

    np_rng = np.random.default_rng(seed)
    for epoch in range(n_epochs):
        logger = MetricLogger()
        order = np_rng.permutation(len(train_ds))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            batch = vc_collate([train_ds.__getitem__(int(i), rng=np_rng)
                                for i in order[s:s + batch_size]])
            arrays = {
                "video": torch.as_tensor(batch["video"]).to(device, non_blocking=True),
                "input_tokens": torch.as_tensor(tokenize_batch(
                    batch["input_text"], tokenizer, d.max_input_tokens)).to(device),
                "output_tokens": torch.as_tensor(tokenize_batch(
                    batch["output_text"], tokenizer, d.max_output_tokens,
                    buckets=d.output_buckets)).to(device),
            }
            metrics = train_step(state, arrays, seed)
            logger.update(loss=float(metrics["loss"]))

        metrics = val_eval()
        ckpt.maybe_save_best(state, epoch, metrics)
        ckpt.save_last(state, epoch)
        with open(log_path, "a") as f:
            f.write(json.dumps({"epoch": epoch, **logger.global_averages(), **metrics}) + "\n")

    if ckpt.has("best"):
        ckpt.restore("best", state)
    return val_eval()


def _cli(argv=None) -> None:
    import argparse

    from vidchapters_tpu_torch.config import load_config

    p = argparse.ArgumentParser(description="Video-captioning (Vid2Seq) training / "
                                            "zero-shot eval")
    p.add_argument("--train-json", default=None, help="required unless --eval")
    p.add_argument("--val-json", required=True)
    p.add_argument("--features-path", required=True)
    p.add_argument("--save-dir", required=True)
    p.add_argument("--model-config", default=None, help="Vid2SeqConfig json")
    p.add_argument("--data-config", default=None, help="DataConfig json")
    p.add_argument("--subtitles-path", default=None)
    p.add_argument("--tokenizer-path", default="")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval", action="store_true",
                   help="skip training; run the chosen zero-shot evaluator on --val-json")
    p.add_argument("--model-type", default="random", choices=["random", "blip2", "llama"],
                   help="--eval captioner (vc.py model selection); random scores the ASR")
    p.add_argument("--blip2-dir", default=None,
                   help="HF blip2-flan-t5-xl dir for --model-type blip2")
    p.add_argument("--llama-dir", default=None, help="HF LLaMA dir for --model-type llama")
    p.add_argument("--videos-path", default=None,
                   help="json mapping vid -> raw video path (blip2 eval needs first frames)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    model_cfg = load_config(Vid2SeqConfig, a.model_config) if a.model_config else Vid2SeqConfig()
    data_cfg = load_config(DataConfig, a.data_config) if a.data_config else DataConfig()
    if a.eval:
        ds = VideoCaptioningDataset(a.val_json, a.features_path, training=False,
                                    cfg=data_cfg, subtitles_path=a.subtitles_path,
                                    videos_path=a.videos_path)
        if a.model_type == "random":
            # the --random baseline scores the ASR text itself (vc.py:109)
            _, metrics = evaluate_vc_with_captioner(ds, lambda clip, asr: asr)
        elif a.model_type == "blip2":
            if not a.blip2_dir or not a.videos_path:
                p.error("--model-type blip2 needs --blip2-dir and --videos-path")
            from vidchapters_tpu_torch.models.blip2 import build_blip2_captioner

            _, metrics = evaluate_vc_blip2(ds, build_blip2_captioner(a.blip2_dir,
                                                                     device=a.device))
        else:
            if not a.llama_dir:
                p.error("--model-type llama needs --llama-dir")
            from vidchapters_tpu_torch.models.llama import build_llama_titler

            _, metrics = evaluate_vc_llama(ds, build_llama_titler(a.llama_dir,
                                                                  device=a.device))
        print(json.dumps(metrics))
        return
    if not a.train_json:
        p.error("--train-json required without --eval")
    print(json.dumps(main(a.train_json, a.val_json, a.features_path, model_cfg, data_cfg,
                          a.save_dir, subtitles_path=a.subtitles_path,
                          tokenizer_path=a.tokenizer_path, n_epochs=a.epochs,
                          batch_size=a.batch_size, lr=a.lr, seed=a.seed, device=a.device)))


if __name__ == "__main__":
    _cli()
