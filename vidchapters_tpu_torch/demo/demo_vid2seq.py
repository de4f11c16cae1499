"""Single-video chapter generation demo.

Counterpart of ``vidchapters_tpu/demo/demo_vid2seq.py`` (the reference's
demo_vid2seq.py:24-197): decode the video at 1 FPS, extract CLIP ViT-L/14
features (``factory/features``, the image tower's attention on the fused
kernel), subsample/pad to ``max_feats``, build the time+text ASR input from
a Whisper pickle, generate with beam search (the T5 decode kernel and the
top-k kernel on the card), and regex-decode ``<time=k>`` pairs into
chapters.

Usage:
  python -m vidchapters_tpu_torch.demo.demo_vid2seq --video_path v.mp4 \\
      --asr_path v_asr.pkl --ckpt_path vid2seq.pth \\
      --clip_ckpt ViT-L-14.pt --tokenizer_path spiece.model

Precomputed features (``--features_path f.npy``) skip decode + CLIP. It runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="",
                   help="experiment json; its model section replaces the "
                        "full-recipe Vid2Seq defaults (for custom-scale "
                        "checkpoints)")
    p.add_argument("--video_path", default="")
    p.add_argument("--features_path", default="",
                   help="precomputed [T, 768] .npy (skips decode + CLIP)")
    p.add_argument("--asr_path", default="",
                   help="whisper(x) pickle for this video")
    p.add_argument("--ckpt_path", default="",
                   help="reference Vid2Seq .pth checkpoint (imported)")
    p.add_argument("--clip_ckpt", default="",
                   help="OpenAI CLIP ViT-L/14 .pt (TorchScript archive or state dict)")
    p.add_argument("--tokenizer_path", default="",
                   help="T5 spiece.model (byte fallback if empty)")
    # None = inherit from --config (model.num_bins / data.*) when given,
    # else the reference demo defaults; an explicit flag always wins
    p.add_argument("--num_bins", type=int, default=None)
    p.add_argument("--max_feats", type=int, default=None)
    p.add_argument("--max_input_tokens", type=int, default=None)
    p.add_argument("--num_beams", type=int, default=4)
    p.add_argument("--max_output_tokens", type=int, default=None)
    p.add_argument("--out_path", default="")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def clip_features(video_path: str, clip_ckpt: str, device) -> np.ndarray:
    """1-FPS frames of ``video_path`` through the ViT-L/14 image tower of
    the OpenAI checkpoint ``clip_ckpt`` -> [T, 768] float32."""
    from vidchapters_tpu_torch.factory.features import (
        CLIPFeatureExtractor,
        decode_video_1fps,
    )
    from vidchapters_tpu_torch.models.clip import (
        VIT_L14,
        CLIPImageEncoder,
        convert_openai_clip_visual,
        load_openai_clip,
    )

    frames = decode_video_1fps(video_path)
    encoder = CLIPImageEncoder(VIT_L14)
    encoder.load_state_dict(convert_openai_clip_visual(load_openai_clip(clip_ckpt)))
    return CLIPFeatureExtractor(encoder, device)(frames)


def main(args=None) -> list:
    from vidchapters_tpu_torch import resolve_device
    from vidchapters_tpu_torch.config import GenerationConfig, Vid2SeqConfig
    from vidchapters_tpu_torch.data.features import subsample_or_pad
    from vidchapters_tpu_torch.data.time_tokens import (
        build_time_text_sequence,
        decode_chapter_sequence,
    )
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.train import dvc_train

    args = build_parser().parse_args(args)
    device = resolve_device(args.device)
    # resolve config FIRST: the tokenizer's time-token block and the
    # quantization below must use the loaded model's num_bins, or chapters
    # come back silently mis-timestamped on custom-scale checkpoints
    if args.config:
        from vidchapters_tpu_torch.config import ExperimentConfig, load_config

        exp_cfg = load_config(ExperimentConfig, args.config)
        cfg = exp_cfg.model
        data_defaults = exp_cfg.data
    else:
        from vidchapters_tpu_torch.config import DataConfig

        cfg = Vid2SeqConfig()
        data_defaults = DataConfig()
    if args.num_bins is None:
        args.num_bins = cfg.num_bins
    if args.max_feats is None:
        args.max_feats = data_defaults.max_feats
    if args.max_input_tokens is None:
        args.max_input_tokens = data_defaults.max_input_tokens
    if args.max_output_tokens is None:
        args.max_output_tokens = data_defaults.max_output_tokens
    tokenizer = build_tokenizer(args.tokenizer_path, num_bins=args.num_bins)

    # 1. frame features
    if args.features_path:
        feats = np.load(args.features_path).astype(np.float32)
    else:
        feats = clip_features(args.video_path, args.clip_ckpt, device)
    duration = float(len(feats))  # 1 FPS
    video = subsample_or_pad(feats, args.max_feats)[None]

    # 2. ASR -> time+text tokens (demo_vid2seq.py:141-150)
    if args.asr_path:
        from vidchapters_tpu_torch.utils.io import load_pickle

        sub = load_pickle(args.asr_path)
        if "segments" in sub:
            from vidchapters_tpu_torch.factory.asr import proc_asr

            sub = proc_asr(sub)
        input_tokens = np.asarray(build_time_text_sequence(
            sub["start"], sub["end"], sub["text"], duration, tokenizer,
            args.num_bins, args.max_input_tokens, filter_to_duration=True))
    else:
        input_tokens = np.asarray([tokenizer.eos_token_id])
    input_tokens = np.pad(input_tokens,
                          (0, args.max_input_tokens - len(input_tokens)))[None]

    # 3. model
    model = Vid2Seq(cfg)
    if args.ckpt_path:
        from vidchapters_tpu_torch.models.torch_import import (
            load_torch_checkpoint,
            vid2seq_from_reference,
        )

        model.load_state_dict(vid2seq_from_reference(load_torch_checkpoint(args.ckpt_path),
                                                     model))
    else:
        print("WARNING: no checkpoint given; using random weights")
        model.init_weights(torch.Generator().manual_seed(0))
    model.to(device)

    gen = GenerationConfig(num_beams=args.num_beams, max_length=args.max_output_tokens)
    generate = dvc_train.make_generate_fn(model, gen)
    seqs = generate(torch.from_numpy(video).to(device),
                    torch.from_numpy(input_tokens.astype(np.int32)).to(device))
    text = tokenizer.batch_decode(np.asarray(seqs.cpu()), skip_special_tokens=True)[0]
    chapters = decode_chapter_sequence(text, duration, args.num_bins)
    for ch in chapters:
        st, ed = ch["timestamp"]
        print(f"[{st:8.1f}s - {ed:8.1f}s] {ch['sentence']}")
    if args.out_path:
        with open(args.out_path, "w") as f:
            json.dump(chapters, f, indent=2)
    return chapters


if __name__ == "__main__":
    main()
