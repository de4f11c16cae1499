"""Persistent chapter-generation inference server (PyTorch port).

Counterpart of ``vidchapters_tpu/serve.py``: ASR -> time+text tokens,
encode, beam decode, ``<time=k>`` parse, answered as JSON over HTTP:

    POST /v1/chapters {"features": [[...]...], "duration": 120.0,
                       "asr": {"text": [...], "start": [...], "end": [...]}}
      -> {"chapters": [{"sentence": ..., "timestamp": [s, e]}], ...}
    GET  /healthz -> {"ok": true, "buckets": [...]}

- input lengths snap to ``DataConfig.input_buckets`` and batch sizes to
  ``batch_buckets`` (pad rows are replicas of row 0), so a batch's shapes
  come from a bounded set;
- concurrent requests are coalesced: a dispatcher thread drains the
  request queue and runs one batched generate per input bucket (a lone
  request waits at most ``max_wait_ms`` for company);
- device calls are pipelined: the dispatcher hands each call's on-device
  result to a completion thread, which copies it to the host and wakes its
  requests while the dispatcher assembles the next batch;
- features are subsampled/padded host-side to the static ``max_feats``.

Usage:
    python -m vidchapters_tpu_torch.serve --config exp.json \
        [--ckpt SAVE_DIR | CKPT_FILE | state_dict.pt | reference.pth | jax.npz] \
        [--device cuda] \
        --port 8976
(--ckpt omitted = seeded random weights: smoke/benchmark mode.)
"""

from __future__ import annotations

import json
import queue as queue_mod
import threading
import time
from collections import deque
from pathlib import Path
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from vidchapters_tpu_torch import resolve_device
from vidchapters_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    GenerationConfig,
)
from vidchapters_tpu_torch.data.time_tokens import (
    build_time_text_sequence,
    decode_chapter_sequence,
)
from vidchapters_tpu_torch.models import torch_import
from vidchapters_tpu_torch.models.weights import from_jax_params
from vidchapters_tpu_torch.runtime import jax_checkpoint
from vidchapters_tpu_torch.runtime.checkpoint import CheckpointManager


class _Pending:
    """One enqueued request awaiting a coalesced device call."""

    __slots__ = ("video", "tokens", "bucket", "event", "seq", "error")

    def __init__(self, video: np.ndarray, tokens: np.ndarray, bucket: int):
        self.video = video
        self.tokens = tokens
        self.bucket = bucket
        self.event = threading.Event()
        self.seq: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None


class ChapterGenerator:
    """Inference engine: (features, duration, asr) -> chapter list."""

    def __init__(self, model, tokenizer, data_cfg: DataConfig,
                 gen_cfg: GenerationConfig, num_bins: int, device=None,
                 coalesce: bool = True, max_batch: int = 8,
                 batch_buckets=(1, 2, 4, 8), max_wait_ms: float = 25.0,
                 pipeline: bool = True):
        from vidchapters_tpu_torch.train.dvc_train import make_generate_fn

        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.tokenizer = tokenizer
        self.data_cfg = data_cfg
        self.num_bins = num_bins
        self.buckets = sorted(
            {b for b in data_cfg.input_buckets
             if b <= data_cfg.max_input_tokens}
            | {data_cfg.max_input_tokens})
        self._generate = make_generate_fn(self.model, gen_cfg)
        self._lock = threading.Lock()
        # request coalescing
        self.coalesce = coalesce
        self.batch_buckets = sorted(b for b in batch_buckets
                                    if b <= max_batch) or [1]
        self._max_batch = self.batch_buckets[-1]
        self._max_wait = max_wait_ms / 1000.0
        self.device_calls = 0  # observability: batched calls made
        # observability: the decode steps of each device call, newest last
        self.decode_steps: Deque[int] = deque(maxlen=4096)
        self._queue: queue_mod.Queue = queue_mod.Queue()
        self._dispatcher: Optional[threading.Thread] = None
        self._dispatcher_lock = threading.Lock()
        self._closed = False
        # pipelined (double-buffered) dispatch: in-flight device results
        # travel dispatcher -> completion thread through a bounded queue
        self.pipeline = pipeline
        self._completion_q: queue_mod.Queue = queue_mod.Queue(maxsize=1)
        self._completer: Optional[threading.Thread] = None
        self._close_timeout = 5.0  # close() join patience (tests shrink it)

    def _ensure_dispatcher(self) -> None:
        # locked: two concurrent first requests must not each start a
        # dispatcher (check-then-start race would degrade coalescing);
        # a dedicated lock so an in-flight device call (which holds
        # self._lock) cannot delay enqueueing
        with self._dispatcher_lock:
            if self._dispatcher is None or not self._dispatcher.is_alive():
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop, daemon=True)
                self._dispatcher.start()
            if self.pipeline and (self._completer is None
                                  or not self._completer.is_alive()):
                self._completer = threading.Thread(
                    target=self._completion_loop, daemon=True)
                self._completer.start()

    def _batch_bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self._max_batch

    def _dispatch_loop(self) -> None:
        """Drain the queue into per-input-bucket groups and run one device
        call per group.  While a batch is on the device, new requests pile up
        in the queue, so batching adapts to load without a fixed delay."""
        try:
            while True:
                item = self._queue.get()
                if item is None:  # shutdown sentinel
                    return
                batch = [item]
                deadline = time.monotonic() + self._max_wait
                while len(batch) < self._max_batch:
                    timeout = deadline - time.monotonic()
                    try:
                        nxt = (self._queue.get_nowait() if timeout <= 0
                               else self._queue.get(timeout=timeout))
                    except queue_mod.Empty:
                        break
                    if nxt is None:
                        self._run_groups(batch)
                        return
                    batch.append(nxt)
                self._run_groups(batch)
        finally:
            if self.pipeline:
                # the dispatcher — not close() — ends the completion
                # thread: FIFO guarantees every in-flight (group, seqs)
                # this loop enqueued is fetched before the sentinel, so a
                # device call that outlives close()'s join timeout still
                # wakes its requests instead of stranding them
                self._completion_q.put(None)

    def _run_groups(self, batch: List[_Pending]) -> None:
        groups: Dict[int, List[_Pending]] = {}
        for p in batch:
            groups.setdefault(p.bucket, []).append(p)
        for group in groups.values():
            if self.pipeline:
                # the completion thread copies the result to the host so
                # the dispatcher can assemble and launch the next batch
                try:
                    seqs = self._device_dispatch(
                        np.stack([p.video for p in group]),
                        np.stack([p.tokens for p in group]))
                except Exception as e:  # shape or launch errors: fail now
                    for p in group:
                        p.error = e
                        p.event.set()
                    continue
                self._completion_q.put((group, seqs))
                continue
            try:
                seqs = self._device_generate(
                    np.stack([p.video for p in group]),
                    np.stack([p.tokens for p in group]))
                for p, seq in zip(group, seqs):
                    p.seq = seq
            except Exception as e:  # surface as per-request 500s
                for p in group:
                    p.error = e
            finally:
                for p in group:
                    p.event.set()

    def _completion_loop(self) -> None:
        """Block on in-flight device results and wake their requests."""
        while True:
            item = self._completion_q.get()
            if item is None:  # shutdown sentinel
                return
            group, seqs = item
            try:
                out = _to_host(seqs)[: len(group)]
                for p, seq in zip(group, out):
                    p.seq = seq
            except Exception as e:
                for p in group:
                    p.error = e
            finally:
                for p in group:
                    p.event.set()

    def _device_dispatch(self, videos: np.ndarray, tokens: np.ndarray):
        """Run one generate (padded to a batch bucket) WITHOUT copying the
        result to the host; returns the on-device sequences."""
        n = videos.shape[0]
        b = self._batch_bucket(n)
        if b > n:  # pad with replicas of row 0 (dropped after decode)
            videos = np.concatenate(
                [videos, np.repeat(videos[:1], b - n, axis=0)])
            tokens = np.concatenate(
                [tokens, np.repeat(tokens[:1], b - n, axis=0)])
        with self._lock:
            seqs = self._generate(
                torch.from_numpy(np.ascontiguousarray(videos)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(tokens)).to(self.device))
            self.device_calls += 1
            self.decode_steps.append(self._generate.decode_steps)
        return seqs

    def _device_generate(self, videos: np.ndarray, tokens: np.ndarray
                         ) -> np.ndarray:
        """Dispatch + blocking fetch (warmup and non-coalesced paths)."""
        n = videos.shape[0]
        return _to_host(self._device_dispatch(videos, tokens))[:n]

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _input_tokens(self, asr: Optional[dict], duration: float) -> np.ndarray:
        if not asr or not asr.get("text"):
            return np.array([self.tokenizer.eos_token_id], np.int32)
        ids = build_time_text_sequence(
            asr["start"], asr["end"], asr["text"], duration, self.tokenizer,
            self.num_bins, self.data_cfg.max_input_tokens,
            filter_to_duration=True)
        return np.asarray(ids, np.int32)

    def generate_chapters(self, features: np.ndarray, duration: float,
                          asr: Optional[dict] = None) -> List[Dict]:
        """[T, D] float features + seconds + optional ASR -> chapters
        ``[{"sentence": str, "timestamp": [start, end]}]``."""
        from vidchapters_tpu_torch.data.features import subsample_or_pad

        video = subsample_or_pad(np.asarray(features, np.float32),
                                 self.data_cfg.max_feats,
                                 self.data_cfg.features_dim)
        ids = self._input_tokens(asr, duration)
        bucket = self._bucket(len(ids))
        tokens = np.zeros(bucket, np.int32)
        tokens[:min(len(ids), bucket)] = ids[:bucket]
        if self.coalesce:
            if self._closed:
                raise RuntimeError("ChapterGenerator is closed")
            pending = _Pending(video, tokens, bucket)
            self._ensure_dispatcher()
            self._queue.put(pending)
            pending.event.wait()
            if pending.error is not None:
                raise pending.error
            seq = pending.seq
        else:
            seq = self._device_generate(video[None], tokens[None])[0]
        text = self.tokenizer.batch_decode(np.asarray(seq)[None],
                                           skip_special_tokens=True)[0]
        return decode_chapter_sequence(text, float(duration), self.num_bins)

    def warmup(self, batch_sizes=(1,)) -> None:
        """Run one generate per (input bucket x batch size) before serving
        traffic, so kernel builds and first-call allocations are paid
        before the first request."""
        for b in self.buckets:
            asr = {"text": ["warmup"], "start": [0.0], "end": [1.0]}
            feats = np.zeros((self.data_cfg.max_feats,
                              self.data_cfg.features_dim), np.float32)
            ids = self._input_tokens(asr, 10.0)
            pad = np.zeros(b, np.int32)
            pad[:len(ids)] = ids[:b]
            for n in batch_sizes:
                self._device_generate(
                    np.repeat(feats[None], n, axis=0),
                    np.repeat(pad[None], n, axis=0))

    def close(self) -> None:
        """Stop the dispatcher thread. The batch already on the device
        completes; requests still queued when the shutdown sentinel lands
        are failed fast (error set + event signalled) so no caller blocks
        forever, and new enqueues are rejected."""
        self._closed = True
        t = self._close_timeout
        dispatcher_exited = True
        if self._dispatcher is not None and self._dispatcher.is_alive():
            self._queue.put(None)
            self._dispatcher.join(timeout=t)
            dispatcher_exited = not self._dispatcher.is_alive()
        if self._completer is not None and self._completer.is_alive():
            # the dispatch loop enqueues the completion sentinel itself on
            # exit (after its last in-flight result). Only inject one here
            # if the dispatcher never started its loop exit — i.e. it is
            # already dead without having sent it (defensive; a live
            # dispatcher will send it, and the completer must outlive it).
            if dispatcher_exited:
                self._completer.join(timeout=t)
                if self._completer.is_alive():
                    # bounded (maxsize-1) queue: a blocking put could stall
                    # close() for a full in-flight device fetch — give up
                    # after the timeout instead (the completer is a daemon)
                    try:
                        self._completion_q.put(None, timeout=t)
                    except queue_mod.Full:
                        pass
                    self._completer.join(timeout=t)
        # drain requests stranded behind (or racing) the sentinels
        while True:
            try:
                item = self._queue.get_nowait()
            except queue_mod.Empty:
                break
            if item is not None:
                item.error = RuntimeError("ChapterGenerator closed before "
                                          "this request was dispatched")
                item.event.set()
        popped_sentinel = False
        while True:
            try:
                item = self._completion_q.get_nowait()
            except queue_mod.Empty:
                break
            if item is None:
                # a dispatcher that outlived the join timeout enqueues its
                # completion sentinel LATE — it belongs to the completer,
                # not to this drain; remember it and put it back so the
                # still-alive completer is not stranded on an empty queue
                popped_sentinel = True
                continue
            for p in item[0]:
                p.error = RuntimeError("ChapterGenerator closed before "
                                       "this result was fetched")
                p.event.set()
        if popped_sentinel and (self._completer is not None
                                and self._completer.is_alive()):
            try:
                self._completion_q.put_nowait(None)
            except queue_mod.Full:
                pass


def _make_handler(engine: ChapterGenerator):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "buckets": engine.buckets})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/chapters":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                features = np.asarray(req["features"], np.float32)
                if features.ndim != 2:
                    raise ValueError("features must be [frames, dim]")
                duration = float(req["duration"])
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            try:
                chapters = engine.generate_chapters(
                    features, duration, req.get("asr"))
            except Exception as e:  # surface engine errors as 500s
                self._reply(500, {"error": str(e)})
                return
            self._reply(200, {"chapters": chapters})

        def log_message(self, fmt, *args):  # quiet access log
            pass

    return Handler


def serve(engine: ChapterGenerator, host: str = "127.0.0.1",
          port: int = 8976, warmup: bool = True, on_ready=None):
    """Blocking server loop. ``on_ready(httpd)`` is called once the socket
    listens (port 0 picks a free port: read ``httpd.server_address``), so
    a caller running this in a thread can later ``httpd.shutdown()`` it.
    Returns the server object when interrupted or shut down."""
    from http.server import ThreadingHTTPServer

    if warmup:
        engine.warmup()
    httpd = ThreadingHTTPServer((host, port), _make_handler(engine))
    print(f"serving chapters on http://{host}:{httpd.server_address[1]} "
          f"(buckets={engine.buckets})", flush=True)
    if on_ready is not None:
        on_ready(httpd)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return httpd


def _to_host(seqs) -> np.ndarray:
    """On-device sequences as a host array (waits for the device)."""
    if isinstance(seqs, torch.Tensor):
        return seqs.cpu().numpy()
    return np.asarray(seqs)


def load_serving_params(model, ckpt: Optional[str], seed: int = 0):
    """Weights for the server, in place on ``model``; returns ``model``.
    ``ckpt`` is one of:

    - a save directory of ``train/dvc_main``: its ``best`` checkpoint if
      there is one, else ``last`` (as vidchapters_tpu/serve.py:459-465
      restores one); a save directory of the JAX package in its npz form
      (``best.npz`` / ``last.npz``, ``runtime/jax_checkpoint``) the same way;
    - a checkpoint file of that module (a payload with a ``"model"`` key);
    - one npz checkpoint of the JAX package;
    - a ``torch.save``d bare state_dict of the port's Vid2Seq;
    - a reference ``.pth`` (``{"model", "optimizer", "epoch", "args"}`` or a
      bare state_dict under the reference's names), through
      ``models/torch_import`` (vidchapters_tpu/serve.py:447-457);
    - None: seeded random weights (``torch.Generator``).

    Anything else raises, as does a reference name with no place in the
    port's Vid2Seq."""
    if not ckpt:
        model.init_weights(torch.Generator().manual_seed(seed))
        return model
    path = Path(ckpt)
    if path.is_dir():
        name, npz = jax_checkpoint.find(path, ("best", "last"))
        if npz is not None:
            model.load_state_dict(from_jax_params(jax_checkpoint.read_params(npz), model))
            print(f"restored the JAX package's '{name}' from {ckpt}")
        else:
            model.load_state_dict(CheckpointManager(str(path)).load(
                name, map_location="cpu")["model"])
            print(f"restored '{name}' from {ckpt}")
        return model
    if jax_checkpoint.is_jax_npz(path):
        model.load_state_dict(from_jax_params(jax_checkpoint.read_params(path), model))
        print(f"imported JAX checkpoint {ckpt}")
        return model
    payload = torch_import.load_payload(path)
    if torch_import.load_reference_weights(payload, model):
        print(f"imported reference checkpoint {ckpt}")
    elif isinstance(payload, dict) and isinstance(payload.get("model"), dict):
        model.load_state_dict(payload["model"])
        print(f"loaded checkpoint {ckpt}")
    elif isinstance(payload, dict) and payload and all(
            isinstance(v, torch.Tensor) for v in payload.values()):
        model.load_state_dict(payload)
        print(f"loaded state_dict {ckpt}")
    else:
        raise ValueError(
            f"{ckpt} is neither a checkpoint of train/dvc_main, a state_dict of the "
            f"port's Vid2Seq nor a reference Vid2Seq .pth")
    return model


def main(args=None) -> None:
    import argparse

    from vidchapters_tpu_torch.config import load_config
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq

    p = argparse.ArgumentParser(description="Chapter-generation server")
    p.add_argument("--config", required=True, help="ExperimentConfig json")
    p.add_argument("--ckpt", default=None,
                   help="a train/dvc_main save directory (best, else last), "
                        "one of its checkpoint files, a torch.save'd "
                        "state_dict of the port's Vid2Seq, a reference "
                        ".pth, or the JAX package's checkpoint in npz form "
                        "(a directory or one .npz; convert_jax_checkpoint.py "
                        "writes it); omit for seeded random weights")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights when --ckpt is omitted")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, or cpu)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8976)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--no-coalesce", action="store_true",
                   help="serve requests one by one")
    p.add_argument("--no-pipeline", action="store_true",
                   help="copy each call's result to the host before "
                        "assembling the next batch")
    p.add_argument("--max-batch", type=int, default=8,
                   help="largest coalesced batch (snaps to batch buckets)")
    p.add_argument("--max-wait-ms", type=float, default=25.0,
                   help="max extra latency a lone request pays for batching")
    a = p.parse_args(args)

    cfg: ExperimentConfig = load_config(ExperimentConfig, a.config)
    tokenizer = build_tokenizer(cfg.tokenizer_path,
                                num_bins=cfg.model.num_bins)
    model = load_serving_params(Vid2Seq(cfg.model), a.ckpt, a.seed)
    engine = ChapterGenerator(model, tokenizer, cfg.data, cfg.generation,
                              cfg.model.num_bins, device=a.device,
                              coalesce=not a.no_coalesce,
                              max_batch=a.max_batch,
                              max_wait_ms=a.max_wait_ms,
                              pipeline=not a.no_pipeline)
    serve(engine, a.host, a.port, warmup=not a.no_warmup)
    engine.close()


if __name__ == "__main__":
    main()
