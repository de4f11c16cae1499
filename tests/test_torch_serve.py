"""The port's chapter server on the CPU: coalesced requests come back with
the JAX engine's chapters for the same weights, the batched sequences are
the JAX engine's, and the HTTP surface answers through ``serve``."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests._torch_helpers import jax_params, port_model, small_cfgs


def _asr(i):
    return {"text": [f"step {i} mix the flour", "bake it"], "start": [0.0, 4.0],
            "end": [3.0, 9.0]}


@pytest.fixture(scope="module")
def engines():
    from vidchapters_tpu import config as jc
    from vidchapters_tpu.data.tokenizer import build_tokenizer as jax_tok
    from vidchapters_tpu.serve import ChapterGenerator as JaxEngine
    from vidchapters_tpu_torch import config as tc
    from vidchapters_tpu_torch.data.tokenizer import build_tokenizer
    from vidchapters_tpu_torch.serve import ChapterGenerator

    jcfg, tcfg = small_cfgs()
    jmodel, params = jax_params(jcfg, seed=5)

    def data(m):
        return m.DataConfig(max_feats=16, features_dim=128, max_input_tokens=64,
                            input_buckets=(32, 64))

    def gen(m):
        return m.GenerationConfig(num_beams=4, max_length=16, repetition_penalty=3.0)

    ref = JaxEngine(jmodel, params, jax_tok("", 100), data(jc), gen(jc), 100)
    eng = ChapterGenerator(port_model(tcfg, params), build_tokenizer("", 100),
                           data(tc), gen(tc), 100, device="cpu")
    eng._max_wait = 0.25  # batch reliably even when threads start slowly
    yield ref, eng
    eng.close()
    ref.close()


def test_coalesced_chapters_match_jax_engine(engines):
    ref, eng = engines
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(20 + 5 * i, 128)).astype(np.float32) for i in range(4)]
    ref.coalesce = False
    expected = [ref.generate_chapters(f, 30.0, _asr(i)) for i, f in enumerate(feats)]
    results = [None] * 4
    calls_before = eng.device_calls

    def work(i):
        results[i] = eng.generate_chapters(feats[i], 30.0, _asr(i))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert results == expected
    assert eng.device_calls - calls_before < 4  # requests were batched


def test_batched_sequences_match_jax_engine(engines):
    ref, eng = engines
    rng = np.random.default_rng(1)
    videos = rng.normal(size=(3, 16, 128)).astype(np.float32)
    tokens = np.zeros((3, 32), np.int32)
    for i in range(3):
        ids = eng._input_tokens(_asr(i), 30.0)[:32]
        tokens[i, :len(ids)] = ids
    got = eng._device_generate(videos, tokens)  # pads to batch bucket 4
    np.testing.assert_array_equal(got, ref._device_generate(videos, tokens))
    assert len(np.unique(got)) > 8


def test_http_surface(engines):
    from vidchapters_tpu_torch.serve import serve

    _, eng = engines
    ready = threading.Event()
    box = {}

    def on_ready(httpd):
        box["httpd"] = httpd
        ready.set()

    t = threading.Thread(target=serve, args=(eng, "127.0.0.1", 0, False, on_ready),
                         daemon=True)
    t.start()
    assert ready.wait(timeout=30)
    port = box["httpd"].server_address[1]

    def req(path, payload=None):
        data = json.dumps(payload).encode() if payload is not None else None
        r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
        try:
            with urllib.request.urlopen(r, timeout=120) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        code, body = req("/healthz")
        assert code == 200 and body["buckets"] == [32, 64]
        code, body = req("/v1/chapters", {"features": np.zeros((10, 128)).tolist(),
                                          "duration": 12.0, "asr": _asr(0)})
        assert code == 200 and isinstance(body["chapters"], list)
        code, body = req("/v1/chapters", {"features": [1.0], "duration": 5})
        assert code == 400 and "frames, dim" in body["error"]
        assert req("/v1/nope", {})[0] == 404
    finally:
        box["httpd"].shutdown()
        t.join(timeout=30)
    assert not t.is_alive()


def test_cuda_default_raises_without_a_card():
    import torch

    from vidchapters_tpu_torch import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """One epoch of ``train/dvc_main.main`` at a tiny width into a temporary
    save directory, with the trained model kept in memory."""
    from tests.test_torch_dvc_main import _tiny_cfg, _write_dataset
    from vidchapters_tpu_torch.train import dvc_main

    root = tmp_path_factory.mktemp("dvc_run")
    _write_dataset(root)
    cfg = _tiny_cfg(root, num_beams=2)
    states = []

    class Recorded(dvc_main.TrainState):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            states.append(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(dvc_main, "TrainState", Recorded)
    try:
        dvc_main.main(cfg, device="cpu")
    finally:
        mp.undo()
    assert len(states) == 1
    return cfg, root / "ckpt", states[0].model


def _same_state(model, ref) -> None:
    import torch

    got, want = model.state_dict(), ref.state_dict()
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert torch.equal(got[name], t), name


def _tokens(cfg, model):
    import torch

    from vidchapters_tpu_torch.train.dvc_train import make_generate_fn

    rng = np.random.default_rng(3)
    video = torch.from_numpy(rng.normal(size=(2, cfg.data.max_feats, cfg.data.features_dim))
                             .astype(np.float32))
    tokens = torch.from_numpy(rng.integers(3, 100, size=(2, 12)).astype(np.int64))
    return make_generate_fn(model, cfg.generation)(video, tokens)


def test_serve_ckpt_from_dvc_main_save_directory(trained_run):
    import torch

    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.serve import load_serving_params

    cfg, save_dir, trained = trained_run
    assert (save_dir / "best").exists() and (save_dir / "last").exists()
    served = load_serving_params(Vid2Seq(cfg.model), str(save_dir))
    _same_state(served, trained)
    best = torch.load(save_dir / "best", weights_only=True)["model"]
    for name, t in served.state_dict().items():
        assert torch.equal(t, best[name]), name
    np.testing.assert_array_equal(_tokens(cfg, served).numpy(), _tokens(cfg, trained).numpy())


def test_serve_ckpt_falls_back_to_last(trained_run, tmp_path):
    import shutil

    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.serve import load_serving_params

    cfg, save_dir, trained = trained_run
    only_last, empty = tmp_path / "only_last", tmp_path / "empty"
    only_last.mkdir()
    empty.mkdir()
    shutil.copy(save_dir / "last", only_last / "last")
    _same_state(load_serving_params(Vid2Seq(cfg.model), str(only_last)), trained)
    with pytest.raises(FileNotFoundError, match="neither a 'best' nor a 'last'"):
        load_serving_params(Vid2Seq(cfg.model), str(empty))


@pytest.mark.parametrize("form", ["payload_file", "bare_state_dict"])
def test_serve_ckpt_from_a_file(trained_run, tmp_path, form):
    import torch

    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.serve import load_serving_params

    cfg, save_dir, trained = trained_run
    path = tmp_path / "weights.pt"
    if form == "payload_file":
        path.write_bytes((save_dir / "best").read_bytes())
    else:
        torch.save(trained.state_dict(), path)
    served = load_serving_params(Vid2Seq(cfg.model), str(path))
    _same_state(served, trained)
    np.testing.assert_array_equal(_tokens(cfg, served).numpy(), _tokens(cfg, trained).numpy())


def test_serve_ckpt_refuses_a_foreign_file(tmp_path):
    import torch

    from tests.test_torch_dvc_main import _tiny_cfg
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.serve import load_serving_params

    path = tmp_path / "foreign.pth"
    torch.save({"state": {"encoder.weight": torch.zeros(2)}, "epoch": 3}, path)
    with pytest.raises(ValueError, match="nor a reference Vid2Seq .pth"):
        load_serving_params(Vid2Seq(_tiny_cfg(tmp_path).model), str(path))
