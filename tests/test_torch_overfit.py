"""The learning proof in the port, on the CPU:

(a) the counterpart of ``tests/test_overfit_e2e.py``: the same tiny
    Vid2Seq, data and 400 steps, in the port's train step; beam 4 then
    reproduces at least 3 of the 4 chapter sequences;
(b) the JAX package trains the same model as that test does; imported by
    ``from_jax_params``, the port's greedy and beam-4 decodes, on the
    standard route and on the decode kernel's route (its plain version on
    the CPU), give the tokens of JAX's ``make_generate_fn``, with rows that
    end at EOS before ``max_length`` and loops that stop early;
(c) ``python -m vidchapters_tpu_torch.train.overfit --smoke --device cpu``
    runs end to end, prints the keys of ``tpu_overfit.py``'s record and
    writes no record;
(d) ``overfit.py``'s data are ``tpu_overfit.py``'s, and its label-smoothing
    floor and SODA_c ceiling are that script's formulas on them.
"""

import ast
import json
import pickle
from pathlib import Path

import numpy as np
import pytest

import torch

ROOT = Path(__file__).resolve().parent.parent
TITLES = ("alpha part", "beta part")
STEPS = 400
MAX_LENGTH = 32


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the port's 400 steps take about 0.21 s each so
    (0.33 s on one, 0.17 on four), and the file does not spin many threads
    against the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(2, n))
    yield
    torch.set_num_threads(n)


def _data(build_time_text_sequence, tokenizer):
    """``test_overfit_e2e.py``'s 4 videos [16, 16] and their 2-chapter
    targets, padded to 48 tokens."""
    rng = np.random.default_rng(0)
    videos, outputs = [], []
    for i in range(4):
        f = rng.normal(size=(16, 16)).astype(np.float32)
        f[:8] *= 3.0 if i % 2 == 0 else 0.3
        videos.append(f)
        seq = build_time_text_sequence([0.0, 50.0], [50.0, 100.0],
                                       [TITLES[i % 2], TITLES[(i + 1) % 2]], 100.0,
                                       tokenizer, 100, 48)
        outputs.append(np.pad(seq, (0, 48 - len(seq))))
    return np.stack(videos), np.stack(outputs).astype(np.int32)


def _configs(m):
    """``test_overfit_e2e.py``'s model config in the package ``m``'s config."""
    t5 = m.T5Config(vocab_size=32200, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                    num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
                    relative_attention_max_distance=32, dtype="float32", dropout_rate=0.0,
                    encoder_dropout=0.0, decoder_dropout=0.0, label_smoothing=0.0)
    vit = m.TemporalViTConfig(num_features=16, embed_dim=16, depth=1, num_heads=2,
                              mlp_dim=32, dtype="float32")
    return m.Vid2SeqConfig(t5=t5, vit=vit)


def _good_chapters(seqs, tokenizer, decode_chapter_sequence) -> int:
    """``test_overfit_e2e.py``'s count of rows decoded to their 2 chapters."""
    good = 0
    for i, text in enumerate(tokenizer.batch_decode(np.asarray(seqs),
                                                    skip_special_tokens=True)):
        events = decode_chapter_sequence(text, 100.0, 100)
        want = TITLES[i % 2].capitalize() + "."
        good += (len(events) == 2 and events[0]["sentence"] == want
                 and abs(events[0]["timestamp"][0]) < 2
                 and abs(events[0]["timestamp"][1] - 50.0) < 2)
    return good


def test_port_memorises_the_chapters():
    """(a): 400 steps of the port's train step at lr 3e-3, then beam 4."""
    from vidchapters_tpu_torch import config as tc
    from vidchapters_tpu_torch.data.time_tokens import (build_time_text_sequence,
                                                        decode_chapter_sequence)
    from vidchapters_tpu_torch.data.tokenizer import ByteLevelTokenizer
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.train.dvc_train import (TrainState, make_generate_fn,
                                                       make_train_step)
    from vidchapters_tpu_torch.train.schedules import build_optimizer

    tok = ByteLevelTokenizer()
    videos, outputs = _data(build_time_text_sequence, tok)
    model = Vid2Seq(_configs(tc)).init_weights(torch.Generator().manual_seed(0))
    opt = build_optimizer(tc.OptimConfig(lr=3e-3, clip_max_norm=1.0,
                                         fraction_warmup_steps=0.0, schedule=""),
                          STEPS, model.parameters())
    state = TrainState(model, opt)
    step = make_train_step(model, denoising=0.0)
    batch = {"video": torch.from_numpy(videos),
             "input_tokens": torch.ones((4, 1), dtype=torch.int64),
             "output_tokens": torch.from_numpy(outputs).long()}
    first = None
    for _ in range(STEPS):
        metrics = step(state, batch, 0)
        first = first if first is not None else float(metrics["total_loss"])
    assert float(metrics["total_loss"]) < 0.5, (first, float(metrics["total_loss"]))

    generate = make_generate_fn(model, tc.GenerationConfig(num_beams=4,
                                                           max_length=MAX_LENGTH))
    seqs = generate(batch["video"], batch["input_tokens"].int())
    assert _good_chapters(seqs.numpy(), tok, decode_chapter_sequence) >= 3, \
        tok.batch_decode(seqs.numpy(), skip_special_tokens=True)


@pytest.fixture(scope="module")
def jax_trained():
    """The JAX package trains the tiny model as ``test_overfit_e2e.py`` does:
    (JAX model, its params as numpy, videos, targets)."""
    import jax
    import jax.numpy as jnp

    from vidchapters_tpu import config as jc
    from vidchapters_tpu.data.time_tokens import build_time_text_sequence
    from vidchapters_tpu.data.tokenizer import ByteLevelTokenizer
    from vidchapters_tpu.models.vid2seq import Vid2Seq
    from vidchapters_tpu.train.dvc_train import TrainState, make_train_step
    from vidchapters_tpu.train.schedules import build_optimizer

    videos, outputs = _data(build_time_text_sequence, ByteLevelTokenizer())
    model = Vid2Seq(_configs(jc))
    key = jax.random.PRNGKey(0)
    v, o = jnp.asarray(videos), jnp.asarray(outputs)
    inp = jnp.ones((4, 1), jnp.int32)
    params = model.init({"params": key, "dropout": key}, v, inp, jnp.ones_like(inp),
                        o)["params"]
    tx = build_optimizer(jc.OptimConfig(lr=3e-3, clip_max_norm=1.0,
                                        fraction_warmup_steps=0.0, schedule=""), STEPS)
    step = jax.jit(make_train_step(model, tx, denoising=0.0))
    state = TrainState(params, tx.init(params), jnp.array(0))
    batch = {"video": v, "input_tokens": inp, "output_tokens": o}
    for _ in range(STEPS):
        state, metrics = step(state, batch, key)
    assert float(metrics["total_loss"]) < 0.5
    return model, jax.device_get(state.params), videos, outputs


@pytest.mark.parametrize("beams, max_length, stops_early",
                         [(1, MAX_LENGTH, True), (4, MAX_LENGTH, False), (4, 128, True)],
                         ids=["greedy", "beam4", "beam4_len128"])
def test_jax_trained_model_decodes_alike(jax_trained, beams, max_length, stops_early,
                                         monkeypatch):
    """(b): the port's tokens equal JAX's on both routes, every row ends at
    EOS before ``max_length``. Greedy stops when every row has ended; beam
    search when 4 hypotheses have ended and no running beam can beat the
    worst of them, which takes more than 32 steps here (84 of 128): at 32
    it runs to ``max_length`` and returns its best finished row."""
    import jax
    import jax.numpy as jnp

    from vidchapters_tpu import config as jc
    from vidchapters_tpu.train.dvc_train import make_generate_fn as jax_generate_fn
    from vidchapters_tpu_torch import config as tc
    from vidchapters_tpu_torch.data.time_tokens import decode_chapter_sequence
    from vidchapters_tpu_torch.data.tokenizer import ByteLevelTokenizer
    from vidchapters_tpu_torch.models import t5 as t5_mod
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.models.weights import from_jax_params
    from vidchapters_tpu_torch.train.dvc_train import make_generate_fn

    jmodel, params, videos, _ = jax_trained
    inp = np.ones((4, 1), np.int32)
    want = np.asarray(jax_generate_fn(jmodel, jc.GenerationConfig(
        num_beams=beams, max_length=max_length))(params, jnp.asarray(videos),
                                                 jnp.asarray(inp), jax.random.PRNGKey(0)))
    eos_at = [int(np.argmax(row == 1)) if (row == 1).any() else max_length for row in want]
    assert max(eos_at) < MAX_LENGTH - 1, want
    assert _good_chapters(want, ByteLevelTokenizer(), decode_chapter_sequence) >= 3

    model = Vid2Seq(_configs(tc))
    model.load_state_dict(from_jax_params(params, model))
    for mega in (False, True):
        monkeypatch.setattr(t5_mod, "USE_MEGA_DECODE", mega)
        generate = make_generate_fn(model, tc.GenerationConfig(num_beams=beams,
                                                               max_length=max_length))
        got = generate(torch.from_numpy(videos), torch.from_numpy(inp)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"mega={mega}")
        if stops_early:
            assert max(eos_at) < generate.decode_steps < max_length, generate.decode_steps
        else:
            assert generate.decode_steps == max_length


def _record_keys() -> set:
    """The keys of the record ``tpu_overfit.py`` prints (its ``out`` dict)."""
    tree = ast.parse((ROOT / "tpu_overfit.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "out" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("tpu_overfit.py has no out = {...}")


def test_overfit_smoke_runs_on_the_cpu(tmp_path, capsys):
    """(c): the plumbing end to end, three epochs of the smoke's tiny model."""
    from vidchapters_tpu_torch.train import overfit

    record = tmp_path / "record.json"
    before = overfit.RECORD.read_bytes() if overfit.RECORD.exists() else None
    out = overfit.main(["--smoke", "--device", "cpu", "--epochs", "3",
                        "--workdir", str(tmp_path / "work"), "--out", str(record)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _record_keys() <= set(printed) and printed["epochs"] == 3
    assert not record.exists()
    assert (overfit.RECORD.read_bytes() if overfit.RECORD.exists() else None) == before
    assert len(printed["serving"]["one_by_one"]) == 8 == len(printed["serving"]["together"])
    assert len(out["serving"]["decode_steps_one_by_one"]) == 8
    for name in ("best", "last", "log.txt"):
        assert (tmp_path / "work" / "ckpt" / name).exists(), name
    assert np.isfinite(printed["generative_loss_last"]) and printed["steps"] == 3


def test_floor_and_ceiling_are_tpu_overfits(tmp_path):
    """(d): the same files as ``tpu_overfit.build_dataset``, and that script's
    floor and SODA_c ceiling (its formulas at ``tpu_overfit.py:188-211``)."""
    from tpu_overfit import build_dataset as jax_build_dataset
    from vidchapters_tpu.config import T5Config
    from vidchapters_tpu.evals.soda import eval_soda
    from vidchapters_tpu_torch.train import overfit

    jann, jasr, jfeats = jax_build_dataset(str(tmp_path / "jax"), 8,
                                           np.random.default_rng(0))
    (tmp_path / "port").mkdir()
    ann, asr, feats = overfit.build_dataset(tmp_path / "port", 8, np.random.default_rng(0))
    assert json.loads(Path(jann).read_text()) == json.loads(ann.read_text())
    with open(jasr, "rb") as f, open(asr, "rb") as g:
        assert pickle.load(f) == pickle.load(g)
    names = sorted(p.name for p in Path(jfeats).iterdir())
    assert names == sorted(p.name for p in feats.iterdir()) and len(names) == 8
    for name in names:
        assert np.array_equal(np.load(Path(jfeats) / name), np.load(feats / name))

    eps, V = T5Config().label_smoothing, T5Config().vocab_size
    p_t, p_o = 1.0 - eps + eps / V, eps / V
    floor = -(p_t * np.log(p_t) + (V - 1) * p_o * np.log(p_o))
    assert overfit.label_smoothing_floor(eps, V) == pytest.approx(floor, rel=1e-12)
    assert round(floor, 4) == 1.363
    a_json = json.loads(Path(jann).read_text())
    quant_sub = {"results": {
        vid: [{"sentence": s,
               "timestamp": [int(99 * t0 / a["duration"]) / 99 * a["duration"],
                             int(99 * t1 / a["duration"]) / 99 * a["duration"]]}
              for s, (t0, t1) in zip(a["sentences"], a["timestamps"])]
        for vid, a in a_json.items()}}
    ceiling = eval_soda(quant_sub, [jann])["soda_c"]
    assert overfit.soda_c_ceiling(ann) == pytest.approx(ceiling, rel=1e-9)
    assert round(ceiling, 4) == 0.5163
