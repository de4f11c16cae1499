"""The JAX package's checkpoints in the port, on the CPU:

- the JAX package saves a small Vid2Seq's ``(params, opt_state, step)``
  with orbax (``best`` and ``last``); ``convert_jax_checkpoint.py`` writes
  their npz form, which the JAX package's own ``restore_params`` reads back
  bit for bit;
- ``serve.load_serving_params`` on that directory (``best`` first) and on
  one npz gives ``from_jax_params``'s state dict bit for bit, and the
  logits of JAX's model within ``tests/test_torch_model.py``'s TOL;
- ``dvc_main --load`` takes the npz (params only): the same weights, and
  the same final eval as the port's own checkpoint of them;
- the JAX package's npz fallback (written with its ``_HAS_ORBAX`` False) is
  read directly;
- PDVC's ``eval_main`` loads a JAX-saved PDVC checkpoint to
  ``pdvc_from_jax_params``'s state dict;
- every parameter layout the JAX package saves (``scan_layers`` True,
  "encoder" or "decoder", the ViT's ``scan_layers``, ``fused_qkv``, and
  scan with ``fused_qkv``), saved with orbax and converted, and as the npz
  fallback, loads through ``serve`` and ``dvc_main --load`` to the state
  dict of the JAX package's own migration (``utils/migrate_ckpt``) bit for
  bit, with logits within TOL of the JAX model in its own layout;
- an unparseable key, a leaf with no place in the model, a packed kernel
  of the wrong form, both forms of a name in one directory and an
  unconverted orbax directory raise.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_helpers import jax_params, small_cfgs
from tests.test_torch_model import TOL


def _jax_state(jcfg, params):
    """JAX's train state tuple ``(params, opt_state, step)`` as dvc_main saves it."""
    from vidchapters_tpu import config as jc
    from vidchapters_tpu.train.schedules import build_optimizer

    tx = build_optimizer(jc.OptimConfig(), 10)
    return (params, tx.init(params), jnp.asarray(3, jnp.int32))


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_trees_equal(got[k], v, f"{path}/{k}")
        else:
            g = np.asarray(got[k])
            assert g.dtype == np.asarray(v).dtype and np.array_equal(g, np.asarray(v)), \
                f"{path}/{k}"


def _assert_state_dicts_equal(got, want):
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A JAX save directory with orbax ``best`` and ``last`` of different
    params, and its conversion."""
    from convert_jax_checkpoint import convert
    from vidchapters_tpu.runtime.checkpoint import CheckpointManager

    tmp = tmp_path_factory.mktemp("jaxckpt")
    jcfg, tcfg = small_cfgs()
    jmodel, params = jax_params(jcfg)
    _, other = jax_params(jcfg, seed=1)
    mgr = CheckpointManager(str(tmp / "jax"))
    mgr.save_last(_jax_state(jcfg, other), 0)
    assert mgr.maybe_save_best(_jax_state(jcfg, params), 0, {"CIDEr": 1.5})
    assert (tmp / "jax" / "best").is_dir() and not (tmp / "jax" / "best.npz").exists()
    written = convert(tmp / "jax", tmp / "out")
    return {"dir": tmp / "out", "written": written, "jax": (jcfg, jmodel, params, other),
            "tcfg": tcfg, "tmp": tmp}


def test_converter_output_reads_back_in_jax_bit_for_bit(converted):
    from vidchapters_tpu.runtime.checkpoint import CheckpointManager

    out = converted["dir"]
    _, _, params, other = converted["jax"]
    assert sorted(p.name for p in converted["written"]) == ["best.npz", "last.npz"]
    for name in ("best.meta.json", "last.meta.json", "manager.json"):
        assert (out / name).exists(), name
    assert json.loads((out / "best.meta.json").read_text())["CIDEr"] == 1.5
    mgr = CheckpointManager(str(out))
    for name, want in (("best", params), ("last", other)):
        got = jax.device_get(mgr.restore_params(name, params))
        _assert_trees_equal(got, want)
    with np.load(out / "best.npz") as data:  # params only, keyed as (params,)
        assert all(k.startswith("[0]/['") for k in data.files)


def test_serve_loads_the_converted_directory_and_one_npz(converted):
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.models.weights import from_jax_params
    from vidchapters_tpu_torch.serve import load_serving_params

    _, jmodel, params, other = converted["jax"]
    model = load_serving_params(Vid2Seq(converted["tcfg"]), str(converted["dir"]))
    _assert_state_dicts_equal(model.state_dict(), from_jax_params(params, model))  # best
    last = load_serving_params(Vid2Seq(converted["tcfg"]), str(converted["dir"] / "last.npz"))
    _assert_state_dicts_equal(last.state_dict(), from_jax_params(other, last))

    rng = np.random.default_rng(0)
    tokens = rng.integers(3, 32200, size=(2, 20)).astype(np.int32)
    tokens[0, 15:] = 0
    dec = rng.integers(3, 32200, size=(2, 12)).astype(np.int32)
    args = [tokens, (tokens != 0).astype(np.int32), dec, np.ones_like(dec)]
    ref = jmodel.apply({"params": params}, *map(jnp.asarray, args),
                       method=lambda m, *a: m.t5(*a))
    with torch.no_grad():
        got = model.eval().t5(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_jax_npz_fallback_is_read_directly(tmp_path, monkeypatch):
    """The JAX package without orbax writes ``last.npz`` of the whole train
    state; the port takes its params (the moments and step are left)."""
    from vidchapters_tpu.runtime import checkpoint
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.models.weights import from_jax_params
    from vidchapters_tpu_torch.runtime import jax_checkpoint
    from vidchapters_tpu_torch.serve import load_serving_params

    monkeypatch.setattr(checkpoint, "_HAS_ORBAX", False)
    jcfg, tcfg = small_cfgs()
    _, params = jax_params(jcfg)
    checkpoint.CheckpointManager(str(tmp_path)).save_last(_jax_state(jcfg, params), 0)
    with np.load(tmp_path / "last.npz") as data:
        assert any(k.startswith("[1]/") for k in data.files) and "[2]" in data.files
    _assert_trees_equal(jax_checkpoint.read_params(tmp_path / "last.npz"), params)
    model = load_serving_params(Vid2Seq(tcfg), str(tmp_path))
    _assert_state_dicts_equal(model.state_dict(), from_jax_params(params, model))
    # the converter copies an npz checkpoint as it is
    from convert_jax_checkpoint import convert

    (copy,) = convert(tmp_path / "last.npz", tmp_path / "copy")
    assert copy.read_bytes() == (tmp_path / "last.npz").read_bytes()
    assert (tmp_path / "copy" / "last.meta.json").exists()


def test_dvc_main_load_takes_the_jax_npz(tmp_path, capsys, monkeypatch):
    """``--load`` of a JAX npz: the params loaded bit for bit, and ``--eval``
    on them scores as on the port's own checkpoint of the same weights."""
    from tests.test_torch_dvc_main import _tiny_cfg, _write_dataset
    from vidchapters_tpu import config as jc
    from vidchapters_tpu.runtime import checkpoint
    from vidchapters_tpu_torch.config import save_config
    from vidchapters_tpu_torch.models import t5
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.models.weights import from_jax_params
    from vidchapters_tpu_torch.train import dvc_main

    monkeypatch.setattr(t5, "USE_MEGA_DECODE", False)
    _write_dataset(tmp_path)
    cfg = _tiny_cfg(tmp_path, num_beams=1)
    save_config(cfg, str(tmp_path / "exp.json"))
    jcfg = jc.load_config(jc.ExperimentConfig, str(tmp_path / "exp.json"))
    _, params = jax_params(jcfg.model, seed=2)
    monkeypatch.setattr(checkpoint, "_HAS_ORBAX", False)
    checkpoint.CheckpointManager(str(tmp_path / "jax")).save_last(
        _jax_state(jcfg.model, params), 0)
    (tmp_path / "jax" / "last.npz").rename(tmp_path / "jax" / "best.npz")

    model = Vid2Seq(cfg.model)
    want = from_jax_params(params, model)
    dvc_main._load_weights(model, str(tmp_path / "jax" / "best.npz"))
    _assert_state_dicts_equal(model.state_dict(), want)
    own = tmp_path / "own.pt"
    torch.save({"model": want, "optimizer": {}, "step": 0, "epoch": 0}, own)
    scores = {}
    for name, load in (("jax", tmp_path / "jax" / "best.npz"), ("own", own)):
        scores[name] = dvc_main.main(cfg, load=str(load), eval_only=True, device="cpu")
    assert "imported the params of JAX checkpoint" in capsys.readouterr().out
    assert scores["jax"] == scores["own"] and np.isfinite(scores["jax"]["chapters_CIDEr"])


def test_pdvc_eval_main_loads_a_jax_checkpoint(tmp_path, monkeypatch):
    """A JAX PDVC save directory (orbax ``best`` / ``last`` of ``(params,)``,
    the JAX ``translator.json``), converted: ``eval_main`` evaluates the
    ``best`` params, ``pdvc_from_jax_params``'s state dict bit for bit."""
    from convert_jax_checkpoint import convert
    from tests.test_torch_pdvc_main import CFG, _write_dataset
    from vidchapters_tpu.config import PDVCConfig as JConfig
    from vidchapters_tpu.data.pdvc_dataset import Translator as JTranslator
    from vidchapters_tpu.models.pdvc import PDVC as JPDVC
    from vidchapters_tpu.runtime.checkpoint import CheckpointManager
    from vidchapters_tpu_torch.config import PDVCConfig
    from vidchapters_tpu_torch.models.weights import pdvc_from_jax_params
    from vidchapters_tpu_torch.train import pdvc_main

    root = _write_dataset(tmp_path)
    jmodel = JPDVC(JConfig(**CFG))
    vf = jnp.zeros((1, CFG["frame_embedding_num"], CFG["feature_dim"]), jnp.float32)
    init = jax.jit(lambda k: jmodel.init({"params": k}, vf, jnp.ones(vf.shape[:2], jnp.int32),
                                         method=jmodel.init_all)["params"])
    best, last = (jax.device_get(init(jax.random.PRNGKey(s))) for s in (0, 1))
    mgr = CheckpointManager(str(tmp_path / "jax"), best_metric="soda_c")
    mgr.save_last((last,), 0)
    mgr.maybe_save_best((best,), 0, {"soda_c": 0.2})
    sents = [s for a in json.loads((root / "train.json").read_text()).values()
             for s in a["sentences"]]
    JTranslator.build(sents).to_json(tmp_path / "jax" / "translator.json")
    convert(tmp_path / "jax", tmp_path / "out")
    assert (tmp_path / "out" / "translator.json").exists()

    seen = []
    real = pdvc_main.make_pdvc_infer

    def capture(model, cfg):
        seen.append({k: v.clone() for k, v in model.state_dict().items()})
        return real(model, cfg)

    monkeypatch.setattr(pdvc_main, "make_pdvc_infer", capture)
    cfg = PDVCConfig(**CFG)
    scored = pdvc_main.eval_main(str(tmp_path / "out"), str(root / "val.json"),
                                 str(root / "f"), cfg, save_dir=str(tmp_path / "eval"),
                                 device="cpu")
    assert "soda_c" in scored
    from vidchapters_tpu_torch.models.pdvc import PDVC

    _assert_state_dicts_equal(seen[0], pdvc_from_jax_params(best, PDVC(cfg)))


def test_unparseable_key_raises_naming_it(tmp_path):
    from vidchapters_tpu_torch.runtime.jax_checkpoint import parse_key, read_params

    assert parse_key("[0]/['t5']/.mu/[3]/[\"a/b\"]") == (0, "t5", ("attr", "mu"), 3, "a/b")
    for bad in ("[0]/t5/['x']", "[0]//['x']", "[<flat index 0>]", "[0]['x']"):
        np.savez(tmp_path / "bad.npz", **{bad: np.zeros(2)})
        with pytest.raises(ValueError, match="cannot parse JAX checkpoint key"):
            read_params(tmp_path / "bad.npz")
    np.savez(tmp_path / "opt.npz", **{"[1]/[0]/.mu/['w']": np.zeros(2)})
    with pytest.raises(ValueError, match="no \\[0\\] \\(params\\) subtree"):
        read_params(tmp_path / "opt.npz")
    np.savez(tmp_path / "attr.npz", **{"[0]/.w": np.zeros(2)})
    with pytest.raises(ValueError, match="not a params leaf"):
        read_params(tmp_path / "attr.npz")


LAYOUTS = {  # (T5Config.scan_layers, T5Config.fused_qkv, TemporalViTConfig.scan_layers)
    "scan_both": (True, False, False),
    "scan_encoder": ("encoder", False, False),
    "scan_decoder": ("decoder", False, False),
    "scan_vit": (False, False, True),
    "fused_qkv": (False, True, False),
    "scan_fused": (True, True, False),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_every_saved_layout_imports(layout, tmp_path, monkeypatch):
    """A JAX Vid2Seq initialised in ``layout`` and saved by
    ``CheckpointManager`` (orbax, then ``convert_jax_checkpoint.py``; and the
    npz fallback): ``serve.load_serving_params`` and ``dvc_main --load`` give
    ``from_jax_params`` of JAX's own ``migrate_params(..., "unrolled",
    fuse="unfuse")`` bit for bit, and the logits of the JAX model in
    ``layout`` within TOL."""
    from convert_jax_checkpoint import convert
    from vidchapters_tpu.runtime import checkpoint
    from vidchapters_tpu.utils.migrate_ckpt import migrate_params
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.models.weights import from_jax_params
    from vidchapters_tpu_torch.serve import load_serving_params
    from vidchapters_tpu_torch.train import dvc_main

    scan, fused, vit_scan = LAYOUTS[layout]
    jcfg, tcfg = small_cfgs()
    jcfg = dataclasses.replace(
        jcfg, t5=dataclasses.replace(jcfg.t5, scan_layers=scan, fused_qkv=fused),
        vit=dataclasses.replace(jcfg.vit, scan_layers=vit_scan))
    jmodel, params = jax_params(jcfg, seed=3)
    stacks = [p for p, s in (("t5/encoder", scan in (True, "encoder")),
                             ("t5/decoder", scan in (True, "decoder")),
                             ("visual_encoder", vit_scan)) if s]
    for path in stacks:  # the layout is the one asked for
        node = params
        for k in path.split("/"):
            node = node[k]
        assert "blocks" in node and "block_0" not in node, path
    assert ("qkv" in params["t5"]["decoder"]["blocks" if scan in (True, "decoder")
                                             else "block_0"]["self_attn"]) == fused
    want = from_jax_params(migrate_params(params, "unrolled", fuse="unfuse"),
                           Vid2Seq(tcfg))

    checkpoint.CheckpointManager(str(tmp_path / "orbax")).save_last(
        _jax_state(jcfg, params), 0)
    convert(tmp_path / "orbax", tmp_path / "converted")
    monkeypatch.setattr(checkpoint, "_HAS_ORBAX", False)
    checkpoint.CheckpointManager(str(tmp_path / "fallback")).save_last(
        _jax_state(jcfg, params), 0)
    for save in ("converted", "fallback"):
        npz = tmp_path / save / "last.npz"
        served = load_serving_params(Vid2Seq(tcfg), str(tmp_path / save))
        _assert_state_dicts_equal(served.state_dict(), want)
        loaded = Vid2Seq(tcfg)
        dvc_main._load_weights(loaded, str(npz))
        _assert_state_dicts_equal(loaded.state_dict(), want)

    rng = np.random.default_rng(0)
    video = rng.normal(size=(2, jcfg.vit.num_features, jcfg.vit.embed_dim)).astype(np.float32)
    tokens = rng.integers(3, 32200, size=(2, 20)).astype(np.int32)
    tokens[0, 15:] = 0
    dec = rng.integers(3, 32200, size=(2, 12)).astype(np.int32)
    args = [video, tokens, (tokens != 0).astype(np.int32), dec]
    ref = jmodel.apply({"params": params}, *map(jnp.asarray, args),
                       method=lambda m, v, t, a, d: m.t5.decode(d, jnp.ones_like(d),
                                                                *m.encode(v, t, a)))
    with torch.no_grad():
        d = torch.from_numpy(dec)
        got = served.eval().t5.decode(d, torch.ones_like(d),
                                      *served.encode(*map(torch.from_numpy, args[:3])))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_a_packed_kernel_of_the_wrong_form_raises():
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.models.weights import from_jax_params, unfuse_attention

    jcfg, tcfg = small_cfgs()
    jcfg = dataclasses.replace(jcfg, t5=dataclasses.replace(jcfg.t5, fused_qkv=True))
    _, params = jax_params(jcfg)
    attn = params["t5"]["encoder"]["block_0"]["self_attn"]
    with pytest.raises(ValueError, match="does not hold 3 projections"):
        unfuse_attention({"qkv": {"kernel": attn["qkv"]["kernel"][..., :2, :]}})
    with pytest.raises(ValueError, match="expected one kernel"):
        unfuse_attention({"kv": {"kernel": np.zeros((128, 256), np.float32)}})
    params["t5"]["encoder"]["block_0"]["self_attn"]["qkv"]["kernel"] = \
        attn["qkv"]["kernel"][:, :2]  # 2 of 4 heads: no port parameter fits it
    with pytest.raises(ValueError, match="does not fit"):
        from_jax_params(params, Vid2Seq(tcfg))


def test_a_leaf_with_no_place_raises(converted, tmp_path):
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.serve import load_serving_params

    with np.load(converted["dir"] / "best.npz") as data:
        arrays = dict(data)
    arrays["[0]/['t5']/['bogus']/['kernel']"] = np.zeros((2, 2), np.float32)
    np.savez(tmp_path / "best.npz", **arrays)
    with pytest.raises(ValueError, match="t5/bogus/kernel"):
        load_serving_params(Vid2Seq(converted["tcfg"]), str(tmp_path))


def test_both_forms_in_one_directory_raise(converted, tmp_path):
    """``best`` of the port beside ``best.npz`` of the JAX package: serve and
    PDVC's ``eval_main`` refuse to choose; an orbax ``best`` directory
    alone asks for the converter."""
    import shutil

    from vidchapters_tpu_torch.config import PDVCConfig
    from vidchapters_tpu_torch.models.vid2seq import Vid2Seq
    from vidchapters_tpu_torch.serve import load_serving_params
    from vidchapters_tpu_torch.train.pdvc_main import eval_main

    shutil.copy(converted["dir"] / "best.npz", tmp_path / "best.npz")
    torch.save({"model": {}}, tmp_path / "best")
    (tmp_path / "translator.json").write_text(json.dumps({"ix_to_word": {}}))
    with pytest.raises(ValueError, match="holds 'best' twice"):
        load_serving_params(Vid2Seq(converted["tcfg"]), str(tmp_path))
    with pytest.raises(ValueError, match="holds 'best' twice"):
        eval_main(str(tmp_path), "unused.json", "unused", PDVCConfig(), device="cpu")
    with pytest.raises(ValueError, match="convert_jax_checkpoint.py"):
        load_serving_params(Vid2Seq(converted["tcfg"]), str(converted["tmp"] / "jax"))
