"""The port's chapter mining (``factory/chapters``) and annotation
preprocessing (``factory/preproc``) against the JAX package's: identical
outputs on the same descriptions and annotation dicts. And the slice's new
modules import where jax cannot be imported."""

import subprocess
import sys
from pathlib import Path

import pytest

from vidchapters_tpu.factory import chapters as jc
from vidchapters_tpu.factory import preproc as jp
from vidchapters_tpu_torch.factory import chapters as tc
from vidchapters_tpu_torch.factory import preproc as tp

DESCRIPTIONS = {
    "plain": "Intro 0:00\nMixing 1:30 the dough\n3:45 - Baking!\nhttp://x.y/z 4:00 link",
    "hours": "00:00:00 Start\n01:02:03 Middle part\n1:10:00 End",
    "decreasing": "0:00 A\n2:00 B\n1:00 C",
    "one": "0:00 only one",
    "malformed": "123:45 bad\n0:00 ok\n12:345 bad\n00:00:00:00 bad\n5:00 fine",
    "single_chars": "0:00 a\n1:00 b",
    "punct_titles": "0:00 ---\n1:00 [Part 2]\n2:30 ...Part 3...",
    "no_timestamps": "just a description",
    "url_only": "see https://a.b/0:00\n1:00 next",
    "mixed": "Chapters:\n0:00 Intro\nwatch 10:15 Deep dive\n#tags\n59:59 Outro :)",
}

CHAPTER_DATA = {
    "vidA": {"duration": 300.0, "chapters": [{"label": "Intro", "time": 0},
                                             {"label": "Main part", "time": 60},
                                             {"label": "Outro", "time": 250}]},
    "vidB": {"chapters": [{"label": "X", "time": 0}]},  # no duration
    "vidC": {"duration": 100.0, "chapters": [{"label": "All of it", "time": 0},
                                             {"label": "Tail", "time": 95}]},
    "vidD": {"duration": 50.0, "chapters": [{"label": "ok", "time": 0},
                                            {"label": "!!!", "time": 10}]},
    "vidE": {"duration": 80.0, "chapters": [{"label": "a", "time": 0},
                                            {"label": "b", "time": 90}]},
    "vidF": {"duration": 200.0, "chapters": [{"label": "One", "time": 0},
                                             {"label": "Two", "time": 50},
                                             {"label": "Three", "time": 120}]},
}
SPLITS = {"train": {"vidA", "vidC"}, "val": {"vidD", "vidF"}, "test": {"vidE"}}


@pytest.mark.parametrize("name", sorted(DESCRIPTIONS))
def test_description_to_chapters_equal(name):
    desc = DESCRIPTIONS[name]
    assert tc.parse_timestamp_lines(desc) == jc.parse_timestamp_lines(desc)
    for line in desc.split("\n"):
        assert tc.extract_timestamp(line) == jc.extract_timestamp(line)
        assert tc.clean_title(line) == jc.clean_title(line)
    assert tc.description_to_chapters(desc) == jc.description_to_chapters(desc)


def test_mine_chapters_equal():
    out = tc.mine_chapters(DESCRIPTIONS)
    assert out == jc.mine_chapters(DESCRIPTIONS)
    assert sorted(out) == ["hours", "malformed", "mixed", "plain", "punct_titles"]


@pytest.mark.parametrize("splits", [None, SPLITS])
def test_chapters_to_dvc_equal(splits):
    got = tp.chapters_to_dvc(CHAPTER_DATA, splits)
    assert got == jp.chapters_to_dvc(CHAPTER_DATA, splits)
    assert sum(len(v) for v in got.values()) > 0


def test_chapters_to_vmr_equal():
    got = tp.chapters_to_vmr(CHAPTER_DATA, SPLITS)
    assert got == jp.chapters_to_vmr(CHAPTER_DATA, SPLITS)
    assert all(got[s] for s in ("train", "val"))


def test_vitt_and_youcook_equal():
    rows = [{"id": "v1", "annotations": [{"timestamp_ms": 30000, "tag": "cut"},
                                         {"timestamp_ms": 0, "tag": "intro"},
                                         {"timestamp_ms": 90000, "tag": " "}]},
            {"id": "v1", "annotations": [{"timestamp_ms": 0, "tag": "again"}]},
            {"id": "v2", "annotations": [{"timestamp_ms": 5000, "tag": "x"}]},
            {"id": "v3", "annotations": [{"timestamp_ms": 500000, "tag": "late"}]}]
    durations = {"v1": 120.0, "v3": 100.0}
    assert tp.vitt_to_dvc(rows, durations) == jp.vitt_to_dvc(rows, durations)
    yc = {"v2": {"duration": 100.0, "annotations": [{"segment": [0, 10], "sentence": "a"},
                                                    {"segment": [12, 40], "sentence": "b"}]},
          "v4": {"duration": 10.0, "annotations": []}}
    assert tp.youcook_to_dvc(yc) == jp.youcook_to_dvc(yc)


NEW_MODULES = ("models.clip", "factory.features", "factory.align", "factory.chapters",
               "factory.preproc", "demo.demo_vid2seq", "demo.run_on_video")


def test_new_modules_import_with_jax_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vidchapters_tpu'):\n"
            "    sys.modules[name] = None\n"
            + "".join(f"import vidchapters_tpu_torch.{m}\n" for m in NEW_MODULES)
            + "print('ok')\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
