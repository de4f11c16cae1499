"""The PyTorch port stands alone: no module of ``vidchapters_tpu_torch`` and
not ``chip_smoke.py`` imports jax, flax, optax, orbax or the JAX package,
and the package imports in a process where jax cannot be imported."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vidchapters_tpu"}
SOURCES = sorted((ROOT / "vidchapters_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vidchapters_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import vidchapters_tpu_torch.serve, vidchapters_tpu_torch.models.weights\n"
        "import vidchapters_tpu_torch.ops.decoding, vidchapters_tpu_torch.runtime.rng\n"
        "import vidchapters_tpu_torch.train.dvc_train, vidchapters_tpu_torch.train.schedules\n"
        "import vidchapters_tpu_torch.data.dvc_dataset, vidchapters_tpu_torch.utils.io\n"
        "import vidchapters_tpu_torch.train.dvc_main, vidchapters_tpu_torch.ops.decode_attention\n"
        "import vidchapters_tpu_torch.runtime.checkpoint, vidchapters_tpu_torch.evals\n"
        "import vidchapters_tpu_torch.train.pdvc_main, vidchapters_tpu_torch.train.pdvc_train\n"
        "import vidchapters_tpu_torch.models.pdvc, vidchapters_tpu_torch.models.pdvc_loss\n"
        "import vidchapters_tpu_torch.ops.deformable_attention, vidchapters_tpu_torch.ops.matching\n"
        "import vidchapters_tpu_torch.ops.span_ops, vidchapters_tpu_torch.data.pdvc_dataset\n"
        "import vidchapters_tpu_torch.factory.audio, vidchapters_tpu_torch.factory.vad\n"
        "import vidchapters_tpu_torch.factory.asr, vidchapters_tpu_torch.factory.whisper_transcribe\n"
        "import vidchapters_tpu_torch.models.whisper, vidchapters_tpu_torch.ops.whisper_megakernel\n"
        "import vidchapters_tpu_torch.ops.probes, vidchapters_tpu_torch.models.torch_import\n"
        "import vidchapters_tpu_torch.data.native_spm, vidchapters_tpu_torch.data.native_loader\n"
        "import vidchapters_tpu_torch.data.features, vidchapters_tpu_torch.data.tokenizer\n"
        "import vidchapters_tpu_torch.data.vc_dataset, vidchapters_tpu_torch.train.vc_train\n"
        "import vidchapters_tpu_torch.train.vc_main, vidchapters_tpu_torch.evals.captioning\n"
        "import vidchapters_tpu_torch.evals.para, vidchapters_tpu_torch.evals.moment\n"
        "import vidchapters_tpu_torch.train.postprocessing, vidchapters_tpu_torch.data.clip_tokenizer\n"
        "import vidchapters_tpu_torch.data.grounding_dataset, vidchapters_tpu_torch.models.clip\n"
        "import vidchapters_tpu_torch.models.bert, vidchapters_tpu_torch.models.grounding\n"
        "import vidchapters_tpu_torch.train.grounding_train, vidchapters_tpu_torch.train.grounding_main\n"
        "import vidchapters_tpu_torch.zeroshot.run, vidchapters_tpu_torch.models.blip2\n"
        "import vidchapters_tpu_torch.models.llama, vidchapters_tpu_torch.zeroshot.visual_vcg\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'vidchapters_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
