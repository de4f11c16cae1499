"""Write the JAX package's checkpoints in its flat-npz form, which the PyTorch
port reads (``vidchapters_tpu_torch/runtime/jax_checkpoint.py``).

    python convert_jax_checkpoint.py SRC OUT

``SRC`` is a save directory of ``vidchapters_tpu/runtime/checkpoint.
CheckpointManager`` (``dvc_main``, ``vc_main``, ``pdvc_main``, ...), one
checkpoint directory in it (``.../best``), or an npz checkpoint. For each
of ``best`` and ``last`` found (or the one given), the orbax checkpoint is
restored without a template and its element 0, the params (as the JAX
package's ``restore_params`` takes it), is written to ``OUT/{name}.npz`` as
that package's npz fallback writes a ``(params,)`` tuple: each leaf under
``"/".join(str(k) for k in keypath)``. So ``CheckpointManager(OUT).
restore_params(name, template)`` reads it back, and so does the port:
``serve.py --ckpt OUT``, ``dvc_main --load OUT/best.npz``, PDVC's
``eval_main`` on ``OUT``. An npz checkpoint (the fallback's own, params
first) is copied as it is. ``{name}.meta.json``, ``manager.json`` and
PDVC's ``translator.json`` are copied where present.

Runs where JAX and orbax are installed; the port never imports it.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path
from typing import List

CHECKPOINTS = ("best", "last")
SIDE_FILES = ("manager.json", "translator.json")


def _write_params_npz(ckpt_dir: Path, out: Path) -> None:
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    raw = ocp.StandardCheckpointer().restore(ckpt_dir.absolute())
    params = raw[0] if isinstance(raw, (list, tuple)) else raw
    flat = jax.tree_util.tree_flatten_with_path((params,))[0]
    np.savez(out, **{"/".join(str(k) for k in kp): np.asarray(v) for kp, v in flat})


def convert(src: "str | Path", out: "str | Path") -> List[Path]:
    """Convert ``src`` into ``out`` (see the module's docstring); returns the
    npz files written."""
    src, out = Path(src), Path(out)
    out.mkdir(parents=True, exist_ok=True)
    if src.is_file():
        if src.suffix != ".npz":
            raise ValueError(f"{src} is neither a checkpoint directory nor an npz checkpoint")
        root, found = src.parent, [src.name.removesuffix(".npz")]
    elif any((src / n).exists() or (src / f"{n}.npz").exists() for n in CHECKPOINTS):
        root, found = src, list(CHECKPOINTS)
    else:  # one checkpoint directory of a save directory
        root, found = src.parent, [src.name]
    written = []
    for name in found:
        ckpt, npz = root / name, root / f"{name}.npz"
        if npz.is_file():
            shutil.copy2(npz, out / npz.name)
        elif ckpt.is_dir():
            _write_params_npz(ckpt, out / npz.name)
        else:
            continue
        written.append(out / npz.name)
        meta = root / f"{name}.meta.json"
        if meta.exists():
            shutil.copy2(meta, out / meta.name)
    if not written:
        raise FileNotFoundError(f"{src} holds no {' or '.join(CHECKPOINTS)} checkpoint")
    for side in SIDE_FILES:
        if (root / side).exists():
            shutil.copy2(root / side, out / side)
    return written


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="a CheckpointManager save directory, one checkpoint "
                               "directory in it, or an npz checkpoint")
    p.add_argument("out", help="directory to write {best,last}.npz and their side files to")
    args = p.parse_args(argv)
    if Path(args.out).resolve() == Path(args.src).resolve():
        raise SystemExit("OUT must differ from SRC")
    for path in convert(args.src, args.out):
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
