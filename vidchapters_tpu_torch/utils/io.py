"""Small IO helpers (reference: util/basic_utils.py:10-60); the port's own
copy of the helpers of ``vidchapters_tpu/utils/io.py`` that the datasets and
the ASR factory use."""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any


def load_json(path: str | Path) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def load_pickle(path: str | Path) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj: Any, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)
