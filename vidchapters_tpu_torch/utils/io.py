"""Small IO helpers (reference: util/basic_utils.py:10-60); the port's own
copy of the readers of ``vidchapters_tpu/utils/io.py`` that the dataset uses."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any


def load_json(path: str | Path) -> Any:
    with open(path, "r") as f:
        return json.load(f)
