"""VQA answer vocabulary: the in-tree ``ans2label.json`` (3129 answers,
indexed as the released VQA heads are).

The artifact ships once, with the JAX package
(``uniter_tpu/utils/ans2label.json``); the port reads it by file path and
does not import that package.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "..", "uniter_tpu", "utils",
                            "ans2label.json")


def default_ans2label_path() -> Optional[str]:
    """Path of the in-tree answer vocabulary (None if absent)."""
    path = os.path.normpath(DEFAULT_PATH)
    return path if os.path.exists(path) else None


def load_ans2label(path: Optional[str] = None) -> Dict[str, int]:
    """An answer->label map; ``None`` resolves to the in-tree artifact."""
    path = path or default_ans2label_path()
    if path is None:
        raise FileNotFoundError("no ans2label.json: pass --ans2label")
    with open(path) as f:
        d = json.load(f)
    return {str(k): int(v) for k, v in d.items()}
