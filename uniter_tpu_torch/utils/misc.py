"""Config/flag system and small helpers (counterpart of
``uniter_tpu/utils/misc.py``, reference utils/misc.py).

``parse_with_config``: precedence CLI > --config JSON > argparse default
(reference utils/misc.py:26-36).
"""

from __future__ import annotations

import argparse
import json
import random
import sys

import numpy as np
import torch


def parse_with_config(parser: argparse.ArgumentParser,
                      argv=None) -> argparse.Namespace:
    args = parser.parse_args(argv)
    if getattr(args, "config", None):
        with open(args.config) as f:
            config_args = json.load(f)
        cli = sys.argv[1:] if argv is None else argv
        override_keys = {
            arg[2:].split("=")[0] for arg in cli if arg.startswith("--")
        }
        for k, v in config_args.items():
            if k not in override_keys:
                setattr(args, k, v)
    del args.config
    return args


def set_random_seed(seed: int):
    """Python, numpy and torch's global generators (parameter init; the
    dropout masks take their own per-step generators)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
