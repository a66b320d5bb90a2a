"""The work a BEiT-3 VQA serving call needs, counted from valid lengths
(the yardstick's rules, ``yardstick.py``, for the Multiway Transformer).

A pair holds ``split`` vision rows (CLS and patches) and ``t`` valid text
tokens (bos and eos included): ``n = split + t`` valid positions.

* Matmuls, 2 FLOP a multiply-add: per layer and valid position Q, K, V and
  the output (4 H^2) and the FFN (2 H I), each through its segment's
  expert; the patch convolution once an image (patches x C p^2 x H); the
  pooler (H^2) and the head (2 H^2 + 2 H A) on each pair's row 0.
  Attention adds 4 n^2 H a pair a layer (the scores and P V), which K1
  does.
* K1 a layer: q, k, v and out read or written once (n H elements each)
  and the key bias (4 bytes a key).
* The fused tails (the multiway K3/K5 and the pooler's K5), bytes: each
  activation read or written once and the fp32 weight vectors (two sets on
  the multiway launches). A layer makes one multiway K5 (LNin: x in, y out)
  and a multiway K3 for its attention tail (x, res in; the sum and y out);
  the FFN tail is the next layer's K3 (the last layer's, the output norm's
  K3 without the sum when ``normalize_output``, else no launch); the
  embedding's LN1 one K5; the pooler's LayerNorm a K5 on one row a pair.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def vqa_call_work(t, n_img: int, cfg: dict, num_answer: int,
                  elem_bytes: int = 2) -> Dict[str, float]:
    """What one call needs: pairs of ``t`` valid text tokens over ``n_img``
    distinct images."""
    h, inter = cfg["encoder_embed_dim"], cfg["encoder_ffn_embed_dim"]
    lay, p, c = cfg["encoder_layers"], cfg["patch_size"], cfg.get(
        "in_chans", 3)
    patches = (cfg["img_size"] // p) ** 2
    split = patches + 1
    t = np.asarray(t, np.float64)
    pairs = float(len(t))
    n = split + t
    s1, s2 = float(n.sum()), float((n * n).sum())
    gemm = lay * s1 * 2.0 * (4.0 * h * h + 2.0 * h * inter)
    attn = lay * 4.0 * h * s2
    conv = n_img * patches * 2.0 * (c * p * p) * h
    head = pairs * 2.0 * (h * h + 2.0 * h * h + 2.0 * h * num_answer)
    k3 = 2 * lay - 1 + (1 if cfg.get("normalize_output", True) else 0)
    k3_acts = 4.0 * (2 * lay - 1) + (
        3.0 if cfg.get("normalize_output", True) else 0.0)
    k5 = lay + 1
    tails_bytes = (s1 * h * elem_bytes * (k3_acts + 2.0 * k5)
                   + (k3 + k5) * 4 * h * 4.0
                   + pairs * h * elem_bytes * 2.0 + 2 * h * 4.0)
    return {"pairs": pairs, "flop": gemm + attn + conv + head,
            "k1_flop": attn,
            "k1_bytes": lay * (4.0 * s1 * h * elem_bytes + 4.0 * s1),
            "tails_bytes": tails_bytes}
