"""The yardstick: the card's peaks and the work each batch needs.

Peaks are one NVIDIA H100 SXM's published dense rates at its 700 W limit
(NVIDIA's data sheet): 989 TFLOP/s for bfloat16 products, 67 TFLOP/s for
float32 outside the tensor cores, and 3.35 TB/s of HBM. (Float32
products through three TF32 passes, the fastest route exact to float32,
would take 495/3 TFLOP/s; no cell runs them yet.)

Work is counted from what the inputs need, never from the padded shapes:
a batch row holds ``t`` valid text tokens and ``r`` valid regions, ``n =
t + r`` valid positions of the joint sequence.

* Matmuls: 2 FLOP a multiply-add for every weight a valid position passes
  through: per layer Q, K, V and the output (4 H^2) and the FFN (2 H I);
  the image embedding's projections (2048 H + 7 H a region); the heads on
  the rows or slots they read. Attention adds 4 n H per valid query per
  layer (the scores and P V). The backward counts twice the forward;
  recomputation is not counted.
* K1 (attention forward) over a row: 4 n^2 H FLOP, q, k, v and out read
  or written once (n H elements each) and the key bias (4 n bytes).
  K2: 10 n^2 H FLOP, seven n H tensors.
* The fused tails, per launch over ``rows`` valid positions of width H:
  activations read and written once, the fp32 weight vectors, against
  about 8, 16, 7 and 13 float32 operations an element (K3, K4, K5, K6).
* K7 (IPOT, 50 steps, k = 1) on a valid [N, M] plan: A read once and T
  written once with the [M] and [N] vectors, fp32, against 50 (3 + 4k)
  operations a plan element.

These are frozen copies of the port's own formulas (``chip_smoke.py``
``bound_ms``, ``tail_bound_ms``, ``ipot_bound_ms``), counted on valid
lengths.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12

IMG_DIM = 2048
POS_DIM = 7
TAIL_TERMS = {  # kernel: (activations moved, fp32 vectors, fp32 ops/elem)
    "k3": (3, 2, 8), "k4": (5, 3, 16), "k5": (2, 2, 7), "k6": (3, 3, 13)}


def lengths(batch) -> tuple:
    """(t, r) valid text tokens and regions of each row, from the batch's
    ``attn_mask`` and text bucket."""
    t_b = batch["input_ids"].shape[-1]
    mask = np.asarray(batch["attn_mask"]) > 0
    return mask[:, :t_b].sum(1), mask[:, t_b:].sum(1)


def trunk_flops(t, r, cfg: dict) -> float:
    """Forward FLOP of the embeddings and the encoder on rows of ``t`` text
    tokens and ``r`` regions."""
    h, inter, lay = (cfg["hidden_size"], cfg["intermediate_size"],
                     cfg["num_hidden_layers"])
    n = (np.asarray(t) + np.asarray(r)).astype(np.float64)
    per_layer = n * (8.0 * h * h + 4.0 * h * inter) + 4.0 * n * n * h
    emb = np.asarray(r, np.float64) * 2.0 * (IMG_DIM + POS_DIM) * h
    return float(lay * per_layer.sum() + emb.sum())


def head_flops(task: str, batch, cfg: dict, num_answer: int = 0) -> float:
    """Forward FLOP of a task head on the rows or slots it reads."""
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    rows = float(np.asarray(batch["ex_weight"]).sum()) \
        if "ex_weight" in batch else float(batch["input_ids"].shape[0])
    pool = 2.0 * h * h
    if task == "vqa":
        return rows * (pool + 2.0 * (2 * h * h + 2 * h * num_answer))
    if task == "itm":
        t, r = lengths(batch)
        cost = 2.0 * float((t * r).sum()) * h
        return rows * (pool + 2.0 * 2 * h) + cost
    if task == "mlm":
        slots = float((np.asarray(batch["mlm_tgt"]) != -1).sum())
        return slots * 2.0 * (h * h + h * v)
    slots = float(np.asarray(batch["mrm_valid"]).sum())
    if task == "mrfr":
        return slots * 2.0 * (h * h + h * IMG_DIM)
    if task.startswith("mrc"):
        return slots * 2.0 * (h * h + h * cfg.get("img_label_dim", 1601))
    raise ValueError(f"unknown task {task!r}")


def attention_work(t, r, cfg: dict, elem_bytes: int = 2) -> Dict[str, float]:
    """FLOP and bytes of K1 and K2 over every layer of one batch."""
    h, lay = cfg["hidden_size"], cfg["num_hidden_layers"]
    n = (np.asarray(t) + np.asarray(r)).astype(np.float64)
    nn2 = float((n * n).sum())
    nsum = float(n.sum())
    return {"k1_flop": lay * 4.0 * h * nn2,
            "k1_bytes": lay * (4.0 * nsum * h * elem_bytes + 4.0 * nsum),
            "k2_flop": lay * 10.0 * h * nn2,
            "k2_bytes": lay * (7.0 * nsum * h * elem_bytes + 4.0 * nsum)}


def tail_work(t, r, cfg: dict, elem_bytes: int = 2) -> Dict[str, float]:
    """Bytes and fp32 operations of one training step's fused tails:
    K3/K4 twice a layer on the joint rows, K5/K6 once on the text rows and
    once on the image rows."""
    h, lay = cfg["hidden_size"], cfg["num_hidden_layers"]
    joint = float((np.asarray(t) + np.asarray(r)).sum())
    launches = {"k3": [joint] * (2 * lay), "k4": [joint] * (2 * lay),
                "k5": [float(np.sum(t)), float(np.sum(r))],
                "k6": [float(np.sum(t)), float(np.sum(r))]}
    out = {"tails_bytes": 0.0, "tails_ops": 0.0}
    for k, rows in launches.items():
        acts, vecs, ops = TAIL_TERMS[k]
        for n in rows:
            out["tails_bytes"] += acts * n * h * elem_bytes + vecs * h * 4.0
            out["tails_ops"] += ops * n * h
    return out


def ipot_work(t, r, iteration: int = 50, k: int = 1) -> Dict[str, float]:
    """Bytes and fp32 operations of K7 over the valid [N, M] = [r, t] plans
    of one ITM batch."""
    n = np.asarray(r, np.float64)
    m = np.asarray(t, np.float64)
    return {"ot_bytes": float((4.0 * (2 * n * m + 2 * m + n + 2)).sum()),
            "ot_ops": float((iteration * (3 + 4 * k) * n * m).sum())}


def bound_s(flop: float, nbytes: float, peak: float) -> float:
    """Least time for ``flop`` at ``peak`` against ``nbytes`` over HBM."""
    return max(flop / peak, nbytes / HBM_BYTES_PER_S)


def train_batch_work(task: str, batch, cfg: dict,
                     num_answer: int = 0) -> Dict[str, float]:
    """Everything the per-layer readers count of one training batch."""
    t, r = lengths(batch)
    rows = float(np.asarray(batch["ex_weight"]).sum()) \
        if "ex_weight" in batch else float(len(t))
    slots = float(np.asarray(batch["attn_mask"]).size)
    fwd = trunk_flops(t, r, cfg) + head_flops(task, batch, cfg, num_answer)
    out = {"ex": rows, "valid": float((t + r).sum()), "slots": slots,
           "flop": 3.0 * fwd, **attention_work(t, r, cfg),
           **tail_work(t, r, cfg)}
    if task == "itm":
        out.update(ipot_work(t, r))
    return out


def score_call_work(t, r, cfg: dict, elem_bytes: int = 2) -> Dict[str, float]:
    """What one retrieval scoring call needs: every text (``t`` valid
    tokens each) against every image (``r`` valid regions each). The image
    corpus is embedded once a call (2048 H + 7 H a region); layers
    0..L-2 run on every valid position of every pair, with K1; the last
    layer's K and V on every valid position, its Q, output and FFN on the
    CLS row, its attention 4 n H for that one query; then the pooler and
    the rank head on the CLS row."""
    h, inter, lay = (cfg["hidden_size"], cfg["intermediate_size"],
                     cfg["num_hidden_layers"])
    t = np.asarray(t, np.float64)
    r = np.asarray(r, np.float64)
    n_t, n_r = len(t), len(r)
    pairs = float(n_t * n_r)
    s1 = n_r * t.sum() + n_t * r.sum()  # sum of n over the pairs
    s2 = (n_r * (t * t).sum() + n_t * (r * r).sum()
          + 2.0 * t.sum() * r.sum())  # sum of n^2
    full = (lay - 1) * (s1 * (8.0 * h * h + 4.0 * h * inter) + 4.0 * h * s2)
    last = s1 * 4.0 * h * h + pairs * (4.0 * h * h + 4.0 * h * inter) \
        + 4.0 * h * s1
    heads = pairs * (2.0 * h * h + 2.0 * h)
    emb = r.sum() * 2.0 * (IMG_DIM + POS_DIM) * h
    return {"pairs": pairs, "flop": full + last + heads + emb,
            "k1_flop": (lay - 1) * 4.0 * h * s2,
            "k1_bytes": (lay - 1) * (4.0 * s1 * h * elem_bytes + 4.0 * s1)}
