"""The weight bridge: JAX parameter trees and reference ``.pt`` state dicts
-> this package's state dicts.

Counterpart of ``uniter_tpu/models/checkpoint.py``. The key tables
(``_STATIC_MAP``, ``_LAYER_MAP``, ``_PRETRAIN_HEAD_MAP``, ``_TASK_HEAD_MAP``)
are that module's, re-stated here because the port imports nothing of the
JAX package. ``state_dict_from_jax_params`` is its ``export_state_dict`` in
numpy for the trunk, the pretraining heads and the fine-tune heads: flax ``Dense`` kernels [in, out] become
``nn.Linear`` weights [out, in], and the scanned ``[L, ...]`` layer stacks
under ``encoder/layer/bert_layer`` become ``encoder.layer.{i}.*``. Module
names in ``models/`` follow those keys, so the result loads with
``strict=True``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

# flax path (relative to the UniterModel root) -> (torch key, kind)
# kind: "linear_w" transpose, "raw" as-is.
_STATIC_MAP = {
    "embeddings/word_embeddings/embedding": ("embeddings.word_embeddings.weight", "raw"),
    "embeddings/position_embeddings/embedding": ("embeddings.position_embeddings.weight", "raw"),
    "embeddings/token_type_embeddings/embedding": ("embeddings.token_type_embeddings.weight", "raw"),
    "embeddings/LayerNorm/weight": ("embeddings.LayerNorm.weight", "raw"),
    "embeddings/LayerNorm/bias": ("embeddings.LayerNorm.bias", "raw"),
    "img_embeddings/img_linear/kernel": ("img_embeddings.img_linear.weight", "linear_w"),
    "img_embeddings/img_linear/bias": ("img_embeddings.img_linear.bias", "raw"),
    "img_embeddings/img_layer_norm/weight": ("img_embeddings.img_layer_norm.weight", "raw"),
    "img_embeddings/img_layer_norm/bias": ("img_embeddings.img_layer_norm.bias", "raw"),
    "img_embeddings/pos_linear/kernel": ("img_embeddings.pos_linear.weight", "linear_w"),
    "img_embeddings/pos_linear/bias": ("img_embeddings.pos_linear.bias", "raw"),
    "img_embeddings/pos_layer_norm/weight": ("img_embeddings.pos_layer_norm.weight", "raw"),
    "img_embeddings/pos_layer_norm/bias": ("img_embeddings.pos_layer_norm.bias", "raw"),
    "img_embeddings/mask_embedding": ("img_embeddings.mask_embedding.weight", "raw"),
    "img_embeddings/LayerNorm/weight": ("img_embeddings.LayerNorm.weight", "raw"),
    "img_embeddings/LayerNorm/bias": ("img_embeddings.LayerNorm.bias", "raw"),
    "pooler/dense/kernel": ("pooler.dense.weight", "linear_w"),
    "pooler/dense/bias": ("pooler.dense.bias", "raw"),
}

# Per-layer tensors, stacked along axis 0 over layers in the JAX tree.
# flax subpath under encoder/layer/bert_layer -> (torch subkey, kind)
_LAYER_MAP = {
    "attention/query/kernel": ("attention.self.query.weight", "linear_w"),
    "attention/query/bias": ("attention.self.query.bias", "raw"),
    "attention/key/kernel": ("attention.self.key.weight", "linear_w"),
    "attention/key/bias": ("attention.self.key.bias", "raw"),
    "attention/value/kernel": ("attention.self.value.weight", "linear_w"),
    "attention/value/bias": ("attention.self.value.bias", "raw"),
    "attention/output_dense/kernel": ("attention.output.dense.weight", "linear_w"),
    "attention/output_dense/bias": ("attention.output.dense.bias", "raw"),
    "attention/output_LayerNorm/weight": ("attention.output.LayerNorm.weight", "raw"),
    "attention/output_LayerNorm/bias": ("attention.output.LayerNorm.bias", "raw"),
    "intermediate_dense/kernel": ("intermediate.dense.weight", "linear_w"),
    "intermediate_dense/bias": ("intermediate.dense.bias", "raw"),
    "output_dense/kernel": ("output.dense.weight", "linear_w"),
    "output_dense/bias": ("output.dense.bias", "raw"),
    "output_LayerNorm/weight": ("output.LayerNorm.weight", "raw"),
    "output_LayerNorm/bias": ("output.LayerNorm.bias", "raw"),
}

# Pretraining-head flax paths (at the params root) -> reference keys
# (reference model/pretrain.py:50-63 module names).
_PRETRAIN_HEAD_MAP = {
    "cls/transform/dense/kernel": ("cls.predictions.transform.dense.weight", "linear_w"),
    "cls/transform/dense/bias": ("cls.predictions.transform.dense.bias", "raw"),
    "cls/transform/LayerNorm/weight": ("cls.predictions.transform.LayerNorm.weight", "raw"),
    "cls/transform/LayerNorm/bias": ("cls.predictions.transform.LayerNorm.bias", "raw"),
    "cls/bias": ("cls.predictions.bias", "raw"),
    "feat_regress/net_dense/kernel": ("feat_regress.net.0.weight", "linear_w"),
    "feat_regress/net_dense/bias": ("feat_regress.net.0.bias", "raw"),
    "feat_regress/net_ln/weight": ("feat_regress.net.2.weight", "raw"),
    "feat_regress/net_ln/bias": ("feat_regress.net.2.bias", "raw"),
    "feat_regress/bias": ("feat_regress.bias", "raw"),
    "region_classifier/net_dense/kernel": ("region_classifier.net.0.weight", "linear_w"),
    "region_classifier/net_dense/bias": ("region_classifier.net.0.bias", "raw"),
    "region_classifier/net_ln/weight": ("region_classifier.net.2.weight", "raw"),
    "region_classifier/net_ln/bias": ("region_classifier.net.2.bias", "raw"),
    "region_classifier/net_out/kernel": ("region_classifier.net.3.weight", "linear_w"),
    "region_classifier/net_out/bias": ("region_classifier.net.3.bias", "raw"),
    "itm_output/kernel": ("itm_output.weight", "linear_w"),
    "itm_output/bias": ("itm_output.bias", "raw"),
}

# Fine-tune task-head flax paths (at the params root) -> reference keys;
# (flax_path, torch_key, kind). RE lists two torch layouts per flax path
# (a Linear at mlp=1, a Sequential at mlp=2, reference model/re.py:30-35).
_TASK_HEAD_MAP = (
    # VQA / VE: Sequential(Linear, GELU, LayerNorm, Linear) (model/vqa.py:23-28)
    ("vqa_hidden/kernel", "vqa_output.0.weight", "linear_w"),
    ("vqa_hidden/bias", "vqa_output.0.bias", "raw"),
    ("vqa_ln/weight", "vqa_output.2.weight", "raw"),
    ("vqa_ln/bias", "vqa_output.2.bias", "raw"),
    ("vqa_out/kernel", "vqa_output.3.weight", "linear_w"),
    ("vqa_out/bias", "vqa_output.3.bias", "raw"),
    # VCR: Sequential(Linear, ReLU, LayerNorm, Linear) (model/vcr.py:24-29)
    ("vcr_hidden/kernel", "vcr_output.0.weight", "linear_w"),
    ("vcr_hidden/bias", "vcr_output.0.bias", "raw"),
    ("vcr_ln/weight", "vcr_output.2.weight", "raw"),
    ("vcr_ln/bias", "vcr_output.2.bias", "raw"),
    ("vcr_out/kernel", "vcr_output.3.weight", "linear_w"),
    ("vcr_out/bias", "vcr_output.3.bias", "raw"),
    # NLVR2 heads (model/nlvr2.py:51,142-147)
    ("nlvr2_output/kernel", "nlvr2_output.weight", "linear_w"),
    ("nlvr2_output/bias", "nlvr2_output.bias", "raw"),
    ("attn1/in_proj_weight", "attn1.in_proj_weight", "raw"),
    ("attn1/in_proj_bias", "attn1.in_proj_bias", "raw"),
    ("attn1/out_proj/kernel", "attn1.out_proj.weight", "linear_w"),
    ("attn1/out_proj/bias", "attn1.out_proj.bias", "raw"),
    ("attn2/in_proj_weight", "attn2.in_proj_weight", "raw"),
    ("attn2/in_proj_bias", "attn2.in_proj_bias", "raw"),
    ("attn2/out_proj/kernel", "attn2.out_proj.weight", "linear_w"),
    ("attn2/out_proj/bias", "attn2.out_proj.bias", "raw"),
    ("fc_dense/kernel", "fc.0.weight", "linear_w"),
    ("fc_dense/bias", "fc.0.bias", "raw"),
    ("attn_pool/fc/kernel", "attn_pool.fc.0.weight", "linear_w"),
    ("attn_pool/fc/bias", "attn_pool.fc.0.bias", "raw"),
    # ITM / retrieval (model/itm.py:20-22)
    ("itm_output/kernel", "itm_output.weight", "linear_w"),
    ("itm_output/bias", "itm_output.bias", "raw"),
    ("rank_output/kernel", "rank_output.weight", "linear_w"),
    ("rank_output/bias", "rank_output.bias", "raw"),
    # RE (model/re.py:27-35): mlp=2 Sequential first, then mlp=1 Linear
    ("re_hidden/kernel", "re_output.0.weight", "linear_w"),
    ("re_hidden/bias", "re_output.0.bias", "raw"),
    ("re_ln/weight", "re_output.2.weight", "raw"),
    ("re_ln/bias", "re_output.2.bias", "raw"),
    ("re_output/kernel", "re_output.3.weight", "linear_w"),
    ("re_output/bias", "re_output.3.bias", "raw"),
    ("re_output/kernel", "re_output.weight", "linear_w"),
    ("re_output/bias", "re_output.bias", "raw"),
)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _convert(arr, kind: str) -> np.ndarray:
    arr = np.asarray(arr)
    return np.ascontiguousarray(arr.T) if kind == "linear_w" else arr


def state_dict_from_jax_params(params: Mapping[str, Any], *,
                               trunk: str = "uniter",
                               prefix: str = "uniter.") -> Dict[str, np.ndarray]:
    """JAX parameter tree (nested dicts of arrays) -> reference-format state
    dict of numpy arrays: trunk keys under ``prefix``, task heads at the
    root. Equal, key for key, in order and bit for bit, to the JAX
    package's ``export_state_dict`` (trunk, pretraining heads, fine-tune
    heads)."""
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = {}
    troot = f"{trunk}/" if trunk and trunk in params else ""
    for path, (tkey, kind) in _STATIC_MAP.items():
        if troot + path in flat:
            out[prefix + tkey] = _convert(flat[troot + path], kind)
    for subpath, (tsub, kind) in _LAYER_MAP.items():
        full = f"{troot}encoder/layer/bert_layer/{subpath}"
        if full in flat:
            for i, arr in enumerate(np.asarray(flat[full])):
                out[f"{prefix}encoder.layer.{i}.{tsub}"] = _convert(arr, kind)
    for path, (tkey, kind) in _PRETRAIN_HEAD_MAP.items():
        if path in flat:
            out[tkey] = _convert(flat[path], kind)
    two_layer_re = "re_hidden/kernel" in flat
    for path, tkey, kind in _TASK_HEAD_MAP:
        if path not in flat or tkey in out:
            continue
        # emit RE's Sequential form only when the 2-layer head exists,
        # else the plain Linear
        if tkey.startswith("re_output.3.") and not two_layer_re:
            continue
        if (tkey.startswith("re_output.")
                and "." not in tkey[len("re_output."):] and two_layer_re):
            continue
        out[tkey] = _convert(flat[path], kind)
    return out


def normalize_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """gamma/beta rename + ``uniter.``/``bert.`` prefix stripping + numpy,
    fp16 widened to fp32 (the JAX package's function of the same name).

    Returns keys relative to the UniterModel root (``embeddings.*``,
    ``encoder.*``, ...) plus any task-head keys as they were."""
    out = {}
    for key, val in state_dict.items():
        k = key.replace("gamma", "weight").replace("beta", "bias")
        arr = np.asarray(val.detach().cpu().numpy() if hasattr(val, "detach")
                         else val)
        out[k] = arr.astype(np.float32) if arr.dtype == np.float16 else arr
    # released checkpoints prefix the trunk with "uniter." (task models) or
    # "bert." (converted BERT init, scripts/convert_ckpt.py)
    for prefix in ("uniter.", "bert."):
        if any(k.startswith(prefix) for k in out):
            out = {(k[len(prefix):] if k.startswith(prefix) else k): v
                   for k, v in out.items()}
            break
    return out


def pretrain_head_state_dict(state_dict: Mapping[str, np.ndarray]
                             ) -> Dict[str, np.ndarray]:
    """The pretraining-head tensors of a normalized state dict, under the
    reference keys ``UniterForPretraining`` names its heads by (the JAX
    package's ``pretrain_head_params_from_state_dict``)."""
    return {tkey: state_dict[tkey]
            for tkey, _ in _PRETRAIN_HEAD_MAP.values() if tkey in state_dict}


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a torch .pt state dict (weights only) and normalize it."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd and all(
        not hasattr(v, "numpy") for k, v in sd.items() if k != "state_dict"
    ):
        sd = sd["state_dict"]
    return normalize_state_dict(sd)

