"""Shared helpers for task models: batch encoding through the trunk
(counterpart of ``uniter_tpu/models/common.py``)."""

from __future__ import annotations


def encode_batch(uniter, batch, deterministic: bool = True):
    """Run the UniterModel trunk on the canonical batch dict.

    Canonical keys (static shapes): input_ids [B,T], position_ids [B,T],
    img_feat [B,R,D], img_pos_feat [B,R,7], attn_mask [B,T+R]; optional
    txt_type_ids, img_type_ids, img_masks.
    """
    return uniter(
        input_ids=batch.get("input_ids"),
        position_ids=batch.get("position_ids"),
        img_feat=batch.get("img_feat"),
        img_pos_feat=batch.get("img_pos_feat"),
        attn_mask=batch["attn_mask"],
        img_masks=batch.get("img_masks"),
        txt_type_ids=batch.get("txt_type_ids"),
        img_type_ids=batch.get("img_type_ids"),
        deterministic=deterministic,
    )
