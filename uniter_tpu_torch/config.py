"""Model configuration.

The hyperparameter surface of ``uniter_tpu.config.UniterConfig`` (the
reference's ``UniterConfig``, loaded from config/uniter-{base,large}.json)
plus the compute-policy knobs this package acts on. ``from_dict`` ignores
the JAX package's other knobs (block fusion, LayerNorm/FFN kernels, scan
and remat settings), so a training run's ``log/model.json`` loads
unchanged; ``resolve_kernel_policies`` maps its attention policy onto this
package's kernel for an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class UniterConfig:
    """BERT-style hyperparameters for the single-stream UNITER encoder."""

    vocab_size: int = 28996
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02

    # --- compute policy (no reference equivalent) ---
    # Compute dtype of the encoder; parameters are always stored fp32.
    dtype: str = "bfloat16"
    # "cuda" (the hand-written kernel, csrc/mha_fwd.cu) or "xla" (the plain
    # torch version). The JAX package's "auto"/"pallas"/"pallas_nt" are
    # accepted and resolved by resolve_kernel_policies.
    attention_impl: str = "xla"
    layer_norm_eps: float = 1e-12
    # One [3H, H] projection instead of three (weights stay query/key/value,
    # so checkpoints are unaffected).
    fused_qkv: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def replace(self, **kw) -> "UniterConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any], **overrides) -> "UniterConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw.update(overrides)
        return cls(**kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def resolve_kernel_policies(cfg: UniterConfig, device) -> UniterConfig:
    """Resolve the attention policy for ``device`` (decided from the
    argument, never by probing the process).

    On a CUDA device "auto", "pallas" and "pallas_nt" select the
    hand-written kernel ("cuda"); the TPU's ``pallas_nt`` layout variant
    has no counterpart here. "xla", and every policy on a CPU device,
    select the plain torch version.
    """
    on_cuda = torch.device(device).type == "cuda"
    att = cfg.attention_impl
    if att in ("auto", "pallas", "pallas_nt", "cuda"):
        att = "cuda" if on_cuda else "xla"
    elif att != "xla":
        raise ValueError(f"unknown attention_impl {att!r}")
    return cfg.replace(attention_impl=att)


def base_config(**overrides) -> UniterConfig:
    """uniter-base: 12L/768H/12 heads (reference config/uniter-base.json)."""
    return UniterConfig(**overrides)


def large_config(**overrides) -> UniterConfig:
    """uniter-large: 24L/1024H/16 heads (reference config/uniter-large.json)."""
    kw = dict(
        hidden_size=1024,
        num_hidden_layers=24,
        num_attention_heads=16,
        intermediate_size=4096,
    )
    kw.update(overrides)
    return UniterConfig(**kw)


def tiny_config(**overrides) -> UniterConfig:
    """A small config for tests."""
    kw = dict(
        vocab_size=512,
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=128,
        max_position_embeddings=64,
        dtype="float32",
    )
    kw.update(overrides)
    return UniterConfig(**kw)
