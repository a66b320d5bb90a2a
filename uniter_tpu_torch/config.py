"""Model configuration.

The hyperparameter surface of ``uniter_tpu.config.UniterConfig`` (the
reference's ``UniterConfig``, loaded from config/uniter-{base,large}.json)
plus the compute-policy knobs this package acts on. ``from_dict`` ignores
the JAX package's other knobs (its scan settings), so a training run's
``log/model.json`` loads unchanged; ``resolve_kernel_policies`` maps
its attention, block-fusion, LayerNorm and FFN policies onto this package's
kernels for an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from uniter_tpu_torch.ops.dropout import DROPOUT_IMPLS

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
    # Dropout masks of the plain tails: "xla" is the 32-bit rule (keep iff
    # u32 >= rate * 2**32, Philox bits, ops/dropout.py); "u16"/"u8" the
    # JAX package's reduced-bit rules on the top 16/8 bits of the same
    # words. K1-K6 and the heads keep the 32-bit rule, as in JAX.
    dropout_impl: str = "xla"
    # "cuda" runs each live dropout + residual + LayerNorm tail as one fused
    # Function (K3-K6, csrc/fused_tail.cu on the card); "none" composes the
    # plain ops. The JAX package's "auto"/"pallas" are accepted and resolved
    # by resolve_kernel_policies.
    block_fusion: str = "none"
    # "cuda" runs every LayerNorm that no fused tail takes through K8
    # (csrc/fused_tail.cu ``uniter_layer_norm_fwd``, plain fp32 backward);
    # "xla" is the plain version. The JAX package's "pallas" is accepted
    # and resolved by resolve_kernel_policies.
    layer_norm_impl: str = "xla"
    # "cuda" runs each BERT layer's gelu FFN as K9 (csrc/ffn.cu: both
    # products and the GELU in one launch, plain fp32 backward); "xla" is
    # the unfused Linear -> GELU -> Linear. The JAX package's "pallas" is
    # accepted and resolved by resolve_kernel_policies.
    ffn_impl: str = "xla"
    layer_norm_eps: float = 1e-12
    # One [3H, H] projection instead of three (weights stay query/key/value,
    # so checkpoints are unaffected).
    fused_qkv: bool = False
    # Recompute each encoder layer's activations in the backward
    # (--remat; torch.utils.checkpoint, models/encoder.py).
    remat: bool = False

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


def resolve_kernel_policies(cfg: UniterConfig, device, *,
                            training: bool = False) -> UniterConfig:
    """Resolve the kernel policies for ``device`` (decided from the
    argument, never by probing the process).

    Attention: on a CUDA device "auto", "pallas" and "pallas_nt" select the
    hand-written kernels ("cuda"); the TPU's ``pallas_nt`` layout variant
    has no counterpart here. "xla", and every policy on a CPU device,
    select the plain torch version.

    Block fusion (the fused dropout + residual + LayerNorm tails, K3-K6)
    decides only the tails whose dropout mask is live
    (``uniter_tpu/models/encoder.py`` :65,92), so inference, and every
    policy on a CPU device, resolve it to "none" (a tail with no live mask
    in a forward that records no gradient takes K3/K5 at rate 0 on the card
    whatever it says: ``models/encoder.py``). For ``training`` on a CUDA
    device "auto", "pallas" and "cuda" select the kernels ("cuda") and
    "none" stays "none". For ``training``
    ``dropout_impl`` must be "xla", "u16" or "u8" (inference draws no
    mask).

    LayerNorm: "pallas" and "cuda" select K8 ("cuda") on a CUDA device and
    the plain version ("xla") on a CPU device, as
    ``uniter_tpu/config.py`` ``resolve_kernel_policies`` does; "xla" stays.
    The FFN (``ffn_impl``) resolves the same way: "pallas" and "cuda" to K9
    ("cuda") on a CUDA device, to "xla" on a CPU device.
    """
    on_cuda = torch.device(device).type == "cuda"
    att = cfg.attention_impl
    if att in ("auto", "pallas", "pallas_nt", "cuda"):
        att = "cuda" if on_cuda else "xla"
    elif att != "xla":
        raise ValueError(f"unknown attention_impl {att!r}")
    bf = cfg.block_fusion
    if bf not in ("auto", "none", "pallas", "cuda"):
        raise ValueError(f"unknown block_fusion {bf!r}")
    bf = "cuda" if training and on_cuda and bf != "none" else "none"
    ln = cfg.layer_norm_impl
    if ln in ("pallas", "cuda"):
        ln = "cuda" if on_cuda else "xla"
    elif ln != "xla":
        raise ValueError(f"unknown layer_norm_impl {ln!r}")
    ffn = cfg.ffn_impl
    if ffn in ("pallas", "cuda"):
        ffn = "cuda" if on_cuda else "xla"
    elif ffn != "xla":
        raise ValueError(f"unknown ffn_impl {ffn!r}")
    if training and cfg.dropout_impl not in DROPOUT_IMPLS:
        raise ValueError(f"unknown dropout_impl {cfg.dropout_impl!r}")
    return cfg.replace(attention_impl=att, block_fusion=bf,
                       layer_norm_impl=ln, ffn_impl=ffn)


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
