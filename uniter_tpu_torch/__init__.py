"""UNITER on PyTorch and CUDA: the port of ``uniter_tpu`` to one NVIDIA H100.

The module layout mirrors ``uniter_tpu`` file for file, so each module's
counterpart is easy to find. The package imports ``torch`` and never
``jax``; the JAX package stays the reference the tests hold it against.
Every Pallas kernel on a ported path is a hand-written CUDA kernel under
``csrc/``, built at first use; its plain torch version sits beside its
wrapper and serves CPU tensors.
"""

__version__ = "0.1.0"
