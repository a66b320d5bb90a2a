"""Multi-process data parallelism over ``torch.distributed`` (counterpart
of ``uniter_tpu/parallel/``)."""
