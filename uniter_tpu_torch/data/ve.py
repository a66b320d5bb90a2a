"""SNLI-VE dataset aliases (reference data/ve.py: VE = VQA with 3 answers;
counterpart of ``uniter_tpu/data/ve.py``)."""

from uniter_tpu_torch.data.vqa import VeDataset  # noqa: F401

VeEvalDataset = VeDataset
