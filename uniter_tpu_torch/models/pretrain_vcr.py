"""VCR second-stage pretraining model (MLM / MRFR / MRC, no ITM).

Counterpart of ``uniter_tpu/models/pretrain_vcr.py`` (reference
model/pretrain_vcr.py): ``UniterForPretraining`` with the batch's
``txt_type_ids`` (0 question, 2 answer, 3 rationale) flowing through
``encode_batch``. The 4-row type table and the 81 special word rows are the
driver's checkpoint surgeries over a config with ``type_vocab_size=4`` and
``vocab_size + 81``. An ``itm*`` task raises ``ValueError``.
"""

from __future__ import annotations

from uniter_tpu_torch.models.pretrain import UniterForPretraining


def _refuse_itm(task: str):
    if task.startswith("itm"):
        raise ValueError("VCR 2nd-stage pretraining has no ITM task "
                         "(reference pretrain_vcr.py:43-68)")


class UniterForPretrainingForVCR(UniterForPretraining):
    def forward(self, batch, task="mlm", compute_loss=True, *,
                deterministic: bool = False, generator=None):
        _refuse_itm(task)
        return super().forward(batch, task, compute_loss,
                               deterministic=deterministic,
                               generator=generator)

    def scalar_loss(self, batch, task: str, **kw):
        _refuse_itm(task)
        return super().scalar_loss(batch, task, **kw)
