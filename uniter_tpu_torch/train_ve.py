"""SNLI-VE fine-tuning on one device (counterpart of the root
``train_ve.py``, reference train_ve.py): the VQA driver with 3 answers and
the recipe's defaults (lr 8e-5, 4000 steps, 400 warm-up):

    python -m uniter_tpu_torch.train_ve --config CONFIG.json \\
        [--device cuda] [--num_train_steps N] ...

The txt DBs hold SNLI-VE examples in the VQA layout (``target`` labels
0-2); ``python -m uniter_tpu_torch.inf_vqa --train_dir OUTPUT_DIR``
predicts from the run.
"""

from __future__ import annotations

from uniter_tpu_torch import train_vqa
from uniter_tpu_torch.utils.misc import parse_with_config


def get_parser():
    parser = train_vqa.get_parser()
    parser.set_defaults(num_answer=3, learning_rate=8e-5,
                        num_train_steps=4000, warmup_steps=400)
    return parser


main = train_vqa.main

if __name__ == "__main__":
    main(parse_with_config(get_parser()))
