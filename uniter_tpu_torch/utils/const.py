"""Constants (reference utils/const.py)."""

IMG_DIM = 2048
IMG_LABEL_DIM = 1601
BUCKET_SIZE = 8192

# SNLI-VE gold labels -> answer ids (reference utils/misc.py VE_ENT2IDX)
VE_ENT2IDX = {"contradiction": 0, "entailment": 1, "neutral": 2}
