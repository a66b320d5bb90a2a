"""Constants (reference utils/const.py)."""

IMG_DIM = 2048
IMG_LABEL_DIM = 1601
BUCKET_SIZE = 8192
