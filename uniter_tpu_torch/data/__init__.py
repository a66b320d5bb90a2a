"""The numpy data layer, copied from ``uniter_tpu.data`` with only import
paths changed. Nothing is imported eagerly: ``buckets``, ``sampler``,
``loader``, ``datasets`` and ``vqa`` load without ``msgpack`` or
``liblz4``, which only ``txt_db``/``img_db`` need."""
