"""Shared fine-tune driver plumbing (counterpart of
``uniter_tpu/training/driver.py``): the common CLI surface, model config,
checkpoint load and the run harness.

Each ``train_*.py`` entry point supplies a small adapter (datasets, model,
loss, validation) and inherits the reference's driver behavior
(train_nlvr2.py:55-276 skeleton): config-JSON CLI, provenance dump, scalar
log, periodic validation, checkpoints with resume. One process drives one
device (``--device``, the card by default); ``torchrun --nproc_per_node N
-m uniter_tpu_torch.<cli>`` runs N of them as one data-parallel job
(``setup_run`` joins the process group: NCCL on the card, or gloo with
``--dist_backend gloo``, which lets ranks share a card). Every rank runs
the same global batch plan and trains on its contiguous block of each
batch; evaluation sets are sharded by rank (``shard_kw``) and gathered;
rank 0 alone logs and writes. Blocks and shards follow the data axis:
under a data x model grid (``parallel/mesh.py`` ``make_mesh``, built
through the API as in the JAX package) ``place_state`` also cuts the
model's tensor-parallel blocks, and the model ranks of a data group read
the same batches.

The flags are the JAX drivers'. ``--attention_impl`` and
``--block_fusion`` default to ``auto``: on the card the hand-written
attention kernels (K1/K2) and the fused dropout + residual + LayerNorm
tails (K3-K6), on the CPU their plain versions; ``--block_fusion none``
keeps the plain tails on the card. The LayerNorm and FFN policies
(``layer_norm_impl``, ``ffn_impl``) come from the ``--model_config`` JSON
and resolve for ``--device`` (K8, K9 on the card when set to
``pallas``/``cuda``). Flags that tune TPU machinery are
accepted and do nothing here: ``--attn_batch_block`` (the TPU kernel's grid
blocking), ``--warmup_compile`` (ahead-of-time XLA compiles), ``--fp16``
and ``--pin_mem`` (batches are always pinned). ``--remat``,
``--param_dtype bfloat16`` (master weights; needs ``--fused_adamw 1``),
``--optim adam``/``adamax``, ``--dropout_impl u16``/``u8``, ``--wire_codec
int8``, ``--profile_dir`` and ``--fsdp`` (the parameters of
``--fsdp_min_size`` elements or more, and their optimizer state, sharded
over the ranks at rest and gathered a unit at a time in the forward and
the backward: ``parallel/fsdp.py``) act as in the JAX drivers
(``uniter_tpu/training/driver.py:147-180,275-285,440-455``).
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from uniter_tpu_torch.config import UniterConfig, resolve_kernel_policies
from uniter_tpu_torch.data.buckets import BucketSpec, size_multiple
from uniter_tpu_torch.data.loader import AccumLoader, MetaLoader
from uniter_tpu_torch.models.checkpoint import load_torch_checkpoint
from uniter_tpu_torch.parallel.collectives import (
    all_gather_list, barrier, data_index, data_size, init_distributed,
    is_distributed, num_processes, process_index)
from uniter_tpu_torch.training.loop import (
    MixedTaskLoop, TrainLoop, pretrain_loss_units)
from uniter_tpu_torch.training.optim import build_optimizer
from uniter_tpu_torch.training.sched import get_lr_schedule
from uniter_tpu_torch.training.step import TrainState, make_train_step
from uniter_tpu_torch.utils.logger import LOGGER, TB_LOGGER, add_log_to_file
from uniter_tpu_torch.utils.misc import set_random_seed
from uniter_tpu_torch.utils.save import TrainStateSaver, save_training_meta


def add_common_args(parser: argparse.ArgumentParser):
    parser.add_argument("--config", type=str)
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--model_config", type=str)
    parser.add_argument("--output_dir", default=None, type=str)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cuda, cuda:N, cpu)")
    parser.add_argument("--compressed_db", action="store_true",
                        help="img DBs use the *_compressed (npz) store "
                             "layout (reference train_vqa.py:316)")
    parser.add_argument("--max_txt_len", type=int, default=60)
    parser.add_argument("--conf_th", type=float, default=0.2)
    parser.add_argument("--max_bb", type=int, default=100)
    parser.add_argument("--min_bb", type=int, default=10)
    parser.add_argument("--num_bb", type=int, default=36)
    parser.add_argument("--train_batch_size", type=int, default=4096)
    parser.add_argument("--val_batch_size", type=int, default=4096)
    parser.add_argument("--gradient_accumulation_steps", type=int, default=1)
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="optimizer steps per stacked batch")
    parser.add_argument("--learning_rate", type=float, default=3e-5)
    parser.add_argument("--lr_mul", type=float, default=1.0)
    parser.add_argument("--valid_steps", type=int, default=1000)
    parser.add_argument("--log_steps", type=int, default=100)
    parser.add_argument("--num_train_steps", type=int, default=8000)
    parser.add_argument("--optim", default="adamw")
    parser.add_argument("--fused_adamw", type=int, default=1,
                        help="one-pass AdamW (both moments may be bf16)")
    parser.add_argument("--moment_dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="storage dtype for both Adam moments (fp32 "
                             "arithmetic either way; needs --fused_adamw)")
    parser.add_argument("--param_dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="storage dtype for large parameters "
                             "(embeddings, GEMM weights; LayerNorm and "
                             "biases stay fp32): bfloat16 keeps fp32 "
                             "master weights in the fused optimizer; "
                             "needs --fused_adamw 1")
    parser.add_argument("--wire_codec", default="cast",
                        choices=["cast", "int8"],
                        help="host->card format of img_feat: 'cast' "
                             "(bit-exact) or 'int8' (per-row int8 + scale, "
                             "dequantized on the card; ~0.4%% error)")
    parser.add_argument("--dropout_impl", default="xla",
                        choices=["xla", "u16", "u8"],
                        help="mask rule of the plain dropout tails: 32-bit "
                             "thresholds, or 16/8-bit (keep rate quantized "
                             "to 1/65536 or 1/256)")
    parser.add_argument("--betas", nargs=2, type=float, default=[0.9, 0.98])
    parser.add_argument("--dropout", type=float, default=0.1)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--grad_norm", type=float, default=2.0)
    parser.add_argument("--warmup_steps", type=int, default=800)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--attention_impl", default="auto",
                        choices=["auto", "xla", "pallas", "pallas_nt"],
                        help="auto/pallas: the hand-written CUDA kernels "
                             "on the card, the plain version on the CPU")
    parser.add_argument("--block_fusion", default="auto",
                        choices=["auto", "none", "pallas"],
                        help="auto/pallas: the fused dropout+residual+"
                             "LayerNorm kernels (K3-K6) on the card, the "
                             "plain tails on the CPU; none: the plain tails")
    parser.add_argument("--attn_batch_block", type=int, default=0,
                        help="TPU kernel grid blocking; no effect here")
    parser.add_argument("--fp16", action="store_true",
                        help="accepted for config compat; bf16 is used")
    parser.add_argument("--n_workers", type=int, default=4)
    parser.add_argument("--worker_type", default=None,
                        choices=["thread", "process", "shm"])
    parser.add_argument("--pin_mem", action="store_true",
                        help="accepted; batches are always pinned")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of a few "
                             "hot-loop steps here")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each encoder layer's activations "
                             "in the backward (less activation memory, "
                             "about one more forward)")
    parser.add_argument("--fsdp", action="store_true",
                        help="ZeRO-3: shard the parameters and their "
                             "optimizer state (moments, and the masters of "
                             "--param_dtype bfloat16) over the processes")
    parser.add_argument("--fsdp_min_size", type=int, default=2 ** 16,
                        help="smallest parameter (elements) to shard; "
                             "smaller ones stay replicated")
    parser.add_argument("--dist_backend", default=None,
                        choices=["nccl", "gloo"],
                        help="process group backend under torchrun "
                             "(default: nccl on the card, gloo on the "
                             "CPU); gloo lets several ranks share a card")
    parser.add_argument("--warmup_compile", action="store_true",
                        help="XLA compile warm-up; no effect here")
    return parser


def optim_kwargs(opts) -> dict:
    """Shared optimizer options (drivers pass these to build_optimizer)."""
    md = getattr(opts, "moment_dtype", "float32")
    md = torch.bfloat16 if md == "bfloat16" else None
    fused = bool(getattr(opts, "fused_adamw", 0))
    if md is not None and not fused:
        raise ValueError("--moment_dtype bfloat16 requires --fused_adamw 1")
    master = getattr(opts, "param_dtype", "float32") == "bfloat16"
    if master and not fused:
        raise ValueError("--param_dtype bfloat16 requires --fused_adamw 1")
    return dict(
        betas=tuple(opts.betas), weight_decay=opts.weight_decay,
        grad_norm=opts.grad_norm, optim=opts.optim, fused=fused,
        mu_dtype=md, nu_dtype=md, master=master,
        fsdp=bool(getattr(opts, "fsdp", False)),
        fsdp_min_size=getattr(opts, "fsdp_min_size", 2 ** 16))


def model_config_from_opts(opts, **overrides) -> UniterConfig:
    with open(opts.model_config) as f:
        raw = json.load(f)
    if raw.get("model_type", "uniter") != "uniter":
        raise NotImplementedError(
            f"training a {raw['model_type']!r} model is not supported: the "
            f"port trains UNITER; BEiT-3 (models/beit3.py) serves only")
    cfg = UniterConfig.from_dict(
        raw, dtype=opts.dtype,
        attention_impl=getattr(opts, "attention_impl", "auto"),
        block_fusion=getattr(opts, "block_fusion", "auto"),
        dropout_impl=getattr(opts, "dropout_impl", "xla"),
        remat=bool(getattr(opts, "remat", False)), **overrides)
    # --dropout overrides both dropout rates (reference utils/misc.py:57-63)
    drop = getattr(opts, "dropout", None)
    if drop is not None:
        cfg = cfg.replace(hidden_dropout_prob=drop,
                          attention_probs_dropout_prob=drop)
    return resolve_kernel_policies(cfg, opts.device, training=True)


def wire_codec(opts) -> Optional[str]:
    """``--wire_codec`` as the loops take it (None for ``cast``)."""
    codec = getattr(opts, "wire_codec", "cast")
    return None if codec == "cast" else codec


def init_weights(model: nn.Module, std: float):
    """The JAX package's initialisers: normal(0, std) for linear weights
    and embedding tables, zero biases, LayerNorm ones and zeros (torch's
    global generator, seeded by ``set_random_seed``)."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Embedding)):
            nn.init.normal_(module.weight, 0.0, std)
            if getattr(module, "bias", None) is not None:
                nn.init.zeros_(module.bias)
        elif hasattr(module, "eps") and hasattr(module, "weight"):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)


def open_img_db(path, opts, compress=None, gt=False):
    """A ``DetectFeatDb``; ``compress=None`` resolves from
    ``opts.compressed_db``. Ground-truth region DBs (``gt=True``, or ``coco_gt``/``*_gt`` by name, as the
    reference detects them) open with conf_th=-1 and num_bb=100."""
    from uniter_tpu_torch.data.img_db import DetectFeatDb

    if compress is None:
        compress = bool(getattr(opts, "compressed_db", False))
    base = os.path.basename(os.path.normpath(path))
    if "coco_gt" in base or base.endswith("_gt"):
        gt = True
    if gt:
        return DetectFeatDb(path, conf_th=-1, max_bb=opts.max_bb,
                            min_bb=opts.min_bb, num_bb=100,
                            compress=compress)
    return DetectFeatDb(path, conf_th=opts.conf_th, max_bb=opts.max_bb,
                        min_bb=opts.min_bb, num_bb=opts.num_bb,
                        compress=compress)


_TYPE_KEY = "embeddings.token_type_embeddings.weight"
_WORD_KEY = "embeddings.word_embeddings.weight"


def load_trunk_checkpoint(model, opts, *, n_type_rows: Optional[int] = None,
                          type_copy_row: int = 1, n_special_words: int = 0,
                          extra: Optional[Callable] = None):
    """Load ``--checkpoint`` (a reference or exported ``.pt``) into the
    ``uniter`` trunk, with the JAX package's surgeries
    (``uniter_tpu/training/driver.py`` ``load_trunk_checkpoint``):

    * token-type widening: with ``n_type_rows`` the file's type rows fill
      the first rows of the model's table and row ``type_copy_row`` of the
      file is copied into every row past them (NLVR2: 2 rows -> 3, row 1
      into row 2, reference model/nlvr2.py:26-34; VCR: 2 -> 4, row 0 into
      rows 2 and 3, model/vcr.py:32-41);
    * word widening: with ``n_special_words`` the file's word rows fill the
      first rows of the model's table and the rows past them keep their
      initial values (VCR's 81 special tokens, model/vcr.py:42-50); a file
      that already has the model's rows (a VCR-pretrained one) loads as it
      is.

    Keys the trunk does not have are skipped; a trunk key the file lacks
    keeps its initial value, as the JAX merge does. A trunk key whose shape
    differs (after the widening) raises ``ValueError`` with the key and
    both shapes, as that merge does (``strict_shapes=True``).
    ``extra(model, sd)`` then loads what lies outside the trunk (the
    pretraining heads) from the same normalized state dict."""
    if not opts.checkpoint:
        return model
    sd = load_torch_checkpoint(opts.checkpoint)
    own = model.uniter.state_dict()
    take = {}
    for k, v in sd.items():
        if k not in own:
            continue
        v = torch.from_numpy(np.ascontiguousarray(v))
        widen = ((k == _TYPE_KEY and n_type_rows is not None)
                 or (k == _WORD_KEY and n_special_words > 0))
        if widen:
            if (v.shape[1:] != own[k].shape[1:]
                    or v.shape[0] > own[k].shape[0]
                    or (k == _TYPE_KEY and own[k].shape[0] != n_type_rows)):
                raise ValueError(f"{k}: cannot widen {tuple(v.shape)} to "
                                 f"{tuple(own[k].shape)}")
            new = own[k].clone()
            new[:v.shape[0]] = v
            if k == _TYPE_KEY:
                new[v.shape[0]:] = v[type_copy_row]
            v = new
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(
                f"shape mismatch for uniter.{k}: ckpt {tuple(v.shape)} vs "
                f"model {tuple(own[k].shape)}")
        take[k] = v
    model.uniter.load_state_dict(take, strict=False)
    if extra is not None:
        extra(model, sd)
    LOGGER.info("loaded %d trunk tensors from %s (%d of the trunk's %d "
                "left at init)", len(take), opts.checkpoint,
                len(own) - len(take), len(own))
    return model


def init_process(opts):
    """Join the launcher's process group (``parallel.collectives
    .init_distributed``) and set ``opts.device`` to this rank's device; on
    ranks past 0 the log says warnings only. Nothing happens outside a
    launcher."""
    opts.device = init_distributed(opts.device,
                                   getattr(opts, "dist_backend", None))
    if process_index() > 0:
        LOGGER.setLevel(logging.WARNING)


def setup_run(opts, model_cfg):
    """The process group (``init_process``), the seed, and on rank 0 the
    run's provenance (``log/hps.json``, ``model.json``), scalars and log
    file. Call it before building anything on ``opts.device``."""
    init_process(opts)
    set_random_seed(opts.seed)
    os.makedirs(opts.output_dir, exist_ok=True)
    if process_index() == 0:
        save_training_meta(opts.output_dir, opts, model_cfg.to_dict())
        TB_LOGGER.create(os.path.join(opts.output_dir, "log"))
        add_log_to_file(os.path.join(opts.output_dir, "log", "log.txt"))
    barrier()  # the run's directories exist before any rank writes
    LOGGER.info("device: %s (attention %s, block_fusion %s, layer_norm %s, "
                "ffn %s, dtype %s), %d process(es)%s", opts.device,
                model_cfg.attention_impl, model_cfg.block_fusion,
                model_cfg.layer_norm_impl, model_cfg.ffn_impl,
                model_cfg.dtype, num_processes(),
                f" over {torch.distributed.get_backend()}"
                if is_distributed() else "")


def shard_kw() -> dict:
    """This rank's share of a data set (the ``BucketLoader``'s
    ``shard_index``/``shard_count``; the reference's
    ``ids[rank::size]``, data/data.py:218-225): its place on the data
    axis, so the model ranks of a data group read the same batches."""
    return dict(shard_index=data_index(), shard_count=data_size())


def bucket_spec(opts, dataset, budget=None) -> BucketSpec:
    """The JAX driver's bucket grid: batch sizes in multiples of
    ``rows_per_example`` x the number of processes (at least 8), so every
    rank takes whole examples."""
    rows = getattr(dataset, "rows_per_example", 1)
    cap = getattr(opts, "max_txt_len", 60)
    if cap == -1:
        cap = 506
    cap += 6
    txt_buckets = tuple(b for b in (32, 64, 96, 128, 160, 192, 256, 320, 512)
                        if b < cap) + (((cap + 7) // 8) * 8,)
    try:
        max_r = max(dataset.size_of(i)[1] for i in range(len(dataset)))
    except Exception:
        max_r = opts.max_bb
    max_r = max(max_r, 4)
    img_buckets = tuple(b for b in (20, 40, 64, 100) if b < max_r) + (
        ((max_r + 3) // 4) * 4,)
    return BucketSpec(
        txt_buckets=txt_buckets, img_buckets=img_buckets,
        token_budget=budget or opts.train_batch_size,
        size_mul=size_multiple(rows, data_size()))


def check_token_range(model_cfg, dataset, n_samples: int = 32):
    """Fail fast on ids past the embedding tables (the lookup clamps them,
    as the JAX package's does, which would otherwise train silently on the
    wrong rows). A record that holds its rows (VCR's candidates, NLVR2's
    image pairs) is checked row by row."""
    n = len(dataset)
    if n == 0:
        return

    def deep_max(v):
        if isinstance(v, (list, tuple)):
            vals = [m for m in (deep_max(x) for x in v) if m is not None]
            return max(vals) if vals else None
        arr = np.asarray(v)
        return int(arr.max()) if arr.size else None

    rng = np.random.RandomState(0)
    for i in range(0, n, max(1, n // n_samples)):
        rec = dataset.get_record(i, rng)
        if not isinstance(rec, dict):
            return
        rows = rec.get("rows", [rec])
        m = deep_max([r.get("input_ids", ()) for r in rows])
        if m is not None and m >= model_cfg.vocab_size:
            raise ValueError(
                f"token id {m} >= vocab_size {model_cfg.vocab_size} "
                f"(record {i})")
        m = deep_max([r.get("txt_type_ids", ()) for r in rows])
        if m is not None and m >= model_cfg.type_vocab_size:
            raise ValueError(
                f"type id {m} >= type_vocab_size "
                f"{model_cfg.type_vocab_size} (record {i})")


def place_state(model: nn.Module, learning_rate, *, fsdp: bool = False,
                fsdp_min_size: int = 2 ** 16, **opt_kw) -> TrainState:
    """The train state placed on the grid ``parallel/mesh.py``
    ``make_mesh`` built (counterpart of JAX ``place_state``,
    ``uniter_tpu/training/loop.py:61-80``): the model's tensor-parallel
    blocks over the model axis first (``parallel/tp.py``
    ``shard_model``), then the optimizer
    (``build_optimizer``'s keywords), with ``--fsdp`` sharding the
    parameters and their state over the data group. ``model`` holds full
    parameters (a checkpoint loaded); a resume loads full tensors into the
    placed state (``TrainStateSaver.restore``)."""
    from uniter_tpu_torch.parallel.tp import shard_model

    shard_model(model)
    opt = build_optimizer(model, learning_rate, fsdp=fsdp,
                          fsdp_min_size=fsdp_min_size, **opt_kw)
    return TrainState(step=0, model=model, opt=opt)


def resumable_state(opts, model):
    """The schedule, the train state over ``build_optimizer`` (no
    tensor-parallel cut, as ``place_state`` makes) and its saver, resumed
    from ``output_dir`` when it holds one: (sched, state, saver)."""
    sched = get_lr_schedule(opts.learning_rate, opts.warmup_steps,
                            opts.num_train_steps)
    state = TrainState(step=0, model=model, opt=build_optimizer(
        model, sched, **optim_kwargs(opts)))
    saver = TrainStateSaver(opts.output_dir)
    if saver.restore(state, seed=opts.seed) is not None:
        LOGGER.info("resumed from step %d", state.step)
    return sched, state, saver


def run_loop(loop_cls, opts, state, saver, sched, **kw):
    """``loop_cls`` (a ``training/loop.py`` ``LoopCore``) with the flags
    every training CLI passes it alike, and ``kw``, run to its end."""
    cdt = state.model.uniter.config.compute_dtype
    kw = {"profile_dir": getattr(opts, "profile_dir", None), **kw}
    state = loop_cls(
        state=state, device=opts.device, num_train_steps=opts.num_train_steps,
        valid_steps=opts.valid_steps,
        log_steps=getattr(opts, "log_steps", 100), saver=saver,
        seed=opts.seed, transfer_dtype=None if cdt == torch.float32 else cdt,
        lr_schedule=sched, wire_codec=wire_codec(opts), **kw).run()
    LOGGER.info("training finished at step %d", state.step)
    return state


def run_training(opts, *, model, loss_fn, train_loader, validate_fn=None,
                 lr_mul_paths: Sequence[str] = (), loss_scale: str = "sum",
                 best_metric: Optional[str] = None):
    """Optimizer, train state (resumed from ``output_dir`` when it holds
    one), and the loop. ``model`` is on ``opts.device`` already.

    With ``best_metric`` the loop keeps ``ckpt/model_step_best.pt`` at the
    best validation value of that metric (reference train_re.py:259-263):
    a resumed run starts from the saved best value, a fresh run in a reused
    ``output_dir`` first removes a previous run's best export, so ``--ckpt
    best`` never resolves to another run's weights."""
    sched = get_lr_schedule(opts.learning_rate, opts.warmup_steps,
                            opts.num_train_steps)
    state = place_state(model, sched, lr_mul=getattr(opts, "lr_mul", 1.0),
                        lr_mul_paths=lr_mul_paths, **optim_kwargs(opts))
    saver = TrainStateSaver(opts.output_dir)
    best_value = None
    if saver.restore(state, seed=opts.seed) is not None:
        LOGGER.info("resumed from step %d", state.step)
        info = saver.best_info() if best_metric else None
        if info is not None:
            best_value = float(info["value"])
        # the sidecar may lie on rank 0's disk alone: its value for all
        best_value = all_gather_list(best_value)[0]
    elif best_metric:
        saver.clear_best()
    ds = getattr(train_loader, "dataset", None)
    if ds is not None:
        check_token_range(model.uniter.config, ds)
    return run_loop(
        TrainLoop, opts, state, saver, sched, loss_fn=loss_fn,
        train_loader=train_loader, validate_fn=validate_fn,
        gradient_accumulation_steps=opts.gradient_accumulation_steps,
        steps_per_call=getattr(opts, "steps_per_call", 1),
        loss_scale=loss_scale, best_metric=best_metric,
        best_value=best_value)


def run_pretraining(opts, *, model, loaders, val_loaders, validate, loss_fn):
    """The pretraining CLIs' run (``pretrain``, ``pretrain_vcr``): the
    task loaders (name -> (loader, ratio)) checked against the
    vocabulary, grouped by ``--gradient_accumulation_steps`` and mixed by
    a seeded ``MetaLoader``; ``resumable_state``; one step function per
    task over ``loss_fn(model, batch, generator, task)``; ``validate(model,
    val_loaders, device)`` at ``valid_steps``; and ``MixedTaskLoop``. The
    train loaders are closed at the end. ``model`` is on ``opts.device``
    already."""
    for loader, _ in loaders.values():
        check_token_range(model.uniter.config, loader.dataset)
    accum = opts.gradient_accumulation_steps
    if accum > 1:
        loaders = {name: (AccumLoader(loader, accum), ratio)
                   for name, (loader, ratio) in loaders.items()}
    meta = MetaLoader(loaders, accum_steps=1, seed=opts.seed)
    sched, state, saver = resumable_state(opts, model)
    # one step function per task, built at its first draw
    get_step = functools.cache(lambda task: make_train_step(
        functools.partial(loss_fn, task=task), loss_scale="sum",
        accum_steps=accum))

    def validate_fn(state, step):
        return (validate(state.model, val_loaders, opts.device)
                if val_loaders else {})

    try:
        return run_loop(MixedTaskLoop, opts, state, saver, sched, meta=meta,
                        get_step=get_step, validate_fn=validate_fn,
                        loss_units_fn=pretrain_loss_units)
    finally:
        for loader in meta.loaders.values():
            getattr(loader, "base", loader).close()
