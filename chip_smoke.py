#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``uniter_tpu_torch``) on one NVIDIA
card: the quickest proof that the port builds and runs on the GPU.

    python3 chip_smoke.py              # every phase, as below
    python3 chip_smoke.py tails train  # device, build, then these alone
    python3 chip_smoke.py k2-groups    # not in the full run: the fp32 K2
                                       # at every split of its key tiles

A small kernel is timed two ways: its device time (``graph_ms``: 50 calls
captured in one CUDA graph, the graph replayed between CUDA events) and its
call time (``cuda_ms``: 500 calls from Python between CUDA events). The
first is what the card spends; the second adds the host's launch path
(checks, allocation, the ctypes call) whenever the host is the slower.

Phases, each printing its own lines:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
   exits non-zero when torch sees no CUDA device.
2. build: every hand-written kernel from ``uniter_tpu_torch/csrc/``, one
   ``nvcc`` per source, all at once (``-Xptxas -v`` report printed); the
   count of tensor-core instructions in ``cuobjdump -sass`` of the
   attention libraries (HMMA; TF32 HMMA in each fp32 instantiation) and of
   K9's (HGMMA), which must not be 0; registers, stack and shared memory
   of the fp32 attention instantiations, of every K9 instance and of K7's
   (``cuobjdump -res-usage``; K7's register form must not spill) and the
   dynamic shared memory of a launch.
3. K1 (``csrc/mha_fwd.cu``) at rate 0 against its plain version
   ``_mha_torch`` on the card, at the serving path's attention shapes,
   fp32 (the TF32 kernel, three passes a product; its LSE and the LSE's
   remainder) and bf16, with random key lengths and all-padding rows; at
   every shape the device and call times of K1 and of SDPA forward in
   turns, and the plain version's call time at (96, 104).
4. K1 and K2 (``csrc/mha_bwd.cu``) at rates 0 and 0.1 against their plain
   versions with the same seeds, at the training shapes (flagship,
   pretrain mix, retrieval, long buckets, uniter-large heads), both dtypes
   one pass from K1's out and LSE (bf16 with the output's remainder, fp32
   with the LSE's): K1's LSE against the plain one, K2 against
   ``_mha_bwd_lse_torch`` and against ``_mha_bwd_torch``, bitwise replay;
   the keep fraction measured through K1; at every shape and dtype the
   device and call times of K1 and K2 against
   ``scaled_dot_product_attention`` forward and backward (a library
   yardstick, never on a path) in turns kernel, SDPA, SDPA, kernel,
   medians, with the bounds (fp32 products at the three-pass TF32 rate,
   the FP32 units' 67 TFLOP/s printed beside); at (96, 104, 12, 64) also
   the plain versions at rates 0 and 0.1; the kernels SDPA launches in
   fp32 and its error against ``_mha_torch``. The last training shape,
   (8, 352, 12, 64), is the largest bucket of the VCR config.
5. K3-K6 (``csrc/fused_tail.cu``: dropout + residual + LayerNorm, and
   LayerNorm + dropout, forward and backward) against their plain versions
   in ``ops/fused_block.py`` at rates 0 and 0.1 (same seed), fp32 and bf16,
   at the sub-block tail (9984, 768), the text and image embedding tails
   (6144, 768) and (3840, 768), uniter-large (9984, 1024) and a ragged 91
   rows, and a width that takes the 4-wide path in bf16 (33, 772); the
   keep fraction and the mask, bit for bit, through K3; dw/db bit for bit
   on replay and equal to the fixed-order sum of the kernel's own
   per-block partials (``_sum_partials_torch``); K3 and K5 forward at rate
   0 through ``inference_tail`` in bf16 at a retrieval scoring tile
   (671,744, 768); device and call times of K3/K4 at (9984, 768) and
   K5/K6 at (6144, 768) and (3840, 768), rates 0 and 0.1, in turns with
   ``F.layer_norm`` and its backward (a library yardstick, never on a
   path); the plain versions' call times; the host
   time of a launch of K5, K8 and K9, piece by piece (``launch_path``).
6. serving path: uniter-base VQA inference (12 layers, 768 hidden, 12
   heads, 3129 answers; random weights from a seed in the JAX package's
   parameter layout, carried through the weight bridge) over in-memory
   questions fed through the port's ``BucketLoader`` at ``inf_vqa``'s
   default 8192-token budget, into the loop over batches ``inf_vqa`` runs.
   Once through the kernel (launch counts reset just before and read just
   after: K1 12 a batch, K3 at the 24 residual tails and K5 at the 2
   embedding tails at rate 0; K2, K4 and K6-K8 must not launch), once
   through the plain attention, LayerNorms and tails (``plain_tails``: no
   kernel at all); logits and answers agree.
7. training path: the uniter-base VQA fine-tune step at the JAX package's
   flagship shapes (``bench.py``: B=96, 64 text + 40 image tokens, bf16
   over fp32 parameters, dropout 0.1, fused AdamW with bf16 moments,
   mean BCE x 3129) under three policies in turns: plain (attention
   ``xla``, block fusion ``none``), K1/K2 (``cuda``/``none``) and K1-K6
   (``cuda``/``cuda``, resolved from ``auto``); launch counts per step of
   the K1-K6 path; step 1's loss of all three; profiles; 2-layer fp32 runs
   at dropout 0 (K1/K2 against plain) and 0.1 (K1-K6 and K1/K2 against
   plain); the same step at full depth in fp32 (``--dtype float32``)
   through K1-K6 and plain in turns: examples/s, launches, step 1's loss,
   device busy ms a step.
8. the CLI: ``train_vqa.main`` on DBs written from a seed (12 layers,
   validate and save at 10 and 20 steps, resume to 25) and
   ``inf_vqa.main`` on its output, on the card, through K1-K6.
9. NLVR2: ``UniterForNlvr2PairedAttn`` at uniter-base width on a fixed
   batch of 48 pairs (96 rows, 64 text + 40 image tokens, bf16, dropout
   0.1) through K1-K6 and through the plain path in turns (launches per
   step, step 1's loss, pairs/s); then ``train_nlvr2.main`` on paired DBs
   written from a seed (20 steps, validate and save at 10 and 20, resume to
   25) and ``inf_nlvr2.main``, one ``results.csv`` row per example.
10. K7 (``csrc/ipot.cu``: all of ``ipot_pallas``, preparation, loop and
   re-mask, of an example in one launch) against its plain version
   ``ops.ot.ipot`` at (B, N, M) = (48, 64, 160) (the pretrain-mix bucket),
   (96, 40, 64), (64, 100, 64) (register form), (8, 100, 512) (Q in shared
   memory, A in device memory) and a ragged (5, 37, 23), random lengths,
   two all-padding examples, k = 1 and 2: the plan, the distance, exact
   zeros where the plan is masked, bitwise repeatability; that one call
   runs one device kernel; ``ipot_cuda``'s device and call times against
   the plain loop's, the bound and the times before the redesign.
11. K8 (``uniter_layer_norm_fwd`` in ``csrc/fused_tail.cu``) against the
   plain ``layer_norm`` at the tails' shapes, fp32 and bf16; device and
   call times in turns with ``F.layer_norm``, the plain call time.
12. pretraining: ``UniterForPretraining`` at uniter-base on fixed batches
   at ``bench.py``'s pretrain-mix shape (B=48, 160 text + 64 image tokens,
   bf16, dropout 0.1, fused AdamW) under three policies in turns: plain,
   K1-K6 with the plain OT, and K1-K7; per task (mlm, mrfr, itm, mrc-kl)
   launches per step and step-1 agreement; the 2:2:1:1 mix as examples/s
   (median over turns); the ITM step with and without OT; a profile of the
   K1-K7 ITM step; 2-layer fp32 runs with ``layer_norm_impl="cuda"``.
13. K8 on a path: the serving pass on a quarter of the questions with
   ``layer_norm_impl="cuda"`` (launches per batch: K8 at the 3 LayerNorms
   no tail takes; logits, answers).
14. the pretraining CLI: ``pretrain.main`` on two corpora written from a
   seed (12 layers, four tasks mixed 2:2:1:1, validate and save at 10 and
   20 steps, resume to 25 with the task mix fast-forwarded).
15. K9 (``csrc/ffn.cu``: x W1 + b1 -> erf-GELU -> W2 + b2 in one launch)
   against its plain version ``ops.ffn.ffn_plain`` at (rows, H) = (15360,
   768) (the retrieval train step), (9984, 768), (9984, 1024) (uniter-large
   widths) and a ragged (4097, 768), D_mid = 4 H, fp32 and bf16, bitwise
   repeatability; device and call times of the kernel and of the cuBLAS
   composition ``F.linear -> F.gelu -> F.linear`` (a yardstick, never on a
   path) in turns kernel, composition, composition, kernel, the plain
   version's call time, the bound, the kernel's TFLOP/s and its share of
   the bound.
16. retrieval training: ``UniterForImageTextRetrieval`` at uniter-base on a
   fixed batch at ``configs/train-itm-flickr-base-tpu.json``'s shape (40
   groups x 3 rows, 64 text + 64 image tokens, bf16, dropout 0.1, fused
   AdamW) with the FFN unfused and through K9 (K1-K6 both) in turns:
   launches per step, step 1's loss, examples/s, a profile of each; a
   2-layer fp32 run of K1-K9 against plain.
17. hard negatives: ``UniterForImageTextRetrievalHardNeg`` at uniter-base,
   64 candidates, hard_size 31, 2 candidate batches a step: the mined sets
   of both FFN policies at fp32, the losses at bf16, K9 launches.
18. retrieval serving: ``fast_score_matrix`` (pre-embedded corpus, CLS-only
   last layer) over 32 texts x 64 images in memory, fp32 and bf16, through
   K1 + K9 with the tails' K3/K5 at rate 0, and through the plain
   attention, FFN and tails, in turns (launches, scores, recalls,
   pairs/s).
19. the retrieval CLIs: ``train_itm.main`` on DBs written from a seed with a
   model config asking for ``"ffn_impl": "pallas"`` (20 steps, validate and
   save at 10 and 20, resume to 25), ``inf_itm.main`` on its run and
   ``train_itm_hard_negatives.main`` for 4 steps.
20. VCR (``vcr``): ``UniterForVisualCommonsenseReasoning`` at uniter-base
   with 4 token-type rows and 28996 + 81 words, on batches of
   ``train_vcr``'s loader (``VcrDataset`` qa and qar concatenated, the
   config's bucket grid and 4000-token budget) over DBs written from a
   seed (questions 8-30 tokens, answers 5-25, rationales 10-50, 2-20
   ground-truth plus 10-100 detected regions), bf16, dropout 0.1, fused
   AdamW with bf16 moments, under plain and K1-K6 in turns: launches per
   step, step-1 agreement, rows/s, a profile at the epoch's largest bucket
   (device busy ms a step), 2-layer fp32 runs of K1-K6 against plain.
21. VCR serving (``vcr_serve``): ``inf_vcr``'s loop in fp32 over the val
   (8 rows a question) and test (20) splits through K1 and the tails'
   K3/K5 at rate 0, and through the plain attention and tails: K1 12 a
   batch, K3 24 and K5 2; the same argmax in every qa and qar group;
   scores within 1e-3.
22. RE (``re``): ``UniterForReferringExpressionComprehension`` on a fixed
   batch at ``configs/train-refcoco-base-tpu.json``'s shapes (128
   expressions, T 64, up to 100 gt regions), the cls loss under plain and
   K1-K6 (launches, step-1 agreement, 2-layer fp32), then 5 rank-loss
   steps through K1-K6 with the negatives drawn on the card: finite
   losses, the hard share, easy negatives never the target or padding, a
   replay of each step's draw from its seed.
23. the task CLIs (``task_cli``): ``train_ve`` (5 steps, resume to 7),
   ``train_re`` validating every 2 steps (best export and sidecar) and
   ``inf_re --ckpt best`` on two splits, ``train_vcr --tasks qa,qar`` and
   ``inf_vcr`` val and test, ``pretrain_vcr`` (mlm / mrfr / mrc-kl, 6
   steps, resume to 8), all at uniter-base on the card.
24. preprocessing and the flags chain (``prepro``): a 28,996-entry
   ``vocab.txt``, 256 npz dumps (10-100 regions) and raw annotations of
   the six tasks made from a seed (2,048 VQA questions of 6-20 words with
   answers from the in-tree ``ans2label``) through ``python -m
   uniter_tpu_torch.convert_imgdir`` and ``python -m
   uniter_tpu_torch.prepro`` (seven processes at once; record counts and
   meta checked), then ``train_vqa`` at uniter-base with ``--remat
   --param_dtype bfloat16 --fused_adamw 1 --moment_dtype bfloat16
   --wire_codec int8 --dropout_impl u16 --profile_dir`` for 20 steps
   (async saves at 10 and 20; K1-K6 24/12/48/24/2/2 a step, validation's
   K1, K3 and K5 counted apart; a trace of the 6 profiled steps), a resume
   to 25 and ``inf_vqa`` on the fp32 export.
25. the flags (``flags``): the flagship step through K1-K6 under baseline,
   remat, master and remat+master in turns (examples/s, busy ms a step,
   peak memory, launches a step; step-1 losses: remat equal, master within
   1e-3; the remat gradients against the baseline's: the whole
   gradient within 1e-6 relative, beside a second baseline pass), the
   u16/u8 keep fractions of the plain dropout on the card,
   the int8 wire error on the card, adam/adamax 3 steps against float64.
26. data parallelism (``dist``), each run a ``torchrun --standalone``
   launch of this file's ``--dist-worker`` (which calls the entry point's
   ``main``, as ``torchrun -m uniter_tpu_torch.train_vqa`` does) or one
   process without a process group: ``train_vqa`` at uniter-base (bf16,
   dropout 0.1, K1-K6, 20 steps, validate and save at 10 and 20) alone and
   under NCCL at world size 1, replicated and with ``--fsdp
   --fsdp_min_size 65536``, the losses bit for bit equal; examples/s and
   device busy ms a step of each; K1-K6 launches a step; the --fsdp run
   resumed to 25 without --fsdp; the flagship step with and without an
   NCCL group of one in turns; then two ranks sharing the card over gloo:
   5 fp32 steps at dropout 0.1 against one process, replicated and with
   --fsdp (the parameters sharded at rest; every step within 1e-6), each
   rank's parameter and optimizer-state bytes at rest and its peak of
   allocated memory, each rank's K3 mask of a bf16 step bit-equal to its
   block of the one process's, the --fsdp pair resumed at world 1 without
   --fsdp against the one process resumed (1e-5), ``inf_vqa`` at world 2
   writing world 1's answers; the same over NCCL on two cards where the
   host has them. The k2 and tails phases also hold K1-K6 to their plain
   versions at a row base past 2**32, and K1's and K3's masks to
   ``keep_mask`` there bit for bit.
27. the kernels' JSON line, then ``{"ok": true, "device": ...}`` as the
   last line. Any failed check raises and the script exits non-zero.

TF32 is off for matmuls and cuDNN (fp32 runs are full fp32; the fp32
attention kernels split every product three ways on the TF32 tensor
cores, which keeps fp32 accuracy). Files go under the checkout's ``tmp/``
(removed at the end) and ``chiprun_out/``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_QUESTIONS = 2048
TOKEN_BUDGET = 8192  # inf_vqa's --batch_size default
K1_SHAPES = [  # (B, S, H, D): the bucketed eval shapes, uniter-base heads
    (96, 104, 12, 64), (64, 172, 12, 64), (48, 224, 12, 64), (8, 512, 12, 64),
    (96, 104, 16, 64),  # uniter-large heads
]
K1_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
TRAIN_SHAPES = [  # (B, S, H, D): flagship, pretrain mix, retrieval, long
    # buckets, uniter-large heads, and last the largest bucket of the VCR
    # config (max_txt_len 220 -> text bucket 232, gt + detected regions up
    # to 120; 4000 tokens -> 8 rows)
    (96, 104, 12, 64), (48, 224, 12, 64), (120, 128, 12, 64),
    (64, 172, 12, 64), (8, 512, 12, 64), (96, 104, 16, 64),
    (8, 352, 12, 64),
]
K2_TOL_FP32 = 1e-4  # another summation order over S and D
# bf16 K2 against the fp32 formula on the same bf16 inputs, out and LSE:
# 1e-3 + 2^-8 |ref| (one rounding of the result to bf16, half a step, plus
# the hi/lo split's ~2^-16 and fp32 noise)
K2_TOL_BF16 = 1e-3
TIME_TURNS = 3
RATE = 0.1
# (rows, H): the flagship sub-block tail B*S = 96*104, the text and image
# embedding tails 96*64 and 96*40, uniter-large, a ragged row count, a
# width that bf16 rows cannot take 8 at a time (the kernels' 4-wide path)
TAIL_SHAPES = [(9984, 768), (6144, 768), (3840, 768), (9984, 1024),
               (91, 768), (33, 772)]
# (rows, H) -> the tails timed there: K3/K4 at the sub-block tail, K5/K6
# at the text and image embedding tails
TAIL_TIMED = {(9984, 768): ("drop_res_ln_fwd", "drop_res_ln_bwd"),
              (6144, 768): ("ln_drop_fwd", "ln_drop_bwd"),
              (3840, 768): ("ln_drop_fwd", "ln_drop_bwd")}
# (rows, H) of a retrieval scoring tile at inf_itm's defaults (32 x 128
# pairs of 64 text + 100 image tokens): the inference route's K3/K5
# launches there, forward only at rate 0
SCORE_TILE = (32 * 128 * (64 + 100), 768)
# the same tile's FFN intermediate: the in-place GELU's shape
GELU_TILE = (SCORE_TILE[0], 3072)
TAIL_FWD_TOL_FP32 = 1e-5
TAIL_BWD_TOL_FP32 = 1e-4  # dx/dres, as K2's
TAIL_DWDB_REL = 1e-4  # dw/db: sums over rows in another order, of max|ref|
# the card's published peaks (NVIDIA H100 SXM data sheet): the bound of a
# kernel is the larger of its bytes over the memory rate and its operations
# over the peak rate of its type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# matrix products: fp32 at fp32 accuracy runs on the TF32 tensor cores in
# three passes (495 TFLOP/s / 3), the least time the card can take for
# them; the FP32 units' 67 TFLOP/s is printed beside it
PRODUCT_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
OUT_DIR = os.path.join(REPO, "chiprun_out")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


KERNELS = ("mha_fwd", "mha_bwd", "drop_res_ln_fwd", "drop_res_ln_bwd",
           "ln_drop_fwd", "ln_drop_bwd", "ipot", "layer_norm_fwd", "ffn_fwd")
# launches per uniter-base training step of K1-K6 (12 layers, 24 sub-block
# tails, 2 embedding tails); K7-K9 are 0 unless a phase says otherwise
STEP_LAUNCHES = {"mha_fwd": 12, "mha_bwd": 12, "drop_res_ln_fwd": 24,
                 "drop_res_ln_bwd": 24, "ln_drop_fwd": 2, "ln_drop_bwd": 2,
                 "ipot": 0, "layer_norm_fwd": 0, "ffn_fwd": 0}
# (B, N, M): the pretrain-mix bucket, the flagship bucket, the full region
# count (all three in registers), a plan past the register form (form 1: Q
# in shared memory, A in device memory), ragged
K7_SHAPES = [(48, 64, 160), (96, 40, 64), (64, 100, 64), (8, 100, 512),
             (5, 37, 23)]


def _wrappers():
    from uniter_tpu_torch.ops import attention, ffn, fused_block, layer_norm, ot

    out = {n: getattr(attention if n.startswith("mha") else fused_block, n)
           for n in KERNELS[:6]}
    out["ipot"] = ot.ipot_cuda
    out["layer_norm_fwd"] = layer_norm.layer_norm_fwd
    out["ffn_fwd"] = ffn.ffn_fwd
    return out


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches():
    return {n: fn.launches for n, fn in _wrappers().items()}


def device_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = smi.stdout.strip().splitlines()
    check(smi.returncode == 0 and lines, f"nvidia-smi failed: {smi.stderr}")
    print(lines[0])
    print(f"[device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")


def ptxas_report(log):
    """One line per kernel of ``nvcc -Xptxas -v``'s report: its name
    (demangled by ``c++filt`` where the toolkit's host has it), registers,
    barriers and shared memory, and its spills."""
    entries, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m[1], ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            entries.append((name, line.split(":", 1)[-1].strip(), spill))
            name = None
    names = [e[0] for e in entries]
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = [n.replace("(anonymous namespace)::", "")
                     .split("(")[0].removeprefix("void ")
                     for n in out.stdout.splitlines()]
    except OSError:
        pass
    return [f"{n}: {used}; {spill}" for n, (_, used, spill)
            in zip(names, entries)]


def build_phase():
    from uniter_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    logs = _kernels.build(verbose=True)
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        for line in ptxas_report(log):
            print(f"[build] {name}: {line}")
    print(f"[build] sources {sorted(set(_kernels.SOURCES.values()))} "
          f"(kernels {sorted(_kernels.SIGNATURES)}) in {secs:.2f} s "
          f"({len(logs)} compiled)")


def k1_inputs(torch, b, s, h, d, dtype, gen, device="cuda"):
    """q/k/v on the card and a bias with random key lengths; rows 0 and 1
    are all padding, row 0 with a zero query (tests/test_torch_attention.py
    explains why row 1 is held to the fp32 grid bound at -10000)."""
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=device)
               .to(dtype) for _ in range(3))
    q[0] = 0
    lens = torch.randint(1, s + 1, (b,), generator=gen, device=device)
    lens[:2] = 0
    mask = torch.arange(s, device=device)[None, :] < lens[:, None]
    bias = (1.0 - mask.float()) * -10000.0
    return q, k, v, bias


def cuda_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters=50, warmup=5, stream=None):
    """Device time per call (ms): after ``warmup`` calls, ``iters`` calls of
    ``fn`` captured into one CUDA graph, the graph replayed between CUDA
    events, divided by ``iters``. The host's launch path (Python checks,
    allocation, the ctypes call) runs once, at capture, and not in the
    replay, so this is what the card spends; ``cuda_ms`` beside it is the
    call time a step pays when the host is slower than the card. Inputs
    stay the same across the calls, as in ``cuda_ms`` (an input under the
    50 MB L2 may be served from it). ``stream``: the capture stream; an
    autograd backward is captured on the stream its forward ran on."""
    s = stream if stream is not None else torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        for _ in range(iters):
            fn()
    graph.replay()  # the first replay uploads the graph
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(s):
        start.record()
        graph.replay()
        end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def both_ms(torch, fn, stream=None, n_graph=50, n_call=500):
    """(device ms, call ms) of ``fn``: ``graph_ms`` over ``n_graph`` calls,
    then ``cuda_ms`` over ``n_call`` (500 by default: a host-paced time
    wanders between calls of 50)."""
    dev = graph_ms(torch, fn, iters=n_graph, stream=stream)
    warm = max(1, n_call // 10)
    if stream is None:
        return dev, cuda_ms(torch, fn, n_call, warm)
    with torch.cuda.stream(stream):
        return dev, cuda_ms(torch, fn, n_call, warm)


def k1_phase(torch):
    """K1 at rate 0 against ``_mha_torch`` at K1_SHAPES, fp32 (the TF32
    kernel, with its LSE and the LSE's remainder) and bf16; at every shape
    and dtype the device and call times of K1 and of SDPA forward in turns
    kernel, SDPA, SDPA, kernel, and at (96, 104) the plain version's.
    Returns (worst fp32 err, {(shape, dtype): times})."""
    import torch.nn.functional as F

    from uniter_tpu_torch.ops.attention import _mha_torch, mha_fwd

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    timing = {}
    for b, s, h, d in K1_SHAPES:
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            q, k, v, bias = k1_inputs(torch, b, s, h, d, dtype, gen)
            lse = torch.empty(b, h, s, device="cuda")
            lo = torch.empty_like(lse) if name == "float32" else None
            out = mha_fwd(q, k, v, bias, lse=lse, lse_lo=lo)
            torch.cuda.synchronize()
            ref, ref_lse = _mha_torch(q.float(), k.float(), v.float(), bias,
                                      return_lse=True)
            diff = (out.float() - ref).abs()
            tol = K1_TOL[name]
            err = torch.cat([diff[:1], diff[2:]]).max().item()
            grid = diff[1].max().item()
            grid_bound = 2.0 ** -9 * v[1].float().abs().max().item() + tol
            uniform = (out[0].float() - v[0].float().mean(0)).abs().max().item()
            e_lse = excess(lse, ref_lse, 2.0**-20)
            ok = (err <= tol and grid <= grid_bound and uniform <= tol
                  and e_lse <= 1e-5 and bool(torch.isfinite(out).all()))
            extra = ""
            if lo is not None:  # lse + lse_lo against the float64 LSE,
                # row 1 aside (its scores sit on the fp32 grid at -10000)
                exact = _mha_torch(*(t.double() for t in (q, k, v, bias)),
                                   return_lse=True)[1]
                e_lo = (lse.double() + lo.double() - exact).abs()
                e_hi = (lse.double() - exact).abs()
                e_lo, e_hi = (torch.cat([x[:1], x[2:]]).max().item()
                              for x in (e_lo, e_hi))
                ok = ok and e_lo <= 1e-5
                extra = (f"; LSE + remainder against float64 (row 1 aside) "
                         f"{e_lo:.3e} (tol 1e-5; the LSE alone {e_hi:.3e})")
            print(f"[K1] B={b} S={s} H={h} D={d} {name}: max|diff| {err:.3e} "
                  f"(tol {tol:g}); all-padding rows: zero query vs uniform "
                  f"average {uniform:.3e}, random query {grid:.3e} (bound "
                  f"{grid_bound:.3e}); LSE |diff| - 2^-20 |ref| {e_lse:.3e} "
                  f"(tol 1e-5){extra} {'ok' if ok else 'FAIL'}")
            check(ok, f"K1 disagrees with _mha_torch at {(b, s, h, d)} {name}")
            if name == "float32":
                worst = max(worst, err)
            timing[(b, s, h, d, name)] = time_k1(
                torch, F, q, k, v, bias, mha_fwd, _mha_torch,
                plain=(b, s, h) == K1_SHAPES[0][:3])
    return worst, timing


def time_k1(torch, F, q, k, v, bias, mha_fwd, _mha_torch, plain=False):
    """Device and call times (``both_ms``: 20 calls a graph, 50 from
    Python) of K1 at rate 0 writing no LSE (the serving path's call) and of
    ``scaled_dot_product_attention`` forward on [B, H, S, D] copies, in
    TIME_TURNS turns kernel, SDPA, SDPA, kernel; medians. With ``plain``,
    also the plain version's call time."""
    b, s, h, d = q.shape
    dname = str(q.dtype)[6:]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = bias[:, None, None, :].to(q.dtype)

    def sdpa():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, mask)

    fns = {"fwd": lambda: mha_fwd(q, k, v, bias), "sdpa_fwd": sdpa}
    runs = {key: [] for key in fns}
    for _ in range(TIME_TURNS):
        for key in ("fwd", "sdpa_fwd", "sdpa_fwd", "fwd"):
            runs[key].append(both_ms(torch, fns[key], n_graph=20, n_call=50))
    t = {key: tuple(float(np.median([r[i] for r in v])) for i in (0, 1))
         for key, v in runs.items()}
    bms, by = bound_ms(b, s, h, d, dname, False)
    simt = bound_ms(b, s, h, d, dname, False, simt=True)[0]
    line = (f"[K1] times at B={b} S={s} H={h} D={d} {dname}, us device / "
            f"call (median of {TIME_TURNS} turns kernel, SDPA, SDPA, "
            f"kernel): K1 {t['fwd'][0] * 1e3:.1f} / {t['fwd'][1] * 1e3:.1f}, "
            f"SDPA forward {t['sdpa_fwd'][0] * 1e3:.1f} / "
            f"{t['sdpa_fwd'][1] * 1e3:.1f}; bound {bms * 1e3:.1f} ({by}), K1 "
            f"{bms / t['fwd'][0] * 100:.1f}% of it")
    if dname == "float32":
        line += (f"; with fp32 products at the FP32 units' 67 TFLOP/s the "
                 f"bound would read {simt * 1e3:.1f}")
    if plain:
        t["plain"] = cuda_ms(torch, lambda: _mha_torch(q, k, v, bias), 20, 3)
        line += f"; plain version's call {t['plain'] * 1e3:.1f}"
    print(line)
    return t


def bound_ms(b, s, h, d, dtype, backward, simt=False):
    """Least time for the function on this card: K1 reads q, k, v and
    writes out (4 tensors) and does 4*B*H*S^2*D FLOP; K2 reads q, k, v, g
    and writes dq, dk, dv (7 tensors) and does 10*B*H*S^2*D FLOP (the
    scores, dV, dP, dQ, dK), at PRODUCT_FLOPS (fp32: three TF32 passes;
    ``simt``: the FP32 units' rate instead, for comparison). K2 also reads
    out and the LSE, its own design's choice, not counted here."""
    elem = b * s * h * d * (4 if dtype == "float32" else 2)
    nbytes = (7 if backward else 4) * elem + b * s * 4  # + the fp32 bias
    flops = (10 if backward else 4) * b * h * s * s * d
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / (PEAK_FLOPS if simt else PRODUCT_FLOPS)[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def train_inputs(torch, b, s, h, d, dtype, gen):
    """q/k/v/g on the card; random key lengths with every row but row 0
    holding a valid key; row 0 all padding with a zero query (exactly
    -10000 scores; a random query there sits on the fp32 grid at -10000,
    see tests/test_torch_attention.py)."""
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                  .to(dtype) for _ in range(4))
    q[0] = 0
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[0] = 0
    mask = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    return q, k, v, (1.0 - mask.float()) * -10000.0, g


def keep_fraction(torch, mha_fwd, b, s, h, d):
    """The keep fraction at RATE measured through K1: with q = k = 0 and no
    padding P is uniform, so with v = 1 every output entry is the row's
    kept count / (S (1 - rate))."""
    z = torch.zeros(b, s, h, d, device="cuda")
    out = mha_fwd(z, z, torch.ones_like(z), torch.zeros(b, s, device="cuda"),
                  RATE, 4242)
    return out[..., 0].double().mean().item() * (1.0 - RATE)


def excess(x, ref, rel):
    """max(|x - ref| - rel |ref|): the absolute part of a tolerance
    ``atol + rel |ref|`` that x uses."""
    return ((x.float() - ref).abs() - rel * ref.abs()).max().item()


def _demangle(name):
    try:
        name = subprocess.run(["c++filt", name], capture_output=True,
                              text=True, timeout=60).stdout.strip() or name
    except OSError:
        pass
    return name.replace("(anonymous namespace)::", "").split("(")[0] \
        .removeprefix("void ")


def sass_phase(torch):
    """``cuobjdump -sass`` of the attention libraries and of K9's: the
    kernels must run on the tensor cores (HMMA instructions for
    ``mma.sync``, counted per fp32 instantiation as TF32 HMMA, each of
    which must have some; HGMMA for K9's ``wgmma``); ``cuobjdump
    -res-usage``: registers, stack (spills) and static shared memory of the
    fp32 attention instantiations and of every K9 instance, with the
    dynamic shared memory a launch asks for."""
    from uniter_tpu_torch.ops import _kernels
    from uniter_tpu_torch.ops.attention import SMEM_LIMIT, _bwd_smem

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts, tf32 = {}, {}
    for name, op in (("mha_fwd", "HMMA"), ("mha_bwd", "HMMA"),
                     ("ffn", "HGMMA")):
        res = subprocess.run([tool, "-sass", _kernels._paths(name)[1]],
                             capture_output=True, text=True, timeout=120)
        check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-500:]}")
        counts[name] = sum(op in line for line in res.stdout.splitlines())
        fn = None
        for line in res.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = _demangle(m[1])
                if "tf32" in fn:
                    tf32[fn] = 0
            elif fn in tf32 and "HMMA" in line and "TF32" in line:
                tf32[fn] += 1
    print(f"[sass] HMMA instructions: libmha_fwd.so {counts['mha_fwd']}, "
          f"libmha_bwd.so {counts['mha_bwd']}; HGMMA (wgmma) instructions: "
          f"libffn.so {counts['ffn']}")
    print("[sass] TF32 HMMA (mma.sync m16n8k8) in the fp32 attention "
          "kernels: " + "; ".join(f"{n} {c}" for n, c in tf32.items()))
    check(all(counts.values()), "no tensor-core instructions in the "
          "attention or FFN libraries")
    check(len(tf32) == 8 and all(tf32.values()),
          f"an fp32 attention instantiation without TF32 HMMA: {tf32}")
    for lib in ("mha_fwd", "mha_bwd", "ffn"):
        res = subprocess.run([tool, "-res-usage", _kernels._paths(lib)[1]],
                             capture_output=True, text=True, timeout=120)
        check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-500:]}")
        lines = res.stdout.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Function ([^:\s]+):", line)
            if m and i + 1 < len(lines) and ("ffn" in m[1] or "tf32" in m[1]):
                label = "K9" if lib == "ffn" else ("K1" if lib == "mha_fwd"
                                                   else "K2")
                name, usage = _demangle(m[1]), lines[i + 1].strip()
                extra = ""
                if label != "K9":  # blocks an SM at S = 104: shared memory
                    # (228 KB an SM, 1 KB reserved a block) and registers
                    dp = int(re.search(r"<(\d+)>", name)[1])
                    regs = int(re.search(r"REG:(\d+)", usage)[1])
                    shared = (5 * 64 * (dp + 4) * 4 if label == "K1"
                              else _bwd_smem(104, dp, torch.float32))
                    fit = min(228 * 1024 // (shared + 1024),
                              65536 // (regs * 128))
                    extra = f"; {shared} B shared at S = 104, {fit} blocks an SM"
                print(f"[sass] {label} {name}: {usage}{extra}")
    smem = _kernels.entry("ffn_smem_bytes")
    print("[sass] K9 dynamic shared memory a launch asks for (bytes): "
          + "; ".join(f"D_in = D_out = {h} {d}: {smem(h, h, c)}"
                      for h in (768, 1024)
                      for d, c in (("bf16", 1), ("fp32", 0))))
    print("[sass] fp32 attention dynamic shared memory a block asks for "
          "(bytes): K1 " + ", ".join(f"D {d}: {5 * 64 * (d + 4) * 4}"
                                     for d in (64, 128))
          + "; K2 at D 64 " + ", ".join(
              f"S {s}: {_bwd_smem(s, 64, torch.float32)}"
              for s in (104, 224, 512))
          + f" (dQ in device memory; at most {SMEM_LIMIT})")
    k7_resources(tool)
    return counts


def k7_resources(tool):
    """``cuobjdump -res-usage`` of K7's instantiations: registers, stack and
    local memory; the register form (A and Q in registers) must not spill."""
    from uniter_tpu_torch.ops import _kernels

    res = subprocess.run([tool, "-res-usage", _kernels._paths("ipot")[1]],
                         capture_output=True, text=True, timeout=120)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-500:]}")
    lines, usage = res.stdout.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Function ([^:\s]+):", line)
        if m and "ipot" in m[1] and i + 1 < len(lines):
            usage[_demangle(m[1])] = lines[i + 1].strip()
    for name, use in usage.items():
        print(f"[sass] K7 {name}: {use}")
    reg = {n: u for n, u in usage.items() if "ipot_reg_kernel" in n}
    check(len(reg) == 4 and all(
        re.search(r"STACK:0\b", u) and re.search(r"LOCAL:0\b", u)
        for u in reg.values()), f"K7's register form spills: {reg}")


def k2_phase(torch):
    """K1 and K2 at rates 0 and RATE against their plain versions at every
    training shape, both dtypes: bf16 through the tensor-core kernels (K1
    with its LSE and output remainder, K2 from K1's out, out_lo and LSE,
    held to ``_mha_bwd_lse_torch`` and to the JAX kernel's formula
    ``_mha_bwd_torch``, both at K2_TOL_BF16 + 2^-8 |ref|), fp32 through the
    SIMT kernels; bitwise replay of the bf16 pair; times at every shape.
    Returns (worst fp32 errors, worst bf16 excess, timing, keep fraction)."""
    import torch.nn.functional as F

    from uniter_tpu_torch.ops.attention import (
        _mha_bwd_lse_torch, _mha_bwd_torch, _mha_torch, mha_bwd, mha_fwd)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = {"mha_fwd": 0.0, "mha_bwd": 0.0}
    worst_bf16 = {"mha_fwd": -1.0, "mha_bwd": -1.0, "mha_bwd_jax": -1.0,
                  "lse": -1.0, "coarse_di": -1.0, "mha_fwd_abs": 0.0,
                  "mha_bwd_abs": 0.0}
    timing = {}
    for b, s, h, d in TRAIN_SHAPES:
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            q, k, v, bias, g = train_inputs(torch, b, s, h, d, dtype, gen)
            qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
            if name == "float32":
                e1, el, e2, e3, same = [], [], [], [], True
                for rate in (0.0, RATE):
                    lse, lo = (torch.empty(b, h, s, device="cuda")
                               for _ in range(2))
                    out = mha_fwd(q, k, v, bias, rate, 99, lse=lse, lse_lo=lo)
                    ref, rlse = _mha_torch(q, k, v, bias, rate, 99,
                                           return_lse=True)
                    e1.append((out - ref).abs().max().item())
                    el.append(excess(lse, rlse, 2.0**-20))
                    got = mha_bwd(q, k, v, bias, g, rate, 99, out=out,
                                  lse=lse, lse_lo=lo)
                    want = _mha_bwd_lse_torch(q, k, v, bias, g, out, lse,
                                              rate, 99, lse_lo=lo)
                    jax_formula = _mha_bwd_torch(q, k, v, bias, g, rate, 99)
                    e2.append(max((x - w).abs().max().item()
                                  for x, w in zip(got, want)))
                    e3.append(max((x - w).abs().max().item()
                                  for x, w in zip(got, jax_formula)))
                    lse2, lo2 = torch.empty_like(lse), torch.empty_like(lo)
                    again = mha_fwd(q, k, v, bias, rate, 99, lse=lse2,
                                    lse_lo=lo2)
                    same = same and torch.equal(out, again) and \
                        torch.equal(lse, lse2) and torch.equal(lo, lo2) and \
                        all(torch.equal(x, y) for x, y in zip(
                            got, mha_bwd(q, k, v, bias, g, rate, 99, out=out,
                                         lse=lse, lse_lo=lo)))
                    same = same and all(bool(torch.isfinite(t).all())
                                        for t in (out, lse, lo, *got))
                torch.cuda.synchronize()
                ok = (max(e1) <= K1_TOL[name] and max(el) <= 1e-5
                      and max(e2) <= K2_TOL_FP32 and max(e3) <= K2_TOL_FP32
                      and same)
                print(f"[K2] B={b} S={s} H={h} D={d} float32 (TF32 tensor "
                      f"cores, three passes): K1 max|diff| rate 0 "
                      f"{e1[0]:.3e}, rate {RATE} {e1[1]:.3e} (tol "
                      f"{K1_TOL[name]:g}); LSE |diff| - 2^-20 |ref| "
                      f"{max(el):.3e} (tol 1e-5); K2 dq/dk/dv max|diff| vs "
                      f"_mha_bwd_lse_torch rate 0 {e2[0]:.3e}, rate {RATE} "
                      f"{e2[1]:.3e}; vs _mha_bwd_torch (the JAX kernel's "
                      f"formula) rate 0 {e3[0]:.3e}, rate {RATE} {e3[1]:.3e}"
                      f" (tol {K2_TOL_FP32:g}); replay bitwise and finite "
                      f"{same} {'ok' if ok else 'FAIL'}")
                check(ok, f"fp32 K1/K2 disagree or do not replay at "
                          f"{(b, s, h, d)}")
                worst["mha_fwd"] = max(worst["mha_fwd"], max(e1))
                worst["mha_bwd"] = max(worst["mha_bwd"], max(e2 + e3))
            else:
                e1, el, elo, e2, e3, e4, same = [], [], [], [], [], [], True
                for rate in (0.0, RATE):
                    lse = torch.empty(b, h, s, device="cuda")
                    lo = torch.empty_like(q)
                    out = mha_fwd(q, k, v, bias, rate, 99, lse=lse,
                                  out_lo=lo)
                    ref, rlse = _mha_torch(qf, kf, vf, bias, rate, 99,
                                           return_lse=True)
                    full = out.float() + lo.float()
                    e1.append(excess(out, ref, 2.0**-8))
                    abs1 = (out.float() - ref).abs().max().item()
                    elo.append((full - ref).abs().max().item())
                    el.append(excess(lse, rlse, 2.0**-20))
                    got = mha_bwd(q, k, v, bias, g, rate, 99, out=out,
                                  lse=lse, out_lo=lo)
                    want = _mha_bwd_lse_torch(qf, kf, vf, bias, gf, full,
                                              lse, rate, 99)
                    jax_formula = _mha_bwd_torch(qf, kf, vf, bias, gf, rate,
                                                 99)
                    e2.append(max(excess(x, w, 2.0**-8)
                                  for x, w in zip(got, want)))
                    abs2 = max((x.float() - w).abs().max().item()
                               for x, w in zip(got, want))
                    worst_bf16["mha_fwd_abs"] = max(worst_bf16["mha_fwd_abs"],
                                                    abs1)
                    worst_bf16["mha_bwd_abs"] = max(worst_bf16["mha_bwd_abs"],
                                                    abs2)
                    e3.append(max(excess(x, w, 2.0**-8)
                                  for x, w in zip(got, jax_formula)))
                    # what the out_lo remainder is for: Di from the bf16
                    # output alone, through the plain formula (not used)
                    coarse = _mha_bwd_lse_torch(qf, kf, vf, bias, gf,
                                                out.float(), lse, rate, 99)
                    e4.append(max(excess(x.bfloat16(), w, 2.0**-8)
                                  for x, w in zip(coarse, jax_formula)))
                    lse2, lo2 = torch.empty_like(lse), torch.empty_like(lo)
                    again = mha_fwd(q, k, v, bias, rate, 99, lse=lse2,
                                    out_lo=lo2)
                    same = same and torch.equal(out, again) and \
                        torch.equal(lse, lse2) and torch.equal(lo, lo2) and \
                        all(torch.equal(x, y) for x, y in zip(
                            got, mha_bwd(q, k, v, bias, g, rate, 99,
                                         out=out, lse=lse, out_lo=lo)))
                    same = same and all(bool(torch.isfinite(t).all())
                                        for t in (out, lse, lo, *got))
                torch.cuda.synchronize()
                ok = (max(e1) <= K1_TOL[name] and max(el) <= 1e-5
                      and max(e2) <= K2_TOL_BF16 and max(e3) <= K2_TOL_BF16
                      and same)
                print(f"[K2] B={b} S={s} H={h} D={d} bfloat16 (tensor "
                      f"cores): K1 |diff| - 2^-8 |ref| rate 0 {e1[0]:.3e}, "
                      f"rate {RATE} {e1[1]:.3e} (tol {K1_TOL[name]:g}, "
                      f"margin {K1_TOL[name] - max(e1):.3e}); out + out_lo "
                      f"max|diff| {max(elo):.3e}; LSE |diff| - "
                      f"2^-20 |ref| {max(el):.3e} (tol 1e-5); K2 vs "
                      f"_mha_bwd_lse_torch rate 0 {e2[0]:.3e}, rate {RATE} "
                      f"{e2[1]:.3e} (tol {K2_TOL_BF16:g} + 2^-8 |ref|, margin "
                      f"{K2_TOL_BF16 - max(e2):.3e}); K2 vs _mha_bwd_torch "
                      f"(the JAX kernel's formula, Di from P) rate 0 "
                      f"{e3[0]:.3e}, rate {RATE} {e3[1]:.3e} (same tol, "
                      f"margin {K2_TOL_BF16 - max(e3):.3e}); with Di from "
                      f"the bf16 output alone it would be {max(e4):.3e}; "
                      f"replay bitwise "
                      f"and finite {same} {'ok' if ok else 'FAIL'}")
                check(ok, f"bf16 K1/K2 disagree or do not replay at "
                          f"{(b, s, h, d)}")
                for key, val in (("mha_fwd", max(e1)), ("mha_bwd", max(e2)),
                                 ("mha_bwd_jax", max(e3)), ("lse", max(el)),
                                 ("coarse_di", max(e4))):
                    worst_bf16[key] = max(worst_bf16[key], val)
            timing[(b, s, h, d, name)] = time_attention(
                torch, F, q, k, v, bias, g, mha_fwd, mha_bwd,
                _mha_torch, _mha_bwd_torch,
                plain=(b, s, h, d) == TRAIN_SHAPES[0])
    frac = keep_fraction(torch, mha_fwd, 96, 104, 12, 64)
    n = 96 * 12 * 104 * 104
    sigma = (RATE * (1 - RATE) / n) ** 0.5
    print(f"[K2] keep fraction through K1 at rate {RATE} over {n} scores: "
          f"{frac:.6f} (want {1 - RATE} +- 4 sigma = {4 * sigma:.1e})")
    check(abs(frac - (1 - RATE)) <= 4 * sigma, "keep fraction")
    print(f"[K2] worst bf16 over {len(TRAIN_SHAPES)} shapes x 2 rates: K1 "
          f"{worst_bf16['mha_fwd']:.3e} of {K1_TOL['bfloat16']:g} (+ 2^-8 "
          f"|ref|), K2 {worst_bf16['mha_bwd']:.3e} of {K2_TOL_BF16:g} (+ 2^-8 "
          f"|ref|), K2 against the JAX kernel's formula "
          f"{worst_bf16['mha_bwd_jax']:.3e} (with Di from the bf16 output "
          f"alone {worst_bf16['coarse_di']:.3e}), LSE "
          f"{worst_bf16['lse']:.3e}")
    attention_row_base(torch, gen)
    return worst, worst_bf16, timing, frac


def attention_row_base(torch, gen):
    """K1 and K2 at ``ROW_BASE`` (a rank's b0 * H * S): at the flagship
    shape, both dtypes, rate RATE, against the plain versions at that
    base; and K1's mask itself against ``keep_mask`` at that base, bit for
    bit: with q = k = 0 and no padding P is uniform, and with v one-hot
    over the head dim (D = S = 64) output (b, q, h, k) is positive exactly
    where score (b, h, q, k) was kept. Then the same at a tensor-parallel
    rank's heads (``HEAD_OFFSETS``: heads ``head0``... of ``heads_total``,
    as views of the whole q/k/v) at that base, and K1's mask there
    against ``keep_mask``'s head block of the whole [B, heads_total, S, S]
    mask."""
    from uniter_tpu_torch.ops.attention import (
        _mha_bwd_lse_torch, _mha_torch, mha_bwd, mha_fwd)
    from uniter_tpu_torch.ops.dropout import keep_mask

    b, s, h, d = TRAIN_SHAPES[0]
    for heads_total, head0, n in [(h, 0, h)] + HEAD_OFFSETS:
        rb = dict(row_base=ROW_BASE)
        if n != heads_total:
            rb.update(heads_total=heads_total, head0=head0)
        where = (f"heads {head0}..{head0 + n - 1} of {heads_total}"
                 if n != heads_total else "")
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            q, k, v, bias, g = train_inputs(torch, b, s, heads_total, d,
                                            dtype, gen)
            blk = (slice(None), slice(None), slice(head0, head0 + n))
            q, k, v, g = (x[blk] for x in (q, k, v, g))
            qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
            lse = torch.empty(b, n, s, device="cuda")
            lo = (torch.empty_like(lse) if name == "float32"
                  else torch.empty(b, s, n, d, device="cuda", dtype=dtype))
            key = "lse_lo" if name == "float32" else "out_lo"
            out = mha_fwd(q, k, v, bias, RATE, 99, lse=lse, **{key: lo},
                          **rb)
            ref = _mha_torch(qf, kf, vf, bias, RATE, 99, **rb)
            got = mha_bwd(q, k, v, bias, g, RATE, 99, out=out, lse=lse,
                          **{key: lo}, **rb)
            full = out.float() + (lo.float() if name == "bfloat16" else 0.0)
            want = _mha_bwd_lse_torch(
                qf, kf, vf, bias, gf, full, lse, RATE, 99,
                lse_lo=lo if name == "float32" else None, **rb)
            if name == "float32":
                e1 = (out - ref).abs().max().item()
                e2 = max((x - w).abs().max().item()
                         for x, w in zip(got, want))
                ok = e1 <= K1_TOL[name] and e2 <= K2_TOL_FP32
            else:
                e1 = excess(out, ref, 2.0**-8)
                e2 = max(excess(x, w, 2.0**-8) for x, w in zip(got, want))
                ok = e1 <= K1_TOL[name] and e2 <= K2_TOL_BF16
            print(f"[K2] B={b} S={s} H={n} D={d} {name} rate {RATE} at row "
                  f"base {ROW_BASE} {where}: K1 {e1:.3e}, K2 {e2:.3e} "
                  f"against the plain versions at those arguments "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"K1/K2 at row base {ROW_BASE} {where} ({name})")
            z = torch.zeros(2, 64, n, 64, device="cuda", dtype=dtype)
            onehot = torch.eye(64, device="cuda", dtype=dtype)[
                None, :, None, :]
            kept = mha_fwd(z, z, onehot.expand(2, 64, n, 64).contiguous(),
                           torch.zeros(2, 64, device="cuda"), RATE, 4242,
                           **rb).permute(0, 2, 1, 3) > 0
            mask = keep_mask(4242, 0, (2, heads_total, 64, 64), RATE,
                             "cuda", row_base=ROW_BASE)[:, head0:head0 + n]
            same = torch.equal(kept, mask)
            print(f"[K2] K1's mask ({name}) at row base {ROW_BASE} {where} "
                  f"equal to keep_mask's at that base bit for bit: {same}")
            check(same, f"K1's mask at a row base {where} ({name})")


def time_attention(torch, F, q, k, v, bias, g, mha_fwd, mha_bwd, _mha_torch,
                   _mha_bwd_torch, plain=False):
    """Device and call times (``both_ms``: 20 calls a graph, 50 from
    Python; ms per call) of K1 (writing the LSE, as training calls it) and
    K2 at rate 0 against ``scaled_dot_product_attention`` forward and
    backward (the float bias as attn_mask on [B, H, S, D] copies, its
    layout), in ``TIME_TURNS`` turns of kernel, SDPA, SDPA, kernel;
    medians, with the bounds. bf16 times the pair from K1's out, LSE and
    output remainder, fp32 from K1's out, LSE and LSE remainder. With
    ``plain``, also K1 and K2 at RATE and the plain versions at both rates
    (call times, turns plain, kernel, kernel, plain)."""
    b, s, h, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    dname = str(q.dtype)[6:]
    lse = torch.empty(b, h, s, device="cuda")
    lo = torch.empty_like(q) if bf16 else torch.empty_like(lse)
    key = "out_lo" if bf16 else "lse_lo"
    out = mha_fwd(q, k, v, bias, 0.0, 5, lse=lse, **{key: lo})
    extra = {"out": out, "lse": lse, key: lo}
    side = torch.cuda.Stream()  # SDPA's backward is captured on its stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        mask = bias[:, None, None, :].to(q.dtype)
        gt = g.transpose(1, 2).contiguous()
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, mask)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, mask)

    fns = {"fwd": (lambda: mha_fwd(q, k, v, bias, 0.0, 5, lse=lse,
                                   **{key: lo}), None),
           "bwd": (lambda: mha_bwd(q, k, v, bias, g, 0.0, 5, **extra), None),
           "sdpa_fwd": (sdpa_fwd, None),
           "sdpa_bwd": (lambda: torch.autograd.grad(
               sdpa_out, (qt, kt, vt), gt, retain_graph=True), side)}
    runs = {name: [] for name in fns}
    for _ in range(TIME_TURNS):
        for kern, lib in (("fwd", "sdpa_fwd"), ("bwd", "sdpa_bwd")):
            for name in (kern, lib, lib, kern):
                fn, st = fns[name]
                runs[name].append(both_ms(torch, fn, stream=st, n_graph=20,
                                          n_call=50))
    torch.cuda.synchronize()
    t = {name: float(np.median([r[1] for r in v])) for name, v in runs.items()}
    t.update({f"{name}_dev": float(np.median([r[0] for r in v]))
              for name, v in runs.items()})
    t["turns"] = runs
    bf, byf = bound_ms(b, s, h, d, dname, False)
    bb, byb = bound_ms(b, s, h, d, dname, True)
    line = (f"[K2] times at B={b} S={s} H={h} D={d} {dname}, us device / "
            f"call (median of {TIME_TURNS} turns kernel, SDPA, SDPA, "
            f"kernel): K1 {t['fwd_dev'] * 1e3:.1f} / {t['fwd'] * 1e3:.1f} "
            f"(bound {bf * 1e3:.1f}, {byf}; {bf / t['fwd_dev'] * 100:.1f}%), "
            f"SDPA forward {t['sdpa_fwd_dev'] * 1e3:.1f} / "
            f"{t['sdpa_fwd'] * 1e3:.1f}; K2 {t['bwd_dev'] * 1e3:.1f} / "
            f"{t['bwd'] * 1e3:.1f} (bound {bb * 1e3:.1f}, {byb}; "
            f"{bb / t['bwd_dev'] * 100:.1f}%), SDPA backward "
            f"{t['sdpa_bwd_dev'] * 1e3:.1f} / {t['sdpa_bwd'] * 1e3:.1f} (SDPA "
            f"backward device turns "
            f"{', '.join(f'{x[0] * 1e3:.1f}' for x in runs['sdpa_bwd'])})")
    if not bf16:
        simt = [bound_ms(b, s, h, d, dname, bwd, simt=True)[0] * 1e3
                for bwd in (False, True)]
        line += (f"; at the FP32 units' 67 TFLOP/s the bounds would read "
                 f"{simt[0]:.1f} and {simt[1]:.1f}")
    print(line)
    if not plain:
        return t
    for rate in (0.0, RATE):
        lse_r = torch.empty(b, h, s, device="cuda")
        lo_r = torch.empty_like(lo)
        out_r = mha_fwd(q, k, v, bias, rate, 5, lse=lse_r, **{key: lo_r})
        ex = {"out": out_r, "lse": lse_r, key: lo_r}
        f = [cuda_ms(torch, lambda: _mha_torch(q, k, v, bias, rate, 5)),
             cuda_ms(torch, lambda: mha_fwd(q, k, v, bias, rate, 5,
                                            lse=lse_r, **{key: lo_r})),
             cuda_ms(torch, lambda: mha_fwd(q, k, v, bias, rate, 5,
                                            lse=lse_r, **{key: lo_r})),
             cuda_ms(torch, lambda: _mha_torch(q, k, v, bias, rate, 5))]
        bw = [cuda_ms(torch, lambda: _mha_bwd_torch(q, k, v, bias, g, rate, 5)),
              cuda_ms(torch, lambda: mha_bwd(q, k, v, bias, g, rate, 5, **ex)),
              cuda_ms(torch, lambda: mha_bwd(q, k, v, bias, g, rate, 5, **ex)),
              cuda_ms(torch, lambda: _mha_bwd_torch(q, k, v, bias, g, rate,
                                                    5))]
        t[rate] = {"fwd": (f[1] + f[2]) / 2, "fwd_plain": (f[0] + f[3]) / 2,
                   "bwd": (bw[1] + bw[2]) / 2,
                   "bwd_plain": (bw[0] + bw[3]) / 2}
        print(f"[K2]   rate {rate} (50 calls, turns plain, kernel, kernel, "
              f"plain): K1 {t[rate]['fwd'] * 1e3:.1f} vs plain "
              f"{t[rate]['fwd_plain'] * 1e3:.1f}; K2 {t[rate]['bwd'] * 1e3:.1f}"
              f" vs plain {t[rate]['bwd_plain'] * 1e3:.1f}")
    return t


def sdpa_fp32_probe(torch):
    """Which kernels ``scaled_dot_product_attention`` launches for fp32 at
    the flagship shape (forward and backward, from a profile), and its
    forward's error against ``_mha_torch``: the yardstick's own numerics."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from uniter_tpu_torch.ops.attention import _mha_torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    q, k, v, bias, g = train_inputs(torch, *TRAIN_SHAPES[0], torch.float32,
                                    gen)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    mask = bias[:, None, None, :]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = F.scaled_dot_product_attention(qt, kt, vt, mask)
        out.backward(g.transpose(1, 2).contiguous())
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA})
    ref = _mha_torch(q, k, v, bias)
    err = (out.detach().transpose(1, 2) - ref).abs()
    print(f"[K2] SDPA fp32 at {TRAIN_SHAPES[0]} launches: "
          + "; ".join(n[:100] for n in names)
          + f"; its forward against _mha_torch: max|diff| "
          f"{torch.cat([err[:1], err[1:]]).max().item():.3e} (all-padding "
          f"row 0 {err[0].max().item():.3e}, the rest "
          f"{err[1:].max().item():.3e})")
    return names


def k2_groups_phase(torch):
    """The fp32 K2 at TRAIN_SHAPES through its C entry with every split of
    the key tiles into equal groups (blocks per (b, h)), call times (min of
    3 runs of 20 calls) and the difference from one group; marks the split
    ``_key_groups`` picks. The evidence for that policy."""
    from uniter_tpu_torch.ops import _kernels
    from uniter_tpu_torch.ops.attention import (_dq_pitch, _key_groups,
                                                _sm_count, mha_fwd)

    fn = _kernels.entry("mha_bwd")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    sms = _sm_count(torch.cuda.current_device())
    for b, s, h, d in TRAIN_SHAPES:
        q, k, v, bias, g = train_inputs(torch, b, s, h, d, torch.float32, gen)
        lse, lo = (torch.empty(b, h, s, device="cuda") for _ in range(2))
        out = mha_fwd(q, k, v, bias, lse=lse, lse_lo=lo)
        tiles, ref, res = -(-s // 64), None, []
        for groups in (n for n in range(1, tiles + 1) if tiles % n == 0):
            scratch = torch.empty((groups, b * h, tiles * 64,
                                   _dq_pitch(d, torch.float32)),
                                  device="cuda")
            grads = [torch.empty_like(q) for _ in range(3)]

            def call():
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), None, lse.data_ptr(),
                        lo.data_ptr(), *(t.data_ptr() for t in grads),
                        scratch.data_ptr(), b, s, h, d, *q.stride()[:3],
                        *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
                        1.0 / d ** 0.5, 0, 1.0, 5, 0, groups,
                        torch.cuda.current_stream().cuda_stream)
                check(rc == 0, f"K2 with {groups} groups: cudaError_t {rc}")

            call()
            torch.cuda.synchronize()
            ref = ref or [t.clone() for t in grads]
            diff = max((x - y).abs().max().item() for x, y in zip(grads, ref))
            ms = min(cuda_ms(torch, call, 20, 3) for _ in range(3))
            res.append(f"{groups} group(s) {ms * 1e3:.1f} us (max|diff| from "
                       f"one group {diff:.1e})")
        print(f"[K2] fp32 key-tile groups at B={b} S={s} H={h} D={d} "
              f"({b * h} (b, h) pairs, {sms} SMs): " + "; ".join(res)
              + f"; _key_groups picks {_key_groups(b * h, s, sms)}")


def tail_bound_ms(name, rows, h, dtype):
    """Least time for a fused tail on this card: the bytes it must move
    (each activation read once, each output written once, w/b and dw/db
    fp32) over 3.35 TB/s against its fp32 operations (about 8, 16, 7 and
    13 per element for K3-K6, the Philox integer work left out) over 67
    TFLOP/s. Returns (ms, "bytes" or "operations")."""
    elem = rows * h * (4 if dtype == "float32" else 2)
    acts, vecs, flop = {"drop_res_ln_fwd": (3, 2, 8),
                        "drop_res_ln_bwd": (5, 3, 16),
                        "ln_drop_fwd": (2, 2, 7),
                        "ln_drop_bwd": (3, 3, 13)}[name]
    by_bytes = (acts * elem + vecs * h * 4) / HBM_BYTES_PER_S * 1e3
    by_ops = flop * rows * h / PEAK_FLOPS["float32"] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def tail_errors(torch, fb, x, res, w, b, g, rate, seed, row_base=0):
    """Each kernel's outputs against its plain version on the fp32 copies
    of the same inputs, masks drawn at ``row_base``. Returns {kernel:
    (worst abs err over its outputs, worst excess over its bound, worst
    dw/db err / max|ref|, worst abs err of its activations)}."""
    kw = dict(row_base=row_base)
    bf16 = x.dtype == torch.bfloat16
    xf, rf, gf = x.float(), res.float(), g.float()

    def act(got, want, tol):
        d = (got.float() - want).abs()
        excess = d - (2.0**-8 * want.abs() + 1e-3 if bf16 else tol)
        return d.max().item(), excess.max().item()

    def vec(got, want):
        d = (got - want).abs().max().item()
        return d, d / max(want.abs().max().item(), 1e-30)

    out = {}
    y = fb.drop_res_ln_fwd(x, res, w, b, rate, seed, **kw)
    e = act(y, fb._drop_res_ln_torch(xf, rf, w, b, rate, seed, **kw),
            TAIL_FWD_TOL_FP32)
    out["drop_res_ln_fwd"] = (*e, 0.0, e[0])
    y = fb.ln_drop_fwd(x, w, b, rate, seed, **kw)
    e = act(y, fb._ln_drop_torch(xf, w, b, rate, seed, **kw),
            TAIL_FWD_TOL_FP32)
    out["ln_drop_fwd"] = (*e, 0.0, e[0])
    for name, got, want, n_act in (
            ("drop_res_ln_bwd",
             fb.drop_res_ln_bwd(x, res, w, g, rate, seed, **kw),
             fb._drop_res_ln_bwd_torch(xf, rf, w, gf, rate, seed, **kw), 2),
            ("ln_drop_bwd", fb.ln_drop_bwd(x, w, g, rate, seed, **kw),
             fb._ln_drop_bwd_torch(xf, w, gf, rate, seed, **kw), 1)):
        errs = [act(a, r, TAIL_BWD_TOL_FP32)
                for a, r in zip(got[:n_act], want[:n_act])]
        vecs = [vec(a, r) for a, r in zip(got[n_act:], want[n_act:])]
        out[name] = (max(e[0] for e in errs + vecs),
                     max(e[1] for e in errs), max(v[1] for v in vecs),
                     max(e[0] for e in errs))
    torch.cuda.synchronize()
    return out


def tail_tree(torch, fb, x, res, w, g, rate):
    """K4's and K6's dw/db against ``_sum_partials_torch`` (the kernels'
    fixed-order sum, in torch) of their own per-block partials, and
    against a second launch. Returns {kernel: (equal to the torch sum,
    equal on replay, blocks)}."""
    out = {}
    for name, r in (("drop_res_ln_bwd", res), ("ln_drop_bwd", None)):
        _, _, part, dwdb = fb._tail_bwd(x, r, w, g, rate, 31, 1e-12)
        again = fb._tail_bwd(x, r, w, g, rate, 31, 1e-12)[3]
        out[name] = (torch.equal(dwdb, fb._sum_partials_torch(part)),
                     torch.equal(dwdb, again), part.shape[1])
    return out


def launch_path(torch, fb):
    """Host time of a launch, us per call (the host clock over 2,000 calls
    after 200, the card synchronised every 100): the K5, K8 and K9 wrappers
    and ``F.layer_norm`` at widths where the card is faster than the host
    ((8, 768) bf16; K9 at (8, 64) -> 256 -> 64), and the wrappers' parts."""
    import torch.nn.functional as F

    from uniter_tpu_torch.ops import _kernels, ffn, layer_norm as ln

    x = torch.randn(8, 768, device="cuda").bfloat16()
    w, b = torch.ones(768, device="cuda"), torch.zeros(768, device="cuda")
    wl, bl = w.bfloat16(), b.bfloat16()
    dev = x.device
    grid = _kernels.entry("tail_bwd_grid")
    fx = torch.randn(8, 64, device="cuda").bfloat16()
    fw1 = (0.1 * torch.randn(256, 64, device="cuda")).bfloat16()
    fw2 = (0.1 * torch.randn(64, 256, device="cuda")).bfloat16()
    fb1, fb2 = torch.zeros(256, device="cuda"), torch.zeros(64, device="cuda")
    fy = torch.empty(8, 64, device="cuda").bfloat16()
    packed = ffn._CALL.pack(fx.data_ptr(), fw1.data_ptr(), fb1.data_ptr(),
                            fw2.data_ptr(), fb2.data_ptr(), fy.data_ptr(), 8,
                            64, 256, 64, 1, dev.index, 0,
                            torch._C._cuda_getCurrentRawStream(dev.index))
    k9_entry = _kernels.entry("ffn_fwd")

    def host_us(fn, n=2000):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn()
            if i % 100 == 99:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    parts = {
        "K5 wrapper": lambda: fb.ln_drop_fwd(x, w, b),
        "K8 wrapper": lambda: ln.layer_norm_fwd(x, w, b),
        "F.layer_norm": lambda: F.layer_norm(x, (768,), wl, bl, 1e-12),
        "short check": lambda: fb._launchable((x,), (w, b), 0.0, 5),
        "K8 one-look check": lambda: ln._fits(x, w, b),
        "torch.empty_like": lambda: torch.empty_like(x),
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw current stream":
            lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "a 5-argument ctypes call": lambda: grid(8, 768, 1, 0, dev.index),
        "K9 wrapper (8, 64 -> 256 -> 64)":
            lambda: ffn.ffn_fwd(fx, fw1, fb1, fw2, fb2),
        "K9 one-look check": lambda: ffn._fits(fx, fw1, fb1, fw2, fb2),
        "torch.empty (8, 64)":
            lambda: torch.empty((8, 64), dtype=fx.dtype, device=dev),
        "K9 packing": lambda: ffn._CALL.pack(
            fx.data_ptr(), fw1.data_ptr(), fb1.data_ptr(), fw2.data_ptr(),
            fb2.data_ptr(), fy.data_ptr(), 8, 64, 256, 64, 1, dev.index, 0,
            torch._C._cuda_getCurrentRawStream(dev.index)),
        "K9 entry on a packed block (3 tensor maps, the launch)":
            lambda: k9_entry(packed)}
    us = {k: host_us(f) for k, f in parts.items()}
    print("[K3-K9] host time of a launch, us a call (host clock, 2,000 calls "
          "at (8, 768) bf16): " + "; ".join(f"{k} {v:.2f}"
                                            for k, v in us.items()))
    return us


def tail_phase(torch):
    """K3-K6 against their plain versions at TAIL_SHAPES, fp32 and bf16,
    rates 0 and RATE; the mask and keep fraction through K3; K3 and K5
    forward at rate 0 at ``SCORE_TILE``; times.
    Returns (worst fp32 abs err per kernel, timing dict)."""
    from uniter_tpu_torch.ops import fused_block as fb
    from uniter_tpu_torch.ops.dropout import keep_mask

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    names = ("drop_res_ln_fwd", "drop_res_ln_bwd", "ln_drop_fwd",
             "ln_drop_bwd")
    worst = {n: 0.0 for n in names}
    timing = {}
    for rows, h in TAIL_SHAPES:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            x, res, g = (torch.randn(rows, h, generator=gen, device="cuda")
                         .to(dtype) for _ in range(3))
            w = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
            b = 0.1 * torch.randn(h, generator=gen, device="cuda")
            for rate in (0.0, RATE):
                e = tail_errors(torch, fb, x, res, w, b, g, rate, 31)
                ok = (all(v[1] <= 0 for v in e.values())
                      and all(v[2] <= TAIL_DWDB_REL for v in e.values()))
                tol = ("fp32: fwd 1e-5, dx/dres 1e-4" if dname == "float32"
                       else "bf16: 2^-8 |ref| + 1e-3")
                print(f"[K3-K6] ({rows}, {h}) {dname} rate {rate}: y, dx, "
                      f"dres max|diff| "
                      + ", ".join(f"{n} {v[3]:.2e}" for n, v in e.items())
                      + f" ({tol}); dw/db max|diff| "
                      + ", ".join(f"{n} {e[n][0]:.2e}" for n in names[1::2])
                      + "; dw/db max|diff|/max|ref| "
                      f"{max(v[2] for v in e.values()):.2e} (tol "
                      f"{TAIL_DWDB_REL:g}) {'ok' if ok else 'FAIL'}")
                check(ok, f"K3-K6 disagree with their plain versions at "
                      f"{(rows, h)} {dname} rate {rate}")
                tree = tail_tree(torch, fb, x, res, w, g, rate)
                print(f"[K3-K6] ({rows}, {h}) {dname} rate {rate}: dw/db "
                      f"equal to _sum_partials_torch of the kernel's own "
                      f"block partials, bit for bit: " + ", ".join(
                          f"{n} {v[0]} ({v[2]} blocks)"
                          for n, v in tree.items())
                      + "; equal on replay: " + ", ".join(
                          f"{n} {v[1]}" for n, v in tree.items()))
                check(all(v[0] and v[1] for v in tree.values()),
                      f"K4/K6 dw/db: fixed-order sum or replay at "
                      f"{(rows, h)} {dname} rate {rate}")
                if dname == "float32":  # all outputs, dw/db included
                    for n, v in e.items():
                        worst[n] = max(worst[n], v[0])
            if (rows, h) in TAIL_TIMED:
                timing.update(time_tails(torch, fb, x, res, w, b, g, dname))
    # the mask through K3, bit for bit, and its keep fraction: x = 1, res =
    # 0, w = 1, b = 0 make LN(dropout(x)) positive exactly where x was kept
    rows, h = TAIL_SHAPES[0]
    ones = torch.ones(rows, h, device="cuda")
    w, b = torch.ones(h, device="cuda"), torch.zeros(h, device="cuda")
    kept = fb.drop_res_ln_fwd(ones, torch.zeros_like(ones), w, b, RATE,
                              4242) > 0
    same = torch.equal(kept, keep_mask(4242, 0, (rows, h), RATE, "cuda"))
    n = rows * h
    frac = kept.double().mean().item()
    sigma = (RATE * (1 - RATE) / n) ** 0.5
    print(f"[K3-K6] keep fraction through K3 at rate {RATE} over {n} "
          f"elements: {frac:.6f} (want {1 - RATE} +- 4 sigma = "
          f"{4 * sigma:.1e}); mask equal to keep_mask bit for bit: {same}")
    check(same, "K3's mask differs from ops.dropout.keep_mask")
    check(abs(frac - (1 - RATE)) <= 4 * sigma, "keep fraction through K3")
    tail_row_base(torch, fb, keep_mask, gen)
    tail_score_tile(torch, fb, gen)
    timing["launch_path"] = launch_path(torch, fb)
    timing["gelu"] = gelu_score_tile(torch, gen)
    return worst, timing


def gelu_score_tile(torch, gen):
    """The scorer's GELU at ``GELU_TILE`` in bf16 and fp32: the in-place
    route (``BertIntermediate`` under ``inference_mode``: ``gelu_``, the
    library's erf GELU in place) against the fp32 erf formula, row block
    by row block (fp32 1e-6 + 1e-6 |ref|, bf16 2^-8 |ref| + 1e-3); then
    call times (CUDA events, ms; each call moves gigabytes) of the route,
    with the five-pass composition (``gelu``: div, erf, add, mul, mul; the
    route under autograd) before and after, against the byte bound of one
    read and one write. Returns {dtype: times and errors}."""
    import math

    from uniter_tpu_torch.ops import activations as act

    rows, mid = GELU_TILE
    block = 65536
    out = {}
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        torch.cuda.empty_cache()
        x = torch.randn(rows, mid, generator=gen, device="cuda", dtype=dtype)
        x0 = x.clone()
        with torch.inference_mode():
            act.gelu_(x)
        worst, excess = 0.0, -1.0
        for r in range(0, rows, block):
            v = x0[r:r + block].float()
            want = v * 0.5 * (1.0 + torch.erf(v * (1.0 / math.sqrt(2.0))))
            d = (x[r:r + block].float() - want).abs_()
            want.abs_()
            lim = (1e-6 + 1e-6 * want if dtype == torch.float32
                   else 2.0**-8 * want + 1e-3)
            worst = max(worst, d.max().item())
            excess = max(excess, (d - lim).max().item())
            del v, want, d, lim
        ok = excess <= 0
        tol = ("1e-6 + 1e-6 |ref|" if dtype == torch.float32
               else "2^-8 |ref| + 1e-3")
        # the route in place on x (its values drift from call to call, its
        # bytes do not); the composition out of place from x0
        route = lambda: act.gelu_(x)  # noqa: E731
        chain = lambda: act.gelu(x0)  # noqa: E731
        e0 = cuda_ms(torch, chain, 5, 1)
        t = [cuda_ms(torch, route, 10, 2), cuda_ms(torch, route, 10, 2)]
        e1 = cuda_ms(torch, chain, 5, 1)
        nbytes = 2 * x0.numel() * x0.element_size()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        res = {"ms": sum(t) / 2, "chain_ms": (e0 + e1) / 2,
               "bound_ms": bound, "max_abs_err": worst}
        out[dname] = res
        print(f"[gelu] {GELU_TILE} {dname} in place (the library's erf "
              f"GELU): max|diff| from the fp32 erf formula {worst:.2e} "
              f"({tol}) {'ok' if ok else 'FAIL'}; ms a call: route "
              f"{res['ms']:.3f} (turns {t[0]:.3f}, {t[1]:.3f}), five-pass "
              f"composition {res['chain_ms']:.3f} ({e0:.3f}, {e1:.3f}); "
              f"byte bound {bound:.3f} ({nbytes / 1e9:.2f} GB): route "
              f"{100 * bound / res['ms']:.1f}%, composition "
              f"{100 * bound / res['chain_ms']:.1f}%")
        check(ok, f"the in-place GELU disagrees with the erf formula at "
              f"{GELU_TILE} {dname}")
        del x, x0
        torch.cuda.empty_cache()
    return out


def tail_score_tile(torch, fb, gen):
    """The inference route's K3 and K5 (``inference_tail``, rate 0) in bf16
    at ``SCORE_TILE``, forward only, against their plain versions on the
    fp32 copies of the same inputs: within 2^-8 |ref| + 1e-3."""
    rows, h = SCORE_TILE
    x, res = (torch.randn(rows, h, generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    w = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    b = 0.1 * torch.randn(h, generator=gen, device="cuda")
    errs = {}
    for name, r in (("drop_res_ln_fwd", res), ("ln_drop_fwd", None)):
        before = getattr(fb, name).launches
        y = fb.inference_tail(x, r, w, b).float()
        want = (fb._ln_drop_torch(x.float(), w, b) if r is None else
                fb._drop_res_ln_torch(x.float(), r.float(), w, b))
        d = (y - want).abs_()
        excess = (d - 2.0**-8 * want.abs_() - 1e-3).max().item()
        errs[name] = (d.max().item(), excess,
                      getattr(fb, name).launches - before)
        del y, want, d
    ok = all(e[1] <= 0 and e[2] == 1 for e in errs.values())
    print(f"[K3-K6] {SCORE_TILE} bfloat16 rate 0, forward only through "
          f"inference_tail (a scoring tile): y max|diff| " + ", ".join(
              f"{n} {e[0]:.2e} ({e[2]} launch)" for n, e in errs.items())
          + f" (bf16: 2^-8 |ref| + 1e-3) {'ok' if ok else 'FAIL'}")
    check(ok, f"K3/K5 at rate 0 disagree with their plain versions at "
              f"{SCORE_TILE}")


# a rank's row base in the checks of K1-K6 at one: past 2**32 rows, so the
# counter's high word is live (data parallelism passes b0 * S to the tails
# and b0 * H * S to the attention kernels)
ROW_BASE = 2**33 + 4099
# (heads_total, head0, heads of the launch): a rank's heads under a model
# axis of 2 (uniter-base's second half), and an uneven place (3 of 16 from
# head 5: an offset that is not a multiple of the launch's heads)
HEAD_OFFSETS = [(12, 6, 6), (16, 5, 3)]


def tail_row_base(torch, fb, keep_mask, gen):
    """K3-K6 at ``ROW_BASE``: each against its plain version at that base
    (both dtypes, the first tail shape, rate RATE), and K3's mask against
    ``keep_mask`` at that base bit for bit, which is not the mask at 0."""
    rows, h = TAIL_SHAPES[0]
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        x, res, g = (torch.randn(rows, h, generator=gen, device="cuda")
                     .to(dtype) for _ in range(3))
        w = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
        b = 0.1 * torch.randn(h, generator=gen, device="cuda")
        e = tail_errors(torch, fb, x, res, w, b, g, RATE, 31, ROW_BASE)
        ok = (all(v[1] <= 0 for v in e.values())
              and all(v[2] <= TAIL_DWDB_REL for v in e.values()))
        print(f"[K3-K6] ({rows}, {h}) {dname} rate {RATE} at row base "
              f"{ROW_BASE}: max|diff| against the plain versions at that "
              "base " + ", ".join(f"{n} {v[0]:.2e}" for n, v in e.items())
              + f" {'ok' if ok else 'FAIL'}")
        check(ok, f"K3-K6 at row base {ROW_BASE} disagree with their plain "
                  f"versions ({dname})")
    ones = torch.ones(rows, h, device="cuda")
    w, b = torch.ones(h, device="cuda"), torch.zeros(h, device="cuda")
    kept = fb.drop_res_ln_fwd(ones, torch.zeros_like(ones), w, b, RATE,
                              4242, row_base=ROW_BASE) > 0
    want = keep_mask(4242, 0, (rows, h), RATE, "cuda", row_base=ROW_BASE)
    same = torch.equal(kept, want)
    other = not torch.equal(want, keep_mask(4242, 0, (rows, h), RATE,
                                            "cuda"))
    print(f"[K3-K6] K3's mask at row base {ROW_BASE} equal to keep_mask at "
          f"that base bit for bit: {same} (and not the mask at 0: {other})")
    check(same and other, "K3's mask at a row base")


def time_tails(torch, fb, x, res, w, b, g, dname):
    """Device and call times (``both_ms``, ms per call) of K3/K4 at the
    sub-block tail or K5/K6 at an embedding tail (``TAIL_TIMED``), rates 0
    and RATE, each in turns kernel, library, library, kernel; the plain
    versions' call times before and after. Library (a yardstick, never on
    a path), in x's dtype: ``F.layer_norm(x + res)`` (two calls: the add,
    then the LayerNorm) for K3 and its autograd backward for K4;
    ``F.layer_norm`` and its backward for K5/K6. Returns {(name, dname,
    rows, rate): {"dev", "call", "lib_dev", "lib_call", "plain"}}."""
    import torch.nn.functional as F

    rows, h = x.shape
    fname, bname = TAIL_TIMED[(rows, h)]
    sub = fname == "drop_res_ln_fwd"
    if sub:
        kern = {fname: lambda r: fb.drop_res_ln_fwd(x, res, w, b, r, 5),
                bname: lambda r: fb.drop_res_ln_bwd(x, res, w, g, r, 5)}
        plain = {fname: lambda r: fb._drop_res_ln_torch(x, res, w, b, r, 5),
                 bname: lambda r: fb._drop_res_ln_bwd_torch(x, res, w, g, r,
                                                            5)}
    else:
        kern = {fname: lambda r: fb.ln_drop_fwd(x, w, b, r, 5),
                bname: lambda r: fb.ln_drop_bwd(x, w, g, r, 5)}
        plain = {fname: lambda r: fb._ln_drop_torch(x, w, b, r, 5),
                 bname: lambda r: fb._ln_drop_bwd_torch(x, w, g, r, 5)}
    xr = x.detach().clone().requires_grad_()
    rr = res.detach().clone().requires_grad_()
    wl = w.to(x.dtype).detach().requires_grad_()
    bl = b.to(x.dtype).detach().requires_grad_()

    def lib_fwd():
        with torch.no_grad():
            return F.layer_norm(x + res if sub else x, (h,), wl, bl, 1e-12)

    s = torch.cuda.Stream()  # the backward's forward, and so its capture
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        y = F.layer_norm(xr + rr if sub else xr, (h,), wl, bl, 1e-12)
    ins = (xr, rr, wl, bl) if sub else (xr, wl, bl)
    lib = {fname: (lib_fwd, None),
           bname: (lambda: torch.autograd.grad(y, ins, g, retain_graph=True),
                   s)}
    out = {}
    print(f"[K3-K6] times at ({rows}, {h}) {dname}, us per call: device "
          f"(50 calls in one CUDA graph, replayed) / call (500 calls from "
          f"Python, CUDA events); turns kernel, library, library, kernel:")
    for name in (fname, bname):
        lfn, ls = lib[name]
        bound, by = tail_bound_ms(name, rows, h, dname)
        for rate in (0.0, RATE):
            p0 = cuda_ms(torch, lambda: plain[name](rate))
            t = [both_ms(torch, lambda: kern[name](rate)),
                 both_ms(torch, lfn, ls), both_ms(torch, lfn, ls),
                 both_ms(torch, lambda: kern[name](rate))]
            p1 = cuda_ms(torch, lambda: plain[name](rate))
            r = {"dev": (t[0][0] + t[3][0]) / 2,
                 "call": (t[0][1] + t[3][1]) / 2,
                 "lib_dev": (t[1][0] + t[2][0]) / 2,
                 "lib_call": (t[1][1] + t[2][1]) / 2, "plain": (p0 + p1) / 2}
            out[(name, dname, rows, rate)] = r
            print(f"[K3-K6]   {name} rate {rate}: kernel {r['dev'] * 1e3:.1f}"
                  f" / {r['call'] * 1e3:.1f}; library {r['lib_dev'] * 1e3:.1f}"
                  f" / {r['lib_call'] * 1e3:.1f}"
                  f"{' (add + F.layer_norm)' if sub and name == fname else ''}"
                  f"; turns " + ", ".join(f"{d * 1e3:.1f}/{c * 1e3:.1f}"
                                          for d, c in t)
                  + f"; plain call {r['plain'] * 1e3:.1f}; bound "
                  f"{bound * 1e3:.1f} ({by})")
    return out


def jax_layout_params(cfg, num_answer, img_dim, seed, label_dim=None,
                      itm=False, head="vqa"):
    """A uniter-base parameter tree in the JAX package's layout (flax Dense
    kernels [in, out], layers stacked [L, ...]): normal(0, 0.02) for
    matrices and embeddings, ones and zeros for LayerNorm, zero biases. The
    VQA head by default; with ``label_dim`` the four pretraining heads; with
    ``itm`` the retrieval heads (``itm_output``, ``rank_output``); with
    ``head`` "vcr" VCR's, "re1" / "re2" RE's at mlp 1 / 2 (and no pooler:
    RE reads none)."""
    rng = np.random.default_rng(seed)
    h, ff, nl = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers

    def w(*shape):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(cfg.initializer_range))

    def ln(*lead, n=h):
        return {"weight": np.ones(lead + (n,), np.float32),
                "bias": np.zeros(lead + (n,), np.float32)}

    def dense(n_in, n_out, *lead):
        return {"kernel": w(*lead, n_in, n_out),
                "bias": np.zeros(lead + (n_out,), np.float32)}

    layer = {
        "attention": {"query": dense(h, h, nl), "key": dense(h, h, nl),
                      "value": dense(h, h, nl),
                      "output_dense": dense(h, h, nl),
                      "output_LayerNorm": ln(nl)},
        "intermediate_dense": dense(h, ff, nl),
        "output_dense": dense(ff, h, nl),
        "output_LayerNorm": ln(nl),
    }
    uniter = {
        "embeddings": {
            "word_embeddings": {"embedding": w(cfg.vocab_size, h)},
            "position_embeddings": {
                "embedding": w(cfg.max_position_embeddings, h)},
            "token_type_embeddings": {"embedding": w(cfg.type_vocab_size, h)},
            "LayerNorm": ln()},
        "img_embeddings": {
            "img_linear": dense(img_dim, h), "img_layer_norm": ln(),
            "pos_linear": dense(7, h), "pos_layer_norm": ln(),
            "mask_embedding": w(2, img_dim), "LayerNorm": ln()},
        "encoder": {"layer": {"bert_layer": layer}},
        "pooler": {"dense": dense(h, h)},
    }
    if itm:
        return {"uniter": uniter, "itm_output": dense(h, 2),
                "rank_output": dense(h, 1)}
    if head == "vcr":
        return {"uniter": uniter, "vcr_hidden": dense(h, 2 * h),
                "vcr_ln": ln(n=2 * h), "vcr_out": dense(2 * h, 2)}
    if head in ("re1", "re2"):
        del uniter["pooler"]
        tree = {"uniter": uniter, "re_output": dense(h, 1)}
        if head == "re2":
            tree.update(re_hidden=dense(h, h), re_ln=ln())
        return tree
    if label_dim is not None:
        return {
            "uniter": uniter,
            "cls": {"transform": {"dense": dense(h, h), "LayerNorm": ln()},
                    "bias": np.zeros(cfg.vocab_size, np.float32)},
            "feat_regress": {"net_dense": dense(h, h), "net_ln": ln(),
                             "bias": np.zeros(img_dim, np.float32)},
            "region_classifier": {"net_dense": dense(h, h), "net_ln": ln(),
                                  "net_out": dense(h, label_dim)},
            "itm_output": dense(h, 2)}
    return {"uniter": uniter, "vqa_hidden": dense(h, 2 * h),
            "vqa_ln": ln(n=2 * h), "vqa_out": dense(2 * h, num_answer)}


class InMemoryVqa:
    """Questions made from a seed: 6-66 tokens (CLS/SEP included), 10-100
    regions of fp16 features cut from one shared random pool, 7-d boxes.
    Duck-types the dataset interface ``BucketLoader`` reads; batches are
    collated by ``VqaDataset.collate``, as ``inf_vqa`` collates them."""

    def __init__(self, n, vocab, num_answer, img_dim, seed):
        rng = np.random.default_rng(seed)
        self.num_answer = num_answer
        self.txt = [rng.integers(1000, vocab, int(t)).astype(np.int32)
                    for t in rng.integers(6, 67, n)]
        for ids in self.txt:
            ids[0], ids[-1] = 101, 102  # CLS ... SEP
        self.nbb = rng.integers(10, 101, n)
        self.pool = rng.standard_normal((8192, img_dim),
                                        dtype=np.float32).astype(np.float16)
        self.ofs = rng.integers(0, 8192 - 100, n)
        self.pos = rng.random((n, 100, 7), dtype=np.float32)

    def __len__(self):
        return len(self.txt)

    def size_of(self, i):
        return len(self.txt[i]), int(self.nbb[i])

    def get_record(self, i, rng=None):
        nbb = int(self.nbb[i])
        return dict(input_ids=self.txt[i],
                    img_feat=self.pool[self.ofs[i]:self.ofs[i] + nbb],
                    img_pos_feat=self.pos[i, :nbb],
                    target=np.zeros(self.num_answer, np.float32),
                    qid=f"q{i}")


def serve_tails(cfg):
    """Launches per served batch of the inference tails: K3 at rate 0 at
    both sub-block tails of every layer, K5 at the 2 embedding tails."""
    return {"drop_res_ln_fwd": 2 * cfg.num_hidden_layers, "ln_drop_fwd": 2}


@contextlib.contextmanager
def plain_tails(on=True):
    """With ``on``, the inference tails' plain path (the plain add and
    LayerNorm): ``ops.fused_block._launchable`` refuses every tensor, so
    ``inference_tail`` gives None and no tail launches K3/K5. The serving
    checks' plain side runs under it, so their kernel side holds the
    inference route against the plain tails at the path's own shapes."""
    from uniter_tpu_torch.ops import fused_block as fb

    launchable = fb._launchable
    if on:
        fb._launchable = lambda *a, **k: False
    try:
        yield
    finally:
        fb._launchable = launchable


def main_path_phase(torch, device="cuda", n_questions=N_QUESTIONS,
                    per_batch=None, tag="main", **cfg_overrides):
    """uniter-base VQA inference through the kernels and through the plain
    path (the plain attention, LayerNorms and tails: no kernel at all).
    ``per_batch`` is the launches per served batch the kernel pass must
    show (K1 and the inference tails, ``serve_tails``, by default; every
    other kernel 0). Returns (launch counts, batches, questions/s per
    path, logits max|diff|)."""
    from uniter_tpu_torch.config import base_config, resolve_kernel_policies
    from uniter_tpu_torch.data.buckets import spec_from_dataset
    from uniter_tpu_torch.data.loader import BucketLoader
    from uniter_tpu_torch.data.vqa import VqaDataset
    from uniter_tpu_torch.inf_vqa import answer_questions
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
    from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu_torch.utils.const import IMG_DIM

    num_answer = 3129
    base = base_config(dtype="float32", attention_impl="pallas",
                       **cfg_overrides)
    t0 = time.perf_counter()
    sd = state_dict_from_jax_params(
        jax_layout_params(base, num_answer, IMG_DIM, SEED))
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    models = {}
    for impl in ("cuda", "xla"):  # the plain path has no kernel at all
        cfg = base.replace(attention_impl=impl)
        if impl == "xla":
            cfg = cfg.replace(layer_norm_impl="xla")
        cfg = resolve_kernel_policies(cfg, device)
        m = UniterForVisualQuestionAnswering(cfg, IMG_DIM, num_answer)
        m.load_state_dict(sd, strict=True)
        models[impl] = m.to(device).eval()
    check(models["cuda"].uniter.config.attention_impl
          == ("cuda" if torch.device(device).type == "cuda" else "xla"),
          "the kernel config did not resolve to the kernel")
    ds = InMemoryVqa(n_questions, base.vocab_size, num_answer, IMG_DIM, SEED)
    loader = BucketLoader(ds, spec_from_dataset(ds, TOKEN_BUDGET),
                          VqaDataset.collate, shuffle=False, drop_last=False)
    n_batches = len(loader)
    label2ans = {i: str(i) for i in range(num_answer)}
    print(f"[{tag}] uniter-base VQA, {n_questions} questions in {n_batches} "
          f"batches (budget {TOKEN_BUDGET} tokens); set-up "
          f"{time.perf_counter() - t0:.1f} s")

    def run(impl):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        with plain_tails(impl == "xla"):
            results, logits = answer_questions(models[impl], loader,
                                               label2ans, device,
                                               keep_logits=True)
        return results, logits, time.perf_counter() - t

    run("xla")  # warm-up: cuBLAS handles, allocator, host pools
    reset_launches()
    res_k, logits_k, _ = run("cuda")
    counts = read_launches()
    per_batch = per_batch or {"mha_fwd": base.num_hidden_layers,
                              **serve_tails(base)}
    want = {k: per_batch.get(k, 0) * n_batches for k in KERNELS}
    check(counts == want, f"{tag}: serving launched {counts}, want {want} "
          f"({per_batch} per batch, {n_batches} batches)")
    res_x, logits_x, _ = run("xla")
    secs = {"xla": [], "cuda": []}
    for impl in ("xla", "cuda", "cuda", "xla"):
        secs[impl].append(run(impl)[2])
    qps = {impl: n_questions * len(v) / sum(v) for impl, v in secs.items()}

    check(len(res_k) == len(res_x) == n_questions, "answer count")
    lk = np.stack([logits_k[f"q{i}"] for i in range(n_questions)])
    lx = np.stack([logits_x[f"q{i}"] for i in range(n_questions)])
    check(lk.shape == (n_questions, num_answer) and np.isfinite(lk).all()
          and np.isfinite(lx).all(), "logits not finite or misshapen")
    err = float(np.abs(lk - lx).max())
    agree = float((lk.argmax(1) == lx.argmax(1)).mean())
    check([r["question_id"] for r in res_k] == [r["question_id"]
                                                 for r in res_x],
          "question order differs")
    print(f"[{tag}] kernels (K1, the tails' K3/K5 at rate 0) vs plain "
          f"path (no kernel): logits max|diff| {err:.3e} (tol 1e-3), argmax "
          f"agreement {agree * 100:.2f}% (>= 99.9%)")
    print(f"[{tag}] launches {counts}: {per_batch} per batch x {n_batches} "
          f"batches, every other kernel 0")
    print(f"[{tag}] questions/s: kernels {qps['cuda']:.1f}, plain "
          f"{qps['xla']:.1f} (turns plain, kernel, kernel, plain; host "
          f"clock, each pass ends in the logits' readback)")
    check(err <= 1e-3, f"logits differ by {err}")
    check(agree >= 0.999, f"argmax agreement {agree}")
    return counts, n_batches, qps, err


def flagship_batch(torch, cfg, num_answer, img_dim, transfer_dtype,
                   wire_codec=None):
    """``bench.py``'s fixed batch: B=96, 64 text + 40 image tokens, full
    masks, targets with 0.3% positives; every row real (ex_weight 1), so
    the loss is mean BCE x num_answer. ``wire_codec`` as the loops take
    it."""
    from uniter_tpu_torch.training.loop import train_batch_to_device

    b, t, r = 96, 64, 40
    rng = np.random.RandomState(0)
    batch = dict(
        input_ids=rng.randint(1, 28000, (b, t)).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        img_feat=rng.randn(b, r, img_dim).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=np.ones((b, t + r), np.int32),
        targets=(rng.rand(b, num_answer) < 0.003).astype(np.float32),
        ex_weight=np.ones(b, np.float32))
    return train_batch_to_device(batch, torch.device("cuda"), transfer_dtype,
                                 wire_codec)


def make_trainer(torch, cfg, sd, num_answer, master=False):
    """Model, fused AdamW (bf16 moments, betas (0.9, 0.98), eps 1e-6, wd
    0.01, clip 2.0, lr 8e-5 warmed up over 600 of 6000 steps) and the
    step, as ``bench.py`` builds them; loss_scale "mean". ``master``:
    master-weight mode (``--param_dtype bfloat16``)."""
    from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu_torch.train_vqa import vqa_loss
    from uniter_tpu_torch.training.optim import build_optimizer
    from uniter_tpu_torch.training.sched import get_lr_schedule
    from uniter_tpu_torch.training.step import TrainState, make_train_step
    from uniter_tpu_torch.utils.const import IMG_DIM

    model = UniterForVisualQuestionAnswering(cfg, IMG_DIM, num_answer)
    model.load_state_dict(sd, strict=True)
    model.to("cuda")
    opt = build_optimizer(model, get_lr_schedule(8e-5, 600, 6000),
                          betas=(0.9, 0.98), eps=1e-6, weight_decay=0.01,
                          grad_norm=2.0, fused=True, mu_dtype=torch.bfloat16,
                          nu_dtype=torch.bfloat16, master=master)
    step = make_train_step(
        lambda m, b, g: (vqa_loss(m, b, g, num_answer), {}),
        loss_scale="mean")
    return TrainState(step=0, model=model, opt=opt), step


def profile_steps(torch, state, step, batch, n, tag, label="train"):
    """torch.profiler over ``n`` steps: device busy time by kernel, idle
    share of the wall clock. The full table goes to chiprun_out/."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, batch, SEED)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3,
             e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)

    def share(*keys):
        return sum(r[1] for r in rows
                   if any(k in r[0].lower() for k in keys))

    # the plain Philox bits run as int64 elementwise passes ("<long"
    # functors) and the stack of their four words (8-byte cat)
    groups = {"K1": share("mha_fwd_"), "K2": share("mha_bwd_"),
              "fused tails (K3-K6)": share("tail_fwd", "tail_bwd",
                                           "sum_partials"),
              "ipot (K7)": share("ipot_reg_kernel", "ipot_mem_kernel"),
              "K8": share("layer_norm_fwd_kernel"),
              "K9": share("ffn_wgmma_kernel", "ffn_f32_kernel"),
              "GEMM": share("gemm", "cutlass", "xmma", "sm90_", "nvjet"),
              "Philox bits": share("<long", "opaquetype<8u>")}
    groups["other"] = busy - sum(groups.values())
    tails = [r for r in rows
             if any(k in r[0] for k in ("tail_fwd", "tail_bwd",
                                        "sum_partials"))]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"train_profile_{tag}.txt"), "w") as f:
        for name, ms, count in rows:
            f.write(f"{ms:10.3f} ms {count:6d}  {name}\n")
    ops = sum(r[2] for r in rows) / n
    print(f"[{label}] profile, {tag}, {n} steps: wall "
          f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms, idle "
          f"{(1 - busy / 1e3 / wall) * 100:.1f}%, device ops a step "
          f"{ops:g}; "
          + ", ".join(f"{k} {v:.1f} ms ({v / busy * 100:.1f}%)"
                      for k, v in groups.items()))
    for name, ms, count in rows[:12]:
        print(f"[{label}]   {ms:9.2f} ms {ms / busy * 100:5.1f}% x{count:<5d} "
              f"{name[:90]}")
    if tails:
        print(f"[{label}] fused tails by kernel, us a call: " + "; ".join(
            f"{re.search(r'(tail_fwd|tail_bwd|sum_partials)(<[^>]*>)?', name)[0]}"
            f" x{count} {ms / count * 1e3:.1f}" for name, ms, count in tails))
    return state, {"wall_ms": wall * 1e3, "busy_ms": busy, "ops": ops,
                   **groups}


POLICIES = {  # name -> (attention_impl, block_fusion) before resolution
    "plain": ("xla", "none"), "K1/K2": ("auto", "none"),
    "K1-K6": ("auto", "auto")}


def policy_configs(base, device="cuda"):
    """Each policy's training config, resolved for ``device``."""
    from uniter_tpu_torch.config import resolve_kernel_policies

    cfgs = {name: resolve_kernel_policies(
        base.replace(attention_impl=att, block_fusion=bf), device,
        training=True) for name, (att, bf) in POLICIES.items()}
    got = {n: (c.attention_impl, c.block_fusion) for n, c in cfgs.items()}
    check(got == {"plain": ("xla", "none"), "K1/K2": ("cuda", "none"),
                  "K1-K6": ("cuda", "cuda")},
          f"the policies resolved to {got}")
    return cfgs


def run_policies(torch, trainers, batches, n_steps):
    """Two steps of warm-up per policy, then turns of ``n_steps`` steps in
    the order of ``trainers`` and back (plain, K1/K2, K1-K6, K1-K6, K1/K2,
    plain), a trainer's step i on ``batches[i % len(batches)]``; launch
    counts set to 0 just before each K1-K6 run and read just after. Returns
    (seconds per policy, losses per policy, real rows per policy over the
    turns, K1-K6 launches summed, K1-K6 steps)."""
    losses = {n: [] for n in trainers}
    rows = {n: 0 for n in trainers}
    total = {k: 0 for k in KERNELS}
    steps = 0

    def run(name, n):
        nonlocal total, steps
        state, step = trainers[name]
        if name == "K1-K6":
            reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = []
        for _ in range(n):
            b = batches[state.step % len(batches)]
            ms.append(step(state, b, SEED)[1]["loss"])
            rows[name] += int(b["ex_weight"].sum())
        losses[name] += [float(x) for x in ms]  # the readback ends the turn
        dt = time.perf_counter() - t0
        if name == "K1-K6":
            total = {k: total[k] + v for k, v in read_launches().items()}
            steps += n
        return dt

    for name in trainers:  # warm-up: allocator, cuBLAS handles
        run(name, 2)
    rows = {n: 0 for n in trainers}
    secs = {n: [] for n in trainers}
    for name in list(trainers) + list(trainers)[::-1]:
        secs[name].append(run(name, n_steps))
    check(steps == trainers["K1-K6"][0].step, "K1-K6 step count")
    return secs, losses, rows, total, steps


def check_launches(total, steps, want_per_step, tag):
    per_step = {k: v / steps for k, v in total.items()}
    print(f"[{tag}] K1-K6 path launches over {steps} steps: "
          + ", ".join(f"{k} {v}" for k, v in total.items())
          + "; per step " + ", ".join(f"{k} {per_step[k]:g}" for k in total)
          + f" (want {want_per_step})")
    check(per_step == want_per_step, f"{tag}: launches per step {per_step}")


def step1_agreement(losses, tag, rows, terms):
    """Step 1 of every policy: the same parameters, batch and dropout
    seeds (the generator is keyed by (seed, step)), so the same masks."""
    first = {n: v[0] for n, v in losses.items()}
    rel = max(abs(v - first["plain"]) / abs(first["plain"])
              for v in first.values())
    print(f"[{tag}] step 1 losses " + ", ".join(
        f"{n} {v:.6f}" for n, v in first.items())
        + f"; max relative diff from plain {rel:.2e} (tol 1e-3: bf16 "
        f"roundings, 2**-8 each, placed differently in 12 layers, averaged "
        f"over {rows} x {terms} loss terms)")
    check(all(np.isfinite(v).all() for v in losses.values()),
          f"{tag}: non-finite loss")
    check(rel <= 1e-3, f"{tag}: step 1 losses differ across policies")
    return rel


def train_phase(torch):
    """The flagship fine-tune step under the three policies, then the
    2-layer fp32 runs. Returns launches per kernel, steps, examples/s per
    policy, step-1 agreement and the profiles."""
    from uniter_tpu_torch.config import base_config
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
    from uniter_tpu_torch.utils.const import IMG_DIM

    num_answer, b = 3129, 96
    base = base_config(dtype="bfloat16", hidden_dropout_prob=RATE,
                       attention_probs_dropout_prob=RATE)
    sd = {k: torch.from_numpy(v) for k, v in state_dict_from_jax_params(
        jax_layout_params(base, num_answer, IMG_DIM, SEED)).items()}
    batch = flagship_batch(torch, base, num_answer, IMG_DIM, torch.bfloat16)
    trainers = {name: make_trainer(torch, cfg, sd, num_answer)
                for name, cfg in policy_configs(base).items()}
    torch.cuda.reset_peak_memory_stats()
    secs, losses, _, total, steps = run_policies(torch, trainers, [batch],
                                                 10)
    eps = {n: 10 * b * len(v) / sum(v) for n, v in secs.items()}
    order = ("plain", "K1/K2", "K1-K6", "K1-K6", "K1/K2", "plain")
    turn_s = {n: list(v) for n, v in secs.items()}
    print(f"[train] uniter-base VQA step, B={b}, T=64, R=40, bf16 over fp32 "
          f"parameters, dropout {RATE}, fused AdamW bf16 moments: examples/s "
          + ", ".join(f"{n} {v:.1f}" for n, v in eps.items())
          + " (turns of 10 steps: " + ", ".join(order) + "; host clock, each "
          "turn ends in the loss readback; turn seconds "
          + ", ".join(f"{turn_s[n].pop(0):.3f}" for n in order) + "); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(three trainers)")
    check_launches(total, steps, STEP_LAUNCHES, "train")
    rel1 = step1_agreement(losses, "train", b, num_answer)
    lk = losses["K1-K6"]
    print(f"[train] K1-K6 loss on the fixed batch: first {lk[0]:.4f}, last "
          f"{lk[-1]:.4f}")
    check(lk[-1] < lk[0], "the loss did not fall on the fixed batch")
    prof = {}
    for name in ("K1-K6", "K1/K2", "plain"):
        state, step = trainers[name]
        prof[name] = profile_steps(torch, state, step, batch, 3,
                                   name.replace("/", "_"))[1]
    del trainers
    torch.cuda.empty_cache()
    small = two_layer_runs(torch, num_answer)
    return {"launches": total, "steps": steps, "ex_per_s": eps,
            "step1_rel": rel1, "profile": prof, "two_layer": small}


def train32_phase(torch, n_steps=5):
    """The flagship fine-tune step in fp32 (``--dtype float32``: B=96, T=64,
    R=40, dropout 0.1, fused AdamW with bf16 moments) through K1-K6 and
    through the plain attention and tails, in turns plain, K1-K6, K1-K6,
    plain of ``n_steps`` steps (host clock, each turn ended by the loss
    readback), launch counts of the K1-K6 turns, step 1's losses, and a
    3-step profile of each (device busy ms a step, idle share). Returns
    {"ex_per_s", "busy_ms", "launches", "step1_rel"}."""
    from uniter_tpu_torch.config import base_config
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
    from uniter_tpu_torch.utils.const import IMG_DIM

    num_answer, b = 3129, 96
    base = base_config(dtype="float32", hidden_dropout_prob=RATE,
                       attention_probs_dropout_prob=RATE)
    sd = {k: torch.from_numpy(v) for k, v in state_dict_from_jax_params(
        jax_layout_params(base, num_answer, IMG_DIM, SEED)).items()}
    batch = flagship_batch(torch, base, num_answer, IMG_DIM, None)
    cfgs = policy_configs(base)
    trainers = {n: make_trainer(torch, cfgs[n], sd, num_answer)
                for n in ("plain", "K1-K6")}
    losses = {n: [] for n in trainers}

    def run(name, n):
        state, step = trainers[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = [step(state, batch, SEED)[1]["loss"] for _ in range(n)]
        losses[name] += [float(x) for x in ms]
        return time.perf_counter() - t0

    for name in trainers:  # warm-up, and step 1 of each
        run(name, 1)
    secs = {n: [] for n in trainers}
    total, steps = {k: 0 for k in KERNELS}, 0
    for name in ("plain", "K1-K6", "K1-K6", "plain"):
        if name == "K1-K6":
            reset_launches()
        secs[name].append(run(name, n_steps))
        if name == "K1-K6":
            total = {k: total[k] + v for k, v in read_launches().items()}
            steps += n_steps
    eps = {n: n_steps * b * len(v) / sum(v) for n, v in secs.items()}
    first = {n: v[0] for n, v in losses.items()}
    rel = abs(first["K1-K6"] - first["plain"]) / abs(first["plain"])
    print(f"[train32] uniter-base VQA step in fp32, B={b}, T=64, R=40, "
          f"dropout {RATE}, fused AdamW bf16 moments: examples/s "
          + ", ".join(f"{n} {v:.1f}" for n, v in eps.items())
          + f" (turns of {n_steps} steps plain, K1-K6, K1-K6, plain after "
          f"one warm-up step each; host clock, each turn ends in the loss "
          f"readback); step 1 losses plain {first['plain']:.7f}, K1-K6 "
          f"{first['K1-K6']:.7f}, relative diff {rel:.2e} (tol 1e-5: fp32 "
          f"rounding of other summation orders)")
    check(rel <= 1e-5, "fp32 train step: step 1 losses differ")
    check_launches(total, steps, STEP_LAUNCHES, "train32")
    busy = {}
    for name in ("K1-K6", "plain"):
        state, step = trainers[name]
        prof = profile_steps(torch, state, step, batch, 3,
                             "fp32_" + name.replace("/", "_"),
                             label="train32")[1]
        busy[name] = prof["busy_ms"] / 3
    print(f"[train32] device busy ms a step: " + ", ".join(
        f"{n} {v:.1f}" for n, v in busy.items()))
    del trainers
    torch.cuda.empty_cache()
    return {"ex_per_s": eps, "busy_ms": busy, "launches": total,
            "step1_rel": rel}


def two_layer_runs(torch, num_answer):
    """2 layers at base width in fp32, 3 steps each: at dropout 0 K1/K2
    against plain (the tails stay plain: no mask is live), at dropout 0.1
    K1-K6 and K1/K2 against plain (same masks). Relative loss differences
    held to 1e-5, fp32 rounding of other summation orders (and of x * (1 /
    (1 - rate)) against x / (1 - rate) in the tails)."""
    from uniter_tpu_torch.config import base_config
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
    from uniter_tpu_torch.utils.const import IMG_DIM

    out = {}
    for rate in (0.0, RATE):
        cfg = base_config(num_hidden_layers=2, dtype="float32",
                          hidden_dropout_prob=rate,
                          attention_probs_dropout_prob=rate)
        sd = {k: torch.from_numpy(v) for k, v in state_dict_from_jax_params(
            jax_layout_params(cfg, num_answer, IMG_DIM, SEED)).items()}
        batch = flagship_batch(torch, cfg, num_answer, IMG_DIM, None)
        cfgs = policy_configs(cfg)
        if rate == 0.0:
            cfgs.pop("K1-K6")  # no live mask: the same path as K1/K2
        losses = {}
        for name, c in cfgs.items():
            reset_launches()
            state, step = make_trainer(torch, c, sd, num_answer)
            losses[name] = [float(step(state, batch, SEED)[1]["loss"])
                            for _ in range(3)]
            tails = sum(v for k, v in read_launches().items()
                        if not k.startswith("mha"))
            check((tails > 0) == (name == "K1-K6" and rate > 0),
                  f"2-layer {name} at dropout {rate}: {tails} tail launches")
        rel = max(abs(a - c) / abs(c) for n in losses if n != "plain"
                  for a, c in zip(losses[n], losses["plain"]))
        print(f"[train] fp32, dropout {rate}, 2 layers, 3 steps: losses "
              + "; ".join(f"{n} {v}" for n, v in losses.items())
              + f"; max relative diff from plain {rel:.2e} (tol 1e-5)")
        check(rel <= 1e-5, f"fp32 dropout-{rate} losses differ from plain")
        out[rate] = rel
    return out


def write_vqa_dbs(root, n_img, n_q, seed, n_labels=3129):
    """txt/img DBs of ``n_q`` questions over ``n_img`` images (10-100
    regions of fp16 2048-d features, conf, boxes), answers of ``n_labels``
    labels (SNLI-VE: 3), with the port's writers."""
    from uniter_tpu_torch.data.img_db import write_img_db
    from uniter_tpu_torch.data.txt_db import write_txt_db

    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((8192, 2048), dtype=np.float32).astype(
        np.float16)
    names = [f"coco_{i:06d}.npz" for i in range(n_img)]

    def records():
        for n in names:
            nbb = int(rng.integers(10, 101))
            o = int(rng.integers(0, 8192 - nbb))
            yield n, dict(
                features=pool[o:o + nbb],
                norm_bb=rng.random((nbb, 6), dtype=np.float32).astype(
                    np.float16),
                conf=np.linspace(1, 0.3, nbb).astype(np.float16),
                soft_labels=np.zeros((nbb, 1601), np.float16))

    write_img_db(os.path.join(root, "img"), records(), conf_th=0.2,
                 max_bb=100, min_bb=10)
    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [999, 28996]}
    recs, t2i = {}, {}
    for i in range(n_q):
        name = names[i % n_img]
        recs[f"q{i}"] = dict(
            input_ids=[int(x) for x in rng.integers(999, 28996,
                                                    int(rng.integers(4, 21)))],
            img_fname=name,
            target={"labels": [int(rng.integers(0, n_labels))],
                    "scores": [1.0]})
        t2i[f"q{i}"] = name
    write_txt_db(os.path.join(root, "txt"), recs, meta, t2i)


def cli_phase(torch, n_q=2000):
    """``train_vqa.main`` (uniter-base, 12 layers) for 20 steps, validating
    and saving at 10 and 20, a resume to 25, and ``inf_vqa.main`` on its
    output, all on the card."""
    from uniter_tpu_torch import inf_vqa, train_vqa
    from uniter_tpu_torch.utils.misc import parse_with_config

    os.makedirs(os.path.join(REPO, "tmp"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_",
                            dir=os.path.join(REPO, "tmp"))
    try:
        t0 = time.perf_counter()
        write_vqa_dbs(work, 400, n_q, SEED)
        out = os.path.join(work, "run")
        conf = dict(
            train_txt_db=os.path.join(work, "txt"),
            train_img_db=os.path.join(work, "img"),
            val_txt_db=os.path.join(work, "txt"),
            val_img_db=os.path.join(work, "img"),
            model_config=os.path.join(REPO, "configs", "uniter-base.json"),
            output_dir=out, num_train_steps=20, valid_steps=10, log_steps=5,
            train_batch_size=5120, val_batch_size=10240, n_workers=2,
            moment_dtype="bfloat16", device="cuda", checkpoint="")
        path = os.path.join(work, "train.json")
        with open(path, "w") as f:
            json.dump(conf, f)
        t1 = time.perf_counter()
        state = train_vqa.main(parse_with_config(train_vqa.get_parser(),
                                                 ["--config", path]))
        check(state.step == 20, f"train_vqa stopped at {state.step}")
        del state
        t2 = time.perf_counter()
        state = train_vqa.main(parse_with_config(
            train_vqa.get_parser(),
            ["--config", path, "--num_train_steps", "25"]))
        check(state.step == 25, f"resumed run stopped at {state.step}")
        del state
        t3 = time.perf_counter()
        with open(os.path.join(out, "log", "log.txt")) as f:
            log = f.read()
        check("resumed from step 20" in log, "the rerun did not resume")
        ckpts = sorted(os.listdir(os.path.join(out, "ckpt")))
        scores = [json.loads(line)["valid/score"] for line in
                  open(os.path.join(out, "log", "scalars.jsonl"))
                  if "valid/score" in line]
        res = inf_vqa.main(inf_vqa.get_parser().parse_args([
            "--txt_db", os.path.join(work, "txt"),
            "--img_db", os.path.join(work, "img"), "--train_dir", out,
            "--output_dir", os.path.join(work, "ans"), "--device", "cuda",
            "--save_logits"]))
        t4 = time.perf_counter()
        with open(res) as f:
            answers = json.load(f)
        logits = np.load(os.path.join(work, "ans", "logits.npz"))
        check(sorted(a["question_id"] for a in answers)
              == sorted(f"q{i}" for i in range(n_q)), "answer set")
        check(all(np.isfinite(logits[k].astype(np.float32)).all()
                  for k in logits.files), "non-finite logits")
        print(f"[cli] {n_q} questions over 400 images written in "
              f"{t1 - t0:.1f} s; train_vqa 20 steps (validate + save at 10, "
              f"20) {t2 - t1:.1f} s; resumed to 25 {t3 - t2:.1f} s; inf_vqa "
              f"{t4 - t3:.1f} s; checkpoints {ckpts}; valid scores {scores}; "
              f"{len(answers)} answers, logits finite")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def nlvr2_batch(torch, n_pairs, t, r, img_dim, transfer_dtype, seed):
    """A fixed paired batch: 2 rows per pair (left image type 1, right 2),
    ragged text and region lengths, labels 0/1, every pair real."""
    from uniter_tpu_torch.training.loop import train_batch_to_device

    rng = np.random.RandomState(seed)
    rows = 2 * n_pairs
    tl = np.repeat(rng.randint(t // 2, t + 1, n_pairs), 2)
    nb = rng.randint(r // 2, r + 1, rows)
    attn = np.concatenate([np.arange(t) < tl[:, None],
                           np.arange(r) < nb[:, None]], 1).astype(np.int32)
    ids = np.repeat(rng.randint(1, 28000, (n_pairs, t)), 2, 0)
    batch = dict(
        input_ids=(ids * (np.arange(t) < tl[:, None])).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (rows, 1)),
        img_feat=rng.randn(rows, r, img_dim).astype(np.float32),
        img_pos_feat=rng.rand(rows, r, 7).astype(np.float32),
        attn_mask=attn,
        img_type_ids=np.tile(np.array([[1], [2]], np.int32),
                             (n_pairs, r)) * (np.arange(r) < nb[:, None]),
        targets=rng.randint(0, 2, n_pairs).astype(np.int32),
        ex_weight=np.ones(n_pairs, np.float32))
    return train_batch_to_device(batch, torch.device("cuda"), transfer_dtype)


def nlvr2_phase(torch):
    """UniterForNlvr2PairedAttn at uniter-base width (random weights from a
    seed) on a fixed batch of 48 pairs through the three policies in turns.
    Returns launches, steps, pairs/s per policy and step-1 agreement."""
    from uniter_tpu_torch.config import base_config
    from uniter_tpu_torch.models.nlvr2 import UniterForNlvr2PairedAttn
    from uniter_tpu_torch.train_nlvr2 import nlvr2_loss
    from uniter_tpu_torch.training.driver import init_weights
    from uniter_tpu_torch.training.optim import build_optimizer
    from uniter_tpu_torch.training.sched import get_lr_schedule
    from uniter_tpu_torch.training.step import TrainState, make_train_step
    from uniter_tpu_torch.utils.const import IMG_DIM

    n_pairs = 48
    base = base_config(dtype="bfloat16", type_vocab_size=3,
                       hidden_dropout_prob=RATE,
                       attention_probs_dropout_prob=RATE)
    torch.manual_seed(SEED)
    ref = UniterForNlvr2PairedAttn(base, IMG_DIM)
    init_weights(ref, base.initializer_range)
    sd = ref.state_dict()
    batch = nlvr2_batch(torch, n_pairs, 64, 40, IMG_DIM, torch.bfloat16, SEED)
    trainers = {}
    for name, cfg in policy_configs(base).items():
        model = UniterForNlvr2PairedAttn(cfg, IMG_DIM)
        model.load_state_dict(sd, strict=True)
        model.to("cuda")
        opt = build_optimizer(model, get_lr_schedule(3e-5, 800, 8000),
                              betas=(0.9, 0.98), weight_decay=0.01,
                              grad_norm=2.0, fused=True)
        trainers[name] = (TrainState(step=0, model=model, opt=opt),
                          make_train_step(
                              lambda m, b, g: (nlvr2_loss(m, b, g), {})))
    secs, losses, _, total, steps = run_policies(torch, trainers, [batch],
                                                 10)
    pps = {n: 10 * n_pairs * len(v) / sum(v) for n, v in secs.items()}
    print(f"[nlvr2] paired-attn uniter-base step, {n_pairs} pairs (96 rows, "
          f"T=64, R=40), bf16 over fp32 parameters, dropout {RATE}, fused "
          f"AdamW: pairs/s " + ", ".join(f"{n} {v:.1f}" for n, v in pps.items())
          + " (turns of 10 steps: plain, K1/K2, K1-K6, K1-K6, K1/K2, plain; "
          "host clock, each turn ends in the loss readback)")
    # 12 layers plus attn1/attn2 for K1/K2
    check_launches(total, steps, {**STEP_LAUNCHES, "mha_fwd": 14,
                                  "mha_bwd": 14}, "nlvr2")
    rel1 = step1_agreement(losses, "nlvr2", n_pairs, 2)
    del trainers
    torch.cuda.empty_cache()
    return {"launches": total, "steps": steps, "pairs_per_s": pps,
            "step1_rel": rel1}


def write_nlvr2_dbs(root, n_img, n_ex, seed):
    """An img DB of ``n_img`` images (10-100 regions) and a paired txt DB of
    ``n_ex`` examples (2 images each, labels 0/1), with the port's writers."""
    from uniter_tpu_torch.data.img_db import write_img_db
    from uniter_tpu_torch.data.txt_db import write_txt_db

    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((8192, 2048), dtype=np.float32).astype(
        np.float16)
    names = [f"nlvr2_{i:05d}.npz" for i in range(n_img)]

    def records():
        for n in names:
            nbb = int(rng.integers(10, 101))
            o = int(rng.integers(0, 8192 - nbb))
            yield n, dict(
                features=pool[o:o + nbb],
                norm_bb=rng.random((nbb, 6), dtype=np.float32).astype(
                    np.float16),
                conf=np.linspace(1, 0.3, nbb).astype(np.float16),
                soft_labels=np.zeros((nbb, 1601), np.float16))

    write_img_db(os.path.join(root, "img"), records(), conf_th=0.2,
                 max_bb=100, min_bb=10)
    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [999, 28996]}
    recs, t2i = {}, {}
    for i in range(n_ex):
        pair = [names[(2 * i) % n_img], names[(2 * i + 1) % n_img]]
        recs[f"ex_{i}"] = dict(
            input_ids=[int(x) for x in rng.integers(999, 28996,
                                                    int(rng.integers(4, 31)))],
            img_fname=pair, target=int(rng.integers(0, 2)))
        t2i[f"ex_{i}"] = pair
    write_txt_db(os.path.join(root, "txt"), recs, meta, t2i)


def nlvr2_cli_phase(torch, n_ex=1000):
    """``train_nlvr2.main`` (paired-attn, uniter-base, default flags: K1-K6)
    for 20 steps, validating and saving at 10 and 20, a resume to 25, and
    ``inf_nlvr2.main`` on its output, all on the card."""
    from uniter_tpu_torch import inf_nlvr2, train_nlvr2
    from uniter_tpu_torch.utils.misc import parse_with_config

    os.makedirs(os.path.join(REPO, "tmp"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_nlvr2_",
                            dir=os.path.join(REPO, "tmp"))
    try:
        t0 = time.perf_counter()
        write_nlvr2_dbs(work, 400, n_ex, SEED)
        out = os.path.join(work, "run")
        conf = dict(
            train_txt_db=os.path.join(work, "txt"),
            train_img_db=os.path.join(work, "img"),
            val_txt_db=os.path.join(work, "txt"),
            val_img_db=os.path.join(work, "img"),
            model_config=os.path.join(REPO, "configs", "uniter-base.json"),
            output_dir=out, num_train_steps=20, valid_steps=10, log_steps=5,
            train_batch_size=5120, val_batch_size=10240, n_workers=2,
            device="cuda", checkpoint="")
        path = os.path.join(work, "train.json")
        with open(path, "w") as f:
            json.dump(conf, f)
        t1 = time.perf_counter()
        reset_launches()
        state = train_nlvr2.main(parse_with_config(train_nlvr2.get_parser(),
                                                   ["--config", path]))
        counts = read_launches()
        check(state.step == 20, f"train_nlvr2 stopped at {state.step}")
        check(state.model.uniter.config.block_fusion == "cuda"
              and all((v > 0) == (STEP_LAUNCHES[k] > 0)
                      for k, v in counts.items()),
              f"train_nlvr2's default flags did not run K1-K6 alone: "
              f"{counts}")
        del state
        t2 = time.perf_counter()
        state = train_nlvr2.main(parse_with_config(
            train_nlvr2.get_parser(),
            ["--config", path, "--num_train_steps", "25"]))
        check(state.step == 25, f"resumed run stopped at {state.step}")
        del state
        t3 = time.perf_counter()
        with open(os.path.join(out, "log", "log.txt")) as f:
            log = f.read()
        check("resumed from step 20" in log, "the rerun did not resume")
        check("block_fusion cuda" in log, "block_fusion not logged as cuda")
        ckpts = sorted(os.listdir(os.path.join(out, "ckpt")))
        accs = [json.loads(line)["valid/acc"] for line in
                open(os.path.join(out, "log", "scalars.jsonl"))
                if "valid/acc" in line]
        res = inf_nlvr2.main(inf_nlvr2.get_parser().parse_args([
            "--txt_db", os.path.join(work, "txt"),
            "--img_db", os.path.join(work, "img"), "--train_dir", out,
            "--output_dir", os.path.join(work, "pred"), "--device", "cuda"]))
        t4 = time.perf_counter()
        with open(res) as f:
            rows = [line.strip().split(",") for line in f if line.strip()]
        check(sorted(r[0] for r in rows) == sorted(f"ex_{i}"
                                                   for i in range(n_ex)),
              "results.csv does not hold one row per example")
        check({r[1] for r in rows} <= {"True", "False"}, "labels")
        print(f"[nlvr2-cli] {n_ex} examples over 400 images written in "
              f"{t1 - t0:.1f} s; train_nlvr2 20 steps (validate + save at "
              f"10, 20) {t2 - t1:.1f} s, launches {counts}; resumed to 25 "
              f"{t3 - t2:.1f} s; inf_nlvr2 {t4 - t3:.1f} s; checkpoints "
              f"{ckpts}; valid acc {accs}; {len(rows)} rows in results.csv")
    finally:
        shutil.rmtree(work, ignore_errors=True)

def ot_inputs(torch, b, n, m, gen, d=64):
    """``ipot``'s arguments as ``optimal_transport_dist`` makes them: the
    cosine cost [B, M, N] of random embeddings, random valid lengths,
    examples 1 and B-1 all padding (the collate's batch-padding rows)."""
    from uniter_tpu_torch.ops.ot import cost_matrix_cosine

    x = torch.randn(b, m, d, generator=gen, device="cuda")
    y = torch.randn(b, n, d, generator=gen, device="cuda")
    x_len = torch.randint(1, m + 1, (b,), generator=gen, device="cuda")
    y_len = torch.randint(1, n + 1, (b,), generator=gen, device="cuda")
    x_len[0], y_len[0] = m, n
    for i in (1, b - 1):
        x_len[i] = y_len[i] = 0
    x_pad = torch.arange(m, device="cuda")[None, :] >= x_len[:, None]
    y_pad = torch.arange(n, device="cuda")[None, :] >= y_len[:, None]
    joint = x_pad[:, :, None] | y_pad[:, None, :]
    cost = cost_matrix_cosine(x, y).masked_fill(joint, 0.0)
    return cost, x_len.float(), x_pad, y_len.float(), y_pad, joint


def ipot_bound_ms(b, n, m, iteration=50, k=1):
    """Least time for K7 on this card: A read once and T written once
    (plus the [B, M] and [B, N] vectors) over 3.35 TB/s, against its fp32
    operations over 67 TFLOP/s: per element and step 1 for Q = A T, 2 k each
    for Q sigma and Q^T delta, 2 for T = delta Q sigma."""
    nbytes = 4 * (2 * b * n * m + 2 * b * m + b * n + 2 * b)
    flops = iteration * (3 + 4 * k) * b * n * m
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def kernel_node_name(cu, node):
    """The function name of a kernel node of a CUDA graph (libcuda ``cu``),
    or None: CUDA_KERNEL_NODE_PARAMS_v2 holds the CUfunction first and the
    CUkernel at its eighth pointer, whichever the launch left."""
    import ctypes

    params = (ctypes.c_void_p * 16)()
    if cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params):
        return None
    name = ctypes.c_char_p()
    if params[0] and not cu.cuFuncGetName(ctypes.byref(name),
                                          ctypes.c_void_p(params[0])):
        return name.value.decode()
    if params[7] and not cu.cuKernelGetName(ctypes.byref(name),
                                            ctypes.c_void_p(params[7])):
        return name.value.decode()
    return None


def graph_kernels(torch, fn):
    """What one call of ``fn`` puts on its stream, read from a CUDA graph
    captured from it (after a warm-up call), read through libcuda: the name of
    each kernel node, and the type number of any other node
    (``cuGraphNodeGetType``). A count, unlike a profile: nothing from
    before or after the call can enter it."""
    import ctypes

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t()
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    found = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            found.append(f"node type {kind.value}")
            continue
        name = kernel_node_name(cu, node)
        found.append(_demangle(name) if name else "kernel")
    del graph
    return found


# K7 before its redesign (one launch on inputs its wrapper prepared with
# torch operations, then a torch re-mask) at K7_SHAPES, 50 steps, k = 1, in
# us: that kernel launched alone on prepared inputs in a CUDA graph, and its
# wrapper's call, as this script's K7 phase measured them on an NVIDIA H100
# 80GB HBM3 at 700.00 W (the call is host-paced: 215-456 us at the first
# shape across runs)
K7_BEFORE_US = {(48, 64, 160): (155.5, 395.6), (96, 40, 64): (96.4, 471.9),
                (64, 100, 64): (207.7, 277.1), (8, 100, 512): (1079.2, 1147.1),
                (5, 37, 23): (91.8, 319.5)}


def k7_phase(torch):
    """K7 against ``ipot`` at K7_SHAPES, k = 1 and 2 (1e-5 + 1e-4 |ref|, the
    distance to 1e-4, exact zeros at joint padding and in all-padding
    examples, a bitwise repeat); one call runs one device kernel and
    nothing else; at every shape (k = 1) ``ipot_cuda``'s device time (a
    CUDA graph of calls) and call time in turns plain, kernel, kernel,
    plain. Returns (worst |T - ref|, {shape: {"call", "dev", "plain"}})."""
    from uniter_tpu_torch.ops.ot import ipot, ipot_cuda, ipot_form

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst, timing = 0.0, {}
    for b, n, m in K7_SHAPES:
        args = ot_inputs(torch, b, n, m, gen)
        cost, jp_t = args[0], args[5].transpose(1, 2)
        for k in (1, 2):
            got = ipot_cuda(*args, 0.5, 50, k)
            torch.cuda.synchronize()
            want = ipot(*args, 0.5, 50, k)
            diff = (got - want).abs()
            excess = (diff - (1e-5 + 1e-4 * want.abs())).max().item()
            dist = torch.einsum("bmn,bnm->b", cost, got)
            dist_ref = torch.einsum("bmn,bnm->b", cost, want)
            rel = ((dist - dist_ref).abs()
                   / dist_ref.abs().clamp_min(1e-6)).max().item()
            zeros = bool((got[jp_t] == 0).all() and (got[1] == 0).all()
                         and (got[b - 1] == 0).all())
            again = torch.equal(got, ipot_cuda(*args, 0.5, 50, k))
            ok = (excess <= 0 and rel <= 1e-4 and zeros and again
                  and bool(torch.isfinite(got).all()))
            print(f"[K7] B={b} N={n} M={m} k={k} (form {ipot_form(n, m)}): "
                  f"T max|diff| {diff.max().item():.3e} (tol 1e-5 + 1e-4 "
                  f"|ref|, max|ref| {want.abs().max().item():.3e}); "
                  f"distance max rel diff {rel:.2e} (tol 1e-4); zero where "
                  f"masked and in all-padding examples: {zeros}; bitwise "
                  f"equal on a second run: {again} {'ok' if ok else 'FAIL'}")
            check(ok, f"K7 disagrees with ipot at {(b, n, m)} k={k}")
            worst = max(worst, diff.max().item())
        ops = graph_kernels(torch, lambda: ipot_cuda(*args, 0.5, 50, 1))
        print(f"[K7] B={b} N={n} M={m}: one ipot_cuda call puts on its "
              f"stream {ops}")
        check(len(ops) == 1 and (ops[0] == "kernel" or "ipot_" in ops[0]),
              f"one ipot_cuda call ran {ops}, not one K7 kernel")
        plain = [cuda_ms(torch, lambda: ipot(*args, 0.5, 50, 1), 5, 1)]
        dev, call = zip(*[both_ms(torch, lambda: ipot_cuda(*args, 0.5, 50, 1))
                          for _ in range(2)])
        plain.append(cuda_ms(torch, lambda: ipot(*args, 0.5, 50, 1), 5, 1))
        t = timing[(b, n, m)] = {"dev": sum(dev) / 2, "call": sum(call) / 2,
                                 "plain": sum(plain) / 2}
        bound, by = ipot_bound_ms(b, n, m)
        p_dev, p_call = K7_BEFORE_US[(b, n, m)]
        print(f"[K7] time at B={b} N={n} M={m}, 50 steps, k=1: ipot_cuda "
              f"device {t['dev'] * 1e3:.1f} us (CUDA graph; turns "
              f"{', '.join(f'{x * 1e3:.1f}' for x in dev)}), call "
              f"{t['call'] * 1e3:.1f} us "
              f"({', '.join(f'{x * 1e3:.1f}' for x in call)}); plain "
              f"{t['plain'] * 1e3:.1f} us per call (CUDA events; "
              f"{', '.join(f'{x * 1e3:.1f}' for x in plain)}); bound "
              f"{bound * 1e3:.2f} us ({by}), {bound / t['dev'] * 100:.1f}% "
              f"of it; before the redesign: launch alone {p_dev} us, "
              f"call {p_call} us")
    return worst, timing


def k8_phase(torch):
    """K8 against the plain ``layer_norm`` at TAIL_SHAPES, fp32 (1e-5) and
    bf16 (half a bf16 step of the value + 1e-3); times at (9984, 768)
    against plain and ``F.layer_norm``. Returns (worst fp32 err, timing)."""
    import torch.nn.functional as F

    from uniter_tpu_torch.ops.layer_norm import (
        _layer_norm_torch, layer_norm_fwd)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst, timing = 0.0, {}
    for rows, h in TAIL_SHAPES + [(96, 1536)]:  # + the VQA head's LayerNorm
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            x = (2.0 * torch.randn(rows, h, generator=gen, device="cuda")
                 + 0.5).to(dtype)
            w = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
            b = 0.1 * torch.randn(h, generator=gen, device="cuda")
            got = layer_norm_fwd(x, w, b, 1e-12)
            torch.cuda.synchronize()
            want = _layer_norm_torch(x.float(), w, b, 1e-12)
            diff = (got.float() - want).abs()
            tol = (TAIL_FWD_TOL_FP32 if dname == "float32"
                   else 2.0**-8 * want.abs() + 1e-3)
            ok = (diff - tol).max().item() <= 0 and got.dtype == dtype
            print(f"[K8] ({rows}, {h}) {dname}: max|diff| "
                  f"{diff.max().item():.3e} "
                  f"({'tol 1e-5' if dname == 'float32' else 'bf16: 2^-8 |ref| + 1e-3'}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"K8 disagrees with layer_norm at {(rows, h)} {dname}")
            if dname == "float32":
                worst = max(worst, diff.max().item())
            if (rows, h) == TAIL_SHAPES[0]:
                wl, bl = w.to(dtype), b.to(dtype)
                p0 = cuda_ms(torch, lambda: _layer_norm_torch(x, w, b))
                t = [both_ms(torch, lambda: layer_norm_fwd(x, w, b)),
                     both_ms(torch, lambda: F.layer_norm(x, (h,), wl, bl,
                                                         1e-12)),
                     both_ms(torch, lambda: F.layer_norm(x, (h,), wl, bl,
                                                         1e-12)),
                     both_ms(torch, lambda: layer_norm_fwd(x, w, b))]
                p1 = cuda_ms(torch, lambda: _layer_norm_torch(x, w, b))
                r = {"dev": (t[0][0] + t[3][0]) / 2,
                     "call": (t[0][1] + t[3][1]) / 2,
                     "lib_dev": (t[1][0] + t[2][0]) / 2,
                     "lib_call": (t[1][1] + t[2][1]) / 2,
                     "plain": (p0 + p1) / 2}
                timing[dname] = r
                bound = ((2 * rows * h * x.element_size() + 2 * h * 4)
                         / HBM_BYTES_PER_S * 1e3)
                print(f"[K8] time at ({rows}, {h}) {dname}, us per call, "
                      f"device (CUDA graph) / call (CUDA events), turns "
                      f"kernel, F.layer_norm, F.layer_norm, kernel: kernel "
                      f"{r['dev'] * 1e3:.1f} / {r['call'] * 1e3:.1f}, "
                      f"F.layer_norm {r['lib_dev'] * 1e3:.1f} / "
                      f"{r['lib_call'] * 1e3:.1f} (turns "
                      f"{', '.join(f'{d * 1e3:.1f}/{c * 1e3:.1f}' for d, c in t)}"
                      f"); plain call {r['plain'] * 1e3:.1f}; bound "
                      f"{bound * 1e3:.1f} us (bytes)")
    return worst, timing


PRETRAIN_SHAPE = (48, 160, 64)  # bench.py's pretrain mix: B, T, R
PRETRAIN_TASKS = ("mlm", "mrfr", "itm", "mrc-kl")
MIX_CYCLE = ("mlm", "itm", "mlm", "itm", "mrfr", "mrc-kl")  # 2:2:1:1
# name -> (attention_impl, block_fusion, ot_impl) before resolution
PRETRAIN_POLICIES = {"plain": ("xla", "none", "xla"),
                     "K1-K6": ("auto", "auto", "xla"),
                     "K1-K7": ("auto", "auto", "cuda")}


def pretrain_batches(torch, b, t, r, img_dim, label_dim, transfer_dtype,
                     seed=1):
    """One fixed batch per task at the collate's static shapes: full masks,
    ``mlm_slots(t)`` text slots (15% of T valid), ``mrm_slots(r)`` region
    slots (15% of R valid, masked regions zeroed), ITM targets half 1, half
    0."""
    from uniter_tpu_torch.data.mlm import mlm_slots
    from uniter_tpu_torch.data.mrm import mrm_slots
    from uniter_tpu_torch.training.loop import train_batch_to_device

    rng = np.random.RandomState(seed)
    m_txt, m_img = mlm_slots(t), mrm_slots(r)
    v_txt, v_img = max(1, round(0.15 * t)), max(1, round(0.15 * r))
    out = {}
    for task in PRETRAIN_TASKS:
        batch = dict(
            input_ids=rng.randint(1, 28000, (b, t)).astype(np.int32),
            position_ids=np.tile(np.arange(t, dtype=np.int32), (b, 1)),
            img_feat=rng.randn(b, r, img_dim).astype(np.float32),
            img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
            attn_mask=np.ones((b, t + r), np.int32),
            ex_weight=np.ones(b, np.float32))
        if task == "mlm":
            batch["mlm_pos"] = np.sort(
                rng.randint(0, t, (b, m_txt)), -1).astype(np.int32)
            tgt = rng.randint(1, 28000, (b, m_txt)).astype(np.int32)
            tgt[:, v_txt:] = -1
            batch["mlm_tgt"] = tgt
        elif task in ("mrfr", "mrc-kl"):
            pos = np.stack([np.sort(rng.choice(r, m_img, replace=False))
                            for _ in range(b)]).astype(np.int32)
            valid = np.zeros((b, m_img), np.float32)
            valid[:, :v_img] = 1.0
            masks = np.zeros((b, r), bool)
            for i in range(b):
                masks[i, pos[i, :v_img]] = True
            batch["img_feat"] = np.where(masks[..., None], 0.0,
                                         batch["img_feat"]).astype(np.float32)
            batch.update(mrm_pos=pos, mrm_valid=valid, img_masks=masks)
            if task == "mrfr":
                batch["feat_targets"] = rng.randn(b, m_img, img_dim).astype(
                    np.float32)
            else:
                soft = rng.rand(b, m_img, label_dim).astype(np.float32)
                batch["label_targets"] = soft / soft.sum(-1, keepdims=True)
        else:
            batch["targets"] = np.tile(np.array([1, 0], np.int32), b // 2)
        out[task] = train_batch_to_device(batch, torch.device("cuda"),
                                          transfer_dtype)
    return out


def make_pretrainer(torch, cfg, ot_impl, sd, ot_lambda=0.1):
    """Model, fused AdamW (fp32 moments, lr 5e-5 warmed up over 10000 of
    200000 steps: ``pretrain``'s defaults) and one step per task, as
    ``pretrain.main`` builds them; ``itm_no_ot`` is the ITM step with
    ``itm_ot_lambda`` 0."""
    from uniter_tpu_torch.models.pretrain import UniterForPretraining
    from uniter_tpu_torch.training.optim import build_optimizer
    from uniter_tpu_torch.training.sched import get_lr_schedule
    from uniter_tpu_torch.training.step import TrainState, make_train_step

    model = UniterForPretraining(cfg, ot_impl=ot_impl)
    model.load_state_dict(sd, strict=True)
    model.to("cuda")
    opt = build_optimizer(model, get_lr_schedule(5e-5, 10000, 200000),
                          betas=(0.9, 0.98), weight_decay=0.01,
                          grad_norm=2.0, fused=True)

    def step_for(task, lam):
        return make_train_step(
            lambda m, b, g: m.scalar_loss(b, task, ot_lambda=lam,
                                          deterministic=False, generator=g))

    steps = {task: step_for(task, ot_lambda if task == "itm" else 0.0)
             for task in PRETRAIN_TASKS}
    steps["itm_no_ot"] = step_for("itm", 0.0)
    return TrainState(step=0, model=model, opt=opt), steps


def pretrain_configs(base, device="cuda"):
    from uniter_tpu_torch.config import resolve_kernel_policies

    cfgs = {name: (resolve_kernel_policies(
        base.replace(attention_impl=att, block_fusion=bf), device,
        training=True), ot) for name, (att, bf, ot)
        in PRETRAIN_POLICIES.items()}
    got = {n: (c.attention_impl, c.block_fusion, ot)
           for n, (c, ot) in cfgs.items()}
    check(got == {"plain": ("xla", "none", "xla"),
                  "K1-K6": ("cuda", "cuda", "xla"),
                  "K1-K7": ("cuda", "cuda", "cuda")},
          f"the pretraining policies resolved to {got}")
    return cfgs


def pretrain_phase(torch):
    """The uniter-base pretraining step under the three policies. Returns
    the K1-K7 launches per task, mix examples/s, ITM step times, step-1
    agreement, the profile and the 2-layer runs."""
    from uniter_tpu_torch.config import base_config
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
    from uniter_tpu_torch.utils.const import IMG_DIM, IMG_LABEL_DIM

    b, t, r = PRETRAIN_SHAPE
    base = base_config(dtype="bfloat16", hidden_dropout_prob=RATE,
                       attention_probs_dropout_prob=RATE)
    sd = {k: torch.from_numpy(v) for k, v in state_dict_from_jax_params(
        jax_layout_params(base, 0, IMG_DIM, SEED,
                          label_dim=IMG_LABEL_DIM)).items()}
    batches = pretrain_batches(torch, b, t, r, IMG_DIM, IMG_LABEL_DIM,
                               torch.bfloat16)
    trainers = {name: make_pretrainer(torch, cfg, ot, sd)
                for name, (cfg, ot) in pretrain_configs(base).items()}
    torch.cuda.reset_peak_memory_stats()

    def run(name, tasks):
        """The steps of ``tasks`` in turn; ends in the readback of every
        step's metrics. Returns (seconds, metrics per step)."""
        state, steps = trainers[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = [steps[task](state, batches[task.replace("_no_ot", "")],
                          SEED)[1] for task in tasks]
        ms = [{k: float(v) for k, v in m.items()} for m in ms]
        return time.perf_counter() - t0, ms

    # per task: the first step of each policy (same parameters up to two
    # warm-up-sized AdamW steps per earlier task, same masks), then one
    # more; launches of the K1-K7 path set to 0 just before, read just after
    launches, first = {}, {}
    for task in PRETRAIN_TASKS:
        first[task] = {}
        for name in trainers:
            if name == "K1-K7":
                reset_launches()
            _, ms = run(name, [task, task])
            if name == "K1-K7":
                launches[task] = read_launches()
            first[task][name] = ms[0]
        want = {**STEP_LAUNCHES, "ipot": 1 if task == "itm" else 0}
        per_step = {k: v / 2 for k, v in launches[task].items()}
        losses = {n: m["loss"] for n, m in first[task].items()}
        rel = max(abs(v - losses["plain"]) / abs(losses["plain"])
                  for v in losses.values())
        print(f"[pretrain] {task}: K1-K7 launches per step {per_step}; "
              f"first-step loss " + ", ".join(
                  f"{n} {v:.6f}" for n, v in losses.items())
              + f"; max relative diff from plain {rel:.2e} (tol 1e-3: bf16 "
              f"roundings placed differently in 12 layers)")
        check(per_step == want, f"pretrain {task}: launches {per_step}")
        check(all(np.isfinite(list(m.values())).all()
                  for m in first[task].values()), f"{task}: non-finite")
        check(rel <= 1e-3, f"pretrain {task}: first-step losses differ")
    ot = {n: m["itm_ot"] for n, m in first["itm"].items()}
    xe = {n: m["itm_xe"] for n, m in first["itm"].items()}
    # the OT term is a difference of two sums of distances near 1 per
    # example, so it is held to 1e-3 of that scale (the mean distance),
    # and K1-K7 against K1-K6 (the same states, another OT version) to 1e-4
    state, _ = trainers["K1-K7"]
    with torch.no_grad():
        state.model.eval()
        scale = float(state.model.forward_itm(
            batches["itm"], False, True, deterministic=True)[1].mean())
        state.model.train()
    d_pol = max(abs(v - ot["plain"]) for v in ot.values())
    d_ot = abs(ot["K1-K7"] - ot["K1-K6"])
    print(f"[pretrain] itm first step: itm_xe " + ", ".join(
        f"{n} {v:.6f}" for n, v in xe.items()) + "; itm_ot " + ", ".join(
        f"{n} {v:.6e}" for n, v in ot.items())
        + f"; mean OT distance per example {scale:.4f}; itm_ot max diff "
        f"from plain {d_pol:.2e} (tol 1e-3 x that distance), K1-K7 from "
        f"K1-K6 {d_ot:.2e} (tol 1e-4 x that distance)")
    check(d_pol <= 1e-3 * scale and d_ot <= 1e-4 * scale,
          "itm_ot differs across the policies")

    # the 2:2:1:1 mix: one turn is one cycle of six steps
    order = ("plain", "K1-K6", "K1-K7", "K1-K7", "K1-K6", "plain")
    secs = {n: [] for n in trainers}
    for _ in range(3):
        for name in order:
            secs[name].append(run(name, MIX_CYCLE)[0])
    eps = {n: b * len(MIX_CYCLE) / float(np.median(v))
           for n, v in secs.items()}
    print(f"[pretrain] uniter-base pretraining mix mlm:itm:mrfr:mrc-kl = "
          f"2:2:1:1, B={b}, T={t}, R={r}, bf16 over fp32 parameters, dropout "
          f"{RATE}, fused AdamW, itm_ot_lambda 0.1: examples/s "
          + ", ".join(f"{n} {v:.1f}" for n, v in eps.items())
          + " (median over 6 turns of one 6-step cycle each, in the order "
          + ", ".join(order) + " three times; host clock, each turn ends in "
          "the readback of its metrics; turn seconds "
          + "; ".join(f"{n} " + ", ".join(f"{x:.3f}" for x in v)
                      for n, v in secs.items())
          + f"); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB (three trainers)")

    # the ITM step alone: with OT through K7, through the plain loop, and
    # without OT (itm_ot_lambda 0), 5 steps a turn
    itm = {"K1-K7 itm": [], "K1-K6 itm (plain OT)": [],
           "K1-K7 itm_no_ot": [], "plain itm": []}
    for _ in range(3):
        for key, name, task in (
                ("plain itm", "plain", "itm"),
                ("K1-K6 itm (plain OT)", "K1-K6", "itm"),
                ("K1-K7 itm", "K1-K7", "itm"),
                ("K1-K7 itm_no_ot", "K1-K7", "itm_no_ot"),
                ("K1-K7 itm_no_ot", "K1-K7", "itm_no_ot"),
                ("K1-K7 itm", "K1-K7", "itm"),
                ("K1-K6 itm (plain OT)", "K1-K6", "itm"),
                ("plain itm", "plain", "itm")):
            itm[key].append(run(name, [task] * 5)[0] / 5 * 1e3)
    itm_ms = {k: float(np.median(v)) for k, v in itm.items()}
    no_ot = itm_ms["K1-K7 itm_no_ot"]
    print(f"[pretrain] ITM step, ms (median over 6 turns of 5 steps, host "
          f"clock): " + ", ".join(f"{k} {v:.2f}" for k, v in itm_ms.items())
          + f"; OT's share of the step: K7 "
          f"{(itm_ms['K1-K7 itm'] - no_ot) / itm_ms['K1-K7 itm'] * 100:.1f}%"
          f", plain OT "
          f"{(itm_ms['K1-K6 itm (plain OT)'] - no_ot) / itm_ms['K1-K6 itm (plain OT)'] * 100:.1f}%")

    state, steps = trainers["K1-K7"]
    _, prof = profile_steps(torch, state, steps["itm"], batches["itm"], 3,
                            "pretrain_itm_K1_K7", label="pretrain")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del trainers, state, steps
    torch.cuda.empty_cache()
    small = pretrain_two_layer_runs(torch)
    return {"launches": launches, "ex_per_s": eps, "itm_ms": itm_ms,
            "first": first, "profile": prof, "two_layer": small,
            "peak_gib": peak}


def pretrain_two_layer_runs(torch):
    """2 layers at base width in fp32, dropout 0 and 0.1, two steps each of
    itm and mlm: K1-K8 (K7 for the OT, ``layer_norm_impl="cuda"`` for the
    LayerNorms no fused tail takes) against plain, the loss held to 1e-5
    relative and ``itm_ot`` to 1e-5 of the mean OT distance (fp32 rounding
    of other summation orders)."""
    from uniter_tpu_torch.config import base_config, resolve_kernel_policies
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
    from uniter_tpu_torch.utils.const import IMG_DIM, IMG_LABEL_DIM

    b, t, r = PRETRAIN_SHAPE
    out = {}
    for rate in (0.0, RATE):
        cfg = base_config(num_hidden_layers=2, dtype="float32",
                          hidden_dropout_prob=rate,
                          attention_probs_dropout_prob=rate)
        sd = {k: torch.from_numpy(v) for k, v in state_dict_from_jax_params(
            jax_layout_params(cfg, 0, IMG_DIM, SEED,
                              label_dim=IMG_LABEL_DIM)).items()}
        batches = pretrain_batches(torch, b, t, r, IMG_DIM, IMG_LABEL_DIM,
                                   None)
        res = {}
        for name, c, ot in (
                ("K1-K8", resolve_kernel_policies(
                    cfg.replace(attention_impl="auto", block_fusion="auto",
                                layer_norm_impl="pallas"), "cuda",
                    training=True), "cuda"),
                ("plain", resolve_kernel_policies(
                    cfg.replace(attention_impl="xla", block_fusion="none"),
                    "cuda", training=True), "xla")):
            reset_launches()
            state, steps = make_pretrainer(torch, c, ot, sd)
            ms = [steps[task](state, batches[task], SEED)[1]
                  for task in ("itm", "mlm", "itm", "mlm")]
            res[name] = [{k: float(v) for k, v in m.items()} for m in ms]
            counts = read_launches()
            if name == "K1-K8":
                # per step: img/pos LayerNorm, and with no live mask the 2
                # embedding and 4 sub-block tails; the MLM head's one more
                ln_want = 2 * (2 + (0 if rate else 6)) + 2 * (
                    3 + (0 if rate else 6))
                check(counts["ipot"] == 2
                      and counts["layer_norm_fwd"] == ln_want
                      and (counts["drop_res_ln_fwd"] > 0) == (rate > 0),
                      f"2-layer K1-K8 at dropout {rate}: {counts} (want "
                      f"{ln_want} K8 launches)")
            else:
                check(not any(counts.values()),
                      f"2-layer plain launched {counts}")
                with torch.no_grad():
                    state.model.eval()
                    scale = float(state.model.forward_itm(
                        batches["itm"], False, True,
                        deterministic=True)[1].mean())
        rel = max(abs(a["loss"] - c["loss"]) / abs(c["loss"])
                  for a, c in zip(res["K1-K8"], res["plain"]))
        # itm_ot is a difference of sums of per-example distances: held to
        # 1e-5 of the mean distance, not of its own (cancelled) size
        d_ot = max(abs(a["itm_ot"] - c["itm_ot"])
                   for a, c in zip(res["K1-K8"], res["plain"])
                   if "itm_ot" in c)
        print(f"[pretrain] fp32, dropout {rate}, 2 layers, steps itm, mlm, "
              f"itm, mlm: losses K1-K8 "
              f"{[round(m['loss'], 6) for m in res['K1-K8']]}, plain "
              f"{[round(m['loss'], 6) for m in res['plain']]}; max relative "
              f"diff {rel:.2e} (tol 1e-5); itm_ot K1-K8 "
              f"{res['K1-K8'][0]['itm_ot']:.6e}, plain "
              f"{res['plain'][0]['itm_ot']:.6e}, max diff {d_ot:.2e} (tol "
              f"1e-5 x the mean OT distance {scale:.4f})")
        check(d_ot <= 1e-5 * scale,
              f"2-layer fp32 dropout-{rate} itm_ot differs")
        check(rel <= 1e-5, f"2-layer fp32 dropout-{rate} pretraining differs")
        out[rate] = rel
    return out


def write_pretrain_dbs(root, n_img, n_txt, seed):
    """Two corpora ("a", "b"): each an img DB of ``n_img`` images (10-100
    regions of fp16 2048-d features, boxes, soft labels [nbb, 1601]) and a
    txt DB of ``n_txt`` captions, with the port's writers."""
    from uniter_tpu_torch.data.img_db import write_img_db
    from uniter_tpu_torch.data.txt_db import write_txt_db

    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((8192, 2048), dtype=np.float32).astype(
        np.float16)
    soft_pool = rng.random((4096, 1601), dtype=np.float32)
    soft_pool = (soft_pool / soft_pool.sum(-1, keepdims=True)).astype(
        np.float16)
    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [999, 28996]}
    for c in ("a", "b"):
        names = [f"{c}_{i:06d}.npz" for i in range(n_img)]

        def records():
            for n in names:
                nbb = int(rng.integers(10, 101))
                o = int(rng.integers(0, 8192 - nbb))
                so = int(rng.integers(0, 4096 - nbb))
                yield n, dict(
                    features=pool[o:o + nbb],
                    norm_bb=rng.random((nbb, 6), dtype=np.float32).astype(
                        np.float16),
                    conf=np.linspace(1, 0.3, nbb).astype(np.float16),
                    soft_labels=soft_pool[so:so + nbb])

        write_img_db(os.path.join(root, f"img_{c}"), records(), conf_th=0.2,
                     max_bb=100, min_bb=10)
        recs, t2i = {}, {}
        for i in range(n_txt):
            name = names[i % n_img]
            recs[f"{c}{i}"] = dict(
                input_ids=[int(x) for x in rng.integers(
                    999, 28996, int(rng.integers(4, 41)))],
                img_fname=name)
            t2i[f"{c}{i}"] = name
        write_txt_db(os.path.join(root, f"txt_{c}"), recs, meta, t2i)


def pretrain_cli_phase(torch, n_txt=600):
    """``pretrain.main`` (uniter-base, default flags: K1-K7) on two corpora
    and four tasks for 20 steps, validating and saving at 10 and 20, and a
    resume to 25, all on the card."""
    from uniter_tpu_torch import pretrain
    from uniter_tpu_torch.utils.misc import parse_with_config

    os.makedirs(os.path.join(REPO, "tmp"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_pretrain_",
                            dir=os.path.join(REPO, "tmp"))
    try:
        t0 = time.perf_counter()
        write_pretrain_dbs(work, 150, n_txt, SEED)
        out = os.path.join(work, "run")
        datasets = [{"name": c, "db": os.path.join(work, f"txt_{c}"),
                     "img": os.path.join(work, f"img_{c}"),
                     "tasks": ["mlm", "itm", "mrfr", "mrc-kl"],
                     "mix_ratio": [2, 2, 1, 1]} for c in ("a", "b")]
        conf = dict(
            train_datasets=datasets, val_datasets=datasets[:1],
            model_config=os.path.join(REPO, "configs", "uniter-base.json"),
            output_dir=out, num_train_steps=20, valid_steps=10, log_steps=5,
            train_batch_size=5120, val_batch_size=10240, n_workers=2,
            device="cuda", checkpoint="")
        path = os.path.join(work, "pretrain.json")
        with open(path, "w") as f:
            json.dump(conf, f)
        t1 = time.perf_counter()
        reset_launches()
        state = pretrain.main(parse_with_config(pretrain.get_parser(),
                                                ["--config", path]))
        counts = read_launches()
        check(state.step == 20, f"pretrain stopped at {state.step}")
        check(state.model.ot_impl == "cuda" and counts["ipot"] > 0
              and counts["layer_norm_fwd"] == 0
              and all(v > 0 for k, v in counts.items() if STEP_LAUNCHES[k]),
              f"pretrain's default flags did not run K1-K7: {counts}")
        del state
        t2 = time.perf_counter()
        state = pretrain.main(parse_with_config(
            pretrain.get_parser(),
            ["--config", path, "--num_train_steps", "25"]))
        check(state.step == 25, f"resumed run stopped at {state.step}")
        del state
        t3 = time.perf_counter()
        with open(os.path.join(out, "log", "log.txt")) as f:
            log = f.read()
        check("resumed from step 20" in log
              and "fast-forwarded task mix by 20 steps" in log,
              "the rerun did not resume and fast-forward the task mix")
        check("device: cuda" in log and "ot cuda" in log
              and "block_fusion cuda" in log,
              "the log does not name the device and the kernel policies")
        scalars = {}
        for line in open(os.path.join(out, "log", "scalars.jsonl")):
            rec = json.loads(line)
            for k, v in rec.items():
                if k != "step":
                    scalars.setdefault(k, []).append(v)
        valid = {k: v for k, v in scalars.items() if k in (
            "valid/mlm_a_acc", "valid/mrfr_a_loss", "valid/mrc-kl_a_acc",
            "valid/itm_a_acc")}
        # validated at steps 10 and 20; the resumed run ends at 25 with a
        # save and no validation
        check(len(valid) == 4 and all(
            len(v) == 2 and np.isfinite(v).all() for v in valid.values()),
            f"validation logs {valid}")
        train_losses = {k: v[-1] for k, v in scalars.items()
                        if k.startswith("loss/")}
        check(train_losses and np.isfinite(list(train_losses.values())).all(),
              f"training losses {train_losses}")
        ckpts = sorted(os.listdir(os.path.join(out, "ckpt")))
        print(f"[pretrain-cli] 2 corpora x {n_txt} captions over 150 images "
              f"each written in {t1 - t0:.1f} s; pretrain 20 steps (validate "
              f"+ save at 10, 20) {t2 - t1:.1f} s, launches {counts}; "
              f"resumed to 25 {t3 - t2:.1f} s; checkpoints {ckpts}; "
              f"validation {valid}; last training losses {train_losses}")
        return counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


# (rows, H): the retrieval train step (120 rows x 128 tokens), the flagship
# fine-tune rows, uniter-large widths, a ragged row count; D_mid = 4 H
K9_SHAPES = [(15360, 768), (9984, 768), (9984, 1024), (4097, 768)]
K9_TOL_FP32 = 1e-5  # of max(1, max|ref|): another fp32 summation order


def ffn_bound_ms(rows, h, dtype, mid=None, simt=False):
    """Least time for K9 on this card: 4 rows H D_mid FLOP (both products)
    at PRODUCT_FLOPS of the dtype (fp32: three TF32 passes; ``simt``: the
    FP32 units' rate, for comparison), against x and y (rows x H each), W1
    and W2 (H x D_mid each) in the dtype and the fp32 biases over the memory
    rate."""
    mid = mid or 4 * h
    elem = 4 if dtype == "float32" else 2
    nbytes = elem * (2 * rows * h + 2 * h * mid) + 4 * (h + mid)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 4 * rows * h * mid / (PEAK_FLOPS if simt else
                                   PRODUCT_FLOPS)[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def k9_phase(torch):
    """K9 against ``ffn_plain`` at K9_SHAPES, fp32 (1e-5 of max(1,
    max|ref|)) and bf16 (two bf16 steps of |ref| + 1e-3: fp32 sums in another
    order can re-round h), bitwise equal on a second run; at every shape the
    device and call times (``both_ms``) of the kernel and of the cuBLAS
    composition ``F.linear -> F.gelu -> F.linear`` (a yardstick, never on a
    path) in turns kernel, composition, composition, kernel, the plain
    version's call time, the bound, the achieved TFLOP/s and the share of
    the bound. Returns (worst fp32 err, {(rows, h, dtype): {"dev", "call",
    "lib_dev", "lib_call", "plain"} ms})."""
    import torch.nn.functional as F

    from uniter_tpu_torch.ops.ffn import ffn_fwd, ffn_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    worst, timing = 0.0, {}
    print("[K9] times, us per call: device (calls captured in one CUDA "
          "graph, replayed) / call (calls from Python, CUDA events); turns "
          "kernel, composition, composition, kernel")
    for rows, h in K9_SHAPES:
        mid = 4 * h
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            x = torch.randn(rows, h, generator=gen, device="cuda").to(dtype)
            w1 = (0.02 * torch.randn(mid, h, generator=gen, device="cuda")
                  ).to(dtype)
            w2 = (0.02 * torch.randn(h, mid, generator=gen, device="cuda")
                  ).to(dtype)
            b1 = 0.1 * torch.randn(mid, generator=gen, device="cuda")
            b2 = 0.1 * torch.randn(h, generator=gen, device="cuda")
            got = ffn_fwd(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            want = ffn_plain(x, w1, b1, w2, b2).float()
            diff = (got.float() - want).abs()
            if dname == "float32":
                bound = K9_TOL_FP32 * max(1.0, want.abs().max().item())
                label = f"tol {bound:.2e}"
            else:
                bound = 2.0**-6 * want.abs() + 1e-3
                label = "tol 2 bf16 steps (2^-6 |ref|) + 1e-3"
            excess = (diff - bound).max().item()
            again = torch.equal(got, ffn_fwd(x, w1, b1, w2, b2))
            ok = (excess <= 0 and again and got.dtype == dtype
                  and bool(torch.isfinite(got).all()))
            print(f"[K9] ({rows}, {h}) -> {mid} {dname}: max|diff| "
                  f"{diff.max().item():.3e} ({label}; worst excess over it "
                  f"{excess:.2e}); bitwise equal on a second run: {again} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"K9 disagrees with ffn_plain at {(rows, h)} {dname}")
            if dname == "float32":
                worst = max(worst, diff.max().item())
            del got, want, diff
            b1c, b2c = b1.to(dtype), b2.to(dtype)

            def kern():
                return ffn_fwd(x, w1, b1, w2, b2)

            def comp():
                return F.linear(F.gelu(F.linear(x, w1, b1c)), w2, b2c)

            # about 0.1 s a measurement: few calls of a slow kernel
            est = cuda_ms(torch, kern, 3, 1)
            n_call = int(min(500, max(5, 100.0 / est)))
            n_graph = int(min(50, max(3, 50.0 / est)))
            t = [both_ms(torch, f, n_graph=n_graph, n_call=n_call)
                 for f in (kern, comp, comp, kern)]
            plain = cuda_ms(torch, lambda: ffn_plain(x, w1, b1, w2, b2),
                            max(3, n_call // 10), 1)
            r = {"dev": (t[0][0] + t[3][0]) / 2,
                 "call": (t[0][1] + t[3][1]) / 2,
                 "lib_dev": (t[1][0] + t[2][0]) / 2,
                 "lib_call": (t[1][1] + t[2][1]) / 2, "plain": plain}
            timing[(rows, h, dname)] = r
            bms, by = ffn_bound_ms(rows, h, dname)
            tflops = 4 * rows * h * mid / (r["dev"] * 1e-3) / 1e12
            print(f"[K9]   ({rows}, {h}) {dname}: kernel "
                  f"{r['dev'] * 1e3:.1f} / {r['call'] * 1e3:.1f}; "
                  f"composition {r['lib_dev'] * 1e3:.1f} / "
                  f"{r['lib_call'] * 1e3:.1f}; turns "
                  + ", ".join(f"{d * 1e3:.1f}/{c * 1e3:.1f}" for d, c in t)
                  + f" ({n_graph} calls a graph, {n_call} from Python); "
                  f"plain call {plain * 1e3:.1f}; bound {bms * 1e3:.1f} "
                  f"({by}); kernel {tflops:.1f} TFLOP/s, "
                  f"{bms / r['dev'] * 100:.1f}% of the bound"
                  + (f" (at the FP32 units' 67 TFLOP/s the bound would read "
                     f"{ffn_bound_ms(rows, h, dname, simt=True)[0] * 1e3:.1f})"
                     if dname == "float32" else ""))
    return worst, timing


ITM_GROUPS, ITM_NEG = 40, 1  # configs/train-itm-flickr-base-tpu.json
ITM_T, ITM_R = 64, 64
# name -> (attention_impl, block_fusion, ffn_impl) before resolution
ITM_POLICIES = {"K1-K6": ("auto", "auto", "xla"),
                "K1-K6+K9": ("auto", "auto", "pallas")}


def itm_batch(torch, rows, t, r, img_dim, transfer_dtype, seed):
    """A fixed batch of ``rows`` rows: ragged text (8-``t`` tokens) and
    region (10-``r``) lengths, every row real."""
    from uniter_tpu_torch.training.loop import train_batch_to_device

    rng = np.random.RandomState(seed)
    attn = np.zeros((rows, t + r), np.int32)
    tl = rng.randint(8, t + 1, rows)
    nb = rng.randint(10, r + 1, rows)
    for i in range(rows):
        attn[i, :tl[i]] = 1
        attn[i, t:t + nb[i]] = 1
    batch = dict(
        input_ids=rng.randint(1, 28000, (rows, t)).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (rows, 1)),
        img_feat=rng.randn(rows, r, img_dim).astype(np.float32),
        img_pos_feat=rng.rand(rows, r, 7).astype(np.float32),
        attn_mask=attn, ex_weight=np.ones(rows, np.float32))
    return train_batch_to_device(batch, torch.device("cuda"), transfer_dtype)


def itm_state_dict(torch, cfg):
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
    from uniter_tpu_torch.utils.const import IMG_DIM

    return {k: torch.from_numpy(v) for k, v in state_dict_from_jax_params(
        jax_layout_params(cfg, 0, IMG_DIM, SEED, itm=True)).items()}


def make_itm_trainer(torch, cfg, sd, hard_size=None, accum=1):
    """The retrieval model and fused AdamW as ``train_itm`` builds them
    (fp32 moments, betas (0.9, 0.98), wd 0.01, clip 2.0, lr 5e-5 warmed up
    over 2000 of 20000 steps: the flickr recipe), with ``train_itm``'s loss
    (groups of 1 + 2 ITM_NEG) or, with ``hard_size``, the hard-negative
    model and loss over ``accum`` candidate batches a step."""
    from uniter_tpu_torch import train_itm, train_itm_hard_negatives
    from uniter_tpu_torch.models.itm import (
        UniterForImageTextRetrieval, UniterForImageTextRetrievalHardNeg)
    from uniter_tpu_torch.training.optim import build_optimizer
    from uniter_tpu_torch.training.sched import get_lr_schedule
    from uniter_tpu_torch.training.step import TrainState, make_train_step
    from uniter_tpu_torch.utils.const import IMG_DIM

    if hard_size is None:
        model = UniterForImageTextRetrieval(cfg, IMG_DIM)
        sample = 1 + 2 * ITM_NEG
        step = make_train_step(lambda m, b, g: (
            train_itm.rank_loss(m, b, g, sample), {}))
    else:
        model = UniterForImageTextRetrievalHardNeg(cfg, IMG_DIM,
                                                   hard_size=hard_size)
        step = make_train_step(train_itm_hard_negatives.hard_neg_loss,
                               loss_scale="mean", accum_steps=accum)
    model.load_state_dict(sd, strict=True)
    model.to("cuda")
    opt = build_optimizer(model, get_lr_schedule(5e-5, 2000, 20000),
                          betas=(0.9, 0.98), weight_decay=0.01,
                          grad_norm=2.0, fused=True)
    return TrainState(step=0, model=model, opt=opt), step


def itm_configs(base, policies=ITM_POLICIES):
    from uniter_tpu_torch.config import resolve_kernel_policies

    cfgs = {name: resolve_kernel_policies(
        base.replace(attention_impl=att, block_fusion=bf, ffn_impl=ffn),
        "cuda", training=True) for name, (att, bf, ffn) in policies.items()}
    got = {n: (c.attention_impl, c.block_fusion, c.ffn_impl)
           for n, c in cfgs.items()}
    want = {n: tuple("cuda" if v in ("auto", "pallas") else v for v in p)
            for n, p in policies.items()}
    check(got == want, f"the retrieval policies resolved to {got}")
    return cfgs


def itm_train_phase(torch):
    """The retrieval fine-tune step at the flickr recipe's shape under
    K1-K6 (the FFN unfused) and K1-K6 + K9 in turns: launches per step,
    step-1 agreement, examples/s; then the 2-layer fp32 runs."""
    from uniter_tpu_torch.config import base_config
    from uniter_tpu_torch.utils.const import IMG_DIM

    rows = ITM_GROUPS * (1 + 2 * ITM_NEG)
    base = base_config(dtype="bfloat16", hidden_dropout_prob=RATE,
                       attention_probs_dropout_prob=RATE)
    sd = itm_state_dict(torch, base)
    batch = itm_batch(torch, rows, ITM_T, ITM_R, IMG_DIM, torch.bfloat16, 2)
    trainers = {n: make_itm_trainer(torch, c, sd)
                for n, c in itm_configs(base).items()}
    losses = {n: [] for n in trainers}

    def run(name, n):
        state, step = trainers[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = [step(state, batch, SEED)[1]["loss"] for _ in range(n)]
        losses[name] += [float(v) for v in ms]  # the readback ends the turn
        return time.perf_counter() - t0

    counts = {}
    for name in trainers:  # step 1 and 2 of each, counted
        reset_launches()
        run(name, 2)
        counts[name] = {k: v / 2 for k, v in read_launches().items()}
    want = {**STEP_LAUNCHES, "ffn_fwd": 12}
    check(counts["K1-K6+K9"] == want and counts["K1-K6"] == STEP_LAUNCHES,
          f"retrieval launches per step {counts}")
    first = {n: v[0] for n, v in losses.items()}
    rel = abs(first["K1-K6+K9"] - first["K1-K6"]) / abs(first["K1-K6"])
    secs = {n: [] for n in trainers}
    order = ("K1-K6", "K1-K6+K9", "K1-K6+K9", "K1-K6")
    for _ in range(3):
        for name in order:
            secs[name].append(run(name, 5))
    eps = {n: 5 * ITM_GROUPS / float(np.median(v)) for n, v in secs.items()}
    print(f"[itm] uniter-base retrieval step, {ITM_GROUPS} groups x "
          f"{1 + 2 * ITM_NEG} rows = {rows} rows, {ITM_T} text + {ITM_R} "
          f"image tokens (ragged), bf16 over fp32 parameters, dropout {RATE}, "
          f"fused AdamW: examples (groups)/s " + ", ".join(
              f"{n} {v:.1f}" for n, v in eps.items())
          + " (median over 6 turns of 5 steps, in the order "
          + ", ".join(order) + " three times; host clock, each turn ends in "
          "the loss readback; turn seconds " + "; ".join(
              f"{n} " + ", ".join(f"{x:.3f}" for x in v)
              for n, v in secs.items()) + ")")
    print(f"[itm] launches per step {counts['K1-K6+K9']} (K1-K6+K9), "
          f"{counts['K1-K6']} (K1-K6); step-1 loss K1-K6 "
          f"{first['K1-K6']:.6f}, K1-K6+K9 {first['K1-K6+K9']:.6f}, relative "
          f"diff {rel:.2e} (tol 1e-2: bf16 roundings of the FFN placed "
          f"differently in 12 layers, under a margin loss near 0.2)")
    check(all(np.isfinite(v).all() for v in losses.values()),
          "retrieval: non-finite loss")
    check(rel <= 1e-2, "retrieval: step-1 losses differ with K9")
    prof = {}
    for name in ("K1-K6+K9", "K1-K6"):
        state, step = trainers[name]
        prof[name] = profile_steps(
            torch, state, step, batch, 3,
            "itm_" + name.replace("+", "_").replace("-", "_"), "itm")[1]
    del trainers
    torch.cuda.empty_cache()
    small = itm_two_layer_runs(torch)
    return {"launches": counts["K1-K6+K9"], "ex_per_s": eps,
            "k9_launches": int(2 * counts["K1-K6+K9"]["ffn_fwd"]),
            "step1_rel": rel, "profile": prof, "two_layer": small}


def itm_two_layer_runs(torch):
    """2 layers at base width in fp32, dropout 0.1, 3 steps: K1-K9 (every
    policy on: attention, fused tails, K8 LayerNorms, K9 FFN) against plain,
    losses held to 1e-5 relative (fp32 rounding of other summation orders)."""
    from uniter_tpu_torch.config import base_config
    from uniter_tpu_torch.utils.const import IMG_DIM

    cfg = base_config(num_hidden_layers=2, dtype="float32",
                      hidden_dropout_prob=RATE,
                      attention_probs_dropout_prob=RATE)
    sd = itm_state_dict(torch, cfg)
    rows = ITM_GROUPS * (1 + 2 * ITM_NEG)
    batch = itm_batch(torch, rows, ITM_T, ITM_R, IMG_DIM, None, 3)
    cfgs = itm_configs(cfg, {"plain": ("xla", "none", "xla"),
                             "K1-K9": ("auto", "auto", "pallas")})
    cfgs["K1-K9"] = cfgs["K1-K9"].replace(layer_norm_impl="cuda")
    losses, counts = {}, {}
    for name, c in cfgs.items():
        reset_launches()
        state, step = make_itm_trainer(torch, c, sd)
        losses[name] = [float(step(state, batch, SEED)[1]["loss"])
                        for _ in range(3)]
        counts[name] = read_launches()
    check(counts["K1-K9"]["ffn_fwd"] == 6 and counts["K1-K9"]["mha_bwd"] == 6
          and counts["K1-K9"]["layer_norm_fwd"] > 0
          and not any(counts["plain"].values()),
          f"2-layer retrieval launches {counts}")
    rel = max(abs(a - c) / abs(c)
              for a, c in zip(losses["K1-K9"], losses["plain"]))
    print(f"[itm] fp32, dropout {RATE}, 2 layers, 3 steps: losses K1-K9 "
          f"{losses['K1-K9']}, plain {losses['plain']}; max relative diff "
          f"{rel:.2e} (tol 1e-5); K1-K9 launches {counts['K1-K9']}")
    check(rel <= 1e-5, "2-layer fp32 retrieval through K1-K9 differs")
    return rel


HN_CAND, HN_HARD, HN_ACCUM = 64, 31, 2


def hn_phase(torch):
    """The hard-negative step at uniter-base: 64 candidates (one positive,
    63 negatives), hard_size 31, 2 candidate batches a step. fp32: the two
    policies mine the same candidates; bf16: one step each, losses, K9
    launches (12 scoring + 12 training per candidate batch)."""
    from uniter_tpu_torch.config import base_config
    from uniter_tpu_torch.utils.const import IMG_DIM

    out = {}
    for dname, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        base = base_config(dtype=dname, hidden_dropout_prob=RATE,
                           attention_probs_dropout_prob=RATE)
        sd = itm_state_dict(torch, base)
        cands = [itm_batch(torch, HN_CAND, ITM_T, ITM_R, IMG_DIM, dtype,
                           10 + i) for i in range(HN_ACCUM)]
        stacked = {k: torch.stack([c[k] for c in cands]) for k in cands[0]}
        res = {}
        for name, c in itm_configs(base).items():
            state, step = make_itm_trainer(torch, c, sd, HN_HARD, HN_ACCUM)
            if dname == "bfloat16":  # what the step will mine, uncounted
                model = state.model
                res[name + " mined"] = model.mine(cands[0]).tolist()
                with torch.no_grad():
                    model.eval()
                    res[name + " sig"] = torch.sigmoid(
                        model.predict(cands[0])[:, 0])
                    model.train()
            reset_launches()
            if dname == "float32":
                res[name] = [state.model.mine(b).tolist() for b in cands]
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[name] = float(step(state, stacked, SEED)[1]["loss"])
                res[name + " s"] = time.perf_counter() - t0
            res[name + " launches"] = read_launches()["ffn_fwd"]
            del state, step
        torch.cuda.empty_cache()
        out[dname] = res
    f32, b16 = out["float32"], out["bfloat16"]
    same = all(set(a) == set(b) for a, b in zip(f32["K1-K6"],
                                                f32["K1-K6+K9"]))
    order = f32["K1-K6"] == f32["K1-K6+K9"]
    rel = abs(b16["K1-K6+K9"] - b16["K1-K6"]) / abs(b16["K1-K6"])
    overlap = len(set(b16["K1-K6 mined"]) & set(b16["K1-K6+K9 mined"]))
    d_sig = (b16["K1-K6+K9 sig"] - b16["K1-K6 sig"]).abs().max().item()
    print(f"[hn] hard negatives, uniter-base, {HN_CAND} candidates, hard_size "
          f"{HN_HARD}, {HN_ACCUM} candidate batches a step: fp32 mined sets "
          f"equal across K9 on/off: {same} (order equal: {order}; first "
          f"batch K9 {f32['K1-K6+K9'][0][:8]}...); K9 launches mining fp32 "
          f"{f32['K1-K6+K9 launches']} (12 per candidate batch); bf16: the "
          f"two policies' sigmoid scores differ by up to {d_sig:.2e}, their "
          f"mined sets share {overlap} of {HN_HARD + 1} candidates; step-1 "
          f"loss K1-K6 {b16['K1-K6']:.6f}, K1-K6+K9 {b16['K1-K6+K9']:.6f}, "
          f"relative diff {rel:.2e} (tol 5e-2: at bf16 near-ties swap in and "
          f"out of the mined set, and each swap moves a triplet term by its "
          f"score gap, on top of the step's own bf16 rounding); K9 "
          f"launches per step {b16['K1-K6+K9 launches']} (want "
          f"{HN_ACCUM} x (12 scoring + 12 training)); step 1 "
          f"{b16['K1-K6 s'] * 1e3:.1f} ms / {b16['K1-K6+K9 s'] * 1e3:.1f} ms "
          f"(first step, host clock)")
    check(same, "hard negatives: the mined sets differ with K9 at fp32")
    check(f32["K1-K6+K9 launches"] == 12 * HN_ACCUM
          and f32["K1-K6 launches"] == 0
          and b16["K1-K6+K9 launches"] == 24 * HN_ACCUM,
          f"hard-negative K9 launches {out}")
    check(np.isfinite([b16["K1-K6"], b16["K1-K6+K9"]]).all() and rel <= 5e-2,
          "hard negatives: bf16 losses differ with K9")
    return {"launches": b16["K1-K6+K9 launches"], "same": same,
            "rel": rel, "overlap": overlap, "d_sig": d_sig}


class InMemoryItmEval:
    """A retrieval eval corpus made from a seed (``n_txt`` captions of 8-60
    tokens, ``n_img`` images of 10-100 regions of fp16 features), duck-typing
    what ``fast_score_matrix`` and ``itm_eval`` read of an
    ``ItmEvalDataset``: caption i describes image i % n_img (an image that
    no caption describes counts for no text-retrieval recall)."""

    def __init__(self, n_txt, n_img, img_dim, seed):
        rng = np.random.default_rng(seed)
        self.ids = [f"t{i}" for i in range(n_txt)]
        self.all_img_ids = [f"i{j}" for j in range(n_img)]
        self.txt2img = {t: f"i{i % n_img}" for i, t in enumerate(self.ids)}
        self.img2txts = {im: [] for im in self.all_img_ids}
        for t, im in self.txt2img.items():
            self.img2txts[im].append(t)
        self._txt = [rng.integers(1000, 28996, int(n)).astype(np.int32)
                     for n in rng.integers(6, 59, n_txt)]
        nbb = rng.integers(10, 101, n_img)
        self._img = [(rng.standard_normal((int(n), img_dim),
                                          dtype=np.float32).astype(np.float16),
                      rng.random((int(n), 7), dtype=np.float32))
                     for n in nbb]
        self.txt_db = self
        self.img_db = self

    def combine_inputs(self, ids):
        return np.concatenate([[101], ids, [102]]).astype(np.int32)

    def example(self, i):
        return {"input_ids": self._txt[i]}

    def get_img_feat(self, name):
        feat, pos = self._img[int(name[1:])]
        return feat, pos, feat.shape[0]


def itm_serve_phase(torch, n_txt=32, n_img=64):
    """``fast_score_matrix`` (the default ``inf_itm`` path: pre-embedded
    corpus, CLS-only last layer) at uniter-base over an in-memory corpus,
    fp32 and bf16, through K1 + K9 and the tails' K3/K5 at rate 0, and
    through the plain attention, FFN and tails (``plain_tails``), in
    turns."""
    from uniter_tpu_torch.config import base_config, resolve_kernel_policies
    from uniter_tpu_torch.models.itm import UniterForImageTextRetrieval
    from uniter_tpu_torch.utils.const import IMG_DIM
    from uniter_tpu_torch.utils.itm_eval import itm_eval
    from uniter_tpu_torch.utils.itm_fast import fast_score_matrix

    ds = InMemoryItmEval(n_txt, n_img, IMG_DIM, SEED)
    tile = dict(txt_tile=32, img_tile=64)
    n_calls = -(-n_txt // 32) * -(-n_img // 64)
    out = {}
    for dname in ("float32", "bfloat16"):
        base = base_config(dtype=dname)
        sd = itm_state_dict(torch, base)
        models = {}
        for name, att, ffn in (("K1+K9", "pallas", "pallas"),
                               ("plain", "xla", "xla")):
            m = UniterForImageTextRetrieval(resolve_kernel_policies(
                base.replace(attention_impl=att, ffn_impl=ffn), "cuda"),
                IMG_DIM)
            m.load_state_dict(sd, strict=True)
            models[name] = m.to("cuda").eval()

        def run(name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with plain_tails(name == "plain"):
                mat, ids = fast_score_matrix(models[name], ds, 64, 64,
                                             dtype=dname, **tile)
            return mat, ids, time.perf_counter() - t0

        run("plain")  # warm-up
        reset_launches()
        mat_k, ids, _ = run("K1+K9")
        counts = read_launches()
        reset_launches()
        mat_x = run("plain")[0]
        check(all(v == 0 for v in read_launches().values()),
              f"retrieval serving {dname}: the plain path launched a kernel")
        want = {k: 0 for k in KERNELS}
        # K3 at the 22 residual tails of a tile and the CLS layer's 2, K5
        # at each text tile's and each image chunk's embedding tail
        want.update(mha_fwd=11 * n_calls, ffn_fwd=11 * n_calls,
                    drop_res_ln_fwd=24 * n_calls,
                    ln_drop_fwd=-(-n_txt // 32) + -(-n_img // 64))
        check(counts == want, f"retrieval serving {dname} launched {counts}, "
              f"want {want}")
        secs = {"plain": [], "K1+K9": []}
        for name in ("plain", "K1+K9", "K1+K9", "plain"):
            secs[name].append(run(name)[2])
        pps = {n: n_txt * n_img * len(v) / sum(v) for n, v in secs.items()}
        err = float(np.abs(mat_k - mat_x).max())
        rec = {n: itm_eval(m, ids, ds.all_img_ids, ds.txt2img, ds.img2txts)
               for n, m in (("K1+K9", mat_k), ("plain", mat_x))}
        tol = 1e-4 if dname == "float32" else 5e-2
        print(f"[itm-serve] {dname}: {n_txt} texts x {n_img} images "
              f"({n_calls} tile call(s) of 32 x 64 pairs, 64 text + 64 image "
              f"tokens), scores max|diff| K1+K9+K3/K5 vs plain (no kernel) "
              f"{err:.3e} (tol "
              f"{tol:g}); r_mean K1+K9 {rec['K1+K9']['r_mean']:.4f}, plain "
              f"{rec['plain']['r_mean']:.4f} (equal: "
              f"{rec['K1+K9'] == rec['plain']}); pairs/s K1+K9 "
              f"{pps['K1+K9']:.1f}, plain {pps['plain']:.1f} (turns plain, "
              f"kernel, kernel, plain; host clock, each call ends in the "
              f"matrix's readback); launches {counts} (11 K1 and 11 K9 per "
              f"tile call: the CLS-only last layer takes neither; K3 at its "
              f"24 tails, K5 at the text tile's and the image chunk's)")
        check(np.isfinite(mat_k).all() and mat_k.shape == (n_txt, n_img),
              "retrieval scores not finite or misshapen")
        check(err <= tol, f"retrieval serving {dname} scores differ by {err}")
        if dname == "float32":
            check(rec["K1+K9"] == rec["plain"],
                  "retrieval recalls differ at fp32")
        out[dname] = {"launches": counts, "pairs_per_s": pps, "err": err}
        del models
        torch.cuda.empty_cache()
    return out


def write_itm_dbs(root, n_img, n_txt, n_val, seed):
    """An img DB of ``n_img`` images (10-100 regions of fp16 2048-d
    features, boxes, conf) and two txt DBs, ``txt`` (``n_txt`` captions)
    and ``txt_val`` (``n_val`` captions of the first ``n_val`` images), caption
    i describing image i % n_img, with the port's writers."""
    from uniter_tpu_torch.data.img_db import write_img_db
    from uniter_tpu_torch.data.txt_db import write_txt_db

    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((8192, 2048), dtype=np.float32).astype(
        np.float16)
    names = [f"flickr30k_{i:06d}.npz" for i in range(n_img)]

    def records():
        for n in names:
            nbb = int(rng.integers(10, 101))
            o = int(rng.integers(0, 8192 - nbb))
            yield n, dict(
                features=pool[o:o + nbb],
                norm_bb=rng.random((nbb, 6), dtype=np.float32).astype(
                    np.float16),
                conf=np.linspace(1, 0.3, nbb).astype(np.float16),
                soft_labels=np.zeros((nbb, 1601), np.float16))

    write_img_db(os.path.join(root, "img"), records(), conf_th=0.2,
                 max_bb=100, min_bb=10)
    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [999, 28996]}
    for db, n, off in (("txt", n_txt, 0), ("txt_val", n_val, n_txt)):
        recs, t2i = {}, {}
        for i in range(n):
            name = names[i % n_img]
            recs[f"c{off + i}"] = dict(
                input_ids=[int(x) for x in rng.integers(
                    999, 28996, int(rng.integers(6, 41)))],
                img_fname=name)
            t2i[f"c{off + i}"] = name
        write_txt_db(os.path.join(root, db), recs, meta, t2i)


def itm_cli_phase(torch):
    """``train_itm.main`` (uniter-base, a model config with ``"ffn_impl":
    "pallas"``) for 20 steps, validating and saving at 10 and 20, a resume
    to 25, ``inf_itm.main`` on the run, and ``train_itm_hard_negatives.main``
    for 4 steps, all on the card."""
    from uniter_tpu_torch import inf_itm, train_itm, train_itm_hard_negatives
    from uniter_tpu_torch.utils.misc import parse_with_config

    os.makedirs(os.path.join(REPO, "tmp"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_itm_",
                            dir=os.path.join(REPO, "tmp"))
    try:
        t0 = time.perf_counter()
        write_itm_dbs(work, 100, 500, 32, SEED)
        with open(os.path.join(REPO, "configs", "uniter-base.json")) as f:
            model_json = dict(json.load(f), ffn_impl="pallas")
        model_path = os.path.join(work, "uniter-base-ffn.json")
        with open(model_path, "w") as f:
            json.dump(model_json, f)
        out = os.path.join(work, "run")
        conf = dict(
            train_txt_dbs=[os.path.join(work, "txt")],
            train_img_dbs=[os.path.join(work, "img")],
            val_txt_db=os.path.join(work, "txt_val"),
            val_img_db=os.path.join(work, "img"), model_config=model_path,
            output_dir=out, num_train_steps=20, valid_steps=10, log_steps=5,
            train_batch_size=8192, inf_minibatch_size=40, negative_size=1,
            n_workers=2, device="cuda", checkpoint="", warmup_steps=2000,
            learning_rate=5e-5)
        path = os.path.join(work, "train_itm.json")
        with open(path, "w") as f:
            json.dump(conf, f)
        t1 = time.perf_counter()
        reset_launches()
        state = train_itm.main(parse_with_config(train_itm.get_parser(),
                                                 ["--config", path]))
        counts = read_launches()
        check(state.step == 20, f"train_itm stopped at {state.step}")
        check(counts["ffn_fwd"] > 0 and counts["mha_bwd"] > 0,
              f"train_itm did not run K9 and K2: {counts}")
        del state
        t2 = time.perf_counter()
        state = train_itm.main(parse_with_config(
            train_itm.get_parser(),
            ["--config", path, "--num_train_steps", "25"]))
        check(state.step == 25, f"resumed run stopped at {state.step}")
        del state
        t3 = time.perf_counter()
        with open(os.path.join(out, "log", "log.txt")) as f:
            log = f.read()
        check("resumed from step 20" in log and "device: cuda" in log
              and "ffn cuda" in log,
              "train_itm's log does not name the resume, the device and "
              "ffn cuda")
        valid = [json.loads(line).get("valid/r_mean") for line in
                 open(os.path.join(out, "log", "scalars.jsonl"))]
        valid = [v for v in valid if v is not None]
        check(len(valid) == 2 and np.isfinite(valid).all(),
              f"train_itm validation {valid}")
        pred = os.path.join(work, "pred")
        reset_launches()
        logs = inf_itm.main(inf_itm.get_parser().parse_args(
            ["--txt_db", os.path.join(work, "txt_val"), "--img_db",
             os.path.join(work, "img"), "--train_dir", out, "--output_dir",
             pred, "--img_tile", "32"]))
        inf_counts = read_launches()
        t4 = time.perf_counter()
        mat = np.load(os.path.join(pred, "score_matrix.npz"))
        check(mat["score_matrix"].shape == (32, 32)
              and np.isfinite(mat["score_matrix"]).all()
              and np.isfinite(list(logs.values())).all()
              and inf_counts["ffn_fwd"] == 11,
              f"inf_itm: {mat['score_matrix'].shape}, {logs}, {inf_counts}")
        hn_out = os.path.join(work, "hn")
        hn = dict(conf, output_dir=hn_out, num_train_steps=4, valid_steps=4,
                  log_steps=2, train_batch_size=2, negative_size=31,
                  hard_neg_size=15)
        hn_path = os.path.join(work, "hn.json")
        with open(hn_path, "w") as f:
            json.dump(hn, f)
        reset_launches()
        state = train_itm_hard_negatives.main(parse_with_config(
            train_itm_hard_negatives.get_parser(), ["--config", hn_path]))
        hn_counts = read_launches()
        check(state.step == 4 and hn_counts["ffn_fwd"] > 0,
              f"train_itm_hard_negatives: step {state.step}, {hn_counts}")
        del state
        t5 = time.perf_counter()
        with open(os.path.join(hn_out, "log", "log.txt")) as f:
            check("ffn cuda" in f.read(), "the HN log does not say ffn cuda")
        print(f"[itm-cli] 500 + 32 captions over 100 images written in "
              f"{t1 - t0:.1f} s; train_itm 20 steps (validate + save at 10, "
              f"20) {t2 - t1:.1f} s, launches {counts}; resumed to 25 "
              f"{t3 - t2:.1f} s; validation r_mean {valid}; inf_itm (fp32, "
              f"fast path, 32 texts x 32 images) {t4 - t3:.1f} s, results "
              f"{logs}, launches "
              f"{inf_counts}; train_itm_hard_negatives 4 steps (32 "
              f"candidates, hard 15, 2 batches a step, validate + save at 4) "
              f"{t5 - t4:.1f} s, launches {hn_counts}; the logs name device "
              f"cuda and ffn cuda")
        return counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


VCR_OPTS = dict(  # configs/train-vcr-base-tpu.json
    max_txt_len=220, train_batch_size=4000, conf_th=0.2, max_bb=100,
    min_bb=10, num_bb=36, compressed_db=False)
RE_SHAPE = (128, 64, 100)  # configs/train-refcoco-base-tpu.json: B, T, R
_DBS = {}


def scratch_dir(prefix):
    """A directory under the checkout's tmp/, removed when the script
    exits."""
    import atexit

    os.makedirs(os.path.join(REPO, "tmp"), exist_ok=True)
    path = tempfile.mkdtemp(prefix=prefix, dir=os.path.join(REPO, "tmp"))
    atexit.register(shutil.rmtree, path, True)
    return path


def feature_records(rng, names, lo, hi, pool, soft):
    """(name, record) of fp16 2048-d features cut from ``pool``, ``lo``-``hi``
    regions, boxes, confidences above every threshold, soft labels."""
    for n in names:
        nbb = int(rng.integers(lo, hi + 1))
        o = int(rng.integers(0, len(pool) - nbb))
        yield n, dict(
            features=pool[o:o + nbb],
            norm_bb=rng.random((nbb, 6), dtype=np.float32).astype(np.float16),
            conf=np.linspace(1, 0.3, nbb).astype(np.float16),
            soft_labels=soft[o % (len(soft) - nbb):][:nbb])


def feature_pools(rng):
    pool = rng.standard_normal((8192, 2048), dtype=np.float32).astype(
        np.float16)
    soft = rng.random((1024, 1601), dtype=np.float32)
    soft /= soft.sum(1, keepdims=True)
    return pool, soft.astype(np.float16)


def write_vcr_txt(path, rng, n_q, gt_names, det_names):
    """A VCR txt DB of ``n_q`` questions of 8-30 tokens, 4 answers of 5-25
    and 4 rationales of 10-50, with ``id2len_qa.json`` and
    ``id2len_qar.json`` (prepro's lengths: question + longest answer (+
    longest rationale))."""
    from uniter_tpu_torch.data.txt_db import write_txt_db

    def ids(lo, hi):
        return [int(x) for x in rng.integers(999, 28996,
                                             int(rng.integers(lo, hi + 1)))]

    recs, t2i, qa, qar = {}, {}, {}, {}
    for i in range(n_q):
        pair = [gt_names[i % len(gt_names)], det_names[i % len(det_names)]]
        q, ans, rat = ids(8, 30), [ids(5, 25) for _ in range(4)], [
            ids(10, 50) for _ in range(4)]
        recs[f"vcr_{i}"] = dict(input_ids=q, input_ids_as=ans,
                                input_ids_rs=rat,
                                qa_target=int(rng.integers(0, 4)),
                                qar_target=int(rng.integers(0, 4)),
                                img_fname=pair)
        t2i[f"vcr_{i}"] = pair
        qa[f"vcr_{i}"] = len(q) + max(map(len, ans))
        qar[f"vcr_{i}"] = qa[f"vcr_{i}"] + max(map(len, rat))
    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [999, 28996]}
    write_txt_db(path, recs, meta, t2i)
    for name, obj in (("id2len_qa", qa), ("id2len_qar", qar)):
        with open(os.path.join(path, f"{name}.json"), "w") as f:
            json.dump(obj, f)


def vcr_dbs():
    """The VCR DBs of the vcr, vcr_serve and task_cli phases, written once
    under tmp/ with the port's writers: 300 images of ground-truth regions
    (2-20) and 300 of detected ones (10-100), a train txt DB of 600
    questions and a val txt DB of 64."""
    if "vcr" in _DBS:
        return _DBS["vcr"]
    from uniter_tpu_torch.data.img_db import write_img_db

    root = scratch_dir("chip_smoke_vcr_")
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 13)
    pool, soft = feature_pools(rng)
    gt = [f"vcr_gt_{i:05d}.npz" for i in range(300)]
    det = [f"vcr_det_{i:05d}.npz" for i in range(300)]
    write_img_db(os.path.join(root, "img_gt"),
                 feature_records(rng, gt, 2, 20, pool, soft), conf_th=-1,
                 num_bb=100)
    write_img_db(os.path.join(root, "img"),
                 feature_records(rng, det, 10, 100, pool, soft),
                 conf_th=0.2, max_bb=100, min_bb=10)
    write_vcr_txt(os.path.join(root, "txt"), rng, 600, gt, det)
    write_vcr_txt(os.path.join(root, "txt_val"), rng, 64, gt, det)
    print(f"[vcr] DBs written in {time.perf_counter() - t0:.1f} s: 300 gt "
          f"images (2-20 regions), 300 detected (10-100), 600 train and 64 "
          f"val questions (8-30 tokens, answers 5-25, rationales 10-50)")
    _DBS["vcr"] = root
    return root


def vcr_datasets(root, split=None):
    """``train_vcr``'s training dataset (qa and qar concatenated) or, with
    ``split``, its ``VcrEvalDataset`` over the val txt DB."""
    from types import SimpleNamespace

    from uniter_tpu_torch.data.datasets import ConcatDataset
    from uniter_tpu_torch.data.vcr import (VcrDataset, VcrEvalDataset,
                                           VcrTxtTokDb)
    from uniter_tpu_torch.training.driver import open_img_db

    opts = SimpleNamespace(**VCR_OPTS)
    imgs = dict(img_db_gt=open_img_db(os.path.join(root, "img_gt"), opts,
                                      gt=True),
                img_db=open_img_db(os.path.join(root, "img"), opts))
    if split is not None:
        return VcrEvalDataset(split, VcrTxtTokDb(
            os.path.join(root, "txt_val"), max_txt_len=-1, task="qa,qar"),
            **imgs)
    return ConcatDataset([VcrDataset(VcrTxtTokDb(
        os.path.join(root, "txt"), max_txt_len=VCR_OPTS["max_txt_len"],
        task=t), **imgs) for t in ("qa", "qar")]), opts


def vcr_batches(torch, root, n, transfer_dtype):
    """The first ``n`` batches of ``train_vcr``'s loader over the DB (the
    bucket grid and 4000-token budget of its config) and the batch of its
    largest bucket in one epoch, on the card."""
    from uniter_tpu_torch.data.loader import BucketLoader
    from uniter_tpu_torch.data.vcr import VcrDataset
    from uniter_tpu_torch.training.driver import bucket_spec
    from uniter_tpu_torch.training.loop import train_batch_to_device

    ds, opts = vcr_datasets(root)
    loader = BucketLoader(ds, bucket_spec(opts, ds), seed=SEED,
                          collate=VcrDataset.collate, drop_last=False)
    host, largest = [], None
    for b in loader:
        if len(host) < n:
            host.append(b)
        if largest is None or (b["attn_mask"].shape[1]
                               > largest["attn_mask"].shape[1]):
            largest = b
    loader.close()
    return [train_batch_to_device(b, torch.device("cuda"), transfer_dtype)
            for b in host + [largest]]


def make_task_trainer(torch, model, loss, lr, warmup, total,
                      lr_mul_paths=(), loss_scale="sum"):
    """Fused AdamW with bf16 moments (betas (0.9, 0.98), eps 1e-6, wd 0.01,
    clip 2.0), the task's schedule, and its step."""
    from uniter_tpu_torch.training.optim import build_optimizer
    from uniter_tpu_torch.training.sched import get_lr_schedule
    from uniter_tpu_torch.training.step import TrainState, make_train_step

    model.to("cuda")
    opt = build_optimizer(model, get_lr_schedule(lr, warmup, total),
                          betas=(0.9, 0.98), eps=1e-6, weight_decay=0.01,
                          grad_norm=2.0, fused=True, mu_dtype=torch.bfloat16,
                          nu_dtype=torch.bfloat16,
                          lr_mul_paths=lr_mul_paths)
    return (TrainState(step=0, model=model, opt=opt),
            make_train_step(lambda m, b, g: (loss(m, b, g), {}),
                            loss_scale=loss_scale))


def two_policy_configs(base):
    cfgs = policy_configs(base)
    cfgs.pop("K1/K2")
    return cfgs


def vcr_model(torch, cfg, sd):
    from uniter_tpu_torch.models.vcr import UniterForVisualCommonsenseReasoning
    from uniter_tpu_torch.utils.const import IMG_DIM

    model = UniterForVisualCommonsenseReasoning(cfg, IMG_DIM)
    model.load_state_dict(sd, strict=True)
    return model


def vcr_config(**kw):
    from uniter_tpu_torch.config import base_config
    from uniter_tpu_torch.models.vcr import NUM_SPECIAL_TOKENS

    return base_config(type_vocab_size=4,
                       vocab_size=28996 + NUM_SPECIAL_TOKENS, **kw)


def task_state_dict(torch, cfg, head):
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
    from uniter_tpu_torch.utils.const import IMG_DIM

    return {k: torch.from_numpy(v) for k, v in state_dict_from_jax_params(
        jax_layout_params(cfg, 0, IMG_DIM, SEED, head=head)).items()}


def vcr_phase(torch):
    """The VCR fine-tune step at uniter-base (4 type rows, 28996 + 81
    words) on batches of ``train_vcr``'s loader (qa and qar, 4000 tokens),
    bf16, dropout 0.1, under plain and K1-K6 in turns; launches per step,
    step-1 agreement, rows/s, a profile of the largest bucket, and 2-layer
    fp32 runs of K1-K6 against plain."""
    from uniter_tpu_torch.train_vcr import vcr_loss

    root = vcr_dbs()
    base = vcr_config(dtype="bfloat16", hidden_dropout_prob=RATE,
                      attention_probs_dropout_prob=RATE)
    sd = task_state_dict(torch, base, "vcr")
    batches = vcr_batches(torch, root, 6, torch.bfloat16)
    largest = batches.pop()
    shapes = sorted({tuple(b["attn_mask"].shape) for b in batches})
    b_l, s_l = largest["attn_mask"].shape
    print(f"[vcr] {len(batches)} batches of rows x (T + R) {shapes}; the "
          f"largest bucket of the epoch ({b_l}, {s_l}); K1/K2 at the "
          f"config's largest bucket {TRAIN_SHAPES[-1]} are in the k2 phase")
    trainers = {name: make_task_trainer(
        torch, vcr_model(torch, cfg, sd), vcr_loss, 6e-5, 800, 8000)
        for name, cfg in two_policy_configs(base).items()}
    secs, losses, rows, total, steps = run_policies(torch, trainers, batches,
                                                    len(batches))
    rps = {n: rows[n] / sum(v) for n, v in secs.items()}
    print(f"[vcr] uniter-base VCR step, bf16 over fp32 parameters, dropout "
          f"{RATE}, fused AdamW bf16 moments: rows/s " + ", ".join(
              f"{n} {v:.1f}" for n, v in rps.items())
          + f" (turns of {len(batches)} steps: plain, K1-K6, K1-K6, plain; "
          "host clock, each turn ends in the loss readback)")
    check_launches(total, steps, STEP_LAUNCHES, "vcr")
    rel1 = step1_agreement(losses, "vcr", int(batches[0]["ex_weight"].sum()),
                           2)
    busy = {}
    for name in ("K1-K6", "plain"):
        state, step = trainers[name]
        busy[name] = profile_steps(torch, state, step, largest, 3,
                                   "vcr_" + name.replace("/", "_"),
                                   label="vcr")[1]
    print(f"[vcr] largest bucket ({b_l}, {s_l}): device busy ms a step "
          + ", ".join(f"{n} {v['busy_ms'] / 3:.2f}" for n, v in busy.items())
          + "; wall ms a step " + ", ".join(
              f"{n} {v['wall_ms'] / 3:.2f}" for n, v in busy.items()))
    del trainers
    torch.cuda.empty_cache()
    small = task_two_layer(torch, "vcr", batches[0], vcr_loss,
                           vcr_config(**TWO_LAYER), "vcr", vcr_model)
    return {"launches": total, "steps": steps, "rows_per_s": rps,
            "step1_rel": rel1, "two_layer": small, "largest": (b_l, s_l)}


TWO_LAYER = dict(num_hidden_layers=2, dtype="float32",
                 hidden_dropout_prob=RATE, attention_probs_dropout_prob=RATE)


def task_two_layer(torch, tag, batch, loss, base, head, make_model):
    """2 layers at base width in fp32 (``base``), dropout 0.1, 3 steps of
    K1-K6 and of plain on one batch: losses within 1e-5 relative, the fused
    tails launched on the K1-K6 path."""
    batch = {k: v.float() if v.is_floating_point() else v
             for k, v in batch.items()}
    sd = task_state_dict(torch, base, head)
    losses = {}
    for name, cfg in two_policy_configs(base).items():
        reset_launches()
        state, step = make_task_trainer(torch, make_model(torch, cfg, sd),
                                        loss, 1e-4, 10, 100)
        losses[name] = [float(step(state, batch, SEED)[1]["loss"])
                        for _ in range(3)]
        tails = sum(v for k, v in read_launches().items()
                    if not k.startswith("mha"))
        check((tails > 0) == (name == "K1-K6"),
              f"{tag} 2-layer {name}: {tails} tail launches")
    rel = max(abs(a - c) / abs(c) for a, c in zip(losses["K1-K6"],
                                                  losses["plain"]))
    print(f"[{tag}] fp32, dropout {RATE}, 2 layers, 3 steps: losses "
          + "; ".join(f"{n} {v}" for n, v in losses.items())
          + f"; max relative diff {rel:.2e} (tol 1e-5)")
    check(rel <= 1e-5, f"{tag}: fp32 losses differ from plain")
    return rel


def vcr_serve_phase(torch):
    """``inf_vcr``'s loop in fp32 over the val and test splits of the VCR
    DB, through K1 and the tails' K3/K5 at rate 0, and through the plain
    attention and tails (``plain_tails``): launches (K1 12 a batch, K3 24
    and K5 2, nothing else), the same argmax in every qa and qar group,
    scores within 1e-3, examples/s."""
    from uniter_tpu_torch.config import resolve_kernel_policies
    from uniter_tpu_torch.data.buckets import spec_from_dataset
    from uniter_tpu_torch.data.loader import BucketLoader
    from uniter_tpu_torch.inf_vcr import score_examples
    from uniter_tpu_torch.train_vcr import score_groups
    from uniter_tpu_torch.training import infer

    root = vcr_dbs()
    base = vcr_config(dtype="float32")
    sd = task_state_dict(torch, base, "vcr")
    models = {impl: vcr_model(torch, resolve_kernel_policies(
        base.replace(attention_impl=impl), "cuda"), sd).cuda().eval()
        for impl in ("cuda", "xla")}
    out = {}
    for split in ("val", "test"):
        ds = vcr_datasets(root, split)
        loader = BucketLoader(ds, spec_from_dataset(ds, TOKEN_BUDGET),
                              shuffle=False, drop_last=False,
                              collate=ds.collate_fn)
        n_batches = len(loader)
        scores, secs = {}, {}
        for impl in ("xla", "cuda", "cuda", "xla"):
            if impl == "cuda":
                reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            groups = []
            with plain_tails(impl == "xla"):
                for batch, o in infer.eval_batches(
                        lambda b, m=models[impl]: m(b, False), loader,
                        "cuda"):
                    s = o.float().cpu().numpy()[:, 0]
                    groups += [(qa, qar)
                               for _, qa, qar in score_groups(batch, s)]
            secs.setdefault(impl, []).append(time.perf_counter() - t0)
            scores[impl] = groups
            if impl == "cuda":
                counts = read_launches()
                per = {"mha_fwd": 12, **serve_tails(base)}
                want = {k: per.get(k, 0) * n_batches for k in KERNELS}
                check(counts == want, f"vcr_serve {split}: launches {counts}"
                      f", want {want}")
        n_ex = len(scores["cuda"])
        check(n_ex == len(ds) == len(scores["xla"]), "example count")
        err, same = 0.0, True
        for (qa_k, qar_k), (qa_x, qar_x) in zip(scores["cuda"],
                                                scores["xla"]):
            check(np.isfinite(qa_k).all() and np.isfinite(qar_k).all(),
                  "non-finite scores")
            err = max(err, float(np.abs(qa_k - qa_x).max()),
                      float(np.abs(qar_k - qar_x).max()))
            same &= int(qa_k.argmax()) == int(qa_x.argmax())
            for g in range(0, len(qar_k), 4):
                same &= (int(qar_k[g:g + 4].argmax())
                         == int(qar_x[g:g + 4].argmax()))
        logs, rows = score_examples(models["cuda"], loader, "cuda", split)
        eps = {impl: n_ex * len(v) / sum(v) for impl, v in secs.items()}
        print(f"[vcr_serve] {split}: {n_ex} questions ({ds.rows_per_example} "
              f"rows each) in {n_batches} batches, fp32: K1 {12 * n_batches}"
              f", K3 {24 * n_batches}, K5 {2 * n_batches} launches, nothing "
              f"else; scores max|diff| against the plain attention and "
              f"tails {err:.3e} (tol 1e-3), same argmax in every qa/qar "
              f"group: {same}; "
              f"questions/s kernel {eps['cuda']:.1f}, plain {eps['xla']:.1f}"
              f" (turns plain, kernel, kernel, plain); inf_vcr "
              + (f"val {logs}" if split == "val" else
                 f"test {len(rows)} submission rows"))
        check(err <= 1e-3 and same, f"vcr_serve {split}: kernel and plain "
              "scores differ")
        check(split == "val" or len(rows) == n_ex, "submission rows")
        out[split] = {"err": err, "n_batches": n_batches, "q_per_s": eps}
    del models
    torch.cuda.empty_cache()
    return out


def re_batch(torch, b, t, r, img_dim, transfer_dtype, seed):
    """A fixed RE batch: expressions of 4-``t`` tokens, 10-``r`` gt
    regions, the target one of them, non-objects masked."""
    from uniter_tpu_torch.training.loop import train_batch_to_device

    rng = np.random.RandomState(seed)
    tl = rng.randint(4, t + 1, b)
    nb = rng.randint(10, r + 1, b)
    attn = np.concatenate([np.arange(t) < tl[:, None],
                           np.arange(r) < nb[:, None]], 1).astype(np.int32)
    batch = dict(
        input_ids=(rng.randint(1000, 28996, (b, t))
                   * (np.arange(t) < tl[:, None])).astype(np.int32),
        position_ids=np.tile(np.arange(t, dtype=np.int32), (b, 1)),
        img_feat=rng.randn(b, r, img_dim).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=attn, obj_masks=(np.arange(r) >= nb[:, None]),
        targets=(rng.rand(b) * nb).astype(np.int32),
        ex_weight=np.ones(b, np.float32))
    return train_batch_to_device(batch, torch.device("cuda"), transfer_dtype)


def re_model(torch, cfg, sd, **kw):
    from uniter_tpu_torch.models.re import (
        UniterForReferringExpressionComprehension)
    from uniter_tpu_torch.utils.const import IMG_DIM

    model = UniterForReferringExpressionComprehension(cfg, IMG_DIM, **kw)
    model.load_state_dict(sd, strict=True)
    return model


def re_phase(torch):
    """The RE fine-tune step at uniter-base on a fixed batch at
    ``configs/train-refcoco-base-tpu.json``'s shapes (128 expressions,
    ``max_txt_len`` 60, up to 100 gt regions), bf16, dropout 0.1: the cls
    loss under plain and K1-K6 in turns (launches per step, step-1
    agreement, examples/s), a 2-layer fp32 run; then 5 steps of the rank
    loss through K1-K6 with its negatives drawn on the card: finite
    losses, the hard share, easy negatives never the target or padding, a
    replay from the same (seed, step) drawing the same indices."""
    from uniter_tpu_torch.config import base_config
    from uniter_tpu_torch.models import re as re_mod
    from uniter_tpu_torch.train_re import re_loss
    from uniter_tpu_torch.utils.const import IMG_DIM

    b, t, r = RE_SHAPE
    base = base_config(dtype="bfloat16", hidden_dropout_prob=RATE,
                       attention_probs_dropout_prob=RATE)
    sd = task_state_dict(torch, base, "re1")
    batch = re_batch(torch, b, t, r, IMG_DIM, torch.bfloat16, SEED)
    trainers = {name: make_task_trainer(
        torch, re_model(torch, cfg, sd), re_loss, 1e-4, 1500, 24000,
        loss_scale="mean") for name, cfg in two_policy_configs(base).items()}
    secs, losses, rows, total, steps = run_policies(torch, trainers, [batch],
                                                    5)
    eps = {n: rows[n] / sum(v) for n, v in secs.items()}
    print(f"[re] uniter-base RE step (cls), B={b}, T={t}, R={r}, bf16, "
          f"dropout {RATE}: examples/s " + ", ".join(
              f"{n} {v:.1f}" for n, v in eps.items())
          + " (turns of 5 steps: plain, K1-K6, K1-K6, plain)")
    check_launches(total, steps, STEP_LAUNCHES, "re")
    rel1 = step1_agreement(losses, "re", b, r)
    del trainers
    torch.cuda.empty_cache()
    small = task_two_layer(torch, "re", batch, re_loss,
                           base_config(**TWO_LAYER), "re1", re_model)

    # the rank loss: every draw recorded with its generator's seed
    cfg = two_policy_configs(base)["K1-K6"]
    state, step = make_task_trainer(
        torch, re_model(torch, cfg, sd, loss_type="rank", hard_ratio=0.3),
        re_loss, 1e-4, 1500, 24000, loss_scale="mean")
    draws = []
    sample_neg = re_mod.sample_neg

    def recording(scores, targets, masks, ratio, generator, *block):
        seed = generator.initial_seed()
        neg = sample_neg(scores, targets, masks, ratio, generator, *block)
        draws.append((scores.clone(), targets.clone(), masks.clone(), seed,
                      neg.clone()))
        return neg

    re_mod.sample_neg = recording
    try:
        rank_losses = [float(step(state, batch, SEED)[1]["loss"])
                       for _ in range(5)]
    finally:
        re_mod.sample_neg = sample_neg
    check(len(draws) == 5 and all(np.isfinite(rank_losses)),
          f"rank loss: {rank_losses}, {len(draws)} draws")
    n_differ = n_hard = 0
    for scores, targets, masks, seed, neg in draws:
        def again(ratio):
            return sample_neg(scores, targets, masks, ratio,
                              torch.Generator("cuda").manual_seed(seed))

        check(torch.equal(again(0.3), neg), "a replay drew other indices")
        easy, hard = again(0.0), again(1.0)
        check(not (easy == targets.long()).any()
              and not masks.gather(1, easy[:, None]).any(),
              "an easy negative is the target or padding")
        check(((neg == hard) | (neg == easy)).all(), "a negative is neither")
        differ = easy != hard
        n_differ += int(differ.sum())
        n_hard += int((neg[differ] == hard[differ]).sum())
    share = n_hard / max(n_differ, 1)
    print(f"[re] rank loss, 5 steps through K1-K6: losses "
          f"{[round(x, 5) for x in rank_losses]}; hard share {share:.3f} "
          f"over {n_differ} draws where the two differ (hard_ratio 0.3 "
          f"+- 0.1); easy negatives never the target or padding; each "
          f"step's draw replayed bit for bit from its seed")
    check(abs(share - 0.3) <= 0.1, f"hard share {share}")
    del state, step
    torch.cuda.empty_cache()
    return {"launches": total, "steps": steps, "ex_per_s": eps,
            "step1_rel": rel1, "two_layer": small, "hard_share": share}


def write_re_dbs(root, n_img, seed):
    """A gt img DB of ``n_img`` images (3-60 regions) and two RE txt DBs
    (``txt``: 2 refs an image, 2 expressions of 3-20 tokens each; ``txt2``:
    the first half of the images), with the port's writers."""
    from uniter_tpu_torch.data.img_db import write_img_db
    from uniter_tpu_torch.data.re import gt_fname
    from uniter_tpu_torch.data.txt_db import write_txt_db

    rng = np.random.default_rng(seed)
    pool, soft = feature_pools(rng)
    ids = list(range(1000, 1000 + n_img))
    recs = list(feature_records(rng, [gt_fname(i) for i in ids], 3, 60, pool,
                                soft))
    write_img_db(os.path.join(root, "img"), recs, conf_th=0.2, max_bb=100,
                 min_bb=1)
    images, anns, sents, refs = [], [], {}, []
    for iid, (_, rec) in zip(ids, recs):
        n = len(rec["features"])
        bb = rec["norm_bb"].astype(np.float32)
        ann_ids = [iid * 1000 + k for k in range(n)]
        images.append(dict(id=iid, file_name=f"{iid}.jpg", ann_ids=ann_ids,
                           height=480, width=640))
        anns += [dict(id=a, area=100, image_id=iid, category_id=1,
                      iscrowd=0, bbox=[float(bb[k, 0] * 640),
                                       float(bb[k, 1] * 480),
                                       float(bb[k, 4] * 640),
                                       float(bb[k, 5] * 480)])
                 for k, a in enumerate(ann_ids)]
        for _ in range(2):
            k = int(rng.integers(0, n))
            sids = []
            for _ in range(2):
                sid = len(sents)
                sents[str(sid)] = dict(
                    sent_id=sid, ref_id=len(refs), ann_id=ann_ids[k],
                    image_id=iid, bbox=anns[-n + k]["bbox"],
                    input_ids=[int(x) for x in rng.integers(
                        999, 28996, int(rng.integers(3, 21)))],
                    img_fname=gt_fname(iid))
                sids.append(sid)
            refs.append(dict(ref_id=len(refs), ann_id=ann_ids[k],
                             image_id=iid, split="train", sent_ids=sids))
    meta = {"CLS": 101, "SEP": 102, "MASK": 103, "v_range": [999, 28996]}
    for name, keep in (("txt", set(ids)), ("txt2", set(ids[:n_img // 2]))):
        path = os.path.join(root, name)
        part = {k: s for k, s in sents.items() if s["image_id"] in keep}
        write_txt_db(path, part, meta,
                     {k: s["img_fname"] for k, s in part.items()})
        for fname, obj in (
                ("refs", [x for x in refs if x["image_id"] in keep]),
                ("annotations", [a for a in anns if a["image_id"] in keep]),
                ("categories", [dict(id=1, name="object")]),
                ("images", [i for i in images if i["id"] in keep])):
            with open(os.path.join(path, f"{fname}.json"), "w") as f:
                json.dump(obj, f)
    return len(sents)


def run_cli(module, conf, extra=()):
    """``module.main`` on a config JSON (as ``python -m`` runs it); the
    kernels' launches of the run."""
    from uniter_tpu_torch.utils.misc import parse_with_config

    path = conf.pop("_path")
    with open(path, "w") as f:
        json.dump(conf, f)
    reset_launches()
    state = module.main(parse_with_config(module.get_parser(),
                                          ["--config", path, *extra]))
    conf["_path"] = path
    return state, read_launches()


def task_cli_phase(torch):
    """The new CLIs end to end at uniter-base on the card, on DBs written
    with the port's writers: ``train_ve`` 5 steps and a resume to 7;
    ``train_re`` validating every 2 steps (the best export and its
    sidecar), then ``inf_re --ckpt best`` on two colon-separated splits;
    ``train_vcr --tasks qa,qar`` 4 steps, then ``inf_vcr`` on val and test;
    ``pretrain_vcr`` (mlm / mrfr / mrc-kl) 6 steps and a resume to 8."""
    from uniter_tpu_torch import (inf_re, inf_vcr, pretrain_vcr, train_re,
                                  train_ve, train_vcr)

    work = scratch_dir("chip_smoke_tasks_")
    model_config = os.path.join(REPO, "configs", "uniter-base.json")
    common = dict(model_config=model_config, device="cuda", checkpoint="",
                  n_workers=2, log_steps=2, moment_dtype="bfloat16")
    times = {}

    t0 = time.perf_counter()
    ve = os.path.join(work, "ve")
    write_vqa_dbs(ve, 100, 400, SEED, n_labels=3)
    out = os.path.join(ve, "run")
    conf = dict(common, _path=os.path.join(ve, "train.json"),
                train_txt_db=os.path.join(ve, "txt"),
                train_img_db=os.path.join(ve, "img"),
                val_txt_db=os.path.join(ve, "txt"),
                val_img_db=os.path.join(ve, "img"), output_dir=out,
                num_train_steps=5, valid_steps=5, train_batch_size=5120,
                val_batch_size=10240)
    state, ve_counts = run_cli(train_ve, conf)
    check(state.step == 5, f"train_ve stopped at {state.step}")
    check(state.model.vqa_output[3].weight.shape[0] == 3, "VE head width")
    del state
    state, _ = run_cli(train_ve, conf, ["--num_train_steps", "7"])
    check(state.step == 7, f"resumed train_ve stopped at {state.step}")
    del state
    with open(os.path.join(out, "log", "log.txt")) as f:
        check("resumed from step 5" in f.read(), "train_ve did not resume")
    times["train_ve"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    re_root = os.path.join(work, "re")
    n_sent = write_re_dbs(re_root, 80, SEED)
    out = os.path.join(re_root, "run")
    conf = dict(common, _path=os.path.join(re_root, "train.json"),
                train_txt_db=os.path.join(re_root, "txt"),
                train_img_db=os.path.join(re_root, "img"),
                val_txt_db=os.path.join(re_root, "txt"),
                val_img_db=os.path.join(re_root, "img"), output_dir=out,
                num_train_steps=4, valid_steps=2, train_batch_size=128,
                val_batch_size=8192, max_bb=100, min_bb=1, seed=24,
                warmup_steps=1500)
    state, re_counts = run_cli(train_re, conf)
    check(state.step == 4, f"train_re stopped at {state.step}")
    del state
    ckpt = os.path.join(out, "ckpt")
    with open(os.path.join(ckpt, "model_step_best.json")) as f:
        best = json.load(f)
    accs = [json.loads(line) for line in open(
        os.path.join(out, "log", "scalars.jsonl")) if "valid/acc" in line]
    check(os.path.exists(os.path.join(ckpt, "model_step_best.pt"))
          and best["value"] == max(a["valid/acc"] for a in accs),
          f"best export {best} vs validations {accs}")
    pred = os.path.join(re_root, "pred")
    acc = inf_re.main(inf_re.get_parser().parse_args([
        "--txt_db", os.path.join(re_root, "txt") + ":"
        + os.path.join(re_root, "txt2"),
        "--img_db", os.path.join(re_root, "img"), "--train_dir", out,
        "--output_dir", pred, "--use_gt_feat", "--ckpt", "best",
        "--device", "cuda"]))
    res = {n: json.load(open(os.path.join(pred, f"results_{n}_gt.json")))
           for n in ("txt", "txt2")}
    check(res["txt"]["n_ex"] == n_sent and len(res["txt"]["predictions"])
          == n_sent and res["txt2"]["n_ex"] == n_sent // 2,
          f"inf_re results {[(n, r['n_ex']) for n, r in res.items()]}")
    times["train_re + inf_re"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    root = vcr_dbs()
    out = os.path.join(work, "vcr_run")
    conf = dict(common, _path=os.path.join(work, "vcr.json"),
                train_txt_db=os.path.join(root, "txt"),
                train_img_db=os.path.join(root, "img"),
                train_img_db_gt=os.path.join(root, "img_gt"),
                val_txt_db=os.path.join(root, "txt_val"),
                val_img_db=os.path.join(root, "img"),
                val_img_db_gt=os.path.join(root, "img_gt"), output_dir=out,
                tasks="qa,qar", num_train_steps=4, valid_steps=4,
                train_batch_size=4000, val_batch_size=8192,
                **{k: VCR_OPTS[k] for k in ("max_txt_len", "conf_th",
                                            "max_bb", "min_bb", "num_bb")})
    state, vcr_counts = run_cli(train_vcr, conf)
    check(state.step == 4, f"train_vcr stopped at {state.step}")
    del state
    args = ["--txt_db", os.path.join(root, "txt_val"), "--img_db",
            os.path.join(root, "img"), "--img_db_gt",
            os.path.join(root, "img_gt"), "--train_dir", out,
            "--output_dir", os.path.join(work, "vcr_pred"), "--device",
            "cuda"]
    logs = inf_vcr.main(inf_vcr.get_parser().parse_args(args))
    csv_path = inf_vcr.main(inf_vcr.get_parser().parse_args(
        args + ["--split", "test"]))
    with open(csv_path) as f:
        sub = [line.strip().split(",") for line in f if line.strip()]
    check(logs["n_ex"] == 64 and len(sub) == 65 and len(sub[0]) == 21,
          f"inf_vcr: {logs}, {len(sub)} csv rows")
    times["train_vcr + inf_vcr"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = os.path.join(work, "pretrain_vcr")
    tasks = [{"name": "vcr", "db": os.path.join(root, "txt"),
              "vcr_task": "qar", "tasks": ["mlm", "mrfr", "mrc-kl"],
              "mix_ratio": [2, 1, 1]}]
    conf = dict(common, _path=os.path.join(work, "pretrain_vcr.json"),
                train_img_db=os.path.join(root, "img"),
                train_img_db_gt=os.path.join(root, "img_gt"),
                train_datasets=tasks, val_datasets=[], output_dir=out,
                num_train_steps=6, valid_steps=6, train_batch_size=6144,
                **{k: VCR_OPTS[k] for k in ("max_txt_len", "conf_th",
                                            "max_bb", "min_bb", "num_bb")})
    state, pre_counts = run_cli(pretrain_vcr, conf)
    check(state.step == 6, f"pretrain_vcr stopped at {state.step}")
    del state
    state, _ = run_cli(pretrain_vcr, conf, ["--num_train_steps", "8"])
    check(state.step == 8, f"resumed pretrain_vcr stopped at {state.step}")
    del state
    with open(os.path.join(out, "log", "log.txt")) as f:
        log = f.read()
    check("resumed from step 6" in log and "fast-forwarded task mix by 6"
          in log, "pretrain_vcr did not resume")
    times["pretrain_vcr"] = time.perf_counter() - t0
    counts = {"train_ve": ve_counts, "train_re": re_counts,
              "train_vcr": vcr_counts, "pretrain_vcr": pre_counts}
    for name, c in counts.items():
        check(all((v > 0) == (STEP_LAUNCHES[k] > 0) for k, v in c.items()),
              f"{name}'s default flags did not run K1-K6 alone: {c}")
    print(f"[task_cli] train_ve 5 steps + resume to 7, train_re 4 steps "
          f"(validate every 2; best export at step {best['step']}, acc "
          f"{best['value']:.4f}) + inf_re --ckpt best on 2 splits (acc "
          f"{acc:.4f}), train_vcr qa,qar 4 steps + inf_vcr val ({logs}) and "
          f"test ({len(sub) - 1} rows), pretrain_vcr mlm/mrfr/mrc-kl 6 steps "
          f"+ resume to 8; seconds " + ", ".join(
              f"{k} {v:.1f}" for k, v in times.items())
          + f"; launches {counts}")
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------------ prepro

PREPRO_VOCAB = 28996  # uniter-base's word table
PREPRO_IMGS, PREPRO_QUESTIONS = 256, 2048
# every single-card flag of the training drivers (master weights need the
# fused AdamW); --profile_dir is given per run
FLAG_ARGS = ["--remat", "--param_dtype", "bfloat16", "--fused_adamw", "1",
             "--moment_dtype", "bfloat16", "--wire_codec", "int8",
             "--dropout_impl", "u16"]
# launches a step of the K1-K6 path under --remat: each layer's K1 and its
# two K3 run again in the backward's recompute; the embedding tails (K5)
# are not rematerialized, and no backward kernel runs twice
REMAT_LAUNCHES = dict(STEP_LAUNCHES, mha_fwd=24, drop_res_ln_fwd=48)
PREPRO_TASKS = ("vqa", "nlvr", "ve", "itm", "vcr", "re")


def write_vocab(path, rng, size=PREPRO_VOCAB):
    """A ``vocab.txt`` of ``size`` entries laid out as BERT's cased one
    ([PAD] 0, [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103, ``!`` 999, then
    the rest of ASCII punctuation) and words of 2-8 letters made from a
    seed, every third as a ``##`` piece. Returns the whole words."""
    vocab = [f"[unused{i}]" for i in range(999)]
    for i, tok in ((0, "[PAD]"), (100, "[UNK]"), (101, "[CLS]"),
                   (102, "[SEP]"), (103, "[MASK]")):
        vocab[i] = tok
    vocab += [chr(c) for c in range(33, 127) if not chr(c).isalnum()]
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    cand = letters[rng.integers(0, 26, (3 * size, 8))]
    lens = rng.integers(2, 9, 3 * size)
    seen, words = set(vocab), []
    for row, n in zip(cand, lens):
        w = "".join(row[:n])
        if len(words) % 3 == 2:
            w = "##" + w
        if w not in seen:
            seen.add(w)
            words.append(w)
        if len(vocab) + len(words) == size:
            break
    vocab += words
    check(len(vocab) == size and vocab[999] == "!", "vocab layout")
    with open(path, "w") as f:
        f.write("\n".join(vocab))
    return [w for w in words if not w.startswith("##")]


def write_npz_dir(path, rng, n_img):
    """``n_img`` Faster R-CNN dumps ``coco_{id:012}.npz``: 10-100 regions,
    2048-d fp32 features, 6-d boxes, descending confidences, 1601-way soft
    labels."""
    os.makedirs(path)
    pool = rng.standard_normal((8192, 2048), dtype=np.float32)
    for i in range(n_img):
        nbb = int(rng.integers(10, 101))
        o = int(rng.integers(0, 8192 - nbb))
        soft = rng.random((nbb, 1601), dtype=np.float32)
        np.savez(os.path.join(path, f"coco_{i:012}.npz"),
                 features=pool[o:o + nbb],
                 norm_bb=rng.random((nbb, 6), dtype=np.float32),
                 conf=np.linspace(1, 0.05, nbb).astype(np.float32),
                 soft_labels=soft / soft.sum(1, keepdims=True))


def write_annotations(root, rng, words, n_img, n_q):
    """Raw annotations of the six tasks: ``n_q`` VQA questions of 6-20
    words over ``n_img`` images, 10 answers each from the in-tree
    ``ans2label`` (3,129); 32 NLVR2 statements, 32 SNLI-VE hypotheses, 64
    captions, 8 VCR questions, 8 referring expressions (json). Words are
    capitalized or given a suffix now and then, so that WordPiece splits
    and [UNK] show. Returns {task: (prepro args, records expected)}."""
    from uniter_tpu_torch.utils.vqa_answers import load_ans2label

    answers = sorted(load_ans2label(None))
    words = np.array(words)

    def sent(lo=6, hi=21):
        out = []
        for w in rng.choice(words, int(rng.integers(lo, hi))):
            r = rng.random()
            out.append(w.capitalize() if r < 0.1 else w + "s" if r < 0.2
                       else w)
        return " ".join(out) + rng.choice(["?", ".", "!"])

    def dump(name, obj, lines=False):
        path = os.path.join(root, name)
        with open(path, "w") as f:
            if lines:
                f.write("\n".join(json.dumps(o) for o in obj))
            else:
                json.dump(obj, f)
        return path

    qs = [{"question_id": i, "image_id": i % n_img, "question": sent()}
          for i in range(n_q)]
    anns = []
    for i in range(n_q):
        picks = rng.choice(answers, int(rng.integers(1, 4)))
        anns.append({"question_id": i, "answers": [
            {"answer": str(picks[int(j)])}
            for j in rng.integers(0, len(picks), 10)]})
    tasks = {"vqa": (["--annotation", dump("questions.json",
                                           {"questions": qs}),
                      "--vqa_annotations", dump("vqa_ann.json",
                                                {"annotations": anns})],
                     n_q)}
    nlvr = [{"identifier": f"dev-{i:04d}-{k}-0.png", "sentence": sent(),
             "label": "True" if (i + k) % 2 else "False"}
            for i in range(16) for k in range(2)]
    tasks["nlvr"] = (["--annotation", dump("nlvr.jsonl", nlvr, True)], 32)
    ve = [{"pairID": f"p{i}", "Flickr30K_ID": str(i % 8),
           "sentence2": sent(),
           "gold_label": ["entailment", "neutral", "contradiction"][i % 3]}
          for i in range(32)]
    tasks["ve"] = (["--annotation", dump("ve.jsonl", ve, True)], 32)
    caps = {"annotations": [{"id": i, "image_id": i % n_img,
                             "caption": sent()} for i in range(64)]}
    tasks["itm"] = (["--annotation", dump("caps.json", caps)], 64)
    vcr = [{"annot_id": f"val-{i}", "objects": ["person", "dog"],
            "img_fn": f"movie/{i:04d}.jpg",
            "question": sent(3, 8).split() + [[0]],
            "answer_choices": [sent(2, 6).split() + [[k % 2]]
                               for k in range(4)],
            "rationale_choices": [sent(3, 9).split() for _ in range(4)],
            "answer_label": i % 4, "rationale_label": (i + 1) % 4}
           for i in range(8)]
    tasks["vcr"] = (["--annotation", dump("vcr.jsonl", vcr, True)], 8)
    images = [{"id": i, "file_name": f"{i}.jpg", "height": 480,
               "width": 640} for i in range(4)]
    objs = [{"id": 100 + i, "area": 900.0, "bbox": [10.0, 20.0, 30.0, 30.0],
             "image_id": i % 4, "category_id": 1} for i in range(8)]
    refs = [{"ref_id": j, "ann_id": 100 + j, "image_id": j % 4,
             "split": "train", "sentences": [
                 {"sent_id": j, "sent": sent(2, 8)}]} for j in range(8)]
    tasks["re"] = (["--annotation", dump("refs.json", refs),
                    "--instances", dump("instances.json", {
                        "images": images, "annotations": objs,
                        "categories": [{"id": 1, "name": "thing"}]}),
                    "--iid_to_ann_ids", dump("iid.json", {
                        "iid_to_ann_ids": {str(i): [100 + i, 104 + i]
                                           for i in range(4)}})], 8)
    return tasks


def run_procs(cmds, timeout=600):
    """Start every command at once (each ``python -m`` entry point of the
    port in its own process, from the checkout); wait for all; fail on
    the first nonzero exit with its error's tail."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [(cmd, subprocess.Popen(
        [sys.executable, "-m", *cmd], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cmd in cmds]
    for cmd, proc in procs:
        try:
            _, err = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
        check(proc.returncode == 0, f"{' '.join(cmd[:1])} failed: "
              f"{err[-2000:]}")


def trace_summary(profile_dir):
    """(bytes, ``loop.step`` ranges on the host, kernel events) of the
    one trace ``--profile_dir`` holds (each range also has its device
    twin, category ``gpu_user_annotation``)."""
    files = [f for f in os.listdir(profile_dir)
             if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"profile_dir holds {files}")
    path = os.path.join(profile_dir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return (os.path.getsize(path),
            sum(e.get("name") == "loop.step"
                and e.get("cat") == "user_annotation" for e in events),
            sum(e.get("cat") == "kernel" for e in events))


def prepro_phase(torch):
    """The preprocessing and flags chain of this slice at uniter-base: raw
    annotations and npz dumps made from a seed through the port's
    ``convert_imgdir`` and ``prepro`` (six tasks, seven processes at once),
    then ``train_vqa`` with every single-card flag for 20 steps (async
    saves and validation at 10 and 20, the profiler's window 10-15), a
    resume to 25 and ``inf_vqa`` on the fp32 export. Launch counts are
    set to 0 before each training run and read after; ``validate``'s K1
    launches are counted apart, so the rest are the steps'."""
    from uniter_tpu_torch import inf_vqa, train_vqa

    work = scratch_dir("chip_smoke_prepro_")
    rng = np.random.default_rng(SEED)
    secs = {}
    t0 = time.perf_counter()
    vocab = os.path.join(work, "vocab.txt")
    words = write_vocab(vocab, rng)
    write_npz_dir(os.path.join(work, "npz"), rng, PREPRO_IMGS)
    tasks = write_annotations(work, rng, words, PREPRO_IMGS,
                              PREPRO_QUESTIONS)
    secs["fixtures"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = os.path.join(work, "img")
    cmds = [["uniter_tpu_torch.convert_imgdir", "--img_dir",
             os.path.join(work, "npz"), "--output", img, "--nproc", "4"]]
    for task, (args, _) in tasks.items():
        cmds.append(["uniter_tpu_torch.prepro", "--task", task,
                     "--output", os.path.join(work, f"txt_{task}"),
                     "--toker", vocab, *args])
    run_procs(cmds)
    secs["convert_imgdir + prepro x6"] = time.perf_counter() - t0
    with open(os.path.join(img, "nbb_th0.2_max100_min10.json")) as f:
        nbb = json.load(f)
    check(len(nbb) == PREPRO_IMGS and min(nbb.values()) >= 10,
          f"img_db: {len(nbb)} images")
    counts = {}
    for task, (_, n) in tasks.items():
        out = os.path.join(work, f"txt_{task}")
        with open(os.path.join(out, "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(out, "id2len.json")) as f:
            counts[task] = len(json.load(f))
        check((meta["UNK"], meta["CLS"], meta["SEP"], meta["MASK"],
               meta["v_range"], meta["task"]) == (100, 101, 102, 103,
                                                  [999, PREPRO_VOCAB], task),
              f"{task} meta {meta}")
        check(counts[task] == n, f"{task}: {counts[task]} records, want {n}")
    from uniter_tpu_torch.data.txt_db import TxtTokDb

    db = TxtTokDb(os.path.join(work, "txt_vqa"), max_txt_len=-1)
    recs = [db[k] for k in list(db.id2len)[:64]]
    check(all(r["target"]["labels"] and all(
        i == 100 or 999 <= i < PREPRO_VOCAB for i in r["input_ids"])
        for r in recs), "VQA records")
    n_unk = sum(r["input_ids"].count(100) for r in recs)

    out = os.path.join(work, "run")
    prof = [os.path.join(work, "prof_1"), os.path.join(work, "prof_2")]
    conf = dict(_path=os.path.join(work, "train.json"),
                train_txt_db=os.path.join(work, "txt_vqa"),
                train_img_db=img, val_txt_db=os.path.join(work, "txt_vqa"),
                val_img_db=img, output_dir=out,
                model_config=os.path.join(REPO, "configs",
                                          "uniter-base.json"),
                num_train_steps=20, valid_steps=10, log_steps=5,
                train_batch_size=5120, val_batch_size=10240, n_workers=2,
                device="cuda", checkpoint="")
    val = {k: 0 for k in KERNELS}
    real = train_vqa.validate

    def counted(*a, **k):
        before = read_launches()
        try:
            return real(*a, **k)
        finally:
            for name, v in read_launches().items():
                val[name] += v - before[name]

    train_vqa.validate = counted
    try:
        t0 = time.perf_counter()
        state, total = run_cli(train_vqa, conf,
                               FLAG_ARGS + ["--profile_dir", prof[0]])
        secs["train_vqa 20 steps"] = time.perf_counter() - t0
        check(state.step == 20, f"train_vqa stopped at {state.step}")
        check(state.model.uniter.config.remat
              and state.opt.masters()
              and state.model.uniter.embeddings.word_embeddings.weight.dtype
              == torch.bfloat16, "the run did not take the flags")
        del state
        steps = {k: total[k] - val[k] for k in KERNELS}
        check_launches(steps, 20, REMAT_LAUNCHES, "prepro")
        # validation: a batch's 12 K1, 24 K3 and 2 K5 (its tails at rate
        # 0), nothing else
        fwd = ("mha_fwd", "drop_res_ln_fwd", "ln_drop_fwd")
        check(all(v == 0 for k, v in val.items() if k not in fwd)
              and val["mha_fwd"] > 0
              and val["drop_res_ln_fwd"] == 2 * val["mha_fwd"]
              and 6 * val["ln_drop_fwd"] == val["mha_fwd"],
              f"validation launched {val}")
        t0 = time.perf_counter()
        state, _ = run_cli(train_vqa, conf,
                           FLAG_ARGS + ["--profile_dir", prof[1],
                                        "--num_train_steps", "25"])
        secs["resume to 25"] = time.perf_counter() - t0
        check(state.step == 25, f"resumed run stopped at {state.step}")
        del state
    finally:
        train_vqa.validate = real
    with open(os.path.join(out, "log", "log.txt")) as f:
        check("resumed from step 20" in f.read(), "the rerun did not resume")
    ckpts = sorted(os.listdir(os.path.join(out, "ckpt")))
    check({"model_step_10.pt", "model_step_20.pt", "model_step_25.pt"}
          <= set(ckpts), f"checkpoints {ckpts}")
    w = torch.load(os.path.join(out, "ckpt", "model_step_25.pt"),
                   weights_only=True)
    check(all(v.dtype == torch.float32 for v in w.values()),
          "the export is not the fp32 masters")
    del w
    traces = [trace_summary(p) for p in prof]
    check(traces[0][1] == 6 and traces[1][1] == 3 and traces[0][2] > 0,
          f"profiler traces (bytes, steps, kernels) {traces}")
    t0 = time.perf_counter()
    res = inf_vqa.main(inf_vqa.get_parser().parse_args([
        "--txt_db", os.path.join(work, "txt_vqa"), "--img_db", img,
        "--train_dir", out, "--output_dir", os.path.join(work, "ans"),
        "--device", "cuda"]))
    secs["inf_vqa"] = time.perf_counter() - t0
    with open(res) as f:
        answers = json.load(f)
    check(len(answers) == PREPRO_QUESTIONS, f"{len(answers)} answers")
    print(f"[prepro] vocab {PREPRO_VOCAB} entries; convert_imgdir "
          f"{PREPRO_IMGS} npz dumps; prepro records {counts} (the first 64 "
          f"VQA questions hold {n_unk} [UNK]); train_vqa at uniter-base "
          f"with {' '.join(FLAG_ARGS)}: 20 steps (async saves at 10, 20), "
          f"K1-K6 launches a step {steps['mha_fwd'] / 20:g} / "
          f"{steps['mha_bwd'] / 20:g} / {steps['drop_res_ln_fwd'] / 20:g} / "
          f"{steps['drop_res_ln_bwd'] / 20:g} / {steps['ln_drop_fwd'] / 20:g}"
          f" / {steps['ln_drop_bwd'] / 20:g} (validation: K1 "
          f"{val['mha_fwd']}, K3 {val['drop_res_ln_fwd']}, K5 "
          f"{val['ln_drop_fwd']}); resume to 25; profiler traces "
          + ", ".join(f"{b / 2**20:.1f} MiB ({n} steps, {k} kernel events)"
                      for b, n, k in traces)
          + f"; inf_vqa answered {len(answers)} questions; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    torch.cuda.empty_cache()
    return {"launches": steps, "seconds": secs, "traces": traces}


# ------------------------------------------------------------------- flags

FLAG_POLICIES = ("baseline", "remat", "master", "remat+master")


def embed_routes(torch):
    """The flagship step's four lookups (word, position, and the token-type
    table for the text and for the image rows) under three routes:
    ``F.embedding`` (CUDA's own backward), ids one-hot times the table
    (tables of up to 512 rows) and ``SortedLookup``. For each, forward and
    backward (a bf16 gradient into the fp32 table, as ``Embed`` runs it):
    the call time (ms, between CUDA events), the device time and device
    operations a call (torch.profiler over 10 calls), and whether three
    backward passes give the same table gradient bit for bit."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from uniter_tpu_torch.models.encoder import SortedLookup

    b, t, r, h = 96, 64, 40, 768
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lookups = {
        "word": (28996, torch.randint(1, 28000, (b, t), generator=gen,
                                      device=dev)),
        "position": (512, torch.arange(t, device=dev).repeat(b, 1)),
        "type (text)": (2, torch.zeros(b, t, dtype=torch.long, device=dev)),
        "type (image)": (2, torch.ones(b, r, dtype=torch.long, device=dev))}
    routes = {"F.embedding": F.embedding,
              "one-hot": lambda ids, w: F.one_hot(
                  ids, w.shape[0]).to(w.dtype) @ w,
              "SortedLookup": SortedLookup.apply}
    res = {}
    for name, (rows, ids) in lookups.items():
        w = torch.randn(rows, h, device=dev, generator=gen,
                        requires_grad=True)
        g = torch.randn(*ids.shape, h, device=dev, generator=gen).to(
            torch.bfloat16)
        for route, fn in routes.items():
            if route == "one-hot" and rows > 512:
                continue

            def call():
                out = fn(ids, w).to(torch.bfloat16)
                return torch.autograd.grad(out, w, g)[0]

            dws = [call() for _ in range(3)]
            same = all(torch.equal(dws[0], x) for x in dws[1:])
            ms = cuda_ms(torch, call, iters=200, warmup=20)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
            dev_ms = sum(getattr(e, "self_device_time_total", 0)
                         for e in ev) / 1e3 / 10
            ops = sum(e.count for e in ev) / 10
            res[name, route] = {"ms": ms, "device_ms": dev_ms, "ops": ops,
                                "same": same}
    print("[flags] the flagship's lookups (B=96, T=64, R=40, h=768), forward"
          " + backward, call ms / device ms / device ops a call / three "
          "backward passes bit for bit: " + "; ".join(
              f"{n} {rt} {v['ms']:.4f} / {v['device_ms']:.4f} / "
              f"{v['ops']:g} / {v['same']}" for (n, rt), v in res.items()))
    return res


def optim_reference_check(torch, device="cuda"):
    """``--optim adam`` and ``adamax`` for 3 steps (clip 0.5, lr 1e-3, the
    head multiplier 10 on the last Linear) on the card against the optax
    formulas in float64; max |difference| of the parameters."""
    from uniter_tpu_torch.models.encoder import LayerNorm, Linear
    from uniter_tpu_torch.training.optim import build_optimizer

    errs = {}
    for optim in ("adam", "adamax"):
        torch.manual_seed(SEED)
        model = torch.nn.Sequential(Linear(768, 3072), LayerNorm(3072),
                                    Linear(3072, 768)).to(device)
        opt = build_optimizer(model, 1e-3, grad_norm=0.5, lr_mul=10.0,
                              lr_mul_paths=("2.",), optim=optim, fused=True)
        ref = {n: p.detach().double().clone()
               for n, p in model.named_parameters()}
        mu = {n: torch.zeros_like(v) for n, v in ref.items()}
        nu = {n: torch.zeros_like(v) for n, v in ref.items()}
        gen = torch.Generator(device).manual_seed(SEED)
        b1, b2, eps = 0.9, 0.98, 1e-6
        for t in range(1, 4):
            grads = {n: torch.randn(p.shape, generator=gen, device=device)
                     for n, p in model.named_parameters()}
            for n, p in model.named_parameters():
                p.grad = grads[n].clone()
            opt.step()
            norm = torch.sqrt(sum(g.double().square().sum()
                                  for g in grads.values()))
            clip = min(1.0, 0.5 / max(float(norm), 0.5))
            for n in ref:
                g = grads[n].double() * clip
                mu[n] = b1 * mu[n] + (1 - b1) * g
                if optim == "adam":
                    nu[n] = b2 * nu[n] + (1 - b2) * g * g
                    u = (mu[n] / (1 - b1 ** t)) / (
                        (nu[n] / (1 - b2 ** t)).sqrt() + eps)
                else:
                    nu[n] = torch.maximum(g.abs() + eps, b2 * nu[n])
                    u = (mu[n] / (1 - b1 ** t)) / nu[n]
                ref[n] -= 1e-3 * (10.0 if n.startswith("2.") else 1.0) * u
        errs[optim] = max(float((p.detach().double() - ref[n]).abs().max())
                          for n, p in model.named_parameters())
    return errs


def flags_phase(torch, n_steps=10):
    """The flagship step (B=96, T=64, R=40, bf16, dropout 0.1, fused AdamW
    with bf16 moments) through K1-K6 under four policies in turns
    (baseline, remat, master, remat+master and back): step-1 losses, the
    remat gradients against the baseline's from the same generator,
    examples/s, launches a step, the step's peak memory above what the
    trainers hold and each trainer's own, a profile of each; then the
    u16/u8 keep fractions of the plain dropout on the card, the int8 wire
    error on the card and adam/adamax against float64."""
    from uniter_tpu_torch.config import base_config
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
    from uniter_tpu_torch.ops import dropout as D
    from uniter_tpu_torch.train_vqa import vqa_loss
    from uniter_tpu_torch.training.step import step_generator
    from uniter_tpu_torch.utils.const import IMG_DIM

    num_answer, b = 3129, 96
    base = policy_configs(base_config(
        dtype="bfloat16", hidden_dropout_prob=RATE,
        attention_probs_dropout_prob=RATE))["K1-K6"]
    sd = {k: torch.from_numpy(v) for k, v in state_dict_from_jax_params(
        jax_layout_params(base, num_answer, IMG_DIM, SEED)).items()}
    batch = flagship_batch(torch, base, num_answer, IMG_DIM, torch.bfloat16)
    resident, trainers = {}, {}
    for name in FLAG_POLICIES:
        m0 = torch.cuda.memory_allocated()
        cfg = base.replace(remat="remat" in name)
        trainers[name] = make_trainer(torch, cfg, sd, num_answer,
                                      master="master" in name)
        resident[name] = torch.cuda.memory_allocated() - m0
    # the remat gradients against the baseline's, same generator and
    # weights (before any step)
    # (and a second baseline pass: the card's own run-to-run floor)
    grads, loss0 = {}, {}
    for name, trainer in (("baseline", "baseline"), ("remat", "remat"),
                          ("replay", "baseline")):
        model = trainers[trainer][0].model
        model.train()
        loss = vqa_loss(model, batch, step_generator(SEED, 0), num_answer)
        loss.backward()
        loss0[name] = float(loss.detach())
        grads[name] = {k: p.grad for k, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None

    def compare(other):
        """Against the baseline's gradients: the relative difference of
        the whole gradient (|diff| / |g| over every parameter), the worst
        parameter's max |diff| / max |g| and its name, bit for bit."""
        used = [(k, g.float(), grads[other][k].float())
                for k, g in grads["baseline"].items() if g is not None]
        diff2 = sum(float((b - a).square().sum()) for _, a, b in used)
        norm2 = sum(float(a.square().sum()) for _, a, _ in used)
        worst = max((float((b - a).abs().max())
                     / max(float(a.abs().max()), 1e-30), k)
                    for k, a, b in used)
        return ((diff2 / norm2) ** 0.5, *worst,
                all(g is None or torch.equal(g, grads[other][k])
                    for k, g in grads["baseline"].items()))

    rel, worst, worst_key, exact = compare("remat")
    floor, floor_worst, floor_key, replay_exact = compare("replay")
    del grads
    check(loss0["remat"] == loss0["baseline"],
          f"remat changed the step-1 loss: {loss0}")
    # the whole gradient, not the worst parameter: a second pass of the
    # baseline alone differs by up to ~1e-6 of max|g| in the 2-row
    # token-type table (the card's embedding backward); drawing the masks
    # anew in the recompute would move the whole gradient by O(1)
    check(rel <= 1e-6, f"remat gradients differ by {rel:.2e} relative")
    # and each parameter alone, against the card's own floor: a mask fault
    # confined to a few small leaves (LayerNorm biases, one tail) hardly
    # moves the whole gradient but moves those leaves by O(1)
    worst_tol = min(1e-5, max(3 * floor_worst, 1e-6))
    check(worst <= worst_tol,
          f"remat gradients differ by {worst:.2e} of the max at {worst_key}"
          f" (tol {worst_tol:.2e}, a second baseline pass {floor_worst:.2e})")

    first, secs, launches, peak = {}, {n: [] for n in trainers}, {}, {}

    def run(name, n):
        state, step = trainers[name]
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        losses = [step(state, batch, SEED)[1]["loss"] for _ in range(n)]
        losses = [float(x) for x in losses]  # the readback ends the turn
        dt = time.perf_counter() - t0
        launches[name] = {k: v / n for k, v in read_launches().items()}
        peak[name] = max(peak.get(name, 0),
                         torch.cuda.max_memory_allocated() - m0)
        first.setdefault(name, losses[0])
        check(all(np.isfinite(losses)), f"{name}: non-finite loss")
        return dt

    for name in trainers:  # warm-up, and step 1 of every policy
        run(name, 2)
    for name in FLAG_POLICIES + FLAG_POLICIES[::-1]:
        secs[name].append(run(name, n_steps))
    eps = {n: n_steps * b * len(v) / sum(v) for n, v in secs.items()}
    for name in FLAG_POLICIES:
        want = REMAT_LAUNCHES if "remat" in name else STEP_LAUNCHES
        check(launches[name] == want,
              f"{name}: launches per step {launches[name]}")
    step1 = {n: abs(v - first["baseline"]) / abs(first["baseline"])
             for n, v in first.items()}
    check(first["remat"] == first["baseline"]
          and first["remat+master"] == first["master"],
          f"remat changed step 1: {first}")
    check(max(step1.values()) <= 1e-3, f"master mode's step 1: {step1}")
    busy, ops = {}, {}
    for name in FLAG_POLICIES:
        state, step = trainers[name]
        prof = profile_steps(torch, state, step, batch, 3,
                             "flags_" + name.replace("+", "_"),
                             label="flags")[1]
        busy[name], ops[name] = prof["busy_ms"] / 3, prof["ops"]
    del trainers, batch
    torch.cuda.empty_cache()

    # the plain dropout's u16/u8 rules on the card: keep fraction, scale,
    # the CPU's bits
    keep = {}
    x = torch.randn(9984, 768, device="cuda")
    for impl in ("u16", "u8"):
        _, _, keep_q = D.mask_rule(RATE, impl)
        y = D.drop(x, RATE, 4242, impl)
        mask = D.keep_mask(4242, 0, x.shape, RATE, "cuda", impl)
        frac = float(mask.float().mean())
        sigma = (keep_q * (1 - keep_q) / mask.numel()) ** 0.5
        check(abs(frac - keep_q) <= 4 * sigma
              and torch.equal(y[mask], x[mask] * (1.0 / keep_q))
              and not y[~mask].any()
              and torch.equal(D.keep_mask(7, 0, (64, 768), RATE, "cuda",
                                          impl).cpu(),
                              D.keep_mask(7, 0, (64, 768), RATE, "cpu",
                                          impl)),
              f"{impl} dropout on the card: keep {frac} vs {keep_q}")
        keep[impl] = (frac, keep_q, 4 * sigma)
    del x, y, mask
    # the int8 wire codec on the card, against the bf16 cast of the input
    cast = flagship_batch(torch, base, num_answer, IMG_DIM, torch.float32)
    wire = flagship_batch(torch, base, num_answer, IMG_DIM, torch.bfloat16,
                          "int8")
    ref = cast["img_feat"]
    row = ref.abs().amax(-1, keepdim=True)
    werr = float(((wire["img_feat"].float() - ref).abs() / row).max())
    # the int8 step, then two bf16 roundings (the scale's, the product's)
    # of at most 2^-8 of max|row| each
    check(wire["img_feat"].dtype == torch.bfloat16
          and werr <= 1 / 254 + 2 * 2 ** -8, f"int8 wire error {werr}")
    del cast, wire, ref, row
    oerr = optim_reference_check(torch)
    check(max(oerr.values()) <= 1e-6, f"adam/adamax against float64 {oerr}")
    lookups = embed_routes(torch)
    check(all(v["same"] for (_, rt), v in lookups.items()
              if rt != "F.embedding"),
          f"a deterministic lookup route differs between passes {lookups}")
    gib = 2 ** 30
    print(f"[flags] flagship step (B={b}, T=64, R=40, bf16, dropout {RATE}, "
          f"fused AdamW bf16 moments) through K1-K6, turns of {n_steps} "
          f"steps {', '.join(FLAG_POLICIES)} and back: examples/s "
          + ", ".join(f"{n} {v:.1f}" for n, v in eps.items())
          + "; device busy ms a step " + ", ".join(
              f"{n} {v:.2f}" for n, v in busy.items())
          + "; device ops a step " + ", ".join(
              f"{n} {v:g}" for n, v in ops.items())
          + "; step peak above the resident trainers GiB " + ", ".join(
              f"{n} {v / gib:.3f}" for n, v in peak.items())
          + "; a trainer's own GiB (parameters, bf16 copies, moments) "
          + ", ".join(f"{n} {v / gib:.3f}" for n, v in resident.items()))
    print("[flags] launches a step " + "; ".join(
        f"{n} " + "/".join(f"{launches[n][k]:g}" for k in KERNELS[:6])
        for n in FLAG_POLICIES) + " (K1/K2/K3/K4/K5/K6)")
    print(f"[flags] step-1 loss " + ", ".join(
        f"{n} {v:.6f}" for n, v in first.items()) + "; relative to the "
          f"baseline " + ", ".join(f"{n} {v:.2e}" for n, v in step1.items())
          + f"; remat gradients against the baseline's (same generator): "
          f"bit for bit {exact}, |diff| / |g| {rel:.2e} (tol 1e-6), the "
          f"worst parameter {worst:.2e} of its max at {worst_key} (tol "
          f"{worst_tol:.2e}); a "
          f"second baseline pass: bit for bit {replay_exact}, {floor:.2e}, "
          f"worst {floor_worst:.2e} at {floor_key}")
    print("[flags] plain dropout on the card, keep fraction at rate "
          f"{RATE} over 9984 x 768: " + ", ".join(
              f"{k} {f:.6f} (quantized keep {q:.6f}, 4 sigma {s:.1e})"
              for k, (f, q, s) in keep.items())
          + f"; int8 wire error over max|row| {werr:.3e} (bound 1/254 + "
          f"2 x 2^-8); adam/adamax 3 steps against float64 max |diff| "
          + ", ".join(f"{k} {v:.2e}" for k, v in oerr.items()))
    torch.cuda.empty_cache()
    return {"ex_per_s": eps, "busy_ms": busy, "ops": ops, "peak": peak,
            "resident": resident, "launches": launches, "remat_rel": rel,
            "replay_rel": floor, "lookups": lookups}


# ------------------------------------------------------------------- dist

DIST_Q = 1000  # questions of the dist phase's DBs (over 400 images)
DIST_STEPS = 20
GLOO_STEPS = 5
RESUME_STEPS = 8  # the gloo runs resumed at world 1 to this step
# two ranks against one process, replicated and --fsdp, relative, at every
# step and dropout 0.1 (each rank draws its block of the one process's
# masks): a step moves the loss by ~2e-3, so a dropped rank's gradient or
# another rank's masks show
DIST_REL = 1e-6
# a run resumed at world 1 from world 2 (--fsdp) against the one resumed
# from world 1, relative, at every resumed step
RESUME_REL = 1e-5


def dist_worker(spec_path):
    """One rank of a ``dist`` run: ``python3 chip_smoke.py --dist-worker
    SPEC`` under ``torchrun`` (or alone: no process group). It calls the
    port's entry point ``SPEC["module"]``'s ``main`` on ``SPEC["args"]``,
    as ``python -m uniter_tpu_torch.<module>`` does, and writes what the
    phase reads to ``SPEC["out"]``-RANK.json: every step's loss as the
    loop's NaN guard reads it back, the kernels' launches of the run and of
    its validation, the bytes of optimizer state and of parameters the
    rank holds at rest, its peak of allocated device memory, and with
    ``SPEC["masks"]`` the first K3 launch's keep mask, drawn at the row
    base that launch was given (an .npy beside)."""
    import importlib

    import torch
    from uniter_tpu_torch.ops import dropout, fused_block
    from uniter_tpu_torch.parallel.collectives import process_index
    from uniter_tpu_torch.training import loop
    from uniter_tpu_torch.utils.misc import parse_with_config

    with open(spec_path) as f:
        spec = json.load(f)
    if spec["module"] == "tp":
        out = tp_worker(spec)
        with open(f"{spec['out']}-{out['rank']}.json", "w") as f:
            json.dump(out, f)
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        return 0
    module = importlib.import_module(f"uniter_tpu_torch.{spec['module']}")
    losses, val, first_k3 = {}, {k: 0 for k in KERNELS}, []
    guard = loop.NanGuard.check

    def check_and_keep(self, value, step):
        losses[int(step)] = float(value)
        return guard(self, value, step)

    loop.NanGuard.check = check_and_keep
    if hasattr(module, "validate"):
        real = module.validate

        def counted(*a, **k):
            before = read_launches()
            try:
                return real(*a, **k)
            finally:
                for name, v in read_launches().items():
                    val[name] += v - before[name]

        module.validate = counted
    if spec.get("masks"):
        k3 = fused_block.drop_res_ln_fwd

        def first(x, res, weight, bias, rate=0.0, seed=0, eps=1e-12,
                  row_base=0):
            if not first_k3:
                first_k3.append((tuple(x.shape), rate, seed, x.device,
                                 row_base))
            return k3(x, res, weight, bias, rate, seed, eps, row_base)

        first.launches = 0  # the kernel's count lands here (its name)
        fused_block.drop_res_ln_fwd = first
    reset_launches()
    t0 = time.perf_counter()
    if spec["module"].startswith("inf_"):
        module.main(module.get_parser().parse_args(spec["args"]))
        state = None
    else:
        state = module.main(parse_with_config(module.get_parser(),
                                              spec["args"]))
    secs = time.perf_counter() - t0
    rank = process_index()
    out = {"rank": rank, "losses": [losses[s] for s in sorted(losses)],
           "launches": read_launches(), "validation": val, "seconds": secs,
           "state_bytes": state.opt.state_bytes() if state else None,
           "param_bytes": state.opt.param_bytes() if state else None,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "step": state.step if state else None}
    if first_k3:
        shape, rate, seed, device, row_base = first_k3[0]
        keep = dropout.keep_mask(seed, 0, shape, rate, device,
                                 row_base=row_base)
        np.save(f"{spec['out']}-{rank}-mask.npy",
                np.packbits(keep.cpu().numpy().reshape(-1)))
        out["k3"] = {"shape": shape, "rate": rate, "seed": seed,
                     "row_base": row_base,
                     "keep": float(keep.float().mean())}
    with open(f"{spec['out']}-{rank}.json", "w") as f:
        json.dump(out, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


TP_STEPS = 3  # fp32 steps of the 2x2 grid and its one process
TP_RESUME = 5  # both resumed at world 1 to this step
TP_B, TP_T, TP_R = 16, 40, 36  # the grid's global batch (S = 76)
TP_ANSWERS = 3129


def tp_batch(torch, step, dtype, device="cuda"):
    """Global batch ``step`` of the tensor-parallel runs: TP_B examples
    with random text and region lengths (padding in both segments),
    targets with 0.3% positives, every row real; made from (SEED, step),
    so every rank and the one process see the same batches."""
    rng = np.random.RandomState(SEED + 1000 + step)
    b, t, r = TP_B, TP_T, TP_R
    attn = np.zeros((b, t + r), np.int32)
    for i, (tl, nr) in enumerate(zip(rng.randint(8, t + 1, b),
                                     rng.randint(10, r + 1, b))):
        attn[i, :tl] = 1
        attn[i, t:t + nr] = 1
    batch = dict(
        input_ids=rng.randint(1, 28000, (b, t)) * attn[:, :t],
        position_ids=np.tile(np.arange(t), (b, 1)),
        img_feat=rng.randn(b, r, 2048).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=attn,
        targets=(rng.rand(b, TP_ANSWERS) < 0.003).astype(np.float32),
        ex_weight=np.ones(b, np.float32))
    out = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in
           batch.items()}
    out["img_feat"] = out["img_feat"].to(dtype)
    out["img_pos_feat"] = out["img_pos_feat"].to(dtype)
    return out


def tp_worker(spec):
    """One rank of the tensor-parallel runs (``dist_phase``), or the one
    process they are held to: the VQA train step at uniter-base through
    ``make_mesh`` (``spec["model"]`` ranks a model axis), ``place_state``
    (``--fsdp`` at 65536 with ``spec["fsdp"]``) and ``make_train_step``,
    K1-K6 and K9 (``ffn_impl`` cuda), dropout RATE, in ``spec["dtype"]``,
    fused AdamW with bf16 moments (the CLI runs' ``moment_dtype``),
    ``loss_scale`` "mean" (the data ranks' gradients sum to the global
    batch's). Steps ``spec["first"]`` to
    ``spec["last"]`` on ``tp_batch``; ``resume``/``save``: a
    ``TrainStateSaver`` directory to restore from first, to save to
    after. The weights are ``jax_layout_params``'s with seeded biases in
    the layers' projections. With ``spec["probe"]`` it also keeps the
    first K1 launch's arguments and shape (after the steps K1 is replayed
    there and its mask goes to an .npy beside, held against the plain
    mask at those arguments) and layer 0's FFN input, weights and output,
    and after the steps holds that output against K9 on the whole FFN on
    the same input (the one process's kernel), with two planted faults
    (b2 on every rank, a wrong W2 block) that the tolerance must refuse
    (``tp_checks``). Returns the record ``dist_worker`` writes."""
    from uniter_tpu_torch.config import base_config
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
    from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu_torch.ops import attention
    from uniter_tpu_torch.ops.attention import _probs_mask
    from uniter_tpu_torch.ops.ffn import ffn_fwd
    from uniter_tpu_torch.parallel import collectives as C
    from uniter_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from uniter_tpu_torch.train_vqa import vqa_loss
    from uniter_tpu_torch.training.driver import place_state
    from uniter_tpu_torch.training.sched import get_lr_schedule
    from uniter_tpu_torch.training.step import make_train_step
    from uniter_tpu_torch.utils.const import IMG_DIM
    from uniter_tpu_torch.utils.save import TrainStateSaver

    import torch

    dev = torch.device("cuda")
    if C.launched():
        dev = torch.device(C.init_distributed("cuda", "gloo"))
    make_mesh(MeshConfig(model=spec["model"]))
    dtype = getattr(torch, spec["dtype"])
    cfg = base_config(dtype=spec["dtype"], hidden_dropout_prob=RATE,
                      attention_probs_dropout_prob=RATE,
                      attention_impl="cuda", block_fusion="cuda",
                      ffn_impl="cuda")
    model = UniterForVisualQuestionAnswering(cfg, IMG_DIM, TP_ANSWERS)
    sd = state_dict_from_jax_params(jax_layout_params(
        base_config(), TP_ANSWERS, IMG_DIM, SEED))
    # seeded biases in the layers' projections (normal(0, 0.02), not the
    # init's zeros), so that a row-parallel bias added on every model rank,
    # or not at all, moves the losses from step 1 and K9's comparison
    rng = np.random.default_rng(SEED + 17)
    for k in sorted(sd):
        if ".encoder.layer." in k and k.endswith(".bias") \
                and "LayerNorm" not in k:
            sd[k] = (0.02 * rng.standard_normal(sd[k].shape)).astype(
                np.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    state = place_state(model.to(dev), get_lr_schedule(8e-5, 2, 100),
                        grad_norm=2.0, lr_mul=10.0, lr_mul_paths=("vqa_",),
                        fused=True, mu_dtype=torch.bfloat16,
                        nu_dtype=torch.bfloat16, fsdp=spec["fsdp"],
                        fsdp_min_size=65536)
    if spec.get("resume"):
        check(TrainStateSaver(spec["resume"]).restore(state) is not None,
              "nothing to resume")
    step = make_train_step(
        lambda m, b, g: (vqa_loss(m, b, g, TP_ANSWERS), {}),
        loss_scale="mean")
    probe = {}
    if spec.get("probe"):
        real_k1 = attention.mha_fwd

        def first_k1(q, *a, **kw):
            if "k1" not in probe:
                probe["k1"] = (tuple(q.shape), q.dtype, kw.get("row_base", 0),
                               kw.get("heads_total"), kw.get("head0", 0),
                               a[3] if len(a) > 3 else kw.get("rate"),
                               a[4] if len(a) > 4 else kw.get("seed"))
            return real_k1(q, *a, **kw)

        first_k1.launches = 0  # the kernel's count lands here (its name)
        attention.mha_fwd = first_k1
        layer = model.uniter.encoder.layer[0]
        real_ffn = layer.feed_forward

        def kept_ffn(x):
            y = real_ffn(x)
            if "ffn" not in probe:
                w1, w2 = layer.intermediate.dense, layer.output.dense
                probe["ffn"] = [t.detach().clone() for t in (
                    x, w1.weight.to(dtype), w1.bias, w2.weight.to(dtype),
                    w2.bias, y)]
            return y

        layer.feed_forward = kept_ffn
    d, dp = C.data_index(), C.data_size()
    losses = []
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(spec["first"], spec["last"]):
        glob = tp_batch(torch, i, dtype, dev)
        n = TP_B // dp
        _, m = step(state, {k: v[d * n:(d + 1) * n] for k, v in
                            glob.items()}, SEED)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    if spec.get("save"):
        TrainStateSaver(spec["save"]).save(state.step, state)
    rank = C.process_index()
    out = {"rank": rank, "grid": [d, C.model_index()], "losses": losses,
           "launches": launches, "validation": {k: 0 for k in KERNELS},
           "seconds": secs, "state_bytes": state.opt.state_bytes(),
           "param_bytes": state.opt.param_bytes(), "peak_bytes": peak,
           "step": state.step}
    if "k1" in probe:
        # K1 replayed on the card at the first launch's arguments and shape:
        # q = k = 0 and no padding make P uniform, and with v one-hot over
        # a head dim of 128 (>= S) output (b, q, h, k) is positive exactly
        # where score (b, h, q, k) was kept. Its bits go to the .npy; the
        # plain mask at the same arguments is held against them here.
        attention.mha_fwd = real_k1
        shape, dt, base, total, head0, rate, seed = probe["k1"]
        b, s, h, _ = shape
        check(s <= 128, f"tp: S {s} exceeds the one-hot head dim")
        z = torch.zeros(b, s, h, 128, device=dev, dtype=dt)
        hot = torch.eye(s, 128, device=dev, dtype=dt)[None, :, None, :]
        keep = real_k1(z, z, hot.expand(b, s, h, 128).contiguous(),
                       torch.zeros(b, s, device=dev), rate, seed,
                       row_base=base, heads_total=total, head0=head0
                       )[..., :s].permute(0, 2, 1, 3) > 0
        plain = _probs_mask(torch.empty(shape, device=dev), rate, seed, base,
                            total, head0)
        np.save(f"{spec['out']}-{rank}-mask.npy",
                np.packbits(keep.cpu().numpy().reshape(-1)))
        out["k1"] = {"shape": shape, "dtype": str(dt), "row_base": base,
                     "heads_total": total, "head0": head0, "seed": seed,
                     "keep": float(keep.float().mean()),
                     "plain_equal": bool(torch.equal(keep, plain))}
    if "ffn" in probe:
        x, w1, b1, w2, b2, y = probe["ffn"]
        x2, y2 = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
        d_mid = w1.shape[0]
        # |p_0| + |p_1|: this rank's K9 partial (its blocks, zero b2), and
        # the other rank's, summed over the model group
        mine = ffn_fwd(x2, w1, b1, w2, torch.zeros_like(b2)).float()
        part = mine.abs()
        n, mg = C.model_size(), C.model_group()
        faults = {"b2 on every rank": y2.float() + b2.float()}
        if n > 1:
            def whole(t, axis):
                flat = C.all_gather(torch.empty(n * t.numel(), dtype=t.dtype,
                                                device=t.device),
                                    t.contiguous().reshape(-1), mg)
                return torch.cat(list(flat.view(n, *t.shape)), axis)

            w1_m, b1_m = w1, b1
            w1, b1, w2 = whole(w1, 0), whole(b1, 0), whole(w2, 1)
            C.all_reduce_sum(part, mg)
            # this rank's partial with the next rank's W2 block
            o = (C.model_index() + 1) % n
            wrong = ffn_fwd(x2, w1_m, b1_m,
                            w2[:, o * d_mid:(o + 1) * d_mid].contiguous(),
                            torch.zeros_like(b2)).float()
            faults["a wrong W2 block"] = y2.float() - mine + wrong
        want = ffn_fwd(x2, w1, b1, w2, b2).float()
        bound = 2.0**-6 * (part + want.abs()) + 1e-3
        diff = (y2.float() - want).abs()
        out["k9"] = {"excess": (diff - bound).max().item(),
                     "ratio": (diff / bound).max().item(),
                     "max_abs_err": diff.max().item(), "d_mid": d_mid,
                     "faults": {k: {"excess": ((f - want).abs() - bound)
                                    .max().item(),
                                    "ratio": ((f - want).abs() / bound)
                                    .max().item()}
                                for k, f in faults.items()}}
    return out


_DIST_PROCS = []  # every launch of dist_start, stopped by dist_stop


def dist_start(work, name, module, args, nproc=0, backend=None,
               masks=False, **extra):
    """Start the entry point ``module`` on ``args`` in ``nproc`` processes
    under ``torchrun --standalone`` (0: one process, no launcher, no
    process group; ``backend``: its ``--dist_backend``), its output to
    ``work/name.log``; ``dist_wait`` collects it. ``module`` "tp" is
    ``tp_worker`` on the spec's ``extra`` keys."""
    spec = os.path.join(work, f"{name}.json")
    out = os.path.join(work, name)
    if backend:
        args = [*args, "--dist_backend", backend]
    with open(spec, "w") as f:
        json.dump({"module": module, "args": args, "out": out,
                   "masks": masks, **extra}, f)
    cmd = [sys.executable, os.path.join(REPO, "chip_smoke.py"),
           "--dist-worker", spec]
    if nproc:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc), *cmd[1:]]
    env = dict(os.environ, PYTHONPATH=REPO)
    with open(out + ".log", "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    _DIST_PROCS.append(proc)
    return proc, name, out, max(nproc, 1)


def dist_wait(run):
    """Every rank's worker record (``dist_worker``) of a ``dist_start``."""
    proc, name, out, n = run
    try:
        proc.wait(timeout=600)
    finally:
        dist_stop([proc])
    with open(out + ".log") as f:
        log = f.read()
    check(proc.returncode == 0, f"{name} failed: {log[-3000:]}")
    return [json.load(open(f"{out}-{r}.json")) for r in range(n)]


def dist_run(*args, **kw):
    return dist_wait(dist_start(*args, **kw))


def dist_stop(procs):
    """Stop every rank a launch started that still runs."""
    for proc in procs:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()


def trace_busy(profile_dir):
    """(profiled steps, device busy ms a step) of the one trace
    ``--profile_dir`` holds: the union of its kernels' intervals over its
    ``loop.step`` ranges."""
    files = [f for f in os.listdir(profile_dir)
             if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"profile_dir holds {files}")
    with open(os.path.join(profile_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    steps = sum(e.get("name") == "loop.step"
                and e.get("cat") == "user_annotation" for e in events)
    busy, end = 0.0, -1.0
    for s, d in sorted((e["ts"], e["dur"]) for e in events
                       if e.get("cat") == "kernel"):
        busy += max(0.0, s + d - max(s, end))
        end = max(end, s + d)
    check(steps > 0 and busy > 0, f"trace: {steps} steps, busy {busy}")
    return steps, busy / 1e3 / steps


def scalar(out, name, step):
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        vals = [json.loads(x) for x in f]
    return [v[name] for v in vals if name in v and v["step"] == step][-1]


def dist_launch_line(tag, rec, steps):
    per = {k: (rec["launches"][k] - rec["validation"][k]) / steps
           for k in KERNELS[:6]}
    print(f"[dist] {tag}: K1-K6 launches a step "
          + " / ".join(f"{v:g}" for v in per.values())
          + f" (validation: K1 {rec['validation']['mha_fwd']})")
    return per


def flagship_nccl_cost(torch):
    """The flagship step through K1-K6 (``train_phase``'s trainer) in one
    process, in turns without a process group and inside an NCCL group of
    world size 1 (``init_process_group`` on tcp://localhost, destroyed
    after each turn): examples/s and device busy ms a step of each. At
    world 1 the collectives change no number, so the losses are equal."""
    import socket

    from uniter_tpu_torch.config import base_config
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
    from uniter_tpu_torch.utils.const import IMG_DIM

    num_answer, b, n_steps = 3129, 96, 10
    base = base_config(dtype="bfloat16", hidden_dropout_prob=RATE,
                       attention_probs_dropout_prob=RATE)
    sd = {k: torch.from_numpy(v) for k, v in state_dict_from_jax_params(
        jax_layout_params(base, num_answer, IMG_DIM, SEED)).items()}
    batch = flagship_batch(torch, base, num_answer, IMG_DIM, torch.bfloat16)
    cfg = policy_configs(base)["K1-K6"]
    trainers = {g: make_trainer(torch, cfg, sd, num_answer)
                for g in ("no group", "NCCL world 1")}
    secs = {g: [] for g in trainers}
    losses = {g: [] for g in trainers}
    busy = {}

    def group(on):
        if on:
            s = socket.socket()
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
            s.close()
            torch.distributed.init_process_group(
                "nccl", init_method=f"tcp://localhost:{port}", rank=0,
                world_size=1, device_id=torch.device("cuda", 0))
        elif torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()

    for g in list(trainers) + list(trainers)[::-1]:
        state, step = trainers[g]
        group(g != "no group")
        for _ in range(2 if not secs[g] else 0):  # warm-up
            step(state, batch, SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ls = [step(state, batch, SEED)[1]["loss"] for _ in range(n_steps)]
        losses[g] += [float(x) for x in ls]
        secs[g].append(time.perf_counter() - t0)
        if g not in busy:
            busy[g] = profile_steps(torch, state, step, batch, 3,
                                    "dist_" + g.replace(" ", "_"),
                                    label="dist")[1]["busy_ms"] / 3
        group(False)
    eps = {g: n_steps * b * len(v) / sum(v) for g, v in secs.items()}
    check(losses["no group"] == losses["NCCL world 1"],
          "the flagship losses differ inside an NCCL group of one")
    print("[dist] flagship step (B=96, S=104, bf16, dropout 0.1, K1-K6), "
          "turns of 10 steps no group / NCCL world 1 / NCCL world 1 / no "
          "group: examples/s " + ", ".join(f"{g} {v:.1f}"
                                          for g, v in eps.items())
          + "; device busy ms a step " + ", ".join(
              f"{g} {v:.2f}" for g, v in busy.items())
          + "; losses bit-equal")
    del trainers
    torch.cuda.empty_cache()
    return {"ex_per_s": eps, "busy_ms": busy}


# launches a step a rank of the tensor-parallel runs: K1-K6 as a step of
# one process (the model ranks run every layer on their heads and every
# tail replicated), K9 once a layer forward
TP_LAUNCHES = dict(STEP_LAUNCHES, ffn_fwd=12)


def tp_checks(work, tp, back, pair, one_fp32):
    """The tensor-parallel records of ``dist_phase`` (``tp_worker``): the
    2x2 grid's fp32 losses against its one process at every step
    (``DIST_REL``), the ranks' launches a step, each rank's K1 mask of the
    bf16 step (K1 replayed at its launch) against its head block of the
    one process's and the plain mask (bit for bit), K9 on D_mid / 2 within
    its bf16 tolerance (``tp_worker``: 2^-6 (|p_0| + |p_1| + |ref|) +
    1e-3, the fp32 all-reduce of bf16 partials) and past it with each
    planted fault, each
    rank's bytes at rest and at peak against the replicated gloo pair
    ``pair``, and the grid's save resumed at world 1 against the one
    process's (``RESUME_REL``)."""
    one, grid, probe = tp["tp_one"][0], tp["tp_grid"], tp["tp_probe"]
    want = one["losses"]
    check(all(r["losses"] == grid[0]["losses"] for r in grid),
          "tp: the grid's ranks report different losses")
    rel = [abs(x - y) / abs(y) for x, y in zip(grid[0]["losses"], want)]
    check(len(rel) == TP_STEPS and max(rel) <= DIST_REL,
          f"tp: 2x2 losses {grid[0]['losses']} against one process {want}")
    per32 = [{k: r["launches"][k] / TP_STEPS for k in KERNELS}
             for r in grid]
    per16 = [dict(r["launches"]) for r in probe]
    check(all(p == TP_LAUNCHES for p in per32 + per16),
          f"tp: launches a step a rank {per32} / {per16}")
    ref = tp["tp_one_probe"][0]["k1"]
    b1, s1, h1 = ref["shape"][:3]
    one_mask = np.unpackbits(np.load(os.path.join(
        work, "tp_one_probe-0-mask.npy")))[:b1 * h1 * s1 * s1].reshape(
        b1, h1, s1, s1)
    blocks = []
    for r in probe:
        k1, (d, m) = r["k1"], r["grid"]
        b, s_, h = k1["shape"][:3]
        bits = np.unpackbits(np.load(os.path.join(
            work, f"tp_probe-{r['rank']}-mask.npy")))[:b * h * s_ * s_]
        blocks.append(bool(
            np.array_equal(bits.reshape(b, h, s_, s_),
                           one_mask[d * b:(d + 1) * b, m * h:(m + 1) * h])
            and k1["seed"] == ref["seed"] and k1["heads_total"] == h1
            and k1["head0"] == m * h and k1["row_base"] == d * b * h1 * s_
            and k1["plain_equal"] and ref["plain_equal"]))
    check(all(blocks), f"tp: the ranks' K1 masks {[r['k1'] for r in probe]}"
          f" against one process {ref}")
    k9 = [r["k9"] for r in probe]
    d_mid = tp["tp_one_probe"][0]["k9"]["d_mid"]
    check(all(x["excess"] <= 0 and 2 * x["d_mid"] == d_mid for x in k9),
          f"tp: K9 on D_mid / 2 against the whole FFN {k9}")
    fault = {f: min(x["faults"][f]["ratio"] for x in k9)
             for f in k9[0]["faults"]}
    check(all(v > 1 for v in fault.values()),
          f"tp: K9's bound does not refuse a planted fault {fault}")
    mem = {k: [r[k] for r in grid] for k in ("param_bytes", "state_bytes",
                                             "peak_bytes")}
    ratio = {k: [x / pair[0][k] for x in v] for k, v in mem.items()}
    check(all(x <= 0.36 for x in ratio["param_bytes"])
          and all(x <= 0.36 for x in ratio["state_bytes"]),
          f"tp: bytes a rank {mem} against the pair {pair[0]}")
    a, b = back["tp_grid_back"]["losses"], back["tp_one_back"]["losses"]
    rel_back = [abs(x - y) / abs(y) for x, y in zip(a, b)]
    check(len(a) == len(b) == TP_RESUME - TP_STEPS
          and max(rel_back) <= RESUME_REL,
          f"tp: the 2x2 save resumed at world 1 {a} against {b}")
    print(f"[dist] tp: 2x2 grid (data x model, 4 gloo ranks on the card, "
          f"--fsdp at 65536) at uniter-base (12 layers, H 768, 6 of 12 heads "
          f"and D_mid 1536 of 3072 a rank), fp32, dropout {RATE}, K1-K6 and "
          f"K9, {TP_STEPS} steps of a {TP_B}-example batch (S "
          f"{TP_T + TP_R}): losses {[f'{x:.6f}' for x in grid[0]['losses']]} "
          f"against one process {[f'{x:.6f}' for x in want]} (relative "
          f"{', '.join(f'{x:.1e}' for x in rel)}, tol {DIST_REL:g}); "
          f"{grid[0]['seconds'] / TP_STEPS:.2f} s a step on rank 0")
    for r, p32, p16 in zip(grid, per32, per16):
        print(f"[dist] tp rank {r['rank']} at {tuple(r['grid'])}: "
              "K1-K6 and K9 launches a step fp32 " + " / ".join(
                  f"{p32[k]:g}" for k in KERNELS if k in TP_LAUNCHES
                  and TP_LAUNCHES[k]) + ", bf16 " + " / ".join(
                  f"{p16[k]:g}" for k in KERNELS if TP_LAUNCHES[k])
              + f"; parameters at rest {r['param_bytes']} B, optimizer "
              f"state {r['state_bytes']} B, peak allocated "
              f"{r['peak_bytes'] / 2**20:.1f} MiB")
    print(f"[dist] tp: a rank against the replicated gloo pair's rank 0 "
          f"({pair[0]['param_bytes']} B parameters, {pair[0]['state_bytes']}"
          f" B state, {pair[0]['peak_bytes'] / 2**20:.1f} MiB peak; one "
          f"process {one_fp32['peak_bytes'] / 2**20:.1f} MiB): parameters "
          f"{max(ratio['param_bytes']):.4f}x, state "
          f"{max(ratio['state_bytes']):.4f}x, peak "
          f"{min(ratio['peak_bytes']):.3f}-{max(ratio['peak_bytes']):.3f}x "
          f"(the pair ran {GLOO_STEPS} CLI steps of its own batches)")
    print(f"[dist] tp: the bf16 step's K1 masks, K1 replayed on the card "
          f"at each rank's first launch's arguments and shape "
          f"{[r['k1']['shape'] for r in probe][0]} (heads_total {h1}, "
          f"head0 {[r['k1']['head0'] for r in probe]}, row bases "
          f"{[r['k1']['row_base'] for r in probe]}; q = k = 0, v one-hot): "
          f"equal to its block of K1's mask replayed at the one process's "
          f"{ref['shape']} launch, and to the plain mask at its arguments, "
          f"bit for bit: {all(blocks)}")
    print(f"[dist] tp: K9 at D_mid {d_mid // 2} with b2 after the fp32 "
          f"all-reduce against K9 on the whole FFN on the same input: "
          f"max|diff| {max(x['max_abs_err'] for x in k9):.3e}, against "
          f"2^-6 (|p_0| + |p_1| + |ref|) + 1e-3: worst excess "
          f"{max(x['excess'] for x in k9):.3e}, worst |diff| / bound "
          f"{max(x['ratio'] for x in k9):.3f}; planted faults, least "
          f"|diff| / bound over the ranks (> 1 refused): " + ", ".join(
              f"{f} {v:.3f} (excess "
              f"{min(x['faults'][f]['excess'] for x in k9):.3e})"
              for f, v in fault.items()))
    print(f"[dist] tp: the 2x2 --fsdp save at step {TP_STEPS} resumed at "
          f"world 1 to {TP_RESUME}: losses {[f'{x:.6f}' for x in a]} "
          f"against the one process resumed {[f'{x:.6f}' for x in b]} "
          f"(relative {', '.join(f'{x:.1e}' for x in rel_back)}, tol "
          f"{RESUME_REL:g})")
    return {"losses": grid[0]["losses"], "one": want, "rel": rel,
            "launches": per16[0], "launches_fp32": per32[0],
            "k1_blocks": blocks, "k9": k9, "bytes": mem, "ratio": ratio,
            "resume_rel": rel_back}


def dist_phase(torch):
    """Data parallelism over ``torch.distributed`` through the entry points
    (``torchrun -m``'s counterpart: ``chip_smoke.py --dist-worker`` calls
    ``main``): (1) ``train_vqa`` at uniter-base (bf16, dropout 0.1,
    K1-K6) 20 steps, validating and saving at 10 and 20, without a process
    group and under ``torchrun --nproc_per_node 1`` (NCCL), replicated and
    with ``--fsdp --fsdp_min_size 65536``: losses bit-equal; examples/s and
    device busy ms a step (the replicated pair alone on the card, the rest
    of the phase's runs in overlapping waves); the --fsdp run resumed to 25
    without --fsdp; the flagship step with and without an NCCL group of
    one; (2) two ranks sharing the card over gloo: 5 fp32 steps at dropout
    0.1 against one process on the same global batches, replicated and
    --fsdp (every step of both within ``DIST_REL`` of one process), each
    rank's parameter and optimizer-state bytes at rest and peak allocated
    memory, one bf16 step (K1-K6 launches, each rank's K3 mask against its
    block of the one process's, bit for bit), ``inf_vqa`` at world 2
    against world 1, the --fsdp pair resumed at world 1 without --fsdp
    against the one process resumed (``RESUME_REL``); (3) the same over
    NCCL with a card a rank when there are two cards."""
    work = scratch_dir("chip_smoke_dist_")
    t_phase = t0 = time.perf_counter()
    write_vqa_dbs(work, 400, DIST_Q, SEED)
    txt, img = os.path.join(work, "txt"), os.path.join(work, "img")
    base = dict(train_txt_db=txt, train_img_db=img, val_txt_db=txt,
                val_img_db=img, model_config=os.path.join(
                    REPO, "configs", "uniter-base.json"),
                train_batch_size=5120, val_batch_size=10240, n_workers=2,
                moment_dtype="bfloat16", device="cuda", checkpoint="",
                log_steps=1)

    def conf(name, **kw):
        path = os.path.join(work, f"{name}_conf.json")
        with open(path, "w") as f:
            json.dump(dict(base, output_dir=os.path.join(work, name), **kw),
                      f)
        return ["--config", path]

    one = dict(num_train_steps=DIST_STEPS, valid_steps=10)
    two = dict(num_train_steps=GLOO_STEPS, valid_steps=0, dtype="float32",
               dropout=RATE)
    resume = ["--num_train_steps", str(RESUME_STEPS)]
    back = {}  # the runs resumed at world 1
    fsdp = ["--fsdp", "--fsdp_min_size", "65536"]
    backends = [("gloo", "gloo")]
    if torch.cuda.device_count() >= 2:
        backends.append(("nccl2", None))
    res = {"seconds": {"dbs": time.perf_counter() - t0}}
    try:
        # (1) NCCL at world size 1: the timed pair alone on the card
        runs = {}
        for name, nproc in (("alone", 0), ("nccl1", 1)):
            t0 = time.perf_counter()
            prof = os.path.join(work, f"prof_{name}")
            runs[name] = dist_run(work, name, "train_vqa",
                                  conf(name, **one)
                                  + ["--profile_dir", prof], nproc)[0]
            res["seconds"][name] = time.perf_counter() - t0
            runs[name]["ex_per_s"] = scalar(os.path.join(work, name),
                                            "perf/ex_per_s", DIST_STEPS)
            runs[name]["busy"] = trace_busy(prof)
        # the rest in waves that share the card
        t0 = time.perf_counter()
        wave = {name: dist_start(work, name, "train_vqa",
                                 conf(name, **one) + fsdp, nproc)
                for name, nproc in (("alone_fsdp", 0), ("nccl1_fsdp", 1))}
        wave["one_fp32"] = dist_start(work, "one_fp32", "train_vqa",
                                      conf("one_fp32", **two))
        wave["one_masks"] = dist_start(
            work, "one_masks", "train_vqa",
            conf("one_masks", num_train_steps=1, valid_steps=0), masks=True)
        # the tensor-parallel runs: the 2x2 grid and its one process
        tp_ckpt = {n: os.path.join(work, f"{n}_ckpt")
                   for n in ("tp_one", "tp_grid")}
        for name, nproc in (("tp_one", 0), ("tp_grid", 4)):
            wave[name] = dist_start(
                work, name, "tp", [], nproc, model=2 if nproc else 1,
                fsdp=bool(nproc), dtype="float32", first=0, last=TP_STEPS,
                save=tp_ckpt[name])
        wave["tp_one_probe"] = dist_start(
            work, "tp_one_probe", "tp", [], model=1, fsdp=False,
            dtype="bfloat16", first=0, last=1, probe=True)
        got = {name: dist_wait(run) for name, run in wave.items()}
        tp = {n: got[n] for n in ("tp_one", "tp_grid", "tp_one_probe")}
        runs.update({n: got[n][0] for n in ("alone_fsdp", "nccl1_fsdp")})
        ref = got["one_fp32"][0]
        one_mask = np.unpackbits(np.load(os.path.join(
            work, "one_masks-0-mask.npy")))
        one_k3 = got["one_masks"][0]["k3"]
        res["seconds"]["wave 1"] = time.perf_counter() - t0
        for name, rec in runs.items():
            check(rec["step"] == DIST_STEPS
                  and len(rec["losses"]) == DIST_STEPS
                  and np.isfinite(rec["losses"]).all(), f"{name}: {rec}")
        for a, b in (("alone", "nccl1"), ("alone_fsdp", "nccl1_fsdp")):
            check(runs[a]["losses"] == runs[b]["losses"],
                  f"{b}'s losses are not {a}'s bit for bit")
        t0 = time.perf_counter()
        wave = {"resume": dist_start(
            work, "nccl1_fsdp", "train_vqa", conf("nccl1_fsdp", **one)
            + ["--num_train_steps", "25"], 1),
            "inf1": dist_start(work, "inf1", "inf_vqa", [
                "--txt_db", txt, "--img_db", img, "--train_dir",
                os.path.join(work, "one_fp32"), "--output_dir",
                os.path.join(work, "ans1")]),
            "tp_probe": dist_start(
                work, "tp_probe", "tp", [], 4, model=2, fsdp=True,
                dtype="bfloat16", first=0, last=1, probe=True)}
        for tag, backend in backends:
            wave[f"{tag}_fsdp"] = dist_start(
                work, f"{tag}_fsdp", "train_vqa",
                conf(f"{tag}_fsdp", **two) + fsdp, 2, backend)
            wave[f"{tag}_masks"] = dist_start(
                work, f"{tag}_masks", "train_vqa",
                conf(f"{tag}_masks", num_train_steps=1, valid_steps=0), 2,
                backend, masks=True)
            wave[f"{tag}_inf"] = dist_start(work, f"{tag}_inf", "inf_vqa", [
                "--txt_db", txt, "--img_db", img, "--train_dir",
                os.path.join(work, "one_fp32"), "--output_dir",
                os.path.join(work, f"ans_{tag}")], 2,
                backend)
        got = {name: dist_wait(run) for name, run in wave.items()}
        res["seconds"]["wave 2"] = time.perf_counter() - t0
        tp["tp_probe"] = got["tp_probe"]
        rec = got["resume"][0]
        with open(os.path.join(work, "nccl1_fsdp", "log", "log.txt")) as f:
            check("resumed from step 20" in f.read(), "no resume")
        check(rec["step"] == 25 and len(rec["losses"]) == 5, f"resume {rec}")
        with open(os.path.join(work, "ans1", "results.json")) as f:
            answers1 = json.load(f)
        check(len(answers1) == DIST_Q, f"{len(answers1)} answers")
        launches = dist_launch_line("NCCL world 1, replicated",
                                    runs["nccl1"], DIST_STEPS)
        check(launches == {k: STEP_LAUNCHES[k] for k in launches},
              f"distributed launches a step {launches}")
        print("[dist] train_vqa at uniter-base, 20 steps (validate + save "
              "at 10, 20), losses bit-equal with and without the NCCL group "
              "of one, replicated and --fsdp; perf/ex_per_s at step 20 (from "
              "the loop's start, step 10's validation and save included) "
              "and device busy ms a step over the profiled steps, alone on "
              "the card: " + "; ".join(
                  f"{n} {runs[n]['ex_per_s']:.1f} ex/s, "
                  f"{runs[n]['busy'][1]:.2f} ms ({runs[n]['busy'][0]} steps)"
                  for n in ("alone", "nccl1"))
              + "; optimizer state at world 1 " + ", ".join(
                  f"{n} {r['state_bytes'] / 2**20:.1f} MiB"
                  for n, r in runs.items()))
        print(f"[dist] the --fsdp run (NCCL world 1) resumed without --fsdp "
              f"to 25: losses {[round(x, 4) for x in rec['losses']]}")
        res["nccl1"], res["launches"] = runs, launches
        # (2) two ranks on the one card over gloo; (3) NCCL on two cards
        if len(backends) == 1:
            print(f"[dist] NCCL at world size 2 not run: "
                  f"{torch.cuda.device_count()} card(s), and NCCL takes one "
                  "card a rank")
        for tag, backend in backends:
            t0 = time.perf_counter()
            rep = dist_run(work, f"{tag}_replicated", "train_vqa",
                           conf(f"{tag}_replicated", **two), 2, backend)
            res["seconds"][f"{tag}_replicated"] = time.perf_counter() - t0
            ex_s = scalar(os.path.join(work, f"{tag}_replicated"),
                          "perf/ex_per_s", GLOO_STEPS)
            with open(os.path.join(work, f"ans_{tag}", "results.json")) as f:
                check(json.load(f) == answers1,
                      f"{tag}: inf_vqa at world 2 differs from world 1")
            fs = got[f"{tag}_fsdp"]
            for recs in (rep, fs):
                check(recs[0]["losses"] == recs[1]["losses"],
                      f"{tag}: the ranks report different losses")
            want = ref["losses"]
            rel = [abs(x - y) / abs(y)
                   for x, y in zip(rep[0]["losses"], want)]
            rel_fsdp = [abs(x - y) / abs(y)
                        for x, y in zip(fs[0]["losses"], want)]
            check(len(rel) == len(rel_fsdp) == GLOO_STEPS
                  and max(rel + rel_fsdp) <= DIST_REL,
                  f"{tag}: losses {rep[0]['losses']} / {fs[0]['losses']} "
                  f"against one process {want}")
            mem = {k: {"param_bytes": [r["param_bytes"] for r in recs],
                       "state_bytes": [r["state_bytes"] for r in recs],
                       "peak_bytes": [r["peak_bytes"] for r in recs]}
                   for k, recs in (("replicated", rep), ("fsdp", fs))}
            ratio = {k: [f / r for f, r in zip(mem["fsdp"][k],
                                               mem["replicated"][k])]
                     for k in ("param_bytes", "state_bytes")}
            check(all(x <= 0.52 for x in ratio["param_bytes"])
                  and all(0.4 < x < 0.6 for x in ratio["state_bytes"]),
                  f"{tag}: bytes a rank {mem}")
            # (5) each rank's K3 mask is its block of the one process's
            masks = got[f"{tag}_masks"]
            bits = [np.unpackbits(np.load(os.path.join(
                work, f"{tag}_masks-{r}-mask.npy"))) for r in range(2)]
            k3 = [m["k3"] for m in masks]
            n_bits = bits[0].size
            blocks = all(np.array_equal(
                bits[r], one_mask[r * n_bits:(r + 1) * n_bits])
                for r in range(2))
            check(blocks and one_mask.size == 2 * n_bits
                  and all(k["seed"] == one_k3["seed"] for k in k3)
                  and [k["row_base"] for k in k3]
                  == [0, int(np.prod(k3[0]["shape"][:-1]))],
                  f"{tag}: the ranks' K3 masks {k3} against one process "
                  f"{one_k3}")
            per32 = dist_launch_line(
                f"{tag} world 2, rank 0, fp32 dropout {RATE}", rep[0],
                GLOO_STEPS)
            per = dist_launch_line(f"{tag} world 2, rank 0, bf16 dropout "
                                   f"{RATE}", masks[0], 1)
            check(per == {k: STEP_LAUNCHES[k] for k in per}
                  and per32 == per, f"{tag}: launches a step {per} / {per32}")
            print(f"[dist] {tag}, 2 ranks, uniter-base fp32, dropout {RATE}, "
                  f"{GLOO_STEPS} steps: losses "
                  f"{[f'{x:.6f}' for x in rep[0]['losses']]} against one "
                  f"process {[f'{x:.6f}' for x in want]} (relative "
                  f"{', '.join(f'{x:.1e}' for x in rel)}); --fsdp relative "
                  f"{', '.join(f'{x:.1e}' for x in rel_fsdp)}; a rank holds "
                  f"at rest parameters {mem['fsdp']['param_bytes']} B with "
                  f"--fsdp, {mem['replicated']['param_bytes']} replicated "
                  f"({max(ratio['param_bytes']):.4f}x), optimizer state "
                  f"{mem['fsdp']['state_bytes']} / "
                  f"{mem['replicated']['state_bytes']} "
                  f"({max(ratio['state_bytes']):.4f}x; one process "
                  f"{ref['state_bytes']}); peak allocated a rank "
                  f"{[round(x / 2**20, 1) for x in mem['fsdp']['peak_bytes']]}"
                  f" MiB --fsdp, "
                  f"{[round(x / 2**20, 1) for x in mem['replicated']['peak_bytes']]}"
                  f" MiB replicated (one process "
                  f"{ref['peak_bytes'] / 2**20:.1f}); perf/ex_per_s at step "
                  f"{GLOO_STEPS} (from the loop's start, replicated) "
                  f"{ex_s:.1f}; K3 masks of step 1: seed {k3[0]['seed']} on "
                  f"both ranks and one process, row bases "
                  f"{[k['row_base'] for k in k3]}, keep "
                  f"{k3[0]['keep']:.4f} / {k3[1]['keep']:.4f}, each rank's "
                  f"{n_bits} bits equal to its block of the one process's "
                  f"mask: {blocks}; inf_vqa at world 2 wrote world 1's "
                  f"{len(answers1)} answers")
            res[tag] = {"losses": rep[0]["losses"], "one": want, "rel": rel,
                        "rel_fsdp": rel_fsdp, "bytes": mem, "ratio": ratio,
                        "ex_per_s": ex_s, "launches": per,
                        "launches_fp32": per32, "k3_blocks": blocks}
            # (6) the --fsdp world-2 run resumed at world 1 without --fsdp,
            # against one process's run resumed at world 1
            t0 = time.perf_counter()
            names = [f"{tag}_fsdp"] + (["one_fp32"] if tag == "gloo" else [])
            wave = {n: dist_start(work, n, "train_vqa", conf(n, **two)
                                  + resume) for n in names}
            if tag == "gloo":  # the TP runs resumed at world 1
                wave.update({f"{n}_back": dist_start(
                    work, f"{n}_back", "tp", [], model=1, fsdp=False,
                    dtype="float32", first=TP_STEPS, last=TP_RESUME,
                    resume=tp_ckpt[n]) for n in tp_ckpt})
            back.update({n: dist_wait(run)[0] for n, run in wave.items()})
            res["seconds"][f"{tag} resume"] = time.perf_counter() - t0
            a, b = back[f"{tag}_fsdp"]["losses"], back["one_fp32"]["losses"]
            rel_back = [abs(x - y) / abs(y) for x, y in zip(a, b)]
            check(len(a) == len(b) == RESUME_STEPS - GLOO_STEPS
                  and max(rel_back) <= RESUME_REL,
                  f"{tag}: resumed at world 1 {a} against {b}")
            print(f"[dist] {tag}: the --fsdp world-2 run resumed at world 1 "
                  f"without --fsdp to {RESUME_STEPS}: losses "
                  f"{[f'{x:.6f}' for x in a]} against the world-1 run "
                  f"resumed {[f'{x:.6f}' for x in b]} (relative "
                  f"{', '.join(f'{x:.1e}' for x in rel_back)}, tol "
                  f"{RESUME_REL:g})")
            res[tag]["resume_rel"] = rel_back
        res["tp"] = tp_checks(work, tp, back, rep, ref)
    finally:
        dist_stop(_DIST_PROCS)
    t0 = time.perf_counter()
    res["flagship"] = flagship_nccl_cost(torch)
    res["seconds"]["flagship"] = time.perf_counter() - t0
    res["seconds"]["phase"] = time.perf_counter() - t_phase
    print("[dist] seconds " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in res["seconds"].items()))
    return res


# BEiT-3-large VQA at 480 px: 256 pairs of 901 vision rows and up to 24
# text rows a call (S = 909-925)
BEIT3_K1 = (256, 925, 16, 64)
BEIT3_SPLIT = 901


def beit3_k1(torch, F):
    """K1 at ``BEIT3_K1`` (past the old 512 limit): rate 0 against the plain
    version (fp32 products, 32 pairs at a time) and SDPA forward, bf16 and
    fp32; rate RATE against the plain version under the same mask rule on
    the first 4 pairs (rows 0.. of the launch's mask); device / call times
    of K1 and SDPA. Returns {dtype: (err, times)}."""
    from uniter_tpu_torch.ops.attention import _mha_torch, mha_fwd

    b, s, h, d = BEIT3_K1
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out_t = {}
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        lens = torch.randint(BEIT3_SPLIT + 8, s + 1, (b,), generator=gen,
                             device="cuda")
        bias = (1.0 - (torch.arange(s, device="cuda")[None, :]
                       < lens[:, None]).float()) * -10000.0
        before = mha_fwd.launches
        out = mha_fwd(q, k, v, bias)
        launches = mha_fwd.launches - before
        err = 0.0
        for i in range(0, b, 32):
            ref = _mha_torch(q[i:i + 32].float(), k[i:i + 32].float(),
                             v[i:i + 32].float(), bias[i:i + 32])
            err = max(err, (out[i:i + 32].float() - ref).abs().max().item())
            del ref
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        with torch.no_grad():
            sd = F.scaled_dot_product_attention(
                qt, kt, vt, bias[:, None, None, :].to(dtype)).transpose(1, 2)
        e_sdpa = (out.float() - sd.float()).abs().max().item()
        del sd
        drop = mha_fwd(q, k, v, bias, RATE, 4242)
        ref = _mha_torch(q[:4].float(), k[:4].float(), v[:4].float(),
                         bias[:4], RATE, 4242)
        e_drop = (drop[:4].float() - ref).abs().max().item()
        del drop, ref
        tol = K1_TOL[name]
        ok = (err <= tol and e_drop <= tol and launches == 1
              and bool(torch.isfinite(out).all()))
        print(f"[beit3 K1] B={b} S={s} H={h} D={d} {name} (keys "
              f"{BEIT3_SPLIT + 8}-{s} valid): rate 0 max|diff| against the "
              f"plain version {err:.3e} (tol {tol:g}), against SDPA "
              f"{e_sdpa:.3e}; rate {RATE} on pairs 0-3 against the plain "
              f"version under the same mask {e_drop:.3e}; {launches} launch "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"K1 disagrees with the plain version at {BEIT3_K1} {name}")
        del out
        t = time_k1(torch, F, q, k, v, bias, mha_fwd, _mha_torch)
        out_t[name] = (err, t)
        del q, k, v
        torch.cuda.empty_cache()
    return out_t


def beit3_tails(torch, F):
    """The multiway K3 (``multiway_tail_fwd`` with res: the sum and LN_m of
    the sum) and K5 (LN_m) at (256, 925, 1024), split 901, bf16 and fp32,
    against ``_multiway_tail_torch`` on the fp32 copies (bf16: 2^-8 |ref| +
    1e-3; fp32: 1e-5), the sum bit for bit against x + res rounded once;
    device / call times against the plain version and against an add and
    ``F.layer_norm`` with one weight set (the least a library does);
    launches; the bytes bound. Returns {(name, dtype): times}."""
    from uniter_tpu_torch.ops import fused_block as fb

    b, s, h = BEIT3_K1[0], BEIT3_K1[1], 1024
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = {}
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        x, res = (torch.randn(b, s, h, generator=gen, device="cuda")
                  .to(dtype) for _ in range(2))
        vecs = [1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
                if i % 2 == 0 else
                0.1 * torch.randn(h, generator=gen, device="cuda")
                for i in range(4)]
        for name, r in (("k3", res), ("k5", None)):
            before = fb.multiway_tail_fwd.launches
            got = fb.multiway_tail_fwd(x, r, *vecs, BEIT3_SPLIT)
            launches = fb.multiway_tail_fwd.launches - before
            want = fb._multiway_tail_torch(
                x.float(), None if r is None else r.float(), *vecs,
                BEIT3_SPLIT)
            y, wy = (got, want) if r is None else (got[1], want[1])
            d = (y.float() - wy).abs_()
            rel, ab = (2.0**-8, 1e-3) if dname == "bfloat16" else (0.0, 1e-5)
            exc = (d - rel * wy.abs() - ab).max().item()
            sum_ok = True
            if r is not None:
                sum_ok = torch.equal(got[0], (x.float() + r.float()).to(dtype))
            ok = exc <= 0 and sum_ok and launches == 1
            print(f"[beit3 tails] multiway {name.upper()} ({b}, {s}, {h}) "
                  f"split {BEIT3_SPLIT} {dname}: y max|diff| "
                  f"{d.max().item():.2e} (excess over the tolerance "
                  f"{exc:.2e}); sum bit for bit {sum_ok}; {launches} launch "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"the multiway {name} disagrees with its plain version")
            del got, want, y, wy, d
            w0, b0 = vecs[0], vecs[1]

            def lib(r=r):
                t = x if r is None else x + r
                return F.layer_norm(t, (h,), w0.to(dtype), b0.to(dtype), 1e-5)

            fns = {"kernel": lambda r=r: fb.multiway_tail_fwd(
                       x, r, *vecs, BEIT3_SPLIT),
                   "plain": lambda r=r: fb._multiway_tail_torch(
                       x, r, *vecs, BEIT3_SPLIT),
                   "lib": lib}
            t = {k: both_ms(torch, f, n_graph=10, n_call=20)
                 for k, f in fns.items()}
            acts = 4 if r is not None else 2
            elem = 2 if dname == "bfloat16" else 4
            bound = (acts * b * s * h * elem + 4 * h * 4) / HBM_BYTES_PER_S \
                * 1e3
            print(f"[beit3 tails] multiway {name.upper()} times {dname}, us "
                  f"device / call: kernel {t['kernel'][0] * 1e3:.1f} / "
                  f"{t['kernel'][1] * 1e3:.1f}, plain "
                  f"{t['plain'][0] * 1e3:.1f} / {t['plain'][1] * 1e3:.1f}, "
                  f"{'add + ' if r is not None else ''}F.layer_norm "
                  f"{t['lib'][0] * 1e3:.1f} / {t['lib'][1] * 1e3:.1f}; bound "
                  f"{bound * 1e3:.1f} (bytes: {acts} activations), kernel "
                  f"{bound / t['kernel'][0] * 100:.1f}% of it")
            out[(name, dname)] = {**t, "bound": bound, "launches": launches}
        del x, res
        torch.cuda.empty_cache()
    return out


def beit3_serve(torch, n_pairs=256, t_len=24):
    """One BEiT-3-large VQA call (bf16, seeded weights, ``n_pairs`` pairs
    over n_pairs / 5 images, text padded to ``t_len``) through
    ``Beit3ForVisualQuestionAnswering.predict``: launches of K1, the
    multiway tails and K5 (the pooler), the tail counters under a profiler
    session, the call time."""
    from torch.profiler import profile

    from uniter_tpu_torch.models.beit3 import (
        Beit3Config, Beit3ForVisualQuestionAnswering, resolve_beit3_policies)
    from uniter_tpu_torch.ops import attention, fused_block as fb
    from uniter_tpu_torch.utils import trace

    cfg = resolve_beit3_policies(Beit3Config(
        normalize_output=False, attention_impl="auto"), "cuda")
    with torch.device("meta"):
        model = Beit3ForVisualQuestionAnswering(cfg)
    model = model.to_empty(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("weight") and p.dim() == 1:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen,
                                                device="cuda"))
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=gen,
                                           device="cuda"))
    n_img = -(-n_pairs // 5)
    batch = {
        "pixel_values": torch.randint(0, 256, (n_img, 3, 480, 480),
                                      generator=gen, device="cuda",
                                      dtype=torch.uint8),
        "img_index": torch.arange(n_pairs, device="cuda") // 5,
        "input_ids": torch.randint(3, 64000, (n_pairs, t_len), generator=gen,
                                   device="cuda"),
        "text_mask": torch.ones(n_pairs, t_len, dtype=torch.long,
                                device="cuda")}
    with torch.inference_mode():
        model.predict(batch)
        torch.cuda.synchronize()
        names = ("mha_fwd", "multiway", "ln_drop_fwd")
        fns = (attention.mha_fwd, fb.multiway_tail_fwd, fb.ln_drop_fwd)
        before = [f.launches for f in fns]
        with profile():
            logits = model.predict(batch)
            counts = dict(trace.snapshot()["counts"])
        torch.cuda.synchronize()
        launches = {n: f.launches - b0 for n, f, b0 in zip(names, fns,
                                                            before)}
        ms = cuda_ms(torch, lambda: model.predict(batch), iters=5, warmup=1)
    want = {"mha_fwd": 24, "multiway": 72, "ln_drop_fwd": 1}
    ok = (launches == want and counts.get("tail.fused") == 73
          and counts.get("tail.plain") == 25
          and bool(torch.isfinite(logits).all()))
    print(f"[beit3 serve] BEiT-3-large, {n_pairs} pairs over {n_img} images, "
          f"S = {BEIT3_SPLIT + t_len}, bf16: launches {launches} (want "
          f"{want}), counters {counts}; call {ms:.1f} ms "
          f"({n_pairs / ms * 1e3:.1f} pairs/s), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the BEiT-3 serving call launched other kernels than expected")
    del model, batch, logits
    torch.cuda.empty_cache()
    return {"launches": launches, "counts": counts, "ms": ms}


def beit3_phase(torch):
    """K1 past 512 positions, the multiway tails and one BEiT-3-large VQA
    call (``beit3_k1``, ``beit3_tails``, ``beit3_serve``)."""
    import torch.nn.functional as F

    return beit3_k1(torch, F), beit3_tails(torch, F), beit3_serve(torch)


def main(argv):
    """No arguments: every phase, the kernels line and the last line. Phase
    names (``PHASES``): the device and build phases, then those phases
    alone, and no kernels line or last line."""
    import torch

    unknown = [a for a in argv if a not in PHASES]
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}; choose from "
              f"{sorted(PHASES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "uniter_tpu_torch")):
        print("chip_smoke: run from a checkout of the repo", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seconds = {}

    def timed(phase, *args, **kw):
        t0 = time.perf_counter()
        try:
            return phase(*args, **kw)
        finally:
            name = phase.__name__
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

    t_start = time.perf_counter()
    device_phase(torch)
    build_phase()
    if argv:
        for name in argv:
            PHASES[name](torch)
        return 0
    timed(sass_phase, torch)
    k1_err, k1_time = timed(k1_phase, torch)
    k2_err, k2_bf16, k2_time, _ = timed(k2_phase, torch)
    timed(sdpa_fp32_probe, torch)
    tail_err, tail_time = timed(tail_phase, torch)
    serve_counts, n_batches, qps, _ = timed(main_path_phase, torch)
    launches = serve_counts["mha_fwd"]
    train = timed(train_phase, torch)
    train32 = timed(train32_phase, torch)
    timed(cli_phase, torch)
    nlvr2 = timed(nlvr2_phase, torch)
    timed(nlvr2_cli_phase, torch)
    k7_err, k7_time = timed(k7_phase, torch)
    k8_err, k8_time = timed(k8_phase, torch)
    pre = timed(pretrain_phase, torch)
    # K8 on a path: the 3 LayerNorms per served VQA batch that no tail
    # takes (img_layer_norm, pos_layer_norm, the answer head's
    # vqa_output.2); the 26 tails take K3/K5
    ln_counts, ln_batches, _, _ = timed(
        main_path_phase, torch, n_questions=N_QUESTIONS // 4, tag="serve-K8",
        per_batch={"mha_fwd": 12, "layer_norm_fwd": 3, "drop_res_ln_fwd": 24,
                   "ln_drop_fwd": 2},
        layer_norm_impl="pallas")
    cli_counts = timed(pretrain_cli_phase, torch)
    k9_err, k9_time = timed(k9_phase, torch)
    itm = timed(itm_train_phase, torch)
    hn = timed(hn_phase, torch)
    serve_itm = timed(itm_serve_phase, torch)
    itm_cli_counts = timed(itm_cli_phase, torch)
    vcr = timed(vcr_phase, torch)
    vcr_serve = timed(vcr_serve_phase, torch)
    re_res = timed(re_phase, torch)
    task_counts = timed(task_cli_phase, torch)
    prepro = timed(prepro_phase, torch)
    flags = timed(flags_phase, torch)
    dist = timed(dist_phase, torch)
    beit3_k1_res, beit3_tail_res, beit3_serve_res = timed(beit3_phase, torch)
    t = k2_time[TRAIN_SHAPES[0] + ("bfloat16",)]
    t32 = k2_time[TRAIN_SHAPES[0] + ("float32",)]
    kernels = []
    for name, src, kern, replaces, err, bwd, n32 in (
            ("mha_fwd", "mha_fwd.cu", "mha_fwd_tc_kernel<64>",
             "uniter_tpu/ops/attention.py:118", k2_bf16["mha_fwd_abs"],
             False, launches),
            ("mha_bwd", "mha_bwd.cu", "mha_bwd_tc_kernel<64>",
             "uniter_tpu/ops/attention.py:133", k2_bf16["mha_bwd_abs"],
             True, train32["launches"]["mha_bwd"])):
        bound, by = bound_ms(*TRAIN_SHAPES[0], "bfloat16", bwd)
        b32, by32 = bound_ms(*TRAIN_SHAPES[0], "float32", bwd)
        key, lib = ("bwd", "sdpa_bwd") if bwd else ("fwd", "sdpa_fwd")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"uniter_tpu_torch/csrc/{src}", "kernel": kern,
            "replaces": replaces,
            "launches": train["launches"][name], "max_abs_err": err,
            "ms": t[key], "plain_ms": t[0.0][f"{key}_plain"],
            "bound_ms": bound, "bound_by": by, "library_ms": t[lib],
            "device_ms": t[f"{key}_dev"],
            "library_device_ms": t[f"{lib}_dev"],
            "fp32_kernel": kern.replace("tc_kernel", "tf32_kernel"),
            "fp32_launches": n32, "fp32_max_abs_err": k2_err[name],
            "fp32_ms": t32[key], "fp32_device_ms": t32[f"{key}_dev"],
            "fp32_plain_ms": t32[0.0][f"{key}_plain"],
            "fp32_bound_ms": b32, "fp32_bound_by": by32,
            "fp32_library_ms": t32[lib],
            "fp32_library_device_ms": t32[f"{lib}_dev"],
            "dist_launches_per_step": dist["launches"][name],
            "gloo_launches_per_step": dist["gloo"]["launches"][name],
            "tp_launches_per_step": dist["tp"]["launches"][name]})
    for name, line, rows in (("drop_res_ln_fwd", 64, 9984),
                             ("drop_res_ln_bwd", 71, 9984),
                             ("ln_drop_fwd", 200, 6144),
                             ("ln_drop_bwd", 210, 6144)):
        bound, by = tail_bound_ms(name, rows, 768, "bfloat16")
        tt = tail_time[(name, "bfloat16", rows, 0.0)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "uniter_tpu_torch/csrc/fused_tail.cu",
            "replaces": f"uniter_tpu/ops/fused_block.py:{line}",
            "launches": train["launches"][name],
            "max_abs_err": tail_err[name], "ms": tt["call"],
            "plain_ms": tt["plain"], "bound_ms": bound, "bound_by": by,
            "library_ms": tt["lib_call"], "device_ms": tt["dev"],
            "library_device_ms": tt["lib_dev"],
            "dist_launches_per_step": dist["launches"][name],
            "gloo_launches_per_step": dist["gloo"]["launches"][name],
            "tp_launches_per_step": dist["tp"]["launches"][name]})
    bound, by = ipot_bound_ms(*K7_SHAPES[0])
    kernels.append({
        "name": "ipot", "route": "cuda",
        "source": "uniter_tpu_torch/csrc/ipot.cu",
        "replaces": "uniter_tpu/ops/ot.py:102",
        "launches": sum(c["ipot"] for c in pre["launches"].values()),
        "max_abs_err": k7_err, "ms": k7_time[K7_SHAPES[0]]["call"],
        "plain_ms": k7_time[K7_SHAPES[0]]["plain"], "bound_ms": bound,
        "bound_by": by, "library_ms": None,
        "device_ms": k7_time[K7_SHAPES[0]]["dev"], "library_device_ms": None})
    rows, h = TAIL_SHAPES[0]
    kernels.append({
        "name": "layer_norm_fwd", "route": "cuda",
        "source": "uniter_tpu_torch/csrc/fused_tail.cu",
        "replaces": "uniter_tpu/ops/layer_norm.py:38",
        "launches": ln_counts["layer_norm_fwd"], "max_abs_err": k8_err,
        "ms": k8_time["bfloat16"]["call"],
        "plain_ms": k8_time["bfloat16"]["plain"],
        "bound_ms": (2 * rows * h * 2 + 2 * h * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": k8_time["bfloat16"]["lib_call"],
        "device_ms": k8_time["bfloat16"]["dev"],
        "library_device_ms": k8_time["bfloat16"]["lib_dev"]})
    rows, h = K9_SHAPES[0]
    bound, by = ffn_bound_ms(rows, h, "bfloat16")
    kt = k9_time[(rows, h, "bfloat16")]
    kernels.append({
        "name": "ffn_fwd", "route": "cuda",
        "source": "uniter_tpu_torch/csrc/ffn.cu",
        "replaces": "uniter_tpu/ops/ffn.py:48",
        "launches": itm["k9_launches"], "max_abs_err": k9_err,
        "ms": kt["call"], "plain_ms": kt["plain"], "bound_ms": bound,
        "bound_by": by, "library_ms": None, "device_ms": kt["dev"],
        "library_device_ms": None,
        "tp_launches_per_step": dist["tp"]["launches"]["ffn_fwd"]})
    for dname in ("bfloat16", "float32"):
        err, bt = beit3_k1_res[dname]
        bound, by = bound_ms(*BEIT3_K1, dname, False)
        kernels.append({
            "name": "mha_fwd", "route": "cuda", "shape": list(BEIT3_K1),
            "dtype": dname, "source": "uniter_tpu_torch/csrc/mha_fwd.cu",
            "launches": beit3_serve_res["launches"]["mha_fwd"],
            "max_abs_err": err, "ms": bt["fwd"][1], "device_ms": bt["fwd"][0],
            "bound_ms": bound, "bound_by": by,
            "library_ms": bt["sdpa_fwd"][1],
            "library_device_ms": bt["sdpa_fwd"][0]})
    for (name, dname), tt in beit3_tail_res.items():
        kernels.append({
            "name": f"multiway_tail_fwd ({name})", "route": "cuda",
            "shape": [BEIT3_K1[0] * BEIT3_K1[1], 1024], "dtype": dname,
            "source": "uniter_tpu_torch/csrc/fused_tail.cu",
            "launches": beit3_serve_res["launches"]["multiway"],
            "ms": tt["kernel"][1], "device_ms": tt["kernel"][0],
            "plain_ms": tt["plain"][1], "bound_ms": tt["bound"],
            "bound_by": "bytes", "library_ms": tt["lib"][1],
            "library_device_ms": tt["lib"][0]})
    print(f"[smoke] K9 at ({rows}, {h}) bf16: the cuBLAS composition "
          f"F.linear -> F.gelu -> F.linear (no one PyTorch call computes the "
          f"fused FFN, so library_ms is null) took {kt['lib_dev'] * 1e3:.1f} "
          f"/ {kt['lib_call'] * 1e3:.1f} us (device / call); K9 "
          f"launches from the retrieval train path ({itm['k9_launches']} over "
          f"its 2 counted steps), the hard-negative step {hn['launches']} per "
          f"step, retrieval serving "
          f"{serve_itm['float32']['launches']['ffn_fwd']} per fp32 scoring "
          f"pass, the retrieval CLI {itm_cli_counts}")
    print(f"[smoke] kernels line: times bf16 rate 0 at (96, 104, 12, 64) "
          f"for K1/K2 (the bf16 tensor-core kernels; medians of {TIME_TURNS} "
          f"turns; library: scaled_dot_product_attention; the fp32_* keys: "
          f"the TF32 kernels at the same shape, fp32 K1 launches from the "
          f"default serving path, fp32 K2 launches from the fp32 flagship "
          f"train step's K1-K6 turns, {train32['launches']['mha_bwd']} over "
          f"10 steps), at (9984, "
          f"768) for K3/K4 and K8 and (6144, 768) for K5/K6 (library: "
          f"F.layer_norm, after an add for K3/K4), fp32 at (48, 64, 160) for "
          f"K7 (no library call computes it); launches of K1-K6 from the "
          f"flagship training path ({train['steps']} steps), of K7 from the "
          f"pretraining path through K1-K7 (2 steps of each of mlm, mrfr, "
          f"itm, mrc-kl: 1 per ITM step, 0 otherwise), of K8 from the "
          f"serving pass with layer_norm_impl cuda ({ln_batches} batches x "
          f"3); the default serving path launched K1 {launches} times, K3 "
          f"{serve_counts['drop_res_ln_fwd']} and K5 "
          f"{serve_counts['ln_drop_fwd']} (its tails at rate 0) and nothing "
          f"else; NLVR2 launches {nlvr2['launches']} over "
          f"{nlvr2['steps']} steps; the pretraining CLI {cli_counts}; "
          f"max_abs_err of K1/K2 the worst bf16 difference from the plain "
          f"version over the training shapes (fp32_max_abs_err: the fp32 "
          f"kernels' worst, against the plain versions and the JAX kernel's "
          f"formula), of K3-K9 the worst fp32 difference; ms, plain_ms and "
          f"library_ms are call times (calls from Python between CUDA "
          f"events: 50 for K1/K2, 500 for K3-K6 and K8, 50 for the plain "
          f"versions; K7: ipot_cuda), device_ms and library_device_ms "
          f"device times (20 (K1/K2) or 50 calls captured in one CUDA graph "
          f"and replayed; K7: ipot_cuda's calls)")
    print(f"[smoke] K1-K6 on the RE/VCR/VE paths: VCR step "
          f"{vcr['launches']} over {vcr['steps']} steps (rows/s "
          f"{vcr['rows_per_s']}), RE step {re_res['launches']} over "
          f"{re_res['steps']} steps, K1 in VCR serving "
          f"{ {k: v['n_batches'] * 12 for k, v in vcr_serve.items()} }, the "
          f"task CLIs {task_counts}")
    print(f"[smoke] K1-K6 a step under --remat (the prepro chain's "
          f"train_vqa): {prepro['launches']} over 20 steps; the flags "
          f"phase's per policy: {flags['launches']}")
    print(f"[smoke] K1-K6 a step on the distributed path (the dist phase's "
          f"train_vqa at uniter-base, bf16, dropout 0.1): under torchrun "
          f"NCCL world 1 {dist['launches']} over 20 steps "
          f"(dist_launches_per_step), each of 2 gloo ranks sharing the card "
          f"{dist['gloo']['launches']} in its one bf16 step at dropout "
          f"{RATE} (gloo_launches_per_step) and "
          f"{dist['gloo']['launches_fp32']} a step in its {GLOO_STEPS} fp32 "
          f"steps at dropout {RATE}")
    print("[smoke] seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; all, with the device and build phases, "
        f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# phases that run alone: ``python3 chip_smoke.py tails train``
PHASES = {"sass": sass_phase, "k1": k1_phase, "k2": k2_phase,
          "sdpa": sdpa_fp32_probe, "k2-groups": k2_groups_phase,
          "tails": tail_phase, "itm-serve": itm_serve_phase,
          "train32": train32_phase, "serve": main_path_phase,
          "train": train_phase, "nlvr2": nlvr2_phase, "k7": k7_phase,
          "k8": k8_phase, "pretrain": pretrain_phase, "k9": k9_phase,
          "itm": itm_train_phase, "vcr": vcr_phase,
          "vcr_serve": vcr_serve_phase, "re": re_phase,
          "task_cli": task_cli_phase, "prepro": prepro_phase,
          "flags": flags_phase, "dist": dist_phase, "beit3": beit3_phase}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:  # one rank of a dist_phase run
        sys.exit(dist_worker(sys.argv[2]))
    sys.exit(main(sys.argv[1:]))
