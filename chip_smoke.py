#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``uniter_tpu_torch``) on one NVIDIA
card: the quickest proof that the port builds and runs on the GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
   exits non-zero when torch sees no CUDA device.
2. build: every hand-written kernel from ``uniter_tpu_torch/csrc/``, one
   ``nvcc`` per source, all at once (``-Xptxas -v`` report printed).
3. K1 (``csrc/mha_fwd.cu``) against its plain version ``_mha_torch`` on
   the card, at the main path's attention shapes, fp32 and bf16, with
   random key lengths and all-padding rows; time of both at (96, 104).
4. main path: uniter-base VQA inference (12 layers, 768 hidden, 12 heads,
   3129 answers; random weights from a seed in the JAX package's parameter
   layout, carried through the weight bridge) over in-memory questions fed
   through the port's ``BucketLoader`` at ``inf_vqa``'s default 8192-token
   budget, into the same loop over batches ``inf_vqa`` runs. Once through
   the kernel (launch counts reset just before and read just after), once
   through the plain attention; logits and answers must agree.
5. the kernels' JSON line, then ``{"ok": true, "device": ...}`` as the last
   line. Any failed check raises and the script exits non-zero.

TF32 is off for matmuls and cuDNN (the port's inference runs full fp32).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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


def build_phase():
    from uniter_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    logs = _kernels.build(verbose=True)
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {sorted(_kernels.SIGNATURES)} in {secs:.2f} s "
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


def k1_phase(torch):
    from uniter_tpu_torch.ops.attention import _mha_torch, mha_fwd

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    timing = {}
    for b, s, h, d in K1_SHAPES:
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            q, k, v, bias = k1_inputs(torch, b, s, h, d, dtype, gen)
            out = mha_fwd(q, k, v, bias)
            torch.cuda.synchronize()
            ref = _mha_torch(q.float(), k.float(), v.float(), bias)
            diff = (out.float() - ref).abs()
            tol = K1_TOL[name]
            err = torch.cat([diff[:1], diff[2:]]).max().item()
            grid = diff[1].max().item()
            grid_bound = 2.0 ** -9 * v[1].float().abs().max().item() + tol
            uniform = (out[0].float() - v[0].float().mean(0)).abs().max().item()
            ok = (err <= tol and grid <= grid_bound and uniform <= tol
                  and bool(torch.isfinite(out).all()))
            print(f"[K1] B={b} S={s} H={h} D={d} {name}: max|diff| {err:.3e} "
                  f"(tol {tol:g}); all-padding rows: zero query vs uniform "
                  f"average {uniform:.3e}, random query {grid:.3e} (bound "
                  f"{grid_bound:.3e}) {'ok' if ok else 'FAIL'}")
            check(ok, f"K1 disagrees with _mha_torch at {(b, s, h, d)} {name}")
            if name == "float32":
                worst = max(worst, err)
            if (b, s, h) == K1_SHAPES[0][:3]:
                # turns: plain, kernel, kernel, plain
                t = [cuda_ms(torch, lambda: _mha_torch(q, k, v, bias)),
                     cuda_ms(torch, lambda: mha_fwd(q, k, v, bias)),
                     cuda_ms(torch, lambda: mha_fwd(q, k, v, bias)),
                     cuda_ms(torch, lambda: _mha_torch(q, k, v, bias))]
                timing[name] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
                print(f"[K1] time at B={b} S={s} H={h} D={d} {name}: kernel "
                      f"{timing[name][0] * 1e3:.1f} us, plain "
                      f"{timing[name][1] * 1e3:.1f} us per call "
                      f"(turns {', '.join(f'{x * 1e3:.1f}' for x in t)})")
    return worst, timing


def jax_layout_params(cfg, num_answer, img_dim, seed):
    """A uniter-base VQA parameter tree in the JAX package's layout (flax
    Dense kernels [in, out], layers stacked [L, ...]): normal(0, 0.02) for
    matrices and embeddings, ones and zeros for LayerNorm, zero biases."""
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


def main_path_phase(torch, device="cuda", n_questions=N_QUESTIONS,
                    **cfg_overrides):
    """uniter-base VQA inference through the kernel and through the plain
    attention. Returns (kernel launches, batches, kernel q/s, plain q/s,
    logits max|diff|, argmax agreement)."""
    from uniter_tpu_torch.config import base_config, resolve_kernel_policies
    from uniter_tpu_torch.data.buckets import spec_from_dataset
    from uniter_tpu_torch.data.loader import BucketLoader
    from uniter_tpu_torch.data.vqa import VqaDataset
    from uniter_tpu_torch.inf_vqa import answer_questions
    from uniter_tpu_torch.models.checkpoint import state_dict_from_jax_params
    from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu_torch.ops.attention import mha_fwd
    from uniter_tpu_torch.utils.const import IMG_DIM

    num_answer = 3129
    base = base_config(dtype="float32", attention_impl="pallas",
                       **cfg_overrides)
    t0 = time.perf_counter()
    sd = state_dict_from_jax_params(
        jax_layout_params(base, num_answer, IMG_DIM, SEED))
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    models = {}
    for impl in ("cuda", "xla"):
        cfg = resolve_kernel_policies(base.replace(attention_impl=impl),
                                      device)
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
    print(f"[main] uniter-base VQA, {n_questions} questions in {n_batches} "
          f"batches (budget {TOKEN_BUDGET} tokens); set-up "
          f"{time.perf_counter() - t0:.1f} s")

    def run(impl):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        results, logits = answer_questions(models[impl], loader, label2ans,
                                           device, keep_logits=True)
        return results, logits, time.perf_counter() - t

    run("xla")  # warm-up: cuBLAS handles, allocator, host pools
    mha_fwd.launches = 0
    res_k, logits_k, _ = run("cuda")
    launches = mha_fwd.launches
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
    print(f"[main] kernel vs plain attention: logits max|diff| {err:.3e} "
          f"(tol 1e-3), argmax agreement {agree * 100:.2f}% (>= 99.9%)")
    print(f"[main] kernel launches {launches} (want {base.num_hidden_layers}"
          f" layers x {n_batches} batches)")
    print(f"[main] questions/s: kernel {qps['cuda']:.1f}, plain "
          f"{qps['xla']:.1f} (turns plain, kernel, kernel, plain; host "
          f"clock, each pass ends in the logits' readback)")
    check(err <= 1e-3, f"logits differ by {err}")
    check(agree >= 0.999, f"argmax agreement {agree}")
    return launches, n_batches, qps, err


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "uniter_tpu_torch")):
        print("chip_smoke: run from a checkout of the repo", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device_phase(torch)
    build_phase()
    k1_err, k1_time = k1_phase(torch)
    launches, n_batches, qps, _ = main_path_phase(torch)
    check(launches == 12 * n_batches,
          f"K1 launched {launches} times for {n_batches} batches "
          f"(want 12 per batch)")
    kernels = [{
        "name": "mha_fwd",
        "route": "cuda",
        "source": "uniter_tpu_torch/csrc/mha_fwd.cu",
        "replaces": "uniter_tpu/ops/attention.py:118",
        "launches": launches,
        "max_abs_err": k1_err,
        "ms": k1_time["float32"][0],
        "plain_ms": k1_time["float32"][1],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
