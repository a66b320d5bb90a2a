"""The multi-process dry run on a data x model grid (counterpart of the JAX
package's ``__graft_entry__.py`` ``dryrun_multichip``, :87-241).

``dryrun_multichip(n)`` runs in each of n processes launched by
``torchrun`` (gloo on the CPU, one card a rank under NCCL):

  * the grid: ``model`` 2 when n is even and at least 4, else 1, ``data``
    the rest, with ``--fsdp`` at ``fsdp_min_size`` 4096
    (``parallel/mesh.py`` ``make_mesh``, ``training/driver.py``
    ``place_state``: the TP blocks, then ZeRO-3 over the data group);
  * one VQA fine-tune train step of a 2-layer, 128-wide model at dropout
    0.1 on a global batch of 2n examples, each data rank on its block;
  * one pretraining ITM + OT step on the same grid and placement (the OT
    plan on the replicated hidden states: K7 on the card);
  * the retrieval scorer (``utils/itm_fast.py`` ``fast_score_matrix``)
    over 2n + 1 texts split over the data axis, 6 images.

It asserts finite losses and the score matrix's shape, as the JAX dry run
does, and returns the three results. Run it as

    torchrun --standalone --nproc_per_node 4 -m uniter_tpu_torch.dryrun \\
        [--device cpu|cuda] [--dist_backend gloo|nccl]
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np
import torch

N_ANSWER = 16
IMG_DIM = 64


def _config(device):
    from uniter_tpu_torch.config import UniterConfig

    impl = "cuda" if torch.device(device).type == "cuda" else "xla"
    return UniterConfig(
        vocab_size=512, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=256,
        max_position_embeddings=64, dtype="float32", attention_impl=impl)


def example_batch(b, t, r, *, seed=0, targets=False, vocab=512):
    """The JAX dry run's batch (``_example_batch``): ``b`` examples of
    ``t`` tokens and ``r`` regions, no padding."""
    rng = np.random.RandomState(seed)
    batch = dict(
        input_ids=rng.randint(1, vocab, (b, t)).astype(np.int64),
        position_ids=np.tile(np.arange(t, dtype=np.int64), (b, 1)),
        img_feat=rng.randn(b, r, IMG_DIM).astype(np.float32),
        img_pos_feat=rng.rand(b, r, 7).astype(np.float32),
        attn_mask=np.ones((b, t + r), np.int64))
    if targets:
        batch["targets"] = (rng.rand(b, N_ANSWER) < 0.01).astype(np.float32)
    return batch


def _block(batch, device):
    """This data rank's block of a global batch, on ``device``."""
    from uniter_tpu_torch.parallel.collectives import data_index, data_size

    n = len(batch["input_ids"]) // data_size()
    lo = data_index() * n
    return {k: torch.from_numpy(np.asarray(v[lo:lo + n])).to(device)
            for k, v in batch.items()}


def _placed(model, mcfg, device, **opt_kw):
    from uniter_tpu_torch.training.driver import init_weights, place_state
    from uniter_tpu_torch.training.sched import get_lr_schedule

    init_weights(model, 0.02)
    model.to(device)
    return place_state(model, get_lr_schedule(8e-5, 10, 100),
                       grad_norm=2.0, weight_decay=0.01, fused=True,
                       fsdp=mcfg.fsdp, fsdp_min_size=mcfg.fsdp_min_size,
                       **opt_kw)


def _vqa_step(cfg, mcfg, n, device):
    from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu_torch.parallel.collectives import global_sum
    from uniter_tpu_torch.training.step import make_train_step

    torch.manual_seed(0)
    model = UniterForVisualQuestionAnswering(cfg, img_dim=IMG_DIM,
                                             num_answer=N_ANSWER)
    state = _placed(model, mcfg, device, lr_mul=10.0, lr_mul_paths=("vqa_",))
    batch = _block(example_batch(2 * n, 8, 4, targets=True), device)

    def loss_fn(m, b, gen):
        # the global batch's mean (reference train_vqa.py:188's bce.mean()
        # * num_answer): this rank's share of it
        per = m(b, True, deterministic=False, generator=gen)
        count = global_sum(torch.tensor(float(per.numel()), device=device))
        return per.sum() / count * N_ANSWER, {}

    step = make_train_step(loss_fn, loss_scale="sum")
    _, metrics = step(state, batch, 1)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    return loss


def _pretrain_step(cfg, mcfg, n, device):
    from uniter_tpu_torch.models.pretrain import UniterForPretraining
    from uniter_tpu_torch.training.step import make_train_step

    torch.manual_seed(2)
    ot = "cuda" if torch.device(device).type == "cuda" else "xla"
    model = UniterForPretraining(cfg, img_dim=IMG_DIM, img_label_dim=17,
                                 ot_impl=ot)
    state = _placed(model, mcfg, device)
    glob = example_batch(2 * n, 8, 4, seed=1)
    glob["targets"] = np.random.RandomState(1).randint(0, 2, (2 * n,))
    batch = _block(glob, device)
    step = make_train_step(
        lambda m, b, gen: m.scalar_loss(b, "itm", ot_lambda=0.1,
                                        deterministic=False, generator=gen),
        loss_scale="sum")
    _, metrics = step(state, batch, 3)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    return loss


def _retrieval_tile(cfg, n, device):
    """The retrieval scorer over the data axis: each data rank scores its
    texts, every rank assembles the whole matrix."""
    from uniter_tpu_torch.models.itm import UniterForImageTextRetrieval
    from uniter_tpu_torch.parallel.tp import shard_model
    from uniter_tpu_torch.training.driver import init_weights
    from uniter_tpu_torch.utils.itm_fast import fast_score_matrix

    rng = np.random.RandomState(2)
    n_txt, n_img, t_bucket, r_bucket = 2 * n + 1, 6, 8, 4
    toks = [rng.randint(5, cfg.vocab_size - 1, rng.randint(3, t_bucket - 2))
            for _ in range(n_txt)]
    feats = {f"i{j}": (rng.randn(r_bucket, IMG_DIM).astype(np.float32),
                       rng.rand(r_bucket, 7).astype(np.float32), r_bucket)
             for j in range(n_img)}
    ds = SimpleNamespace(
        ids=[f"t{i}" for i in range(n_txt)], all_img_ids=list(feats),
        txt_db=SimpleNamespace(combine_inputs=lambda ids: np.concatenate(
            [[2], np.asarray(ids, np.int32), [3]])),
        img_db=SimpleNamespace(get_img_feat=lambda name: feats[name]),
        example=lambda i: {"input_ids": toks[i]})
    torch.manual_seed(4)
    model = UniterForImageTextRetrieval(cfg, img_dim=IMG_DIM)
    init_weights(model, 0.02)
    shard_model(model.to(device))
    mat, txt_ids = fast_score_matrix(model, ds, t_bucket, r_bucket,
                                     txt_tile=n, img_tile=4,
                                     dtype="float32")
    assert mat.shape == (n_txt, n_img) and len(txt_ids) == n_txt, mat.shape
    assert np.isfinite(mat).all()
    return mat


def dryrun_multichip(n: int, device: str = "cpu") -> dict:
    """The dry run on this process group of ``n`` ranks (module
    docstring); every rank calls it. Returns the grid, the two losses and
    the score matrix."""
    from uniter_tpu_torch.parallel.collectives import num_processes
    from uniter_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    if num_processes() != n:
        raise ValueError(f"dryrun_multichip({n}) in a group of "
                         f"{num_processes()} processes")
    tp = 2 if (n % 2 == 0 and n >= 4) else 1
    mcfg = MeshConfig(data=n // tp, model=tp, fsdp=True, fsdp_min_size=4096)
    mesh = make_mesh(mcfg)
    cfg = _config(device)
    return {"mesh": mesh.shape, "vqa_loss": _vqa_step(cfg, mcfg, n, device),
            "itm_ot_loss": _pretrain_step(cfg, mcfg, n, device),
            "scores": _retrieval_tile(cfg, n, device)}


def main(argv=None):
    from uniter_tpu_torch.parallel.collectives import (
        init_distributed, num_processes, process_index)

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dist_backend", default=None)
    opts = parser.parse_args(argv)
    device = init_distributed(opts.device, opts.dist_backend)
    out = dryrun_multichip(num_processes(), device)
    if process_index() == 0:
        print(f"dryrun_multichip: mesh {out['mesh']}, vqa loss "
              f"{out['vqa_loss']:.6f}, itm+ot loss {out['itm_ot_loss']:.6f}, "
              f"scores {out['scores'].shape}")
    return out


if __name__ == "__main__":
    main()
