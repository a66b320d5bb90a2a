"""The frozen reference against the port's plain paths at tiny widths:
the dropout bits and seeds, the VQA and pretraining losses and their
gradients through the trunk with dropout, AdamW over three steps, IPOT,
and the scorer's CLS path. (The tests import both; the reference imports
nothing of the port.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench.corpus import ImageCorpus, TextCorpus
from gpubench.harness import make_params, reference_shapes
from gpubench.reference import batches as rb
from gpubench.reference.model import (Forward, RefConfig, RefModel, decays,
                                      init_kind, ipot)
from gpubench.reference.optim import RefAdamW, warmup_linear_lr
from gpubench.reference.philox import StepSeeds, keep_mask

torch.set_num_threads(2)
CFG = dict(vocab_size=28996, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128,
           max_position_embeddings=512, type_vocab_size=2)


def _port_cfg():
    from uniter_tpu_torch.config import tiny_config

    return tiny_config(vocab_size=28996, max_position_embeddings=512,
                       hidden_dropout_prob=0.1,
                       attention_probs_dropout_prob=0.1)


def _pair(heads, port_model, seed=5, **kw):
    ref = RefModel(RefConfig.from_dict(CFG), heads, **kw)
    sd = make_params(reference_shapes(ref), init_kind(ref), seed, "cpu", 0.02)
    ref.load_state_dict(sd)
    port_model.load_state_dict(sd)
    return ref, port_model


@pytest.mark.parametrize("shape,rate", [((3, 5, 7), 0.1), ((2, 4, 9, 9), 0.1),
                                        ((4, 33), 0.5)])
def test_keep_mask_is_the_ports(shape, rate):
    from uniter_tpu_torch.ops.dropout import keep_mask as port_mask

    assert torch.equal(keep_mask(2**40 + 17, shape, rate),
                       port_mask(2**40 + 17, 0, shape, rate))


@pytest.mark.parametrize("seed,step", [(0, 0), (2**31 - 2, 5), (12345, 2)])
def test_step_seeds_are_the_ports(seed, step):
    from uniter_tpu_torch.ops.dropout import draw_seed
    from uniter_tpu_torch.training.step import step_generator

    mine, port = StepSeeds(seed, step), step_generator(seed, step)
    assert [mine.next() for _ in range(8)] == [draw_seed(port)
                                              for _ in range(8)]


def _same_grads(port, ref, rtol):
    """Equal gradients, a leaf that got none counting as zeros."""
    gp = dict(port.named_parameters())
    for n, p in ref.named_parameters():
        want = p.grad if p.grad is not None else torch.zeros_like(p)
        got = gp[n].grad if gp[n].grad is not None else torch.zeros_like(p)
        torch.testing.assert_close(got, want, rtol=rtol, atol=1e-6)


def _corpus():
    images = ImageCorpus(3, 12, (10, 30), soft=True)
    texts = TextCorpus(4, 40, (4, 20), images, num_answer=50)
    return images, texts


def _tensors(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()
            if isinstance(v, np.ndarray)}


def test_vqa_loss_and_gradients_match_the_port():
    from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu_torch.train_vqa import vqa_loss
    from uniter_tpu_torch.training.step import step_generator

    images, texts = _corpus()
    b = _tensors(rb.vqa_batch(texts.ids[:6], 32, 40, texts, images, 50))
    ref, port = _pair("vqa", UniterForVisualQuestionAnswering(
        _port_cfg(), 2048, 50), num_answer=50)
    port.train()
    lp = vqa_loss(port, b, step_generator(9, 1), 50)
    lr = Forward(ref).vqa_loss(b, StepSeeds(9, 1))
    lp.backward()
    lr.backward()
    assert abs(float(lp.detach()) - float(lr.detach())) <= 1e-5 * abs(
        float(lr.detach()))
    _same_grads(port, ref, rtol=1e-4)


@pytest.mark.parametrize("task", ["mlm", "mrfr", "mrckl", "itm"])
def test_pretrain_losses_and_gradients_match_the_port(task):
    from uniter_tpu_torch.models.pretrain import UniterForPretraining
    from uniter_tpu_torch.training.step import step_generator

    images, texts = _corpus()
    tags = []
    for i in range(5):
        rs = np.random.RandomState(100 + i)
        tags.append((texts.ids[i], texts.img[(i * 7) % 12], i % 2,
                     rs.get_state()))
    b = _tensors(rb.pretrain_batch(task, tags, 32, 40, texts, images, 0.15))
    ref, port = _pair("pretrain", UniterForPretraining(_port_cfg(), 2048,
                                                       1601))
    port.train()
    lp, _ = port.scalar_loss(b, task, ot_lambda=0.1 if task == "itm" else 0,
                             deterministic=False,
                             generator=step_generator(11, 2))
    lr = Forward(ref).pretrain_loss(b, task, StepSeeds(11, 2), 0.1)
    lp.backward()
    lr.backward()
    assert abs(float(lp.detach()) - float(lr.detach())) <= 1e-5 * abs(
        float(lr.detach()))
    _same_grads(port, ref, rtol=1e-3)


def test_adamw_three_steps_match_the_port():
    from uniter_tpu_torch.models.vqa import UniterForVisualQuestionAnswering
    from uniter_tpu_torch.training.optim import build_optimizer
    from uniter_tpu_torch.training.sched import get_lr_schedule

    ref, port = _pair("vqa", UniterForVisualQuestionAnswering(
        _port_cfg(), 2048, 50), num_answer=50)
    opt = build_optimizer(port, get_lr_schedule(5e-3, 2, 10),
                          betas=(0.9, 0.98), weight_decay=0.01,
                          grad_norm=2.0, lr_mul=10.0, lr_mul_paths=("vqa_",),
                          fused=True)
    mine = RefAdamW(dict(ref.named_parameters()),
                    lr_fn=warmup_linear_lr(5e-3, 2, 10), grad_norm=2.0,
                    decay=decays(ref),
                    lr_mul={n: 10.0 for n, _ in ref.named_parameters()
                            if "vqa_" in n})
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        for n, p in ref.named_parameters():
            g = torch.randn(p.shape, generator=gen)
            p.grad = g.clone()
            dict(port.named_parameters())[n].grad = g.clone()
        opt.step()
        mine.step()
    pp = dict(port.named_parameters())
    for n, p in ref.named_parameters():
        torch.testing.assert_close(pp[n].detach(), p.detach(), rtol=1e-5,
                                   atol=1e-7)


def test_ipot_matches_the_port():
    from uniter_tpu_torch.ops.ot import ipot as port_ipot

    gen = torch.Generator().manual_seed(1)
    b, m, n = 3, 7, 5
    C = torch.rand(b, m, n, generator=gen)
    x_pad = torch.zeros(b, m, dtype=torch.bool)
    x_pad[0, 5:] = True
    y_pad = torch.zeros(b, n, dtype=torch.bool)
    y_pad[1, 3:] = True
    joint = x_pad[:, :, None] | y_pad[:, None, :]
    C = C.masked_fill(joint, 0.0)
    args = (C, (~x_pad).sum(1).float(), x_pad, (~y_pad).sum(1).float(),
            y_pad, joint)
    torch.testing.assert_close(ipot(*args), port_ipot(*args, 0.5, 50, 1),
                               rtol=1e-5, atol=1e-7)


def test_cls_scores_are_the_full_trunks_cls_row():
    images, texts = _corpus()
    b = _tensors(rb.vqa_batch(texts.ids[:4], 32, 40, texts, images, 50))
    ref = RefModel(RefConfig.from_dict(CFG), "pretrain")
    ref.load_state_dict(make_params(reference_shapes(ref), init_kind(ref), 2,
                                    "cpu", 0.02))
    fwd = Forward(ref)
    with torch.no_grad():
        full = fwd.pooled(fwd.trunk(b))
        want = fwd._lin(full, ref.itm_output)[:, 0]
        got = fwd.cls_scores(b, ref.itm_output)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
