"""BEiT-3 for VQA in plain PyTorch: the reference of the ``answer_vqa``
cells.

Written from the BEiT-3 paper (arXiv:2208.10442) and microsoft/unilm's
``beit3/modeling_finetune.py`` (``BEiT3ForVisualQuestionAnswering``,
``Pooler``) over torchscale's ``model/BEiT3.py``,
``architecture/encoder.py`` (``EncoderLayer``, pre-LN, sub-LN),
``component/multihead_attention.py``, ``component/feedforward_network.py``
and ``component/multiway_network.py``, in float32 with TF32 off (the
caller's flags) and no kernel, cache or batching trick. It imports nothing
of the program under test. Parameter names are torchscale's
(``beit3.encoder.layers.3.self_attn.q_proj.A.weight``), so one state dict
loads into both.

Every multiway module runs on the whole sequence with both weight sets and
keeps expert A's rows before the split (the vision CLS and patches) and
expert B's after it; torchscale splits the sequence and concatenates
instead, which gives the same numbers. Each pair carries its own pixels.
As in torchscale, padded text rows are zeroed after the embedding and
masked as keys with -inf. Departures: none at inference (drop-path and
dropout are identities there; no mask token, which only pretraining
reads).

``Numerics`` (``reference.model``) is how products and tensors are
computed: float32, or the control's float8 e4m3.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from gpubench.reference.model import Numerics

POS_OFFSET = 2


@dataclasses.dataclass(frozen=True)
class RefBeit3Config:
    encoder_embed_dim: int
    encoder_attention_heads: int
    encoder_ffn_embed_dim: int
    encoder_layers: int
    vocab_size: int
    img_size: int
    patch_size: int
    in_chans: int = 3
    layernorm_eps: float = 1e-5
    max_source_positions: int = 1024
    normalize_output: bool = True

    @property
    def split(self) -> int:
        return (self.img_size // self.patch_size) ** 2 + 1

    @classmethod
    def from_dict(cls, d: dict, **kw) -> "RefBeit3Config":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{**{k: v for k, v in d.items() if k in names}, **kw})


def _module(**children) -> nn.Module:
    m = nn.Module()
    for k, v in children.items():
        setattr(m, k, v)
    return m


def _pair(make) -> nn.Module:
    return _module(A=make(), B=make())


class RefBeit3Vqa(nn.Module):
    def __init__(self, cfg: RefBeit3Config, num_answer: int):
        super().__init__()
        self.cfg = cfg
        h, f, eps = (cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim,
                     cfg.layernorm_eps)
        layers = nn.ModuleList()
        for _ in range(cfg.encoder_layers):
            layers.append(_module(
                self_attn=_module(
                    k_proj=_pair(lambda: nn.Linear(h, h)),
                    v_proj=_pair(lambda: nn.Linear(h, h)),
                    q_proj=_pair(lambda: nn.Linear(h, h)),
                    out_proj=_pair(lambda: nn.Linear(h, h)),
                    inner_attn_ln=_pair(lambda: nn.LayerNorm(h, eps=eps))),
                self_attn_layer_norm=_pair(lambda: nn.LayerNorm(h, eps=eps)),
                ffn=_pair(lambda: _module(
                    fc1=nn.Linear(h, f), fc2=nn.Linear(f, h),
                    ffn_layernorm=nn.LayerNorm(f, eps=eps))),
                final_layer_norm=_pair(lambda: nn.LayerNorm(h, eps=eps))))
        encoder = _module(
            embed_positions=_module(
                A=nn.Embedding(cfg.split + POS_OFFSET, h),
                B=nn.Embedding(cfg.max_source_positions, h)),
            layers=layers)
        if cfg.normalize_output:
            encoder.layer_norm = _pair(lambda: nn.LayerNorm(h, eps=eps))
        self.beit3 = _module(
            text_embed=nn.Embedding(cfg.vocab_size, h),
            vision_embed=_module(
                proj=nn.Conv2d(cfg.in_chans, h, kernel_size=cfg.patch_size,
                               stride=cfg.patch_size),
                cls_token=nn.Parameter(torch.zeros(1, 1, h))),
            encoder=encoder)
        self.pooler = _module(norm=nn.LayerNorm(h, eps=eps),
                              dense=nn.Linear(h, h))
        self.head = nn.Sequential(nn.Linear(h, 2 * h),
                                  nn.LayerNorm(2 * h, eps=eps), nn.GELU(),
                                  nn.Linear(2 * h, num_answer))


def layer_norm_weights(model: nn.Module) -> Dict[str, bool]:
    """Which parameters are LayerNorm weights (drawn around one by the
    harness, so that the two experts' LayerNorms differ)."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            out[key] = isinstance(mod, nn.LayerNorm) and pname == "weight"
    return out


class Forward:
    """The model's logits for pairs (``pixels`` uint8 [pairs, C, size,
    size], ``input_ids`` [pairs, T] with bos and eos, ``text_mask`` [pairs,
    T], 1 at real tokens)."""

    def __init__(self, model: RefBeit3Vqa, numerics: Numerics = None):
        self.m = model
        self.cfg = model.cfg
        self.nx = numerics or Numerics()

    def lin(self, mod: nn.Linear, x):
        return self.nx.lin(x, mod.weight, mod.bias)

    def ln(self, mod: nn.LayerNorm, x):
        return self.nx.q(F.layer_norm(x, x.shape[-1:], mod.weight, mod.bias,
                                      mod.eps))

    def multiway(self, pair: nn.Module, fn, x):
        """Expert A's result on the vision rows, expert B's on the text
        rows, both computed over the whole sequence."""
        vis = (torch.arange(x.shape[1], device=x.device)
               < self.cfg.split)[None, :, None]
        return torch.where(vis, fn(pair.A, x), fn(pair.B, x))

    def attention(self, att, a, key_pad):
        cfg, nx = self.cfg, self.nx
        b, s, h = a.shape
        nh = cfg.encoder_attention_heads
        d = h // nh
        q, k, v = (self.multiway(p, self.lin, a).view(b, s, nh, d)
                   for p in (att.q_proj, att.k_proj, att.v_proj))
        q = nx.q(q * (1.0 / math.sqrt(d)))
        scores = nx.einsum("bqhd,bkhd->bhqk", q, k)
        scores = scores.masked_fill(key_pad[:, None, None, :], float("-inf"))
        probs = nx.q(torch.softmax(scores, dim=-1))
        ctx = nx.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h)
        ctx = self.multiway(att.inner_attn_ln, self.ln, ctx)
        return self.multiway(att.out_proj, self.lin, ctx)

    def ffn(self, mod, x):
        y = self.nx.q(F.gelu(self.lin(mod.fc1, x)))
        return self.lin(mod.fc2, self.ln(mod.ffn_layernorm, y))

    def logits(self, pixels, input_ids, text_mask):
        cfg, nx, m = self.cfg, self.nx, self.m
        enc, ve = m.beit3.encoder, m.beit3.vision_embed
        px = (pixels.float() / 255.0 - 0.5) / 0.5
        v = nx.q(F.conv2d(nx.q(px), nx.q(ve.proj.weight), ve.proj.bias,
                          stride=cfg.patch_size))
        v = v.flatten(2).transpose(1, 2)
        v = torch.cat((ve.cls_token.expand(v.shape[0], -1, -1), v), 1)
        v = v + enc.embed_positions.A.weight[POS_OFFSET:POS_OFFSET + v.shape[1]]
        t = input_ids.shape[1]
        w = (m.beit3.text_embed.weight[input_ids]
             + enc.embed_positions.B.weight[POS_OFFSET:POS_OFFSET + t])
        x = nx.q(torch.cat((v, w), 1))
        key_pad = torch.cat((torch.zeros(v.shape[:2], dtype=torch.bool,
                                         device=x.device), text_mask == 0), 1)
        x = x * (1.0 - key_pad[..., None].float())
        for layer in enc.layers:
            a = self.multiway(layer.self_attn_layer_norm, self.ln, x)
            x = nx.q(x + self.attention(layer.self_attn, a, key_pad))
            f = self.multiway(layer.final_layer_norm, self.ln, x)
            x = nx.q(x + self.multiway(layer.ffn, self.ffn, f))
        if cfg.normalize_output:
            x = self.multiway(enc.layer_norm, self.ln, x)
        p = m.pooler
        pooled = nx.q(torch.tanh(self.lin(p.dense, self.ln(p.norm, x[:, 0]))))
        hd = m.head
        y = nx.q(F.gelu(self.ln(hd[1], self.lin(hd[0], pooled))))
        return self.lin(hd[3], y).float()


def init_params(model: nn.Module, seed: int, device, std: float = 0.02):
    """The run's parameters for ``model``'s names (``harness.make_params``:
    one normal(0, ``std``) draw cut by sorted name), each LayerNorm weight
    moved to 1 + 5 x its draw (about N(1, 0.1)), so that every expert's
    LayerNorms differ from its twin's."""
    from gpubench.harness import make_params

    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    params = make_params(shapes, {n: "normal" for n in shapes}, seed,
                         device, std)
    for n, is_w in layer_norm_weights(model).items():
        if is_w:
            params[n] = 1.0 + 5.0 * params[n]
    return params
