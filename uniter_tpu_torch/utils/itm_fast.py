"""Device-resident tiled retrieval scoring (counterpart of
``uniter_tpu/utils/itm_fast.py``): the reference's ItmEvalDataset +
inference loop (reference data/itm.py:454-468, utils/itm_eval.py:93-114)
without host work per pair.

The corpus goes to the device once and each call scores a (txt_tile x
img_tile) block of pairs by broadcasting the two tiles against each other.
Two cuts over the training forward, both exact rewrites of its arithmetic
(``tests/test_torch_itm.py`` holds them to the per-pair scorer):

  * **Pre-embedded corpus.** Text and image embeddings are per-item
    functions (nothing crosses modalities before the encoder), so each text
    and image is embedded once, not once per pair; a tile assembles
    ``[txt_emb ; img_emb]`` in token space.
  * **CLS-only last layer.** The retrieval head reads ``hidden[:, 0]``
    alone (pooler -> rank_output, reference model/itm.py:33-44), so layers
    0..L-2 run through ``UniterModel.encode`` and the last layer as
    ``BertLayerCLS``: a [1, S] query and the FFN on one row.
    ``cls_path=False`` runs the whole model instead.

Over several processes the texts are sharded by stride (rank r scores
texts r, r + world, ...; reference utils/itm_eval.py:99) and the rows are
gathered with ``all_gather_array`` into the one-process order, so every
rank returns the whole matrix; every rank calls these functions together.
Everything runs eagerly under ``inference_mode``.
"""

from __future__ import annotations

import numpy as np
import torch


def build_eval_arrays(eval_ds, t_bucket: int, r_bucket: int):
    """Materialize the dataset as dense arrays.

    Returns (txt_ids [n_txt, T] int32, txt_len [n_txt], img_feat
    [n_img, R, D] fp32, img_pos [n_img, R, 7], img_nbb [n_img]) with rows
    ordered as eval_ds.ids / eval_ds.all_img_ids.
    """
    n_txt = len(eval_ds.ids)
    txt_ids = np.zeros((n_txt, t_bucket), np.int32)
    txt_len = np.zeros((n_txt,), np.int32)
    for i in range(n_txt):
        ids = np.asarray(
            eval_ds.txt_db.combine_inputs(eval_ds.example(i)["input_ids"]),
            np.int32)
        tl = min(len(ids), t_bucket)
        txt_ids[i, :tl] = ids[:tl]
        txt_len[i] = tl
    imgs = eval_ds.all_img_ids
    n_img = len(imgs)
    feat0, _, _ = eval_ds.img_db.get_img_feat(imgs[0])
    d = feat0.shape[1]
    img_feat = np.zeros((n_img, r_bucket, d), np.float32)
    img_pos = np.zeros((n_img, r_bucket, 7), np.float32)
    img_nbb = np.zeros((n_img,), np.int32)
    for j, name in enumerate(imgs):
        feat, pos7, _ = eval_ds.img_db.get_img_feat(name)
        nb = min(feat.shape[0], r_bucket)
        img_feat[j, :nb] = feat[:nb]
        img_pos[j, :nb] = pos7[:nb]
        img_nbb[j] = nb
    return txt_ids, txt_len, img_feat, img_pos, img_nbb


def _pad_rows(a, mult):
    """Pad axis 0 to a multiple of ``mult`` by repeating row 0."""
    pad = (-a.shape[0]) % mult
    return np.concatenate([a, np.repeat(a[:1], pad, 0)]) if pad else a


def my_rows(n: int) -> np.ndarray:
    """This rank's rows of ``n``: a stride over the data axis (the model
    ranks of a data group score the same rows)."""
    from uniter_tpu_torch.parallel.collectives import data_index, data_size

    return np.arange(data_index(), n, data_size())


def gather_rows(mine: np.ndarray, n: int) -> np.ndarray:
    """The [n, ...] array whose rows ``my_rows(n)`` each rank holds in
    ``mine``, assembled on every rank (``all_gather_array`` over blocks
    padded to the longest)."""
    from uniter_tpu_torch.parallel.collectives import (
        all_gather_array, data_group, data_size)

    world = data_size()
    if world == 1:
        return mine
    block = np.zeros((-(-n // world),) + mine.shape[1:], mine.dtype)
    block[:len(mine)] = mine
    blocks = all_gather_array(block, data_group())
    out = np.empty((n,) + mine.shape[1:], mine.dtype)
    for r in range(world):
        out[r::world] = blocks[r][:len(range(r, n, world))]
    return out


class _Scorer:
    """The scoring forward of one retrieval model (on its device, in eval
    mode). With ``cls_path`` and at least 2 layers the last layer runs as
    ``BertLayerCLS`` (a copy of its parameters); otherwise the whole
    encoder."""

    def __init__(self, model, cls_path: bool = True):
        from uniter_tpu_torch.models.encoder import BertLayerCLS
        from uniter_tpu_torch.parallel.tp import follow

        self.model = model
        self.uniter = model.uniter
        cfg = self.uniter.config
        self.n_layers = cfg.num_hidden_layers
        self.device = next(model.parameters()).device
        self.split = cls_path and self.n_layers >= 2
        self.cls_layer = None
        if self.split:
            last = self.uniter.encoder.layer[self.n_layers - 1]
            # the last layer's tensor-parallel blocks, when it holds some
            self.cls_layer = follow(BertLayerCLS(cfg), last).to(self.device)
            self.cls_layer.load_state_dict(last.state_dict(), strict=True)
            self.cls_layer.eval()

    def embed_txt(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device).expand_as(ids)
        return self.uniter.embeddings(ids, pos)

    def embed_img(self, feat, pos):
        type_emb = self.uniter.embeddings.token_type_embeddings(
            torch.ones(feat.shape[:2], dtype=torch.long, device=feat.device))
        return self.uniter.img_embeddings(feat, pos, type_emb)

    def score_rows(self, emb, mask):
        """[B] rank scores (fp32) from joint embeddings and 0/1 mask."""
        from uniter_tpu_torch.models.encoder import attn_bias

        if self.split:
            hidden = self.uniter.encode(emb, mask, n_layers=self.n_layers - 1)
            cls = self.cls_layer(hidden, attn_bias(mask))[:, 0]
        else:
            cls = self.uniter.encode(emb, mask)[:, 0]
        pooled = torch.tanh(self.uniter.pooler.dense(cls))
        return self.model.rank_output(pooled).float()[:, 0]

    def tile(self, t_emb, t_mask, i_emb, i_mask):
        """(txt_emb [ct, T, H], t_mask [ct, T], img_emb [ci, R, H], i_mask
        [ci, R]) -> [ct, ci] scores: the full ct x ci cross product."""
        ct, ci = t_emb.shape[0], i_emb.shape[0]
        emb = torch.cat([t_emb.repeat_interleave(ci, 0),
                         i_emb.repeat(ct, 1, 1)], 1)
        mask = torch.cat([t_mask.repeat_interleave(ci, 0),
                          i_mask.repeat(ct, 1)], 1)
        return self.score_rows(emb, mask).reshape(ct, ci)

    def window(self, t_emb, t_mask, w_idx, i_emb_all, imask_all):
        """Each of ct texts against its gathered window ``w_idx`` [ct, bs]
        -> [ct, bs]."""
        ct, bs = w_idx.shape
        idx = w_idx.reshape(-1)
        emb = torch.cat([t_emb.repeat_interleave(bs, 0), i_emb_all[idx]], 1)
        mask = torch.cat([t_mask.repeat_interleave(bs, 0), imask_all[idx]], 1)
        return self.score_rows(emb, mask).reshape(ct, bs)

    def embed_img_corpus(self, img_feat, img_pos, chunk, dtype):
        """Embed the image corpus in ``chunk``-row calls -> [n_pad, R, H] on
        the device; the raw features never stay there."""
        feat_p = _pad_rows(img_feat, chunk)
        pos_p = _pad_rows(img_pos, chunk)
        parts = [self.embed_img(self.put(feat_p[j:j + chunk], dtype),
                                self.put(pos_p[j:j + chunk], dtype))
                 for j in range(0, feat_p.shape[0], chunk)]
        return torch.cat(parts, 0)

    def put(self, a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dtype is not None:
            t = t.to(dtype)
        return t.to(self.device)


def _masks(scorer, lens, width):
    return scorer.put((np.arange(width)[None] < lens[:, None]).astype(
        np.int32))


def fast_score_matrix(model, eval_ds, t_bucket, r_bucket, *,
                      txt_tile: int = 32, img_tile: int = 128,
                      dtype="bfloat16", cls_path: bool = True):
    """[n_txt, n_img] rank-score matrix and the text ids (rows in
    ``eval_ds.ids`` order, columns in ``eval_ds.all_img_ids`` order).
    ``dtype`` is the dtype the image features travel to the device in;
    ``model`` lies on its device and computes in its config's dtype. Each
    rank scores ``my_rows`` of the texts (module docstring)."""
    txt_ids, txt_len, img_feat, img_pos, img_nbb = build_eval_arrays(
        eval_ds, t_bucket, r_bucket)
    n_all, n_img = len(txt_ids), img_feat.shape[0]
    mine = my_rows(n_all)
    txt_ids, txt_len = txt_ids[mine], txt_len[mine]
    n_txt = len(txt_ids)
    if n_txt == 0:
        return (gather_rows(np.zeros((0, n_img), np.float32), n_all),
                list(eval_ds.ids))
    # pad to tile multiples (extra rows repeat row 0; trimmed at the end)
    t_sel = _pad_rows(txt_ids, txt_tile)
    tlen_sel = _pad_rows(txt_len, txt_tile)
    nbb_p = _pad_rows(img_nbb, img_tile)
    cdt = getattr(torch, dtype)
    model.eval()
    scorer = _Scorer(model, cls_path)
    with torch.inference_mode():
        d_txt = scorer.put(t_sel)
        d_tmask = _masks(scorer, tlen_sel, t_bucket)
        d_imask = _masks(scorer, nbb_p, r_bucket)
        # the image corpus embedded once, H-wide, on the device
        d_img_emb = scorer.embed_img_corpus(img_feat, img_pos, img_tile, cdt)
        out = torch.empty((t_sel.shape[0], nbb_p.shape[0]),
                          dtype=torch.float32, device=scorer.device)
        for ti in range(0, t_sel.shape[0], txt_tile):
            # each text tile embedded once, reused across the image tiles
            t_emb = scorer.embed_txt(d_txt[ti:ti + txt_tile])
            for ij in range(0, nbb_p.shape[0], img_tile):
                out[ti:ti + txt_tile, ij:ij + img_tile] = scorer.tile(
                    t_emb, d_tmask[ti:ti + txt_tile],
                    d_img_emb[ij:ij + img_tile], d_imask[ij:ij + img_tile])
        mat = out[:n_txt, :n_img].cpu().numpy()
    return gather_rows(mat, n_all), list(eval_ds.ids)


def fast_windowed_scores(model, val_ds, t_bucket, r_bucket, *,
                         txt_chunk: int = 8, dtype="bfloat16",
                         cls_path: bool = True):
    """[n_txt, bs] window score rows (the gt image at column 0) and the text
    ids: the device-resident form of ItmValDataset's windowed validation
    (data/itm.py ``_window``). Only each text's bs window pairs are scored:
    the embedded image corpus stays on the device and each call gathers
    ``txt_chunk`` texts' circular windows from it by index. Each rank
    scores ``my_rows`` of the texts (module docstring)."""
    txt_ids, txt_len, img_feat, img_pos, img_nbb = build_eval_arrays(
        val_ds, t_bucket, r_bucket)
    n_all, n_img, bs = len(txt_ids), img_feat.shape[0], val_ds.bs
    # circular window positions per text (gt first — data/itm.py _window)
    js = np.asarray([val_ds._img_pos[val_ds.txt2img[t]] for t in val_ds.ids],
                    np.int64).reshape(-1)
    win = (js[:, None] + np.arange(bs)[None, :]) % max(n_img, 1)
    mine = my_rows(n_all)
    txt_ids, txt_len, win = txt_ids[mine], txt_len[mine], win[mine]
    n_txt = len(txt_ids)
    if n_txt == 0:
        return (gather_rows(np.zeros((0, bs), np.float32), n_all),
                list(val_ds.ids))
    t_sel = _pad_rows(txt_ids, txt_chunk)
    tlen_sel = _pad_rows(txt_len, txt_chunk)
    win_p = _pad_rows(win, txt_chunk)
    cdt = getattr(torch, dtype)
    model.eval()
    scorer = _Scorer(model, cls_path)
    with torch.inference_mode():
        d_txt = scorer.put(t_sel)
        d_tmask = _masks(scorer, tlen_sel, t_bucket)
        d_win = scorer.put(win_p.astype(np.int64))
        d_imask = _masks(scorer, img_nbb, r_bucket)
        d_img_emb = scorer.embed_img_corpus(img_feat, img_pos, max(n_img, 1),
                                            cdt)[:n_img]
        out = torch.empty((t_sel.shape[0], bs), dtype=torch.float32,
                          device=scorer.device)
        for ci in range(0, t_sel.shape[0], txt_chunk):
            t_emb = scorer.embed_txt(d_txt[ci:ci + txt_chunk])
            out[ci:ci + txt_chunk] = scorer.window(
                t_emb, d_tmask[ci:ci + txt_chunk], d_win[ci:ci + txt_chunk],
                d_img_emb, d_imask)
        mat = out[:n_txt].cpu().numpy()
    return gather_rows(mat, n_all), list(val_ds.ids)
