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

import itertools

import numpy as np
import torch

from uniter_tpu_torch.utils import trace

# scoring calls of this process: the request id of their spans
_CALLS = itertools.count(1)


@trace.span("itm.build_arrays")
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
    with trace.span("itm.gather"):
        block = np.zeros((-(-n // world),) + mine.shape[1:], mine.dtype)
        block[:len(mine)] = mine
        blocks = all_gather_array(block, data_group())
        out = np.empty((n,) + mine.shape[1:], mine.dtype)
        for r in range(world):
            out[r::world] = blocks[r][:len(range(r, n, world))]
    return out


def _count_slots(pair_len, real, width: int):
    """The counters of one tile of pairs: ``itm.slots``, the token slots it
    computes (``width`` = T + R a pair, rows repeated to fill the tile
    included), and ``itm.valid_slots``, the real pairs' text lengths plus
    region counts (``pair_len`` [ct, ci], ``real`` [ct, ci] bool; host
    arrays)."""
    trace.count("itm.slots", real.size * width)
    trace.count("itm.valid_slots", int(pair_len[real].sum()))


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

    @trace.span("itm.tile")
    def tile(self, t_emb, t_mask, i_emb, i_mask):
        """(txt_emb [ct, T, H], t_mask [ct, T], img_emb [ci, R, H], i_mask
        [ci, R]) -> [ct, ci] scores: the full ct x ci cross product."""
        ct, ci = t_emb.shape[0], i_emb.shape[0]
        emb = torch.cat([t_emb.repeat_interleave(ci, 0),
                         i_emb.repeat(ct, 1, 1)], 1)
        mask = torch.cat([t_mask.repeat_interleave(ci, 0),
                          i_mask.repeat(ct, 1)], 1)
        return self.score_rows(emb, mask).reshape(ct, ci)

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


class _Cross:
    """The columns of ``fast_score_matrix``: every image, crossed with a
    text tile ``img_tile`` images at a time, the corpus embedded in chunks
    of as many."""

    def __init__(self, img_tile: int):
        self.chunk = img_tile

    def select(self, ds, mine, n_img, txt_tile):
        """-> (the result's columns, the columns computed)."""
        return n_img, -(-n_img // self.chunk) * self.chunk

    def upload(self, scorer):
        pass

    def tiles(self, scorer, out, rows, t_emb, t_mask, i_emb, i_mask):
        """Score each tile of the text tile ``rows`` into ``out`` (no tile's
        scores outlive their copy) and yield its images' indices."""
        for ij in range(0, i_emb.shape[0], self.chunk):
            cols = slice(ij, ij + self.chunk)
            out[rows, cols] = scorer.tile(t_emb, t_mask, i_emb[cols],
                                          i_mask[cols])
            yield np.arange(ij, ij + self.chunk)[None]


class _Windows:
    """The columns of ``fast_windowed_scores``: each text's circular
    window of ``bs`` images (gt first, data/itm.py ``_window``), gathered
    by index from the corpus embedded in one call."""

    def select(self, ds, mine, n_img, txt_tile):
        js = np.asarray([ds._img_pos[ds.txt2img[t]] for t in ds.ids],
                        np.int64).reshape(-1)
        win = (js[:, None] + np.arange(ds.bs)[None, :]) % max(n_img, 1)
        self.win = _pad_rows(win[mine], txt_tile)
        self.chunk = max(n_img, 1)
        return ds.bs, ds.bs

    def upload(self, scorer):
        self.d_win = scorer.put(self.win.astype(np.int64))

    def tiles(self, scorer, out, rows, t_emb, t_mask, i_emb, i_mask):
        """Each text of ``rows`` against its gathered window: one tile."""
        bs = self.win.shape[1]
        with trace.span("itm.tile"):
            idx = self.d_win[rows].reshape(-1)
            emb = torch.cat([t_emb.repeat_interleave(bs, 0), i_emb[idx]], 1)
            mask = torch.cat([t_mask.repeat_interleave(bs, 0), i_mask[idx]], 1)
            scores = scorer.score_rows(emb, mask).reshape(-1, bs)
        out[rows] = scores
        yield self.win[rows]


def _score(model, ds, t_bucket, r_bucket, txt_tile, dtype, cls_path, side):
    """The call path of both scorers, the span ``itm.score`` (the call
    number its request): the dataset's arrays, this rank's texts padded to
    ``txt_tile`` rows and the images to ``side.chunk`` (extra rows repeat
    row 0; trimmed at the end), the upload, the tiles and the readback,
    then the rows of every rank. ``side`` (``_Cross`` or ``_Windows``)
    gives the images each text meets."""
    with trace.span("itm.score", request=next(_CALLS)):
        txt_ids, txt_len, img_feat, img_pos, img_nbb = build_eval_arrays(
            ds, t_bucket, r_bucket)
        n_all, n_img = len(txt_ids), img_feat.shape[0]
        mine = my_rows(n_all)
        n_cols, width = side.select(ds, mine, n_img, txt_tile)
        txt_ids, txt_len = txt_ids[mine], txt_len[mine]
        n_txt = len(txt_ids)
        if n_txt == 0:
            return (gather_rows(np.zeros((0, n_cols), np.float32), n_all),
                    list(ds.ids))
        t_sel = _pad_rows(txt_ids, txt_tile)
        tlen_sel = _pad_rows(txt_len, txt_tile)
        nbb = _pad_rows(img_nbb, side.chunk)
        model.eval()
        scorer = _Scorer(model, cls_path)
        with torch.inference_mode():
            with trace.span("itm.upload"):
                d_txt = scorer.put(t_sel)
                d_tmask = _masks(scorer, tlen_sel, t_bucket)
                d_imask = _masks(scorer, nbb, r_bucket)
                # the image corpus embedded once, H-wide, on the device
                d_img_emb = scorer.embed_img_corpus(
                    img_feat, img_pos, side.chunk, getattr(torch, dtype))
                side.upload(scorer)
            out = torch.empty((t_sel.shape[0], width), dtype=torch.float32,
                              device=scorer.device)
            for ti in range(0, t_sel.shape[0], txt_tile):
                rows = slice(ti, ti + txt_tile)
                # each text tile embedded once, reused across its columns
                t_emb = scorer.embed_txt(d_txt[rows])
                for img in side.tiles(scorer, out, rows, t_emb,
                                      d_tmask[rows], d_img_emb, d_imask):
                    if trace.on():
                        r = np.arange(ti, ti + txt_tile)[:, None]
                        _count_slots(tlen_sel[r] + nbb[img],
                                     (r < n_txt) & (img < n_img),
                                     t_bucket + r_bucket)
            with trace.span("itm.readback"):
                mat = out[:n_txt, :n_cols].cpu().numpy()
        return gather_rows(mat, n_all), list(ds.ids)


def fast_score_matrix(model, eval_ds, t_bucket, r_bucket, *,
                      txt_tile: int = 32, img_tile: int = 128,
                      dtype="bfloat16", cls_path: bool = True):
    """[n_txt, n_img] rank-score matrix and the text ids (rows in
    ``eval_ds.ids`` order, columns in ``eval_ds.all_img_ids`` order).
    ``dtype`` is the dtype the image features travel to the device in;
    ``model`` lies on its device and computes in its config's dtype. Each
    rank scores ``my_rows`` of the texts (module docstring). One call is
    the span ``itm.score`` (the call number its request)."""
    return _score(model, eval_ds, t_bucket, r_bucket, txt_tile, dtype,
                  cls_path, _Cross(img_tile))


def fast_windowed_scores(model, val_ds, t_bucket, r_bucket, *,
                         txt_chunk: int = 8, dtype="bfloat16",
                         cls_path: bool = True):
    """[n_txt, bs] window score rows (the gt image at column 0) and the text
    ids: the device-resident form of ItmValDataset's windowed validation
    (data/itm.py ``_window``). Only each text's bs window pairs are scored:
    the embedded image corpus stays on the device and each call gathers
    ``txt_chunk`` texts' circular windows from it by index. Each rank
    scores ``my_rows`` of the texts (module docstring). One call is the
    span ``itm.score`` (the call number its request)."""
    return _score(model, val_ds, t_bucket, r_bucket, txt_chunk, dtype,
                  cls_path, _Windows())
