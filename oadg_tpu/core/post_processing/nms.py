"""Padded, jit-safe NMS (replaces mmcv.ops.nms CUDA kernels).

The reference calls CUDA ``nms``/``batched_nms`` from RPN proposal generation
(mmdet/models/dense_heads/rpn_head.py:231) and ``multiclass_nms``
(mmdet/core/post_processing/bbox_nms.py:8). Sequential greedy NMS does not map
to a static-shape XLA program; we use the tiled suppression algorithm (as in TF's
``non_max_suppression_padded``): process score-sorted boxes in tiles; each tile
is first suppressed by previously resolved tiles with one matrix op, then
resolved internally by iterating a self-suppression fixpoint that provably
converges to the exact greedy result (a box's row is zeroed — it can no longer
suppress — once a definite survivor suppresses it; survivors' rows are never
zeroed). All shapes are static; results come back as fixed-size arrays with
validity masks.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..bbox.geometry import bbox_overlaps

__all__ = ["nms_padded", "batched_nms_padded", "multiclass_nms", "nms_numpy"]


def _pairwise_iou(a, b):
    return bbox_overlaps(a, b, mode="iou")


def nms_padded(boxes: jnp.ndarray,
               scores: jnp.ndarray,
               iou_threshold: float,
               valid: Optional[jnp.ndarray] = None,
               tile_size: int = 256) -> jnp.ndarray:
    """Exact greedy NMS on fixed-size inputs.

    Args:
        boxes: (N, 4) [x1,y1,x2,y2]; scores: (N,); valid: (N,) bool mask of
            real entries (padding rows never kept and never suppress).

    Returns:
        keep: (N,) bool, aligned with input order.
    """
    n = boxes.shape[0]
    if valid is None:
        valid = jnp.ones((n,), dtype=bool)
    t = int(min(tile_size, n))
    n_pad = ((n + t - 1) // t) * t

    neg_inf = jnp.asarray(-jnp.inf, scores.dtype)
    scores_m = jnp.where(valid, scores, neg_inf)
    order = jnp.argsort(-scores_m)
    boxes_s = boxes[order]
    valid_s = valid[order]
    if n_pad != n:
        boxes_s = jnp.pad(boxes_s, ((0, n_pad - n), (0, 0)))
        valid_s = jnp.pad(valid_s, (0, n_pad - n))

    num_tiles = n_pad // t

    def outer(k, keep):
        start = k * t
        tile_boxes = jax.lax.dynamic_slice(boxes_s, (start, 0), (t, 4))
        tile_valid = jax.lax.dynamic_slice(valid_s, (start,), (t,))
        # 1) cross suppression by resolved earlier tiles (keep is False for
        #    this tile and beyond, so the mask restricts to the prefix).
        iou_cross = _pairwise_iou(tile_boxes, boxes_s)            # (t, n_pad)
        sup = jnp.any(keep[None, :] & (iou_cross > iou_threshold), axis=1)
        alive = tile_valid & ~sup
        # 2) within-tile exact resolution via self-suppression fixpoint.
        iou_tile = _pairwise_iou(tile_boxes, tile_boxes)          # (t, t)
        tri = (jnp.arange(t)[:, None] < jnp.arange(t)[None, :])   # row j suppresses col i (j<i)
        iou_m0 = jnp.where(tri & alive[:, None] & alive[None, :]
                           & (iou_tile > iou_threshold), iou_tile, 0.0)

        def cond(state):
            _, changed = state
            return changed

        def body(state):
            iou_m, _ = state
            # a box with an incoming edge is (tentatively) suppressed;
            # zero its outgoing row if suppressed by a definite survivor.
            no_incoming = jnp.max(iou_m, axis=0) <= iou_threshold  # definite survivor
            incoming_from_survivor = jnp.max(
                jnp.where(no_incoming[:, None], iou_m, 0.0), axis=0) > iou_threshold
            new_iou = jnp.where(incoming_from_survivor[:, None], 0.0, iou_m)
            changed = jnp.any(new_iou != iou_m)
            return new_iou, changed

        iou_m, _ = jax.lax.while_loop(cond, body, (iou_m0, jnp.asarray(True)))
        tile_keep = alive & (jnp.max(iou_m, axis=0) <= iou_threshold)
        return jax.lax.dynamic_update_slice(keep, tile_keep, (start,))

    keep_s = jax.lax.fori_loop(0, num_tiles, outer, jnp.zeros((n_pad,), dtype=bool))
    keep_s = keep_s[:n]
    return jnp.zeros((n,), dtype=bool).at[order].set(keep_s)


def batched_nms_padded(boxes, scores, idxs, iou_threshold, valid=None,
                       class_agnostic: bool = False, tile_size: int = 256):
    """NMS applied independently per idx group via the coordinate-offset trick
    (mmcv.ops.batched_nms semantics)."""
    if class_agnostic:
        return nms_padded(boxes, scores, iou_threshold, valid, tile_size)
    max_coord = jnp.max(jnp.where((valid if valid is not None else
                                   jnp.ones(boxes.shape[:1], bool))[:, None],
                                  boxes, 0.0))
    offsets = idxs.astype(boxes.dtype) * (max_coord + 1.0)
    boxes_off = boxes + offsets[:, None]
    return nms_padded(boxes_off, scores, iou_threshold, valid, tile_size)


def soft_nms_padded(boxes: jnp.ndarray, scores: jnp.ndarray,
                    iou_threshold: float = 0.3, sigma: float = 0.5,
                    min_score: float = 1e-3, method: str = "linear",
                    max_out: Optional[int] = None,
                    valid: Optional[jnp.ndarray] = None):
    """Soft-NMS (Bodla et al.; mmcv.ops.soft_nms semantics): instead of
    suppressing overlaps, decay their scores — ``linear`` (1 - iou when
    iou > iou_threshold) or ``gaussian`` (exp(-iou^2 / sigma)).

    Static-shape formulation: ``max_out`` sequential argmax picks over a
    precomputed (N, N) IoU matrix; boxes whose decayed score falls below
    ``min_score`` stop being picked. O(N^2) memory — intended for
    test-time candidate sets (mmdet uses it only in rcnn test_cfg).

    Returns (new_scores (N,), keep (N,) bool) aligned with input order:
    ``new_scores`` holds the decayed score of every kept box.
    """
    n = boxes.shape[0]
    mo = n if max_out is None else min(int(max_out), n)
    if valid is None:
        valid = jnp.ones((n,), bool)
    neg_inf = jnp.asarray(-jnp.inf, jnp.float32)
    iou = _pairwise_iou(boxes, boxes)
    cur = jnp.where(valid, scores.astype(jnp.float32), neg_inf)
    out_sc = jnp.zeros((n,), jnp.float32)
    keep = jnp.zeros((n,), bool)

    def body(i, state):
        cur, out_sc, keep = state
        m = jnp.argmax(cur)
        ms = cur[m]
        ok = ms > min_score
        out_sc = out_sc.at[m].set(jnp.where(ok, ms, 0.0))
        keep = keep.at[m].max(ok)
        row = iou[m]
        if method == "gaussian":
            decay = jnp.exp(-(row ** 2) / sigma)
        else:
            decay = jnp.where(row > iou_threshold, 1.0 - row, 1.0)
        # Guard eliminated (-inf) entries: -inf * 0 (linear decay at IoU==1)
        # would produce NaN, which argmax then prefers, burning pick budget.
        live = ok & (cur > neg_inf)
        cur = jnp.where(live, cur * decay, cur)
        cur = cur.at[m].set(neg_inf)
        return cur, out_sc, keep

    _, out_sc, keep = jax.lax.fori_loop(0, mo, body, (cur, out_sc, keep))
    return out_sc, keep


@partial(jax.jit, static_argnames=("max_per_img", "score_thr",
                                   "iou_threshold", "num_classes",
                                   "nms_type", "sigma", "min_score"))
def multiclass_nms(multi_bboxes: jnp.ndarray,
                   multi_scores: jnp.ndarray,
                   score_thr: float,
                   iou_threshold: float,
                   max_per_img: int,
                   num_classes: int,
                   nms_type: str = "nms",
                   sigma: float = 0.5,
                   min_score: float = 1e-3) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Static-shape multiclass NMS (reference core/post_processing/bbox_nms.py:8).

    Args:
        multi_bboxes: (N, 4) or (N, C*4); multi_scores: (N, C+1), last column
        is background (dropped).
        nms_type: 'nms' (hard greedy) or 'soft_nms' / 'soft_nms_gaussian'
        (score decay; test_cfg ``nms=dict(type='soft_nms', ...)``).

    Returns:
        dets (max_per_img, 5) [x1,y1,x2,y2,score], labels (max_per_img,),
        valid (max_per_img,) bool.
    """
    n = multi_scores.shape[0]
    c = num_classes
    scores = multi_scores[:, :c]                                  # (N, C)
    if multi_bboxes.shape[-1] > 4:
        bboxes = multi_bboxes.reshape(n, c, 4)
    else:
        bboxes = jnp.broadcast_to(multi_bboxes[:, None, :], (n, c, 4))
    bboxes = bboxes.reshape(-1, 4)
    scores = scores.reshape(-1)
    labels = jnp.broadcast_to(jnp.arange(c, dtype=jnp.int32)[None, :], (n, c)).reshape(-1)
    valid = scores > score_thr
    if nms_type in ("soft_nms", "soft_nms_linear", "soft_nms_gaussian"):
        # class separation via the same coordinate-offset trick
        max_coord = jnp.max(jnp.where(valid[:, None], bboxes, 0.0))
        boxes_off = bboxes + (labels.astype(bboxes.dtype)
                              * (max_coord + 1.0))[:, None]
        method = "gaussian" if nms_type == "soft_nms_gaussian" else "linear"
        scores, keep = soft_nms_padded(
            boxes_off, scores, iou_threshold=iou_threshold, sigma=sigma,
            min_score=min_score, method=method,
            max_out=min(4 * max_per_img, scores.shape[0]), valid=valid)
    else:
        keep = batched_nms_padded(bboxes, scores, labels, iou_threshold,
                                  valid=valid)
    final_scores = jnp.where(keep, scores, -jnp.inf)
    top_scores, top_idx = jax.lax.top_k(final_scores, max_per_img)
    out_valid = top_scores > -jnp.inf
    dets = jnp.concatenate([bboxes[top_idx],
                            jnp.where(out_valid, top_scores, 0.0)[:, None]], axis=-1)
    dets = jnp.where(out_valid[:, None], dets, 0.0)
    out_labels = jnp.where(out_valid, labels[top_idx], -1)
    return dets, out_labels, out_valid


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Sequential greedy NMS reference (for tests). Returns kept indices
    in descending-score order."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1) * (y2 - y1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1)
        h = np.maximum(0.0, yy2 - yy1)
        inter = w * h
        iou = inter / np.maximum(areas[i] + areas[order[1:]] - inter, 1e-6)
        order = order[1:][iou <= iou_threshold]
    return np.array(keep, dtype=np.int64)


def nms_match(boxes: jnp.ndarray, scores: jnp.ndarray,
              iou_threshold: float, valid=None):
    """mmcv.ops.nms_match semantics, static-shape: returns for each box the
    index of the kept (suppressing) box it was matched to — kept boxes map
    to themselves. Groups = boxes sharing a match index."""
    keep = nms_padded(boxes, scores, iou_threshold, valid)
    from ..bbox.geometry import bbox_overlaps
    ious = bbox_overlaps(boxes, boxes)
    cand = ious >= iou_threshold
    cand = cand & keep[None, :]
    sc = jnp.where(cand, scores[None, :], -jnp.inf)
    match = jnp.argmax(sc, axis=1)
    self_idx = jnp.arange(boxes.shape[0])
    return jnp.where(keep, self_idx, match)
