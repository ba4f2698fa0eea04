"""Matrix NMS (SOLO) and Fast NMS (YOLACT) — static-shape jnp.

Both algorithms are already matrix-parallel in the reference (they were
designed to avoid sequential greedy NMS), so they map to XLA
directly; only the dynamic filtering becomes masked static sorts.

Parity targets:
- mask_matrix_nms: reference mmdet/core/post_processing/matrix_nms.py:5
  (SOLO decode path).
- fast_nms: reference mmdet/core/post_processing/bbox_nms.py:189
  (YOLACT decode path).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("kernel", "sigma", "filter_thr",
                                   "max_num"))
def mask_matrix_nms(masks: jnp.ndarray,
                    labels: jnp.ndarray,
                    scores: jnp.ndarray,
                    valid: Optional[jnp.ndarray] = None,
                    filter_thr: float = -1.0,
                    max_num: int = -1,
                    kernel: str = "gaussian",
                    sigma: float = 2.0,
                    mask_area: Optional[jnp.ndarray] = None):
    """Matrix NMS over binary masks (reference matrix_nms.py:5).

    Args:
        masks: (N, H, W) float/bool instance masks (padded rows allowed).
        labels/scores: (N,); valid: (N,) bool padding mask.
        filter_thr: decayed-score threshold (<=0: keep all).
        max_num: output rows (<=0: N). Static.

    Returns (scores, labels, masks, keep_inds, valid_out) — rows sorted
    by decayed score, exactly the reference's output modulo static
    padding (valid_out marks real rows).
    """
    n = masks.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    flat = masks.reshape(n, -1).astype(jnp.float32)
    if mask_area is None:
        mask_area = flat.sum(axis=1)
    scores = jnp.where(valid, scores.astype(jnp.float32), -jnp.inf)

    # sort descending (the reference's nms_pre truncation is the caller's
    # top_k here — shapes are static)
    order = jnp.argsort(-scores)
    scores = scores[order]
    labels = labels[order]
    flat = flat[order]
    mask_area = mask_area[order]
    valid_s = valid[order]

    inter = flat @ flat.T                                      # (N, N)
    union = mask_area[:, None] + mask_area[None, :] - inter
    iou = jnp.where(union > 0, inter / jnp.maximum(union, 1e-12), 0.0)
    tri = (jnp.arange(n)[:, None] < jnp.arange(n)[None, :])   # upper, k=1
    same = (labels[:, None] == labels[None, :]) & valid_s[:, None] \
        & valid_s[None, :]
    decay_iou = jnp.where(tri & same, iou, 0.0)                # (N, N)
    compensate = jnp.max(decay_iou, axis=0)                    # (N,)
    comp_m = jnp.broadcast_to(compensate[:, None], (n, n))
    if kernel == "gaussian":
        decay = jnp.exp(-sigma * decay_iou ** 2) / jnp.exp(
            -sigma * comp_m ** 2)
    elif kernel == "linear":
        decay = (1 - decay_iou) / jnp.maximum(1 - comp_m, 1e-12)
    else:
        raise NotImplementedError(kernel)
    # rows without any suppressing edge must contribute 1, not their
    # compensation factor: restrict the min to real edges
    decay = jnp.where(tri & same, decay, 1.0)
    coeff = jnp.min(decay, axis=0)
    new_scores = jnp.where(valid_s, scores * coeff, -jnp.inf)
    if filter_thr > 0:
        valid_s = valid_s & (new_scores >= filter_thr)
        new_scores = jnp.where(valid_s, new_scores, -jnp.inf)

    order2 = jnp.argsort(-new_scores)
    m = n if max_num is None or max_num <= 0 else min(int(max_num), n)
    order2 = order2[:m]
    keep_inds = order[order2]
    out_scores = new_scores[order2]
    out_valid = valid_s[order2] & jnp.isfinite(out_scores)
    return (jnp.where(out_valid, out_scores, 0.0), labels[order2],
            masks[keep_inds], keep_inds, out_valid)


@partial(jax.jit, static_argnames=("score_thr", "iou_thr", "top_k",
                                   "max_num"))
def fast_nms(multi_bboxes: jnp.ndarray,
             multi_scores: jnp.ndarray,
             multi_coeffs: jnp.ndarray,
             score_thr: float,
             iou_thr: float,
             top_k: int,
             max_num: int = -1):
    """YOLACT Fast NMS (reference bbox_nms.py:189): per-class top-k,
    upper-triangular IoU max against HIGHER-scored detections of the same
    class (removed detections still suppress), then one global top max_num.

    Args:
        multi_bboxes: (N, 4) or (N, C*4); multi_scores: (N, C+1) with
        background last; multi_coeffs: (N, coeff_dim) or (N, C*coeff_dim).

    Returns (dets (M, 5), labels (M,), coeffs (M, D), valid (M,)).
    """
    n, c1 = multi_scores.shape
    c = c1 - 1
    scores = multi_scores[:, :c].T                             # (C, N)
    k = min(int(top_k), n)
    top_scores, idx = jax.lax.top_k(scores, k)                 # (C, k)
    if multi_bboxes.shape[-1] > 4:
        boxes_pc = multi_bboxes.reshape(n, c, 4)
        boxes = jnp.take_along_axis(
            jnp.swapaxes(boxes_pc, 0, 1), idx[..., None], axis=1)
    else:
        boxes = multi_bboxes[idx.reshape(-1)].reshape(c, k, 4)
    d = multi_coeffs.shape[-1]
    coeffs = multi_coeffs[idx.reshape(-1)].reshape(c, k, d)

    x1 = jnp.maximum(boxes[:, :, None, 0], boxes[:, None, :, 0])
    y1 = jnp.maximum(boxes[:, :, None, 1], boxes[:, None, :, 1])
    x2 = jnp.minimum(boxes[:, :, None, 2], boxes[:, None, :, 2])
    y2 = jnp.minimum(boxes[:, :, None, 3], boxes[:, None, :, 3])
    inter = jnp.clip(x2 - x1, 0) * jnp.clip(y2 - y1, 0)
    area = ((boxes[:, :, 2] - boxes[:, :, 0])
            * (boxes[:, :, 3] - boxes[:, :, 1]))
    union = area[:, :, None] + area[:, None, :] - inter
    iou = jnp.where(union > 0, inter / jnp.maximum(union, 1e-12), 0.0)
    tri = (jnp.arange(k)[:, None] < jnp.arange(k)[None, :])
    iou_max = jnp.max(jnp.where(tri[None], iou, 0.0), axis=1)  # (C, k)

    keep = (iou_max <= iou_thr) & (top_scores > score_thr)
    flat_scores = jnp.where(keep, top_scores, -jnp.inf).reshape(-1)
    flat_boxes = boxes.reshape(-1, 4)
    flat_coeffs = coeffs.reshape(-1, d)
    flat_labels = jnp.broadcast_to(
        jnp.arange(c, dtype=jnp.int32)[:, None], (c, k)).reshape(-1)

    m = c * k if max_num is None or max_num <= 0 else min(int(max_num),
                                                          c * k)
    out_scores, oi = jax.lax.top_k(flat_scores, m)
    valid = jnp.isfinite(out_scores)
    dets = jnp.concatenate(
        [flat_boxes[oi], jnp.where(valid, out_scores, 0.0)[:, None]],
        axis=-1)
    return dets, flat_labels[oi], flat_coeffs[oi], valid
