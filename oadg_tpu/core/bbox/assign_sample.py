"""Assigner + sampler as static-shape masked jnp ops (jit-safe).

Replaces the reference's dynamic-shaped MaxIoUAssigner
(mmdet/core/bbox/assigners/max_iou_assigner.py:11) and RandomSampler
(mmdet/core/bbox/samplers/random_sampler.py:9) with fixed-size vectorized
equivalents: ragged index lists become masks and randomized top-k ranks.

Assignment codes match mmdet: -1 = ignore, 0 = negative, j+1 = matched gt j.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import numpy as np
import jax.numpy as jnp

from ...utils.registry import BBOX_ASSIGNERS, BBOX_SAMPLERS
from .geometry import bbox_overlaps


def topk_large(scores: jnp.ndarray, k: int, rows: int = 64):
    """Exact top-k over a long 1-D array via a two-stage decomposition.

    Reshape to (rows, n/rows), take the per-row top-k, then top-k over the
    row winners: every global top-k element is inside its own row's top-k,
    so the result is EXACTLY ``lax.top_k(scores, k)`` — including tie order
    (top_k breaks value ties by ascending index; rows are row-major slices,
    so (row, within-row rank) order equals global index order). The
    single-stage partial sort touches the full array per step; the
    two-stage form touches it once.

    Falls back to plain top_k when n is small or k too large for a row.

    Preconditions (ADVICE r4):
    - ``scores`` must contain at least k entries > -inf. The tail is
      padded with -inf; when padded entries win (fewer than k finite
      candidates) their indices are clipped to n-1 — duplicated indices
      where lax.top_k would return the true -inf positions. The sole
      production call site (RandomSampler uniform keys offset to [-2, 1))
      satisfies this; callers reusing this utility must mask on value.
    - Tie-order exactness assumes lax.top_k breaks value ties by ascending
      index. JAX does not formally guarantee this across backends; the
      tie test in tests/test_core_bbox.py is the CI guard (uniform float
      keys tie with probability ~0, so sampler impact would be nil even
      if a backend changed it).
    """
    n = scores.shape[0]
    cols = -(-n // rows)
    if n < 65536 or k > cols:
        return jax.lax.top_k(scores, min(k, n))
    pad = rows * cols - n
    if pad:
        scores = jnp.concatenate(
            [scores, jnp.full((pad,), -jnp.inf, scores.dtype)])
    v, i = jax.lax.top_k(scores.reshape(rows, cols), k)
    gi = (jnp.arange(rows, dtype=jnp.int32)[:, None] * cols
          + i.astype(jnp.int32)).reshape(-1)
    fv, fi = jax.lax.top_k(v.reshape(-1), k)
    # padded -inf entries can win only when fewer than k real candidates
    # exist; clip their (out-of-range) indices — callers mask on value.
    return fv, jnp.minimum(gi[fi], n - 1)


class AssignResult(NamedTuple):
    gt_inds: jnp.ndarray       # (N,) int32: -1 ignore / 0 neg / j+1 pos
    max_overlaps: jnp.ndarray  # (N,) float32
    labels: jnp.ndarray        # (N,) int32 gt label of match, -1 otherwise


class SamplingResult(NamedTuple):
    """Fixed-size sample of ``num`` boxes: positives first, then negatives.

    ``inds`` indexes into the candidate box array; entries beyond
    ``pos+neg`` count are arbitrary but masked by ``valid``.
    """
    inds: jnp.ndarray        # (num,) int32 indices into candidates
    is_pos: jnp.ndarray      # (num,) bool
    valid: jnp.ndarray       # (num,) bool (always all-true when enough negs)
    gt_inds: jnp.ndarray     # (num,) int32 assigned code (gathered)
    labels: jnp.ndarray      # (num,) int32 matched gt labels (gathered)


@BBOX_ASSIGNERS.register_module()
class MaxIoUAssigner:
    """Static-shape MaxIoU assignment.

    Args mirror the reference config schema
    (configs/_base_/models/faster_rcnn_r50_fpn.py train_cfg.rpn.assigner).
    """

    def __init__(self,
                 pos_iou_thr: float,
                 neg_iou_thr,
                 min_pos_iou: float = .0,
                 gt_max_assign_all: bool = True,
                 ignore_iof_thr: float = -1,
                 ignore_wrt_candidates: bool = True,
                 match_low_quality: bool = True,
                 gpu_assign_thr: int = -1,
                 iou_calculator: Optional[dict] = None):
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.gt_max_assign_all = gt_max_assign_all
        self.ignore_iof_thr = ignore_iof_thr
        self.ignore_wrt_candidates = ignore_wrt_candidates
        self.match_low_quality = match_low_quality

    def assign(self,
               bboxes: jnp.ndarray,
               gt_bboxes: jnp.ndarray,
               gt_valid: jnp.ndarray,
               gt_labels: Optional[jnp.ndarray] = None,
               box_valid: Optional[jnp.ndarray] = None) -> AssignResult:
        """Assign each of N candidate boxes to one of G (padded) gts.

        Args:
            bboxes: (N, 4); gt_bboxes: (G, 4); gt_valid: (G,) bool;
            gt_labels: (G,) int32; box_valid: (N,) bool — invalid candidates
            (padding / out-of-image anchors) are assigned -1 (ignore).
        """
        ious = bbox_overlaps(bboxes, gt_bboxes)          # (N, G)
        # Mask padded gts with 0.0 (not -1): the reference treats empty-gt
        # images as all-NEGATIVE (max_overlap 0 -> below neg_iou_thr), and
        # ApproxMaxIoUAssigner shares this convention.
        ious = jnp.where(gt_valid[None, :], ious, 0.0)
        return self.assign_from_ious(ious, gt_valid, gt_labels, box_valid)

    def assign_from_ious(self, ious, gt_valid, gt_labels=None, box_valid=None) -> AssignResult:
        N, G = ious.shape
        max_overlaps = jnp.max(ious, axis=1)             # (N,)
        argmax_overlaps = jnp.argmax(ious, axis=1)       # (N,)

        # start: everything ignored
        assigned = jnp.full((N,), -1, dtype=jnp.int32)
        # negatives
        if isinstance(self.neg_iou_thr, (tuple, list)):
            lo, hi = self.neg_iou_thr
            neg = (max_overlaps >= lo) & (max_overlaps < hi)
        else:
            neg = (max_overlaps >= 0) & (max_overlaps < self.neg_iou_thr)
        assigned = jnp.where(neg, 0, assigned)
        # positives by threshold
        pos = max_overlaps >= self.pos_iou_thr
        assigned = jnp.where(pos, argmax_overlaps.astype(jnp.int32) + 1, assigned)

        if self.match_low_quality:
            # For each gt j: boxes with iou == per-gt max (>= min_pos_iou)
            # get assigned to j. Reference iterates j in order with
            # overwrite, so the highest j wins — expressed as a max.
            gt_max = jnp.max(ious, axis=0)               # (G,)
            cond = (ious == gt_max[None, :]) & gt_valid[None, :] & (
                gt_max[None, :] >= self.min_pos_iou) & (gt_max[None, :] > 0)
            if not self.gt_max_assign_all:
                # only the single argmax box per gt
                gt_argmax = jnp.argmax(ious, axis=0)     # (G,)
                row_ids = jnp.arange(N)[:, None]
                cond = cond & (row_ids == gt_argmax[None, :])
            gt_ids = jnp.arange(1, G + 1, dtype=jnp.int32)[None, :]
            override = jnp.max(jnp.where(cond, gt_ids, 0), axis=1)  # (N,)
            assigned = jnp.where(override > 0, override, assigned)

        if box_valid is not None:
            assigned = jnp.where(box_valid, assigned, -1)

        if gt_labels is not None:
            matched = jnp.clip(assigned - 1, 0, G - 1)
            labels = jnp.where(assigned > 0, gt_labels[matched], -1).astype(jnp.int32)
        else:
            labels = jnp.full((N,), -1, dtype=jnp.int32)
        return AssignResult(assigned, max_overlaps, labels)


def _random_rank(key: jax.Array, mask: jnp.ndarray) -> jnp.ndarray:
    """Rank (0-based) of each True element in a uniformly random order;
    False elements get rank >= num_true."""
    n = mask.shape[0]
    scores = jax.random.uniform(key, (n,)) + jnp.where(mask, 0.0, 2.0)
    order = jnp.argsort(scores)               # True elems first, random order
    ranks = jnp.zeros(n, dtype=jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
    return ranks


def _rank_of(values: jnp.ndarray) -> jnp.ndarray:
    """Position of each element when sorted ascending (double argsort)."""
    order = jnp.argsort(values)
    return jnp.zeros(values.shape[0], jnp.int32).at[order].set(
        jnp.arange(values.shape[0], dtype=jnp.int32))


def _segmented_rank(mask: jnp.ndarray, seg_id: jnp.ndarray,
                    order_values: jnp.ndarray) -> jnp.ndarray:
    """Rank of each True element *within its segment*, ordered by
    ``order_values`` ascending. False elements get a large rank.

    Static-shape replacement for the reference's per-group python loops
    (instance_balanced_pos_sampler.py / score_hlr_sampler.py): lexsort by
    (masked-out-last, segment, value), then rank = position - run start.
    """
    n = mask.shape[0]
    big = jnp.int32(seg_id.max() + 2 if seg_id.size else 1)
    seg = jnp.where(mask, seg_id.astype(jnp.int32), big)
    # stable lexsort: secondary key first, then primary (jnp.argsort is stable)
    perm1 = jnp.argsort(order_values)
    perm2 = jnp.argsort(seg[perm1], stable=True)
    order = perm1[perm2]                       # sorted by (seg, value)
    seg_sorted = seg[order]
    idx = jnp.arange(n, dtype=jnp.int32)
    change = jnp.concatenate([jnp.array([True]),
                              seg_sorted[1:] != seg_sorted[:-1]])
    run_start = jax.lax.cummax(jnp.where(change, idx, -1))
    rank_sorted = idx - run_start
    ranks = jnp.zeros(n, jnp.int32).at[order].set(rank_sorted)
    return jnp.where(mask, ranks, n)


@BBOX_SAMPLERS.register_module()
class RandomSampler:
    """Static-shape random pos/neg sampling.

    Matches reference RandomSampler semantics: sample up to
    ``num * pos_fraction`` positives, fill the rest with random negatives.
    ``add_gt_as_proposals`` is handled by the caller (gt boxes are
    concatenated to the candidate set before assignment — equivalent to the
    reference's in-sampler concat since a gt box assigns to itself).
    """

    def __init__(self, num: int, pos_fraction: float, neg_pos_ub: int = -1,
                 add_gt_as_proposals: bool = True, **kwargs):
        self.num = num
        self.pos_fraction = pos_fraction
        self.neg_pos_ub = neg_pos_ub
        self.add_gt_as_proposals = add_gt_as_proposals

    def _pos_rank(self, key: jax.Array, assign: AssignResult) -> jnp.ndarray:
        """Rank positives for selection (rank < max_pos wins). Subclasses
        override to bias the order (instance balance, hardness, ...)."""
        return _random_rank(key, assign.gt_inds > 0)

    def _neg_rank(self, key: jax.Array, assign: AssignResult,
                  neg_needed) -> jnp.ndarray:
        """Rank negatives for selection (rank < neg_needed wins)."""
        return _random_rank(key, assign.gt_inds == 0)

    def sample(self, key: jax.Array, assign: AssignResult) -> SamplingResult:
        num = self.num
        max_pos = int(round(num * self.pos_fraction))
        is_pos_all = assign.gt_inds > 0
        is_neg_all = assign.gt_inds == 0
        kp, kn = jax.random.split(key)

        pos_rank = self._pos_rank(kp, assign)
        pos_sel = is_pos_all & (pos_rank < max_pos)
        num_pos = jnp.sum(pos_sel)

        neg_needed = num - num_pos
        if self.neg_pos_ub >= 0:
            neg_needed = jnp.minimum(neg_needed, self.neg_pos_ub * jnp.maximum(num_pos, 1))
        neg_rank = self._neg_rank(kn, assign, neg_needed)
        neg_sel = is_neg_all & (neg_rank < neg_needed)

        # Fixed-size gather: selected positives (random order), then selected
        # negatives, then the rest; take first ``num``.
        sort_key = jnp.where(pos_sel, pos_rank.astype(jnp.float32),
                             jnp.where(neg_sel, 1e4 + neg_rank.astype(jnp.float32),
                                       1e8 + jnp.arange(assign.gt_inds.shape[0], dtype=jnp.float32)))
        inds = jnp.argsort(sort_key)[:num].astype(jnp.int32)
        is_pos = pos_sel[inds]
        valid = (pos_sel | neg_sel)[inds]
        return SamplingResult(
            inds=inds,
            is_pos=is_pos,
            valid=valid,
            gt_inds=assign.gt_inds[inds],
            labels=assign.labels[inds],
        )

    def sample_masks(self, key: jax.Array, assign: AssignResult) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Mask-only variant (no gather) for dense heads: returns
        (pos_mask, neg_mask) over all N candidates.

        Selection uses top_k(num) over random priorities instead of a
        full argsort rank: dense heads sample a few hundred of ~800k
        anchors, and the two 786k argsorts per image were a measurable
        slice of the train step. A top-k of uniform scores is the same
        uniform k-subset draw.
        """
        num = self.num
        max_pos = int(round(num * self.pos_fraction))
        is_pos_all = assign.gt_inds > 0
        is_neg_all = assign.gt_inds == 0
        n = is_pos_all.shape[0]
        kp, kn = jax.random.split(key)

        def pick(k, mask, k_static, cutoff):
            scores = jax.random.uniform(k, (n,)) + jnp.where(mask, 0.0, -2.0)
            vals, idx = topk_large(scores, min(k_static, n))
            keep = (vals > -1.0) & (jnp.arange(min(k_static, n)) < cutoff)
            return jnp.zeros((n,), bool).at[idx].set(keep)

        pos_sel = pick(kp, is_pos_all, max_pos, max_pos)
        neg_needed = num - jnp.sum(pos_sel)
        neg_sel = pick(kn, is_neg_all, num, neg_needed)
        return pos_sel, neg_sel


@BBOX_SAMPLERS.register_module()
class PseudoSampler:
    """All positives + all negatives, no subsampling (reference
    mmdet/core/bbox/samplers/pseudo_sampler.py)."""

    def __init__(self, **kwargs):
        pass

    def sample_masks(self, key, assign: AssignResult):
        return assign.gt_inds > 0, assign.gt_inds == 0


@BBOX_SAMPLERS.register_module()
class OHEMSampler(RandomSampler):
    """Online hard example mining (reference
    mmdet/core/bbox/samplers/ohem_sampler.py:10).

    The reference runs the bbox head on every candidate and keeps the
    highest-loss positives/negatives. Static-shape version: the caller
    passes per-candidate ``hard_scores`` (typically the classification loss
    of each candidate under the current head) and selection ranks by score
    descending instead of uniformly at random. Without scores it degrades
    to RandomSampler — same contract the reference has before the head
    exists (e.g. RPN stage).
    """

    def sample(self, key: jax.Array, assign: AssignResult,
               hard_scores: Optional[jnp.ndarray] = None) -> SamplingResult:
        if hard_scores is None:
            return super().sample(key, assign)
        num = self.num
        max_pos = int(round(num * self.pos_fraction))
        is_pos_all = assign.gt_inds > 0
        is_neg_all = assign.gt_inds == 0
        n = assign.gt_inds.shape[0]

        def hard_rank(mask):
            # rank by loss descending among mask; others pushed to the end
            scores = jnp.where(mask, -hard_scores, jnp.inf)
            order = jnp.argsort(scores)
            return jnp.zeros(n, jnp.int32).at[order].set(
                jnp.arange(n, dtype=jnp.int32))

        pos_rank = hard_rank(is_pos_all)
        pos_sel = is_pos_all & (pos_rank < max_pos)
        num_pos = jnp.sum(pos_sel)
        neg_needed = num - num_pos
        if self.neg_pos_ub >= 0:
            neg_needed = jnp.minimum(neg_needed,
                                     self.neg_pos_ub * jnp.maximum(num_pos, 1))
        neg_rank = hard_rank(is_neg_all)
        neg_sel = is_neg_all & (neg_rank < neg_needed)
        sort_key = jnp.where(
            pos_sel, pos_rank.astype(jnp.float32),
            jnp.where(neg_sel, 1e4 + neg_rank.astype(jnp.float32),
                      1e8 + jnp.arange(n, dtype=jnp.float32)))
        inds = jnp.argsort(sort_key)[:num].astype(jnp.int32)
        return SamplingResult(
            inds=inds, is_pos=pos_sel[inds], valid=(pos_sel | neg_sel)[inds],
            gt_inds=assign.gt_inds[inds], labels=assign.labels[inds])


@BBOX_ASSIGNERS.register_module()
class ATSSAssigner:
    """Adaptive Training Sample Selection (reference
    mmdet/core/bbox/assigners/atss_assigner.py:12), static-shape.

    Per gt: take the ``topk`` anchors closest by center distance on each
    pyramid level, compute mean+std of their IoUs as an adaptive threshold,
    keep candidates above it whose centers lie inside the gt box. Ragged
    per-level candidate lists become a fixed (G, L*topk) selection mask.
    """

    def __init__(self, topk: int = 9, ignore_iof_thr: float = -1, **kwargs):
        self.topk = topk

    def assign(self, bboxes, num_level_bboxes, gt_bboxes, gt_valid,
               gt_labels=None, box_valid=None) -> AssignResult:
        """bboxes (N,4); num_level_bboxes: python list of per-level counts
        summing to N; gt_bboxes (G,4); gt_valid (G,)."""
        N, G = bboxes.shape[0], gt_bboxes.shape[0]
        ious = bbox_overlaps(bboxes, gt_bboxes)                  # (N, G)
        ious = jnp.where(gt_valid[None, :], ious, 0.0)
        if box_valid is not None:
            ious = jnp.where(box_valid[:, None], ious, 0.0)

        acx = (bboxes[:, 0] + bboxes[:, 2]) * 0.5
        acy = (bboxes[:, 1] + bboxes[:, 3]) * 0.5
        gcx = (gt_bboxes[:, 0] + gt_bboxes[:, 2]) * 0.5
        gcy = (gt_bboxes[:, 1] + gt_bboxes[:, 3]) * 0.5
        dist = jnp.sqrt((acx[:, None] - gcx[None, :]) ** 2
                        + (acy[:, None] - gcy[None, :]) ** 2)    # (N, G)
        if box_valid is not None:
            dist = jnp.where(box_valid[:, None], dist, jnp.inf)

        # per-level top-k by distance -> candidate mask (N, G)
        cand = jnp.zeros((N, G), bool)
        start = 0
        for nl in num_level_bboxes:
            d = dist[start:start + nl]                           # (nl, G)
            k = min(self.topk, nl)
            thr = -jax.lax.top_k(-d.T, k)[0][:, -1]              # (G,) kth dist
            cand = cand.at[start:start + nl].set(d <= thr[None, :])
            start += nl

        # adaptive IoU threshold over candidates: mean + std
        ci = jnp.where(cand, ious, 0.0)
        cnt = jnp.maximum(jnp.sum(cand, axis=0), 1)              # (G,)
        mean = jnp.sum(ci, axis=0) / cnt
        var = jnp.sum(jnp.where(cand, (ious - mean[None, :]) ** 2, 0.0),
                      axis=0) / cnt
        thr = mean + jnp.sqrt(var)                               # (G,)

        inside = ((acx[:, None] >= gt_bboxes[None, :, 0])
                  & (acx[:, None] <= gt_bboxes[None, :, 2])
                  & (acy[:, None] >= gt_bboxes[None, :, 1])
                  & (acy[:, None] <= gt_bboxes[None, :, 3]))
        pos = cand & inside & (ious >= thr[None, :]) & gt_valid[None, :]

        # each anchor -> gt of max IoU among its positive matches
        pos_ious = jnp.where(pos, ious, -1.0)
        best = jnp.argmax(pos_ious, axis=1)                      # (N,)
        has = jnp.max(pos_ious, axis=1) > -0.5
        assigned = jnp.where(has, best.astype(jnp.int32) + 1, 0)
        if box_valid is not None:
            assigned = jnp.where(box_valid, assigned, -1)
        max_overlaps = jnp.max(jnp.where(gt_valid[None, :], ious, -1.0), axis=1)
        if gt_labels is not None:
            matched = jnp.clip(assigned - 1, 0, G - 1)
            labels = jnp.where(assigned > 0, gt_labels[matched], -1).astype(jnp.int32)
        else:
            labels = jnp.full((N,), -1, jnp.int32)
        return AssignResult(assigned, max_overlaps, labels)


@BBOX_ASSIGNERS.register_module()
class GridAssigner:
    """Config-surface entry for YOLO grid assignment (reference
    core/bbox/assigners/grid_assigner.py); the static-shape implementation
    lives in models/dense_heads/yolo_head.py _targets_single."""

    def __init__(self, pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0,
                 gt_max_assign_all=True, **kwargs):
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou


def _per_gt_topk_mask(values: jnp.ndarray, k: int,
                      valid_cols: jnp.ndarray) -> jnp.ndarray:
    """(N, G) scores -> bool mask marking, per column, the k largest rows.
    Invalid columns produce an all-False column."""
    k = min(k, values.shape[0])
    mask = _rank_matrix_desc(values) < k
    return mask & valid_cols[None, :]


def _rank_matrix_desc(values: jnp.ndarray) -> jnp.ndarray:
    """Per-column 0-based rank of each row when sorted descending."""
    order = jnp.argsort(-values, axis=0)
    n = values.shape[0]
    ranks = jnp.zeros_like(values, dtype=jnp.int32)
    ranks = ranks.at[order, jnp.arange(values.shape[1])[None, :]].set(
        jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None],
                         values.shape))
    return ranks


@BBOX_ASSIGNERS.register_module()
class TaskAlignedAssigner:
    """Task-aligned assignment (reference task_aligned_assigner.py:40-150),
    static-shape standalone: alignment t = score[gt_label]^alpha *
    IoU(decoded, gt)^beta; per-gt top-k candidates with centers inside the
    gt; anchors claimed by several gts go to the max-IoU one.
    ``assign`` returns (AssignResult, assign_metrics). TOODHead carries an
    inlined copy of the same math for its fused loss path."""

    def __init__(self, topk=13, alpha=1.0, beta=6.0, **kw):
        self.topk = topk
        self.alpha = alpha
        self.beta = beta

    def assign(self, pred_scores, decode_bboxes, anchors, gt_bboxes,
               gt_valid, gt_labels, alpha=None, beta=None):
        alpha = self.alpha if alpha is None else alpha
        beta = self.beta if beta is None else beta
        n, g = anchors.shape[0], gt_bboxes.shape[0]
        overlaps = bbox_overlaps(decode_bboxes, gt_bboxes)         # (N, G)
        scores = pred_scores[:, jnp.clip(gt_labels, 0,
                                         pred_scores.shape[1] - 1)]
        metrics = (scores ** alpha) * (overlaps ** beta)
        metrics = jnp.where(gt_valid[None, :], metrics, 0.0)

        topk_mask = _per_gt_topk_mask(metrics, int(self.topk), gt_valid)
        acx = (anchors[:, 0] + anchors[:, 2]) * 0.5
        acy = (anchors[:, 1] + anchors[:, 3]) * 0.5
        inside = ((acx[:, None] - gt_bboxes[None, :, 0] > 0.01)
                  & (acy[:, None] - gt_bboxes[None, :, 1] > 0.01)
                  & (gt_bboxes[None, :, 2] - acx[:, None] > 0.01)
                  & (gt_bboxes[None, :, 3] - acy[:, None] > 0.01))
        is_pos = topk_mask & inside & (metrics > 0)

        pos_ious = jnp.where(is_pos, overlaps, -jnp.inf)
        best = jnp.argmax(pos_ious, axis=1)
        has = jnp.isfinite(jnp.max(pos_ious, axis=1))
        assigned = jnp.where(has, best.astype(jnp.int32) + 1, 0)
        max_overlaps = jnp.where(has, overlaps[jnp.arange(n), best], 0.0)
        assign_metrics = jnp.where(has, metrics[jnp.arange(n), best], 0.0)
        matched = jnp.clip(assigned - 1, 0, g - 1)
        labels = jnp.where(assigned > 0, gt_labels[matched], -1
                           ).astype(jnp.int32)
        return AssignResult(assigned, max_overlaps, labels), assign_metrics


@BBOX_ASSIGNERS.register_module()
class UniformAssigner:
    """YOLOF uniform matching (reference uniform_assigner.py:45-135),
    static-shape standalone: per gt, the ``match_times`` anchors AND the
    ``match_times`` predicted boxes with smallest L1 cxcywh distance are
    positive candidates; candidates whose anchor IoU < pos_ignore_thr are
    ignored, and non-candidates whose predicted IoU > neg_ignore_thr are
    ignored. Conflicts resolve to the max-anchor-IoU gt (the reference's
    sequential overwrite is order-arbitrary). YOLOFHead inlines the same
    scheme in its loss."""

    def __init__(self, pos_ignore_thr=0.15, neg_ignore_thr=0.7,
                 match_times=4, **kw):
        self.pos_ignore_thr = pos_ignore_thr
        self.neg_ignore_thr = neg_ignore_thr
        self.match_times = match_times

    def assign(self, bbox_pred, anchors, gt_bboxes, gt_valid, gt_labels):
        n, g = anchors.shape[0], gt_bboxes.shape[0]

        def cxcywh(b):
            return jnp.stack([(b[..., 0] + b[..., 2]) / 2,
                              (b[..., 1] + b[..., 3]) / 2,
                              b[..., 2] - b[..., 0],
                              b[..., 3] - b[..., 1]], -1)

        def l1(a, b):
            return jnp.sum(jnp.abs(a[:, None] - b[None]), -1)     # (N, G)

        c_pred = l1(cxcywh(bbox_pred), cxcywh(gt_bboxes))
        c_anc = l1(cxcywh(anchors), cxcywh(gt_bboxes))
        cand = (_per_gt_topk_mask(-c_pred, self.match_times, gt_valid)
                | _per_gt_topk_mask(-c_anc, self.match_times, gt_valid))

        anchor_ious = bbox_overlaps(anchors, gt_bboxes)
        pred_ious = bbox_overlaps(bbox_pred, gt_bboxes)
        pred_ious = jnp.where(gt_valid[None, :], pred_ious, 0.0)
        anchor_ious_m = jnp.where(gt_valid[None, :], anchor_ious, 0.0)

        pos_ok = cand & (anchor_ious_m >= self.pos_ignore_thr)
        best_iou = jnp.where(pos_ok, anchor_ious_m, -jnp.inf)
        best = jnp.argmax(best_iou, axis=1)
        has = jnp.isfinite(jnp.max(best_iou, axis=1))

        assigned = jnp.zeros((n,), jnp.int32)
        # negatives whose prediction already overlaps a gt -> ignore
        assigned = jnp.where(jnp.max(pred_ious, axis=1)
                             > self.neg_ignore_thr, -1, assigned)
        # candidates failing the anchor-IoU floor -> ignore
        assigned = jnp.where(jnp.any(cand, axis=1) & ~jnp.any(pos_ok, axis=1),
                             -1, assigned)
        assigned = jnp.where(has, best.astype(jnp.int32) + 1, assigned)
        matched = jnp.clip(assigned - 1, 0, g - 1)
        labels = jnp.where(assigned > 0, gt_labels[matched], -1
                           ).astype(jnp.int32)
        max_overlaps = jnp.max(anchor_ious_m, axis=1)
        return AssignResult(assigned, max_overlaps, labels)


@BBOX_ASSIGNERS.register_module()
class PointAssigner:
    """RepPoints point assignment (reference point_assigner.py:30-140),
    static-shape standalone: each gt selects the ``pos_num`` nearest
    points (center distance normalized by gt wh) on its scale-matched
    pyramid level; points claimed by several gts go to the nearest one.
    RepPointsHead inlines the same selection matrix."""

    def __init__(self, scale=4, pos_num=3, **kw):
        self.scale = scale
        self.pos_num = pos_num

    def assign(self, points, gt_bboxes, gt_valid, gt_labels):
        """points (N, 3): x, y, stride."""
        n, g = points.shape[0], gt_bboxes.shape[0]
        pts_lvl = jnp.log2(points[:, 2]).astype(jnp.int32)        # (N,)
        lvl_min, lvl_max = jnp.min(pts_lvl), jnp.max(pts_lvl)
        gt_cx = (gt_bboxes[:, 0] + gt_bboxes[:, 2]) / 2
        gt_cy = (gt_bboxes[:, 1] + gt_bboxes[:, 3]) / 2
        gt_w = jnp.clip(gt_bboxes[:, 2] - gt_bboxes[:, 0], 1e-6)
        gt_h = jnp.clip(gt_bboxes[:, 3] - gt_bboxes[:, 1], 1e-6)
        gt_lvl = jnp.clip(((jnp.log2(gt_w / self.scale)
                            + jnp.log2(gt_h / self.scale)) / 2
                           ).astype(jnp.int32), lvl_min, lvl_max)

        dist = jnp.sqrt(((points[:, 0:1] - gt_cx[None]) / gt_w[None]) ** 2
                        + ((points[:, 1:2] - gt_cy[None]) / gt_h[None]) ** 2)
        lvl_ok = pts_lvl[:, None] == gt_lvl[None, :]
        dist = jnp.where(lvl_ok & gt_valid[None, :], dist, jnp.inf)
        topk = _per_gt_topk_mask(-dist, self.pos_num, gt_valid) & lvl_ok
        sel = jnp.where(topk & jnp.isfinite(dist), dist, jnp.inf)
        best = jnp.argmin(sel, axis=1)
        has = jnp.isfinite(jnp.min(sel, axis=1))
        assigned = jnp.where(has, best.astype(jnp.int32) + 1, 0)
        matched = jnp.clip(assigned - 1, 0, g - 1)
        labels = jnp.where(assigned > 0, gt_labels[matched], -1
                           ).astype(jnp.int32)
        return AssignResult(assigned, jnp.zeros((n,), jnp.float32), labels)


@BBOX_ASSIGNERS.register_module()
class RegionAssigner:
    """Anchor-center-region assigner (reference
    core/bbox/assigners/region_assigner.py:37): each gt is routed to the
    pyramid level matching its scale; anchors whose centers fall in the
    gt's center region become positive, a larger surrounding region (and
    the same region on the two adjacent levels) becomes ignore; anchors
    outside the image (+allowed_border) are ignored.

    CascadeRPNHead consumes an inline fused variant
    (models/dense_heads/cascade_rpn_head.py:_region_targets); this
    standalone form serves direct use and config-built assigner
    pipelines.  Static-shape contract: ``gt_bboxes`` is the padded
    (G, 4) array with ``gt_valid`` mask; the reference's sequential
    per-gt overwrite order is reproduced exactly by a fori_loop over the
    static gt slots (later gts overwrite earlier ones — order matters,
    reference assign() step comments)."""

    def __init__(self, center_ratio=0.2, ignore_ratio=0.5, **kw):
        self.center_ratio = center_ratio
        self.ignore_ratio = ignore_ratio

    @staticmethod
    def _calc_region(bbox, ratio, stride, featmap_size):
        """reference region_assigner.py:10 calc_region (rounded, clamped)."""
        f = bbox / stride
        x1 = jnp.round((1 - ratio) * f[0] + ratio * f[2])
        y1 = jnp.round((1 - ratio) * f[1] + ratio * f[3])
        x2 = jnp.round(ratio * f[0] + (1 - ratio) * f[2])
        y2 = jnp.round(ratio * f[1] + (1 - ratio) * f[3])
        h, w = featmap_size
        return (jnp.clip(x1, 0, w), jnp.clip(y1, 0, h),
                jnp.clip(x2, 0, w), jnp.clip(y2, 0, h))

    @staticmethod
    def _ctr_inside(anchors, stride, region):
        x1, y1, x2, y2 = region
        f = anchors / stride
        x = (f[:, 0] + f[:, 2]) * 0.5
        y = (f[:, 1] + f[:, 3]) * 0.5
        return (x >= x1) & (x <= x2) & (y >= y1) & (y <= y2)

    def assign(self, mlvl_anchors, gt_bboxes, gt_valid=None,
               img_shape=None, featmap_sizes=None, anchor_scale=4,
               anchor_strides=(4, 8, 16, 32, 64), gt_labels=None,
               allowed_border=0, mlvl_valid_flags=None):
        num_lvls = len(mlvl_anchors)
        if featmap_sizes is None:
            raise ValueError("RegionAssigner.assign needs featmap_sizes")
        g = gt_bboxes.shape[0]
        if gt_valid is None:
            gt_valid = jnp.ones((g,), bool)
        r1 = (1 - self.center_ratio) / 2
        r2 = (1 - self.ignore_ratio) / 2

        scale = jnp.sqrt(jnp.maximum(
            (gt_bboxes[:, 2] - gt_bboxes[:, 0])
            * (gt_bboxes[:, 3] - gt_bboxes[:, 1]), 1e-12))
        min_sz = float(anchor_scale * anchor_strides[0])
        target_lvls = jnp.clip(
            jnp.floor(jnp.log2(scale) - np.log2(min_sz) + 0.5),
            0, num_lvls - 1).astype(jnp.int32)

        lvl_sizes = [a.shape[0] for a in mlvl_anchors]
        offsets = np.concatenate([[0], np.cumsum(lvl_sizes)])
        flat_anchors = jnp.concatenate(mlvl_anchors, axis=0)
        k = flat_anchors.shape[0]

        def per_gt_flags(gi):
            """(pos, ign, adj) flat flags for gt gi at its target level."""
            lvl = target_lvls[gi]
            box = gt_bboxes[gi]
            pos = jnp.zeros((k,), bool)
            ign = jnp.zeros((k,), bool)
            adj = jnp.zeros((k,), bool)
            for li in range(num_lvls):
                a = mlvl_anchors[li]
                stride = anchor_strides[li]
                fs = featmap_sizes[li]
                sl = slice(int(offsets[li]), int(offsets[li + 1]))
                ign_r = self._ctr_inside(
                    a, stride, self._calc_region(box, r2, stride, fs))
                pos_r = self._ctr_inside(
                    a, stride, self._calc_region(box, r1, stride, fs))
                at = lvl == li
                near = (lvl == li + 1) | (lvl == li - 1)
                pos = pos.at[sl].set(jnp.where(at, pos_r, False))
                ign = ign.at[sl].set(jnp.where(at, ign_r, False))
                adj = adj.at[sl].set(jnp.where(near, ign_r, False))
            return pos, ign, adj

        def body(gi, state):
            assigned, adj_all = state
            pos, ign, adj = per_gt_flags(gi)
            v = gt_valid[gi]
            # reference order per gt: ignore region first, then positives
            assigned = jnp.where(v & ign, -1, assigned)
            assigned = jnp.where(v & pos, gi + 1, assigned)
            return assigned, adj_all | (adj & v)

        assigned = jnp.zeros((k,), jnp.int32)
        adj_all = jnp.zeros((k,), bool)
        assigned, adj_all = jax.lax.fori_loop(
            0, g, body, (assigned, adj_all))
        assigned = jnp.where(adj_all, -1, assigned)

        if img_shape is not None:
            ab = float(allowed_border)
            inside = ((flat_anchors[:, 0] >= -ab)
                      & (flat_anchors[:, 1] >= -ab)
                      & (flat_anchors[:, 2] < img_shape[1] + ab)
                      & (flat_anchors[:, 3] < img_shape[0] + ab))
            if mlvl_valid_flags is not None:
                inside = inside & jnp.concatenate(mlvl_valid_flags)
            assigned = jnp.where(inside, assigned, -1)

        matched = jnp.clip(assigned - 1, 0, max(g - 1, 0))
        if gt_labels is not None:
            labels = jnp.where(assigned > 0, gt_labels[matched], -1)
        else:
            labels = jnp.full((k,), -1, jnp.int32)
        return AssignResult(assigned, jnp.zeros((k,), jnp.float32), labels)


@BBOX_ASSIGNERS.register_module()
class CenterRegionAssigner(MaxIoUAssigner):
    """Center-region positive gating on top of MaxIoU (reference
    center_region_assigner.py, FSAF-family); the dense center-region rule
    lives in models/dense_heads/fovea_fsaf_heads.py."""

    def __init__(self, pos_scale=0.2, neg_scale=0.2, **kw):
        super().__init__(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)
        self.pos_scale = pos_scale
        self.neg_scale = neg_scale


@BBOX_ASSIGNERS.register_module()
class ApproxMaxIoUAssigner(MaxIoUAssigner):
    """reference approx_max_iou_assigner.py: each location owns a group of
    ``approxs_per_octave`` approx anchors; the location's assignment IoU is
    the MAX over its group, and the assigned box is the location's square
    anchor. Thresholding/low-quality-rescue then follow MaxIoU semantics
    exactly (the reference delegates to MaxIoUAssigner.assign_wrt_overlaps
    on the grouped-max overlap matrix)."""

    def assign(self, approxs, squares, approxs_per_octave, gt_bboxes,
               gt_valid=None, gt_labels=None, box_valid=None,
               gt_bboxes_ignore=None):
        from .geometry import bbox_overlaps
        k = squares.shape[0]
        if gt_valid is None:
            gt_valid = jnp.ones((gt_bboxes.shape[0],), bool)
        ious = bbox_overlaps(approxs, gt_bboxes)          # (K*A, G)
        ious = ious.reshape(k, int(approxs_per_octave), -1).max(axis=1)
        ious = jnp.where(gt_valid[None, :], ious, 0.0)
        if box_valid is not None:
            ious = jnp.where(box_valid[:, None], ious, 0.0)
        return self.assign_from_ious(ious, gt_valid, gt_labels=gt_labels,
                                     box_valid=box_valid)


@BBOX_ASSIGNERS.register_module()
class SimOTAAssigner:
    """SimOTA dynamic-k assignment (reference sim_ota_assigner.py),
    static-shape standalone. Candidates are points inside a gt or inside
    its center radius; cost = BCE(cls) + 3*(-log IoU) + 1e5*not-in-both;
    per-gt dynamic k = sum of its top-10 IoUs; conflicts resolve to min
    cost (models/dense_heads/yolox_head.py::simota_assign does the core
    selection; this wrapper builds the cost like the head does)."""

    def __init__(self, center_radius=2.5, candidate_topk=10,
                 iou_weight=3.0, cls_weight=1.0, **kw):
        self.center_radius = center_radius
        self.candidate_topk = candidate_topk
        self.iou_weight = iou_weight
        self.cls_weight = cls_weight

    def assign(self, pred_scores, priors, decoded_bboxes, gt_bboxes,
               gt_valid, gt_labels):
        """pred_scores (P, C) joint cls*obj probs; priors (P, 4): x, y,
        stride_x, stride_y; decoded_bboxes (P, 4) xyxy."""
        from ...models.dense_heads.yolox_head import simota_assign
        p, g = priors.shape[0], gt_bboxes.shape[0]
        ious = bbox_overlaps(decoded_bboxes, gt_bboxes)           # (P, G)
        ious = jnp.where(gt_valid[None, :], ious, 0.0)
        px, py = priors[:, 0], priors[:, 1]
        inside = ((px[:, None] > gt_bboxes[None, :, 0])
                  & (px[:, None] < gt_bboxes[None, :, 2])
                  & (py[:, None] > gt_bboxes[None, :, 1])
                  & (py[:, None] < gt_bboxes[None, :, 3]))
        cx = (gt_bboxes[:, 0] + gt_bboxes[:, 2]) / 2
        cy = (gt_bboxes[:, 1] + gt_bboxes[:, 3]) / 2
        r = self.center_radius * priors[:, 2:3]
        in_center = ((jnp.abs(px[:, None] - cx[None]) < r)
                     & (jnp.abs(py[:, None] - cy[None]) < r))
        valid_cand = (inside | in_center) & gt_valid[None, :]

        gt_onehot_p = pred_scores[:, jnp.clip(gt_labels, 0,
                                              pred_scores.shape[1] - 1)]
        eps = 1e-8
        cls_cost = -(jnp.log(gt_onehot_p + eps))                  # BCE @ y=1
        iou_cost = -jnp.log(ious + eps)
        cost = (self.cls_weight * cls_cost + self.iou_weight * iou_cost
                + 1e5 * (~(inside & in_center)))
        assigned = simota_assign(cost, ious, valid_cand, gt_valid,
                                 topk=self.candidate_topk)
        matched = jnp.clip(assigned - 1, 0, g - 1)
        labels = jnp.where(assigned > 0, gt_labels[matched], -1
                           ).astype(jnp.int32)
        max_overlaps = jnp.max(ious, axis=1)
        return AssignResult(assigned, max_overlaps, labels)


@BBOX_SAMPLERS.register_module()
class InstanceBalancedPosSampler(RandomSampler):
    """Positives spread evenly across instances (reference
    mmdet/core/bbox/samplers/instance_balanced_pos_sampler.py:1-56).

    Reference algorithm, static-shape: per-gt quota
    ``round(expected / num_instances) + 1`` positives drawn uniformly
    within each instance; shortfall filled uniformly from the remaining
    positives; overflow subsampled uniformly. Expressed as a rank:
    within-quota positives (in random order) first, leftover positives
    after — cutting at ``max_pos`` reproduces both the fill and the
    subsample cases.
    """

    def _pos_rank(self, key, assign):
        max_pos = int(round(self.num * self.pos_fraction))
        pos = assign.gt_inds > 0
        k1, k2 = jax.random.split(key)
        u = jax.random.uniform(k1, pos.shape)
        within = _segmented_rank(pos, assign.gt_inds, u)
        # instances with >=1 positive == positives holding within-rank 0
        num_inst = jnp.maximum(jnp.sum(pos & (within == 0)), 1)
        quota = jnp.round(max_pos / num_inst).astype(jnp.int32) + 1
        first = pos & (within < quota)
        u2 = jax.random.uniform(k2, pos.shape)
        sort_key = jnp.where(first, u2,
                             jnp.where(pos, 2.0 + u2, 4.0 + u2))
        return _rank_of(sort_key)


@BBOX_SAMPLERS.register_module()
class IoUBalancedNegSampler(RandomSampler):
    """IoU-balanced negative sampling, Libra R-CNN (reference
    mmdet/core/bbox/samplers/iou_balanced_neg_sampler.py:1-158).

    ``floor_fraction`` of the negatives come uniformly from the
    low-IoU floor set; the rest are stratified uniformly over
    ``num_bins`` equal IoU intervals spanning [floor_thr, max_iou],
    with shortfalls refilled uniformly. Static-shape: per-bin quotas
    become segmented random ranks; the reference's set arithmetic
    becomes priority keys cut at ``neg_needed``.
    """

    def __init__(self, num, pos_fraction, floor_thr=-1, floor_fraction=0,
                 num_bins=3, **kw):
        super().__init__(num=num, pos_fraction=pos_fraction, **kw)
        assert floor_thr >= 0 or floor_thr == -1
        assert 0 <= floor_fraction <= 1
        assert num_bins >= 1
        self.floor_thr = floor_thr
        self.floor_fraction = floor_fraction
        self.num_bins = num_bins

    def _neg_rank(self, key, assign, neg_needed):
        neg = assign.gt_inds == 0
        iou = assign.max_overlaps
        n = neg.shape[0]
        if self.floor_thr > 0:
            floor_m = neg & (iou >= 0) & (iou < self.floor_thr)
            iou_m = neg & (iou >= self.floor_thr)
            floor_eff = self.floor_thr
        elif self.floor_thr == 0:
            floor_m = neg & (iou == 0)
            iou_m = neg & (iou > 0)
            floor_eff = 0.0
        else:
            floor_m = jnp.zeros_like(neg)
            iou_m = neg
            floor_eff = 0.0

        k1, k2, k3, k4 = jax.random.split(key, 4)
        exp_iou = jnp.floor(neg_needed * (1 - self.floor_fraction)
                            ).astype(jnp.int32)

        if self.num_bins >= 2:
            # bin edges span [floor_eff, global max IoU] (reference
            # sample_via_interval uses max over *all* candidates)
            max_iou = jnp.maximum(jnp.max(iou), floor_eff + 1e-6)
            interval = (max_iou - floor_eff) / self.num_bins
            bin_id = jnp.clip(((iou - floor_eff) / interval).astype(jnp.int32),
                              0, self.num_bins - 1)
            u = jax.random.uniform(k1, (n,))
            within = _segmented_rank(iou_m, bin_id, u)
            per_bin = exp_iou // self.num_bins
            in_quota = iou_m & (within < per_bin)
        else:
            in_quota = jnp.zeros_like(neg)

        # priority: per-bin quota winners, then remaining iou-set (extras),
        # cut at exp_iou
        u2 = jax.random.uniform(k2, (n,))
        iou_key = jnp.where(in_quota, u2,
                            jnp.where(iou_m, 2.0 + u2, 4.0 + u2))
        iou_sel = iou_m & (_rank_of(iou_key) < exp_iou)
        n_iou = jnp.sum(iou_sel)

        exp_floor = neg_needed - n_iou
        floor_rank = _random_rank(k3, floor_m)
        floor_sel = floor_m & (floor_rank < exp_floor)

        # final fill from any unselected negative
        sel = iou_sel | floor_sel
        u4 = jax.random.uniform(k4, (n,))
        final_key = jnp.where(sel, u4, jnp.where(neg, 2.0 + u4, 4.0 + u4))
        return _rank_of(final_key)


def score_hlr_importance(valid: jnp.ndarray, match_idx: jnp.ndarray,
                         scores: jnp.ndarray):
    """Score hierarchical-local-rank importance (reference
    score_hlr_sampler.py:178-186): within each NMS-match group rank by
    score descending, ``imp = num_valid - rank + score``.

    Args: valid (N,) bool; match_idx (N,) group key (nms_match output);
    scores (N,) max positive-class score. Returns imp (N,), 0 for invalid.
    """
    num_valid = jnp.sum(valid)
    rank_in_group = _segmented_rank(valid, match_idx, -scores)
    imp = num_valid.astype(jnp.float32) - rank_in_group + scores
    return jnp.where(valid, imp, 0.0)


@BBOX_SAMPLERS.register_module()
class ScoreHLRSampler(RandomSampler):
    """ISR-N: negative mining by score hierarchical local rank (reference
    mmdet/core/bbox/samplers/score_hlr_sampler.py:1-265), static-shape.

    ``sample(key, assign, hlr=...)`` takes the head's no-grad outputs on
    every candidate: ``scores`` (max positive-class softmax), ``boxes``
    (decoded boxes of the argmax class), optional ``ori_loss`` (per-
    candidate background CE). Negatives with score > ``score_thr`` are
    grouped with nms_match, two-step-ranked by importance, and the top
    ``neg_needed`` picked; the rest come uniformly from the low-score
    pool. Returns (SamplingResult, neg_label_weights-aligned-to-slots).
    Without ``hlr`` inputs it degrades to uniform sampling (the reference
    precondition — a head context — is absent).
    """

    def __init__(self, num, pos_fraction, neg_pos_ub=-1,
                 add_gt_as_proposals=True, k=0.5, bias=0, score_thr=0.05,
                 iou_thr=0.5, **kwargs):
        super().__init__(num=num, pos_fraction=pos_fraction,
                         neg_pos_ub=neg_pos_ub,
                         add_gt_as_proposals=add_gt_as_proposals)
        self.k = k
        self.bias = bias
        self.score_thr = score_thr
        self.iou_thr = iou_thr
        self._hlr = None

    def _neg_rank(self, key, assign, neg_needed):
        if self._hlr is None:
            return _random_rank(key, assign.gt_inds == 0)
        scores, boxes = self._hlr[:2]
        neg = assign.gt_inds == 0
        n = neg.shape[0]
        valid = neg & (scores > self.score_thr)
        invalid = neg & ~valid

        from ..post_processing.nms import nms_match
        match = nms_match(boxes, jnp.where(valid, scores, -1.0),
                          self.iou_thr, valid=valid)
        imp = score_hlr_importance(valid, match, scores)
        # two-step rank: imp descending among valid
        imp_rank = _segmented_rank(valid, jnp.zeros(n, jnp.int32), -imp)
        self._imp_rank = imp_rank
        self._valid = valid
        # hlr winners first (by importance), then invalid uniformly
        u = jax.random.uniform(key, (n,))
        sort_key = jnp.where(
            valid, imp_rank.astype(jnp.float32) / n,
            jnp.where(invalid, 2.0 + u, 4.0 + u))
        return _rank_of(sort_key)

    def sample(self, key, assign: AssignResult, hlr=None):
        """Returns SamplingResult; with ``hlr`` also stores per-slot
        ``self.last_neg_label_weights`` (ISR-N weights, reference
        :195-210)."""
        self._hlr = hlr
        res = super().sample(key, assign)
        if hlr is None:
            self.last_neg_label_weights = jnp.ones(self.num)
            return res
        num_valid = jnp.sum(self._valid)
        neg_needed = jnp.sum(res.valid & ~res.is_pos)
        up_bound = jnp.maximum(neg_needed, num_valid).astype(jnp.float32)
        slot_rank = self._imp_rank[res.inds].astype(jnp.float32)
        slot_valid = self._valid[res.inds]
        w = (up_bound - slot_rank) / up_bound
        # low-score slots get the min hlr weight (reference :202)
        min_w = jnp.min(jnp.where(slot_valid, w, jnp.inf))
        min_w = jnp.where(jnp.isfinite(min_w), min_w, 1.0)
        w = jnp.where(slot_valid, w, min_w)
        w = (self.bias + (1 - self.bias) * w) ** self.k
        is_neg_slot = res.valid & ~res.is_pos
        if len(hlr) > 2 and hlr[2] is not None:
            ori = hlr[2][res.inds]
            num = jnp.sum(jnp.where(is_neg_slot, ori, 0.0))
            den = jnp.sum(jnp.where(is_neg_slot, ori * w, 0.0))
            w = w * num / jnp.maximum(den, 1e-12)
        self.last_neg_label_weights = jnp.where(is_neg_slot, w, 1.0)
        self._hlr = None
        return res


@BBOX_SAMPLERS.register_module()
class CombinedSampler(RandomSampler):
    """reference combined_sampler.py: separate pos/neg sampler cfgs; both
    resolve onto the masked randomized-rank sampler here."""

    def __init__(self, num, pos_fraction, pos_sampler=None, neg_sampler=None,
                 **kw):
        super().__init__(num=num, pos_fraction=pos_fraction)


@BBOX_SAMPLERS.register_module()
class MaskPseudoSampler(PseudoSampler):
    """reference mask_pseudo_sampler.py."""
    pass
