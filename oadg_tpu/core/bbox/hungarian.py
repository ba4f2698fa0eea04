"""Hungarian assignment for set-prediction heads (reference
mmdet/core/bbox/assigners/hungarian_assigner.py:11 + match_costs/).

The exact rectangular assignment runs on host via ``jax.pure_callback`` to
scipy.optimize.linear_sum_assignment (the reference calls the same scipy
routine); cost construction stays on device. Static shapes: padded gt
columns carry a large cost and are dropped in the callback via the count.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...utils.registry import BBOX_ASSIGNERS
from .geometry import bbox_overlaps


def _lsa_host(cost: np.ndarray, num_valid: np.ndarray) -> np.ndarray:
    """cost (Q, G), num_valid () -> assigned (Q,) int32: 0 = unmatched,
    j+1 = matched to gt j."""
    from scipy.optimize import linear_sum_assignment
    q, g = cost.shape
    nv = int(num_valid)
    out = np.zeros((q,), np.int32)
    if nv > 0:
        rows, cols = linear_sum_assignment(np.asarray(cost[:, :nv],
                                                      np.float64))
        out[rows] = cols.astype(np.int32) + 1
    return out


def _greedy_assign_device(cost: jnp.ndarray, gt_valid: jnp.ndarray
                          ) -> jnp.ndarray:
    """Greedy unique matching on device: repeatedly take the globally
    cheapest (query, gt) pair, masking used rows/columns. G iterations of
    an argmin over the (Q, G) matrix — static shapes, lax.fori_loop."""
    q, g = cost.shape
    BIG = 1e9
    cost0 = jnp.where(gt_valid[None, :], cost, BIG)

    def body(_, state):
        c, assigned = state
        flat = c.reshape(-1)
        i = jnp.argmin(flat)
        qi = i // g
        gi = i % g
        take = flat[i] < BIG / 2
        assigned = jnp.where(
            take, assigned.at[qi].set(gi.astype(jnp.int32) + 1), assigned)
        c = jnp.where(take, c.at[qi, :].set(BIG).at[:, gi].set(BIG), c)
        return c, assigned

    _, assigned = jax.lax.fori_loop(
        0, g, body, (cost0, jnp.zeros((q,), jnp.int32)))
    return assigned


def auction_assign(cost: jnp.ndarray, gt_valid: jnp.ndarray,
                   eps_rel: float = 2e-4, max_sweeps: int = 30000
                   ) -> jnp.ndarray:
    """Near-exact min-cost assignment on device: Bertsekas forward auction
    with fully vectorized Jacobi bidding (all unassigned gts bid each
    sweep). Replaces an earlier greedy fallback with an
    algorithm matching scipy linear_sum_assignment to within
    ``n_valid * eps`` of the optimal total cost (reference semantics:
    mmdet/core/bbox/assigners/hungarian_assigner.py:1-146 runs exact LSA).

    cost (Q, G) float32; gt_valid (G,) bool. Returns (Q,) int32:
    0 = unmatched, j+1 = row matched to gt j. Each valid gt is matched to
    a distinct row (Q >= n_valid assumed, true for DETR-family: Q=100-300
    queries vs <=G padded gts).

    Single phase from zero prices with fixed ``eps = eps_rel * scale``.
    Zero (uniform) initial prices are essential for the ASYMMETRIC case
    (Q > n_valid): rows that end unowned then hold the minimal price,
    which is the epsilon-CS condition of the implied zero-benefit dummy
    persons — so the symmetric optimality theorem applies and the total
    is within n_valid*eps of optimal. (eps-scaling with price persistence
    is NOT sound here: previously-owned rows that end a later phase
    unowned keep inflated prices, violating that condition — measured
    10x-optimal-cost failures before this was removed.) Typical
    convergence is tens of sweeps; adversarial exact-tie columns climb
    prices in eps steps, hence the generous ``max_sweeps`` with early
    exit. A final greedy completion guarantees feasibility even if the
    bound is hit.
    """
    q, g = cost.shape
    NEG = -1e9
    # benefit[i, j] = -cost of giving row i to gt j; invalid gts never bid
    b = jnp.where(gt_valid[None, :], -cost.astype(jnp.float32), NEG)
    scale = jnp.maximum(jnp.max(jnp.where(gt_valid[None, :],
                                          jnp.abs(cost), 0.0)), 1e-3)
    eps0 = eps_rel * scale

    def _scatter_rows(row_of, win_gt, won):
        """row_of[win_gt[i]] = i for rows that saw a winning bid."""
        rows = jnp.arange(q, dtype=jnp.int32)
        tgt = jnp.where(won, win_gt, g)                      # g = dump slot
        return jnp.concatenate([row_of, jnp.zeros((1,), jnp.int32)]
                               ).at[tgt].set(rows)[:g]

    def sweep(state):
        p, owner_row, row_of, eps, it = state
        unass = gt_valid & (row_of < 0)                      # (G,)
        vals = b - p[:, None]                                # (Q, G)
        w1 = jnp.max(vals, axis=0)                           # (G,)
        i_star = jnp.argmax(vals, axis=0)                    # (G,)
        vals2 = vals.at[i_star, jnp.arange(g)].set(NEG)
        w2 = jnp.max(vals2, axis=0)
        w2 = jnp.where(w2 > NEG / 2, w2, w1 - scale)
        bid = p[i_star] + (w1 - w2) + eps                    # (G,)

        # Jacobi conflict resolution: per row, the highest bid wins.
        bid_mat = jnp.where(
            (jnp.arange(q)[:, None] == i_star[None, :]) & unass[None, :],
            bid[None, :], NEG)                               # (Q, G)
        win_bid = jnp.max(bid_mat, axis=1)                   # (Q,)
        win_gt = jnp.argmax(bid_mat, axis=1).astype(jnp.int32)
        won = win_bid > NEG / 2                              # rows with bids

        # previous owners of contested rows lose their row
        loser = jnp.where(won & (owner_row >= 0), owner_row, g)
        row_of = jnp.concatenate([row_of, jnp.zeros((1,), jnp.int32)]
                                 ).at[loser].set(-1)[:g]
        owner_row = jnp.where(won, win_gt, owner_row)
        p = jnp.where(won, win_bid, p)
        row_of = _scatter_rows(row_of, win_gt, won)
        return p, owner_row, row_of, eps, it + 1

    def cond(state):
        _, _, row_of, _, it = state
        return jnp.any(gt_valid & (row_of < 0)) & (it < max_sweeps)

    _, _, row_of, _, _ = jax.lax.while_loop(
        cond, sweep,
        (jnp.zeros((q,), jnp.float32), jnp.full((q,), -1, jnp.int32),
         jnp.full((g,), -1, jnp.int32), eps0, jnp.int32(0)))

    # feasibility completion: any still-unassigned valid gt takes its
    # cheapest unowned row (greedy, G iterations; no-op when converged)
    def fix(j, state):
        row_of, taken = state
        need = gt_valid[j] & (row_of[j] < 0)
        c = jnp.where(taken, 1e9, cost[:, j])
        i = jnp.argmin(c).astype(jnp.int32)
        row_of = jnp.where(need, row_of.at[j].set(i), row_of)
        taken = jnp.where(need, taken.at[i].set(True), taken)
        return row_of, taken

    taken = jnp.zeros((q + 1,), bool).at[
        jnp.where(row_of >= 0, row_of, q)].set(True)[:q]
    row_of, _ = jax.lax.fori_loop(0, g, fix, (row_of, taken))

    assigned = jnp.zeros((q,), jnp.int32)
    gt_ids = jnp.arange(g, dtype=jnp.int32)
    tgt = jnp.where(gt_valid & (row_of >= 0), row_of, q)
    assigned = jnp.concatenate([assigned, jnp.zeros((1,), jnp.int32)]
                               ).at[tgt].set(gt_ids + 1)[:q]
    return assigned


def cxcywh_to_xyxy(b):
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_cxcywh(b):
    x1, y1, x2, y2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


@BBOX_ASSIGNERS.register_module()
class HungarianAssigner:
    """cls_cost: -prob[gt]; reg_cost: L1 on normalized cxcywh;
    iou_cost: -GIoU (weights from the reference's default match costs)."""

    def __init__(self, cls_cost=None, reg_cost=None, iou_cost=None, **kw):
        def w(c, default):
            return float((c or {}).get("weight", default))
        self.cls_w = w(cls_cost, 1.0)
        self.reg_w = w(reg_cost, 5.0)
        self.iou_w = w(iou_cost, 2.0)

    def assign(self, cls_prob, bbox_cxcywh_norm, gt_bboxes_xyxy, gt_valid,
               gt_labels, img_hw):
        """cls_prob (Q, C+1) softmax probs; bbox (Q, 4) normalized cxcywh;
        gt in absolute xyxy. Returns (Q,) int32 codes (0 neg / j+1 pos)."""
        q, g = cls_prob.shape[0], gt_bboxes_xyxy.shape[0]
        h, w = img_hw[0], img_hw[1]
        factor = jnp.stack([w, h, w, h])
        gt_norm = xyxy_to_cxcywh(gt_bboxes_xyxy / factor[None])
        cls_cost = -cls_prob[:, jnp.clip(gt_labels, 0, cls_prob.shape[1] - 1)]
        reg_cost = jnp.sum(
            jnp.abs(bbox_cxcywh_norm[:, None] - gt_norm[None]), -1)
        pred_xyxy = cxcywh_to_xyxy(bbox_cxcywh_norm) * factor[None]
        iou_cost = -bbox_overlaps(pred_xyxy, gt_bboxes_xyxy, mode="giou")
        cost = (self.cls_w * cls_cost + self.reg_w * reg_cost
                + self.iou_w * iou_cost)
        cost = jnp.where(gt_valid[None, :], cost, 1e6)
        # valid gts are padded to the front by the data layer; count them
        num_valid = jnp.sum(gt_valid.astype(jnp.int32))
        # matching is non-differentiable (reference runs it under no_grad) —
        # cut the gradient before the matcher
        cost_sg = jax.lax.stop_gradient(cost.astype(jnp.float32))
        if jax.default_backend() == "cpu":
            # exact scipy LSA via host callback (bit-parity with reference)
            assigned = jax.pure_callback(
                _lsa_host, jax.ShapeDtypeStruct((q,), jnp.int32),
                cost_sg, num_valid, vmap_method="sequential")
        else:
            # on an accelerator: the eps-scaled auction stays on the
            # device, with no host round-trip inside the step — optimal to ~1e-3 relative
            # total cost vs exact LSA (parity-tested vs scipy in
            # tests/test_hungarian_auction.py).
            assigned = auction_assign(cost_sg, gt_valid)
        # guard: padded-gt matches (possible only if valid gts are not
        # front-packed) are dropped
        matched = jnp.clip(assigned - 1, 0, g - 1)
        return jnp.where((assigned > 0) & gt_valid[matched], assigned, 0)
