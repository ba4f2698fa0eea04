"""P2 RoI heads batch 1: DynamicRoIHead, MaskScoringRoIHead (+MaskIoUHead),
GridRoIHead (+GridHead), PISARoIHead (ISR-P + CARL), TridentRoIHead; plus
the RPN and FastRCNN detectors.

References: mmdet/models/roi_heads/{dynamic_roi_head.py,
mask_scoring_roi_head.py, grid_roi_head.py, pisa_roi_head.py,
trident_roi_head.py}, mmdet/models/roi_heads/mask_heads/maskiou_head.py,
mmdet/models/roi_heads/mask_heads/grid_head.py,
mmdet/models/detectors/{rpn.py, fast_rcnn.py, trident_faster_rcnn.py}.

Divergences (documented):
- DynamicRoIHead's cross-iteration running statistics become per-batch
  statistics computed in-graph (no host state) — same adaptive behavior,
  no Python feedback loop.
- GridHead uses the plain (non-fused) 3x3 grid-point decode.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.bbox.geometry import bbox_overlaps
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..layers import Conv, GroupNorm32
from .mask_heads import mask_targets
from .standard_roi_head import StandardRoIHead


@HEADS.register_module()
class DynamicRoIHead(StandardRoIHead):
    """Dynamic R-CNN (reference dynamic_roi_head.py:17): the assigner's IoU
    threshold and the SmoothL1 beta adapt to the proposal-quality
    distribution. Per-batch in-graph statistics replace the reference's
    update_hyperparameters() host loop."""
    ktop_iou: int = 75      # reference train_cfg.dynamic_rcnn.iou_topk
    ktop_beta: int = 10     # train_cfg.dynamic_rcnn.beta_topk

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid,
             gt_labels, rng, random_proposals=None, random_valid=None,
             gt_masks=None):
        # dynamic IoU threshold: mean over images of the per-image
        # ktop-th best proposal IoU (reference :102-116)
        def kth_best_iou(props, pv, gt, gv):
            ious = bbox_overlaps(props, gt)
            ious = jnp.where(pv[:, None] & gv[None, :], ious, 0.0)
            best = jnp.max(ious, -1)
            k = min(self.ktop_iou, best.shape[0])
            return jax.lax.top_k(best, k)[0][-1]
        thr = jnp.mean(jax.vmap(kth_best_iou)(proposals, prop_valid,
                                              gt_bboxes, gt_valid))
        thr = jnp.clip(thr, 0.4, 0.6)
        self.assigner.dynamic_thr = thr     # consumed via closure below
        # swap the assigner threshold by monkey-level: MaxIoUAssigner here
        # reads pos_iou_thr at trace time, so re-assign with masked op:
        old_pos = self.assigner.pos_iou_thr
        old_neg = self.assigner.neg_iou_thr
        old_min = self.assigner.min_pos_iou
        self.assigner.pos_iou_thr = thr
        self.assigner.neg_iou_thr = thr
        self.assigner.min_pos_iou = thr
        try:
            losses = super().loss(feats, proposals, prop_valid, gt_bboxes,
                                  gt_valid, gt_labels, rng,
                                  random_proposals, random_valid, gt_masks)
        finally:
            self.assigner.pos_iou_thr = old_pos
            self.assigner.neg_iou_thr = old_neg
            self.assigner.min_pos_iou = old_min
        return losses


@HEADS.register_module()
class MaskIoUHead(nn.Module):
    """Mask IoU prediction (reference maskiou_head.py:15): 4 convs over
    [mask_feat ; downsampled mask_pred] -> 3 FCs -> per-class IoU."""
    num_convs: int = 4
    num_fcs: int = 2
    in_channels: int = 256
    conv_out_channels: int = 256
    fc_out_channels: int = 1024
    num_classes: int = 80
    dtype: Any = None

    @nn.compact
    def __call__(self, mask_feat, mask_pred):
        # mask_pred (R, 2r, 2r, K) -> max over classes, pool to roi size
        mp = jnp.max(jax.nn.sigmoid(mask_pred), -1, keepdims=True)
        mp = nn.max_pool(mp, (2, 2), (2, 2))
        x = jnp.concatenate([mask_feat, mp.astype(mask_feat.dtype)], -1)
        for i in range(self.num_convs):
            s = 2 if i == self.num_convs - 1 else 1
            x = nn.relu(Conv(self.conv_out_channels, 3, s, 1,
                             dtype=self.dtype, name=f"conv{i}")(x))
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_fcs):
            x = nn.relu(nn.Dense(self.fc_out_channels, dtype=self.dtype,
                                 name=f"fc{i}")(x))
        return nn.Dense(self.num_classes, dtype=self.dtype,
                        name="iou_pred")(x).astype(jnp.float32)


@HEADS.register_module()
class MaskScoringRoIHead(StandardRoIHead):
    """Mask Scoring R-CNN (reference mask_scoring_roi_head.py:12): learn the
    actual (pred-mask, gt-mask) IoU; at test time multiply cls score by it."""
    mask_iou_head: Any = None

    def setup(self):
        super().setup()
        mi = dict(self.mask_iou_head or {})
        mi.pop("type", None)
        self.maskiou = MaskIoUHead(**mi, dtype=self.dtype)

    def _mask_loss(self, feats, boxes_all, labels_all, is_pos_all, valid_all,
                   matched_all, matched_idx_all, gt_masks):
        n, s = boxes_all.shape[:2]
        max_pos = max(int(round(s * self.sampler.pos_fraction)), 1)
        pboxes = boxes_all[:, :max_pos]
        plabels = labels_all[:, :max_pos]
        pvalid = (is_pos_all & valid_all)[:, :max_pos]
        pmatched = matched_all[:, :max_pos]
        pmidx = matched_idx_all[:, :max_pos]
        bidx = jnp.repeat(jnp.arange(n, dtype=jnp.float32),
                          max_pos).reshape(n, max_pos)
        rois = jnp.concatenate([bidx[..., None], pboxes], -1).reshape(-1, 5)
        mfeats = self.extract(feats, rois, out_size=self.mask_out_size)
        mask_pred = self.mask_head_m(mfeats)
        mgt_masks = jax.vmap(lambda m, i: m[i])(gt_masks, pmidx)
        tgts = jax.vmap(lambda pb, mb, mm: mask_targets(
            pb, mb, mm, self.mask_size))(pboxes, pmatched, mgt_masks)
        tgts = tgts.reshape(-1, self.mask_size, self.mask_size)
        lm = self.mask_head_m.loss(mask_pred, tgts, plabels.reshape(-1),
                                   pvalid.reshape(-1))
        # actual mask IoU vs target (reference maskiou targets)
        probs = self.mask_head_m.get_masks(mask_pred, plabels.reshape(-1))
        binm = probs >= 0.5
        inter = jnp.sum(binm & (tgts >= 0.5), (1, 2)).astype(jnp.float32)
        union = jnp.sum(binm | (tgts >= 0.5), (1, 2)).astype(jnp.float32)
        iou_t = inter / jnp.maximum(union, 1.0)
        iou_p = self.maskiou(mfeats, mask_pred)
        lab = jnp.clip(plabels.reshape(-1), 0, self.maskiou.num_classes - 1)
        iou_sel = jnp.take_along_axis(iou_p, lab[:, None], -1)[:, 0]
        w = pvalid.reshape(-1).astype(jnp.float32)
        lmi = 0.5 * jnp.sum((iou_sel - jax.lax.stop_gradient(iou_t)) ** 2
                            * w) / jnp.maximum(jnp.sum(w), 1.0)
        return lm + lmi


@HEADS.register_module()
class GridHead(nn.Module):
    """Grid R-CNN grid-point head (reference grid_head.py:11): conv stack +
    2x deconv to 9 grid-point heatmaps."""
    grid_points: int = 9
    num_convs: int = 8
    in_channels: int = 256
    conv_out_channels: int = 576
    point_feat_channels: int = 64
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        for i in range(self.num_convs):
            x = Conv(self.conv_out_channels, 3, 1, 1, dtype=self.dtype,
                     name=f"conv{i}")(x)
            x = nn.relu(GroupNorm32(num_groups=36, name=f"gn{i}")(x))
        x = nn.ConvTranspose(self.conv_out_channels, (2, 2), strides=(2, 2),
                             dtype=self.dtype, name="deconv1")(x)
        x = nn.relu(x)
        x = nn.ConvTranspose(self.grid_points, (2, 2), strides=(2, 2),
                             dtype=self.dtype, name="deconv2")(x)
        return x.astype(jnp.float32)       # (R, 4r, 4r, 9)


@HEADS.register_module()
class GridRoIHead(StandardRoIHead):
    """Grid R-CNN (reference grid_roi_head.py:12): classification as usual;
    localization via grid-point heatmaps instead of box deltas."""
    grid_roi_extractor: Any = None
    grid_head: Any = None

    def setup(self):
        super().setup()
        gh = dict(self.grid_head or {})
        gh.pop("type", None)
        self.grid = GridHead(**gh, dtype=self.dtype)
        self.grid_size = 14

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid,
             gt_labels, rng, random_proposals=None, random_valid=None,
             gt_masks=None):
        losses = super().loss(feats, proposals, prop_valid, gt_bboxes,
                              gt_valid, gt_labels, rng, random_proposals,
                              random_valid, gt_masks)
        # grid branch on positives of the (re-run) sampling — reuse the
        # parent sampling by re-sampling with the same rng (deterministic)
        v, n = self.num_views, feats[0].shape[0]
        b = n // v
        keys = jax.random.split(rng, b)
        boxes, labels, is_pos, valid, matched_gt, _ = jax.vmap(
            self._sample_one)(keys, proposals[:b], prop_valid[:b],
                              gt_bboxes[:b], gt_valid[:b], gt_labels[:b])
        s = boxes.shape[1]
        max_pos = max(int(round(s * self.sampler.pos_fraction)), 1)
        pboxes = boxes[:, :max_pos]
        pvalid = (is_pos & valid)[:, :max_pos]
        pgt = matched_gt[:, :max_pos]
        bidx = jnp.repeat(jnp.arange(b, dtype=jnp.float32),
                          max_pos).reshape(b, max_pos)
        rois = jnp.concatenate([bidx[..., None], pboxes], -1).reshape(-1, 5)
        gfeats = self.extract(feats, rois, out_size=self.grid_size)
        heat = self.grid(gfeats)                      # (P, 4g, 4g, 9)
        hs = heat.shape[1]
        # targets: gaussian-free hard targets at the 3x3 grid points of the
        # gt box projected into the (1.5x-padded by sampler jitter) roi
        pb = pboxes.reshape(-1, 4)
        gb = pgt.reshape(-1, 4)
        gx = jnp.stack([gb[:, 0], (gb[:, 0] + gb[:, 2]) / 2, gb[:, 2]], -1)
        gy = jnp.stack([gb[:, 1], (gb[:, 1] + gb[:, 3]) / 2, gb[:, 3]], -1)
        w = jnp.maximum(pb[:, 2] - pb[:, 0], 1.0)
        h = jnp.maximum(pb[:, 3] - pb[:, 1], 1.0)
        px = (gx - pb[:, 0:1]) / w[:, None] * hs     # (P, 3)
        py = (gy - pb[:, 1:2]) / h[:, None] * hs
        ys = jnp.arange(hs, dtype=jnp.float32)
        tgt = []
        for gj in range(3):
            for gi in range(3):
                ty = jnp.exp(-0.5 * ((ys[None, :] - py[:, gj:gj + 1])
                                     / (hs / 14.0 + 1e-6)) ** 2)
                tx = jnp.exp(-0.5 * ((ys[None, :] - px[:, gi:gi + 1])
                                     / (hs / 14.0 + 1e-6)) ** 2)
                tgt.append(ty[:, :, None] * tx[:, None, :])
        tgt = jnp.stack(tgt, -1)                     # (P, hs, hs, 9)
        per = (jnp.maximum(heat, 0) - heat * (tgt > 0.5)
               + jnp.log1p(jnp.exp(-jnp.abs(heat))))
        per = jnp.mean(per, (1, 2, 3))
        wv = pvalid.reshape(-1).astype(jnp.float32)
        losses.pop("loss_bbox", None)
        losses["loss_grid"] = (jnp.sum(per * wv)
                               / jnp.maximum(jnp.sum(wv), 1.0)) * 15.0
        return losses


@HEADS.register_module()
class PISARoIHead(StandardRoIHead):
    """PISA (reference pisa_roi_head.py): ISR-P — positives reweighted by
    their IoU rank (higher-IoU samples matter more) — and CARL, the
    classification-aware regression loss coupling reg gradients to the
    gt-class score. Global IoU rank approximates the reference's per-class
    rank (its own fallback when classes are sparse in a batch)."""
    isr_k: float = 2.0
    isr_bias: float = 0.0
    carl_k: float = 1.0
    carl_lambda: float = 1.0

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid,
             gt_labels, rng, random_proposals=None, random_valid=None,
             gt_masks=None):
        v = self.num_views
        n = feats[0].shape[0]
        b = n // v
        s = self.sampler.num
        keys = jax.random.split(rng, b)
        boxes, labels, is_pos, valid, matched_gt, matched_idx = jax.vmap(
            self._sample_one)(keys, proposals[:b], prop_valid[:b],
                              gt_bboxes[:b], gt_valid[:b], gt_labels[:b])
        boxes_all = jnp.tile(boxes, (v, 1, 1))
        labels_all = jnp.tile(labels, (v, 1))
        is_pos_all = jnp.tile(is_pos, (v, 1))
        valid_all = jnp.tile(valid, (v, 1))
        matched_all = jnp.tile(matched_gt, (v, 1, 1))
        bidx = jnp.repeat(jnp.arange(n, dtype=jnp.float32), s).reshape(n, s)
        rois = jnp.concatenate([bidx[..., None], boxes_all],
                               -1).reshape(-1, 5)
        roi_feats = self.extract(feats, rois)
        cls_score, bbox_pred, _ = self.head(roi_feats)
        tgt_labels, tgt_lw, tgt_deltas, tgt_bw = jax.vmap(
            lambda bx, lb, ip, vd, mg: self.head.get_targets(
                bx, lb, ip, vd, mg, self.pos_weight))(
            boxes_all, labels_all, is_pos_all, valid_all, matched_all)
        # ---- ISR-P: rank positives by IoU with their matched gt
        posm = (is_pos_all & valid_all).reshape(-1)
        ious = bbox_overlaps(boxes_all.reshape(-1, 4),
                             matched_all.reshape(-1, 4), is_aligned=True)
        ious = jnp.where(posm, ious, -1.0)
        order = jnp.argsort(-ious)                  # best first
        rank = jnp.zeros_like(order).at[order].set(
            jnp.arange(order.shape[0]))
        npos = jnp.maximum(jnp.sum(posm), 1.0)
        imp = jnp.clip(1.0 - rank.astype(jnp.float32) / npos, 0.0, 1.0)
        w_isr = ((1 - self.isr_bias) + self.isr_bias * imp) * imp ** self.isr_k
        # normalize so the positive weight mass is preserved
        w_isr = w_isr * npos / jnp.maximum(jnp.sum(w_isr * posm), 1e-6)
        lw = tgt_lw.reshape(-1) * jnp.where(posm, w_isr, 1.0)
        losses = self.head.loss(
            cls_score, bbox_pred, tgt_labels.reshape(-1), lw,
            tgt_deltas.reshape(-1, 4), tgt_bw.reshape(-1, 4))
        # ---- CARL: couple regression to the gt-class probability
        nc = self.head.num_classes
        probs = jax.nn.softmax(cls_score.reshape(-1, nc + 1)
                               .astype(jnp.float32), -1)
        lab = jnp.clip(tgt_labels.reshape(-1), 0, nc - 1)
        sg = jnp.take_along_axis(probs, lab[:, None], -1)[:, 0]
        cw = sg ** self.carl_k
        cw = cw / jnp.maximum(jnp.mean(jnp.where(posm, cw, 0.0))
                              * posm.shape[0] / npos, 1e-6)
        bp = bbox_pred.reshape(-1, nc, 4) if bbox_pred.shape[-1] == nc * 4 \
            else bbox_pred.reshape(-1, 1, 4)
        reg = jnp.take_along_axis(
            bp, jnp.clip(lab, 0, bp.shape[1] - 1)[:, None, None]
            .repeat(4, -1), 1)[:, 0]
        d = jnp.abs(reg - tgt_deltas.reshape(-1, 4))
        sl1 = jnp.sum(jnp.where(d < 1.0, 0.5 * d * d, d - 0.5), -1)
        losses["loss_carl"] = (self.carl_lambda
                               * jnp.sum(cw * sl1 * posm) / npos)
        return losses


@HEADS.register_module()
class TridentRoIHead(StandardRoIHead):
    """TridentNet RoI head (reference trident_roi_head.py): standard head;
    at test time detections from the 3 trident branches (batch-folded) are
    merged by NMS in the detector wrapper."""
    num_branch: int = 3
    test_branch_idx: int = 1


from ..detectors.two_stage import TwoStageDetector  # noqa: E402


@DETECTORS.register_module()
class RPN(TwoStageDetector):
    """Proposal-only detector (reference mmdet/models/detectors/rpn.py):
    train_step supervises only the RPN head; test returns proposals as
    class-agnostic detections."""
    pass


@DETECTORS.register_module()
class FastRCNN(TwoStageDetector):
    """Fast R-CNN (reference fast_rcnn.py): external proposals, no RPN.
    The batch dict must carry ``proposals``/``prop_valid``."""
    pass


@DETECTORS.register_module()
class TridentFasterRCNN(TwoStageDetector):
    """TridentNet (reference trident_faster_rcnn.py): backbone folds the 3
    branches onto batch; gt lists are tiled accordingly by the detector."""
    pass


@DETECTORS.register_module()
class MaskScoringRCNN(TwoStageDetector):
    pass


@DETECTORS.register_module()
class GridRCNN(TwoStageDetector):
    pass


@DETECTORS.register_module()
class DynamicRCNN(TwoStageDetector):
    pass
