"""SSD head (reference mmdet/models/dense_heads/ssd_head.py:15): per-level
conv cls/reg predictors over SSD anchors, CE loss with 3:1 online hard
negative mining, SmoothL1 regression.

Static-shape hard-negative mining: negatives are ranked by their CE loss
(one argsort over all anchors) and the top ``neg_pos_ratio * num_pos`` are
kept — identical selection to the reference's per-image topk without ragged
indexing.
"""
from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.anchor import SSDAnchorGenerator
from ...core.bbox.assign_sample import MaxIoUAssigner
from ...core.bbox.coder import DeltaXYWHBBoxCoder
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import DETECTORS, HEADS
from ..layers import Conv


@HEADS.register_module()
class SSDHead(nn.Module):
    num_classes: int = 80
    in_channels: Sequence[int] = (512, 1024, 512, 256, 256, 256)
    anchor_generator: Any = None
    bbox_coder: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        ag = dict(self.anchor_generator or dict(
            input_size=300, basesize_ratio_range=(0.15, 0.9),
            strides=[8, 16, 32, 64, 100, 300],
            ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]]))
        ag.pop("type", None)
        self.prior_gen = SSDAnchorGenerator(**ag)
        bc = dict(self.bbox_coder or dict(target_means=(0., 0., 0., 0.),
                                          target_stds=(.1, .1, .2, .2)))
        bc.pop("type", None)
        self.coder = DeltaXYWHBBoxCoder(**bc)
        tc = dict(self.train_cfg or {})
        asn = dict(tc.get("assigner", dict(
            pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0,
            gt_max_assign_all=False)))
        asn.pop("type", None)
        self.assigner = MaxIoUAssigner(**asn)
        self.neg_pos_ratio = float(tc.get("neg_pos_ratio", 3))
        self.smoothl1_beta = float(tc.get("smoothl1_beta", 1.0))
        nb = self.prior_gen.num_base_anchors
        self.cls_convs = [
            Conv(nb[i] * (self.num_classes + 1), 3, 1, 1, dtype=self.dtype,
                 name=f"cls_conv{i}") for i in range(len(self.in_channels))]
        self.reg_convs = [
            Conv(nb[i] * 4, 3, 1, 1, dtype=self.dtype,
                 name=f"reg_conv{i}") for i in range(len(self.in_channels))]

    def __call__(self, feats):
        cls_scores = [conv(x) for conv, x in zip(self.cls_convs, feats)]
        bbox_preds = [conv(x) for conv, x in zip(self.reg_convs, feats)]
        return (cls_scores, bbox_preds)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds = outs
        n = cls_scores[0].shape[0]
        nc1 = self.num_classes + 1
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_gen.grid_priors_cat(featmap_sizes)
        cls = jnp.concatenate([s.reshape(n, -1, nc1) for s in cls_scores],
                              axis=1).astype(jnp.float32)
        reg = jnp.concatenate([b.reshape(n, -1, 4) for b in bbox_preds],
                              axis=1).astype(jnp.float32)

        def one(cls_i, reg_i, gt, gtv, gtl):
            assign = self.assigner.assign(anchors, gt, gtv, gt_labels=gtl)
            pos = assign.gt_inds > 0
            neg = assign.gt_inds == 0
            labels = jnp.where(pos, assign.labels, self.num_classes)
            logp = jax.nn.log_softmax(cls_i, axis=-1)
            ce = -jnp.take_along_axis(logp, labels[:, None], -1)[:, 0]
            num_pos = jnp.sum(pos)
            # hard negative mining: top (ratio * num_pos) CE among negatives
            k = jnp.minimum(
                (self.neg_pos_ratio * num_pos).astype(jnp.int32),
                jnp.sum(neg).astype(jnp.int32))
            neg_ce = jnp.where(neg, ce, -1.0)
            order = jnp.argsort(-neg_ce)
            rank = jnp.zeros_like(order).at[order].set(
                jnp.arange(order.shape[0]))
            hard_neg = neg & (rank < k)
            cls_w = (pos | hard_neg).astype(jnp.float32)
            matched = jnp.clip(assign.gt_inds - 1, 0, gt.shape[0] - 1)
            deltas = self.coder.encode(anchors, gt[matched])
            diff = jnp.abs(reg_i - deltas)
            b = self.smoothl1_beta
            sl1 = jnp.where(diff < b, 0.5 * diff * diff / b, diff - 0.5 * b)
            loss_bbox = jnp.sum(sl1 * pos[:, None])
            return jnp.sum(ce * cls_w), loss_bbox, num_pos

        lc, lb, np_ = jax.vmap(one)(cls, reg, gt_bboxes, gt_valid, gt_labels)
        total_pos = jnp.maximum(jnp.sum(np_), 1.0)
        return dict(loss_cls=jnp.sum(lc) / total_pos,
                    loss_bbox=jnp.sum(lb) / total_pos)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_scores, bbox_preds = outs
        cfg = dict(cfg or self.test_cfg or {})
        score_thr = float(cfg.get("score_thr", 0.02))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.45))
        max_per_img = int(cfg.get("max_per_img", 200))
        n = cls_scores[0].shape[0]
        nc1 = self.num_classes + 1
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_gen.grid_priors_cat(featmap_sizes)
        cls = jnp.concatenate([s.reshape(n, -1, nc1) for s in cls_scores],
                              axis=1).astype(jnp.float32)
        reg = jnp.concatenate([b.reshape(n, -1, 4) for b in bbox_preds],
                              axis=1).astype(jnp.float32)

        def one(cls_i, reg_i, shape, sf):
            scores = jax.nn.softmax(cls_i, -1)[:, :self.num_classes]
            boxes = self.coder.decode(anchors, reg_i,
                                      max_shape=(shape[0], shape[1]))
            if rescale:
                boxes = boxes / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            pad_scores = jnp.concatenate(
                [scores, jnp.zeros((scores.shape[0], 1))], -1)
            return multiclass_nms(boxes, pad_scores, score_thr, iou_thr,
                                  max_per_img, self.num_classes)

        return jax.vmap(one)(cls, reg, img_shapes, scale_factors)


from ..detectors.single_stage import SingleStageDetector  # noqa: E402


@DETECTORS.register_module()
class SSD(SingleStageDetector):
    """SSD alias detector (reference mmdet/models/detectors/ssd.py is
    registered as SingleStageDetector w/ SSDHead in configs)."""
    pass
