"""ATSS head (reference mmdet/models/dense_heads/atss_head.py:17): single
anchor per location, 4-conv GN towers, per-level learned reg scales,
centerness branch; targets via the adaptive ATSS assigner
(core/bbox/assign_sample.py ATSSAssigner). Losses: focal cls, GIoU on
decoded boxes weighted by centerness targets, BCE centerness — all
static-shape masked arithmetic.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.anchor import AnchorGenerator
from ...core.bbox.assign_sample import ATSSAssigner
from ...core.bbox.coder import DeltaXYWHBBoxCoder
from ...core.bbox.geometry import bbox_overlaps
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..layers import Conv, GroupNorm32


@HEADS.register_module()
class ATSSHead(nn.Module):
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 4
    anchor_generator: Any = None
    bbox_coder: Any = None
    loss_cls: Any = None
    loss_bbox: Any = None
    loss_centerness: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        ag = dict(self.anchor_generator or dict(
            octave_base_scale=8, scales_per_octave=1, ratios=[1.0],
            strides=[8, 16, 32, 64, 128]))
        ag.pop("type", None)
        self.prior_gen = AnchorGenerator(**ag)
        self.strides = tuple(ag.get("strides", (8, 16, 32, 64, 128)))
        bc = dict(self.bbox_coder or dict(target_means=(0., 0., 0., 0.),
                                          target_stds=(.1, .1, .2, .2)))
        bc.pop("type", None)
        self.coder = DeltaXYWHBBoxCoder(**bc)
        self.cls_loss = build_from_cfg(dict(self.loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0)), LOSSES)
        self.reg_loss = build_from_cfg(dict(self.loss_bbox or dict(
            type="GIoULoss", loss_weight=2.0)), LOSSES)
        tc = dict(self.train_cfg or {})
        asn = dict(tc.get("assigner", dict(topk=9)))
        asn.pop("type", None)
        self.assigner = ATSSAssigner(**asn)
        self.cls_convs = [Conv(self.feat_channels, 3, 1, 1, dtype=self.dtype,
                               name=f"cls_conv{i}")
                          for i in range(self.stacked_convs)]
        self.reg_convs = [Conv(self.feat_channels, 3, 1, 1, dtype=self.dtype,
                               name=f"reg_conv{i}")
                          for i in range(self.stacked_convs)]
        self.cls_gns = [GroupNorm32(name=f"cls_gn{i}")
                        for i in range(self.stacked_convs)]
        self.reg_gns = [GroupNorm32(name=f"reg_gn{i}")
                        for i in range(self.stacked_convs)]
        self.atss_cls = Conv(self.num_classes, 3, 1, 1, dtype=self.dtype)
        self.atss_reg = Conv(4, 3, 1, 1, dtype=self.dtype)
        self.atss_centerness = Conv(1, 3, 1, 1, dtype=self.dtype)
        self.scales = self.param("reg_scales", nn.initializers.ones,
                                 (len(self.strides),))

    def __call__(self, feats):
        cls_scores, bbox_preds, centernesses = [], [], []
        for li, x in enumerate(feats):
            c = r = x
            for conv, gn in zip(self.cls_convs, self.cls_gns):
                c = nn.relu(gn(conv(c)))
            for conv, gn in zip(self.reg_convs, self.reg_gns):
                r = nn.relu(gn(conv(r)))
            cls_scores.append(self.atss_cls(c))
            bbox_preds.append(self.atss_reg(r)
                              * self.scales[li].astype(jnp.float32))
            centernesses.append(self.atss_centerness(r))
        return (cls_scores, bbox_preds, centernesses)

    @staticmethod
    def _centerness_target(anchors, gts):
        """sqrt((min(l,r)/max(l,r)) * (min(t,b)/max(t,b))) about the anchor
        center (reference atss_head.py centerness_target)."""
        ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
        ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
        l = ax - gts[:, 0]
        t = ay - gts[:, 1]
        r = gts[:, 2] - ax
        b = gts[:, 3] - ay
        lr = jnp.maximum(jnp.minimum(l, r), 0) / jnp.maximum(
            jnp.maximum(l, r), 1e-6)
        tb = jnp.maximum(jnp.minimum(t, b), 0) / jnp.maximum(
            jnp.maximum(t, b), 1e-6)
        return jnp.sqrt(jnp.clip(lr * tb, 0, 1))

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds, centernesses = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        per_level = self.prior_gen.grid_priors(featmap_sizes)
        num_level = [len(a) for a in per_level]
        anchors = jnp.concatenate(per_level)
        cls = jnp.concatenate(
            [s.reshape(n, -1, self.num_classes) for s in cls_scores], axis=1)
        reg = jnp.concatenate(
            [b.reshape(n, -1, 4) for b in bbox_preds], axis=1)
        ctr = jnp.concatenate(
            [c.reshape(n, -1) for c in centernesses], axis=1)

        def one(gt, gtv, gtl):
            assign = self.assigner.assign(anchors, num_level, gt, gtv,
                                          gt_labels=gtl)
            pos = assign.gt_inds > 0
            labels = jnp.where(pos, assign.labels, self.num_classes)
            matched = jnp.clip(assign.gt_inds - 1, 0, gt.shape[0] - 1)
            mgt = gt[matched]
            ctr_tgt = jnp.where(pos, self._centerness_target(anchors, mgt),
                                0.0)
            return labels, pos, mgt, ctr_tgt

        labels, pos, mgt, ctr_tgt = jax.vmap(one)(gt_bboxes, gt_valid,
                                                  gt_labels)
        num_pos = jnp.maximum(jnp.sum(pos), 1.0)
        loss_cls = self.cls_loss(
            cls.reshape(-1, self.num_classes).astype(jnp.float32),
            labels.reshape(-1), jnp.ones(labels.size, jnp.float32),
            avg_factor=num_pos)
        # GIoU on decoded boxes, weighted by centerness targets
        dec = jax.vmap(lambda r_, a=anchors: self.coder.decode(a, r_))(
            reg.astype(jnp.float32))
        posf = pos.astype(jnp.float32)
        ctr_sum = jnp.maximum(jnp.sum(ctr_tgt * posf), 1e-6)
        loss_bbox = self.reg_loss(
            dec.reshape(-1, 4), mgt.reshape(-1, 4),
            (ctr_tgt * posf).reshape(-1), avg_factor=ctr_sum)
        bce = (jnp.maximum(ctr, 0) - ctr * ctr_tgt
               + jnp.log1p(jnp.exp(-jnp.abs(ctr))))
        loss_centerness = jnp.sum(bce * posf) / num_pos
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_centerness=loss_centerness)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_scores, bbox_preds, centernesses = outs
        cfg = dict(cfg or self.test_cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.6))
        max_per_img = int(cfg.get("max_per_img", 100))
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        per_level = [jnp.asarray(a) for a in
                     self.prior_gen.grid_priors(featmap_sizes)]

        def one(scores_lv, deltas_lv, ctr_lv, shape, sf):
            boxes_all, scores_all = [], []
            for sc, dl, ct, anch in zip(scores_lv, deltas_lv, ctr_lv,
                                        per_level):
                sc = jax.nn.sigmoid(sc.reshape(-1, self.num_classes)
                                    .astype(jnp.float32))
                sc = sc * jax.nn.sigmoid(
                    ct.reshape(-1, 1).astype(jnp.float32))
                dl = dl.reshape(-1, 4)
                k = min(nms_pre, sc.shape[0])
                _, ti = jax.lax.top_k(jnp.max(sc, axis=-1), k)
                boxes = self.coder.decode(anch[ti], dl[ti],
                                          max_shape=(shape[0], shape[1]))
                boxes_all.append(boxes)
                scores_all.append(sc[ti])
            boxes = jnp.concatenate(boxes_all)
            scores = jnp.concatenate(scores_all)
            if rescale:
                boxes = boxes / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            pad_scores = jnp.concatenate(
                [scores, jnp.zeros((scores.shape[0], 1))], axis=-1)
            return multiclass_nms(boxes, pad_scores, score_thr, iou_thr,
                                  max_per_img, self.num_classes)

        return jax.vmap(one)(tuple(cls_scores), tuple(bbox_preds),
                             tuple(centernesses), img_shapes, scale_factors)


from ..detectors.single_stage import SingleStageDetector  # noqa: E402


@DETECTORS.register_module()
class ATSS(SingleStageDetector):
    """ATSS detector (reference mmdet/models/detectors/atss.py:7)."""
    pass
