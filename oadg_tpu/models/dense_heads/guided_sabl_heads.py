"""Guided Anchoring (GA-RPN / GA-Retina) and SABL retina heads.

References: mmdet/models/dense_heads/guided_anchor_head.py (loc + shape
branches, deform-conv feature adaptation, guided anchors),
ga_rpn_head.py, ga_retina_head.py, sabl_retina_head.py +
core/bbox/coder/bucketing_bbox_coder.py.

Static-shape adaptations:
- GA loc/shape targets use the center-region rule (σ_center=0.2,
  σ_ignore=0.5) on the gt's scale-mapped level as dense (P, G) masks.
- The shape branch trains with a decoded-IoU loss against the matched gt
  (the reference's bounded-IoU sampling of 9 candidate shapes collapses to
  the same optimum under the static formulation).
- SABL buckets: per-side bucket classification + in-bucket offset, exactly
  the reference's (2k buckets, top-bucket decode) scheme.
"""
from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.anchor import AnchorGenerator
from ...core.bbox.assign_sample import MaxIoUAssigner
from ...core.bbox.coder import DeltaXYWHBBoxCoder
from ...core.bbox.geometry import bbox_overlaps
from ...core.post_processing.nms import batched_nms_padded, multiclass_nms
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, DeformConv
from .fovea_fsaf_heads import _level_points

INF = 1e8


class FeatureAdaption(nn.Module):
    """Deform-conv adaptation driven by the shape prediction (reference
    guided_anchor_head.py:22)."""
    out_channels: int = 256
    deform_groups: int = 4
    dtype: Any = None

    @nn.compact
    def __call__(self, x, shape_pred):
        off = Conv(self.deform_groups * 18, 1, 1, 0, dtype=self.dtype,
                   name="conv_offset")(
            jax.lax.stop_gradient(shape_pred)).astype(jnp.float32)
        return nn.relu(DeformConv(self.out_channels, 3, padding=1,
                                  deform_groups=self.deform_groups,
                                  name="conv_adaption")(x, off))


class GuidedAnchorBase(nn.Module):
    """Shared GA machinery: loc/shape branches + targets."""
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 256
    strides: Sequence[int] = (8, 16, 32, 64, 128)
    octave_base_scale: int = 8
    deform_groups: int = 4
    loc_filter_thr: float = 0.01
    center_ratio: float = 0.2
    ignore_ratio: float = 0.5
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def _region_mask(self, points, gt, frac):
        px, py = points[:, 0:1], points[:, 1:2]
        cx = (gt[None, :, 0] + gt[None, :, 2]) * 0.5
        cy = (gt[None, :, 1] + gt[None, :, 3]) * 0.5
        gw = gt[None, :, 2] - gt[None, :, 0]
        gh = gt[None, :, 3] - gt[None, :, 1]
        return ((px >= cx - 0.5 * frac * gw) & (px <= cx + 0.5 * frac * gw)
                & (py >= cy - 0.5 * frac * gh)
                & (py <= cy + 0.5 * frac * gh))

    def ga_targets(self, points, sids, strides_pp, gt, gtv):
        """loc target (P,), loc weight (P,), matched gt per point (P, 4),
        shape-positive mask (P,)."""
        nl = len(self.strides)
        # gt level by scale
        scale = jnp.sqrt(jnp.maximum(
            (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]), 1e-6))
        lvl = jnp.clip(jnp.round(jnp.log2(
            scale / self.octave_base_scale / 8.0 + 1e-6)) + 2, 0,
            nl - 1).astype(jnp.int32)
        on_lvl = sids[:, None] == lvl[None, :]
        center = self._region_mask(points, gt, self.center_ratio) & on_lvl
        ignore = self._region_mask(points, gt, self.ignore_ratio) & on_lvl
        center = center & gtv[None, :]
        ignore = ignore & gtv[None, :]
        loc_t = jnp.any(center, -1).astype(jnp.float32)
        loc_w = jnp.where(jnp.any(ignore, -1) & (loc_t == 0), 0.0, 1.0)
        area = ((gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]))[None, :]
        am = jnp.where(center, area, INF)
        gi = jnp.argmin(am, -1)
        shape_pos = jnp.min(am, -1) < INF
        return loc_t, loc_w, gt[gi], shape_pos, gi


@HEADS.register_module()
class GARPNHead(GuidedAnchorBase):
    """GA-RPN (reference ga_rpn_head.py:12)."""

    def setup(self):
        self.rpn_conv = Conv(self.feat_channels, 3, 1, 1, dtype=self.dtype)
        self.conv_loc = Conv(1, 1, 1, 0, dtype=self.dtype)
        self.conv_shape = Conv(2, 1, 1, 0, dtype=self.dtype)
        self.adaption = FeatureAdaption(self.feat_channels,
                                        self.deform_groups,
                                        dtype=self.dtype)
        self.rpn_cls = Conv(1, 1, 1, 0, dtype=self.dtype)
        self.rpn_reg = Conv(4, 1, 1, 0, dtype=self.dtype)
        self.coder = DeltaXYWHBBoxCoder(target_stds=(0.07, 0.07, 0.14,
                                                     0.14))
        tc = dict(self.train_cfg or {})
        asn = dict(tc.get("assigner", dict(pos_iou_thr=0.7,
                                           neg_iou_thr=0.3,
                                           min_pos_iou=0.3)))
        asn.pop("type", None)
        self.assigner = MaxIoUAssigner(**asn)

    def __call__(self, feats):
        locs, shapes, cls_scores, bbox_preds = [], [], [], []
        for x in feats:
            h = nn.relu(self.rpn_conv(x))
            loc = self.conv_loc(h).astype(jnp.float32)
            shp = self.conv_shape(h).astype(jnp.float32)
            ha = self.adaption(h, shp)
            cls_scores.append(self.rpn_cls(ha).astype(jnp.float32))
            bbox_preds.append(self.rpn_reg(ha).astype(jnp.float32))
            locs.append(loc)
            shapes.append(shp)
        return cls_scores, bbox_preds, shapes, locs

    def _guided_anchors(self, points, sids, strides_pp, shapes_flat):
        base = self.octave_base_scale * strides_pp
        w = base * jnp.exp(jnp.clip(shapes_flat[..., 0], -4, 4))
        h = base * jnp.exp(jnp.clip(shapes_flat[..., 1], -4, 4))
        return jnp.stack([points[:, 0] - w / 2, points[:, 1] - h / 2,
                          points[:, 0] + w / 2, points[:, 1] + h / 2], -1)

    def loss(self, outs, gt_bboxes, gt_valid, rng=None, gt_labels=None):
        cls_scores, bbox_preds, shapes, locs = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, sids = _level_points(featmap_sizes, self.strides)
        strides_pp = jnp.asarray(np.asarray(self.strides,
                                            np.float32))[sids]
        loc = jnp.concatenate([l.reshape(n, -1) for l in locs], 1)
        shp = jnp.concatenate([s.reshape(n, -1, 2) for s in shapes], 1)
        cls = jnp.concatenate([c.reshape(n, -1) for c in cls_scores], 1)
        reg = jnp.concatenate([b.reshape(n, -1, 4) for b in bbox_preds], 1)
        anchors = jax.vmap(lambda s: self._guided_anchors(
            points, sids, strides_pp, s))(shp)

        def one(loc_i, anch, gt, gtv):
            loc_t, loc_w, mgt, shape_pos, _ = self.ga_targets(
                points, sids, strides_pp, gt, gtv)
            iou_shape = bbox_overlaps(anch, mgt, is_aligned=True)
            a = self.assigner.assign(jax.lax.stop_gradient(anch), gt, gtv)
            pos = a.gt_inds > 0
            gi = jnp.clip(a.gt_inds - 1, 0, gt.shape[0] - 1)
            neg = a.gt_inds == 0
            return loc_t, loc_w, iou_shape, shape_pos, pos, neg, gt[gi]

        loc_t, loc_w, iou_shape, shape_pos, pos, neg, tgt = jax.vmap(one)(
            loc, anchors, gt_bboxes, gt_valid)
        # loc: focal BCE
        p = jax.nn.sigmoid(loc)
        pt = p * loc_t + (1 - p) * (1 - loc_t)
        a_t = 0.25 * loc_t + 0.75 * (1 - loc_t)
        ce = (jnp.maximum(loc, 0) - loc * loc_t
              + jnp.log1p(jnp.exp(-jnp.abs(loc))))
        nloc = jnp.maximum(jnp.sum(loc_t), 1.0)
        loss_loc = jnp.sum(a_t * (1 - pt) ** 2 * ce * loc_w) / nloc
        # shape: IoU loss on shape-positive points
        nsp = jnp.maximum(jnp.sum(shape_pos), 1.0)
        loss_shape = jnp.sum(-jnp.log(jnp.clip(iou_shape, 1e-6, 1.0))
                             * shape_pos) / nsp
        # cls/reg on guided anchors (binary RPN objectness)
        npos = jnp.maximum(jnp.sum(pos), 1.0)
        cw = (pos | neg).astype(jnp.float32)
        ce2 = (jnp.maximum(cls, 0) - cls * pos
               + jnp.log1p(jnp.exp(-jnp.abs(cls))))
        loss_cls = jnp.sum(ce2 * cw) / jnp.maximum(jnp.sum(cw), 1.0)
        deltas = self.coder.encode(jax.lax.stop_gradient(anchors), tgt)
        d = jnp.abs(reg - deltas)
        sl1 = jnp.sum(jnp.where(d < 1 / 9, 4.5 * d * d, d - 1 / 18), -1)
        loss_reg = jnp.sum(sl1 * pos) / npos
        return dict(loss_rpn_ga_loc=loss_loc, loss_rpn_ga_shape=loss_shape,
                    loss_rpn_cls=loss_cls, loss_rpn_bbox=loss_reg)

    def get_proposals(self, cls_scores, bbox_preds, img_shapes, cfg,
                      shapes=None, locs=None):
        cfg = dict(cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        max_per_img = int(cfg.get("max_per_img", 1000))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.7))
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, sids = _level_points(featmap_sizes, self.strides)
        strides_pp = jnp.asarray(np.asarray(self.strides,
                                            np.float32))[sids]
        cls = jnp.concatenate([c.reshape(n, -1) for c in cls_scores], 1)
        reg = jnp.concatenate([b.reshape(n, -1, 4) for b in bbox_preds], 1)
        shp = jnp.concatenate([s.reshape(n, -1, 2) for s in shapes], 1)
        loc = jnp.concatenate([l.reshape(n, -1) for l in locs], 1)
        anchors = jax.vmap(lambda s: self._guided_anchors(
            points, sids, strides_pp, s))(shp)
        lvl = jnp.broadcast_to(sids[None], cls.shape)

        def one(c, r, a, l, lv, shape):
            score = jax.nn.sigmoid(c) * (jax.nn.sigmoid(l)
                                         > self.loc_filter_thr)
            k = min(nms_pre, score.shape[0])
            top, ti = jax.lax.top_k(score, k)
            boxes = self.coder.decode(a[ti], r[ti],
                                      max_shape=(shape[0], shape[1]))
            keep = batched_nms_padded(boxes, top, lv[ti], iou_thr,
                                      valid=top > 0)
            sc = jnp.where(keep, top, -jnp.inf)
            m = min(max_per_img, k)
            top_s, top_i = jax.lax.top_k(sc, m)
            out_valid = top_s > -jnp.inf
            out_boxes = jnp.where(out_valid[:, None], boxes[top_i], 0.0)
            return (jax.lax.stop_gradient(out_boxes),
                    jnp.where(out_valid, top_s, 0.0), out_valid)

        return jax.vmap(one)(cls, reg, anchors, loc, lvl, img_shapes)


@HEADS.register_module()
class GARetinaHead(GuidedAnchorBase):
    """GA-Retina (reference ga_retina_head.py:11): retina towers + GA
    loc/shape + adapted features for cls/reg."""
    stacked_convs: int = 4
    loss_cls: Any = None
    loss_bbox: Any = None

    def setup(self):
        self.l_cls = build_from_cfg(dict(self.loss_cls or dict(
            type="FocalLoss", gamma=2.0, alpha=0.25, loss_weight=1.0)),
            LOSSES)
        self.l_bbox = build_from_cfg(dict(self.loss_bbox or dict(
            type="SmoothL1Loss", beta=0.04, loss_weight=1.0)), LOSSES)
        self.cls_convs = [Conv(self.feat_channels, 3, 1, 1,
                               dtype=self.dtype, name=f"cls_conv{i}")
                          for i in range(self.stacked_convs)]
        self.reg_convs = [Conv(self.feat_channels, 3, 1, 1,
                               dtype=self.dtype, name=f"reg_conv{i}")
                          for i in range(self.stacked_convs)]
        self.conv_loc = Conv(1, 1, 1, 0, dtype=self.dtype)
        self.conv_shape = Conv(2, 1, 1, 0, dtype=self.dtype)
        self.adapt_cls = FeatureAdaption(self.feat_channels,
                                         self.deform_groups,
                                         dtype=self.dtype, name="adapt_cls")
        self.adapt_reg = FeatureAdaption(self.feat_channels,
                                         self.deform_groups,
                                         dtype=self.dtype, name="adapt_reg")
        self.retina_cls = Conv(self.num_classes, 3, 1, 1, dtype=self.dtype)
        self.retina_reg = Conv(4, 3, 1, 1, dtype=self.dtype)
        self.coder = DeltaXYWHBBoxCoder()
        tc = dict(self.train_cfg or {})
        asn = dict(tc.get("assigner", dict(pos_iou_thr=0.5,
                                           neg_iou_thr=0.4,
                                           min_pos_iou=0.0)))
        asn.pop("type", None)
        self.assigner = MaxIoUAssigner(**asn)

    def __call__(self, feats):
        cls_scores, bbox_preds, shapes, locs = [], [], [], []
        for x in feats:
            c = r = x
            for conv in self.cls_convs:
                c = nn.relu(conv(c))
            for conv in self.reg_convs:
                r = nn.relu(conv(r))
            loc = self.conv_loc(c).astype(jnp.float32)
            shp = self.conv_shape(r).astype(jnp.float32)
            ca = self.adapt_cls(c, shp)
            ra = self.adapt_reg(r, shp)
            cls_scores.append(self.retina_cls(ca).astype(jnp.float32))
            bbox_preds.append(self.retina_reg(ra).astype(jnp.float32))
            shapes.append(shp)
            locs.append(loc)
        return cls_scores, bbox_preds, shapes, locs

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds, shapes, locs = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, sids = _level_points(featmap_sizes, self.strides)
        strides_pp = jnp.asarray(np.asarray(self.strides,
                                            np.float32))[sids]
        loc = jnp.concatenate([l.reshape(n, -1) for l in locs], 1)
        shp = jnp.concatenate([s.reshape(n, -1, 2) for s in shapes], 1)
        cls = jnp.concatenate([c.reshape(n, -1, self.num_classes)
                               for c in cls_scores], 1)
        reg = jnp.concatenate([b.reshape(n, -1, 4) for b in bbox_preds], 1)
        base = self.octave_base_scale * strides_pp
        w = base * jnp.exp(jnp.clip(shp[..., 0], -4, 4))
        h = base * jnp.exp(jnp.clip(shp[..., 1], -4, 4))
        anchors = jnp.stack([points[None, :, 0] - w / 2,
                             points[None, :, 1] - h / 2,
                             points[None, :, 0] + w / 2,
                             points[None, :, 1] + h / 2], -1)

        def one(loc_i, anch, gt, gtv, gtl):
            loc_t, loc_w, mgt, shape_pos, _ = self.ga_targets(
                points, sids, strides_pp, gt, gtv)
            iou_shape = bbox_overlaps(anch, mgt, is_aligned=True)
            a = self.assigner.assign(jax.lax.stop_gradient(anch), gt, gtv,
                                     gt_labels=gtl)
            pos = a.gt_inds > 0
            gi = jnp.clip(a.gt_inds - 1, 0, gt.shape[0] - 1)
            labels = jnp.where(pos, gtl[gi], self.num_classes)
            neg = a.gt_inds == 0
            return (loc_t, loc_w, iou_shape, shape_pos, pos, neg,
                    labels.astype(jnp.int32), gt[gi])

        loc_t, loc_w, iou_shape, shape_pos, pos, neg, labels, tgt = \
            jax.vmap(one)(loc, anchors, gt_bboxes, gt_valid, gt_labels)
        p = jax.nn.sigmoid(loc)
        pt = p * loc_t + (1 - p) * (1 - loc_t)
        a_t = 0.25 * loc_t + 0.75 * (1 - loc_t)
        ce = (jnp.maximum(loc, 0) - loc * loc_t
              + jnp.log1p(jnp.exp(-jnp.abs(loc))))
        nloc = jnp.maximum(jnp.sum(loc_t), 1.0)
        loss_loc = jnp.sum(a_t * (1 - pt) ** 2 * ce * loc_w) / nloc
        nsp = jnp.maximum(jnp.sum(shape_pos), 1.0)
        loss_shape = jnp.sum(-jnp.log(jnp.clip(iou_shape, 1e-6, 1.0))
                             * shape_pos) / nsp
        npos = jnp.maximum(jnp.sum(pos), 1.0)
        cw = (pos | neg).astype(jnp.float32)
        loss_cls = self.l_cls(cls.reshape(-1, self.num_classes),
                              labels.reshape(-1), cw.reshape(-1),
                              avg_factor=npos)
        deltas = self.coder.encode(jax.lax.stop_gradient(anchors), tgt)
        bw = pos.astype(jnp.float32)[..., None] * jnp.ones((1, 1, 4))
        loss_reg = self.l_bbox(reg, deltas, bw, avg_factor=npos * 4)
        return dict(loss_ga_loc=loss_loc, loss_ga_shape=loss_shape,
                    loss_cls=loss_cls, loss_bbox=loss_reg)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_scores, bbox_preds, shapes, locs = outs
        cfg = dict(cfg or self.test_cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.5))
        max_per_img = int(cfg.get("max_per_img", 100))
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, sids = _level_points(featmap_sizes, self.strides)
        strides_pp = jnp.asarray(np.asarray(self.strides,
                                            np.float32))[sids]
        cls = jnp.concatenate([c.reshape(n, -1, self.num_classes)
                               for c in cls_scores], 1)
        reg = jnp.concatenate([b.reshape(n, -1, 4) for b in bbox_preds], 1)
        shp = jnp.concatenate([s.reshape(n, -1, 2) for s in shapes], 1)
        loc = jnp.concatenate([l.reshape(n, -1) for l in locs], 1)
        base = self.octave_base_scale * strides_pp

        def one(c, r, s, l, shape, sf):
            w = base * jnp.exp(jnp.clip(s[:, 0], -4, 4))
            h = base * jnp.exp(jnp.clip(s[:, 1], -4, 4))
            anch = jnp.stack([points[:, 0] - w / 2, points[:, 1] - h / 2,
                              points[:, 0] + w / 2, points[:, 1] + h / 2],
                             -1)
            sc = jax.nn.sigmoid(c) * (jax.nn.sigmoid(l)
                                      > self.loc_filter_thr)[:, None]
            k = min(nms_pre, sc.shape[0])
            _, ti = jax.lax.top_k(jnp.max(sc, -1), k)
            boxes = self.coder.decode(anch[ti], r[ti],
                                      max_shape=(shape[0], shape[1]))
            if rescale:
                boxes = boxes / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            pad = jnp.concatenate([sc[ti],
                                   jnp.zeros((k, 1))], -1)
            return multiclass_nms(boxes, pad, score_thr, iou_thr,
                                  max_per_img, self.num_classes)

        return jax.vmap(one)(cls, reg, shp, loc, img_shapes, scale_factors)


@HEADS.register_module()
class SABLRetinaHead(nn.Module):
    """Side-Aware Boundary Localization (reference sabl_retina_head.py:21):
    square approx anchors; per-side bucket classification + in-bucket
    offset regression."""
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 4
    strides: Sequence[int] = (8, 16, 32, 64, 128)
    approx_anchor_generator: Any = None
    square_anchor_generator: Any = None
    num_buckets: int = 14
    scale_factor: float = 3.0
    loss_cls: Any = None
    loss_bbox_cls: Any = None
    loss_bbox_reg: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        sq = dict(self.square_anchor_generator or dict(
            ratios=[1.0], scales=[4], strides=list(self.strides)))
        sq.pop("type", None)
        self.prior_gen = AnchorGenerator(**sq)
        # approx anchors for assignment (reference sabl_retina_head.py:
        # ApproxMaxIoUAssigner over octave_base_scale x scales_per_octave
        # x ratios approxes per square location)
        ap = dict(self.approx_anchor_generator or dict(
            octave_base_scale=4, scales_per_octave=3,
            ratios=[0.5, 1.0, 2.0], strides=list(self.strides)))
        ap.pop("type", None)
        self.approx_gen = AnchorGenerator(**ap)
        self.approxs_per_octave = self.approx_gen.num_base_anchors[0]
        self.l_cls = build_from_cfg(dict(self.loss_cls or dict(
            type="FocalLoss", gamma=2.0, alpha=0.25, loss_weight=1.0)),
            LOSSES)
        tc = dict(self.train_cfg or {})
        asn = dict(tc.get("assigner", dict(pos_iou_thr=0.5,
                                           neg_iou_thr=0.4,
                                           min_pos_iou=0.0)))
        asn.pop("type", None)
        from ...core.bbox.assign_sample import ApproxMaxIoUAssigner
        self.assigner = ApproxMaxIoUAssigner(**asn)
        self.cls_convs = [Conv(self.feat_channels, 3, 1, 1,
                               dtype=self.dtype, name=f"cls_conv{i}")
                          for i in range(self.stacked_convs)]
        self.reg_convs = [Conv(self.feat_channels, 3, 1, 1,
                               dtype=self.dtype, name=f"reg_conv{i}")
                          for i in range(self.stacked_convs)]
        self.retina_cls = Conv(self.num_classes, 3, 1, 1, dtype=self.dtype)
        # per-side bucket cls (4 sides x buckets) and offsets
        self.bucket_cls = Conv(self.num_buckets * 4, 3, 1, 1,
                               dtype=self.dtype)
        self.bucket_reg = Conv(self.num_buckets * 4, 3, 1, 1,
                               dtype=self.dtype)

    def __call__(self, feats):
        cls_scores, bcls, breg = [], [], []
        for x in feats:
            c = r = x
            for conv in self.cls_convs:
                c = nn.relu(conv(c))
            for conv in self.reg_convs:
                r = nn.relu(conv(r))
            cls_scores.append(self.retina_cls(c).astype(jnp.float32))
            bcls.append(self.bucket_cls(r).astype(jnp.float32))
            breg.append(self.bucket_reg(r).astype(jnp.float32))
        return cls_scores, bcls, breg

    def _bucket_edges(self, anchors):
        """Per-anchor bucket edge positions for each side: (N, 4, buckets).
        Side order: left, right, top, bottom (reference bucketing coder)."""
        nb = self.num_buckets
        w = (anchors[:, 2] - anchors[:, 0]) * self.scale_factor
        h = (anchors[:, 3] - anchors[:, 1]) * self.scale_factor
        cx = (anchors[:, 0] + anchors[:, 2]) * 0.5
        cy = (anchors[:, 1] + anchors[:, 3]) * 0.5
        bw = w / nb
        bh = h / nb
        steps = jnp.arange(nb, dtype=jnp.float32) + 0.5
        left = cx[:, None] - w[:, None] / 2 + steps[None] * bw[:, None]
        top = cy[:, None] - h[:, None] / 2 + steps[None] * bh[:, None]
        return left, top, bw, bh

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bcls, breg = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_gen.grid_priors_cat(featmap_sizes)
        cls = jnp.concatenate([c.reshape(n, -1, self.num_classes)
                               for c in cls_scores], 1)
        bc = jnp.concatenate([c.reshape(n, -1, 4, self.num_buckets)
                              for c in bcls], 1)
        br = jnp.concatenate([c.reshape(n, -1, 4, self.num_buckets)
                              for c in breg], 1)
        left, top, bw, bh = self._bucket_edges(anchors)
        approxs = self.approx_gen.grid_priors_cat(featmap_sizes)

        def one(gt, gtv, gtl):
            a = self.assigner.assign(approxs, anchors,
                                     self.approxs_per_octave, gt, gtv,
                                     gt_labels=gtl)
            pos = a.gt_inds > 0
            gi = jnp.clip(a.gt_inds - 1, 0, gt.shape[0] - 1)
            labels = jnp.where(pos, gtl[gi], self.num_classes)
            neg = a.gt_inds == 0
            tgt = gt[gi]
            # bucket targets: nearest edge bucket + in-bucket offset
            def side(edges, coord, width):
                d = jnp.abs(edges - coord[:, None])       # (N, nb)
                b = jnp.argmin(d, -1)
                off = (coord - jnp.take_along_axis(
                    edges, b[:, None], 1)[:, 0]) / jnp.maximum(width, 1e-6)
                return b, off
            bl, ol = side(left, tgt[:, 0], bw)
            br_, or_ = side(left, tgt[:, 2], bw)
            bt, ot = side(top, tgt[:, 1], bh)
            bb, ob = side(top, tgt[:, 3], bh)
            bidx = jnp.stack([bl, br_, bt, bb], -1)       # (N, 4)
            boff = jnp.stack([ol, or_, ot, ob], -1)
            return (labels.astype(jnp.int32), pos, neg,
                    bidx.astype(jnp.int32), boff)

        labels, pos, neg, bidx, boff = jax.vmap(one)(gt_bboxes, gt_valid,
                                                     gt_labels)
        npos = jnp.maximum(jnp.sum(pos), 1.0)
        cw = (pos | neg).astype(jnp.float32)
        loss_cls = self.l_cls(cls.reshape(-1, self.num_classes),
                              labels.reshape(-1), cw.reshape(-1),
                              avg_factor=npos)
        # bucket CE
        logp = jax.nn.log_softmax(bc, -1)
        nll = -jnp.take_along_axis(logp, bidx[..., None], -1)[..., 0]
        posf = pos.astype(jnp.float32)[..., None]
        loss_bcls = jnp.sum(nll * posf) / (npos * 4)
        # offset smooth l1 at the target bucket
        osel = jnp.take_along_axis(br, bidx[..., None], -1)[..., 0]
        d = jnp.abs(osel - boff)
        sl1 = jnp.where(d < 1.0 / 9.0, 4.5 * d * d, d - 1.0 / 18.0)
        loss_breg = jnp.sum(sl1 * posf) / (npos * 4)
        return dict(loss_cls=loss_cls, loss_bbox_cls=loss_bcls * 1.5,
                    loss_bbox_reg=loss_breg * 1.5)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_scores, bcls, breg = outs
        cfg = dict(cfg or self.test_cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.5))
        max_per_img = int(cfg.get("max_per_img", 100))
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_gen.grid_priors_cat(featmap_sizes)
        cls = jnp.concatenate([c.reshape(n, -1, self.num_classes)
                               for c in cls_scores], 1)
        bc = jnp.concatenate([c.reshape(n, -1, 4, self.num_buckets)
                              for c in bcls], 1)
        br = jnp.concatenate([c.reshape(n, -1, 4, self.num_buckets)
                              for c in breg], 1)
        left, top, bw, bh = self._bucket_edges(anchors)

        def one(c, bci, bri, shape, sf):
            sc = jax.nn.sigmoid(c)
            k = min(nms_pre, sc.shape[0])
            _, ti = jax.lax.top_k(jnp.max(sc, -1), k)
            bsel = jnp.argmax(bci[ti], -1)                # (k, 4)
            osel = jnp.take_along_axis(bri[ti], bsel[..., None],
                                       -1)[..., 0]
            lt = left[ti]
            tp = top[ti]
            x1 = (jnp.take_along_axis(lt, bsel[:, 0:1], 1)[:, 0]
                  + osel[:, 0] * bw[ti])
            x2 = (jnp.take_along_axis(lt, bsel[:, 1:2], 1)[:, 0]
                  + osel[:, 1] * bw[ti])
            y1 = (jnp.take_along_axis(tp, bsel[:, 2:3], 1)[:, 0]
                  + osel[:, 2] * bh[ti])
            y2 = (jnp.take_along_axis(tp, bsel[:, 3:4], 1)[:, 0]
                  + osel[:, 3] * bh[ti])
            boxes = jnp.stack([x1, y1, x2, y2], -1)
            boxes = jnp.clip(boxes, 0, jnp.asarray(
                [shape[1], shape[0], shape[1], shape[0]], jnp.float32))
            if rescale:
                boxes = boxes / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            pad = jnp.concatenate([sc[ti], jnp.zeros((k, 1))], -1)
            return multiclass_nms(boxes, pad, score_thr, iou_thr,
                                  max_per_img, self.num_classes)

        return jax.vmap(one)(cls, bc, br, img_shapes, scale_factors)
