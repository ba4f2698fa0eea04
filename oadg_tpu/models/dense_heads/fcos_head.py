"""FCOS head (reference mmdet/models/dense_heads/fcos_head.py):
anchor-free per-point prediction with centerness, static-shape targets.

Target rule (reference FCOSHead.get_targets): a point is positive for the
smallest-area gt box that contains it AND whose max regression distance
falls in the level's regress_range; centerness =
sqrt((min(l,r)/max(l,r)) * (min(t,b)/max(t,b))).
"""
from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.bbox.transforms import distance2bbox
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import HEADS, LOSSES, build_from_cfg
from ..layers import Conv, GroupNorm32

INF = 1e8


@HEADS.register_module()
class FCOSHead(nn.Module):
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 4
    strides: Sequence[int] = (8, 16, 32, 64, 128)
    regress_ranges: Sequence = ((-1, 64), (64, 128), (128, 256), (256, 512),
                                (512, INF))
    center_sampling: bool = False
    norm_on_bbox: bool = False
    centerness_on_reg: bool = False
    loss_cls: Any = None
    loss_bbox: Any = None
    loss_centerness: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        self.l_cls = build_from_cfg(dict(self.loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0)), LOSSES)
        self.l_bbox = build_from_cfg(dict(self.loss_bbox or dict(
            type="IoULoss", loss_weight=1.0)), LOSSES)
        self.l_ctr = build_from_cfg(dict(self.loss_centerness or dict(
            type="CrossEntropyLoss", use_sigmoid=True, loss_weight=1.0)),
            LOSSES)
        self.cls_convs = [Conv(self.feat_channels, 3, 1, 1, dtype=self.dtype,
                               name=f"cls_conv{i}")
                          for i in range(self.stacked_convs)]
        self.cls_gns = [GroupNorm32(name=f"cls_gn{i}")
                        for i in range(self.stacked_convs)]
        self.reg_convs = [Conv(self.feat_channels, 3, 1, 1, dtype=self.dtype,
                               name=f"reg_conv{i}")
                          for i in range(self.stacked_convs)]
        self.reg_gns = [GroupNorm32(name=f"reg_gn{i}")
                        for i in range(self.stacked_convs)]
        self.conv_cls = Conv(self.num_classes, 3, 1, 1, dtype=self.dtype)
        self.conv_reg = Conv(4, 3, 1, 1, dtype=self.dtype)
        self.conv_ctr = Conv(1, 3, 1, 1, dtype=self.dtype)
        self.scales = self.param("scales", nn.initializers.ones,
                                 (len(self.strides),))

    def __call__(self, feats):
        cls_scores, bbox_preds, ctrs = [], [], []
        for li, x in enumerate(feats):
            c = r = x
            for conv, gn in zip(self.cls_convs, self.cls_gns):
                c = nn.relu(gn(conv(c)))
            for conv, gn in zip(self.reg_convs, self.reg_gns):
                r = nn.relu(gn(conv(r)))
            cls_scores.append(self.conv_cls(c))
            bbox_preds.append(jnp.exp(self.scales[li]
                                      * self.conv_reg(r).astype(jnp.float32)))
            ctrs.append(self.conv_ctr(r if self.centerness_on_reg else c))
        return cls_scores, bbox_preds, ctrs

    def _points(self, featmap_sizes):
        # jnp (staged iota), not numpy: a host-side grid would embed a
        # (sum HW, 2) dense constant in the HLO (see core/anchor docstring)
        pts, strides = [], []
        for (h, w), s in zip(featmap_sizes, self.strides):
            xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) * s
            ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) * s
            px = jnp.broadcast_to(xs[None, :], (h, w)).reshape(-1)
            py = jnp.broadcast_to(ys[:, None], (h, w)).reshape(-1)
            pts.append(jnp.stack([px, py], -1))
            strides.append(jnp.full((h * w,), s, jnp.float32))
        return jnp.concatenate(pts), jnp.concatenate(strides)

    def _targets_single(self, points, ranges, gt, gtv, gtl):
        """(P, 2) points -> labels (P,), bbox_targets (P, 4), ctr (P,)."""
        px, py = points[:, 0:1], points[:, 1:2]                  # (P, 1)
        l = px - gt[None, :, 0]                                  # (P, G)
        t = py - gt[None, :, 1]
        r = gt[None, :, 2] - px
        b = gt[None, :, 3] - py
        ltrb = jnp.stack([l, t, r, b], -1)                       # (P, G, 4)
        inside = jnp.min(ltrb, -1) > 0.01
        maxd = jnp.max(ltrb, -1)
        in_range = (maxd >= ranges[:, 0:1]) & (maxd <= ranges[:, 1:2])
        area = ((gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]))[None, :]
        cand = inside & in_range & gtv[None, :]
        area_m = jnp.where(cand, area, INF)
        gi = jnp.argmin(area_m, -1)                              # (P,)
        pos = jnp.min(area_m, -1) < INF
        labels = jnp.where(pos, gtl[gi], self.num_classes)
        tgt = jnp.take_along_axis(ltrb, gi[:, None, None].repeat(4, -1),
                                  axis=1)[:, 0]                  # (P, 4)
        lr = tgt[:, [0, 2]]
        tb = tgt[:, [1, 3]]
        ctr = jnp.sqrt(jnp.clip(
            (jnp.min(lr, -1) / jnp.maximum(jnp.max(lr, -1), 1e-6))
            * (jnp.min(tb, -1) / jnp.maximum(jnp.max(tb, -1), 1e-6)), 0, 1))
        return labels.astype(jnp.int32), tgt, ctr, pos

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds, ctrs = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, strides = self._points(featmap_sizes)
        ranges = jnp.asarray(np.concatenate([
            np.tile(np.asarray(rr, np.float32)[None], (h * w, 1))
            for (h, w), rr in zip(featmap_sizes, self.regress_ranges)]))
        cls = jnp.concatenate([s.reshape(n, -1, self.num_classes)
                               for s in cls_scores], 1).astype(jnp.float32)
        reg = jnp.concatenate([b.reshape(n, -1, 4) for b in bbox_preds], 1)
        ctr = jnp.concatenate([c.reshape(n, -1) for c in ctrs],
                              1).astype(jnp.float32)

        labels, tgt, ctr_t, pos = jax.vmap(
            lambda g, v, lb: self._targets_single(points, ranges, g, v, lb))(
            gt_bboxes, gt_valid, gt_labels)
        num_pos = jnp.maximum(jnp.sum(pos), 1.0)
        loss_cls = self.l_cls(cls.reshape(-1, self.num_classes),
                              labels.reshape(-1), avg_factor=num_pos)
        # decoded IoU loss on positives
        pred_boxes = distance2bbox(jnp.broadcast_to(points[None], (n,) + points.shape),
                                   reg)
        tgt_boxes = distance2bbox(jnp.broadcast_to(points[None], (n,) + points.shape),
                                  tgt)
        w = pos.astype(jnp.float32) * jnp.maximum(ctr_t, 1e-6)
        denom = jnp.maximum(jnp.sum(w), 1e-6)
        loss_bbox = self.l_bbox(pred_boxes.reshape(-1, 4),
                                tgt_boxes.reshape(-1, 4),
                                weight=w.reshape(-1), avg_factor=denom)
        loss_ctr = self.l_ctr(ctr.reshape(-1), ctr_t.reshape(-1),
                              weight=pos.astype(jnp.float32).reshape(-1),
                              avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_centerness=loss_ctr)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_scores, bbox_preds, ctrs = outs
        cfg = dict(cfg or self.test_cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.5))
        max_per_img = int(cfg.get("max_per_img", 100))
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, _ = self._points(featmap_sizes)
        sizes = [h * w for h, w in featmap_sizes]
        offs = np.concatenate([[0], np.cumsum(sizes)])

        def one(cls_l, reg_l, ctr_l, shape, sf):
            boxes_all, scores_all = [], []
            for li in range(len(cls_l)):
                sc = jax.nn.sigmoid(cls_l[li].reshape(-1, self.num_classes)
                                    .astype(jnp.float32))
                cn = jax.nn.sigmoid(ctr_l[li].reshape(-1).astype(jnp.float32))
                rg = reg_l[li].reshape(-1, 4)
                pts = points[offs[li]:offs[li + 1]]
                k = min(nms_pre, sc.shape[0])
                top_s, ti = jax.lax.top_k(jnp.max(sc, -1) * cn, k)
                boxes = distance2bbox(pts[ti], rg[ti],
                                      max_shape=(shape[0], shape[1]))
                boxes_all.append(boxes)
                scores_all.append(sc[ti] * cn[ti, None])
            boxes = jnp.concatenate(boxes_all)
            scores = jnp.concatenate(scores_all)
            if rescale:
                boxes = boxes / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            pad = jnp.concatenate([scores,
                                   jnp.zeros((scores.shape[0], 1))], -1)
            return multiclass_nms(boxes, pad, score_thr, iou_thr,
                                  max_per_img, self.num_classes)

        return jax.vmap(one)(tuple(cls_scores), tuple(bbox_preds),
                             tuple(ctrs), img_shapes, scale_factors)


from ...utils.registry import DETECTORS  # noqa: E402
from ..detectors.single_stage import SingleStageDetector  # noqa: E402


@DETECTORS.register_module()
class FCOS(SingleStageDetector):
    """Alias detector (reference mmdet/models/detectors/fcos.py)."""
    pass
