"""RepPoints head + detector (reference
mmdet/models/dense_heads/reppoints_head.py,
mmdet/models/detectors/reppoints_detector.py,
core/bbox/assigners/point_assigner.py).

Point-set representation: an initial 9-point set regressed per location
feeds a 3x3 deform conv (the points ARE the conv taps) for classification
and point refinement. points->box via the 'moment' transform (learnable
std multiplier). Init stage assigned by scale-matched nearest points
(PointAssigner), refine stage by MaxIoU on the init boxes — both as static
(P, G) selection matrices instead of mmdet's per-gt index lists.
"""
from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.bbox.assign_sample import MaxIoUAssigner
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, DeformConv, GroupNorm32
from .fovea_fsaf_heads import _level_points

INF = 1e8


@HEADS.register_module()
class RepPointsHead(nn.Module):
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 256
    point_feat_channels: int = 256
    stacked_convs: int = 3
    num_points: int = 9
    gradient_mul: float = 0.1
    point_strides: Sequence[int] = (8, 16, 32, 64, 128)
    point_base_scale: int = 4
    transform_method: str = "moment"
    moment_mul: float = 0.01
    loss_cls: Any = None
    loss_bbox_init: Any = None
    loss_bbox: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        assert self.num_points == 9, "3x3 dcn grid"
        self.l_cls = build_from_cfg(dict(self.loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0)), LOSSES)
        self.l_init = build_from_cfg(dict(self.loss_bbox_init or dict(
            type="SmoothL1Loss", beta=0.11, loss_weight=0.5)), LOSSES)
        self.l_refine = build_from_cfg(dict(self.loss_bbox or dict(
            type="SmoothL1Loss", beta=0.11, loss_weight=1.0)), LOSSES)
        tc = dict(self.train_cfg or {})
        ref = dict(dict(tc.get("refine", {})).get(
            "assigner", dict(pos_iou_thr=0.5, neg_iou_thr=0.4,
                             min_pos_iou=0)))
        ref.pop("type", None)
        self.refine_assigner = MaxIoUAssigner(**ref)
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
        pts = 2 * self.num_points
        self.pts_init_conv = Conv(self.point_feat_channels, 3, 1, 1,
                                  dtype=self.dtype)
        self.pts_init_out = Conv(pts, 1, 1, 0, dtype=self.dtype)
        self.cls_dconv = DeformConv(self.point_feat_channels, 3, padding=1)
        self.cls_gn_out = GroupNorm32()
        self.cls_out = Conv(self.num_classes, 1, 1, 0, dtype=self.dtype)
        self.pts_refine_dconv = DeformConv(self.point_feat_channels, 3,
                                           padding=1)
        self.pts_refine_gn = GroupNorm32()
        self.pts_refine_out = Conv(pts, 1, 1, 0, dtype=self.dtype)
        self.moment_transfer = self.param("moment_transfer",
                                          nn.initializers.zeros, (2,))

    # dcn base grid (dy,dx per tap, row-major) to subtract from point offsets
    _base = np.array([(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1),
                      (1, -1), (1, 0), (1, 1)], np.float32).reshape(-1)

    def points2bbox(self, pts):
        """pts: (..., 2*num_points) (dy,dx interleaved, feature units
        scaled by stride outside). Returns (..., 4) xyxy."""
        p = pts.reshape(pts.shape[:-1] + (self.num_points, 2))
        y, x = p[..., 0], p[..., 1]
        if self.transform_method == "minmax":
            return jnp.stack([x.min(-1), y.min(-1), x.max(-1), y.max(-1)],
                             -1)
        mx, my = x.mean(-1), y.mean(-1)
        sx = jnp.sqrt(jnp.maximum(((x - mx[..., None]) ** 2).mean(-1),
                                  1e-12))
        sy = jnp.sqrt(jnp.maximum(((y - my[..., None]) ** 2).mean(-1),
                                  1e-12))
        mt = (self.moment_transfer * self.moment_mul
              + jax.lax.stop_gradient(self.moment_transfer)
              * (1 - self.moment_mul))
        hw = sx * jnp.exp(mt[0])
        hh = sy * jnp.exp(mt[1])
        return jnp.stack([mx - hw, my - hh, mx + hw, my + hh], -1)

    def __call__(self, feats):
        cls_scores, pts_inits, pts_refines = [], [], []
        base = jnp.asarray(self._base)
        for x in feats:
            c = r = x
            for conv, gn in zip(self.cls_convs, self.cls_gns):
                c = nn.relu(gn(conv(c)))
            for conv, gn in zip(self.reg_convs, self.reg_gns):
                r = nn.relu(gn(conv(r)))
            init = self.pts_init_out(
                nn.relu(self.pts_init_conv(r))).astype(jnp.float32)
            grad_mul = (self.gradient_mul * init
                        + (1 - self.gradient_mul)
                        * jax.lax.stop_gradient(init))
            dcn_off = grad_mul - base
            c2 = nn.relu(self.cls_gn_out(self.cls_dconv(c, dcn_off)))
            cls_scores.append(self.cls_out(c2))
            r2 = nn.relu(self.pts_refine_gn(self.pts_refine_dconv(r,
                                                                  dcn_off)))
            refine = (self.pts_refine_out(r2).astype(jnp.float32)
                      + jax.lax.stop_gradient(init))
            pts_inits.append(init)
            pts_refines.append(refine)
        return cls_scores, pts_inits, pts_refines

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, pts_inits, pts_refines = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, sids = _level_points(featmap_sizes, self.point_strides)
        strides_pp = jnp.asarray(np.asarray(self.point_strides,
                                            np.float32))[sids]
        cls = jnp.concatenate([s.reshape(n, -1, self.num_classes)
                               for s in cls_scores], 1).astype(jnp.float32)
        pin = jnp.concatenate([p.reshape(n, -1, 2 * self.num_points)
                               for p in pts_inits], 1)
        pre = jnp.concatenate([p.reshape(n, -1, 2 * self.num_points)
                               for p in pts_refines], 1)
        # boxes in image units: center + stride-scaled point spread
        def to_boxes(p):
            b = self.points2bbox(p)                             # (B,P,4)
            ctr = jnp.concatenate([points[None], points[None]], -1)
            return b * strides_pp[None, :, None] + ctr
        box_init = to_boxes(pin)
        box_refine = to_boxes(pre)
        nl = len(self.point_strides)

        def one(gt, gtv, gtl, binit):
            # ---- init: scale-matched nearest-point assignment
            gw = gt[:, 2] - gt[:, 0]
            gh = gt[:, 3] - gt[:, 1]
            scale = jnp.sqrt(jnp.maximum(gw * gh, 1e-6))
            lvl = jnp.clip(jnp.floor(
                jnp.log2(scale / self.point_base_scale + 1e-6) - 1),
                0, nl - 1).astype(jnp.int32)                    # (G,)
            gcx = (gt[:, 0] + gt[:, 2]) * 0.5
            gcy = (gt[:, 1] + gt[:, 3]) * 0.5
            d = (jnp.abs(points[:, 0:1] - gcx[None])
                 + jnp.abs(points[:, 1:2] - gcy[None]))         # (P,G)
            on_lvl = sids[:, None] == lvl[None, :]
            d = jnp.where(on_lvl & gtv[None, :], d, INF)
            nearest = jnp.argmin(d, 0)                          # (G,)
            sel = (jnp.arange(points.shape[0])[:, None]
                   == nearest[None, :]) & gtv[None, :]          # (P,G)
            # later gt wins on conflict (reference assigns sequentially)
            gi_init = jnp.where(jnp.any(sel, -1),
                                (sel * jnp.arange(1, gt.shape[0] + 1)
                                 [None, :]).max(-1) - 1, 0)
            pos_init = jnp.any(sel, -1)
            # ---- refine: MaxIoU on init boxes
            a = self.refine_assigner.assign(binit, gt, gtv, gt_labels=gtl)
            pos_ref = a.gt_inds > 0
            gi_ref = jnp.clip(a.gt_inds - 1, 0, gt.shape[0] - 1)
            labels = jnp.where(pos_ref, gtl[gi_ref], self.num_classes)
            return (gi_init.astype(jnp.int32), pos_init,
                    labels.astype(jnp.int32), pos_ref,
                    gi_ref.astype(jnp.int32))

        gi_i, pos_i, labels, pos_r, gi_r = jax.vmap(one)(
            gt_bboxes, gt_valid, gt_labels, box_init)
        norm = (self.point_base_scale * strides_pp)[None, :, None]
        tgt_i = jnp.take_along_axis(gt_bboxes, gi_i[..., None], 1)
        tgt_r = jnp.take_along_axis(gt_bboxes, gi_r[..., None], 1)
        np_i = jnp.maximum(jnp.sum(pos_i), 1.0)
        np_r = jnp.maximum(jnp.sum(pos_r), 1.0)
        wi = pos_i.astype(jnp.float32)[..., None] * jnp.ones((1, 1, 4))
        wr = pos_r.astype(jnp.float32)[..., None] * jnp.ones((1, 1, 4))
        loss_init = self.l_init(box_init / norm, tgt_i / norm, wi,
                                avg_factor=np_i * 4)
        loss_refine = self.l_refine(box_refine / norm, tgt_r / norm, wr,
                                    avg_factor=np_r * 4)
        loss_cls = self.l_cls(cls.reshape(-1, self.num_classes),
                              labels.reshape(-1), avg_factor=np_r)
        return dict(loss_cls=loss_cls, loss_pts_init=loss_init,
                    loss_pts_refine=loss_refine)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_scores, _, pts_refines = outs
        cfg = dict(cfg or self.test_cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.5))
        max_per_img = int(cfg.get("max_per_img", 100))
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, _ = _level_points(featmap_sizes, self.point_strides)
        sizes = [h * w for h, w in featmap_sizes]
        offs = np.concatenate([[0], np.cumsum(sizes)])

        def one(cls_l, pts_l, shape, sf):
            boxes_all, scores_all = [], []
            for li in range(len(cls_l)):
                sc = jax.nn.sigmoid(cls_l[li].reshape(-1, self.num_classes)
                                    .astype(jnp.float32))
                pt = pts_l[li].reshape(-1, 2 * self.num_points)
                pp = points[offs[li]:offs[li + 1]]
                b = (self.points2bbox(pt) * float(self.point_strides[li])
                     + jnp.concatenate([pp, pp], -1))
                k = min(nms_pre, sc.shape[0])
                _, ti = jax.lax.top_k(jnp.max(sc, -1), k)
                boxes = jnp.clip(b[ti],
                                 0, jnp.asarray([shape[1], shape[0],
                                                 shape[1], shape[0]],
                                                jnp.float32))
                boxes_all.append(boxes)
                scores_all.append(sc[ti])
            boxes = jnp.concatenate(boxes_all)
            scores = jnp.concatenate(scores_all)
            if rescale:
                boxes = boxes / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            pad = jnp.concatenate([scores,
                                   jnp.zeros((scores.shape[0], 1))], -1)
            return multiclass_nms(boxes, pad, score_thr, iou_thr,
                                  max_per_img, self.num_classes)

        return jax.vmap(one)(tuple(cls_scores), tuple(pts_refines),
                             img_shapes, scale_factors)


@DETECTORS.register_module()
class RepPointsDetector(SingleStageDetector):
    """Alias (reference mmdet/models/detectors/reppoints_detector.py)."""
    pass
