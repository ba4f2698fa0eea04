"""FoveaBox and FSAF anchor-free heads.

References: mmdet/models/dense_heads/fovea_head.py (FoveaHead),
mmdet/models/dense_heads/fsaf_head.py (FSAFHead, online feature selection),
mmdet/models/detectors/fovea.py, fsaf.py.

Notes: mmdet builds ragged per-gt index lists on CPU; here both
heads use per-point x per-gt candidate matrices (static shapes) like the
FCOS head. FSAF's online feature selection — pick, per gt, the pyramid
level with the lowest (cls+reg) loss over the gt's effective region — is a
static reduction over the 5 levels instead of a data-dependent gather.
"""
from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.bbox.geometry import bbox_overlaps
from ...core.bbox.transforms import distance2bbox
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv

INF = 1e8


def _level_points(featmap_sizes, strides, offset=0.5):
    # jnp (staged iota), not numpy: a host grid would embed a dense
    # (sum HW, 2) constant in the HLO (see core/anchor docstring)
    pts, sids = [], []
    for li, ((h, w), s) in enumerate(zip(featmap_sizes, strides)):
        xs = (jnp.arange(w, dtype=jnp.float32) + offset) * s
        ys = (jnp.arange(h, dtype=jnp.float32) + offset) * s
        px = jnp.broadcast_to(xs[None, :], (h, w)).reshape(-1)
        py = jnp.broadcast_to(ys[:, None], (h, w)).reshape(-1)
        pts.append(jnp.stack([px, py], -1))
        sids.append(jnp.full((h * w,), li, jnp.int32))
    return jnp.concatenate(pts), jnp.concatenate(sids)


@HEADS.register_module()
class FoveaHead(nn.Module):
    """FoveaBox (reference fovea_head.py): per-point classification inside
    a sigma-shrunk 'fovea' of each gt, log-space edge-offset regression
    normalized by per-level base_edge."""
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 4
    strides: Sequence[int] = (8, 16, 32, 64, 128)
    base_edge_list: Sequence[int] = (16, 32, 64, 128, 256)
    scale_ranges: Sequence = ((1, 64), (32, 128), (64, 256), (128, 512),
                              (256, 2048))
    sigma: float = 0.4
    loss_cls: Any = None
    loss_bbox: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        self.l_cls = build_from_cfg(dict(self.loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=1.5, alpha=0.4,
            loss_weight=1.0)), LOSSES)
        self.l_bbox = build_from_cfg(dict(self.loss_bbox or dict(
            type="SmoothL1Loss", beta=0.11, loss_weight=1.0)), LOSSES)
        self.cls_convs = [Conv(self.feat_channels, 3, 1, 1, dtype=self.dtype,
                               name=f"cls_conv{i}")
                          for i in range(self.stacked_convs)]
        self.reg_convs = [Conv(self.feat_channels, 3, 1, 1, dtype=self.dtype,
                               name=f"reg_conv{i}")
                          for i in range(self.stacked_convs)]
        self.conv_cls = Conv(self.num_classes, 3, 1, 1, dtype=self.dtype)
        self.conv_reg = Conv(4, 3, 1, 1, dtype=self.dtype)

    def __call__(self, feats):
        cls_scores, bbox_preds = [], []
        for x in feats:
            c = r = x
            for conv in self.cls_convs:
                c = nn.relu(conv(c))
            for conv in self.reg_convs:
                r = nn.relu(conv(r))
            cls_scores.append(self.conv_cls(c))
            bbox_preds.append(self.conv_reg(r))
        return (cls_scores, bbox_preds)

    def _targets_single(self, points, sids, base, ranges, gt, gtv, gtl):
        px, py = points[:, 0:1], points[:, 1:2]
        cx = (gt[None, :, 0] + gt[None, :, 2]) * 0.5
        cy = (gt[None, :, 1] + gt[None, :, 3]) * 0.5
        gw = gt[None, :, 2] - gt[None, :, 0]
        gh = gt[None, :, 3] - gt[None, :, 1]
        # fovea (sigma-shrunk) region
        in_fovea = ((px >= cx - 0.5 * self.sigma * gw)
                    & (px <= cx + 0.5 * self.sigma * gw)
                    & (py >= cy - 0.5 * self.sigma * gh)
                    & (py <= cy + 0.5 * self.sigma * gh))
        scale = jnp.sqrt(jnp.maximum(gw * gh, 1e-6))[0]          # (G,)
        lo, hi = ranges[:, 0], ranges[:, 1]                       # per point
        in_range = ((scale[None, :] >= lo[:, None])
                    & (scale[None, :] <= hi[:, None]))
        cand = in_fovea & in_range & gtv[None, :]
        area = (gw * gh)[0][None, :]
        area_m = jnp.where(cand, area, INF)
        gi = jnp.argmin(area_m, -1)
        pos = jnp.min(area_m, -1) < INF
        labels = jnp.where(pos, gtl[gi], self.num_classes).astype(jnp.int32)
        g = gt[gi]                                               # (P, 4)
        b = base[:, None]
        tgt = jnp.stack([
            jnp.log(jnp.clip((px[:, 0] - g[:, 0]) / b[:, 0], 1 / 16, 16)),
            jnp.log(jnp.clip((py[:, 0] - g[:, 1]) / b[:, 0], 1 / 16, 16)),
            jnp.log(jnp.clip((g[:, 2] - px[:, 0]) / b[:, 0], 1 / 16, 16)),
            jnp.log(jnp.clip((g[:, 3] - py[:, 0]) / b[:, 0], 1 / 16, 16)),
        ], -1)
        return labels, tgt, pos

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, sids = _level_points(featmap_sizes, self.strides)
        base = jnp.asarray(np.asarray(self.base_edge_list,
                                      np.float32))[sids]
        ranges = jnp.asarray(np.asarray(self.scale_ranges,
                                        np.float32))[sids]
        cls = jnp.concatenate([s.reshape(n, -1, self.num_classes)
                               for s in cls_scores], 1).astype(jnp.float32)
        reg = jnp.concatenate([b.reshape(n, -1, 4)
                               for b in bbox_preds], 1).astype(jnp.float32)
        labels, tgt, pos = jax.vmap(
            lambda g, v, lb: self._targets_single(points, sids, base, ranges,
                                                  g, v, lb))(
            gt_bboxes, gt_valid, gt_labels)
        num_pos = jnp.maximum(jnp.sum(pos), 1.0)
        loss_cls = self.l_cls(cls.reshape(-1, self.num_classes),
                              labels.reshape(-1), avg_factor=num_pos)
        bw = pos.astype(jnp.float32)[..., None] * jnp.ones((1, 1, 4))
        loss_bbox = self.l_bbox(reg, tgt, bw, avg_factor=num_pos * 4)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_scores, bbox_preds = outs
        cfg = dict(cfg or self.test_cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.5))
        max_per_img = int(cfg.get("max_per_img", 100))
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, sids = _level_points(featmap_sizes, self.strides)
        sizes = [h * w for h, w in featmap_sizes]
        offs = np.concatenate([[0], np.cumsum(sizes)])

        def one(cls_l, reg_l, shape, sf):
            boxes_all, scores_all = [], []
            for li in range(len(cls_l)):
                sc = jax.nn.sigmoid(cls_l[li].reshape(-1, self.num_classes)
                                    .astype(jnp.float32))
                rg = jnp.exp(reg_l[li].reshape(-1, 4).astype(jnp.float32))
                pts = points[offs[li]:offs[li + 1]]
                b = float(self.base_edge_list[li])
                k = min(nms_pre, sc.shape[0])
                _, ti = jax.lax.top_k(jnp.max(sc, -1), k)
                rgk = rg[ti] * b
                boxes = jnp.stack([
                    pts[ti, 0] - rgk[:, 0], pts[ti, 1] - rgk[:, 1],
                    pts[ti, 0] + rgk[:, 2], pts[ti, 1] + rgk[:, 3]], -1)
                boxes = jnp.clip(boxes,
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

        return jax.vmap(one)(tuple(cls_scores), tuple(bbox_preds),
                             img_shapes, scale_factors)


@HEADS.register_module()
class FSAFHead(nn.Module):
    """FSAF (reference fsaf_head.py): anchor-free branch with effective /
    ignore regions and online (min-loss) feature-level selection per gt.

    Per level, a point inside a gt's effective box (0.2-shrunk) is a
    positive candidate; points inside the ignore box (0.5-shrunk) but not
    effective get zero cls weight. Per gt, the level whose candidates give
    the lowest mean focal+IoU loss is selected; other levels' candidates
    for that gt revert to background.
    """
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 4
    strides: Sequence[int] = (8, 16, 32, 64, 128)
    effective_fraction: float = 0.2
    ignore_fraction: float = 0.5
    loss_cls: Any = None
    loss_bbox: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        self.l_cls = build_from_cfg(dict(self.loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0)), LOSSES)
        self.l_bbox = build_from_cfg(dict(self.loss_bbox or dict(
            type="IoULoss", eps=1e-6, loss_weight=1.0)), LOSSES)
        self.cls_convs = [Conv(self.feat_channels, 3, 1, 1, dtype=self.dtype,
                               name=f"cls_conv{i}")
                          for i in range(self.stacked_convs)]
        self.reg_convs = [Conv(self.feat_channels, 3, 1, 1, dtype=self.dtype,
                               name=f"reg_conv{i}")
                          for i in range(self.stacked_convs)]
        self.conv_cls = Conv(self.num_classes, 3, 1, 1, dtype=self.dtype)
        self.conv_reg = Conv(4, 3, 1, 1, dtype=self.dtype)

    def __call__(self, feats):
        cls_scores, bbox_preds = [], []
        for x in feats:
            c = r = x
            for conv in self.cls_convs:
                c = nn.relu(conv(c))
            for conv in self.reg_convs:
                r = nn.relu(conv(r))
            cls_scores.append(self.conv_cls(c))
            # FSAF regresses positive normalized distances (relu + eps)
            bbox_preds.append(nn.relu(self.conv_reg(r)) + 1e-4)
        return (cls_scores, bbox_preds)

    def _region_mask(self, points, gt, frac):
        px, py = points[:, 0:1], points[:, 1:2]
        cx = (gt[None, :, 0] + gt[None, :, 2]) * 0.5
        cy = (gt[None, :, 1] + gt[None, :, 3]) * 0.5
        gw = gt[None, :, 2] - gt[None, :, 0]
        gh = gt[None, :, 3] - gt[None, :, 1]
        return ((px >= cx - 0.5 * frac * gw) & (px <= cx + 0.5 * frac * gw)
                & (py >= cy - 0.5 * frac * gh)
                & (py <= cy + 0.5 * frac * gh))

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, sids = _level_points(featmap_sizes, self.strides)
        strides = jnp.asarray(np.asarray(self.strides, np.float32))[sids]
        nl = len(self.strides)
        cls = jnp.concatenate([s.reshape(n, -1, self.num_classes)
                               for s in cls_scores], 1).astype(jnp.float32)
        reg = jnp.concatenate([b.reshape(n, -1, 4)
                               for b in bbox_preds], 1).astype(jnp.float32)

        def one(cls_i, reg_i, gt, gtv, gtl):
            eff = self._region_mask(points, gt, self.effective_fraction)
            ign = self._region_mask(points, gt, self.ignore_fraction)
            eff = eff & gtv[None, :]
            ign = ign & gtv[None, :]
            # per-candidate losses (decoded IoU + focal on the gt class)
            pred_box = distance2bbox(points, reg_i * strides[:, None] * 4.0)
            ious = bbox_overlaps(pred_box, gt, is_aligned=False)  # (P,G)
            reg_l = -jnp.log(jnp.clip(ious, 1e-6, 1.0))
            p = jax.nn.sigmoid(cls_i)                            # (P,C)
            pg = jnp.take_along_axis(
                jnp.broadcast_to(p[:, None, :],
                                 (p.shape[0], gt.shape[0], p.shape[1])),
                jnp.broadcast_to(gtl[None, :, None], (p.shape[0],
                                                      gt.shape[0], 1)),
                axis=2)[..., 0]
            cls_l = -jnp.log(jnp.clip(pg, 1e-6, 1.0))
            tot = cls_l + reg_l                                  # (P,G)
            # per-level mean candidate loss per gt -> select min level
            lvl_loss = []
            for li in range(nl):
                m = eff & (sids == li)[:, None]
                cnt = jnp.maximum(jnp.sum(m, 0), 1)
                lvl_loss.append(jnp.sum(jnp.where(m, tot, 0.0), 0) / cnt)
            lvl_loss = jnp.stack(lvl_loss, 0)                    # (L,G)
            has = jnp.stack([jnp.any(eff & (sids == li)[:, None], 0)
                             for li in range(nl)], 0)
            sel = jnp.argmin(jnp.where(has, lvl_loss, INF), 0)   # (G,)
            eff_sel = eff & (sids[:, None] == sel[None, :])
            # point -> smallest selected gt
            area = ((gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]))[None, :]
            area_m = jnp.where(eff_sel, area, INF)
            gi = jnp.argmin(area_m, -1)
            pos = jnp.min(area_m, -1) < INF
            labels = jnp.where(pos, gtl[gi],
                               self.num_classes).astype(jnp.int32)
            ignored = jnp.any(ign, -1) & ~pos
            iou_pos = jnp.take_along_axis(ious, gi[:, None], 1)[:, 0]
            return labels, pos, ignored, iou_pos

        labels, pos, ignored, iou_pos = jax.vmap(one)(
            cls, reg, gt_bboxes, gt_valid, gt_labels)
        num_pos = jnp.maximum(jnp.sum(pos), 1.0)
        cw = (~ignored).astype(jnp.float32)
        loss_cls = self.l_cls(cls.reshape(-1, self.num_classes),
                              labels.reshape(-1), cw.reshape(-1),
                              avg_factor=num_pos)
        loss_bbox = (self.l_bbox.loss_weight
                     * jnp.sum(-jnp.log(jnp.clip(iou_pos, 1e-6, 1.0))
                               * pos.astype(jnp.float32)) / num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_scores, bbox_preds = outs
        cfg = dict(cfg or self.test_cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.5))
        max_per_img = int(cfg.get("max_per_img", 100))
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, sids = _level_points(featmap_sizes, self.strides)
        sizes = [h * w for h, w in featmap_sizes]
        offs = np.concatenate([[0], np.cumsum(sizes)])

        def one(cls_l, reg_l, shape, sf):
            boxes_all, scores_all = [], []
            for li in range(len(cls_l)):
                sc = jax.nn.sigmoid(cls_l[li].reshape(-1, self.num_classes)
                                    .astype(jnp.float32))
                rg = reg_l[li].reshape(-1, 4).astype(jnp.float32)
                pts = points[offs[li]:offs[li + 1]]
                k = min(nms_pre, sc.shape[0])
                _, ti = jax.lax.top_k(jnp.max(sc, -1), k)
                boxes = distance2bbox(pts[ti],
                                      rg[ti] * self.strides[li] * 4.0,
                                      max_shape=(shape[0], shape[1]))
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

        return jax.vmap(one)(tuple(cls_scores), tuple(bbox_preds),
                             img_shapes, scale_factors)


@DETECTORS.register_module()
class FOVEA(SingleStageDetector):
    """Alias (reference mmdet/models/detectors/fovea.py)."""
    pass


@DETECTORS.register_module()
class FSAF(SingleStageDetector):
    """Alias (reference mmdet/models/detectors/fsaf.py)."""
    pass
