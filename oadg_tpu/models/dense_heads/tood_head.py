"""TOOD head + detector (reference mmdet/models/dense_heads/tood_head.py,
mmdet/models/detectors/tood.py, core/bbox/assigners/task_aligned_assigner.py).

Task-aligned one-stage detection: shared inter-conv stack, per-task layer
attention (TaskDecomposition), probability-aligned classification
(geometric mean of logits and a spatial prob map), and offset-aligned
regression (each decoded box side bilinearly resampled at a learned
offset). Task-aligned assignment t = s^alpha * u^beta, top-k per gt, as a
static (P, G) mask.

Reference trains initial epochs with ATSS then switches to TAL
(tood_head.py initial_epoch); here TAL is used from the start — the
epoch-switch is a host-side knob (set ``initial_epoch=0`` semantics).
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
from ...ops.deform_conv import bilinear_gather
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, GroupNorm32
from .fovea_fsaf_heads import _level_points

INF = 1e8


class TaskDecomposition(nn.Module):
    """Layer attention over the stacked inter feats (reference
    tood_head.py:29)."""
    feat_channels: int
    stacked_convs: int
    dtype: Any = None

    @nn.compact
    def __call__(self, stacked, avg):
        # stacked: (B,H,W,stacked*C); avg: (B,1,1,stacked*C)
        c = self.feat_channels
        n = self.stacked_convs
        la = nn.relu(Conv(c // 4, 1, 1, 0, dtype=self.dtype,
                          name="la_conv1")(avg))
        la = jax.nn.sigmoid(Conv(n, 1, 1, 0, dtype=self.dtype,
                                 name="la_conv2")(la))          # (B,1,1,n)
        b, h, w, _ = stacked.shape
        s = stacked.reshape(b, h, w, n, c) * la[..., None]
        out = Conv(c, 1, 1, 0, dtype=self.dtype,
                   name="reduction_conv")(s.reshape(b, h, w, n * c))
        return nn.relu(GroupNorm32(name="gn")(out))


@HEADS.register_module()
class TOODHead(nn.Module):
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 6
    strides: Sequence[int] = (8, 16, 32, 64, 128)
    anchor_type: str = "anchor_free"
    alignment_topk: int = 13
    alignment_alpha: float = 1.0
    alignment_beta: float = 6.0
    loss_cls: Any = None
    loss_bbox: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        self.l_cls = build_from_cfg(dict(self.loss_cls or dict(
            type="QualityFocalLoss", use_sigmoid=True, beta=2.0,
            loss_weight=1.0)), LOSSES)
        self.l_bbox = build_from_cfg(dict(self.loss_bbox or dict(
            type="GIoULoss", loss_weight=2.0)), LOSSES)
        tc = dict(self.train_cfg or {})
        asn = dict(tc.get("assigner", {}))
        self.topk = int(asn.get("topk", self.alignment_topk))
        self.inter_convs = [Conv(self.feat_channels, 3, 1, 1,
                                 dtype=self.dtype, name=f"inter_conv{i}")
                            for i in range(self.stacked_convs)]
        self.inter_gns = [GroupNorm32(name=f"inter_gn{i}")
                          for i in range(self.stacked_convs)]
        self.cls_decomp = TaskDecomposition(self.feat_channels,
                                            self.stacked_convs,
                                            dtype=self.dtype,
                                            name="cls_decomp")
        self.reg_decomp = TaskDecomposition(self.feat_channels,
                                            self.stacked_convs,
                                            dtype=self.dtype,
                                            name="reg_decomp")
        self.tood_cls = Conv(self.num_classes, 3, 1, 1, dtype=self.dtype)
        self.tood_reg = Conv(4, 3, 1, 1, dtype=self.dtype)
        self.cls_prob_conv1 = Conv(self.feat_channels // 4, 1, 1, 0,
                                   dtype=self.dtype)
        self.cls_prob_conv2 = Conv(1, 3, 1, 1, dtype=self.dtype)
        self.reg_offset_conv1 = Conv(self.feat_channels // 4, 1, 1, 0,
                                     dtype=self.dtype)
        self.reg_offset_conv2 = Conv(4 * 2, 3, 1, 1, dtype=self.dtype)
        self.scales = self.param("scales", nn.initializers.ones,
                                 (len(self.strides),))

    def _align_boxes(self, boxes, offsets):
        """Resample each box side map at its learned offset (reference
        deform_sampling with a 1x1 depthwise trick). boxes (B,H,W,4) in
        image units; offsets (B,H,W,8) (dy,dx per side, feature units)."""
        b, h, w, _ = boxes.shape
        ys = jnp.arange(h, dtype=jnp.float32)[None, :, None]
        xs = jnp.arange(w, dtype=jnp.float32)[None, None, :]
        outs = []
        for c in range(4):
            yy = ys + offsets[..., 2 * c]
            xx = xs + offsets[..., 2 * c + 1]
            outs.append(bilinear_gather(boxes[..., c:c + 1], yy, xx)[..., 0])
        return jnp.stack(outs, -1)

    def __call__(self, feats):
        cls_scores, bbox_preds = [], []
        for li, x in enumerate(feats):
            h = x
            inter = []
            for conv, gn in zip(self.inter_convs, self.inter_gns):
                h = nn.relu(gn(conv(h)))
                inter.append(h)
            stacked = jnp.concatenate(inter, -1)
            avg = jnp.mean(stacked, axis=(1, 2), keepdims=True)
            cf = self.cls_decomp(stacked, avg)
            rf = self.reg_decomp(stacked, avg)
            logits = self.tood_cls(cf).astype(jnp.float32)
            prob = self.cls_prob_conv2(
                nn.relu(self.cls_prob_conv1(stacked))).astype(jnp.float32)
            # sigmoid geometric mean (reference tood_head.py:197)
            score = jnp.sqrt(jnp.clip(
                jax.nn.sigmoid(logits) * jax.nn.sigmoid(prob), 1e-12, 1.0))
            s = float(self.strides[li])
            reg = (jax.nn.relu(self.scales[li]
                               * self.tood_reg(rf).astype(jnp.float32)) * s)
            # decode then offset-align
            hh, ww = x.shape[1:3]
            pts, _ = _level_points([(hh, ww)], [s])
            boxes = distance2bbox(pts[None], reg.reshape(reg.shape[0], -1,
                                                         4))
            boxes = boxes.reshape(reg.shape)
            off = self.reg_offset_conv2(
                nn.relu(self.reg_offset_conv1(stacked))).astype(jnp.float32)
            aligned = self._align_boxes(boxes, off)
            cls_scores.append(score)
            bbox_preds.append(aligned)
        return cls_scores, bbox_preds

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, sids = _level_points(featmap_sizes, self.strides)
        cls = jnp.concatenate([s.reshape(n, -1, self.num_classes)
                               for s in cls_scores], 1)         # probs!
        boxes = jnp.concatenate([b.reshape(n, -1, 4)
                                 for b in bbox_preds], 1)

        def one(sc, bx, gt, gtv, gtl):
            u = bbox_overlaps(bx, gt)                            # (P,G)
            u = jnp.where(gtv[None, :], u, 0.0)
            sg = sc[:, gtl.astype(jnp.int32)]                    # (P,G)
            t = (sg ** self.alignment_alpha) * (u ** self.alignment_beta)
            # inside-gt constraint
            px, py = points[:, 0:1], points[:, 1:2]
            inside = ((px >= gt[None, :, 0]) & (px <= gt[None, :, 2])
                      & (py >= gt[None, :, 1]) & (py <= gt[None, :, 3]))
            # cold-start bootstrap: at init all pred boxes are empty so
            # u == 0 and TAL selects nothing (the reference avoids this
            # with initial-epoch ATSS warmup, tood_head.py initial_epoch).
            # A vanishing center-distance tiebreak keeps the nearest
            # inside-points selected so regression can bootstrap.
            gcx = (gt[None, :, 0] + gt[None, :, 2]) * 0.5
            gcy = (gt[None, :, 1] + gt[None, :, 3]) * 0.5
            dist = jnp.abs(px - gcx) + jnp.abs(py - gcy)
            t = t + 1e-9 / (1.0 + dist)
            t = jnp.where(inside & gtv[None, :], t, 0.0)
            k = min(self.topk, t.shape[0])
            thr = jax.lax.top_k(t.T, k)[0][:, -1]                # (G,)
            cand = (t >= jnp.maximum(thr[None, :], 1e-12)) & (t > 0)
            # conflict: point takes gt with max t
            sel = jnp.where(cand, t, -1.0)
            gi = jnp.argmax(sel, -1)
            pos = jnp.max(sel, -1) > 0
            labels = jnp.where(pos, gtl[gi], self.num_classes)
            # normalized alignment target (reference: t/max_t * max_iou)
            tmax = jnp.max(jnp.where(cand, t, 0.0), 0)           # (G,)
            umax = jnp.max(jnp.where(cand, u, 0.0), 0)
            tsel = jnp.take_along_axis(t, gi[:, None], 1)[:, 0]
            norm_t = (tsel / jnp.clip(tmax[gi], 1e-12, None)
                      * umax[gi]) * pos
            return labels.astype(jnp.int32), pos, gi, norm_t

        labels, pos, gi, norm_t = jax.vmap(one)(cls, boxes, gt_bboxes,
                                                gt_valid, gt_labels)
        tgt = jnp.take_along_axis(gt_bboxes, gi[..., None], 1)
        num_pos = jnp.maximum(jnp.sum(norm_t), 1.0)
        # QFL expects logits; our cls are probabilities -> use logit transform
        logits = jnp.log(jnp.clip(cls, 1e-12, 1.0)
                         / jnp.clip(1 - cls, 1e-12, 1.0))
        loss_cls = self.l_cls(logits.reshape(-1, self.num_classes),
                              (labels.reshape(-1), norm_t.reshape(-1)),
                              avg_factor=num_pos)
        # floor the regression weight so positives train before any IoU
        # signal exists (stands in for the reference's ATSS warmup epochs)
        wb = jnp.maximum(norm_t, 0.05 * pos.astype(jnp.float32))
        loss_bbox = self.l_bbox(boxes.reshape(-1, 4), tgt.reshape(-1, 4),
                                weight=wb.reshape(-1),
                                avg_factor=jnp.maximum(jnp.sum(wb), 1.0))
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_scores, bbox_preds = outs
        cfg = dict(cfg or self.test_cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.6))
        max_per_img = int(cfg.get("max_per_img", 100))

        def one(cls_l, box_l, shape, sf):
            boxes_all, scores_all = [], []
            for li in range(len(cls_l)):
                sc = cls_l[li].reshape(-1, self.num_classes)
                bx = box_l[li].reshape(-1, 4)
                k = min(nms_pre, sc.shape[0])
                _, ti = jax.lax.top_k(jnp.max(sc, -1), k)
                bxt = jnp.clip(bx[ti],
                               0, jnp.asarray([shape[1], shape[0],
                                               shape[1], shape[0]],
                                              jnp.float32))
                boxes_all.append(bxt)
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
class TOOD(SingleStageDetector):
    """Alias (reference mmdet/models/detectors/tood.py)."""
    pass
