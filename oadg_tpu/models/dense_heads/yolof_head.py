"""YOLOF head + detector (reference mmdet/models/dense_heads/yolof_head.py,
mmdet/models/detectors/yolof.py, core/bbox/assigners/uniform_assigner.py).

Single-level (C5 + DilatedEncoder) anchor head with implicit objectness and
uniform matching: each gt takes its k nearest anchors AND k nearest
predicted boxes (L1 center distance) as positive candidates; candidates
whose anchor IoU < pos_ignore_thr are dropped, and anchors whose predicted
box overlaps any gt above neg_ignore_thr are excluded from the negatives.
mmdet's per-image index lists become static (N, G) masks here.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.anchor import AnchorGenerator
from ...core.bbox.coder import DeltaXYWHBBoxCoder
from ...core.bbox.geometry import bbox_overlaps
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, FrozenBN

INF = 1e8


@HEADS.register_module()
class YOLOFHead(nn.Module):
    num_classes: int = 80
    in_channels: int = 512
    num_cls_convs: int = 2
    num_reg_convs: int = 4
    anchor_generator: Any = None
    bbox_coder: Any = None
    loss_cls: Any = None
    loss_bbox: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        ag = dict(self.anchor_generator or dict(
            ratios=[1.0], scales=[1, 2, 4, 8, 16], strides=[32]))
        ag.pop("type", None)
        self.prior_gen = AnchorGenerator(**ag)
        bc = dict(self.bbox_coder or dict(
            target_means=[0., 0., 0., 0.], target_stds=[1., 1., 1., 1.],
            add_ctr_clamp=True, ctr_clamp=32))
        bc.pop("type", None)
        self.coder = DeltaXYWHBBoxCoder(**bc)
        self.l_cls = build_from_cfg(dict(self.loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0)), LOSSES)
        self.l_bbox = build_from_cfg(dict(self.loss_bbox or dict(
            type="GIoULoss", loss_weight=1.0)), LOSSES)
        tc = dict(self.train_cfg or {})
        asn = dict(tc.get("assigner", {}))
        self.match_times = int(asn.get("match_times", 4))
        self.pos_ignore_thr = float(asn.get("pos_ignore_thr", 0.15))
        self.neg_ignore_thr = float(asn.get("neg_ignore_thr", 0.7))
        na = self.prior_gen.num_base_anchors[0]
        self.na = na
        self.cls_subnet = [Conv(self.in_channels, 3, 1, 1, dtype=self.dtype,
                                name=f"cls_conv{i}")
                           for i in range(self.num_cls_convs)]
        self.cls_bns = [FrozenBN(frozen=False, name=f"cls_bn{i}")
                        for i in range(self.num_cls_convs)]
        self.reg_subnet = [Conv(self.in_channels, 3, 1, 1, dtype=self.dtype,
                                name=f"reg_conv{i}")
                           for i in range(self.num_reg_convs)]
        self.reg_bns = [FrozenBN(frozen=False, name=f"reg_bn{i}")
                        for i in range(self.num_reg_convs)]
        self.cls_score = Conv(na * self.num_classes, 3, 1, 1,
                              dtype=self.dtype)
        self.bbox_pred = Conv(na * 4, 3, 1, 1, dtype=self.dtype)
        self.object_pred = Conv(na, 3, 1, 1, dtype=self.dtype)

    def __call__(self, feats):
        x = feats[0] if isinstance(feats, (list, tuple)) else feats
        c = r = x
        for conv, bn in zip(self.cls_subnet, self.cls_bns):
            c = nn.relu(bn(conv(c)))
        for conv, bn in zip(self.reg_subnet, self.reg_bns):
            r = nn.relu(bn(conv(r)))
        cls = self.cls_score(c).astype(jnp.float32)
        reg = self.bbox_pred(r).astype(jnp.float32)
        obj = self.object_pred(r).astype(jnp.float32)
        # implicit objectness fusion (reference yolof_head.py:137-144)
        b, h, w, _ = cls.shape
        cls = cls.reshape(b, h, w, self.na, self.num_classes)
        obj = obj.reshape(b, h, w, self.na, 1)
        norm = cls + obj - jnp.log(
            1.0 + jnp.clip(jnp.exp(cls), a_max=INF)
            + jnp.clip(jnp.exp(obj), a_max=INF))
        return ([norm.reshape(b, h, w, -1)], [reg])

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_gen.grid_priors_cat(featmap_sizes)
        cls = cls_scores[0].reshape(n, -1, self.num_classes)
        reg = bbox_preds[0].reshape(n, -1, 4)
        decoded = self.coder.decode(anchors[None], reg)

        def one(dec, gt, gtv, gtl):
            N, G = anchors.shape[0], gt.shape[0]
            acx = (anchors[:, 0] + anchors[:, 2]) * 0.5
            acy = (anchors[:, 1] + anchors[:, 3]) * 0.5
            pcx = (dec[:, 0] + dec[:, 2]) * 0.5
            pcy = (dec[:, 1] + dec[:, 3]) * 0.5
            gcx = (gt[:, 0] + gt[:, 2]) * 0.5
            gcy = (gt[:, 1] + gt[:, 3]) * 0.5
            cost_a = (jnp.abs(acx[:, None] - gcx[None])
                      + jnp.abs(acy[:, None] - gcy[None]))      # (N,G)
            cost_p = (jnp.abs(pcx[:, None] - gcx[None])
                      + jnp.abs(pcy[:, None] - gcy[None]))
            k = self.match_times
            thr_a = -jax.lax.top_k(-cost_a.T, k)[0][:, -1]       # (G,)
            thr_p = -jax.lax.top_k(-cost_p.T, k)[0][:, -1]
            cand = ((cost_a <= thr_a[None]) | (cost_p <= thr_p[None]))
            cand = cand & gtv[None, :]
            iou_a = bbox_overlaps(anchors, gt)                   # (N,G)
            iou_p = bbox_overlaps(dec, gt)
            iou_p = jnp.where(gtv[None, :], iou_p, 0.0)
            # neg-ignore: predicted box already covers some gt well
            neg_ignore = jnp.max(iou_p, -1) > self.neg_ignore_thr
            # pos-ignore: candidate whose ANCHOR iou too low is dropped
            pos_cand = cand & (iou_a >= self.pos_ignore_thr)
            # anchor -> best candidate gt by anchor IoU
            sel = jnp.where(pos_cand, iou_a, -1.0)
            gi = jnp.argmax(sel, -1)
            pos = jnp.max(sel, -1) > -0.5
            ignored_cand = jnp.any(cand & ~pos_cand, -1) & ~pos
            labels = jnp.where(pos, gtl[gi],
                               self.num_classes).astype(jnp.int32)
            cw = jnp.where(ignored_cand | (neg_ignore & ~pos), 0.0, 1.0)
            tgt = gt[gi]
            return labels, pos, cw, tgt

        labels, pos, cw, tgt = jax.vmap(one)(decoded, gt_bboxes, gt_valid,
                                             gt_labels)
        num_pos = jnp.maximum(jnp.sum(pos), 1.0)
        loss_cls = self.l_cls(cls.reshape(-1, self.num_classes),
                              labels.reshape(-1), cw.reshape(-1),
                              avg_factor=num_pos)
        loss_bbox = self.l_bbox(decoded.reshape(-1, 4), tgt.reshape(-1, 4),
                                weight=pos.astype(jnp.float32).reshape(-1),
                                avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_scores, bbox_preds = outs
        cfg = dict(cfg or self.test_cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.6))
        max_per_img = int(cfg.get("max_per_img", 100))
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_gen.grid_priors_cat(featmap_sizes)

        def one(sc, rg, shape, sf):
            sc = jax.nn.sigmoid(sc.reshape(-1, self.num_classes)
                                .astype(jnp.float32))
            rg = rg.reshape(-1, 4)
            k = min(nms_pre, sc.shape[0])
            _, ti = jax.lax.top_k(jnp.max(sc, -1), k)
            boxes = self.coder.decode(anchors[ti], rg[ti],
                                      max_shape=(shape[0], shape[1]))
            scores = sc[ti]
            if rescale:
                boxes = boxes / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            pad = jnp.concatenate([scores,
                                   jnp.zeros((scores.shape[0], 1))], -1)
            return multiclass_nms(boxes, pad, score_thr, iou_thr,
                                  max_per_img, self.num_classes)

        return jax.vmap(one)(cls_scores[0], bbox_preds[0], img_shapes,
                             scale_factors)


@DETECTORS.register_module()
class YOLOF(SingleStageDetector):
    """Alias (reference mmdet/models/detectors/yolof.py)."""
    pass
