"""GFL head (reference mmdet/models/dense_heads/gfl_head.py:60): ATSS-style
towers, classification as joint cls-IoU quality (QualityFocalLoss), box
regression as a discrete distribution over ``reg_max + 1`` bins per side
(Integral -> expectation; DistributionFocalLoss) plus GIoU on decoded boxes.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.anchor import AnchorGenerator
from ...core.bbox.assign_sample import ATSSAssigner
from ...core.bbox.geometry import bbox_overlaps
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..layers import Conv, GroupNorm32


@HEADS.register_module()
class GFLHead(nn.Module):
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 4
    reg_max: int = 16
    anchor_generator: Any = None
    loss_cls: Any = None
    loss_bbox: Any = None
    loss_dfl: Any = None
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
        self.strides = tuple(s if isinstance(s, int) else s[0]
                             for s in ag.get("strides", (8, 16, 32, 64, 128)))
        self.qfl = build_from_cfg(dict(self.loss_cls or dict(
            type="QualityFocalLoss", beta=2.0, loss_weight=1.0)), LOSSES)
        self.giou = build_from_cfg(dict(self.loss_bbox or dict(
            type="GIoULoss", loss_weight=2.0)), LOSSES)
        self.dfl = build_from_cfg(dict(self.loss_dfl or dict(
            type="DistributionFocalLoss", loss_weight=0.25)), LOSSES)
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
        self.gfl_cls = Conv(self.num_classes, 3, 1, 1, dtype=self.dtype)
        self.gfl_reg = Conv(4 * (self.reg_max + 1), 3, 1, 1, dtype=self.dtype)
        self.scales = self.param("reg_scales", nn.initializers.ones,
                                 (len(self.strides),))

    def __call__(self, feats):
        cls_scores, bbox_preds = [], []
        for li, x in enumerate(feats):
            c = r = x
            for conv, gn in zip(self.cls_convs, self.cls_gns):
                c = nn.relu(gn(conv(c)))
            for conv, gn in zip(self.reg_convs, self.reg_gns):
                r = nn.relu(gn(conv(r)))
            cls_scores.append(self.gfl_cls(c))
            bbox_preds.append(self.gfl_reg(r)
                              * self.scales[li].astype(jnp.float32))
        return (cls_scores, bbox_preds)

    def _integral(self, reg):
        """(..., 4*(reg_max+1)) logits -> (..., 4) expected distances."""
        n = self.reg_max + 1
        p = jax.nn.softmax(reg.reshape(*reg.shape[:-1], 4, n), axis=-1)
        proj = jnp.arange(n, dtype=jnp.float32)
        return jnp.sum(p * proj, axis=-1)

    def _decode(self, centers, dists, strides):
        d = dists * strides[:, None]
        return jnp.stack([centers[:, 0] - d[:, 0], centers[:, 1] - d[:, 1],
                          centers[:, 0] + d[:, 2], centers[:, 1] + d[:, 3]],
                         -1)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds = outs
        n = cls_scores[0].shape[0]
        nbins = 4 * (self.reg_max + 1)
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        per_level = self.prior_gen.grid_priors(featmap_sizes)
        num_level = [len(a) for a in per_level]
        anchors = jnp.concatenate(per_level)
        centers = (anchors[:, :2] + anchors[:, 2:]) * 0.5
        stride_arr = jnp.concatenate([
            jnp.full((nl,), s, jnp.float32)
            for nl, s in zip(num_level, self.strides)])
        cls = jnp.concatenate([s.reshape(n, -1, self.num_classes)
                               for s in cls_scores], 1).astype(jnp.float32)
        reg = jnp.concatenate([b.reshape(n, -1, nbins)
                               for b in bbox_preds], 1).astype(jnp.float32)

        def one(cls_i, reg_i, gt, gtv, gtl):
            assign = self.assigner.assign(anchors, num_level, gt, gtv,
                                          gt_labels=gtl)
            pos = assign.gt_inds > 0
            matched = jnp.clip(assign.gt_inds - 1, 0, gt.shape[0] - 1)
            mgt = gt[matched]
            dists = self._integral(reg_i)                      # (P, 4)
            dec = self._decode(centers, dists, stride_arr)
            ious = bbox_overlaps(dec, mgt, is_aligned=True)
            labels = jnp.where(pos, assign.labels, self.num_classes)
            score = jnp.where(pos, ious, 0.0)
            posf = pos.astype(jnp.float32)
            loss_qfl = self.qfl(cls_i, (labels, score),
                                jnp.ones_like(posf),
                                avg_factor=jnp.maximum(jnp.sum(posf), 1.0))
            wsum = jnp.maximum(jnp.sum(score * posf), 1e-6)
            loss_giou = self.giou(dec, mgt, score * posf, avg_factor=wsum)
            # DFL on per-side distance targets in bin units
            tgt = jnp.stack([
                (centers[:, 0] - mgt[:, 0]), (centers[:, 1] - mgt[:, 1]),
                (mgt[:, 2] - centers[:, 0]), (mgt[:, 3] - centers[:, 1])],
                -1) / stride_arr[:, None]
            tgt = jnp.clip(tgt, 0.0, self.reg_max - 0.01)
            reg_bins = reg_i.reshape(-1, self.reg_max + 1)
            w_dfl = jnp.repeat(score * posf, 4)
            loss_dfl = self.dfl(reg_bins, tgt.reshape(-1), w_dfl,
                                avg_factor=jnp.maximum(jnp.sum(w_dfl), 1e-6))
            return loss_qfl, loss_giou, loss_dfl

        lq, lg, ld = jax.vmap(one)(cls, reg, gt_bboxes, gt_valid, gt_labels)
        return dict(loss_cls=jnp.mean(lq), loss_bbox=jnp.mean(lg),
                    loss_dfl=jnp.mean(ld))

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_scores, bbox_preds = outs
        cfg = dict(cfg or self.test_cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.6))
        max_per_img = int(cfg.get("max_per_img", 100))
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        per_level = [jnp.asarray(a) for a in
                     self.prior_gen.grid_priors(featmap_sizes)]

        def one(scores_lv, reg_lv, shape, sf):
            boxes_all, scores_all = [], []
            for sc, rg, anch, st in zip(scores_lv, reg_lv, per_level,
                                        self.strides):
                sc = jax.nn.sigmoid(sc.reshape(-1, self.num_classes)
                                    .astype(jnp.float32))
                rg = rg.reshape(-1, 4 * (self.reg_max + 1)).astype(jnp.float32)
                k = min(nms_pre, sc.shape[0])
                _, ti = jax.lax.top_k(jnp.max(sc, -1), k)
                ctr = (anch[ti, :2] + anch[ti, 2:]) * 0.5
                d = self._integral(rg[ti]) * st
                boxes = jnp.stack([ctr[:, 0] - d[:, 0], ctr[:, 1] - d[:, 1],
                                   ctr[:, 0] + d[:, 2], ctr[:, 1] + d[:, 3]],
                                  -1)
                boxes = jnp.clip(boxes, 0,
                                 jnp.stack([shape[1], shape[0],
                                            shape[1], shape[0]]))
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


from ..detectors.single_stage import SingleStageDetector  # noqa: E402


@DETECTORS.register_module()
class GFL(SingleStageDetector):
    """GFL detector (reference mmdet/models/detectors/gfl.py:7)."""
    pass
