"""RetinaNet head (reference mmdet/models/dense_heads/retina_head.py):
4-conv cls/reg towers, octave anchors, focal loss over all anchors
(PseudoSampler — no subsampling), multiclass NMS decode.

Static-shape: identical target machinery to the RPN head (masked MaxIoU
assignment) with class labels and num-positive normalization.
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
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import HEADS, LOSSES, build_from_cfg
from ..layers import Conv


@HEADS.register_module()
class RetinaHead(nn.Module):
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 4
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
            octave_base_scale=4, scales_per_octave=3,
            ratios=[0.5, 1.0, 2.0], strides=[8, 16, 32, 64, 128]))
        ag.pop("type", None)
        self.prior_gen = AnchorGenerator(**ag)
        bc = dict(self.bbox_coder or dict(target_means=(0., 0., 0., 0.),
                                          target_stds=(1., 1., 1., 1.)))
        bc.pop("type", None)
        self.coder = DeltaXYWHBBoxCoder(**bc)
        self.cls_loss = build_from_cfg(dict(self.loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0)), LOSSES)
        self.reg_loss = build_from_cfg(dict(self.loss_bbox or dict(
            type="L1Loss", loss_weight=1.0)), LOSSES)
        tc = dict(self.train_cfg or {})
        asn = dict(tc.get("assigner", dict(pos_iou_thr=0.5, neg_iou_thr=0.4,
                                           min_pos_iou=0)))
        asn.pop("type", None)
        self.assigner = MaxIoUAssigner(**asn)
        na = self.prior_gen.num_base_anchors[0]
        # reference retina_head.py init_cfg: every conv Normal(0.01);
        # retina_cls bias_prob=0.01 (sigmoid starts at p=0.01 — keeps the
        # focal loss finite/stable in the first steps)
        from ..layers import bias_prob_init, normal_init
        ki = normal_init(0.01)
        self.cls_convs = [Conv(self.feat_channels, 3, 1, 1, kernel_init=ki,
                               dtype=self.dtype, name=f"cls_conv{i}")
                          for i in range(self.stacked_convs)]
        self.reg_convs = [Conv(self.feat_channels, 3, 1, 1, kernel_init=ki,
                               dtype=self.dtype, name=f"reg_conv{i}")
                          for i in range(self.stacked_convs)]
        self.retina_cls = Conv(na * self.num_classes, 3, 1, 1,
                               kernel_init=ki,
                               bias_init=bias_prob_init(0.01),
                               dtype=self.dtype)
        self.retina_reg = Conv(na * 4, 3, 1, 1, kernel_init=ki,
                               dtype=self.dtype)

    def __call__(self, feats):
        cls_scores, bbox_preds = [], []
        for x in feats:
            c = r = x
            for conv in self.cls_convs:
                c = nn.relu(conv(c))
            for conv in self.reg_convs:
                r = nn.relu(conv(r))
            cls_scores.append(self.retina_cls(c))
            bbox_preds.append(self.retina_reg(r))
        return (cls_scores, bbox_preds)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_gen.grid_priors_cat(featmap_sizes)
        cls = jnp.concatenate(
            [s.reshape(n, -1, self.num_classes) for s in cls_scores], axis=1)
        reg = jnp.concatenate(
            [b.reshape(n, -1, 4) for b in bbox_preds], axis=1)

        def one(gt, gtv, gtl):
            assign = self.assigner.assign(anchors, gt, gtv, gt_labels=gtl)
            pos = assign.gt_inds > 0
            neg = assign.gt_inds == 0
            labels = jnp.where(pos, assign.labels, self.num_classes)
            matched = jnp.clip(assign.gt_inds - 1, 0, gt.shape[0] - 1)
            deltas = self.coder.encode(anchors, gt[matched])
            return labels, pos, neg, deltas

        labels, pos, neg, deltas = jax.vmap(one)(gt_bboxes, gt_valid,
                                                 gt_labels)
        num_pos = jnp.maximum(jnp.sum(pos), 1.0)
        lw = (pos | neg).astype(jnp.float32)
        loss_cls = self.cls_loss(cls.reshape(-1, self.num_classes)
                                 .astype(jnp.float32),
                                 labels.reshape(-1), lw.reshape(-1),
                                 avg_factor=num_pos)
        bw = pos.astype(jnp.float32)[..., None] * jnp.ones((1, 1, 4))
        loss_bbox = self.reg_loss(reg.astype(jnp.float32), deltas, bw,
                                  avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def get_bboxes(self, outs_or_maps, img_shapes, scale_factors,
                   rescale=True, cfg=None):
        cls_scores, bbox_preds = (outs_or_maps
                                  if isinstance(outs_or_maps, tuple)
                                  and len(outs_or_maps) == 2 else
                                  (outs_or_maps, None))
        cfg = dict(cfg or self.test_cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.5))
        max_per_img = int(cfg.get("max_per_img", 100))
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        per_level = [jnp.asarray(a) for a in
                     self.prior_gen.grid_priors(featmap_sizes)]

        def one(scores_lv, deltas_lv, shape, sf):
            boxes_all, scores_all = [], []
            for sc, dl, anch in zip(scores_lv, deltas_lv, per_level):
                sc = jax.nn.sigmoid(sc.reshape(-1, self.num_classes)
                                    .astype(jnp.float32))
                dl = dl.reshape(-1, 4)
                k = min(nms_pre, sc.shape[0])
                top_s, ti = jax.lax.top_k(jnp.max(sc, axis=-1), k)
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
                             img_shapes, scale_factors)
