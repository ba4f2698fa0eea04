"""RPN head: conv tower + anchor-based loss + static-shape proposal generation.

Capability-parity with reference mmdet/models/dense_heads/rpn_head.py:15 and
the AnchorHead target machinery (anchor_head.py:171-455), redesigned for XLA:

- anchors are precomputed host-side per static featmap shape (numpy) and
  closed over by the traced step;
- per-image assignment/sampling is a vmapped masked computation (no ragged
  index lists); ``allowed_border=-1`` (the OA-DG configs) means no border
  filtering, matching the reference;
- the loss is computed over all levels concatenated at once — identical math
  to mmdet's per-level ``loss_single`` sum because every term is a weighted
  sum divided by the same ``num_total_samples``;
- proposal generation: per-level top-``nms_pre`` -> decode -> clip ->
  level-offset batched NMS -> top-``max_per_img``, all padded to static
  sizes with validity masks (reference rpn_head.py:103-231).

Multi-view (OA-DG): losses are view-chunked inside CrossEntropyLossPlus /
L1LossPlus; this head just lays rows out views-major.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.anchor import AnchorGenerator
from ...core.bbox.assign_sample import MaxIoUAssigner, RandomSampler
from ...core.post_processing.nms import (batched_nms_padded,
                                         nms_padded)
from ...utils.registry import HEADS, LOSSES, BBOX_CODERS, build_from_cfg
from ..layers import Conv, normal_init


def _build(cfg, registry, **default):
    return build_from_cfg(dict(cfg), registry, default) if cfg else None


@HEADS.register_module()
class RPNHead(nn.Module):
    in_channels: int = 256
    feat_channels: int = 256
    anchor_generator: Any = None
    bbox_coder: Any = None
    loss_cls: Any = None
    loss_bbox: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_classes: int = 1
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        ag = dict(self.anchor_generator or dict(
            scales=[8], ratios=[0.5, 1.0, 2.0], strides=[4, 8, 16, 32, 64]))
        ag.pop("type", None)
        self.prior_gen = AnchorGenerator(**ag)
        bc = dict(self.bbox_coder or dict(target_means=(0., 0., 0., 0.),
                                          target_stds=(1., 1., 1., 1.)))
        bc.pop("type", None)
        from ...core.bbox.coder import DeltaXYWHBBoxCoder
        self.coder = DeltaXYWHBBoxCoder(**bc)
        self.cls_loss = _build(self.loss_cls or dict(
            type="CrossEntropyLoss", use_sigmoid=True, loss_weight=1.0), LOSSES)
        self.reg_loss = _build(self.loss_bbox or dict(
            type="L1Loss", loss_weight=1.0), LOSSES)
        tc = dict(self.train_cfg or {})
        asn = dict(tc.get("assigner", dict(pos_iou_thr=0.7, neg_iou_thr=0.3,
                                           min_pos_iou=0.3)))
        asn.pop("type", None)
        self.assigner = MaxIoUAssigner(**asn)
        smp = dict(tc.get("sampler", dict(num=256, pos_fraction=0.5)))
        smp.pop("type", None)
        self.sampler = RandomSampler(**smp)
        na = len(ag.get("ratios", [0.5, 1.0, 2.0])) * len(ag.get("scales", [8]))
        # reference rpn_head.py init_cfg: Normal(std=0.01) on every conv —
        # load-bearing at step 0 (deltas ~ 0 -> proposals ~ anchors)
        ki = normal_init(0.01)
        self.rpn_conv = Conv(self.feat_channels, 3, 1, 1, kernel_init=ki,
                             dtype=self.dtype)
        self.rpn_cls = Conv(na * self.num_classes, 1, 1, 0, kernel_init=ki,
                            dtype=self.dtype)
        self.rpn_reg = Conv(na * 4, 1, 1, 0, kernel_init=ki,
                            dtype=self.dtype)

    def __call__(self, feats: Sequence[jnp.ndarray]):
        cls_scores, bbox_preds = [], []
        for x in feats:
            t = nn.relu(self.rpn_conv(x))
            cls_scores.append(self.rpn_cls(t))       # (N, H, W, A)
            bbox_preds.append(self.rpn_reg(t))       # (N, H, W, A*4)
        return cls_scores, bbox_preds

    # ---------------- anchors ----------------

    def _anchors(self, featmap_sizes) -> jnp.ndarray:
        return self.prior_gen.grid_priors_cat(featmap_sizes)    # (K, 4)

    # ---------------- training ----------------

    def loss(self, cls_scores, bbox_preds, gt_bboxes, gt_valid, rng,
             img_shapes=None):
        """All-level RPN loss.

        Args:
            cls_scores/bbox_preds: per-level NHWC head outputs, N views-major.
            gt_bboxes: (N, G, 4); gt_valid: (N, G) bool; rng: PRNG key.
            img_shapes: (N, 2) valid (h, w) per image — used when
                ``train_cfg.allowed_border >= 0`` to exclude anchors
                crossing the image border from assignment/sampling
                (reference anchor_head.get_targets inside_flags; the
                OA-DG configs use allowed_border=-1 = no filtering).
        """
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self._anchors(featmap_sizes)                   # (K, 4)
        k = anchors.shape[0]
        ab = float(dict(self.train_cfg or {}).get("allowed_border", -1))

        cls = jnp.concatenate(
            [s.reshape(n, -1, self.num_classes) for s in cls_scores], axis=1)
        reg = jnp.concatenate(
            [b.reshape(n, -1, 4) for b in bbox_preds], axis=1)   # (N, K, 4)

        def targets_one(gt, gtv, key, shape):
            box_valid = None
            if ab >= 0 and shape is not None:
                box_valid = ((anchors[:, 0] >= -ab)
                             & (anchors[:, 1] >= -ab)
                             & (anchors[:, 2] < shape[1] + ab)
                             & (anchors[:, 3] < shape[0] + ab))
            assign = self.assigner.assign(anchors, gt, gtv,
                                          box_valid=box_valid)
            pos, neg = self.sampler.sample_masks(key, assign)
            labels = jnp.where(pos, 0, self.num_classes)         # fg label = 0
            label_w = (pos | neg).astype(jnp.float32)
            matched = jnp.clip(assign.gt_inds - 1, 0, gt.shape[0] - 1)
            # gt[matched] as a one-hot (K, G) @ (G, 4) matmul instead of a
            # row gather of (K,) tiny 4-float rows. HIGHEST precision so
            # pixel coordinates survive exactly (one-hot rows are exact).
            onehot = jax.nn.one_hot(matched, gt.shape[0], dtype=jnp.float32)
            mgt = jnp.matmul(onehot, gt, precision=jax.lax.Precision.HIGHEST)
            deltas = self.coder.encode(anchors, mgt)
            bbox_w = pos.astype(jnp.float32)[:, None] * jnp.ones((1, 4))
            return labels, label_w, deltas, bbox_w, pos, neg

        keys = jax.random.split(rng, n)
        shapes = (img_shapes if img_shapes is not None
                  else jnp.zeros((n, 2)))
        if ab >= 0 and img_shapes is None:
            raise ValueError("allowed_border >= 0 needs img_shapes")
        labels, label_w, deltas, bbox_w, pos, neg = jax.vmap(targets_one)(
            gt_bboxes, gt_valid, keys, shapes)
        num_total = jnp.maximum(jnp.sum(pos) + jnp.sum(neg), 1.0)

        loss_cls = self.cls_loss(
            cls.reshape(-1, self.num_classes).astype(jnp.float32),
            labels.reshape(-1),
            label_w.reshape(-1), avg_factor=num_total)
        loss_bbox = self.reg_loss(
            reg.reshape(-1, 4).astype(jnp.float32), deltas.reshape(-1, 4),
            bbox_w.reshape(-1, 4), avg_factor=num_total)
        return dict(loss_rpn_cls=loss_cls, loss_rpn_bbox=loss_bbox)

    # ---------------- proposals ----------------

    def get_proposals(self, cls_scores, bbox_preds, img_shapes, cfg):
        """Static-shape proposal generation (reference rpn_head.py:103-231).

        Args:
            img_shapes: (N, 2) float (h, w) valid region per image.
            cfg: dict(nms_pre, max_per_img, nms=dict(iou_threshold), min_bbox_size)

        Returns:
            boxes (N, max_per_img, 4), scores (N, max_per_img),
            valid (N, max_per_img) bool.
        """
        nms_pre = int(cfg.get("nms_pre", 1000))
        max_per_img = int(cfg.get("max_per_img", 1000))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.7))
        min_size = float(cfg.get("min_bbox_size", 0))

        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        per_level_anchors = [jnp.asarray(a) for a in
                             self.prior_gen.grid_priors(featmap_sizes)]

        def one_image(scores_lv, deltas_lv, img_shape):
            # batched_nms with level ids never suppresses ACROSS levels
            # (the coordinate-offset trick separates them), so per-level
            # NMS under one more vmap is exactly equivalent — and turns
            # one O((5*nms_pre)^2) suppression fixpoint into 5 parallel
            # O(nms_pre^2) ones.
            cand_boxes, cand_scores, cand_valid = [], [], []
            for lvl, (sc, dl, anch) in enumerate(
                    zip(scores_lv, deltas_lv, per_level_anchors)):
                sc = sc.reshape(-1)                               # (HWA,)
                dl = dl.reshape(-1, 4)
                kk = sc.shape[0]
                top = min(nms_pre, kk)
                ts, ti = jax.lax.top_k(sc, top)
                boxes = self.coder.decode(anch[ti], dl[ti],
                                          max_shape=(img_shape[0], img_shape[1]))
                pad = nms_pre - top
                if pad:
                    boxes = jnp.pad(boxes, ((0, pad), (0, 0)))
                cand_boxes.append(boxes)
                cand_scores.append(jnp.pad(jax.nn.sigmoid(ts), (0, pad)))
                cand_valid.append(jnp.pad(jnp.ones((top,), bool), (0, pad)))
            boxes = jnp.stack(cand_boxes)                # (L, nms_pre, 4)
            scores = jnp.stack(cand_scores)
            valid = jnp.stack(cand_valid)
            if min_size > 0:
                w = boxes[..., 2] - boxes[..., 0]
                h = boxes[..., 3] - boxes[..., 1]
                valid = valid & (w > min_size) & (h > min_size)
            keep = jax.vmap(lambda b, s, v: nms_padded(
                b, s, iou_thr, v))(boxes, scores, valid)
            boxes = boxes.reshape(-1, 4)
            scores = scores.reshape(-1)
            sc = jnp.where(keep.reshape(-1), scores, -jnp.inf)
            top_s, top_i = jax.lax.top_k(sc, max_per_img)
            out_valid = top_s > -jnp.inf
            out_boxes = jnp.where(out_valid[:, None], boxes[top_i], 0.0)
            return out_boxes, jnp.where(out_valid, top_s, 0.0), out_valid

        del n
        boxes, scores, valid = jax.vmap(one_image)(
            tuple(cls_scores), tuple(bbox_preds), img_shapes)
        # proposals are training DATA for the RoI head, not a gradient path
        # (the reference detaches them implicitly by materializing tensors);
        # without this the backward would differentiate through NMS gathers.
        return (jax.lax.stop_gradient(boxes), jax.lax.stop_gradient(scores),
                valid)
