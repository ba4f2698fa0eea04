"""YOLOv3 head + OA-DG contrastive variant (reference
mmdet/models/dense_heads/yolo_head.py:24 and yolo_head_cont.py:24).

Static-shape design: per-image targets over concatenated multi-level
anchors (grid assignment as masked argmax), dense target/neg maps instead
of index lists; the OA-DG variant adds per-level 256-d cont conv maps, JSD
consistency on conf/cls maps across views, and supcontrast over sampled
anchor embeddings (yolo_head_cont.py:339-466).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.bbox.coder import YOLOBBoxCoder
from ...core.bbox.geometry import bbox_overlaps
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import (HEADS, LOSSES, PRIOR_GENERATORS,
                               build_from_cfg)
from ..layers import Conv, ConvModule
from ..losses.common import binary_cross_entropy_with_logits, weight_reduce_loss
from ..losses.oadg import jsd_consistency, supcontrast


class YOLOAnchorGenerator:
    """Multi-size grid priors (reference core/anchor YOLOAnchorGenerator;
    registered in PRIOR_GENERATORS for config-driven construction)."""

    def __init__(self, base_sizes, strides):
        self.base_sizes = base_sizes
        self.strides = [s if isinstance(s, (tuple, list)) else (s, s)
                        for s in strides]

    @property
    def num_base_priors(self):
        return [len(b) for b in self.base_sizes]

    def grid_priors(self, featmap_sizes) -> List[jnp.ndarray]:
        # jnp (staged iota), not numpy — a host grid would embed a dense
        # (HWA, 4) constant in the HLO (see core/anchor docstring)
        out = []
        for (h, w), sizes, (sw, sh) in zip(featmap_sizes, self.base_sizes,
                                           self.strides):
            cx = (jnp.arange(w, dtype=jnp.float32) + 0.5) * sw
            cy = (jnp.arange(h, dtype=jnp.float32) + 0.5) * sh
            cxx = jnp.broadcast_to(cx[None, :], (h, w)).reshape(-1)
            cyy = jnp.broadcast_to(cy[:, None], (h, w)).reshape(-1)
            anchors = []
            for (bw, bh) in sizes:
                anchors.append(jnp.stack([cxx - bw / 2, cyy - bh / 2,
                                          cxx + bw / 2, cyy + bh / 2], -1))
            # location-major, anchors innermost
            out.append(jnp.stack(anchors, axis=1).reshape(-1, 4))
        return out

    def responsible_indices(self, featmap_sizes):
        """Helpers for responsible flags: cell index per anchor row."""
        idx = []
        for (h, w), sizes in zip(featmap_sizes, self.base_sizes):
            cell = np.repeat(np.arange(h * w), len(sizes))
            idx.append(cell)
        return idx


PRIOR_GENERATORS.register_module(module=YOLOAnchorGenerator)


@HEADS.register_module()
class YOLOV3Head(nn.Module):
    num_classes: int = 80
    in_channels: Sequence[int] = (512, 256, 128)
    out_channels: Sequence[int] = (1024, 512, 256)
    anchor_generator: Any = None
    bbox_coder: Any = None
    featmap_strides: Sequence[int] = (32, 16, 8)
    one_hot_smoother: float = 0.0
    loss_cls: Any = None
    loss_conf: Any = None
    loss_xy: Any = None
    loss_wh: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    norm_cfg: Any = None
    dtype: Any = None

    def setup(self):
        ag = dict(self.anchor_generator or dict(
            base_sizes=[[(116, 90), (156, 198), (373, 326)],
                        [(30, 61), (62, 45), (59, 119)],
                        [(10, 13), (16, 30), (33, 23)]],
            strides=[32, 16, 8]))
        ag.pop("type", None)
        self.prior_gen = YOLOAnchorGenerator(**ag)
        self.coder = YOLOBBoxCoder()
        self.l_cls = build_from_cfg(dict(self.loss_cls or dict(
            type="CrossEntropyLoss", use_sigmoid=True, loss_weight=1.0)), LOSSES)
        self.l_conf = build_from_cfg(dict(self.loss_conf or dict(
            type="CrossEntropyLoss", use_sigmoid=True, loss_weight=1.0)), LOSSES)
        self.l_xy = build_from_cfg(dict(self.loss_xy or dict(
            type="CrossEntropyLoss", use_sigmoid=True, loss_weight=2.0,
            reduction="sum")), LOSSES)
        self.l_wh = build_from_cfg(dict(self.loss_wh or dict(
            type="MSELoss", loss_weight=2.0, reduction="sum")), LOSSES)
        tc = dict(self.train_cfg or {})
        asn = dict(tc.get("assigner", dict(pos_iou_thr=0.5, neg_iou_thr=0.5,
                                           min_pos_iou=0.0)))
        self.pos_iou_thr = float(asn.get("pos_iou_thr", 0.5))
        self.neg_iou_thr = float(asn.get("neg_iou_thr", 0.5))
        self.min_pos_iou = float(asn.get("min_pos_iou", 0.0))
        na = self.prior_gen.num_base_priors[0]
        self.bridges = [ConvModule(self.out_channels[i], 3, 1, 1,
                                   norm_cfg=self.norm_cfg or dict(type="BN"),
                                   act="leaky_relu", dtype=self.dtype,
                                   name=f"conv_bridge{i}")
                        for i in range(len(self.in_channels))]
        from ..layers import normal_init
        # reference yolo_head.py init_cfg: Normal(std=0.01) on convs_pred
        self.preds = [Conv(na * self.num_attrib, 1, 1, 0,
                           kernel_init=normal_init(0.01), dtype=self.dtype,
                           name=f"conv_pred{i}")
                      for i in range(len(self.in_channels))]

    @property
    def num_attrib(self):
        return 5 + self.num_classes

    def __call__(self, feats):
        maps = []
        for i, x in enumerate(feats):
            maps.append(self.preds[i](self.bridges[i](x)))
        return (maps,)

    # ---------------- targets ----------------

    def _targets_single(self, anchors, cell_ids, strides, gt, gtv, gtl):
        """Grid assignment (reference GridAssigner semantics): returns
        target_map (K, num_attrib), neg_map (K,)."""
        k = anchors.shape[0]
        ious = bbox_overlaps(anchors, gt)                   # (K, G)
        ious = jnp.where(gtv[None, :], ious, -1.0)
        max_iou = jnp.max(ious, axis=1)
        neg_map = (max_iou < self.neg_iou_thr) & (max_iou >= 0)

        # responsible anchors: cell containing the gt center at each level
        cx = (gt[:, 0] + gt[:, 2]) / 2
        cy = (gt[:, 1] + gt[:, 3]) / 2
        # per anchor: which gt (if any) it is responsible for & best iou
        gx = jnp.floor(cx[None, :] / strides[:, None])      # (K, G)
        gy = jnp.floor(cy[None, :] / strides[:, None])
        anchor_cx = jnp.floor(((anchors[:, 0] + anchors[:, 2]) / 2)[:, None]
                              / strides[:, None])
        anchor_cy = jnp.floor(((anchors[:, 1] + anchors[:, 3]) / 2)[:, None]
                              / strides[:, None])
        responsible = (gx == anchor_cx) & (gy == anchor_cy) & gtv[None, :]
        r_ious = jnp.where(responsible, ious, -1.0)
        # for each gt: responsible anchor with max iou (> min_pos_iou)
        best_anchor = jnp.argmax(r_ious, axis=0)            # (G,)
        best_iou = jnp.max(r_ious, axis=0)
        pos_mask = jnp.zeros((k,), bool)
        gt_of_anchor = jnp.zeros((k,), jnp.int32)
        g = gt.shape[0]
        sel = gtv & (best_iou > self.min_pos_iou)
        pos_mask = pos_mask.at[best_anchor].max(sel)
        gt_of_anchor = gt_of_anchor.at[best_anchor].max(
            jnp.where(sel, jnp.arange(g, dtype=jnp.int32), 0))

        matched_gt = gt[gt_of_anchor]
        deltas = self.coder.encode(anchors, matched_gt, strides)
        onehot = jax.nn.one_hot(gtl[gt_of_anchor], self.num_classes)
        if self.one_hot_smoother:
            onehot = onehot * (1 - self.one_hot_smoother) \
                + self.one_hot_smoother / self.num_classes
        target = jnp.concatenate(
            [deltas, pos_mask[:, None].astype(jnp.float32), onehot], axis=-1)
        target = jnp.where(pos_mask[:, None], target,
                           jnp.zeros_like(target))
        neg_map = neg_map & ~pos_mask
        return target, neg_map

    def loss(self, pred_maps, gt_bboxes, gt_valid, gt_labels, rng=None):
        n = pred_maps[0].shape[0]
        featmap_sizes = [tuple(m.shape[1:3]) for m in pred_maps]
        anchors_np = self.prior_gen.grid_priors(featmap_sizes)
        strides = jnp.concatenate([
            jnp.full((len(a),), s, jnp.float32)
            for a, s in zip(anchors_np, self.featmap_strides)])
        anchors = jnp.concatenate(anchors_np)
        cell_ids = None

        pred = jnp.concatenate(
            [m.reshape(n, -1, self.num_attrib) for m in pred_maps], axis=1)

        target, neg = jax.vmap(
            lambda g, v, l: self._targets_single(anchors, cell_ids, strides,
                                                 g, v, l))(
            gt_bboxes, gt_valid, gt_labels)
        pos = target[..., 4]
        pos_and_neg = jnp.clip(pos + neg.astype(jnp.float32), 0, 1)

        pred32 = pred.astype(jnp.float32)
        losses = dict(
            loss_cls=self.l_cls(pred32[..., 5:], target[..., 5:],
                                weight=pos[..., None]),
            loss_conf=self.l_conf(pred32[..., 4], target[..., 4],
                                  weight=pos_and_neg),
            loss_xy=self.l_xy(pred32[..., :2], target[..., :2],
                              weight=pos[..., None]),
            loss_wh=self.l_wh(pred32[..., 2:4], target[..., 2:4],
                              weight=pos[..., None]),
        )
        return losses

    # ---------------- inference ----------------

    def get_bboxes(self, pred_maps, img_shapes, scale_factors,
                   rescale=True, cfg=None):
        # accept the raw forward outs tuple ((maps,) or (maps, conts))
        if isinstance(pred_maps, tuple) and isinstance(pred_maps[0],
                                                       (list, tuple)):
            pred_maps = pred_maps[0]
        cfg = dict(cfg or self.test_cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        conf_thr = float(cfg.get("conf_thr", 0.005))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.45))
        max_per_img = int(cfg.get("max_per_img", 100))

        n = pred_maps[0].shape[0]
        featmap_sizes = [tuple(m.shape[1:3]) for m in pred_maps]
        anchors_np = self.prior_gen.grid_priors(featmap_sizes)

        def one(maps, shape, sf):
            all_boxes, all_scores, all_valid = [], [], []
            for m, anch, stride in zip(maps, anchors_np,
                                       self.featmap_strides):
                p = m.reshape(-1, self.num_attrib).astype(jnp.float32)
                xy = jax.nn.sigmoid(p[:, :2])
                conf = jax.nn.sigmoid(p[:, 4])
                cls = jax.nn.sigmoid(p[:, 5:])
                boxes = self.coder.decode(
                    jnp.asarray(anch),
                    jnp.concatenate([xy, p[:, 2:4]], -1),
                    jnp.full((p.shape[0],), float(stride)))
                k = min(nms_pre, p.shape[0])
                top_conf, ti = jax.lax.top_k(conf, k)
                boxes = boxes[ti]
                scores = cls[ti] * top_conf[:, None]
                valid = top_conf > conf_thr
                all_boxes.append(boxes)
                all_scores.append(scores)
                all_valid.append(valid)
            boxes = jnp.concatenate(all_boxes)
            scores = jnp.concatenate(all_scores)
            valid = jnp.concatenate(all_valid)
            if rescale:
                boxes = boxes / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            scores = jnp.where(valid[:, None], scores, 0.0)
            pad_scores = jnp.concatenate(
                [scores, jnp.zeros((scores.shape[0], 1))], axis=-1)
            return multiclass_nms(boxes, pad_scores, score_thr, iou_thr,
                                  max_per_img, self.num_classes)

        return jax.vmap(one)(tuple(pred_maps), img_shapes, scale_factors)


@HEADS.register_module()
class YOLOV3HeadCont(YOLOV3Head):
    """OA-DG YOLOv3 head (reference yolo_head_cont.py:24): extra 256-d cont
    conv per level; JSD consistency on conf/cls across views; supcontrast
    over sampled anchor embeddings."""
    cont_feat_channels: int = 256
    jsd_conf_weight: float = 1.0
    jsd_cls_weight: float = 1.0
    cont_loss_weight: float = 0.1
    temperature: float = 0.07
    max_cont_anchors: int = 512
    wo_pos: bool = False             # reference yolo_head_cont.py:93
    cont_cfg: Any = None             # dict(loss_weight=, dim=, temperature=)

    def setup(self):
        super().setup()
        # cont_cfg is the reference's config schema
        # (yolo_head_cont.py:84-90: loss_weight/dim/temperature keys);
        # explicit fields take effect when cont_cfg is absent.
        cc = dict(self.cont_cfg or {})
        self.cont_w = float(cc.get("loss_weight", self.cont_loss_weight))
        self.cont_dim = int(cc.get("dim", self.cont_feat_channels))
        self.cont_temper = float(cc.get("temperature", self.temperature))
        self.cont_convs = [
            ConvModule(self.cont_dim, 3, 1, 1,
                       norm_cfg=self.norm_cfg or dict(type="BN"),
                       act="leaky_relu", dtype=self.dtype,
                       name=f"conv_cont{i}")
            for i in range(len(self.in_channels))]

    def __call__(self, feats):
        maps, conts = [], []
        for i, x in enumerate(feats):
            bridge = self.bridges[i](x)
            maps.append(self.preds[i](bridge))
            conts.append(self.cont_convs[i](x))
        return maps, conts

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        pred_maps, cont_maps = outs
        n = pred_maps[0].shape[0]
        v = self.num_views
        b = n // max(v, 1)
        # Supervised losses are VIEW-1 ONLY (reference yolo_head_cont.py
        # loss_single slices pred[[0,1]] = the first samples_per_gpu=2
        # entries of the views-major batch, i.e. view 1).
        if v > 1:
            losses = super().loss([m[:b] for m in pred_maps],
                                  gt_bboxes[:b], gt_valid[:b], gt_labels[:b])
        else:
            losses = super().loss(pred_maps, gt_bboxes, gt_valid, gt_labels)
        pred = jnp.concatenate(
            [m.reshape(n, -1, self.num_attrib) for m in pred_maps], axis=1)
        pred32 = pred.astype(jnp.float32)
        k = pred.shape[1]
        if v > 1:
            # per-view target maps: jsd_cls multiplies logits by its row's
            # own pos mask unless wo_pos (yolo_head_cont.py:437); the cont
            # sampling reuses them below.
            featmap_sizes = [tuple(m.shape[1:3]) for m in pred_maps]
            anchors_np = self.prior_gen.grid_priors(featmap_sizes)
            strides_all = jnp.concatenate([
                jnp.full((len(a),), s, jnp.float32)
                for a, s in zip(anchors_np, self.featmap_strides)])
            anchors_all = jnp.concatenate(anchors_np)
            tgt_all, _ = jax.vmap(
                lambda g, vv, l: self._targets_single(
                    anchors_all, None, strides_all, g, vv, l))(
                gt_bboxes, gt_valid, gt_labels)
            pos_all = tgt_all[..., 4:5]                        # (N, K, 1)
        if v > 1 and self.jsd_conf_weight:
            # batchmean: reference divides each view-chunk KL sum by its
            # leading dim (= b), per level; summing levels first and
            # dividing once by b is identical.
            losses["loss_csconf"] = self.jsd_conf_weight * jsd_consistency(
                pred32[..., 4].reshape(n, -1, 1), v, float(b))
        if v > 1 and self.jsd_cls_weight:
            cls_logits = pred32[..., 5:]
            if not self.wo_pos:
                cls_logits = cls_logits * pos_all
            losses["loss_cscls"] = self.jsd_cls_weight * jsd_consistency(
                cls_logits, v, float(b))
        if v > 1 and self.cont_w and rng is not None:
            # sample pos + random negative anchor embeddings; views share
            # the same anchor indices — the supcontrast_yolo mask pairs
            # row i of view 1 with row i of view 2 as "same instance"
            # (reference contrastive_loss.py:269-275)
            # repeat per-anchor count per location (cont maps are
            # per-location, pred maps per-anchor)
            reps = [len(bs) for bs in self.prior_gen.base_sizes]
            cont = jnp.concatenate([
                jnp.repeat(c.reshape(n, fs[0] * fs[1], -1), r, axis=1)
                for c, fs, r in zip(
                    [c.reshape(n, -1, self.cont_dim)
                     for c in cont_maps], featmap_sizes, reps)], axis=1)
            pos = tgt_all[:, :, 4] > 0                  # (N, K)
            m = self.max_cont_anchors
            rank = jnp.where(pos[:b], 0.0, 1.0) + \
                jax.random.uniform(rng, pos[:b].shape) * 0.1
            sel = jnp.argsort(rank, axis=1)[:, :m]      # pos first + random
            labels_full = jnp.where(
                pos, jnp.argmax(tgt_all[..., 5:], -1), self.num_classes)
            feats_sel = []
            labels_sel = []
            for view in range(v):
                rows = cont[view * b:(view + 1) * b]
                lab = labels_full[view * b:(view + 1) * b]
                feats_sel.append(jnp.take_along_axis(
                    rows, sel[..., None], axis=1).reshape(-1, rows.shape[-1]))
                labels_sel.append(jnp.take_along_axis(lab, sel, axis=1)
                                  .reshape(-1))
            all_feats = jnp.concatenate(feats_sel).astype(jnp.float32)
            all_labels = jnp.concatenate(labels_sel)
            valid = jnp.ones_like(all_labels, bool)
            losses["loss_cont"] = self.cont_w * supcontrast(
                all_feats, all_labels, valid, (m * b, v, 0),
                temper=self.cont_temper)
        return losses
