"""YOLOX head (reference mmdet/models/dense_heads/yolox_head.py:25) with a
static-shape SimOTA assigner (reference
mmdet/core/bbox/assigners/sim_ota_assigner.py:12).

Decoupled per-level stems (cls tower / reg tower), outputs cls (C),
bbox (4: xy offset + wh log), objectness (1). Training: SimOTA dynamic-k
matching fully vectorized over (points x gts) — dynamic_k from the top-10
IoU sum, selection by cost rank, conflicts resolved by min-cost — no ragged
indexing anywhere.
"""
from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.bbox.geometry import bbox_overlaps
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import DETECTORS, HEADS
from ..backbones.csp_darknet import ConvBNSiLU


def simota_assign(cost, ious, valid_candidate, gt_valid, topk: int = 10):
    """cost (P, G) lower=better; ious (P, G); valid_candidate (P, G) bool
    (center prior); gt_valid (G,). Returns assigned (P,) int32
    (0 = background, j+1 = gt j) — reference SimOTAAssigner.assign."""
    p, g = cost.shape
    big = 1e9
    cost = jnp.where(valid_candidate & gt_valid[None], cost, big)
    # dynamic k per gt: sum of top-10 candidate IoUs, clamped >= 1
    iou_m = jnp.where(valid_candidate & gt_valid[None], ious, 0.0)
    topk_ious = jax.lax.top_k(iou_m.T, min(topk, p))[0]        # (G, k)
    dynamic_k = jnp.clip(jnp.sum(topk_ious, axis=1).astype(jnp.int32), 1, p)
    # rank candidates per gt by cost; select rank < dynamic_k
    order = jnp.argsort(cost, axis=0)                          # (P, G)
    ranks = jnp.zeros((p, g), jnp.int32)
    ranks = ranks.at[order, jnp.arange(g)[None, :]].set(
        jnp.arange(p, dtype=jnp.int32)[:, None])
    selected = (ranks < dynamic_k[None, :]) & (cost < big)
    # conflicts: point matched to >1 gt keeps the min-cost gt
    sel_cost = jnp.where(selected, cost, big)
    best_gt = jnp.argmin(sel_cost, axis=1)                     # (P,)
    has = jnp.min(sel_cost, axis=1) < big
    return jnp.where(has, best_gt.astype(jnp.int32) + 1, 0)


@HEADS.register_module()
class YOLOXHead(nn.Module):
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 2
    strides: Sequence[int] = (8, 16, 32)
    center_radius: float = 2.5
    loss_weight_obj: float = 1.0
    loss_weight_cls: float = 1.0
    loss_weight_bbox: float = 5.0
    loss_weight_l1: float = 1.0
    use_l1: bool = False             # flipped on by YOLOXModeSwitchHook
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        self.stems = [ConvBNSiLU(self.feat_channels, 1, dtype=self.dtype,
                                 name=f"stem{i}")
                      for i in range(len(self.strides))]
        self.cls_towers = [
            [ConvBNSiLU(self.feat_channels, 3, dtype=self.dtype,
                        name=f"cls{i}_{j}") for j in range(self.stacked_convs)]
            for i in range(len(self.strides))]
        self.reg_towers = [
            [ConvBNSiLU(self.feat_channels, 3, dtype=self.dtype,
                        name=f"reg{i}_{j}") for j in range(self.stacked_convs)]
            for i in range(len(self.strides))]
        self.cls_preds = [nn.Conv(self.num_classes, (1, 1), dtype=self.dtype,
                                  name=f"cls_pred{i}")
                          for i in range(len(self.strides))]
        self.reg_preds = [nn.Conv(4, (1, 1), dtype=self.dtype,
                                  name=f"reg_pred{i}")
                          for i in range(len(self.strides))]
        self.obj_preds = [nn.Conv(1, (1, 1), dtype=self.dtype,
                                  name=f"obj_pred{i}")
                          for i in range(len(self.strides))]

    def __call__(self, feats):
        cls_scores, bbox_preds, objectnesses = [], [], []
        for i, x in enumerate(feats[:len(self.strides)]):
            x = self.stems[i](x)
            c = r = x
            for conv in self.cls_towers[i]:
                c = conv(c)
            for conv in self.reg_towers[i]:
                r = conv(r)
            cls_scores.append(self.cls_preds[i](c))
            bbox_preds.append(self.reg_preds[i](r))
            objectnesses.append(self.obj_preds[i](r))
        return (cls_scores, bbox_preds, objectnesses)

    def _points(self, featmap_sizes):
        # jnp (staged iota), not numpy — avoids dense HLO grid constants
        pts, strides = [], []
        for (h, w), s in zip(featmap_sizes, self.strides):
            xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) * s
            ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) * s
            px = jnp.broadcast_to(xs[None, :], (h, w)).reshape(-1)
            py = jnp.broadcast_to(ys[:, None], (h, w)).reshape(-1)
            pts.append(jnp.stack([px, py], -1))
            strides.append(jnp.full((h * w,), s, jnp.float32))
        return jnp.concatenate(pts), jnp.concatenate(strides)

    def _decode(self, reg, pts, strides):
        xy = reg[..., :2] * strides[:, None] + pts
        wh = jnp.exp(jnp.clip(reg[..., 2:], -10, 8)) * strides[:, None]
        return jnp.concatenate([xy - wh / 2, xy + wh / 2], -1)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds, objectnesses = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        pts, strides = self._points(featmap_sizes)
        cls = jnp.concatenate([s.reshape(n, -1, self.num_classes)
                               for s in cls_scores], 1).astype(jnp.float32)
        reg = jnp.concatenate([b.reshape(n, -1, 4)
                               for b in bbox_preds], 1).astype(jnp.float32)
        obj = jnp.concatenate([o.reshape(n, -1)
                               for o in objectnesses], 1).astype(jnp.float32)
        boxes = jax.vmap(lambda r: self._decode(r, pts, strides))(reg)

        def one(cls_i, obj_i, reg_i, boxes_i, gt, gtv, gtl):
            ious = bbox_overlaps(boxes_i, gt)                  # (P, G)
            inside = ((pts[:, 0:1] >= gt[None, :, 0])
                      & (pts[:, 0:1] <= gt[None, :, 2])
                      & (pts[:, 1:2] >= gt[None, :, 1])
                      & (pts[:, 1:2] <= gt[None, :, 3]))
            cx = (gt[:, 0] + gt[:, 2]) / 2
            cy = (gt[:, 1] + gt[:, 3]) / 2
            r = self.center_radius * strides[:, None]
            in_center = ((jnp.abs(pts[:, 0:1] - cx[None]) < r)
                         & (jnp.abs(pts[:, 1:2] - cy[None]) < r))
            valid_cand = inside | in_center
            prob = jax.nn.sigmoid(cls_i) * jax.nn.sigmoid(obj_i)[:, None]
            onehot = jax.nn.one_hot(gtl, self.num_classes)     # (G, C)
            # cls cost: BCE of sqrt(joint prob) against gt one-hot
            pr = jnp.sqrt(jnp.clip(prob, 1e-8, 1.0))
            cls_cost = -(onehot[None] * jnp.log(pr[:, None])
                         + (1 - onehot[None]) * jnp.log(1 - pr[:, None] + 1e-8)
                         ).sum(-1)
            iou_cost = -jnp.log(jnp.clip(ious, 1e-8, 1.0))
            cost = cls_cost + 3.0 * iou_cost + 1e5 * (~(inside & in_center))
            assigned = simota_assign(cost, ious, valid_cand, gtv)
            pos = assigned > 0
            matched = jnp.clip(assigned - 1, 0, gt.shape[0] - 1)
            num_pos = jnp.maximum(jnp.sum(pos), 1.0)
            posf = pos.astype(jnp.float32)
            # objectness BCE everywhere
            obj_t = posf
            obj_l = jnp.maximum(obj_i, 0) - obj_i * obj_t + jnp.log1p(
                jnp.exp(-jnp.abs(obj_i)))
            # cls BCE at positives (target = onehot * IoU)
            tgt_iou = jnp.take_along_axis(ious, matched[:, None], 1)[:, 0]
            cls_t = jax.nn.one_hot(gtl[matched], self.num_classes) \
                * tgt_iou[:, None]
            cls_l = (jnp.maximum(cls_i, 0) - cls_i * cls_t + jnp.log1p(
                jnp.exp(-jnp.abs(cls_i)))).sum(-1)
            # IoU loss at positives
            iou_l = 1.0 - jnp.take_along_axis(ious, matched[:, None], 1) ** 2
            # L1 on raw deltas (reference yolox_head.py _get_l1_target;
            # enabled for the last num_last_epochs by YOLOXModeSwitchHook)
            mgt = gt[matched]
            t_xy = ((mgt[:, :2] + mgt[:, 2:]) / 2 - pts) / strides[:, None]
            t_wh = jnp.log(jnp.clip(
                (mgt[:, 2:] - mgt[:, :2]) / strides[:, None], 1e-8, None))
            l1 = jnp.sum(jnp.abs(reg_i - jnp.concatenate([t_xy, t_wh], -1)),
                         axis=-1)
            return (jnp.sum(obj_l), jnp.sum(cls_l * posf),
                    jnp.sum(iou_l[:, 0] * posf), jnp.sum(l1 * posf), num_pos)

        lo, lc, lb, ll1, np_ = jax.vmap(one)(cls, obj, reg, boxes, gt_bboxes,
                                             gt_valid, gt_labels)
        tot = jnp.maximum(jnp.sum(np_), 1.0)
        losses = dict(
            loss_obj=self.loss_weight_obj * jnp.sum(lo) / tot,
            loss_cls=self.loss_weight_cls * jnp.sum(lc) / tot,
            loss_bbox=self.loss_weight_bbox * jnp.sum(lb) / tot)
        if self.use_l1:
            losses["loss_l1"] = self.loss_weight_l1 * jnp.sum(ll1) / tot
        return losses

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_scores, bbox_preds, objectnesses = outs
        cfg = dict(cfg or self.test_cfg or {})
        score_thr = float(cfg.get("score_thr", 0.01))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.65))
        max_per_img = int(cfg.get("max_per_img", 100))
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        pts, strides = self._points(featmap_sizes)
        cls = jnp.concatenate([s.reshape(n, -1, self.num_classes)
                               for s in cls_scores], 1).astype(jnp.float32)
        reg = jnp.concatenate([b.reshape(n, -1, 4)
                               for b in bbox_preds], 1).astype(jnp.float32)
        obj = jnp.concatenate([o.reshape(n, -1)
                               for o in objectnesses], 1).astype(jnp.float32)

        def one(cls_i, reg_i, obj_i, shape, sf):
            boxes = self._decode(reg_i, pts, strides)
            scores = jax.nn.sigmoid(cls_i) * jax.nn.sigmoid(obj_i)[:, None]
            if rescale:
                boxes = boxes / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            pad_scores = jnp.concatenate(
                [scores, jnp.zeros((scores.shape[0], 1))], -1)
            return multiclass_nms(boxes, pad_scores, score_thr, iou_thr,
                                  max_per_img, self.num_classes)

        return jax.vmap(one)(cls, reg, obj, img_shapes, scale_factors)


from ..detectors.single_stage import SingleStageDetector  # noqa: E402


@DETECTORS.register_module()
class YOLOX(SingleStageDetector):
    """YOLOX detector (reference mmdet/models/detectors/yolox.py:12)."""
    pass
