"""FreeAnchor retina head + RetinaSepBN head.

References: mmdet/models/dense_heads/free_anchor_retina_head.py (detection-
customized max-likelihood: per-gt anchor bags, positive bag loss + focal
negative loss), mmdet/models/dense_heads/retina_sepbn_head.py (NAS-FPN's
shared-conv / per-level-BN retina head).

Static-shape port: mmdet gathers per-gt bag indices with nonzero(); here
bags are a (G, topk) gather from the dense (N, G) IoU matrix, and invalid
gts are masked out of both bag and box-prob terms.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.bbox.geometry import bbox_overlaps
from ...utils.registry import HEADS
from ..layers import FrozenBN
from .retina_head import RetinaHead


@HEADS.register_module()
class FreeAnchorRetinaHead(RetinaHead):
    pre_anchor_topk: int = 50
    bbox_thr: float = 0.6
    gamma: float = 2.0
    alpha: float = 0.5

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_gen.grid_priors_cat(featmap_sizes)
        cls = jnp.concatenate(
            [s.reshape(n, -1, self.num_classes) for s in cls_scores],
            axis=1).astype(jnp.float32)
        reg = jnp.concatenate(
            [b.reshape(n, -1, 4) for b in bbox_preds],
            axis=1).astype(jnp.float32)
        prob = jax.nn.sigmoid(cls)                               # (B,N,C)
        k = self.pre_anchor_topk

        def one(prob_i, reg_i, gt, gtv, gtl):
            ious = bbox_overlaps(gt, anchors)                    # (G,N)
            ious = jnp.where(gtv[:, None], ious, 0.0)
            # ---- negative: P(object|anchor,class) from IoU saturation
            t1 = self.bbox_thr
            t2 = jnp.clip(jnp.max(ious, -1, keepdims=True),
                          a_min=t1 + 1e-12)
            obj_prob = jnp.clip((ious - t1) / (t2 - t1), 0.0, 1.0)  # (G,N)
            obj_prob = jnp.where(gtv[:, None], obj_prob, 0.0)
            cls_oh = jax.nn.one_hot(gtl, self.num_classes)       # (G,C)
            # image_box_prob[a,c] = max over gt of class c
            box_prob = jnp.max(obj_prob[:, :, None] * cls_oh[:, None, :],
                               axis=0)                           # (N,C)
            neg_prob = prob_i * (1 - box_prob)
            neg_bag = (neg_prob ** self.gamma
                       * -jnp.log(jnp.clip(1 - neg_prob, 1e-12, 1.0)))
            # ---- positive: per-gt anchor bag
            bag_iou, bag_idx = jax.lax.top_k(ious, k)            # (G,k)
            bag_cls = prob_i[bag_idx.reshape(-1)].reshape(
                gt.shape[0], k, self.num_classes)
            m_cls = jnp.take_along_axis(
                bag_cls, jnp.broadcast_to(gtl[:, None, None],
                                          (gt.shape[0], k, 1)),
                axis=2)[..., 0]
            anch = anchors[bag_idx.reshape(-1)].reshape(gt.shape[0], k, 4)
            pred = reg_i[bag_idx.reshape(-1)].reshape(gt.shape[0], k, 4)
            tgt = self.coder.encode(anch, gt[:, None, :])
            # smooth-l1 box likelihood (reference :239-244)
            beta = getattr(self.reg_loss, "beta", 0.11)
            d = jnp.abs(pred - tgt)
            sl1 = jnp.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
            m_box = jnp.exp(-self.reg_loss.loss_weight * jnp.sum(sl1, -1))
            m = jnp.clip(m_cls * m_box, 0.0, 1.0 - 1e-6)        # (G,k)
            w = m / jnp.clip(1 - m, 1e-12, None)
            w = w / jnp.clip(jnp.sum(w, -1, keepdims=True), 1e-12, None)
            bag_prob = jnp.sum(w * m, -1)                        # (G,)
            pos_bag = -jnp.log(jnp.clip(bag_prob, 1e-12, 1.0)) * gtv
            return jnp.sum(neg_bag), jnp.sum(pos_bag), jnp.sum(gtv)

        neg, pos, ng = jax.vmap(one)(prob, reg, gt_bboxes, gt_valid,
                                     gt_labels)
        num_gts = jnp.maximum(jnp.sum(ng), 1.0)
        loss_pos = self.alpha * jnp.sum(pos) / num_gts
        loss_neg = ((1 - self.alpha) * jnp.sum(neg)
                    / jnp.maximum(num_gts * k, 1.0))
        return dict(positive_bag_loss=loss_pos, negative_bag_loss=loss_neg)


@HEADS.register_module()
class RetinaSepBNHead(RetinaHead):
    """Retina head with shared conv weights but per-level BN (reference
    retina_sepbn_head.py, used by NAS-FPN configs)."""
    num_levels: int = 5

    def setup(self):
        super().setup()
        self.cls_bns = [[FrozenBN(frozen=False, name=f"cls_bn{li}_{i}")
                         for i in range(self.stacked_convs)]
                        for li in range(self.num_levels)]
        self.reg_bns = [[FrozenBN(frozen=False, name=f"reg_bn{li}_{i}")
                         for i in range(self.stacked_convs)]
                        for li in range(self.num_levels)]

    def __call__(self, feats):
        cls_scores, bbox_preds = [], []
        for li, x in enumerate(feats):
            c = r = x
            for i, conv in enumerate(self.cls_convs):
                c = nn.relu(self.cls_bns[li][i](conv(c)))
            for i, conv in enumerate(self.reg_convs):
                r = nn.relu(self.reg_bns[li][i](conv(r)))
            cls_scores.append(self.retina_cls(c))
            bbox_preds.append(self.retina_reg(r))
        return (cls_scores, bbox_preds)
