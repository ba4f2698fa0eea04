"""PAA head + detector (reference mmdet/models/dense_heads/paa_head.py,
mmdet/models/detectors/paa.py).

Probabilistic anchor assignment: per gt, the top-k anchors per level by IoU
are scored by their current (cls + reg) loss; a 2-component 1-D Gaussian
mixture is fit to the scores and the low-loss component becomes the
positive set. The reference fits sklearn GMMs per gt on CPU; here it is a
fixed-iteration batched EM in jnp (static shapes, runs on device inside the
train step). Includes the IoU-prediction branch and score-voting decode.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.bbox.geometry import bbox_overlaps
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv
from .retina_head import RetinaHead

INF = 1e8


def gmm_em_1d(x, valid, iters: int = 10):
    """Batched 2-component 1-D GMM EM over the last axis.

    x: (..., K) samples; valid: (..., K) bool. Returns responsibility of the
    LOW-mean component, (..., K).
    """
    big = jnp.where(valid, x, 0.0)
    cnt = jnp.maximum(jnp.sum(valid, -1, keepdims=True), 1)
    mean = jnp.sum(big, -1, keepdims=True) / cnt
    var = jnp.sum(jnp.where(valid, (x - mean) ** 2, 0.0), -1,
                  keepdims=True) / cnt + 1e-6
    xmin = jnp.min(jnp.where(valid, x, INF), -1, keepdims=True)
    xmax = jnp.max(jnp.where(valid, x, -INF), -1, keepdims=True)
    mu = jnp.concatenate([xmin, xmax], -1)                      # (...,2)
    sig = jnp.concatenate([var, var], -1)
    pi = jnp.full(mu.shape, 0.5)

    def step(state, _):
        mu, sig, pi = state
        # E-step
        d = x[..., None] - mu[..., None, :]                     # (...,K,2)
        logp = (-0.5 * d * d / sig[..., None, :]
                - 0.5 * jnp.log(2 * np.pi * sig[..., None, :])
                + jnp.log(jnp.clip(pi[..., None, :], 1e-12, None)))
        r = jax.nn.softmax(logp, -1)
        r = jnp.where(valid[..., None], r, 0.0)
        # M-step
        nk = jnp.maximum(jnp.sum(r, -2), 1e-6)                  # (...,2)
        mu2 = jnp.sum(r * x[..., None], -2) / nk
        sig2 = jnp.sum(r * (x[..., None] - mu2[..., None, :]) ** 2,
                       -2) / nk + 1e-6
        pi2 = nk / jnp.maximum(jnp.sum(nk, -1, keepdims=True), 1e-6)
        return (mu2, sig2, pi2), None

    (mu, sig, pi), _ = jax.lax.scan(step, (mu, sig, pi), None, length=iters)
    d = x[..., None] - mu[..., None, :]
    logp = (-0.5 * d * d / sig[..., None, :]
            - 0.5 * jnp.log(2 * np.pi * sig[..., None, :])
            + jnp.log(jnp.clip(pi[..., None, :], 1e-12, None)))
    r = jax.nn.softmax(logp, -1)
    low = jnp.argmin(mu, -1)                                    # (...,)
    r_low = jnp.take_along_axis(r, low[..., None, None], -1)[..., 0]
    return jnp.where(valid, r_low, 0.0)


@HEADS.register_module()
class PAAHead(RetinaHead):
    """PAA = Retina-style towers + centerness/IoU branch + GMM assignment."""
    topk: int = 9
    score_voting: bool = True
    covariance_type: str = "diag"

    def setup(self):
        super().setup()
        na = self.prior_gen.num_base_anchors[0]
        self.retina_iou = Conv(na, 3, 1, 1, dtype=self.dtype)
        self.l_iou = build_from_cfg(dict(
            type="CrossEntropyLoss", use_sigmoid=True, loss_weight=0.5),
            LOSSES)

    def __call__(self, feats):
        cls_scores, bbox_preds, ious = [], [], []
        for x in feats:
            c = r = x
            for conv in self.cls_convs:
                c = nn.relu(conv(c))
            for conv in self.reg_convs:
                r = nn.relu(conv(r))
            cls_scores.append(self.retina_cls(c))
            bbox_preds.append(self.retina_reg(r))
            ious.append(self.retina_iou(r))
        return cls_scores, bbox_preds, ious

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds, iou_preds = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        per_level = self.prior_gen.grid_priors(featmap_sizes)
        anchors = jnp.concatenate(per_level)
        nlb = [a.shape[0] for a in per_level]
        cls = jnp.concatenate([s.reshape(n, -1, self.num_classes)
                               for s in cls_scores], 1).astype(jnp.float32)
        reg = jnp.concatenate([b.reshape(n, -1, 4)
                               for b in bbox_preds], 1).astype(jnp.float32)
        iop = jnp.concatenate([i.reshape(n, -1)
                               for i in iou_preds], 1).astype(jnp.float32)
        decoded = self.coder.decode(anchors[None], reg)
        k = self.topk

        def one(sc, dec, gt, gtv, gtl):
            N, G = anchors.shape[0], gt.shape[0]
            ious = bbox_overlaps(anchors, gt)                    # (N,G)
            ious = jnp.where(gtv[None, :], ious, 0.0)
            # candidate top-k per level per gt
            cand = jnp.zeros((N, G), bool)
            start = 0
            for nl_ in nlb:
                kk = min(k, nl_)
                i_lv = ious[start:start + nl_]
                thr = jax.lax.top_k(i_lv.T, kk)[0][:, -1]
                cand = cand.at[start:start + nl_].set(
                    (i_lv >= jnp.maximum(thr[None, :], 1e-12))
                    & (i_lv > 0))
                start += nl_
            cand = cand & gtv[None, :]
            # per-candidate loss: focal cls at gt class + giou of decoded
            p = jax.nn.sigmoid(sc)                               # (N,C)
            pg = p[:, gtl.astype(jnp.int32)]                     # (N,G)
            cls_l = -((1 - pg) ** 2) * jnp.log(jnp.clip(pg, 1e-12, 1.0))
            giou = bbox_overlaps(dec, gt, mode="giou")           # (N,G)
            loss_cand = cls_l + (1 - giou)
            # GMM over candidates per gt
            big = jnp.where(cand, loss_cand, INF)
            r_low = gmm_em_1d(big.T, cand.T)                     # (G,N)
            pos_mat = (r_low.T > 0.5) & cand
            sel = jnp.where(pos_mat, ious, -1.0)
            gi = jnp.argmax(sel, -1)
            pos = jnp.max(sel, -1) > -0.5
            labels = jnp.where(pos, gtl[gi], self.num_classes)
            tgt = gt[gi]
            iou_t = bbox_overlaps(dec, tgt, is_aligned=True)
            return labels.astype(jnp.int32), pos, tgt, iou_t

        labels, pos, tgt, iou_t = jax.vmap(one)(cls, decoded, gt_bboxes,
                                                gt_valid, gt_labels)
        num_pos = jnp.maximum(jnp.sum(pos), 1.0)
        posf = pos.astype(jnp.float32)
        loss_cls = self.cls_loss(cls.reshape(-1, self.num_classes),
                                 labels.reshape(-1), avg_factor=num_pos)
        giou = bbox_overlaps(decoded.reshape(-1, 4), tgt.reshape(-1, 4),
                             mode="giou", is_aligned=True)
        loss_bbox = jnp.sum((1 - giou) * posf.reshape(-1) * 1.3) / num_pos
        from ..losses.common import binary_cross_entropy_with_logits
        iou_l = binary_cross_entropy_with_logits(
            iop.reshape(-1), jax.lax.stop_gradient(iou_t).reshape(-1))
        loss_iou = jnp.sum(iou_l * posf.reshape(-1) * 0.5) / num_pos
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_iou=loss_iou)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_scores, bbox_preds, iou_preds = outs
        # fold IoU prediction into scores (reference: sqrt(score * iou))
        fused = []
        for s, i in zip(cls_scores, iou_preds):
            sc = jax.nn.sigmoid(s.astype(jnp.float32))
            b, h, w, _ = sc.shape
            scr = sc.reshape(b, h, w, -1, self.num_classes)
            io = jax.nn.sigmoid(i.astype(jnp.float32))[..., None]
            fused.append(jnp.sqrt(jnp.clip(scr * io, 1e-12, 1.0))
                         .reshape(b, h, w, -1))
        # reuse Retina decode on pre-sigmoided scores via logit transform
        logits = [jnp.log(jnp.clip(f, 1e-12, 1.0)
                          / jnp.clip(1 - f, 1e-12, 1.0)) for f in fused]
        return super().get_bboxes((logits, bbox_preds), img_shapes,
                                  scale_factors, rescale=rescale, cfg=cfg)


@DETECTORS.register_module()
class PAA(SingleStageDetector):
    """Alias (reference mmdet/models/detectors/paa.py)."""
    pass
