"""Cascade RPN (reference mmdet/models/dense_heads/cascade_rpn_head.py,
core/bbox/assigners/region_assigner.py).

Two-stage RPN refinement: stage 1 regresses anchor offsets with a
region-based assignment (center cells of each gt on its scale-mapped
level); stage 2 re-assigns by IoU on the refined anchors and adds the
objectness branch. The reference's adaptive (offset-guided) convs become
a deform conv driven by the stage-1 deltas — same alignment idea, dense
tap gathers.
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
from ...core.post_processing.nms import batched_nms_padded
from ...utils.registry import HEADS
from ..layers import Conv, DeformConv
from .fovea_fsaf_heads import _level_points

INF = 1e8


@HEADS.register_module()
class CascadeRPNHead(nn.Module):
    in_channels: int = 256
    feat_channels: int = 256
    strides: Sequence[int] = (4, 8, 16, 32, 64)
    anchor_scale: int = 8
    center_ratio: float = 0.2
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        self.prior_gen = AnchorGenerator(scales=[self.anchor_scale],
                                         ratios=[1.0],
                                         strides=list(self.strides))
        self.coder = DeltaXYWHBBoxCoder(
            target_stds=(0.1, 0.1, 0.5, 0.5))
        tc = dict(self.train_cfg or {})
        asn = dict(tc.get("assigner", dict(pos_iou_thr=0.7,
                                           neg_iou_thr=0.3,
                                           min_pos_iou=0.3)))
        asn.pop("type", None)
        self.assigner2 = MaxIoUAssigner(**asn)
        self.rpn_conv1 = Conv(self.feat_channels, 3, 1, 1, dtype=self.dtype)
        self.reg1 = Conv(4, 1, 1, 0, dtype=self.dtype)
        self.offset_conv = Conv(18, 1, 1, 0, dtype=self.dtype)
        self.adapt = DeformConv(self.feat_channels, 3, padding=1)
        self.cls2 = Conv(1, 1, 1, 0, dtype=self.dtype)
        self.reg2 = Conv(4, 1, 1, 0, dtype=self.dtype)

    def __call__(self, feats):
        reg1s, cls2s, reg2s = [], [], []
        for x in feats:
            h = nn.relu(self.rpn_conv1(x))
            r1 = self.reg1(h).astype(jnp.float32)
            off = self.offset_conv(
                jax.lax.stop_gradient(r1)).astype(jnp.float32)
            ha = nn.relu(self.adapt(h, off))
            cls2s.append(self.cls2(ha).astype(jnp.float32))
            reg2s.append(self.reg2(ha).astype(jnp.float32))
            reg1s.append(r1)
        return cls2s, reg2s, reg1s

    def _region_targets(self, points, sids, strides_pp, gt, gtv):
        """Stage-1 region assignment: center cells on the scale level."""
        nl = len(self.strides)
        scale = jnp.sqrt(jnp.maximum(
            (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]), 1e-6))
        lvl = jnp.clip(jnp.round(jnp.log2(
            scale / self.anchor_scale / 4.0 + 1e-6)), 0,
            nl - 1).astype(jnp.int32)
        px, py = points[:, 0:1], points[:, 1:2]
        cx = (gt[None, :, 0] + gt[None, :, 2]) * 0.5
        cy = (gt[None, :, 1] + gt[None, :, 3]) * 0.5
        gw = gt[None, :, 2] - gt[None, :, 0]
        gh = gt[None, :, 3] - gt[None, :, 1]
        r = self.center_ratio
        center = ((px >= cx - 0.5 * r * gw) & (px <= cx + 0.5 * r * gw)
                  & (py >= cy - 0.5 * r * gh) & (py <= cy + 0.5 * r * gh))
        on_lvl = sids[:, None] == lvl[None, :]
        cand = center & on_lvl & gtv[None, :]
        area = ((gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]))[None, :]
        am = jnp.where(cand, area, INF)
        gi = jnp.argmin(am, -1)
        pos = jnp.min(am, -1) < INF
        return pos, gt[gi]

    def loss(self, outs, gt_bboxes, gt_valid, rng=None, gt_labels=None):
        cls2s, reg2s, reg1s = outs
        n = cls2s[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls2s]
        points, sids = _level_points(featmap_sizes, self.strides)
        strides_pp = jnp.asarray(np.asarray(self.strides,
                                            np.float32))[sids]
        anchors = self.prior_gen.grid_priors_cat(featmap_sizes)
        r1 = jnp.concatenate([x.reshape(n, -1, 4) for x in reg1s], 1)
        r2 = jnp.concatenate([x.reshape(n, -1, 4) for x in reg2s], 1)
        c2 = jnp.concatenate([x.reshape(n, -1) for x in cls2s], 1)
        refined = self.coder.decode(anchors[None], r1)

        def one(ref, gt, gtv):
            pos1, tgt1 = self._region_targets(points, sids, strides_pp,
                                              gt, gtv)
            a = self.assigner2.assign(jax.lax.stop_gradient(ref), gt, gtv)
            pos2 = a.gt_inds > 0
            neg2 = a.gt_inds == 0
            gi = jnp.clip(a.gt_inds - 1, 0, gt.shape[0] - 1)
            return pos1, tgt1, pos2, neg2, gt[gi]

        pos1, tgt1, pos2, neg2, tgt2 = jax.vmap(one)(refined, gt_bboxes,
                                                     gt_valid)
        np1 = jnp.maximum(jnp.sum(pos1), 1.0)
        d1 = self.coder.encode(anchors[None], tgt1)
        diff1 = jnp.abs(r1 - d1)
        sl1 = jnp.sum(jnp.where(diff1 < 1/9, 4.5 * diff1 ** 2,
                                diff1 - 1/18), -1)
        loss_reg1 = jnp.sum(sl1 * pos1) / np1
        np2 = jnp.maximum(jnp.sum(pos2), 1.0)
        cw = (pos2 | neg2).astype(jnp.float32)
        ce = (jnp.maximum(c2, 0) - c2 * pos2
              + jnp.log1p(jnp.exp(-jnp.abs(c2))))
        loss_cls = jnp.sum(ce * cw) / jnp.maximum(jnp.sum(cw), 1.0)
        d2 = self.coder.encode(jax.lax.stop_gradient(refined), tgt2)
        diff2 = jnp.abs(r2 - d2)
        sl2 = jnp.sum(jnp.where(diff2 < 1/9, 4.5 * diff2 ** 2,
                                diff2 - 1/18), -1)
        loss_reg2 = jnp.sum(sl2 * pos2) / np2
        return dict(loss_rpn_reg_s1=loss_reg1, loss_rpn_cls=loss_cls,
                    loss_rpn_reg_s2=loss_reg2)

    def get_proposals(self, cls_scores, bbox_preds, img_shapes, cfg,
                      reg1s=None):
        cfg = dict(cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        max_per_img = int(cfg.get("max_per_img", 1000))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.7))
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, sids = _level_points(featmap_sizes, self.strides)
        anchors = self.prior_gen.grid_priors_cat(featmap_sizes)
        c2 = jnp.concatenate([x.reshape(n, -1) for x in cls_scores], 1)
        r2 = jnp.concatenate([x.reshape(n, -1, 4) for x in bbox_preds], 1)
        r1 = jnp.concatenate([x.reshape(n, -1, 4) for x in reg1s], 1) \
            if reg1s is not None else jnp.zeros_like(r2)
        lvl = jnp.broadcast_to(sids[None], c2.shape)

        def one(c, ra, rb, lv, shape):
            base = self.coder.decode(anchors, ra)
            boxes = self.coder.decode(base, rb,
                                      max_shape=(shape[0], shape[1]))
            sc = jax.nn.sigmoid(c)
            k = min(nms_pre, sc.shape[0])
            top, ti = jax.lax.top_k(sc, k)
            keep = batched_nms_padded(boxes[ti], top, lv[ti], iou_thr,
                                      valid=top > 0)
            scm = jnp.where(keep, top, -jnp.inf)
            m = min(max_per_img, k)
            ts, ii = jax.lax.top_k(scm, m)
            ov = ts > -jnp.inf
            return (jax.lax.stop_gradient(
                jnp.where(ov[:, None], boxes[ti][ii], 0.0)),
                jnp.where(ov, ts, 0.0), ov)

        return jax.vmap(one)(c2, r1, r2, lvl, img_shapes)
