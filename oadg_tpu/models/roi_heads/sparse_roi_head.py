"""Sparse R-CNN / QueryInst (reference
mmdet/models/dense_heads/embedding_rpn_head.py,
mmdet/models/roi_heads/bbox_heads/dii_head.py,
mmdet/models/roi_heads/sparse_roi_head.py,
mmdet/models/detectors/{sparse_rcnn.py, queryinst.py}).

Learned proposal boxes + features, refined by ``num_stages`` DII heads
(self-attention over proposals, dynamic instance interaction with the RoI
features, FFN), Hungarian-matched focal/L1/GIoU losses per stage. All
static-shape: ``num_proposals`` is fixed; padded gts are masked in the
matcher. The dynamic conv is two batched matmuls.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import jax
import jax.numpy as jnp

from ... import nn
from ...core.bbox.geometry import bbox_overlaps
from ...core.bbox.hungarian import HungarianAssigner, xyxy_to_cxcywh
from ...ops.roi_align import roi_align_multilevel
from ...utils.registry import DETECTORS, HEADS, build_from_cfg
from ..detectors.two_stage import TwoStageDetector
from ..losses.common import sigmoid_focal_loss


@HEADS.register_module()
class EmbeddingRPNHead(nn.Module):
    """Learned proposals (reference embedding_rpn_head.py:10): a (P, 4)
    normalized-cxcywh parameter + (P, C) proposal features, broadcast to
    the batch."""
    num_proposals: int = 100
    proposal_feature_channel: int = 256
    dtype: Any = None

    @nn.compact
    def __call__(self, batch_size, img_whwh):
        """img_whwh: (B, 4) [w, h, w, h] per image."""
        boxes = self.param("init_proposal_bboxes",
                           lambda k, s: jnp.tile(
                               jnp.asarray([[0.5, 0.5, 1.0, 1.0]]),
                               (self.num_proposals, 1)),
                           (self.num_proposals, 4))
        feats = self.param("init_proposal_features",
                           nn.initializers.normal(1.0),
                           (self.num_proposals,
                            self.proposal_feature_channel))
        cx, cy, w, h = (boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3])
        xyxy = jnp.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                         -1)
        abs_boxes = xyxy[None] * img_whwh[:, None, :]
        pf = jnp.tile(feats[None], (batch_size, 1, 1))
        return abs_boxes, pf


class DIIHead(nn.Module):
    """Dynamic Instance Interactive head (reference dii_head.py:16)."""
    num_classes: int = 80
    feat_channels: int = 256
    dim_feedforward: int = 2048
    num_heads: int = 8
    dynamic_dim: int = 64
    pooler_resolution: int = 7
    num_cls_fcs: int = 1
    num_reg_fcs: int = 3
    dtype: Any = None

    @nn.compact
    def __call__(self, roi_feats, prop_feats):
        """roi_feats (B, P, r, r, C); prop_feats (B, P, C)."""
        b, p, r, _, c = roi_feats.shape
        d = self.feat_channels
        # 1) self-attention over the P proposals
        x = prop_feats
        attn = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads, qkv_features=d, dtype=self.dtype,
            name="self_attn")(x, x)
        x = nn.LayerNorm(dtype=jnp.float32, name="norm1")(
            (x + attn).astype(jnp.float32)).astype(prop_feats.dtype)
        # 2) dynamic instance interaction: two generated 1x1 convs applied
        #    to the roi grid (reference DynamicConv)
        params = nn.Dense(2 * d * self.dynamic_dim, dtype=self.dtype,
                          name="dynamic_gen")(x)
        w1 = params[..., :d * self.dynamic_dim].reshape(
            b, p, d, self.dynamic_dim)
        w2 = params[..., d * self.dynamic_dim:].reshape(
            b, p, self.dynamic_dim, d)
        rf = roi_feats.reshape(b, p, r * r, c)
        y = jnp.einsum("bpnc,bpcd->bpnd", rf, w1.astype(rf.dtype),
                       preferred_element_type=jnp.float32)
        y = nn.relu(nn.LayerNorm(dtype=jnp.float32, name="dn1")(y))
        y = jnp.einsum("bpnd,bpdc->bpnc", y.astype(rf.dtype),
                       w2.astype(rf.dtype),
                       preferred_element_type=jnp.float32)
        y = nn.relu(nn.LayerNorm(dtype=jnp.float32, name="dn2")(y))
        y = y.reshape(b, p, r * r * c)
        y = nn.Dense(d, dtype=self.dtype, name="out_proj")(
            y.astype(prop_feats.dtype))
        x = nn.LayerNorm(dtype=jnp.float32, name="norm2")(
            (x + y).astype(jnp.float32)).astype(prop_feats.dtype)
        # 3) FFN
        f = nn.Dense(self.dim_feedforward, dtype=self.dtype,
                     name="ffn1")(x)
        f = nn.Dense(d, dtype=self.dtype, name="ffn2")(nn.relu(f))
        x = nn.LayerNorm(dtype=jnp.float32, name="norm3")(
            (x + f).astype(jnp.float32)).astype(prop_feats.dtype)
        # heads
        cls_f = x
        for i in range(self.num_cls_fcs):
            cls_f = nn.relu(nn.LayerNorm(dtype=jnp.float32,
                                         name=f"cls_ln{i}")(
                nn.Dense(d, use_bias=False, dtype=self.dtype,
                         name=f"cls_fc{i}")(cls_f).astype(jnp.float32))
                .astype(x.dtype))
        reg_f = x
        for i in range(self.num_reg_fcs):
            reg_f = nn.relu(nn.LayerNorm(dtype=jnp.float32,
                                         name=f"reg_ln{i}")(
                nn.Dense(d, use_bias=False, dtype=self.dtype,
                         name=f"reg_fc{i}")(reg_f).astype(jnp.float32))
                .astype(x.dtype))
        cls = nn.Dense(self.num_classes, dtype=self.dtype,
                       name="fc_cls")(cls_f).astype(jnp.float32)
        delta = nn.Dense(4, dtype=self.dtype,
                         name="fc_reg")(reg_f).astype(jnp.float32)
        return cls, delta, x


def _apply_deltas(boxes, deltas):
    """Sparse R-CNN delta application (reference dii_head refine): deltas
    scale/shift in cxcywh with stds (0.5, 0.5, 1, 1)-ish; we use the DETR
    convention the reference DIIHead uses (wx=wy=2, ww=wh=1)."""
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    dx, dy, dw, dh = (deltas[..., 0] / 2.0, deltas[..., 1] / 2.0,
                      deltas[..., 2], deltas[..., 3])
    ncx = cx + dx * w
    ncy = cy + dy * h
    nw = w * jnp.exp(jnp.clip(dw, -4.0, 4.0))
    nh = h * jnp.exp(jnp.clip(dh, -4.0, 4.0))
    return jnp.stack([ncx - nw / 2, ncy - nh / 2, ncx + nw / 2,
                      ncy + nh / 2], -1)


@HEADS.register_module()
class SparseRoIHead(nn.Module):
    """Iterative DII stages with per-stage Hungarian matching (reference
    sparse_roi_head.py:13)."""
    num_stages: int = 6
    stage_loss_weights: Sequence[float] = (1.0,) * 6
    proposal_feature_channel: int = 256
    bbox_roi_extractor: Any = None
    bbox_head: Any = None
    mask_head: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None
    cls_weight: float = 2.0
    l1_weight: float = 5.0
    giou_weight: float = 2.0

    def setup(self):
        bh = dict(self.bbox_head or {})
        bh.pop("type", None)
        bh.setdefault("feat_channels", self.proposal_feature_channel)
        self.stages = [DIIHead(**bh, dtype=self.dtype, name=f"dii{i}")
                       for i in range(self.num_stages)]
        ext = dict(self.bbox_roi_extractor or {})
        roi_layer = dict(ext.get("roi_layer", dict(output_size=7)))
        self.roi_out_size = int(roi_layer.get("output_size", 7))
        self.featmap_strides = tuple(ext.get("featmap_strides",
                                             (4, 8, 16, 32)))
        self.finest_scale = int(ext.get("finest_scale", 56))
        self.sampling_ratio = 2
        self.matcher = HungarianAssigner(
            cls_cost=dict(weight=self.cls_weight),
            reg_cost=dict(weight=self.l1_weight),
            iou_cost=dict(weight=self.giou_weight))
        self.nc = int(bh.get("num_classes", 80))

    def _extract(self, feats, boxes):
        b, p = boxes.shape[:2]
        bidx = jnp.repeat(jnp.arange(b, dtype=jnp.float32), p).reshape(b, p)
        rois = jnp.concatenate([bidx[..., None], boxes], -1).reshape(-1, 5)
        rf = roi_align_multilevel(
            list(feats[: len(self.featmap_strides)]), rois,
            output_size=self.roi_out_size,
            featmap_strides=self.featmap_strides,
            sampling_ratio=self.sampling_ratio,
            finest_scale=self.finest_scale)
        return rf.reshape(b, p, self.roi_out_size, self.roi_out_size, -1)

    def _stage_loss(self, cls, boxes, gt, gtv, gtl, img_shape):
        """Hungarian match + focal/L1/GIoU for one image."""
        h, w = img_shape[0], img_shape[1]
        prob = jax.nn.sigmoid(cls)
        factor = jnp.stack([w, h, w, h])
        # matcher expects (C+1) softmax-ish probs; pad a bg column
        probp = jnp.concatenate([prob, jnp.zeros_like(prob[:, :1])], -1)
        bnorm = xyxy_to_cxcywh(boxes / factor[None])
        assigned = self.matcher.assign(probp, bnorm, gt, gtv, gtl,
                                       (h, w))
        pos = assigned > 0
        gi = jnp.clip(assigned - 1, 0, gt.shape[0] - 1)
        labels = jnp.where(pos, gtl[gi], self.nc)
        onehot = jax.nn.one_hot(labels, self.nc)
        lcls = jnp.sum(sigmoid_focal_loss(cls, onehot, 2.0, 0.25))
        tgt = gt[gi]
        tnorm = xyxy_to_cxcywh(tgt / factor[None])
        l1 = jnp.sum(jnp.abs(bnorm - tnorm), -1) * pos
        giou = bbox_overlaps(boxes, tgt, mode="giou", is_aligned=True)
        lgiou = (1 - giou) * pos
        npos = jnp.maximum(jnp.sum(pos), 1.0)
        return (self.cls_weight * lcls / npos,
                self.l1_weight * jnp.sum(l1) / npos,
                self.giou_weight * jnp.sum(lgiou) / npos)

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid,
             gt_labels, rng, prop_feats=None, img_shapes=None, **kw):
        boxes = proposals
        pf = prop_feats
        losses: Dict[str, jnp.ndarray] = {}
        for si, stage in enumerate(self.stages):
            rf = self._extract(feats, boxes)
            cls, delta, pf = stage(rf, pf)
            new_boxes = _apply_deltas(boxes, delta)
            lc, l1, lg = jax.vmap(self._stage_loss)(
                cls, new_boxes, gt_bboxes, gt_valid, gt_labels, img_shapes)
            wgt = self.stage_loss_weights[si]
            losses[f"s{si}.loss_cls"] = jnp.mean(lc) * wgt
            losses[f"s{si}.loss_bbox"] = jnp.mean(l1) * wgt
            losses[f"s{si}.loss_iou"] = jnp.mean(lg) * wgt
            boxes = jax.lax.stop_gradient(new_boxes)
        return losses

    def simple_test(self, feats, proposals, prop_valid, img_shapes,
                    scale_factors, prop_feats=None, rescale=True):
        tc = dict(self.test_cfg or {})
        max_per_img = int(tc.get("max_per_img", 100))
        boxes = proposals
        pf = prop_feats
        cls = None
        for stage in self.stages:
            rf = self._extract(feats, boxes)
            cls, delta, pf = stage(rf, pf)
            boxes = _apply_deltas(boxes, delta)
        prob = jax.nn.sigmoid(cls)                    # (B, P, C)
        b, p, nc = prob.shape

        def one(pr, bx, sf):
            flat = pr.reshape(-1)
            k = min(max_per_img, flat.shape[0])
            top, ti = jax.lax.top_k(flat, k)
            qi = ti // nc
            ci = ti % nc
            bsel = bx[qi]
            if rescale:
                bsel = bsel / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            dets = jnp.concatenate([bsel, top[:, None]], -1)
            return dets, ci.astype(jnp.int32), top > 0.0

        return jax.vmap(one)(prob, boxes, scale_factors)


@DETECTORS.register_module()
class SparseRCNN(TwoStageDetector):
    """Sparse R-CNN (reference sparse_rcnn.py): EmbeddingRPN + SparseRoIHead.
    Overrides the two-stage flow: no anchor RPN, no NMS."""

    def forward_train(self, batch):
        feats = self.extract_feat(batch["img"])
        b = batch["img"].shape[0]
        shp = batch["img_shape"]
        whwh = jnp.stack([shp[:, 1], shp[:, 0], shp[:, 1], shp[:, 0]], -1)
        boxes, pf = self.rpn(b, whwh)
        return self.roi.loss(feats, boxes, None, batch["gt_bboxes"],
                             batch["gt_valid"], batch["gt_labels"],
                             self.make_rng("sampling"), prop_feats=pf,
                             img_shapes=batch["img_shape"])

    def simple_test(self, batch, rescale: bool = True):
        feats = self.extract_feat(batch["img"])
        b = batch["img"].shape[0]
        shp = batch["img_shape"]
        whwh = jnp.stack([shp[:, 1], shp[:, 0], shp[:, 1], shp[:, 0]], -1)
        boxes, pf = self.rpn(b, whwh)
        sf = batch.get("scale_factor", jnp.ones((b, 4), jnp.float32))
        return self.roi.simple_test(feats, boxes, None, batch["img_shape"],
                                    sf, prop_feats=pf, rescale=rescale)


@DETECTORS.register_module()
class QueryInst(SparseRCNN):
    """QueryInst (reference queryinst.py) — SparseRCNN + per-stage mask
    branch; registered with the box path (mask branch lands with the
    instance-seg surface)."""
    pass
