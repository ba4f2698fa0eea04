"""DETR head + detector (reference mmdet/models/dense_heads/detr_head.py:24,
mmdet/models/detectors/detr.py:10).

Set prediction on the last backbone map: 1x1 input proj -> flatten ->
encoder/decoder transformer (models/utils/transformer.py) -> per-layer class
+ box FFNs. Hungarian matching (core/bbox/hungarian.py) gives targets; loss =
CE (bg weight 0.1) + L1 (cxcywh, normalized) + GIoU, summed over decoder
layers (aux losses, reference detr_head.py loss()).
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ... import nn
from ...core.bbox.geometry import bbox_overlaps
from ...core.bbox.hungarian import (HungarianAssigner, cxcywh_to_xyxy,
                                    xyxy_to_cxcywh)
from ...utils.registry import DETECTORS, HEADS
from ..utils.transformer import SinePositionalEncoding, Transformer


@HEADS.register_module()
class DETRHead(nn.Module):
    num_classes: int = 80
    in_channels: int = 2048
    num_query: int = 100
    embed_dims: int = 256
    num_heads: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    feedforward_channels: int = 2048
    bg_cls_weight: float = 0.1
    l1_weight: float = 5.0
    giou_weight: float = 2.0
    cls_weight: float = 1.0
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        self.input_proj = nn.Dense(self.embed_dims, dtype=self.dtype)
        self.pos_enc = SinePositionalEncoding(self.embed_dims // 2)
        self.transformer = Transformer(
            self.embed_dims, self.num_heads, self.num_encoder_layers,
            self.num_decoder_layers, self.feedforward_channels,
            dtype=self.dtype)
        self.query_embed = self.param(
            "query_embed", nn.initializers.normal(1.0),
            (self.num_query, self.embed_dims))
        self.fc_cls = nn.Dense(self.num_classes + 1, dtype=self.dtype)
        self.reg_fc1 = nn.Dense(self.embed_dims, dtype=self.dtype)
        self.reg_fc2 = nn.Dense(self.embed_dims, dtype=self.dtype)
        self.fc_reg = nn.Dense(4, dtype=self.dtype)
        asn = dict((dict(self.train_cfg or {})).get("assigner", {}))
        asn.pop("type", None)
        self.assigner = HungarianAssigner(**asn)

    def __call__(self, feats):
        x = feats[-1]                             # (B, H, W, C) last level
        b, h, w, _ = x.shape
        x = self.input_proj(x).reshape(b, h * w, self.embed_dims)
        pos = self.pos_enc(h, w).reshape(h * w, self.embed_dims).astype(
            x.dtype)
        dec = self.transformer(x, pos, self.query_embed.astype(x.dtype))
        cls = self.fc_cls(dec).astype(jnp.float32)      # (L, B, Q, C+1)
        y = nn.relu(self.reg_fc1(dec))
        y = nn.relu(self.reg_fc2(y))
        boxes = jax.nn.sigmoid(self.fc_reg(y).astype(jnp.float32))
        return (cls, boxes)

    def _loss_single_layer(self, cls, boxes, gt_bboxes, gt_valid, gt_labels,
                           img_shape):
        """One decoder layer, one image."""
        prob = jax.nn.softmax(cls, -1)
        assigned = self.assigner.assign(prob, boxes, gt_bboxes, gt_valid,
                                        gt_labels, img_shape)
        pos = assigned > 0
        matched = jnp.clip(assigned - 1, 0, gt_bboxes.shape[0] - 1)
        labels = jnp.where(pos, gt_labels[matched], self.num_classes)
        logp = jax.nn.log_softmax(cls, -1)
        ce = -jnp.take_along_axis(logp, labels[:, None], -1)[:, 0]
        cls_w = jnp.where(labels == self.num_classes, self.bg_cls_weight, 1.0)
        num_pos = jnp.maximum(jnp.sum(pos), 1.0)
        loss_cls = self.cls_weight * jnp.sum(ce * cls_w) / (
            num_pos + jnp.sum(cls_w * (labels == self.num_classes)))
        h, w = img_shape[0], img_shape[1]
        factor = jnp.stack([w, h, w, h])
        gt_norm = xyxy_to_cxcywh(gt_bboxes / factor[None])
        tgt = gt_norm[matched]
        posf = pos.astype(jnp.float32)
        loss_l1 = self.l1_weight * jnp.sum(
            jnp.abs(boxes - tgt) * posf[:, None]) / num_pos
        pred_xyxy = cxcywh_to_xyxy(boxes) * factor[None]
        gious = bbox_overlaps(pred_xyxy, gt_bboxes[matched], mode="giou",
                              is_aligned=True)
        loss_giou = self.giou_weight * jnp.sum((1 - gious) * posf) / num_pos
        return loss_cls, loss_l1, loss_giou

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None,
             img_shapes=None):
        cls_all, box_all = outs                 # (L, B, Q, ...)
        L = cls_all.shape[0]
        losses = {}
        for li in range(L):
            lc, ll, lg = jax.vmap(self._loss_single_layer)(
                cls_all[li], box_all[li], gt_bboxes, gt_valid, gt_labels,
                img_shapes)
            tag = "" if li == L - 1 else f"d{li}."
            losses[f"{tag}loss_cls"] = jnp.mean(lc)
            losses[f"{tag}loss_bbox"] = jnp.mean(ll)
            losses[f"{tag}loss_iou"] = jnp.mean(lg)
        return losses

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_all, box_all = outs
        cfg = dict(cfg or self.test_cfg or {})
        max_per_img = int(cfg.get("max_per_img", 100))
        cls, boxes = cls_all[-1], box_all[-1]   # final decoder layer

        def one(cls_i, box_i, shape, sf):
            prob = jax.nn.softmax(cls_i, -1)[:, :self.num_classes]
            scores = jnp.max(prob, -1)
            labels = jnp.argmax(prob, -1).astype(jnp.int32)
            h, w = shape[0], shape[1]
            factor = jnp.stack([w, h, w, h])
            xyxy = cxcywh_to_xyxy(box_i) * factor[None]
            if rescale:
                xyxy = xyxy / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            k = min(max_per_img, scores.shape[0])
            top, ti = jax.lax.top_k(scores, k)
            dets = jnp.concatenate([xyxy[ti], top[:, None]], -1)
            return dets, labels[ti], jnp.ones((k,), bool)

        return jax.vmap(one)(cls, boxes, img_shapes, scale_factors)


@DETECTORS.register_module()
class DETR(nn.Module):
    """DETR detector (reference mmdet/models/detectors/detr.py:10)."""
    backbone: Any = None
    neck: Any = None
    bbox_head: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    init_cfg: Any = None
    pretrained: Any = None
    dtype: Any = None

    def setup(self):
        from ...utils.registry import BACKBONES, NECKS, build_from_cfg
        bb = dict(self.backbone)
        bb_type = bb.pop("type", "ResNet")
        self.backbone_m = build_from_cfg(dict(type=bb_type, **bb,
                                              dtype=self.dtype), BACKBONES)
        if self.neck is not None:
            nk = dict(self.neck)
            nk_type = nk.pop("type", "ChannelMapper")
            self.neck_m = build_from_cfg(dict(type=nk_type, **nk,
                                              dtype=self.dtype), NECKS)
        else:
            self.neck_m = None
        bh = dict(self.bbox_head)
        bh_type = bh.pop("type", "DETRHead")
        from ...utils.registry import HEADS as _HEADS
        self.head = build_from_cfg(
            dict(type=bh_type, **bh, train_cfg=self.train_cfg,
                 test_cfg=self.test_cfg, dtype=self.dtype), _HEADS)

    def __call__(self, batch, mode: str = "train"):
        feats = self.backbone_m(batch["img"])
        if self.neck_m is not None:
            feats = self.neck_m(feats)
        outs = self.head(feats)
        if mode == "train":
            return self.head.loss(outs, batch["gt_bboxes"],
                                  batch["gt_valid"], batch["gt_labels"],
                                  img_shapes=batch["img_shape"])
        sf = batch.get("scale_factor",
                       jnp.ones((batch["img"].shape[0], 4), jnp.float32))
        return self.head.get_bboxes(outs, batch["img_shape"], sf)
