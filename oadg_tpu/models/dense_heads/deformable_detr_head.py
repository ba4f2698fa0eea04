"""Deformable DETR (reference mmdet/models/dense_heads/deformable_detr_head.py,
mmdet/models/utils/transformer.py DeformableDetrTransformer,
mmcv MultiScaleDeformableAttention CUDA kernel, detectors/deformable_detr.py).

MultiScaleDeformableAttention: the CUDA kernel's per-query
scatter/gather becomes a batched bilinear gather of num_points taps per
level (ops/deform_conv.bilinear_gather) + einsum-weighted sum — all dense
matmul/gather. Iterative bbox refinement between decoder
layers; sigmoid-focal classification with Hungarian matching per layer.
"""
from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.bbox.geometry import bbox_overlaps
from ...core.bbox.hungarian import (HungarianAssigner, cxcywh_to_xyxy,
                                    xyxy_to_cxcywh)
from ...ops.deform_conv import bilinear_gather
from ...utils.registry import DETECTORS, HEADS
from ..losses.common import sigmoid_focal_loss
from ..utils.transformer import FFN, SinePositionalEncoding


class MSDeformAttention(nn.Module):
    """Multi-scale deformable attention (replaces the mmcv CUDA op)."""
    embed_dims: int = 256
    num_heads: int = 8
    num_levels: int = 4
    num_points: int = 4
    dtype: Any = None

    @nn.compact
    def __call__(self, query, ref_points, value_list):
        """query (B, Q, C); ref_points (B, Q, 2) normalized [0,1];
        value_list: per-level (B, H, W, C). Returns (B, Q, C)."""
        b, q, c = query.shape
        nh, nl, npt = self.num_heads, len(value_list), self.num_points
        hd = self.embed_dims // nh
        off = nn.Dense(nh * nl * npt * 2, dtype=self.dtype,
                       name="sampling_offsets")(query)
        off = off.reshape(b, q, nh, nl, npt, 2).astype(jnp.float32)
        attn = nn.Dense(nh * nl * npt, dtype=self.dtype,
                        name="attention_weights")(query)
        attn = jax.nn.softmax(
            attn.reshape(b, q, nh, nl * npt).astype(jnp.float32), -1)
        attn = attn.reshape(b, q, nh, nl, npt)
        out = jnp.zeros((b, q, nh, hd), jnp.float32)
        for li, v in enumerate(value_list):
            h, w = v.shape[1:3]
            val = nn.Dense(self.embed_dims, dtype=self.dtype,
                           name=f"value_proj{li}")(v)
            val = val.reshape(b, h, w, nh, hd)
            # sampling locations in pixels of this level
            px = ref_points[..., 0] * w                      # (B,Q)
            py = ref_points[..., 1] * h
            sx = px[:, :, None, None] + off[:, :, :, li, :, 0] \
                * w / (2.0 * npt)
            sy = py[:, :, None, None] + off[:, :, :, li, :, 1] \
                * h / (2.0 * npt)                             # (B,Q,nh,npt)
            for hi in range(nh):
                taps = bilinear_gather(val[:, :, :, hi],
                                       sy[:, :, hi] - 0.5,
                                       sx[:, :, hi] - 0.5)    # (B,Q,npt,hd)
                out = out.at[:, :, hi].add(
                    jnp.sum(taps.astype(jnp.float32)
                            * attn[:, :, hi, li, :, None], axis=2))
        out = out.reshape(b, q, self.embed_dims).astype(query.dtype)
        return nn.Dense(self.embed_dims, dtype=self.dtype,
                        name="output_proj")(out)


class _LN(nn.Module):
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        return nn.LayerNorm(dtype=jnp.float32)(
            x.astype(jnp.float32)).astype(self.dtype or x.dtype)


class DeformableEncoderLayer(nn.Module):
    embed_dims: int
    num_heads: int
    num_levels: int
    num_points: int
    ffn_dims: int
    dtype: Any = None

    @nn.compact
    def __call__(self, tokens, ref_points, shapes):
        # tokens (B, N, C) flattened across levels; reshape per level views
        value_list = _unflatten(tokens, shapes)
        y = MSDeformAttention(self.embed_dims, self.num_heads,
                              self.num_levels, self.num_points,
                              self.dtype, name="attn")(
            tokens, ref_points, value_list)
        x = _LN(self.dtype, name="norm1")(tokens + y)
        y = FFN(self.embed_dims, self.ffn_dims, dtype=self.dtype,
                name="ffn")(x)
        return _LN(self.dtype, name="norm2")(y)


class DeformableDecoderLayer(nn.Module):
    embed_dims: int
    num_heads: int
    num_levels: int
    num_points: int
    ffn_dims: int
    dtype: Any = None

    @nn.compact
    def __call__(self, tgt, query_pos, ref_points, memory_tokens, shapes):
        q = tgt + query_pos
        sa = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads, qkv_features=self.embed_dims,
            dtype=self.dtype, name="self_attn")(q, q)
        x = _LN(self.dtype, name="norm1")(tgt + sa)
        value_list = _unflatten(memory_tokens, shapes)
        ca = MSDeformAttention(self.embed_dims, self.num_heads,
                               self.num_levels, self.num_points,
                               self.dtype, name="cross_attn")(
            x + query_pos, ref_points, value_list)
        x = _LN(self.dtype, name="norm2")(x + ca)
        y = FFN(self.embed_dims, self.ffn_dims, dtype=self.dtype,
                name="ffn")(x)
        return _LN(self.dtype, name="norm3")(y)


def _unflatten(tokens, shapes):
    outs = []
    start = 0
    b = tokens.shape[0]
    for (h, w) in shapes:
        outs.append(tokens[:, start:start + h * w].reshape(b, h, w, -1))
        start += h * w
    return outs


@HEADS.register_module()
class DeformableDETRHead(nn.Module):
    num_classes: int = 80
    in_channels: int = 2048
    num_query: int = 300
    embed_dims: int = 256
    num_heads: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    num_points: int = 4
    feedforward_channels: int = 1024
    with_box_refine: bool = False
    as_two_stage: bool = False
    sync_cls_avg_factor: bool = True
    cls_weight: float = 2.0
    l1_weight: float = 5.0
    giou_weight: float = 2.0
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        self.pos_enc = SinePositionalEncoding(self.embed_dims // 2)
        self.enc_layers = [DeformableEncoderLayer(
            self.embed_dims, self.num_heads, 4, self.num_points,
            self.feedforward_channels, self.dtype, name=f"enc{i}")
            for i in range(self.num_encoder_layers)]
        self.dec_layers = [DeformableDecoderLayer(
            self.embed_dims, self.num_heads, 4, self.num_points,
            self.feedforward_channels, self.dtype, name=f"dec{i}")
            for i in range(self.num_decoder_layers)]
        self.query_embed = self.param(
            "query_embed", nn.initializers.normal(1.0),
            (self.num_query, 2 * self.embed_dims))
        self.level_embed = self.param(
            "level_embed", nn.initializers.normal(1.0),
            (4, self.embed_dims))
        self.ref_fc = nn.Dense(2, dtype=self.dtype)
        self.cls_branches = [nn.Dense(self.num_classes, dtype=self.dtype,
                                      name=f"cls{i}")
                             for i in range(self.num_decoder_layers)]
        self.reg_branches = [
            (nn.Dense(self.embed_dims, dtype=self.dtype, name=f"reg{i}_1"),
             nn.Dense(self.embed_dims, dtype=self.dtype, name=f"reg{i}_2"),
             nn.Dense(4, dtype=self.dtype, name=f"reg{i}_3"))
            for i in range(self.num_decoder_layers)]
        asn = dict((dict(self.train_cfg or {})).get("assigner", {}))
        asn.pop("type", None)
        self.assigner = HungarianAssigner(**asn)

    def __call__(self, feats):
        feats = list(feats[-4:])
        b = feats[0].shape[0]
        shapes = [f.shape[1:3] for f in feats]
        toks, refs = [], []
        for li, f in enumerate(feats):
            h, w = f.shape[1:3]
            pos = self.pos_enc(h, w).reshape(h * w, self.embed_dims)
            t = f.reshape(b, h * w, -1)
            toks.append(t + (pos + self.level_embed[li]).astype(t.dtype))
            ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h
            xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w
            refs.append(jnp.stack([jnp.tile(xs, h), jnp.repeat(ys, w)],
                                  -1))
        tokens = jnp.concatenate(toks, 1)
        enc_refs = jnp.broadcast_to(jnp.concatenate(refs, 0)[None],
                                    (b, tokens.shape[1], 2))
        for layer in self.enc_layers:
            tokens = layer(tokens, enc_refs, shapes)
        qe = self.query_embed
        query_pos = jnp.broadcast_to(qe[None, :, :self.embed_dims],
                                     (b, self.num_query, self.embed_dims)
                                     ).astype(tokens.dtype)
        tgt = jnp.broadcast_to(qe[None, :, self.embed_dims:],
                               (b, self.num_query, self.embed_dims)
                               ).astype(tokens.dtype)
        ref = jax.nn.sigmoid(self.ref_fc(query_pos).astype(jnp.float32))
        cls_all, box_all = [], []
        for i, layer in enumerate(self.dec_layers):
            tgt = layer(tgt, query_pos, ref, tokens, shapes)
            cls = self.cls_branches[i](tgt).astype(jnp.float32)
            r1, r2, r3 = self.reg_branches[i]
            y = nn.relu(r1(tgt))
            y = nn.relu(r2(y))
            delta = r3(y).astype(jnp.float32)
            # iterative refinement around the reference point
            ref_logit = jnp.log(jnp.clip(ref, 1e-6, 1 - 1e-6)
                                / jnp.clip(1 - ref, 1e-6, None))
            cx = jax.nn.sigmoid(delta[..., 0] + ref_logit[..., 0])
            cy = jax.nn.sigmoid(delta[..., 1] + ref_logit[..., 1])
            w = jax.nn.sigmoid(delta[..., 2] - 2.0)
            h = jax.nn.sigmoid(delta[..., 3] - 2.0)
            boxes = jnp.stack([cx, cy, w, h], -1)
            cls_all.append(cls)
            box_all.append(boxes)
            if self.with_box_refine:
                ref = jax.lax.stop_gradient(boxes[..., :2])
        return (jnp.stack(cls_all), jnp.stack(box_all))

    def _loss_single(self, cls, boxes, gt_bboxes, gt_valid, gt_labels,
                     img_shape):
        prob = jax.nn.sigmoid(cls)
        probp = jnp.concatenate([prob, jnp.zeros_like(prob[:, :1])], -1)
        assigned = self.assigner.assign(probp, boxes, gt_bboxes, gt_valid,
                                        gt_labels, img_shape)
        pos = assigned > 0
        matched = jnp.clip(assigned - 1, 0, gt_bboxes.shape[0] - 1)
        labels = jnp.where(pos, gt_labels[matched], self.num_classes)
        onehot = jax.nn.one_hot(labels, self.num_classes)
        num_pos = jnp.maximum(jnp.sum(pos), 1.0)
        loss_cls = self.cls_weight * jnp.sum(
            sigmoid_focal_loss(cls, onehot, 2.0, 0.25)) / num_pos
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
        cls_all, box_all = outs
        L = cls_all.shape[0]
        losses = {}
        for li in range(L):
            lc, ll, lg = jax.vmap(self._loss_single)(
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
        cls, boxes = cls_all[-1], box_all[-1]
        nc = self.num_classes

        def one(cls_i, box_i, shape, sf):
            prob = jax.nn.sigmoid(cls_i).reshape(-1)
            k = min(max_per_img, prob.shape[0])
            top, ti = jax.lax.top_k(prob, k)
            qi = ti // nc
            ci = (ti % nc).astype(jnp.int32)
            h, w = shape[0], shape[1]
            factor = jnp.stack([w, h, w, h])
            xyxy = cxcywh_to_xyxy(box_i[qi]) * factor[None]
            if rescale:
                xyxy = xyxy / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            dets = jnp.concatenate([xyxy, top[:, None]], -1)
            return dets, ci, top > 0.0

        return jax.vmap(one)(cls, boxes, img_shapes, scale_factors)


from .detr_head import DETR  # noqa: E402


@DETECTORS.register_module()
class DeformableDETR(DETR):
    """Alias (reference mmdet/models/detectors/deformable_detr.py); the
    head handles the multi-level deformable transformer."""
    pass
