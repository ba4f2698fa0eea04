"""Single-stage instance segmentation: SOLO / Decoupled SOLO and YOLACT.

References: mmdet/models/dense_heads/solo_head.py (grid-cell instance
masks, dice loss, matrix NMS), yolact_head.py + yolact protonet/segm heads,
mmdet/models/detectors/{solo.py, yolact.py,
single_stage_instance_seg.py}.

Data contract: ``gt_masks`` arrive as the repo's box-cropped (G, M0, M0)
device format (core/mask/structures.py); full-image mask targets are
reconstructed by resampling each crop into the output grid at its gt box —
one bilinear gather per gt, static shapes.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.bbox.assign_sample import MaxIoUAssigner
from ...core.anchor import AnchorGenerator
from ...core.bbox.coder import DeltaXYWHBBoxCoder
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..layers import Conv, GroupNorm32
from ..detectors.single_stage import SingleStageDetector


def paste_crop_masks(crops, boxes, out_hw, stride=1.0):
    """(G, M0, M0) box-cropped masks + (G, 4) boxes -> (G, H, W) full maps.

    Inverse bilinear sampling: for each output pixel, map into the crop's
    normalized box frame and gather (zero outside the box).
    """
    g, m0, _ = crops.shape
    h, w = out_hw
    ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) * stride
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) * stride
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    bw = jnp.maximum(x2 - x1, 1e-3)
    bh = jnp.maximum(y2 - y1, 1e-3)
    u = (xs[None, None, :] - x1[:, None, None]) / bw[:, None, None]
    v = (ys[None, :, None] - y1[:, None, None]) / bh[:, None, None]
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    cu = jnp.clip(u * (m0 - 1), 0, m0 - 1)
    cv = jnp.clip(v * (m0 - 1), 0, m0 - 1)
    u0 = jnp.floor(cu).astype(jnp.int32)
    v0 = jnp.floor(cv).astype(jnp.int32)
    u1 = jnp.minimum(u0 + 1, m0 - 1)
    v1 = jnp.minimum(v0 + 1, m0 - 1)
    fu = cu - u0
    fv = cv - v0

    def per_gt(crop, v0g, v1g, u0g, u1g, fug, fvg, ins):
        a = crop[v0g, u0g]
        b = crop[v0g, u1g]
        c = crop[v1g, u0g]
        d = crop[v1g, u1g]
        val = (a * (1 - fvg) * (1 - fug) + b * (1 - fvg) * fug
               + c * fvg * (1 - fug) + d * fvg * fug)
        return jnp.where(ins, val, 0.0)

    return jax.vmap(per_gt)(crops, v0, v1, u0, u1, fu, fv, inside)


@HEADS.register_module()
class SOLOHead(nn.Module):
    """SOLO v1 (reference solo_head.py:99): per-level SxS grid category +
    per-cell instance mask channels."""
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 4
    num_grids: Sequence[int] = (40, 36, 24, 16, 12)
    scale_ranges: Sequence = ((1, 96), (48, 192), (96, 384), (192, 768),
                              (384, 2048))
    pos_scale: float = 0.2
    strides: Sequence[int] = (8, 8, 16, 32, 32)
    mask_stride: int = 4
    loss_mask: Any = None
    loss_cls: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        self.l_cls = build_from_cfg(dict(self.loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0)), LOSSES)
        self.cate_convs = [Conv(self.feat_channels, 3, 1, 1,
                                dtype=self.dtype, name=f"cate_conv{i}")
                           for i in range(self.stacked_convs)]
        self.cate_gns = [GroupNorm32(name=f"cate_gn{i}")
                         for i in range(self.stacked_convs)]
        self.mask_convs = [Conv(self.feat_channels, 3, 1, 1,
                                dtype=self.dtype, name=f"mask_conv{i}")
                           for i in range(self.stacked_convs)]
        self.mask_gns = [GroupNorm32(name=f"mask_gn{i}")
                         for i in range(self.stacked_convs)]
        self.conv_cate = Conv(self.num_classes, 3, 1, 1, dtype=self.dtype)
        self.conv_masks = [Conv(s * s, 1, 1, 0, dtype=self.dtype,
                                name=f"conv_mask{i}")
                           for i, s in enumerate(self.num_grids)]

    def __call__(self, feats):
        cate_preds, mask_preds = [], []
        for li, x in enumerate(feats[:len(self.num_grids)]):
            s = self.num_grids[li]
            # category branch on an SxS-resized view (reference :188)
            c = jax.image.resize(x, (x.shape[0], s, s, x.shape[-1]),
                                 "bilinear")
            for conv, gn in zip(self.cate_convs, self.cate_gns):
                c = nn.relu(gn(conv(c)))
            cate_preds.append(self.conv_cate(c).astype(jnp.float32))
            # mask branch with coord-conv (reference appends x/y coords)
            b, h, w, _ = x.shape
            yy = jnp.linspace(-1, 1, h)[None, :, None, None]
            xx = jnp.linspace(-1, 1, w)[None, None, :, None]
            m = jnp.concatenate(
                [x, jnp.broadcast_to(yy, (b, h, w, 1)).astype(x.dtype),
                 jnp.broadcast_to(xx, (b, h, w, 1)).astype(x.dtype)], -1)
            for conv, gn in zip(self.mask_convs, self.mask_gns):
                m = nn.relu(gn(conv(m)))
            m = jnp.repeat(jnp.repeat(m, 2, 1), 2, 2)   # 2x upsample
            mask_preds.append(self.conv_masks[li](m).astype(jnp.float32))
        return cate_preds, mask_preds

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None,
             gt_masks=None):
        cate_preds, mask_preds = outs
        losses: Dict[str, jnp.ndarray] = {}
        total_dice = 0.0
        total_pos = 0.0
        cls_losses = []
        for li in range(len(cate_preds)):
            s = self.num_grids[li]
            lo, hi = self.scale_ranges[li]
            mp = mask_preds[li]
            mh, mw = mp.shape[1:3]

            def one(cate, mpred, gt, gtv, gtl, gmask):
                # gt scale gate for this level
                gw = gt[:, 2] - gt[:, 0]
                gh = gt[:, 3] - gt[:, 1]
                scale = jnp.sqrt(jnp.maximum(gw * gh, 1e-6))
                in_lvl = (scale >= lo) & (scale <= hi) & gtv
                # center region cells
                cx = (gt[:, 0] + gt[:, 2]) * 0.5
                cy = (gt[:, 1] + gt[:, 3]) * 0.5
                # grid coords normalized by image extent (mask map * stride)
                iw = mw * (self.strides[li] / 2.0)
                ih = mh * (self.strides[li] / 2.0)
                gx0 = jnp.clip(((cx - gw * self.pos_scale / 2) / iw * s)
                               .astype(jnp.int32), 0, s - 1)
                gx1 = jnp.clip(((cx + gw * self.pos_scale / 2) / iw * s)
                               .astype(jnp.int32), 0, s - 1)
                gy0 = jnp.clip(((cy - gh * self.pos_scale / 2) / ih * s)
                               .astype(jnp.int32), 0, s - 1)
                gy1 = jnp.clip(((cy + gh * self.pos_scale / 2) / ih * s)
                               .astype(jnp.int32), 0, s - 1)
                ii = jnp.arange(s)
                inx = (ii[None, :] >= gx0[:, None]) & (ii[None, :]
                                                       <= gx1[:, None])
                iny = (ii[None, :] >= gy0[:, None]) & (ii[None, :]
                                                       <= gy1[:, None])
                cells = (iny[:, :, None] & inx[:, None, :]) \
                    & in_lvl[:, None, None]                    # (G, s, s)
                cells = cells.reshape(-1, s * s)               # (G, s2)
                # cell -> smallest gt
                area = (gw * gh)[:, None]
                am = jnp.where(cells, area, 1e12)
                gi = jnp.argmin(am, 0)                          # (s2,)
                pos = jnp.min(am, 0) < 1e12
                labels = jnp.where(pos, gtl[gi], self.num_classes)
                # mask targets: paste each gt's crop at mask resolution
                full = paste_crop_masks(gmask, gt, (mh, mw),
                                        self.strides[li] / 2.0)  # (G,mh,mw)
                tgt = full[gi]                                  # (s2,mh,mw)
                pred = jnp.transpose(mpred, (2, 0, 1))          # (s2,mh,mw)
                p = jax.nn.sigmoid(pred)
                inter = jnp.sum(p * tgt, (1, 2))
                dice = 1 - 2 * inter / jnp.maximum(
                    jnp.sum(p * p, (1, 2)) + jnp.sum(tgt * tgt, (1, 2)),
                    1e-6)
                dsum = jnp.sum(dice * pos)
                return labels.astype(jnp.int32), pos, dsum

            labels, pos, dsum = jax.vmap(one)(
                cate_preds[li], mask_preds[li], gt_bboxes, gt_valid,
                gt_labels, gt_masks if gt_masks is not None
                else jnp.zeros(gt_bboxes.shape[:2] + (28, 28)))
            npos_l = jnp.sum(pos)
            total_dice = total_dice + jnp.sum(dsum)
            total_pos = total_pos + npos_l
            cls_losses.append(self.l_cls(
                cate_preds[li].reshape(-1, self.num_classes),
                labels.reshape(-1), avg_factor=jnp.maximum(npos_l, 1.0)))
        losses["loss_cls"] = sum(cls_losses)
        losses["loss_mask"] = 3.0 * total_dice / jnp.maximum(total_pos,
                                                             1.0)
        return losses

    def get_results(self, outs, img_shapes, scale_factors, cfg=None):
        """Padded instance results (reference solo_head.py:497
        _get_results_single): score filter -> per-level area filter
        (mask area > stride) -> maskness rescoring -> mask matrix NMS.
        Returns (B, K, mh, mw) masks + labels + scores."""
        from ...core.post_processing.matrix_nms import mask_matrix_nms
        cate_preds, mask_preds = outs
        cfg = dict(cfg or self.test_cfg or {})
        score_thr = float(cfg.get("score_thr", 0.1))
        mask_thr = float(cfg.get("mask_thr", 0.5))
        filter_thr = float(cfg.get("filter_thr", 0.05))
        kernel = str(cfg.get("kernel", "gaussian"))
        sigma = float(cfg.get("sigma", 2.0))
        nms_pre = int(cfg.get("nms_pre", 500))
        max_per_img = int(cfg.get("max_per_img", 100))
        # flatten all levels at the finest mask resolution
        b = cate_preds[0].shape[0]
        mh, mw = mask_preds[0].shape[1:3]
        cates, masks, strides = [], [], []
        for li in range(len(cate_preds)):
            s = self.num_grids[li]
            cates.append(jax.nn.sigmoid(
                cate_preds[li].reshape(b, s * s, self.num_classes)))
            m = mask_preds[li]
            m = jax.image.resize(m, (b, mh, mw, m.shape[-1]), "bilinear")
            masks.append(jnp.transpose(m, (0, 3, 1, 2)))
            strides.append(jnp.full((s * s,), float(self.strides[li])))
        cate = jnp.concatenate(cates, 1)                # (B, N, C)
        mask = jnp.concatenate(masks, 1)                # (B, N, mh, mw)
        stride_of = jnp.concatenate(strides)            # (N,)

        def one(c, m):
            flat = c.reshape(-1)
            k = min(nms_pre, flat.shape[0])
            top, ti = jax.lax.top_k(flat, k)
            ci = (ti % self.num_classes).astype(jnp.int32)
            ni = ti // self.num_classes
            mp = jax.nn.sigmoid(m[ni])                  # (k, mh, mw)
            bm = mp > mask_thr
            sums = bm.sum(axis=(1, 2)).astype(jnp.float32)
            # area filter: mask bigger than its level stride (the mask
            # grid is at 1/4 input res, so compare in mask pixels like
            # the reference does after its own resize)
            valid = (top > score_thr) & (sums > stride_of[ni])
            maskness = (mp * bm).sum(axis=(1, 2)) / jnp.maximum(sums, 1.0)
            sc = top * maskness
            sc, labels, bms, keep_inds, valid = mask_matrix_nms(
                bm, ci, sc, valid=valid, filter_thr=filter_thr,
                max_num=max_per_img, kernel=kernel, sigma=sigma,
                mask_area=sums)
            return bms, labels, jnp.where(valid, sc, 0.0)

        return jax.vmap(one)(cate, mask)


@HEADS.register_module()
class DecoupledSOLOHead(SOLOHead):
    """Decoupled SOLO (reference solo_head.py:513): separate X and Y mask
    banks; cell mask = sigmoid(mx) * sigmoid(my)."""

    def setup(self):
        super().setup()
        self.conv_masks_x = [Conv(s, 1, 1, 0, dtype=self.dtype,
                                  name=f"conv_mask_x{i}")
                             for i, s in enumerate(self.num_grids)]
        self.conv_masks_y = [Conv(s, 1, 1, 0, dtype=self.dtype,
                                  name=f"conv_mask_y{i}")
                             for i, s in enumerate(self.num_grids)]

    def __call__(self, feats):
        cate_preds, mask_preds = [], []
        for li, x in enumerate(feats[:len(self.num_grids)]):
            s = self.num_grids[li]
            c = jax.image.resize(x, (x.shape[0], s, s, x.shape[-1]),
                                 "bilinear")
            for conv, gn in zip(self.cate_convs, self.cate_gns):
                c = nn.relu(gn(conv(c)))
            cate_preds.append(self.conv_cate(c).astype(jnp.float32))
            b, h, w, _ = x.shape
            yy = jnp.linspace(-1, 1, h)[None, :, None, None]
            xx = jnp.linspace(-1, 1, w)[None, None, :, None]
            m = jnp.concatenate(
                [x, jnp.broadcast_to(yy, (b, h, w, 1)).astype(x.dtype),
                 jnp.broadcast_to(xx, (b, h, w, 1)).astype(x.dtype)], -1)
            for conv, gn in zip(self.mask_convs, self.mask_gns):
                m = nn.relu(gn(conv(m)))
            m = jnp.repeat(jnp.repeat(m, 2, 1), 2, 2)
            mx = self.conv_masks_x[li](m).astype(jnp.float32)  # (B,H,W,s)
            my = self.conv_masks_y[li](m).astype(jnp.float32)
            # combine into s*s cell masks: logit_xy = mx[i] + my[j]
            comb = (mx[:, :, :, None, :] + my[:, :, :, :, None])
            mask_preds.append(comb.reshape(m.shape[0], m.shape[1],
                                           m.shape[2], s * s))
        return cate_preds, mask_preds


@HEADS.register_module()
class YOLACTHead(nn.Module):
    """YOLACT (reference yolact_head.py:14): retina-style anchor head with
    a per-anchor prototype-coefficient branch; masks = protos @ coeffs."""
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 1
    num_protos: int = 32
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
            octave_base_scale=3, scales_per_octave=1,
            ratios=[0.5, 1.0, 2.0], strides=[8, 16, 32, 64, 128]))
        ag.pop("type", None)
        self.prior_gen = AnchorGenerator(**ag)
        bc = dict(self.bbox_coder or dict(
            target_means=(0., 0., 0., 0.),
            target_stds=(0.1, 0.1, 0.2, 0.2)))
        bc.pop("type", None)
        self.coder = DeltaXYWHBBoxCoder(**bc)
        self.cls_loss = build_from_cfg(dict(self.loss_cls or dict(
            type="CrossEntropyLoss", loss_weight=1.0)), LOSSES)
        self.reg_loss = build_from_cfg(dict(self.loss_bbox or dict(
            type="SmoothL1Loss", beta=1.0, loss_weight=1.5)), LOSSES)
        tc = dict(self.train_cfg or {})
        asn = dict(tc.get("assigner", dict(pos_iou_thr=0.5,
                                           neg_iou_thr=0.4,
                                           min_pos_iou=0.0)))
        asn.pop("type", None)
        self.assigner = MaxIoUAssigner(**asn)
        na = self.prior_gen.num_base_anchors[0]
        self.head_convs = [Conv(self.feat_channels, 3, 1, 1,
                                dtype=self.dtype, name=f"head_conv{i}")
                           for i in range(self.stacked_convs)]
        self.conv_cls = Conv(na * (self.num_classes + 1), 3, 1, 1,
                             dtype=self.dtype)
        self.conv_reg = Conv(na * 4, 3, 1, 1, dtype=self.dtype)
        self.conv_coeff = Conv(na * self.num_protos, 3, 1, 1,
                               dtype=self.dtype)
        # protonet (reference yolact protonet: 3 convs + up + 2 convs)
        self.proto_convs = [Conv(self.feat_channels, 3, 1, 1,
                                 dtype=self.dtype, name=f"proto_conv{i}")
                            for i in range(3)]
        self.proto_out = Conv(self.num_protos, 1, 1, 0, dtype=self.dtype)
        self.segm_conv = Conv(self.num_classes, 1, 1, 0, dtype=self.dtype)

    def __call__(self, feats):
        cls_scores, bbox_preds, coeffs = [], [], []
        for x in feats:
            h = x
            for conv in self.head_convs:
                h = nn.relu(conv(h))
            cls_scores.append(self.conv_cls(h).astype(jnp.float32))
            bbox_preds.append(self.conv_reg(h).astype(jnp.float32))
            coeffs.append(jnp.tanh(self.conv_coeff(h).astype(jnp.float32)))
        p = feats[0]
        for conv in self.proto_convs:
            p = nn.relu(conv(p))
        p = jnp.repeat(jnp.repeat(p, 2, 1), 2, 2)
        protos = nn.relu(self.proto_out(p).astype(jnp.float32))
        segm = self.segm_conv(feats[0]).astype(jnp.float32)
        return cls_scores, bbox_preds, coeffs, protos, segm

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None,
             gt_masks=None):
        cls_scores, bbox_preds, coeffs, protos, segm = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_gen.grid_priors_cat(featmap_sizes)
        nc = self.num_classes
        cls = jnp.concatenate([s.reshape(n, -1, nc + 1)
                               for s in cls_scores], 1)
        reg = jnp.concatenate([b.reshape(n, -1, 4) for b in bbox_preds], 1)
        cof = jnp.concatenate([c.reshape(n, -1, self.num_protos)
                               for c in coeffs], 1)
        ph, pw = protos.shape[1:3]

        def one(gt, gtv, gtl, cof_i, proto_i, gmask):
            a = self.assigner.assign(anchors, gt, gtv, gt_labels=gtl)
            pos = a.gt_inds > 0
            neg = a.gt_inds == 0
            gi = jnp.clip(a.gt_inds - 1, 0, gt.shape[0] - 1)
            labels = jnp.where(pos, gtl[gi], nc)
            deltas = self.coder.encode(anchors, gt[gi])
            # mask loss on top-k positive anchors (static cap)
            kmax = 32
            sel = jnp.where(pos, a.max_overlaps, -1.0)
            top, ti = jax.lax.top_k(sel, kmax)
            mvalid = top > 0
            mc = cof_i[ti]                                  # (k, protos)
            mlogit = jnp.einsum("hwp,kp->khw", proto_i, mc)
            full = paste_crop_masks(gmask, gt, (ph, pw), 4.0)
            tgt = full[gi[ti]]
            # crop-to-box BCE (reference crops the loss to the gt box)
            box = gt[gi[ti]] / 4.0
            ys = jnp.arange(ph, dtype=jnp.float32)[None, :, None]
            xs = jnp.arange(pw, dtype=jnp.float32)[None, None, :]
            x1 = box[:, 0][:, None, None]
            y1 = box[:, 1][:, None, None]
            x2 = box[:, 2][:, None, None]
            y2 = box[:, 3][:, None, None]
            inb = (xs >= x1) & (xs <= x2) & (ys >= y1) & (ys <= y2)
            ce = (jnp.maximum(mlogit, 0) - mlogit * tgt
                  + jnp.log1p(jnp.exp(-jnp.abs(mlogit))))
            area = jnp.maximum(jnp.sum(inb, (1, 2)), 1.0)
            lm = jnp.sum(jnp.sum(ce * inb, (1, 2)) / area * mvalid) \
                / jnp.maximum(jnp.sum(mvalid), 1.0)
            return labels.astype(jnp.int32), pos, neg, deltas, lm

        gm = (gt_masks if gt_masks is not None
              else jnp.zeros(gt_bboxes.shape[:2] + (28, 28)))
        labels, pos, neg, deltas, lm = jax.vmap(one)(
            gt_bboxes, gt_valid, gt_labels, cof, protos, gm)
        num_pos = jnp.maximum(jnp.sum(pos), 1.0)
        lw = (pos | neg).astype(jnp.float32)
        loss_cls = self.cls_loss(cls.reshape(-1, nc + 1),
                                 labels.reshape(-1), lw.reshape(-1),
                                 avg_factor=num_pos)
        bw = pos.astype(jnp.float32)[..., None] * jnp.ones((1, 1, 4))
        loss_bbox = self.reg_loss(reg, deltas, bw, avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_mask=6.125 * jnp.mean(lm))

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        """YOLACT decode (reference yolact_head.py:393 get_bboxes ->
        core/post_processing/bbox_nms.py:189 fast_nms): per-class top-k,
        parallel triangular suppression, one global top max_per_img.
        Returns (dets, labels, valid, coeffs) — coeffs feed the protonet
        mask assembly."""
        from ...core.post_processing.matrix_nms import fast_nms
        cls_scores, bbox_preds, coeffs, protos, segm = outs
        cfg = dict(cfg or self.test_cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(cfg.get("iou_thr", dict(cfg.get(
            "nms", {})).get("iou_threshold", 0.5)))
        top_k = int(cfg.get("top_k", 200))
        max_per_img = int(cfg.get("max_per_img", 100))
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_gen.grid_priors_cat(featmap_sizes)
        nc = self.num_classes
        np_proto = coeffs[0].shape[-1] // (
            cls_scores[0].shape[-1] // (nc + 1))
        cls = jnp.concatenate([s.reshape(n, -1, nc + 1)
                               for s in cls_scores], 1)
        reg = jnp.concatenate([b.reshape(n, -1, 4) for b in bbox_preds], 1)
        cof = jnp.concatenate([c.reshape(n, -1, np_proto)
                               for c in coeffs], 1)

        def one(c, r, co, shape, sf):
            sc = jax.nn.softmax(c, -1)
            k = min(nms_pre, sc.shape[0])
            _, ti = jax.lax.top_k(jnp.max(sc[:, :nc], -1), k)
            boxes = self.coder.decode(anchors[ti], r[ti],
                                      max_shape=(shape[0], shape[1]))
            if rescale:
                boxes = boxes / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            dets, labels, out_cof, valid = fast_nms(
                boxes, sc[ti], co[ti], score_thr, iou_thr, top_k,
                max_per_img)
            return dets, labels, valid, out_cof

        return jax.vmap(one)(cls, reg, cof, img_shapes, scale_factors)


@DETECTORS.register_module()
class SOLO(SingleStageDetector):
    """SOLO detector (reference solo.py via single_stage_instance_seg.py):
    mask-only single-stage — train passes gt_masks to the head."""

    def __call__(self, batch, mode="train"):
        feats = self.extract_feat(batch["img"])
        outs = self.head(feats)
        if mode == "train":
            return self.head.loss(outs, batch["gt_bboxes"],
                                  batch["gt_valid"], batch["gt_labels"],
                                  self.make_rng("sampling"),
                                  gt_masks=batch.get("gt_masks"))
        return self.head.get_results(outs, batch["img_shape"],
                                     batch.get("scale_factor"))


@DETECTORS.register_module()
class YOLACT(SingleStageDetector):
    def __call__(self, batch, mode="train"):
        feats = self.extract_feat(batch["img"])
        outs = self.head(feats)
        if mode == "train":
            return self.head.loss(outs, batch["gt_bboxes"],
                                  batch["gt_valid"], batch["gt_labels"],
                                  self.make_rng("sampling"),
                                  gt_masks=batch.get("gt_masks"))
        sf = batch.get("scale_factor",
                       jnp.ones((batch["img"].shape[0], 4), jnp.float32))
        return self.head.get_bboxes(outs, batch["img_shape"], sf)
