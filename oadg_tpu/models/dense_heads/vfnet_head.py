"""VFNet head + detector (reference mmdet/models/dense_heads/vfnet_head.py,
mmdet/models/detectors/vfnet.py).

FCOS-style point head with: initial ltrb regression -> star-shaped 9-point
sampling of the predicted box (the deform-conv offsets) -> refined
regression + IoU-aware varifocal classification. ATSS assignment over
8x-stride square anchors (reference default), all static-shape.
"""
from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.bbox.assign_sample import ATSSAssigner
from ...core.bbox.geometry import bbox_overlaps
from ...core.bbox.transforms import distance2bbox
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, DeformConv, GroupNorm32
from .fovea_fsaf_heads import _level_points

INF = 1e8


@HEADS.register_module()
class VFNetHead(nn.Module):
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 3
    strides: Sequence[int] = (8, 16, 32, 64, 128)
    regress_ranges: Sequence = ((-1, 64), (64, 128), (128, 256), (256, 512),
                                (512, INF))
    gradient_mul: float = 0.1
    dcn_kernel: int = 3
    loss_cls: Any = None
    loss_bbox: Any = None
    loss_bbox_refine: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        self.l_cls = build_from_cfg(dict(self.loss_cls or dict(
            type="VarifocalLoss", use_sigmoid=True, alpha=0.75, gamma=2.0,
            iou_weighted=True, loss_weight=1.0)), LOSSES)
        self.l_bbox = build_from_cfg(dict(self.loss_bbox or dict(
            type="GIoULoss", loss_weight=1.5)), LOSSES)
        self.l_bbox_ref = build_from_cfg(dict(self.loss_bbox_refine or dict(
            type="GIoULoss", loss_weight=2.0)), LOSSES)
        tc = dict(self.train_cfg or {})
        asn = dict(tc.get("assigner", dict(topk=9)))
        asn.pop("type", None)
        self.assigner = ATSSAssigner(**asn)
        self.cls_convs = [Conv(self.feat_channels, 3, 1, 1, dtype=self.dtype,
                               name=f"cls_conv{i}")
                          for i in range(self.stacked_convs)]
        self.cls_gns = [GroupNorm32(name=f"cls_gn{i}")
                        for i in range(self.stacked_convs)]
        self.reg_convs = [Conv(self.feat_channels, 3, 1, 1, dtype=self.dtype,
                               name=f"reg_conv{i}")
                          for i in range(self.stacked_convs)]
        self.reg_gns = [GroupNorm32(name=f"reg_gn{i}")
                        for i in range(self.stacked_convs)]
        self.vfnet_reg = Conv(4, 3, 1, 1, dtype=self.dtype)
        self.reg_refine_dconv = DeformConv(self.feat_channels,
                                           self.dcn_kernel, padding=1)
        self.reg_refine_gn = GroupNorm32()
        self.vfnet_reg_refine = Conv(4, 3, 1, 1, dtype=self.dtype)
        self.cls_dconv = DeformConv(self.feat_channels, self.dcn_kernel,
                                    padding=1)
        self.cls_gn = GroupNorm32()
        self.vfnet_cls = Conv(self.num_classes, 3, 1, 1, dtype=self.dtype)
        self.scales = self.param("scales", nn.initializers.ones,
                                 (len(self.strides),))
        self.scales_refine = self.param("scales_refine",
                                        nn.initializers.ones,
                                        (len(self.strides),))

    def _star_offsets(self, bbox_pred, stride):
        """bbox_pred: (B,H,W,4) ltrb in image units. Returns deform offsets
        (B,H,W,18) placing the 9 taps on the star points of the box
        (reference vfnet_head.py star_dcn_offset), relative to the regular
        3x3 grid, in feature-grid units."""
        bp = (self.gradient_mul * bbox_pred
              + (1 - self.gradient_mul) * jax.lax.stop_gradient(bbox_pred))
        bp = bp / stride
        l, t, r, b = bp[..., 0], bp[..., 1], bp[..., 2], bp[..., 3]
        z = jnp.zeros_like(l)
        # taps (row-major ky,kx in {-1,0,1}): (dy, dx) targets
        tap_dy = [-t, -t, -t, z, z, z, b, b, b]
        tap_dx = [-l, z, r, -l, z, r, -l, z, r]
        base = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1),
                (1, -1), (1, 0), (1, 1)]
        offs = []
        for (by, bx), dy, dx in zip(base, tap_dy, tap_dx):
            offs.append(dy - by)
            offs.append(dx - bx)
        return jnp.stack(offs, -1)

    def __call__(self, feats):
        cls_scores, bbox_preds, bbox_refined = [], [], []
        for li, x in enumerate(feats):
            c = r = x
            for conv, gn in zip(self.cls_convs, self.cls_gns):
                c = nn.relu(gn(conv(c)))
            for conv, gn in zip(self.reg_convs, self.reg_gns):
                r = nn.relu(gn(conv(r)))
            s = float(self.strides[li])
            init = (jnp.exp(self.scales[li]
                            * self.vfnet_reg(r).astype(jnp.float32)) * s)
            off = self._star_offsets(init, s)
            r2 = nn.relu(self.reg_refine_gn(self.reg_refine_dconv(r, off)))
            delta = (self.scales_refine[li]
                     * self.vfnet_reg_refine(r2).astype(jnp.float32))
            refined = jnp.exp(delta) * jax.lax.stop_gradient(init)
            c2 = nn.relu(self.cls_gn(self.cls_dconv(c, off)))
            cls_scores.append(self.vfnet_cls(c2))
            bbox_preds.append(init)
            bbox_refined.append(refined)
        return cls_scores, bbox_preds, bbox_refined

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds, bbox_refined = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, sids = _level_points(featmap_sizes, self.strides)
        strides_pp = jnp.asarray(np.asarray(self.strides,
                                            np.float32))[sids]
        # 8x-stride square anchors for ATSS assignment (reference uses the
        # ATSS anchor convention: octave_base_scale 8, one per point)
        half = strides_pp * 4.0
        anchors = jnp.stack([points[:, 0] - half, points[:, 1] - half,
                             points[:, 0] + half, points[:, 1] + half], -1)
        nlb = [h * w for h, w in featmap_sizes]
        cls = jnp.concatenate([s.reshape(n, -1, self.num_classes)
                               for s in cls_scores], 1).astype(jnp.float32)
        init = jnp.concatenate([b.reshape(n, -1, 4) for b in bbox_preds], 1)
        refi = jnp.concatenate([b.reshape(n, -1, 4) for b in bbox_refined],
                               1)
        box_init = distance2bbox(points[None], init)
        box_refi = distance2bbox(points[None], refi)

        def one(gt, gtv, gtl, bri):
            a = self.assigner.assign(anchors, nlb, gt, gtv, gt_labels=gtl)
            pos = a.gt_inds > 0
            gi = jnp.clip(a.gt_inds - 1, 0, gt.shape[0] - 1)
            labels = jnp.where(pos, gtl[gi], self.num_classes)
            tgt = gt[gi]
            iou_ref = bbox_overlaps(bri, tgt, is_aligned=True)
            return labels.astype(jnp.int32), pos, tgt, iou_ref

        labels, pos, tgt, iou_ref = jax.vmap(one)(gt_bboxes, gt_valid,
                                                  gt_labels, box_refi)
        num_pos = jnp.maximum(jnp.sum(pos), 1.0)
        posf = pos.astype(jnp.float32)
        # varifocal target: refined IoU at the gt class
        vf_tgt = (jax.nn.one_hot(labels, self.num_classes)
                  * (jnp.clip(iou_ref, 0.0, 1.0) * posf)[..., None])
        loss_cls = self.l_cls(cls, jax.lax.stop_gradient(vf_tgt),
                              avg_factor=num_pos)
        loss_bbox = self.l_bbox(box_init.reshape(-1, 4), tgt.reshape(-1, 4),
                                weight=posf.reshape(-1), avg_factor=num_pos)
        loss_ref = self.l_bbox_ref(box_refi.reshape(-1, 4),
                                   tgt.reshape(-1, 4),
                                   weight=posf.reshape(-1),
                                   avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_bbox_rf=loss_ref)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale=True,
                   cfg=None):
        cls_scores, _, bbox_refined = outs
        cfg = dict(cfg or self.test_cfg or {})
        nms_pre = int(cfg.get("nms_pre", 1000))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.6))
        max_per_img = int(cfg.get("max_per_img", 100))
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, _ = _level_points(featmap_sizes, self.strides)
        sizes = [h * w for h, w in featmap_sizes]
        offs = np.concatenate([[0], np.cumsum(sizes)])

        def one(cls_l, reg_l, shape, sf):
            boxes_all, scores_all = [], []
            for li in range(len(cls_l)):
                sc = jax.nn.sigmoid(cls_l[li].reshape(-1, self.num_classes)
                                    .astype(jnp.float32))
                rg = reg_l[li].reshape(-1, 4)
                pts = points[offs[li]:offs[li + 1]]
                k = min(nms_pre, sc.shape[0])
                _, ti = jax.lax.top_k(jnp.max(sc, -1), k)
                boxes = distance2bbox(pts[ti], rg[ti],
                                      max_shape=(shape[0], shape[1]))
                boxes_all.append(boxes)
                scores_all.append(sc[ti])
            boxes = jnp.concatenate(boxes_all)
            scores = jnp.concatenate(scores_all)
            if rescale:
                boxes = boxes / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            pad = jnp.concatenate([scores,
                                   jnp.zeros((scores.shape[0], 1))], -1)
            return multiclass_nms(boxes, pad, score_thr, iou_thr,
                                  max_per_img, self.num_classes)

        return jax.vmap(one)(tuple(cls_scores), tuple(bbox_refined),
                             img_shapes, scale_factors)


@DETECTORS.register_module()
class VFNet(SingleStageDetector):
    """Alias (reference mmdet/models/detectors/vfnet.py)."""
    pass
