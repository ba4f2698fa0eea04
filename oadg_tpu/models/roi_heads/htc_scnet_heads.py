"""HTC, SCNet and PointRend RoI heads.

References: mmdet/models/roi_heads/htc_roi_head.py (interleaved cascade +
semantic branch + mask info flow), scnet_roi_head.py (+ feature relay and
global-context head), point_rend_roi_head.py + mask_heads/mask_point_head.py
(uncertainty-sampled point refinement), mask_heads/fused_semantic_head.py,
mask_heads/global_context_head.py, mask_heads/coarse_mask_head.py.

Static-shape notes: point sampling uses a fixed ``num_points`` with
importance sampling expressed as top-k over uncertainty logits; the
semantic branch trains only when the batch carries ``gt_semantic_seg``.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import jax
import jax.numpy as jnp

from ... import nn
from ...ops.deform_conv import bilinear_gather
from ...ops.misc_ops import point_sample
from ...utils.registry import DETECTORS, HEADS, build_from_cfg
from ..layers import Conv
from .cascade_roi_head import CascadeRoIHead
from .mask_heads import FCNMaskHead, mask_targets
from .standard_roi_head import StandardRoIHead


@HEADS.register_module()
class FusedSemanticHead(nn.Module):
    """Reference fused_semantic_head.py:12: fuse all FPN levels at the
    ``fusion_level`` resolution, conv stack, segmentation + embedding."""
    num_ins: int = 5
    fusion_level: int = 1
    num_convs: int = 4
    in_channels: int = 256
    conv_out_channels: int = 256
    num_classes: int = 183
    dtype: Any = None

    @nn.compact
    def __call__(self, feats):
        tgt = feats[self.fusion_level]
        x = Conv(self.conv_out_channels, 1, 1, 0, dtype=self.dtype,
                 name=f"lateral{self.fusion_level}")(tgt)
        for i, f in enumerate(feats[:self.num_ins]):
            if i == self.fusion_level:
                continue
            y = Conv(self.conv_out_channels, 1, 1, 0, dtype=self.dtype,
                     name=f"lateral{i}")(f)
            y = jax.image.resize(y, (y.shape[0],) + tgt.shape[1:3]
                                 + (y.shape[-1],), "bilinear")
            x = x + y
        for i in range(self.num_convs):
            x = nn.relu(Conv(self.conv_out_channels, 3, 1, 1,
                             dtype=self.dtype, name=f"conv{i}")(x))
        seg = Conv(self.num_classes, 1, 1, 0, dtype=self.dtype,
                   name="conv_seg")(x).astype(jnp.float32)
        embed = nn.relu(Conv(self.conv_out_channels, 1, 1, 0,
                             dtype=self.dtype, name="conv_embedding")(x))
        return seg, embed


@HEADS.register_module()
class GlobalContextHead(nn.Module):
    """SCNet global context (reference global_context_head.py): pooled
    multilabel classification over the image's classes."""
    num_convs: int = 4
    in_channels: int = 256
    conv_out_channels: int = 256
    num_classes: int = 80
    loss_weight: float = 1.0
    dtype: Any = None

    @nn.compact
    def __call__(self, feat):
        x = feat
        for i in range(self.num_convs):
            x = nn.relu(Conv(self.conv_out_channels, 3, 1, 1,
                             dtype=self.dtype, name=f"conv{i}")(x))
        pooled = jnp.mean(x, (1, 2))
        logits = nn.Dense(self.num_classes, dtype=self.dtype,
                          name="fc")(pooled).astype(jnp.float32)
        return logits, x


class HTCMaskHead(FCNMaskHead):
    """FCNMaskHead + 1x1 res conv for the inter-stage info flow
    (reference htc_mask_head.py)."""
    with_conv_res: bool = True


@HEADS.register_module()
class HybridTaskCascadeRoIHead(CascadeRoIHead):
    """HTC (reference htc_roi_head.py:14): cascade bbox stages interleaved
    with per-stage mask heads; semantic features added to both branches;
    mask info flows between stages through a 1x1 conv."""
    mask_roi_extractor: Any = None
    mask_head: Any = None
    semantic_roi_extractor: Any = None
    semantic_head: Any = None
    semantic_fusion: Sequence[str] = ("bbox", "mask")
    interleaved: bool = True
    mask_info_flow: bool = True

    def setup(self):
        super().setup()
        from collections.abc import Mapping
        mh_cfg = self.mask_head
        if isinstance(mh_cfg, Mapping) or mh_cfg is None:
            mh_cfg = [dict(mh_cfg or {})] * self.num_stages
        self.mask_heads = [
            build_from_cfg(dict(type="FCNMaskHead",
                                **{k: v for k, v in dict(h or {}).items()
                                   if k != "type"}, dtype=self.dtype), HEADS)
            for h in mh_cfg]
        info_ch = int(dict(mh_cfg[0] or {}).get("in_channels", 256))
        self.info_convs = [Conv(info_ch, 1, 1, 0, dtype=self.dtype,
                                name=f"info_conv{i}")
                           for i in range(self.num_stages)]
        if self.semantic_head is not None:
            sh = dict(self.semantic_head)
            sh.pop("type", None)
            self.semantic = FusedSemanticHead(**sh, dtype=self.dtype)
        else:
            self.semantic = None
        mext = dict(self.mask_roi_extractor or self.bbox_roi_extractor
                    or {})
        mlayer = dict(mext.get("roi_layer", dict(output_size=14)))
        self.mask_out_size = int(mlayer.get("output_size", 14))
        self.mask_size = 2 * self.mask_out_size

    def _mask_feats(self, feats, rois, sem_embed=None):
        from ...ops.roi_align import roi_align, roi_align_multilevel
        mf = roi_align_multilevel(
            list(feats[: len(self.featmap_strides)]), rois,
            output_size=self.mask_out_size,
            featmap_strides=self.featmap_strides,
            sampling_ratio=self.sampling_ratio,
            finest_scale=self.finest_scale)
        if sem_embed is not None and "mask" in self.semantic_fusion:
            sf = roi_align(sem_embed, rois, output_size=self.mask_out_size,
                           spatial_scale=1.0 / 8.0,
                           sampling_ratio=self.sampling_ratio)
            mf = mf + sf.astype(mf.dtype)
        return mf

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid,
             gt_labels, rng, random_proposals=None, random_valid=None,
             gt_masks=None, gt_semantic_seg=None):
        losses, refined_chain = self._cascade_stages(
            feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
            rng, refine_all=self.interleaved)
        sem_embed = None
        if self.semantic is not None:
            seg, sem_embed = self.semantic(feats)
            if gt_semantic_seg is not None:
                tgt = jax.image.resize(
                    gt_semantic_seg.astype(jnp.int32)[..., None],
                    (seg.shape[0], seg.shape[1], seg.shape[2], 1),
                    "nearest")[..., 0]
                logp = jax.nn.log_softmax(seg, -1)
                nll = -jnp.take_along_axis(
                    logp, jnp.clip(tgt, 0, seg.shape[-1] - 1)[..., None],
                    -1)[..., 0]
                valid = tgt < 255
                losses["loss_semantic_seg"] = (
                    jnp.sum(nll * valid) /
                    jnp.maximum(jnp.sum(valid), 1.0)) * 0.2
        if gt_masks is None:
            return losses
        # Per-stage mask losses: stage i samples from the boxes REFINED by
        # bbox stage i (interleaved=True, reference htc_roi_head.py — it
        # calls refine_bboxes between the bbox and mask branches of each
        # stage), or from that stage's entry boxes when interleaved=False
        # (reference cascade_roi_head.py: same sampling results as bbox).
        n = feats[0].shape[0]
        keys = jax.random.split(jax.random.fold_in(rng, 7), self.num_stages)
        last_feat = None
        for stage in range(self.num_stages):
            if self.interleaved:
                cur_boxes, cur_valid = refined_chain[stage]
            elif stage == 0:
                cur_boxes, cur_valid = proposals, prop_valid
            else:
                cur_boxes, cur_valid = refined_chain[stage - 1]
            skeys = jax.random.split(keys[stage], n)
            boxes, labels, is_pos, valid, matched = jax.vmap(
                lambda k, p, pv, g, gv, gl, s=stage: self._stage_sample(
                    s, k, p, pv, g, gv, gl))(
                skeys, cur_boxes, cur_valid, gt_bboxes, gt_valid, gt_labels)
            s_num = boxes.shape[1]
            max_pos = max(int(round(
                s_num * self.samplers[stage].pos_fraction)), 1)
            pboxes = boxes[:, :max_pos]
            plabels = labels[:, :max_pos]
            pvalid = (is_pos & valid)[:, :max_pos]
            pmatched = matched[:, :max_pos]
            bidx = jnp.repeat(jnp.arange(n, dtype=jnp.float32),
                              max_pos).reshape(n, max_pos)
            rois = jnp.concatenate([bidx[..., None], pboxes],
                                   -1).reshape(-1, 5)
            mf = self._mask_feats(feats, rois, sem_embed)
            if self.mask_info_flow and last_feat is not None:
                mf = mf + self.info_convs[stage](last_feat)
            last_feat = mf
            mask_pred = self.mask_heads[stage](mf)
            # gt mask index: recompute matched idx from matched boxes — use
            # nearest gt by IoU (static approximation of the index carry)
            from ...core.bbox.geometry import bbox_overlaps
            gi = jax.vmap(lambda mb, g: jnp.argmax(
                bbox_overlaps(mb, g), -1))(pmatched, gt_bboxes)
            mgt = jax.vmap(lambda m, i: m[i])(gt_masks, gi)
            tgts = jax.vmap(lambda pb, mb, mm: mask_targets(
                pb, mb, mm, self.mask_size))(pboxes, pmatched, mgt)
            lm = self.mask_heads[stage].loss(
                mask_pred, tgts.reshape(-1, self.mask_size, self.mask_size),
                plabels.reshape(-1), pvalid.reshape(-1))
            losses[f"s{stage}.loss_mask"] = (lm
                                             * self.stage_loss_weights[stage])
        return losses

    def simple_test(self, feats, proposals, prop_valid, img_shapes,
                    scale_factors, rescale=True):
        return super().simple_test(feats, proposals, prop_valid, img_shapes,
                                   scale_factors, rescale=rescale)


@HEADS.register_module()
class SCNetRoIHead(HybridTaskCascadeRoIHead):
    """SCNet (reference scnet_roi_head.py): HTC structure + global-context
    multilabel head. The reference's feature relay is folded into the
    semantic fusion path (single shared mask head instead of per-stage)."""
    glbctx_head: Any = None

    def setup(self):
        super().setup()
        if self.glbctx_head is not None:
            gc = dict(self.glbctx_head)
            gc.pop("type", None)
            self.glbctx = GlobalContextHead(**gc, dtype=self.dtype)
        else:
            self.glbctx = None

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid,
             gt_labels, rng, random_proposals=None, random_valid=None,
             gt_masks=None, gt_semantic_seg=None):
        losses = super().loss(feats, proposals, prop_valid, gt_bboxes,
                              gt_valid, gt_labels, rng,
                              gt_masks=gt_masks,
                              gt_semantic_seg=gt_semantic_seg)
        if self.glbctx is not None:
            logits, _ = self.glbctx(feats[-1])
            nc = logits.shape[-1]
            onehot = jnp.max(
                jax.nn.one_hot(gt_labels, nc)
                * gt_valid[..., None].astype(jnp.float32), axis=1)
            per = (jnp.maximum(logits, 0) - logits * onehot
                   + jnp.log1p(jnp.exp(-jnp.abs(logits))))
            losses["loss_glbctx"] = (jnp.mean(per)
                                     * self.glbctx.loss_weight)
        return losses


@HEADS.register_module()
class MaskPointHead(nn.Module):
    """PointRend point head (reference mask_point_head.py:16): per-point MLP
    over [fine-grained feature ; coarse mask logit at the point]."""
    num_fcs: int = 3
    in_channels: int = 256
    fc_channels: int = 256
    num_classes: int = 80
    class_agnostic: bool = False
    coarse_pred_each_layer: bool = True
    dtype: Any = None

    @nn.compact
    def __call__(self, fine, coarse):
        """fine (R, P, C); coarse (R, P, K) -> logits (R, P, K)."""
        x = jnp.concatenate([fine, coarse.astype(fine.dtype)], -1)
        for i in range(self.num_fcs):
            x = nn.relu(nn.Dense(self.fc_channels, dtype=self.dtype,
                                 name=f"fc{i}")(x))
            if self.coarse_pred_each_layer:
                x = jnp.concatenate([x, coarse.astype(x.dtype)], -1)
        out_ch = 1 if self.class_agnostic else self.num_classes
        return nn.Dense(out_ch, dtype=self.dtype,
                        name="fc_logits")(x).astype(jnp.float32)


@HEADS.register_module()
class PointRendRoIHead(StandardRoIHead):
    """PointRend (reference point_rend_roi_head.py:17): coarse FCN mask +
    MLP refinement at uncertainty-sampled points. Training samples
    ``num_points`` with importance sampling (top-uncertain fraction of an
    oversampled set + random rest) — expressed as pure top-k."""
    point_head: Any = None
    num_points: int = 196
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75

    def setup(self):
        super().setup()
        ph = dict(self.point_head or {})
        ph.pop("type", None)
        ph.setdefault("num_classes",
                      dict(self.mask_head or {}).get("num_classes", 80))
        self.point = MaskPointHead(**ph, dtype=self.dtype)

    def _point_loss(self, feats, rois, mask_pred, tgts_full, labels, pvalid,
                    pboxes, rng):
        """Sample uncertain points in roi-normalized coords, refine, BCE."""
        r = mask_pred.shape[0]
        npts = self.num_points
        nover = int(npts * self.oversample_ratio)
        k_imp = int(npts * self.importance_sample_ratio)
        key1, key2 = jax.random.split(rng)
        cand = jax.random.uniform(key1, (r, nover, 2))
        lab = jnp.clip(labels, 0, self.point.num_classes - 1)
        # coarse logits at candidate points (bilinear over the mask grid)
        sel = jnp.take_along_axis(mask_pred, lab[:, None, None, None],
                                  -1)[..., 0]                     # (R,h,h)
        h = sel.shape[-1]
        lx = cand[..., 0] * h - 0.5
        ly = cand[..., 1] * h - 0.5
        logit = bilinear_gather(sel[..., None], ly, lx)[..., 0]   # (R,nover)
        unc = -jnp.abs(logit)
        _, ti = jax.lax.top_k(unc, k_imp)
        imp_pts = jnp.take_along_axis(cand, ti[..., None].repeat(2, -1), 1)
        rnd_pts = jax.random.uniform(key2, (r, npts - k_imp, 2))
        pts = jnp.concatenate([imp_pts, rnd_pts], 1)              # (R,npts,2)
        # fine-grained features: sample FPN level 0 at the image coords
        x1y1 = rois[:, 1:3]
        wh = jnp.maximum(rois[:, 3:5] - rois[:, 1:3], 1.0)
        img_pts = x1y1[:, None, :] + pts * wh[:, None, :]
        f0 = feats[0]
        stride0 = float(self.featmap_strides[0])
        bidx = rois[:, 0].astype(jnp.int32)
        fx = img_pts[..., 0] / stride0 - 0.5
        fy = img_pts[..., 1] / stride0 - 0.5
        # gather per-roi from its image: fold batch into y coordinate
        hb = f0.shape[1]
        fine = bilinear_gather(
            f0.reshape(1, -1, f0.shape[2], f0.shape[3]),
            (fy + bidx[:, None] * hb)[None], fx[None])[0]         # (R,P,C)
        # coarse logits for ALL classes at the chosen points
        cy = pts[..., 1] * h - 0.5
        cx = pts[..., 0] * h - 0.5
        coarse = bilinear_gather(mask_pred, cy, cx)               # (R,P,K)
        refined = self.point(fine, coarse)                        # (R,P,K|1)
        if self.point.class_agnostic:
            plog = refined[..., 0]
        else:
            plog = jnp.take_along_axis(refined, lab[:, None, None],
                                       -1)[..., 0]
        # point targets: sample the full-res mask targets at pts
        ms = tgts_full.shape[-1]
        ty = pts[..., 1] * ms - 0.5
        tx = pts[..., 0] * ms - 0.5
        tgt = (bilinear_gather(tgts_full[..., None], ty, tx)[..., 0]
               >= 0.5).astype(jnp.float32)
        per = (jnp.maximum(plog, 0) - plog * tgt
               + jnp.log1p(jnp.exp(-jnp.abs(plog))))
        per = jnp.mean(per, -1)
        w = pvalid.astype(jnp.float32)
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1.0)

    def _mask_loss(self, feats, boxes_all, labels_all, is_pos_all, valid_all,
                   matched_all, matched_idx_all, gt_masks):
        n, s = boxes_all.shape[:2]
        max_pos = max(int(round(s * self.sampler.pos_fraction)), 1)
        pboxes = boxes_all[:, :max_pos]
        plabels = labels_all[:, :max_pos]
        pvalid = (is_pos_all & valid_all)[:, :max_pos]
        pmatched = matched_all[:, :max_pos]
        pmidx = matched_idx_all[:, :max_pos]
        bidx = jnp.repeat(jnp.arange(n, dtype=jnp.float32),
                          max_pos).reshape(n, max_pos)
        rois = jnp.concatenate([bidx[..., None], pboxes], -1).reshape(-1, 5)
        mfeats = self.extract(feats, rois, out_size=self.mask_out_size)
        mask_pred = self.mask_head_m(mfeats)
        mgt = jax.vmap(lambda m, i: m[i])(gt_masks, pmidx)
        tgts = jax.vmap(lambda pb, mb, mm: mask_targets(
            pb, mb, mm, self.mask_size))(pboxes, pmatched, mgt)
        tgts = tgts.reshape(-1, self.mask_size, self.mask_size)
        lm = self.mask_head_m.loss(mask_pred, tgts, plabels.reshape(-1),
                                   pvalid.reshape(-1))
        lp = self._point_loss(feats, rois, mask_pred, tgts,
                              plabels.reshape(-1), pvalid.reshape(-1),
                              pboxes.reshape(-1, 4),
                              jax.random.PRNGKey(0))
        return lm + lp


from ..detectors.two_stage import MaskRCNN, TwoStageDetector  # noqa: E402


@DETECTORS.register_module()
class HybridTaskCascade(TwoStageDetector):
    """Alias detector (reference mmdet/models/detectors/htc.py)."""
    pass


@DETECTORS.register_module()
class SCNet(TwoStageDetector):
    """Alias (reference scnet.py)."""
    pass


@DETECTORS.register_module()
class PointRend(MaskRCNN):
    """Alias (reference point_rend.py)."""
    pass


@HEADS.register_module()
class CoarseMaskHead(FCNMaskHead):
    """PointRend coarse head entry (reference coarse_mask_head.py) —
    served by the FCN mask head (the point branch refines it)."""
    pass


@HEADS.register_module()
class SCNetMaskHead(FCNMaskHead):
    """reference scnet_mask_head.py (FCN mask head + conv_to_res blocks)."""
    pass


@HEADS.register_module()
class SCNetSemanticHead(FusedSemanticHead):
    """reference scnet_semantic_head.py."""
    pass


@HEADS.register_module()
class FeatureRelayHead(nn.Module):
    """reference feature_relay_head.py: FC feature -> spatial map feeding
    the SCNet mask branch."""
    in_channels: int = 1024
    out_conv_channels: int = 256
    roi_feat_size: int = 7
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        r = self.roi_feat_size
        y = nn.Dense(self.out_conv_channels * r * r, dtype=self.dtype,
                     name="fc")(x)
        return y.reshape(x.shape[0], r, r, self.out_conv_channels)
