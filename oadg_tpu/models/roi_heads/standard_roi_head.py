"""RoI heads: assignment/sampling + multilevel RoIAlign + box head.

``StandardRoIHead`` reproduces reference
mmdet/models/roi_heads/standard_roi_head.py:13 (assign -> sample ->
_bbox_forward -> loss; simple_test via get_bboxes + multiclass NMS).

``ContrastiveRoIHead`` reproduces reference contrastive_roi_head.py:11 —
the OA-DG head: proposals are assigned/sampled ONLY for the first B (clean)
images and the same sampled boxes are replicated across views
(contrastive_roi_head.py:84-97), the box head additionally emits contrastive
embeddings, random-proposal embeddings are concatenated
(:139-142), and the loss adds the supervised-contrastive term.

Static-shape policy: every per-image list becomes a padded (B, S, ...) array
with masks; sampling uses randomized-rank top-k (core/bbox/assign_sample.py).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ... import nn
from ...core.bbox.assign_sample import MaxIoUAssigner, RandomSampler
from ...core.post_processing.nms import multiclass_nms
from ...ops.roi_align import roi_align_multilevel
from ...utils.registry import HEADS, LOSSES, build_from_cfg


@HEADS.register_module()
class StandardRoIHead(nn.Module):
    bbox_roi_extractor: Any = None
    bbox_head: Any = None
    mask_roi_extractor: Any = None
    mask_head: Any = None
    shared_head: Any = None          # C4: res5 (ResLayer) applied to rois
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        bh = dict(self.bbox_head or {})
        bh.pop("type", None)
        head_type = (self.bbox_head or {}).get("type", "Shared2FCBBoxHead")
        self.head = build_from_cfg(dict(type=head_type, **bh, dtype=self.dtype),
                                   HEADS)
        sh = dict(self.shared_head or {})
        if sh:
            sh_type = sh.pop("type", "ResLayer")
            sh.pop("pretrained", None)
            self.shared_head_m = build_from_cfg(
                dict(type=sh_type, **sh, dtype=self.dtype), HEADS)
        else:
            self.shared_head_m = None
        ext = dict(self.bbox_roi_extractor or {})
        if ext.get("type") == "GenericRoIExtractor":
            from ...utils.registry import ROI_EXTRACTORS
            self.roi_extractor_m = build_from_cfg(
                dict(ext, dtype=self.dtype), ROI_EXTRACTORS)
        else:
            self.roi_extractor_m = None
        roi_layer = dict(ext.get("roi_layer", dict(output_size=7)))
        self.roi_out_size = int(roi_layer.get("output_size", 7))
        self.featmap_strides = tuple(ext.get("featmap_strides", (4, 8, 16, 32)))
        self.finest_scale = int(ext.get("finest_scale", 56))
        # sampling_ratio=0 in configs means adaptive in CUDA; static 2 here.
        sr = int(roi_layer.get("sampling_ratio", 0))
        self.sampling_ratio = sr if sr > 0 else 2
        tc = dict(self.train_cfg or {})
        asn = dict(tc.get("assigner", dict(pos_iou_thr=0.5, neg_iou_thr=0.5,
                                           min_pos_iou=0.5,
                                           match_low_quality=False)))
        asn.pop("type", None)
        self.assigner = MaxIoUAssigner(**asn)
        smp = dict(tc.get("sampler", dict(num=512, pos_fraction=0.25)))
        smp_type = smp.pop("type", "RandomSampler")
        smp.pop("context", None)       # ScoreHLR: head context is implicit
        self.add_gt_as_proposals = smp.pop("add_gt_as_proposals", True)
        from ...utils.registry import BBOX_SAMPLERS
        sampler_cls = BBOX_SAMPLERS.get(smp_type) or RandomSampler
        if not hasattr(sampler_cls, "sample"):   # PseudoSampler etc.
            sampler_cls = RandomSampler
        self.sampler = sampler_cls(**smp)
        self.pos_weight = float(tc.get("pos_weight", -1))
        # optional mask branch (reference standard_roi_head.py init_mask_head)
        mh = dict(getattr(self, "mask_head", None) or {})
        if mh:
            mh_type = mh.pop("type", "FCNMaskHead")
            self.mask_head_m = build_from_cfg(
                dict(type=mh_type, **mh, dtype=self.dtype), HEADS)
            mext = dict(getattr(self, "mask_roi_extractor", None)
                        or self.bbox_roi_extractor or {})
            mlayer = dict(mext.get("roi_layer", dict(output_size=14)))
            self.mask_out_size = int(mlayer.get("output_size", 14))
            self.mask_size = int(tc.get("mask_size", 28))
        else:
            self.mask_head_m = None

    # ---------------- shared pieces ----------------

    def extract(self, feats, rois, out_size: Optional[int] = None):
        """Multilevel RoIAlign (R, 5) -> (R, out, out, C)."""
        if self.roi_extractor_m is not None:   # GenericRoIExtractor cfg
            return self.roi_extractor_m(
                list(feats[: len(self.featmap_strides)]), rois,
                out_size=out_size or self.roi_out_size)
        return roi_align_multilevel(
            list(feats[: len(self.featmap_strides)]), rois,
            output_size=out_size or self.roi_out_size,
            featmap_strides=self.featmap_strides,
            sampling_ratio=self.sampling_ratio,
            finest_scale=self.finest_scale)

    def _sample_one(self, key, proposals, prop_valid, gt, gt_valid, gt_labels):
        """Assign + sample one clean image. Returns per-sample arrays of
        length ``sampler.num``."""
        if self.add_gt_as_proposals:
            cand = jnp.concatenate([gt, proposals], axis=0)
            cand_valid = jnp.concatenate([gt_valid, prop_valid], axis=0)
        else:
            cand = proposals
            cand_valid = prop_valid
        assign = self.assigner.assign(cand, gt, gt_valid, gt_labels=gt_labels,
                                      box_valid=cand_valid)
        res = self.sampler.sample(key, assign)
        boxes = cand[res.inds]
        matched = jnp.clip(res.gt_inds - 1, 0, gt.shape[0] - 1)
        matched_gt = gt[matched]
        return boxes, res.labels, res.is_pos, res.valid, matched_gt, matched

    def _mask_loss(self, feats, boxes_all, labels_all, is_pos_all, valid_all,
                   matched_all, matched_idx_all, gt_masks):
        """Mask branch on the positive slots only (the sampler orders
        positives first, so the first ``num*pos_fraction`` slots contain
        every selected positive — static-shape pos-only compute, matching
        the reference's ``pos_rois`` restriction)."""
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
        mask_pred = self.mask_head_m(mfeats)              # (R, 2r, 2r, K)

        from .mask_heads import mask_targets
        mgt_masks = jax.vmap(lambda m, i: m[i])(gt_masks, pmidx)
        tgts = jax.vmap(lambda pb, mb, mm: mask_targets(
            pb, mb, mm, self.mask_size))(pboxes, pmatched, mgt_masks)
        return self.mask_head_m.loss(
            mask_pred, tgts.reshape(-1, self.mask_size, self.mask_size),
            plabels.reshape(-1), pvalid.reshape(-1))

    def simple_test_mask(self, feats, dets, det_labels):
        """(N, D, 5) dets -> (N, D, 2r, 2r) class-selected mask probs
        (reference test_mixins.py simple_test_mask)."""
        n, d = dets.shape[:2]
        bidx = jnp.repeat(jnp.arange(n, dtype=jnp.float32), d).reshape(n, d)
        rois = jnp.concatenate([bidx[..., None], dets[..., :4]], -1).reshape(-1, 5)
        mfeats = self.extract(feats, rois, out_size=self.mask_out_size)
        mask_pred = self.mask_head_m(mfeats)
        probs = self.mask_head_m.get_masks(mask_pred, det_labels.reshape(-1))
        return probs.reshape(n, d, probs.shape[-2], probs.shape[-1])

    # ---------------- training ----------------

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid,
             gt_labels, rng, random_proposals=None, random_valid=None,
             gt_masks=None):
        """Compute RoI losses.

        Args:
            feats: FPN maps, batch N = num_views * B (views-major).
            proposals/prop_valid: (N, P, 4) / (N, P) — only the first B rows
                (clean images) are used when num_views > 1.
            gt_*: (N, G, ...) padded ground truth.
            random_proposals: (N, Q, 4) OA random proposals (contrastive only).
            gt_masks: (N, G, M0, M0) per-gt box-cropped masks (mask branch).
        """
        v = self.num_views
        n = feats[0].shape[0]
        b = n // v
        s = self.sampler.num

        keys = jax.random.split(rng, b)
        boxes, labels, is_pos, valid, matched_gt, matched_idx = jax.vmap(
            self._sample_one)(
            keys, proposals[:b], prop_valid[:b], gt_bboxes[:b], gt_valid[:b],
            gt_labels[:b])
        # replicate sampling across views (reference contrastive_roi_head.py:84-97)
        boxes_all = jnp.tile(boxes, (v, 1, 1))                   # (N, S, 4)
        labels_all = jnp.tile(labels, (v, 1))
        is_pos_all = jnp.tile(is_pos, (v, 1))
        valid_all = jnp.tile(valid, (v, 1))
        matched_all = jnp.tile(matched_gt, (v, 1, 1))

        bidx = jnp.repeat(jnp.arange(n, dtype=jnp.float32), s).reshape(n, s)
        rois = jnp.concatenate([bidx[..., None], boxes_all], axis=-1).reshape(-1, 5)
        roi_feats = self.extract(feats, rois)
        if self.shared_head_m is not None:      # C4: res5 on roi features
            roi_feats = self.shared_head_m(roi_feats)
        cls_score, bbox_pred, cont = self.head(roi_feats)

        tgt_labels, tgt_lw, tgt_deltas, tgt_bw = jax.vmap(
            lambda bx, lb, ip, vd, mg: self.head.get_targets(
                bx, lb, ip, vd, mg, self.pos_weight))(
            boxes_all, labels_all, is_pos_all, valid_all, matched_all)

        losses = self.head.loss(
            cls_score, bbox_pred,
            tgt_labels.reshape(-1), tgt_lw.reshape(-1),
            tgt_deltas.reshape(-1, 4), tgt_bw.reshape(-1, 4),
            rois=boxes_all.reshape(-1, 4))
        if self.mask_head_m is not None and gt_masks is not None:
            losses["loss_mask"] = self._mask_loss(
                feats, boxes_all, tgt_labels, is_pos_all, valid_all,
                matched_all, jnp.tile(matched_idx, (v, 1)), gt_masks)
        return losses

    # ---------------- inference ----------------

    def simple_test(self, feats, proposals, prop_valid, img_shapes,
                    scale_factors, rescale=True):
        """Padded detection: returns dets (N, max_per_img, 5), labels, valid."""
        tc = dict(self.test_cfg or {})
        score_thr = float(tc.get("score_thr", 0.05))
        nms_cfg = dict(tc.get("nms", {}))
        iou_thr = float(nms_cfg.get("iou_threshold", 0.5))
        nms_type = str(nms_cfg.get("type", "nms"))
        if nms_type == "soft_nms" and nms_cfg.get("method") == "gaussian":
            nms_type = "soft_nms_gaussian"
        sigma = float(nms_cfg.get("sigma", 0.5))
        min_score = float(nms_cfg.get("min_score", 1e-3))
        max_per_img = int(tc.get("max_per_img", 100))

        n, p = proposals.shape[:2]
        bidx = jnp.repeat(jnp.arange(n, dtype=jnp.float32), p).reshape(n, p)
        rois = jnp.concatenate([bidx[..., None], proposals], axis=-1).reshape(-1, 5)
        roi_feats = self.extract(feats, rois)
        if self.shared_head_m is not None:      # C4: res5 on roi features
            roi_feats = self.shared_head_m(roi_feats)
        cls_score, bbox_pred, _ = self.head(roi_feats)
        nc = self.head.num_classes
        cls_score = cls_score.reshape(n, p, -1)
        bbox_pred = bbox_pred.reshape(n, p, -1)

        def one(rois_i, cls_i, reg_i, pv, shape, sf):
            boxes, scores = self.head.get_bboxes(
                rois_i, cls_i, reg_i, (shape[0], shape[1]), sf, rescale=rescale)
            scores = jnp.where(pv[:, None], scores, 0.0)
            return multiclass_nms(boxes, scores, score_thr, iou_thr,
                                  max_per_img, nc, nms_type=nms_type,
                                  sigma=sigma, min_score=min_score)

        rois_im = rois.reshape(n, p, 5)
        return jax.vmap(one)(rois_im, cls_score, bbox_pred, prop_valid,
                             img_shapes, scale_factors)


@HEADS.register_module()
class ContrastiveRoIHead(StandardRoIHead):
    """OA-DG RoI head: multi-view shared sampling + contrastive loss."""

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid,
             gt_labels, rng, random_proposals=None, random_valid=None,
             gt_masks=None):
        v = self.num_views
        n = feats[0].shape[0]
        b = n // v
        s = self.sampler.num

        keys = jax.random.split(rng, b)
        boxes, labels, is_pos, valid, matched_gt, _ = jax.vmap(
            self._sample_one)(
            keys, proposals[:b], prop_valid[:b], gt_bboxes[:b], gt_valid[:b],
            gt_labels[:b])
        boxes_all = jnp.tile(boxes, (v, 1, 1))
        labels_all = jnp.tile(labels, (v, 1))
        is_pos_all = jnp.tile(is_pos, (v, 1))
        valid_all = jnp.tile(valid, (v, 1))
        matched_all = jnp.tile(matched_gt, (v, 1, 1))

        bidx = jnp.repeat(jnp.arange(n, dtype=jnp.float32), s).reshape(n, s)
        rois = jnp.concatenate([bidx[..., None], boxes_all], axis=-1).reshape(-1, 5)
        roi_feats = self.extract(feats, rois)
        if self.shared_head_m is not None:      # C4: res5 on roi features
            roi_feats = self.shared_head_m(roi_feats)
        cls_score, bbox_pred, cont = self.head(roi_feats)

        tgt_labels, tgt_lw, tgt_deltas, tgt_bw = jax.vmap(
            lambda bx, lb, ip, vd, mg: self.head.get_targets(
                bx, lb, ip, vd, mg, self.pos_weight))(
            boxes_all, labels_all, is_pos_all, valid_all, matched_all)

        losses = self.head.loss(
            cls_score, bbox_pred,
            tgt_labels.reshape(-1), tgt_lw.reshape(-1),
            tgt_deltas.reshape(-1, 4), tgt_bw.reshape(-1, 4),
            rois=boxes_all.reshape(-1, 4))

        # contrastive branch: roi embeddings + random-proposal embeddings
        if cont is not None:
            loss_cont_cfg = (self.bbox_head or {}).get("loss_cont") or dict(
                type="ContrastiveLossPlus", loss_weight=0.01,
                temperature=0.06, num_views=2)
            cont_loss = build_from_cfg(dict(loss_cont_cfg), LOSSES)
            nc = self.head.num_classes
            if random_proposals is not None:
                q = random_proposals.shape[1]
                rb = jnp.repeat(jnp.arange(n, dtype=jnp.float32), q).reshape(n, q)
                rrois = jnp.concatenate([rb[..., None], random_proposals],
                                        axis=-1).reshape(-1, 5)
                rfeats = self.extract(feats, rrois)
                _, _, rcont = self.head(rfeats)
                all_feats = jnp.concatenate([cont, rcont], axis=0)
                all_labels = jnp.concatenate(
                    [tgt_labels.reshape(-1),
                     jnp.full((n * q,), nc, jnp.int32)], axis=0)
                all_valid = jnp.concatenate(
                    [valid_all.reshape(-1),
                     (random_valid if random_valid is not None else
                      jnp.ones((n, q), bool)).reshape(-1)], axis=0)
                layout = (s * b, v, q * b)
            else:
                all_feats, all_labels = cont, tgt_labels.reshape(-1)
                all_valid = valid_all.reshape(-1)
                layout = (s * b, v, 0)
            losses["loss_cont"] = cont_loss(
                all_feats.astype(jnp.float32), all_labels, all_valid, layout)
        return losses


@HEADS.register_module()
class DoubleHeadRoIHead(StandardRoIHead):
    """Double-Head R-CNN (reference
    mmdet/models/roi_heads/double_roi_head.py:8): StandardRoIHead with the
    DoubleConvFCBBoxHead; branch loss weighting folds into the head's
    loss_cls/loss_bbox weights."""
    pass
