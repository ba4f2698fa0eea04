"""Two-stage detectors: FasterRCNN + OA-DG training path.

Reference parity (mmdet/models/detectors/two_stage.py, base.py):
- ``forward_train`` (two_stage.py:92): backbone+neck -> RPN loss + proposals
  -> RoI head loss. Multi-view batches arrive views-major
  ``[B clean; B aug1; ...]`` — ``integrate_data`` (base.py:22-48) is a
  batch-dim concat done by the data layer here, not the detector.
- ``get_random_proposal_list`` (two_stage.py:162-204): extra background
  proposals for OA-Loss from (a) OA-Mix multilevel boxes filtered by
  IoU < iou_max vs gt, (b) oamix background boxes, (c) freshly sampled
  random boxes ('oagrb' mode). Rejection loops become masked candidates.
- ``simple_test`` (two_stage.py:224): RPN proposals -> RoI head detection.

The detector is one module; the train step is
``detector.apply(vars, batch, mode='train', rngs=...)`` returning a loss
dict — everything inside is jit-traceable with static shapes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from ... import nn
from ...core.bbox.geometry import bbox_overlaps
from ...utils.registry import (BACKBONES, DETECTORS, HEADS, NECKS,
                               build_from_cfg)


def random_boxes_uniform(key, img_shape, num: int, scales, ratios):
    """Sample ``num`` random boxes like reference
    generate_random_bboxes_xy (bbox_augmentation.py:123): corner uniform in
    the image, area = U(*scales) * H * W, aspect = U(*ratios); boxes that
    would overflow the image are marked invalid instead of re-drawn.

    Returns boxes (num, 4), valid (num,).
    """
    h, w = img_shape[0], img_shape[1]
    k1, k2, k3, k4 = jax.random.split(key, 4)
    x1 = jax.random.uniform(k1, (num,)) * w
    y1 = jax.random.uniform(k2, (num,)) * h
    scale = jax.random.uniform(k3, (num,), minval=min(scales), maxval=max(scales)) * h * w
    ratio = jax.random.uniform(k4, (num,), minval=min(ratios), maxval=max(ratios))
    bw = jnp.sqrt(scale / ratio)
    bh = jnp.sqrt(scale * ratio)
    x2 = x1 + bw
    y2 = y1 + bh
    valid = (x2 <= w) & (y2 <= h)
    boxes = jnp.stack([x1, y1, jnp.minimum(x2, w), jnp.minimum(y2, h)], axis=-1)
    return boxes, valid


@DETECTORS.register_module()
class TwoStageDetector(nn.Module):
    backbone: Any = None
    neck: Any = None
    rpn_head: Any = None
    roi_head: Any = None
    train_cfg: Any = None
    test_cfg: Any = None
    num_views: int = 1
    init_cfg: Any = None
    pretrained: Any = None
    dtype: Any = None

    def setup(self):
        bb = dict(self.backbone)
        bb_type = bb.pop("type", "ResNet")
        self.backbone_m = build_from_cfg(dict(type=bb_type, **bb,
                                              dtype=self.dtype), BACKBONES)
        if self.neck is not None:
            nk = dict(self.neck)
            nk_type = nk.pop("type", "FPN")
            self.neck_m = build_from_cfg(dict(type=nk_type, **nk,
                                              dtype=self.dtype), NECKS)
        else:
            self.neck_m = None
        tc = dict(self.train_cfg or {})
        if self.rpn_head is not None:
            rh = dict(self.rpn_head)
            rh_type = rh.pop("type", "RPNHead")
            self.rpn = build_from_cfg(
                dict(type=rh_type, **rh, train_cfg=tc.get("rpn"),
                     test_cfg=self.test_cfg, num_views=self.num_views,
                     dtype=self.dtype), HEADS)
        if self.roi_head is not None:
            roi = dict(self.roi_head)
            roi_type = roi.pop("type", "StandardRoIHead")
            if roi_type == "CascadeRoIHead" and roi.get("mask_head"):
                # Cascade-Mask R-CNN == HTC without the semantic branch or
                # mask info flow (reference cascade_roi_head.py's mask path
                # is exactly this) — route to the HTC head which already
                # implements per-stage mask training + stage-averaged test
                roi_type = "HybridTaskCascadeRoIHead"
                roi.setdefault("mask_info_flow", False)
                roi.setdefault("semantic_fusion", ())
            self.roi = build_from_cfg(
                dict(type=roi_type, **roi, train_cfg=tc.get("rcnn"),
                     test_cfg=dict(self.test_cfg or {}).get("rcnn"),
                     num_views=self.num_views, dtype=self.dtype), HEADS)
        self.random_proposal_cfg = tc.get("random_proposal_cfg")

    def extract_feat(self, img):
        x = self.backbone_m(img)
        if self.neck_m is not None:
            x = self.neck_m(x)
        return x

    # ---------------- random proposals (OA-Loss negatives) ----------------

    def _random_proposals(self, batch, rng):
        """Per-image random proposal stack (N, Q, 4) + validity (N, Q)."""
        cfg = dict(self.random_proposal_cfg)
        iou_max = float(cfg.get("iou_max", 0.7))
        num = int(cfg.get("num_bboxes", 10))
        scales = tuple(cfg.get("scales", (0.01, 0.3)))
        ratios = tuple(cfg.get("ratios", (0.3, 1 / 0.3)))
        gt = batch["gt_bboxes"]
        gtv = batch["gt_valid"]
        n = gt.shape[0]

        parts, parts_valid = [], []
        if "multilevel_boxes" in batch:
            mb = batch["multilevel_boxes"]
            mv = batch.get("multilevel_valid", jnp.ones(mb.shape[:2], bool))
            ious = jax.vmap(lambda a, b, bv: jnp.max(
                jnp.where(bv[None, :], bbox_overlaps(a, b), 0.0), axis=1))(
                mb, gt, gtv)
            parts.append(mb)
            parts_valid.append(mv & (ious < iou_max))
        if "oamix_boxes" in batch:
            ob = batch["oamix_boxes"]
            ov = batch.get("oamix_valid", jnp.ones(ob.shape[:2], bool))
            parts.append(ob)
            parts_valid.append(ov)
        if cfg.get("bbox_from", "oagrb").endswith("rb"):
            keys = jax.random.split(rng, n)
            rb, rv = jax.vmap(lambda k, s: random_boxes_uniform(
                k, s, num, scales, ratios))(keys, batch["img_shape"])
            ious = jax.vmap(lambda a, b, bv: jnp.max(
                jnp.where(bv[None, :], bbox_overlaps(a, b), 0.0), axis=1))(
                rb, gt, gtv)
            parts.append(rb)
            parts_valid.append(rv & (ious < iou_max))
        if not parts:
            return None, None
        return (jnp.concatenate(parts, axis=1),
                jnp.concatenate(parts_valid, axis=1))

    # ---------------- train / test ----------------

    def __call__(self, batch, mode: str = "train"):
        if mode == "train":
            return self.forward_train(batch)
        if mode == "aug_test":
            views, metas = batch
            return self.aug_test(views, metas)
        return self.simple_test(batch)

    def forward_train(self, batch):
        feats = self.extract_feat(batch["img"])
        losses = {}
        rpn_rng = self.make_rng("sampling")
        roi_rng = self.make_rng("sampling")

        cls_scores, bbox_preds = self.rpn(feats)
        losses.update(self.rpn.loss(cls_scores, bbox_preds,
                                    batch["gt_bboxes"], batch["gt_valid"],
                                    rpn_rng,
                                    img_shapes=batch.get("img_shape")))
        proposal_cfg = dict(self.train_cfg or {}).get(
            "rpn_proposal", dict(self.test_cfg or {}).get("rpn", {}))
        # proposals only needed for the clean chunk (sampling is replicated
        # across views, contrastive_roi_head.py:84-97)
        b = batch["img"].shape[0] // self.num_views
        prop_boxes, _, prop_valid = self.rpn.get_proposals(
            [s[:b] for s in cls_scores], [p[:b] for p in bbox_preds],
            batch["img_shape"][:b], proposal_cfg)
        if self.num_views > 1:
            pad = ((0, prop_boxes.shape[0] * (self.num_views - 1)),)
            prop_boxes = jnp.concatenate(
                [prop_boxes] * self.num_views, axis=0)
            prop_valid = jnp.concatenate([prop_valid] * self.num_views, axis=0)

        random_proposals = random_valid = None
        if self.random_proposal_cfg is not None:
            random_proposals, random_valid = self._random_proposals(
                batch, self.make_rng("sampling"))

        losses.update(self.roi.loss(
            feats, prop_boxes, prop_valid, batch["gt_bboxes"],
            batch["gt_valid"], batch["gt_labels"], roi_rng,
            random_proposals=random_proposals, random_valid=random_valid,
            gt_masks=batch.get("gt_masks")))
        return losses

    def simple_test(self, batch, rescale: bool = True):
        feats = self.extract_feat(batch["img"])
        cls_scores, bbox_preds = self.rpn(feats)
        cfg = dict(self.test_cfg or {}).get("rpn", {})
        prop_boxes, _, prop_valid = self.rpn.get_proposals(
            cls_scores, bbox_preds, batch["img_shape"], cfg)
        sf = batch.get("scale_factor",
                       jnp.ones((batch["img"].shape[0], 4), jnp.float32))
        return self.roi.simple_test(feats, prop_boxes, prop_valid,
                                    batch["img_shape"], sf, rescale=rescale)

    def aug_test(self, views, metas):
        """Test-time augmentation (reference two_stage.py:268 aug_test,
        core/post_processing/merge_augs.py:13 merge_aug_proposals + :84
        merge_aug_bboxes):

        1. per-view RPN proposals, mapped back to the ORIGINAL image frame
           (flip-back + un-scale), concatenated, one NMS -> shared merged
           proposal set;
        2. per-view RoI forward on the SAME merged proposals (mapped into
           each view's frame), decoded boxes mapped back;
        3. boxes and softmax scores AVERAGED over views, then one
           multiclass NMS with the rcnn test_cfg.

        Args:
            views: tuple of per-view batch dicts (img (B,Hv,Wv,3),
                img_shape (B,2), scale_factor (B,4)) — shapes may differ
                per view (multi-scale TTA); XLA compiles each branch once.
            metas: STATIC tuple of (flip: bool, flip_direction: str) per
                view (closed over by the jitted step, not traced).
        """
        from ...core.bbox.transforms import bbox_flip
        from ...core.post_processing.nms import multiclass_nms, nms_padded

        rpn_cfg = dict(self.test_cfg or {}).get("rpn", {})
        rcnn_cfg = dict(self.test_cfg or {}).get("rcnn", {})

        def flip_im(boxes, shapes, fdir):
            return jax.vmap(lambda bx, s: bbox_flip(bx, s, fdir))(boxes,
                                                                  shapes)

        feats_l, boxes_l, scores_l, valid_l = [], [], [], []
        for vd, (flip, fdir) in zip(views, metas):
            feats = self.extract_feat(vd["img"])
            feats_l.append(feats)
            cs, bp = self.rpn(feats)
            pb, ps, pv = self.rpn.get_proposals(cs, bp, vd["img_shape"],
                                                rpn_cfg)
            if flip:
                pb = flip_im(pb, vd["img_shape"], fdir)
            boxes_l.append(pb / vd["scale_factor"][:, None, :4])
            scores_l.append(ps)
            valid_l.append(pv)

        cat_b = jnp.concatenate(boxes_l, axis=1)
        cat_s = jnp.concatenate(scores_l, axis=1)
        cat_v = jnp.concatenate(valid_l, axis=1)
        iou_thr = float(dict(rpn_cfg.get("nms", {})).get("iou_threshold",
                                                         0.7))
        max_num = int(rpn_cfg.get("max_per_img", 1000))

        def merge_one(b, s, v):
            keep = nms_padded(b, s, iou_thr, valid=v)
            sc = jnp.where(keep, s, -jnp.inf)
            top_s, ti = jax.lax.top_k(sc, min(max_num, sc.shape[0]))
            return b[ti], jnp.isfinite(top_s)

        props, pvalid = jax.vmap(merge_one)(cat_b, cat_s, cat_v)
        n, p = props.shape[:2]
        bidx = jnp.repeat(jnp.arange(n, dtype=jnp.float32), p).reshape(n, p)

        agg_boxes = agg_scores = None
        for vd, feats, (flip, fdir) in zip(views, feats_l, metas):
            vb = props * vd["scale_factor"][:, None, :4]
            if flip:
                vb = flip_im(vb, vd["img_shape"], fdir)
            rois = jnp.concatenate([bidx[..., None], vb], -1).reshape(-1, 5)
            rf = self.roi.extract(feats, rois)
            if self.roi.shared_head_m is not None:
                rf = self.roi.shared_head_m(rf)
            cls_score, bbox_pred = self.roi.head(rf)[:2]
            cls_score = cls_score.reshape(n, p, -1)
            bbox_pred = bbox_pred.reshape(n, p, -1)
            rois_im = rois.reshape(n, p, 5)

            def one(rois_i, cls_i, reg_i, shape, sf):
                return self.roi.head.get_bboxes(
                    rois_i, cls_i, reg_i, (shape[0], shape[1]), sf,
                    rescale=False)

            bxs, scs = jax.vmap(one)(rois_im, cls_score, bbox_pred,
                                     vd["img_shape"], vd["scale_factor"])
            bxs = bxs.reshape(n, -1, 4)              # (n, p*C, 4) view frame
            if flip:
                bxs = flip_im(bxs, vd["img_shape"], fdir)
            bxs = bxs / vd["scale_factor"][:, None, :4]
            agg_boxes = bxs if agg_boxes is None else agg_boxes + bxs
            agg_scores = scs if agg_scores is None else agg_scores + scs

        nv = len(views)
        boxes = (agg_boxes / nv).reshape(n, p, -1)
        scores = agg_scores / nv
        score_thr = float(rcnn_cfg.get("score_thr", 0.05))
        iou = float(dict(rcnn_cfg.get("nms", {})).get("iou_threshold", 0.5))
        mpi = int(rcnn_cfg.get("max_per_img", 100))
        nc = self.roi.head.num_classes

        def fin(b, s, pv):
            s = jnp.where(pv[:, None], s, 0.0)
            return multiclass_nms(b, s, score_thr, iou, mpi, nc)

        return jax.vmap(fin)(boxes, scores, pvalid)


@DETECTORS.register_module()
class FasterRCNN(TwoStageDetector):
    """Alias detector (reference mmdet/models/detectors/faster_rcnn.py:7)."""
    pass


@DETECTORS.register_module()
class MaskRCNN(TwoStageDetector):
    """Mask R-CNN (reference mmdet/models/detectors/mask_rcnn.py:7): the
    RoI head carries the mask branch when ``roi_head.mask_head`` is set —
    training consumes (B, G, M0, M0) box-cropped gt masks from the batch
    (``gt_masks``), inference appends per-detection 2r x 2r mask probs."""

    def simple_test(self, batch, rescale: bool = True):
        feats = self.extract_feat(batch["img"])
        cls_scores, bbox_preds = self.rpn(feats)
        cfg = dict(self.test_cfg or {}).get("rpn", {})
        prop_boxes, _, prop_valid = self.rpn.get_proposals(
            cls_scores, bbox_preds, batch["img_shape"], cfg)
        sf = batch.get("scale_factor",
                       jnp.ones((batch["img"].shape[0], 4), jnp.float32))
        dets, labels, valid = self.roi.simple_test(
            feats, prop_boxes, prop_valid, batch["img_shape"], sf,
            rescale=rescale)
        if getattr(self.roi, "mask_head_m", None) is None:
            return dets, labels, valid
        # mask head consumes feature-space boxes: undo the rescale
        boxes_feat = dets[..., :4] * sf[:, None, :] if rescale else dets[..., :4]
        masks = self.roi.simple_test_mask(
            feats, jnp.concatenate([boxes_feat, dets[..., 4:]], -1), labels)
        return dets, labels, valid, masks
