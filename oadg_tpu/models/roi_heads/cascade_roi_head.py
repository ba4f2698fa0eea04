"""Cascade R-CNN RoI head (reference mmdet/models/roi_heads/cascade_roi_head.py):
three refinement stages with increasing IoU thresholds (0.5/0.6/0.7),
stage loss weights, decode-and-reassign between stages; inference averages
the stages' class scores on the final refined boxes.

Static-shape: each stage re-assigns and re-samples the SAME fixed number of
RoIs from the previous stage's refined boxes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp

from ... import nn
from ...core.bbox.assign_sample import MaxIoUAssigner, RandomSampler
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import HEADS, build_from_cfg
from .standard_roi_head import StandardRoIHead


@HEADS.register_module()
class CascadeRoIHead(nn.Module):
    num_stages: int = 3
    stage_loss_weights: Sequence[float] = (1.0, 0.5, 0.25)
    bbox_roi_extractor: Any = None
    bbox_head: Any = None            # list of per-stage head cfgs (or one)
    train_cfg: Any = None            # list of per-stage rcnn cfgs
    test_cfg: Any = None
    num_views: int = 1
    dtype: Any = None

    def setup(self):
        from collections.abc import Mapping
        heads_cfg = self.bbox_head
        if heads_cfg is None or isinstance(heads_cfg, Mapping):
            heads_cfg = [heads_cfg or {}] * self.num_stages
        self.heads = [
            build_from_cfg(dict(type=dict(h).get("type", "Shared2FCBBoxHead"),
                                **{k: v for k, v in dict(h).items()
                                   if k != "type"},
                                dtype=self.dtype), HEADS)
            for h in heads_cfg]
        ext = dict(self.bbox_roi_extractor or {})
        roi_layer = dict(ext.get("roi_layer", dict(output_size=7)))
        self.roi_out_size = int(roi_layer.get("output_size", 7))
        self.featmap_strides = tuple(ext.get("featmap_strides", (4, 8, 16, 32)))
        self.finest_scale = int(ext.get("finest_scale", 56))
        sr = int(roi_layer.get("sampling_ratio", 0))
        self.sampling_ratio = sr if sr > 0 else 2

        tcs = self.train_cfg
        if tcs is None:
            tcs = [dict(assigner=dict(pos_iou_thr=t, neg_iou_thr=t,
                                      min_pos_iou=t, match_low_quality=False),
                        sampler=dict(num=512, pos_fraction=0.25,
                                     add_gt_as_proposals=True))
                   for t in (0.5, 0.6, 0.7)]
        from collections.abc import Mapping as _Mapping
        if isinstance(tcs, _Mapping):
            tcs = [tcs] * self.num_stages
        assigners, samplers, add_gt = [], [], []
        for tc in tcs:
            asn = dict(dict(tc).get("assigner", {}))
            asn.pop("type", None)
            assigners.append(MaxIoUAssigner(**(asn or dict(
                pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
                match_low_quality=False))))
            smp = dict(dict(tc).get("sampler", dict(num=512,
                                                    pos_fraction=0.25)))
            smp.pop("type", None)
            add_gt.append(smp.pop("add_gt_as_proposals", True))
            samplers.append(RandomSampler(**smp))
        self.assigners = assigners
        self.samplers = samplers
        self.add_gt = add_gt

    def extract(self, feats, rois):
        from ...ops.roi_align import roi_align_multilevel
        return roi_align_multilevel(
            list(feats[: len(self.featmap_strides)]), rois,
            output_size=self.roi_out_size,
            featmap_strides=self.featmap_strides,
            sampling_ratio=self.sampling_ratio,
            finest_scale=self.finest_scale)

    def _stage_sample(self, stage, key, proposals, prop_valid, gt, gtv, gtl):
        if self.add_gt[stage]:
            cand = jnp.concatenate([gt, proposals], axis=0)
            cand_valid = jnp.concatenate([gtv, prop_valid], axis=0)
        else:
            cand, cand_valid = proposals, prop_valid
        assign = self.assigners[stage].assign(cand, gt, gtv, gt_labels=gtl,
                                              box_valid=cand_valid)
        res = self.samplers[stage].sample(key, assign)
        boxes = cand[res.inds]
        matched = jnp.clip(res.gt_inds - 1, 0, gt.shape[0] - 1)
        return boxes, res.labels, res.is_pos, res.valid, gt[matched]

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid,
             gt_labels, rng, random_proposals=None, random_valid=None):
        losses, _ = self._cascade_stages(feats, proposals, prop_valid,
                                         gt_bboxes, gt_valid, gt_labels, rng)
        return losses

    def _cascade_stages(self, feats, proposals, prop_valid, gt_bboxes,
                        gt_valid, gt_labels, rng, refine_all=False):
        """Run the bbox cascade; return (losses, refined_chain) where
        refined_chain[i] = (boxes, valid) refined by stage i's regressor —
        the proposals the reference's interleaved HTC mask branch samples
        from (htc_roi_head.py: refine_bboxes between bbox and mask).
        With refine_all the last stage's refinement is computed too."""
        n = feats[0].shape[0]
        losses: Dict[str, jnp.ndarray] = {}
        refined_chain = []
        cur_boxes, cur_valid = proposals, prop_valid
        keys = jax.random.split(rng, self.num_stages)
        for stage in range(self.num_stages):
            head = self.heads[stage]
            skeys = jax.random.split(keys[stage], n)
            boxes, labels, is_pos, valid, matched = jax.vmap(
                lambda k, p, pv, g, gv, gl, s=stage: self._stage_sample(
                    s, k, p, pv, g, gv, gl))(
                skeys, cur_boxes, cur_valid, gt_bboxes, gt_valid, gt_labels)
            s_num = boxes.shape[1]
            bidx = jnp.repeat(jnp.arange(n, dtype=jnp.float32),
                              s_num).reshape(n, s_num)
            rois = jnp.concatenate([bidx[..., None], boxes], -1).reshape(-1, 5)
            roi_feats = self.extract(feats, rois)
            cls_score, bbox_pred, _ = head(roi_feats)
            tl, tw, td, tb = jax.vmap(
                lambda bx, lb, ip, vd, mg, h=head: h.get_targets(
                    bx, lb, ip, vd, mg))(boxes, labels, is_pos, valid, matched)
            stage_losses = head.loss(cls_score, bbox_pred, tl.reshape(-1),
                                     tw.reshape(-1), td.reshape(-1, 4),
                                     tb.reshape(-1, 4))
            w = self.stage_loss_weights[stage]
            for k, v in stage_losses.items():
                losses[f"s{stage}.{k}"] = v * w if k.startswith("loss") else v
            # refine boxes for the next stage (decode predicted deltas of the
            # matched/predicted class, reference bbox_head.refine_bboxes)
            if stage < self.num_stages - 1 or refine_all:
                r = bbox_pred.shape[0]
                if head.reg_class_agnostic:
                    deltas = bbox_pred.reshape(r, 4)
                else:
                    safe = jnp.clip(tl.reshape(-1), 0, head.num_classes - 1)
                    deltas = jnp.take_along_axis(
                        bbox_pred.reshape(r, -1, 4),
                        safe[:, None, None].repeat(4, -1), axis=1)[:, 0]
                refined = head.coder.decode(rois[:, 1:5],
                                            deltas.astype(jnp.float32))
                cur_boxes = jax.lax.stop_gradient(refined.reshape(n, s_num, 4))
                cur_valid = valid
            refined_chain.append((cur_boxes, cur_valid))
        return losses, refined_chain

    def simple_test(self, feats, proposals, prop_valid, img_shapes,
                    scale_factors, rescale=True):
        tc = dict(self.test_cfg or {})
        score_thr = float(tc.get("score_thr", 0.05))
        iou_thr = float(dict(tc.get("nms", {})).get("iou_threshold", 0.5))
        max_per_img = int(tc.get("max_per_img", 100))
        n, p = proposals.shape[:2]
        nc = self.heads[-1].num_classes

        boxes = proposals
        scores_sum = None
        for stage, head in enumerate(self.heads):
            bidx = jnp.repeat(jnp.arange(n, dtype=jnp.float32), p).reshape(n, p)
            rois = jnp.concatenate([bidx[..., None], boxes], -1).reshape(-1, 5)
            roi_feats = self.extract(feats, rois)
            cls_score, bbox_pred, _ = head(roi_feats)
            sc = jax.nn.softmax(cls_score.astype(jnp.float32), -1)
            scores_sum = sc if scores_sum is None else scores_sum + sc
            if stage < self.num_stages - 1:
                r = bbox_pred.shape[0]
                if head.reg_class_agnostic:
                    deltas = bbox_pred.reshape(r, 4)
                else:
                    lbl = jnp.argmax(sc[:, :nc], -1)
                    deltas = jnp.take_along_axis(
                        bbox_pred.reshape(r, -1, 4),
                        lbl[:, None, None].repeat(4, -1), axis=1)[:, 0]
                shapes = jnp.repeat(img_shapes, p, axis=0)
                boxes = head.coder.decode(
                    rois[:, 1:5], deltas.astype(jnp.float32),
                    max_shape=(shapes[:, 0], shapes[:, 1])).reshape(n, p, 4)
        scores = (scores_sum / self.num_stages).reshape(n, p, -1)
        final_pred = bbox_pred.reshape(n, p, -1)
        last = self.heads[-1]

        def one(b, s, reg, pv, shape, sf):
            # decode the final stage's per-class deltas on its input boxes
            if last.reg_class_agnostic:
                dec = last.coder.decode(b, reg.reshape(p, 4),
                                        max_shape=(shape[0], shape[1]))
                dec = jnp.broadcast_to(dec[:, None, :], (p, nc, 4))
            else:
                rep = jnp.repeat(b[:, None, :], nc, axis=1)
                dec = last.coder.decode(rep, reg.reshape(p, -1, 4),
                                        max_shape=(shape[0], shape[1]))
            if rescale:
                dec = dec / jnp.asarray(sf, jnp.float32).reshape(-1)[:4]
            sc = jnp.where(pv[:, None], s, 0.0)
            return multiclass_nms(dec.reshape(p, -1), sc, score_thr, iou_thr,
                                  max_per_img, nc)

        return jax.vmap(one)(boxes, scores, final_pred, prop_valid,
                             img_shapes, scale_factors)


from ...utils.registry import DETECTORS  # noqa: E402
from ..detectors.two_stage import TwoStageDetector  # noqa: E402


@DETECTORS.register_module()
class CascadeRCNN(TwoStageDetector):
    """Alias detector (reference mmdet/models/detectors/cascade_rcnn.py)."""
    pass
