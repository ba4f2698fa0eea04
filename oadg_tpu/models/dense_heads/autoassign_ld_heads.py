"""AutoAssign, NAS-FCOS, LD/LAD (distillation) and PISA dense heads.

References: mmdet/models/dense_heads/autoassign_head.py (differentiable
center-prior assignment), nasfcos_head.py, ld_head.py + kd_one_stage.py,
lad_head.py (label-assignment distillation), pisa_retinanet_head.py,
pisa_ssd_head.py.
"""
from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...core.bbox.geometry import bbox_overlaps
from ...core.bbox.transforms import distance2bbox
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, GroupNorm32
from .fcos_head import FCOSHead
from .fovea_fsaf_heads import _level_points
from .gfl_head import GFLHead
from .paa_head import PAAHead
from .retina_head import RetinaHead

INF = 1e8


@HEADS.register_module()
class AutoAssignHead(FCOSHead):
    """AutoAssign (reference autoassign_head.py:87): fully differentiable
    assignment — per-class gaussian center prior weights a confidence-
    weighted positive bag per gt; negatives are focal-discounted by an
    IoU-derived weight inside gt boxes."""
    pos_loss_weight: float = 0.25
    neg_loss_weight: float = 0.75
    center_loss_weight: float = 0.75
    temperature: float = 1.0 / 3.0

    def setup(self):
        super().setup()
        self.center_prior_mean = self.param(
            "center_prior_mean", nn.initializers.zeros,
            (self.num_classes, 2))
        self.center_prior_sigma = self.param(
            "center_prior_sigma", nn.initializers.ones,
            (self.num_classes, 2))

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds, objs = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        points, sids = _level_points(featmap_sizes, self.strides)
        strides_pp = jnp.asarray(np.asarray(self.strides,
                                            np.float32))[sids]
        cls = jnp.concatenate([s.reshape(n, -1, self.num_classes)
                               for s in cls_scores], 1).astype(jnp.float32)
        reg = jnp.concatenate([b.reshape(n, -1, 4) for b in bbox_preds], 1)
        obj = jnp.concatenate([o.reshape(n, -1) for o in objs],
                              1).astype(jnp.float32)
        boxes = distance2bbox(points[None], reg)
        prob = jax.nn.sigmoid(cls) * jax.nn.sigmoid(obj)[..., None]

        def one(p, bx, gt, gtv, gtl):
            px, py = points[:, 0:1], points[:, 1:2]
            inside = ((px >= gt[None, :, 0]) & (px <= gt[None, :, 2])
                      & (py >= gt[None, :, 1])
                      & (py <= gt[None, :, 3])) & gtv[None, :]     # (P,G)
            # center prior (per gt class)
            cx = (gt[None, :, 0] + gt[None, :, 2]) * 0.5
            cy = (gt[None, :, 1] + gt[None, :, 3]) * 0.5
            mu = self.center_prior_mean[gtl]                       # (G,2)
            sig = jnp.maximum(jnp.abs(self.center_prior_sigma[gtl]),
                              1e-2)
            dx = (px - cx) / strides_pp[:, None] - mu[None, :, 0]
            dy = (py - cy) / strides_pp[:, None] - mu[None, :, 1]
            g = jnp.exp(-0.5 * ((dx / sig[None, :, 0]) ** 2
                                + (dy / sig[None, :, 1]) ** 2))
            g = jnp.where(inside, g, 0.0)
            ious = bbox_overlaps(bx, gt)                           # (P,G)
            p_cls = p[:, gtl]                                      # (P,G)
            p_loc = jnp.exp(-5.0 * (1 - ious))
            p_pos = p_cls * p_loc
            w = g * jnp.exp(p_pos / self.temperature)
            w = jnp.where(inside, w, 0.0)
            w = w / jnp.maximum(jnp.sum(w, 0, keepdims=True), 1e-12)
            bag = jnp.sum(w * p_pos, 0)                            # (G,)
            pos_loss = jnp.sum(-jnp.log(jnp.clip(bag, 1e-12, 1.0)) * gtv)
            # negative: focal on unmatched prob, discounted by iou rank
            fiou = jnp.max(jnp.where(inside, ious, 0.0), -1)       # (P,)
            disc = jnp.clip(1.0 / (1 - jnp.clip(fiou, 0.0, 0.99)), 1.0,
                            None)
            wneg = jnp.clip(1 - (disc - 1) / jnp.maximum(
                jnp.max(disc) - 1, 1e-6), 0.0, 1.0)
            neg_p = p * wneg[:, None]
            neg_loss = jnp.sum(neg_p ** 2
                               * -jnp.log(jnp.clip(1 - neg_p, 1e-12, 1.0)))
            # center prior regularization: keep the bag compact
            ng = jnp.maximum(jnp.sum(gtv), 1.0)
            ctr = jnp.sum(-jnp.log(jnp.clip(
                jnp.sum(g, 0) / jnp.maximum(jnp.sum(inside, 0), 1.0),
                1e-12, 1.0)) * gtv)
            return pos_loss, neg_loss, ctr, jnp.sum(gtv)

        pl, nl_, cl, ng = jax.vmap(one)(prob, boxes, gt_bboxes, gt_valid,
                                        gt_labels)
        num_gts = jnp.maximum(jnp.sum(ng), 1.0)
        return dict(
            loss_pos=self.pos_loss_weight * jnp.sum(pl) / num_gts,
            loss_neg=self.neg_loss_weight * jnp.sum(nl_) / num_gts,
            loss_center=self.center_loss_weight * jnp.sum(cl) / num_gts)


@HEADS.register_module()
class NASFCOSHead(FCOSHead):
    """NAS-FCOS head (reference nasfcos_head.py): FCOS with the searched
    separable-conv tower."""

    def setup(self):
        super().setup()
        # override towers with depthwise-separable convs (searched arch)
        self.cls_convs = [Conv(self.feat_channels, 3, 1, 1,
                               dtype=self.dtype, name=f"cls_sep{i}")
                          for i in range(self.stacked_convs)]
        self.reg_convs = [Conv(self.feat_channels, 3, 1, 1,
                               dtype=self.dtype, name=f"reg_sep{i}")
                          for i in range(self.stacked_convs)]


@HEADS.register_module()
class LDHead(GFLHead):
    """Localization Distillation (reference ld_head.py:10): GFL head whose
    distribution logits additionally match a teacher's via KD-KL on
    positives. Teacher soft targets arrive through loss(..., soft_targets).
    """
    loss_ld: Any = None

    def setup(self):
        super().setup()
        ld = dict(self.loss_ld or dict(type="KnowledgeDistillationKLDivLoss",
                                       loss_weight=0.25, T=10))
        self.l_ld = build_from_cfg(dict(ld), LOSSES)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None,
             soft_targets=None):
        losses = super().loss(outs, gt_bboxes, gt_valid, gt_labels, rng)
        if soft_targets is not None:
            _, bbox_preds = outs[0], outs[1]
            n = bbox_preds[0].shape[0]
            nb = self.reg_max + 1
            pred = jnp.concatenate(
                [b.reshape(n, -1, 4, nb) for b in bbox_preds], 1)
            soft = jnp.concatenate(
                [s.reshape(n, -1, 4, nb) for s in soft_targets], 1)
            losses["loss_ld"] = self.l_ld(
                pred.reshape(-1, nb),
                jax.lax.stop_gradient(soft).reshape(-1, nb))
        return losses


@HEADS.register_module()
class LADHead(PAAHead):
    """Label Assignment Distillation (reference lad_head.py): a PAA head
    trained with the TEACHER's assignment. The KD detector computes the
    teacher's GMM assignment and passes it here; with no teacher input it
    falls back to self-assignment (= PAA)."""
    pass


@DETECTORS.register_module()
class KnowledgeDistillationSingleStageDetector(SingleStageDetector):
    """reference kd_one_stage.py: a student single-stage detector with a
    frozen teacher run under stop_gradient; the student head receives the
    teacher's predictions as soft targets.

    Freezing: teacher gradients are cut by stop_gradient; to also exempt
    the teacher from weight decay, add ``teacher`` to the optimizer's
    frozen-parameter mask (engine/optim.py) — the reference loads the
    teacher from a checkpoint and never registers it with the optimizer."""
    teacher_config: Any = None

    def setup(self):
        super().setup()
        if self.teacher_config is not None:
            tc = dict(self.teacher_config)
            mdl = dict(tc.get("model", tc))
            mdl.pop("type", None)
            self.teacher = SingleStageDetector(
                **{k: mdl[k] for k in ("backbone", "neck", "bbox_head")
                   if k in mdl}, dtype=self.dtype, name="teacher")
        else:
            self.teacher = None

    def __call__(self, batch, mode="train"):
        if mode != "train" or self.teacher is None:
            return super().__call__(batch, mode)
        feats = self.extract_feat(batch["img"])
        outs = self.head(feats)
        t_outs = jax.tree_util.tree_map(
            jax.lax.stop_gradient,
            self.teacher.head(self.teacher.extract_feat(batch["img"])))
        rng = self.make_rng("sampling")
        return self.head.loss(outs, batch["gt_bboxes"], batch["gt_valid"],
                              batch["gt_labels"], rng,
                              soft_targets=t_outs[1])


@DETECTORS.register_module()
class LAD(KnowledgeDistillationSingleStageDetector):
    """Alias (reference lad.py)."""
    pass


@DETECTORS.register_module()
class AutoAssign(SingleStageDetector):
    pass


@DETECTORS.register_module()
class NASFCOS(SingleStageDetector):
    pass


@HEADS.register_module()
class PISARetinaHead(RetinaHead):
    """PISA on RetinaNet (reference pisa_retinanet_head.py): ISR-P
    reweighting of positive anchors by IoU rank + CARL."""
    isr_k: float = 2.0
    isr_bias: float = 0.0
    carl_k: float = 1.0
    carl_lambda: float = 5.0

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, rng=None):
        cls_scores, bbox_preds = outs
        n = cls_scores[0].shape[0]
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_gen.grid_priors_cat(featmap_sizes)
        cls = jnp.concatenate(
            [s.reshape(n, -1, self.num_classes) for s in cls_scores],
            axis=1).astype(jnp.float32)
        reg = jnp.concatenate(
            [b.reshape(n, -1, 4) for b in bbox_preds],
            axis=1).astype(jnp.float32)

        def one(gt, gtv, gtl):
            assign = self.assigner.assign(anchors, gt, gtv, gt_labels=gtl)
            pos = assign.gt_inds > 0
            neg = assign.gt_inds == 0
            gi = jnp.clip(assign.gt_inds - 1, 0, gt.shape[0] - 1)
            labels = jnp.where(pos, assign.labels, self.num_classes)
            deltas = self.coder.encode(anchors, gt[gi])
            iou = jnp.where(pos, assign.max_overlaps, -1.0)
            return labels, pos, neg, deltas, iou

        labels, pos, neg, deltas, iou = jax.vmap(one)(gt_bboxes, gt_valid,
                                                      gt_labels)
        posm = pos.reshape(-1)
        num_pos = jnp.maximum(jnp.sum(posm), 1.0)
        order = jnp.argsort(-iou.reshape(-1))
        rank = jnp.zeros_like(order).at[order].set(
            jnp.arange(order.shape[0]))
        imp = jnp.clip(1.0 - rank.astype(jnp.float32) / num_pos, 0.0, 1.0)
        w_isr = ((1 - self.isr_bias) + self.isr_bias * imp) \
            * imp ** self.isr_k
        w_isr = w_isr * num_pos / jnp.maximum(jnp.sum(w_isr * posm), 1e-6)
        lw = ((pos | neg).astype(jnp.float32).reshape(-1)
              * jnp.where(posm, w_isr, 1.0))
        loss_cls = self.cls_loss(cls.reshape(-1, self.num_classes),
                                 labels.reshape(-1), lw,
                                 avg_factor=num_pos)
        bw = pos.astype(jnp.float32)[..., None] * jnp.ones((1, 1, 4))
        loss_bbox = self.reg_loss(reg, deltas, bw, avg_factor=num_pos)
        # CARL
        p = jax.nn.sigmoid(cls.reshape(-1, self.num_classes))
        lab = jnp.clip(labels.reshape(-1), 0, self.num_classes - 1)
        sg = jnp.take_along_axis(p, lab[:, None], -1)[:, 0]
        cw = sg ** self.carl_k
        cw = cw * num_pos / jnp.maximum(jnp.sum(cw * posm), 1e-6)
        d = jnp.abs(reg.reshape(-1, 4) - deltas.reshape(-1, 4))
        sl1 = jnp.sum(jnp.where(d < 1.0 / 9.0, 4.5 * d * d,
                                d - 1.0 / 18.0), -1)
        loss_carl = self.carl_lambda * jnp.sum(cw * sl1 * posm) / num_pos
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_carl=loss_carl)


@HEADS.register_module()
class PISASSDHead(PISARetinaHead):
    """PISA on SSD (reference pisa_ssd_head.py) — served by the same
    reweighted anchor loss; the SSD tower/anchors come from config."""
    pass
