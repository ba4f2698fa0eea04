"""Panoptic FPN (reference mmdet/models/detectors/panoptic_fpn.py,
panoptic_two_stage_segmentor.py, seg_heads/panoptic_fpn_head.py,
seg_heads/panoptic_fusion_heads/heuristic_fusion_head.py).

PanopticFPN = Mask R-CNN + a semantic (stuff) head over the FPN; fusion of
thing masks and stuff logits is the reference's greedy heuristic, done
host-side in numpy (offline metric path, like the reference's CPU fusion).
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...utils.registry import DETECTORS, HEADS, build_from_cfg
from .two_stage import TwoStageDetector


@DETECTORS.register_module()
class PanopticFPN(TwoStageDetector):
    """Two-stage panoptic segmentor with an FPN semantic head."""
    semantic_head: Any = None

    def setup(self):
        super().setup()
        sh = dict(self.semantic_head or dict(num_classes=54))
        sh.pop("type", None)
        from ..roi_heads.htc_scnet_heads import FusedSemanticHead
        self.semantic = FusedSemanticHead(**sh, dtype=self.dtype,
                                          name="semantic_head")

    def forward_train(self, batch):
        losses = super().forward_train(batch)
        feats = self.extract_feat(batch["img"])
        seg, _ = self.semantic(feats)
        gt_sem = batch.get("gt_semantic_seg")
        if gt_sem is not None:
            tgt = jax.image.resize(
                gt_sem.astype(jnp.int32)[..., None],
                (seg.shape[0], seg.shape[1], seg.shape[2], 1),
                "nearest")[..., 0]
            logp = jax.nn.log_softmax(seg, -1)
            nll = -jnp.take_along_axis(
                logp, jnp.clip(tgt, 0, seg.shape[-1] - 1)[..., None],
                -1)[..., 0]
            valid = tgt < 255
            losses["loss_semantic_seg"] = 0.5 * (
                jnp.sum(nll * valid) / jnp.maximum(jnp.sum(valid), 1.0))
        return losses

    def simple_test(self, batch, rescale: bool = True):
        dets = super().simple_test(batch, rescale=rescale)
        feats = self.extract_feat(batch["img"])
        seg, _ = self.semantic(feats)
        return dets, jax.nn.softmax(seg, -1)


def heuristic_fuse_panoptic(dets, det_labels, det_masks, stuff_probs,
                            num_things: int, overlap_thr: float = 0.5,
                            stuff_area_limit: int = 4096,
                            instance_id_offset: int = 1000):
    """Host-side greedy fusion (reference heuristic_fusion_head.py):
    higher-scoring thing masks claim pixels first; stuff fills the rest if
    its area clears ``stuff_area_limit``. numpy in/out.

    dets (D, 5), det_labels (D,), det_masks (D, H, W) bool,
    stuff_probs (H, W, S). Returns (H, W) panoptic id map
    (label * offset + instance).
    """
    h, w = stuff_probs.shape[:2]
    pan = np.full((h, w), -1, np.int64)
    taken = np.zeros((h, w), bool)
    order = np.argsort(-dets[:, 4])
    inst = 0
    for i in order:
        if dets[i, 4] <= 0:
            continue
        m = det_masks[i] & ~taken
        if m.sum() == 0 or m.sum() / max(det_masks[i].sum(), 1) < overlap_thr:
            continue
        inst += 1
        pan[m] = int(det_labels[i]) * instance_id_offset + inst
        taken |= m
    stuff = np.argmax(stuff_probs, -1)
    for s in range(stuff_probs.shape[-1]):
        m = (stuff == s) & ~taken
        if m.sum() >= stuff_area_limit:
            pan[m] = (num_things + s) * instance_id_offset
            taken |= m
    return pan


@DETECTORS.register_module()
class TwoStagePanopticSegmentor(PanopticFPN):
    """reference panoptic_two_stage_segmentor.py — the generic two-stage
    panoptic entry; PanopticFPN provides the semantic head + fusion."""
    pass
