"""RCNN box heads + static-shape target/loss computation.

Parity targets:
- ``Shared2FCBBoxHead`` (reference
  mmdet/models/roi_heads/bbox_heads/convfc_bbox_head.py:203): flatten 7x7
  RoI features -> 2 shared FC(1024) -> linear cls (C+1) / reg (4C).
- ``Shared2FCContrastiveHead`` (reference contrastive_head.py:353): adds the
  contrastive branch ``fc_cont`` — an ``num_linear``-layer MLP to
  ``feat_channels`` (cont_predictor_cfg, contrastive_head.py:252-263).
- ``BBoxHead.loss`` / ``get_targets_with_absolute`` (bbox_head.py:328):
  labels (bg = num_classes), label_weights 1 on sampled rows, encoded deltas
  + weight 1 on positives; cls avg_factor = count(label_weights > 0), bbox
  avg_factor = total row count — reproduced exactly, but with masks instead
  of ragged ``pos_inds`` indexing.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ... import nn
from ...core.bbox.coder import DeltaXYWHBBoxCoder
from ...utils.registry import HEADS, LOSSES, build_from_cfg
from ..losses.common import accuracy


def _coder_from_cfg(cfg) -> DeltaXYWHBBoxCoder:
    c = dict(cfg or dict(target_means=(0., 0., 0., 0.),
                         target_stds=(0.1, 0.1, 0.2, 0.2)))
    c.pop("type", None)
    return DeltaXYWHBBoxCoder(**c)


@HEADS.register_module()
class Shared2FCBBoxHead(nn.Module):
    """ConvFC box head (reference convfc_bbox_head.py:11): optional shared
    conv stack + shared FC stack -> cls / reg (/ cont) branches. The
    Shared2FC default is 0 convs + 2 FCs; Shared4Conv1FC uses 4 convs + 1 FC.
    """
    in_channels: int = 256
    fc_out_channels: int = 1024
    conv_out_channels: int = 256
    roi_feat_size: int = 7
    num_classes: int = 80
    num_shared_convs: int = 0
    num_shared_fcs: int = 2
    bbox_coder: Any = None
    reg_class_agnostic: bool = False
    reg_decoded_bbox: bool = False   # IoU-family losses regress decoded boxes
    with_avg_pool: bool = False      # C4 heads: global-avg-pool the rois
    norm_cfg: Any = None
    loss_cls: Any = None
    loss_bbox: Any = None
    with_cont: bool = False
    cont_predictor_cfg: Any = None
    loss_cont: Any = None            # consumed by ContrastiveRoIHead
    dtype: Any = None

    def setup(self):
        from ..layers import ConvModule
        self.coder = _coder_from_cfg(self.bbox_coder)
        self.cls_loss = build_from_cfg(dict(self.loss_cls or dict(
            type="CrossEntropyLoss", loss_weight=1.0)), LOSSES)
        self.reg_loss = build_from_cfg(dict(self.loss_bbox or dict(
            type="SmoothL1Loss", beta=1.0, loss_weight=1.0)), LOSSES)
        self.shared_convs = [
            ConvModule(self.conv_out_channels, 3, 1, 1,
                       norm_cfg=self.norm_cfg, dtype=self.dtype,
                       name=f"shared_conv{i}")
            for i in range(self.num_shared_convs)]
        from ..layers import normal_init
        xavier = nn.initializers.xavier_uniform()
        self.shared_fcs = [nn.Dense(self.fc_out_channels, dtype=self.dtype,
                                    kernel_init=xavier,
                                    name=f"shared_fc{i}")
                           for i in range(self.num_shared_fcs)]
        # reference convfc_bbox_head.py init_cfg: cls Normal(0.01),
        # reg Normal(0.001), fcs Xavier
        self.fc_cls = nn.Dense(self.num_classes + 1, dtype=self.dtype,
                               kernel_init=normal_init(0.01))
        reg_dim = 4 if self.reg_class_agnostic else 4 * self.num_classes
        self.fc_reg = nn.Dense(reg_dim, dtype=self.dtype,
                               kernel_init=normal_init(0.001))
        if self.with_cont:
            cfg = dict(self.cont_predictor_cfg or dict(num_linear=2,
                                                       feat_channels=256))
            self.fc_cont = [nn.Dense(cfg.get("feat_channels", 256),
                                     dtype=self.dtype, name=f"fc_cont{i}")
                            for i in range(cfg.get("num_linear", 2))]

    def __call__(self, roi_feats: jnp.ndarray):
        """roi_feats (R, 7, 7, C) -> (cls (R, C+1), reg (R, 4C), cont | None)."""
        x = roi_feats
        for conv in self.shared_convs:
            x = conv(x)
        if self.with_avg_pool:       # C4: (R, h, w, C) -> (R, C)
            x = jnp.mean(x, axis=(1, 2))
        x = x.reshape(x.shape[0], -1)
        for fc in self.shared_fcs:
            x = nn.relu(fc(x))
        cls_score = self.fc_cls(x)
        bbox_pred = self.fc_reg(x)
        cont = None
        if self.with_cont:
            h = x
            for i, fc in enumerate(self.fc_cont):
                h = fc(h)
                if i < len(self.fc_cont) - 1:
                    h = nn.relu(h)
            cont = h
        return cls_score, bbox_pred, cont

    # ---------------- targets ----------------

    def get_targets(self, sampled_boxes, sample_labels, sample_is_pos,
                    sample_valid, matched_gt, pos_weight: float = -1.0):
        """Per-image static targets (reference bbox_head.get_targets /
        get_targets_with_absolute, bbox_head.py:328).

        Args (all per image, leading dim = num_samples):
            sampled_boxes: (S, 4) sampled proposals.
            sample_labels: (S,) matched gt labels (valid for positives).
            sample_is_pos / sample_valid: (S,) bool.
            matched_gt: (S, 4) matched gt box per positive row.

        Returns labels, label_weights, bbox_targets, bbox_weights.
        """
        s = sampled_boxes.shape[0]
        labels = jnp.where(sample_is_pos, sample_labels, self.num_classes)
        pw = 1.0 if pos_weight <= 0 else pos_weight
        label_w = jnp.where(sample_valid,
                            jnp.where(sample_is_pos, pw, 1.0), 0.0)
        if self.reg_decoded_bbox:
            # IoU-family losses: target is the absolute gt box; the pred
            # is decoded in loss() (reference bbox_head.py get_targets)
            deltas = matched_gt
        else:
            deltas = self.coder.encode(sampled_boxes, matched_gt)
        bbox_w = (sample_is_pos.astype(jnp.float32))[:, None] * jnp.ones((1, 4))
        return labels.astype(jnp.int32), label_w, deltas, bbox_w

    # ---------------- loss ----------------

    def loss(self, cls_score, bbox_pred, labels, label_weights, bbox_targets,
             bbox_weights, rois=None):
        """Reference BBoxHead.loss semantics with masked regression rows.
        ``rois`` (R, 4) are required when ``reg_decoded_bbox`` (the deltas
        are decoded against them before the IoU-family loss)."""
        losses = {}
        avg_factor = jnp.maximum(jnp.sum(label_weights > 0), 1.0)
        losses["loss_cls"] = self.cls_loss(
            cls_score.astype(jnp.float32), labels, label_weights,
            avg_factor=avg_factor)
        losses["acc"] = accuracy(cls_score, labels, (label_weights > 0).astype(jnp.float32))

        r = bbox_pred.shape[0]
        if self.reg_class_agnostic:
            pos_pred = bbox_pred.reshape(r, 4)
        else:
            safe = jnp.clip(labels, 0, self.num_classes - 1)
            pos_pred = jnp.take_along_axis(
                bbox_pred.reshape(r, -1, 4), safe[:, None, None].repeat(4, -1),
                axis=1)[:, 0]
        if self.reg_decoded_bbox:
            assert rois is not None, "reg_decoded_bbox needs the roi boxes"
            pos_pred = self.coder.decode(rois.reshape(r, 4),
                                         pos_pred.astype(jnp.float32))
        # reference: loss over pos rows only, avg_factor = total rows
        losses["loss_bbox"] = self.reg_loss(
            pos_pred.astype(jnp.float32), bbox_targets, bbox_weights,
            avg_factor=float(r))
        return losses

    # ---------------- inference ----------------

    def get_bboxes(self, rois, cls_score, bbox_pred, img_shape, scale_factor,
                   rescale: bool = False):
        """Decode per-roi boxes + softmax scores (reference
        bbox_head.get_bboxes). Returns (boxes (R, C*4 or 4), scores (R, C+1))."""
        scores = jax.nn.softmax(cls_score.astype(jnp.float32), axis=-1)
        r = rois.shape[0]
        if self.reg_class_agnostic:
            boxes = self.coder.decode(rois[:, 1:5], bbox_pred, max_shape=img_shape)
        else:
            rep = jnp.repeat(rois[:, None, 1:5], self.num_classes, axis=1)
            boxes = self.coder.decode(rep, bbox_pred.reshape(r, -1, 4),
                                      max_shape=img_shape)
        if rescale:
            sf = jnp.asarray(scale_factor, jnp.float32).reshape(-1)[:4]
            boxes = boxes / sf
        return boxes.reshape(r, -1), scores


@HEADS.register_module()
class ContrastiveHead(Shared2FCBBoxHead):
    """BBoxHead + contrastive branch (reference contrastive_head.py:16)."""
    with_cont: bool = True
    num_shared_fcs: int = 0


@HEADS.register_module()
class Shared2FCContrastiveHead(Shared2FCBBoxHead):
    """2 shared FCs + cls/reg/cont branches (reference contrastive_head.py:353)."""
    with_cont: bool = True
    num_shared_fcs: int = 2


@HEADS.register_module()
class Shared4Conv1FCBBoxHead(Shared2FCBBoxHead):
    """4 shared 3x3 convs + 1 shared FC (reference convfc_bbox_head.py)."""
    num_shared_convs: int = 4
    num_shared_fcs: int = 1


@HEADS.register_module()
class ConvFCBBoxHead(Shared2FCBBoxHead):
    """General ConvFC head; branch-specific conv/fc stacks beyond the shared
    stack collapse to the shared configuration (reference
    convfc_bbox_head.py:11)."""
    pass


@HEADS.register_module()
class BBoxHead(Shared2FCBBoxHead):
    """Plain BBoxHead (no shared FCs; avg-pooled features straight to the
    linear cls/reg, reference bbox_head.py)."""
    num_shared_fcs: int = 0


@HEADS.register_module()
class DoubleConvFCBBoxHead(Shared2FCBBoxHead):
    """Double-Head R-CNN box head (reference
    mmdet/models/roi_heads/bbox_heads/double_bbox_head.py:51): a conv
    branch (residual bottlenecks + global pool) for regression and an FC
    branch for classification."""
    num_convs: int = 4
    num_fcs: int = 2

    def setup(self):
        from ..layers import Conv, FrozenBN
        self.coder = _coder_from_cfg(self.bbox_coder)
        self.cls_loss = build_from_cfg(dict(self.loss_cls or dict(
            type="CrossEntropyLoss", loss_weight=1.0)), LOSSES)
        self.reg_loss = build_from_cfg(dict(self.loss_bbox or dict(
            type="SmoothL1Loss", beta=1.0, loss_weight=1.0)), LOSSES)
        self.res_convs = []
        convs = []
        for i in range(self.num_convs):
            convs.append((
                Conv(self.conv_out_channels // 4, 1, 1, 0, use_bias=False,
                     dtype=self.dtype, name=f"res{i}_conv1"),
                Conv(self.conv_out_channels // 4, 3, 1, 1, use_bias=False,
                     dtype=self.dtype, name=f"res{i}_conv2"),
                Conv(self.conv_out_channels, 1, 1, 0, use_bias=False,
                     dtype=self.dtype, name=f"res{i}_conv3"),
            ))
        self.res_convs = convs
        self.conv_in = Conv(self.conv_out_channels, 1, 1, 0,
                            dtype=self.dtype, name="conv_in")
        self.fcs = [nn.Dense(self.fc_out_channels, dtype=self.dtype,
                             name=f"fc{i}") for i in range(self.num_fcs)]
        self.fc_cls = nn.Dense(self.num_classes + 1, dtype=self.dtype)
        reg_dim = 4 if self.reg_class_agnostic else 4 * self.num_classes
        self.fc_reg = nn.Dense(reg_dim, dtype=self.dtype)

    def __call__(self, roi_feats):
        # reg branch: conv bottlenecks + global average pool
        x = self.conv_in(roi_feats)
        for c1, c2, c3 in self.res_convs:
            y = nn.relu(c1(x))
            y = nn.relu(c2(y))
            y = c3(y)
            x = nn.relu(x + y)
        reg_feat = jnp.mean(x, axis=(1, 2))
        bbox_pred = self.fc_reg(reg_feat)
        # cls branch: flatten + fcs
        f = roi_feats.reshape(roi_feats.shape[0], -1)
        for fc in self.fcs:
            f = nn.relu(fc(f))
        cls_score = self.fc_cls(f)
        return cls_score, bbox_pred, None


@HEADS.register_module()
class Shared2FCBBoxHeadDropout(Shared2FCBBoxHead):
    """Dropout variant (reference convfc_bbox_head_dropout.py:171-190,
    'dropout1d' mode: F.dropout on the shared-FC activations in training).
    Active when the caller provides a 'dropout' PRNG stream (train path);
    deterministic identity otherwise (test path) — matching
    F.dropout(training=...) semantics."""
    dropout_rate: float = 0.5

    def __call__(self, roi_feats: jnp.ndarray):
        x = roi_feats
        for conv in self.shared_convs:
            x = conv(x)
        x = x.reshape(x.shape[0], -1)
        use_drop = self.has_rng("dropout") and self.dropout_rate > 0
        for i, fc in enumerate(self.shared_fcs):
            x = nn.relu(fc(x))
            if use_drop:
                keep = 1.0 - self.dropout_rate
                mask = jax.random.bernoulli(
                    self.make_rng("dropout"), keep, x.shape)
                x = jnp.where(mask, x / keep, 0.0)
        cls_score = self.fc_cls(x)
        bbox_pred = self.fc_reg(x)
        return cls_score, bbox_pred, None


@HEADS.register_module()
class ConvFCBBoxHeadDropout(Shared2FCBBoxHeadDropout):
    """Reference convfc_bbox_head_dropout.py registered name."""
    pass


@HEADS.register_module()
class SABLHead(Shared2FCBBoxHead):
    """Config-surface entry for the two-stage SABL head (reference
    bbox_heads/sabl_head.py). The bucketing localization machinery lives in
    guided_sabl_heads.SABLRetinaHead; the RCNN variant is served by the
    delta head here (documented divergence: bucket-cls localization in the
    second stage lands with a future round)."""
    pass
