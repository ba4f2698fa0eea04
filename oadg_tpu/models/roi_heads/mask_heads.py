"""Mask head (FCNMaskHead) + static-shape mask targets.

Reference: mmdet/models/roi_heads/mask_heads/fcn_mask_head.py:30 (4x conv3x3
-> 2x deconv -> 1x1 class logits; training loss = BCE at the matched class
over positive RoIs; mask_target.py crops full-image gt bitmap masks to each
positive proposal and resizes to ``mask_size``).

Redesign: full-image bitmap masks are ragged and huge. Ground
truth flows through the batcher as per-GT masks **pre-cropped to the gt box**
at a fixed resolution (B, G, M0, M0) — see core/mask/structures.py. A mask
target for a positive proposal is the gt-crop resampled through the
box-relative affinity between the proposal and its matched gt box
(one bilinear gather, static shapes, exact up to resampling).
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from ... import nn
from ...utils.registry import HEADS
from ..layers import Conv


def resample_box_to_box(mask, src_box, dst_box, out_size: int):
    """Sample ``dst_box``'s grid from ``mask`` (M0, M0) that spans
    ``src_box`` (both boxes in image coords). Zero outside ``src_box``.
    Replaces reference mask_target_single's cv2 crop+resize."""
    m0 = mask.shape[0]
    sx1, sy1, sx2, sy2 = src_box[0], src_box[1], src_box[2], src_box[3]
    dx1, dy1, dx2, dy2 = dst_box[0], dst_box[1], dst_box[2], dst_box[3]
    sw = jnp.maximum(sx2 - sx1, 1e-6)
    sh = jnp.maximum(sy2 - sy1, 1e-6)
    xs = dx1 + (jnp.arange(out_size) + 0.5) / out_size * (dx2 - dx1)
    ys = dy1 + (jnp.arange(out_size) + 0.5) / out_size * (dy2 - dy1)
    u = (xs - sx1) / sw * m0 - 0.5            # crop-pixel coords
    v = (ys - sy1) / sh * m0 - 0.5

    def axis_sample(m, t, axis):
        t0 = jnp.floor(t).astype(jnp.int32)
        w1 = t - t0
        a = jnp.take(m, jnp.clip(t0, 0, m0 - 1), axis=axis)
        b = jnp.take(m, jnp.clip(t0 + 1, 0, m0 - 1), axis=axis)
        inb = ((t >= -0.5) & (t <= m0 - 0.5)).astype(m.dtype)
        shape = [1, 1]
        shape[axis] = t.shape[0]
        wb = w1.reshape(shape)
        return (a * (1 - wb) + b * wb) * inb.reshape(shape)

    out = axis_sample(mask, v, 0)
    return axis_sample(out, u, 1)


def mask_targets(pos_boxes, matched_gt_boxes, matched_gt_masks,
                 mask_size: int):
    """(P,4), (P,4), (P,M0,M0) -> (P,mask_size,mask_size) binary targets."""
    t = jax.vmap(lambda m, s, d: resample_box_to_box(m, s, d, mask_size))(
        matched_gt_masks, matched_gt_boxes, pos_boxes)
    return (t >= 0.5).astype(jnp.float32)


@HEADS.register_module()
class FCNMaskHead(nn.Module):
    """Reference fcn_mask_head.py:30 architecture (NHWC)."""
    num_convs: int = 4
    in_channels: int = 256
    conv_out_channels: int = 256
    num_classes: int = 80
    class_agnostic: bool = False
    loss_mask: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        for i in range(self.num_convs):
            x = nn.relu(Conv(self.conv_out_channels, 3, 1, 1,
                             dtype=self.dtype, name=f"conv_{i}")(x))
        x = nn.ConvTranspose(self.conv_out_channels, (2, 2), strides=(2, 2),
                             dtype=self.dtype, name="upsample")(x)
        x = nn.relu(x)
        out_ch = 1 if self.class_agnostic else self.num_classes
        x = Conv(out_ch, 1, 1, 0, dtype=self.dtype, name="conv_logits")(x)
        return x.astype(jnp.float32)        # (R, 2*roi, 2*roi, K)

    def loss(self, mask_pred, mask_targets_, labels, pos_valid):
        """BCE at the matched-class channel, mean over positive pixels
        (reference fcn_mask_head.py loss: loss_mask = BCE(pred[pos, label]))."""
        if self.class_agnostic:
            sel = mask_pred[..., 0]
        else:
            lab = jnp.clip(labels, 0, self.num_classes - 1)
            sel = jnp.take_along_axis(
                mask_pred, lab[:, None, None, None], axis=-1)[..., 0]
        per = jnp.maximum(sel, 0) - sel * mask_targets_ + jnp.log1p(
            jnp.exp(-jnp.abs(sel)))
        per = jnp.mean(per, axis=(1, 2))            # (P,)
        w = pos_valid.astype(jnp.float32)
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1.0)

    def get_masks(self, mask_pred, labels):
        """Per-detection sigmoid mask probs at the predicted class."""
        if self.class_agnostic:
            return jax.nn.sigmoid(mask_pred[..., 0])
        lab = jnp.clip(labels, 0, self.num_classes - 1)
        sel = jnp.take_along_axis(mask_pred, lab[:, None, None, None],
                                  axis=-1)[..., 0]
        return jax.nn.sigmoid(sel)
