"""Device-side batch preprocessing: on-device OA-Mix + multi-view
integration.

Replaces the reference's ``integrate_data`` (mmdet/models/detectors/base.py
:22-48 — a host-side torch.cat of pipeline-produced views) with a fused
device computation: raw clean images are augmented on-chip
(ops/oamix_device.py), normalized, and laid out views-major
``[B clean; B aug1; ...]`` with gt/meta tiled — all inside the jitted train
step, so augmentation overlaps nothing and costs no host<->device traffic.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp

import numpy as np

from ..ops.oamix_device import oamix_batch


def make_oadg_preprocess(oamix_cfg: Dict[str, Any],
                         img_norm_cfg: Dict[str, Any],
                         out_dtype: Optional[Any] = None) -> Callable:
    """Build the (batch, key) -> views-major batch function.

    The norm constants stay numpy (host) on purpose: a jnp.asarray here
    would live on the accelerator and jit-lowering would block fetching it
    back behind everything queued on the device.

    ``out_dtype``: dtype of the integrated image stack. A bf16 model casts
    images at its first conv anyway, so passing bf16 here is model-visible
    bit-identical (normalize math stays f32, one rounding either way) while
    the (B*V, H, W, 3) concatenate — the single largest non-conv tensor in
    the step — moves half the bytes. Default None keeps float32 (tests compare against host
    Normalize at f32 tolerance).
    """
    mean = np.asarray(img_norm_cfg.get("mean", [123.675, 116.28, 103.53]),
                      np.float32)
    std = np.asarray(img_norm_cfg.get("std", [58.395, 57.12, 57.375]),
                     np.float32)
    to_rgb = bool(img_norm_cfg.get("to_rgb", True))
    num_views = int(oamix_cfg.get("num_views", 2))
    cfg = dict(oamix_cfg)

    def preprocess(batch: Dict[str, jnp.ndarray], key) -> Dict[str, jnp.ndarray]:
        raw = batch["img_raw"]
        if raw.dtype != jnp.float32:           # uint8 collate path
            raw = raw.astype(jnp.float32)
        out = oamix_batch(raw, batch["gt_bboxes"],
                          batch["gt_valid"], batch["img_shape"], key, cfg)
        aug = out["aug"]                       # (B, V-1, H, W, 3) raw
        if to_rgb:
            aug = aug[..., ::-1]
        aug = (aug - mean) / std
        if out_dtype is not None:
            aug = aug.astype(out_dtype)

        if "img" in batch:                     # host-normalized clean view
            clean = batch["img"]
            if out_dtype is not None:
                clean = clean.astype(out_dtype)
        else:
            # normalize-on-device path: the collate ships only the raw
            # uint8 batch; derive the clean view here (one fused
            # elementwise pass instead of host numpy per sample)
            clean = raw[..., ::-1] if to_rgb else raw
            clean = (clean - mean) / std
            if out_dtype is not None:
                clean = clean.astype(out_dtype)

        def tile(x):
            return jnp.concatenate([x] * num_views, axis=0)

        imgs = jnp.concatenate(
            [clean] + [aug[:, v] for v in range(aug.shape[1])], axis=0)
        new_batch = {
            "img": imgs,
            "gt_bboxes": tile(batch["gt_bboxes"]),
            "gt_labels": tile(batch["gt_labels"]),
            "gt_valid": tile(batch["gt_valid"]),
            "img_shape": tile(batch["img_shape"]),
            "scale_factor": tile(batch.get(
                "scale_factor",
                jnp.ones((raw.shape[0], 4), jnp.float32))),
            "multilevel_boxes": tile(out["multilevel_boxes"]),
            "multilevel_valid": tile(out["multilevel_valid"]),
            "oamix_boxes": tile(out["oamix_boxes"]),
            "oamix_valid": tile(out["oamix_valid"]),
        }
        return new_batch

    return preprocess
