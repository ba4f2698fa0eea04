"""Geometric image kernels in pure XLA (jnp), faithful to the cv2 calls the
reference makes from its CPU augmentation pipeline.

Replaces (see SURVEY.md §2.4):
- ``cv2.warpAffine`` / ``cv2.getRotationMatrix2D`` (reference
  mmdet/datasets/pipelines/augmix.py:91-92 and friends) -> :func:`warp_affine`
  (inverse-map bilinear gather, BORDER_CONSTANT semantics).
- ``cv2.GaussianBlur(ksize=(0,0), sigmaX, sigmaY)`` (reference
  mmdet/datasets/pipelines/oa_mix.py:90) -> :func:`gaussian_blur` with
  OpenCV's derived kernel size and REFLECT_101 border.
- ``cv2.resize`` bilinear (oa_mix.py:91) -> :func:`resize_bilinear`
  (half-pixel-center convention, same as cv2).

All functions are jit-safe, operate on float32 arrays in [0, 255] (HWC), and
vmap cleanly over a leading batch dimension.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "invert_affine", "rotation_matrix", "warp_affine", "warp_affine_batch",
    "gaussian_kernel1d", "gaussian_blur", "box_blur3", "resize_bilinear",
]


def invert_affine(m: jnp.ndarray) -> jnp.ndarray:
    """Invert a 2x3 affine matrix (cv2.invertAffineTransform)."""
    a, b, tx = m[0, 0], m[0, 1], m[0, 2]
    c, d, ty = m[1, 0], m[1, 1], m[1, 2]
    det = a * d - b * c
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return jnp.stack([jnp.stack([ia, ib, itx]), jnp.stack([ic, id_, ity])])


def rotation_matrix(center: Tuple, angle_deg, scale=1.0) -> jnp.ndarray:
    """cv2.getRotationMatrix2D: rotate ``angle_deg`` CCW about ``center``."""
    angle = jnp.deg2rad(jnp.asarray(angle_deg, jnp.float32))
    alpha = scale * jnp.cos(angle)
    beta = scale * jnp.sin(angle)
    cx, cy = center[0], center[1]
    return jnp.stack([
        jnp.stack([alpha, beta, (1.0 - alpha) * cx - beta * cy]),
        jnp.stack([-beta, alpha, beta * cx + (1.0 - alpha) * cy]),
    ])


def _bilinear_sample(img: jnp.ndarray, xs: jnp.ndarray, ys: jnp.ndarray,
                     border_value: float = 0.0) -> jnp.ndarray:
    """Sample ``img`` (H, W, C) at float coords; out-of-range reads return
    ``border_value`` (cv2 BORDER_CONSTANT)."""
    h, w = img.shape[0], img.shape[1]
    x0 = jnp.floor(xs)
    y0 = jnp.floor(ys)
    fx = xs - x0
    fy = ys - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = img[jnp.clip(yi, 0, h - 1), jnp.clip(xi, 0, w - 1)]
        return jnp.where(inside[..., None], v, border_value)

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    wx = fx[..., None]
    wy = fy[..., None]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def warp_affine(img: jnp.ndarray, m: jnp.ndarray,
                border_value: float = 0.0,
                inverse_map: bool = False) -> jnp.ndarray:
    """cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT) on (H, W, C) float32.

    ``m`` is the forward 2x3 transform (cv2 inverts it internally unless
    WARP_INVERSE_MAP; pass ``inverse_map=True`` if ``m`` already maps
    dst->src). Output size equals input size (the reference always warps to
    the source size — cv2 dsize=(0,0) / img_size).
    """
    h, w = img.shape[0], img.shape[1]
    inv = m if inverse_map else invert_affine(m)
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    src_x = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    src_y = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    src_x = jnp.broadcast_to(src_x, (h, w))
    src_y = jnp.broadcast_to(src_y, (h, w))
    return _bilinear_sample(img, src_x, src_y, border_value)


def warp_affine_batch(imgs: jnp.ndarray, ms: jnp.ndarray,
                      border_value: float = 0.0) -> jnp.ndarray:
    """Batched warp: imgs (B, H, W, C), ms (B, 2, 3)."""
    return jax.vmap(lambda i, m: warp_affine(i, m, border_value))(imgs, ms)


def _cv2_ksize_from_sigma(sigma: float, max_ksize: int) -> int:
    """cv2.GaussianBlur ksize derivation for float images:
    ksize = round(sigma * 4 * 2 + 1) | 1 (createGaussianFilter)."""
    k = int(round(sigma * 8 + 1)) | 1
    return max(1, min(k, max_ksize))


def gaussian_kernel1d(sigma: float, ksize: int) -> np.ndarray:
    """cv2.getGaussianKernel for ksize derived from sigma (sigma > 0)."""
    half = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _reflect101_pad(img: jnp.ndarray, pad_h: int, pad_w: int) -> jnp.ndarray:
    """cv2 BORDER_REFLECT_101 (= numpy 'reflect')."""
    pads = [(pad_h, pad_h), (pad_w, pad_w)] + [(0, 0)] * (img.ndim - 2)
    return jnp.pad(img, pads, mode="reflect")


def _sep_conv(img: jnp.ndarray, ky: np.ndarray, kx: np.ndarray) -> jnp.ndarray:
    """Separable filtering of (H, W, C) via depthwise conv, reflect101 pad."""
    ry, rx = len(ky) // 2, len(kx) // 2
    x = _reflect101_pad(img, ry, rx)
    c = x.shape[-1]
    x = x.transpose(2, 0, 1)[:, None]                          # channels -> batch: (C,1,H,W)
    wy = jnp.asarray(ky, img.dtype).reshape(1, 1, -1, 1)
    wx = jnp.asarray(kx, img.dtype).reshape(1, 1, 1, -1)
    # HIGHEST: a GPU may run a float32 conv in TF32, which breaks the pins
    hi = jax.lax.Precision.HIGHEST
    x = jax.lax.conv_general_dilated(x, wy, (1, 1), "VALID",
                                     dimension_numbers=("NCHW", "OIHW", "NCHW"),
                                     precision=hi)
    x = jax.lax.conv_general_dilated(x, wx, (1, 1), "VALID",
                                     dimension_numbers=("NCHW", "OIHW", "NCHW"),
                                     precision=hi)
    return x[:, 0].transpose(1, 2, 0)


def gaussian_blur(img: jnp.ndarray, sigma_x: float, sigma_y: float = 0.0,
                  ksize: Optional[Tuple[int, int]] = None) -> jnp.ndarray:
    """cv2.GaussianBlur on (H, W, C) float32 with static sigmas.

    ``ksize=None`` reproduces cv2's ksize-from-sigma derivation (the
    ``(0, 0)`` call in reference oa_mix.py:90). Sigmas must be static Python
    floats (mask-blur sigmas in OA-Mix depend on box size — the on-device
    pipeline quantizes them to a static set; see ops/oamix_device.py).
    """
    sigma_y = sigma_y or sigma_x
    h, w = int(img.shape[0]), int(img.shape[1])
    if ksize is None:
        kx = _cv2_ksize_from_sigma(float(sigma_x), 2 * w - 1)
        ky = _cv2_ksize_from_sigma(float(sigma_y), 2 * h - 1)
    else:
        kx, ky = ksize
    return _sep_conv(img, gaussian_kernel1d(float(sigma_y), ky),
                     gaussian_kernel1d(float(sigma_x), kx))


def box_blur3(img: jnp.ndarray) -> jnp.ndarray:
    """cv2.blur(ksize=(3,3)) with default (REFLECT_101) border."""
    k = np.ones(3, np.float32) / 3.0
    return _sep_conv(img, k, k)


def resize_bilinear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """cv2.resize INTER_LINEAR (half-pixel centers, edge clamp) on (H, W, C)."""
    return jax.image.resize(img, (out_h, out_w) + img.shape[2:], method="linear")
