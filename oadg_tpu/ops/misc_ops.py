"""Misc native-op replacements (SURVEY §2.4): CornerPool, point_sample,
RoIPool, MaskedConv2d helper, CARAFE content-aware upsampling.

All pure jnp/XLA — these ops are memory-bound gathers/scans for which XLA's
fusion is already memory-bound; no hand-written kernel needed.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .deform_conv import bilinear_gather

__all__ = ["corner_pool", "point_sample", "roi_pool", "carafe",
           "masked_conv_apply"]


def corner_pool(x: jnp.ndarray, direction: str) -> jnp.ndarray:
    """mmcv.ops.CornerPool: running max toward one border (NHWC).

    direction: 'top' (max over rows below), 'bottom', 'left', 'right'.
    Used by corner_head.py / centripetal_head.py in the reference.
    """
    if direction == "top":       # out[i] = max(x[i:])
        return jnp.flip(jax.lax.cummax(jnp.flip(x, 1), axis=1), 1)
    if direction == "bottom":    # out[i] = max(x[:i+1])
        return jax.lax.cummax(x, axis=1)
    if direction == "left":
        return jnp.flip(jax.lax.cummax(jnp.flip(x, 2), axis=2), 2)
    if direction == "right":
        return jax.lax.cummax(x, axis=2)
    raise ValueError(direction)


def point_sample(feats: jnp.ndarray, points: jnp.ndarray,
                 align_corners: bool = False) -> jnp.ndarray:
    """mmcv point_sample: bilinear sample at normalized [0,1] points.

    feats: (B, H, W, C); points: (B, P, 2) (x, y) in [0, 1].
    Matches F.grid_sample(align_corners=False) pixel mapping:
    pix = p * size - 0.5 (border samples clamp via zero-weight handling —
    mmcv uses default zero padding; for interior points identical).
    Returns (B, P, C).
    """
    b, h, w, c = feats.shape
    if align_corners:
        xs = points[..., 0] * (w - 1)
        ys = points[..., 1] * (h - 1)
    else:
        xs = points[..., 0] * w - 0.5
        ys = points[..., 1] * h - 0.5
    return bilinear_gather(feats, ys, xs)


def roi_pool(feats: jnp.ndarray, rois: jnp.ndarray, output_size: int = 7,
             spatial_scale: float = 1.0, samples: int = 4) -> jnp.ndarray:
    """RoIPool (max in each bin). The CUDA kernel maxes over the integer
    cells in each bin (data-dependent count); here we max over a static
    ``samples``x``samples`` bilinear grid per bin — equal for bins smaller
    than ``samples`` cells, an unbiased approximation above.

    feats: (B, H, W, C); rois: (R, 5) [batch, x1, y1, x2, y2].
    Returns (R, out, out, C).
    """
    r = rois.shape[0]
    out = output_size
    bi = rois[:, 0].astype(jnp.int32)
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale
    bw = jnp.maximum(x2 - x1, 1.0) / out
    bh = jnp.maximum(y2 - y1, 1.0) / out
    gs = out * samples
    steps = (jnp.arange(gs, dtype=jnp.float32) + 0.5) / samples
    xs = x1[:, None] + steps[None, :] * bw[:, None]          # (R, gs)
    ys = y1[:, None] + steps[None, :] * bh[:, None]
    yy = jnp.broadcast_to(ys[:, :, None], (r, gs, gs))
    xx = jnp.broadcast_to(xs[:, None, :], (r, gs, gs))
    # gather per roi from its batch image: flatten batch into coords
    b, h, w, c = feats.shape
    table = feats.reshape(1, b * h, w, c)
    vals = bilinear_gather(table, (yy + (bi * h)[:, None, None])[None],
                           xx[None])[0]                      # (R, gs, gs, C)
    vals = vals.reshape(r, out, samples, out, samples, c)
    return jnp.max(jnp.max(vals, axis=4), axis=2)


def carafe(x: jnp.ndarray, masks: jnp.ndarray, kernel_size: int = 5,
           group_size: int = 1, scale_factor: int = 2) -> jnp.ndarray:
    """CARAFE content-aware reassembly (mmcv.ops.CARAFEPack core).

    x: (B, H, W, C); masks: (B, H*s, W*s, G*k*k) normalized (softmax) kernels.
    Each upsampled output pixel = sum_k mask_k * x[neighborhood k] at the
    source location. Expressed as k*k shifted maps — XLA fuses into one
    weighted sum, no gathers.
    """
    b, h, w, c = x.shape
    s = scale_factor
    k = kernel_size
    g = group_size
    pad = k // 2
    xp = jnp.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    # upsample source index: out (i,j) reads x[i//s, j//s] neighborhood
    taps = []
    for dy in range(k):
        for dx in range(k):
            taps.append(xp[:, dy:dy + h, dx:dx + w, :])
    taps = jnp.stack(taps, axis=3)                           # (B,H,W,k*k,C)
    # replicate to output resolution
    taps = jnp.repeat(jnp.repeat(taps, s, axis=1), s, axis=2)
    m = masks.reshape(b, h * s, w * s, g, k * k)
    taps = taps.reshape(b, h * s, w * s, k * k, g, c // g)
    out = jnp.einsum("bhwkgc,bhwgk->bhwgc", taps, m.astype(taps.dtype))
    return out.reshape(b, h * s, w * s, c)


def masked_conv_apply(conv_out: jnp.ndarray, mask: jnp.ndarray
                      ) -> jnp.ndarray:
    """mmcv MaskedConv2d semantics: dense conv then zero where mask is off.
    The CUDA kernel skips masked locations to save FLOPs; a dense conv
    plus mask needs no data-dependent gathers."""
    return conv_out * mask.astype(conv_out.dtype)[..., None]
