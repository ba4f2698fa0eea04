"""Spectral-residual saliency as an FFT kernel (jit-safe, vmappable).

Replaces OpenCV-contrib's ``cv2.saliency.StaticSaliencySpectralResidual``
used by OA-Mix to score foreground regions (reference
mmdet/datasets/pipelines/oa_mix.py:108-110). Follows the OpenCV
implementation (Hou & Zhang, CVPR'07 as implemented in opencv_contrib
saliencySpecializedClasses.cpp):

1. convert to grayscale, resize to 64x64;
2. FFT -> log(amplitude + 1); spectral residual = log-amp − 3x3 box blur;
3. recombine exp(residual) with the original phase, inverse FFT;
4. magnitude -> GaussianBlur(ksize=(5,5), sigma=8) -> square -> divide
   by the max.

Each constant and the op order were pinned by disassembling
libopencv_saliency.so 4.6.0 (the naive paper reading differs: contrib
adds 1 before the log, blurs BEFORE squaring, and never subtracts the
min when normalizing); the host-side transcription
(data/pipelines/oa_mix_host._spectral_saliency_map) reproduces contrib
bit-exactly and this kernel matches it up to f32/bilinear-resize
differences.

OA-Mix reduces the map to ``mean(uint8(map*255))`` per box and gates on
``score <= 10``; the mean is taken here over the 64x64 map (the reference
resizes back to the crop first — a mean-preserving step up to interpolation).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .image_ops import box_blur3, gaussian_kernel1d, _sep_conv

__all__ = ["spectral_residual_saliency", "saliency_score", "crop_resize_gray"]

_SIZE = 64


def crop_resize_gray(img: jnp.ndarray, box: jnp.ndarray,
                     bgr: bool = True) -> jnp.ndarray:
    """Extract ``box`` = [x1, y1, x2, y2] (int-valued, traced) from
    (H, W, 3) and resize to (64, 64) grayscale via a bilinear gather.

    Static-shape equivalent of ``img[y1:y2, x1:x2]`` + cv2 resize: sample the
    64x64 half-pixel-center grid directly from the crop's coordinate range.
    """
    if bgr:
        w = jnp.asarray([0.114, 0.587, 0.299], img.dtype)
    else:
        w = jnp.asarray([0.299, 0.587, 0.114], img.dtype)
    # HIGHEST: a GPU may run a float32 dot in TF32, which breaks the pins
    gray = jnp.dot(img, w, precision=jax.lax.Precision.HIGHEST)  # (H, W)
    x1, y1, x2, y2 = box[0], box[1], box[2], box[3]
    bw = jnp.maximum(x2 - x1, 1).astype(jnp.float32)
    bh = jnp.maximum(y2 - y1, 1).astype(jnp.float32)
    sx = bw / _SIZE
    sy = bh / _SIZE
    u = (jnp.arange(_SIZE, dtype=jnp.float32) + 0.5) * sx - 0.5 + x1  # crop -> img space
    v = (jnp.arange(_SIZE, dtype=jnp.float32) + 0.5) * sy - 0.5 + y1
    # clamp inside the crop (cv2.resize clamps at crop edges, not image edges)
    u = jnp.clip(u, x1, x2 - 1)
    v = jnp.clip(v, y1, y2 - 1)
    u0 = jnp.floor(u); fv_u = u - u0
    v0 = jnp.floor(v); fv_v = v - v0
    h, wth = gray.shape
    u0i = jnp.clip(u0.astype(jnp.int32), 0, wth - 1)
    u1i = jnp.clip(u0i + 1, 0, wth - 1)
    v0i = jnp.clip(v0.astype(jnp.int32), 0, h - 1)
    v1i = jnp.clip(v0i + 1, 0, h - 1)
    # Separable bilinear sampling via ROW slices instead of 2D point
    # gathers: gray[v[:,None], u[None,:]] lowers to 4096 scalar-granularity
    # gathers from the 8 MB image. Row gathers read contiguous (1, W) slices;
    # the column step then gathers (1, 64) slices from a 512 KB operand.
    # NOTE: lerping v before u reassociates vs the old 2D-gather version
    # (numerically equivalent, not bit-equal — golden parity passes).
    r0 = gray[v0i, :]                                            # (64, W)
    r1 = gray[v1i, :]
    rows = r0 * (1 - fv_v)[:, None] + r1 * fv_v[:, None]         # (64, W)
    rows_t = rows.T                                              # (W, 64)
    out_t = (rows_t[u0i] * (1 - fv_u)[:, None]
             + rows_t[u1i] * fv_u[:, None])                      # (64u, 64v)
    return out_t.T


def spectral_residual_saliency(gray64: jnp.ndarray) -> jnp.ndarray:
    """(64, 64) grayscale -> (64, 64) saliency map in [0, 1].

    Matches OpenCV-contrib 4.6.0's computeSaliencyImpl step for step
    (confirmed by disassembly; see oa_mix_host._spectral_saliency_map,
    the bit-exact host transcription): ``log(magnitude + 1)``, 3x3 box
    blur of the log-amplitude, recombine with the phase, |idft|,
    GaussianBlur(ksize=5, sigma=8) FIRST then square, and normalize by
    dividing by the max (contrib divides by maxVal; it never subtracts
    the min)."""
    f = jnp.fft.fft2(gray64.astype(jnp.float32))
    mag = jnp.abs(f)
    phase = jnp.angle(f)
    log_amp = jnp.log1p(mag)
    blurred = box_blur3(log_amp[..., None])[..., 0]
    residual = log_amp - blurred
    combined = jnp.exp(residual) * jnp.exp(1j * phase)
    sal = jnp.abs(jnp.fft.ifft2(combined))
    k = gaussian_kernel1d(8.0, 5)
    sal = _sep_conv(sal[..., None], k, k)[..., 0]
    sal = sal * sal
    return sal / jnp.maximum(jnp.max(sal), 1e-30)


def saliency_score(img: jnp.ndarray, box: jnp.ndarray,
                   min_size: int = 4, bgr: bool = True) -> jnp.ndarray:
    """Per-box OA-Mix saliency score: ``mean(uint8(map * 255))``; boxes
    smaller than ``min_size`` (= spatial_ratio, oa_mix.py:103) score -1."""
    boxi = jnp.asarray(box, jnp.int32)
    gray = crop_resize_gray(img, boxi, bgr=bgr)
    sal = spectral_residual_saliency(gray)
    score = jnp.mean(jnp.floor(sal * 255.0).astype(jnp.float32))
    too_small = ((boxi[2] - boxi[0]) < min_size) | ((boxi[3] - boxi[1]) < min_size)
    return jnp.where(too_small, -1.0, score)
