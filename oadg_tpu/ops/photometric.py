"""PIL-exact photometric ops as jnp LUT kernels (jit-safe, vmappable).

Reimplements the Pillow C operators the reference's AugMix/OA-Mix chain calls
(reference mmdet/datasets/pipelines/augmix.py:64-212):
``ImageOps.autocontrast/equalize/posterize/solarize/invert`` and
``ImageEnhance.Color/Contrast/Brightness/Sharpness``. Bit-matching PIL's
integer semantics is a stated fidelity goal (SURVEY.md §2.4), so each op
follows the exact Pillow histogram / truncation arithmetic:

- autocontrast: LUT ``clip(trunc(i*scale + offset))`` from nonzero histogram
  extremes (PIL ImageOps.autocontrast, cutoff=0).
- equalize: ``lut[i] = (step//2 + cumsum_{j<i} h[j]) // step`` with
  ``step = (sum(h) - h[last nonzero]) // 255`` (PIL ImageOps.equalize).
- enhance ops: ``out = trunc(degenerate + factor*(img - degenerate))``
  clipped, per Pillow's ImagingBlend cast; degenerate images follow PIL
  (grayscale via the 16-bit fixed-point L conversion, mean-gray, black,
  SMOOTH-filtered with 1px border passthrough).

Inputs are float32 (H, W, 3) holding uint8 values [0..255]; outputs the same.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "autocontrast", "equalize", "posterize", "solarize", "invert",
    "grayscale_l", "enhance_color", "enhance_contrast", "enhance_brightness",
    "enhance_sharpness",
]


def autocontrast(img: jnp.ndarray) -> jnp.ndarray:
    """Gather-free: PIL's nonzero-histogram extremes are simply the per
    channel min/max pixel values; the LUT ``clip(trunc(i*scale+offset))`` is
    applied arithmetically, so no histogram is built."""
    x = jnp.clip(img, 0, 255)
    xi = jnp.trunc(x)                                           # uint8 value
    # Two-stage per-channel extrema: reduce (H, W*C) over rows first, then
    # the small (W, C) tail. Bitwise-identical: min/max are associative
    # and commutative.
    h, w, c = xi.shape
    row = xi.reshape(h, w * c)
    lo = jnp.min(row, axis=0).reshape(w, c).min(axis=0)         # (C,)
    hi = jnp.max(row, axis=0).reshape(w, c).max(axis=0)
    span = hi - lo
    scale = 255.0 / jnp.where(span > 0, span, 1.0)
    out = jnp.clip(jnp.trunc(xi * scale - lo * scale), 0, 255)
    return jnp.where(span > 0, out, xi)


def equalize_lut_from_hist(hist: jnp.ndarray) -> jnp.ndarray:
    """PIL ImageOps.equalize LUT from per-channel histograms (C, 256) ->
    (C, 256) float32 (identity where the channel is degenerate)."""
    c = hist.shape[0]
    idx = jnp.arange(256)
    nz = hist > 0
    n_nz = jnp.sum(nz, axis=1)
    last_idx = jnp.max(jnp.where(nz, idx[None, :], -1), axis=1)
    h_last = jnp.take_along_axis(hist, jnp.clip(last_idx, 0)[:, None],
                                 axis=1)[:, 0]
    total = jnp.sum(hist, axis=1)
    step = (total - h_last) // 255
    cum_before = jnp.concatenate(
        [jnp.zeros((c, 1), jnp.int32), jnp.cumsum(hist, axis=1)[:, :-1]],
        axis=1)
    step_safe = jnp.where(step > 0, step, 1)
    lut = jnp.clip((step_safe[:, None] // 2 + cum_before)
                   // step_safe[:, None], 0, 255)
    use_ident = (n_nz <= 1) | (step == 0)
    return jnp.where(use_ident[:, None], idx[None, :],
                     lut).astype(jnp.float32)


def apply_lut_nibble(x: jnp.ndarray, lut: jnp.ndarray) -> jnp.ndarray:
    """Apply a per-channel (C, 256) LUT to uint8-valued ``x`` (H, W, C).

    Hi/lo nibble one-hots (EXACT, gather-free): with
    x = 16*h + l,  lut[x] = sum_h T_hi[h] * (L @ T_lo)[h]  where
    L = lut.reshape(16, 16). 32 compares + a tiny K=16 matmul per value
    instead of 256 compare-FMAs. Every partial result selects exactly ONE
    lut entry (the factors are one-hot) and lut values are integers
    <= 255 (exact in bf16), so the output is bit-identical to a real
    table lookup."""
    c = x.shape[-1]
    xi2 = x.reshape(-1, c)                                      # (N, C) f32
    hi_n = jnp.floor(xi2 * (1.0 / 16.0))
    lo_n = xi2 - hi_n * 16.0
    nib = jnp.arange(16, dtype=jnp.float32)
    t_lo = (lo_n[..., None] == nib).astype(jnp.bfloat16)        # (N, C, 16)
    t_hi = (hi_n[..., None] == nib).astype(jnp.bfloat16)        # (N, C, 16)
    lut16 = lut.reshape(c, 16, 16).astype(jnp.bfloat16)         # [c, h, l]
    # m entries are EXACT lut values in bf16 (one-hot selection of
    # integers <= 255), so the bf16 intermediate is lossless and halves
    # the (N, C, 16) traffic vs f32
    m = jnp.einsum("ncl,chl->nch", t_lo, lut16,
                   preferred_element_type=jnp.bfloat16)         # (N, C, 16)
    out = jnp.sum(t_hi.astype(jnp.float32) * m.astype(jnp.float32),
                  axis=-1)                                      # (N, C)
    return out.reshape(x.shape)


def hist256(x: jnp.ndarray) -> jnp.ndarray:
    """256-bin histogram of ``x`` (any shape) of values in [0, 255]
    (truncated to integers first) -> (256,) int32 exact counts.

    A compare-and-sum over the bins, which XLA fuses into one reduction.
    On an H100 it took less time than a nibble one-hot matmul or a
    scatter-add bincount (PERF.md)."""
    flat = jnp.trunc(jnp.clip(x.reshape(-1).astype(jnp.float32), 0, 255))
    bins = jnp.arange(256, dtype=jnp.float32)
    return jnp.sum(flat[None, :] == bins[:, None], axis=1, dtype=jnp.int32)


def image_hist256(img: jnp.ndarray) -> jnp.ndarray:
    """Per-channel 256-bin histogram of uint8-valued (H, W, C) -> (C, 256)
    int32."""
    return jnp.stack([hist256(img[..., ch]) for ch in range(img.shape[-1])])


def equalize(img: jnp.ndarray) -> jnp.ndarray:
    """Gather/scatter-free PIL ImageOps.equalize: compare-sum histogram
    (image_hist256) + nibble-matmul LUT apply."""
    x = jnp.trunc(jnp.clip(img, 0, 255))                        # (H, W, C)
    lut = equalize_lut_from_hist(image_hist256(x))
    return apply_lut_nibble(x, lut)


def autocontrast_params(img: jnp.ndarray):
    """Per-channel (lo, hi) uint8-valued extrema of (H, W, C) — the PIL
    autocontrast (cutoff=0) histogram extremes. Lane-dense two-stage
    reduce (see autocontrast)."""
    xi = jnp.trunc(jnp.clip(img, 0, 255))
    h, w, c = xi.shape
    row = xi.reshape(h, w * c)
    lo = jnp.min(row, axis=0).reshape(w, c).min(axis=0)         # (C,)
    hi = jnp.max(row, axis=0).reshape(w, c).max(axis=0)
    return lo, hi


def posterize(img: jnp.ndarray, bits) -> jnp.ndarray:
    """Keep ``bits`` high bits per channel. ``bits`` may be traced (1..8)."""
    mask = (255 << (8 - jnp.asarray(bits, jnp.int32))) & 255
    x = jnp.clip(img, 0, 255).astype(jnp.int32)
    return (x & mask).astype(jnp.float32)


def solarize(img: jnp.ndarray, threshold) -> jnp.ndarray:
    """Invert pixels >= threshold. ``threshold`` may be traced (0..256)."""
    x = jnp.clip(img, 0, 255)
    return jnp.where(x < threshold, x, 255.0 - x)


def invert(img: jnp.ndarray) -> jnp.ndarray:
    return 255.0 - jnp.clip(img, 0, 255)


def grayscale_l(img: jnp.ndarray) -> jnp.ndarray:
    """PIL 'L' conversion: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16,
    returning (H, W) uint8-valued float. Channel order is RGB."""
    x = jnp.clip(img, 0, 255).astype(jnp.int32)
    l = (x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16
    return l.astype(jnp.float32)


def _blend(degenerate: jnp.ndarray, img: jnp.ndarray, factor) -> jnp.ndarray:
    # Pillow rounds the float product before the add. A backend that fuses
    # the multiply-add (XLA:CPU does) skips that rounding and can move the
    # truncated result by one level. So the factor is split into two
    # halves of 12 significant bits: each product with an integer
    # difference (<= 9 bits) is exact, and their one rounded sum is
    # Pillow's product on every backend, fused or not.
    f = jnp.asarray(factor, jnp.float32)
    f_hi = jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(f, jnp.uint32) & jnp.uint32(0xFFFFF000),
        jnp.float32)
    diff = img - degenerate
    prod = f_hi * diff + (f - f_hi) * diff
    return jnp.clip(jnp.trunc(degenerate + prod), 0, 255)


def enhance_color(img: jnp.ndarray, factor) -> jnp.ndarray:
    gray = grayscale_l(img)[..., None]
    return _blend(jnp.broadcast_to(gray, img.shape), img, factor)


def enhance_contrast(img: jnp.ndarray, factor) -> jnp.ndarray:
    gray = grayscale_l(img)
    mean = jnp.floor(jnp.mean(gray) + 0.5)                      # PIL int(mean+.5)
    return _blend(jnp.full_like(img, mean), img, factor)


def enhance_brightness(img: jnp.ndarray, factor) -> jnp.ndarray:
    return _blend(jnp.zeros_like(img), img, factor)


def enhance_sharpness(img: jnp.ndarray, factor) -> jnp.ndarray:
    x = jnp.clip(img, 0, 255).astype(jnp.float32)
    h, w = x.shape[0], x.shape[1]
    # PIL's SMOOTH filter [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13 as plain
    # adds: the integer tap sum is exact in f32 on every backend (a GPU
    # convolution may round through TF32 or Winograd and flip the +0.5
    # rounding), and n/13 stays >= 1/26 away from every rounding edge.
    p = jnp.pad(x, ((1, 1), (1, 1), (0, 0)))
    taps = sum(p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3))
    sm = jnp.clip(jnp.floor((taps + 4.0 * x) / 13.0 + 0.5), 0, 255)
    # PIL's 3x3 filter leaves a 1px border copied from the source image.
    ri = jnp.arange(h)[:, None, None]
    ci = jnp.arange(w)[None, :, None]
    border = (ri == 0) | (ri == h - 1) | (ci == 0) | (ci == w - 1)
    degenerate = jnp.where(border, x, sm)
    return _blend(degenerate, x, factor)
