"""Deformable convolution v1/v2 in JAX (replaces mmcv.ops.DeformConv2d /
ModulatedDeformConv2d CUDA kernels; reference users: reppoints_head.py,
vfnet_head.py, guided_anchor_head.py, configs/dcn/*).

Design: the CUDA kernel's per-output-location im2col with
data-dependent addresses becomes (1) a batched bilinear gather of the
K = kh*kw deformed taps — 4 axis-aligned gathers on a flattened (B*H*W, C)
table, fully vectorized, and (2) one large einsum (one dense
matmul). Gradients flow through the gathers (scatter-add under AD).

Layouts: NHWC activations; weights (kh, kw, C_in // groups, C_out) (the
nn.Conv convention). Offsets follow the torch/mmcv channel order
(deform_groups * kh * kw * 2) with (dy, dx) interleaved per tap, NHWC-last,
so torch-converted offset-conv weights work unchanged.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp

__all__ = ["deform_conv2d", "modulated_deform_conv2d", "bilinear_gather"]


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def bilinear_gather(feats: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray
                    ) -> jnp.ndarray:
    """Sample (B,H,W,C) at fractional coords.

    ys/xs: (B, ...) same shape; out-of-range samples contribute zero, taps
    whose 4 corners are all outside give exactly 0 (matches the CUDA
    kernel's zero-padding semantics).

    Returns (B, ..., C).
    """
    b, h, w, c = feats.shape
    tail = ys.shape[1:]
    ys = ys.reshape(b, -1)
    xs = xs.reshape(b, -1)
    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    wy = ys - y0
    wx = xs - x0
    y0i = y0.astype(jnp.int32)
    x0i = x0.astype(jnp.int32)
    table = feats.reshape(b * h * w, c)
    base = (jnp.arange(b, dtype=jnp.int32) * (h * w))[:, None]

    def tap(yi, xi):
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))
        idx = base + jnp.clip(yi, 0, h - 1) * w + jnp.clip(xi, 0, w - 1)
        v = jnp.take(table, idx.reshape(-1), axis=0).reshape(b, -1, c)
        return v * valid[..., None].astype(feats.dtype)

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    wy = wy[..., None].astype(feats.dtype)
    wx = wx[..., None].astype(feats.dtype)
    out = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
           + v10 * wy * (1 - wx) + v11 * wy * wx)
    return out.reshape((b,) + tail + (c,))


def _deform_sample(x: jnp.ndarray, offset: jnp.ndarray,
                   kernel_size, stride, padding, dilation,
                   deform_groups: int,
                   mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Gather the K deformed taps. Returns (B, Ho, Wo, K, C)."""
    b, h, w, c = x.shape
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    k = kh * kw
    ho, wo = offset.shape[1], offset.shape[2]
    dg = deform_groups

    # (B, Ho, Wo, dg, K, 2) with last dim (dy, dx) — torch channel order is
    # dg*K*2 with y first (mmcv deform_conv offset layout).
    off = offset.astype(jnp.float32).reshape(b, ho, wo, dg, k, 2)

    oy = (jnp.arange(ho, dtype=jnp.float32) * sh - ph)[:, None, None]
    ox = (jnp.arange(wo, dtype=jnp.float32) * sw - pw)[None, :, None]
    ky = (jnp.arange(kh, dtype=jnp.float32) * dh)
    kx = (jnp.arange(kw, dtype=jnp.float32) * dw)
    gy = (oy + jnp.repeat(ky, kw)[None, None, :])            # (Ho, 1, K)
    gx = (ox + jnp.tile(kx, kh)[None, None, :])              # (1, Wo, K)
    ys = gy[None, :, :, None, :] + off[..., 0]               # (B,Ho,Wo,dg,K)
    xs = gx[None, :, :, None, :] + off[..., 1]

    if dg == 1:
        taps = bilinear_gather(x, ys[:, :, :, 0], xs[:, :, :, 0])
    else:
        # split channels across deform groups, sample each with its offsets
        xg = x.reshape(b, h, w, dg, c // dg)
        taps = jnp.concatenate(
            [bilinear_gather(xg[:, :, :, g], ys[:, :, :, g], xs[:, :, :, g])
             for g in range(dg)], axis=-1)                   # (B,Ho,Wo,K,C)
    if mask is not None:
        m = mask.astype(taps.dtype).reshape(b, ho, wo, dg, k)
        m = jnp.swapaxes(m, 3, 4)                            # (B,Ho,Wo,K,dg)
        m = jnp.repeat(m, c // dg, axis=-1)                  # (B,Ho,Wo,K,C)
        taps = taps * m
    return taps


def deform_conv2d(x: jnp.ndarray, offset: jnp.ndarray, weight: jnp.ndarray,
                  stride: Union[int, Tuple[int, int]] = 1,
                  padding: Union[int, Tuple[int, int]] = 0,
                  dilation: Union[int, Tuple[int, int]] = 1,
                  groups: int = 1, deform_groups: int = 1,
                  bias: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """DCNv1 (mmcv.ops.deform_conv2d semantics).

    Args:
        x: (B, H, W, C_in) NHWC input.
        offset: (B, Ho, Wo, deform_groups*kh*kw*2), (dy, dx) per tap.
        weight: (kh, kw, C_in // groups, C_out).
    Returns:
        (B, Ho, Wo, C_out).
    """
    kh, kw, cin_g, cout = weight.shape
    taps = _deform_sample(x, offset, (kh, kw), stride, padding, dilation,
                          deform_groups)                     # (B,Ho,Wo,K,C)
    b, ho, wo, k, c = taps.shape
    if groups == 1:
        out = jnp.einsum("bhwkc,kco->bhwo",
                         taps, weight.reshape(k, cin_g, cout),
                         preferred_element_type=jnp.float32)
    else:
        tg = taps.reshape(b, ho, wo, k, groups, c // groups)
        wg = weight.reshape(k, cin_g, groups, cout // groups)
        out = jnp.einsum("bhwkgc,kcgo->bhwgo", tg, wg,
                         preferred_element_type=jnp.float32)
        out = out.reshape(b, ho, wo, cout)
    out = out.astype(x.dtype)
    if bias is not None:
        out = out + bias.astype(out.dtype)
    return out


def modulated_deform_conv2d(x: jnp.ndarray, offset: jnp.ndarray,
                            mask: jnp.ndarray, weight: jnp.ndarray,
                            stride: Union[int, Tuple[int, int]] = 1,
                            padding: Union[int, Tuple[int, int]] = 0,
                            dilation: Union[int, Tuple[int, int]] = 1,
                            groups: int = 1, deform_groups: int = 1,
                            bias: Optional[jnp.ndarray] = None
                            ) -> jnp.ndarray:
    """DCNv2 (mmcv.ops.modulated_deform_conv2d): per-tap sigmoid-activated
    modulation scalars multiply the sampled values.

    mask: (B, Ho, Wo, deform_groups*kh*kw), already sigmoid-activated.
    """
    kh, kw, cin_g, cout = weight.shape
    taps = _deform_sample(x, offset, (kh, kw), stride, padding, dilation,
                          deform_groups, mask=mask)
    b, ho, wo, k, c = taps.shape
    if groups == 1:
        out = jnp.einsum("bhwkc,kco->bhwo",
                         taps, weight.reshape(k, cin_g, cout),
                         preferred_element_type=jnp.float32)
    else:
        tg = taps.reshape(b, ho, wo, k, groups, c // groups)
        wg = weight.reshape(k, cin_g, groups, cout // groups)
        out = jnp.einsum("bhwkgc,kcgo->bhwgo", tg, wg,
                         preferred_element_type=jnp.float32)
        out = out.reshape(b, ho, wo, cout)
    out = out.astype(x.dtype)
    if bias is not None:
        out = out + bias.astype(out.dtype)
    return out
