"""Swin Transformer backbone (reference mmdet/models/backbones/swin.py:
SwinTransformer — P2 backbone surface).

Design notes (vs the reference's torch implementation):
- Window attention is batched as one big (num_windows*B, 49, C) attention —
  a single large matmul chain rather than per-window loops.
- The shifted-window mask is computed from static shapes at trace time
  (numpy), so the whole stage is one fused XLA program; `jnp.roll` performs
  the cyclic shift (an on-device permute).
- Feature maps stay NHWC; patch merging is a reshape+concat+dense.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ...utils.registry import BACKBONES


def _rel_pos_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2 relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]          # (2, N, N)
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def _shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """(num_windows, N, N) additive mask for shifted windows (static)."""
    img_mask = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for ws_ in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, ws_] = cnt
            cnt += 1
    win = img_mask.reshape(hp // ws, ws, wp // ws, ws).transpose(
        0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, :, None] - win[:, None, :]
    return np.where(diff == 0, 0.0, -100.0).astype(np.float32)


class WindowAttention(nn.Module):
    dim: int
    num_heads: int
    window_size: int
    dtype: Any = None

    @nn.compact
    def __call__(self, x, attn_mask=None):
        """x: (B_, N, C) with N = window_size**2."""
        ws, nh = self.window_size, self.num_heads
        n = ws * ws
        hd = self.dim // nh
        qkv = nn.Dense(self.dim * 3, dtype=self.dtype, name="qkv")(x)
        q, k, v = jnp.split(qkv.reshape(-1, n, 3, nh, hd)
                            .transpose(2, 0, 3, 1, 4), 3, axis=0)
        q, k, v = q[0], k[0], v[0]                       # (B_, nh, N, hd)
        attn = (q @ k.transpose(0, 1, 3, 2)).astype(jnp.float32) / np.sqrt(hd)
        table = self.param("rel_bias",
                           nn.initializers.truncated_normal(0.02),
                           ((2 * ws - 1) ** 2, nh))
        idx = jnp.asarray(_rel_pos_index(ws).reshape(-1))
        bias = table[idx].reshape(n, n, nh).transpose(2, 0, 1)
        attn = attn + bias[None]
        if attn_mask is not None:
            nw = attn_mask.shape[0]
            attn = attn.reshape(-1, nw, nh, n, n) + attn_mask[None, :, None]
            attn = attn.reshape(-1, nh, n, n)
        attn = jax.nn.softmax(attn, axis=-1).astype(v.dtype)
        out = (attn @ v).transpose(0, 2, 1, 3).reshape(-1, n, self.dim)
        return nn.Dense(self.dim, dtype=self.dtype, name="proj")(out)


class SwinBlock(nn.Module):
    dim: int
    num_heads: int
    window_size: int = 7
    shift: int = 0
    mlp_ratio: float = 4.0
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        """x: (B, H, W, C); H, W already padded to window multiples."""
        b, h, w, c = x.shape
        ws = self.window_size
        shortcut = x
        x = nn.LayerNorm(dtype=self.dtype, name="norm1")(x)
        if self.shift:
            x = jnp.roll(x, (-self.shift, -self.shift), axis=(1, 2))
        xw = x.reshape(b, h // ws, ws, w // ws, ws, c).transpose(
            0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        mask = None
        if self.shift:
            mask = jnp.asarray(_shift_attn_mask(h, w, ws, self.shift))
        xw = WindowAttention(self.dim, self.num_heads, ws, dtype=self.dtype,
                             name="attn")(xw, mask)
        x = xw.reshape(b, h // ws, w // ws, ws, ws, c).transpose(
            0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
        if self.shift:
            x = jnp.roll(x, (self.shift, self.shift), axis=(1, 2))
        x = shortcut + x
        y = nn.LayerNorm(dtype=self.dtype, name="norm2")(x)
        y = nn.Dense(int(self.dim * self.mlp_ratio), dtype=self.dtype,
                     name="fc1")(y)
        y = nn.gelu(y)
        y = nn.Dense(self.dim, dtype=self.dtype, name="fc2")(y)
        return x + y


@BACKBONES.register_module()
class SwinTransformer(nn.Module):
    """Swin-T/S/B by (embed_dims, depths, num_heads); defaults = Swin-T
    (reference configs/swin/*: embed_dims=96, depths=(2,2,6,2))."""
    embed_dims: int = 96
    depths: Sequence[int] = (2, 2, 6, 2)
    num_heads: Sequence[int] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    patch_size: int = 4
    out_indices: Sequence[int] = (0, 1, 2, 3)
    frozen_stages: int = -1
    init_cfg: Any = None
    convert_weights: bool = False
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        ws = self.window_size
        x = nn.Conv(self.embed_dims, (self.patch_size, self.patch_size),
                    strides=(self.patch_size, self.patch_size),
                    dtype=self.dtype, name="patch_embed")(x)
        x = nn.LayerNorm(dtype=self.dtype, name="patch_norm")(x)
        outs = []
        for si, depth in enumerate(self.depths):
            dim = self.embed_dims * (2 ** si)
            # pad to window multiples (static at trace time)
            b, h, w, c = x.shape
            ph = (ws - h % ws) % ws
            pw = (ws - w % ws) % ws
            xp = jnp.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)))
            for bi in range(depth):
                xp = SwinBlock(dim, self.num_heads[si], ws,
                               shift=0 if bi % 2 == 0 else ws // 2,
                               mlp_ratio=self.mlp_ratio, dtype=self.dtype,
                               name=f"stage{si}_block{bi}")(xp)
            x = xp[:, :h, :w]
            if si in self.out_indices:
                outs.append(nn.LayerNorm(dtype=self.dtype,
                                         name=f"out_norm{si}")(x))
            if si < len(self.depths) - 1:
                # patch merging: 2x2 concat + linear to 2*dim
                b, h, w, c = x.shape
                ph2, pw2 = h % 2, w % 2
                xm = jnp.pad(x, ((0, 0), (0, ph2), (0, pw2), (0, 0)))
                h2, w2 = xm.shape[1] // 2, xm.shape[2] // 2
                xm = xm.reshape(b, h2, 2, w2, 2, c).transpose(
                    0, 1, 3, 2, 4, 5).reshape(b, h2, w2, 4 * c)
                xm = nn.LayerNorm(dtype=self.dtype,
                                  name=f"merge_norm{si}")(xm)
                x = nn.Dense(2 * dim, use_bias=False, dtype=self.dtype,
                             name=f"merge_reduce{si}")(xm)
        return tuple(outs)
