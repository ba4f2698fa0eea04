"""Pyramid Vision Transformer v1/v2 backbones (reference
mmdet/models/backbones/pvt.py: PyramidVisionTransformer,
PyramidVisionTransformerV2).

Attention is one batched dense matmul (no windowing
needed — SRA reduces K/V spatially by sr_ratio so the score matrix stays
small); LayerNorm in fp32; NHWC feature maps between stages.

v1: non-overlapping patch embed + absolute position embeddings (bilinearly
resized to the runtime grid). v2: overlapping conv patch embed, depthwise
conv in the MLP, optional linear-SRA (7x7 adaptive pool), no pos embed.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp

from ... import nn
from ...ops.image_ops import resize_bilinear
from ...utils.registry import BACKBONES
from ..layers import Conv


class _LN(nn.Module):
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        return nn.LayerNorm(epsilon=1e-6, dtype=jnp.float32)(
            x.astype(jnp.float32)).astype(self.dtype or x.dtype)


class SRAttention(nn.Module):
    dim: int
    num_heads: int
    sr_ratio: int = 1
    linear: bool = False
    dtype: Any = None

    @nn.compact
    def __call__(self, x, h, w):
        b, n, c = x.shape
        q = nn.Dense(self.dim, dtype=self.dtype, name="q")(x)
        if self.linear:
            feat = x.reshape(b, h, w, c)
            # adaptive 7x7 pool (reference uses AdaptiveAvgPool2d(7))
            feat = jax.image.resize(feat, (b, 7, 7, c), "linear")
            feat = Conv(self.dim, 1, 1, 0, dtype=self.dtype,
                        name="sr")(feat)
            feat = _LN(self.dtype, name="sr_norm")(feat.reshape(b, 49, c))
            feat = nn.gelu(feat)
        elif self.sr_ratio > 1:
            feat = x.reshape(b, h, w, c)
            feat = Conv(self.dim, self.sr_ratio, self.sr_ratio, 0,
                        dtype=self.dtype, name="sr")(feat)
            feat = feat.reshape(b, -1, c)
            feat = _LN(self.dtype, name="sr_norm")(feat)
        else:
            feat = x
        kv = nn.Dense(self.dim * 2, dtype=self.dtype, name="kv")(feat)
        hd = self.dim // self.num_heads
        qh = q.reshape(b, n, self.num_heads, hd)
        k, v = jnp.split(kv, 2, -1)
        kh = k.reshape(b, -1, self.num_heads, hd)
        vh = v.reshape(b, -1, self.num_heads, hd)
        att = jnp.einsum("bnhd,bmhd->bhnm", qh, kh,
                         preferred_element_type=jnp.float32) * (hd ** -0.5)
        att = jax.nn.softmax(att, -1).astype(x.dtype)
        out = jnp.einsum("bhnm,bmhd->bnhd", att, vh).reshape(b, n, self.dim)
        return nn.Dense(self.dim, dtype=self.dtype, name="proj")(out)


class PVTBlock(nn.Module):
    dim: int
    num_heads: int
    mlp_ratio: float = 4.0
    sr_ratio: int = 1
    linear: bool = False
    use_conv_ffn: bool = False
    dtype: Any = None

    @nn.compact
    def __call__(self, x, h, w):
        y = _LN(self.dtype, name="norm1")(x)
        x = x + SRAttention(self.dim, self.num_heads, self.sr_ratio,
                            self.linear, self.dtype, name="attn")(y, h, w)
        y = _LN(self.dtype, name="norm2")(x)
        hid = int(self.dim * self.mlp_ratio)
        y = nn.Dense(hid, dtype=self.dtype, name="fc1")(y)
        if self.use_conv_ffn:
            b, n, c = y.shape
            y2 = y.reshape(b, h, w, c)
            y2 = nn.Conv(c, (3, 3), padding=[(1, 1), (1, 1)],
                         feature_group_count=c, dtype=self.dtype,
                         name="dwconv")(y2)
            y = y2.reshape(b, n, c)
        y = nn.gelu(y)
        y = nn.Dense(self.dim, dtype=self.dtype, name="fc2")(y)
        return x + y


@BACKBONES.register_module()
class PyramidVisionTransformer(nn.Module):
    pretrain_img_size: int = 224
    in_channels: int = 3
    embed_dims: Sequence[int] = (64, 128, 320, 512)
    num_heads: Sequence[int] = (1, 2, 5, 8)
    num_layers: Sequence[int] = (3, 4, 6, 3)
    patch_sizes: Sequence[int] = (4, 2, 2, 2)
    strides: Sequence[int] = (4, 2, 2, 2)
    sr_ratios: Sequence[int] = (8, 4, 2, 1)
    mlp_ratios: Sequence[float] = (8, 8, 4, 4)
    out_indices: Sequence[int] = (0, 1, 2, 3)
    use_abs_pos_embed: bool = True
    use_conv_ffn: bool = False
    linear: bool = False
    overlapping: bool = False
    norm_cfg: Any = None
    init_cfg: Any = None
    pretrained: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        outs = []
        for si in range(len(self.num_layers)):
            p = self.patch_sizes[si]
            s = self.strides[si]
            pad = p // 2 if self.overlapping else 0
            x = Conv(self.embed_dims[si], p, s, pad, dtype=self.dtype,
                     name=f"patch_embed{si}")(x)
            b, h, w, c = x.shape
            t = _LN(self.dtype, name=f"embed_norm{si}")(
                x.reshape(b, h * w, c))
            if self.use_abs_pos_embed:
                g = self.pretrain_img_size // (4 * 2 ** si)
                pe = self.param(f"pos_embed{si}", nn.initializers.normal(
                    0.02), (g * g, c))
                pe = resize_bilinear(pe.reshape(g, g, c), h, w)
                t = t + pe.reshape(1, h * w, c).astype(t.dtype)
            for bi in range(self.num_layers[si]):
                t = PVTBlock(self.embed_dims[si], self.num_heads[si],
                             self.mlp_ratios[si], self.sr_ratios[si],
                             self.linear, self.use_conv_ffn, self.dtype,
                             name=f"stage{si}_block{bi}")(t, h, w)
            t = _LN(self.dtype, name=f"out_norm{si}")(t)
            x = t.reshape(b, h, w, c)
            if si in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module()
class PyramidVisionTransformerV2(PyramidVisionTransformer):
    """PVTv2 (reference pvt.py:430): overlapping patch embed (7/3 stem),
    conv-FFN, no abs pos embed."""
    patch_sizes: Sequence[int] = (7, 3, 3, 3)
    use_abs_pos_embed: bool = False
    use_conv_ffn: bool = True
    overlapping: bool = True
