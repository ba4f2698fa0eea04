"""Transformer building blocks for DETR-family heads (reference
mmdet/models/utils/transformer.py + positional_encoding.py).

Notes: attention over the flattened feature map is one large batched
matmul chain; everything is static-shape, post-norm DETR
layout. MultiScaleDeformableAttention (Deformable DETR) is not replicated —
plain global attention is dense matmuls and cheap at DETR's 1/32
resolution.
"""
from __future__ import annotations

from typing import Any, Optional

import jax.numpy as jnp
import numpy as np

from ... import nn


class SinePositionalEncoding:
    """Reference mmdet/models/utils/positional_encoding.py:12 (static)."""

    def __init__(self, num_feats: int = 128, temperature: int = 10000,
                 normalize: bool = True, scale: float = 2 * np.pi):
        self.num_feats = num_feats
        self.temperature = temperature
        self.normalize = normalize
        self.scale = scale

    def __call__(self, h: int, w: int) -> jnp.ndarray:
        """(H, W, 2*num_feats) positional map (no batch; broadcast later)."""
        y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w))
        x = np.arange(1, w + 1, dtype=np.float32)[None, :] * np.ones((h, 1))
        if self.normalize:
            eps = 1e-6
            y = y / (y[-1:, :] + eps) * self.scale
            x = x / (x[:, -1:] + eps) * self.scale
        dim_t = self.temperature ** (
            2 * (np.arange(self.num_feats) // 2) / self.num_feats)
        pos_x = x[..., None] / dim_t
        pos_y = y[..., None] / dim_t
        pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])],
                         axis=-1).reshape(h, w, -1)
        pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])],
                         axis=-1).reshape(h, w, -1)
        return jnp.asarray(np.concatenate([pos_y, pos_x], axis=-1))


class FFN(nn.Module):
    embed_dims: int
    feedforward_channels: int
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        y = nn.Dense(self.feedforward_channels, dtype=self.dtype,
                     name="fc1")(x)
        y = nn.relu(y)
        y = nn.Dense(self.embed_dims, dtype=self.dtype, name="fc2")(y)
        return x + y


class EncoderLayer(nn.Module):
    embed_dims: int
    num_heads: int
    feedforward_channels: int
    dtype: Any = None

    @nn.compact
    def __call__(self, x, pos):
        q = k = x + pos
        attn = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads, dtype=self.dtype, name="self_attn")(
            q, k, x)
        x = nn.LayerNorm(dtype=self.dtype, name="norm1")(x + attn)
        x = FFN(self.embed_dims, self.feedforward_channels,
                dtype=self.dtype, name="ffn")(x)
        return nn.LayerNorm(dtype=self.dtype, name="norm2")(x)


class DecoderLayer(nn.Module):
    embed_dims: int
    num_heads: int
    feedforward_channels: int
    dtype: Any = None

    @nn.compact
    def __call__(self, tgt, memory, query_pos, mem_pos):
        q = k = tgt + query_pos
        sa = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads, dtype=self.dtype, name="self_attn")(
            q, k, tgt)
        tgt = nn.LayerNorm(dtype=self.dtype, name="norm1")(tgt + sa)
        ca = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads, dtype=self.dtype, name="cross_attn")(
            tgt + query_pos, memory + mem_pos, memory)
        tgt = nn.LayerNorm(dtype=self.dtype, name="norm2")(tgt + ca)
        tgt = FFN(self.embed_dims, self.feedforward_channels,
                  dtype=self.dtype, name="ffn")(tgt)
        return nn.LayerNorm(dtype=self.dtype, name="norm3")(tgt)


class Transformer(nn.Module):
    """DETR encoder-decoder (reference transformer.py Transformer):
    returns per-decoder-layer outputs (L, B, Q, C) for aux losses."""
    embed_dims: int = 256
    num_heads: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    feedforward_channels: int = 2048
    dtype: Any = None

    @nn.compact
    def __call__(self, x, pos, query_embed):
        """x: (B, HW, C); pos: (HW, C); query_embed: (Q, C)."""
        b = x.shape[0]
        posb = pos[None]
        for i in range(self.num_encoder_layers):
            x = EncoderLayer(self.embed_dims, self.num_heads,
                             self.feedforward_channels, dtype=self.dtype,
                             name=f"enc{i}")(x, posb)
        q = query_embed.shape[0]
        tgt = jnp.zeros((b, q, self.embed_dims), x.dtype)
        qpos = jnp.broadcast_to(query_embed[None], (b, q, self.embed_dims))
        outs = []
        for i in range(self.num_decoder_layers):
            tgt = DecoderLayer(self.embed_dims, self.num_heads,
                               self.feedforward_channels, dtype=self.dtype,
                               name=f"dec{i}")(tgt, x, qpos, posb)
            outs.append(tgt)
        return jnp.stack(outs)                   # (L, B, Q, C)
