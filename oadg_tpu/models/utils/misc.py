"""models/utils surface (reference mmdet/models/utils/): small shared
building blocks — ResLayer, build_linear_layer, NormedLinear/NormedConv2d,
SELayer, gaussian heatmap targets, interpolate_as.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from ..backbones.resnet import ARCH, BasicBlock, Bottleneck


class ResLayer(nn.Module):
    """A single ResNet stage as a standalone layer (reference
    mmdet/models/utils/res_layer.py:7; used by shared_heads/res_layer)."""
    depth: int = 50
    stage: int = 3
    stride: int = 2
    norm_cfg: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        block, stage_blocks = ARCH[self.depth]
        planes = 64 * 2 ** self.stage
        expansion = 4 if block is Bottleneck else 1
        for j in range(stage_blocks[self.stage]):
            stride = self.stride if j == 0 else 1
            downsample = j == 0 and (stride != 1 or
                                     x.shape[-1] != planes * expansion)
            x = block(planes, stride, 1, downsample, "pytorch",
                      self.norm_cfg or dict(type="BN"), self.dtype,
                      name=f"block{j}")(x)
        return x


def build_linear_layer(cfg: Optional[dict], out_features: int, dtype=None,
                       name=None):
    """reference mmdet/models/utils/builder.py build_linear_layer: only
    'Linear' is used by OA-DG configs; NormedLinear supported too."""
    t = (cfg or {}).get("type", "Linear")
    if t == "NormedLinear":
        return NormedLinear(out_features, dtype=dtype, name=name,
                            tempearture=(cfg or {}).get("tempearture", 20))
    return nn.Dense(out_features, dtype=dtype, name=name)


class NormedLinear(nn.Module):
    """L2-normalized linear (reference mmdet/models/utils/normed_predictor.py:
    NormedLinear; note the reference's 'tempearture' spelling)."""
    out_features: int
    tempearture: float = 20.0
    eps: float = 1e-6
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        w = self.param("kernel", nn.initializers.lecun_normal(),
                       (x.shape[-1], self.out_features))
        b = self.param("bias", nn.initializers.zeros, (self.out_features,))
        wn = w / (jnp.linalg.norm(w, axis=0, keepdims=True) + self.eps)
        xn = x / (jnp.linalg.norm(x, axis=-1, keepdims=True) + self.eps)
        return self.tempearture * (xn @ wn) + b


class NormedConv2d(nn.Module):
    """L2-normalized 1x1 conv predictor (normed_predictor.py NormedConv2d)."""
    out_channels: int
    tempearture: float = 20.0
    eps: float = 1e-6
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        w = self.param("kernel", nn.initializers.lecun_normal(),
                       (1, 1, x.shape[-1], self.out_channels))
        wn = w / (jnp.linalg.norm(w.reshape(-1, self.out_channels), axis=0)
                  + self.eps)
        xn = x / (jnp.linalg.norm(x, axis=-1, keepdims=True) + self.eps)
        return self.tempearture * jax.lax.conv_general_dilated(
            xn, wn, (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))


class SELayer(nn.Module):
    """Squeeze-and-excitation (reference mmdet/models/utils/se_layer.py)."""
    ratio: int = 16
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        c = x.shape[-1]
        s = jnp.mean(x, axis=(1, 2))
        s = nn.relu(nn.Dense(max(c // self.ratio, 1), dtype=self.dtype,
                             name="fc1")(s))
        s = jax.nn.sigmoid(nn.Dense(c, dtype=self.dtype, name="fc2")(s))
        return x * s[:, None, None, :]


def gaussian_radius(det_size, min_overlap: float = 0.7):
    """reference mmdet/models/utils/gaussian_target.py gaussian_radius."""
    height, width = det_size
    a1 = 1
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = jnp.sqrt(b1 ** 2 - 4 * a1 * c1)
    r1 = (b1 + sq1) / 2
    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = jnp.sqrt(b2 ** 2 - 4 * a2 * c2)
    r2 = (b2 + sq2) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = jnp.sqrt(b3 ** 2 - 4 * a3 * c3)
    r3 = (b3 + sq3) / 2
    return jnp.minimum(jnp.minimum(r1, r2), r3)


def gen_gaussian_target(heatmap, center, radius):
    """Draw one gaussian onto (H, W) heatmap via max-composition
    (gaussian_target.py gen_gaussian_target), static-shape: evaluated over
    the whole map rather than a dynamic window."""
    h, w = heatmap.shape
    cx, cy = center[0], center[1]
    sigma = (2 * radius + 1) / 6.0
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    g = jnp.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * sigma ** 2))
    g = jnp.where(g < jnp.finfo(jnp.float32).eps, 0.0, g)
    return jnp.maximum(heatmap, g)


def interpolate_as(source, target):
    """Resize ``source`` (B, h, w, C) to target's spatial shape, bilinear
    (reference mmdet/models/utils/misc.py interpolate_as)."""
    th, tw = target.shape[1:3]
    return jax.image.resize(source,
                            (source.shape[0], th, tw, source.shape[-1]),
                            method="bilinear")
