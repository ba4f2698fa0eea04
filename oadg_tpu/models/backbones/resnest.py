"""ResNeSt backbone (reference mmdet/models/backbones/resnest.py):
ResNetV1d with Split-Attention bottlenecks (radix softmax over cardinal
splits), avg-down shortcuts and avd (avg-pool-before-conv) downsampling.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp

from ... import nn
from ...utils.registry import BACKBONES
from ..layers import Conv, build_norm, norm_eval_cfg
from .resnet import ResNet


class SplitAttentionConv(nn.Module):
    """SplAtConv2d (reference resnest.py:14): grouped conv producing
    radix*channels, radix-softmax channel attention over the splits."""
    channels: int
    kernel_size: int = 3
    stride: int = 1
    padding: int = 1
    dilation: int = 1
    groups: int = 1
    radix: int = 2
    reduction_factor: int = 4
    norm_cfg: Optional[dict] = None
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        norm = build_norm(self.norm_cfg or dict(type="BN"), self.dtype)
        r, c = self.radix, self.channels
        y = nn.Conv(c * r, (self.kernel_size, self.kernel_size),
                    strides=(self.stride, self.stride),
                    padding=[(self.padding, self.padding)] * 2,
                    kernel_dilation=(self.dilation, self.dilation),
                    feature_group_count=self.groups * r, use_bias=False,
                    dtype=self.dtype, name="conv")(x)
        y = norm()(y)
        y = nn.relu(y)
        b, h, w, _ = y.shape
        splits = y.reshape(b, h, w, r, c)
        gap = jnp.mean(jnp.sum(splits, axis=3), axis=(1, 2),
                       keepdims=True)                            # (B,1,1,C)
        inter = max(c * r // self.reduction_factor, 32)
        a = nn.relu(norm()(Conv(inter, 1, 1, 0, dtype=self.dtype,
                                name="fc1")(gap)))
        a = Conv(c * r, 1, 1, 0, dtype=self.dtype, name="fc2")(a)
        a = a.reshape(b, 1, 1, r, c)
        att = jax.nn.softmax(a.astype(jnp.float32), axis=3).astype(y.dtype)
        return jnp.sum(splits * att, axis=3)


class BottleneckS(nn.Module):
    """ResNeSt bottleneck."""
    planes: int
    stride: int = 1
    dilation: int = 1
    downsample: bool = False
    style: str = "pytorch"
    norm_cfg: Optional[dict] = None
    dtype: Any = None
    groups: int = 1
    base_width: int = 4
    radix: int = 2
    avg_down_stride: bool = True

    @nn.compact
    def __call__(self, x):
        norm = build_norm(self.norm_cfg or dict(type="BN"), self.dtype)
        width = int(self.planes * (self.base_width / 64.0)) * self.groups
        identity = x
        out = Conv(width, 1, 1, 0, use_bias=False, dtype=self.dtype,
                   name="conv1")(x)
        out = norm()(out)
        out = nn.relu(out)
        avd = self.avg_down_stride and self.stride > 1
        out = SplitAttentionConv(width, 3, 1 if avd else self.stride,
                                 self.dilation, self.dilation, self.groups,
                                 self.radix,
                                 norm_cfg=self.norm_cfg, dtype=self.dtype,
                                 name="conv2")(out)
        if avd:
            out = nn.avg_pool(out, (3, 3), (self.stride, self.stride),
                              padding=[(1, 1), (1, 1)])
        out = Conv(self.planes * 4, 1, 1, 0, use_bias=False,
                   dtype=self.dtype, name="conv3")(out)
        out = norm()(out)
        if self.downsample:
            # ResNetV1d avg-down shortcut
            if self.stride > 1:
                identity = nn.avg_pool(identity,
                                       (self.stride, self.stride),
                                       (self.stride, self.stride))
            identity = Conv(self.planes * 4, 1, 1, 0, use_bias=False,
                            dtype=self.dtype, name="downsample_conv")(identity)
            identity = norm()(identity)
        return nn.relu(out + identity)


ARCH_S = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3),
          200: (3, 24, 36, 3)}


@BACKBONES.register_module()
class ResNeSt(nn.Module):
    """Schema mirrors reference ResNeSt (depth, radix, groups, base_width,
    out_indices, strides, dilations); deep stem + avg-down fixed (V1d)."""
    depth: int = 50
    num_stages: int = 4
    out_indices: Sequence[int] = (0, 1, 2, 3)
    strides: Sequence[int] = (1, 2, 2, 2)
    dilations: Sequence[int] = (1, 1, 1, 1)
    groups: int = 1
    base_width: int = 4
    radix: int = 2
    stem_channels: int = 64
    base_channels: int = 64
    style: str = "pytorch"
    frozen_stages: int = -1
    norm_cfg: Any = None
    norm_eval: bool = True
    init_cfg: Any = None
    pretrained: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        from ..layers import max_pool_3x3_s2
        norm = build_norm(norm_eval_cfg(self.norm_cfg, self.norm_eval), self.dtype)
        for i, s in enumerate((2, 1, 1)):
            x = Conv(self.stem_channels // (2 if i < 2 else 1), 3, s, 1,
                     use_bias=False, dtype=self.dtype,
                     name=f"stem_conv{i+1}")(x)
            x = norm()(x)
            x = nn.relu(x)
        x = max_pool_3x3_s2(x)
        outs = []
        for i in range(self.num_stages):
            planes = self.base_channels * 2 ** i
            for j in range(ARCH_S[self.depth][i]):
                stride = self.strides[i] if j == 0 else 1
                ds = j == 0 and (stride != 1 or x.shape[-1] != planes * 4)
                x = BottleneckS(planes, stride, self.dilations[i], ds,
                                self.style, norm_eval_cfg(self.norm_cfg, self.norm_eval),
                                self.dtype, self.groups, self.base_width,
                                self.radix, name=f"layer{i+1}_{j}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
