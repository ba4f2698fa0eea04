"""MobileNetV2 backbone (reference mmdet/models/backbones/mobilenet_v2.py:
inverted-residual stages with out_indices taps) — NHWC.

Depthwise convs use nn.Conv's feature_group_count; BN runs in frozen
(inference-stats) mode like the rest of the detection backbones here.
"""
from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp

from ... import nn
from ...utils.registry import BACKBONES
from ..layers import FrozenBN


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(nn.Module):
    out_channels: int
    stride: int
    expand_ratio: int
    frozen_bn: bool = False
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        inp = x.shape[-1]
        hidden = inp * self.expand_ratio
        identity = x
        if self.expand_ratio != 1:
            x = nn.Conv(hidden, (1, 1), use_bias=False, dtype=self.dtype,
                        name="expand")(x)
            x = FrozenBN(dtype=self.dtype, frozen=self.frozen_bn, name="expand_bn")(x)
            x = nn.relu6(x)
        x = nn.Conv(hidden, (3, 3), strides=(self.stride, self.stride),
                    padding=[(1, 1), (1, 1)], feature_group_count=hidden,
                    use_bias=False, dtype=self.dtype, name="dw")(x)
        x = FrozenBN(dtype=self.dtype, frozen=self.frozen_bn, name="dw_bn")(x)
        x = nn.relu6(x)
        x = nn.Conv(self.out_channels, (1, 1), use_bias=False,
                    dtype=self.dtype, name="project")(x)
        x = FrozenBN(dtype=self.dtype, frozen=self.frozen_bn, name="project_bn")(x)
        if self.stride == 1 and inp == self.out_channels:
            x = x + identity
        return x


@BACKBONES.register_module()
class MobileNetV2(nn.Module):
    widen_factor: float = 1.0
    out_indices: Sequence[int] = (1, 2, 4, 7)
    frozen_stages: int = -1
    norm_cfg: Any = None
    norm_eval: bool = False          # reference mobilenet_v2.py default
    act_cfg: Any = None
    init_cfg: Any = None
    dtype: Any = None

    # (expand_ratio, channels, num_blocks, stride) per stage
    arch = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

    @nn.compact
    def __call__(self, x):
        """Layer indexing matches the reference (mobilenet_v2.py:117-131):
        indices 0..6 are the seven inverted-residual stages, index 7 is the
        final 1280-channel 1x1 conv (present when widen_factor == 1)."""
        c = _make_divisible(32 * self.widen_factor)
        x = nn.Conv(c, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)],
                    use_bias=False, dtype=self.dtype, name="stem")(x)
        x = FrozenBN(dtype=self.dtype, frozen=self.norm_eval, name="stem_bn")(x)
        x = nn.relu6(x)
        outs = []
        for si, (t, ch, nblk, s) in enumerate(self.arch):
            oc = _make_divisible(ch * self.widen_factor)
            for bi in range(nblk):
                x = InvertedResidual(oc, s if bi == 0 else 1, t,
                                     frozen_bn=self.norm_eval,
                                     dtype=self.dtype,
                                     name=f"layer{si + 1}_{bi}")(x)
            if si in self.out_indices:
                outs.append(x)
        if 7 in self.out_indices:
            oc = (_make_divisible(1280 * self.widen_factor)
                  if self.widen_factor > 1.0 else 1280)
            y = nn.Conv(oc, (1, 1), use_bias=False, dtype=self.dtype,
                        name="conv2")(x)
            y = FrozenBN(dtype=self.dtype, frozen=self.norm_eval, name="conv2_bn")(y)
            outs.append(nn.relu6(y))
        return tuple(outs)
