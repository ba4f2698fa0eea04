"""Additional necks from the P2 surface (reference mmdet/models/necks/):
BFP (Libra R-CNN balanced feature pyramid, bfp.py:11), HRFPN (hrfpn.py:12),
DilatedEncoder (YOLOF, dilated_encoder.py:23), SSDNeck (ssd_neck.py passthru
variant)."""
from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp

from ... import nn
from ...utils.registry import NECKS
from ..layers import Conv, ConvModule, FrozenBN


def _resize_nearest(x, hw):
    h0, w0 = x.shape[1:3]
    h1, w1 = hw
    ys = (jnp.arange(h1) * h0 // h1).astype(jnp.int32)
    xs = (jnp.arange(w1) * w0 // w1).astype(jnp.int32)
    return x[:, ys][:, :, xs]


@NECKS.register_module()
class BFP(nn.Module):
    """Balanced feature pyramid: gather-resize-average all levels at the
    ``refine_level``, refine (conv), scatter back residually."""
    in_channels: int = 256
    num_levels: int = 5
    refine_level: int = 2
    refine_type: Optional[str] = "conv"       # None | 'conv' | 'non_local'
    dtype: Any = None

    @nn.compact
    def __call__(self, inputs):
        assert len(inputs) == self.num_levels
        target_hw = inputs[self.refine_level].shape[1:3]
        gathered = []
        for i, x in enumerate(inputs):
            if i < self.refine_level:
                # downsample via adaptive max pool (stride ratio)
                r = x.shape[1] // target_hw[0]
                x = jax.lax.reduce_window(
                    x, -jnp.inf, jax.lax.max, (1, r, r, 1), (1, r, r, 1),
                    "VALID")[:, :target_hw[0], :target_hw[1]]
            elif i > self.refine_level:
                x = _resize_nearest(x, target_hw)
            gathered.append(x)
        bsf = sum(gathered) / len(gathered)
        if self.refine_type == "conv":
            bsf = Conv(self.in_channels, 3, 1, 1, dtype=self.dtype,
                       name="refine")(bsf)
        elif self.refine_type == "non_local":
            from ..layers import NonLocal2d
            bsf = NonLocal2d(self.in_channels, dtype=self.dtype,
                             name="refine")(bsf)
        outs = []
        for i, x in enumerate(inputs):
            hw = x.shape[1:3]
            if i < self.refine_level:
                res = _resize_nearest(bsf, hw)
            elif i > self.refine_level:
                r = bsf.shape[1] // hw[0]
                res = jax.lax.reduce_window(
                    bsf, -jnp.inf, jax.lax.max, (1, r, r, 1), (1, r, r, 1),
                    "VALID")[:, :hw[0], :hw[1]]
            else:
                res = bsf
            outs.append(x + res)
        return tuple(outs)


@NECKS.register_module()
class HRFPN(nn.Module):
    """HRNet feature pyramid: concat all branches at the highest resolution,
    1x1 reduce, then avg-pool pyramid + per-level 3x3 convs."""
    in_channels: Sequence[int] = (18, 36, 72, 144)
    out_channels: int = 256
    num_outs: int = 5
    dtype: Any = None

    @nn.compact
    def __call__(self, inputs):
        hw = inputs[0].shape[1:3]
        ups = [inputs[0]] + [_resize_nearest(x, hw) for x in inputs[1:]]
        x = jnp.concatenate(ups, axis=-1)
        x = Conv(self.out_channels, 1, 1, 0, dtype=self.dtype,
                 name="reduction")(x)
        outs = [x]
        for i in range(1, self.num_outs):
            s = 2 ** i
            outs.append(nn.avg_pool(x, (s, s), strides=(s, s)))
        return tuple(
            Conv(self.out_channels, 3, 1, 1, dtype=self.dtype,
                 name=f"fpn_conv{i}")(o) for i, o in enumerate(outs))


class _DilatedBlock(nn.Module):
    mid_channels: int
    dilation: int
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        out_ch = x.shape[-1]
        y = nn.relu(FrozenBN(dtype=self.dtype, frozen=False, name="bn1")(
            Conv(self.mid_channels, 1, 1, 0, dtype=self.dtype,
                 name="conv1")(x)))
        d = self.dilation
        y = nn.relu(FrozenBN(dtype=self.dtype, frozen=False, name="bn2")(
            Conv(self.mid_channels, 3, 1, d, dilation=d, dtype=self.dtype,
                 name="conv2")(y)))
        y = nn.relu(FrozenBN(dtype=self.dtype, frozen=False, name="bn3")(
            Conv(out_ch, 1, 1, 0, dtype=self.dtype, name="conv3")(y)))
        return x + y


@NECKS.register_module()
class DilatedEncoder(nn.Module):
    """YOLOF's single-level encoder: lateral 1x1 + 3x3, then 4 dilated
    residual blocks (dilations 2,4,6,8)."""
    in_channels: int = 2048
    out_channels: int = 512
    block_mid_channels: int = 128
    num_residual_blocks: int = 4
    block_dilations: Sequence[int] = (2, 4, 6, 8)
    dtype: Any = None

    @nn.compact
    def __call__(self, inputs):
        x = inputs[-1]
        x = FrozenBN(dtype=self.dtype, frozen=False, name="lateral_bn")(
            Conv(self.out_channels, 1, 1, 0, dtype=self.dtype,
                 name="lateral")(x))
        x = FrozenBN(dtype=self.dtype, frozen=False, name="fpn_bn")(
            Conv(self.out_channels, 3, 1, 1, dtype=self.dtype,
                 name="fpn_conv")(x))
        for i in range(self.num_residual_blocks):
            x = _DilatedBlock(self.block_mid_channels,
                              self.block_dilations[i], dtype=self.dtype,
                              name=f"block{i}")(x)
        return (x,)
