"""FPN neck (NHWC). Capability-parity with reference
mmdet/models/necks/fpn.py:11: lateral 1x1 convs, nearest top-down upsample,
3x3 output convs, extra outputs via max-pool (``num_outs > inputs``) or extra
convs on input/output (``add_extra_convs``)."""
from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp

from ... import nn
from ...utils.registry import NECKS
from ..layers import Conv, ConvModule


def _upsample_nearest_2x(x, out_hw):
    b, h, w, c = x.shape
    y = jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)
    return y[:, :out_hw[0], :out_hw[1], :]


@NECKS.register_module()
class FPN(nn.Module):
    in_channels: Sequence[int] = (256, 512, 1024, 2048)
    out_channels: int = 256
    num_outs: int = 5
    start_level: int = 0
    end_level: int = -1
    add_extra_convs: Any = False          # False | 'on_input' | 'on_lateral' | 'on_output'
    relu_before_extra_convs: bool = False
    norm_cfg: Optional[dict] = None
    dtype: Any = None

    @nn.compact
    def __call__(self, inputs):
        end = len(self.in_channels) if self.end_level == -1 else self.end_level + 1
        used = list(inputs[self.start_level:end])
        laterals = [
            Conv(self.out_channels, 1, 1, 0, dtype=self.dtype,
                 name=f"lateral_{i}")(x)
            for i, x in enumerate(used)
        ]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _upsample_nearest_2x(
                laterals[i], laterals[i - 1].shape[1:3])
        outs = [
            Conv(self.out_channels, 3, 1, 1, dtype=self.dtype,
                 name=f"fpn_conv_{i}")(laterals[i])
            for i in range(len(laterals))
        ]
        extra = self.num_outs - len(outs)
        if extra > 0:
            if not self.add_extra_convs:
                for _ in range(extra):
                    outs.append(jax.lax.reduce_window(
                        outs[-1], -jnp.inf, jax.lax.max,
                        (1, 1, 1, 1), (1, 2, 2, 1), "VALID"))
            else:
                src = {"on_input": used[-1], "on_lateral": laterals[-1],
                       "on_output": outs[-1]}[self.add_extra_convs
                                              if isinstance(self.add_extra_convs, str)
                                              else "on_input"]
                for k in range(extra):
                    if k > 0 and self.relu_before_extra_convs:
                        src = nn.relu(src)
                    src = Conv(self.out_channels, 3, 2, 1, dtype=self.dtype,
                               name=f"extra_conv_{k}")(src)
                    outs.append(src)
        return tuple(outs)


@NECKS.register_module()
class ChannelMapper(nn.Module):
    """1x1 conv per level to a common channel count (reference
    mmdet/models/necks/channel_mapper.py)."""
    in_channels: Sequence[int] = (512, 1024, 2048)
    out_channels: int = 256
    kernel_size: int = 3
    norm_cfg: Optional[dict] = None
    dtype: Any = None

    @nn.compact
    def __call__(self, inputs):
        return tuple(
            ConvModule(self.out_channels, self.kernel_size, 1,
                       self.kernel_size // 2, norm_cfg=self.norm_cfg,
                       act=None, dtype=self.dtype, name=f"conv_{i}")(x)
            for i, x in enumerate(inputs))


@NECKS.register_module()
class PAFPN(FPN):
    """Path Aggregation FPN (reference mmdet/models/necks/pafpn.py): FPN
    top-down pass + an extra bottom-up path with downsample convs."""

    @nn.compact
    def __call__(self, inputs):
        end = len(self.in_channels) if self.end_level == -1 else self.end_level + 1
        used = list(inputs[self.start_level:end])
        laterals = [
            Conv(self.out_channels, 1, 1, 0, dtype=self.dtype,
                 name=f"lateral_{i}")(x)
            for i, x in enumerate(used)
        ]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _upsample_nearest_2x(
                laterals[i], laterals[i - 1].shape[1:3])
        inter = [
            Conv(self.out_channels, 3, 1, 1, dtype=self.dtype,
                 name=f"fpn_conv_{i}")(laterals[i])
            for i in range(len(laterals))
        ]
        # bottom-up augmentation
        for i in range(len(inter) - 1):
            down = Conv(self.out_channels, 3, 2, 1, dtype=self.dtype,
                        name=f"downsample_conv_{i}")(inter[i])
            inter[i + 1] = inter[i + 1] + down[:, :inter[i + 1].shape[1],
                                               :inter[i + 1].shape[2], :]
        outs = [
            Conv(self.out_channels, 3, 1, 1, dtype=self.dtype,
                 name=f"pafpn_conv_{i}")(x) if i > 0 else x
            for i, x in enumerate(inter)
        ]
        extra = self.num_outs - len(outs)
        for _ in range(max(extra, 0)):
            outs.append(jax.lax.reduce_window(
                outs[-1], -jnp.inf, jax.lax.max,
                (1, 1, 1, 1), (1, 2, 2, 1), "VALID"))
        return tuple(outs)
