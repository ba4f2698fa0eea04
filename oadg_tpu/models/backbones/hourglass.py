"""Stacked Hourglass backbone (reference mmdet/models/backbones/hourglass.py)
— used by CornerNet / CentripetalNet. Recursive encoder-decoder with
BasicBlock residual layers; nearest-neighbor upsampling on the decoder path.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import jax.numpy as jnp

from ... import nn
from ...utils.registry import BACKBONES
from ..layers import Conv, ConvModule, build_norm
from .resnet import BasicBlock


def _res_layer(x, planes, blocks, stride, norm_cfg, dtype, name_fn):
    for j in range(blocks):
        s = stride if j == 0 else 1
        ds = j == 0 and (s != 1 or x.shape[-1] != planes)
        x = BasicBlock(planes, s, 1, ds, "pytorch", norm_cfg, dtype,
                       name=name_fn(j))(x)
    return x


class HourglassModule(nn.Module):
    depth: int
    stage_channels: Sequence[int]
    stage_blocks: Sequence[int]
    norm_cfg: Optional[dict] = None
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        cur_c = self.stage_channels[0]
        nxt_c = self.stage_channels[1]
        cur_b = self.stage_blocks[0]
        nxt_b = self.stage_blocks[1]
        up1 = _res_layer(x, cur_c, cur_b, 1, self.norm_cfg, self.dtype,
                         lambda j: f"up1_{j}")
        low1 = _res_layer(x, nxt_c, cur_b, 2, self.norm_cfg, self.dtype,
                          lambda j: f"low1_{j}")
        if self.depth > 1:
            low2 = HourglassModule(self.depth - 1, self.stage_channels[1:],
                                   self.stage_blocks[1:], self.norm_cfg,
                                   self.dtype, name="low2")(low1)
        else:
            low2 = _res_layer(low1, nxt_c, nxt_b, 1, self.norm_cfg,
                              self.dtype, lambda j: f"low2_{j}")
        low3 = _res_layer(low2, cur_c, cur_b, 1, self.norm_cfg, self.dtype,
                          lambda j: f"low3_{j}")
        up2 = jnp.repeat(jnp.repeat(low3, 2, axis=1), 2, axis=2)
        return up1 + up2


@BACKBONES.register_module()
class HourglassNet(nn.Module):
    downsample_times: int = 5
    num_stacks: int = 2
    stage_channels: Sequence[int] = (256, 256, 384, 384, 384, 512)
    stage_blocks: Sequence[int] = (2, 2, 2, 2, 2, 4)
    feat_channel: int = 256
    norm_cfg: Any = None
    init_cfg: Any = None
    pretrained: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        ncfg = self.norm_cfg or dict(type="BN")
        c0 = self.stage_channels[0]
        x = ConvModule(128, 7, 2, 3, norm_cfg=ncfg, dtype=self.dtype,
                       name="stem_conv")(x)
        x = _res_layer(x, c0, 1, 2, ncfg, self.dtype,
                       lambda j: f"stem_res{j}")
        outs = []
        for si in range(self.num_stacks):
            hg = HourglassModule(self.downsample_times, self.stage_channels,
                                 self.stage_blocks, ncfg, self.dtype,
                                 name=f"hg{si}")(x)
            feat = ConvModule(self.feat_channel, 3, 1, 1, norm_cfg=ncfg,
                              dtype=self.dtype, name=f"out_conv{si}")(hg)
            outs.append(feat)
            if si < self.num_stacks - 1:
                # intermediate fusion (reference hourglass.py:187-193)
                a = ConvModule(c0, 1, 1, 0, norm_cfg=ncfg, act=None,
                               dtype=self.dtype, name=f"remap_x{si}")(x)
                b = ConvModule(c0, 1, 1, 0, norm_cfg=ncfg, act=None,
                               dtype=self.dtype, name=f"remap_f{si}")(feat)
                x = nn.relu(a + b)
                x = _res_layer(x, c0, 1, 1, ncfg, self.dtype,
                               lambda j: f"inter_res{si}_{j}")
        return tuple(outs)
