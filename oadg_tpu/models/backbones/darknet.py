"""Darknet-53 backbone (reference mmdet/models/backbones/darknet.py:60).

Conv-BN-LeakyReLU(0.1) stem + 5 stages of (stride-2 downsample conv +
N residual blocks); outputs stages (3, 4, 5) -> channels (256, 512, 1024).
"""
from __future__ import annotations

from typing import Any, Sequence


from ... import nn
from ...utils.registry import BACKBONES
from ..layers import ConvModule, norm_eval_cfg


class DarkBlock(nn.Module):
    """Residual block: 1x1 half-channels -> 3x3 back + skip."""
    channels: int
    norm_cfg: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        half = self.channels // 2
        out = ConvModule(half, 1, 1, 0, norm_cfg=self.norm_cfg or dict(type="BN"),
                         act="leaky_relu", dtype=self.dtype, name="conv1")(x)
        out = ConvModule(self.channels, 3, 1, 1,
                         norm_cfg=self.norm_cfg or dict(type="BN"),
                         act="leaky_relu", dtype=self.dtype, name="conv2")(out)
        return x + out


@BACKBONES.register_module()
class Darknet(nn.Module):
    depth: int = 53
    out_indices: Sequence[int] = (3, 4, 5)
    frozen_stages: int = -1
    norm_cfg: Any = None
    norm_eval: bool = True
    act_cfg: Any = None
    pretrained: Any = None
    init_cfg: Any = None
    dtype: Any = None

    LAYERS = (1, 2, 8, 8, 4)
    CHANNELS = ((32, 64), (64, 128), (128, 256), (256, 512), (512, 1024))

    @nn.compact
    def __call__(self, x):
        # norm_eval covers ONLY the backbone (reference darknet.py:174);
        # the YOLO neck/head BNs stay live during training.
        norm = norm_eval_cfg(self.norm_cfg, self.norm_eval)
        x = ConvModule(32, 3, 1, 1, norm_cfg=norm, act="leaky_relu",
                       dtype=self.dtype, name="conv1")(x)
        outs = []
        for i, (n_blocks, (cin, cout)) in enumerate(
                zip(self.LAYERS, self.CHANNELS)):
            x = ConvModule(cout, 3, 2, 1, norm_cfg=norm, act="leaky_relu",
                           dtype=self.dtype, name=f"down{i + 1}")(x)
            for j in range(n_blocks):
                x = DarkBlock(cout, norm, self.dtype,
                              name=f"stage{i + 1}_{j}")(x)
            if (i + 1) in self.out_indices:
                outs.append(x)
        return tuple(outs)
