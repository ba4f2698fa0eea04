"""RegNetX backbone (reference mmdet/models/backbones/regnet.py:10):
quantized-linear width schedule, grouped bottlenecks with expansion 1.
"""
from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp
import numpy as np

from ... import nn
from ...utils.registry import BACKBONES
from ..layers import Conv, FrozenBN, build_norm


def _generate_widths(w0, wa, wm, depth, q=8):
    """regnet.py generate_regnet: quantized log-linear widths."""
    ws_cont = np.arange(depth) * wa + w0
    ks = np.round(np.log(ws_cont / w0) / np.log(wm))
    ws = w0 * np.power(wm, ks)
    ws = np.round(ws / q) * q
    num_stages = len(np.unique(ws))
    ws = ws.astype(int).tolist()
    stage_widths, stage_blocks = [], []
    for w in sorted(set(ws)):
        stage_widths.append(w)
        stage_blocks.append(ws.count(w))
    return stage_widths, stage_blocks, num_stages


def _adjust(widths, groups, bottleneck_ratio=1.0):
    adj_w, adj_g = [], []
    for w, g in zip(widths, groups):
        wb = int(round(w * bottleneck_ratio))
        g = min(g, wb)
        wb = int(round(wb / g) * g)
        adj_w.append(int(wb / bottleneck_ratio))
        adj_g.append(g)
    return adj_w, adj_g


ARCH_PRESETS = {
    "regnetx_400mf": dict(w0=24, wa=24.48, wm=2.54, group_w=16, depth=22),
    "regnetx_800mf": dict(w0=56, wa=35.73, wm=2.28, group_w=16, depth=16),
    "regnetx_1.6gf": dict(w0=80, wa=34.01, wm=2.25, group_w=24, depth=18),
    "regnetx_3.2gf": dict(w0=88, wa=26.31, wm=2.25, group_w=48, depth=25),
    "regnetx_4.0gf": dict(w0=96, wa=38.65, wm=2.43, group_w=40, depth=23),
    "regnetx_6.4gf": dict(w0=184, wa=60.83, wm=2.07, group_w=56, depth=17),
    "regnetx_8.0gf": dict(w0=80, wa=49.56, wm=2.88, group_w=120, depth=23),
    "regnetx_12gf": dict(w0=168, wa=73.36, wm=2.37, group_w=112, depth=19),
}


class RegBlock(nn.Module):
    width: int
    stride: int
    group_width: int
    frozen_bn: bool = True
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        groups = max(self.width // self.group_width, 1)
        identity = x
        y = nn.relu(FrozenBN(dtype=self.dtype, frozen=self.frozen_bn, name="bn1")(
            Conv(self.width, 1, 1, 0, use_bias=False, dtype=self.dtype,
                 name="conv1")(x)))
        y = nn.Conv(self.width, (3, 3), strides=(self.stride, self.stride),
                    padding=[(1, 1), (1, 1)], feature_group_count=groups,
                    use_bias=False, dtype=self.dtype, name="conv2")(y)
        y = nn.relu(FrozenBN(dtype=self.dtype, frozen=self.frozen_bn, name="bn2")(y))
        y = FrozenBN(dtype=self.dtype, frozen=self.frozen_bn, name="bn3")(
            Conv(self.width, 1, 1, 0, use_bias=False, dtype=self.dtype,
                 name="conv3")(y))
        if self.stride != 1 or x.shape[-1] != self.width:
            identity = FrozenBN(dtype=self.dtype, frozen=self.frozen_bn, name="downsample_bn")(
                Conv(self.width, 1, self.stride, 0, use_bias=False,
                     dtype=self.dtype, name="downsample_conv")(x))
        return nn.relu(y + identity)


@BACKBONES.register_module()
class RegNet(nn.Module):
    arch: Any = "regnetx_3.2gf"
    out_indices: Sequence[int] = (0, 1, 2, 3)
    frozen_stages: int = -1
    norm_cfg: Any = None
    norm_eval: bool = True
    init_cfg: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        a = (ARCH_PRESETS[self.arch] if isinstance(self.arch, str)
             else dict(self.arch))
        widths, blocks, _ = _generate_widths(a["w0"], a["wa"], a["wm"],
                                             a["depth"])
        groups = [a["group_w"]] * len(widths)
        widths, groups = _adjust(widths, groups)
        x = Conv(32, 3, 2, 1, use_bias=False, dtype=self.dtype,
                 name="stem")(x)
        x = FrozenBN(dtype=self.dtype, frozen=self.norm_eval, name="stem_bn")(x)
        x = nn.relu(x)
        outs = []
        for si, (wdt, nb, gw) in enumerate(zip(widths, blocks, groups)):
            for bi in range(nb):
                x = RegBlock(wdt, 2 if bi == 0 else 1, gw,
                             frozen_bn=self.norm_eval, dtype=self.dtype,
                             name=f"layer{si + 1}_{bi}")(x)
            if si in self.out_indices:
                outs.append(x)
        return tuple(outs)
