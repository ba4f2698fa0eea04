"""CSPDarknet backbone (reference mmdet/models/backbones/csp_darknet.py:
YOLOX's backbone) — NHWC, SiLU activations, live BN (norm_eval=False).

Includes the shared CSPLayer (reference mmdet/models/utils/csp_layer.py)
used by YOLOXPAFPN as well.
"""
from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp

from ... import nn
from ...utils.registry import BACKBONES
from ..layers import FrozenBN


class ConvBNSiLU(nn.Module):
    """Conv + BN + SiLU. BN is LIVE by default: the reference trains
    CSPDarknet/YOLOX with norm_eval=False and
    norm_cfg=dict(type='BN', momentum=0.03, eps=0.001)
    (csp_darknet.py:189) — momentum 0.03 -> decay 0.97 here."""
    out_channels: int
    kernel: int = 1
    stride: int = 1
    frozen_bn: bool = False
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        p = self.kernel // 2
        x = nn.Conv(self.out_channels, (self.kernel, self.kernel),
                    strides=(self.stride, self.stride),
                    padding=[(p, p), (p, p)], use_bias=False,
                    dtype=self.dtype, name="conv")(x)
        x = FrozenBN(dtype=self.dtype, frozen=self.frozen_bn, eps=1e-3,
                     momentum=0.97, name="bn")(x)
        return nn.silu(x)


class DarknetBottleneck(nn.Module):
    out_channels: int
    expansion: float = 0.5
    add_identity: bool = True
    frozen_bn: bool = False
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        hidden = int(self.out_channels * self.expansion)
        y = ConvBNSiLU(hidden, 1, frozen_bn=self.frozen_bn,
                       dtype=self.dtype, name="conv1")(x)
        y = ConvBNSiLU(self.out_channels, 3, frozen_bn=self.frozen_bn,
                       dtype=self.dtype, name="conv2")(y)
        if self.add_identity and x.shape[-1] == self.out_channels:
            return x + y
        return y


class CSPLayer(nn.Module):
    """Cross-stage-partial layer (reference models/utils/csp_layer.py:60)."""
    out_channels: int
    num_blocks: int = 1
    add_identity: bool = True
    expand_ratio: float = 0.5
    frozen_bn: bool = False
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        mid = int(self.out_channels * self.expand_ratio)
        main = ConvBNSiLU(mid, 1, frozen_bn=self.frozen_bn,
                          dtype=self.dtype, name="main_conv")(x)
        short = ConvBNSiLU(mid, 1, frozen_bn=self.frozen_bn,
                           dtype=self.dtype, name="short_conv")(x)
        for i in range(self.num_blocks):
            main = DarknetBottleneck(mid, 1.0, self.add_identity,
                                     frozen_bn=self.frozen_bn,
                                     dtype=self.dtype, name=f"block{i}")(main)
        out = jnp.concatenate([main, short], axis=-1)
        return ConvBNSiLU(self.out_channels, 1, frozen_bn=self.frozen_bn,
                          dtype=self.dtype, name="final_conv")(out)


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling (csp_darknet.py SPPBottleneck)."""
    out_channels: int
    kernel_sizes: Sequence[int] = (5, 9, 13)
    frozen_bn: bool = False
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        mid = x.shape[-1] // 2
        x = ConvBNSiLU(mid, 1, frozen_bn=self.frozen_bn,
                       dtype=self.dtype, name="conv1")(x)
        pools = [x]
        for k in self.kernel_sizes:
            p = k // 2
            pools.append(jax.lax.reduce_window(
                jnp.pad(x, ((0, 0), (p, p), (p, p), (0, 0)),
                        constant_values=-jnp.inf),
                -jnp.inf, jax.lax.max, (1, k, k, 1), (1, 1, 1, 1), "VALID"))
        x = jnp.concatenate(pools, axis=-1)
        return ConvBNSiLU(self.out_channels, 1, frozen_bn=self.frozen_bn,
                          dtype=self.dtype, name="conv2")(x)


@BACKBONES.register_module()
class CSPDarknet(nn.Module):
    """P5 arch: stages (128,3) (256,9) (512,9) (1024,3+SPP), Focus stem
    (space-to-depth + conv), deepen/widen factors (csp_darknet.py:124)."""
    arch: str = "P5"
    deepen_factor: float = 1.0
    widen_factor: float = 1.0
    out_indices: Sequence[int] = (2, 3, 4)
    frozen_stages: int = -1
    norm_eval: bool = False          # reference csp_darknet.py:189
    norm_cfg: Any = None             # schema compat (BN momentum/eps fixed)
    act_cfg: Any = None
    init_cfg: Any = None
    dtype: Any = None

    arch_settings = {
        "P5": [(64, 128, 3, True, False), (128, 256, 9, True, False),
               (256, 512, 9, True, False), (512, 1024, 3, False, True)],
    }

    @nn.compact
    def __call__(self, x):
        settings = self.arch_settings[self.arch]
        wf, df = self.widen_factor, self.deepen_factor
        # Focus: space-to-depth 2x then 3x3 conv (csp_darknet.py Focus)
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).transpose(
            0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        ne = self.norm_eval
        x = ConvBNSiLU(int(64 * wf), 3, frozen_bn=ne, dtype=self.dtype,
                       name="stem")(x)
        outs = []
        if 0 in self.out_indices:
            outs.append(x)
        for si, (ic, oc, nb, add_id, use_spp) in enumerate(settings):
            oc = int(oc * wf)
            nb = max(round(nb * df), 1)
            x = ConvBNSiLU(oc, 3, 2, frozen_bn=ne, dtype=self.dtype,
                           name=f"stage{si + 1}_conv")(x)
            if use_spp:
                x = SPPBottleneck(oc, frozen_bn=ne, dtype=self.dtype,
                                  name=f"stage{si + 1}_spp")(x)
            x = CSPLayer(oc, nb, add_identity=add_id, frozen_bn=ne,
                         dtype=self.dtype, name=f"stage{si + 1}_csp")(x)
            if si + 1 in self.out_indices:
                outs.append(x)
        return tuple(outs)
