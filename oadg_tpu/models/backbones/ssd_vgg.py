"""SSD-VGG16 backbone (reference mmdet/models/backbones/ssd_vgg.py:14):
VGG-16 conv trunk with ceil-mode pools, conv6/conv7 dilated head, L2Norm on
conv4_3, and the SSD extra-conv pyramid — NHWC.
"""
from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp

from ... import nn
from ...utils.registry import BACKBONES


def _max_pool(x, k, s, ceil=False):
    h, w = x.shape[1:3]
    if ceil:
        ph = (-(h - k) % s) % s if h % s else 0
        pw = (-(w - k) % s) % s if w % s else 0
        # ceil_mode: pad bottom/right with -inf so partial windows count
        x = jnp.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)),
                    constant_values=-jnp.inf)
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max,
                                 (1, k, k, 1), (1, s, s, 1), "VALID")


@BACKBONES.register_module()
class SSDVGG(nn.Module):
    input_size: int = 300
    depth: int = 16
    with_last_pool: bool = False
    ceil_mode: bool = True
    out_indices: Sequence[int] = (3, 4)
    out_feature_indices: Sequence[int] = (22, 34)
    l2_norm_scale: float = 20.0
    init_cfg: Any = None
    dtype: Any = None

    # VGG-16 stage widths
    stages = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

    @nn.compact
    def __call__(self, x):
        outs = []
        for si, (ch, nconv) in enumerate(self.stages):
            for ci in range(nconv):
                x = nn.relu(nn.Conv(ch, (3, 3), padding=[(1, 1), (1, 1)],
                                    dtype=self.dtype,
                                    name=f"conv{si + 1}_{ci + 1}")(x))
            if si == 3:                       # conv4_3 tap, before pool4
                scale = self.param("l2_norm_scale_p",
                                   nn.initializers.constant(
                                       self.l2_norm_scale), (x.shape[-1],))
                norm = jnp.sqrt(jnp.sum(
                    x.astype(jnp.float32) ** 2, -1, keepdims=True)) + 1e-10
                outs.append((x.astype(jnp.float32) / norm
                             * scale).astype(x.dtype))
            if si < 4:
                x = _max_pool(x, 2, 2, ceil=self.ceil_mode)
            elif self.with_last_pool:
                x = _max_pool(x, 2, 2)
        # pool5 3x3 s1 + dilated conv6/conv7 (fc-converted)
        x = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)),
                    constant_values=-jnp.inf)
        x = _max_pool(x, 3, 1)
        x = nn.relu(nn.Conv(1024, (3, 3), padding=[(6, 6), (6, 6)],
                            kernel_dilation=(6, 6), dtype=self.dtype,
                            name="conv6")(x))
        x = nn.relu(nn.Conv(1024, (1, 1), dtype=self.dtype, name="conv7")(x))
        outs.append(x)
        # extra feature pyramid (ssd_vgg.py extra_setting): alternating
        # 1x1/3x3(s2) convs down to 1x1 maps
        extra = ((256, 1, 1, 0), (512, 3, 2, 1), (128, 1, 1, 0),
                 (256, 3, 2, 1), (128, 1, 1, 0), (256, 3, 1, 0),
                 (128, 1, 1, 0), (256, 3, 1, 0))
        for i, (ch, k, s, p) in enumerate(extra):
            x = nn.relu(nn.Conv(ch, (k, k), strides=(s, s),
                                padding=[(p, p), (p, p)], dtype=self.dtype,
                                name=f"extra{i}")(x))
            if i % 2 == 1:
                outs.append(x)
        return tuple(outs)
