"""YOLOX PAFPN neck (reference mmdet/models/necks/yolox_pafpn.py): CSP
top-down + bottom-up aggregation with SiLU conv blocks."""
from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp

from ... import nn
from ...utils.registry import NECKS
from ..backbones.csp_darknet import ConvBNSiLU, CSPLayer


def _up2(x, hw):
    y = jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)
    return y[:, :hw[0], :hw[1]]


@NECKS.register_module()
class YOLOXPAFPN(nn.Module):
    in_channels: Sequence[int] = (256, 512, 1024)
    out_channels: int = 256
    num_csp_blocks: int = 3
    dtype: Any = None

    @nn.compact
    def __call__(self, inputs):
        n = len(self.in_channels)
        feats = list(inputs[-n:])
        # top-down (yolox_pafpn.py forward): reduce high, upsample, CSP-merge
        inner_outs = [feats[-1]]
        for idx in range(n - 1, 0, -1):
            high = ConvBNSiLU(self.in_channels[idx - 1], 1, dtype=self.dtype,
                              name=f"reduce{n - 1 - idx}")(inner_outs[0])
            inner_outs[0] = high
            up = _up2(high, feats[idx - 1].shape[1:3])
            merged = jnp.concatenate([up, feats[idx - 1]], axis=-1)
            inner = CSPLayer(self.in_channels[idx - 1], self.num_csp_blocks,
                             add_identity=False, dtype=self.dtype,
                             name=f"td_csp{n - 1 - idx}")(merged)
            inner_outs.insert(0, inner)
        # bottom-up
        outs = [inner_outs[0]]
        for idx in range(n - 1):
            down = ConvBNSiLU(outs[-1].shape[-1], 3, 2, dtype=self.dtype,
                              name=f"down{idx}")(outs[-1])
            down = down[:, :inner_outs[idx + 1].shape[1],
                        :inner_outs[idx + 1].shape[2]]
            merged = jnp.concatenate([down, inner_outs[idx + 1]], axis=-1)
            outs.append(CSPLayer(self.in_channels[idx + 1],
                                 self.num_csp_blocks, add_identity=False,
                                 dtype=self.dtype,
                                 name=f"bu_csp{idx}")(merged))
        return tuple(
            ConvBNSiLU(self.out_channels, 1, dtype=self.dtype,
                       name=f"out{i}")(o) for i, o in enumerate(outs))
