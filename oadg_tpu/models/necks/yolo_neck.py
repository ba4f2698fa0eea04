"""YOLOv3 neck (reference mmdet/models/necks/yolo_neck.py:65): three
DetectionBlocks with top-down 1x1-conv + 2x upsample + concat fusion."""
from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp

from ... import nn
from ...utils.registry import NECKS
from ..layers import ConvModule


class DetectionBlock(nn.Module):
    """5-conv block: 1x1/3x3 alternating (reference yolo_neck.py:12)."""
    out_channels: int
    norm_cfg: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        n = self.out_channels
        norm = self.norm_cfg or dict(type="BN")
        x = ConvModule(n, 1, 1, 0, norm_cfg=norm, act="leaky_relu",
                       dtype=self.dtype, name="conv1")(x)
        x = ConvModule(n * 2, 3, 1, 1, norm_cfg=norm, act="leaky_relu",
                       dtype=self.dtype, name="conv2")(x)
        x = ConvModule(n, 1, 1, 0, norm_cfg=norm, act="leaky_relu",
                       dtype=self.dtype, name="conv3")(x)
        x = ConvModule(n * 2, 3, 1, 1, norm_cfg=norm, act="leaky_relu",
                       dtype=self.dtype, name="conv4")(x)
        x = ConvModule(n, 1, 1, 0, norm_cfg=norm, act="leaky_relu",
                       dtype=self.dtype, name="conv5")(x)
        return x


@NECKS.register_module()
class YOLOV3Neck(nn.Module):
    num_scales: int = 3
    in_channels: Sequence[int] = (1024, 512, 256)
    out_channels: Sequence[int] = (512, 256, 128)
    norm_cfg: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, feats):
        # feats fine->coarse from backbone; process coarse->fine
        assert len(feats) == self.num_scales
        outs = []
        x = DetectionBlock(self.out_channels[0], self.norm_cfg, self.dtype,
                           name="detect1")(feats[-1])
        outs.append(x)
        for i in range(1, self.num_scales):
            t = ConvModule(self.out_channels[i], 1, 1, 0,
                           norm_cfg=self.norm_cfg or dict(type="BN"),
                           act="leaky_relu", dtype=self.dtype,
                           name=f"conv{i}")(x)
            b, h, w, c = t.shape
            t = jnp.repeat(jnp.repeat(t, 2, axis=1), 2, axis=2)
            skip = feats[-1 - i]
            t = t[:, : skip.shape[1], : skip.shape[2], :]
            t = jnp.concatenate([t, skip], axis=-1)
            x = DetectionBlock(self.out_channels[i], self.norm_cfg,
                               self.dtype, name=f"detect{i + 1}")(t)
            outs.append(x)
        return tuple(outs)        # coarse -> fine (strides 32, 16, 8)
