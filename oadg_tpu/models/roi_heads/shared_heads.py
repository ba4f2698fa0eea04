"""Shared RoI heads (reference mmdet/models/roi_heads/shared_heads/
res_layer.py): the C4 Faster R-CNN applies ResNet stage 5 (layer4) to the
7x7 RoI features before a light bbox head."""
from __future__ import annotations

from typing import Any


from ... import nn
from ...utils.registry import HEADS
from ..backbones.resnet import ARCH, Bottleneck
from ..layers import norm_eval_cfg


@HEADS.register_module()
class ResLayer(nn.Module):
    depth: int = 50
    stage: int = 3
    stride: int = 2
    dilation: int = 1
    style: str = "caffe"
    norm_cfg: Any = None
    norm_eval: bool = True
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        _, stage_blocks = ARCH[self.depth]
        planes = 64 * 2 ** self.stage
        for j in range(stage_blocks[self.stage]):
            stride = self.stride if j == 0 else 1
            ds = j == 0 and (stride != 1 or x.shape[-1] != planes * 4)
            x = Bottleneck(planes, stride, self.dilation, ds, self.style,
                           norm_eval_cfg(self.norm_cfg, self.norm_eval),
                           self.dtype,
                           name=f"layer{self.stage+1}_{j}")(x)
        return x
