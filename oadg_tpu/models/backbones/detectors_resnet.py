"""DetectoRS backbones (reference mmdet/models/backbones/detectors_resnet.py
/ detectors_resnext.py): ResNet with SAC (switchable atrous convolution)
and RFP (recursive feature pyramid) input connections.

SAC: the 3x3 conv runs twice with shared weights at dilation 1 and 3; a
1x1 switch conv (on an avg-pooled input) gates between them, with pre/post
context modules. RFP: each stage's first block can add a projected rfp_feat
(the neck feeds features back for a second unrolled step).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import jax.lax as lax
import jax.numpy as jnp

from ... import nn
from ...utils.registry import BACKBONES
from ..layers import Conv, build_norm, max_pool_3x3_s2, norm_eval_cfg
from .resnet import ARCH, Bottleneck


class SACConv(nn.Module):
    """Switchable atrous conv (reference mmcv SAConv2d)."""
    features: int
    stride: int = 1
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        k = self.param("kernel", nn.initializers.he_normal(),
                       (3, 3, x.shape[-1], self.features))
        # pre-context: global avg added
        pre = Conv(x.shape[-1], 1, 1, 0, dtype=self.dtype,
                   name="pre_context")(jnp.mean(x, (1, 2), keepdims=True))
        x = x + pre
        sw_in = nn.avg_pool(x, (5, 5), (self.stride, self.stride),
                            padding=[(2, 2), (2, 2)])
        s = Conv(1, 1, 1, 0, dtype=self.dtype, name="switch")(sw_in)
        s = nn.sigmoid(s.astype(jnp.float32)).astype(x.dtype)
        kd = k.astype(x.dtype)
        out1 = lax.conv_general_dilated(
            x, kd, (self.stride, self.stride), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        delta = self.param("weight_diff", nn.initializers.zeros, k.shape)
        out3 = lax.conv_general_dilated(
            x, (k + delta).astype(x.dtype), (self.stride, self.stride),
            [(3, 3), (3, 3)], rhs_dilation=(3, 3),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        out = s * out1 + (1 - s) * out3
        post = Conv(self.features, 1, 1, 0, dtype=self.dtype,
                    name="post_context")(jnp.mean(out, (1, 2),
                                                  keepdims=True))
        return out + post


class BottleneckSAC(nn.Module):
    planes: int
    stride: int = 1
    dilation: int = 1
    downsample: bool = False
    sac: bool = False
    norm_cfg: Optional[dict] = None
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        norm = build_norm(self.norm_cfg or dict(type="BN"), self.dtype)
        identity = x
        out = Conv(self.planes, 1, 1, 0, use_bias=False, dtype=self.dtype,
                   name="conv1")(x)
        out = nn.relu(norm()(out))
        if self.sac:
            out = SACConv(self.planes, self.stride, dtype=self.dtype,
                          name="conv2")(out)
        else:
            out = Conv(self.planes, 3, self.stride, self.dilation,
                       dilation=self.dilation, use_bias=False,
                       dtype=self.dtype, name="conv2")(out)
        out = nn.relu(norm()(out))
        out = norm()(Conv(self.planes * 4, 1, 1, 0, use_bias=False,
                          dtype=self.dtype, name="conv3")(out))
        if self.downsample:
            identity = Conv(self.planes * 4, 1, self.stride, 0,
                            use_bias=False, dtype=self.dtype,
                            name="downsample_conv")(x)
            identity = norm()(identity)
        return nn.relu(out + identity)


@BACKBONES.register_module()
class DetectoRS_ResNet(nn.Module):
    """Schema mirrors the reference: ``sac=dict(type='SAC')`` +
    ``stage_with_sac`` flags, ``rfp_inplanes`` for the recursive feedback.
    Call with ``rfp_feats`` (list of per-stage tensors or None) for the
    unrolled second step."""
    depth: int = 50
    num_stages: int = 4
    out_indices: Sequence[int] = (0, 1, 2, 3)
    strides: Sequence[int] = (1, 2, 2, 2)
    dilations: Sequence[int] = (1, 1, 1, 1)
    sac: Any = None
    stage_with_sac: Sequence[bool] = (False, False, False, False)
    rfp_inplanes: Any = None
    output_img: bool = False
    style: str = "pytorch"
    frozen_stages: int = -1
    norm_cfg: Any = None
    norm_eval: bool = True
    conv_cfg: Any = None
    init_cfg: Any = None
    pretrained: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, x, rfp_feats=None):
        img = x
        norm = build_norm(norm_eval_cfg(self.norm_cfg, self.norm_eval), self.dtype)
        x = Conv(64, 7, 2, 3, use_bias=False, dtype=self.dtype,
                 name="conv1")(x)
        x = nn.relu(norm()(x))
        x = max_pool_3x3_s2(x)
        _, stage_blocks = ARCH[self.depth]
        outs = []
        for i in range(self.num_stages):
            planes = 64 * 2 ** i
            use_sac = self.sac is not None and self.stage_with_sac[i]
            for j in range(stage_blocks[i]):
                stride = self.strides[i] if j == 0 else 1
                ds = j == 0 and (stride != 1 or x.shape[-1] != planes * 4)
                x = BottleneckSAC(planes, stride, self.dilations[i], ds,
                                  use_sac, norm_eval_cfg(self.norm_cfg, self.norm_eval),
                                  self.dtype, name=f"layer{i+1}_{j}")(x)
                if (j == 0 and self.rfp_inplanes and rfp_feats is not None
                        and rfp_feats[i] is not None):
                    r = Conv(x.shape[-1], 1, 1, 0, dtype=self.dtype,
                             name=f"rfp_conv{i+1}")(rfp_feats[i])
                    x = nn.relu(x + r)
            if i in self.out_indices:
                outs.append(x)
        if self.output_img:
            return tuple([img] + outs)
        return tuple(outs)


@BACKBONES.register_module()
class DetectoRS_ResNeXt(DetectoRS_ResNet):
    """Grouped-conv variant registered for config compatibility (reference
    detectors_resnext.py); the SAC/RFP machinery is shared — the grouped
    3x3 becomes SAC's dense dual-dilation conv."""
    groups: int = 32
    base_width: int = 4
