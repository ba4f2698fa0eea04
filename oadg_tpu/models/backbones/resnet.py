"""ResNet backbone family (NHWC).

Same capability surface as the reference backbone
(mmdet/models/backbones/resnet.py:306): depths 18/34/50/101/152,
``pytorch``/``caffe`` block styles (stride placement in the bottleneck),
per-stage strides/dilations (the DC5 variant uses strides=(1,2,2,1),
dilations=(1,1,1,2), reference configs/_base_/models/faster_rcnn_r50_caffe_dc5.py:9),
``out_indices``, ``deep_stem``, ``avg_down``, and ``frozen_stages``.

Differences:
- NHWC layout with bf16-friendly compute; BN is frozen-statistics affine
  (see models/layers.py) matching ``norm_eval=True`` training.
- ``frozen_stages`` does not gate module construction — freezing is a
  gradient mask applied in the optimizer (engine/optim.py) plus a
  ``stop_gradient`` at the frozen-stage boundary so XLA skips the frozen
  stages' backward convs entirely (they run at the largest spatial sizes).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ... import nn
from ...utils.registry import BACKBONES
from ..layers import Conv, build_norm, max_pool_3x3_s2, norm_eval_cfg


def conv_norm(x, feats, k, s, p, norm, dtype, cname, *, dilation=1,
              bn_name=None):
    """conv -> BN with the frozen-BN affine folded INTO the conv kernel.

    Frozen BN (``norm_eval=True``) is a pure per-channel affine, so
    conv(x, K)*w + b == conv(x, K*w) + b exactly; folding it removes the
    two full-activation memory passes (mul+add, plus their backward
    reductions). Falls back
    to the plain conv->norm sequence for live BN. Param paths and
    creation order are identical in both branches (FrozenBN auto-numbering
    is by instantiation order, preserved here), so checkpoints, the torch
    converter and the optimizer freeze masks are untouched.
    """
    conv = Conv(feats, k, s, p, dilation=dilation, use_bias=False,
                dtype=dtype, name=cname)
    nkw = {"name": bn_name} if bn_name else {}
    if getattr(norm, "folds_affine", False):
        w, b = norm(**nkw)(None, affine_only=True, channels=feats)
        return conv(x, w, b)
    return norm(**nkw)(conv(x))


class BasicBlock(nn.Module):
    planes: int
    stride: int = 1
    dilation: int = 1
    downsample: bool = False
    style: str = "pytorch"
    norm_cfg: Optional[dict] = None
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        norm = build_norm(self.norm_cfg or dict(type="BN"), self.dtype)
        identity = x
        out = conv_norm(x, self.planes, 3, self.stride, self.dilation,
                        norm, self.dtype, "conv1", dilation=self.dilation)
        out = nn.relu(out)
        out = conv_norm(out, self.planes, 3, 1, 1, norm, self.dtype, "conv2")
        if self.downsample:
            identity = conv_norm(x, self.planes, 1, self.stride, 0, norm,
                                 self.dtype, "downsample_conv",
                                 bn_name="downsample_bn")
        return nn.relu(out + identity)


class Bottleneck(nn.Module):
    planes: int
    stride: int = 1
    dilation: int = 1
    downsample: bool = False
    style: str = "pytorch"
    norm_cfg: Optional[dict] = None
    dtype: Any = None
    dcn: Optional[dict] = None      # dict(type='DCNv2', deform_groups=N)

    @nn.compact
    def __call__(self, x):
        # caffe style puts the stride on the 1x1 conv, pytorch on the 3x3
        # (reference resnet.py Bottleneck.conv1_stride/conv2_stride).
        s1, s2 = (self.stride, 1) if self.style == "caffe" else (1, self.stride)
        norm = build_norm(self.norm_cfg or dict(type="BN"), self.dtype)
        identity = x
        out = conv_norm(x, self.planes, 1, s1, 0, norm, self.dtype, "conv1")
        out = nn.relu(out)
        if self.dcn is not None:
            from ..layers import ModulatedDeformConv
            out = ModulatedDeformConv(
                self.planes, 3, s2, self.dilation, self.dilation,
                deform_groups=int(dict(self.dcn).get("deform_groups", 1)),
                dtype=self.dtype, name="conv2")(out)
            out = norm()(out)
        else:
            out = conv_norm(out, self.planes, 3, s2, self.dilation, norm,
                            self.dtype, "conv2", dilation=self.dilation)
        out = nn.relu(out)
        out = conv_norm(out, self.planes * 4, 1, 1, 0, norm, self.dtype,
                        "conv3")
        if self.downsample:
            identity = conv_norm(x, self.planes * 4, 1, self.stride, 0, norm,
                                 self.dtype, "downsample_conv",
                                 bn_name="downsample_bn")
        return nn.relu(out + identity)


ARCH = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@BACKBONES.register_module()
class ResNet(nn.Module):
    """Config schema mirrors the reference (depth, num_stages, out_indices,
    strides, dilations, style, frozen_stages, norm_cfg, norm_eval)."""
    depth: int = 50
    num_stages: int = 4
    out_indices: Sequence[int] = (0, 1, 2, 3)
    strides: Sequence[int] = (1, 2, 2, 2)
    dilations: Sequence[int] = (1, 1, 1, 1)
    style: str = "pytorch"
    deep_stem: bool = False
    base_channels: int = 64
    stem_channels: int = 64
    frozen_stages: int = -1          # consumed by the optimizer mask
    dcn: Any = None                  # reference: dcn=dict(type='DCNv2', ...)
    stage_with_dcn: Any = (False, False, False, False)
    norm_cfg: Any = None
    norm_eval: bool = True           # False -> live (Sync)BN in train steps
    with_cp: bool = False            # activation checkpointing (jax remat)
    init_cfg: Any = None             # checkpoint init handled by converter
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        block, stage_blocks = ARCH[self.depth]
        ncfg = norm_eval_cfg(self.norm_cfg, self.norm_eval)
        norm = build_norm(ncfg, self.dtype)
        if self.deep_stem:
            for i, s in enumerate((2, 1, 1)):
                x = conv_norm(x, self.stem_channels // (2 if i < 2 else 1),
                              3, s, 1, norm, self.dtype, f"stem_conv{i+1}")
                x = nn.relu(x)
        else:
            x = conv_norm(x, self.stem_channels, 7, 2, 3, norm, self.dtype,
                          "conv1")
            x = nn.relu(x)
        x = max_pool_3x3_s2(x)
        if self.frozen_stages >= 0:
            # frozen params get no update anyway (optimizer mask); cutting
            # the gradient here also skips the frozen stages' backward convs
            # entirely (stem + layer1 run at the largest spatial size, so
            # this is a real step-time win, not just bookkeeping).
            x = jax.lax.stop_gradient(x)

        outs = []
        expansion = 4 if block is Bottleneck else 1
        for i in range(self.num_stages):
            planes = self.base_channels * 2 ** i
            for j in range(stage_blocks[i]):
                stride = self.strides[i] if j == 0 else 1
                downsample = j == 0 and (stride != 1 or
                                         x.shape[-1] != planes * expansion)
                dcn = (self.dcn if (self.dcn is not None
                                    and self.stage_with_dcn[i]
                                    and block is Bottleneck) else None)
                kw = {} if block is BasicBlock else {"dcn": dcn}
                # with_cp: the reference wraps each block in
                # torch.utils.checkpoint (resnet.py:87); the JAX
                # form is nn.remat — activations recompute in the backward
                # pass, trading FLOPs for device memory (enables larger
                # per-device batches)
                cls = nn.remat(block) if self.with_cp else block
                x = cls(planes, stride, self.dilations[i], downsample,
                        self.style, ncfg,
                        self.dtype, name=f"layer{i+1}_{j}", **kw)(x)
            if self.frozen_stages >= i + 1:
                x = jax.lax.stop_gradient(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module()
class ResNetV1d(ResNet):
    """ResNet with deep stem + avg-down (reference resnet.py ResNetV1d)."""
    deep_stem: bool = True


class BottleneckX(nn.Module):
    """Grouped bottleneck (reference mmdet/models/backbones/resnext.py)."""
    planes: int
    stride: int = 1
    dilation: int = 1
    downsample: bool = False
    style: str = "pytorch"
    norm_cfg: Optional[dict] = None
    groups: int = 32
    base_width: int = 4
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        width = int(self.planes * (self.base_width / 64.0)) * self.groups
        s1, s2 = (self.stride, 1) if self.style == "caffe" else (1, self.stride)
        norm = build_norm(self.norm_cfg or dict(type="BN"), self.dtype)
        identity = x
        out = conv_norm(x, width, 1, s1, 0, norm, self.dtype, "conv1")
        out = nn.relu(out)
        p = self.dilation
        out = nn.Conv(width, (3, 3), strides=(s2, s2),
                       padding=[(p, p), (p, p)],
                       kernel_dilation=(p, p),
                       feature_group_count=self.groups, use_bias=False,
                       dtype=self.dtype, name="conv2")(out)
        out = norm()(out)
        out = nn.relu(out)
        out = conv_norm(out, self.planes * 4, 1, 1, 0, norm, self.dtype,
                        "conv3")
        if self.downsample:
            identity = conv_norm(x, self.planes * 4, 1, self.stride, 0, norm,
                                 self.dtype, "downsample_conv",
                                 bn_name="downsample_bn")
        return nn.relu(out + identity)


@BACKBONES.register_module()
class ResNeXt(ResNet):
    """ResNeXt (reference mmdet/models/backbones/resnext.py): grouped
    bottlenecks; config adds ``groups`` and ``base_width``."""
    groups: int = 32
    base_width: int = 4

    @nn.compact
    def __call__(self, x):
        _, stage_blocks = ARCH[self.depth]
        ncfg = norm_eval_cfg(self.norm_cfg, self.norm_eval)
        norm = build_norm(ncfg, self.dtype)
        x = conv_norm(x, self.stem_channels, 7, 2, 3, norm, self.dtype,
                      "conv1")
        x = nn.relu(x)
        x = max_pool_3x3_s2(x)
        if self.frozen_stages >= 0:
            x = jax.lax.stop_gradient(x)
        outs = []
        for i in range(self.num_stages):
            planes = self.base_channels * 2 ** i
            for j in range(stage_blocks[i]):
                stride = self.strides[i] if j == 0 else 1
                downsample = j == 0 and (stride != 1 or
                                         x.shape[-1] != planes * 4)
                x = BottleneckX(planes, stride, self.dilations[i], downsample,
                                self.style, ncfg,
                                self.groups, self.base_width, self.dtype,
                                name=f"layer{i+1}_{j}")(x)
            if self.frozen_stages >= i + 1:
                x = jax.lax.stop_gradient(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


class Bottle2neck(nn.Module):
    """Res2Net multi-scale bottleneck (reference
    mmdet/models/backbones/res2net.py:14): the 3x3 is split into
    ``scales - 1`` sequential sub-convs over width-wise chunks, each fed the
    previous chunk's output (hierarchical residual-like connections)."""
    planes: int
    stride: int = 1
    dilation: int = 1
    downsample: bool = False
    style: str = "pytorch"
    norm_cfg: Optional[dict] = None
    scales: int = 4
    base_width: int = 26
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        norm = build_norm(self.norm_cfg or dict(type="BN"), self.dtype)
        width = int(self.planes * (self.base_width / 64.0))
        s1, s2 = (self.stride, 1) if self.style == "caffe" else (1, self.stride)
        identity = x
        out = conv_norm(x, width * self.scales, 1, s1, 0, norm, self.dtype,
                        "conv1")
        out = nn.relu(out)
        chunks = jnp.split(out, self.scales, axis=-1)
        sp_outs = []
        sp = None
        for k in range(self.scales - 1):
            inp = chunks[k] if (k == 0 or s2 != 1) else sp + chunks[k]
            sp = conv_norm(inp, width, 3, s2, self.dilation, norm, self.dtype,
                           f"conv2_{k}", dilation=self.dilation)
            sp = nn.relu(sp)
            sp_outs.append(sp)
        last = chunks[-1]
        if s2 != 1:
            # stage-downsampling blocks avg-pool the untouched chunk
            last = nn.avg_pool(last, (3, 3), strides=(s2, s2),
                               padding=[(1, 1), (1, 1)])
        out = jnp.concatenate(sp_outs + [last], axis=-1)
        out = conv_norm(out, self.planes * 4, 1, 1, 0, norm, self.dtype,
                        "conv3")
        if self.downsample:
            identity = nn.avg_pool(x, (self.stride, self.stride),
                                   strides=(self.stride, self.stride)) \
                if self.stride != 1 else x
            identity = conv_norm(identity, self.planes * 4, 1, 1, 0, norm,
                                 self.dtype, "downsample_conv",
                                 bn_name="downsample_bn")
        return nn.relu(out + identity)


@BACKBONES.register_module()
class Res2Net(ResNet):
    """Res2Net (reference mmdet/models/backbones/res2net.py:240): deep stem +
    avg-down + Bottle2neck; config adds ``scales`` and ``base_width``."""
    scales: int = 4
    base_width: int = 26
    deep_stem: bool = True

    @nn.compact
    def __call__(self, x):
        _, stage_blocks = ARCH[self.depth]
        ncfg = norm_eval_cfg(self.norm_cfg, self.norm_eval)
        norm = build_norm(ncfg, self.dtype)
        for i, s in enumerate((2, 1, 1)):
            x = conv_norm(x, self.stem_channels // (2 if i < 2 else 1),
                          3, s, 1, norm, self.dtype, f"stem_conv{i+1}")
            x = nn.relu(x)
        x = max_pool_3x3_s2(x)
        if self.frozen_stages >= 0:
            x = jax.lax.stop_gradient(x)
        outs = []
        for i in range(self.num_stages):
            planes = self.base_channels * 2 ** i
            for j in range(stage_blocks[i]):
                stride = self.strides[i] if j == 0 else 1
                downsample = j == 0 and (stride != 1 or
                                         x.shape[-1] != planes * 4)
                x = Bottle2neck(planes, stride, self.dilations[i], downsample,
                                self.style, ncfg,
                                self.scales, self.base_width, self.dtype,
                                name=f"layer{i+1}_{j}")(x)
            if self.frozen_stages >= i + 1:
                x = jax.lax.stop_gradient(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
