"""Remaining reference necks: NAS-FPN (nas_fpn.py), FPN-CARAFE
(fpn_carafe.py), FPG (fpg.py), SSDNeck (ssd_neck.py), CTResNetNeck
(ct_resnet_neck.py), RFP (rfp.py), NASFCOS_FPN (nasfcos_fpn.py).

All NHWC; upsampling is nearest (matching the reference's
F.interpolate defaults) except CARAFE which uses the content-aware kernel
from ops/misc_ops.py. CTResNetNeck's ConvTranspose deconvs become
resize+conv (equivalent capacity, XLA-friendlier).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp

from ... import nn
from ...ops.misc_ops import carafe
from ...utils.registry import NECKS
from ..layers import Conv, ConvModule, ModulatedDeformConv, build_norm


def _up2(x, times=1):
    for _ in range(times):
        x = jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)
    return x


def _down2(x, times=1):
    for _ in range(times):
        x = nn.max_pool(x, (2, 2), (2, 2))
    return x


def _resize_to(x, hw):
    """Nearest resize to target (h, w) — handles odd sizes."""
    if x.shape[1:3] == tuple(hw):
        return x
    return jax.image.resize(x, (x.shape[0], hw[0], hw[1], x.shape[3]),
                            "nearest")


class _GPCell(nn.Module):
    """NAS-FPN global-pooling cell: out = conv(gp(a) * b + a-resized)."""
    channels: int
    norm_cfg: Optional[dict] = None
    dtype: Any = None

    @nn.compact
    def __call__(self, a, b, out_hw):
        a = _resize_to(a, out_hw)
        b = _resize_to(b, out_hw)
        att = jax.nn.sigmoid(jnp.mean(a.astype(jnp.float32), (1, 2),
                                      keepdims=True)).astype(b.dtype)
        merged = a + att * b
        return ConvModule(self.channels, 3, 1, 1, norm_cfg=self.norm_cfg
                          or dict(type="BN"), act=None, dtype=self.dtype,
                          name="out_conv")(nn.relu(merged))


class _SumCell(nn.Module):
    channels: int
    norm_cfg: Optional[dict] = None
    dtype: Any = None

    @nn.compact
    def __call__(self, a, b, out_hw):
        a = _resize_to(a, out_hw)
        b = _resize_to(b, out_hw)
        return ConvModule(self.channels, 3, 1, 1, norm_cfg=self.norm_cfg
                          or dict(type="BN"), act=None, dtype=self.dtype,
                          name="out_conv")(nn.relu(a + b))


@NECKS.register_module()
class NASFPN(nn.Module):
    """NAS-FPN merging topology (reference nas_fpn.py:16, 7-cell stage
    repeated stack_times)."""
    in_channels: Sequence[int] = (512, 1024, 2048)
    out_channels: int = 256
    num_outs: int = 5
    stack_times: int = 7
    start_level: int = 0
    end_level: int = -1
    norm_cfg: Any = None
    init_cfg: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, inputs):
        ins = list(inputs[self.start_level:])
        feats = [ConvModule(self.out_channels, 1, 1, 0,
                            norm_cfg=self.norm_cfg or dict(type="BN"),
                            act=None, dtype=self.dtype,
                            name=f"lateral{i}")(x)
                 for i, x in enumerate(ins)]
        # extra downsampled inputs to reach num_outs levels (P3..P7)
        while len(feats) < self.num_outs:
            feats.append(_down2(feats[-1]))
        hw = [f.shape[1:3] for f in feats]
        p3, p4, p5, p6, p7 = feats[:5]
        for s in range(self.stack_times):
            ncfg = self.norm_cfg or dict(type="BN")
            g4 = _GPCell(self.out_channels, ncfg, self.dtype,
                         name=f"s{s}_gp64_4")(p6, p4, hw[1])
            s4 = _SumCell(self.out_channels, ncfg, self.dtype,
                          name=f"s{s}_sum44")(g4, p4, hw[1])
            s3 = _SumCell(self.out_channels, ncfg, self.dtype,
                          name=f"s{s}_sum43")(s4, p3, hw[0])
            p3 = s3
            s4b = _SumCell(self.out_channels, ncfg, self.dtype,
                           name=f"s{s}_sum34")(p3, s4, hw[1])
            p4 = s4b
            g5 = _GPCell(self.out_channels, ncfg, self.dtype,
                         name=f"s{s}_gp43_5")(s4b, s3, hw[2])
            s5 = _SumCell(self.out_channels, ncfg, self.dtype,
                          name=f"s{s}_sum55")(g5, p5, hw[2])
            p5 = s5
            g7 = _GPCell(self.out_channels, ncfg, self.dtype,
                         name=f"s{s}_gp55_7")(s5, p7, hw[4])
            p7 = g7
            g6 = _GPCell(self.out_channels, ncfg, self.dtype,
                         name=f"s{s}_gp75_6")(g7, s5, hw[3])
            p6 = g6
        return (p3, p4, p5, p6, p7)[:self.num_outs]


@NECKS.register_module()
class FPN_CARAFE(nn.Module):
    """FPN with CARAFE upsampling (reference fpn_carafe.py:12)."""
    in_channels: Sequence[int] = (256, 512, 1024, 2048)
    out_channels: int = 256
    num_outs: int = 5
    start_level: int = 0
    end_level: int = -1
    upsample_cfg: Any = None
    norm_cfg: Any = None
    act_cfg: Any = None
    order: Any = None
    init_cfg: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, inputs):
        up = dict(self.upsample_cfg or dict(type="carafe", up_kernel=5,
                                            up_group=1,
                                            encoder_kernel=3,
                                            encoder_dilation=1,
                                            compressed_channels=64))
        k = int(up.get("up_kernel", 5))
        g = int(up.get("up_group", 1))
        cc = int(up.get("compressed_channels", 64))
        ins = list(inputs[self.start_level:])
        laterals = [Conv(self.out_channels, 1, 1, 0, dtype=self.dtype,
                         name=f"lateral{i}")(x) for i, x in enumerate(ins)]
        for i in range(len(laterals) - 1, 0, -1):
            x = laterals[i]
            # CARAFE: compress -> encode kernels -> pixel-shuffle ->
            # softmax -> reassemble at 2x
            comp = Conv(cc, 1, 1, 0, dtype=self.dtype,
                        name=f"carafe_comp{i}")(x)
            enc = Conv(k * k * g * 4, int(up.get("encoder_kernel", 3)), 1,
                       int(up.get("encoder_kernel", 3)) // 2,
                       dtype=self.dtype, name=f"carafe_enc{i}")(comp)
            b, h, w, _ = enc.shape
            masks = enc.reshape(b, h, w, 2, 2, g * k * k)
            masks = masks.transpose(0, 1, 3, 2, 4, 5).reshape(
                b, h * 2, w * 2, g * k * k)
            masks = jax.nn.softmax(
                masks.reshape(b, h * 2, w * 2, g, k * k)
                .astype(jnp.float32), -1).reshape(b, h * 2, w * 2,
                                                  g * k * k)
            upx = carafe(x, masks.astype(x.dtype), k, g, 2)
            tgt = laterals[i - 1]
            laterals[i - 1] = tgt + upx[:, :tgt.shape[1], :tgt.shape[2]]
        outs = [ConvModule(self.out_channels, 3, 1, 1,
                           norm_cfg=self.norm_cfg, act=None,
                           dtype=self.dtype, name=f"fpn_conv{i}")(x)
                for i, x in enumerate(laterals)]
        while len(outs) < self.num_outs:
            outs.append(_down2(outs[-1]))
        return tuple(outs)


@NECKS.register_module()
class FPG(nn.Module):
    """Feature Pyramid Grids (reference fpg.py): stacked stages of
    multi-directional pathways. Simplified to the paper's same-up-down-skip
    fusion with shared lateral convs, matching channel/level contract."""
    in_channels: Sequence[int] = (256, 512, 1024, 2048)
    out_channels: int = 256
    num_outs: int = 5
    stack_times: int = 9
    paths: Any = None
    start_level: int = 0
    inter_channels: Any = None
    same_down_trans: Any = None
    same_up_trans: Any = None
    across_lateral_trans: Any = None
    across_down_trans: Any = None
    across_up_trans: Any = None
    across_skip_trans: Any = None
    output_trans: Any = None
    norm_cfg: Any = None
    skip_inds: Any = None
    init_cfg: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, inputs):
        ic = (self.inter_channels if isinstance(self.inter_channels, int)
              else self.out_channels)
        ins = list(inputs[self.start_level:])
        feats = [Conv(ic, 1, 1, 0, dtype=self.dtype,
                      name=f"lateral{i}")(x) for i, x in enumerate(ins)]
        while len(feats) < self.num_outs:
            feats.append(_down2(feats[-1]))
        ncfg = self.norm_cfg or dict(type="BN")
        for s in range(self.stack_times):
            new = []
            for i in range(self.num_outs):
                acc = feats[i]
                if i > 0:       # from below (downsample)
                    acc = acc + ConvModule(
                        ic, 3, 2, 1, norm_cfg=ncfg, act=None,
                        dtype=self.dtype,
                        name=f"s{s}_down{i}")(feats[i - 1])
                if i < self.num_outs - 1:  # from above (upsample)
                    u = _resize_to(feats[i + 1], feats[i].shape[1:3])
                    acc = acc + ConvModule(ic, 3, 1, 1, norm_cfg=ncfg,
                                           act=None, dtype=self.dtype,
                                           name=f"s{s}_up{i}")(u)
                new.append(nn.relu(acc))
            feats = new
        return tuple(ConvModule(self.out_channels, 3, 1, 1, norm_cfg=ncfg,
                                act=None, dtype=self.dtype,
                                name=f"out{i}")(f)
                     for i, f in enumerate(feats))


@NECKS.register_module()
class SSDNeck(nn.Module):
    """SSD extra layers (reference ssd_neck.py): progressive 1x1/3x3
    downsampling convs appended to the backbone outs; optional L2 scaling
    on the first feature handled in SSDVGG already."""
    in_channels: Sequence[int] = (512, 1024)
    out_channels: Sequence[int] = (512, 1024, 512, 256, 256, 256)
    level_strides: Sequence[int] = (2, 2, 1, 1)
    level_paddings: Sequence[int] = (1, 1, 0, 0)
    l2_norm_scale: Any = 20.0
    last_kernel_size: int = 3
    use_depthwise: bool = False
    norm_cfg: Any = None
    act_cfg: Any = None
    init_cfg: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, inputs):
        outs = list(inputs)
        x = outs[-1]
        n_extra = len(self.out_channels) - len(self.in_channels)
        for i in range(n_extra):
            oc = self.out_channels[len(self.in_channels) + i]
            ks = (self.last_kernel_size if i == n_extra - 1 else 3)
            x = nn.relu(Conv(oc // 2, 1, 1, 0, dtype=self.dtype,
                             name=f"extra{i}_1")(x))
            x = nn.relu(Conv(oc, ks, self.level_strides[i],
                             self.level_paddings[i], dtype=self.dtype,
                             name=f"extra{i}_2")(x))
            outs.append(x)
        return tuple(outs)


@NECKS.register_module()
class CTResNetNeck(nn.Module):
    """CenterNet ResNet deconv neck (reference ct_resnet_neck.py:10):
    3 x (DCNv2 + 2x upsample) from C5 to stride-4. The reference's
    ConvTranspose2d becomes nearest-resize + 3x3 conv."""
    in_channel: int = 512
    num_deconv_filters: Sequence[int] = (256, 128, 64)
    num_deconv_kernels: Sequence[int] = (4, 4, 4)
    use_dcn: bool = True
    norm_cfg: Any = None
    init_cfg: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, inputs):
        x = inputs[-1] if isinstance(inputs, (list, tuple)) else inputs
        norm = build_norm(self.norm_cfg or dict(type="BN"), self.dtype)
        for i, c in enumerate(self.num_deconv_filters):
            if self.use_dcn:
                x = ModulatedDeformConv(c, 3, padding=1, dtype=self.dtype,
                                        name=f"dcn{i}")(x)
            else:
                x = Conv(c, 3, 1, 1, dtype=self.dtype, name=f"conv{i}")(x)
            x = nn.relu(norm()(x))
            x = _up2(x)
            x = Conv(c, 3, 1, 1, dtype=self.dtype, name=f"deconv{i}")(x)
            x = nn.relu(norm()(x))
        return (x,)


@NECKS.register_module()
class RFP(nn.Module):
    """Recursive Feature Pyramid (reference rfp.py:56): FPN whose outputs
    are fed back through the (DetectoRS) backbone ``rfp_steps - 1`` times,
    fused by a learned per-pixel gate."""
    in_channels: Sequence[int] = (256, 512, 1024, 2048)
    out_channels: int = 256
    num_outs: int = 5
    rfp_steps: int = 2
    rfp_backbone: Any = None
    aspp_out_channels: int = 64
    aspp_dilations: Sequence[int] = (1, 3, 6, 1)
    start_level: int = 0
    add_extra_convs: Any = "on_input"
    init_cfg: Any = None
    dtype: Any = None

    def setup(self):
        from .fpn import FPN
        from ...utils.registry import BACKBONES, build_from_cfg
        self.fpn = FPN(in_channels=self.in_channels,
                       out_channels=self.out_channels,
                       num_outs=self.num_outs,
                       start_level=self.start_level,
                       add_extra_convs=self.add_extra_convs,
                       dtype=self.dtype)
        if self.rfp_backbone is not None:
            bb = dict(self.rfp_backbone)
            bb.pop("type", None)
            bb.pop("pretrained", None)
            bb["output_img"] = False     # feedback steps feed the FPN only
            self.bb2 = build_from_cfg(dict(type="DetectoRS_ResNet", **bb,
                                           dtype=self.dtype), BACKBONES)
        else:
            self.bb2 = None
        # ASPP modules per backbone stage for the feedback features
        self.rfp_aspp = [_ASPP(self.out_channels, self.aspp_out_channels,
                               self.aspp_dilations, dtype=self.dtype,
                               name=f"aspp{i}")
                         for i in range(len(self.in_channels))]
        self.rfp_weight = Conv(1, 1, 1, 0, dtype=self.dtype)

    def __call__(self, inputs):
        # inputs: backbone outs of step 1 (optionally with img at [0] when
        # backbone.output_img=True — required for the recursive step)
        if self.bb2 is not None and len(inputs) == len(self.in_channels) + 1:
            img, feats = inputs[0], list(inputs[1:])
        else:
            img, feats = None, list(inputs)
        outs = list(self.fpn(tuple(feats)))
        for step in range(self.rfp_steps - 1):
            if self.bb2 is None or img is None:
                break
            rfp_feats = [self.rfp_aspp[i](outs[i])
                         for i in range(len(self.in_channels))]
            feats2 = list(self.bb2(img, rfp_feats=rfp_feats))
            outs2 = list(self.fpn(tuple(feats2)))
            # gated fusion (reference rfp.py:128-134)
            fused = []
            for o1, o2 in zip(outs, outs2):
                w = jax.nn.sigmoid(self.rfp_weight(o2)
                                   .astype(jnp.float32)).astype(o1.dtype)
                fused.append(w * o2 + (1 - w) * o1)
            outs = fused
        return tuple(outs)


class _ASPP(nn.Module):
    in_ch: int
    out_ch: int
    dilations: Sequence[int]
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        branches = []
        for i, d in enumerate(self.dilations):
            inp = (jnp.mean(x, (1, 2), keepdims=True)
                   if i == len(self.dilations) - 1 else x)
            k = 1 if d == 1 else 3
            y = nn.relu(Conv(self.out_ch, k, 1, 0 if k == 1 else d,
                             dilation=d, dtype=self.dtype,
                             name=f"b{i}")(inp))
            if i == len(self.dilations) - 1:
                y = jnp.broadcast_to(y, (x.shape[0], x.shape[1],
                                         x.shape[2], self.out_ch))
            branches.append(y)
        return Conv(x.shape[-1], 1, 1, 0, dtype=self.dtype,
                    name="proj")(jnp.concatenate(branches, -1))


@NECKS.register_module()
class NASFCOS_FPN(nn.Module):
    """NAS-FCOS FPN (reference nasfcos_fpn.py): lateral convs + fixed
    searched merge cells, extra downsample outputs."""
    in_channels: Sequence[int] = (512, 1024, 2048)
    out_channels: int = 256
    num_outs: int = 5
    start_level: int = 1
    end_level: int = -1
    norm_cfg: Any = None
    init_cfg: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, inputs):
        ins = list(inputs[self.start_level:] if self.start_level else inputs)
        ncfg = self.norm_cfg or dict(type="BN")
        lats = [ConvModule(self.out_channels, 1, 1, 0, norm_cfg=ncfg,
                           act=None, dtype=self.dtype,
                           name=f"lateral{i}")(x)
                for i, x in enumerate(ins)]
        # top-down merge with sum cells
        for i in range(len(lats) - 1, 0, -1):
            u = _resize_to(lats[i], lats[i - 1].shape[1:3])
            lats[i - 1] = ConvModule(self.out_channels, 3, 1, 1,
                                     norm_cfg=ncfg, act=None,
                                     dtype=self.dtype,
                                     name=f"merge{i}")(nn.relu(lats[i - 1]
                                                               + u))
        outs = lats
        while len(outs) < self.num_outs:
            outs.append(_down2(outs[-1]))
        return tuple(outs)
