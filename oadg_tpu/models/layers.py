"""Shared NN building blocks (NHWC, torch-faithful padding).

Replaces mmcv's ConvModule / norm layers used throughout the reference's
model zoo. Convolutions use explicit symmetric padding to bit-match torch's
Conv2d semantics (XLA 'SAME' pads asymmetrically for stride 2, which would
shift features by one pixel versus the reference at borders).

Norm policy: the reference trains detection models with frozen-statistics
BatchNorm (``norm_eval=True``, reference mmdet/models/backbones/resnet.py
train()), so BN here is an affine transform using stored moving statistics —
no cross-batch state, no syncBN collectives. Moving mean/var live in the
``batch_stats`` collection (converted from torch checkpoints); scale/bias in
``params``. Whether they receive gradients is decided by the optimizer mask
(see engine/optim.py), mirroring ``norm_cfg=dict(requires_grad=...)``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

from .. import nn

Dtype = Any


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def normal_init(std: float):
    """mmcv ``Normal(std=...)`` initializer (reference NormalInit)."""
    return nn.initializers.normal(stddev=std)


def bias_prob_init(prior_prob: float):
    """mmcv ``bias_prob`` initializer: constant -log((1-p)/p) so a
    sigmoid-classified head starts predicting probability ``p``
    (reference mmcv bias_init_with_prob; RetinaNet-family heads use
    p=0.01 — load-bearing for focal-loss training stability)."""
    import math
    b = float(-math.log((1 - prior_prob) / prior_prob))
    return nn.initializers.constant(b)


class Conv(nn.Module):
    """torch-compatible Conv2d on NHWC: explicit symmetric padding."""
    features: int
    kernel_size: Union[int, Tuple[int, int]] = 3
    stride: Union[int, Tuple[int, int]] = 1
    padding: Union[int, Tuple[int, int]] = 0
    dilation: Union[int, Tuple[int, int]] = 1
    use_bias: bool = True
    kernel_init: Any = None          # None -> nn.Conv default (lecun_normal)
    bias_init: Any = None
    dtype: Optional[Dtype] = None

    @nn.compact
    def __call__(self, x, out_scale=None, out_bias=None):
        """out_scale/out_bias: optional per-output-channel affine folded
        INTO the conv (y = conv(x, K*s) + (bias*s + b)) — used to absorb a
        frozen BatchNorm so no separate x*w+b pass touches the activation
        tensor in device memory (see FrozenBN affine_only / resnet.py block fold)."""
        k = _pair(self.kernel_size)
        p = _pair(self.padding)
        kw = {}
        if self.kernel_init is not None:
            kw["kernel_init"] = self.kernel_init
        if self.bias_init is not None:
            kw["bias_init"] = self.bias_init
        if (k == (7, 7) and _pair(self.stride) == (2, 2) and p == (3, 3)
                and _pair(self.dilation) == (1, 1) and x.shape[-1] <= 4
                and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
            # ResNet-family stem: see _S2DStemConv. Param path/shape is
            # identical to the nn.Conv branch (name="Conv_0").
            return _S2DStemConv(self.features, use_bias=self.use_bias,
                                dtype=self.dtype, name="Conv_0",
                                **kw)(x, out_scale, out_bias)
        if out_scale is not None:
            return _AffineFoldConv(
                self.features, k, _pair(self.stride),
                ((p[0], p[0]), (p[1], p[1])), _pair(self.dilation),
                use_bias=self.use_bias, dtype=self.dtype, name="Conv_0",
                **kw)(x, out_scale, out_bias)
        return nn.Conv(self.features, k, strides=_pair(self.stride),
                       padding=[(p[0], p[0]), (p[1], p[1])],
                       kernel_dilation=_pair(self.dilation),
                       use_bias=self.use_bias, dtype=self.dtype, **kw)(x)


class _AffineFoldConv(nn.Module):
    """Conv2d with a per-output-channel affine folded into the kernel.

    conv(x, K) * s + b == conv(x, K * s) + b exactly (s is per-OUTPUT
    channel, a linear map commutes with it); folding moves the affine from
    two full-activation memory passes (mul + add, plus their backward) onto
    the (kh, kw, cin, cout) kernel — a few thousand FLOPs. Param path and
    shape match the nn.Conv branch (``Conv_0/kernel``) so checkpoints,
    converters and init distributions are untouched."""
    features: int
    kernel_size: Tuple[int, int] = (3, 3)
    strides: Tuple[int, int] = (1, 1)
    padding: Any = ((0, 0), (0, 0))
    dilation: Tuple[int, int] = (1, 1)
    use_bias: bool = True
    kernel_init: Any = None
    bias_init: Any = None
    dtype: Optional[Dtype] = None

    @nn.compact
    def __call__(self, x, out_scale, out_bias):
        kh, kw = self.kernel_size
        cin = x.shape[-1]
        kern = self.param("kernel",
                          self.kernel_init or nn.initializers.lecun_normal(),
                          (kh, kw, cin, self.features))
        dtype = self.dtype or jnp.promote_types(x.dtype, kern.dtype)
        s = out_scale.astype(jnp.float32)
        kf = (kern.astype(jnp.float32) * s[None, None, None, :]).astype(dtype)
        y = jax.lax.conv_general_dilated(
            x.astype(dtype), kf, window_strides=self.strides,
            padding=tuple(self.padding), rhs_dilation=self.dilation,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        b = out_bias.astype(jnp.float32)
        if self.use_bias:
            bias = self.param("bias",
                              self.bias_init or nn.initializers.zeros,
                              (self.features,))
            b = b + bias.astype(jnp.float32) * s
        return y + b.astype(dtype)


class _S2DStemConv(nn.Module):
    """7x7/s2 stem conv computed as an EXACT W-only space-to-depth conv.

    C_in=3 fills little of a matmul unit's reduction width, so the stem
    runs far below the other convs' utilization. Folding the W axis into channels
    (a 1x2 space-to-depth) yields a 7x4/s(2,1) conv with C_in=6 — same
    math, reassociated: out[i,j] taps x[2i+dy-3, 2j+dx-3] for dy,dx in
    [0,7); over a front-zero-padded kernel W of 8 the tap index factors
    as dx+1 = 2t+s with t in [0,4), s in {0,1}. Unlike the full 2x2 fold
    (4x4/s1, C_in=12), the input relayout here is a FREE reshape —
    adjacent w pairs are contiguous in NHWC, so (B,H,W,C)->(B,H,W/2,2C)
    moves no data, while the 2x2 fold's H interleave needs a relayout
    (tools/misc/bench_s2d.py times the forms; H stays a strided conv
    axis).

    The parameter keeps the reference (7, 7, C, F) shape and the
    param path ``.../Conv_0/kernel`` — checkpoints, the torch converter
    and init distributions are untouched.
    """
    features: int
    use_bias: bool = True
    kernel_init: Any = None
    bias_init: Any = None
    dtype: Optional[Dtype] = None

    @nn.compact
    def __call__(self, x, out_scale=None, out_bias=None):
        cin = x.shape[-1]
        f = self.features
        kern = self.param(
            "kernel",
            self.kernel_init or nn.initializers.lecun_normal(),
            (7, 7, cin, f))
        # Mirror nn.Conv's dtype promotion: with dtype unset, promote
        # input and kernel to their common dtype with the f32 params
        # (a bf16 image then computes in f32, exactly like the nn.Conv
        # fallback would) instead of silently adopting x.dtype.
        dtype = self.dtype or jnp.promote_types(x.dtype, kern.dtype)
        # kernel: (7,7,cin,F) -> zero col at the FRONT of W -> (7,8,cin,F)
        # -> (7, t, s*cin, F): adjacent W taps fold into channel pairs
        kp = jnp.pad(kern, ((0, 0), (1, 0), (0, 0), (0, 0)))
        if out_scale is not None:     # fold a frozen-BN scale (see Conv)
            kp = kp.astype(jnp.float32) * out_scale.astype(jnp.float32)
        k2 = kp.reshape(7, 4, 2 * cin, f).astype(dtype)
        # input: (B,H,W,C) -> (B,H,W/2, s*C) — free reshape in NHWC
        b, h, w, _ = x.shape
        x2 = x.reshape(b, h, w // 2, 2 * cin)
        y = jax.lax.conv_general_dilated(
            x2.astype(dtype), k2, window_strides=(2, 1),
            padding=((3, 3), (2, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        badd = None
        if self.use_bias:
            bias = self.param("bias",
                              self.bias_init or nn.initializers.zeros,
                              (f,))
            badd = bias.astype(jnp.float32)
            if out_scale is not None:
                badd = badd * out_scale.astype(jnp.float32)
        if out_bias is not None:
            badd = (out_bias.astype(jnp.float32) if badd is None
                    else badd + out_bias.astype(jnp.float32))
        if badd is not None:
            y = y + badd.astype(dtype)
        return y


class FrozenBN(nn.Module):
    """BatchNorm. Despite the historical name this is the full layer —
    the class name is load-bearing (it is baked into parameter paths used
    by checkpoints, the torch converter and the optimizer freeze masks),
    so both modes live here:

    * ``frozen=True`` (default, the reference's ``norm_eval=True``):
      y = scale * (x - mean) / sqrt(var + eps) + bias with stored moving
      statistics; never updates them. Bit-identical to the round-1/2
      behavior.
    * ``frozen=False`` (live BN, reference ``norm_eval=False`` — YOLOv3
      neck/head, CSPDarknet/YOLOX, SyncBN configs): when the
      ``batch_stats`` collection is mutable (i.e. inside a train step
      applied with ``mutable=['batch_stats']``) normalize with the batch
      statistics and fold them into the moving stats. Under pjit the
      reductions run over the GLOBAL sharded batch, so XLA inserts the
      cross-chip collective automatically — live BN on a mesh IS SyncBN
      (reference SyncBN: mmdet configs ``norm_cfg=dict(type='SyncBN')``).
      Outside a mutable apply (eval / inference) it falls back to moving
      statistics, matching ``module.eval()`` semantics.

    Mean/var are non-trainable ``batch_stats`` variables; scale/bias are
    params (frozen or not by the optimizer mask). ``momentum`` is the
    decay of the OLD stats (torch momentum m -> here ``1 - m``); the
    moving var is updated with the unbiased estimate like torch.
    """
    eps: float = 1e-5
    dtype: Optional[Dtype] = None
    frozen: bool = True
    momentum: float = 0.9

    @nn.compact
    def __call__(self, x, affine_only: bool = False,
                 channels: Optional[int] = None):
        """affine_only=True: don't consume an activation — return the
        equivalent per-channel ``(w, b)`` f32 pair (y = x*w + b) so the
        caller can fold it into the producing conv's kernel/bias
        (``Conv(..., out_scale=w, out_bias=b)``). Only valid in frozen
        (stored-statistics) mode; params/variables are created exactly as
        in the apply path so checkpoints and freeze masks are unchanged."""
        c = channels if affine_only else x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (c,))
        bias = self.param("bias", nn.initializers.zeros, (c,))
        mean = self.variable("batch_stats", "mean", jnp.zeros, (c,))
        var = self.variable("batch_stats", "var", jnp.ones, (c,))
        if affine_only:
            if not self.frozen:
                raise ValueError("affine_only fold requires frozen BN "
                                 "(live BN statistics depend on the conv "
                                 "output)")
            inv = jax.lax.rsqrt(var.value.astype(jnp.float32) + self.eps)
            w = scale.astype(jnp.float32) * inv
            b = bias.astype(jnp.float32) - mean.value.astype(jnp.float32) * w
            return w, b
        dt = self.dtype or x.dtype
        live = ((not self.frozen) and not self.is_initializing()
                and self.is_mutable_collection("batch_stats"))
        if live:
            xf = x.astype(jnp.float32)
            axes = tuple(range(x.ndim - 1))
            m = jnp.mean(xf, axis=axes)
            v = jnp.maximum(jnp.mean(jnp.square(xf), axis=axes)
                            - jnp.square(m), 0.0)
            n = 1
            for a in axes:
                n *= x.shape[a]
            corr = n / max(n - 1, 1)          # torch stores unbiased var
            mom = self.momentum
            mean.value = jax.lax.stop_gradient(
                mom * mean.value + (1.0 - mom) * m)
            var.value = jax.lax.stop_gradient(
                mom * var.value + (1.0 - mom) * v * corr)
            use_m, use_v = m, v
        else:
            use_m = mean.value.astype(jnp.float32)
            use_v = var.value.astype(jnp.float32)
        inv = jax.lax.rsqrt(use_v + self.eps)
        w = (scale.astype(jnp.float32) * inv).astype(dt)
        b = (bias.astype(jnp.float32)
             - use_m * scale.astype(jnp.float32) * inv).astype(dt)
        return x * w + b


class GroupNorm32(nn.Module):
    num_groups: int = 32
    dtype: Optional[Dtype] = None

    @nn.compact
    def __call__(self, x):
        ng = min(self.num_groups, x.shape[-1])
        while x.shape[-1] % ng:
            ng -= 1
        return nn.GroupNorm(num_groups=ng, dtype=self.dtype)(x)


def build_norm(norm_cfg: Optional[dict], dtype=None) -> Callable:
    """norm_cfg dict (mmdet schema) -> module factory.

    BN/SyncBN mode: live batch statistics by default (the reference's
    ``model.train()`` puts every BN in train mode), except when the cfg
    carries ``_eval=True`` — backbones inject that from their
    ``norm_eval`` flag before propagating norm_cfg to their blocks
    (reference resnet.py train() / darknet.py:174). torch ``momentum``
    (default 0.1) and ``eps`` from the cfg are honored
    (csp_darknet.py norm_cfg momentum=0.03 eps=0.001).
    """
    if norm_cfg is None:
        return lambda **kw: (lambda x: x)
    t = norm_cfg.get("type", "BN")
    if t in ("BN", "SyncBN", "MMSyncBN"):
        frozen = bool(norm_cfg.get("_eval", False))
        eps = float(norm_cfg.get("eps", 1e-5))
        mom = 1.0 - float(norm_cfg.get("momentum", 0.1))
        fact = lambda **kw: FrozenBN(dtype=dtype, frozen=frozen, eps=eps,
                                     momentum=mom, **kw)
        # frozen BN is a pure per-channel affine -> callers may fold it
        # into the preceding conv (FrozenBN affine_only / Conv out_scale)
        fact.folds_affine = frozen
        return fact
    if t == "GN":
        ng = norm_cfg.get("num_groups", 32)
        return lambda **kw: GroupNorm32(num_groups=ng, dtype=dtype, **kw)
    raise NotImplementedError(f"norm type {t}")


def norm_eval_cfg(norm_cfg: Optional[dict], norm_eval: bool) -> Optional[dict]:
    """Inject a backbone's ``norm_eval`` flag into the norm_cfg it
    propagates to its blocks (consumed by :func:`build_norm`)."""
    if norm_cfg is None:
        norm_cfg = dict(type="BN")
    return {**dict(norm_cfg), "_eval": bool(norm_eval)}


class ConvModule(nn.Module):
    """mmcv ConvModule: conv -> norm -> act (order fixed to the common case)."""
    features: int
    kernel_size: Union[int, Tuple[int, int]] = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    norm_cfg: Optional[dict] = None
    act: Optional[str] = "relu"
    use_bias: Optional[bool] = None
    dtype: Optional[Dtype] = None

    @nn.compact
    def __call__(self, x):
        bias = (self.norm_cfg is None) if self.use_bias is None else self.use_bias
        x = Conv(self.features, self.kernel_size, self.stride, self.padding,
                 self.dilation, use_bias=bias, dtype=self.dtype, name="conv")(x)
        if self.norm_cfg is not None:
            x = build_norm(self.norm_cfg, self.dtype)()(x)
        if self.act == "relu":
            x = nn.relu(x)
        elif self.act == "leaky_relu":
            x = nn.leaky_relu(x, negative_slope=0.1)
        elif self.act is not None:
            raise NotImplementedError(self.act)
        return x


class DeformConv(nn.Module):
    """DCNv1 layer with externally supplied offsets (mmcv DeformConv2d;
    offsets layout (dy, dx) per tap — see ops/deform_conv.py). Used by
    RepPoints / VFNet star-dcn / guided-anchor feature adaptation."""
    features: int
    kernel_size: int = 3
    stride: int = 1
    padding: int = 1
    dilation: int = 1
    deform_groups: int = 1
    use_bias: bool = False
    dtype: Optional[Dtype] = None

    @nn.compact
    def __call__(self, x, offset):
        from ..ops.deform_conv import deform_conv2d
        k = _pair(self.kernel_size)
        w = self.param("kernel", nn.initializers.he_normal(),
                       (k[0], k[1], x.shape[-1], self.features))
        b = (self.param("bias", nn.initializers.zeros, (self.features,))
             if self.use_bias else None)
        return deform_conv2d(x, offset, w.astype(x.dtype),
                             stride=self.stride, padding=self.padding,
                             dilation=self.dilation,
                             deform_groups=self.deform_groups, bias=b)


class ModulatedDeformConv(nn.Module):
    """DCNv2 layer that predicts its own offsets+mask from the input
    (mmcv ModulatedDeformConv2dPack — the `dcn=dict(type='DCNv2')` form
    used inside backbones)."""
    features: int
    kernel_size: int = 3
    stride: int = 1
    padding: int = 1
    dilation: int = 1
    deform_groups: int = 1
    use_bias: bool = False
    dtype: Optional[Dtype] = None

    @nn.compact
    def __call__(self, x):
        from ..ops.deform_conv import modulated_deform_conv2d
        k = _pair(self.kernel_size)
        nk = k[0] * k[1] * self.deform_groups
        # conv_offset initialized to zero like mmcv (identity start)
        om = Conv(3 * nk, self.kernel_size, self.stride, self.padding,
                  self.dilation, use_bias=True, dtype=self.dtype,
                  name="conv_offset")(x)
        om = om.astype(jnp.float32)
        off, mask = om[..., :2 * nk], jax.nn.sigmoid(om[..., 2 * nk:])
        w = self.param("kernel", nn.initializers.he_normal(),
                       (k[0], k[1], x.shape[-1], self.features))
        b = (self.param("bias", nn.initializers.zeros, (self.features,))
             if self.use_bias else None)
        return modulated_deform_conv2d(x, off, mask, w.astype(x.dtype),
                                       stride=self.stride,
                                       padding=self.padding,
                                       dilation=self.dilation,
                                       deform_groups=self.deform_groups,
                                       bias=b)


def max_pool_3x3_s2(x):
    """torch MaxPool2d(kernel_size=3, stride=2, padding=1) on NHWC."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        [(0, 0), (1, 1), (1, 1), (0, 0)])


class NonLocal2d(nn.Module):
    """Embedded-gaussian non-local block (mmcv.cnn.NonLocal2d; consumed by
    BFP refine and backbone plugins, reference mmdet/models/necks/bfp.py).

    y = x + W_out( softmax(theta(x) phi(x)^T) g(x) ) over flattened HW —
    three 1x1 projections at C/2 plus one attention matmul.
    """
    in_channels: int
    reduction: int = 2
    use_scale: bool = True
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        b, h, w, c = x.shape
        inter = max(self.in_channels // self.reduction, 1)
        theta = nn.Conv(inter, (1, 1), dtype=self.dtype, name="theta")(x)
        phi = nn.Conv(inter, (1, 1), dtype=self.dtype, name="phi")(x)
        g = nn.Conv(inter, (1, 1), dtype=self.dtype, name="g")(x)
        q = theta.reshape(b, h * w, inter)
        k = phi.reshape(b, h * w, inter)
        v = g.reshape(b, h * w, inter)
        attn = jnp.einsum("bqc,bkc->bqk", q, k)
        if self.use_scale:
            attn = attn / jnp.sqrt(jnp.asarray(inter, attn.dtype))
        attn = jax.nn.softmax(attn, axis=-1)
        y = jnp.einsum("bqk,bkc->bqc", attn, v).reshape(b, h, w, inter)
        # conv_out is zero-init in mmcv (residual starts as identity)
        y = nn.Conv(self.in_channels, (1, 1), dtype=self.dtype,
                    kernel_init=nn.initializers.zeros, name="conv_out")(y)
        return x + y
