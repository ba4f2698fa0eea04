"""Standard layers: dense, convolution, normalization, attention, pooling.

Channels-last. Parameter names, shapes and default initializers follow
flax.linen's layers of the same name, so parameter trees and converted
checkpoints keep their layout. Parameters are float32; with ``dtype=None``
a layer computes in the common dtype of its input and its parameters.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .module import Module, compact

initializers = jax.nn.initializers
default_kernel_init = initializers.lecun_normal()

Dtype = Any
PaddingLike = Union[str, int, Sequence[Union[int, Tuple[int, int]]]]


def _common_dtype(*args, dtype=None):
    """``dtype``, or the common floating dtype of ``args`` (None skipped)."""
    if dtype is None:
        dtype = jnp.result_type(*[jnp.asarray(x) for x in args
                                  if x is not None])
        if not jnp.issubdtype(dtype, jnp.inexact):
            dtype = jnp.promote_types(jnp.float32, dtype)
    return dtype


def promote_dtype(*args, dtype=None):
    """Cast ``args`` (None passes through) to :func:`_common_dtype`."""
    dtype = _common_dtype(*args, dtype=dtype)
    return [None if x is None else jnp.asarray(x, dtype) for x in args]


def _bias(y, bias):
    return y if bias is None else y + jnp.reshape(
        bias, (1,) * (y.ndim - 1) + (-1,))


class Dense(Module):
    """``x @ kernel + bias`` over the last axis; kernel (in, features)."""
    features: int
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            (jnp.shape(x)[-1], self.features), jnp.float32)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           jnp.float32) if self.use_bias else None)
        x, kernel, bias = promote_dtype(x, kernel, bias, dtype=self.dtype)
        return _bias(lax.dot_general(x, kernel,
                                     (((x.ndim - 1,), (0,)), ((), ()))), bias)


class _DenseGeneral(Module):
    """A dense map from the ``axis`` dims of ``x`` to ``features`` dims;
    kernel ``x.shape[axis] + features``, initialized as its 2-D flattening
    (attention's projections)."""
    features: Tuple[int, ...]
    axis: Tuple[int, ...] = (-1,)
    dtype: Optional[Dtype] = None

    @compact
    def __call__(self, x):
        axis = tuple(sorted(a % x.ndim for a in self.axis))
        n_in = len(axis)

        def kernel_init(rng, shape, dtype):
            flat = (int(np.prod(shape[:n_in])), int(np.prod(shape[n_in:])))
            return jnp.reshape(default_kernel_init(rng, flat, dtype), shape)

        kernel = self.param("kernel", kernel_init,
                            tuple(x.shape[a] for a in axis) + self.features,
                            jnp.float32)
        bias = self.param("bias", initializers.zeros, self.features,
                          jnp.float32)
        x, kernel, bias = promote_dtype(x, kernel, bias, dtype=self.dtype)
        y = lax.dot_general(x, kernel, ((axis, tuple(range(n_in))), ((), ())))
        return y + jnp.reshape(bias, (1,) * (x.ndim - n_in) + self.features)


def _padding(padding: PaddingLike, rank: int):
    if isinstance(padding, str):
        return padding
    if isinstance(padding, int):
        return [(padding, padding)] * rank
    pads = [(p, p) if isinstance(p, int) else tuple(p) for p in padding]
    if len(pads) != rank or any(len(p) != 2 for p in pads):
        raise ValueError(f"invalid padding {padding!r} for {rank} spatial "
                         "dims")
    return pads


class Conv(Module):
    """2-d convolution on NHWC input; kernel (kh, kw, in // groups,
    features)."""
    features: int
    kernel_size: Sequence[int]
    strides: Union[int, Sequence[int]] = 1
    padding: PaddingLike = "SAME"
    kernel_dilation: Union[int, Sequence[int]] = 1
    feature_group_count: int = 1
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        ks = tuple(self.kernel_size)

        def per_dim(v):
            return (v,) * len(ks) if isinstance(v, int) else tuple(v)

        cin = x.shape[-1]
        if cin % self.feature_group_count:
            raise ValueError(f"{self.feature_group_count} groups do not "
                             f"divide {cin} input channels")
        kernel = self.param(
            "kernel", self.kernel_init,
            ks + (cin // self.feature_group_count, self.features),
            jnp.float32)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           jnp.float32) if self.use_bias else None)
        x, kernel, bias = promote_dtype(x, kernel, bias, dtype=self.dtype)
        y = lax.conv_general_dilated(
            x, kernel, per_dim(self.strides), _padding(self.padding, len(ks)),
            rhs_dilation=per_dim(self.kernel_dilation),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=self.feature_group_count)
        return _bias(y, bias)


class ConvTranspose(Module):
    """Transposed 2-d convolution (``lax.conv_transpose``) on NHWC input;
    kernel (kh, kw, in, features)."""
    features: int
    kernel_size: Sequence[int]
    strides: Sequence[int] = (1, 1)
    padding: PaddingLike = "SAME"
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        ks = tuple(self.kernel_size)
        kernel = self.param("kernel", self.kernel_init,
                            ks + (x.shape[-1], self.features), jnp.float32)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           jnp.float32) if self.use_bias else None)
        x, kernel, bias = promote_dtype(x, kernel, bias, dtype=self.dtype)
        y = lax.conv_transpose(x, kernel, tuple(self.strides),
                               _padding(self.padding, len(ks)),
                               dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return _bias(y, bias)


def _stats(x, axes, dtype):
    """Mean and variance of ``x`` over ``axes`` in at least float32, the
    variance as E[x^2] - E[x]^2 clipped at zero."""
    x = jnp.asarray(x, jnp.promote_types(dtype or jnp.result_type(x),
                                         jnp.float32))
    mean = x.mean(axes)
    return mean, jnp.maximum(0.0, lax.square(x).mean(axes) - lax.square(mean))


def _normalize(mdl: Module, x, mean, var, epsilon, dtype):
    """``(x - mean) / sqrt(var + epsilon) * scale + bias`` with
    per-channel ``scale`` and ``bias`` params."""
    c = x.shape[-1]
    scale = mdl.param("scale", initializers.ones, (c,), jnp.float32)
    bias = mdl.param("bias", initializers.zeros, (c,), jnp.float32)
    y = (x - mean) * (lax.rsqrt(var + epsilon) * scale) + bias
    return jnp.asarray(y, _common_dtype(x, scale, bias, dtype=dtype))


class LayerNorm(Module):
    """Normalize over the last axis, with a learned per-feature scale and
    bias."""
    epsilon: float = 1e-6
    dtype: Optional[Dtype] = None

    @compact
    def __call__(self, x):
        mean, var = _stats(x, (x.ndim - 1,), self.dtype)
        return _normalize(self, x, mean[..., None], var[..., None],
                          self.epsilon, self.dtype)


class GroupNorm(Module):
    """Normalize each of ``num_groups`` channel groups over the spatial
    axes, with a learned per-channel scale and bias."""
    num_groups: int = 32
    epsilon: float = 1e-6
    dtype: Optional[Dtype] = None

    @compact
    def __call__(self, x):
        c, g = x.shape[-1], self.num_groups
        if g <= 0 or c % g:
            raise ValueError(f"{g} groups do not divide {c} channels")
        spatial = tuple(range(1, x.ndim - 1))
        mean, var = _stats(x.reshape(x.shape[:-1] + (g, c // g)),
                           spatial + (x.ndim,), self.dtype)
        mean, var = (jnp.expand_dims(jnp.repeat(m, c // g, axis=-1), spatial)
                     for m in (mean, var))
        return _normalize(self, x, mean, var, self.epsilon, self.dtype)


class MultiHeadDotProductAttention(Module):
    """Multi-head attention: ``query``/``key``/``value`` projections to
    (heads, depth), softmax(q k^T / sqrt(depth)) v, ``out`` projection back
    to the query's width."""
    num_heads: int
    dtype: Optional[Dtype] = None
    qkv_features: Optional[int] = None

    @compact
    def __call__(self, inputs_q, inputs_k=None, inputs_v=None):
        inputs_k = inputs_q if inputs_k is None else inputs_k
        inputs_v = inputs_k if inputs_v is None else inputs_v
        qkv = self.qkv_features or inputs_q.shape[-1]
        if qkv % self.num_heads:
            raise ValueError(f"{self.num_heads} heads do not divide {qkv}")
        heads = (self.num_heads, qkv // self.num_heads)
        q, k, v = (_DenseGeneral(heads, dtype=self.dtype, name=n)(x)
                   for n, x in (("query", inputs_q), ("key", inputs_k),
                                ("value", inputs_v)))
        q, k, v = promote_dtype(q, k, v, dtype=self.dtype)
        dtype = q.dtype
        q = q / jnp.sqrt(q.shape[-1]).astype(dtype)
        w = jax.nn.softmax(jnp.einsum("...qhd,...khd->...hqk", q, k))
        x = jnp.einsum("...hqk,...khd->...qhd", w.astype(dtype), v)
        return _DenseGeneral((inputs_q.shape[-1],), axis=(-2, -1),
                             dtype=self.dtype, name="out")(x)


def _pool(x, init, reduce_fn, window_shape, strides, padding):
    """``reduce_window`` over the spatial axes of NHWC ``x``."""
    window_shape = tuple(window_shape)
    strides = tuple(strides or (1,) * len(window_shape))
    if not isinstance(padding, str):
        padding = ((0, 0),) + tuple(map(tuple, padding)) + ((0, 0),)
    return lax.reduce_window(x, init, reduce_fn, (1,) + window_shape + (1,),
                             (1,) + strides + (1,), padding)


def avg_pool(x, window_shape, strides=None, padding="VALID"):
    """Mean over windows; padded cells count as zeros."""
    return _pool(x, 0.0, lax.add, window_shape, strides,
                 padding) / np.prod(window_shape)


def max_pool(x, window_shape, strides=None, padding="VALID"):
    return _pool(x, -jnp.inf, lax.max, window_shape, strides, padding)
