"""Micro-bench: stem space-to-depth formulations on the device.

Times the s2d reshape+transpose feeding _S2DStemConv (layers.py) in
candidate forms. Candidates must be mathematically
identical stems (same 7x7/s2 result); we time transform+conv end to end.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
import jax
from oadg_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax.numpy as jnp
import numpy as np

B, H, W, F = 8, 1024, 2048, 64
x = jax.device_put(jnp.zeros((B, H, W, 3), jnp.bfloat16))
k7 = jax.device_put(jnp.asarray(
    np.random.RandomState(0).randn(7, 7, 3, F) * 0.05, jnp.bfloat16))


def k_s2d(kern):
    kp = jnp.pad(kern, ((1, 0), (1, 0), (0, 0), (0, 0)))
    k2 = kp.reshape(4, 2, 4, 2, 3, F).transpose(0, 2, 1, 3, 4, 5)
    return k2.reshape(4, 4, 12, F)


def conv(x2, k2, cin):
    return jax.lax.conv_general_dilated(
        x2, k2, window_strides=(1, 1), padding=((2, 1), (2, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def v_current(x, kern):
    k2 = k_s2d(kern)
    x2 = x.reshape(B, H // 2, 2, W // 2, 2, 3)
    x2 = x2.transpose(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 12)
    return conv(x2, k2, 12)


def v_two_conv(x, kern):
    # rows split even/odd; each row pair contributes via its own 6-channel
    # kernel half. (p,q,c) channel order inside each half: q in row-pairs.
    k2 = k_s2d(kern)                       # (4,4,12,F), ch = p*6 + q*3 + c
    k_even, k_odd = k2[:, :, :6], k2[:, :, 6:]
    xe = x[:, 0::2].reshape(B, H // 2, W // 2, 6)
    xo = x[:, 1::2].reshape(B, H // 2, W // 2, 6)
    return conv(xe, k_even, 6) + conv(xo, k_odd, 6)


def v_slices(x, kern):
    k2 = k_s2d(kern)
    parts = [x[:, p::2, q::2, :] for p in (0, 1) for q in (0, 1)]
    x2 = jnp.concatenate(parts, axis=-1)   # ch = (p,q,c) like k_s2d
    return conv(x2, k2, 12)


def v_wfold(x, kern):
    # Fold only W into channels: (B,H,W,3)->(B,H,W/2,6) is a FREE reshape
    # (adjacent w pairs are contiguous in NHWC); H stays a stride-2 conv
    # axis. 7*4*6=168 MACs/out vs full-s2d 4*4*12=192, zero relayout.
    kp = jnp.pad(kern, ((0, 0), (1, 0), (0, 0), (0, 0)))   # (7,8,3,F)
    k2 = kp.reshape(7, 4, 2, 3, F).reshape(7, 4, 6, F)
    x2 = x.reshape(B, H, W // 2, 6)
    return jax.lax.conv_general_dilated(
        x2, k2, window_strides=(2, 1), padding=((3, 3), (2, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def v_plain(x, kern):
    return jax.lax.conv_general_dilated(
        x, kern, window_strides=(2, 2), padding=((3, 3), (3, 3)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def bench(name, fn):
    f = jax.jit(fn)
    y = f(x, k7)
    _ = np.asarray(y[0, 0, 0, :2])         # sync
    t0 = time.perf_counter()
    for _ in range(10):
        y = f(x, k7)
    _ = np.asarray(y[0, 0, 0, :2])
    dt = (time.perf_counter() - t0) / 10
    print(f"{name:12s} {dt*1e3:8.2f} ms  out={y.shape}")
    return y


ys = {}
for name, fn in (("current", v_current), ("two_conv", v_two_conv),
                 ("slices", v_slices), ("wfold", v_wfold),
                 ("plain7x7", v_plain)):
    ys[name] = bench(name, fn)

ref = np.asarray(ys["plain7x7"], np.float32)
for name in ("current", "two_conv", "slices", "wfold"):
    err = np.abs(np.asarray(ys[name], np.float32) - ref).max()
    print(f"{name} vs plain max err: {err}")
