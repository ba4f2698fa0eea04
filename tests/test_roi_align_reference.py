"""Multi-level RoIAlign (ops/roi_align.py) against a per-roi numpy
bilinear reference (mmcv roi_align_cuda_kernel semantics: aligned=True,
sampling_ratio=2, FPN level mapping with finest_scale=56), forward and VJP.

The cases cover what the removed window kernels special-cased: mixed FPN
levels, extreme-aspect rois, rois wider than 32 cells of their level, and
levels smaller than 32x40; plus bf16 features with the f32 gradient table.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from oadg_tpu.ops.roi_align import roi_align_multilevel

OUT, SR, FINEST = 7, 2, 56


def _taps(f_h, f_w, y, x):
    """Bilinear taps [(row, col, weight)] of one sample point, or []."""
    if y <= -1.0 or y >= f_h or x <= -1.0 or x >= f_w:
        return []
    y, x = min(max(y, 0.0), f_h - 1), min(max(x, 0.0), f_w - 1)
    y0, x0 = int(math.floor(y)), int(math.floor(x))
    y1, x1 = min(y0 + 1, f_h - 1), min(x0 + 1, f_w - 1)
    ly, lx = y - y0, x - x0
    return [(y0, x0, (1 - ly) * (1 - lx)), (y0, x1, (1 - ly) * lx),
            (y1, x0, ly * (1 - lx)), (y1, x1, ly * lx)]


def _samples(rois, strides, shapes):
    """Per roi: its level and, per output bin, the taps of its samples."""
    out = []
    for b, x1, y1, x2, y2 in rois.astype(np.float64):
        scale = math.sqrt((x2 - x1) * (y2 - y1))
        lvl = int(np.clip(math.floor(math.log2(scale / FINEST + 1e-6)), 0,
                          len(strides) - 1))
        s = 1.0 / strides[lvl]
        f_h, f_w = shapes[lvl]
        rx1, ry1 = x1 * s - 0.5, y1 * s - 0.5
        bw, bh = (x2 * s - 0.5 - rx1) / OUT, (y2 * s - 0.5 - ry1) / OUT
        bins = {}
        for ph in range(OUT):
            for pw in range(OUT):
                taps = []
                for iy in range(SR):
                    for ix in range(SR):
                        taps += _taps(f_h, f_w,
                                      ry1 + (ph + (iy + 0.5) / SR) * bh,
                                      rx1 + (pw + (ix + 0.5) / SR) * bw)
                bins[ph, pw] = taps
        out.append((int(b), lvl, bins))
    return out


def ref_forward(feats, rois, strides):
    shapes = [f.shape[1:3] for f in feats]
    res = np.zeros((len(rois), OUT, OUT, feats[0].shape[-1]))
    for r, (b, lvl, bins) in enumerate(_samples(rois, strides, shapes)):
        f = feats[lvl][b].astype(np.float64)
        for (ph, pw), taps in bins.items():
            for y, x, wt in taps:
                res[r, ph, pw] += wt * f[y, x]
    return res / (SR * SR)


def ref_vjp(feats, rois, strides, g):
    shapes = [f.shape[1:3] for f in feats]
    grads = [np.zeros(f.shape, np.float64) for f in feats]
    for r, (b, lvl, bins) in enumerate(_samples(rois, strides, shapes)):
        for (ph, pw), taps in bins.items():
            for y, x, wt in taps:
                grads[lvl][b, y, x] += wt * g[r, ph, pw] / (SR * SR)
    return grads


def _case(name):
    rng = np.random.RandomState(11)
    if name == "mixed_levels":
        strides, hw = (4, 8, 16, 32), (256, 384)
        rois = [[0, 10, 12, 40, 44], [1, 5, 7, 150, 133], [0, 30, 20, 250,
                 240], [1, 0, 0, 383, 255], [0, 100, 60, 115, 70]]
    elif name == "extreme_aspect":
        strides, hw = (4, 8), (64, 96)
        rois = [[0, 0, 0, 370, 20], [1, 3, 0, 12, 250], [0, 1, 30, 95, 34]]
    elif name == "wide_rois":               # > 32 cells of their level
        strides, hw = (4, 8), (128, 512)
        rois = [[0, 8, 40, 308, 70], [1, 0, 90, 500, 112],
                [0, 20, 3, 60, 125]]
    else:                                   # "small_levels"
        strides, hw = (4, 8, 16, 32), (64, 96)
        rois = [[0, 5, 5, 30, 30], [1, 0, 0, 180, 170], [0, -5, 3, 90, 60],
                [1, 20, 10, 95, 63]]
    shapes = [(hw[0] // s, hw[1] // s) for s in strides]
    feats = [rng.rand(2, fh, fw, 8).astype(np.float32) for fh, fw in shapes]
    rois = np.asarray(rois, np.float32)
    g = rng.rand(len(rois), OUT, OUT, 8).astype(np.float32)
    return feats, rois, strides, g


CASES = ["mixed_levels", "extreme_aspect", "wide_rois", "small_levels"]


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_numpy(case):
    feats, rois, strides, _ = _case(case)
    got = roi_align_multilevel([jnp.asarray(f) for f in feats],
                               jnp.asarray(rois), OUT, strides, SR, FINEST)
    np.testing.assert_allclose(np.asarray(got),
                               ref_forward(feats, rois, strides),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_vjp_matches_numpy(case):
    feats, rois, strides, g = _case(case)
    _, vjp = jax.vjp(lambda fs: roi_align_multilevel(
        fs, jnp.asarray(rois), OUT, strides, SR, FINEST),
        [jnp.asarray(f) for f in feats])
    got = vjp(jnp.asarray(g))[0]
    for a, b in zip(got, ref_vjp(feats, rois, strides, g)):
        # the f32 sample coordinates are off by up to eps*|x| (~3e-5 cells
        # at x ~ 500), which moves each bilinear weight by as much
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5, atol=1e-5)


def test_bf16_features_f32_table():
    """bf16 features: the forward reads bf16 values, and the gradient is
    accumulated in f32 and rounded to bf16 once (within one bf16 rounding
    of the exact sum)."""
    feats, rois, strides, g = _case("mixed_levels")
    f16 = [jnp.asarray(f).astype(jnp.bfloat16) for f in feats]
    out, vjp = jax.vjp(lambda fs: roi_align_multilevel(
        fs, jnp.asarray(rois), OUT, strides, SR, FINEST), f16)
    want = ref_forward([np.asarray(f, np.float32) for f in f16], rois,
                       strides)
    np.testing.assert_allclose(np.asarray(out, np.float32), want,
                               rtol=2 ** -7, atol=2 ** -7)
    grads = vjp(jnp.asarray(g).astype(out.dtype))[0]
    for a, b in zip(grads, ref_vjp(feats, rois, strides,
                                   np.asarray(jnp.asarray(g).astype(
                                       out.dtype), np.float32))):
        assert a.dtype == jnp.bfloat16
        np.testing.assert_allclose(np.asarray(a, np.float32), b,
                                   rtol=2 ** -8, atol=1e-6)
