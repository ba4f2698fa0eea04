"""Bit-fidelity tests: jnp image ops vs PIL / cv2 golden outputs.

The reference runs its augmentation chain through Pillow and OpenCV on CPU
(mmdet/datasets/pipelines/augmix.py); our on-device kernels must match
within quantization tolerance (SURVEY.md §6 north star).
"""
import cv2
import numpy as np
import pytest
from PIL import Image, ImageEnhance, ImageOps

import jax.numpy as jnp

from oadg_tpu.ops import (autocontrast, enhance_brightness, enhance_color,
                          enhance_contrast, enhance_sharpness, equalize,
                          gaussian_blur, invert, posterize, resize_bilinear,
                          roi_align, rotation_matrix, solarize,
                          spectral_residual_saliency, warp_affine)

RNG = np.random.RandomState(42)
IMG = RNG.randint(0, 256, (40, 56, 3)).astype(np.uint8)
# a structured image (gradients) to exercise histogram paths
GX, GY = np.meshgrid(np.arange(56), np.arange(40))
IMG2 = np.stack([(GX * 4) % 256, (GY * 6) % 256, ((GX + GY) * 3) % 256],
                axis=-1).astype(np.uint8)


def to_j(img):
    return jnp.asarray(img, jnp.float32)


def assert_close_u8(ours, pil, tol=1):
    ours = np.asarray(ours).astype(np.int32)
    pil = np.asarray(pil).astype(np.int32)
    diff = np.abs(ours - pil)
    assert diff.max() <= tol, f"max diff {diff.max()} > {tol}"


@pytest.mark.parametrize("img", [IMG, IMG2])
def test_autocontrast_matches_pil(img):
    # tol=1: PIL truncates a float64 LUT ramp; at exact rational boundaries
    # (e.g. int(234 * (255/234))) double rounding lands one below the exact
    # value while float32 lands on it.
    ref = ImageOps.autocontrast(Image.fromarray(img))
    assert_close_u8(autocontrast(to_j(img)), ref, tol=1)


@pytest.mark.parametrize("img", [IMG, IMG2])
def test_equalize_matches_pil(img):
    ref = ImageOps.equalize(Image.fromarray(img))
    assert_close_u8(equalize(to_j(img)), ref, tol=0)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 7])
def test_posterize_matches_pil(bits):
    ref = ImageOps.posterize(Image.fromarray(IMG), bits)
    assert_close_u8(posterize(to_j(IMG), bits), ref, tol=0)


@pytest.mark.parametrize("thr", [1, 77, 128, 255])
def test_solarize_matches_pil(thr):
    ref = ImageOps.solarize(Image.fromarray(IMG), thr)
    assert_close_u8(solarize(to_j(IMG), thr), ref, tol=0)


def test_invert_matches_pil():
    ref = ImageOps.invert(Image.fromarray(IMG))
    assert_close_u8(invert(to_j(IMG)), ref, tol=0)


@pytest.mark.parametrize("factor", [0.1, 0.55, 1.0, 1.6, 1.9])
def test_enhance_ops_match_pil(factor):
    pil = Image.fromarray(IMG2)
    assert_close_u8(enhance_color(to_j(IMG2), factor),
                    ImageEnhance.Color(pil).enhance(factor), tol=1)
    assert_close_u8(enhance_contrast(to_j(IMG2), factor),
                    ImageEnhance.Contrast(pil).enhance(factor), tol=1)
    assert_close_u8(enhance_brightness(to_j(IMG2), factor),
                    ImageEnhance.Brightness(pil).enhance(factor), tol=1)
    assert_close_u8(enhance_sharpness(to_j(IMG2), factor),
                    ImageEnhance.Sharpness(pil).enhance(factor), tol=1)


@pytest.mark.parametrize("name", ["Color", "Contrast", "Brightness",
                                  "Sharpness"])
def test_enhance_blend_bit_exact_vs_pil(name):
    """Pillow rounds factor*(img - degenerate) before adding; the blend
    keeps that rounding even where the backend fuses the multiply-add, so
    at factors whose product is not exact in f32 the output is bit-equal
    to Pillow (a fused multiply-add moved ~0.4% of values by one level)."""
    ops = dict(Color=enhance_color, Contrast=enhance_contrast,
               Brightness=enhance_brightness, Sharpness=enhance_sharpness)
    img = np.random.RandomState(7).randint(3, 251, (96, 128, 3)).astype(
        np.uint8)
    for factor in (1.6, 1.7777777, 0.3):
        want = np.asarray(getattr(ImageEnhance, name)(
            Image.fromarray(img)).enhance(factor))
        got = np.asarray(ops[name](to_j(img), factor))
        np.testing.assert_array_equal(got, want.astype(np.float32),
                                      err_msg=f"{name} factor={factor}")


@pytest.mark.parametrize("angle,center", [(17.0, (28.0, 20.0)), (-30.0, (10.0, 5.0))])
def test_warp_rotate_matches_cv2(angle, center):
    m_cv = cv2.getRotationMatrix2D(center, angle, 1.0)
    ref = cv2.warpAffine(IMG, m_cv, (IMG.shape[1], IMG.shape[0]))
    ours = warp_affine(to_j(IMG), rotation_matrix(center, angle))
    ours = np.round(np.asarray(ours))
    diff = np.abs(ours - ref.astype(np.float64))
    # cv2 uses 5-bit fixed-point interp tables -> small differences allowed
    assert np.mean(diff <= 2) > 0.995
    assert np.median(diff) <= 1


@pytest.mark.parametrize("m", [
    np.float32([[1, -0.2, 3.0], [0, 1, 0]]),           # shear_x form
    np.float32([[1, 0, 0], [-0.15, 1, -2.0]]),         # shear_y form
    np.float32([[1, 0, -7], [0, 1, 4]]),               # translate
])
def test_warp_affine_matches_cv2(m):
    ref = cv2.warpAffine(IMG, m, (IMG.shape[1], IMG.shape[0]))
    ours = np.round(np.asarray(warp_affine(to_j(IMG), jnp.asarray(m))))
    diff = np.abs(ours - ref.astype(np.float64))
    assert np.mean(diff <= 2) > 0.995


@pytest.mark.parametrize("sigma", [1.0, 2.5, 4.0])
def test_gaussian_blur_matches_cv2(sigma):
    x = (RNG.rand(32, 48, 3) * 255).astype(np.float32)
    ref = cv2.GaussianBlur(x, (0, 0), sigmaX=sigma, sigmaY=sigma)
    ours = np.asarray(gaussian_blur(jnp.asarray(x), sigma))
    assert np.abs(ours - ref).max() < 0.25


def test_resize_bilinear_matches_cv2():
    x = (RNG.rand(16, 20, 3) * 255).astype(np.float32)
    ref = cv2.resize(x, (80, 64), interpolation=cv2.INTER_LINEAR)
    ours = np.asarray(resize_bilinear(jnp.asarray(x), 64, 80))
    assert np.abs(ours - ref).max() < 0.6


def _spectral_residual_np(gray64):
    """Straight numpy port of the OpenCV-contrib 4.6.0 algorithm for
    testing (log(mag+1), blur-then-square, divide-by-max — see
    oa_mix_host._spectral_saliency_map for the disassembly-pinned
    details)."""
    f = np.fft.fft2(gray64.astype(np.float64))
    mag, phase = np.abs(f), np.angle(f)
    log_amp = np.log1p(mag)
    pad = np.pad(log_amp, 1, mode="reflect")
    blur = sum(pad[i:i + 64, j:j + 64] for i in range(3) for j in range(3)) / 9.0
    sal = np.abs(np.fft.ifft2(np.exp(log_amp - blur) * np.exp(1j * phase)))
    k = cv2.getGaussianKernel(5, 8.0)
    sal = cv2.sepFilter2D(sal, -1, k, k)
    sal = sal * sal
    return sal / max(sal.max(), 1e-30)


def test_spectral_residual_matches_numpy_reference():
    gray = (RNG.rand(64, 64) * 255).astype(np.float32)
    ref = _spectral_residual_np(gray)
    ours = np.asarray(spectral_residual_saliency(jnp.asarray(gray)))
    assert np.abs(ours - ref).max() < 1e-3


def _roi_align_np(feat, rois, out, scale, sr):
    """Numpy re-derivation of aligned RoIAlign with static sampling grid."""
    b, h, w, c = feat.shape
    res = np.zeros((len(rois), out, out, c), np.float32)
    for r, roi in enumerate(rois):
        bi = int(roi[0])
        x1, y1, x2, y2 = [v * scale - 0.5 for v in roi[1:]]
        bw, bh = (x2 - x1) / out, (y2 - y1) / out
        for oy in range(out):
            for ox in range(out):
                acc = np.zeros(c, np.float32)
                for iy in range(sr):
                    for ix in range(sr):
                        y = y1 + (oy + (iy + 0.5) / sr) * bh
                        x = x1 + (ox + (ix + 0.5) / sr) * bw
                        if x <= -1 or x >= w or y <= -1 or y >= h:
                            continue
                        xx, yy = min(max(x, 0), w - 1), min(max(y, 0), h - 1)
                        x0, y0 = int(xx), int(yy)
                        x1i, y1i = min(x0 + 1, w - 1), min(y0 + 1, h - 1)
                        fx, fy = xx - x0, yy - y0
                        acc += ((feat[bi, y0, x0] * (1 - fx) + feat[bi, y0, x1i] * fx) * (1 - fy)
                                + (feat[bi, y1i, x0] * (1 - fx) + feat[bi, y1i, x1i] * fx) * fy)
                res[r, oy, ox] = acc / (sr * sr)
    return res


def test_roi_align_matches_reference():
    feat = RNG.rand(2, 16, 24, 8).astype(np.float32)
    rois = np.array([
        [0, 4.0, 4.0, 40.0, 28.0],
        [1, 0.0, 0.0, 90.0, 60.0],
        [0, 33.3, 7.7, 50.1, 20.9],
        [1, -4.0, -4.0, 10.0, 10.0],      # partially outside
    ], np.float32)
    ref = _roi_align_np(feat, rois, 7, 0.25, 2)
    ours = np.asarray(roi_align(jnp.asarray(feat), jnp.asarray(rois),
                                output_size=7, spatial_scale=0.25,
                                sampling_ratio=2, chunk=3))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_roi_align_grads_finite():
    import jax
    feat = jnp.asarray(RNG.rand(1, 8, 8, 4).astype(np.float32))
    rois = jnp.asarray([[0, 2.0, 2.0, 20.0, 20.0]], dtype=jnp.float32)

    def loss(f):
        return roi_align(f, rois, output_size=7, spatial_scale=0.25).sum()

    g = jax.grad(loss)(feat)
    assert np.isfinite(np.asarray(g)).all() and float(jnp.abs(g).sum()) > 0


def test_roi_align_multilevel_matches_single_level():
    from oadg_tpu.ops.roi_align import roi_align_multilevel
    rng = np.random.RandomState(1)
    feats = [jnp.asarray(rng.rand(2, 32 >> i, 48 >> i, 8).astype(np.float32))
             for i in range(4)]
    strides = (4, 8, 16, 32)
    # rois sized to map to each level (finest_scale=56)
    rois = np.array([
        [0, 10, 10, 40, 40],        # small -> level 0
        [1, 0, 0, 120, 100],        # -> level 1
        [0, 0, 0, 60, 300],         # -> level 2-ish
        [1, 0, 0, 190, 120],        # larger
    ], np.float32)
    out = np.asarray(roi_align_multilevel(feats, jnp.asarray(rois),
                                          output_size=7,
                                          featmap_strides=strides,
                                          sampling_ratio=2, chunk=3))
    # reference: explicit level mapping + single-level roi_align
    from oadg_tpu.ops.roi_align import map_roi_levels, roi_align
    lvls = np.asarray(map_roi_levels(jnp.asarray(rois), 4, 56))
    for i, roi in enumerate(rois):
        l = int(lvls[i])
        ref = np.asarray(roi_align(feats[l], jnp.asarray(roi[None]),
                                   output_size=7,
                                   spatial_scale=1.0 / strides[l],
                                   sampling_ratio=2, chunk=4))[0]
        np.testing.assert_allclose(out[i], ref, rtol=1e-4, atol=1e-5,
                                   err_msg=f"roi {i} level {l}")


def test_roi_align_multilevel_vjp_matches_autodiff():
    """The hand-written backward (one combined scatter-add over all 4
    bilinear taps) must equal autodiff through the chunked gather impl."""
    import jax
    from oadg_tpu.ops.roi_align import (_roi_align_multilevel_impl,
                                        roi_align_multilevel)
    rng = np.random.RandomState(7)
    feats = [jnp.asarray(rng.rand(2, 32 >> i, 48 >> i, 8).astype(np.float32))
             for i in range(4)]
    rois = jnp.asarray(np.array([
        [0, 10, 10, 40, 40],
        [1, 0, 0, 120, 100],
        [0, 0, 0, 60, 300],
        [1, -5, 3, 190, 120],
    ], np.float32))
    g_out = jnp.asarray(rng.rand(4, 7, 7, 8).astype(np.float32))

    def loss_custom(fs):
        return jnp.sum(roi_align_multilevel(fs, rois, 7, (4, 8, 16, 32),
                                            2, 56, chunk=3) * g_out)

    def loss_auto(fs):
        return jnp.sum(_roi_align_multilevel_impl(
            fs, rois, output_size=7, featmap_strides=(4, 8, 16, 32),
            sampling_ratio=2, finest_scale=56, chunk=3) * g_out)

    gc = jax.grad(loss_custom)(list(feats))
    ga = jax.grad(loss_auto)(list(feats))
    for a, b in zip(gc, ga):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=2e-6)


def test_roi_align_bf16_backward_close_to_f32():
    """With bf16 features the backward still accumulates in an f32 table
    and rounds once to bf16 at the end: it must equal the f32-feature
    gradient up to that one rounding."""
    import jax
    from oadg_tpu.ops.roi_align import roi_align_multilevel
    rng = np.random.RandomState(3)
    feats16 = [jnp.asarray(rng.rand(2, 32 >> i, 48 >> i, 8)
                           .astype(np.float32)).astype(jnp.bfloat16)
               for i in range(4)]
    rois = jnp.asarray(np.array([
        [0, 10, 10, 40, 40],
        [1, 0, 0, 120, 100],
        [0, 2, 3, 60, 50],
    ], np.float32))
    g_out = jnp.asarray(rng.rand(3, 7, 7, 8).astype(np.float32))

    def loss(fs):
        return jnp.sum(roi_align_multilevel(fs, rois, 7, (4, 8, 16, 32),
                                            2, 56, chunk=3) * g_out)

    g16 = jax.grad(loss)(list(feats16))
    g32 = jax.grad(jax.jit(loss))([f.astype(jnp.float32) for f in feats16])
    for a, b in zip(g16, g32):
        assert a.dtype == jnp.bfloat16
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        scale = max(np.abs(b).max(), 1e-3)
        assert np.max(np.abs(a - b)) / scale < 2e-2
        # one bf16 rounding of the f32 sum (the two sums may add in
        # different orders, so a value on a rounding edge may go either way)
        np.testing.assert_allclose(a, b, rtol=2 ** -8, atol=1e-6)
