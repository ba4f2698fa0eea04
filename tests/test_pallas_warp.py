"""Row-shift warps (ops/row_warp.py) vs a numpy reference and cv2."""
import cv2
import numpy as np

import jax.numpy as jnp

from oadg_tpu.ops.row_warp import (shear_rows, warp_rotate, warp_shear_x,
                                   warp_translate)

RNG = np.random.RandomState(0)


def _shear_rows_numpy(img, shifts, fracs):
    """Per-pixel loop: out[y, x] = (1-f) img[y, x+s] + f img[y, x+s+1],
    reads outside the row give 0."""
    h, w, c = img.shape
    out = np.zeros_like(img, dtype=np.float64)
    for y in range(h):
        for x in range(w):
            for tap, wgt in ((0, 1.0 - fracs[y]), (1, fracs[y])):
                sx = x + shifts[y] + tap
                if 0 <= sx < w:
                    out[y, x] += wgt * img[y, sx]
    return out


def test_shear_rows_matches_xla_reference():
    h, w, c = 32, 256, 3
    img = RNG.rand(h, w, c).astype(np.float32) * 255
    shifts = RNG.randint(-20, 20, (h,)).astype(np.int32)
    fracs = RNG.rand(h).astype(np.float32)
    out = shear_rows(jnp.asarray(img), jnp.asarray(shifts),
                     jnp.asarray(fracs), max_shift=32)
    np.testing.assert_allclose(np.asarray(out),
                               _shear_rows_numpy(img, shifts, fracs),
                               rtol=1e-5, atol=1e-3)


def test_shear_rows_zero_shift_identity():
    h, w, c = 16, 128, 3
    img = jnp.asarray(RNG.rand(h, w, c).astype(np.float32))
    out = shear_rows(img, jnp.zeros(h, jnp.int32), jnp.zeros(h),
                     max_shift=8)
    np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-6)


def test_translate_matches_cv2():
    h, w = 40, 64
    img = RNG.randint(0, 255, (h, w, 3)).astype(np.float32)
    tx, ty = 7, -4
    # cv2 forward translate by (-tx, -ty) == inverse sample at (x+tx, y+ty)
    m = np.float32([[1, 0, -tx], [0, 1, -ty]])
    ref = cv2.warpAffine(img, m, (w, h))
    out = warp_translate(jnp.asarray(img), float(tx), float(ty),
                         max_shift=16)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-2)


def test_shear_x_matches_cv2():
    h, w = 48, 64
    img = RNG.randint(0, 255, (h, w, 3)).astype(np.float32)
    s, cy = 0.2, h / 2.0
    # cv2 form (augmix.py shear_x): M = [[1, -s, -tx],[0,1,0]], tx=-s*cy
    m = np.float32([[1, -s, s * cy], [0, 1, 0]])
    ref = cv2.warpAffine(img, m, (w, h))
    out = warp_shear_x(jnp.asarray(img), s, w / 2.0, cy, max_shift=24)
    diff = np.abs(np.asarray(out) - ref)
    # interior parity (borders differ by the interp tap convention)
    assert np.median(diff) < 1.0
    assert np.mean(diff < 3) > 0.97


def test_rotate_close_to_cv2():
    h, w = 64, 96
    img = cv2.GaussianBlur(
        RNG.randint(0, 255, (h, w, 3)).astype(np.float32), (5, 5), 2)
    deg = 12.0
    center = (w / 2.0, h / 2.0)
    m = cv2.getRotationMatrix2D(center, deg, 1.0)
    ref = cv2.warpAffine(img, m, (w, h))
    out = np.asarray(warp_rotate(jnp.asarray(img), jnp.deg2rad(deg),
                                 center[0], center[1],
                                 max_shift_x=40, max_shift_y=40))
    # compare interior region (3-shear borders differ)
    di = np.abs(out[12:-12, 12:-12] - ref[12:-12, 12:-12])
    assert np.median(di) < 4.0, np.median(di)
    assert np.mean(di < 12) > 0.9, np.mean(di < 12)
