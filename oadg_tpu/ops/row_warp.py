"""Separable affine warps for the OA-Mix background geometric ops.

The affine ops OA-Mix uses on the whole image (rotate <= 30deg,
shear <= 0.3, translate) decompose into per-row horizontal shifts:
shear_x/translate_x exactly, shear_y/translate_y via a transpose, and
rotation via the Paeth 3-shear factorization
R(t) = Shx(-tan(t/2)) . Shy(sin t) . Shx(-tan(t/2)).

``shear_rows`` is the per-row shift: each output row reads one contiguous,
shifted window of its input row, which XLA lowers to a gather along the
row axis.
"""
from __future__ import annotations

import jax.numpy as jnp


def shear_rows(img, shifts, fracs, max_shift: int):
    """Per-row horizontal shift with linear interpolation, zero border.

    out[y, x] = (1-f[y]) * img[y, x + s[y]] + f[y] * img[y, x + s[y] + 1]
    with reads outside [0, W) giving 0. ``shifts`` int32 (H,) in
    [-max_shift, max_shift]; ``fracs`` f32 (H,) in [0, 1). Computes and
    returns float32 whatever the input dtype.
    """
    img = img.astype(jnp.float32)
    h, w, c = img.shape
    pad = max_shift + 1
    img_p = jnp.pad(img, ((0, 0), (pad, pad), (0, 0)))
    base = jnp.clip(shifts + pad, 0, img_p.shape[1] - (w + 1))
    idx = base[:, None] + jnp.arange(w)[None, :]
    a = jnp.take_along_axis(img_p, idx[..., None], axis=1)
    b = jnp.take_along_axis(img_p, (idx + 1)[..., None], axis=1)
    f = fracs[:, None, None]
    return a * (1.0 - f) + b * f


def _row_shift_params(k1, k2, n_rows: int, max_shift: int):
    """Continuous per-row offset o(y) = k1*y + k2, split into int + frac."""
    y = jnp.arange(n_rows, dtype=jnp.float32)
    off = jnp.clip(k1 * y + k2, -max_shift, max_shift)
    s = jnp.floor(off)
    return s.astype(jnp.int32), off - s


def _along_y(fn, img, *args):
    """Apply a row-shift warp to the columns of ``img``."""
    return jnp.transpose(fn(jnp.transpose(img, (1, 0, 2)), *args), (1, 0, 2))


def warp_shear_x(img, s, cx, cy, max_shift: int):
    """cv2-form shear_x (augmix.py:115): inverse sx = x + s*(y - cy)."""
    shifts, fracs = _row_shift_params(s, -s * cy, img.shape[0], max_shift)
    return shear_rows(img, shifts, fracs, max_shift)


def warp_shear_y(img, s, cx, cy, max_shift: int):
    return _along_y(warp_shear_x, img, s, cy, cx, max_shift)


def warp_translate_x(img, tx, max_shift: int):
    shifts, fracs = _row_shift_params(0.0, tx, img.shape[0], max_shift)
    return shear_rows(img, shifts, fracs, max_shift)


def warp_translate_y(img, ty, max_shift: int):
    return _along_y(warp_translate_x, img, ty, max_shift)


def warp_translate(img, tx, ty, max_shift: int):
    return warp_translate_y(warp_translate_x(img, tx, max_shift), ty,
                            max_shift)


def warp_rotate(img, rad, cx, cy, max_shift_x: int, max_shift_y: int):
    """3-shear rotation about (cx, cy) (Paeth): three 1D resampling passes.
    For |rad| <= 30deg the shears are tan(rad/2) <= 0.27, sin(rad) <= 0.5."""
    a = -jnp.tan(rad / 2.0)
    b = jnp.sin(rad)
    out = warp_shear_x(img, a, cx, cy, max_shift_x)
    out = warp_shear_y(out, b, cx, cy, max_shift_y)
    return warp_shear_x(out, a, cx, cy, max_shift_x)
