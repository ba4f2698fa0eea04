"""hist256 (ops/photometric.py) — the equalize histogram: exact integer
counts against numpy's bincount."""
import numpy as np

import jax.numpy as jnp

from oadg_tpu.ops.photometric import hist256, image_hist256


def test_hist256_matches_bincount():
    rng = np.random.RandomState(0)
    x = rng.uniform(-5, 261, (313, 77)).astype(np.float32)
    h = np.asarray(hist256(jnp.asarray(x)))
    ref = np.bincount(
        np.trunc(np.clip(x.reshape(-1), 0, 255)).astype(np.int64),
        minlength=256)
    assert h.shape == (256,) and h.dtype == np.int32
    np.testing.assert_array_equal(h, ref)
    assert h.sum() == x.size
    img = rng.randint(0, 256, (40, 64, 3)).astype(np.float32)
    per_channel = np.asarray(image_hist256(jnp.asarray(img)))
    for ch in range(3):
        np.testing.assert_array_equal(
            per_channel[ch],
            np.bincount(img[..., ch].astype(np.int64).ravel(),
                        minlength=256))


def test_hist256_empty_bins_and_saturation():
    x = np.full((64, 64), 300.0, np.float32)       # all clip to 255
    h = np.asarray(hist256(jnp.asarray(x)))
    assert h[255] == 64 * 64 and h[:255].sum() == 0
