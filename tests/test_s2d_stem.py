"""Space-to-depth stem conv (models/layers.py _S2DStemConv): the 7x7/s2
ResNet stem reformulated as a 4x4/s1 conv on a 2x2 space-to-depth input.
Must be numerically equivalent to the plain conv (same param shape/path,
reference mmdet/models/backbones/resnet.py stem) and fall back cleanly on
odd extents.
"""
import jax
import jax.numpy as jnp
import numpy as np

from oadg_tpu import nn
from oadg_tpu.models.layers import Conv


def _ref_conv(x, kernel):
    ref = nn.Conv(kernel.shape[-1], (7, 7), strides=(2, 2),
                  padding=[(3, 3), (3, 3)], use_bias=False)
    return ref.apply({"params": {"kernel": kernel}}, x)


def test_s2d_stem_matches_plain_conv():
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(2, 64, 128, 3).astype(np.float32))
    m = Conv(64, 7, 2, 3, use_bias=False)
    v = m.init(jax.random.PRNGKey(0), x)
    kernel = v["params"]["Conv_0"]["kernel"]
    assert kernel.shape == (7, 7, 3, 64)          # checkpoint-compatible
    y = m.apply(v, x)
    y_ref = _ref_conv(x, kernel)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               atol=5e-6, rtol=1e-5)


def test_s2d_stem_gradients_match():
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(1, 32, 64, 3).astype(np.float32))
    m = Conv(16, 7, 2, 3, use_bias=False)
    v = m.init(jax.random.PRNGKey(0), x)

    def loss_s2d(params):
        return jnp.sum(m.apply(params, x) ** 2)

    def loss_ref(params):
        return jnp.sum(_ref_conv(x, params["params"]["Conv_0"]["kernel"])
                       ** 2)

    g1 = jax.grad(loss_s2d)(v)["params"]["Conv_0"]["kernel"]
    g2 = jax.grad(loss_ref)(v)["params"]["Conv_0"]["kernel"]
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                               atol=1e-3, rtol=1e-4)


def test_s2d_stem_odd_extent_fallback():
    x = jnp.zeros((1, 31, 64, 3), jnp.float32)    # odd H -> plain conv
    m = Conv(8, 7, 2, 3, use_bias=False)
    v = m.init(jax.random.PRNGKey(0), x)
    assert v["params"]["Conv_0"]["kernel"].shape == (7, 7, 3, 8)
    assert m.apply(v, x).shape == (1, 16, 32, 8)
