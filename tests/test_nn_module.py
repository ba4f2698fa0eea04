"""oadg_tpu.nn: parameter naming, rng streams, collections, remat,
intermediates and the standard layers against plain references."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from oadg_tpu import nn
from oadg_tpu.models.layers import FrozenBN
from oadg_tpu.utils.checkpoint import from_state_dict, to_state_dict


class Block(nn.Module):
    features: int

    @nn.compact
    def __call__(self, x):
        x = nn.Dense(self.features)(x)
        x = nn.Dense(self.features)(nn.relu(x))
        return x, jax.random.uniform(self.make_rng("noise"), (2,))


class Net(nn.Module):
    def setup(self):
        self.blocks = [Block(3), Block(2)]
        self.heads = {"a": nn.Dense(1), "b": nn.Dense(1)}
        self.norm = nn.LayerNorm()

    def __call__(self, x):
        x, r0 = self.blocks[0](x)
        x, r1 = self.blocks[1](x)
        y = self.heads["a"](self.norm(x)) + self.heads["b"](x)
        return y, r0, r1, self.make_rng("noise")


X = jnp.arange(8.0).reshape(2, 4)
RNGS = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}


def _paths(tree):
    return sorted(jax.tree_util.keystr(p)
                  for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0])


def test_param_tree_names_and_initial_values():
    """setup() names submodules after attributes (name_i in lists, name_key
    in dicts), compact methods as ClassName_i; initial values derive from
    the seed and the path only (pinned: checkpoints and converters rely on
    both)."""
    v = Net().init(RNGS, X)
    assert _paths(v) == sorted(
        f"['params']['{m}']['{leaf}']"
        for m in ("blocks_0']['Dense_0", "blocks_0']['Dense_1",
                  "blocks_1']['Dense_0", "blocks_1']['Dense_1",
                  "heads_a", "heads_b")
        for leaf in ("bias", "kernel")) + [
        "['params']['norm']['bias']", "['params']['norm']['scale']"]
    np.testing.assert_allclose(
        np.asarray(v["params"]["blocks_1"]["Dense_1"]["kernel"]).ravel(),
        [-0.6447741985321045, -0.29506269097328186, 0.010175411589443684,
         -1.252393364906311], rtol=1e-6)


def test_rng_streams_fold_in_path_and_call_count():
    v = Net().init(RNGS, X)
    _, r0, r1, key = Net().apply(v, X, rngs={"noise": jax.random.PRNGKey(5)})
    np.testing.assert_allclose(np.asarray(r0),
                               [0.3610492944717407, 0.04053974151611328],
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(r1),
                               [0.08913171291351318, 0.6781455278396606],
                               rtol=1e-6)
    assert np.asarray(key).tolist() == [1386675425, 2929474233]
    # an rng stream that was not given falls back to 'params'
    v2 = Net().init({"params": jax.random.PRNGKey(0)}, X)
    assert _paths(v2) == _paths(v)


def test_compact_child_called_twice_shares_its_parameters():
    class Twice(nn.Module):
        def setup(self):
            self.block = Block(4)

        def __call__(self, x):
            a, _ = self.block(x)
            b, _ = self.block(x)
            return a, b

    v = Twice().init(RNGS, X)
    assert set(v["params"]["block"]) == {"Dense_0", "Dense_1"}
    a, b = Twice().apply(v, X, rngs={"noise": jax.random.PRNGKey(0)})
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_duplicate_submodule_name_in_one_call_raises():
    class Dup(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(2, name="d")(x) + nn.Dense(2, name="d")(x)

    with pytest.raises(nn.ScopeError, match="used twice"):
        Dup().init(jax.random.PRNGKey(0), X)


def test_mutable_collections_and_live_batch_norm():
    bn = FrozenBN(frozen=False)
    x = jax.random.normal(jax.random.PRNGKey(0), (4, 3, 3, 2)) * 2 + 1
    v = bn.init(jax.random.PRNGKey(1), x)
    assert set(v) == {"params", "batch_stats"}
    y = bn.apply(v, x)                       # not mutable: moving stats
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=1e-5,
                               atol=1e-5)
    y, new = bn.apply(v, x, mutable=["batch_stats"])
    assert set(new) == {"batch_stats"}
    m = float(jnp.mean(x[..., 0]))
    np.testing.assert_allclose(float(new["batch_stats"]["mean"][0]),
                               0.1 * m, rtol=1e-5)
    # the input variables are not modified
    assert float(v["batch_stats"]["mean"][0]) == 0.0


def test_missing_and_immutable_variables_raise():
    d = nn.Dense(2)
    with pytest.raises(nn.ScopeError, match="missing"):
        d.apply({"params": {}}, X)

    class Counter(nn.Module):
        @nn.compact
        def __call__(self, x):
            n = self.variable("stats", "n", lambda: 0)
            n.value = n.value + 1
            return x

    with pytest.raises(nn.ScopeError, match="missing"):
        Counter().apply({}, X)
    with pytest.raises(nn.ScopeError, match="not mutable"):
        Counter().apply({"stats": {"n": 0}}, X)
    _, out = Counter().apply({"stats": {"n": 0}}, X, mutable="stats")
    assert out == {"stats": {"n": 1}}


def test_attributes_are_frozen_outside_setup():
    class Setter(nn.Module):
        @nn.compact
        def __call__(self, x):
            self.cache = x
            return x

    with pytest.raises(AttributeError, match="only in setup"):
        Setter().init(jax.random.PRNGKey(0), X)


def test_remat_keeps_parameters_and_gradients():
    plain, ckpt = Block, nn.remat(Block)

    def loss(cls, params):
        y, _ = cls(3, name="b").apply({"params": params}, X,
                                      rngs={"noise": jax.random.PRNGKey(0)})
        return jnp.sum(y ** 2)

    params = Block(3).init(RNGS, X)["params"]
    assert _paths(ckpt(3).init(RNGS, X)["params"]) == _paths(params)
    g_plain = jax.grad(lambda p: loss(plain, p))(params)
    g_ckpt = jax.grad(lambda p: loss(ckpt, p))(params)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6), g_plain,
        g_ckpt)


def test_remat_carries_mutable_state_out():
    class Live(nn.Module):
        @nn.compact
        def __call__(self, x):
            return FrozenBN(frozen=False)(x)

    x = jax.random.normal(jax.random.PRNGKey(0), (4, 2, 2, 3)) + 3.0
    v = Live().init(jax.random.PRNGKey(1), x)
    _, a = Live().apply(v, x, mutable=["batch_stats"])
    _, b = nn.remat(Live)().apply(v, x, mutable=["batch_stats"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)


def test_capture_intermediates_and_apply_methods():
    v = Net().init(RNGS, X)
    rngs = {"noise": jax.random.PRNGKey(5)}
    _, state = Net().apply(
        v, X, rngs=rngs, mutable=["intermediates"],
        capture_intermediates=lambda mdl, name: "blocks" in str(mdl.name))
    inter = state["intermediates"]
    assert set(inter) == {"blocks_0", "blocks_1"}
    assert len(inter["blocks_0"]["__call__"]) == 1
    ref = Net().apply(v, X, rngs=rngs)
    by_name = Net().apply(v, X, rngs=rngs, method="__call__")
    by_fn = Net().apply(v, X, rngs=rngs, method=lambda m, x: m(x))
    by_bound = Net().apply(v, X, rngs=rngs, method=Net().__call__)
    for out in (by_name, by_fn, by_bound):
        np.testing.assert_array_equal(np.asarray(out[1]), np.asarray(ref[1]))


def test_state_dict_round_trip_of_optimizer_state():
    params = {"w": jnp.ones((2, 3)), "b": [jnp.zeros(3), jnp.ones(1)]}
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    state = {"params": params, "opt_state": opt.init(params), "epoch": 3}
    flat = to_state_dict(state)
    assert set(flat["params"]["b"]) == {"0", "1"}
    back = from_state_dict(state, flat)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(state))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, state)


# ------------------------------------------------------------ layers ----

def _conv_ref(x, k, stride, pads, groups=1):
    return jax.lax.conv_general_dilated(
        x, k, stride, pads, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, precision="highest")


@pytest.mark.parametrize("padding,pads", [
    ("SAME", "SAME"), ("VALID", "VALID"), (1, [(1, 1), (1, 1)]),
    ([(2, 0), (0, 1)], [(2, 0), (0, 1)])])
def test_conv_padding_forms_match_lax(padding, pads):
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 9, 7, 4))
    conv = nn.Conv(6, (3, 3), strides=(2, 1), padding=padding,
                   feature_group_count=2)
    v = conv.init(jax.random.PRNGKey(1), x)
    k = v["params"]["kernel"]
    assert k.shape == (3, 3, 2, 6)
    want = _conv_ref(x, k, (2, 1), pads, groups=2) + v["params"]["bias"]
    np.testing.assert_allclose(np.asarray(conv.apply(v, x)),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_conv_transpose_doubles_resolution():
    x = jax.random.normal(jax.random.PRNGKey(0), (1, 5, 5, 3))
    m = nn.ConvTranspose(4, (2, 2), strides=(2, 2), padding="VALID")
    v = m.init(jax.random.PRNGKey(1), x)
    y = m.apply(v, x)
    assert y.shape == (1, 10, 10, 4) and v["params"]["kernel"].shape == (
        2, 2, 3, 4)
    # stride == window: every output pixel sees one input pixel through
    # one tap; lax.conv_transpose (transpose_kernel=False) takes the taps
    # in flipped order
    k = np.asarray(v["params"]["kernel"])
    for a in (0, 1):
        for b in (0, 1):
            want = np.einsum("bhwc,cf->bhwf", np.asarray(x), k[1 - a, 1 - b])
            np.testing.assert_allclose(
                np.asarray(y)[:, a::2, b::2],
                want + np.asarray(v["params"]["bias"]), rtol=1e-5, atol=1e-5)


def test_group_and_layer_norm_match_numpy():
    x = np.random.RandomState(0).randn(2, 4, 4, 8).astype(np.float32) * 3
    gn = nn.GroupNorm(num_groups=4)
    y = np.asarray(gn.apply(gn.init(jax.random.PRNGKey(0), x), x))
    g = x.reshape(2, 4, 4, 4, 2)
    ref = ((g - g.mean((1, 2, 4), keepdims=True))
           / np.sqrt(g.var((1, 2, 4), keepdims=True) + 1e-6)).reshape(x.shape)
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4)
    ln = nn.LayerNorm(epsilon=1e-5)
    y = np.asarray(ln.apply(ln.init(jax.random.PRNGKey(0), x), x))
    ref = (x - x.mean(-1, keepdims=True)) / np.sqrt(
        x.var(-1, keepdims=True) + 1e-5)
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4)


def test_attention_matches_explicit_softmax():
    rng = np.random.RandomState(0)
    q = rng.randn(2, 5, 8).astype(np.float32)
    kv = rng.randn(2, 7, 8).astype(np.float32)
    m = nn.MultiHeadDotProductAttention(num_heads=2)
    v = m.init(jax.random.PRNGKey(0), q, kv)
    p = jax.tree_util.tree_map(np.asarray, v["params"])
    assert p["query"]["kernel"].shape == (8, 2, 4)
    assert p["out"]["kernel"].shape == (2, 4, 8)
    proj = {n: np.einsum("bld,dhk->blhk", x, p[n]["kernel"]) + p[n]["bias"]
            for n, x in (("query", q), ("key", kv), ("value", kv))}
    s = np.einsum("bqhd,bkhd->bhqk", proj["query"] / 2.0, proj["key"])
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    o = np.einsum("bhqk,bkhd->bqhd", w, proj["value"])
    ref = np.einsum("bqhd,hdf->bqf", o, p["out"]["kernel"]) + p["out"]["bias"]
    np.testing.assert_allclose(np.asarray(m.apply(v, q, kv)), ref,
                               rtol=1e-4, atol=1e-4)


def test_pooling_counts_padding_as_zeros():
    x = jnp.ones((1, 4, 4, 1))
    avg = nn.avg_pool(x, (3, 3), (1, 1), ((1, 1), (1, 1)))
    assert float(avg[0, 0, 0, 0]) == pytest.approx(4 / 9)
    assert float(avg[0, 1, 1, 0]) == pytest.approx(1.0)
    mx = nn.max_pool(jnp.arange(16.0).reshape(1, 4, 4, 1), (2, 2), (2, 2))
    assert np.asarray(mx).ravel().tolist() == [5.0, 7.0, 13.0, 15.0]
