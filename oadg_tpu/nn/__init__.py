"""The neural-network layer kit of the model zoo: modules with parameter
and state collections (:mod:`.module`), standard layers (:mod:`.layers`)
and the activations the heads use."""
from jax.nn import (gelu, leaky_relu, log_softmax, one_hot, relu, relu6,
                    sigmoid, silu, softmax)

from .layers import (Conv, ConvTranspose, Dense, GroupNorm, LayerNorm,
                     MultiHeadDotProductAttention, avg_pool, initializers,
                     max_pool)
from .module import Module, ScopeError, compact, remat
