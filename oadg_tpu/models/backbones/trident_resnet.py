"""TridentNet ResNet (reference mmdet/models/backbones/trident_resnet.py):
the final stage becomes weight-shared multi-branch with per-branch
dilations (1, 2, 3). Here the branches are folded onto the batch
dimension (weights shared by construction), so the trident stage is one
dense conv per dilation on the shared input — no parameter duplication.

Train mode returns num_branch outputs stacked on batch; test mode (the
reference's ``test_branch_idx``) selects one branch.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import jax.numpy as jnp

from ... import nn
from ...utils.registry import BACKBONES
from ..layers import Conv, build_norm, norm_eval_cfg
from .resnet import ARCH, Bottleneck, ResNet


class TridentBottleneck(nn.Module):
    planes: int
    stride: int = 1
    dilations: Sequence[int] = (1, 2, 3)
    downsample: bool = False
    concat_output: bool = False
    norm_cfg: Optional[dict] = None
    dtype: Any = None

    @nn.compact
    def __call__(self, xs):
        """xs: list of per-branch inputs (same shapes)."""
        norm = build_norm(self.norm_cfg or dict(type="BN"), self.dtype)
        conv1 = Conv(self.planes, 1, 1, 0, use_bias=False, dtype=self.dtype,
                     name="conv1")
        conv3_kernel = self.param(
            "conv2_kernel", nn.initializers.he_normal(),
            (3, 3, self.planes, self.planes))
        conv3 = Conv(self.planes * 4, 1, 1, 0, use_bias=False,
                     dtype=self.dtype, name="conv3")
        n1 = norm()
        n2 = norm()
        n3 = norm()
        ds_conv = (Conv(self.planes * 4, 1, self.stride, 0, use_bias=False,
                        dtype=self.dtype, name="downsample_conv")
                   if self.downsample else None)
        ds_norm = norm() if self.downsample else None
        import jax.lax as lax
        outs = []
        for bi, x in enumerate(xs):
            d = self.dilations[bi]
            identity = x
            out = nn.relu(n1(conv1(x)))
            out = lax.conv_general_dilated(
                out, conv3_kernel.astype(out.dtype),
                (self.stride, self.stride), [(d, d), (d, d)],
                rhs_dilation=(d, d),
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
            out = nn.relu(n2(out))
            out = n3(conv3(out))
            if ds_conv is not None:
                identity = ds_norm(ds_conv(x))
            outs.append(nn.relu(out + identity))
        return outs


@BACKBONES.register_module()
class TridentResNet(nn.Module):
    """3-stage base ResNet + trident stage (reference trident_resnet.py:57).
    ``num_branch`` weight-shared branches with dilations (1,2,3); output is
    branch-concat on batch in train, single ``test_branch_idx`` in test."""
    depth: int = 50
    num_branch: int = 3
    test_branch_idx: int = 1
    trident_dilations: Sequence[int] = (1, 2, 3)
    num_stages: int = 3
    out_indices: Sequence[int] = (2,)
    strides: Sequence[int] = (1, 2, 2)
    dilations: Sequence[int] = (1, 1, 1)
    style: str = "caffe"
    frozen_stages: int = -1
    norm_cfg: Any = None
    norm_eval: bool = True
    init_cfg: Any = None
    pretrained: Any = None
    mode: str = "train"
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        from ..layers import max_pool_3x3_s2
        norm = build_norm(norm_eval_cfg(self.norm_cfg, self.norm_eval), self.dtype)
        x = Conv(64, 7, 2, 3, use_bias=False, dtype=self.dtype,
                 name="conv1")(x)
        x = norm()(x)
        x = nn.relu(x)
        x = max_pool_3x3_s2(x)
        _, stage_blocks = ARCH[self.depth]
        for i in range(self.num_stages):
            planes = 64 * 2 ** i
            for j in range(stage_blocks[i]):
                stride = self.strides[i] if j == 0 else 1
                ds = j == 0 and (stride != 1 or x.shape[-1] != planes * 4)
                x = Bottleneck(planes, stride, self.dilations[i], ds,
                               self.style, norm_eval_cfg(self.norm_cfg, self.norm_eval),
                               self.dtype, name=f"layer{i+1}_{j}")(x)
        # trident stage (stage 4)
        planes = 64 * 2 ** 3
        branches = [x] * self.num_branch
        for j in range(stage_blocks[3]):
            ds = j == 0
            last = j == stage_blocks[3] - 1
            branches = TridentBottleneck(
                planes, 2 if j == 0 else 1, self.trident_dilations, ds,
                last, norm_eval_cfg(self.norm_cfg, self.norm_eval), self.dtype,
                name=f"layer4_{j}")(branches)
        if self.mode == "train":
            out = jnp.concatenate(branches, axis=0)
        else:
            out = branches[self.test_branch_idx]
        return (out,)
