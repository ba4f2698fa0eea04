"""HRNet backbone (reference mmdet/models/backbones/hrnet.py): parallel
multi-resolution branches with repeated cross-resolution fusion.

Config schema matches the reference's ``extra`` dict (stage1..stage4 with
num_modules/num_branches/block/num_blocks/num_channels). Upsampling in the
fusion layers is nearest-neighbor (reference uses
F.interpolate(mode='nearest')); NHWC throughout.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import jax.numpy as jnp

from ... import nn
from ...utils.registry import BACKBONES
from ..layers import Conv, build_norm, norm_eval_cfg
from .resnet import BasicBlock, Bottleneck

BLOCKS = {"BASIC": (BasicBlock, 1), "BOTTLENECK": (Bottleneck, 4)}


def _upsample_nearest(x, scale):
    b, h, w, c = x.shape
    x = jnp.repeat(x, scale, axis=1)
    return jnp.repeat(x, scale, axis=2)


class HRModule(nn.Module):
    num_branches: int
    block: str
    num_blocks: Sequence[int]
    num_channels: Sequence[int]
    multiscale_output: bool = True
    norm_cfg: Optional[dict] = None
    dtype: Any = None

    @nn.compact
    def __call__(self, xs):
        block, exp = BLOCKS[self.block]
        norm = build_norm(self.norm_cfg or dict(type="BN"), self.dtype)
        # per-branch residual blocks
        outs = []
        for bi in range(self.num_branches):
            x = xs[bi]
            planes = self.num_channels[bi]
            for j in range(self.num_blocks[bi]):
                ds = (j == 0 and x.shape[-1] != planes * exp)
                x = block(planes, 1, 1, ds,
                          "pytorch", self.norm_cfg or dict(type="BN"),
                          self.dtype, name=f"branch{bi}_block{j}")(x)
            outs.append(x)
        # fusion: every output branch sums contributions from every input
        n_out = self.num_branches if self.multiscale_output else 1
        fused = []
        for i in range(n_out):
            acc = None
            for j in range(self.num_branches):
                y = outs[j]
                if j > i:       # upsample j -> i: 1x1 conv + nearest
                    y = Conv(self.num_channels[i] * exp, 1, 1, 0,
                             use_bias=False, dtype=self.dtype,
                             name=f"fuse{i}_{j}_conv")(y)
                    y = norm()(y)
                    y = _upsample_nearest(y, 2 ** (j - i))
                elif j < i:     # downsample j -> i: chain of 3x3 s2 convs
                    for k in range(i - j):
                        last = k == i - j - 1
                        ch = (self.num_channels[i] * exp if last
                              else self.num_channels[j] * exp)
                        y = Conv(ch, 3, 2, 1, use_bias=False,
                                 dtype=self.dtype,
                                 name=f"fuse{i}_{j}_down{k}")(y)
                        y = norm()(y)
                        if not last:
                            y = nn.relu(y)
                acc = y if acc is None else acc + y
            fused.append(nn.relu(acc))
        return fused


@BACKBONES.register_module()
class HRNet(nn.Module):
    extra: Any = None
    in_channels: int = 3
    norm_cfg: Any = None
    norm_eval: bool = True
    frozen_stages: int = -1
    init_cfg: Any = None
    pretrained: Any = None
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        extra = dict(self.extra or {})
        norm = build_norm(norm_eval_cfg(self.norm_cfg, self.norm_eval), self.dtype)
        # stem: two stride-2 convs
        for i in range(2):
            x = Conv(64, 3, 2, 1, use_bias=False, dtype=self.dtype,
                     name=f"stem_conv{i+1}")(x)
            x = norm()(x)
            x = nn.relu(x)
        # stage 1
        s1 = dict(extra.get("stage1", dict(num_modules=1, num_branches=1,
                                           block="BOTTLENECK",
                                           num_blocks=(4,),
                                           num_channels=(64,))))
        block, exp = BLOCKS[s1["block"]]
        planes = s1["num_channels"][0]
        for j in range(s1["num_blocks"][0]):
            ds = (j == 0 and x.shape[-1] != planes * exp)
            x = block(planes, 1, 1, ds, "pytorch",
                      norm_eval_cfg(self.norm_cfg, self.norm_eval), self.dtype,
                      name=f"layer1_{j}")(x)
        xs = [x]
        prev_channels = [planes * exp]
        # stages 2..4 with transitions
        for si in (2, 3, 4):
            scfg = dict(extra[f"stage{si}"])
            blk, exp_s = BLOCKS[scfg["block"]]
            tgt = [c * exp_s for c in scfg["num_channels"]]
            nb = scfg["num_branches"]
            # transition: adapt existing branches, create new by downsample
            new_xs = []
            for bi in range(nb):
                if bi < len(xs):
                    y = xs[bi]
                    if y.shape[-1] != tgt[bi]:
                        y = Conv(tgt[bi], 3, 1, 1, use_bias=False,
                                 dtype=self.dtype,
                                 name=f"trans{si}_{bi}")(y)
                        y = norm()(y)
                        y = nn.relu(y)
                else:
                    y = xs[-1]
                    y = Conv(tgt[bi], 3, 2, 1, use_bias=False,
                             dtype=self.dtype, name=f"trans{si}_{bi}")(y)
                    y = norm()(y)
                    y = nn.relu(y)
                new_xs.append(y)
            xs = new_xs
            for mi in range(scfg["num_modules"]):
                ms = (scfg.get("multiscale_output", True)
                      or mi < scfg["num_modules"] - 1 or si < 4)
                xs = HRModule(nb, scfg["block"], scfg["num_blocks"],
                              scfg["num_channels"], ms,
                              norm_eval_cfg(self.norm_cfg, self.norm_eval),
                              self.dtype, name=f"stage{si}_module{mi}")(xs)
        return tuple(xs)
