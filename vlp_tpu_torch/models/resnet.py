"""ResNet-18/34/50 (counterpart of ``vlp_tpu/models/resnet.py``).

NHWC images at the public functions, as in the JAX package; inside, the
backbone runs on the NCHW view of that layout (``permute(0, 3, 1, 2)``, a
channels-last tensor), so cuDNN takes its channels-last convolutions and no
transpose is ever copied. Convolutions in the compute dtype (bf16) with
fp32 parameters cast at each call, as flax's ``nn.Conv(dtype=...)`` does,
and no bias; ``BatchNorm`` (``models/vit.py``) keeps fp32 statistics and
computes in ``norm_dtype`` (``trainer.bn_dtype``). The convolutions and
BatchNorm were XLA outside Pallas in the JAX package and are
``F.conv2d`` and plain PyTorch here: this path has no kernel of its own.

Stems: ``conv7`` (7x7/2, pad 3) and ``s2d`` (2x2 space-to-depth, then a
4x4/1 conv padded (2, 1) on each axis, which ``F.pad`` writes out since a
conv's own padding is symmetric). Then BatchNorm, ReLU, a 3x3/2 max pool
padded with -inf, the stages (``stages.{i}.{j}``, flax
``stage{i}_block{j}``) and an fp32 global mean (``forward_features``).
``forward_head`` is the identity: the reference's head applies dropout and
a class layer that no caller turns on (``num_classes=0``, dropout 0: the
JAX registry passes the dual tower's ``image_dropout`` to no backbone; the
task's 1-logit head sits outside the backbone). A module's mode decides
between batch and running statistics, as flax's ``train=`` does; the task
sets it (``models/tasks.py``).

Under tensor parallelism (``parallel/tp.py``) a block whose 3x3 conv2 the
JAX rule shards (stages 2-4) splits over the model ranks: a
``BasicBlock``'s conv1 by output channels, BN1 and ReLU on them, conv2 by
input channels; a ``Bottleneck``'s conv2 by output channels, BN2 and ReLU
on them, conv3 by input channels, conv1 whole. The shortcut's 1x1 conv,
where the rule shards it, takes this rank's input channels. The last
conv's partial sums and the shortcut's are summed over the model ranks in
one all-reduce before their BatchNorms and the residual.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from vlp_tpu_torch.models.vit import BatchNorm
from vlp_tpu_torch.parallel.collectives import (copy_to_model,
                                                reduce_from_model)
from vlp_tpu_torch.parallel import tp


def _conv(in_dim: int, out_dim: int, kernel: int, stride: int,
          device: Optional[torch.device], padding: Optional[int] = None
          ) -> nn.Conv2d:
    """Bias-free conv with flax ``_conv``'s symmetric padding
    ``(kernel - 1) // 2`` unless ``padding`` is given."""
    pad = (kernel - 1) // 2 if padding is None else padding
    return nn.Conv2d(in_dim, out_dim, kernel, stride=stride, padding=pad,
                     bias=False, device=device)


def conv(x: torch.Tensor, module: nn.Conv2d) -> torch.Tensor:
    """``module`` on NCHW ``x`` in x's dtype, the weight cast to it in the
    channels-last layout that x has."""
    w = module.weight.to(x.dtype, memory_format=torch.channels_last)
    return F.conv2d(x, w, None, module.stride, module.padding)


def _split_block_(block: nn.Module, mesh, i: int) -> Dict:
    """Splits ``block`` where it splits (``tp.conv_splits`` of its 3x3
    conv2): conv<i> by output channels with bn<i> (its running statistics
    too), conv<i + 1> by input channels, and the shortcut conv by input
    channels where it splits too; else nothing."""
    if not tp.conv_splits(block.conv2, block.conv2.weight.shape[0], mesh):
        return {}
    block.tp_mesh = mesh
    bn = getattr(block, f"bn{i}")
    out = {f"conv{i}.weight": tp.split_(getattr(block, f"conv{i}"),
                                        "weight", mesh, 0),
           **{f"bn{i}.{n}": tp.split_(bn, n, mesh, 0)
              for n in ("weight", "bias", "running_mean", "running_var")},
           f"conv{i + 1}.weight": tp.split_(getattr(block, f"conv{i + 1}"),
                                            "weight", mesh, 1)}
    ds = getattr(block, "ds_conv", None)
    block.ds_split = ds is not None and tp.conv_splits(
        ds, ds.weight.shape[1], mesh)
    if block.ds_split:
        out["ds_conv.weight"] = tp.split_(ds, "weight", mesh, 1)
    return out


def _tail(block: nn.Module, x: torch.Tensor, xs: torch.Tensor,
          y: torch.Tensor, bn: BatchNorm) -> torch.Tensor:
    """A block's end: the last conv's output ``y``, then ``bn``, the
    shortcut, the residual and ReLU. In a split block ``y`` is a partial
    sum, summed over the model ranks before ``bn``; where the shortcut
    conv is split too, with its partial sums on this rank's channels of
    ``xs`` (x after ``copy_to_model``), in one all-reduce. The sum runs on
    the NHWC view, which the channels-last maps have; unsplit it is the
    identity."""
    dt, nt, mesh = block.dtype, block.norm_dtype, block.tp_mesh
    parts = [y.permute(0, 2, 3, 1)]
    if block.ds_split:
        c = xs.shape[1] // mesh.model_world
        r = mesh.model_rank
        parts.append(conv(xs[:, r * c:(r + 1) * c], block.ds_conv).permute(
            0, 2, 3, 1))
    summed = reduce_from_model(parts[0] if len(parts) == 1
                               else torch.cat(parts, -1), mesh).permute(
                                   0, 3, 1, 2)
    n = y.shape[1]
    y = bn(summed[:, :n].to(nt))
    if block.ds_split:
        residual = block.ds_bn(summed[:, n:].to(nt))
    elif hasattr(block, "ds_conv"):
        residual = block.ds_bn(conv(x, block.ds_conv).to(nt))
    else:
        residual = x
    return F.relu((y + residual).to(dt))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_dim: int, filters: int, stride: int,
                 downsample: bool, dtype: torch.dtype,
                 norm_dtype: torch.dtype,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.dtype, self.norm_dtype = dtype, norm_dtype
        self.conv1 = _conv(in_dim, filters, 3, stride, device)
        self.bn1 = BatchNorm(filters, norm_dtype, device)
        self.conv2 = _conv(filters, filters, 3, 1, device)
        self.bn2 = BatchNorm(filters, norm_dtype, device)
        if downsample:
            self.ds_conv = _conv(in_dim, filters, 1, stride, device)
            self.ds_bn = BatchNorm(filters, norm_dtype, device)
        self.tp_mesh, self.ds_split = None, False

    def tp_split_(self, mesh) -> Dict:
        """conv1 by output channels with BN1, conv2 by input channels."""
        return _split_block_(self, mesh, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, nt = self.dtype, self.norm_dtype
        xs = copy_to_model(x, self.tp_mesh)
        y = F.relu(self.bn1(conv(xs, self.conv1).to(nt)).to(dt))
        return _tail(self, x, xs, conv(y, self.conv2), self.bn2)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_dim: int, filters: int, stride: int,
                 downsample: bool, dtype: torch.dtype,
                 norm_dtype: torch.dtype,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.dtype, self.norm_dtype = dtype, norm_dtype
        out_dim = filters * self.expansion
        # bn1 and bn2 take an fp32 input whatever norm_dtype is, as the
        # reference casts it (the statistics are fp32 either way)
        self.conv1 = _conv(in_dim, filters, 1, 1, device)
        self.bn1 = BatchNorm(filters, norm_dtype, device)
        self.conv2 = _conv(filters, filters, 3, stride, device)
        self.bn2 = BatchNorm(filters, norm_dtype, device)
        self.conv3 = _conv(filters, out_dim, 1, 1, device)
        self.bn3 = BatchNorm(out_dim, norm_dtype, device)
        if downsample:
            self.ds_conv = _conv(in_dim, out_dim, 1, stride, device)
            self.ds_bn = BatchNorm(out_dim, norm_dtype, device)
        self.tp_mesh, self.ds_split = None, False

    def tp_split_(self, mesh) -> Dict:
        """conv2 by output channels with BN2, conv3 by input channels;
        conv1 whole."""
        return _split_block_(self, mesh, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, nt, mesh = self.dtype, self.norm_dtype, self.tp_mesh
        y = F.relu(self.bn1(conv(x, self.conv1).float()).to(dt))
        y = F.relu(self.bn2(conv(copy_to_model(y, mesh), self.conv2).float()
                            ).to(dt))
        xs = copy_to_model(x, mesh) if self.ds_split else x
        return _tail(self, x, xs, conv(y, self.conv3), self.bn3)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int],
                 block_cls: Type[nn.Module], in_chans: int = 3,
                 dtype: torch.dtype = torch.bfloat16,
                 norm_dtype: torch.dtype = torch.float32,
                 stem: str = "conv7",
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"unknown stem {stem!r}: conv7 or s2d")
        self.dtype, self.norm_dtype = dtype, norm_dtype
        self.stem = stem
        # flax names the s2d conv stem_conv_s2d; convert.py maps it here
        self.stem_conv = _conv(4 * in_chans, 64, 4, 1, device, padding=0) \
            if stem == "s2d" else _conv(in_chans, 64, 7, 2, device)
        self.stem_bn = BatchNorm(64, norm_dtype, device)
        stages = []
        in_dim = 64
        for i, size in enumerate(stage_sizes):
            filters = 64 * 2 ** i
            out_dim = filters * block_cls.expansion
            blocks = []
            for j in range(size):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(
                    in_dim, filters, stride,
                    stride != 1 or in_dim != out_dim, dtype, norm_dtype,
                    device))
                in_dim = out_dim
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        self.num_features = in_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_head(self.forward_features(x))

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images [B, H, W, C] -> stem, stages, global mean -> fp32
        [B, D]."""
        x = x.to(self.dtype)
        if self.stem == "s2d":
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        x = x.permute(0, 3, 1, 2)
        if self.stem == "s2d":
            x = F.pad(x, (2, 1, 2, 1))
        x = self.stem_bn(conv(x, self.stem_conv).to(self.norm_dtype))
        x = F.relu(x.to(self.dtype))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for stage in self.stages:
            for block in stage:
                x = block(x)
        return x.float().mean((2, 3))

    def forward_head(self, feats: torch.Tensor) -> torch.Tensor:
        return feats


def resnet18(**kw) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, **kw)


def resnet_micro(**kw) -> ResNet:
    """Two stages of one BasicBlock: the JAX package's small ResNet for
    tests, on the same stem, block, BatchNorm and pool code."""
    return ResNet((1, 1), BasicBlock, **kw)


FEATURE_DIMS = {"resnet18": 512, "resnet34": 512, "resnet50": 2048,
                "resnet_micro": 128}
