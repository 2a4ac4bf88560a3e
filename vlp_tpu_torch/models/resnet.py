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
"""
from __future__ import annotations

from typing import Optional, Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from vlp_tpu_torch.models.vit import BatchNorm


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, nt = self.dtype, self.norm_dtype
        y = F.relu(self.bn1(conv(x, self.conv1).to(nt)).to(dt))
        y = self.bn2(conv(y, self.conv2).to(nt))
        residual = self.ds_bn(conv(x, self.ds_conv).to(nt)) \
            if hasattr(self, "ds_conv") else x
        return F.relu((y + residual).to(dt))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, nt = self.dtype, self.norm_dtype
        y = F.relu(self.bn1(conv(x, self.conv1).float()).to(dt))
        y = F.relu(self.bn2(conv(y, self.conv2).float()).to(dt))
        y = self.bn3(conv(y, self.conv3).to(nt))
        residual = self.ds_bn(conv(x, self.ds_conv).to(nt)) \
            if hasattr(self, "ds_conv") else x
        return F.relu((y + residual).to(dt))


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
