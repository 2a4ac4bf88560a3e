"""The clinical MLP and the late-fusion head (counterpart of
``vlp_tpu/models/heads.py``).

``ClinicalMLP``: three blocks of fp32 ``Dense`` -> ``BatchNorm`` (fp32,
momentum 0.9, eps 1e-5, flax's fast variance clipped at 0 and its biased
running update, on the ``[B, C]`` rows) -> ReLU, widths (32, 20, 10), over
the 15-dim clinical vector (one-hot site [13], age bin, sex); submodules
``fc{i}`` and ``bn{i}``, flax's names, so ``convert`` maps
``clinical_mlp/fc{i}`` and ``clinical_mlp/bn{i}`` with no rule of its own.
``FusionHead``: ``fuse``, a ``Dense(20, 1)`` over
``concat(image_logits, clinical)`` in fp32. The widths are fixed, as
``FusionModel`` fixes them in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vlp_tpu_torch.data.encoding import CLINICAL_DIM
from vlp_tpu_torch.models.vit import BatchNorm, Dense

HIDDEN = (32, 20, 10)


class ClinicalMLP(nn.Module):
    def __init__(self, device: Optional[torch.device] = None) -> None:
        super().__init__()
        widths = (CLINICAL_DIM, *HIDDEN)
        for i, (n_in, n_out) in enumerate(zip(widths, widths[1:])):
            setattr(self, f"fc{i}", Dense(n_in, n_out, device))
            setattr(self, f"bn{i}", BatchNorm(n_out, torch.float32, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        for i in range(len(HIDDEN)):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x)))
        return x


class FusionHead(nn.Module):
    """concat(image_logits [B, 10], clinical [B, 10]) -> [B, 1]."""

    def __init__(self, device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.fuse = Dense(10 + HIDDEN[-1], 1, device)

    def forward(self, image_feats: torch.Tensor,
                clinical_feats: torch.Tensor) -> torch.Tensor:
        return self.fuse(torch.cat([image_feats.float(),
                                    clinical_feats.float()], dim=-1))
