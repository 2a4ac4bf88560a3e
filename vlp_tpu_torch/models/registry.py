"""Backbone registry (counterpart of ``vlp_tpu/models/registry.py``).

Only ``nest_small`` is ported; every other backbone of the JAX allowlist
raises ``NotImplementedError`` until its slice lands (ROADMAP.md)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vlp_tpu_torch.models import nest


def create_backbone(name: str, dtype: torch.dtype = torch.bfloat16,
                    in_chans: int = 3,
                    device: Optional[torch.device] = None
                    ) -> Tuple[nn.Module, int]:
    """Returns (module, feature_dim), the width read from the module."""
    if name != "nest_small":
        raise NotImplementedError(
            f"backbone {name!r} is not ported to vlp_tpu_torch yet; "
            "ROADMAP.md lists the order in which the port proceeds")
    m = nest.nest_small(in_chans=in_chans, dtype=dtype, device=device)
    return m, m.num_features
