"""Backbone registry (counterpart of ``vlp_tpu/models/registry.py``).

Ported: ``nest_small``, ``vit_base_patch16_224`` and
``vit_large_patch16_224``; every other backbone of the JAX allowlist, and
``remat=True``, raise ``NotImplementedError`` until their slice lands
(ROADMAP.md)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vlp_tpu_torch.models import nest, vit

# name -> the module that defines the function of that name (looked up at
# call time)
_MODULES = {"nest_small": nest, "vit_base_patch16_224": vit,
            "vit_large_patch16_224": vit}


def create_backbone(name: str, dtype: torch.dtype = torch.bfloat16,
                    in_chans: int = 3,
                    device: Optional[torch.device] = None,
                    fused_attention: Optional[bool] = None,
                    megakernel: bool = True, remat: bool = False
                    ) -> Tuple[nn.Module, int]:
    """Returns (module, feature_dim), the width read from the module.
    ``fused_attention`` None is the model's default (on)."""
    if name not in _MODULES:
        raise NotImplementedError(
            f"backbone {name!r} is not ported to vlp_tpu_torch yet; "
            "ROADMAP.md lists the order in which the port proceeds")
    if remat:
        raise NotImplementedError(
            "remat=True (per-block rematerialization) is not ported to "
            "vlp_tpu_torch yet; see ROADMAP.md")
    m = getattr(_MODULES[name], name)(
        in_chans=in_chans, dtype=dtype, device=device,
        fused_attention=True if fused_attention is None else fused_attention,
        megakernel=megakernel)
    return m, m.num_features
