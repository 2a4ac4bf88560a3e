"""Backbone registry (counterpart of ``vlp_tpu/models/registry.py``): the
reference's allowlist, ``resnet18``, ``resnet34``, ``resnet50``,
``resnet50-res512-all`` (the torchxrayvision ResNet50, a ResNet50 on
1-channel input), ``resnet_micro``, ``nest_small``,
``vit_base_patch16_224`` and ``vit_large_patch16_224``. ``stem`` and
``norm_dtype`` reach the ResNets, ``fused_attention`` and ``megakernel``
the transformers, as in the JAX registry. ``remat`` reaches only the
transformers there too (per-block rematerialisation), so a ResNet takes
``remat=True`` and ignores it. ``dropout_rate`` (the dual tower's ``image_dropout``) is
taken and passed to no backbone, as the JAX registry does, so a rate above
0 changes nothing on either side (no experiment sets one)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vlp_tpu_torch.models import nest, resnet, vit

# name -> (module, the function of that module that builds it; looked up
# at call time)
_BACKBONES = {
    "resnet18": (resnet, "resnet18"), "resnet34": (resnet, "resnet34"),
    "resnet50": (resnet, "resnet50"),
    "resnet50-res512-all": (resnet, "resnet50"),
    "resnet_micro": (resnet, "resnet_micro"),
    "nest_small": (nest, "nest_small"),
    "vit_base_patch16_224": (vit, "vit_base_patch16_224"),
    "vit_large_patch16_224": (vit, "vit_large_patch16_224")}


def create_backbone(name: str, dtype: torch.dtype = torch.bfloat16,
                    in_chans: int = 3,
                    device: Optional[torch.device] = None,
                    fused_attention: Optional[bool] = None,
                    megakernel: bool = True, remat: bool = False,
                    norm_dtype: torch.dtype = torch.float32,
                    stem: str = "conv7",
                    dropout_rate: float = 0.0) -> Tuple[nn.Module, int]:
    """Returns (module, feature_dim), the width read from the module.
    ``fused_attention`` None is the model's default (on); ``dropout_rate``
    is ignored, as in the JAX registry."""
    if name not in _BACKBONES:
        raise ValueError(f"Unknown backbone {name!r}; allowed: "
                         f"{sorted(_BACKBONES)}")
    module, fn = _BACKBONES[name]
    kw = dict(in_chans=in_chans, dtype=dtype, device=device)
    if module is resnet:
        kw.update(norm_dtype=norm_dtype, stem=stem)
    else:
        kw.update(fused_attention=True if fused_attention is None
                  else fused_attention, megakernel=megakernel, remat=remat)
    m = getattr(module, fn)(**kw)
    return m, m.num_features
