"""torchvision / torchxrayvision ResNet checkpoints -> the port's ResNet
(counterpart of ``vlp_tpu/models/torch_import.py``).

The reference's strongest model is the torchxrayvision ResNet50
(``resnet50-res512-all``: torchvision's resnet50 with a 1-channel conv1,
trained on 512 x 512 chest x-rays scaled to -1024..1024; reference
OnlyImagingModule.py:55-69). ``convert_torchvision_resnet`` maps such a
state dict onto the port's ``models/resnet.py`` keys:

  conv1 / bn1                       -> stem_conv / stem_bn
  layer{L}.{B}.conv{K} / bn{K}      -> stages.{L-1}.{B}.conv{K} / bn{K}
  layer{L}.{B}.downsample.0 / .1    -> stages.{L-1}.{B}.ds_conv / ds_bn
  fc                                -> head (where the shapes match)

Convolutions keep torch's OIHW layout, BatchNorm its weight, bias and
running statistics (``num_batches_tracked`` is dropped: the port's
BatchNorm, like flax's, has no counter), and ``fc``'s ``[out, in]`` weight
becomes a ``Dense`` ``[in, out]``. The weights are the user's to stage
(``XRV_WEIGHTS_PATH``); where they cannot be loaded the run keeps its
random init with a warning, as the JAX package's does.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import torch

from vlp_tpu_torch.convert import check_state, state_shapes
from vlp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

XRV_WEIGHTS = "resnet50-res512-all"
_BLOCK = re.compile(r"^stages\.(\d+)\.(\d+)\.(.+)$")
_BLOCK_PARTS = {"ds_conv": "downsample.0", "ds_bn": "downsample.1"}


def _source_key(key: str) -> str:
    """The torchvision key a port ResNet key comes from."""
    module, leaf = key.rsplit(".", 1)
    if module in ("stem_conv", "stem_bn"):
        return f"{'conv1' if module == 'stem_conv' else 'bn1'}.{leaf}"
    m = _BLOCK.match(module)
    if m is None:
        raise KeyError(f"{key!r} is not a ResNet backbone entry")
    part = _BLOCK_PARTS.get(m[3], m[3])
    return f"layer{int(m[1]) + 1}.{m[2]}.{part}.{leaf}"


def convert_torchvision_resnet(state_dict: Mapping[str, Any], target: Any,
                               prefix: str = "") -> Dict[str, torch.Tensor]:
    """``target``'s state dict (``target``: a ``models/resnet.py`` ResNet,
    or its keys mapped to tensors or shapes) with every backbone entry
    taken from ``state_dict`` (``prefix`` removed from its keys), in fp32. A
    ``head.weight``/``head.bias`` of ``target`` takes ``fc`` where the
    shapes match and keeps its own otherwise (where ``target`` holds
    tensors), with an info line. Raises KeyError on a missing entry and
    ValueError on a shape that differs."""
    sd = {k.removeprefix(prefix): torch.as_tensor(v)
          for k, v in state_dict.items()}
    shapes = state_shapes(target)
    own = target.state_dict() if isinstance(target, torch.nn.Module) \
        else target
    out, kept = {}, {}
    for key in shapes:
        if key.startswith("head."):
            kept[key] = own[key]
            continue
        src = _source_key(key)
        if src not in sd:
            raise KeyError(f"the torchvision checkpoint lacks {prefix}{src}"
                           f" (for {key!r})")
        out[key] = sd[src].float().contiguous()
    if kept:
        w = sd.get("fc.weight")
        if w is not None and (tuple(w.shape[::-1]), tuple(
                sd["fc.bias"].shape)) == (shapes["head.weight"],
                                          shapes["head.bias"]):
            out["head.weight"] = w.float().t().contiguous()
            out["head.bias"] = sd["fc.bias"].float()
        else:
            if w is not None:
                logger.info("fc head shape %s != %s; keeping the fresh head "
                            "(strict=False transfer semantics)",
                            tuple(w.shape[::-1]), shapes["head.weight"])
            out.update({k: v for k, v in kept.items()
                        if isinstance(v, torch.Tensor)})
    check_state(out, {k: shapes[k] for k in out},
                "the torchvision checkpoint")
    return out


def load_torchxrayvision_resnet50(target: Any,
                                  weights_path: Optional[str] = None
                                  ) -> Optional[Dict[str, torch.Tensor]]:
    """The xrv ``resnet50-res512-all`` weights as ``target``'s state dict
    (see ``convert_torchvision_resnet``), from ``weights_path`` (a state
    dict or a pickled module, ``torch.load``ed as the JAX package loads
    it) or, without one, from the ``torchxrayvision`` package's own cache;
    the ``model.`` prefix of xrv's wrapper is stripped where present. Any
    failure, a file that does not fit included, gives None and a warning,
    and the run keeps its random init."""
    try:
        if weights_path:
            sd = torch.load(weights_path, map_location="cpu",
                            weights_only=False)
            if hasattr(sd, "state_dict"):
                sd = sd.state_dict()
        else:
            import torchxrayvision as xrv  # an optional package

            sd = xrv.models.ResNet(weights=XRV_WEIGHTS).state_dict()
        prefix = "model." if any(k.startswith("model.") for k in sd) else ""
        return convert_torchvision_resnet(sd, target, prefix)
    except Exception as e:
        logger.warning(
            "torchxrayvision resnet50 weights unavailable (%s: %s); the xrv "
            "path runs from random init.", type(e).__name__, e)
        return None
