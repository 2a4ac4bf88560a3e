"""Exports a vlp_tpu checkpoint's model variables to a '/'-keyed .npz that
``vlp_tpu_torch`` loads (``vlp_tpu_torch.serve --weights``).

Runs where JAX is installed. The checkpoint is restored through
``vlp_tpu.serve.Predictor``, so a checkpoint saved with the other
``model.fused_attention`` setting is migrated to the fused attention layout
the port expects. Pass the overrides the checkpoint was trained with.

Usage:
  python scripts/export_flax_params.py --checkpoint ck_dir \
      --output weights.npz experiment=baseline_only_imaging_nest_small
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vlp_tpu.config import Config, apply_overrides  # noqa: E402
from vlp_tpu_torch.convert import flatten  # noqa: E402


def export(cfg: Config, checkpoint: str, output: str) -> str:
    """Restores ``checkpoint`` for ``cfg``'s model and writes its variables
    (``{'params': ..., **extra_vars}``, flattened with '/') to ``output``."""
    import jax

    from vlp_tpu.serve import Predictor

    # batch 1: the restore only needs the variables' shapes
    predictor = Predictor(cfg, checkpoint, mean=0.0, std=1.0, batch_size=1)
    flat = flatten(jax.device_get(predictor.variables))
    np.savez(output, **{k: np.asarray(v) for k, v in flat.items()})
    return output


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output", required=True)
    args, overrides = parser.parse_known_args(argv)
    cfg = apply_overrides(Config(), overrides)
    print(export(cfg, args.checkpoint, args.output))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
