"""Console entry points of the port (counterpart of ``vlp_tpu/cli.py``):
``vlp-torch-train`` and ``vlp-torch-test-eval``."""
from __future__ import annotations

import sys


def train_main(argv=None) -> int:
    from vlp_tpu_torch.train.driver import main

    return main(argv if argv is not None else sys.argv[1:])


def test_eval_main(argv=None) -> int:
    from vlp_tpu_torch.eval.test_eval import main

    return main(argv if argv is not None else sys.argv[1:])
