"""``python -m vlp_tpu_torch.train [--device cuda|cpu] experiment=<name>
[dotted.overrides=...]``: the k-fold training driver
(``vlp_tpu_torch.train.driver.main``)."""
from vlp_tpu_torch.train.driver import main

raise SystemExit(main())
