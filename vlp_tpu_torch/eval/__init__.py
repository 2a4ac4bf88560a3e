"""Offline evaluation of the port's checkpoints (counterpart of
``vlp_tpu/eval``): the per-subgroup metrics of the frozen test split
(``subgroup``) and its command line (``test_eval``), in numpy and the
``csv`` module. The JAX package's results tables, LaTeX, plots, linear
probe evaluation and EDA need pandas, scikit-learn or matplotlib and are
not ported (ROADMAP Queue 1 item 15 (b))."""
