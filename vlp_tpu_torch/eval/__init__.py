"""Offline evaluation of the port's checkpoints and runs (counterpart of
``vlp_tpu/eval``): the per-subgroup metrics of the frozen test split
(``subgroup``) and its command line (``test_eval``); the t-SNE, silhouette
and confusion counts on the device and their figures (``plotting``), the
retrospective figures (``replot``), the offline linear probe of a VLP
checkpoint (``linear_probe_eval``), the README's results table
(``results_table``), LaTeX tables (``latex``) and dataset reports
(``eda``), in torch, numpy and the standard library; matplotlib draws the
figures where it is installed and is imported only where one is drawn."""
