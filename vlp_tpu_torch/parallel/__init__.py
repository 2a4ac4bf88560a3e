"""Data parallelism over N processes, one per device, with the JAX mesh's
global-batch semantics (counterpart of ``vlp_tpu/parallel/``):
``mesh`` (the process group and this rank's rows), ``collectives`` (the
reductions that GSPMD inserts on a ``('data',)`` mesh, with their
gradients) and ``infonce`` (the global-batch contrastive loss in both
``mesh.infonce_impl`` forms)."""
