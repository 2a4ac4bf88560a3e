"""vlp_tpu_torch — the PyTorch/CUDA port of ``vlp_tpu`` for one NVIDIA H100.

The JAX package ``vlp_tpu`` stays the reference; each module here keeps the
name of its counterpart there. Every Pallas TPU kernel on a ported path is a
CUDA C++ kernel written for Hopper (``vlp_tpu_torch/csrc``, built with nvcc
at first use) beside a plain PyTorch version that CPU tensors take.

Ported so far: the NesT-Small classifier's serving path
(``vlp_tpu_torch.serve.Predictor``) with the half-block kernels
``ln_attention`` and ``ln_mlp``. ROADMAP.md lists what follows.
"""
