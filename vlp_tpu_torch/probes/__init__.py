"""Probes of the ResNet kernels on one CUDA card (counterparts of
``benchmarks/conv_probe.py`` and ``benchmarks/bn_gemm_probe.py``): each
times a hand-written kernel beside its plain version and the PyTorch call
that a model would make, at the reference's shapes, and prints one JSON
line per shape.

  python -m vlp_tpu_torch.probes.conv_probe [--batch 128]
  python -m vlp_tpu_torch.probes.bn_gemm_probe [--batch 128]
"""
