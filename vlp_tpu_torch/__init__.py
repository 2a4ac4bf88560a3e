"""vlp_tpu_torch — the PyTorch/CUDA port of ``vlp_tpu`` for one NVIDIA H100.

The JAX package ``vlp_tpu`` stays the reference; each module here keeps the
name of its counterpart there. Every Pallas TPU kernel on a ported path is a
CUDA C++ kernel written for Hopper (``vlp_tpu_torch/csrc``, built with nvcc
at first use) beside a plain PyTorch version that CPU tensors take.

Ported so far: the NesT-Small classifier's serving path
(``vlp_tpu_torch.serve.Predictor``) and training step
(``vlp_tpu_torch.train.step.make_train_step``), with the half-block kernels
``ln_attention`` and ``ln_mlp``, their backwards, and the augmentation
kernels ``shear_rows`` and ``add_gaussian_noise``; and the unfused block
path of ViT-B/16, ViT-L/16 and NesT-Small with ``megakernel=False``, with
the packed-qkv attention ``attend_qkv`` and the fused MLP ``fused_mlp`` and
their backwards; NesT-Small on its token map (``ln_attention_windows`` and
its backward); the ResNets with BatchNorm and CORAL (cuDNN convolutions,
no kernel of their own); and the ResNet probes ``conv3x3`` and
``bn_relu_gemm`` (``vlp_tpu_torch.probes``). ROADMAP.md lists what follows.
"""
