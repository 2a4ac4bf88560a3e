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
no kernel of their own); the vision-language pretraining step (the
hash tokenizer, the BERT-family text towers on SDPA, the dual tower, the
CLIP losses and per-tower parameter groups; its kernels are the
augmentation's); the probe kernels (``vlp_tpu_torch.probes``); and the
training entry point, ``python -m vlp_tpu_torch.train`` (the config tree
and experiment registry, the synthetic data modules and the device
loader, the ``Trainer`` with its metrics, callbacks and checkpoints, the
k-fold driver); the late-fusion task (the clinical MLP and the fusion
head), the frozen test-set evaluation (``test=true``,
``vlp_tpu_torch.eval``) and serving the trainer's checkpoints. ROADMAP.md
lists what follows.
"""
