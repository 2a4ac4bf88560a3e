"""Smoke run of the PyTorch/CUDA port (``vlp_tpu_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each printing its lines before the last line:

1. device: torch/CUDA versions and the card's name and power limit
   (``nvidia-smi``); exits nonzero when no CUDA device is present.
2. build: compiles ``vlp_tpu_torch/csrc`` with nvcc (sm_90a) and loads it;
   then checks that the kernels on the wgmma + TMA mainloop
   (``csrc/wgmma_gemm.cuh``: #19b, #17 at both tile widths, the four
   products of #3/#6's sequence in its three instances, the dual tiles
   (``csrc/mlp_bwd.cuh``) of #4/#10 and of #14 (the accurate GELU, 64 and
   128 columns) and the forwards' products
   (``csrc/dense_epi.cuh``: #2/#9's fc1 with its bias + GELU epilogue;
   #13/#19a's fc1 with the accurate GELU at 128 and 64 columns; the bias
   (+ residual) epilogue that #2/#9's fc2, #1/#5's qkv product and
   out-projection and #13/#19a's fc2 share at 64 columns, and #13/#19a's
   fc1 without GELU at 128), whose registers it prints) reach
   Hopper's units: ``cuobjdump --dump-sass`` of the library shows HGMMA
   and UTMALDG in each, and the build's ``-Xptxas -v`` report shows 0 spill bytes for
   each and no serialized wgmma; that every instance of the forward core
   (``csrc/mhsa_reg.cuh``: #7's, #1's and #5's v0 order at head dim 32 and
   13 key tiles, both row maps, and #15's forms, v0, nosm, pipe, pipe2,
   stage and the kRecip v0 and stage of #16's pass 1, at every key-tile
   count) spills nothing, with the registers of each form by key tiles and
   the shared memory a block of each mode takes at S 196 and 256 (the
   parked p of pipe2 and stage) printed; and that every instance of
   the register-resident attention-core backward
   (``csrc/mhsa_reg_bwd.cuh``, #3's and #6's at head dim 32 and 13 key
   tiles among them, and #16's uni core, which also forms o, at every key
   tile count, its registers printed) spills nothing.
3. kernels: ``ln_attention`` and ``ln_mlp`` against their plain PyTorch
   versions at the shapes serving gives them, NesT-Small's three levels at
   batch 64 (bf16 inputs from a seeded CUDA generator), against the plain
   version in bf16 and in fp32, and both also at a ragged request of 37
   images, reruns bit-equal; ``ln_attention``'s y and the qkv and o it
   leaves for the backward, against the plain pieces (qkv = bf16(ln @
   Wqkv + bqkv), o = ``attend_qkv_plain(qkv)``), and its o bit-equal to
   #7 ``attend_qkv`` on the same qkv (one core); ``ln_mlp``'s h against
   the h that #4's dual tile recomputes from the same ln (bf16 ulps apart,
   printed); then the median time of kernel and plain version at the same
   shapes.
4. slice: ``Predictor`` for ``experiment=baseline_only_imaging_nest_small``
   (NesT-Small, 224x224, bf16, batch 64, random weights at the flax
   initializers' scales) answers requests of 64, 64 and 37 images; the
   launch counters must show 24 launches of each kernel per forward; the
   first 8 logits are held against the same weights run on the CPU in
   fp32; per-batch latency and images/s are timed.

5. training kernels: the backward kernels ``ln_attention_bwd`` and
   ``ln_mlp_bwd`` against their plain versions (bf16 and fp32) at
   NesT-Small's three levels at batch 64, every cotangent, reruns
   bit-equal; ``shear_rows`` bit-equal to its plain version along rows
   and columns at [64, 224, 224] and [128, 224, 224] at the warp's ramp
   shifts and at random ones, at widths that are not a multiple of 4
   ([3, 17, 30], [2, 224, 225]), with max_shift beyond the line, and with
   shifts of exactly +-max_shift and integral ones (fraction 0), one
   launch a call; ``add_gaussian_noise`` at W 224 (the 16-byte path) and
   226 (the scalar path): the Philox words against Random123's known
   answers and the plain version's words, values within a stated bound,
   sigma 0 the identity, the moments of one sigma-1 draw; then the median
   time of kernel and plain version on the warp's shifts and the step's
   sigmas, and ``probes/augment_probe.py`` at batch 64 and 128: device time
   alone (warm and with the L2 flushed) of every case beside
   ``F.grid_sample`` and ``torch.normal``, with the shares of the bound.
6. training slice: ``make_train_step`` for
   ``experiment=baseline_only_imaging_nest_small`` (NesT-Small, 224x224
   uint8 batches of 64, bf16, AdamW under cosine_warmup, the experiment's
   augmentation) with random weights: 3 warm-up steps, then 10 timed steps
   whose launch counters must show 24 + 24 + 24 + 24 + 3 + 1 kernel
   launches per step; finite loss and gradients, parameters moving from
   step 1 on, the lr the optimizer used equal to cosine_warmup's linear
   warmup written out (0 at step 0); the bf16 gradients of a 4-image batch
   (augmentation off) held against fp32 on the CPU; step latency, images/s,
   device step time and peak memory.

7. unfused-path kernels: ``attend_qkv`` and its backward at ViT-B/16's
   shape (N 32, S 197, 12 heads of 64) and NesT-Small's three levels at
   batch 64 (heads of 32), ``fused_mlp`` and its backward at NesT-Small's
   three levels (and ``fused_mlp`` at a ragged request of 37 images),
   against their plain versions in bf16 and fp32, every output and
   cotangent; the forward's and the backwards' reruns bit-equal, and #8's
   recompute check (the p and ds that its phase B recomputes bit-equal to
   phase A's); then kernel and plain version timed
   as plain, kernel, kernel, plain, and ``scaled_dot_product_attention``
   (forward, and its autograd backward) on the same q, k, v views as the
   yardstick of #7 and #8 (the port never calls it).
8. ViT-B/16 serving: ``Predictor`` for
   ``experiment=baseline_only_imaging_vit_base`` (batch 32) answers 32, 32
   and 19 images with 12 launches of ``attend_qkv`` per forward and none
   of the half-block kernels; logits against fp32 on the CPU; latency.
9. ViT-B/16 training: the experiment's step at batch 32, full width and
   depth, with the checks of phase 6 and 12 + 12 launches of
   ``attend_qkv`` and its backward, 3 + 1 augmentation launches per step.
10. NesT-Small with ``model.megakernel=false``, training at batch 64, full
   depth: 24 launches each of ``attend_qkv``, ``fused_mlp`` and their
   backwards per step, none of the half-block kernels, and phase 6's
   checks.

11. windowed kernels: ``ln_attention_windows`` (#5) and its backward (#6)
   on NesT-Small's three level maps at batch 64 ([64, 56, 56, 96],
   [64, 28, 28, 192], [64, 14, 14, 384], windows of 14) against their plain
   versions in bf16 and fp32, every cotangent; against #1 and #3 on the
   blockified map (y, qkv, o, dx and dbqkv bit-equal, the other weight
   gradients within 2^-6), #5 also on a ragged request's 37 maps; reruns
   of #5 and #6 bit-identical; timed as plain, kernel, kernel, plain, with
   #1 and #3 on the blockified map timed in the same turns.
12. NesT-Small serving with the backbone's ``nhwc_windows`` set (no config
   key: the attribute of the built model): requests of 64, 64 and 37
   images, 24 launches of #5 and 24 of ``ln_mlp`` per forward and none of
   #1; logits against fp32 on the CPU with the same flag and against the
   blockified path on the same weights on the card; whether the patch
   convolution and the pools leave the map contiguous; request latency of
   both paths in alternating turns.
13. NesT-Small training with ``nhwc_windows`` set, batch 64, full depth:
   24 launches each of #5, #6, ``ln_mlp`` and ``ln_mlp_bwd`` and 3 + 1
   augmentation launches per step, none of #1 or #3, and phase 6's checks;
   then the step of both paths on the same task in alternating turns.

14. probe kernels: ``conv3x3`` (#17) at ResNet34's stage-2/3 shapes
   ([128, 28, 28, 128], [128, 14, 14, 256]) and ``bn_relu_gemm`` (#18) at
   ResNet50's boundary shapes, and both at an odd batch with ragged tiles,
   against their plain versions in bf16 and in fp32 (TF32 off for cuDNN and
   cuBLAS), the map's edge pixels on their own, #17's reruns bit-equal;
   then the probe entry points (``vlp_tpu_torch.probes.conv_probe.run``,
   ``bn_gemm_probe.run``) at batch 128: kernel, plain version and
   ``F.conv2d`` or the two-op PyTorch version in turns, #17 and cuDNN also
   as device time alone (calls queued behind a spin kernel), and the stem
   max pool's first-max against its equality-split backward.
15. ResNet34 serving: ``Predictor`` for
   ``experiment=baseline_only_imaging_resnet34`` (batch 64, BatchNorm in
   eval mode) answers 64, 64 and 37 images with no kernel launch; logits
   against fp32 on the CPU; an image's logit independent of its batch; the
   running statistics untouched; latency.
16. ResNet34 training at batch 64, full depth, CORAL (weight 1000) live on
   batches that hold datasets 0 and 1: 3 + 1 augmentation launches per
   step and no other kernel, phase 6's checks, the running statistics
   moving from step 0 on, CORAL nonzero in every timed step; the 4-image
   gradients in train-mode BatchNorm with both domains present: fp32 on
   the card against fp32 on the CPU, and bf16 on the card against fp32 on
   the CPU beside bf16 on the CPU against fp32 on the CPU.
17. xrv-ResNet50 (``experiment=baseline_only_imaging_xrv_resnet50``:
   1-channel input, intensity scaling, Bottleneck blocks): one serving
   request of 32 and the training step at batch 32, with the checks of
   phases 15 and 16.
18. MLP probe kernels: ``mlp_tile`` (#13, and its no-GELU and no-LN
   ablations) and ``mlp_chain`` (#19a, each stage set) at every (TM, FS)
   instance (#2's launch sequence: fc1's tile 128 or 64 columns wide),
   ``mlp_tile_bwd`` (#14, every cotangent) at each of its dual tile's
   widths, and ``mlp_single`` (#19b, the wgmma + TMA kernel), reruns of
   each bit-identical, at NesT-Small level 3's width (D 384, F 1536) on the
   rows of batch 16 and on a ragged M (the last 128-row tile partial in
   both), against their plain versions in bf16 and in fp32 (TF32 off);
   then the probe entry points (``vlp_tpu_torch.probes.mega_probe.run``,
   ``mlp_probe.run``) at batch 128: each instance, the shipped #2/#4, the
   plain versions, ``torch.matmul`` and the two-matmul chain in turns,
   each instance also as device time alone beside the shipped #2/#4, the
   two-matmul chain or ``torch.matmul``, each instance's error against the
   plain bf16 version held to the same bound as at the smaller shapes.
19. attention probe kernels: ``attn_sched`` (#15) in every mode (v0, the
   nosm bound against its own plain version, pipe, pipe2, stage), its core
   alone, ``attn_sched_bwd`` (#16, every cotangent) and its core in every
   mode (v0, stage2, uni), at NesT-Small level 3's width (D 384, 12 heads)
   on 4 samples of S 196, 4 of a ragged S 37 and 2 of every mode's
   largest S 256, biases and beta drawn at scale 1 and gamma not 1,
   against their plain versions in bf16 and in fp32 (TF32 off); the
   softmax modes' y bit-equal to each other and to the shipped #1's
   (``ln_attention``: v0 launches what #1 launches), every backward mode
   bit-identical on a rerun, its core's o bit-equal in every mode (uni's
   from the backward core's p, v0's and stage2's from the forward core
   with kRecip), the elements apart printed; then the probe entry point
   (``vlp_tpu_torch.probes.attn_probe.run``) at batch 128: each mode, its
   core, SDPA on the same q, k, v, the shipped #1/#3 and the plain versions
   in turns, each mode, its core, #1/#3 and SDPA also as device time
   alone, each mode's error there held to the same bound.

20. VLP pretraining: ``make_train_step`` for
   ``experiment=pretrain_resnet34_tinybert`` (the dual tower: ResNet34 and
   TinyBERT, 4 layers of 312, 12 heads of 26; embedding 128; batch 128,
   224x224 uint8 images, ragged 8-40-token captions each twice, bf16,
   AdamW at 1e-3 under cosine, the 5-degree shear and the noise) from
   seeded weights at the flax scales: 3 warm-up and 10 timed steps whose
   launch counters must show 3 ``shear_rows`` + 1 ``add_gaussian_noise``
   per step and no other kernel; finite losses and gradients, the lr equal
   to cosine's value written out (the base lr at step 0), ``logit_scale``
   and the running statistics moving, ``exp(logit_scale)`` at most 100;
   step latency, images/s, device span, peak memory, and the SDPA backend
   the text tower takes (kernel names under the profiler); ``eval_fn`` and
   ``embed_images_fn`` on a batch with all-zero caption masks (finite),
   16 rows against fp32 on the CPU; the 4-image gradients as phase 16
   holds them (the packed q|k|v compared in its flax parts; the attention
   key bias, whose exact gradient is 0, left out of the cosines). Then on
   the same machinery: one step each of ``_masked_loss`` and
   ``_non_square_loss`` (the loss within 1e-5 of the plain loss written
   out in numpy fp64, recomputed from the card's embeddings), two
   of ``_frozen_text`` (text tower bit-identical, image tower moving), one
   of ``_split_lr`` (each group at its own lr), and
   ``pretrain_resnet34_distilbert`` (6 x 768, heads of 64): 3 steps with
   the same checks and its eval.

Then one JSON line with every kernel: its launches in the timed training
steps of the path that runs it (NesT-Small's for #1-#4, #11, #12; ViT-B's
for #7, #8; NesT unfused for #9, #10; NesT with ``nhwc_windows`` for #5,
#6; ``other_launches`` adds the other paths (``vlp_resnet34_tinybert_train``
among them for #11, #12), ``serve_launches`` the serving phases; #17 and
#18 carry
``"path": "probe"`` and the launches of the probes' runs, as do #13,
#14, #19a, #19b, #15 and #16, whose ``core_launches`` count the launches
of their cores alone), its largest
error against the plain bf16 version, and its times per training step of
that path (for #17 and #18: one call at each probe shape, summed, with
``per_shape`` beside; for #13, #14, #19a and #19b: one call of the fastest
instance, with every instance, ablation, the shipped #2/#4 and the
two-matmul chain in ``per_shape``; for #15 and #16: one call of the fastest
mode, every mode (core and SDPA times beside) and the shipped #1/#3 in
``per_shape``): ``ms`` and ``plain_ms`` (the sum over the path's
calls of the median time per call), ``bound_ms`` (the larger of the bytes
the calls must move, each input read and each output written once, over
3.35 TB/s, and their operations over 989 TFLOP/s bf16, or 67 TFLOP/s fp32
for shear and noise; ``bound_by`` says which), and ``library_ms`` (SDPA
for #7 and #8, ``F.conv2d`` for #17, ``torch.matmul`` for #19b,
``F.grid_sample`` for #11 and ``torch.normal`` for #12, null where no
single PyTorch call computes the function); #11, #12, #13, #14, #16,
#17, #19a and #19b add ``device_ms`` and ``library_device_ms``, the same
calls' device time alone (#19a's library the two-matmul chain; #13, #14
and #16 also ``shipped_device_ms``, the shipped #2's, #4's or #3's, and
#16 ``core_device_ms`` and ``sdpa_device_ms``), and #11 and #12 also
``device_cold_ms`` and
``library_device_cold_ms`` (the L2 flushed before each call) and each
probe case at batch 64 and 128 in ``per_shape``. Last ``{"ok": true,
"device": {...}}``. Any failed check raises.

The launch counts of each path are set to 0 just before that path's run and
read just after; the launches that compare a kernel with its plain version
fall outside those runs.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import torch.nn.functional as F

from vlp_tpu_torch.config import (EXPERIMENTS, NEST_UNFUSED, PRETRAIN,
                                  TRAIN_EXPERIMENTS)
from vlp_tpu_torch.models.tasks import build_task
from vlp_tpu_torch.models.vit import conv_nhwc
from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops import attn_sched as AS
from vlp_tpu_torch.ops import block_attention as BA
from vlp_tpu_torch.ops import bn_gemm as BG
from vlp_tpu_torch.ops import conv3x3 as CV
from vlp_tpu_torch.ops import fused_block as FB
from vlp_tpu_torch.ops import fused_mlp as FM
from vlp_tpu_torch.ops import mlp_tile as MT
from vlp_tpu_torch.ops import noise as NZ
from vlp_tpu_torch.ops import shear as SH
from vlp_tpu_torch.ops.warp import default_max_shift, shear_shifts
from vlp_tpu_torch.probes import (attn_probe, augment_probe, bn_gemm_probe,
                                  conv_probe, mega_probe, mlp_probe)
from vlp_tpu_torch.probes._timing import BF16_FLOPS, HBM_BYTES_PER_S
from vlp_tpu_torch.probes._timing import median_ms as _median_ms
from vlp_tpu_torch.serve import Predictor
from vlp_tpu_torch.train.setup import (batch_for, build_training,
                                      random_batch, random_pretrain_batch)
from vlp_tpu_torch.train.step import to_device, train_steps

# (blocks per image, D, heads, depth) of NesT-Small's levels at 224x224
LEVELS = ((16, 96, 3, 2), (4, 192, 6, 2), (1, 384, 12, 20))
SEQ = 196
# Kernel vs plain version, as a share of the reference's largest |value|.
# Both round to bf16 at the same five points and differ only in fp32
# summation order, which can flip one rounding (one bf16 ulp is 2^-8 of the
# value at most): two ulps at the largest output.
BOUND_VS_PLAIN_BF16 = 2.0 ** -6
# Against fp32 the five bf16 roundings (each <= 2^-9 relative) add up;
# twice their sum, rounded up to a power of two.
BOUND_VS_PLAIN_FP32 = 2.0 ** -5
# NesT-Small bf16 logits vs fp32 on the CPU: 48 half-blocks each round the
# residual stream to bf16 (2^-9 relative), sqrt(48) * 2^-9 ~ 1.4% if
# uncorrelated; allow 5% of max(1, max|logit|).
BOUND_LOGITS = 0.05
REQUESTS = (64, 64, 37)
BATCH = 64
RAGGED = REQUESTS[-1]  # images of the ragged request
# Backward kernel vs plain backward, each of the seven cotangents, as a
# share of the reference's largest |value|. Against plain bf16: both round
# at the same points (ln, qkv, p, do/l, ds, dqkv; h, dh; dx and the weight
# gradients) and differ in fp32 summation order, which can flip one bf16
# rounding of an intermediate (2^-8 relative) and then moves the sums
# downstream of it by about as much; the final casts add one ulp: 2^-6, four
# ulps of the largest output. Against plain fp32: six bf16 roundings on the
# way (each <= 2^-9 relative) add up to ~1.2%; 2^-4 leaves a factor 5.
BOUND_BWD_BF16 = 2.0 ** -6
BOUND_BWD_FP32 = 2.0 ** -4
# shear_rows: the kernel rounds a * (1 - f), b * f and their sum separately
# (no FMA), as the plain version's three tensor ops do, and reads the same
# clamped elements: exact.
BOUND_SHEAR = 0.0
# add_gaussian_noise, x in [0, 256) and sigma 1: the words are equal, so the
# values differ only by logf/sqrtf/cosf/sinf against torch's log/sqrt/cos/
# sin (each within 2 ulps: <= 16 ulps of |z| < 8 in all, 2^-17) and by the
# one rounding of x + sigma * z that this can flip (one ulp of |out| < 512,
# 2^-14): 2^-14 + 2^-17 < 2^-13.
BOUND_NOISE = 2.0 ** -13
# training slice
STEPS_PER_EPOCH = 10      # the schedule's epoch length for this run
WARMUP_STEPS = 3
TIMED_STEPS = 10
GRAD_BATCH = 4
# NesT-Small gradients, bf16 on the card vs fp32 on the CPU (same weights,
# augmentation off): each of the 48 half-blocks rounds the residual stream
# to bf16 on the way forward and dx on the way back (2^-9 relative each),
# sqrt(96) * 2^-9 ~ 1.9% if uncorrelated, and every weight gradient is cast
# to bf16 once (2^-9): allow 10% of the gradient's L2 norm, and a cosine of
# at least 0.98 (a 20% error) for every tensor.
# ViT-B/16 (24 half blocks) and NesT unfused round no more often: the same
# bounds hold for them.
BOUND_GRAD_REL = 0.1
BOUND_GRAD_COS = 0.98
NEST = "baseline_only_imaging_nest_small"
VIT_B = "baseline_only_imaging_vit_base"
VIT_BATCH = 32
VIT_REQUESTS = (32, 32, 19)
# (label, N, S, D, heads, calls per training step) of the attention kernels
# #7/#8 on the unfused path: ViT-B/16 at batch 32 (12 blocks), NesT-Small's
# levels at batch 64
VIT_ATTN = ("ViT-B", VIT_BATCH, 197, 768, 12, 12)
NEST_ATTN = tuple((f"NesT L{i}", BATCH * nb, SEQ, d, h, depth)
                  for i, (nb, d, h, depth) in enumerate(LEVELS))
# NesT-Small's level maps (side at 224x224) and its window
SIDES = (56, 28, 14)
WINDOW = 14
# serving and training of both NesT paths in alternating turns
AB_ROUNDS = 4
AB_STEPS = 5
RESNET34 = "baseline_only_imaging_resnet34"
XRV = "baseline_only_imaging_xrv_resnet50"
XRV_BATCH = 32
# an image's logit alone and inside a full batch (the same padded batch
# shape, so the same kernels): BatchNorm in eval mode makes them equal up
# to the convolution algorithms' summation order; a BatchNorm left in
# training mode would move them by the batch's statistics
BOUND_BATCH_INDEPENDENCE = 1e-3
# The ResNets' gradients in train-mode BatchNorm, 4 images, both domains.
# BatchNorm's backward subtracts nearly equal terms and magnifies any
# rounding difference, so each comparison is scaled by the CPU's own:
# - fp32 on the card (TF32 off) against fp32 on the CPU: the same
#   arithmetic summed in other orders. On the CPU alone the same batch in
#   reverse order (the same loss and gradients in exact arithmetic) moves
#   the fp32 gradients by a share r of their norm; the card may differ by
#   3 r. Per tensor, the card's cosine gap 1 - cos may be 0.001, or 3
#   times the CPU's own gap on the reversed batch where that is larger:
#   a gradient that largely cancels (the text tower's key kernel) holds
#   more rounding noise on the CPU alone than a flat 0.999 allows.
# - bf16 against fp32: bf16's roundings (2^-9) move the gradients by a
#   large share of their norm, on the CPU as much as on the card; the
#   card's bf16 gradients may be at most twice as far from fp32 as the
#   CPU's bf16 gradients are.
BOUND_GRAD_FP32_VS_ORDER = 3.0
BOUND_GRAD_COS_FP32 = 0.999
BOUND_GRAD_BF16_VS_CPU = 2.0
# parameters whose exact gradient is 0 (see _check_grads), named by the
# flax parts of the text tower's packed q|k|v (see _grad_views)
ZERO_GRAD = "attn.key.bias"
_PACKED_QKV = re.compile(r"^(text_encoder\..*attn\.)qkv\.(weight|bias)$")
# probe kernels: the checks' shapes (B, H, W, C, K) and (M, C, K), the
# probes' shapes and odd ones (ragged M and N tiles, C not a multiple
# of 32, a one-pixel-high map, an odd batch; for #18 also C at the kernel's
# limit with K 16, and one row with C 16 at K 256)
CONV_CHECKS = ((128, 28, 28, 128, 128), (128, 14, 14, 256, 256),
               (3, 7, 9, 48, 80), (5, 1, 33, 16, 144))
GEMM_CHECKS = ((128 * 56 * 56, 256, 64), (128 * 28 * 28, 512, 128),
               (128 * 56 * 56, 64, 256), (3 * 7 * 9, 48, 80),
               (4097, BG.MAX_C, 16), (1, 16, 256))
PROBE_BATCH = 128
# the device-time fields of the #17, #18, #19b, #14 and #16 records (calls
# queued behind a spin kernel: no host time): the kernel's and its
# yardsticks' (one PyTorch call; #18's two-op version; the shipped #3/#4;
# #16's core and SDPA's backward)
DEVICE_KEYS = ("kernel_device_ms", "library_device_ms", "two_op_device_ms")
BWD_DEVICE_KEYS = ("kernel_device_ms", "shipped_device_ms", "core_device_ms",
                   "sdpa_device_ms")
# MLP probe kernels: the checks' row counts (batch 16 at level 3, and a
# ragged M; the last 128-row tile of each is partial) at level 3's width
MLP_CHECK_ROWS = (16 * SEQ, 1037)
MLP_D, MLP_F = 384, 1536
# attention probe kernels: the checks' (N, S) at level 3's width, 12 heads:
# the probe's S, a ragged one and every mode's largest
ATTN_CHECKS = ((4, SEQ), (4, 37), (2, 256))
ATTN_D, ATTN_HEADS = 384, 12
# Peak rate of one H100 SXM (NVIDIA's data sheet) of fp32 outside the
# tensor cores (shear, noise); device memory and bf16 in probes/_timing.py
FP32_FLOPS = 67e12
# VLP pretraining (phase 20): the bench's batch; rows of the eval batch
# whose caption mask is all zeros; the rows held against fp32 on the CPU
VLP_BATCH = 128
VLP_ZERO_MASK_ROWS = (5, 77)
VLP_CPU_ROWS = 16
# bf16 embeddings on the card vs fp32 on the CPU, same weights, eval mode:
# the image tower rounds as ResNet34's logits do (BOUND_LOGITS), and each of
# TinyBERT's 4 (DistilBERT's 6) post-LN layers rounds its residual stream
# to bf16 twice (2^-9 relative, renormalised by each LayerNorm): a few
# percent at most; allow 5% of each tower's largest |value|
BOUND_EMB = 0.05
# the loss on the card against the plain loss recomputed in fp32 on the
# CPU from the card's own embeddings: the same fp32 arithmetic over a
# 128 x 128 matrix in another order
BOUND_LOSS_VS_CPU = 1e-5
VLP_VARIANTS = ("pretrain_resnet34_tinybert_masked_loss",
                "pretrain_resnet34_tinybert_non_square_loss")
VLP_DISTILBERT = "pretrain_resnet34_distilbert"


def _work(name, n, s, d, f=None):
    """(operations, bytes) one call must do and move: each input read once,
    each output written once, at N = n, S = s (the MLP kernels: n rows,
    s = 1), width d and hidden f = 4d. The backwards count the products
    they must form (the attention core's recomputed scores included)."""
    m = n * s
    f = 4 * d if f is None else f
    return {
        "ln_attention": (8 * m * d * d + 4 * m * s * d,
                         4 * m * d + 8 * d * d + 24 * d),
        "ln_mlp": (4 * m * d * f, 4 * m * d + 4 * d * f + 12 * d + 4 * f),
        "ln_attention_bwd": (16 * m * d * d + 10 * m * s * d,
                             14 * m * d + 16 * d * d + 44 * d),
        "ln_mlp_bwd": (10 * m * d * f,
                       6 * m * d + 8 * d * f + 20 * d + 8 * f),
        "attend_qkv": (4 * m * s * d, 8 * m * d),
        "attend_qkv_bwd": (10 * m * s * d, 14 * m * d),
        "fused_mlp": (4 * m * d * f, 4 * m * d + 4 * d * f + 4 * f + 4 * d),
        "fused_mlp_bwd": (10 * m * d * f, 6 * m * d + 8 * d * f + 8 * f
                          + 4 * d),
    }[name]


def _stat():
    return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "flops": 0,
            "bytes": 0, "library_ms": None}


def _finish(stat, rate=BF16_FLOPS):
    """bound_ms and bound_by of the accumulated work."""
    t_bytes = stat["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = stat["flops"] / rate * 1e3
    stat["bound_ms"] = max(t_bytes, t_ops)
    stat["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return stat


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(f"nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")
    _check_hopper_units()


# the kernels on the wgmma + TMA mainloop (csrc/wgmma_gemm.cuh): #19b
# (DenseRows), #17 at 128 and 256 output channels a block (ConvTaps), the
# four products of #3/#6's sequence (RowsNT to bf16 and to fp32, ColsTN to
# fp32 split-K partials; #4/#10's and #14's weight gradients, dln and dx
# and #16's do and tail run on the same three), the dual tiles
# (csrc/mlp_bwd.cuh: #4/#10's DualMlp<false> at 64 columns a block, #14's
# DualMlp<true>, the accurate GELU, at 64 and 128), and the forwards'
# products (csrc/dense_epi.cuh): DenseEpi<true> bias + GELU at 128 columns
# a block (#2/#9's fc1), <true, true> bias + the accurate GELU at 128 and
# 64 (#13/#19a's fc1, csrc/mlp_tile.cu), <false> bias (+ residual) at 64
# (#2/#9's and #13/#19a's fc2, #1/#5's and #16's qkv and #1/#5's
# out-projection: csrc/mlp_fwd.cuh's kFc2Width, csrc/ln_attention.cuh's
# kQkvWidth, kOutWidth) and at 128 (#13/#19a's fc1 without GELU), and the
# register-A form AffineReluRows (#18, csrc/bn_relu_gemm.cu) at 64 and 128
WGMMA_KERNEL = "wgmma_gemm_kernel"
WGMMA_FWD = "DenseEpi"
# the forward products' instances by the epilogue form in their names
# (DenseEpi<kGelu, kErf>): (count, who runs them)
WGMMA_FWDS = {"DenseEpiILb1ELb0E": (1, "#2/#9's fc1"),
              "DenseEpiILb1ELb1E": (2, "#13/#19a's fc1, accurate GELU"),
              "DenseEpiILb0ELb0E": (2, "bias (+ residual): #1/#2/#5/#9's, "
                                       "#13/#19a's")}
WGMMA_FWD_WIDTH = re.compile(r"DenseEpiILb[01]ELb[01]EEELi(\d+)E")
WGMMA_DUAL = "DualMlp"
# (#4/#10's, #14's) dual tile instances, by the GELU form in their names
WGMMA_DUALS = {"DualMlpILb0E": 1, "DualMlpILb1E": 2}
# #18's register-A form: its instances by tile width, in ptxas's mangled
# names (wgmma_gemm_kernel<AffineReluRows, BN, STAGES, MINB, bf16>)
WGMMA_AFFINE = "AffineReluRows"
WGMMA_AFFINE_WIDTHS = (64, 128)
WGMMA_AFFINE_WIDTH = re.compile(r"AffineReluRowsELi(\d+)E")
WGMMA_INSTANCES = (6 + sum(n for n, _ in WGMMA_FWDS.values())
                   + sum(WGMMA_DUALS.values()) + len(WGMMA_AFFINE_WIDTHS))
WGMMA_FORMS = ("DenseRows", "ConvTaps", "RowsNT", "ColsTN", WGMMA_DUAL,
               WGMMA_FWD, WGMMA_AFFINE)
# the wmma engine that #18 ran on until it moved onto the register-A form
# (csrc/implicit_gemm.cuh, deleted): no instance may be left in the build
IGEMM_KERNEL = "igemm_kernel"
# the register-resident attention-core backward (csrc/mhsa_reg_bwd.cuh):
# every instance of both row maps must keep 0 spill bytes, and #3's and
# #6's at NesT's S = 196 (head dim 32, 13 key tiles, with the column sums
# and without o: <32, 13, row map, true, false>, in ptxas's mangled names)
# and #16's uni core at the probe's S = 196 (<32, 13, IdentityRows, true,
# true>: the sums and o) must be built
REG_BWD_KERNEL = "mhsa_reg_bwd_kernel"
NEST_ROW_MAPS = ("IdentityRows", "WindowRows")
REG_BWD_NEST_ARGS = ("ILi32ELi13E", "Lb1ELb0E")
REG_BWD_UNI_ARGS = ("ILi32ELi13E", "IdentityRows", "Lb1ELb1E")
# the register-resident forward core (csrc/mhsa_reg.cuh,
# mhsa_reg_kernel<HD, KT, Rows, Order, kNosm, kRecip> in ptxas's mangled
# names): #1's and #5's v0 instance at NesT's S = 196 (<32, 13, row map, 0,
# false, false>) and #15's forms at every key-tile count must be built, and
# every instance (#7's at both head dims among them) must keep 0 spill bytes
REG_FWD_KERNEL = "mhsa_reg_kernel"
REG_FWD_ARGS = re.compile(r"mhsa_reg_kernelILi(\d+)ELi(\d+)ENS_\d+(\w+?Rows)"
                          r"ELi(\d)ELb([01])ELb([01])E")
# #15's modes and #16's two-pass modes' pass 1: (mode, order, nosm, recip)
SCHED_FORMS = {"v0": ("v0", 0, 0, 0), "nosm": ("nosm", 0, 1, 0),
               "pipe": ("pipe", 1, 0, 0), "pipe2": ("pipe2", 2, 0, 0),
               "stage": ("stage", 3, 0, 0),
               "v0 recip (#16 v0's pass 1)": ("v0", 0, 0, 1),
               "stage recip (#16 stage2's pass 1)": ("stage", 3, 0, 1)}


def _ptxas_report(log: str):
    """{kernel: (registers, spill store bytes, spill load bytes)} and the
    ptxas lines that name a serialized wgmma, from the build's
    ``-Xptxas -v`` log."""
    regs, spills, serial = {}, {}, []
    current = props = None
    for line in log.splitlines():
        if "Compiling entry function '" in line:
            current = line.split("'")[1]
        elif "Function properties for " in line:
            props = line.split("Function properties for ")[1].strip()
        elif "bytes spill stores" in line and props is not None:
            words = line.replace(",", "").split()
            spills[props] = (int(words[words.index("spill") - 2]),
                             int(words[-4]))
            props = None
        elif "Used " in line and " registers" in line and current:
            regs[current] = int(line.split("Used ")[1].split()[0])
        if "serialized" in line:
            serial.append(line.strip())
    return {k: (regs.get(k), *spills.get(k, (None, None))) for k in regs}, \
        serial


def _sass_functions(sass: str):
    """{function name: its SASS text} from ``cuobjdump --dump-sass``."""
    funcs, name, body = {}, None, []
    for line in sass.splitlines():
        if "Function : " in line:
            if name is not None:
                funcs[name] = "\n".join(body)
            name, body = line.split("Function : ")[1].strip(), []
        elif name is not None:
            body.append(line)
    if name is not None:
        funcs[name] = "\n".join(body)
    return funcs


def _check_forward_cores(report) -> None:
    """Every instance of the register-resident forward core keeps 0 spill
    bytes; #1's and #5's v0 instance at 13 key tiles and each of #15's
    forms at every key-tile count are built. Prints the registers of each
    and the shared memory a block of each mode takes at S 196 and 256, the
    parked p beyond v0's staged k and v."""
    fwd = {}
    for name, v in report.items():
        m = REG_FWD_ARGS.search(name)
        if m:
            hd, kt, rows, order, nosm, recip = m.groups()
            fwd[(int(hd), int(kt), rows, int(order), int(nosm),
                 int(recip))] = v
    check(len(fwd) == sum(REG_FWD_KERNEL in k for k in report),
          f"a {REG_FWD_KERNEL} instance's name does not parse")
    for rows in NEST_ROW_MAPS:
        check((32, 13, rows, 0, 0, 0) in fwd,
              f"ptxas reported no {REG_FWD_KERNEL}<32, 13, {rows}> (v0)")
        nreg, st, ld = fwd[(32, 13, rows, 0, 0, 0)]
        print(f"ptxas {REG_FWD_KERNEL}<32, 13, {rows}, v0> (#1/#5's core): "
              f"{nreg} registers, spill stores {st} bytes, spill loads {ld} "
              "bytes")
    lib = _build.load_library()
    for form, (mode, order, nosm, recip) in SCHED_FORMS.items():
        regs = {k[1]: v[0] for k, v in fwd.items()
                if k[0] == 32 and k[2] == "IdentityRows"
                and k[3:] == (order, nosm, recip)}
        check(len(regs) == 16, f"ptxas reported {len(regs)} key-tile "
              f"instances of #15's {form}, expected 16")
        smem = {s: lib.vlp_attn_sched_core_smem(s, AS.MODES.index(mode))
                for s in (SEQ, 256)}
        park = {s: b - lib.vlp_attn_sched_core_smem(s, 0)
                for s, b in smem.items()}
        print(f"ptxas {REG_FWD_KERNEL} #15 {form}: registers by key tiles "
              f"{dict(sorted(regs.items()))}; a block's shared memory "
              f"{smem[SEQ]} bytes at S {SEQ}, {smem[256]} at 256, "
              + (f"of which parked p {park[SEQ]} / {park[256]}"
                 if park[SEQ] else "nothing parked"))
    spilling = sorted(k for k, (_, st, ld) in report.items()
                      if REG_FWD_KERNEL in k and (st or ld))
    print(f"ptxas {REG_FWD_KERNEL}: {len(fwd)} instances, {len(spilling)} "
          "spilling")
    check(not spilling, f"{REG_FWD_KERNEL} instances spill: {spilling}")


def _check_hopper_units() -> None:
    """The wgmma + TMA kernels reach Hopper's units: their SASS holds HGMMA
    (wgmma) and UTMALDG (TMA loads), ptxas reports 0 spill bytes for every
    instance and serializes none of their wgmma; every instance of the
    register-resident attention cores, forward and backward, keeps 0 spill
    bytes, #1's, #3's, #5's, #6's and #15's among them."""
    report, serial = _ptxas_report(_build.build_log().read_text())
    mine = {k: v for k, v in report.items() if WGMMA_KERNEL in k}
    for name, (nreg, st, ld) in sorted(mine.items()):
        print(f"ptxas {name}: {nreg} registers, spill stores {st} bytes, "
              f"spill loads {ld} bytes")
    check(len(mine) == WGMMA_INSTANCES,
          f"ptxas reported {len(mine)} {WGMMA_KERNEL} instances, expected "
          f"{WGMMA_INSTANCES}")
    check(all(any(f in k for k in mine) for f in WGMMA_FORMS),
          f"a form of {WGMMA_FORMS} has no {WGMMA_KERNEL} instance")
    check(all(st == 0 and ld == 0 for _, st, ld in mine.values()),
          "a wgmma_gemm_kernel instance spills")
    for form, want in WGMMA_DUALS.items():
        dual = sorted(v[0] for k, v in mine.items() if form in k)
        check(len(dual) == want, f"ptxas reported {len(dual)} {form} "
              f"instances, expected {want}")
        print(f"ptxas dual tile {form} "
              f"({'#14' if want == 2 else '#4/#10'}): {dual} registers, 0 "
              "spill bytes")
    for form, (want, who) in WGMMA_FWDS.items():
        fwd = {}
        for k, v in mine.items():
            if form in k:
                width = WGMMA_FWD_WIDTH.search(k)
                fwd[int(width.group(1)) if width else k] = v[0]
        check(len(fwd) == want, f"ptxas reported {len(fwd)} {form} "
              f"instances, expected {want}")
        print(f"ptxas forward product {form} ({who}): registers by tile "
              f"width {fwd}, 0 spill bytes")
    check(sum(WGMMA_FWD in k for k in mine) == sum(
        n for n, _ in WGMMA_FWDS.values()),
          f"a {WGMMA_FWD} instance of another form")
    affine = {}
    for k, v in mine.items():
        if WGMMA_AFFINE in k:
            width = WGMMA_AFFINE_WIDTH.search(k)
            affine[int(width.group(1)) if width else k] = v[0]
    check(sorted(affine) == list(WGMMA_AFFINE_WIDTHS),
          f"ptxas reported {WGMMA_AFFINE} instances {sorted(affine)}, "
          f"expected widths {WGMMA_AFFINE_WIDTHS}")
    print(f"ptxas register-A form {WGMMA_AFFINE} (#18): registers by tile "
          f"width {affine}, 0 spill bytes")
    check(not any(IGEMM_KERNEL in k for k in report),
          f"the build still holds an {IGEMM_KERNEL} instance")
    _check_forward_cores(report)
    core = {k: v for k, v in report.items() if REG_BWD_KERNEL in k}
    for rows in NEST_ROW_MAPS:
        found = [v for k, v in core.items()
                 if rows in k and all(a in k for a in REG_BWD_NEST_ARGS)]
        check(len(found) == 1,
              f"ptxas reported no {REG_BWD_KERNEL}<32, 13, {rows}, true>")
        nreg, st, ld = found[0]
        print(f"ptxas {REG_BWD_KERNEL}<32, 13, {rows}, true, false>: {nreg} "
              f"registers, spill stores {st} bytes, spill loads {ld} bytes")
    uni = sorted((k, v) for k, v in core.items() if "Lb1ELb1E" in k)
    check(any(all(a in k for a in REG_BWD_UNI_ARGS) for k, _ in uni),
          f"ptxas reported no {REG_BWD_KERNEL}<32, 13, IdentityRows, true, "
          "true> (#16's uni core)")
    regs = {int(k.split("ILi32ELi")[1].split("E")[0]): v[0]
            for k, v in uni if "ILi32ELi" in k}
    print(f"ptxas {REG_BWD_KERNEL}<32, KT, IdentityRows, true, true> (#16's "
          f"uni core): registers by key tiles {dict(sorted(regs.items()))}, "
          f"spill bytes {sum(st + ld for _, (_, st, ld) in uni)}")
    spilling = sorted(k for k, (_, st, ld) in core.items() if st or ld)
    print(f"ptxas {REG_BWD_KERNEL}: {len(core)} instances, "
          f"{len(spilling)} spilling")
    check(not spilling, f"{REG_BWD_KERNEL} instances spill: {spilling}")
    bad = [line for line in serial if WGMMA_KERNEL in line]
    check(not bad, f"ptxas serializes wgmma: {bad}")
    cuobjdump = str(Path(_build.find_nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass",
                           str(_build.library_path())], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    every = _sass_functions(sass)
    check(not any(IGEMM_KERNEL in k for k in every),
          f"the library's SASS still holds an {IGEMM_KERNEL}")
    funcs = {k: v for k, v in every.items() if WGMMA_KERNEL in k}
    check(len(funcs) == WGMMA_INSTANCES,
          f"SASS holds {len(funcs)} {WGMMA_KERNEL} instances, expected "
          f"{WGMMA_INSTANCES}")
    for name, body in sorted(funcs.items()):
        hgmma, utma = body.count("HGMMA"), body.count("UTMALDG")
        print(f"sass {name}: {hgmma} HGMMA, {utma} UTMALDG")
        check(hgmma > 0 and utma > 0, f"{name}: no HGMMA or no UTMALDG")


def _inputs(gen, n, d):
    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = rand(n, SEQ, d).bfloat16()
    attn = (1.0 + rand(d, scale=0.1), rand(d, scale=0.1),
            rand(d, 3 * d, scale=d ** -0.5).bfloat16(),
            rand(3 * d, scale=0.02), rand(d, d, scale=d ** -0.5).bfloat16(),
            rand(d, scale=0.02))
    mlp = (1.0 + rand(d, scale=0.1), rand(d, scale=0.1),
           rand(d, 4 * d, scale=d ** -0.5).bfloat16(), rand(4 * d, scale=0.02),
           rand(4 * d, d, scale=(4 * d) ** -0.5).bfloat16(),
           rand(d, scale=0.02))
    return x, attn, mlp


def _err(out, ref):
    diff = (out.float() - ref.float()).abs().max().item()
    return diff, diff / ref.float().abs().max().item()


def _timed_pair(plain, kern):
    """Median ms of plain and kernel, taken as plain, kernel, kernel,
    plain so that both see the same card state."""
    p1, k1, k2, p2 = (_median_ms(fn) for fn in (plain, kern, kern, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def _check_outputs(name, where, outs, refs, refs32, labels, bound,
                   bound32, stat):
    """Each output against the plain bf16 (``bound``) and fp32
    (``bound32``) versions, relative to the reference's largest value."""
    worst = worst32 = 0.0
    each = []
    for label, out, ref, ref32 in zip(labels, outs, refs, refs32):
        check(out.shape == ref.shape and out.dtype == ref.dtype,
              f"{name} {label}: {out.dtype}{tuple(out.shape)} vs "
              f"{ref.dtype}{tuple(ref.shape)}")
        check(bool(torch.isfinite(out.float()).all()),
              f"{name} {where} {label}: non-finite")
        a, r = _err(out, ref)
        r32 = _err(out, ref32)[1]
        check(r <= bound, f"{name} {where} {label}: {r:.3g} > {bound}")
        check(r32 <= bound32, f"{name} {where} {label}: {r32:.3g} > "
              f"{bound32} vs fp32")
        stat["max_abs_err"] = max(stat["max_abs_err"], a)
        worst, worst32 = max(worst, r), max(worst32, r32)
        each.append(f"{label} {r:.4g}/{r32:.4g}")
    print(f"kernel {name} {where}: worst rel vs plain bf16 {worst:.6g} "
          f"(bound {bound:g}), vs plain fp32 {worst32:.6g} (bound "
          f"{bound32:g}); each bf16/fp32: {', '.join(each)}")


def _calls(n, d, heads, x, attn, mlp):
    """(name, kernel fn, plain fn, fp32 plain fn) of one level's shapes."""
    f32 = [t.float() for t in attn]
    f32m = [t.float() for t in mlp]
    rows = x.reshape(n * SEQ, d)
    return (
        ("ln_attention",
         lambda: FB.ln_attention(x, *attn, heads),
         lambda: FB.ln_attention_plain(x, *attn, heads),
         lambda: FB.ln_attention_plain(x.float(), *f32, heads)),
        ("ln_mlp",
         lambda: FB.ln_mlp(rows, *mlp),
         lambda: FB.ln_mlp_plain(rows, *mlp),
         lambda: FB.ln_mlp_plain(rows.float(), *f32m)),
    )


def _bf16_ulps(a, b):
    """Distance of two bf16 tensors in steps of the format."""
    def ordered(t):
        k = t.view(torch.int16).to(torch.int32)
        return torch.where(k < 0, -(k & 0x7FFF), k)
    return (ordered(a) - ordered(b)).abs()


def _h_vs_dual_tile(rows, mlp):
    """#2's h (its forward's bias + GELU epilogue) and the h that #4's dual
    tile recomputes from #2's ln on the same rows: (largest distance in
    bf16 ulps, elements apart, elements)."""
    lib = _build.load_library()
    m, d = rows.shape
    f = 4 * d
    (g, b, b1, b2), (w1, w2) = FB._cast(
        torch.bfloat16, vectors=(mlp[0], mlp[1], mlp[3], mlp[5]),
        matrices=(mlp[2], mlp[4]))
    ln, y, dy = (torch.empty_like(rows) for _ in range(3))
    h, h_dual, dh = (torch.empty(m, f, dtype=torch.bfloat16, device="cuda")
                     for _ in range(3))
    col = torch.empty(-(-m // 128), f, device="cuda")
    err = lib.vlp_ln_mlp(rows.data_ptr(), g.data_ptr(), b.data_ptr(),
                         w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                         b2.data_ptr(), ln.data_ptr(), h.data_ptr(),
                         y.data_ptr(), m, d, f, 1e-6, FB._stream())
    _build.check(lib, err, "ln_mlp")
    dy.copy_(rows)
    err = lib.vlp_mlp_dual(ln.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                           dy.data_ptr(), w2.data_ptr(), h_dual.data_ptr(),
                           dh.data_ptr(), col.data_ptr(), m, d, f,
                           FB._stream())
    _build.check(lib, err, "mlp_dual")
    ulps = _bf16_ulps(h, h_dual)
    return ulps.max().item(), int((ulps > 0).sum().item()), ulps.numel()


def _ln_attention_parts(where, x, attn, heads, stat):
    """#1's y and the qkv and o it leaves for the backward against the
    plain pieces (bf16 and fp32), its o bit-equal to #7 ``attend_qkv`` on
    the same qkv (one core), and a rerun bit-equal."""
    (g, b, bq, bo), (wq, wo) = FB._cast(
        torch.bfloat16, vectors=(attn[0], attn[1], attn[3], attn[5]),
        matrices=(attn[2], attn[4]))
    outs = FB._ln_attention_cuda(x, g, b, wq, bq, wo, bo, heads)
    torch.cuda.synchronize()
    _check_outputs("ln_attention", where, outs,
                   FB.ln_attention_plain_parts(x, *attn, heads),
                   FB.ln_attention_plain_parts(
                       x.float(), *[t.float() for t in attn], heads),
                   ("y", "qkv", "o"), BOUND_VS_PLAIN_BF16,
                   BOUND_VS_PLAIN_FP32, stat)
    check(torch.equal(outs[2], BA.attend_qkv(outs[1], heads)),
          f"ln_attention {where}: o differs from attend_qkv on its qkv")
    again = FB._ln_attention_cuda(x, g, b, wq, bq, wo, bo, heads)
    check(all(torch.equal(a, c) for a, c in zip(outs, again)),
          f"ln_attention {where}: reruns differ")
    print(f"kernel ln_attention {where}: o bit-equal to attend_qkv on its "
          "qkv; y, qkv and o bit-equal on a rerun")


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = {name: _stat() for name in ("ln_attention", "ln_mlp")}
    for nb, d, heads, depth in LEVELS:
        n = BATCH * nb
        x, attn, mlp = _inputs(gen, n, d)
        for name, kern, plain, plain32 in _calls(n, d, heads, x, attn, mlp):
            if name == "ln_attention":
                _ln_attention_parts(f"N={n} S={SEQ} D={d}", x, attn, heads,
                                    stats[name])
            else:
                out = kern()
                torch.cuda.synchronize()
                _check_outputs(name, f"N={n} S={SEQ} D={d}", (out,),
                               (plain(),), (plain32(),), ("y",),
                               BOUND_VS_PLAIN_BF16, BOUND_VS_PLAIN_FP32,
                               stats[name])
                del out
            k_ms, p_ms = _timed_pair(plain, kern)
            print(f"time {name} N={n} S={SEQ} D={d} (batch {BATCH}): kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms per call")
            _add(stats[name], depth, k_ms, p_ms,
                 _work(name, n, SEQ, d) if name == "ln_attention"
                 else _work(name, n * SEQ, 1, d))
        # the ragged request's samples and rows, and #2's h against #4's
        _ln_attention_parts(f"N={RAGGED * nb} S={SEQ} D={d} ({RAGGED} "
                            "images)", x[:RAGGED * nb], attn, heads,
                            stats["ln_attention"])
        rows = x[:RAGGED * nb].reshape(-1, d)
        f32m = [t.float() for t in mlp]
        out = FB.ln_mlp(rows, *mlp)
        torch.cuda.synchronize()
        where = f"M={rows.shape[0]} D={d} ({RAGGED} images)"
        _check_outputs("ln_mlp", where, (out,), (FB.ln_mlp_plain(rows, *mlp),),
                       (FB.ln_mlp_plain(rows.float(), *f32m),), ("y",),
                       BOUND_VS_PLAIN_BF16, BOUND_VS_PLAIN_FP32,
                       stats["ln_mlp"])
        check(torch.equal(out, FB.ln_mlp(rows, *mlp)),
              f"ln_mlp {where}: reruns differ")
        most, apart, total = _h_vs_dual_tile(x.reshape(-1, d), mlp)
        check(most <= 1, f"ln_mlp D={d}: h {most} bf16 ulps from the dual "
              "tile's")
        same = "bit-equal" if apart == 0 else \
            f"{apart} of {total} elements 1 bf16 ulp apart"
        print(f"kernel ln_mlp D={d}: h against #4's dual tile on the same "
              f"ln: {same}")
        del out, rows
        del x, attn, mlp
        torch.cuda.empty_cache()
    return stats


def _add(stat, calls, k_ms, p_ms, work, lib_ms=None):
    """Adds `calls` calls of median times k_ms, p_ms (and lib_ms) and their
    work to a kernel's per-step totals."""
    stat["ms"] += calls * k_ms
    stat["plain_ms"] += calls * p_ms
    stat["flops"] += calls * work[0]
    stat["bytes"] += calls * work[1]
    if lib_ms is not None:
        stat["library_ms"] = (stat["library_ms"] or 0.0) + calls * lib_ms


def phase_serve(smi: str, key: str, batch: int, requests, per_forward,
                nhwc: bool = False):
    """``Predictor`` for ``experiment=key`` at ``batch`` answers
    ``requests``; every kernel launches ``per_forward[name]`` times per
    forward (0 where unnamed); logits vs fp32 on the CPU; latency. With
    ``nhwc`` the NesT backbone's ``nhwc_windows`` is set, and the logits and
    latency are also held against the blockified path."""
    cfg = EXPERIMENTS[key]
    check(cfg.precision == "bf16" and cfg.image_size == 224,
          f"unexpected experiment config {cfg}")
    pred = Predictor(cfg, None, mean=128.0, std=64.0, batch_size=batch,
                     device="cuda")
    if nhwc:
        pred.task.model.backbone.nhwc_windows = True
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, 256, (k, 224, 224), dtype=np.uint8)
            for k in requests]
    pred.predict_arrays(reqs[-1][:1])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    _reset_counts()
    probs = [pred.predict_arrays(r) for r in reqs]
    launches = _counts()
    forwards = sum(-(-k // batch) for k in requests)
    print(f"serve {key}: answered requests of {list(requests)} images in "
          f"{forwards} batch-{batch} forwards; launches {launches}")
    for name, count in launches.items():
        want = per_forward.get(name, 0) * forwards
        check(count == want, f"{name}: {count} launches, expected {want}")
    for p, k in zip(probs, requests):
        check(p.shape == (k,) and bool(np.all(np.isfinite(p)))
              and bool(np.all((p >= 0) & (p <= 1))),
              "probabilities must be finite and in [0, 1]")

    stats = _running_stats(pred.task.model)
    logits = pred.predict_logits(reqs[0][:8])
    full = pred.predict_logits(reqs[0])[:8]
    gap = float(np.abs(full - logits).max())
    print(f"serve {key}: logits[:8] alone vs inside the full request: "
          f"bit-equal {bool(np.array_equal(full, logits))}, max_abs {gap:.6g}")
    check(gap <= BOUND_BATCH_INDEPENDENCE * max(1.0, float(np.abs(
        full).max())), f"an image's logit depends on its batch by {gap}")
    check(all(torch.equal(a, b) for a, b in zip(
        stats, _running_stats(pred.task.model))),
        "serving changed the running statistics")
    ref = Predictor(dataclasses.replace(cfg, precision="fp32"), None,
                    mean=128.0, std=64.0, batch_size=8, device="cpu")
    ref.task.model.load_state_dict(pred.task.model.state_dict())
    if nhwc:
        ref.task.model.backbone.nhwc_windows = True
    ref_logits = ref.predict_logits(reqs[0][:8])
    err = float(np.abs(logits - ref_logits).max())
    bound = BOUND_LOGITS * max(1.0, float(np.abs(ref_logits).max()))
    print(f"serve {key}: logits[:8] bf16 on GPU vs fp32 on CPU: max_abs "
          f"{err:.6g} (bound {bound:.6g}); gpu {np.round(logits, 4).tolist()}"
          f" cpu {np.round(ref_logits, 4).tolist()}")
    check(err <= bound, f"logits differ by {err:.4g} > {bound:.4g}")

    if nhwc:
        _serve_vs_blockified(smi, key, pred, reqs[0], logits)

    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        pred.predict_arrays(reqs[0])
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    full = pred._batch(reqs[0], None)
    fwd_ms = _median_ms(lambda: pred.task.eval_fn(full))
    print(f"serve {key}{' nhwc_windows' if nhwc else ''}: batch-{batch} "
          f"request latency median "
          f"{med * 1e3:.3f} ms (min {min(times) * 1e3:.3f}, max "
          f"{max(times) * 1e3:.3f}, n=10), {batch / med:.1f} images/s; "
          f"device forward {fwd_ms:.3f} ms; on {smi}")
    del pred, ref
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items() if v}


def _serve_vs_blockified(smi, key, pred, request, logits):
    """The windowed path's logits against the blockified path's on the same
    weights on the card; whether the patch convolution and the pools leave
    the map contiguous (else the level's ``.contiguous()`` copies); the
    request latency of both paths in alternating turns."""
    backbone = pred.task.model.backbone
    backbone.nhwc_windows = False
    blocked = pred.predict_logits(request[:8])
    backbone.nhwc_windows = True
    diff = float(np.abs(logits - blocked).max())
    print(f"serve {key}: logits[:8] nhwc_windows vs blockified on the card: "
          f"bit-equal {bool(np.array_equal(logits, blocked))}, max_abs "
          f"{diff:.6g}")
    check(diff <= BOUND_LOGITS * max(1.0, float(np.abs(blocked).max())),
          f"nhwc_windows logits differ from the blockified path's by {diff}")
    with torch.inference_mode():
        x = pred.task._prep_eval(pred._batch(request, None))
        x = conv_nhwc(x.to(backbone.dtype), backbone.patch_embed,
                      backbone.patch_size, 0)
        layout = [x.is_contiguous()]
        for pool in backbone.pools:
            x = pool(x)
            layout.append(x.is_contiguous())
    print(f"serve {key}: NHWC map contiguous after the patch conv, pool0, "
          f"pool1: {layout}")
    times = {False: [], True: []}
    for r in range(AB_ROUNDS):
        for flag in ((False, True) if r % 2 == 0 else (True, False)):
            backbone.nhwc_windows = flag
            for _ in range(AB_STEPS):
                t0 = time.perf_counter()
                pred.predict_arrays(request)
                times[flag].append(time.perf_counter() - t0)
    backbone.nhwc_windows = True
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    print(f"serve {key}: batch-{len(request)} request latency in alternating "
          f"turns ({AB_ROUNDS} x {AB_STEPS} each): nhwc_windows median "
          f"{med[True]:.3f} ms (min {min(times[True]) * 1e3:.3f}), "
          f"blockified {med[False]:.3f} ms (min "
          f"{min(times[False]) * 1e3:.3f}); on {smi}")


KERNELS = (*FB.KERNELS, *BA.KERNELS, *FM.KERNELS, SH.shear_rows,
           NZ.add_gaussian_noise, *CV.KERNELS, *BG.KERNELS, *MT.KERNELS,
           *AS.KERNELS)


def _reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def _counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


BWD_NAMES = {"ln_attention_bwd": ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv",
                                  "dwout", "dbout"),
             "ln_mlp_bwd": ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2",
                            "db2")}


def _bwd_calls(n, d, heads, x, attn, mlp, dy):
    """(name, kernel fn, plain fn, fp32 plain fn) of one level's backward
    shapes; the attention kernel reads the forward launch's qkv and o."""
    (g, b, bq, bo), (wq, wo) = FB._cast(
        torch.bfloat16, vectors=(attn[0], attn[1], attn[3], attn[5]),
        matrices=(attn[2], attn[4]))
    _, qkv, o = FB._ln_attention_cuda(x, g, b, wq, bq, wo, bo, heads)
    rows, drows = x.reshape(n * SEQ, d), dy.reshape(n * SEQ, d)
    (g2, b2, b1, _), (w1, w2) = FB._cast(
        torch.bfloat16, vectors=(mlp[0], mlp[1], mlp[3], mlp[5]),
        matrices=(mlp[2], mlp[4]))
    return (
        ("ln_attention_bwd",
         lambda: FB.ln_attention_bwd(x, g, b, wq, bq, wo, dy, heads, qkv, o),
         lambda: FB.ln_attention_bwd_plain(x, g, b, wq, bq, wo, dy, heads),
         lambda: FB.ln_attention_bwd_plain(x.float(), g, b, wq.float(), bq,
                                           wo.float(), dy.float(), heads)),
        ("ln_mlp_bwd",
         lambda: FB.ln_mlp_bwd(rows, g2, b2, w1, b1, w2, drows),
         lambda: FB.ln_mlp_bwd_plain(rows, g2, b2, w1, b1, w2, drows),
         lambda: FB.ln_mlp_bwd_plain(rows.float(), g2, b2, w1.float(), b1,
                                     w2.float(), drows.float())),
    )


def phase_train_kernels():
    gen = torch.Generator(device="cuda").manual_seed(1)
    stats = {name: _stat() for name in ("ln_attention_bwd", "ln_mlp_bwd",
                                        "shear_rows", "add_gaussian_noise")}
    for nb, d, heads, depth in LEVELS:
        n = BATCH * nb
        x, attn, mlp = _inputs(gen, n, d)
        dy = torch.randn(n, SEQ, d, generator=gen, device="cuda").bfloat16()
        for name, kern, plain, plain32 in _bwd_calls(n, d, heads, x, attn,
                                                     mlp, dy):
            outs = kern()
            torch.cuda.synchronize()
            where = f"N={n} S={SEQ} D={d}"
            _check_outputs(name, where, outs, plain(), plain32(),
                           BWD_NAMES[name], BOUND_BWD_BF16, BOUND_BWD_FP32,
                           stats[name])
            check(all(torch.equal(a, b) for a, b in zip(outs, kern())),
                  f"{name} {where}: reruns differ")
            print(f"kernel {name} {where}: reruns bit-equal")
            del outs
            k_ms, p_ms = _timed_pair(plain, kern)
            print(f"time {name} N={n} S={SEQ} D={d} (batch {BATCH}): kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms per call")
            _add(stats[name], depth, k_ms, p_ms,
                 _work(name, n, SEQ, d) if name == "ln_attention_bwd"
                 else _work(name, n * SEQ, 1, d))
        del x, attn, mlp, dy
        torch.cuda.empty_cache()

    stats["shear_rows"].update(_check_shear(gen))
    stats["add_gaussian_noise"].update(_check_noise(gen))
    _augment_times(stats)
    return stats


# shear_rows' exactness checks: (label, B, H, W, max_shift, shifts), each
# on both axes; shifts "warp" are the warp's ramps at the augmentation's
# full ranges, "random" N(0, 60^2), "wide" N(0, (2 max_shift)^2) (beyond
# the clip), "edge" exactly +-max_shift and integers in between (fraction
# 0); max_shift 40 > W = 30 and 250 > W = 225 reach past the line
SHEAR_CHECKS = (
    ("warp", 64, 224, 224, None, "warp"),
    ("random", 64, 224, 224, None, "random"),
    ("warp", 128, 224, 224, None, "warp"),
    ("random", 128, 224, 224, None, "random"),
    ("ragged", 3, 17, 30, 10, "random"),
    ("ragged", 2, 224, 225, None, "warp"),
    ("beyond", 3, 17, 30, 40, "wide"),
    ("beyond", 2, 224, 225, 250, "wide"),
    ("edge", 64, 224, 224, None, "edge"),
    ("edge", 3, 17, 30, 10, "edge"))
# add_gaussian_noise's widths: 224 (112 words a row: the 16-byte path) and
# 226 (113: four words may cross a row's end, the scalar path)
NOISE_WIDTHS = (224, 226)


def _shear_shift(gen, kind, b, n, axis, ms):
    """[b, n] shifts of one check along ``axis`` (n lines)."""
    if kind == "warp":  # the x-shear's row ramp, the y-shear's column ramp
        params = augment_probe.warp_params(b, gen)
        return shear_shifts(*params, n, n)[1 - axis]
    scale = {"random": augment_probe.RANDOM_SHIFT, "wide": 2.0 * ms}
    if kind in scale:
        return torch.randn(b, n, generator=gen, device="cuda") * scale[kind]
    ints = torch.randint(-ms, ms + 1, (b, n), generator=gen,
                         device="cuda").float()
    ints[:, 0::3] = float(ms)
    ints[:, 1::3] = -float(ms)
    return ints


def _check_shear(gen):
    """Each of SHEAR_CHECKS on both axes bit-equal to the plain version,
    one launch a call; returns the largest error."""
    worst = 0.0
    for label, b, h, w, ms, kind in SHEAR_CHECKS:
        ms = default_max_shift(h, w) if ms is None else ms
        img = torch.randint(0, 256, (b, h, w), generator=gen,
                            device="cuda").float()
        for axis in (1, 0):
            n = h if axis == 1 else w
            shift = _shear_shift(gen, kind, b, n, axis, ms).contiguous()
            before = SH.shear_rows.launches
            out = SH.shear_rows(img, shift, ms, axis)
            check(SH.shear_rows.launches == before + 1,
                  "shear_rows: one launch a call")
            a = (out - SH.shear_rows_plain(img, shift, ms, axis)).abs() \
                .max().item()
            print(f"kernel shear_rows [{b}, {h}, {w}] axis {axis} "
                  f"max_shift {ms} {label} shifts ({kind}): max_abs vs "
                  f"plain {a:.6g} (bound {BOUND_SHEAR:g})")
            check(a <= BOUND_SHEAR, f"shear_rows [{b}, {h}, {w}] axis "
                  f"{axis} {kind}: {a:.3g}")
            worst = max(worst, a)
    return {"max_abs_err": worst}


def _check_noise(gen):
    """Philox's known answers; at each of NOISE_WIDTHS the kernel's words
    equal to the plain version's, values within BOUND_NOISE, sigma 0 the
    identity; the moments of one sigma-1 draw. Returns the largest
    error."""
    kat = ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"), \
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         "408f276d 41c83b0e a20bc7c6 6d5451fd"), \
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xa4093822, 0x299f31d0), "d16cfe09 94fdcceb 5001e420 24126ea1")
    for ctr, key, want in kat:
        got = NZ.philox4x32(torch.tensor([ctr], device="cuda"),
                            torch.tensor([key], device="cuda"))
        got = " ".join(f"{int(v):08x}" for v in got[0].tolist())
        check(got == want, f"philox4x32 {ctr} {key}: {got} != {want}")
    print("kernel philox4x32: Random123 known-answer vectors equal")
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (BATCH, 2), generator=gen,
                          device="cuda", dtype=torch.int32)
    ones = torch.ones(BATCH, device="cuda")
    worst = 0.0
    for w in NOISE_WIDTHS:
        half = w // 2
        groups = -(-224 * half // 4)
        ctr = torch.zeros(BATCH * groups, 4, dtype=torch.long, device="cuda")
        ctr[:, 0] = torch.arange(groups, device="cuda").repeat(BATCH)
        key = (seeds.long() & 0xFFFFFFFF).repeat_interleave(groups, 0)
        words = NZ.philox4x32(ctr, key).reshape(BATCH, -1)[:, :224 * half]
        check(torch.equal(words.reshape(BATCH, 224, half),
                          NZ.noise_words_plain(seeds, 224, w)),
              f"noise words at W {w} differ from the plain version's")
        print(f"kernel philox4x32: the {words.numel()} words of a "
              f"[64, 224, {w}] draw equal the plain version's")
        del ctr, key, words
        x = torch.rand(BATCH, 224, w, generator=gen, device="cuda") * 256.0
        before = NZ.add_gaussian_noise.launches
        out = NZ.add_gaussian_noise(x, seeds, ones)
        check(NZ.add_gaussian_noise.launches == before + 1,
              "add_gaussian_noise: one launch a call")
        a = (out - NZ.add_gaussian_noise_plain(x, seeds, ones)).abs() \
            .max().item()
        print(f"kernel add_gaussian_noise [64, 224, {w}] sigma 1: max_abs "
              f"vs plain {a:.6g} (bound {BOUND_NOISE:g})")
        check(a <= BOUND_NOISE, f"add_gaussian_noise W {w}: {a:.3g} > "
              f"{BOUND_NOISE}")
        worst = max(worst, a)
        check(torch.equal(NZ.add_gaussian_noise(x, seeds,
                                                torch.zeros_like(ones)), x),
              f"sigma 0 must leave x unchanged (W {w})")
        z = NZ.add_gaussian_noise(torch.zeros_like(x), seeds, ones).double()
        mean, var = z.mean().item(), z.var().item()
        # 3.2M draws: the mean within 4 standard errors; the variance
        # within 1% (its standard error is sqrt(2 / n) = 0.08%)
        print(f"kernel add_gaussian_noise [64, 224, {w}] sigma 1: mean "
              f"{mean:.6g}, var {var:.6g} over {z.numel()} draws")
        check(abs(mean) < 4 / z.numel() ** 0.5 and abs(var - 1) < 0.01,
              f"noise moments off (W {w})")
        del x, out, z
    return {"max_abs_err": worst}


def _augment_times(stats):
    """#11 and #12 per training step at batch 64 (three shears: rows,
    columns, rows at the warp's ramps; one noise call at the step's
    sigmas): kernel and plain in turns on CUDA events; then the augment
    probe at batch 64 and 128, device time alone warm and cold beside
    ``F.grid_sample`` and ``torch.normal``."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = augment_probe.cases(BATCH, gen)
    per_step = {"shear_rows": (("shear_ax1_ramp", 2), ("shear_ax0_ramp", 1)),
                "add_gaussian_noise": (("noise", 1),)}
    for name, parts in per_step.items():
        for case_name, calls in parts:
            case = cases[case_name]
            k_ms, p_ms = _timed_pair(case.plain, case.kernel)
            print(f"time {name} {case_name} [64, 224, 224]: kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms per call")
            px = BATCH * 224 * 224
            # shear: the fp32 image read and written, one shift a line, a
            # lerp (3 operations) a pixel; noise: x read and written, the
            # seeds and sigmas, about 10 fp32 operations a value
            # (Box-Muller's log, sqrt, cos or sin, and the scaling),
            # Philox's integer products not counted
            work = ((3 * px, 8 * px + 4 * BATCH * 224)
                    if name == "shear_rows" else
                    (10 * px, 8 * px + 12 * BATCH))
            _add(stats[name], calls, k_ms, p_ms, work)
    del cases
    records = augment_probe.run(augment_probe.BATCHES, seed=4)
    for name, parts in per_step.items():
        at64 = {r["case"]: r for r in records if r["batch"] == BATCH}
        for key, field in (("library_ms", "library_event_ms"),
                           ("kernel_device_ms", "kernel_warm_ms"),
                           ("library_device_ms", "library_warm_ms"),
                           ("kernel_device_cold_ms", "kernel_cold_ms"),
                           ("library_device_cold_ms", "library_cold_ms")):
            stats[name][key] = sum(calls * at64[c][field]
                                   for c, calls in parts)
        stats[name]["per_shape"] = {}
    for r in records:
        name = "add_gaussian_noise" if r["case"] == "noise" else "shear_rows"
        bound = (BOUND_NOISE if r["case"] == "noise" else BOUND_SHEAR)
        check(r["max_abs_err"] <= bound, f"augment probe {r['case']} batch "
              f"{r['batch']}: {r['max_abs_err']:.3g} > {bound}")
        print(f"device {r['case']} [{r['batch']}, 224, 224]: kernel warm "
              f"{r['kernel_warm_ms'] * 1e3:.2f} us "
              f"({100 * r['kernel_share_warm']:.1f}% of the bound), cold "
              f"{r['kernel_cold_ms'] * 1e3:.2f} us "
              f"({100 * r['kernel_share_cold']:.1f}%), event "
              f"{r['kernel_event_ms'] * 1e3:.2f} us (host "
              f"{r['host_ms'] * 1e3:.2f} us); library warm "
              f"{r['library_warm_ms'] * 1e3:.2f} us, cold "
              f"{r['library_cold_ms'] * 1e3:.2f} us "
              f"({100 * r['library_share_cold']:.1f}%); bound "
              f"{r['bound_ms'] * 1e3:.2f} us")
        stats[name]["per_shape"][f"{r['case']}_b{r['batch']}"] = {
            k: r[k] for k in ("kernel_warm_ms", "kernel_cold_ms",
                              "kernel_event_ms", "host_ms",
                              "library_warm_ms", "library_cold_ms",
                              "library_event_ms", "bound_ms")}
    torch.cuda.empty_cache()


def _dqkv_parts(t, d):
    return t[..., :d], t[..., d:2 * d], t[..., 2 * d:]


def phase_unfused_kernels():
    """Phase 7: #7-#10 against their plain versions at the shapes of the
    unfused path, then timed (plain, kernel, kernel, plain) beside SDPA.
    Returns per-step totals of each kernel on ViT-B/16 (#7, #8) or NesT
    unfused (#9, #10), and NesT unfused's #7/#8 totals."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    stats = {name: _stat() for name in ("attend_qkv", "attend_qkv_bwd",
                                        "fused_mlp", "fused_mlp_bwd")}
    nest = {name: _stat() for name in ("attend_qkv", "attend_qkv_bwd")}
    for label, n, s, d, heads, calls in (VIT_ATTN, *NEST_ATTN):
        where = f"{label} N={n} S={s} D={d} H={heads}"
        qkv = (torch.randn(n, s, 3 * d, generator=gen, device="cuda")
               * 1.5).bfloat16()
        do = torch.randn(n, s, d, generator=gen, device="cuda").bfloat16()
        tot = stats if label == VIT_ATTN[0] else nest
        out = BA.attend_qkv(qkv, heads)
        torch.cuda.synchronize()
        _check_outputs("attend_qkv", where, (out,),
                       (BA.attend_qkv_plain(qkv, heads),),
                       (BA.attend_qkv_plain(qkv.float(), heads),), ("o",),
                       BOUND_VS_PLAIN_BF16, BOUND_VS_PLAIN_FP32,
                       tot["attend_qkv"])
        dqkv = BA.attend_qkv_bwd(qkv, do, heads)
        torch.cuda.synchronize()
        _check_outputs(
            "attend_qkv_bwd", where, _dqkv_parts(dqkv, d),
            _dqkv_parts(BA.attend_qkv_bwd_plain(qkv, do, heads), d),
            _dqkv_parts(BA.attend_qkv_bwd_plain(qkv.float(), do.float(),
                                                heads), d),
            ("dq", "dk", "dv"), BOUND_BWD_BF16, BOUND_BWD_FP32,
            tot["attend_qkv_bwd"])
        check(torch.equal(dqkv, BA.attend_qkv_bwd(qkv, do, heads)),
              f"attend_qkv_bwd {where}: reruns differ")
        checked, mismatches = BA.attend_qkv_bwd_checked(qkv, do, heads)
        check(torch.equal(checked, dqkv), f"attend_qkv_bwd {where}: the "
              "checked run differs")
        check(mismatches == 0, f"attend_qkv_bwd {where}: the recomputed p "
              f"and ds differ from phase A's in {mismatches} elements")
        print(f"kernel attend_qkv_bwd {where}: reruns bit-equal; the "
              "recomputed p and ds bit-equal to phase A's")
        del out, dqkv, checked
        torch.cuda.empty_cache()
        # the library's yardstick on the same q, k, v views: SDPA forward,
        # and its autograd backward alone
        ql, kl, vl = qkv.detach().requires_grad_().view(
            n, s, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        dol = do.view(n, s, heads, d // heads).transpose(1, 2)
        with torch.no_grad():
            lib_f = statistics.mean(_median_ms(
                lambda: F.scaled_dot_product_attention(ql, kl, vl))
                for _ in range(2))
        ol = F.scaled_dot_product_attention(ql, kl, vl)
        lib_b = statistics.mean(_median_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), dol, retain_graph=True)) for _ in range(2))
        del ql, kl, vl, ol
        for name, kern, plain, lib in (
                ("attend_qkv", lambda: BA.attend_qkv(qkv, heads),
                 lambda: BA.attend_qkv_plain(qkv, heads), lib_f),
                ("attend_qkv_bwd", lambda: BA.attend_qkv_bwd(qkv, do, heads),
                 lambda: BA.attend_qkv_bwd_plain(qkv, do, heads), lib_b)):
            k_ms, p_ms = _timed_pair(plain, kern)
            print(f"time {name} {where}: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, SDPA {lib:.4f} ms per call")
            _add(tot[name], calls, k_ms, p_ms, _work(name, n, s, d), lib)
        del qkv, do
        torch.cuda.empty_cache()

    for label, n, s, d, _, calls in NEST_ATTN:
        m, f = n * s, 4 * d
        where = f"{label} M={m} D={d} F={f}"
        x = torch.randn(m, d, generator=gen, device="cuda").bfloat16()
        dy = torch.randn(m, d, generator=gen, device="cuda").bfloat16()
        (b1, b2), (w1, w2) = FB._cast(
            torch.bfloat16,
            vectors=(torch.randn(f, generator=gen, device="cuda") * 0.02,
                     torch.randn(d, generator=gen, device="cuda") * 0.02),
            matrices=(torch.randn(d, f, generator=gen, device="cuda")
                      * d ** -0.5,
                      torch.randn(f, d, generator=gen, device="cuda")
                      * f ** -0.5))
        f32 = (w1.float(), b1, w2.float(), b2)
        out = FM.fused_mlp(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        _check_outputs("fused_mlp", where, (out,),
                       (FM.fused_mlp_plain(x, w1, b1, w2, b2),),
                       (FM.fused_mlp_plain(x.float(), *f32),), ("y",),
                       BOUND_VS_PLAIN_BF16, BOUND_VS_PLAIN_FP32,
                       stats["fused_mlp"])
        check(torch.equal(out, FM.fused_mlp(x, w1, b1, w2, b2)),
              f"fused_mlp {where}: reruns differ")
        x37 = x[:m * RAGGED // BATCH]
        _check_outputs("fused_mlp", f"M={x37.shape[0]} D={d} ({RAGGED} "
                       "images)", (FM.fused_mlp(x37, w1, b1, w2, b2),),
                       (FM.fused_mlp_plain(x37, w1, b1, w2, b2),),
                       (FM.fused_mlp_plain(x37.float(), *f32),), ("y",),
                       BOUND_VS_PLAIN_BF16, BOUND_VS_PLAIN_FP32,
                       stats["fused_mlp"])
        outs = FM.fused_mlp_bwd(x, w1, b1, w2, dy)
        torch.cuda.synchronize()
        _check_outputs("fused_mlp_bwd", where, outs,
                       FM.fused_mlp_bwd_plain(x, w1, b1, w2, dy),
                       FM.fused_mlp_bwd_plain(x.float(), f32[0], b1, f32[2],
                                              dy.float()),
                       ("dx", "dw1", "db1", "dw2", "db2"), BOUND_BWD_BF16,
                       BOUND_BWD_FP32, stats["fused_mlp_bwd"])
        check(all(torch.equal(a, b) for a, b in zip(
            outs, FM.fused_mlp_bwd(x, w1, b1, w2, dy))),
            f"fused_mlp_bwd {where}: reruns differ")
        del out, outs
        for name, kern, plain in (
                ("fused_mlp", lambda: FM.fused_mlp(x, w1, b1, w2, b2),
                 lambda: FM.fused_mlp_plain(x, w1, b1, w2, b2)),
                ("fused_mlp_bwd", lambda: FM.fused_mlp_bwd(x, w1, b1, w2, dy),
                 lambda: FM.fused_mlp_bwd_plain(x, w1, b1, w2, dy))):
            k_ms, p_ms = _timed_pair(plain, kern)
            print(f"time {name} {where}: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms per call")
            _add(stats[name], calls, k_ms, p_ms, _work(name, m, 1, d))
        del x, dy, w1, w2
        torch.cuda.empty_cache()
    for name, stat in nest.items():
        _finish(stat)
        print(f"per NesT-unfused step: {name} kernel {stat['ms']:.4f} ms, "
              f"plain {stat['plain_ms']:.4f} ms, SDPA "
              f"{stat['library_ms']:.4f} ms, bound {stat['bound_ms']:.4f} "
              f"ms ({stat['bound_by']})")
    return stats


def phase_window_kernels():
    """Phase 11: #5 and #6 against their plain versions and against #1 and
    #3 on the blockified map, at NesT-Small's level maps at batch 64, then
    timed as plain, kernel, #1/#3, #1/#3, kernel, plain. Returns their
    per-step totals on the NHWC training path."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    stats = {name: _stat() for name in ("ln_attention_windows",
                                        "ln_attention_windows_bwd")}
    names = BWD_NAMES["ln_attention_bwd"]
    for (nb, d, heads, depth), side in zip(LEVELS, SIDES):
        n = BATCH * nb  # windows
        where = f"[{BATCH}, {side}, {side}, {d}] window {WINDOW}"
        x, attn, _ = _inputs(gen, n, d)
        x = x.reshape(BATCH, side, side, d)
        dy = torch.randn(x.shape, generator=gen, device="cuda").bfloat16()
        (g, b, bq, bo), (wq, wo) = FB._cast(
            torch.bfloat16, vectors=(attn[0], attn[1], attn[3], attn[5]),
            matrices=(attn[2], attn[4]))
        bf = (g, b, wq, bq, wo, bo)
        f32 = (g, b, wq.float(), bq, wo.float(), bo)
        y, qkv, o = FB._ln_attention_windows_cuda(x, WINDOW, *bf, heads)
        torch.cuda.synchronize()
        _check_outputs(
            "ln_attention_windows", where, (y,),
            (FB.ln_attention_windows_plain(x, WINDOW, *bf, heads),),
            (FB.ln_attention_windows_plain(x.float(), WINDOW, *f32, heads),),
            ("y",), BOUND_VS_PLAIN_BF16, BOUND_VS_PLAIN_FP32,
            stats["ln_attention_windows"])
        outs = FB.ln_attention_windows_bwd(x, WINDOW, g, b, wq, bq, wo, dy,
                                           heads, qkv, o)
        torch.cuda.synchronize()
        _check_outputs(
            "ln_attention_windows_bwd", where, outs,
            FB.ln_attention_windows_bwd_plain(x, WINDOW, g, b, wq, bq, wo, dy,
                                              heads),
            FB.ln_attention_windows_bwd_plain(x.float(), WINDOW, g, b,
                                              wq.float(), bq, wo.float(),
                                              dy.float(), heads),
            names, BOUND_BWD_BF16, BOUND_BWD_FP32,
            stats["ln_attention_windows_bwd"])
        check(all(torch.equal(a, c) for a, c in zip(
            outs, FB.ln_attention_windows_bwd(x, WINDOW, g, b, wq, bq, wo, dy,
                                              heads, qkv, o))),
            f"ln_attention_windows_bwd {where}: reruns differ")

        # #1 and #3 on the blockified map: the same arithmetic per row and
        # per window, so y, dx and dbqkv (per-window sums in blockify order)
        # are bit-equal; the other weight gradients sum their rows in map
        # order rather than blockify order
        t, tdy = FB._windows(x, WINDOW), FB._windows(dy, WINDOW)
        y1, qkv1, o1 = FB._ln_attention_cuda(t, *bf, heads)
        blocked = FB.ln_attention_bwd(t, g, b, wq, bq, wo, tdy, heads, qkv1,
                                      o1)
        pairs = {"y": (y, FB._unwindows(y1, x, WINDOW)),
                 "qkv": (qkv, FB._unwindows(qkv1, qkv, WINDOW)),
                 "o": (o, FB._unwindows(o1, x, WINDOW)),
                 "dx": (outs[0], FB._unwindows(blocked[0], x, WINDOW)),
                 **{nm: (a, c) for nm, a, c in zip(names[1:], outs[1:],
                                                   blocked[1:])}}
        equal = [nm for nm, (a, c) in pairs.items() if torch.equal(a, c)]
        rel = {nm: _err(a, c)[1] for nm, (a, c) in pairs.items()}
        print(f"kernel ln_attention_windows{{,_bwd}} {where} vs #1/#3 on the "
              f"blockified map: bit-equal {equal}; rel "
              f"{', '.join(f'{nm} {r:.4g}' for nm, r in rel.items())}")
        check({"y", "qkv", "o", "dx", "dbqkv"} <= set(equal),
              f"{where}: y, qkv, o, dx or dbqkv differ from #1/#3's")
        check(max(rel.values()) <= BOUND_BWD_BF16,
              f"{where}: weight gradients differ from #3's beyond the bound")
        check(all(torch.equal(a, c) for a, c in zip(
            (y, qkv, o), FB._ln_attention_windows_cuda(x, WINDOW, *bf,
                                                       heads))),
              f"ln_attention_windows {where}: reruns differ")
        # the ragged request's maps: #5 against plain and against #1 on the
        # blockified map
        xr = x[:RAGGED]
        yr = FB.ln_attention_windows(xr, WINDOW, *bf, heads)
        torch.cuda.synchronize()
        _check_outputs(
            "ln_attention_windows", f"{where} ({RAGGED} images)", (yr,),
            (FB.ln_attention_windows_plain(xr, WINDOW, *bf, heads),),
            (FB.ln_attention_windows_plain(xr.float(), WINDOW, *f32,
                                           heads),),
            ("y",), BOUND_VS_PLAIN_BF16, BOUND_VS_PLAIN_FP32,
            stats["ln_attention_windows"])
        check(torch.equal(yr, FB._unwindows(FB.ln_attention(
            FB._windows(xr, WINDOW), *bf, heads), xr, WINDOW)),
            f"ln_attention_windows {where} ({RAGGED} images): y differs "
            "from #1's on the blockified map")
        del y, outs, blocked, pairs, xr, yr

        for name, kern, plain, blk in (
                ("ln_attention_windows",
                 lambda: FB.ln_attention_windows(x, WINDOW, *bf, heads),
                 lambda: FB.ln_attention_windows_plain(x, WINDOW, *bf, heads),
                 lambda: FB.ln_attention(t, *bf, heads)),
                ("ln_attention_windows_bwd",
                 lambda: FB.ln_attention_windows_bwd(
                     x, WINDOW, g, b, wq, bq, wo, dy, heads, qkv, o),
                 lambda: FB.ln_attention_windows_bwd_plain(
                     x, WINDOW, g, b, wq, bq, wo, dy, heads),
                 lambda: FB.ln_attention_bwd(t, g, b, wq, bq, wo, tdy, heads,
                                             qkv1, o1))):
            p1, k1, b1, b2, k2, p2 = (_median_ms(fn) for fn in (
                plain, kern, blk, blk, kern, plain))
            k_ms, p_ms, b_ms = (k1 + k2) / 2, (p1 + p2) / 2, (b1 + b2) / 2
            print(f"time {name} {where} (batch {BATCH}): kernel {k_ms:.4f} "
                  f"ms, plain {p_ms:.4f} ms, "
                  f"#{1 if name == 'ln_attention_windows' else 3} on the "
                  f"blockified map {b_ms:.4f} ms per call (kernel / "
                  f"blockified {k_ms / b_ms:.4f})")
            _add(stats[name], depth, k_ms, p_ms,
                 _work(name.replace("_windows", ""), n, SEQ, d))
        del x, dy, t, tdy, qkv, o, qkv1, o1, y1
        torch.cuda.empty_cache()
    return stats


def _train_vs_blockified(smi, key, task, step, state, batches, batch_size):
    """The step of the NHWC and the blockified path on one task, in
    alternating turns of ``AB_STEPS`` steps."""
    backbone = task.model.backbone
    times = {False: [], True: []}
    peak = {False: 0, True: 0}
    i = 0
    for r in range(AB_ROUNDS):
        for flag in ((False, True) if r % 2 == 0 else (True, False)):
            backbone.nhwc_windows = flag
            torch.cuda.reset_peak_memory_stats()
            for _ in range(AB_STEPS):
                batch = batches[i % len(batches)]
                i += 1
                t0 = time.perf_counter()
                train_steps(step, state, [batch])
                torch.cuda.synchronize()
                times[flag].append(time.perf_counter() - t0)
            peak[flag] = max(peak[flag], torch.cuda.max_memory_allocated())
    backbone.nhwc_windows = True
    for flag, label in ((True, "nhwc_windows"), (False, "blockified")):
        med = statistics.median(times[flag])
        print(f"train {key}: {label} step in alternating turns "
              f"({AB_ROUNDS} x {AB_STEPS}): median {med * 1e3:.3f} ms (min "
              f"{min(times[flag]) * 1e3:.3f}, max "
              f"{max(times[flag]) * 1e3:.3f}), {batch_size / med:.1f} "
              f"images/s, peak memory {peak[flag] / 2 ** 30:.3f} GiB; on "
              f"{smi}")


def _running_stats(model):
    """Copies of the model's BatchNorm running statistics (none for NesT
    and ViT)."""
    return [b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


def _grad_views(model, grads=True):
    """[(name, gradient or parameter)] of every parameter, the text tower's
    packed q|k|v kernel and bias split into their flax parts
    (``attn.query.weight`` ...), whose gradients differ in kind: the key
    bias's is exactly 0, the key kernel's largely cancels."""
    out = []
    for name, p in model.named_parameters():
        t = p.grad.detach().float().cpu() if grads else p
        m = _PACKED_QKV.match(name)
        if m is None:
            out.append((name, t))
        else:
            out.extend((f"{m[1]}{part}.{m[2]}", c) for part, c in zip(
                ("query", "key", "value"), t.chunk(3, -1)))
    return out


def _grads(task, batch, device):
    task.model.zero_grad(set_to_none=True)
    loss, _ = task.loss_fn({k: torch.from_numpy(v).to(device)
                            for k, v in batch.items()},
                           torch.Generator(device=device))
    loss.backward()
    return [g for _, g in _grad_views(task.model)]


def _grad_gap(a, b):
    """(relative L2 of a against b over all tensors, cosine per tensor)."""
    fa = torch.cat([g.reshape(-1) for g in a]).double()
    fb = torch.cat([g.reshape(-1) for g in b]).double()
    cos = [torch.nn.functional.cosine_similarity(
        x.reshape(1, -1).double(), y.reshape(1, -1).double()).item()
        for x, y in zip(a, b)]
    return ((fa - fb).norm() / fb.norm()).item(), cos


def _check_grads(key, task, tcfg, statics):
    """The ``GRAD_BATCH``-image gradients, augmentation off, both domains:
    bf16 on the card against fp32 on the CPU; with BatchNorm (train mode)
    also fp32 on the card against fp32 on the CPU, with fp32 on the CPU on
    the reversed batch and bf16 on the CPU as the yardsticks."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def built(precision, device):
        t = build_task(dataclasses.replace(tcfg, serve=dataclasses.replace(
            tcfg.serve, precision=precision)), statics, device)
        t.model.load_state_dict(task.model.state_dict())
        backbone = getattr(task.model, "backbone", None)
        if hasattr(backbone, "nhwc_windows"):
            t.model.backbone.nhwc_windows = backbone.nhwc_windows
        return t

    gbatch = batch_for(tcfg, np.random.default_rng(2), GRAD_BATCH)
    names = [n for n, _ in _grad_views(task.model, grads=False)]
    # a tensor whose exact gradient is 0 (the text tower's attention key
    # bias: softmax ignores a shift of a query's scores) holds rounding
    # noise on every side; its cosine says nothing, and it is left out
    held = [i for i, n in enumerate(names) if not n.endswith(ZERO_GRAD)]

    def worst_of(c):
        return min(held, key=lambda i: c[i])

    g_gpu = _grads(built(tcfg.serve.precision, cuda), gbatch, cuda)
    g_cpu = _grads(built("fp32", cpu), gbatch, cpu)
    rel, cos = _grad_gap(g_gpu, g_cpu)
    worst = worst_of(cos)
    if len(held) < len(names):
        top = max(g.abs().max().item() for g in g_cpu)
        noise = max(g_gpu[i].abs().max().item() for i in range(len(names))
                    if i not in held)
        print(f"train {key}: {len(names) - len(held)} tensors of exact "
              f"gradient 0 ({ZERO_GRAD}), left out of the cosines: largest "
              f"|g| on GPU {noise:.3g}, {noise / top:.3g} of the largest "
              f"|g| of the model")
    print(f"train {key}: {GRAD_BATCH}-image gradients bf16 on GPU vs fp32 "
          f"on CPU: relative L2 {rel:.6g}; per-tensor cosine min "
          f"{cos[worst]:.6g} at {names[worst]}, median "
          f"{statistics.median(cos):.6g}")
    if not _running_stats(task.model):
        check(rel <= BOUND_GRAD_REL, f"gradient relative L2 {rel:.4g} > "
              f"{BOUND_GRAD_REL}")
        check(cos[worst] >= BOUND_GRAD_COS,
              f"gradient cosine {cos[worst]:.4g}")
        return
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g32 = _grads(built("fp32", cuda), gbatch, cuda)
    rel32, cos32 = _grad_gap(g32, g_cpu)
    worst32 = worst_of(cos32)
    reversed_batch = {k: np.ascontiguousarray(v[::-1])
                      for k, v in gbatch.items()}
    rel_order, cos_order = _grad_gap(
        _grads(built("fp32", cpu), reversed_batch, cpu), g_cpu)
    rel_cpu, cos_cpu = _grad_gap(_grads(built(tcfg.serve.precision, cpu),
                                        gbatch, cpu), g_cpu)
    # each tensor's cosine gap against its bound: the flat one, or the
    # CPU's own gap on the reversed batch times BOUND_GRAD_FP32_VS_ORDER
    allowed = [max(1.0 - BOUND_GRAD_COS_FP32,
                   BOUND_GRAD_FP32_VS_ORDER * (1.0 - c)) for c in cos_order]
    tight = max(held, key=lambda i: (1.0 - cos32[i]) / allowed[i])
    print(f"train {key}: fp32 on GPU (TF32 off) vs fp32 on CPU: relative "
          f"L2 {rel32:.6g}, {rel32 / rel_order:.4g} times the CPU's own "
          f"fp32 change on the reversed batch, {rel_order:.6g} (bound "
          f"{BOUND_GRAD_FP32_VS_ORDER:g} times); cosine min "
          f"{cos32[worst32]:.6g} at {names[worst32]} (the CPU's own on the "
          f"reversed batch {cos_order[worst32]:.6g} there, bound "
          f"{1.0 - allowed[worst32]:.6g}); nearest its bound "
          f"{names[tight]}: cosine {cos32[tight]:.6g}, the CPU's own "
          f"{cos_order[tight]:.6g}, bound {1.0 - allowed[tight]:.6g} (the "
          f"larger gap of {1.0 - BOUND_GRAD_COS_FP32:g} and "
          f"{BOUND_GRAD_FP32_VS_ORDER:g} times the CPU's own); CPU's own "
          f"cosine min {cos_order[worst_of(cos_order)]:.6g} at "
          f"{names[worst_of(cos_order)]}; bf16 on CPU vs fp32 on CPU: "
          f"relative "
          f"L2 {rel_cpu:.6g}, cosine min "
          f"{cos_cpu[worst_of(cos_cpu)]:.6g}, median "
          f"{statistics.median(cos_cpu):.6g}; bf16 GPU gap / bf16 CPU gap "
          f"{rel / rel_cpu:.4g} (bound {BOUND_GRAD_BF16_VS_CPU:g})")
    check(rel32 <= BOUND_GRAD_FP32_VS_ORDER * rel_order,
          f"fp32 gradient relative L2 {rel32:.4g}, the CPU's own on the "
          f"reversed batch {rel_order:.4g}")
    check(1.0 - cos32[tight] <= allowed[tight], f"fp32 gradient cosine "
          f"{cos32[tight]:.6g} at {names[tight]}, bound "
          f"{1.0 - allowed[tight]:.6g}")
    check(rel <= BOUND_GRAD_BF16_VS_CPU * rel_cpu,
          f"bf16 gradients {rel:.4g} from fp32, bf16 on the CPU "
          f"{rel_cpu:.4g}")


def phase_train_slice(smi: str, key: str, model: str, batch_size: int,
                      per_step_want: dict, nhwc: bool = False,
                      coral: float = 0.0):
    """The training step of ``experiment=key`` at its batch from random
    weights, on batches that hold datasets 0 and 1: 3 warm-up and 10 timed
    steps; every kernel launches ``per_step_want[name]`` times per step (0
    where unnamed); phase 6's checks; with BatchNorm the running statistics
    moving from step 0 on, with ``coral`` (the experiment's weight) CORAL
    nonzero in every timed step; latency, device span and peak memory. With
    ``nhwc`` the NesT backbone's ``nhwc_windows`` is set, and the step is
    also timed against the blockified path's in alternating turns."""
    tcfg = TRAIN_EXPERIMENTS[key]
    aug = tcfg.augment()
    check(tcfg.serve.model == model and tcfg.serve.precision == "bf16"
          and tcfg.serve.image_size == 224 and tcfg.batch_size == batch_size
          and tcfg.optimizer == "adamw" and tcfg.scheduler == "cosine_warmup"
          and tcfg.coral_lambda == coral and aug.enabled
          and aug.noise_prob == 0.5 and aug.shear_deg == 0.0,
          f"unexpected training config {tcfg}")
    cuda = torch.device("cuda")
    task, state, step = build_training(tcfg, cuda, STEPS_PER_EPOCH)
    if nhwc:
        task.model.backbone.nhwc_windows = True
    rng = np.random.default_rng(1)
    batches = [random_batch(rng, batch_size, tcfg.serve.image_size)
               for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    auxes, used_lrs = [], []

    def run(batch):
        auxes.extend(train_steps(step, state, [batch]))
        # the lr the optimizer's update read
        used_lrs.append(state.optimizer.param_groups[0]["lr"])

    def params():
        return torch.cat([p.detach().reshape(-1) for p in
                          task.model.parameters()]).clone()

    p0, stats0 = params(), _running_stats(task.model)
    run(batches[0])
    p1, stats1 = params(), _running_stats(task.model)
    check(all(not torch.equal(a, b) for a, b in zip(stats0, stats1)),
          "a running statistic did not move at step 0")
    for batch in batches[1:WARMUP_STEPS]:
        run(batch)
    p_warm = params()
    check(torch.equal(p0, p1), "lr 0 at step 0 must leave the parameters")
    check(not torch.equal(p1, p_warm), "parameters did not move at step 1")
    torch.cuda.synchronize()

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    times, events = [], []
    for batch in batches[WARMUP_STEPS:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run(batch)
        end.record()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        events.append((start, end))
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / TIMED_STEPS for k, v in launches.items()}
    print(f"train {key}: {TIMED_STEPS} timed steps, launches {launches}")
    want = {name: per_step_want.get(name, 0) for name in per_step}
    check(per_step == want, f"launches per step {per_step}, expected {want}")
    check(not torch.equal(p_warm, params()),
          "parameters did not move in the timed steps")
    losses = torch.stack([a["loss"] for a in auxes]).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite loss {losses}")
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in task.model.parameters()), "non-finite gradient")
    # cosine_warmup's lr at step i < warmup_epochs * steps_per_epoch (40
    # here; all 13 steps are inside) is base_lr * (i / steps_per_epoch) /
    # warmup_epochs, 0 at step 0: written out, not read from make_schedule
    warm = tcfg.warmup_epochs * STEPS_PER_EPOCH
    check(len(used_lrs) <= warm, "the steps must lie inside the warmup")
    want_lrs = [tcfg.lr * i / warm for i in range(len(used_lrs))]
    check(all(math.isclose(u, w, rel_tol=1e-12)
              for u, w in zip(used_lrs, want_lrs)),
          f"lr used per step {used_lrs}, expected {want_lrs}")
    check([a["lr"] for a in auxes] == used_lrs,
          "aux lr differs from the optimizer's")
    if coral:
        corals = torch.stack([a["coral"] for a in auxes]).float().cpu()
        print(f"train {key}: CORAL (weight {coral:g}) per step "
              f"{corals.tolist()}")
        check(bool((corals[WARMUP_STEPS:] > 0).all())
              and bool(torch.isfinite(corals).all()),
              "CORAL must be finite and nonzero in the timed steps")
    if stats0:
        moved = sum(not torch.equal(a, b) for a, b in zip(
            stats1, _running_stats(task.model)))
        print(f"train {key}: {len(stats0)} running statistics, all moved at "
              f"step 0, {moved} moved again after it")
        check(moved == len(stats0), "running statistics stopped moving")
    print(f"train {key}: losses {[round(v, 5) for v in losses.tolist()]}; "
          f"lr used "
          f"{used_lrs[0]:.6g} -> {used_lrs[-1]:.6g} = base_lr x step / "
          f"{warm} (steps_per_epoch {STEPS_PER_EPOCH}, cosine_warmup over "
          f"{tcfg.warmup_epochs} of {tcfg.max_epochs} epochs)")

    med = statistics.median(times)
    dev_ms = statistics.median(s.elapsed_time(e) for s, e in events)
    print(f"train {key}: batch-{batch_size} step latency median "
          f"{med * 1e3:.3f} ms (min {min(times) * 1e3:.3f}, max "
          f"{max(times) * 1e3:.3f}, n={TIMED_STEPS}), "
          f"{batch_size / med:.1f} images/s; device step span "
          f"median {dev_ms:.3f} ms; peak memory {peak / 2 ** 30:.3f} GiB; "
          f"on {smi}")
    if nhwc:
        _train_vs_blockified(smi, key, task, step, state,
                             batches[WARMUP_STEPS:], batch_size)

    # gradients on the card vs fp32 on the CPU, augmentation off
    _check_grads(key, task, tcfg, dataclasses.replace(
        task.statics, augment=task.statics.augment._replace(enabled=False)))
    del task, state, step
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items() if v}


def _edge_err(y, ref, b, h, w):
    """Relative error of y against ref [B*H*W, K] on the map's border
    pixels (first and last row and column), where the halo is masked."""
    y4 = y.float().view(b, h, w, -1)
    r4 = ref.float().view(b, h, w, -1)
    edge = torch.zeros(h, w, dtype=torch.bool, device=y.device)
    edge[0], edge[-1], edge[:, 0], edge[:, -1] = True, True, True, True
    diff = (y4 - r4)[:, edge].abs().max().item()
    return diff / r4.abs().max().item()


def phase_probe_kernels(smi: str):
    """Phase 14: #17 and #18 against their plain versions (bf16, and fp32
    with TF32 off) at the probe shapes and odd ones, reruns bit-equal, #18
    also with a and b as views of longer vectors whose tail holds NaN (the
    kernel reads no channel past C), then the probes' runs at batch 128
    with the launch counts set to 0 just before and read just after.
    Returns (per-kernel totals over the probe shapes, launches)."""
    torch.backends.cudnn.allow_tf32 = False  # the fp32 plain versions and
    torch.backends.cuda.matmul.allow_tf32 = False  # cuDNN in full fp32
    print("probe checks: TF32 off for cuDNN convolutions and cuBLAS "
          "matmuls (cuDNN runs fp32 convolutions in TF32 by default)")
    gen = torch.Generator(device="cuda").manual_seed(4)
    stats = {"conv3x3": _stat(), "bn_relu_gemm": _stat()}
    for b, h, w, c, k in CONV_CHECKS:
        x = torch.randn(b, h, w, c, generator=gen, device="cuda").bfloat16()
        wt = (torch.randn(3, 3, c, k, generator=gen, device="cuda")
              * (9 * c) ** -0.5).bfloat16()
        y = CV.conv3x3(x, wt)
        torch.cuda.synchronize()
        ref = CV.conv3x3_plain(x, wt)
        _check_outputs("conv3x3", f"[{b}, {h}, {w}, {c}] -> {k}", (y,),
                       (ref,), (CV.conv3x3_plain(x.float(), wt.float()),),
                       ("y",), BOUND_VS_PLAIN_BF16, BOUND_VS_PLAIN_FP32,
                       stats["conv3x3"])
        edge = _edge_err(y, ref, b, h, w)
        again = torch.equal(CV.conv3x3(x, wt), y)
        print(f"kernel conv3x3 [{b}, {h}, {w}, {c}] -> {k}: edge pixels rel "
              f"vs plain bf16 {edge:.6g} (bound {BOUND_VS_PLAIN_BF16:g}); "
              f"rerun bit-equal {again}")
        check(edge <= BOUND_VS_PLAIN_BF16, "conv3x3 edge pixels")
        check(again, f"conv3x3 [{b}, {h}, {w}, {c}] -> {k}: a rerun differs")
        del x, wt, y, ref
    for m, c, k in GEMM_CHECKS:
        x = torch.randn(m, c, generator=gen, device="cuda").bfloat16()
        a = torch.randn(1, c, generator=gen, device="cuda")
        bb = torch.randn(1, c, generator=gen, device="cuda")
        wt = (torch.randn(c, k, generator=gen, device="cuda")
              * 0.05).bfloat16()
        y = BG.bn_relu_gemm(x, a, bb, wt)
        torch.cuda.synchronize()
        _check_outputs("bn_relu_gemm", f"[{m}, {c}] -> {k}", (y,),
                       (BG.bn_relu_gemm_plain(x, a, bb, wt),),
                       (BG.bn_relu_gemm_plain(x.float(), a, bb,
                                              wt.float()),),
                       ("y",), BOUND_VS_PLAIN_BF16, BOUND_VS_PLAIN_FP32,
                       stats["bn_relu_gemm"])
        again = torch.equal(BG.bn_relu_gemm(x, a, bb, wt), y)
        # a and b as the first C of 64 more channels, the tail NaN
        tails = [torch.full((1, c + 64), float("nan"), device="cuda")
                 for _ in range(2)]
        for t, v in zip(tails, (a, bb)):
            t[:, :c] = v
        y_tail = BG.bn_relu_gemm(x, tails[0][:, :c], tails[1][:, :c], wt)
        finite = bool(torch.isfinite(y_tail.float()).all())
        same = torch.equal(y_tail, y)
        print(f"kernel bn_relu_gemm [{m}, {c}] -> {k}: rerun bit-equal "
              f"{again}; a, b with a NaN tail: finite {finite}, bit-equal "
              f"{same}")
        check(again, f"bn_relu_gemm [{m}, {c}] -> {k}: a rerun differs")
        check(finite and same, f"bn_relu_gemm [{m}, {c}] -> {k}: a or b's "
              "tail past C reached the output")
        del x, a, bb, wt, y, y_tail, tails
    torch.cuda.empty_cache()

    _reset_counts()
    records = conv_probe.run(PROBE_BATCH) + bn_gemm_probe.run(PROBE_BATCH)
    launches = _counts()
    print(f"probes at batch {PROBE_BATCH}: launches {launches}")
    check(launches["conv3x3"] > 0 and launches["bn_relu_gemm"] > 0
          and all(v == 0 for n, v in launches.items()
                  if n not in ("conv3x3", "bn_relu_gemm")),
          "the probes must launch #17 and #18 and nothing else")
    for rec in records:
        print(f"probe {json.dumps(rec)}")
        name = rec["probe"]
        if name == "stem_maxpool":
            check(math.isclose(rec["grad_sum_first_max"],
                               rec["grad_sum_eqsplit"], rel_tol=1e-5),
                  "the two max-pool gradients must have one sum")
            continue
        st = stats[name]
        lib = rec["library_ms"]
        _add(st, 1, rec["kernel_ms"], rec["plain_ms"],
             (rec["flops"], rec["bytes"]), lib)
        for key in DEVICE_KEYS:
            if key in rec:
                st[key] = st.get(key, 0.0) + rec[key]
        st.setdefault("per_shape", {})[rec["shape"]] = {
            k: rec[k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                *DEVICE_KEYS, "bound_ms", "bound_by",
                                "two_op_ms") if k in rec}
        print(f"time {name} {rec['shape']} (batch {PROBE_BATCH}): kernel "
              f"{rec['kernel_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              + (f"F.conv2d {lib:.4f} ms; device alone kernel "
                 f"{rec['kernel_device_ms']:.4f} ms, F.conv2d "
                 f"{rec['library_device_ms']:.4f} ms" if lib is not None else
                 f"two-op torch {rec['two_op_ms']:.4f} ms; device alone "
                 f"kernel {rec['kernel_device_ms']:.4f} ms, two-op "
                 f"{rec['two_op_device_ms']:.4f} ms")
              + f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); "
              f"on {smi}")
    return stats, launches


MLP_BWD_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


def _mlp_probe_checks(gen, m, stats):
    """Every instance of #13 (and its ablations), #19a (each stage set),
    #19b and #14 at M rows of level 3's width against the plain versions in
    bf16 and fp32; the reruns of each bit-identical. b1 and b2 are
    drawn at scale 1, so that a dropped or misindexed bias moves y by about
    as much as the MLP branch does, far past the bounds."""
    d, f = MLP_D, MLP_F

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = rand(m, d).bfloat16()
    params = (1.0 + rand(d, scale=0.1), rand(d, scale=0.1),
              rand(d, f, scale=d ** -0.5).bfloat16(), rand(f),
              rand(f, d, scale=f ** -0.5).bfloat16(), rand(d))
    p32 = [t.float() for t in params]
    dy = rand(m, d).bfloat16()
    w1, w2 = params[2], params[4]
    where = f"M={m} D={d} F={f}"
    for tm, fs in MT.TILES:
        at = f"{where} tm={tm} fs={fs}"
        for flags in ({}, {"gelu": False}, {"ln": False}):
            y = MT.mlp_tile(x, *params, tm=tm, fs=fs, **flags)
            torch.cuda.synchronize()
            _check_outputs("mlp_tile", f"{at} {flags or 'full'}", (y,),
                           (MT.mlp_tile_plain(x, *params, **flags),),
                           (MT.mlp_tile_plain(x.float(), *p32, **flags),),
                           ("y",), BOUND_VS_PLAIN_BF16, BOUND_VS_PLAIN_FP32,
                           stats["mlp_tile"])
            check(torch.equal(MT.mlp_tile(x, *params, tm=tm, fs=fs,
                                          **flags), y),
                  f"mlp_tile {at} {flags or 'full'}: a rerun differs")
        for stages in MT.CHAIN_STAGES:
            y = MT.mlp_chain(x, w1, w2, stages, tm=tm, fs=fs)
            torch.cuda.synchronize()
            _check_outputs("mlp_chain", f"{at} stages {stages}", (y,),
                           (MT.mlp_chain_plain(x, w1, w2, stages),),
                           (MT.mlp_chain_plain(x.float(), w1.float(),
                                               w2.float(), stages),),
                           ("y",), BOUND_VS_PLAIN_BF16, BOUND_VS_PLAIN_FP32,
                           stats["mlp_chain"])
            check(torch.equal(MT.mlp_chain(x, w1, w2, stages, tm=tm, fs=fs),
                              y), f"mlp_chain {at} stages {stages}: a rerun "
                  "differs")
    z = MT.mlp_single(x, w1)
    torch.cuda.synchronize()
    _check_outputs("mlp_single", where, (z,), (MT.mlp_single_plain(x, w1),),
                   (MT.mlp_single_plain(x.float(), w1.float()),), ("z",),
                   BOUND_VS_PLAIN_BF16, BOUND_VS_PLAIN_FP32,
                   stats["mlp_single"])
    check(torch.equal(MT.mlp_single(x, w1), z),
          f"mlp_single {where}: a rerun differs")
    refs = MT.mlp_tile_bwd_plain(x, *params[:5], dy)
    refs32 = MT.mlp_tile_bwd_plain(x.float(), *p32[:5], dy.float())
    for tm, fs in MT.BWD_TILES:
        outs = MT.mlp_tile_bwd(x, *params[:5], dy, tm=tm, fs=fs)
        torch.cuda.synchronize()
        _check_outputs("mlp_tile_bwd", f"{where} tm={tm} fs={fs}", outs,
                       refs, refs32, MLP_BWD_NAMES, BOUND_BWD_BF16,
                       BOUND_BWD_FP32, stats["mlp_tile_bwd"])
        again = MT.mlp_tile_bwd(x, *params[:5], dy, tm=tm, fs=fs)
        check(all(torch.equal(a, b) for a, b in zip(outs, again)),
              f"mlp_tile_bwd {where} tm={tm} fs={fs}: a rerun differs")


def _best(stat, records, is_call, yardsticks=()):
    """The fastest of the ``records`` for which ``is_call`` holds (the
    kernel's instances) as the kernel's call: its ms, plain ms and work;
    every record in ``per_shape``."""
    best = min(filter(is_call, records), key=lambda r: r["kernel_ms"])
    stat.update(ms=best["kernel_ms"], plain_ms=best["plain_ms"],
                flops=best["flops"], bytes=best["bytes"],
                best=best["variant"])
    for key in ("library_ms", *DEVICE_KEYS, *BWD_DEVICE_KEYS):
        if key in best:
            stat[key] = best[key]
    stat["per_shape"] = {
        r["variant"]: {k: r[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                         "bound_by", *yardsticks) if k in r}
        for r in records}


def phase_mlp_probe_kernels(smi: str):
    """Phase 18: #13, #14, #19a and #19b against their plain versions (bf16,
    and fp32 with TF32 off) at every instance, on batch 16's rows and a
    ragged M; then the probes' runs at batch 128 with the launch counts set
    to 0 just before and read just after, each instance's error there
    against the plain bf16 version held to the same bound. Returns
    (per-kernel stats, launches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(6)
    names = tuple(k.__name__ for k in MT.KERNELS)
    stats = {name: _stat() for name in names}
    t0 = time.perf_counter()
    for m in MLP_CHECK_ROWS:
        _mlp_probe_checks(gen, m, stats)
        torch.cuda.empty_cache()
    t_checks = time.perf_counter() - t0

    _reset_counts()
    records = mega_probe.run(PROBE_BATCH) + mlp_probe.run(PROBE_BATCH)
    launches = _counts()
    print(f"MLP probes at batch {PROBE_BATCH}: launches {launches}")
    shipped = ("ln_mlp", "ln_mlp_bwd")
    check(all(launches[n] > 0 for n in names + shipped)
          and all(v == 0 for n, v in launches.items()
                  if n not in names + shipped),
          "the MLP probes must launch #13, #14, #19a, #19b and the shipped "
          "#2/#4, and nothing else")
    by_probe = {p: [r for r in records if r["probe"] == p] for p in
                ("mlp_fwd", "mlp_bwd", "mlp_chain", "mlp_single")}

    def instance(r):  # not an ablation or the shipped kernel
        return r["variant"].startswith("tile ")

    for rec in records:
        print(f"probe {json.dumps(rec)}")
        yard = {k: v for k, v in rec.items() if k.endswith("_ms") and k not in
                ("kernel_ms", "plain_ms", "bound_ms")}
        err = rec.get("max_abs_err")
        name = {"mlp_fwd": "mlp_tile", "mlp_bwd": "mlp_tile_bwd"}.get(
            rec["probe"], rec["probe"])
        if name in names and (instance(rec) or rec["probe"] in (
                "mlp_chain", "mlp_single")):
            bound = (BOUND_BWD_BF16 if name == "mlp_tile_bwd"
                     else BOUND_VS_PLAIN_BF16)
            rel = rec["max_rel_err"]
            print(f"kernel {name} {rec['variant']} (batch {PROBE_BATCH}): "
                  f"rel vs plain bf16 {rel:.6g} (bound {bound:g})")
            check(rel <= bound, f"{name} {rec['variant']} at batch "
                  f"{PROBE_BATCH}: {rel:.3g} > {bound}")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        print(f"time {rec['probe']} {rec['variant']} (batch {PROBE_BATCH}): "
              f"kernel {rec['kernel_ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
              f"ms, {rec['tflops']:.1f} TFLOP/s, bound {rec['bound_ms']:.4f} "
              f"ms ({rec['bound_by']}), "
              + "".join(f"{k[:-3]} {v:.4f} ms, " for k, v in yard.items())
              + (f"max|d| vs plain {err:.4g}; " if err is not None else "")
              + f"on {smi}")
    _best(stats["mlp_tile"], by_probe["mlp_fwd"], instance,
          BWD_DEVICE_KEYS[:2])
    _best(stats["mlp_tile_bwd"], by_probe["mlp_bwd"], instance,
          BWD_DEVICE_KEYS)
    # the pure chain is #19a's call; its GELU and LN stages in per_shape
    _best(stats["mlp_chain"], by_probe["mlp_chain"],
          lambda r: not r["stages"], ("two_matmuls_ms", *DEVICE_KEYS))
    _best(stats["mlp_single"], by_probe["mlp_single"], lambda r: True,
          ("library_ms", *DEVICE_KEYS))
    for name in names:
        st = stats[name]
        alone = {k: st[k] for k in (*DEVICE_KEYS, *BWD_DEVICE_KEYS)
                 if st.get(k) is not None}
        print(f"time {name} fastest ({st['best']}): kernel {st['ms']:.4f} ms "
              f"per call, plain {st['plain_ms']:.4f} ms"
              + (f", torch.matmul {st['library_ms']:.4f} ms"
                 if st["library_ms"] is not None else "")
              + "".join(f", {k} {v:.4f}" for k, v in alone.items())
              + f"; on {smi}")
    print(f"MLP probe phase: checks {t_checks:.1f} s, probes "
          f"{time.perf_counter() - t0 - t_checks:.1f} s")
    return stats, launches


def _attn_probe_checks(gen, n, s, stats):
    """#15 in every mode (and its core) and #16 in every mode (and its core)
    on n samples of s tokens at level 3's width against the plain versions
    in bf16 and fp32; the softmax modes' y bit-equal; #16's reruns
    bit-identical. The biases and beta are drawn at scale 1 and gamma is
    not 1, so a dropped bias or affine moves the outputs far past the
    bounds."""
    d, heads = ATTN_D, ATTN_HEADS

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = rand(n, s, d).bfloat16()
    params = (1.0 + rand(d, scale=0.2), rand(d),
              rand(d, 3 * d, scale=d ** -0.5).bfloat16(), rand(3 * d),
              rand(d, d, scale=d ** -0.5).bfloat16(), rand(d))
    p32 = [t.float() for t in params]
    dy = rand(n, s, d).bfloat16()
    where = f"N={n} S={s} D={d}"
    qkv = AS.ln_qkv_plain(x, *params[:4])[-1]
    ys = {}
    for mode in AS.MODES:
        y = AS.attn_sched(x, *params, heads, mode)
        o = AS.attn_sched_core(qkv, heads, mode)
        torch.cuda.synchronize()
        _check_outputs("attn_sched", f"{where} {mode}", (y, o),
                       (AS.attn_sched_plain(x, *params, heads, mode),
                        AS.attn_sched_core_plain(qkv, heads, mode)),
                       (AS.attn_sched_plain(x.float(), *p32, heads, mode),
                        AS.attn_sched_core_plain(qkv.float(), heads, mode)),
                       ("y", "core o"), BOUND_VS_PLAIN_BF16,
                       BOUND_VS_PLAIN_FP32, stats["attn_sched"])
        ys[mode] = y
    check(all(torch.equal(ys[m], ys["v0"]) for m in ("pipe", "pipe2",
                                                     "stage")),
          f"attn_sched {where}: the softmax modes' y differ")
    shipped = FB.ln_attention(x, *params, heads)
    check(torch.equal(ys["v0"], shipped),
          f"attn_sched {where}: v0's y differs from #1 ln_attention's in "
          f"{int((ys['v0'] != shipped).sum())} elements")
    print(f"kernel attn_sched {where}: v0, pipe, pipe2, stage y bit-equal, "
          "and bit-equal to #1 ln_attention's")
    refs = AS.attn_sched_bwd_plain(x, *params[:5], dy, heads)
    refs32 = AS.attn_sched_bwd_plain(x.float(), *p32[:5], dy.float(), heads)
    core_refs = AS.attn_sched_bwd_core_plain(qkv, dy, heads)
    core_refs32 = AS.attn_sched_bwd_core_plain(qkv.float(), dy.float(),
                                               heads)
    outs, core_o = {}, {}
    for mode in AS.BWD_MODES:
        outs[mode] = AS.attn_sched_bwd(x, *params[:5], dy, heads, mode)
        core = AS.attn_sched_bwd_core(qkv, dy, heads, mode)
        core_o[mode] = core[0]
        torch.cuda.synchronize()
        _check_outputs("attn_sched_bwd", f"{where} {mode}", outs[mode] + core,
                       refs + core_refs, refs32 + core_refs32,
                       BWD_NAMES["ln_attention_bwd"] + ("core o",
                                                        "core dqkv"),
                       BOUND_BWD_BF16, BOUND_BWD_FP32,
                       stats["attn_sched_bwd"])
        again = AS.attn_sched_bwd(x, *params[:5], dy, heads, mode)
        check(all(torch.equal(a, b) for a, b in zip(outs[mode], again)),
              f"attn_sched_bwd {where} {mode}: a rerun differs")
    same = [m for m in AS.BWD_MODES[1:] if all(
        torch.equal(a, b) for a, b in zip(outs[m], outs["v0"]))]
    apart = {m: int((core_o[m] != core_o["v0"]).sum())
             for m in AS.BWD_MODES[1:]}
    print(f"kernel attn_sched_bwd {where}: reruns bit-identical; modes "
          f"bit-equal to v0: {same}; core o against v0's pass-1 o (the "
          f"forward core with kRecip): stage2's and uni's (the backward "
          f"core's kOut) differ in {apart['stage2']} and {apart['uni']} of "
          f"{core_o['v0'].numel()} elements")
    check(not any(apart.values()),
          f"attn_sched_bwd {where}: the modes' o differ: {apart}")


def phase_attn_probe_kernels(smi: str):
    """Phase 19: #15 and #16 in every mode against their plain versions
    (bf16, and fp32 with TF32 off) at 4 samples of S 196 and of a ragged S;
    then the probe's run at batch 128 with the launch counts set to 0 just
    before and read just after, each mode's error there against the plain
    bf16 version held to the same bound. Returns (per-kernel stats,
    launches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(7)
    stats = {"attn_sched": _stat(), "attn_sched_bwd": _stat()}
    t0 = time.perf_counter()
    for n, s in ATTN_CHECKS:
        _attn_probe_checks(gen, n, s, stats)
        torch.cuda.empty_cache()
    t_checks = time.perf_counter() - t0

    _reset_counts()
    records = attn_probe.run(PROBE_BATCH)
    launches = _counts()
    print(f"attention probe at batch {PROBE_BATCH}: launches {launches}")
    ours = tuple(k.__name__ for k in AS.KERNELS)
    shipped = ("ln_attention", "ln_attention_bwd")
    check(all(launches[n] > 0 for n in ours + shipped)
          and all(v == 0 for n, v in launches.items()
                  if n not in ours + shipped),
          "the attention probe must launch #15, #16 (and their cores) and "
          "the shipped #1/#3, and nothing else")
    for rec in records:
        print(f"probe {json.dumps(rec)}")
        name = {"attn_fwd": "attn_sched", "attn_bwd": "attn_sched_bwd"}[
            rec["probe"]]
        err = rec["max_abs_err"]
        if "#" not in rec["variant"] and err is not None:
            bound = (BOUND_BWD_BF16 if name == "attn_sched_bwd"
                     else BOUND_VS_PLAIN_BF16)
            rel = rec["max_rel_err"]
            print(f"kernel {name} {rec['variant']} (batch {PROBE_BATCH}): "
                  f"rel vs plain bf16 {rel:.6g} (bound {bound:g})")
            check(rel <= bound, f"{name} {rec['variant']} at batch "
                  f"{PROBE_BATCH}: {rel:.3g} > {bound}")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        print(f"time {rec['probe']} {rec['variant']} (batch {PROBE_BATCH}): "
              f"kernel {rec['kernel_ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
              f"ms, {rec['tflops']:.1f} TFLOP/s, bound {rec['bound_ms']:.4f} "
              f"ms ({rec['bound_by']})"
              + (f", core {rec['core_ms']:.4f} ms, SDPA {rec['sdpa_ms']:.4f} "
                 "ms" if "core_ms" in rec else "")
              + "".join(f", {k[:-3]} {rec[k]:.4f} ms" for k in BWD_DEVICE_KEYS
                        if k in rec)
              + f"; on {smi}")
    for name, probe in (("attn_sched", "attn_fwd"),
                        ("attn_sched_bwd", "attn_bwd")):
        # the fastest mode that computes the function (not nosm, a bound)
        _best(stats[name], [r for r in records if r["probe"] == probe],
              lambda r: "#" not in r["variant"] and r["variant"] != "nosm",
              ("core_ms", "sdpa_ms", *BWD_DEVICE_KEYS))
        st = stats[name]
        print(f"time {name} fastest ({st['best']}): kernel {st['ms']:.4f} ms "
              f"per call, plain {st['plain_ms']:.4f} ms")
    print(f"attention probe phase: checks {t_checks:.1f} s, probe "
          f"{time.perf_counter() - t0 - t_checks:.1f} s")
    return stats, launches


def _cosine_lr(base_lr: float, step: int, max_epochs: int) -> float:
    """``cosine``'s lr written out: CosineAnnealingLR over ``max_epochs``,
    stepped on whole epochs of ``STEPS_PER_EPOCH`` steps."""
    epoch = min(step // STEPS_PER_EPOCH, max_epochs)
    return base_lr * 0.5 * (1 + math.cos(math.pi * epoch / max_epochs))


def _sdpa_kernels(task, batch) -> str:
    """The attention kernels one text-tower forward and backward launch
    (under the profiler), and the SDPA backend their names say."""
    cuda = torch.device("cuda")
    ids = torch.from_numpy(batch["input_ids"]).to(cuda)
    mask = torch.from_numpy(batch["attention_mask"]).to(cuda)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        task.model.encode_text(ids, mask).sum().backward()
        torch.cuda.synchronize()
    task.model.zero_grad(set_to_none=True)
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and re.search(r"flash|fmha|attention|attn|softmax|sdpa",
                                  e.name, re.IGNORECASE)})
    text = " ".join(names).lower()
    backend = ("cudnn" if "cudnn" in text else "flash" if "flash" in text
               else "efficient" if re.search(r"fmha|efficient|mem_eff", text)
               else "math" if "softmax" in text else "unknown")
    return f"{backend} ({'; '.join(n[:90] for n in names)})"


def _vlp_run(key: str, steps: int, timed: int = 0):
    """``build_training`` of ``experiment=key`` on the card and ``steps``
    training steps on seeded pretrain batches (ragged 8-40-token captions,
    each twice); the last ``timed`` are timed, the launch counts set to 0
    just before them and read just after. Checks: finite losses, finite
    gradients of every trained parameter, every group's lr equal to
    ``cosine``'s value of its own base lr written out (the base lr at step
    0, so parameters move from step 0), ``logit_scale`` and the BatchNorm
    running statistics moving at every untimed step and across the timed
    ones, ``exp(logit_scale)`` at most ``logit_scale_max``. Returns (task,
    state, auxes, launches of the timed steps, step times, events, peak
    memory, the batches)."""
    tcfg = TRAIN_EXPERIMENTS[key]
    cuda = torch.device("cuda")
    task, state, step = build_training(tcfg, cuda, STEPS_PER_EPOCH)
    rng = np.random.default_rng(1)
    batches = [random_pretrain_batch(rng, tcfg.batch_size,
                                     tcfg.serve.image_size,
                                     tcfg.max_token_length,
                                     tcfg.serve.text_model)
               for _ in range(steps)]
    opt = state.optimizer
    base = {"image": tcfg.image_encoder_lr, "text": tcfg.text_encoder_lr,
            "projection": tcfg.projection_lr}
    auxes, used, scales = [], [], []
    launches, times, events, peak = None, [], [], 0

    def snapshot():
        return (task.model.logit_scale.detach().clone(),
                _running_stats(task.model))

    before = snapshot()
    scale0 = float(before[0].exp())
    for i, batch in enumerate(batches):
        if i == steps - timed:
            torch.cuda.synchronize()
            _reset_counts()
            torch.cuda.reset_peak_memory_stats()
            before_timed = snapshot()
        if i >= steps - timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            auxes.extend(train_steps(step, state, [batch]))
            end.record()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            events.append((start, end))
        else:
            auxes.extend(train_steps(step, state, [batch]))
            after = snapshot()
            check(not torch.equal(after[0], before[0]),
                  f"{key}: logit_scale did not move at step {i}")
            check(all(not torch.equal(a, b) for a, b in zip(after[1],
                                                            before[1])),
                  f"{key}: a running statistic did not move at step {i}")
            before = after
        used.append({g["name"]: g["lr"] for g in opt.param_groups})
        scales.append(float(task.model.logit_scale.detach().exp())
                      if i < steps - timed else None)
    if timed:
        launches = _counts()
        peak = torch.cuda.max_memory_allocated()
        after = snapshot()
        check(not torch.equal(after[0], before_timed[0])
              and all(not torch.equal(a, b) for a, b in zip(
                  after[1], before_timed[1])),
              f"{key}: logit_scale or a running statistic stopped moving")
    scales[-1] = float(task.model.logit_scale.detach().exp())
    losses = torch.stack([a["loss"] for a in auxes]).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"{key}: loss {losses}")
    trained = [p for p in task.model.parameters() if p.requires_grad]
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in trained), f"{key}: a non-finite or missing gradient")
    for i, lrs in enumerate(used):
        want = {g: _cosine_lr(tcfg.lr if base.get(g) is None else base[g],
                              i, tcfg.max_epochs) for g in lrs}
        check(all(math.isclose(lrs[g], want[g], rel_tol=1e-12)
                  for g in lrs), f"{key}: lr at step {i} {lrs}, cosine "
              f"gives {want}")
        check(auxes[i]["group_lrs"] == lrs, f"{key}: aux lrs differ")
    check(all(x is None or x <= tcfg.serve.logit_scale_max for x in scales),
          f"{key}: exp(logit_scale) {scales}")
    print(f"vlp {key}: {steps} steps, losses "
          f"{[round(v, 5) for v in losses.tolist()]}; lr by group at step 0 "
          f"{used[0]} -> step {steps - 1} {used[-1]} (cosine over "
          f"{tcfg.max_epochs} epochs of {STEPS_PER_EPOCH} steps); "
          f"exp(logit_scale) {scale0:.6f} -> {scales[-1]:.6f}")
    return task, state, auxes, launches, times, events, peak, batches


def _vlp_embeddings_vs_cpu(smi: str, key: str, task, tcfg) -> None:
    """``eval_fn`` and ``embed_images_fn`` on one batch whose caption masks
    at ``VLP_ZERO_MASK_ROWS`` are all zeros: finite embeddings, the image
    embeddings of both equal, and the first ``VLP_CPU_ROWS`` rows within
    ``BOUND_EMB`` of fp32 on the CPU on the same weights (eval mode keeps
    every row independent of the others)."""
    batch = random_pretrain_batch(np.random.default_rng(3), VLP_BATCH,
                                  tcfg.serve.image_size,
                                  tcfg.max_token_length,
                                  tcfg.serve.text_model)
    for r in VLP_ZERO_MASK_ROWS:
        batch["attention_mask"][r] = 0
    out = task.eval_fn(to_device(batch, torch.device("cuda")))
    emb = task.embed_images_fn(to_device(batch, torch.device("cuda")))
    check(all(bool(torch.isfinite(out[k]).all()) for k in
              ("img_emb", "txt_emb", "loss")),
          f"{key}: non-finite eval output")
    check(torch.equal(emb, out["img_emb"]),
          f"{key}: embed_images_fn differs from eval_fn's image embeddings")
    cpu_task = build_task(dataclasses.replace(
        tcfg, serve=dataclasses.replace(tcfg.serve, precision="fp32")),
        task.statics, torch.device("cpu"))
    cpu_task.model.load_state_dict(task.model.state_dict())
    rows = {k: v[:VLP_CPU_ROWS] for k, v in batch.items()}
    ref = cpu_task.eval_fn(to_device(rows, torch.device("cpu")))
    errs = {}
    for k in ("img_emb", "txt_emb"):
        got = out[k][:VLP_CPU_ROWS].float().cpu()
        errs[k] = ((got - ref[k]).abs().max()
                   / ref[k].abs().max()).item()
    zero = [r for r in VLP_ZERO_MASK_ROWS if r < VLP_CPU_ROWS]
    print(f"vlp {key}: eval loss {out['loss'].item():.6f}; bf16 embeddings "
          f"on GPU vs fp32 on CPU (rows 0-{VLP_CPU_ROWS - 1}, all-zero "
          f"caption masks at rows {list(VLP_ZERO_MASK_ROWS)}, finite): "
          f"image {errs['img_emb']:.6g}, text {errs['txt_emb']:.6g} of the "
          f"largest |value| (bound {BOUND_EMB}); on {smi}")
    check(bool(zero), "an all-zero caption mask must be among the CPU rows")
    check(max(errs.values()) <= BOUND_EMB, f"{key}: embeddings {errs}")


# the deprecated CLIP losses written out in numpy fp64 from their
# definitions (the reference's VisionLanguageModule), apart from the port's
# ops/losses.py; padded rows (mask 0) at the tail of the batch

def _plain_clip_logits(img, txt, logit_scale, scale_max):
    """L2-normalised rows, img @ txt^T times min(exp(logit_scale), max)."""
    img = img / np.maximum(np.linalg.norm(img, axis=1, keepdims=True), 1e-12)
    txt = txt / np.maximum(np.linalg.norm(txt, axis=1, keepdims=True), 1e-12)
    return img @ txt.T * min(math.exp(float(logit_scale)), scale_max)


def _plain_xent(logits, mask):
    """Cross-entropy of each valid row against its diagonal over the
    valid columns, averaged over the valid rows."""
    valid = mask > 0
    lg = logits[np.ix_(valid, valid)]
    top = lg.max(1, keepdims=True)
    lse = top[:, 0] + np.log(np.exp(lg - top).sum(1))
    return float((lse - np.diag(lg)).mean())


def _plain_masked_infonce(logits, caption_id, mask):
    """Off-diagonal logits of the same caption set to 0 (the reference's
    ``logits * mask``), then the symmetric cross-entropy."""
    dup = (caption_id[:, None] == caption_id[None, :]) \
        & ~np.eye(len(caption_id), dtype=bool)
    lg = np.where(dup, 0.0, logits)
    return (_plain_xent(lg, mask) + _plain_xent(lg.T, mask)) / 2


def _plain_non_square_infonce(logits, caption_id, mask):
    """BCE-with-logits mean over [valid rows, one column per distinct
    caption, its first row]; the target is 1 where the row's caption is
    the column's."""
    valid = np.flatnonzero(mask > 0)
    cid = caption_id[valid]
    _, first = np.unique(cid, return_index=True)
    x = logits[np.ix_(valid, valid[first])]
    t = (cid[:, None] == cid[first][None, :]).astype(np.float64)
    # -log sigmoid(x) = log(1 + e^-x); -log(1 - sigmoid(x)) = log(1 + e^x)
    return float((t * np.logaddexp(0.0, -x)
                  + (1 - t) * np.logaddexp(0.0, x)).mean())


def phase_vlp(smi: str) -> dict:
    """Phase 20: VLP pretraining (``experiment=pretrain_resnet34_tinybert``)
    at full width, then its siblings on the same machinery. Returns the
    launches of the timed steps."""
    key = PRETRAIN
    tcfg = TRAIN_EXPERIMENTS[key]
    aug = tcfg.augment()
    s = tcfg.serve
    check(s.task == "vision_language" and s.model == "resnet34"
          and s.text_model == "tinybert" and s.precision == "bf16"
          and s.image_size == 224 and s.embedding_dim == 128
          and tcfg.batch_size == VLP_BATCH and tcfg.max_token_length == 40
          and tcfg.optimizer == "adamw" and tcfg.lr == 1e-3
          and tcfg.scheduler == "cosine" and aug.enabled
          and aug.shear_deg == 5.0 and aug.noise_prob == 0.5,
          f"unexpected pretrain config {tcfg}")
    task, state, auxes, launches, times, events, peak, batches = _vlp_run(
        key, WARMUP_STEPS + TIMED_STEPS, timed=TIMED_STEPS)
    per_step = {k: v / TIMED_STEPS for k, v in launches.items()}
    want = {name: {"shear_rows": 3, "add_gaussian_noise": 1}.get(name, 0)
            for name in per_step}
    print(f"vlp {key}: {TIMED_STEPS} timed steps, launches {launches}")
    check(per_step == want, f"launches per step {per_step}, expected {want}")
    med = statistics.median(times)
    dev_ms = statistics.median(a.elapsed_time(b) for a, b in events)
    print(f"vlp {key}: batch-{VLP_BATCH} step latency median "
          f"{med * 1e3:.3f} ms (min {min(times) * 1e3:.3f}, max "
          f"{max(times) * 1e3:.3f}, n={TIMED_STEPS}), "
          f"{VLP_BATCH / med:.1f} images/s; device step span median "
          f"{dev_ms:.3f} ms; peak memory {peak / 2 ** 30:.3f} GiB; on {smi}")
    print(f"vlp {key}: TinyBERT (head dim 26) SDPA backend "
          f"{_sdpa_kernels(task, batches[0])}")
    _vlp_embeddings_vs_cpu(smi, key, task, tcfg)
    _check_grads(f"vlp {key}", task, tcfg, dataclasses.replace(
        task.statics, augment=task.statics.augment._replace(enabled=False)))
    del task, state, auxes, batches
    torch.cuda.empty_cache()

    for variant in VLP_VARIANTS:  # one step each, the loss recomputed
        vtask, _, (aux,), *_, vbatches = _vlp_run(variant, 1)
        logits = _plain_clip_logits(
            *(aux[k].double().cpu().numpy() for k in
              ("img_emb", "txt_emb", "logit_scale")), vtask.scale_max)
        fn = _plain_masked_infonce if vtask.loss_variant == "masked" \
            else _plain_non_square_infonce
        plain = fn(logits, vbatches[0]["caption_id"],
                   aux["mask"].double().cpu().numpy())
        rel = abs(aux["loss"].item() - plain) / abs(plain)
        print(f"vlp {variant}: loss on GPU {aux['loss'].item():.8f}, plain "
              f"fp64 numpy from the GPU's embeddings {plain:.8f}, relative "
              f"{rel:.3g} (bound {BOUND_LOSS_VS_CPU})")
        check(rel <= BOUND_LOSS_VS_CPU, f"{variant}: loss {rel:.3g} apart")
        del vtask
    # _frozen_text: the text tower bit-identical, the image tower moving;
    # build_training is seeded, so a second build starts from the same
    # weights as _vlp_run's
    frozen = "pretrain_resnet34_tinybert_frozen_text"
    ftask, _, _ = build_training(TRAIN_EXPERIMENTS[frozen],
                                 torch.device("cuda"), STEPS_PER_EPOCH)
    text0 = [p.detach().clone() for p in
             ftask.model.text_encoder.parameters()]
    img0 = [p.detach().clone() for p in
            ftask.model.image_encoder.parameters()]
    del ftask
    ftask, fstate, *_ = _vlp_run(frozen, 2)
    check([g["name"] for g in fstate.optimizer.param_groups]
          == ["image", "projection"], "frozen text: groups")
    check(all(torch.equal(a, b) for a, b in zip(
        text0, ftask.model.text_encoder.parameters())),
        "frozen text: the text tower moved")
    check(all(not torch.equal(a, b) for a, b in zip(
        img0, ftask.model.image_encoder.parameters())),
        "frozen text: an image-tower parameter did not move")
    print(f"vlp {frozen}: 2 steps, text tower bit-identical, every "
          "image-tower parameter moved")
    del ftask, fstate
    # _split_lr: each group at its own lr (checked in _vlp_run)
    stask, sstate, *_ = _vlp_run("pretrain_resnet34_tinybert_split_lr", 1)
    check({g["name"]: g["lr"] for g in sstate.optimizer.param_groups}
          == {"image": 1e-4, "text": 1e-5, "projection": 1e-3},
          "split lr: the groups' lrs")
    del stask, sstate
    # DistilBERT (6 x 768, 12 heads of 64): eval and 3 steps
    dcfg = TRAIN_EXPERIMENTS[VLP_DISTILBERT]
    dtask, dstate, _, dl, dtimes, _, _, dbatches = _vlp_run(
        VLP_DISTILBERT, 3, timed=3)
    check({k: v / 3 for k, v in dl.items() if v}
          == {"shear_rows": 3, "add_gaussian_noise": 1},
          f"distilbert: launches {dl}")
    print(f"vlp {VLP_DISTILBERT}: 3 steps, launches {dl}, step latency "
          f"median {statistics.median(dtimes) * 1e3:.3f} ms; DistilBERT "
          f"(head dim 64) SDPA backend {_sdpa_kernels(dtask, dbatches[0])}")
    _vlp_embeddings_vs_cpu(smi, VLP_DISTILBERT, dtask, dcfg)
    del dtask, dstate
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items() if v}


def main() -> int:
    smi = phase_device()
    phase_build()
    t0 = time.perf_counter()
    stats = phase_kernels()
    serve = phase_serve(smi, NEST, BATCH, REQUESTS,
                        {"ln_attention": 24, "ln_mlp": 24})
    stats.update(phase_train_kernels())
    nest = phase_train_slice(smi, NEST, "nest_small", BATCH, {
        "ln_attention": 24, "ln_mlp": 24, "ln_attention_bwd": 24,
        "ln_mlp_bwd": 24, "shear_rows": 3, "add_gaussian_noise": 1})
    stats.update(phase_unfused_kernels())
    serve_vit = phase_serve(smi, VIT_B, VIT_BATCH, VIT_REQUESTS,
                            {"attend_qkv": 12})
    vit = phase_train_slice(smi, VIT_B, "vit_base_patch16_224", VIT_BATCH, {
        "attend_qkv": 12, "attend_qkv_bwd": 12, "shear_rows": 3,
        "add_gaussian_noise": 1})
    unfused = phase_train_slice(smi, NEST_UNFUSED, "nest_small", BATCH, {
        "attend_qkv": 24, "attend_qkv_bwd": 24, "fused_mlp": 24,
        "fused_mlp_bwd": 24, "shear_rows": 3, "add_gaussian_noise": 1})
    stats.update(phase_window_kernels())
    serve_nhwc = phase_serve(smi, NEST, BATCH, REQUESTS,
                             {"ln_attention_windows": 24, "ln_mlp": 24},
                             nhwc=True)
    nhwc = phase_train_slice(smi, NEST, "nest_small", BATCH, {
        "ln_attention_windows": 24, "ln_mlp": 24,
        "ln_attention_windows_bwd": 24, "ln_mlp_bwd": 24, "shear_rows": 3,
        "add_gaussian_noise": 1}, nhwc=True)
    probe_stats, probe = phase_probe_kernels(smi)
    stats.update(probe_stats)
    serve_r34 = phase_serve(smi, RESNET34, BATCH, REQUESTS, {})
    r34 = phase_train_slice(smi, RESNET34, "resnet34", BATCH, {
        "shear_rows": 3, "add_gaussian_noise": 1}, coral=1000.0)
    serve_xrv = phase_serve(smi, XRV, XRV_BATCH, (XRV_BATCH,), {})
    xrv = phase_train_slice(smi, XRV, "resnet50-res512-all", XRV_BATCH, {
        "shear_rows": 3, "add_gaussian_noise": 1})
    mlp_stats, mlp_probes = phase_mlp_probe_kernels(smi)
    stats.update(mlp_stats)
    attn_stats, attn_probes = phase_attn_probe_kernels(smi)
    stats.update(attn_stats)
    t20 = time.perf_counter()
    vlp = phase_vlp(smi)
    print(f"phases 3-19: {t20 - t0:.1f} s; phase 20: "
          f"{time.perf_counter() - t20:.1f} s")
    # kernel -> (source, the TPU kernel it replaces, the training path whose
    # launches and per-step times the line gives)
    sources = {
        "ln_attention": ("ln_attention.cu", "fused_block.py:493", nest),
        "ln_mlp": ("ln_mlp.cu", "fused_block.py:786", nest),
        "ln_attention_bwd": ("ln_attention_bwd.cu", "fused_block.py:522",
                             nest),
        "ln_mlp_bwd": ("ln_mlp_bwd.cu", "fused_block.py:813", nest),
        "ln_attention_windows": ("ln_attention_windows.cu",
                                 "fused_block.py:1004", nhwc),
        "ln_attention_windows_bwd": ("ln_attention_windows_bwd.cu",
                                     "fused_block.py:1034", nhwc),
        "attend_qkv": ("block_attention.cu", "block_attention.py:175", vit),
        "attend_qkv_bwd": ("block_attention_bwd.cu", "block_attention.py:197",
                           vit),
        "fused_mlp": ("fused_mlp.cu", "fused_mlp.py:137", unfused),
        "fused_mlp_bwd": ("fused_mlp_bwd.cu", "fused_mlp.py:164", unfused),
        "shear_rows": ("shear.cu", "pallas_shear.py:45", nest),
        "add_gaussian_noise": ("noise.cu", "pallas_noise.py:64", nest),
        "conv3x3": ("conv3x3.cu", "benchmarks/conv_probe.py:87", probe),
        "bn_relu_gemm": ("bn_relu_gemm.cu", "benchmarks/bn_gemm_probe.py:74",
                         probe),
        "mlp_tile": ("mlp_tile.cu", "benchmarks/mega_variants.py:150",
                     mlp_probes),
        "mlp_tile_bwd": ("mlp_tile_bwd.cu", "benchmarks/mega_variants.py:297",
                         mlp_probes),
        "mlp_chain": ("mlp_tile.cu", "benchmarks/mlp_probe.py:72",
                      mlp_probes),
        "mlp_single": ("gemm_single.cu", "benchmarks/mlp_probe.py:92",
                       mlp_probes),
        "attn_sched": ("attn_sched.cu", "benchmarks/mega_variants.py:617",
                       attn_probes),
        "attn_sched_bwd": ("attn_sched_bwd.cu",
                           "benchmarks/mega_variants.py:589", attn_probes)}
    paths = {"nest_train": nest, "vit_b_train": vit,
             "nest_unfused_train": unfused, "nest_nhwc_train": nhwc,
             "resnet34_train": r34, "xrv_resnet50_train": xrv,
             "vlp_resnet34_tinybert_train": vlp}
    serves = {"nest_serve": serve, "vit_b_serve": serve_vit,
              "nest_nhwc_serve": serve_nhwc, "resnet34_serve": serve_r34,
              "xrv_resnet50_serve": serve_xrv}
    kernels = []
    for name, (source, replaces, path) in sources.items():
        stat = _finish(stats[name], FP32_FLOPS if name in (
            "shear_rows", "add_gaussian_noise") else BF16_FLOPS)
        entry = {"name": name, "route": "cuda",
                 "source": f"vlp_tpu_torch/csrc/{source}",
                 "replaces": replaces if replaces.startswith("benchmarks/")
                 else f"vlp_tpu/ops/{replaces}",
                 "launches": path[name],
                 **{k: stat[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")}}
        if path is probe or path is mlp_probes or path is attn_probes:
            entry.update(path="probe", per_shape=stat["per_shape"])
        if path is attn_probes:
            entry["core_launches"] = path[f"{name}_core"]
        if "best" in stat:
            entry["fastest"] = stat["best"]
        if "kernel_device_ms" in stat:  # device time alone
            entry.update(device_ms=stat["kernel_device_ms"],
                         library_device_ms=stat.get("library_device_ms"))
        if "two_op_device_ms" in stat:  # #18's yardstick alone
            entry["two_op_device_ms"] = stat["two_op_device_ms"]
        for key in BWD_DEVICE_KEYS[1:]:  # #14's, #16's yardsticks alone
            if key in stat:
                entry[key] = stat[key]
        if "kernel_device_cold_ms" in stat:  # #11, #12: with the L2 flushed
            entry.update(
                device_cold_ms=stat["kernel_device_cold_ms"],
                library_device_cold_ms=stat["library_device_cold_ms"],
                per_shape=stat["per_shape"])
        other = {p: c[name] for p, c in paths.items()
                 if c is not path and name in c}
        if other:
            entry["other_launches"] = other
        served = {p: c[name] for p, c in serves.items() if name in c}
        if served:
            entry["serve_launches"] = served
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
