"""Vision Transformer and the pre-LN transformer block (counterpart of
``vlp_tpu/models/vit.py``).

``EncoderBlock`` on ``[N, S, D]`` tokens takes one of the reference's two
compositions per half block, by the same per-shape choice:

- the half-block kernels (``ln_attention``, ``ln_mlp``) when ``megakernel``
  and ``fused_attention`` are set and ``supports_attn`` / ``supports_mlp``
  hold (NesT-Small by default);
- otherwise the unfused path: ``LayerNorm`` -> ``FusedSelfAttention``
  (``Dense`` qkv -> the ``attend_qkv`` kernel -> ``Dense`` out) -> residual,
  then ``LayerNorm`` -> ``MlpBlock`` (the ``fused_mlp`` kernel where
  ``fused_mlp.supports`` holds, else ``Dense`` -> GELU -> ``Dense``) ->
  residual. ViT-B/16 and ViT-L/16 take it at full width, NesT with
  ``megakernel=False``.

On a NesT token map ``[B, H, W, D]`` (``window`` set, NesT with
``nhwc_windows``) the attention half is ``ln_attention_windows`` straight
on the map, and the MLP half ``ln_mlp`` on its rows where ``supports_mlp``
holds, else ``LayerNorm`` -> ``MlpBlock`` -> residual (the reference's
``_window_call``).

The predicates are copies of the TPU kernels' VMEM arithmetic
(``ops/fused_block.py``, ``ops/fused_mlp.py``): they say which composition
the reference computes at a shape, and the port computes the same one.
``Dense`` and ``LayerNorm`` mirror flax's parameters and rounding;
``flax_init_`` gives the flax initializers' scales.

With ``fused_attention=False`` the block takes the reference's flax
layout: neither half-block kernel, and attention as flax's
``MultiHeadDotProductAttention`` (``MultiHeadAttention``: SDPA, which XLA
computed on the TPU) between the LayerNorm and the residual; the MLP half
is still ``LayerNorm`` -> ``MlpBlock``, so ``fused_mlp`` runs where
``fused_mlp.supports`` holds (``vlp_tpu/models/vit.py:179-205``). flax's
separate query/key/value leaves reach the same packed ``attn.qkv`` as the
fused layout's (``convert.pack_qkv``), so a state dict of either layout
loads into the other unchanged.

With ``remat`` the ViT (and NesT) rematerialise each block
(``torch.utils.checkpoint``, the reference's ``nn.remat(EncoderBlock)``):
the backward keeps only the block inputs and runs each block's forward
again, kernels included; the parameters are the same.

Under tensor parallelism (``parallel/tp.py``) a block's attention and MLP
each split over the model ranks where the JAX rule shards their largest
weight: ``attend_qkv`` and ``fused_mlp`` then run on a rank's H / M heads
and F / M hidden columns, the out-projection's and fc2's partial sums are
all-reduced before their biases (the ``fused_mlp`` kernel gets a zero b2)
and the residual. A split half never takes a half-block kernel (it cannot
form a partial sum); a half that stays whole keeps its kernel, as a
whole block does. The patch embedding splits by output channels and the
position embedding is gathered where it is added.

Under sequence parallelism (``parallel/sequence.py`` calls a block with
``seq_mesh``) its x holds one block of T / n tokens of each row:
LayerNorm, the qkv product, the out-projection and the MLP run on the
rank's own tokens, and only attention sees every token. In flax's layout
k and v are gathered over the seq ranks and SDPA runs the rank's queries
against all T keys; in the fused layout the packed qkv is gathered,
``attend_qkv`` runs over the whole sequence and the rank keeps its rows
(``attend_qkv_bwd`` then runs over the whole sequence, and the gather's
reduce-scatter sums dqkv back to the rank's tokens). Neither half takes
a half-block kernel there: ``ln_attention`` needs every token of a row
block, and the reference's kernel gate sends every kernel to its XLA path
on a 2-D mesh.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vlp_tpu_torch.ops import fused_mlp as FM
from vlp_tpu_torch.ops.block_attention import attend_qkv
from vlp_tpu_torch.ops.fused_block import (ln_attention,
                                           ln_attention_windows, ln_mlp,
                                           supports_attn, supports_mlp)
from vlp_tpu_torch.parallel.collectives import (all_reduce, copy_to_model,
                                                gather_from_model,
                                                reduce_from_model, seq_gather)
from vlp_tpu_torch.parallel import tp

_LN_EPS = 1e-6
_BN_EPS = 1e-5
# flax lecun_normal: a normal truncated at two standard deviations, rescaled
# so that the truncated distribution's std is sqrt(1 / fan_in)
_TRUNC_STD_CORRECTION = 0.87962566103423978
# sqrt(0.5) as jax.nn.gelu casts it to a bf16 input's dtype
_SQRT_HALF_BF16 = 0.70703125


class Dense(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` stored ``[in, out]``, the
    layout of a flax ``Dense`` kernel; in the input's dtype, the product
    rounded before the bias is added, as flax's ``Dense(dtype=...)``.
    Split by columns (``tp.split_columns_``) its input passes
    ``copy_to_model``; split by rows (``tp.split_rows_``) the partial
    products are summed over the model ranks before the bias. Unsplit,
    both are the identity."""

    def __init__(self, in_features: int, out_features: int,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(in_features, out_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        self.col_mesh = self.row_mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = copy_to_model(x, self.col_mesh) @ self.weight.to(x.dtype)
        return reduce_from_model(y, self.row_mesh) + self.bias.to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32, epsilon=eps)``: fp32, eps 1e-6
    unless given (BERT's is 1e-12), variance as ``E[x^2] - E[x]^2`` clipped
    at 0 (flax's ``use_fast_variance``)."""

    def __init__(self, dim: int, device: Optional[torch.device] = None,
                 eps: float = _LN_EPS) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class Embed(nn.Module):
    """flax ``nn.Embed(param_dtype=float32)``: a ``[num, features]`` fp32
    table whose rows the ids pick, in fp32. Split on the JAX rule's dim: by
    rows, a rank looks up the ids in its range (zeros elsewhere) and the
    model ranks' lookups are summed, exactly; by columns, its columns are
    gathered."""

    def __init__(self, num: int, features: int,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, features, device=device))
        self.row_mesh = self.col_mesh = None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        mesh = self.row_mesh
        if mesh is None:
            return gather_from_model(F.embedding(ids, self.weight),
                                     self.col_mesh, -1)
        n = self.weight.shape[0]
        local = ids - mesh.model_rank * n
        inside = ((local >= 0) & (local < n)).unsqueeze(-1)
        rows = F.embedding(local.clamp(0, n - 1), self.weight)
        return reduce_from_model(rows * inside, mesh)

    def tp_split_(self, mesh) -> Dict:
        dim = tp.jax_dim(self.weight.shape, mesh)
        if dim is None:
            return {}
        setattr(self, "row_mesh" if dim == 0 else "col_mesh", mesh)
        return {"weight": tp.split_(self, "weight", mesh, dim)}


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype,
    param_dtype=float32)`` over axis 1 of an NCHW tensor. Statistics in
    fp32 with the fast variance ``E[x^2] - E[x]^2`` clipped at 0; in
    training mode (``self.training``) it normalises with the batch
    statistics and updates ``running = 0.9 running + 0.1 batch`` with the
    biased batch variance (no ``num_batches_tracked``), in eval mode it
    normalises with the running statistics; the result is cast to
    ``dtype``. ``torch.nn.BatchNorm2d`` differs: it keeps the unbiased
    variance as its running one.

    On a data mesh (``mesh``, set by ``set_batchnorm_mesh``) the training
    statistics are the global batch's, as flax's under GSPMD: the per-
    channel fp32 sum, sum of squares and count are all-reduced with a
    gradient (``parallel/collectives.py``), and the running update, made
    from the reduced statistics, is the same on every rank.
    ``nn.SyncBatchNorm`` is not used: its variance and running update are
    not flax's."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.mesh = None
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def _global_moments(self, x: torch.Tensor, axes) -> tuple:
        """E[x] and E[x^2] over the mesh's global batch."""
        c = x.shape[1]
        count = x.new_full((1,), x.numel() // c)
        sums = all_reduce(torch.cat([x.sum(axes), (x * x).sum(axes), count]),
                          self.mesh)
        n = sums[-1].detach()  # a count: no gradient to carry back
        return sums[:c] / n, sums[c:2 * c] / n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            axes = (0, *range(2, x.dim()))
            if self.mesh is None:
                mean, mean_sq = x.mean(axes), (x * x).mean(axes)
            else:
                mean, mean_sq = self._global_moments(x, axes)
            var = (mean_sq - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
                self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + _BN_EPS) * self.weight
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


def set_batchnorm_mesh(model: nn.Module, mesh) -> None:
    """Every ``BatchNorm`` of ``model`` takes the mesh's global statistics
    (None: this process's batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh


def gelu_exact(h: torch.Tensor) -> torch.Tensor:
    """``nn.gelu(h, approximate=False)`` as ``jax.nn.gelu`` writes it,
    ``0.5 * h * erfc(-h * sqrt(0.5))``, each operation in h's dtype: for
    bf16 the product with bf16(sqrt(0.5)), erfc and the final product each
    round to bf16 (torch computes each in fp32 and rounds once, as XLA does
    op by op). Under jit XLA may keep fp32 between the three operations;
    that moves a result by at most one bf16 ulp."""
    c = _SQRT_HALF_BF16 if h.dtype == torch.bfloat16 else math.sqrt(0.5)
    return (0.5 * h) * torch.special.erfc(-h * c)


class FusedSelfAttention(nn.Module):
    """One packed QKV projection to ``[N, S, 3D]``, the ``attend_qkv``
    kernel on it (heads stay packed), and the output projection: the
    reference's ``FusedSelfAttention``, parameters ``qkv`` and ``out``."""

    def __init__(self, dim: int, num_heads: int,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, device)
        self.out = Dense(dim, dim, device)

    def forward(self, x: torch.Tensor, seq_mesh=None) -> torch.Tensor:
        """x [N, S, D]; with ``seq_mesh``, this seq rank's S of the row's
        n S tokens."""
        qkv = self.qkv(x)
        if seq_mesh is None:
            return self.out(attend_qkv(qkv, self.num_heads))
        o = attend_qkv(seq_gather(qkv, seq_mesh), self.num_heads)
        s, r = x.shape[1], seq_mesh.model_rank
        return self.out(o[:, r * s:(r + 1) * s])

    def flax_qkv_shape(self) -> tuple:
        """The packed qkv kernel's shape in flax's tree ([D, 3D])."""
        return tuple(self.qkv.weight.shape)


class MultiHeadAttention(nn.Module):
    """Self-attention of flax ``nn.MultiHeadDotProductAttention(num_heads,
    dtype, param_dtype=float32)``, optionally under a padding mask (the
    text tower's). flax's query, key and value kernels ``[D, H, hd]`` are
    held as one packed ``Dense`` ``qkv`` ``[D, 3 H hd]`` (q | k | v, which
    ``convert`` concatenates) and its out kernel ``[H, hd, D]`` as ``out``
    ``[H hd, D]``. q is divided by ``sqrt(hd)`` rounded to the compute
    dtype before the product, as flax divides it; the scores, softmax and
    weighted sum are one ``F.scaled_dot_product_attention`` call."""

    def __init__(self, dim: int, heads: int,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.num_heads = heads
        self.qkv = Dense(dim, 3 * dim, device)
        self.out = Dense(dim, dim, device)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                live: Optional[torch.Tensor] = None,
                seq_mesh=None) -> torch.Tensor:
        """x [B, L, D] in the compute dtype; ``bias`` and ``live`` from
        ``bert.padding_bias``, or None: no mask. With ``seq_mesh`` (no
        mask), x holds this seq rank's L of the row's n L tokens, whose k
        and v are gathered."""
        b, length = x.shape[:2]
        width = self.qkv.weight.shape[1] // 3  # this rank's heads' width
        hd = width // self.num_heads
        qkv = self.qkv(x).view(b, length, 3, self.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        if seq_mesh is not None:
            kv = seq_gather(qkv[:, :, 1:], seq_mesh)
            k, v = kv.permute(2, 0, 3, 1, 4).unbind(0)
        # flax: query / jnp.sqrt(depth).astype(dtype)
        q = q / torch.tensor(math.sqrt(hd), dtype=x.dtype).item()
        if live is not None:
            q = q * live
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                           scale=1.0)
        return self.out(o.transpose(1, 2).reshape(b, length, width))

    def flax_qkv_shape(self) -> tuple:
        """flax's query kernel's shape ([D, H, hd])."""
        d, h = self.qkv.weight.shape[0], self.num_heads
        return (d, h, d // h)


class MlpBlock(nn.Module):
    """fc1 -> exact GELU -> fc2 (the reference's ``MlpBlock``): the
    ``fused_mlp`` kernel where ``fused_mlp.supports`` holds for the rows,
    else two ``Dense`` layers around ``gelu_exact``; one parameter tree."""

    def __init__(self, dim: int, hidden: int,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.fc1 = Dense(dim, hidden, device)
        self.fc2 = Dense(hidden, dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, d = x.shape[:-1], x.shape[-1]
        m = math.prod(lead)
        if FM.supports(m, d, self.fc1.weight.shape[1], x.element_size()):
            # split (``tp.split_mlp_``): this rank's F / M hidden columns
            mesh = self.fc1.col_mesh
            b2 = self.fc2.bias if mesh is None \
                else torch.zeros_like(self.fc2.bias)
            y = FM.fused_mlp(copy_to_model(x, mesh).reshape(m, d),
                             self.fc1.weight, self.fc1.bias, self.fc2.weight,
                             b2)
            if mesh is not None:  # fc2's bias once, after the sum
                y = reduce_from_model(y, mesh) + self.fc2.bias.to(x.dtype)
            return y.view(*lead, d)
        return self.fc2(gelu_exact(self.fc1(x)))


class EncoderBlock(nn.Module):
    """Pre-LN transformer block on ``[N, S, D]`` tokens, or on a
    ``[B, H, W, D]`` token map with attention inside ``window`` x
    ``window`` tiles, in the compute dtype; parameter names follow the JAX
    block's tree (``ln1``, ``attn/{qkv,out}``, ``ln2``, ``mlp/{fc1,fc2}``),
    the same on every path and in both attention layouts (module
    docstring)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 device: Optional[torch.device] = None, *,
                 fused_attention: bool = True,
                 megakernel: bool = True,
                 window: Optional[int] = None) -> None:
        super().__init__()
        self.num_heads = num_heads
        # the half-block kernels need the packed layout, as in the reference
        self.megakernel = megakernel and fused_attention
        self.fused_attention = fused_attention
        self.window = window
        self.ln1 = LayerNorm(dim, device)
        self.attn = FusedSelfAttention(dim, num_heads, device) \
            if fused_attention else MultiHeadAttention(dim, num_heads, device)
        self.ln2 = LayerNorm(dim, device)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), device)
        # split over the model ranks (``tp_split_``)
        self.attn_split = self.mlp_split = False

    def forward(self, x: torch.Tensor, seq_mesh=None) -> torch.Tensor:
        """``seq_mesh``: x holds its seq rank's token block of each row
        (``parallel/sequence.py``), and attention gathers the others."""
        if x.dim() == 4:
            return self._window_forward(x)
        if seq_mesh is not None:
            if self.attn_split or self.mlp_split:
                raise ValueError("EncoderBlock: sequence parallelism over a "
                                 "block split by tensor parallelism")
            x = x + self.attn(self.ln1(x).to(x.dtype), seq_mesh=seq_mesh)
            return self._mlp_half(x, False)
        n, s, d = x.shape
        if self.megakernel and not self.attn_split and supports_attn(
                n, s, d, self.num_heads, x.element_size()):
            x = ln_attention(x, *self._attn_params(), self.num_heads)
        else:
            x = x + self.attn(self.ln1(x).to(x.dtype))
        return self._mlp_half(x, self.megakernel and not self.mlp_split)

    def tp_split_(self, mesh) -> Dict:
        """The attention by heads and the MLP by hidden columns, each
        where it splits."""
        attn = tp.prefixed("attn", tp.split_attention_(self.attn, mesh))
        mlp = tp.prefixed("mlp", tp.split_mlp_(self.mlp, "fc1", "fc2", mesh))
        self.attn_split, self.mlp_split = bool(attn), bool(mlp)
        return {**attn, **mlp}

    def _window_forward(self, x: torch.Tensor) -> torch.Tensor:
        """NesT's blockify-free path on the map [B, H, W, D]
        (``vlp_tpu/models/vit.py:218-245``); the caller (NesT) checks
        ``supports_window`` and the packed layout."""
        if not self.window or not self.fused_attention or self.attn_split:
            raise ValueError("EncoderBlock: a [B, H, W, D] input needs "
                             "window=, fused_attention and a whole "
                             "attention")
        x = ln_attention_windows(x, self.window, *self._attn_params(),
                                 self.num_heads)
        return self._mlp_half(x, not self.mlp_split)

    def _attn_params(self):
        return (self.ln1.weight, self.ln1.bias, self.attn.qkv.weight,
                self.attn.qkv.bias, self.attn.out.weight, self.attn.out.bias)

    def _mlp_half(self, x: torch.Tensor, fused: bool) -> torch.Tensor:
        """``ln_mlp`` on x's rows where ``fused`` and ``supports_mlp`` hold,
        else LayerNorm -> MlpBlock -> residual."""
        d = x.shape[-1]
        m = x.numel() // d
        mlp = self.mlp
        if fused and supports_mlp(m, d, mlp.fc1.weight.shape[1],
                                  x.element_size()):
            y = ln_mlp(x.reshape(m, d), self.ln2.weight, self.ln2.bias,
                       mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight,
                       mlp.fc2.bias)
            return y.view(x.shape)
        return x + mlp(self.ln2(x).to(x.dtype))


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, stride: int,
              padding: int) -> torch.Tensor:
    """flax ``nn.Conv`` in the activation dtype on NHWC: the convolution
    without bias, then the bias, where the conv has one, added in that
    dtype. A conv split by output channels (``tp.split_conv_out_``) holds
    this model rank's, which are gathered."""
    dt, mesh = x.dtype, getattr(conv, "tp_mesh", None)
    y = F.conv2d(copy_to_model(x, mesh).permute(0, 3, 1, 2),
                 conv.weight.to(dt), None, stride=stride,
                 padding=padding).permute(0, 2, 3, 1)
    y = y if conv.bias is None else y + conv.bias.to(dt)
    return gather_from_model(y, mesh, -1)


class ViT(nn.Module):
    """Pre-LN ViT with a class token (the reference's ``ViT``): patch conv,
    CLS token, position embedding, ``depth`` encoder blocks (``blocks.i``,
    flax ``block{i}``; each rematerialised with ``remat``), a final fp32
    LayerNorm; returns the CLS feature."""

    def __init__(self, img_size: int = 224, in_chans: int = 3,
                 patch_size: int = 16, hidden_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.bfloat16,
                 fused_attention: bool = True, megakernel: bool = True,
                 remat: bool = False,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.patch_size = patch_size
        self.num_features = hidden_dim
        self.patch_embed = nn.Conv2d(in_chans, hidden_dim, patch_size,
                                     stride=patch_size, device=device)
        self.cls_token = nn.Parameter(
            torch.zeros(1, 1, hidden_dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(
            1, (img_size // patch_size) ** 2 + 1, hidden_dim, device=device))
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden_dim, num_heads, mlp_ratio, device,
                         fused_attention=fused_attention,
                         megakernel=megakernel)
            for _ in range(depth))
        self.final_ln = LayerNorm(hidden_dim, device)

    def tp_split_(self, mesh) -> Dict:
        return {**tp.prefixed("patch_embed",
                              tp.split_conv_out_(self.patch_embed, mesh)),
                **tp.gather_params_(self, ("cls_token", "pos_embed"), mesh)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> the fp32 CLS feature [B, D]."""
        b, dt = x.shape[0], self.dtype
        x = conv_nhwc(x.to(dt), self.patch_embed, self.patch_size, 0)
        x = x.reshape(b, -1, self.num_features)
        cls = tp.full_param(self.cls_token).to(dt).expand(
            b, 1, self.num_features)
        x = torch.cat([cls, x], dim=1) + tp.full_param(self.pos_embed).to(dt)
        for blk in self.blocks:
            x = run_block(blk, x, self.remat)
        return self.final_ln(x)[:, 0]


def run_block(block: nn.Module, x: torch.Tensor,
              remat: bool) -> torch.Tensor:
    """``block(x)``; with ``remat`` and autograd recording, rematerialised:
    only x is kept for the backward, which runs the block's forward again
    (``nn.remat(EncoderBlock, prevent_cse=False)``). No block draws random
    numbers, so the RNG state is not stashed."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False,
                          preserve_rng_state=False)
    return block(x)


def vit_base_patch16_224(**kw) -> ViT:
    return ViT(patch_size=16, hidden_dim=768, depth=12, num_heads=12, **kw)


def vit_large_patch16_224(**kw) -> ViT:
    return ViT(patch_size=16, hidden_dim=1024, depth=24, num_heads=16, **kw)


FEATURE_DIMS = {"vit_base_patch16_224": 768, "vit_large_patch16_224": 1024}


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD_CORRECTION
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights at the scales of the JAX package's flax initializers:
    Dense and Conv kernels lecun-normal with zero biases (a conv may have
    none; the text tower's packed q|k|v and out kernels are Dense, fan-in
    D and H * hd), LayerNorm and BatchNorm ones and zeros, BatchNorm's
    running mean 0 and variance 1, position embeddings N(0, 0.02), the
    class token zeros; ``Embed`` tables N(0, 1 / features) (flax's
    ``default_embed_init``, a plain normal). A module with raw parameters
    of another kind initialises them in its ``flax_init_own_(generator)``,
    which is called first."""
    for module in model.modules():
        if hasattr(module, "flax_init_own_"):
            module.flax_init_own_(generator)
        if isinstance(module, Dense):
            _lecun_normal_(module.weight, module.weight.shape[0], generator)
            module.bias.zero_()
        elif isinstance(module, Embed):
            nn.init.normal_(module.weight, 0.0,
                            module.weight.shape[1] ** -0.5,
                            generator=generator)
        elif isinstance(module, nn.Conv2d):
            w = module.weight
            _lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3],
                           generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (LayerNorm, BatchNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
            if isinstance(module, BatchNorm):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        for name, p in module.named_parameters(recurse=False):
            if name.startswith("pos_embed"):
                nn.init.normal_(p, 0.0, 0.02, generator=generator)
            elif name == "cls_token":
                p.zero_()
