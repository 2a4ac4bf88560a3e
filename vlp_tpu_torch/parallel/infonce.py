"""The global-batch contrastive losses (counterpart of
``vlp_tpu/parallel/infonce.py:31-76`` and of the dense path GSPMD takes in
``VisionLanguageTask._symmetric_loss``).

Both forms take this rank's rows of the two towers' embeddings and mask
and return the loss of the global batch, the same on every rank
(``collectives``' convention):

- ``infonce_gspmd``: one all-gather of each embedding (and of the mask),
  then the dense ``[B_g, B_g]`` logits and ``losses.symmetric_infonce``,
  as GSPMD computes the JAX task's loss on batch-sharded embeddings.
- ``infonce_shard_map``: one gather of the normalised ``(txt, img,
  mask)``, packed into one tensor, this rank's ``[B_local, B_global]`` row
  block of each direction labelled by ``rank * B_local + i``, and one
  all-reduce of ``(loss sum, count)``: the JAX ``shard_map`` body. No rank
  forms the ``[B_g, B_g]`` matrix.

Labels are positions, so caption uniqueness must hold within the global
batch: every rank walks the same sampler and takes its rows of the same
global batch (``data/pipeline.py``). ``clip_loss`` routes the task's three
loss variants; the deprecated ``masked`` and ``non_square`` variants always
take the dense form over the gathered caption ids, as in the JAX task.
"""
from __future__ import annotations

from typing import Optional

import torch

from vlp_tpu_torch.ops import losses
from vlp_tpu_torch.parallel.collectives import all_gather, all_reduce
from vlp_tpu_torch.parallel.mesh import Mesh

IMPLS = ("gspmd", "shard_map")


def _scale(logit_scale: torch.Tensor, scale_max: float) -> torch.Tensor:
    return torch.exp(logit_scale).clamp(max=scale_max)


def infonce_gspmd(img: torch.Tensor, txt: torch.Tensor,
                  logit_scale: torch.Tensor, mask: torch.Tensor,
                  mesh: Optional[Mesh], scale_max: float = 100.0
                  ) -> torch.Tensor:
    """The dense global loss from the gathered embeddings."""
    logits = losses.clip_logits(all_gather(img.float(), mesh),
                                all_gather(txt.float(), mesh), logit_scale,
                                scale_max)
    return losses.symmetric_infonce(logits, all_gather(mask.float(), mesh))


def infonce_shard_map(img: torch.Tensor, txt: torch.Tensor,
                      logit_scale: torch.Tensor, mask: torch.Tensor,
                      mesh: Optional[Mesh], scale_max: float = 100.0
                      ) -> torch.Tensor:
    """This rank's row block of the global logits and one reduction."""
    b, e = img.shape
    scale = _scale(logit_scale, scale_max)
    img_n = losses.l2_normalize(img.float())
    txt_n = losses.l2_normalize(txt.float())
    mask = mask.float().reshape(-1)
    # one gather for all three operands, as the JAX body binds one
    packed = all_gather(torch.cat([txt_n, img_n, mask[:, None]], 1), mesh)
    txt_all, img_all, mask_all = packed.split([e, e, 1], 1)
    mask_all = mask_all.reshape(-1)
    rank = 0 if mesh is None else mesh.rank
    labels = rank * b + torch.arange(b, device=img.device)

    def row_ce(q, keys):
        logits = (q @ keys.T) * scale  # [b, B_g]
        logits = torch.where(mask_all[None, :] > 0, logits,
                             torch.full_like(logits, -1e9))
        logp = torch.log_softmax(logits, dim=-1)
        per = -logp.gather(1, labels[:, None]).reshape(-1)
        return (per * mask).sum()

    part = torch.stack([row_ce(img_n, txt_all) + row_ce(txt_n, img_all),
                        mask.sum()])
    total, count = all_reduce(part, mesh).unbind(0)
    return total / (2.0 * count.clamp(min=1.0))


def clip_loss(variant: str, impl: str, img: torch.Tensor, txt: torch.Tensor,
              logit_scale: torch.Tensor, mask: torch.Tensor,
              caption_id: Optional[torch.Tensor], mesh: Optional[Mesh],
              scale_max: float = 100.0) -> torch.Tensor:
    """The global-batch loss of ``model.loss_variant`` from this rank's
    rows. Without a mesh each form is the one-device loss of the JAX task
    (``shard_map`` engages only on a mesh there, too)."""
    if variant in ("masked", "non_square"):
        logits = losses.clip_logits(all_gather(img.float(), mesh),
                                    all_gather(txt.float(), mesh),
                                    logit_scale, scale_max)
        cid = all_gather(caption_id.reshape(-1), mesh)
        m = all_gather(mask.float(), mesh)
        fn = losses.masked_infonce if variant == "masked" \
            else losses.non_square_infonce
        return fn(logits, cid, m)
    if impl == "shard_map" and mesh is not None:
        return infonce_shard_map(img, txt, logit_scale, mask, mesh,
                                 scale_max)
    return infonce_gspmd(img, txt, logit_scale, mask, mesh, scale_max)
