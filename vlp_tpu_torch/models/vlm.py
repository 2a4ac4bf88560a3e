"""The CLIP-style dual tower (counterpart of ``vlp_tpu/models/vlm.py``).

``image_encoder``: a backbone of the registry (the ResNets on the pretrain
path); ``image_dropout`` reaches the registry, which ignores it as the JAX
registry does. ``text_encoder``: a ``BertEncoder`` of ``TEXT_CONFIGS``;
``image_projection`` [D_img, E] and ``text_projection`` [D_txt, E], raw
fp32 matrices applied to the fp32 features (fp32 products: TF32 stays
off); ``logit_scale``, a 0-d fp32 parameter that ``losses.clip_logits``
exponentiates and clamps. The forward returns the un-normalised embeddings
and ``logit_scale``, as the JAX module does, so the loss builds the [B, B]
logits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vlp_tpu_torch.models.bert import TEXT_CONFIGS, BertEncoder
from vlp_tpu_torch.models.registry import create_backbone


class VisionLanguageModel(nn.Module):
    def __init__(self, image_model: str = "resnet34",
                 text_model: str = "distilbert", embedding_dim: int = 128,
                 image_dropout: float = 0.0,
                 logit_scale_init: float = 2.6592,
                 dtype: torch.dtype = torch.bfloat16,
                 in_chans: int = 3,
                 device: Optional[torch.device] = None,
                 **backbone_kw) -> None:
        """``backbone_kw`` go to ``create_backbone`` (``norm_dtype``,
        ``stem``, ``fused_attention``, ``megakernel``, ``remat``)."""
        super().__init__()
        self.image_encoder, image_dim = create_backbone(
            image_model, dtype=dtype, in_chans=in_chans, device=device,
            dropout_rate=image_dropout, **backbone_kw)
        text_cfg = TEXT_CONFIGS[text_model]
        self.text_encoder = BertEncoder(text_cfg, dtype, device)
        self.logit_scale_init = logit_scale_init
        self.image_projection = nn.Parameter(
            torch.empty(image_dim, embedding_dim, device=device))
        self.text_projection = nn.Parameter(
            torch.empty(text_cfg.hidden_size, embedding_dim, device=device))
        self.logit_scale = nn.Parameter(
            torch.full((), logit_scale_init, device=device))

    @torch.no_grad()
    def flax_init_own_(self, generator: torch.Generator) -> None:
        """The flax initializers of this module's own parameters (``vit.
        flax_init_`` calls it): the projections [d, E] N(0, d^-1/2),
        ``logit_scale`` ``logit_scale_init``."""
        for p in (self.image_projection, self.text_projection):
            nn.init.normal_(p, 0.0, p.shape[0] ** -0.5, generator=generator)
        self.logit_scale.fill_(self.logit_scale_init)

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(image embeddings [B, E], text embeddings [B, E],
        logit_scale)."""
        return (self.encode_image(images),
                self.encode_text(input_ids, attention_mask),
                self.logit_scale)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(images) @ self.image_projection

    def image_features(self, images: torch.Tensor) -> torch.Tensor:
        """The un-projected pooled backbone features (the linear probe's
        and the encoder transfer's input)."""
        return self.image_encoder(images)

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
        return self.text_encoder(input_ids, attention_mask) \
            @ self.text_projection
