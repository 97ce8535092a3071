"""End-to-end raw-image VQA model, ``vqa_end2end``: uint8 RGB images ->
normalize (and resize) on the device -> ResNet-101 -> the [B, h*w, 2048]
grid -> the ``vqa_attention`` head (one glimpse, the gathered attention:
kernels K1/K2 forward, K3/K8 backward on the card).

The backbone always runs its inference BatchNorm (the JAX package calls it
with ``train=False``). With ``freeze_backbone`` (the default) it also runs
under ``torch.no_grad()``: the grid is data to the head, as JAX's
``stop_gradient`` makes it, and no activation of the 101 layers is kept;
the Trainer then freezes the ``resnet`` parameters (no optimizer moments,
no update). With ``freeze_backbone=False`` the head's attention backward
returns dv (the explicit backward) and the gradient reaches the backbone.

Batch format: ``images`` [B, S, S, 3] uint8 (S = ``image_size``, 448),
``q_ids`` [B, T]. Parameter names follow the JAX package's tree: ``resnet``
and ``head``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from vqa_transfer_externaldata_torch.models.vqa_attention import (
    VQAAttentionModel, vqa_loss)
from vqa_transfer_externaldata_torch.ops.resnet import (
    BACKBONE_STEM, RESNET101_STAGES, ResNetV1, preprocess_images)

end2end_loss = vqa_loss


class VQAEnd2EndModel(nn.Module):
    # The JAX package's default stem (load_resnet_backbone converts
    # checkpoints to it).
    stem = BACKBONE_STEM

    def __init__(self, vocab_size: int, num_answers: int, *,
                 word_dim: int = 300, rnn_dim: int = 512,
                 fusion_dim: int = 1024, att_hidden: int = 512,
                 answer_dim: int = 300, dropout: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16,
                 freeze_backbone: bool = True, image_size: int = 448,
                 stage_sizes: Sequence[int] = RESNET101_STAGES,
                 width: int = 64,
                 word_init: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.freeze_backbone = freeze_backbone
        self.image_size = image_size
        self.resnet = ResNetV1(stage_sizes, width, dtype=dtype,
                               stem=self.stem, generator=generator)
        self.head = VQAAttentionModel(
            vocab_size, num_answers, feature_dim=self.resnet.out_channels,
            word_dim=word_dim, rnn_dim=rnn_dim, fusion_dim=fusion_dim,
            att_hidden=att_hidden, answer_dim=answer_dim, dropout=dropout,
            feature_grad=not freeze_backbone, dtype=dtype,
            word_init=word_init, generator=generator)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 images [B, S, S, 3] -> the grid [B, h*w, C] in the compute
        dtype (without a gradient when the backbone is frozen)."""
        frozen = torch.no_grad() if self.freeze_backbone else \
            contextlib.nullcontext()
        with frozen:
            x = preprocess_images(images, self.image_size)
            grid = self.resnet(x)["grid"]
            B, h, w, C = grid.shape
            # A view of the channels_last activations; contiguous() is a
            # no-op then, and a copy only for another layout.
            return grid.reshape(B, h * w, C).contiguous()

    def forward(self, images: torch.Tensor, q_ids: torch.Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        return self.head(self.features(images), q_ids, train=train,
                         generator=generator)
