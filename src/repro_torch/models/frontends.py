"""Stub modality frontends (port of ``repro/models/frontends.py``).

``[audio]`` (whisper) and ``[vlm]`` (chameleon) architectures consume
*pre-computed* frame/patch embeddings. These helpers give the frames'
shape and dtype and synthetic inputs for smoke runs; neither package
implements a mel+conv codec or a ViT.

The draws follow the reference's distributions, not its bits (those
are ``jax.random``'s): parity tests feed the reference's own frames, as
numpy, to both packages.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.models.common import dtype_of


def audio_frame_spec(cfg: ArchConfig, batch: int
                     ) -> Tuple[Tuple[int, int, int], torch.dtype]:
    """Whisper conv frontend output: shape (B, source_len, d_model) and
    the compute dtype."""
    return ((batch, cfg.encdec.source_len, cfg.d_model),
            dtype_of(cfg.compute_dtype))


def synthetic_audio_frames(generator: torch.Generator, cfg: ArchConfig,
                           batch: int, device: Optional[torch.device] = None
                           ) -> torch.Tensor:
    """Standard normal frames in the compute dtype, drawn on the
    generator's device and moved to ``device``."""
    shape, dtype = audio_frame_spec(cfg, batch)
    x = torch.randn(shape, generator=generator, device=generator.device)
    return x.to(device=device, dtype=dtype)


def vision_tokens(generator: torch.Generator, cfg: ArchConfig, batch: int,
                  seq: int, image_fraction: float = 0.25,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """Chameleon early fusion: VQ image tokens interleaved with text
    tokens. Both live in one vocab, image codes in ``[int(0.75 V), V)``:
    each position is an image code with probability ``image_fraction``,
    else a text token below that range. int32."""
    img_lo = int(cfg.vocab_size * 0.75)
    dev = generator.device
    text = torch.randint(0, img_lo, (batch, seq), generator=generator,
                         device=dev)
    image = torch.randint(img_lo, cfg.vocab_size, (batch, seq),
                          generator=generator, device=dev)
    is_img = torch.rand((batch, seq), generator=generator,
                        device=dev) < image_fraction
    return torch.where(is_img, image, text).to(device=device,
                                                dtype=torch.int32)
