"""Small utilities: the port's copy of what it needs of
cocodr_tpu/utils/misc.py."""
from __future__ import annotations

import torch

# the reference's empirical embedding std (evaluate/model/models.py:81-89)
NOISE_SCALE = 26.8


def add_embedding_noise(emb, generator: torch.Generator, noise_level: float,
                        scale: float = NOISE_SCALE):
    """Gaussian embedding perturbation for robustness probing: emb +
    N(0, 1) * scale * noise_level, the noise drawn in float32 from
    `generator` (on emb's device) and cast to emb's dtype. The JAX package
    draws from a threefry key; the two give other numbers from the same
    seed, so only the distributions agree."""
    if noise_level <= 0:
        return emb
    noise = torch.randn(emb.shape, generator=generator, dtype=torch.float32,
                        device=emb.device)
    return emb + (noise * scale * noise_level).to(emb.dtype)
