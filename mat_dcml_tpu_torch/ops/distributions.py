"""Action distributions as plain functions on tensors.

Port of ``mat_dcml_tpu/ops/distributions.py``, with the entropies and the
Huber loss of the PPO update.  Unavailable logits are forced
to -1e10, as the reference does.  Sampling takes its noise as an input:
a categorical draw is ``argmax(logits + gumbel)``, the identity behind
``jax.random.categorical``, so a test can feed both packages the same noise.
"""

from __future__ import annotations

import math

import torch

MASK_VALUE = -1e10
LOG_2PI = math.log(2.0 * math.pi)


def mask_logits(logits: torch.Tensor, available: torch.Tensor | None) -> torch.Tensor:
    if available is None:
        return logits
    return torch.where(available == 0, MASK_VALUE, logits)


def categorical_mode(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def categorical_sample_from_gumbel(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    return torch.argmax(gumbel + logits, dim=-1)


def categorical_log_prob(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Log prob of integer ``action`` under ``Categorical(logits)``."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, action[..., None].long())[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    """``-(p * log p).sum()`` over the support; a masked logit (-1e10) has
    ``p == 0`` and adds nothing, as in ``torch.distributions.Categorical``."""
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    return -torch.where(p > 0, p * logp, 0.0).sum(-1)


def normal_sample_from_noise(mean: torch.Tensor, std: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return mean + std * noise


def normal_log_prob(mean: torch.Tensor, std: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    var = std * std
    return -((action - mean) ** 2) / (2 * var) - torch.log(std) - 0.5 * LOG_2PI


def gumbel_noise(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(u))`` with ``u`` kept above 0."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def normal_entropy(mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    del mean
    return 0.5 + 0.5 * LOG_2PI + torch.log(std)


def huber_loss(e: torch.Tensor, delta: float) -> torch.Tensor:
    """``0.5 e^2`` where ``|e| <= delta``, else ``delta (|e| - delta / 2)``."""
    a = torch.abs(e)
    return torch.where(a <= delta, 0.5 * e * e, delta * (a - 0.5 * delta))
