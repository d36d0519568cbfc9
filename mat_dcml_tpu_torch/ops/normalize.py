"""The debiased running value normaliser (ValueNorm).

Port of ``mat_dcml_tpu/ops/normalize.py`` (``mat/utils/valuenorm.py``): EMA of
the mean and mean square with ``beta = 0.99999``, a debiasing term clamped to
``>= 1e-5`` and the variance to ``>= 1e-2``.  The state is a tuple of
tensors, and every function returns a new one.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class ValueNormState(NamedTuple):
    running_mean: torch.Tensor      # (shape,)
    running_mean_sq: torch.Tensor   # (shape,)
    debiasing_term: torch.Tensor    # ()


def value_norm_init(shape: int = 1, device=None) -> ValueNormState:
    return ValueNormState(
        running_mean=torch.zeros(shape, device=device),
        running_mean_sq=torch.zeros(shape, device=device),
        debiasing_term=torch.zeros((), device=device),
    )


def _debiased_mean_var(state: ValueNormState, epsilon: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    term = torch.clamp(state.debiasing_term, min=epsilon)
    mean = state.running_mean / term
    mean_sq = state.running_mean_sq / term
    var = torch.clamp(mean_sq - mean ** 2, min=1e-2)
    return mean, var


def value_norm_update(state: ValueNormState, batch: torch.Tensor, beta: float = 0.99999) -> ValueNormState:
    """EMA update from ``batch``, whose trailing dim is the state's shape."""
    axes = tuple(range(batch.dim() - 1))
    batch_mean = batch.mean(dim=axes)
    batch_sq_mean = (batch ** 2).mean(dim=axes)
    return ValueNormState(
        running_mean=state.running_mean * beta + batch_mean * (1.0 - beta),
        running_mean_sq=state.running_mean_sq * beta + batch_sq_mean * (1.0 - beta),
        debiasing_term=state.debiasing_term * beta + (1.0 - beta),
    )


def value_norm_normalize(state: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    mean, var = _debiased_mean_var(state)
    return (x - mean) / torch.sqrt(var)


def value_norm_denormalize(state: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    mean, var = _debiased_mean_var(state)
    return x * torch.sqrt(var) + mean
