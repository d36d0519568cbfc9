"""PopArt: preserve-outputs-precisely value-head rescaling.

Port of ``mat_dcml_tpu/ops/popart.py`` (``:36-64``;
``mat/algorithms/utils/popart.py:48-70``).  The running moments are the
ValueNorm's (``ops/normalize.py``); an update advances them from a batch
AND rescales the value head's weights so that its denormalised outputs are
unchanged:

    w' = w * old_std / new_std
    b' = (old_std * b + old_mean - new_mean) / new_std

The head is ``{"kernel": (in, out), "bias": (out,)}`` (a flax Dense's
layout); ``popart_update`` returns the new moments and the new head, as the
JAX function does.  A trainer with one head a stack row maps it over the
rows (``torch.func.vmap``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from mat_dcml_tpu_torch.ops.normalize import ValueNormState, _debiased_mean_var, value_norm_update


def popart_std_mean(state: ValueNormState) -> Tuple[torch.Tensor, torch.Tensor]:
    mean, var = _debiased_mean_var(state)
    return torch.sqrt(var), mean


def popart_update(state: ValueNormState, batch: torch.Tensor, head: Dict[str, torch.Tensor],
                  beta: float = 0.99999) -> Tuple[ValueNormState, Dict[str, torch.Tensor]]:
    """Advance the moments from ``batch (..., out)`` and rescale ``head``."""
    old_std, old_mean = popart_std_mean(state)
    new_state = value_norm_update(state, batch, beta=beta)
    new_std, new_mean = popart_std_mean(new_state)
    kernel = head["kernel"] * (old_std / new_std)[None, :]
    bias = (old_std * head["bias"] + old_mean - new_mean) / new_std
    return new_state, {"kernel": kernel, "bias": bias}


def popart_normalize(state: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    mean, var = _debiased_mean_var(state)
    return (x - mean) / torch.sqrt(var)


def popart_denormalize(state: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    mean, var = _debiased_mean_var(state)
    return x * torch.sqrt(var) + mean
