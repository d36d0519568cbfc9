"""Generalized Advantage Estimation over the leading time axis.

Port of ``mat_dcml_tpu/ops/gae.py::compute_gae``, the masked GAE of
``shared_buffer.py:207-238``:

  delta_t = r_t + gamma * V_{t+1} * mask_{t+1} - V_t
  gae_t   = delta_t + gamma * lambda * mask_{t+1} * gae_{t+1}
  ret_t   = gae_t + V_t

``mask_{t+1}`` is 0 when the env's episode ended at step t.  The reverse
``lax.scan`` becomes a loop over T; ``compute_gae_chunked`` gives the same
values and is not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch


def compute_gae(rewards: torch.Tensor, values: torch.Tensor, masks: torch.Tensor,
                gamma: float, gae_lambda: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rewards (T, ...)``, ``values (T+1, ...)`` (denormalised, bootstrap
    last), ``masks (T+1, ...)`` (``masks[0]`` unused) -> ``(advantages,
    returns)``, each ``(T, ...)``."""
    T = rewards.shape[0]
    adv = torch.empty_like(rewards)
    gae = torch.zeros_like(rewards[0])
    for t in range(T - 1, -1, -1):
        delta = rewards[t] + gamma * values[t + 1] * masks[t + 1] - values[t]
        gae = delta + gamma * gae_lambda * masks[t + 1] * gae
        adv[t] = gae
    return adv, adv + values[:-1]
