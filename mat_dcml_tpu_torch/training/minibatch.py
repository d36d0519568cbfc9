"""Minibatch assembly for the PPO update: per-epoch row permutations and the
gather of a minibatch's rows.

Port of the default (``minibatch_layout="gather"``) path of
``mat_dcml_tpu/training/minibatch.py`` and ``ppo.py``'s ``run_epoch``.  The
contiguous layout and the streaming chunk helpers are XLA memory devices
that give the same values, and are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def permutations(n_epochs: int, n_rows: int, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """``(n_epochs, n_rows)``: one random row order per PPO epoch."""
    return torch.stack([torch.randperm(n_rows, generator=generator, device=device)
                        for _ in range(n_epochs)])


def minibatch_rows(perm: torch.Tensor, num_mini_batch: int) -> torch.Tensor:
    """``(num_mini_batch, mb_size)`` row indices; rows past ``mb_size *
    num_mini_batch`` are dropped, as the reference floors
    (``shared_buffer.py:250-261``)."""
    mb_size = perm.shape[0] // num_mini_batch
    return perm[: mb_size * num_mini_batch].reshape(num_mini_batch, mb_size)


def gather_rows(tree: Dict[str, torch.Tensor], rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: v[rows] for k, v in tree.items()}
