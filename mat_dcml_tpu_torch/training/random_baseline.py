"""Random baseline policy and no-op trainer.

Port of ``mat_dcml_tpu/training/random_baseline.py`` (reference
``mat/algorithms/random/``, ``random_policy.py:79-109``): per agent, a
uniform-random *available* discrete action for all but the last
``n_cont_tail`` agents, and ``U(0, 1)`` for the tail (the DCML coding-ratio
agent); values and log-probs are zeros and the trainer does nothing.  The
sanity anchor the benchmark sweeps compare against (``--algorithm_name
random``; the runner never checkpoints it).

Uniform among the available actions is the argmax of Gumbel noise restricted
to the available set.  Randomness is an input, as everywhere in the port:
``get_actions`` takes the Gumbel draws ``(B, A, action_dim)`` and the
uniforms ``(B, A)`` (the collector's ``gumbel`` and ``tail_noise`` slots),
or draws them from a generator.
"""

from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional

import torch

from mat_dcml_tpu_torch.device import resolve_device, synchronize
from mat_dcml_tpu_torch.ops import distributions as D
from mat_dcml_tpu_torch.training.ppo import TrainMetrics


class RandomPolicyOutput(NamedTuple):
    value: torch.Tensor      # (B, A, 1) zeros
    action: torch.Tensor     # (B, A, 1)
    log_prob: torch.Tensor   # (B, A, 1) zeros


class RandomTrainState(NamedTuple):
    """The random baseline trains nothing; its state is empty."""


class RandomPolicy:
    """Drop-in for ``TransformerPolicy.get_actions`` on the DCML layout, on
    ``device`` (default ``cuda``)."""

    def __init__(self, n_agent: int, action_dim: int, n_cont_tail: int = 1, device=None):
        self.n_agent = n_agent
        self.action_dim = action_dim
        self.n_cont_tail = n_cont_tail
        self.device = resolve_device(device)

    def draw_noise(self, n_envs: int, steps: int, generator: Optional[torch.Generator]):
        """``(gumbel (steps, B, A, action_dim), uniform (steps, B, A))``."""
        A = self.n_agent
        gumbel = D.gumbel_noise((steps, n_envs, A, self.action_dim), generator, self.device)
        uniform = torch.rand((steps, n_envs, A), generator=generator, device=self.device)
        return gumbel, uniform

    def get_actions(self, state, obs, available_actions=None, deterministic: bool = False, *,
                    gumbel: Optional[torch.Tensor] = None,
                    tail_noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> RandomPolicyOutput:
        """``(B, A, ...)`` batched sampling; ``tail_noise`` is the uniforms
        ``(B, A)``.  ``deterministic`` is ignored: the reference has no
        deterministic random mode."""
        obs = torch.as_tensor(obs, device=self.device)
        B, A = obs.shape[:2]
        if gumbel is None or tail_noise is None:
            g, u = self.draw_noise(B, 1, generator)
            gumbel = g[0] if gumbel is None else gumbel
            tail_noise = u[0] if tail_noise is None else tail_noise
        gumbel = gumbel.to(self.device)
        ava = (torch.ones(B, A, self.action_dim, device=self.device)
               if available_actions is None
               else torch.as_tensor(available_actions, device=self.device))
        disc = torch.argmax(torch.where(ava > 0, gumbel, -torch.inf), dim=-1).float()
        is_tail = torch.arange(A, device=self.device) >= (A - self.n_cont_tail)
        action = torch.where(is_tail[None, :], tail_noise.to(self.device), disc)[..., None]
        zeros = torch.zeros(B, A, 1, device=self.device)
        return RandomPolicyOutput(value=zeros, action=action, log_prob=zeros)


class RandomTrainer:
    """No-op trainer (``random_trainer.py``): keeps the runner's
    collect-then-train loop and its records without learning anything."""

    def __init__(self, policy: RandomPolicy):
        self.policy = policy

    def init_state(self) -> RandomTrainState:
        return RandomTrainState()

    def state_dict(self, state: RandomTrainState) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, state: RandomTrainState, saved: Dict[str, Any]) -> RandomTrainState:
        return state

    def train_iteration(self, collector, state, rollout_state,
                        generator: Optional[torch.Generator] = None):
        """Collect one chunk; the update is nothing.  Returns what
        ``MATTrainer.train_iteration`` returns."""
        t0 = time.perf_counter()
        rollout_state, traj = collector.collect(rollout_state, generator=generator)
        synchronize(self.policy.device)
        t1 = time.perf_counter()
        z = torch.zeros((), device=self.policy.device)
        metrics = TrainMetrics(value_loss=z, policy_loss=z, dist_entropy=z, grad_norm=z,
                               ratio=torch.ones((), device=self.policy.device), param_norm=z,
                               update_ratio=z, nonfinite_grads=z)
        return state, rollout_state, metrics, traj.chunk_stats, (t1 - t0, time.perf_counter() - t1)
