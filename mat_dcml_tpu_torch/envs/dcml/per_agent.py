"""The per-agent (separated-policy) view of the DCML env.

Port of ``mat_dcml_tpu/envs/dcml/per_agent.py::PerAgentDCMLEnv``
(``:23-48``).  Every agent acts through one
:class:`~mat_dcml_tpu_torch.envs.spaces.MixedRole` space: a worker's
categorical head, or the master's Gaussian ratio, chosen per row by a role
flag that rides as a third ``available_actions`` column (0 for the workers,
1 for the master).  Actions are ``(E, A, 1)`` floats, the layout the env
steps.  Draws pass through to the wrapped env.
"""

from __future__ import annotations

import torch

from mat_dcml_tpu_torch.envs.dcml.env import DCMLEnv, TimeStep
from mat_dcml_tpu_torch.envs.spaces import MixedRole


class PerAgentDCMLEnv:
    """Wraps :class:`DCMLEnv` with role-augmented availability masks."""

    def __init__(self, env: DCMLEnv):
        self.env = env
        self.n_agents = env.n_agents
        self.obs_dim = env.obs_dim
        self.share_obs_dim = env.share_obs_dim
        self.action_space = MixedRole(n=env.action_dim, cont_dim=1)
        self.action_dim = env.action_dim
        self.device = env.device
        w = env.n_agents - env.cfg.consts.extra_agent
        self._role = torch.cat([torch.zeros(w, 1), torch.ones(env.n_agents - w, 1)]).to(
            env.device)

    def draw_reset(self, n_envs, generator=None):
        return self.env.draw_reset(n_envs, generator)

    def draw_step(self, n_envs, generator=None):
        return self.env.draw_step(n_envs, generator)

    def _wrap(self, ts: TimeStep) -> TimeStep:
        E = ts.available_actions.shape[0]
        role = self._role.expand(E, -1, -1)
        return ts._replace(available_actions=torch.cat(
            [ts.available_actions.float(), role], dim=-1))

    def reset(self, draws, episode_idx=0):
        state, ts = self.env.reset(draws, episode_idx)
        return state, self._wrap(ts)

    def step(self, state, action, draws):
        state, ts = self.env.step(state, action, draws)
        return state, self._wrap(ts)
