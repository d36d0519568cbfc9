"""The single-agent joint view of the DCML env, for the centralised PPO.

Port of ``mat_dcml_tpu/envs/dcml/joint.py::JointDCMLEnv`` (``:24-63``).  The
reference's ``ppo`` flattens all DCML agents into one decision: the state is
the observation, and the action is the joint ``(w bits, ratio)`` vector of a
``DCMLActionSpace(mixed=True)`` head (``ppo_policy.py``, ``act.py:83-105``).
This view exposes one agent over the batched env: ``obs = share_obs`` of
agent 0, ``available_actions`` the workers' masks ``(E, 1, w, 2)``, and a
step's action ``(E, 1, w + 1)`` spread back to the per-agent layout
``(E, A, 1)`` the env steps.  Draws pass through to the wrapped env.
"""

from __future__ import annotations

from mat_dcml_tpu_torch.envs.dcml.env import DCMLEnv, TimeStep
from mat_dcml_tpu_torch.envs.spaces import DCMLActionSpace


class JointDCMLEnv:
    """Wraps :class:`DCMLEnv` with its A agents collapsed into one."""

    def __init__(self, env: DCMLEnv):
        self.env = env
        self.w = env.n_agents - 1              # the workers
        self.n_agents = 1
        self.obs_dim = env.share_obs_dim
        self.share_obs_dim = env.share_obs_dim
        self.action_space = DCMLActionSpace(n=env.action_dim, n_sub=self.w, semi_index=-1,
                                            mixed=True, multi_discrete=True, continuous=True)
        self.action_dim = self.action_space.sample_dim    # w + 1
        self.device = env.device

    def draw_reset(self, n_envs, generator=None):
        return self.env.draw_reset(n_envs, generator)

    def draw_step(self, n_envs, generator=None):
        return self.env.draw_step(n_envs, generator)

    def _wrap(self, ts: TimeStep) -> TimeStep:
        share = ts.share_obs[:, :1]                                 # (E, 1, sob)
        return TimeStep(obs=share, share_obs=share,
                        available_actions=ts.available_actions[:, None, :self.w, :],
                        reward=ts.reward[:, :1], done=ts.done[:, :1], delay=ts.delay,
                        payment=ts.payment, objectives=ts.objectives[:, :1])

    def reset(self, draws, episode_idx=0):
        state, ts = self.env.reset(draws, episode_idx)
        return state, self._wrap(ts)

    def step(self, state, action, draws):
        """``action (E, 1, w + 1)``: the bits, then the ratio."""
        state, ts = self.env.step(state, action[:, 0, :, None], draws)
        return state, self._wrap(ts)
