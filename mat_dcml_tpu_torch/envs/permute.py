"""Per-episode agent-order permutation wrapper.

Port of ``mat_dcml_tpu/envs/permute.py::AgentPermutationWrapper`` (the
reference's ``Random_StarCraft2_Env`` and ``random_mujoco_multi.py``, whose
only addition is shuffling the agent order each episode so a policy cannot
overfit to slot identity), over the port's batched env protocol: outward row
``i`` of env ``e`` is inner agent ``perm[e, i]`` for obs, share_obs,
availability, reward and done, and incoming action rows are gathered back
with the inverse permutation before the inner ``step``.

A fresh order is drawn where the inner env auto-resets: the returned obs
already belong to the new episode, so they take the new order while that
step's reward and done keep the old one (``permute.py:70-91``).  Whole
per-agent action rows are permuted (the reference's flattened
``agent_recovery`` scrambles multi-dimensional torques; JAX fixed that too).

The permutations are draws like the env's own: :class:`ResetDraws` and
:class:`StepDraws` carry the inner env's draws and one permutation per env
(``(E, N)`` int64), which a test can take from ``jax.random.permutation``;
:meth:`AgentPermutationWrapper.draw_reset` / ``draw_step`` make them from a
``torch.Generator`` (the inner draws first).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch


class PermutedState(NamedTuple):
    inner: Any
    perm: torch.Tensor   # (E, N) int64: outward row i shows inner agent perm[:, i]
    inv: torch.Tensor    # (E, N) argsort(perm): inner agent j reads outward row inv[:, j]


class ResetDraws(NamedTuple):
    inner: Any
    perm: torch.Tensor   # (E, N) the episode's order


class StepDraws(NamedTuple):
    inner: Any
    perm: torch.Tensor   # (E, N) the next episode's order, used where one ends


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (E, N, ...)`` with its rows reordered per env by ``idx (E, N)``."""
    return x.gather(1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand_as(x))


class AgentPermutationWrapper:
    """Wrap a batched env with per-episode agent shuffling; every other
    attribute (``n_agents``, ``obs_dim``, ``action_dim``, ...) is the inner
    env's."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def _perm(self, n_envs: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        u = torch.rand(n_envs, self.env.n_agents, generator=generator, device=self.env.device)
        return torch.argsort(u, dim=1)

    def draw_reset(self, n_envs: int, generator: Optional[torch.Generator] = None) -> ResetDraws:
        inner = self.env.draw_reset(n_envs, generator)
        return ResetDraws(inner, self._perm(n_envs, generator))

    def draw_step(self, n_envs: int, generator: Optional[torch.Generator] = None) -> StepDraws:
        inner = self.env.draw_step(n_envs, generator)
        return StepDraws(inner, self._perm(n_envs, generator))

    def _permute_ts(self, ts, perm):
        return ts._replace(obs=_rows(ts.obs, perm), share_obs=_rows(ts.share_obs, perm),
                           available_actions=_rows(ts.available_actions, perm),
                           reward=_rows(ts.reward, perm), done=_rows(ts.done, perm))

    def reset(self, draws: ResetDraws, episode_idx=0):
        inner, ts = self.env.reset(draws.inner, episode_idx)
        perm = draws.perm.long()
        return PermutedState(inner, perm, torch.argsort(perm, dim=1)), self._permute_ts(ts, perm)

    def step(self, st: PermutedState, action: torch.Tensor, draws: StepDraws):
        E, N = st.perm.shape
        inner_action = _rows(action.reshape(E, N, -1), st.inv).reshape(action.shape)
        inner, ts = self.env.step(st.inner, inner_action, draws.inner)
        # reward and done describe the episode just played: the old order
        out = ts._replace(reward=_rows(ts.reward, st.perm), done=_rows(ts.done, st.perm))
        # obs and availability may belong to the auto-reset next episode
        fresh = draws.perm.long()
        done_now = ts.done.any(dim=1)[:, None]
        perm = torch.where(done_now, fresh, st.perm)
        inv = torch.where(done_now, torch.argsort(fresh, dim=1), st.inv)
        out = out._replace(obs=_rows(ts.obs, perm), share_obs=_rows(ts.share_obs, perm),
                           available_actions=_rows(ts.available_actions, perm))
        return PermutedState(inner, perm, inv), out
