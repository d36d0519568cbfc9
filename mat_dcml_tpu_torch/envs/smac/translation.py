"""Multi-map SMAC feature translation (``starcraft2/feature_translation.py``).

Port of ``mat_dcml_tpu/envs/smac/translation.py``.  Maps differ in agent
counts, rosters and action spaces; to train one policy across maps, each
map's obs, state and availability are padded into one universal layout:

- agents padded to ``TARGET_NUM_AGENT`` (27), enemies to ``TARGET_NUM_ENEMY``
  (30), so ``TARGET_ACTION_DIM`` = 36 actions; a padded agent is dead: zero
  features and the no-op alone available;
- each unit row widened to a universal schema with a shield slot and a
  one-hot over every known unit type (``UNIFIED_TYPES``), so "marine" is the
  same column on every map;
- a task embedding (the map's one-hot and its normalised team sizes and step
  limit, ``gen_task_embedding``) appended to obs and state: obs 869, state
  1754.

:class:`TranslatedSMACEnv` exposes the padded env with the batched env
protocol of :class:`~mat_dcml_tpu_torch.envs.smac.smaclite.SMACLiteEnv` (the
same draws), so collectors and policies are map-agnostic.  As in JAX it has
no ``episode_limit`` (an evaluation's step budget then takes 200 a battle).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mat_dcml_tpu_torch.envs.smac.maps import UNIT_STATS, map_param_registry
from mat_dcml_tpu_torch.envs.smac.smaclite import (
    N_ACTIONS_NO_ATTACK,
    SMACLiteConfig,
    SMACLiteEnv,
    SMACTimeStep,
)

TARGET_NUM_AGENT = 27
TARGET_NUM_ENEMY = 30
TARGET_ACTION_DIM = N_ACTIONS_NO_ATTACK + TARGET_NUM_ENEMY

UNIFIED_TYPES: Tuple[str, ...] = tuple(sorted(UNIT_STATS))
N_TYPES = len(UNIFIED_TYPES)

# universal row widths: (flag, dist, relx, rely, health, shield, type*)
UNIT_ROW_DIM = 5 + 1 + N_TYPES
OWN_ROW_DIM = 1 + 1 + N_TYPES
STATE_ALLY_DIM = 4 + 1 + N_TYPES          # health, cd, relx, rely, shield, type*
STATE_ENEMY_DIM = 3 + 1 + N_TYPES

_MAP_NAMES = tuple(sorted(map_param_registry))
TASK_EMBEDDING_DIM = len(_MAP_NAMES) + 3


def gen_task_embedding(map_name: str) -> np.ndarray:
    """Map one-hot + (n_agents, n_enemies, limit) normalised
    (``feature_translation.py:283-293``)."""
    mp = map_param_registry[map_name]
    one_hot = np.zeros(len(_MAP_NAMES), np.float32)
    one_hot[_MAP_NAMES.index(map_name)] = 1.0
    extras = np.array(
        [mp.n_agents / TARGET_NUM_AGENT, mp.n_enemies / TARGET_NUM_ENEMY, mp.limit / 200.0],
        np.float32,
    )
    return np.concatenate([one_hot, extras])


def _widen_rows(rows: torch.Tensor, env: SMACLiteEnv, flag_cols: int) -> torch.Tensor:
    """``(..., k, row_dim) -> (..., k, flag_cols + 4 + 1 + N_TYPES)``: the first
    ``flag_cols + 4`` columns copied, the shield into the universal shield
    slot, the unit type re-embedded into the unified one-hot (JAX
    ``_widen_rows``, whose column split this keeps)."""
    lead = rows[..., : flag_cols + 3]
    health = rows[..., flag_cols + 3: flag_cols + 4]
    idx = flag_cols + 4
    if env.shield_bits:
        shield = rows[..., idx: idx + 1]
        idx += 1
    else:
        shield = torch.zeros_like(health)
    uni = torch.zeros(*rows.shape[:-1], N_TYPES, dtype=rows.dtype, device=rows.device)
    local_types = env.map_params.unit_types
    if env.unit_type_bits:
        for j, name in enumerate(local_types):
            uni[..., UNIFIED_TYPES.index(name)] = rows[..., idx + j]
    else:
        # homogeneous map: the one roster type, set where the row is live
        # (a padded or unseen row stays all zero)
        live = (rows.abs().sum(-1) > 0).to(rows.dtype)
        uni[..., UNIFIED_TYPES.index(local_types[0])] = live
    return torch.cat([lead, health, shield, uni], dim=-1)


def _pad_axis(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    """Zeros appended along ``axis`` up to ``target``."""
    shape = list(x.shape)
    shape[axis] = target - x.shape[axis]
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


class TranslatedSMACEnv:
    """E battles of one SMAC-lite map in the universal multi-map layout."""

    def __init__(self, cfg: SMACLiteConfig = SMACLiteConfig(), device=None):
        self.env = SMACLiteEnv(cfg, device=device)
        self.device = self.env.device
        self.map_name = cfg.map_name
        self.n_agents = TARGET_NUM_AGENT
        self.action_dim = TARGET_ACTION_DIM
        self._task_emb = torch.as_tensor(gen_task_embedding(cfg.map_name), device=self.device)
        self.obs_dim = (4 + TARGET_NUM_ENEMY * UNIT_ROW_DIM
                        + (TARGET_NUM_AGENT - 1) * UNIT_ROW_DIM + OWN_ROW_DIM
                        + TASK_EMBEDDING_DIM)
        self.share_obs_dim = (TARGET_NUM_AGENT * STATE_ALLY_DIM
                              + TARGET_NUM_ENEMY * STATE_ENEMY_DIM
                              + TARGET_NUM_AGENT * TARGET_ACTION_DIM + TASK_EMBEDDING_DIM)

    def draw_reset(self, n_envs, generator=None):
        return self.env.draw_reset(n_envs, generator)

    def draw_step(self, n_envs, generator=None):
        return self.env.draw_step(n_envs, generator)

    # ------------------------------------------------------------ translate

    def _translate_obs(self, obs: torch.Tensor) -> torch.Tensor:
        e = self.env
        E, A, Ne = obs.shape[0], e.n_agents, e.n_enemies
        i = 4
        move = obs[..., :i]
        enemy = obs[..., i: i + Ne * e.enemy_feat_dim].reshape(E, A, Ne, e.enemy_feat_dim)
        i += Ne * e.enemy_feat_dim
        ally = obs[..., i: i + (A - 1) * e.ally_feat_dim].reshape(E, A, A - 1, e.ally_feat_dim)
        i += (A - 1) * e.ally_feat_dim
        own = obs[..., i:]
        enemy_u = _pad_axis(_widen_rows(enemy, e, flag_cols=1), 2, TARGET_NUM_ENEMY)
        ally_u = _pad_axis(_widen_rows(ally, e, flag_cols=1), 2, TARGET_NUM_AGENT - 1)
        own_u = _widen_rows(own[:, :, None, :], e, flag_cols=-3)[:, :, 0, :]
        flat = torch.cat([move, enemy_u.reshape(E, A, -1), ally_u.reshape(E, A, -1), own_u,
                          self._task_emb.expand(E, A, TASK_EMBEDDING_DIM)], dim=-1)
        return _pad_axis(flat, 1, TARGET_NUM_AGENT)

    def _translate_state(self, share_obs: torch.Tensor) -> torch.Tensor:
        e = self.env
        E, A, Ne = share_obs.shape[0], e.n_agents, e.n_enemies
        row = share_obs[:, 0]
        i = A * e.state_ally_dim
        a_state = row[:, :i].reshape(E, A, e.state_ally_dim)
        e_state = row[:, i: i + Ne * e.state_enemy_dim].reshape(E, Ne, e.state_enemy_dim)
        i += Ne * e.state_enemy_dim
        last = row[:, i:].reshape(E, A, e.n_actions)
        a_u = _pad_axis(_widen_rows(a_state, e, flag_cols=0), 1, TARGET_NUM_AGENT)
        e_u = _pad_axis(_widen_rows(e_state, e, flag_cols=-1), 1, TARGET_NUM_ENEMY)
        # the last-action one-hot: its no-attack block, then its attack block padded
        last_u = torch.cat([last[..., :N_ACTIONS_NO_ATTACK],
                            _pad_axis(last[..., N_ACTIONS_NO_ATTACK:], 2, TARGET_NUM_ENEMY)],
                           dim=-1)
        last_u = _pad_axis(last_u, 1, TARGET_NUM_AGENT)
        state = torch.cat([a_u.reshape(E, -1), e_u.reshape(E, -1), last_u.reshape(E, -1),
                           self._task_emb.expand(E, -1)], dim=-1)
        return state[:, None].expand(E, TARGET_NUM_AGENT, self.share_obs_dim)

    def _translate_avail(self, avail: torch.Tensor) -> torch.Tensor:
        E, A = avail.shape[:2]
        wide = torch.cat([avail[..., :N_ACTIONS_NO_ATTACK],
                          _pad_axis(avail[..., N_ACTIONS_NO_ATTACK:], 2, TARGET_NUM_ENEMY)],
                         dim=-1)
        pad_rows = avail.new_zeros(E, TARGET_NUM_AGENT - A, TARGET_ACTION_DIM)
        pad_rows[..., 0] = 1.0                     # padded agents: the no-op alone
        return torch.cat([wide, pad_rows], dim=1)

    def _translate_ts(self, ts: SMACTimeStep) -> SMACTimeStep:
        E = ts.obs.shape[0]
        return SMACTimeStep(
            obs=self._translate_obs(ts.obs),
            share_obs=self._translate_state(ts.share_obs),
            available_actions=self._translate_avail(ts.available_actions),
            reward=ts.reward[:, :1].expand(E, TARGET_NUM_AGENT, 1).contiguous(),
            done=ts.done[:, :1].expand(E, TARGET_NUM_AGENT).contiguous(),
            delay=ts.delay,
            payment=ts.payment,
        )

    # --------------------------------------------------------------- control

    def reset(self, draws, episode_idx=0):
        st, ts = self.env.reset(draws, episode_idx)
        return st, self._translate_ts(ts)

    def step(self, st, action: torch.Tensor, draws):
        """``action (E, 27, 1)``: the padded agents' actions are dropped; an
        attack id past the map's enemies is unavailable and downgraded in
        the env."""
        st, ts = self.env.step(st, action[:, : self.env.n_agents], draws)
        return st, self._translate_ts(ts)
