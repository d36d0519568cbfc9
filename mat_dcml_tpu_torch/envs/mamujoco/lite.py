"""Multi-agent MuJoCo lite: a jointed-chain stand-in for the MuJoCo robots,
batched over E envs on one device.

Port of ``mat_dcml_tpu/envs/mamujoco/lite.py::MJLiteEnv``.  The robot is
factorized into agents by the obsk joint partitions (``obsk.py``); each joint
follows the closed-form damped dynamics

    omega' = omega + dt (gain tau - damping omega - stiffness theta)
    theta' = theta + dt omega'
    reward = -mean((theta' - target)^2) - ctrl_cost mean(tau^2)

with ``tau`` the agents' torques clipped to [-1, 1] and scattered onto their
joints.  Every agent shares the reward.  An agent observes theta, omega and
target of the joints within ``agent_obsk`` hops of its own (zeros past its
row's width); the state is every joint's theta, omega and target.  Actions
are continuous; availability is all ones ``(E, A, 1)``.

The JAX env is a per-env function under ``vmap``; here every tensor has a
leading E axis and one call steps all E envs.  Randomness is an input, as in
the port's DCML env (``envs/dcml/env.py``): ``reset`` takes a
:class:`ResetDraws` and ``step`` a :class:`StepDraws`, holding exactly the
``uniform`` values the JAX env draws (``lite.py:118-166``), so a test can
replay them; :meth:`MJLiteEnv.draw_reset` and :meth:`MJLiteEnv.draw_step`
make them from a ``torch.Generator``.  ``step`` ends with the JAX env's
auto-reset: where an episode ends, the state returned is the next episode's
first and the reward is the last step's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from mat_dcml_tpu_torch.device import resolve_device
from mat_dcml_tpu_torch.envs.mamujoco.obsk import build_obs_indices, get_parts_and_edges
from mat_dcml_tpu_torch.envs.spaces import Box

THETA0 = (-0.1, 0.1)    # reset posture, uniform
TARGET = (-1.0, 1.0)    # per-episode target posture, uniform


class MJLiteState(NamedTuple):
    theta: torch.Tensor     # (E, J)
    omega: torch.Tensor     # (E, J)
    target: torch.Tensor    # (E, J)
    t: torch.Tensor         # (E,) int64 steps into the episode


class TimeStep(NamedTuple):
    obs: torch.Tensor                # (E, A, obs_dim)
    share_obs: torch.Tensor          # (E, A, share_obs_dim)
    available_actions: torch.Tensor  # (E, A, 1) ones
    reward: torch.Tensor             # (E, A, 1)
    done: torch.Tensor               # (E, A) bool
    delay: torch.Tensor              # (E,) zeros: the collector's DCML channels
    payment: torch.Tensor            # (E,) zeros


class ResetDraws(NamedTuple):
    """The draws of one reset, per env (``lite.py:120-124``)."""

    theta: torch.Tensor     # (E, J) U(-0.1, 0.1)
    target: torch.Tensor    # (E, J) U(-1, 1)


class StepDraws(NamedTuple):
    """The draws of one step: those of the auto-reset it always computes
    (``lite.py:160-161``), used where the episode ends."""

    reset: ResetDraws


@dataclasses.dataclass(frozen=True)
class MJLiteConfig:
    scenario: str = "HalfCheetah-v2"
    agent_conf: str = "2x3"
    agent_obsk: int = 1
    episode_length: int = 50
    dt: float = 0.05
    gain: float = 4.0
    damping: float = 0.4
    stiffness: float = 0.5
    ctrl_cost: float = 0.05


class MJLiteEnv:
    """E lite robots stepped together on ``device`` (default ``cuda``)."""

    def __init__(self, cfg: MJLiteConfig = MJLiteConfig(), device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        parts, graph = get_parts_and_edges(cfg.scenario, cfg.agent_conf)
        self.partitions = parts
        self.n_joints = len(graph.joints)
        self.n_agents = len(parts)
        # torques per agent: the largest partition (mujoco_multi.py:50)
        self.joints_per_agent = self.action_dim = max(len(p) for p in parts)
        # per-agent obs gather indices over the joint axis, -1 padded; the
        # state has one theta / omega per actuated joint, so the root's
        # global entries of the obsk rows drop out
        qpos_to_jid = {jt.qpos_id: j for j, jt in enumerate(graph.joints)}
        rows = []
        for p in parts:
            qpos_ids, _ = build_obs_indices(graph, p, cfg.agent_obsk)
            rows.append([qpos_to_jid[q] for q in qpos_ids if q in qpos_to_jid])
        width = max(len(r) for r in rows)
        jids = torch.tensor([r + [-1] * (width - len(r)) for r in rows], device=dev)
        self._obs_jids = jids.clamp(0, self.n_joints - 1)
        self._obs_mask = (jids >= 0).float()
        own = torch.tensor([list(p) + [-1] * (self.joints_per_agent - len(p)) for p in parts],
                           device=dev)
        self._own_jids = own.clamp(0, self.n_joints - 1).reshape(-1)
        self._own_valid = (own >= 0).float()
        self.obs_dim = 3 * width                     # theta, omega, target per visible joint
        self.share_obs_dim = 3 * self.n_joints
        self.episode_limit = cfg.episode_length
        self.action_space = Box(self.joints_per_agent)

    # ----------------------------------------------------------------- draws

    def draw_reset(self, n_envs: int, generator: Optional[torch.Generator] = None) -> ResetDraws:
        """A reset's draws for ``n_envs`` envs from ``generator``, on the env's device."""
        def uniform(lo_hi):
            u = torch.rand((n_envs, self.n_joints), generator=generator, device=self.device)
            return lo_hi[0] + (lo_hi[1] - lo_hi[0]) * u

        return ResetDraws(theta=uniform(THETA0), target=uniform(TARGET))

    def draw_step(self, n_envs: int, generator: Optional[torch.Generator] = None) -> StepDraws:
        return StepDraws(reset=self.draw_reset(n_envs, generator))

    # ------------------------------------------------------------------- obs

    def _observe(self, st: MJLiteState):
        def gather(x):                                # (E, J) -> (E, A, width)
            return x[:, self._obs_jids] * self._obs_mask

        obs = torch.cat([gather(st.theta), gather(st.omega), gather(st.target)], dim=-1)
        E = st.theta.shape[0]
        state = torch.cat([st.theta, st.omega, st.target], dim=-1)
        share = state[:, None].expand(E, self.n_agents, self.share_obs_dim)
        avail = torch.ones(E, self.n_agents, 1, device=self.device)
        return obs, share, avail

    def _timestep(self, st: MJLiteState, reward: torch.Tensor, done: torch.Tensor) -> TimeStep:
        obs, share, avail = self._observe(st)
        E, A = obs.shape[:2]
        zeros = torch.zeros(E, device=self.device)
        return TimeStep(obs=obs, share_obs=share, available_actions=avail,
                        reward=reward[:, None, None].expand(E, A, 1).contiguous(),
                        done=done[:, None].expand(E, A).contiguous(),
                        delay=zeros, payment=zeros.clone())

    # --------------------------------------------------------------- control

    def _fresh(self, draws: ResetDraws) -> MJLiteState:
        E = draws.theta.shape[0]
        return MJLiteState(theta=draws.theta, omega=torch.zeros_like(draws.theta),
                           target=draws.target,
                           t=torch.zeros(E, dtype=torch.int64, device=self.device))

    def reset(self, draws: ResetDraws, episode_idx=0):
        """Fresh episodes (``MJLiteEnv.reset``); ``episode_idx`` is unused, as
        in JAX."""
        del episode_idx
        st = self._fresh(draws)
        E = st.theta.shape[0]
        return st, self._timestep(st, torch.zeros(E, device=self.device),
                                  torch.zeros(E, dtype=torch.bool, device=self.device))

    def step(self, st: MJLiteState, action: torch.Tensor, draws: StepDraws):
        """One control step per env (``MJLiteEnv.step``); ``action (E, A,
        action_dim)`` torques, clipped to [-1, 1]."""
        c = self.cfg
        E = st.theta.shape[0]
        act = torch.clamp(action.reshape(E, self.n_agents, -1), -1.0, 1.0)
        # scatter each agent's torques back onto its joints
        tau = torch.zeros(E, self.n_joints, device=self.device).index_add_(
            1, self._own_jids, (act * self._own_valid).reshape(E, -1))
        omega = st.omega + c.dt * (c.gain * tau - c.damping * st.omega - c.stiffness * st.theta)
        theta = st.theta + c.dt * omega
        err = theta - st.target
        reward = -(err ** 2).mean(-1) - c.ctrl_cost * (tau ** 2).mean(-1)
        t = st.t + 1
        done = t >= c.episode_length
        fresh = self._fresh(draws.reset)
        mid = MJLiteState(theta=theta, omega=omega, target=st.target, t=t)
        new = MJLiteState(*(torch.where(done if a.dim() == 1 else done[:, None], a, b)
                            for a, b in zip(fresh, mid)))
        return new, self._timestep(new, reward, done)
