"""Trajectory collection on the device for the actor-critic family.

Port of ``mat_dcml_tpu/training/ac_rollout.py`` (``ACTrajectory``,
``ACRolloutState``, ``ACRolloutCollector``: ``init_state`` ``:114``,
``collect`` ``:132-``).  The JAX ``lax.scan`` over T steps is a Python loop;
each step acts with the policy's current weights (no gradient) and steps the
batched env (a DCML view: ``envs/dcml/{joint,per_agent}.py``).  Kept from
the JAX collector:

- the mask convention ``masks[t+1] = 1 - done_env[t]``, ``masks[0]`` the
  mask the chunk started with, all-ones ``active_masks``;
- the actor and critic hidden states entering each step, carried and
  stored (unchanged by the feed-forward policy; the recurrent slice fills
  them);
- IPPO's decentralised value (``use_local_value``): the critic reads, and
  the trajectory stores as ``share_obs``, the local obs;
- the on-device episode accounting: per-env running sums of reward, delay
  and payment, flushed into the chunk's totals where an episode ends.

The shared collector acts all ``E * A`` rows through one policy (stack
``S = 1``, rows in (env, agent) order, JAX's ``_rows``);
:class:`StackedRolloutCollector` (IPPO's and HAPPO's) acts each agent's
``E`` rows through its own policy, one batched product for all agents.

Randomness is an input: :class:`ACCollectDraws` holds the env's draws and
the policy's noise for every step; :meth:`ACRolloutCollector.draw` makes
them from a ``torch.Generator`` on the device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from mat_dcml_tpu_torch.models.act_layer import ACNoise
from mat_dcml_tpu_torch.models.actor_critic import ACOutput, ActorCriticPolicy
from mat_dcml_tpu_torch.training.rollout import _at, _stack


class ACTrajectory(NamedTuple):
    """One chunk, time-major ``(T, E, A, d)``."""

    share_obs: torch.Tensor          # the critic's input (local obs under IPPO)
    obs: torch.Tensor
    available_actions: torch.Tensor
    actions: torch.Tensor
    log_probs: torch.Tensor
    values: torch.Tensor
    rewards: torch.Tensor
    masks: torch.Tensor              # (T+1, E, A, 1)
    active_masks: torch.Tensor       # (T+1, E, A, 1)
    actor_h: torch.Tensor            # (T, E, A, N, h) hidden entering each step
    critic_h: torch.Tensor
    dones: torch.Tensor              # (T, E)
    delays: torch.Tensor             # (T, E)
    payments: torch.Tensor
    chunk_stats: Dict[str, torch.Tensor]


class ACRolloutState(NamedTuple):
    env_states: NamedTuple
    obs: torch.Tensor                # (E, A, obs)
    share_obs: torch.Tensor          # (E, A, sob)
    available_actions: torch.Tensor
    mask: torch.Tensor               # (E, A, 1)
    actor_h: torch.Tensor            # (E, A, N, h)
    critic_h: torch.Tensor
    episode_acc: torch.Tensor        # (E, 3) running reward, delay, payment


class ACCollectDraws(NamedTuple):
    """The random numbers of one chunk, each with a leading T axis: the
    env's ``StepDraws`` and the policy's :class:`ACNoise` at the
    collector's ``(S, N)`` rows."""

    env: NamedTuple
    noise: ACNoise


class ACRolloutCollector:
    """``use_local_value``: the critic reads the local obs (IPPO)."""

    stacked = False

    def __init__(self, env, policy: ActorCriticPolicy, episode_length: int,
                 use_local_value: bool = False):
        self.env = env
        self.policy = policy
        self.T = episode_length
        self.use_local_value = use_local_value

    # the (E, A, ...) <-> (S, N, ...) layouts
    def to_stack(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(1, x.shape[0] * x.shape[1], *x.shape[2:])

    def from_stack(self, y: torch.Tensor, E: int, A: int) -> torch.Tensor:
        return y.reshape(E, A, *y.shape[2:])

    def stack_rows(self, E: int, A: int) -> Tuple[int, int]:
        return 1, E * A

    def cent(self, st: ACRolloutState) -> torch.Tensor:
        return st.obs if self.use_local_value else st.share_obs

    def apply(self, st: ACRolloutState, deterministic: bool = False,
              noise: Optional[ACNoise] = None) -> ACOutput:
        """The policy's actions, log-probs, values and next hidden states at
        the ``(E, A, ...)`` level, with the policy's own weights."""
        E, A = st.obs.shape[:2]
        s = self.to_stack
        out = self.policy.get_actions(s(self.cent(st)), s(st.obs), s(st.actor_h),
                                      s(st.critic_h), s(st.mask), s(st.available_actions),
                                      deterministic, noise)
        return ACOutput(*(self.from_stack(x, E, A) for x in out))

    def draw(self, n_envs: int, generator: Optional[torch.Generator]) -> ACCollectDraws:
        """The chunk's env draws, then the policy's noise, from ``generator``."""
        env_draws = _stack([self.env.draw_step(n_envs, generator) for _ in range(self.T)])
        S, N = self.stack_rows(n_envs, self.env.n_agents)
        return ACCollectDraws(env_draws, self.policy.draw_noise(S, N, generator, lead=(self.T,)))

    def init_state(self, n_envs: int, draws: Optional[NamedTuple] = None,
                   generator: Optional[torch.Generator] = None) -> ACRolloutState:
        """Fresh envs from ``draws`` (the env's reset draws; drawn from
        ``generator`` when not given)."""
        if draws is None:
            draws = self.env.draw_reset(n_envs, generator)
        env_states, ts = self.env.reset(draws)
        E, A = ts.obs.shape[:2]
        dev = ts.obs.device
        ah, ch = self.policy.init_hidden(E * A)
        return ACRolloutState(
            env_states=env_states, obs=ts.obs, share_obs=ts.share_obs,
            available_actions=ts.available_actions, mask=torch.ones(E, A, 1, device=dev),
            actor_h=ah.reshape(E, A, *ah.shape[1:]), critic_h=ch.reshape(E, A, *ch.shape[1:]),
            episode_acc=torch.zeros(E, 3, device=dev),
        )

    def collect(self, rollout_state: ACRolloutState, draws: Optional[ACCollectDraws] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[ACRolloutState, ACTrajectory]:
        """Roll ``T`` steps with the policy's current weights (no gradient)."""
        st = rollout_state
        E = st.obs.shape[0]
        if draws is None:
            draws = self.draw(E, generator)
        keys = ("share_obs", "obs", "available_actions", "actions", "log_probs", "values",
                "rewards", "next_mask", "actor_h", "critic_h", "delay", "payment", "done",
                "flushed", "n_done")
        tr = {k: [] for k in keys}
        with torch.no_grad():
            for t in range(self.T):
                out = self.apply(st, noise=ACNoise(*(None if x is None else x[t]
                                                    for x in draws.noise)))
                env_states, ts = self.env.step(st.env_states, out.action, _at(draws.env, t))
                done_env = ts.done.all(dim=1)                                  # (E,)
                next_mask = torch.where(done_env[:, None, None], 0.0, 1.0).expand_as(st.mask)
                step_vals = torch.stack([ts.reward.sum(-1).mean(-1), ts.delay, ts.payment], -1)
                acc = st.episode_acc + step_vals
                tr["flushed"].append(torch.where(done_env[:, None], acc, 0.0).sum(0))
                tr["n_done"].append(done_env.sum().float())
                acc = torch.where(done_env[:, None], 0.0, acc)
                for k, v in (("share_obs", self.cent(st)), ("obs", st.obs),
                             ("available_actions", st.available_actions),
                             ("actions", out.action), ("log_probs", out.log_prob),
                             ("values", out.value), ("rewards", ts.reward),
                             ("next_mask", next_mask), ("actor_h", st.actor_h),
                             ("critic_h", st.critic_h), ("delay", ts.delay),
                             ("payment", ts.payment), ("done", done_env)):
                    tr[k].append(v)
                st = ACRolloutState(env_states, ts.obs, ts.share_obs, ts.available_actions,
                                    next_mask, out.actor_h, out.critic_h, acc)
        tr = {k: torch.stack(v) for k, v in tr.items()}
        flushed = tr["flushed"].sum(0)
        chunk_stats = {
            "n_done": tr["n_done"].sum(),
            "done_reward_sum": flushed[0],
            "done_delay_sum": flushed[1],
            "done_payment_sum": flushed[2],
            "step_reward_mean": tr["rewards"].sum(-1).mean(),
        }
        masks = torch.cat([rollout_state.mask[None], tr["next_mask"]], dim=0)
        traj = ACTrajectory(
            share_obs=tr["share_obs"], obs=tr["obs"], available_actions=tr["available_actions"],
            actions=tr["actions"], log_probs=tr["log_probs"], values=tr["values"],
            rewards=tr["rewards"], masks=masks, active_masks=torch.ones_like(masks),
            actor_h=tr["actor_h"], critic_h=tr["critic_h"], dones=tr["done"],
            delays=tr["delay"], payments=tr["payment"], chunk_stats=chunk_stats,
        )
        return st, traj


class StackedRolloutCollector(ACRolloutCollector):
    """One policy an agent (``policy.n_stack == A``): agent ``a``'s ``E``
    rows through stack row ``a`` (``ippo.py:48-58``'s vmap over the stacked
    parameters).  ``use_local_value=True`` is IPPO's decentralised value;
    HAPPO and HATRPO keep the centralised critic over ``share_obs``."""

    stacked = True

    def to_stack(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(0, 1)

    def from_stack(self, y: torch.Tensor, E: int, A: int) -> torch.Tensor:
        return y.transpose(0, 1)

    def stack_rows(self, E: int, A: int) -> Tuple[int, int]:
        return A, E
