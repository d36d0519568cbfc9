"""Trajectory collection on the device.

Port of ``mat_dcml_tpu/training/rollout.py``. The JAX ``lax.scan`` over the
T steps of a chunk becomes a Python loop: each step decodes the E envs'
actions with the policy (stochastic, in the policy's decode mode) and steps
the batched env. The env is either of the port's batched envs, DCML
(``envs/dcml/env.py``) or multi-agent MuJoCo lite
(``envs/mamujoco/lite.py``): anything with ``draw_reset`` / ``draw_step`` /
``reset`` / ``step`` over explicit draws, whose time steps carry ``delay``
and ``payment`` (zeros for MuJoCo). Kept from the JAX collector:

- the mask convention ``masks[t+1] = 1 - done_env[t]`` (``dcml_runner.py:261-272``),
  with ``masks[0]`` the mask the chunk started with;
- all-ones ``active_masks`` (every agent shares the episode's done);
- the on-device episode accounting (``chunk_stats``): per-env running sums
  of reward, delay and payment, flushed into chunk totals where an episode
  ends, so only a handful of scalars leave the device;
- MO-MAT (``n_objective > 1`` on the policy's config): the rewards are the
  env's objective vector ``(E, A, n_objective)``, and ``chunk_stats`` holds
  each objective's step mean (``step_objective_<i>_mean``);
- DMO-MAT (``dynamic_coefficients``): per-env preference weights on the
  objective simplex, a Dirichlet(1, ..., 1) draw made as normalised
  exponentials (``rollout.py:113-120``), drawn at ``init_state`` and
  redrawn where an episode ends (``:215-224``); they are appended to both
  ``obs`` and ``share_obs`` (``augment_share_obs``: the encoder reads
  ``obs`` unless ``encode_state``), carried in the rollout state and
  recorded per step in the trajectory (the weights each step's reward was
  taken under).

Randomness is an input: :class:`CollectDraws` holds the policy's noise and
the env's draws for every step; :meth:`RolloutCollector.draw` makes them from
a ``torch.Generator`` on the device, DMO-MAT's exponentials included
(``CollectDraws.coef_exp``; ``init_state``'s ``coef_exp``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from mat_dcml_tpu_torch.models.policy import TransformerPolicy


class Trajectory(NamedTuple):
    """One chunk, time-major ``(T, E, A, d)``."""

    share_obs: torch.Tensor          # (T, E, A, sob)
    obs: torch.Tensor                # (T, E, A, obs)
    available_actions: torch.Tensor  # (T, E, A, avail_dim): act_dim (DCML), 1 (MuJoCo)
    actions: torch.Tensor            # (T, E, A, act_out_dim)
    log_probs: torch.Tensor          # (T, E, A, act_prob_dim)
    values: torch.Tensor             # (T, E, A, n_objective)
    rewards: torch.Tensor            # (T, E, A, n_objective)
    masks: torch.Tensor              # (T+1, E, A, 1)
    active_masks: torch.Tensor       # (T+1, E, A, 1)
    delays: torch.Tensor             # (T, E)
    payments: torch.Tensor           # (T, E)
    dones: torch.Tensor              # (T, E) episode-end flags
    chunk_stats: Dict[str, torch.Tensor]
    # DMO-MAT: each step's preference weights (T, E, n_objective); else None
    objective_coefficients: Optional[torch.Tensor] = None


class RolloutState(NamedTuple):
    """The carry between chunks (``shared_buffer.py:188-198``)."""

    env_states: NamedTuple           # the env's state, every field with a leading E
    obs: torch.Tensor                # (E, A, obs)
    share_obs: torch.Tensor          # (E, A, sob)
    available_actions: torch.Tensor  # (E, A, avail_dim)
    mask: torch.Tensor               # (E, A, 1) mask entering the next chunk
    episode_acc: torch.Tensor        # (E, 3) running reward, delay, payment
    objective_coefficients: Optional[torch.Tensor] = None   # (E, n_objective), DMO-MAT


class CollectDraws(NamedTuple):
    """The random numbers of one chunk, each with a leading T axis.  The
    policy's noise has the shapes of ``models/decode.py::noise_shapes``
    (None where the action family reads none): for DCML ``gumbel (T, E, A,
    adim)`` and ``tail_noise (T, A, E, adim)``, for MuJoCo's continuous
    actions ``tail_noise (T, A, E, adim)`` only."""

    gumbel: Optional[torch.Tensor]      # Gumbel noise of the categorical draws
    tail_noise: Optional[torch.Tensor]  # normals of the Gaussian parts (the
                                        # random baseline: its U(0, 1) draws)
    env: NamedTuple                     # the env's StepDraws, every field (T, E, ...)
    coef_exp: Optional[torch.Tensor] = None   # DMO-MAT: (T, E, n_objective) Exp(1) draws


def _at(draws, t: int):
    """Step ``t`` of a NamedTuple of tensors with a leading T axis (nested)."""
    return type(draws)(*(_at(x, t) if isinstance(x, tuple) else x[t] for x in draws))


def _stack(steps):
    """NamedTuples of tensors (nested) -> one with every leaf stacked on a
    new leading axis."""
    first = steps[0]
    return type(first)(*(_stack(xs) if isinstance(xs[0], tuple) else torch.stack(xs)
                         for xs in zip(*steps)))


class RolloutCollector:
    """``dynamic_coefficients``: DMO-MAT's per-env preference weights
    (module docstring), on when the policy has more than one objective; the
    policy must then take ``obs`` and ``share_obs`` widened by
    ``n_objective``."""

    def __init__(self, env, policy: TransformerPolicy, episode_length: int,
                 dynamic_coefficients: bool = False):
        self.env = env
        self.policy = policy
        self.T = episode_length
        # from the policy, so the reward channels match the critic's (the
        # random baseline has no config: one objective)
        self.n_objective = getattr(getattr(policy, "cfg", None), "n_objective", 1)
        self.dynamic_coefficients = dynamic_coefficients and self.n_objective > 1

    def _draw_exp(self, shape, generator, device) -> torch.Tensor:
        return torch.empty(shape, device=device).exponential_(generator=generator)

    def draw(self, n_envs: int, generator: Optional[torch.Generator]) -> CollectDraws:
        """The chunk's noise and env draws from ``generator`` on the policy's
        device: the env's, the policy's, then DMO-MAT's exponentials."""
        env_draws = _stack([self.env.draw_step(n_envs, generator) for _ in range(self.T)])
        gumbel, tail_noise = self.policy.draw_noise(n_envs, self.T, generator)
        coef_exp = (self._draw_exp((self.T, n_envs, self.n_objective), generator,
                                   self.policy.device)
                    if self.dynamic_coefficients else None)
        return CollectDraws(gumbel=gumbel, tail_noise=tail_noise, env=env_draws,
                            coef_exp=coef_exp)

    @staticmethod
    def sample_coefficients(exp_draws: torch.Tensor) -> torch.Tensor:
        """Dirichlet(1, ..., 1) from Exp(1) draws ``(..., n_objective)``:
        normalised to the simplex (``rollout.py:113-120``)."""
        return exp_draws / exp_draws.sum(-1, keepdim=True)

    def augment_share_obs(self, x: torch.Tensor, coefs: Optional[torch.Tensor]) -> torch.Tensor:
        """Append each env's preference weights ``coefs (E, n_objective)`` to
        every agent's row of ``x (E, A, d)`` (DMO-MAT; else ``x``)."""
        if not self.dynamic_coefficients:
            return x
        return torch.cat([x, coefs[:, None, :].expand(-1, x.shape[1], -1)], dim=-1)

    def init_state(self, n_envs: int, draws: Optional[NamedTuple] = None,
                   generator: Optional[torch.Generator] = None,
                   coef_exp: Optional[torch.Tensor] = None) -> RolloutState:
        """Fresh envs from ``draws`` (the env's reset draws), and under
        DMO-MAT first preference weights from ``coef_exp (E, n_objective)``;
        whichever is not given is drawn from ``generator``, the env's
        first."""
        if draws is None:
            draws = self.env.draw_reset(n_envs, generator)
        env_states, ts = self.env.reset(draws)
        E, A = ts.obs.shape[:2]
        dev = ts.obs.device
        coefs = None
        if self.dynamic_coefficients:
            if coef_exp is None:
                coef_exp = self._draw_exp((E, self.n_objective), generator, dev)
            coefs = self.sample_coefficients(coef_exp.to(dev))
        return RolloutState(
            env_states=env_states, obs=self.augment_share_obs(ts.obs, coefs),
            share_obs=self.augment_share_obs(ts.share_obs, coefs),
            available_actions=ts.available_actions,
            mask=torch.ones(E, A, 1, device=dev),
            episode_acc=torch.zeros(E, 3, device=dev),
            objective_coefficients=coefs,
        )

    def collect(self, rollout_state: RolloutState, draws: Optional[CollectDraws] = None,
                generator: Optional[torch.Generator] = None) -> Tuple[RolloutState, Trajectory]:
        """Roll ``T`` steps with the policy's current weights (no gradient)."""
        st = rollout_state
        E = st.obs.shape[0]
        if draws is None:
            draws = self.draw(E, generator)
        keys = ("share_obs", "obs", "available_actions", "actions", "log_probs", "values",
                "rewards", "next_mask", "delay", "payment", "done", "flushed", "n_done",
                "objective_coefficients")
        tr = {k: [] for k in keys}
        with torch.no_grad():
            for t in range(self.T):
                gumbel, tail_noise = (None if x is None else x[t]
                                      for x in (draws.gumbel, draws.tail_noise))
                out = self.policy.get_actions(
                    st.share_obs, st.obs, st.available_actions, deterministic=False,
                    gumbel=gumbel, tail_noise=tail_noise,
                )
                env_states, ts = self.env.step(st.env_states, out.action, _at(draws.env, t))
                done_env = ts.done.all(dim=1)                                  # (E,)
                next_mask = torch.where(done_env[:, None, None], 0.0, 1.0).expand_as(st.mask)
                reward = ts.objectives if self.n_objective > 1 else ts.reward
                # on-device episode accounting: per-env sums, flushed where an
                # episode ends
                step_vals = torch.stack([reward.sum(-1).mean(-1), ts.delay, ts.payment], -1)
                acc = st.episode_acc + step_vals
                tr["flushed"].append(torch.where(done_env[:, None], acc, 0.0).sum(0))
                tr["n_done"].append(done_env.sum().float())
                acc = torch.where(done_env[:, None], 0.0, acc)
                for k, v in (("share_obs", st.share_obs), ("obs", st.obs),
                             ("available_actions", st.available_actions),
                             ("actions", out.action), ("log_probs", out.log_prob),
                             ("values", out.value), ("rewards", reward),
                             ("next_mask", next_mask), ("delay", ts.delay),
                             ("payment", ts.payment), ("done", done_env)):
                    tr[k].append(v)
                coefs = st.objective_coefficients
                if self.dynamic_coefficients:
                    # the weights of this step; fresh ones where the episode ended
                    tr["objective_coefficients"].append(coefs)
                    fresh = self.sample_coefficients(draws.coef_exp[t])
                    coefs = torch.where(done_env[:, None], fresh, coefs)
                st = RolloutState(env_states, self.augment_share_obs(ts.obs, coefs),
                                  self.augment_share_obs(ts.share_obs, coefs),
                                  ts.available_actions, next_mask, acc, coefs)
        tr = {k: torch.stack(v) if v else None for k, v in tr.items()}
        flushed = tr["flushed"].sum(0)
        chunk_stats = {
            "n_done": tr["n_done"].sum(),
            "done_reward_sum": flushed[0],
            "done_delay_sum": flushed[1],
            "done_payment_sum": flushed[2],
            "step_reward_mean": tr["rewards"].sum(-1).mean(),
        }
        if self.n_objective > 1:
            for i in range(self.n_objective):
                chunk_stats[f"step_objective_{i}_mean"] = tr["rewards"][..., i].mean()
        masks = torch.cat([rollout_state.mask[None], tr["next_mask"]], dim=0)
        traj = Trajectory(
            share_obs=tr["share_obs"], obs=tr["obs"], available_actions=tr["available_actions"],
            actions=tr["actions"], log_probs=tr["log_probs"], values=tr["values"],
            rewards=tr["rewards"], masks=masks, active_masks=torch.ones_like(masks),
            delays=tr["delay"], payments=tr["payment"], dones=tr["done"],
            chunk_stats=chunk_stats, objective_coefficients=tr["objective_coefficients"],
        )
        return st, traj
