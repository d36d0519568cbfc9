"""The PPO update of the actor-critic family (centralised PPO, MAPPO, and
the per-agent core of IPPO and HAPPO).

Port of ``mat_dcml_tpu/training/mappo.py`` (``MAPPOConfig``, ``Bootstrap``,
``MAPPOTrainer``), feed-forward (``_train_ff``, ``:310-383``; the chunked
recurrent trainer waits for the recurrent slice, ROADMAP.md queue 1, item
9).  The JAX update is one jitted ``lax.scan`` over epochs and minibatches;
here it is two Python loops over the same arithmetic:

- the targets once an update (``base_runner.train:329-435``): the
  bootstrap value, the ValueNorm (or PopArt) denormalisation, GAE through
  ``ops/gae.py``, the advantages normalised over active entries
  (``_compute_targets`` ``:232-249``);
- per minibatch, the ValueNorm (``ops/normalize.py``) or PopArt
  (``ops/popart.py``, which also rescales the critic's head) updated on the
  minibatch's returns, then the targets normalised (``_normalize_targets``
  ``:250-270``); the clipped surrogate (the ratio ``exp(logp - old)`` per
  action dim, or with ``importance_prod`` the product over the dims, a sum
  of log-prob differences), the clipped Huber value loss, the entropy
  (``_value_loss`` / ``_policy_loss`` ``:198-231``);
- the actor and the critic with optimisers of their own, each gradient
  clipped by its own global norm as ``optax.clip_by_global_norm`` does
  (scaled by ``max / norm`` only when ``norm >= max``, no epsilon), then
  the optional weight decay, then Adam (``_apply_updates`` ``:284-308``).

The weights are the policy's flat ``(S, P)`` tensors
(``models/actor_critic.py``), and everything the update keeps carries the
same stack axis: Adam's moments and step count (:class:`AdamState`, optax's
``scale_by_adam`` on one tensor a group, a step count a stack row) and the
ValueNorm (``ops/normalize.py``'s arithmetic on each row; PopArt's
functions mapped over the rows with ``torch.func.vmap``).  With
``S = 1`` this is MAPPO; IPPO (``training/ippo.py``) updates its A rows at
once, each row's loss, clip and Adam its own (JAX's ``vmap`` over agents);
HAPPO (``training/happo.py``) updates one row at a time.

Randomness is an input: ``train`` takes each stack row's per-epoch row
permutations, or draws them from a generator.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.func import vmap

from mat_dcml_tpu_torch.device import synchronize
from mat_dcml_tpu_torch.models.actor_critic import ActorCriticPolicy
from mat_dcml_tpu_torch.ops.distributions import huber_loss
from mat_dcml_tpu_torch.ops.gae import compute_gae
from mat_dcml_tpu_torch.ops.normalize import ValueNormState, value_norm_init
from mat_dcml_tpu_torch.ops.popart import popart_normalize, popart_update
from mat_dcml_tpu_torch.training.ac_rollout import ACRolloutCollector, ACTrajectory


# config.py's defaults for the JAX fields that no DCML run changes
OPTI_EPS = 1e-5          # Adam's epsilon
HUBER_DELTA = 10.0


@dataclasses.dataclass(frozen=True)
class MAPPOConfig:
    """The fields of the JAX ``MAPPOConfig`` that the feed-forward update
    reads; defaults follow ``config.py`` (lr 5e-4 group, ppo group).  The
    critic's lr is the actor's, as every DCML run sets it
    (``base_runner.py:216-226``)."""

    lr: float = 5e-4
    weight_decay: float = 0.0
    clip_param: float = 0.2
    ppo_epoch: int = 15
    num_mini_batch: int = 1
    entropy_coef: float = 0.01
    value_loss_coef: float = 1.0
    max_grad_norm: float = 10.0
    gamma: float = 0.99
    gae_lambda: float = 0.95
    use_clipped_value_loss: bool = True
    use_huber_loss: bool = True
    use_popart: bool = False
    use_valuenorm: bool = True
    use_value_active_masks: bool = True
    use_policy_active_masks: bool = True
    use_max_grad_norm: bool = True
    importance_prod: bool = False


class Bootstrap(NamedTuple):
    """The rollout's tail, for the bootstrap value: ``(E, A, ...)``."""

    cent_obs: torch.Tensor
    critic_h: torch.Tensor
    mask: torch.Tensor


# ------------------------------------------------------------------ Adam

class AdamState(NamedTuple):
    """optax ``scale_by_adam``'s state on a flat ``(S, P)`` group: a step
    count a stack row, the two moments."""

    count: torch.Tensor      # (S,) int64
    mu: torch.Tensor         # (S, P)
    nu: torch.Tensor


def adam_init(flat: torch.Tensor) -> AdamState:
    return AdamState(torch.zeros(flat.shape[0], dtype=torch.int64, device=flat.device),
                     torch.zeros_like(flat), torch.zeros_like(flat))


def adam_update(grad: torch.Tensor, st: AdamState, lr: float, eps: float, b1: float = 0.9,
                b2: float = 0.999) -> Tuple[torch.Tensor, AdamState]:
    """``(updates, state)`` of ``optax.adam(lr, eps=eps)`` in optax's order:
    the moments, the bias corrections at the incremented count, then
    ``-lr * m_hat / (sqrt(v_hat) + eps)``."""
    mu = (1 - b1) * grad + b1 * st.mu
    nu = (1 - b2) * (grad * grad) + b2 * st.nu
    count = st.count + 1
    c = count.to(torch.float32)[:, None]
    mu_hat = mu / (1 - torch.pow(b1, c))      # a float base: no host-to-device copy
    nu_hat = nu / (1 - torch.pow(b2, c))
    return -lr * (mu_hat / (torch.sqrt(nu_hat) + eps)), AdamState(count, mu, nu)


def row_norm(x: torch.Tensor) -> torch.Tensor:
    """``optax.global_norm`` of each stack row of a flat ``(S, P)`` group."""
    return torch.sqrt((x * x).sum(1))


def clip_rows(grad: torch.Tensor, norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` on each stack row:
    ``select(norm < max, g, g / norm * max)``."""
    n = norm[:, None]
    return torch.where(n < max_norm, grad, grad / n * max_norm)


def stack_value_norm(n_stack: int, n_objective: int = 1, device=None) -> ValueNormState:
    """A ValueNorm a stack row: ``(S, n)``, ``(S, n)``, ``(S,)``."""
    vn = value_norm_init(n_objective, device=device)
    return ValueNormState(*(x.expand(n_stack, *x.shape).clone() for x in vn))


def vn_stats(vn: ValueNormState) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops/normalize.py``'s debiased ``(mean, var)`` of each stack row of
    a stacked ValueNorm, ``(S, n)`` each."""
    term = torch.clamp(vn.debiasing_term, min=1e-5)[:, None]
    mean = vn.running_mean / term
    return mean, torch.clamp(vn.running_mean_sq / term - mean ** 2, min=1e-2)


def vn_update(vn: ValueNormState, batch: torch.Tensor, beta: float = 0.99999) -> ValueNormState:
    """``value_norm_update`` of each stack row from its rows ``batch (S,
    rows, n)``."""
    return ValueNormState(vn.running_mean * beta + batch.mean(1) * (1.0 - beta),
                          vn.running_mean_sq * beta + (batch ** 2).mean(1) * (1.0 - beta),
                          vn.debiasing_term * beta + (1.0 - beta))


def vn_normalize(vn: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    """``x (S, rows, n)`` normalised by each stack row's statistics."""
    mean, var = vn_stats(vn)
    return (x - mean[:, None]) / torch.sqrt(var)[:, None]


def rows_of(tree, rows: slice):
    """A NamedTuple of stacked tensors cut to stack ``rows`` (copies)."""
    return type(tree)(*(x[rows].clone() for x in tree))


# --------------------------------------------------------------- trainer

@dataclasses.dataclass
class MAPPOTrainState:
    """What the update carries besides the weights (which live in the
    policy): both optimisers, the ValueNorm, the count of updates."""

    actor_opt: AdamState
    critic_opt: AdamState
    value_norm: ValueNormState
    update_step: int = 0


class MAPPOMetrics(NamedTuple):
    value_loss: torch.Tensor
    policy_loss: torch.Tensor
    dist_entropy: torch.Tensor
    actor_grad_norm: torch.Tensor
    critic_grad_norm: torch.Tensor
    ratio: torch.Tensor
    grad_norm: torch.Tensor
    param_norm: torch.Tensor
    update_ratio: torch.Tensor
    nonfinite_grads: torch.Tensor


def batched_permutations(shape, n: int, generator: Optional[torch.Generator],
                         device) -> torch.Tensor:
    """``(*shape, n)`` uniformly random orders of ``n`` rows, one draw for
    all (the order of ``shape`` uniform keys)."""
    return torch.rand((*shape, n), generator=generator, device=device).argsort(-1)


def gather_stack(tree: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Each stack row's rows ``idx (S, mb)`` of every ``(S, n, ...)`` tensor."""
    s = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {k: v[s, idx] for k, v in tree.items()}


def bootstrap_input(collector, rs) -> Bootstrap:
    """The update's bootstrap for a post-collect rollout state
    (``base_runner.py:204-214``; the MAT family reads the rollout state
    itself): the critic's obs (IPPO's decentralised value: the local obs),
    hidden state and mask."""
    return Bootstrap(cent_obs=collector.cent(rs), critic_h=rs.critic_h, mask=rs.mask)


def ac_train_iteration(trainer, collector: ACRolloutCollector, state, rollout_state,
                       generator: Optional[torch.Generator] = None):
    """One collect + update; ``(state, rollout_state, metrics, chunk_stats,
    (collect_s, train_s))``, the wall seconds with the device synchronised
    at each end.  The bootstrap is the post-collect rollout state's
    (IPPO's decentralised value reads the local obs), as JAX's
    ``ac_train_iteration``."""
    device = trainer.policy.device
    t0 = time.perf_counter()
    rollout_state, traj = collector.collect(rollout_state, generator=generator)
    synchronize(device)
    t1 = time.perf_counter()
    state, metrics = trainer.train(state, traj, bootstrap_input(collector, rollout_state),
                                   generator=generator)
    synchronize(device)
    return state, rollout_state, metrics, traj.chunk_stats, (t1 - t0, time.perf_counter() - t1)


class MAPPOTrainer:
    """The update of a policy shared by all agents (``policy.n_stack == 1``),
    or, with ``stacked``, of one policy an agent updated at once (IPPO)."""

    stacked = False

    def __init__(self, policy: ActorCriticPolicy, cfg: MAPPOConfig):
        self.policy = policy
        self.cfg = cfg
        self.n_objective = policy.critic.n_objective

    # ----------------------------------------------------------- state

    def init_state(self) -> MAPPOTrainState:
        p = self.policy
        return MAPPOTrainState(adam_init(p.actor_flat), adam_init(p.critic_flat),
                               stack_value_norm(p.n_stack, self.n_objective, p.device))

    def state_dict(self, state: MAPPOTrainState) -> Dict[str, Any]:
        """The whole training state, as live tensors (a checkpoint copies
        them): both weight groups, both optimisers, the ValueNorm, the
        update count."""
        return {"actor": self.policy.actor_flat, "critic": self.policy.critic_flat,
                "actor_opt": state.actor_opt._asdict(), "critic_opt": state.critic_opt._asdict(),
                "value_norm": state.value_norm._asdict(), "update_step": state.update_step}

    def load_state_dict(self, state: MAPPOTrainState, saved: Dict[str, Any]) -> MAPPOTrainState:
        """Load ``saved`` (a :meth:`state_dict`) into the policy's weights in
        place and into ``state``."""
        dev = self.policy.device
        self.policy.actor_flat.copy_(saved["actor"])
        self.policy.critic_flat.copy_(saved["critic"])
        state.actor_opt = AdamState(**{k: v.to(dev) for k, v in saved["actor_opt"].items()})
        state.critic_opt = AdamState(**{k: v.to(dev) for k, v in saved["critic_opt"].items()})
        state.value_norm = ValueNormState(**{k: v.to(dev) for k, v in saved["value_norm"].items()})
        state.update_step = int(saved["update_step"])
        return state

    def train_iteration(self, collector, state, rollout_state, generator=None):
        return ac_train_iteration(self, collector, state, rollout_state, generator)

    # ---------------------------------------------------------- layouts

    def to_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``(T, E, A, ...)`` -> ``(S, rows, ...)``: one stack row of ``T * E
        * A`` rows in (t, e, a) order (JAX's flat reshape), or, stacked, a
        row an agent of ``T * E`` rows in (t, e) order."""
        T, E, A = x.shape[:3]
        if self.stacked:
            return x.movedim(2, 0).reshape(A, T * E, *x.shape[3:])
        return x.reshape(1, T * E * A, *x.shape[3:])

    def _stack_in(self, x: torch.Tensor) -> torch.Tensor:
        """``(E, A, ...)`` -> the policy's ``(S, N, ...)``."""
        if self.stacked:
            return x.transpose(0, 1)
        return x.reshape(1, x.shape[0] * x.shape[1], *x.shape[2:])

    # ---------------------------------------------------------- targets

    @property
    def _value_norm_on(self) -> bool:
        return self.cfg.use_popart or self.cfg.use_valuenorm

    def _denorm(self, vn: ValueNormState, values: torch.Tensor) -> torch.Tensor:
        """Denormalise ``(T+1, E, A, n)`` values, each agent by its stack row
        (the one row when shared)."""
        if not self._value_norm_on:
            return values
        mean, var = vn_stats(vn)          # (S, n): S = A or 1, broadcast over agents
        return values * torch.sqrt(var) + mean

    def _targets(self, state: MAPPOTrainState, traj: ACTrajectory, boot: Bootstrap):
        """``(advantages, returns)``, each ``(T, E, A, 1)``
        (``_compute_targets``): normalised over all active entries, or
        stacked over each agent's."""
        cfg = self.cfg
        E, A = boot.cent_obs.shape[:2]
        with torch.no_grad():
            next_v = self.policy.get_values(self._stack_in(boot.cent_obs), None, None)
            next_v = (next_v.transpose(0, 1) if self.stacked else next_v.reshape(E, A, -1))
            values_all = self._denorm(state.value_norm,
                                      torch.cat([traj.values, next_v[None]], 0))
            adv, returns = compute_gae(traj.rewards, values_all, traj.masks, cfg.gamma,
                                       cfg.gae_lambda)
            active = traj.active_masks[:-1]
            dims = (0, 1, 3) if self.stacked else (0, 1, 2, 3)
            denom = active.sum(dims, keepdim=True)
            mean = (adv * active).sum(dims, keepdim=True) / denom
            var = (((adv - mean) ** 2) * active).sum(dims, keepdim=True) / denom
            return (adv - mean) / (torch.sqrt(var) + 1e-5), returns

    def _normalize_targets(self, vn: ValueNormState, critic_flat: torch.Tensor,
                           ret_b: torch.Tensor):
        """ValueNorm or PopArt updated on the minibatch's returns ``(S, mb,
        n)``, then the returns normalised; PopArt also rescales the critic
        head in ``critic_flat``, in place (``r_mappo.py:52-89``)."""
        cfg = self.cfg
        if cfg.use_popart:
            with torch.no_grad():
                p = self.policy.critic_params(critic_flat)
                head = {"kernel": p["critic/v_out/kernel"], "bias": p["critic/v_out/bias"]}
                vn, new = vmap(popart_update)(vn, ret_b, head)
                head["kernel"].copy_(new["kernel"])
                head["bias"].copy_(new["bias"])
            return vn, vmap(popart_normalize)(vn, ret_b)
        if cfg.use_valuenorm:
            vn = vn_update(vn, ret_b)
            return vn, vn_normalize(vn, ret_b)
        return vn, ret_b

    # ----------------------------------------------------------- losses

    def _value_loss(self, values, old_values, ret_norm, active) -> torch.Tensor:
        """``(S,)``: the clipped (Huber) value loss of each stack row."""
        cfg = self.cfg
        v_clipped = old_values + torch.clamp(values - old_values, -cfg.clip_param, cfg.clip_param)
        err_c, err_o = ret_norm - v_clipped, ret_norm - values
        if cfg.use_huber_loss:
            vl_c, vl_o = huber_loss(err_c, HUBER_DELTA), huber_loss(err_o, HUBER_DELTA)
        else:
            vl_c, vl_o = 0.5 * err_c ** 2, 0.5 * err_o ** 2
        vl = torch.maximum(vl_o, vl_c) if cfg.use_clipped_value_loss else vl_o
        if cfg.use_value_active_masks:
            return (vl * active).sum((1, 2)) / active.sum((1, 2))
        return vl.mean((1, 2))

    def _policy_loss(self, logp, old_logp, adv, active, factor=None):
        """``(loss (S,), ratio)``; ``factor``: HAPPO's weight on each row's
        clipped surrogate (``happo_trainer.py:128-140``)."""
        cfg = self.cfg
        delta = logp - old_logp
        ratio = torch.exp(delta.sum(-1, keepdim=True)) if cfg.importance_prod else torch.exp(delta)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * adv
        surr = torch.minimum(surr1, surr2)
        if factor is not None:
            surr = factor * surr
        surr = surr.sum(-1, keepdim=True)
        if cfg.use_policy_active_masks:
            return -(surr * active).sum((1, 2)) / active.sum((1, 2)), ratio
        return -surr.mean((1, 2)), ratio

    # ----------------------------------------------------------- update

    def _apply(self, flat: torch.Tensor, grad: torch.Tensor, opt: AdamState, lr: float):
        """Clip, weight decay and Adam on one group, ``flat`` moved in place;
        returns ``(update, opt, raw grad norm (S,))``."""
        cfg = self.cfg
        norm = row_norm(grad)
        if cfg.use_max_grad_norm:
            grad = clip_rows(grad, norm, cfg.max_grad_norm)
        if cfg.weight_decay:
            grad = grad + cfg.weight_decay * flat
        upd, opt = adam_update(grad, opt, lr, OPTI_EPS)
        flat += upd
        return upd, opt, norm

    def _minibatch(self, af, cf, aopt, copt, vn, b):
        """One minibatch step on the leaves ``af``, ``cf`` (updated in
        place); returns ``(aopt, copt, vn, metrics)``, each metric ``(S,)``."""
        cfg = self.cfg
        vn, ret_norm = self._normalize_targets(vn, cf, b["returns"])
        values, logp, ent = self.policy.evaluate_actions(
            b["cent_obs"], b["obs"], None, None, b["actions"], None, b["avail"], b["active"],
            actor_flat=af, critic_flat=cf)
        policy_loss, ratio = self._policy_loss(logp, b["log_probs"], b["adv"], b["active"],
                                               b.get("factor"))
        value_loss = self._value_loss(values, b["values"], ret_norm, b["active"])
        total = policy_loss - ent * cfg.entropy_coef + value_loss * cfg.value_loss_coef
        ga, gc = torch.autograd.grad(total.sum(), [af, cf])
        with torch.no_grad():
            a_up, aopt, a_gn = self._apply(af, ga, aopt, cfg.lr)
            c_up, copt, c_gn = self._apply(cf, gc, copt, cfg.lr)
            gn = torch.sqrt(a_gn * a_gn + c_gn * c_gn)
            pn = torch.sqrt((af * af).sum(1) + (cf * cf).sum(1))
            un = torch.sqrt((a_up * a_up).sum(1) + (c_up * c_up).sum(1))
            metrics = dict(value_loss=value_loss.detach(), policy_loss=policy_loss.detach(),
                           dist_entropy=ent.detach(), actor_grad_norm=a_gn, critic_grad_norm=c_gn,
                           ratio=ratio.detach().mean(tuple(range(1, ratio.dim()))),
                           grad_norm=gn, param_norm=pn, update_ratio=un / (pn + 1e-12),
                           nonfinite_grads=(~torch.isfinite(gn)).float())
        return aopt, copt, vn, metrics

    def _epochs(self, af, cf, aopt, copt, vn, data, perms):
        """The PPO epochs over ``data`` (``(S, n, ...)`` rows) in the row
        orders ``perms (S, n_epochs, n)``; returns ``(aopt, copt, vn,
        metrics)``, each metric ``(S,)`` averaged over the steps, the
        non-finite count summed."""
        n = perms.shape[-1]
        mb = n // self.cfg.num_mini_batch
        steps: List[Dict[str, torch.Tensor]] = []
        for e in range(perms.shape[1]):
            for j in range(self.cfg.num_mini_batch):
                b = gather_stack(data, perms[:, e, j * mb:(j + 1) * mb])
                aopt, copt, vn, m = self._minibatch(af, cf, aopt, copt, vn, b)
                steps.append(m)
        out = {k: torch.stack([m[k] for m in steps]).mean(0) for k in steps[0]}
        out["nonfinite_grads"] = torch.stack([m["nonfinite_grads"] for m in steps]).sum(0)
        return aopt, copt, vn, out

    def _data(self, traj: ACTrajectory, adv, returns) -> Dict[str, torch.Tensor]:
        r = self.to_rows
        return {"cent_obs": r(traj.share_obs), "obs": r(traj.obs),
                "avail": r(traj.available_actions), "actions": r(traj.actions),
                "log_probs": r(traj.log_probs), "values": r(traj.values),
                "active": r(traj.active_masks[:-1]), "adv": r(adv), "returns": r(returns)}

    def draw_permutations(self, n_rows: int, generator) -> torch.Tensor:
        return batched_permutations((self.policy.n_stack, self.cfg.ppo_epoch), n_rows,
                                    generator, self.policy.device)

    def train(self, state: MAPPOTrainState, traj: ACTrajectory, boot: Bootstrap,
              perms: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None
              ) -> Tuple[MAPPOTrainState, MAPPOMetrics]:
        """One update over a chunk, in place on the policy's weights and
        ``state``.  ``perms (S, ppo_epoch, rows)``: each stack row's row
        order an epoch (drawn from ``generator`` when not given).  The
        metrics are averaged over (epoch, minibatch), the non-finite count
        summed; ``(S,)`` each when stacked, else scalars."""
        adv, returns = self._targets(state, traj, boot)
        data = self._data(traj, adv, returns)
        n = data["obs"].shape[1]
        if n < self.cfg.num_mini_batch:
            raise ValueError(f"{n} rows a stack row < num_mini_batch {self.cfg.num_mini_batch}")
        if perms is None:
            perms = self.draw_permutations(n, generator)
        af = self.policy.actor_flat.detach().requires_grad_(True)    # the policy's storage
        cf = self.policy.critic_flat.detach().requires_grad_(True)
        state.actor_opt, state.critic_opt, state.value_norm, m = self._epochs(
            af, cf, state.actor_opt, state.critic_opt, state.value_norm, data, perms)
        state.update_step += 1
        metrics = MAPPOMetrics(**m)
        if not self.stacked:
            metrics = MAPPOMetrics(*(x[0] for x in metrics))
        return state, metrics
