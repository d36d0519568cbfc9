"""The MAT PPO update.

Port of ``mat_dcml_tpu/training/ppo.py::MATTrainer`` (``mat_trainer.py``).
The JAX update is one jitted ``lax.scan`` over epochs and minibatches; here
it is two Python loops over the same arithmetic.  Kept:

- the E-major flatten of the ``(T, E)`` rows;
- the per-epoch target recompute (bootstrap, GAE, advantage normalisation
  over active entries) (``mat_trainer.py:178-198``);
- the clipped surrogate summed over the action dim;
- the clipped Huber value loss, ValueNorm updated on the full minibatch
  before normalising the targets (``mat_trainer.py:68-71``);
- entropy; global-norm clipping with optax's rule (scale by
  ``max_norm / norm`` only when ``norm >= max_norm``, no epsilon); Adam;
- every switch of the JAX config, each with the JAX trainer's arithmetic
  when set off: the clipped value loss (else the plain one), the Huber loss
  (else ``0.5 e^2``), ValueNorm (PopArt, ``use_popart``, takes the same
  ValueNorm path in the MAT trainer), the value and policy active masks
  (else plain means), the grad-norm clip (the norm is still reported) and
  the per-epoch recompute of returns (else one target computation before
  the first epoch);
- MO-MAT (``n_objective > 1``): a ValueNorm and GAE per objective channel,
  the advantages scalarised with ``objective_weights`` (normalised to the
  simplex; equal weights when empty), or with DMO-MAT's per-step
  preference weights where the trajectory carries them; scalarised before
  the advantage normalisation (``mo_combined_norm``) or after a
  normalisation per channel;
- ``use_linear_lr_decay``: optax's ``linear_schedule(lr, 0,
  total_updates)``, which counts Adam steps (one a minibatch), so the lr
  reaches 0 after ``total_updates`` minibatch steps, not updates;
- ``weight_decay``: L2 added to the clipped gradient before Adam (optax's
  ``add_decayed_weights`` between the clip and Adam), not AdamW; the
  reported ``grad_norm`` is the norm before both.

Adam is ``torch.optim.Adam(foreach=True)``: the same update as
``optax.adam`` (``m_hat / (sqrt(v_hat) + eps)``), the multi-tensor
implementation on every device; its ``weight_decay`` adds ``wd * p`` to the
gradient it is given, as optax's chain does. The JAX trainer's streaming
devices (``update_stream_chunks``, ``grad_accum_steps``,
``target_stream_chunk``, ``minibatch_layout="contiguous"``,
``update_offload``) give the same values up to summation order and are not
ported: each minibatch is one pass.

Randomness is an input: ``train`` takes the epochs' row permutations, or
draws them from a generator.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mat_dcml_tpu_torch.device import synchronize
from mat_dcml_tpu_torch.models.policy import TransformerPolicy
from mat_dcml_tpu_torch.ops.distributions import huber_loss
from mat_dcml_tpu_torch.ops.gae import compute_gae
from mat_dcml_tpu_torch.ops.normalize import (
    ValueNormState,
    value_norm_denormalize,
    value_norm_init,
    value_norm_normalize,
    value_norm_update,
)
from mat_dcml_tpu_torch.training.minibatch import gather_rows, minibatch_rows, permutations
from mat_dcml_tpu_torch.training.rollout import RolloutCollector, RolloutState, Trajectory

# the loss and target switches of the JAX PPOConfig that the recipe keeps on
RECIPE_SWITCHES = ("use_clipped_value_loss", "use_huber_loss", "use_valuenorm",
                   "use_value_active_masks", "use_policy_active_masks", "use_max_grad_norm",
                   "recompute_returns_per_epoch")


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The fields of the JAX ``PPOConfig`` that this update reads; defaults
    follow the DCML recipe (``DCML_MAT_Train.py:193``)."""

    lr: float = 5e-5
    opti_eps: float = 1e-5
    weight_decay: float = 0.0
    clip_param: float = 0.2
    ppo_epoch: int = 15
    num_mini_batch: int = 4
    entropy_coef: float = 0.01
    value_loss_coef: float = 1.0
    max_grad_norm: float = 10.0
    gamma: float = 0.99
    gae_lambda: float = 0.95
    huber_delta: float = 10.0
    use_clipped_value_loss: bool = True
    use_huber_loss: bool = True
    use_valuenorm: bool = True
    use_popart: bool = False
    use_value_active_masks: bool = True
    use_policy_active_masks: bool = True
    use_max_grad_norm: bool = True
    use_linear_lr_decay: bool = False
    recompute_returns_per_epoch: bool = True
    # MO-MAT: comma-separated scalarisation weights ("99,1"), normalised to
    # the simplex; empty: equal weights; a count other than n_objective raises
    objective_weights: str = ""
    # MO-MAT: scalarise the raw per-channel advantages, then normalise once
    # (True), or normalise each channel, then scalarise (False)
    mo_combined_norm: bool = True

    @property
    def value_norm_on(self) -> bool:
        """The MAT trainer's ValueNorm path: ``use_valuenorm`` or
        ``use_popart`` (``ppo.py:299``)."""
        return self.use_valuenorm or self.use_popart


@dataclasses.dataclass
class TrainState:
    """What the update carries besides the weights, which live in the
    policy's model: Adam's moments and step, the ValueNorm, the count of
    updates."""

    optimizer: torch.optim.Adam
    value_norm: ValueNormState
    update_step: int = 0


class TrainMetrics(NamedTuple):
    value_loss: torch.Tensor
    policy_loss: torch.Tensor
    dist_entropy: torch.Tensor
    grad_norm: torch.Tensor
    ratio: torch.Tensor
    param_norm: torch.Tensor
    update_ratio: torch.Tensor
    nonfinite_grads: torch.Tensor


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the 2-norm of all entries together."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def parse_objective_weights(spec: str, n_objective: int) -> List[float]:
    """``PPOConfig.objective_weights`` on the simplex (only their ratios
    matter); empty: equal weights.  A count other than ``n_objective``
    raises ``ValueError`` (``ppo.py:183-198``)."""
    if not spec:
        return [1.0 / n_objective] * n_objective
    w = np.asarray([float(x) for x in spec.split(",")], np.float32)
    if len(w) != n_objective:
        raise ValueError(f"objective_weights has {len(w)} entries for {n_objective} objectives")
    return (w / w.sum()).tolist()


class MATTrainer:
    """``total_updates``: the lr schedule's length in Adam steps (the JAX
    runner passes ``run.episodes``)."""

    def __init__(self, policy: TransformerPolicy, cfg: PPOConfig, total_updates: int = 1):
        self.policy = policy
        self.cfg = cfg
        self.n_objective = getattr(policy.cfg, "n_objective", 1)
        self.objective_weights = torch.tensor(
            parse_objective_weights(cfg.objective_weights, self.n_objective),
            device=policy.device)
        self.total_updates = max(int(total_updates), 1)

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return list(self.policy.model.parameters())

    def init_state(self) -> TrainState:
        opt = torch.optim.Adam(self.params, lr=self.cfg.lr, eps=self.cfg.opti_eps,
                               weight_decay=self.cfg.weight_decay, foreach=True)
        return TrainState(optimizer=opt, value_norm=value_norm_init(self.n_objective,
                                                                    device=self.policy.device))

    def adam_steps(self, state: TrainState) -> int:
        """Adam steps taken so far (optax's schedule count): the step count
        Adam keeps with every parameter, on the host."""
        st = state.optimizer.state.get(self.params[0], {})
        return int(st["step"]) if "step" in st else 0

    def lr_at(self, count: int) -> float:
        """The lr of Adam step ``count`` (from 0): under
        ``use_linear_lr_decay`` ``optax.linear_schedule(lr, 0,
        total_updates)(count)`` in f32, as optax computes it, ``lr * (1 -
        min(count, total) / total)``."""
        cfg = self.cfg
        if not cfg.use_linear_lr_decay:
            return cfg.lr
        total = np.float32(self.total_updates)
        frac = np.float32(1.0) - np.float32(min(count, self.total_updates)) / total
        return float(np.float32(cfg.lr) * frac)

    def state_dict(self, state: TrainState) -> Dict[str, Any]:
        """The whole training state, as live tensors (a checkpoint copies
        them): the model's ``state_dict``, Adam's (moments and step counts),
        the ValueNorm's tensors and the update count."""
        return {
            "model": self.policy.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "value_norm": state.value_norm._asdict(),
            "update_step": state.update_step,
        }

    def load_state_dict(self, state: TrainState, saved: Dict[str, Any]) -> TrainState:
        """Load ``saved`` (a :meth:`state_dict`) into the live model and
        ``state``'s optimizer, in place, so Adam keeps the model's own
        parameters.  Adam's step counts go to the CPU, where a fresh
        (non-capturable) Adam keeps them."""
        self.policy.model.load_state_dict(saved["model"])
        opt = saved["optimizer"]
        opt = {**opt, "state": {k: {n: v.cpu() if n == "step" else v for n, v in st.items()}
                                for k, st in opt["state"].items()}}
        state.optimizer.load_state_dict(opt)
        dev = self.policy.device
        state.value_norm = ValueNormState(**{k: v.to(dev) for k, v in saved["value_norm"].items()})
        state.update_step = int(saved["update_step"])
        return state

    def draw_permutations(self, n_rows: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        return permutations(self.cfg.ppo_epoch, n_rows, generator, self.policy.device)

    def train_iteration(self, collector: RolloutCollector, state: TrainState,
                        rollout_state: RolloutState, generator: Optional[torch.Generator] = None):
        """One collect + update; returns ``(state, rollout_state, metrics,
        chunk_stats)`` as the JAX trainer does, then ``(collect_s, train_s)``:
        the wall seconds of each, the device synchronised at each end."""
        t0 = time.perf_counter()
        rollout_state, traj = collector.collect(rollout_state, generator=generator)
        synchronize(self.policy.device)
        t1 = time.perf_counter()
        state, metrics = self.train(state, traj, rollout_state, generator=generator)
        synchronize(self.policy.device)
        seconds = (t1 - t0, time.perf_counter() - t1)
        return state, rollout_state, metrics, traj.chunk_stats, seconds

    # ------------------------------------------------------------------ train

    def train(self, state: TrainState, traj: Trajectory, rollout_state: RolloutState,
              perms: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> Tuple[TrainState, TrainMetrics]:
        """One PPO update over a chunk, in place on the policy's weights and
        ``state``.  ``perms (ppo_epoch, T * E)``: the row order of each epoch
        (drawn from ``generator`` when not given).  Returns the metrics
        averaged over (epoch, minibatch), the non-finite count summed."""
        cfg = self.cfg
        T, E = traj.rewards.shape[:2]
        n_rows = T * E
        if n_rows < cfg.num_mini_batch:
            raise ValueError(f"PPO needs episode_length * n_rollout_threads ({n_rows}) >= "
                             f"num_mini_batch ({cfg.num_mini_batch})")
        if perms is None:
            perms = self.draw_permutations(n_rows, generator)

        def flatten_rows(x):   # (T, E, ...) -> (E * T, ...), E-major
            return x.transpose(0, 1).reshape(n_rows, *x.shape[2:])

        flat = {k: flatten_rows(getattr(traj, k)) for k in (
            "share_obs", "obs", "available_actions", "actions", "log_probs", "values")}
        flat["active_masks"] = flatten_rows(traj.active_masks[:-1])

        steps = []
        fixed = None if cfg.recompute_returns_per_epoch else self._targets(
            state, traj, rollout_state)
        for epoch in range(cfg.ppo_epoch):
            adv_flat, ret_flat = fixed if fixed is not None else self._targets(
                state, traj, rollout_state)
            for rows in minibatch_rows(perms[epoch], cfg.num_mini_batch):
                steps.append(self._apply_minibatch(
                    state, gather_rows(flat, rows), adv_flat[rows], ret_flat[rows]))
        state.update_step += 1
        stacked = [torch.stack(m) for m in zip(*steps)]
        metrics = TrainMetrics(*(m.mean() for m in stacked))
        return state, metrics._replace(nonfinite_grads=stacked[-1].sum())

    def _targets(self, state: TrainState, traj: Trajectory, rollout_state: RolloutState):
        """Bootstrap, GAE and advantage normalisation over active entries
        (``mat_trainer.py:180-197``), flattened E-major; with several
        objectives the advantages are scalarised (``ppo.py:308-333``)."""
        cfg = self.cfg
        T, E = traj.rewards.shape[:2]
        with torch.no_grad():
            next_values = self.policy.get_values(rollout_state.share_obs, rollout_state.obs)
            values_all = torch.cat([traj.values, next_values[None]], dim=0)
            if cfg.value_norm_on:
                values_all = value_norm_denormalize(state.value_norm, values_all)
            adv, returns = compute_gae(traj.rewards, values_all, traj.masks, cfg.gamma, cfg.gae_lambda)
            w = None
            if self.n_objective > 1:
                # DMO-MAT's per-step weights (broadcast over agents) when
                # collected, else the static ones
                w = (traj.objective_coefficients[:, :, None, :]
                     if traj.objective_coefficients is not None else self.objective_weights)
                if cfg.mo_combined_norm:
                    adv = (adv * w).sum(-1, keepdim=True)
            active = traj.active_masks[:-1]
            axes = tuple(range(adv.dim() - 1))
            denom = active.sum()
            mean = (adv * active).sum(axes) / denom
            var = (((adv - mean) ** 2) * active).sum(axes) / denom
            adv_norm = (adv - mean) / (torch.sqrt(var) + 1e-5)
            if w is not None and not cfg.mo_combined_norm:
                adv_norm = (adv_norm * w).sum(-1, keepdim=True)
        flat = lambda x: x.transpose(0, 1).reshape(T * E, *x.shape[2:])   # noqa: E731
        return flat(adv_norm), flat(returns)

    def _apply_minibatch(self, state: TrainState, batch, adv_b, ret_b):
        cfg = self.cfg
        ret_target = ret_b
        if cfg.value_norm_on:
            state.value_norm = value_norm_update(state.value_norm,
                                                 ret_b.reshape(-1, ret_b.shape[-1]))
            ret_target = value_norm_normalize(state.value_norm, ret_b)
        active = batch["active_masks"]
        active_sum = active.sum()

        values, logp, ent = self.policy.evaluate_actions(
            batch["share_obs"], batch["obs"], batch["actions"], batch["available_actions"])
        ratio = torch.exp(logp - batch["log_probs"])
        surr1 = ratio * adv_b
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * adv_b
        surr = torch.minimum(surr1, surr2).sum(-1, keepdim=True)
        if cfg.use_policy_active_masks:
            policy_loss = -(surr * active).sum() / active_sum
            entropy = (ent * active).sum() / active_sum
        else:
            policy_loss = -surr.mean()
            entropy = ent.mean()

        def value_err(e):
            return huber_loss(e, cfg.huber_delta) if cfg.use_huber_loss else 0.5 * e * e

        v_old = batch["values"]
        vl = value_err(ret_target - values)
        if cfg.use_clipped_value_loss:
            v_clipped = v_old + torch.clamp(values - v_old, -cfg.clip_param, cfg.clip_param)
            vl = torch.maximum(vl, value_err(ret_target - v_clipped))
        if cfg.use_value_active_masks:
            value_loss = (vl * active).sum() / active_sum
        else:
            value_loss = vl.mean()
        loss = policy_loss - entropy * cfg.entropy_coef + value_loss * cfg.value_loss_coef

        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss.backward()
        params = self.params
        grads = [p.grad for p in params]
        with torch.no_grad():
            gnorm = global_norm(grads)
            if cfg.use_max_grad_norm:
                # optax.clip_by_global_norm: select(norm < max, g, g / norm * max)
                keep = gnorm < cfg.max_grad_norm
                for g in grads:
                    g.copy_(torch.where(keep, g, g / gnorm * cfg.max_grad_norm))
            before = [p.detach().clone() for p in params]
            if cfg.use_linear_lr_decay:
                for group in opt.param_groups:
                    group["lr"] = self.lr_at(self.adam_steps(state))
            opt.step()
            pnorm = global_norm(params)
            unorm = global_norm(torch._foreach_sub([p.detach() for p in params], before))
        return (value_loss.detach(), policy_loss.detach(), entropy.detach(), gnorm,
                (ratio.sum() / ratio.numel()).detach(), pnorm, unorm / (pnorm + 1e-12),
                (~torch.isfinite(gnorm)).float())
