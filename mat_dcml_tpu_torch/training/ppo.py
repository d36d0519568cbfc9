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
  ``max_norm / norm`` only when ``norm >= max_norm``, no epsilon); Adam.

Adam is ``torch.optim.Adam(foreach=True)``: the same update as
``optax.adam`` (``m_hat / (sqrt(v_hat) + eps)``), the multi-tensor
implementation on every device.  The JAX trainer's streaming devices
(``update_stream_chunks``, ``grad_accum_steps``, ``target_stream_chunk``,
``minibatch_layout="contiguous"``, ``update_offload``) give the same values
up to summation order and are not ported: each minibatch is one pass.

Only the recipe's path is ported: the JAX config's loss and target switches
(``RECIPE_SWITCHES``) stay fields, and setting one off raises.

Randomness is an input: ``train`` takes the epochs' row permutations, or
draws them from a generator.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

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

# the switches of the JAX PPOConfig that the recipe keeps on
RECIPE_SWITCHES = ("use_clipped_value_loss", "use_huber_loss", "use_valuenorm",
                   "use_value_active_masks", "use_policy_active_masks", "use_max_grad_norm",
                   "recompute_returns_per_epoch")


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The fields of the JAX ``PPOConfig`` that this update reads; defaults
    follow the DCML recipe (``DCML_MAT_Train.py:193``)."""

    lr: float = 5e-5
    opti_eps: float = 1e-5
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
    use_value_active_masks: bool = True
    use_policy_active_masks: bool = True
    use_max_grad_norm: bool = True
    recompute_returns_per_epoch: bool = True

    def __post_init__(self):
        off = [name for name in RECIPE_SWITCHES if not getattr(self, name)]
        if off:
            raise NotImplementedError(
                f"{', '.join(off)} off: only the recipe's update is ported "
                "(ROADMAP.md queue 1, item 6)")


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


class MATTrainer:
    def __init__(self, policy: TransformerPolicy, cfg: PPOConfig):
        self.policy = policy
        self.cfg = cfg

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return list(self.policy.model.parameters())

    def init_state(self) -> TrainState:
        opt = torch.optim.Adam(self.params, lr=self.cfg.lr, eps=self.cfg.opti_eps, foreach=True)
        return TrainState(optimizer=opt, value_norm=value_norm_init(1, device=self.policy.device))

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
        for epoch in range(cfg.ppo_epoch):
            adv_flat, ret_flat = self._targets(state, traj, rollout_state)
            for rows in minibatch_rows(perms[epoch], cfg.num_mini_batch):
                steps.append(self._apply_minibatch(
                    state, gather_rows(flat, rows), adv_flat[rows], ret_flat[rows]))
        state.update_step += 1
        stacked = [torch.stack(m) for m in zip(*steps)]
        metrics = TrainMetrics(*(m.mean() for m in stacked))
        return state, metrics._replace(nonfinite_grads=stacked[-1].sum())

    def _targets(self, state: TrainState, traj: Trajectory, rollout_state: RolloutState):
        """Bootstrap, GAE and advantage normalisation over active entries
        (``mat_trainer.py:180-197``), flattened E-major."""
        cfg = self.cfg
        T, E = traj.rewards.shape[:2]
        with torch.no_grad():
            next_values = self.policy.get_values(rollout_state.share_obs, rollout_state.obs)
            values_all = value_norm_denormalize(
                state.value_norm, torch.cat([traj.values, next_values[None]], dim=0))
            adv, returns = compute_gae(traj.rewards, values_all, traj.masks, cfg.gamma, cfg.gae_lambda)
            active = traj.active_masks[:-1]
            axes = tuple(range(adv.dim() - 1))
            denom = active.sum()
            mean = (adv * active).sum(axes) / denom
            var = (((adv - mean) ** 2) * active).sum(axes) / denom
            adv_norm = (adv - mean) / (torch.sqrt(var) + 1e-5)
        flat = lambda x: x.transpose(0, 1).reshape(T * E, *x.shape[2:])   # noqa: E731
        return flat(adv_norm), flat(returns)

    def _apply_minibatch(self, state: TrainState, batch, adv_b, ret_b):
        cfg = self.cfg
        state.value_norm = value_norm_update(state.value_norm, ret_b.reshape(-1, ret_b.shape[-1]))
        ret_target = value_norm_normalize(state.value_norm, ret_b)
        active = batch["active_masks"]
        active_sum = active.sum()

        values, logp, ent = self.policy.evaluate_actions(
            batch["share_obs"], batch["obs"], batch["actions"], batch["available_actions"])
        ratio = torch.exp(logp - batch["log_probs"])
        surr1 = ratio * adv_b
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * adv_b
        surr = torch.minimum(surr1, surr2).sum(-1, keepdim=True)
        policy_loss = -(surr * active).sum() / active_sum
        entropy = (ent * active).sum() / active_sum

        v_old = batch["values"]
        v_clipped = v_old + torch.clamp(values - v_old, -cfg.clip_param, cfg.clip_param)
        vl = torch.maximum(huber_loss(ret_target - values, cfg.huber_delta),
                           huber_loss(ret_target - v_clipped, cfg.huber_delta))
        value_loss = (vl * active).sum() / active_sum
        loss = policy_loss - entropy * cfg.entropy_coef + value_loss * cfg.value_loss_coef

        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss.backward()
        params = self.params
        grads = [p.grad for p in params]
        with torch.no_grad():
            gnorm = global_norm(grads)
            # optax.clip_by_global_norm: select(norm < max, g, g / norm * max)
            keep = gnorm < cfg.max_grad_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / gnorm * cfg.max_grad_norm))
            before = [p.detach().clone() for p in params]
            opt.step()
            pnorm = global_norm(params)
            unorm = global_norm(torch._foreach_sub([p.detach() for p in params], before))
        return (value_loss.detach(), policy_loss.detach(), entropy.detach(), gnorm,
                (ratio.sum() / ratio.numel()).detach(), pnorm, unorm / (pnorm + 1e-12),
                (~torch.isfinite(gnorm)).float())
