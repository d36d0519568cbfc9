"""HAPPO and HATRPO: the heterogeneous-agent trust-region family.

Port of ``mat_dcml_tpu/training/happo.py`` (``happo_trainer.py``,
``hatrpo_trainer.py`` and the sequential loop of ``base_runner.py:329-417``),
feed-forward:

    for agent in randperm(A):
        old_logp  = the agent's log-probs of its rollout actions
        train the agent (PPO surrogate x factor, or a TRPO step)
        new_logp  = the same with the updated weights
        factor   *= exp(sum(new_logp - old_logp))             (:247-248)

so each agent sees the policy shift of those updated before it.  The
policy holds one stack row an agent; each agent's targets come from its own
critic and ValueNorm, computed once for all agents before the loop.  The
agent in turn is cut out of the stack (its weights, its two Adam states, its
ValueNorm), trained alone as a one-row MAPPO update with ``factor`` on its
clipped surrogate (``:285-358``), and only its row is written back
(``:253``): the other agents' weights and Adam moments do not move.

HATRPO (``:359-``) keeps the critic's Adam step and replaces the actor's
with a natural-gradient step: the conjugate gradient solves ``F x = g`` for
the Fisher-vector products of the self-KL (the k3 estimator
``exp(d) - 1 - d`` on the taken actions, Hessian-vector products by double
backward, damping 0.1, 10 iterations, ``:482-499``); the step is scaled to
the ``KL_THRESHOLD`` ball, then a line search over ``0.5 ** k``, ``k < 10``,
takes the first fraction whose KL is below the threshold and whose
improvement is positive and above ``ACCEPT_RATIO`` of the expected one
(``:507-``); as in JAX, all ten fractions are evaluated and the first
accepted is selected.  One pass over the minibatches an agent, no epochs
(``hatrpo_trainer.py:351-412``).

On the card each agent's turn replays as one CUDA graph
(``training/graphs.py``): the turn is shape-static and free of host
synchronisation (hence the line search without an early exit).

Randomness is an input: ``train`` takes the agent order and each turn's
minibatch permutations (HAPPO: ``ppo_epoch`` an agent, HATRPO: one), or
draws them from a generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from mat_dcml_tpu_torch.models.actor_critic import ActorCriticPolicy
from mat_dcml_tpu_torch.training.ac_rollout import ACTrajectory, StackedRolloutCollector
from mat_dcml_tpu_torch.training.graphs import CapturedCall
from mat_dcml_tpu_torch.training.mappo import (
    Bootstrap,
    MAPPOConfig,
    MAPPOTrainer,
    MAPPOTrainState,
    batched_permutations,
    gather_stack,
    rows_of,
)


class HAPPORolloutCollector(StackedRolloutCollector):
    """One policy an agent, the critic on ``share_obs`` (``happo_policy.py``)."""

    def __init__(self, env, policy: ActorCriticPolicy, episode_length: int):
        super().__init__(env, policy, episode_length, use_local_value=False)


# HATRPO's settings: config.py's trpo group defaults, which no DCML run changes
KL_THRESHOLD = 0.01
LS_STEPS = 10            # line-search fractions 0.5 ** k, k < LS_STEPS
ACCEPT_RATIO = 0.5
CG_ITERS = 10
CG_DAMPING = 0.1


class HAPPOMetrics(NamedTuple):
    value_loss: torch.Tensor
    policy_loss: torch.Tensor
    dist_entropy: torch.Tensor
    ratio: torch.Tensor
    factor_mean: torch.Tensor
    kl: torch.Tensor              # HATRPO; 0 for HAPPO
    accepted: torch.Tensor        # HATRPO's line-search acceptance rate; 1 for HAPPO
    grad_norm: torch.Tensor
    param_norm: torch.Tensor
    update_ratio: torch.Tensor
    nonfinite_grads: torch.Tensor


class HAPPOTrainer(MAPPOTrainer):
    """The sequential-factor PPO over one policy an agent."""

    stacked = True

    def __init__(self, policy: ActorCriticPolicy, cfg: MAPPOConfig, n_agents: int):
        if policy.n_stack != n_agents:
            raise ValueError(f"{type(self).__name__} needs one policy an agent: n_stack "
                             f"{policy.n_stack}, {n_agents} agents")
        # the importance weight is the product over action dims (happo_trainer.py:125)
        super().__init__(policy, dataclasses.replace(cfg, importance_prod=True))
        self.n_agents = n_agents
        self._graphs: Dict[tuple, CapturedCall] = {}   # a captured turn by shapes

    @property
    def epochs_per_agent(self) -> int:
        return self.cfg.ppo_epoch

    def draw_order(self, generator) -> torch.Tensor:
        return torch.randperm(self.n_agents, generator=generator, device=self.policy.device)

    def draw_permutations(self, n_rows: int, generator) -> torch.Tensor:
        """``(A, epochs_per_agent, n_rows)``: the row orders of the agent
        trained at each turn."""
        return batched_permutations((self.n_agents, self.epochs_per_agent), n_rows, generator,
                                    self.policy.device)

    def _eval_logp(self, af: torch.Tensor, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            logp, _ = self.policy.actor_evaluate(data["obs"], None, data["actions"], None,
                                                 data["avail"], data["active"], actor_flat=af)
        return logp

    def train(self, state: MAPPOTrainState, traj: ACTrajectory, boot: Bootstrap,
              order: Optional[torch.Tensor] = None, perms: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> Tuple[MAPPOTrainState, HAPPOMetrics]:
        """One update over a chunk, in place on the policy's weights and
        ``state``.  ``order (A,)``: the agents in the order they train;
        ``perms (A, epochs, T * E)``: the row orders at each turn (both drawn
        from ``generator`` when not given, the order first).  The metrics are
        averaged over each agent's steps, then over the agents (the
        non-finite counts summed); ``factor_mean`` is the mean factor after
        each agent's update."""
        T, E = traj.rewards.shape[:2]
        data_all = self.prepare(state, traj, boot)
        if order is None:
            order = self.draw_order(generator)
        if perms is None:
            perms = self.draw_permutations(T * E, generator)
        factor = torch.ones(1, T * E, 1, device=self.policy.device)
        turns: List[Dict[str, torch.Tensor]] = []
        for j, i in enumerate(order.tolist()):
            factor, m = self.turn(state, data_all, i, factor, perms[j:j + 1])
            turns.append(m)
        state.update_step += 1
        out = {k: torch.cat([m[k] for m in turns]).mean() for k in HAPPOMetrics._fields}
        out["nonfinite_grads"] = torch.cat([m["nonfinite_grads"] for m in turns]).sum()
        return state, HAPPOMetrics(**out)

    def prepare(self, state: MAPPOTrainState, traj: ACTrajectory,
                boot: Bootstrap) -> Dict[str, torch.Tensor]:
        """Each agent's rows ``(A, T * E, ...)`` with its own targets, from
        its own critic and ValueNorm (``base_runner.py:336-344``)."""
        adv, returns = self._targets(state, traj, boot)
        return self._data(traj, adv, returns)

    def turn(self, state: MAPPOTrainState, data_all: Dict[str, torch.Tensor], i: int,
             factor: torch.Tensor, perms: torch.Tensor):
        """Agent ``i``'s turn: its row cut out of the stack (weights, both
        Adam states, ValueNorm), trained on its rows ``data_all[k][i]`` with
        ``factor (1, T * E, 1)`` in the row orders ``perms (1, epochs, T *
        E)``, written back in place.  Returns ``(factor after the turn, the
        turn's metrics)``."""
        p = self.policy
        row = slice(i, i + 1)
        data = {k: v[row] for k, v in data_all.items()}
        data["factor"] = factor
        af = p.actor_flat[row].detach().clone().requires_grad_(True)
        cf = p.critic_flat[row].detach().clone().requires_grad_(True)
        args = (af, cf, rows_of(state.actor_opt, row), rows_of(state.critic_opt, row),
                rows_of(state.value_norm, row), data, perms)
        if p.device.type == "cuda":     # one graph replay a turn (training/graphs.py)
            key = (self.cfg, perms.shape, tuple((k, v.shape) for k, v in data.items()))
            if key not in self._graphs:
                self._graphs[key] = CapturedCall(self._turn_body)
            out = self._graphs[key](*args)
        else:
            out = self._turn_body(*args)
        af, cf, aopt, copt, vn, factor, m = out
        with torch.no_grad():
            p.actor_flat[row] = af
            p.critic_flat[row] = cf
            for full, part in ((state.actor_opt, aopt), (state.critic_opt, copt),
                               (state.value_norm, vn)):
                for x, y in zip(full, part):
                    x[row] = y
        return factor.clone(), {k: v.clone() for k, v in m.items()}

    def _turn_body(self, af, cf, aopt, copt, vn, data, perms):
        """A turn on one agent's cut-out row (``af``, ``cf``: leaves, moved in
        place): its old log-probs, its update, its new log-probs, the factor
        after it.  Shape-static and free of host synchronisation, so that
        it replays as one CUDA graph."""
        old_logp = self._eval_logp(af, data)
        aopt, copt, vn, m = self._update_agent(af, cf, aopt, copt, vn, data, perms)
        new_logp = self._eval_logp(af, data)
        factor = data["factor"] * torch.exp((new_logp - old_logp).sum(-1, keepdim=True))
        m["factor_mean"] = factor.mean()[None]
        return af, cf, aopt, copt, vn, factor, m

    def _update_agent(self, af, cf, aopt, copt, vn, data, perms):
        """The PPO epochs of one agent (a one-row stack) with the factor on
        its surrogate (``happo_trainer.py:96-160``)."""
        aopt, copt, vn, m = self._epochs(af, cf, aopt, copt, vn, data, perms)
        one = torch.ones_like(m["ratio"])
        m.update(kl=0 * one, accepted=one, factor_mean=0 * one)
        return aopt, copt, vn, m


class HATRPOTrainer(HAPPOTrainer):
    """The HAPPO outer loop with the actor's PPO step replaced by the
    KL-constrained natural-gradient step (module docstring)."""

    @property
    def epochs_per_agent(self) -> int:
        return 1

    def _terms(self, flat: torch.Tensor, old_logp: torch.Tensor, b):
        """``(surrogate, entropy, KL)`` of the actor weights ``flat``: the
        factor-weighted importance ratio times the advantage, the mean over
        active rows; the mean k3 estimate of KL(old || new) on the taken
        actions (``kl_approx``, ``hatrpo_trainer.py:125-128``)."""
        logp, ent = self.policy.actor_evaluate(b["obs"], None, b["actions"], None, b["avail"],
                                               b["active"], actor_flat=flat)
        ratio = torch.exp((logp - b["log_probs"]).sum(-1, keepdim=True))
        surr = (ratio * b["factor"] * b["adv"]).sum(-1, keepdim=True)
        if self.cfg.use_policy_active_masks:
            surr = (surr * b["active"]).sum() / b["active"].sum()
        else:
            surr = surr.mean()
        d = logp - old_logp
        return surr, ent[0], (torch.exp(d) - 1.0 - d).sum(-1, keepdim=True).mean()

    def _trpo_step(self, af, cf, aopt, copt, vn, b):
        cfg = self.cfg
        vn, ret_norm = self._normalize_targets(vn, cf, b["returns"])

        # the critic: Adam on the clipped Huber value loss (hatrpo_trainer.py:215-227)
        values = self.policy.get_values(b["cent_obs"], None, None, critic_flat=cf)
        vl = self._value_loss(values, b["values"], ret_norm, b["active"]) * cfg.value_loss_coef
        (gc,) = torch.autograd.grad(vl.sum(), [cf])
        with torch.no_grad():
            c_up, copt, c_gn = self._apply(cf, gc, copt, cfg.lr)

        # the actor: the natural gradient of the factor-weighted surrogate
        with torch.no_grad():
            old_logp, _ = self.policy.actor_evaluate(b["obs"], None, b["actions"], None,
                                                     b["avail"], b["active"], actor_flat=af)
        loss0, ent0, kl0 = self._terms(af, old_logp, b)
        (g,) = torch.autograd.grad(loss0, [af], retain_graph=True)
        g = g.detach()
        (kl_grad,) = torch.autograd.grad(kl0, [af], create_graph=True)

        def fvp(v):
            (hvp,) = torch.autograd.grad((kl_grad * v).sum(), [af], retain_graph=True)
            return hvp + CG_DAMPING * v

        x = torch.zeros_like(g)
        r, d = g.clone(), g.clone()
        rdotr = (g * g).sum()
        for _ in range(CG_ITERS):
            Ap = fvp(d)
            alpha = rdotr / torch.clamp((d * Ap).sum(), min=1e-10)
            x = x + alpha * d
            r = r - alpha * Ap
            new_rdotr = (r * r).sum()
            beta = new_rdotr / torch.clamp(rdotr, min=1e-10)
            d = r + beta * d
            rdotr = new_rdotr
        shs = 0.5 * (x * fvp(x)).sum()
        step_size = 1.0 / torch.sqrt(torch.clamp(shs / KL_THRESHOLD, min=1e-10))
        full_step = step_size * x
        expected_improve = (g * full_step).sum()

        # the line search over 0.5 ** k: every fraction evaluated, the first
        # accepted taken (JAX's vmapped candidates; no host synchronisation)
        with torch.no_grad():
            flat0 = af.detach().clone()
            flats, oks, kls = [], [], []
            for k in range(LS_STEPS):
                frac = 0.5 ** k
                new_flat = flat0 + frac * full_step
                new_loss, _, kl = self._terms(new_flat, old_logp, b)
                improve = new_loss - loss0
                expected = expected_improve * frac
                denom = torch.where(expected.abs() < 1e-10, 1e-10, expected)
                oks.append((kl < KL_THRESHOLD) & (improve / denom > ACCEPT_RATIO)
                           & (improve > 0))
                flats.append(new_flat)
                kls.append(kl)
            oks = torch.stack(oks)
            first = torch.argmax(oks.float()).view(1)      # the first True
            accepted = oks.any()
            af.copy_(torch.where(accepted, torch.stack(flats).index_select(0, first)[0], flat0))
            kl_sel = torch.where(accepted, torch.stack(kls).index_select(0, first)[0], 0.0)
            accepted = accepted.float()
            gn = torch.sqrt(c_gn * c_gn + (g * g).sum())
            pn = torch.sqrt((af * af).sum(1) + (cf * cf).sum(1))
            step = af - flat0
            un = torch.sqrt((c_up * c_up).sum(1) + (step * step).sum(1))
            metrics = dict(value_loss=vl.detach(), policy_loss=-loss0.detach()[None],
                           dist_entropy=ent0.detach()[None], ratio=torch.ones_like(pn),
                           factor_mean=torch.zeros_like(pn), kl=kl_sel[None],
                           accepted=accepted[None], grad_norm=gn, param_norm=pn,
                           update_ratio=un / (pn + 1e-12),
                           nonfinite_grads=(~torch.isfinite(gn)).float())
        return aopt, copt, vn, metrics

    def _update_agent(self, af, cf, aopt, copt, vn, data, perms):
        """One pass over the minibatches in the order ``perms (1, 1, n)``."""
        n = perms.shape[-1]
        mb = n // self.cfg.num_mini_batch
        steps = []
        for j in range(self.cfg.num_mini_batch):
            b = gather_stack(data, perms[:, 0, j * mb:(j + 1) * mb])
            aopt, copt, vn, m = self._trpo_step(af, cf, aopt, copt, vn, b)
            steps.append(m)
        out = {k: torch.stack([m[k] for m in steps]).mean(0) for k in steps[0]}
        out["nonfinite_grads"] = torch.stack([m["nonfinite_grads"] for m in steps]).sum(0)
        return aopt, copt, vn, out
