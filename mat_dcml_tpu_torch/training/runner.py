"""The classic collect-then-train loop, and the DCML runner.

Port of ``mat_dcml_tpu/training/runner.py`` and of the episodic loop of
``base_runner.py`` (``_train_loop_episodic``, ``:702``): each episode
collects one chunk, runs one PPO update, and every ``log_interval`` episodes
(and on the first episode of a process) writes one record to
``<run_dir>/metrics.jsonl`` with the JAX record's basic keys.  Kept from the
JAX runner:

- checkpoints under ``<run_dir>/models`` (``training/checkpoint.py``) every
  ``save_interval`` episodes and on the last, unless the trainer's state is
  empty, as the ``random`` baseline's is (``base_runner.py:928-937``); saves
  are asynchronous and the loop's exit waits for the last one;
- resume in :meth:`EpisodicRunner.setup` (``base_runner.py:484-560``), from
  ``model_dir``, or from the run's own ``models/`` when ``resume="auto"``:
  the newest valid regular step S resumes at S + 1 with a fresh rollout
  state, the emergency carry (``training/resilience.py::pack_carry``, step E
  of ``models/emergency``) at E with the stopped run's rollout state and
  generator, and wins when it is no older than the newest regular step;
- graceful stop: SIGTERM / SIGINT make the loop save the emergency carry
  at the next episode boundary and exit 75;
- evaluation every ``eval_interval`` episodes under ``use_eval``
  (``base_runner.py:941-947``), its records written to ``metrics.jsonl``;
  :meth:`DCMLRunner.evaluate` is ``dcml_runner.py``'s deterministic protocol.

``DCMLRunner`` trains the MAT family on the DCML env as the JAX runner
builds it (``MAT_DCML_ALGOS``: ``mat``; ``mat_dec``, MAT-Dec with one MLP
actor for all agents; ``momat``, MO-MAT's two-objective critic on the
(completion time, payment) channels; ``dmomat``, MO-MAT with per-episode
preference weights appended to obs and share_obs), the feed-forward
actor-critic family (``AC_DCML_ALGOS``, :func:`build_ac_components`:
``ppo``, the centralised PPO over the joint action; ``mappo``, one shared
policy; ``ippo``, one policy an agent with a local value; ``happo`` and
``hatrpo``, one policy an agent trained in turn), or the ``random``
baseline, and evaluates; ``training/mujoco_runner.py::MujocoRunner`` trains
``mat`` on multi-agent MuJoCo lite. MO runs add
``average_step_objective_<i>`` to each record (``base_runner.py:900-914``);
``training/smac_runner.py`` trains ``mat`` and ``mat_dec`` on SMAC-lite.
Not ported yet: telemetry, fused dispatch, the dispatch watchdog (ROADMAP.md
queue 1, items 12-13).

Randomness: the weights come from a CPU ``torch.Generator`` seeded with
``--seed`` (so they are the same on every device); the env, policy noise and
minibatch permutations from one generator on the run's device, seeded with
``--seed``, whose state an emergency checkpoint carries.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.device import resolve_device, synchronize
from mat_dcml_tpu_torch.envs.dcml.env import DCMLEnv, DCMLEnvConfig
from mat_dcml_tpu_torch.envs.dcml.joint import JointDCMLEnv
from mat_dcml_tpu_torch.envs.dcml.per_agent import PerAgentDCMLEnv
from mat_dcml_tpu_torch.models.actor_critic import ACConfig, ActorCriticPolicy
from mat_dcml_tpu_torch.models.mat import SEMI_DISCRETE, TRUNK_DTYPES, MATConfig
from mat_dcml_tpu_torch.models.policy import TransformerPolicy
from mat_dcml_tpu_torch.training.ac_rollout import ACRolloutCollector, ACRolloutState
from mat_dcml_tpu_torch.training.checkpoint import CheckpointManager
from mat_dcml_tpu_torch.training.happo import (
    HAPPORolloutCollector,
    HAPPOTrainer,
    HATRPOTrainer,
)
from mat_dcml_tpu_torch.training.ippo import IPPORolloutCollector, IPPOTrainer
from mat_dcml_tpu_torch.training.mappo import MAPPOConfig, MAPPOTrainer
from mat_dcml_tpu_torch.training.ppo import MATTrainer, PPOConfig
from mat_dcml_tpu_torch.training.resilience import (
    GracefulStopHandler,
    PreemptedExit,
    pack_carry,
    unpack_tree,
)
from mat_dcml_tpu_torch.training.rollout import RolloutCollector

RESUME_MODES = ("strict", "auto")
MAT_DCML_ALGOS = ("mat", "mat_dec", "momat", "dmomat")
AC_DCML_ALGOS = ("ppo", "mappo", "ippo", "happo", "hatrpo")
RECURRENT_AC_ALGOS = ("rmappo", "rhappo", "rhatrpo")


def check_run(run: RunConfig, algorithms=("mat",)) -> None:
    """The run settings the port's trainers do not take: raise on them.
    ``algorithms`` are the ones the caller trains."""
    if run.algorithm_name in RECURRENT_AC_ALGOS:
        raise NotImplementedError(
            f"algorithm_name={run.algorithm_name!r}: the recurrent actor-critic variants "
            "(GRULayer, the chunked recurrent trainer) are not ported yet; the feed-forward "
            f"{AC_DCML_ALGOS} are (ROADMAP.md queue 1, item 9)")
    if run.algorithm_name not in algorithms:
        raise NotImplementedError(
            f"algorithm_name={run.algorithm_name!r} is not ported yet here; this trains "
            f"{algorithms} (ROADMAP.md queue 1, item 9)"
        )
    if run.model_dtype not in TRUNK_DTYPES:
        raise ValueError(f"model_dtype must be one of {tuple(TRUNK_DTYPES)}, "
                         f"got {run.model_dtype!r}")
    if run.resume not in RESUME_MODES:
        raise ValueError(f"resume must be one of {RESUME_MODES}, got {run.resume!r}")
    if run.decode_mode == "stride":
        # stride is the deterministic benchmark-protocol decode; it cannot
        # sample, so it cannot collect rollouts
        raise ValueError(
            "decode_mode='stride' is eval-only (see DCMLRunner.evaluate); "
            "training collect needs 'cached', 'scan', or 'spec'"
        )


def build_mat_policy(run: RunConfig, env: DCMLEnv, device=None,
                     generator: Optional[torch.Generator] = None) -> TransformerPolicy:
    """The DCML policy of ``run.algorithm_name`` in the MAT family, as the JAX
    runner builds it (``mat_dcml_tpu/training/runner.py:58-94``)."""
    check_run(run, MAT_DCML_ALGOS)
    algo = run.algorithm_name
    n_objective = 2 if algo in ("momat", "dmomat") else run.n_objective
    # dmomat conditions the policy on the preference weights, appended to
    # both obs and share_obs
    widen = n_objective if algo == "dmomat" else 0
    cfg = MATConfig(
        n_agent=env.n_agents, obs_dim=env.obs_dim + widen, state_dim=env.share_obs_dim + widen,
        action_dim=env.action_dim, n_block=run.n_block, n_embd=run.n_embd, n_head=run.n_head,
        action_type=SEMI_DISCRETE, semi_index=-env.cfg.consts.extra_agent,
        encode_state=run.encode_state,
        dec_actor=run.dec_actor or algo == "mat_dec",
        share_actor=run.share_actor or algo == "mat_dec",
        n_objective=n_objective,
        dtype=run.model_dtype,
    )
    return TransformerPolicy(cfg, decode_mode=run.decode_mode, device=device, generator=generator)


def ac_config_kwargs(ppo: PPOConfig) -> dict:
    """The ``MAPPOConfig`` fields a run's ``PPOConfig`` sets
    (``base_runner.py:216-226``)."""
    return dict(lr=ppo.lr, ppo_epoch=ppo.ppo_epoch,
                num_mini_batch=ppo.num_mini_batch, clip_param=ppo.clip_param,
                entropy_coef=ppo.entropy_coef, value_loss_coef=ppo.value_loss_coef,
                max_grad_norm=ppo.max_grad_norm, gamma=ppo.gamma, gae_lambda=ppo.gae_lambda)


def build_ac_components(run: RunConfig, ppo: PPOConfig, env: DCMLEnv, device=None,
                        generator: Optional[torch.Generator] = None):
    """``(policy, trainer, collector)`` of ``run.algorithm_name`` in the
    actor-critic family, as the JAX runner builds them
    (``mat_dcml_tpu/training/runner.py:140-190``): ``ppo`` over the joint
    view (one agent, the mixed action space, the product importance
    weight); the others over the per-agent view (``MixedRole``), ``mappo``
    with one shared policy, ``ippo`` one an agent with the critic on local
    obs, ``happo`` and ``hatrpo`` one an agent with the centralised critic.
    The weights are drawn from ``generator`` (a CPU generator)."""
    check_run(run, AC_DCML_ALGOS)
    algo = run.algorithm_name
    kw = ac_config_kwargs(ppo)
    ac = ACConfig(hidden_size=run.n_embd)
    T = run.episode_length
    if algo == "ppo":
        wrapped = JointDCMLEnv(env)
        policy = ActorCriticPolicy(ac, wrapped.obs_dim, wrapped.share_obs_dim,
                                   wrapped.action_space, device=device, generator=generator)
        return (policy, MAPPOTrainer(policy, MAPPOConfig(importance_prod=True, **kw)),
                ACRolloutCollector(wrapped, policy, T))
    wrapped = PerAgentDCMLEnv(env)
    A = wrapped.n_agents
    policy = ActorCriticPolicy(
        ac, wrapped.obs_dim, wrapped.obs_dim if algo == "ippo" else wrapped.share_obs_dim,
        wrapped.action_space, n_stack=1 if algo == "mappo" else A, device=device,
        generator=generator)
    if algo == "mappo":
        return (policy, MAPPOTrainer(policy, MAPPOConfig(**kw)),
                ACRolloutCollector(wrapped, policy, T))
    if algo == "ippo":
        return (policy, IPPOTrainer(policy, MAPPOConfig(**kw), n_agents=A),
                IPPORolloutCollector(wrapped, policy, T, use_local_value=True))
    trainer_cls = HATRPOTrainer if algo == "hatrpo" else HAPPOTrainer
    return (policy, trainer_cls(policy, MAPPOConfig(**kw), n_agents=A),
            HAPPORolloutCollector(wrapped, policy, T))


def restore_mat_policy(run: RunConfig, env: DCMLEnv, model_dir, step: Optional[int] = None,
                       device=None, build=build_mat_policy):
    """``(policy, step)``: the MAT built by ``build(run, env, device=...)``
    (default the DCML one) from ``run``'s model flags, with the weights of
    checkpoint ``step`` (default the newest) under ``model_dir``; a shape
    mismatch fails in ``load_state_dict``."""
    policy = build(run, env, device=device)
    mgr = CheckpointManager(model_dir, device=device)
    step = mgr.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {model_dir}")
    policy.model.load_state_dict(mgr.restore(step)["model"])
    return policy, step


class EpisodicRunner:
    """The collector and trainer around an env and a policy built by the
    subclass (``make_env``, ``make_policy``, ``make_trainer``) on
    ``run.device``, the episodic loop, its checkpoints and its resume.
    ``ALGORITHMS`` are the ``algorithm_name`` values the subclass trains."""

    ALGORITHMS = ("mat",)

    def __init__(self, run: RunConfig, ppo: PPOConfig, log_fn=print):
        check_run(run, self.ALGORITHMS)
        self.run_cfg = run
        self.log = log_fn
        self.device = resolve_device(run.device)
        self.generator = torch.Generator(device=self.device).manual_seed(run.seed)
        self.env = self.make_env()
        self.policy = self.make_policy(torch.Generator().manual_seed(run.seed))
        self.trainer = self.make_trainer(ppo)
        self.collector = self.make_collector()
        self.run_dir = (Path(run.run_dir) / run.env_name / run.scenario / run.algorithm_name
                        / run.experiment_name)
        self.metrics_path = self.run_dir / "metrics.jsonl"
        self.ckpt = CheckpointManager(self.run_dir / "models", log=log_fn, device=self.device)
        self.stop = GracefulStopHandler(log=log_fn) if run.graceful_stop else None
        self.emergency = self._emergency_manager(self.ckpt.directory)
        self.records: list = []
        self.eval_records: list = []
        self.start_episode = 0

    def make_env(self):
        raise NotImplementedError

    def make_policy(self, generator: torch.Generator):
        raise NotImplementedError

    def make_trainer(self, ppo: PPOConfig):
        return MATTrainer(self.policy, ppo, total_updates=self.run_cfg.episodes)

    def make_collector(self):
        run = self.run_cfg
        return RolloutCollector(self.env, self.policy, run.episode_length,
                                dynamic_coefficients=run.algorithm_name == "dmomat")

    def evaluate(self, n_steps: int = 100, seed: int = 0, stride: Optional[int] = None) -> dict:
        raise NotImplementedError(f"{type(self).__name__} has no evaluation yet "
                                  "(ROADMAP.md queue 1, item 10)")

    def _extra_metrics(self, record: dict) -> None:
        """A subclass's renaming of a record's keys, in place, before it is
        written (``base_runner.py:925``)."""

    # ---------------------------------------------------------------- resume

    def _emergency_manager(self, models: Path) -> CheckpointManager:
        """The one-slot manager of the emergency carry under ``models``."""
        return CheckpointManager(models / "emergency", max_to_keep=1, log=self.log,
                                 device=self.device)

    def setup(self):
        """The training state and the rollout state the loop starts from:
        fresh, or restored (module docstring) when ``model_dir`` is set or
        ``resume="auto"``."""
        run = self.run_cfg
        train_state = self.trainer.init_state()
        rollout_state = self.collector.init_state(run.n_rollout_threads, generator=self.generator)
        restore_dir = run.model_dir or (str(self.ckpt.directory) if run.resume == "auto" else None)
        if restore_dir:
            return self._maybe_restore(train_state, rollout_state, Path(restore_dir))
        return train_state, rollout_state

    def _maybe_restore(self, train_state, rollout_state, directory: Path):
        """``(train_state, rollout_state)`` restored from ``directory``: the
        emergency carry's, or the newest valid step's with the fresh rollout
        state."""
        directory = directory.absolute()
        own = directory == self.ckpt.directory
        mgr = self.ckpt if own else CheckpointManager(directory, log=self.log, device=self.device)
        step, saved = mgr.restore_latest_valid()
        emergency = self.emergency if own else self._emergency_manager(directory)
        episode, carry = emergency.restore_latest_valid()
        # the carry of episode E is that episode's input; step S resumes at S + 1
        if carry is not None and episode > (-1 if step is None else step):
            rollout_state = unpack_tree(carry["rollout_state"], rollout_state)
            got = rollout_state.obs.shape[0]
            if got != self.run_cfg.n_rollout_threads:
                raise ValueError(f"the emergency checkpoint was taken with n_rollout_threads="
                                 f"{got}, this run uses {self.run_cfg.n_rollout_threads}")
            train_state = self.trainer.load_state_dict(train_state, carry["train_state"])
            self.generator.set_state(carry["generator"].cpu())   # a CPU byte tensor
            self.start_episode = episode
            self.log(f"restored emergency checkpoint from {emergency.directory}; "
                     f"resuming at episode {episode}")
            return train_state, rollout_state
        if saved is None:
            if self.run_cfg.resume == "auto":
                self.log(f"[resume auto] no checkpoint under {directory}; starting fresh")
                return train_state, rollout_state
            raise FileNotFoundError(f"no checkpoint under {directory}")
        train_state = self.trainer.load_state_dict(train_state, saved)
        self.start_episode = step + 1
        self.log(f"restored checkpoint step {step} (full state) from {directory}; "
                 f"resuming at episode {self.start_episode}")
        return train_state, rollout_state

    def _graceful_stop_check(self, episode: int, train_state, rollout_state) -> None:
        """Honour a pending SIGTERM / SIGINT at an episode boundary: a
        blocking save of the full carry as step ``episode`` of the emergency
        slot, then :class:`PreemptedExit` (exit 75)."""
        if self.stop is None or not self.stop.stop_requested:
            return
        run = self.run_cfg
        reason = self.stop.reason or "signal"
        carry = pack_carry(self.trainer.state_dict(train_state), rollout_state, self.generator)
        self.emergency.save(episode, carry, blocking=True)
        latency = self.stop.latency_s()
        total_steps = episode * run.episode_length * run.n_rollout_threads
        self._write({"emergency_checkpoint": reason, "episode": episode,
                     "total_steps": total_steps, "stop_latency_s": latency})
        self.ckpt.finish()
        self.log(f"[resilience] graceful stop at episode {episode} ({latency:.2f}s after "
                 f"{reason}); exiting preempted")
        raise PreemptedExit()

    # ------------------------------------------------------------------ loop

    def _write(self, record: dict) -> None:
        self.run_dir.mkdir(parents=True, exist_ok=True)
        with open(self.metrics_path, "a") as writer:
            writer.write(json.dumps(record) + "\n")

    def train_loop(self, num_episodes: Optional[int] = None, train_state=None, rollout_state=None):
        run = self.run_cfg
        episodes = run.episodes if num_episodes is None else num_episodes
        if train_state is None:
            train_state, rollout_state = self.setup()
        E = run.n_rollout_threads
        first = self.start_episode
        self.log(f"algorithm={run.algorithm_name} env={run.env_name}/{run.scenario} "
                 f"episodes={episodes} start={first} device={self.device}")
        if first >= episodes:
            self.log(f"resume at episode {first} >= requested {episodes} episodes; "
                     "nothing to train")
            return train_state, rollout_state
        agg = dict(n_done=0.0, done_reward_sum=0.0, done_delay_sum=0.0, done_payment_sum=0.0)
        start = time.time()
        if self.stop is not None:
            self.stop.install()
        try:
            for episode in range(first, episodes):
                self._graceful_stop_check(episode, train_state, rollout_state)
                train_state, rollout_state, metrics, chunk_stats, (collect_s, train_s) = \
                    self.trainer.train_iteration(self.collector, train_state, rollout_state,
                                                 generator=self.generator)
                stats = {k: float(v) for k, v in chunk_stats.items()}
                for k in agg:
                    agg[k] += stats[k]
                total_steps = (episode + 1) * run.episode_length * E
                if episode % run.log_interval == 0 or episode == first:
                    steps_here = (episode + 1 - first) * run.episode_length * E
                    record = {
                        "episode": episode,
                        "total_steps": total_steps,
                        "fps": steps_here / max(time.time() - start, 1e-9),
                        "average_step_rewards": stats["step_reward_mean"],
                        # per-agent metrics (IPPO) averaged, as JAX's record does
                        **{k: float(v.sum() if k == "nonfinite_grads" else v.float().mean())
                           for k, v in metrics._asdict().items()},
                        "step_time_collect": collect_s,
                        "step_time_train": train_s,
                    }
                    for k, v in stats.items():   # per-objective step means (MO)
                        if k.startswith("step_objective_"):
                            record[f"average_step_objective_{k.split('_')[2]}"] = v
                    if agg["n_done"] > 0:
                        record["aver_episode_rewards"] = agg["done_reward_sum"] / agg["n_done"]
                        record["aver_episode_delays"] = agg["done_delay_sum"] / agg["n_done"]
                        record["aver_episode_payments"] = agg["done_payment_sum"] / agg["n_done"]
                        agg = dict.fromkeys(agg, 0.0)
                    self._extra_metrics(record)
                    self._write(record)
                    self.records.append(record)
                    self.log(f"ep {episode} steps {total_steps} fps {record['fps']:.0f} "
                             f"avg_r {record['average_step_rewards']:.3f} "
                             f"vloss {record['value_loss']:.3f} ploss {record['policy_loss']:.3f} "
                             f"ent {record['dist_entropy']:.3f} collect {collect_s:.2f}s "
                             f"train {train_s:.2f}s")
                if run.save_interval > 0 and (episode % run.save_interval == 0
                                              or episode == episodes - 1):
                    state = self.trainer.state_dict(train_state)
                    if state:     # the random baseline's is empty
                        self.ckpt.save(episode, state)
                if run.use_eval and episode % run.eval_interval == 0:
                    info = self.evaluate()
                    info.update(episode=episode, total_steps=total_steps)
                    self._write(info)
                    self.eval_records.append(info)
                    self.log(f"eval ep {episode}: {info}")
        finally:
            if self.stop is not None:
                self.stop.uninstall()
            # saves are asynchronous: the last must land before anyone reads
            # the run's models/
            self.ckpt.finish()
        return train_state, rollout_state


class DCMLRunner(EpisodicRunner):
    """The DCML recipe: the worker-selection env and the semi-discrete MAT
    family (``MAT_DCML_ALGOS``), the actor-critic family
    (``AC_DCML_ALGOS``), or the random baseline
    (``algorithm_name="random"``)."""

    ALGORITHMS = MAT_DCML_ALGOS + AC_DCML_ALGOS + ("random",)

    def __init__(self, run: RunConfig, ppo: PPOConfig, log_fn=print,
                 env_config: DCMLEnvConfig = DCMLEnvConfig()):
        self.env_config = env_config
        self.ppo_cfg = ppo
        super().__init__(run, ppo, log_fn)

    def make_env(self) -> DCMLEnv:
        return DCMLEnv(self.env_config, device=self.device)

    @property
    def is_ac(self) -> bool:
        return self.run_cfg.algorithm_name in AC_DCML_ALGOS

    def make_policy(self, generator: torch.Generator):
        if self.is_ac:
            self.policy, self._ac_trainer, self._ac_collector = build_ac_components(
                self.run_cfg, self.ppo_cfg, self.env, self.device, generator)
            return self.policy
        if self.run_cfg.algorithm_name == "random":
            from mat_dcml_tpu_torch.training.random_baseline import RandomPolicy

            return RandomPolicy(self.env.n_agents, self.env.action_dim,
                                n_cont_tail=self.env.cfg.consts.extra_agent, device=self.device)
        return build_mat_policy(self.run_cfg, self.env, device=self.device, generator=generator)

    def make_trainer(self, ppo: PPOConfig):
        if self.is_ac:
            return self._ac_trainer
        if self.run_cfg.algorithm_name == "random":
            from mat_dcml_tpu_torch.training.random_baseline import RandomTrainer

            return RandomTrainer(self.policy)
        return super().make_trainer(ppo)

    def make_collector(self):
        return self._ac_collector if self.is_ac else super().make_collector()

    # ----------------------------------------------------------------- eval

    def evaluate(self, n_steps: int = 100, seed: int = 0, stride: Optional[int] = None) -> dict:
        """Deterministic-policy evaluation on fresh envs with episode delay
        and payment accounting and per-call inference timing
        (``mat_dcml_tpu/training/runner.py:215-312``, ``dcml_runner.py:319-448``).
        The weights are the policy's own: the port's training state holds
        the live model, so JAX's ``train_state`` argument has no
        counterpart.  The decode is the policy's mode, deterministic
        (``scan``: one ``ar_decode`` launch a step on the card), or with
        ``stride`` the reference's block-commit decode (teacher-forced
        passes through the attention kernel).  The envs and their draws come
        from a generator seeded ``seed + 13``, apart from the run's; a
        ``dmomat`` policy reads obs and share_obs widened by the preference
        weights drawn at the reset, fixed for the whole evaluation
        (``mat_dcml_tpu/training/runner.py:240-246``).  The actor-critic
        family acts deterministically through its collector on its view of
        the env (``runner.py:275-290``); it has no stride decode."""
        E = self.run_cfg.n_rollout_threads
        gen = torch.Generator(device=self.device).manual_seed(seed + 13)
        col = self.collector
        env = col.env
        st = col.init_state(E, generator=gen)

        if self.is_ac:
            if stride is not None:
                raise ValueError("stride is the MAT decode; the actor-critic family has none")

            def act(st):
                with torch.no_grad():
                    return col.apply(st, deterministic=True)

            def advance(st, out, ts):
                mask = torch.where(ts.done.all(dim=1)[:, None, None], 0.0, 1.0).expand_as(st.mask)
                return ACRolloutState(st.env_states, ts.obs, ts.share_obs, ts.available_actions,
                                      mask, out.actor_h, out.critic_h, st.episode_acc)

            def action_of(out):
                return out.action
        else:
            coefs = st.objective_coefficients

            def act(st):
                with torch.no_grad():
                    if stride is None:
                        return self.policy.get_actions(st.share_obs, st.obs, st.available_actions,
                                                       deterministic=True).action
                    return self.policy.act_stride(st.share_obs, st.obs, st.available_actions,
                                                  stride=stride).action

            def advance(st, out, ts):
                return st._replace(obs=col.augment_share_obs(ts.obs, coefs),
                                   share_obs=col.augment_share_obs(ts.share_obs, coefs),
                                   available_actions=ts.available_actions)

            def action_of(out):
                return out

        act(st)   # warm-up: the first call on the card loads the kernels
        infer_time = 0.0
        per_step = []
        for _ in range(n_steps):
            synchronize(self.device)   # the env step queued before is not the call's
            t0 = time.perf_counter()
            out = act(st)
            synchronize(self.device)
            infer_time += time.perf_counter() - t0
            env_states, ts = env.step(st.env_states, action_of(out), env.draw_step(E, gen))
            st = advance(st, out, ts)._replace(env_states=env_states)
            per_step.append(torch.stack([ts.reward.sum(-1).mean(-1), ts.delay, ts.payment,
                                         ts.done.all(dim=1).float()]))
        r, d, p, done = torch.stack(per_step).cpu().numpy().transpose(1, 0, 2)  # (4, n_steps, E)
        done = done > 0.5
        acc = np.zeros((3, E))
        episodes = [[], [], []]
        for t in range(n_steps):
            acc += np.stack([r[t], d[t], p[t]])
            if done[t].any():
                for i in range(3):
                    episodes[i].extend(acc[i, done[t]].tolist())
                acc[:, done[t]] = 0.0
        info = {
            "eval_average_step_rewards": float(np.mean(r.mean(axis=1))),
            "eval_average_delays": float(np.mean(d.mean(axis=1))),
            "eval_average_payments": float(np.mean(p.mean(axis=1))),
            "eval_inference_sec_per_call": infer_time / n_steps,
        }
        if episodes[1]:
            info["eval_aver_episode_rewards"] = float(np.mean(episodes[0]))
            info["eval_aver_episode_delays"] = float(np.mean(episodes[1]))
            info["eval_aver_episode_payments"] = float(np.mean(episodes[2]))
        return info
