"""The classic collect-then-train loop, and the DCML runner.

Port of ``mat_dcml_tpu/training/runner.py::build_mat_policy`` and a lean
``EpisodicRunner`` around ``base_runner.py::_train_loop_episodic`` (``:702``):
each episode collects one chunk, runs one PPO update, and every
``log_interval`` episodes writes one record to ``<run_dir>/metrics.jsonl``
with the JAX record's basic keys.  ``DCMLRunner`` trains on the DCML env;
``training/mujoco_runner.py::MujocoRunner`` on multi-agent MuJoCo lite.  Not ported yet, each said where it
matters: checkpointing and resume (ROADMAP.md queue 1, item 7), evaluation
(item 8), telemetry, fused dispatch and resilience (items 12-13).

Randomness: the weights come from a CPU ``torch.Generator`` seeded with
``--seed`` (so they are the same on every device); the env, policy noise and
minibatch permutations from one generator on the run's device, seeded with
``--seed``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import torch

from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.device import resolve_device
from mat_dcml_tpu_torch.envs.dcml.env import DCMLEnv, DCMLEnvConfig
from mat_dcml_tpu_torch.models.mat import SEMI_DISCRETE, TRUNK_DTYPES, MATConfig
from mat_dcml_tpu_torch.models.policy import TransformerPolicy
from mat_dcml_tpu_torch.training.ppo import MATTrainer, PPOConfig
from mat_dcml_tpu_torch.training.rollout import RolloutCollector


def check_run(run: RunConfig) -> None:
    """The run settings the port's trainers do not take: raise on them."""
    if run.algorithm_name != "mat":
        raise NotImplementedError(
            f"algorithm_name={run.algorithm_name!r} is not ported yet; the port trains 'mat' "
            "(ROADMAP.md queue 1, item 9)"
        )
    if run.model_dtype not in TRUNK_DTYPES:
        raise ValueError(f"model_dtype must be one of {tuple(TRUNK_DTYPES)}, "
                         f"got {run.model_dtype!r}")
    if run.decode_mode == "stride":
        # stride is the deterministic benchmark-protocol decode; it cannot
        # sample, so it cannot collect rollouts
        raise ValueError(
            "decode_mode='stride' is eval-only (see DCMLRunner.evaluate); "
            "training collect needs 'cached', 'scan', or 'spec'"
        )


def build_mat_policy(run: RunConfig, env: DCMLEnv, device=None,
                     generator: Optional[torch.Generator] = None) -> TransformerPolicy:
    check_run(run)
    cfg = MATConfig(
        n_agent=env.n_agents, obs_dim=env.obs_dim, state_dim=env.share_obs_dim,
        action_dim=env.action_dim, n_block=run.n_block, n_embd=run.n_embd, n_head=run.n_head,
        action_type=SEMI_DISCRETE, semi_index=-env.cfg.consts.extra_agent,
        dtype=run.model_dtype,
    )
    return TransformerPolicy(cfg, decode_mode=run.decode_mode, device=device, generator=generator)


class EpisodicRunner:
    """The collector and trainer around an env and a policy built by the
    subclass (``make_env`` and ``make_policy``) on ``run.device``, and the
    episodic loop."""

    def __init__(self, run: RunConfig, ppo: PPOConfig, log_fn=print):
        self.run_cfg = run
        self.log = log_fn
        self.device = resolve_device(run.device)
        self.generator = torch.Generator(device=self.device).manual_seed(run.seed)
        self.env = self.make_env()
        self.policy = self.make_policy(torch.Generator().manual_seed(run.seed))
        self.trainer = MATTrainer(self.policy, ppo)
        self.collector = RolloutCollector(self.env, self.policy, run.episode_length)
        self.run_dir = (Path(run.run_dir) / run.env_name / run.scenario / run.algorithm_name
                        / run.experiment_name)
        self.metrics_path = self.run_dir / "metrics.jsonl"
        self.records: list = []
        self.log("checkpointing is not ported yet (ROADMAP.md queue 1, item 7): "
                 "this run saves no model")

    def make_env(self):
        raise NotImplementedError

    def make_policy(self, generator: torch.Generator) -> TransformerPolicy:
        raise NotImplementedError

    def setup(self):
        train_state = self.trainer.init_state()
        rollout_state = self.collector.init_state(self.run_cfg.n_rollout_threads,
                                                  generator=self.generator)
        return train_state, rollout_state

    def train_loop(self, num_episodes: Optional[int] = None, train_state=None, rollout_state=None):
        run = self.run_cfg
        episodes = run.episodes if num_episodes is None else num_episodes
        if train_state is None:
            train_state, rollout_state = self.setup()
        E = run.n_rollout_threads
        self.log(f"algorithm={run.algorithm_name} env={run.env_name}/{run.scenario} "
                 f"episodes={episodes} device={self.device}")
        self.run_dir.mkdir(parents=True, exist_ok=True)
        agg = dict(n_done=0.0, done_reward_sum=0.0, done_delay_sum=0.0, done_payment_sum=0.0)
        start = time.time()
        with open(self.metrics_path, "a") as writer:
            for episode in range(episodes):
                train_state, rollout_state, metrics, chunk_stats, (collect_s, train_s) = \
                    self.trainer.train_iteration(self.collector, train_state, rollout_state,
                                                 generator=self.generator)
                stats = {k: float(v) for k, v in chunk_stats.items()}
                for k in agg:
                    agg[k] += stats[k]
                if episode % run.log_interval != 0:
                    continue
                total_steps = (episode + 1) * run.episode_length * E
                record = {
                    "episode": episode,
                    "total_steps": total_steps,
                    "fps": total_steps / max(time.time() - start, 1e-9),
                    "average_step_rewards": stats["step_reward_mean"],
                    **{k: float(v) for k, v in metrics._asdict().items()},
                    "step_time_collect": collect_s,
                    "step_time_train": train_s,
                }
                if agg["n_done"] > 0:
                    record["aver_episode_rewards"] = agg["done_reward_sum"] / agg["n_done"]
                    record["aver_episode_delays"] = agg["done_delay_sum"] / agg["n_done"]
                    record["aver_episode_payments"] = agg["done_payment_sum"] / agg["n_done"]
                    agg = dict.fromkeys(agg, 0.0)
                writer.write(json.dumps(record) + "\n")
                writer.flush()
                self.records.append(record)
                self.log(f"ep {episode} steps {total_steps} fps {record['fps']:.0f} "
                         f"avg_r {record['average_step_rewards']:.3f} "
                         f"vloss {record['value_loss']:.3f} ploss {record['policy_loss']:.3f} "
                         f"ent {record['dist_entropy']:.3f} collect {collect_s:.2f}s "
                         f"train {train_s:.2f}s")
        return train_state, rollout_state


class DCMLRunner(EpisodicRunner):
    """The DCML recipe: the worker-selection env and the semi-discrete MAT."""

    def __init__(self, run: RunConfig, ppo: PPOConfig, log_fn=print,
                 env_config: DCMLEnvConfig = DCMLEnvConfig()):
        self.env_config = env_config
        super().__init__(run, ppo, log_fn)

    def make_env(self) -> DCMLEnv:
        return DCMLEnv(self.env_config, device=self.device)

    def make_policy(self, generator: torch.Generator) -> TransformerPolicy:
        return build_mat_policy(self.run_cfg, self.env, device=self.device, generator=generator)
