"""SMAC runners: battle win-rate records, evaluation by battles, and one
policy trained across several maps.

Port of ``mat_dcml_tpu/training/smac_runner.py`` (``runner/shared/
smac_runner.py``, ``smac_multi_runner.py``) over the port's episodic loop:

- :class:`SMACRunner` trains the MAT family's ``mat`` and ``mat_dec``
  (MAT-Dec: one MLP actor shared by all agents, as
  ``generic_runner.py::build_discrete_policy`` sets ``dec_actor`` and
  ``share_actor``) on SMAC-lite, optionally with per-episode agent
  shuffling (``random_order``, the reference's ``Random_StarCraft2_Env``).
  The env puts the battle-won flag and the dead allies' share on the
  collector's ``delay`` / ``payment`` channels of the terminal step, so the
  per-episode sums are the metrics: each record's ``aver_episode_delays`` /
  ``aver_episode_payments`` become ``win_rate`` / ``dead_ratio``
  (``smac_runner.py:41-44``).  :meth:`SMACRunner.evaluate` plays
  deterministic battles until ``n_episodes`` have ended (``:46-93``).
- :class:`SMACMultiRunner` trains one policy on the universal translated
  layout (``envs/smac/translation.py``) across maps: one collector and one
  rollout state a map, one map's collect and update per episode in turn,
  per-map ``win_rate_<map>`` records, per-map evaluation (held-out maps
  included), and under ``model_dir`` the few-shot restore of the weights
  alone (a fresh optimizer).
- :func:`make_multi_map_runner` keeps JAX's routing: a heterogeneous roster,
  or ``random_order``, takes :class:`SMACMultiRunner`; a same-shape roster
  takes JAX's scenario-as-data runner (``SMACScenarioRunner`` over
  ``envs/scenario.py``), which is not ported yet and raises.

Any other algorithm raises (ROADMAP.md queue 1, item 9), as do MO critics
(``n_objective`` > 1: SMAC has one reward channel).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.envs.permute import AgentPermutationWrapper
from mat_dcml_tpu_torch.envs.smac.maps import get_map_params
from mat_dcml_tpu_torch.envs.smac.smaclite import SMACLiteConfig, SMACLiteEnv
from mat_dcml_tpu_torch.envs.smac.translation import TranslatedSMACEnv
from mat_dcml_tpu_torch.training.checkpoint import CheckpointManager
from mat_dcml_tpu_torch.training.mujoco_runner import build_policy
from mat_dcml_tpu_torch.training.ppo import PPOConfig
from mat_dcml_tpu_torch.training.rollout import RolloutCollector
from mat_dcml_tpu_torch.training.runner import EpisodicRunner

SMAC_ALGOS = ("mat", "mat_dec")


def _check_smac_run(run: RunConfig) -> None:
    if run.n_objective != 1:
        raise NotImplementedError("n_objective > 1: SMAC has one reward channel (MO critics "
                                  "train on DCML)")


def evaluate_battles(policy, env, collector: RolloutCollector, n_envs: int,
                     n_episodes: int = 32, seed: int = 0, max_steps: Optional[int] = None,
                     reset_draws=None, draw_step: Optional[Callable] = None) -> dict:
    """Deterministic battles on ``n_envs`` fresh envs until ``n_episodes``
    have ended, or the JAX step budget ``4 * episode_limit * (max(n_episodes
    // E, 1) + 1)`` (``episode_limit`` 200 where the env has none, as the
    translated layout) runs out (``smac_runner.py:46-93``).  The envs and
    their draws come from a generator seeded ``seed + 17`` on the policy's
    device; the decode is the policy's mode, deterministic (``scan``: one
    ``ar_decode`` launch a step on the card).  Returns the win rate and dead
    ratio over the battles that ended, their count (all that ended on the
    last step count), and the mean step reward.  A replay passes the draws
    instead: ``reset_draws``, and ``draw_step(done)``, each step's draws given
    the episode ends ``(E,)`` of the step before (none before the first)."""
    dev = policy.device
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    if draw_step is None:
        draw_step = lambda done: env.draw_step(n_envs, gen)  # noqa: E731
    st = collector.init_state(n_envs, draws=reset_draws, generator=gen)
    env_states, obs, share_obs, avail = st.env_states, st.obs, st.share_obs, st.available_actions
    done = torch.zeros(n_envs, dtype=torch.bool, device=dev)
    limit = max_steps or 4 * getattr(env, "episode_limit", 200) * (
        max(n_episodes // n_envs, 1) + 1)
    episodes = wins = 0
    dead_ratios, rewards = [], []
    for _ in range(limit):
        with torch.no_grad():
            action = policy.get_actions(share_obs, obs, avail, deterministic=True).action
        env_states, ts = env.step(env_states, action, draw_step(done))
        obs, share_obs, avail = ts.obs, ts.share_obs, ts.available_actions
        done = ts.done.all(dim=1)
        # one host read a step: whether enough battles have ended
        row = torch.cat([done.float(), ts.delay, ts.payment, ts.reward.mean()[None]]).cpu().numpy()
        done_h, won, dead = row[:n_envs] > 0.5, row[n_envs:2 * n_envs], row[2 * n_envs:-1]
        rewards.append(float(row[-1]))
        if done_h.any():
            episodes += int(done_h.sum())
            wins += int(won[done_h].sum())
            dead_ratios.extend(dead[done_h].tolist())
        if episodes >= n_episodes:
            break
    return {
        "eval_win_rate": wins / max(episodes, 1),
        "eval_episodes": episodes,
        "eval_dead_ratio": float(np.mean(dead_ratios)) if dead_ratios else 0.0,
        "eval_average_step_rewards": float(np.mean(rewards)),
    }


class SMACRunner(EpisodicRunner):
    """MAT or MAT-Dec on one SMAC-lite map, the episodic collect-then-train
    loop with its checkpoints, resume and graceful stop."""

    ALGORITHMS = SMAC_ALGOS

    def __init__(self, run: RunConfig, ppo: PPOConfig,
                 env_config: SMACLiteConfig = SMACLiteConfig(), random_order: bool = False,
                 log_fn=print):
        _check_smac_run(run)
        self.env_config = env_config
        self.random_order = random_order
        super().__init__(run, ppo, log_fn)

    def make_env(self):
        env = SMACLiteEnv(self.env_config, device=self.device)
        return AgentPermutationWrapper(env) if self.random_order else env

    def make_policy(self, generator: torch.Generator):
        return build_policy(self.run_cfg, self.env, device=self.device, generator=generator,
                            algorithms=SMAC_ALGOS)

    def _extra_metrics(self, record: dict) -> None:
        if "aver_episode_delays" in record:
            record["win_rate"] = record.pop("aver_episode_delays")
            record["dead_ratio"] = record.pop("aver_episode_payments")

    def evaluate(self, n_episodes: int = 32, seed: int = 0,
                 max_steps: Optional[int] = None) -> dict:
        """:func:`evaluate_battles` with the run's E envs and the policy's
        own weights (the JAX ``train_state`` argument has no counterpart)."""
        return evaluate_battles(self.policy, self.env, self.collector,
                                self.run_cfg.n_rollout_threads, n_episodes, seed, max_steps)


class SMACMultiRunner(EpisodicRunner):
    """One MAT policy, many maps, through the universal translated layout
    (``smac_runner.py:96-213``): one collector and rollout state a map, one
    map's collect and update per episode, round-robin."""

    ALGORITHMS = SMAC_ALGOS

    def __init__(self, run: RunConfig, ppo: PPOConfig, train_maps: Sequence[str],
                 random_order: bool = False, log_fn=print):
        _check_smac_run(run)
        self.train_maps = tuple(train_maps)
        self.random_order = random_order
        self.envs = {}
        super().__init__(run, ppo, log_fn)
        self.collectors = {m: RolloutCollector(env, self.policy, run.episode_length)
                           for m, env in self.envs.items()}
        self.collector = self.collectors[self.train_maps[0]]

    def _make_env(self, map_name: str):
        env = TranslatedSMACEnv(SMACLiteConfig(map_name=map_name), device=self.device)
        # evaluation maps, held-out ones included, go through the same
        # wrapper, so win rates compare across maps
        return AgentPermutationWrapper(env) if self.random_order else env

    def make_env(self):
        self.envs = {m: self._make_env(m) for m in self.train_maps}
        return self.envs[self.train_maps[0]]

    def make_policy(self, generator: torch.Generator):
        return build_policy(self.run_cfg, self.env, device=self.device, generator=generator,
                            algorithms=SMAC_ALGOS)

    def setup(self):
        """The training state, under ``model_dir`` with the newest valid
        step's weights alone (few-shot transfer: a fresh optimizer and
        schedule, ``smac_runner.py:142-146``), and a fresh rollout state a
        map, drawn in the roster's order."""
        run = self.run_cfg
        train_state = self.trainer.init_state()
        if run.model_dir:
            directory = Path(run.model_dir).absolute()
            step, saved = CheckpointManager(directory, log=self.log,
                                            device=self.device).restore_latest_valid()
            if saved is None:
                raise FileNotFoundError(f"no checkpoint under {directory}")
            self.policy.model.load_state_dict(saved["model"])
            self.log(f"restored checkpoint step {step} (params) from {directory}")
        rollout_states = {m: self.collectors[m].init_state(run.n_rollout_threads,
                                                           generator=self.generator)
                          for m in self.train_maps}
        return train_state, rollout_states

    def train_loop(self, num_episodes: Optional[int] = None, train_state=None,
                   rollout_states=None):
        run = self.run_cfg
        episodes = run.episodes if num_episodes is None else num_episodes
        if train_state is None:
            train_state, rollout_states = self.setup()
        self.log(f"algorithm={run.algorithm_name} maps={self.train_maps} episodes={episodes} "
                 f"device={self.device}")
        # per map since the last record: battles ended, battles won (the win
        # flag fires on the terminal step of a won battle)
        ended = dict.fromkeys(self.train_maps, 0.0)
        won = dict.fromkeys(self.train_maps, 0.0)
        try:
            for episode in range(episodes):
                m = self.train_maps[episode % len(self.train_maps)]
                train_state, rollout_states[m], metrics, stats, (collect_s, train_s) = \
                    self.trainer.train_iteration(self.collectors[m], train_state,
                                                 rollout_states[m], generator=self.generator)
                ended[m] += float(stats["n_done"])
                won[m] += float(stats["done_delay_sum"])
                if episode % run.log_interval == 0:
                    record = {
                        "episode": episode,
                        "map": m,
                        "average_step_rewards": float(stats["step_reward_mean"]),
                        "value_loss": float(metrics.value_loss),
                        "policy_loss": float(metrics.policy_loss),
                        "dist_entropy": float(metrics.dist_entropy),
                        "step_time_collect": collect_s,
                        "step_time_train": train_s,
                    }
                    for name in self.train_maps:
                        if ended[name] > 0:
                            record[f"win_rate_{name}"] = won[name] / ended[name]
                    ended = dict.fromkeys(self.train_maps, 0.0)
                    won = dict.fromkeys(self.train_maps, 0.0)
                    self._write(record)
                    self.records.append(record)
                    self.log(f"ep {episode} [{m}] {json.dumps(record)}")
                if run.save_interval > 0 and (episode % run.save_interval == 0
                                              or episode == episodes - 1):
                    self.ckpt.save(episode, self.trainer.state_dict(train_state))
        finally:
            self.ckpt.finish()
        return train_state, rollout_states

    def evaluate(self, maps: Optional[Sequence[str]] = None, n_episodes: int = 16,
                 seed: int = 0) -> dict:
        """Per-map deterministic win rates ``eval_win_rate_<map>``; ``maps``
        may include held-out maps (few-shot evaluation,
        ``smac_multi_runner.py:160-275``)."""
        maps = tuple(maps) if maps is not None else self.train_maps
        out = {}
        for m in maps:
            env = self.envs.get(m) or self._make_env(m)
            collector = RolloutCollector(env, self.policy, self.run_cfg.episode_length)
            info = evaluate_battles(self.policy, env, collector, self.run_cfg.n_rollout_threads,
                                    n_episodes, seed)
            out[f"eval_win_rate_{m}"] = info["eval_win_rate"]
        return out


def make_multi_map_runner(run: RunConfig, ppo: PPOConfig, train_maps: Sequence[str],
                          random_order: bool = False, log_fn=print) -> SMACMultiRunner:
    """The multi-map backend for a roster (``smac_runner.py:313-335``): a
    same-shape roster (equal ally and enemy counts and map size) of several
    maps is JAX's scenario-as-data path, one compiled program over the
    roster, which is not ported and raises rather than train the host-cycled
    way, which trains differently; a heterogeneous roster, or
    ``random_order``, takes :class:`SMACMultiRunner`."""
    maps = tuple(train_maps)
    mps = [get_map_params(m) for m in maps]
    same_shape = (len({(len(mp.agents), len(mp.enemies)) for mp in mps}) == 1
                  and len({mp.map_size for mp in mps}) == 1)
    if same_shape and not random_order and len(maps) > 1:
        raise NotImplementedError(
            f"same-shape roster {maps}: JAX trains it with SMACScenarioRunner over "
            "envs/scenario.py (scenario-as-data), not ported yet (ROADMAP.md queue 1, "
            "item 10); add --random_order for the host-cycled multi-map runner")
    if len(maps) > 1:
        why = "random_order" if random_order else "heterogeneous roster"
        log_fn(f"[smac-multi] {why}: host-cycled multi-map runner over {maps}")
    return SMACMultiRunner(run, ppo, maps, random_order=random_order, log_fn=log_fn)
