"""Train MAT on multi-agent MuJoCo (lite) with the PyTorch port.

The port's counterpart of the repository's ``train_mujoco.py``: the same
flags and defaults for what the port supports (``--scenario HalfCheetah-v2
--agent_conf 2x3 --agent_obsk 1``, episode_length 50, the run and PPO
defaults otherwise), the lite dynamics only, plus ``--device`` (default
``cuda``; raises when no card is present).  ``--random_order`` shuffles the
agent order every episode (``envs/permute.py``).  Fault injection
(``--faulty_node``, ``--eval_faulty_node``) and the gym backend are not
ported yet (ROADMAP.md queue 1, item 10): those flags are unknown here, and
``--backend`` takes only ``lite``.  Metrics stream to
``<run_dir>/mujoco/<scenario>_<agent_conf>/mat/<experiment_name>/metrics.jsonl``.

Usage:
  python -m mat_dcml_tpu_torch.train_mujoco                      # on the card
  python -m mat_dcml_tpu_torch.train_mujoco --device cpu --num_env_steps 40 \\
      --n_rollout_threads 2 --episode_length 10 --n_embd 16 --log_interval 1
  python -m mat_dcml_tpu_torch.train_mujoco --scenario manyagent_ant --agent_conf 10x2 \\
      --decode_mode scan                                         # the decode-step kernel
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from mat_dcml_tpu_torch.config import parse_cli_with_extras
from mat_dcml_tpu_torch.envs.mamujoco.lite import MJLiteConfig
from mat_dcml_tpu_torch.training.mujoco_runner import MujocoRunner


def parse(argv=None):
    """``(run, ppo, env_config, random_order)`` from the command line (strict)."""
    extras = argparse.ArgumentParser(add_help=False)
    extras.add_argument("--agent_conf", type=str, default="2x3")
    extras.add_argument("--agent_obsk", type=int, default=1)
    extras.add_argument("--backend", type=str, default="lite", choices=("lite",))
    # per-episode agent-order shuffling (random_mujoco_multi.py)
    extras.add_argument("--random_order", action="store_true")
    run, ppo, ns = parse_cli_with_extras(argv, extras=extras, overrides={
        "env_name": "mujoco", "scenario": "HalfCheetah-v2", "episode_length": 50,
    })
    env_config = MJLiteConfig(scenario=run.scenario, agent_conf=ns.agent_conf,
                              agent_obsk=ns.agent_obsk, episode_length=run.episode_length)
    run = dataclasses.replace(run, scenario=f"{run.scenario}_{ns.agent_conf}")
    return run, ppo, env_config, ns.random_order


def main(argv=None):
    run, ppo, env_config, random_order = parse(argv)
    runner = MujocoRunner(run, ppo, env_config, random_order=random_order)
    runner.log(f"env=mujoco/{env_config.scenario}/{env_config.agent_conf} "
               f"agents={runner.env.n_agents} action_dim={runner.env.action_dim}")
    runner.train_loop()


if __name__ == "__main__":
    main(sys.argv[1:])
