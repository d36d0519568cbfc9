"""Train MAT on a SMAC map (the SMAC-lite combat stand-in) with the PyTorch port.

The port's counterpart of the repository's ``train_smac.py``: the same flags
and defaults for what the port supports (``--map_name 3m``, episode_length
60, env_name ``StarCraft2``, the run and PPO defaults otherwise), plus
``--device`` (default ``cuda``; raises when no card is present).
``--algorithm_name``: ``mat`` or ``mat_dec``.  ``--random_order`` shuffles
the agent order every episode (``envs/permute.py``).  ``--backend sc2``
exits with the JAX entry point's message: the real game needs the external
``smac`` package and a game binary.  Metrics stream to
``<run_dir>/StarCraft2/<map>/<algorithm>/<experiment_name>/metrics.jsonl``
(``win_rate`` and ``dead_ratio`` in each record where a battle ended),
checkpoints to its ``models/``; after training the final evaluation
(``--eval_episodes`` deterministic battles, default 32) is printed.  SIGTERM / SIGINT
and ``--resume auto`` behave as in ``train_dcml``.

Usage:
  python -m mat_dcml_tpu_torch.train_smac --map_name 8m --n_rollout_threads 32 \\
      --num_mini_batch 1 --episode_length 100 --lr 5e-4 --ppo_epoch 15 \\
      --clip_param 0.05                                        # the recipe, on the card
  python -m mat_dcml_tpu_torch.train_smac --device cpu --map_name 3m --num_env_steps 240 \\
      --n_rollout_threads 4 --episode_length 30 --n_embd 16 --n_block 1 --log_interval 1 \\
      --eval_episodes 4
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from mat_dcml_tpu_torch.config import parse_cli_with_extras
from mat_dcml_tpu_torch.envs.smac.maps import map_param_registry
from mat_dcml_tpu_torch.envs.smac.smaclite import SMACLiteConfig
from mat_dcml_tpu_torch.training.smac_runner import SMACRunner

SC2_MESSAGE = ("--backend sc2 needs the external smac package + an SC2 install "
               "(not bundled); wire SMACHostEnv through ShareSubprocVecEnv + "
               "HostRolloutCollector (envs/smac/host.py docstring).")


def parse(argv=None):
    """``(run, ppo, namespace)`` from the command line (strict)."""
    extras = argparse.ArgumentParser(add_help=False)
    extras.add_argument("--map_name", type=str, default="3m", choices=sorted(map_param_registry))
    extras.add_argument("--backend", type=str, default="smaclite", choices=("smaclite", "sc2"))
    # per-episode agent-order shuffling (Random_StarCraft2_Env)
    extras.add_argument("--random_order", action="store_true")
    # battles the final evaluation plays to their end (JAX's RunConfig field)
    extras.add_argument("--eval_episodes", type=int, default=32)
    run, ppo, ns = parse_cli_with_extras(argv, extras=extras, overrides={
        "env_name": "StarCraft2", "episode_length": 60,
    })
    if ns.backend == "sc2":
        raise SystemExit(SC2_MESSAGE)
    return dataclasses.replace(run, scenario=ns.map_name), ppo, ns


def main(argv=None):
    run, ppo, ns = parse(argv)
    runner = SMACRunner(run, ppo, SMACLiteConfig(map_name=ns.map_name),
                        random_order=ns.random_order)
    runner.log(f"env=SMAC/{ns.map_name} agents={runner.env.n_agents} "
               f"actions={runner.env.action_dim} random_order={ns.random_order}")
    runner.train_loop()
    info = runner.evaluate(n_episodes=ns.eval_episodes)
    runner.log(f"final eval: {info}")
    return info


if __name__ == "__main__":
    main(sys.argv[1:])
