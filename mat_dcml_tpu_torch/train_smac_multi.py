"""Multi-map SMAC training with the PyTorch port: one MAT policy across
several SMAC-lite maps.

The port's counterpart of the repository's ``train_smac_multi.py``:
``--train_maps`` (default ``3m,8m``), ``--eval_maps`` (default the training
maps; held-out maps evaluate few-shot), ``--random_order``, episode_length
60, env_name ``StarCraft2Multi``, scenario ``multi``, plus ``--device``
(default ``cuda``).  Heterogeneous rosters, or ``--random_order``, train
round-robin over per-map collectors on the universal translated layout
(``training/smac_runner.py::SMACMultiRunner``); a same-shape roster is JAX's
scenario-as-data path, not ported yet, and raises.  ``--model_dir``
restores the weights alone (few-shot transfer).  Each record carries the
map it trained and ``win_rate_<map>``; the final evaluation's per-map win
rates are printed.

Usage:
  python -m mat_dcml_tpu_torch.train_smac_multi --train_maps 3m,8m,2s3z,3s5z,MMM \\
      --n_rollout_threads 36 --num_mini_batch 1 --episode_length 100 --lr 5e-4 \\
      --ppo_epoch 10 --clip_param 0.05                         # the recipe, on the card
  python -m mat_dcml_tpu_torch.train_smac_multi --device cpu --train_maps 2m,3m \\
      --eval_maps 2m,3m,8m --num_env_steps 160 --n_rollout_threads 4 --episode_length 20 \\
      --n_embd 16 --n_block 1 --log_interval 1 --eval_episodes 4
"""

from __future__ import annotations

import argparse
import sys

from mat_dcml_tpu_torch.config import parse_cli_with_extras
from mat_dcml_tpu_torch.envs.smac.maps import map_param_registry
from mat_dcml_tpu_torch.training.smac_runner import make_multi_map_runner


def _maps(arg: str):
    names = [m for m in arg.split(",") if m]
    for m in names:
        if m not in map_param_registry:
            raise SystemExit(f"unknown map {m!r}; known: {sorted(map_param_registry)}")
    return names


def parse(argv=None):
    """``(run, ppo, train_maps, eval_maps, namespace)`` (strict)."""
    extras = argparse.ArgumentParser(add_help=False)
    extras.add_argument("--train_maps", type=str, default="3m,8m")
    extras.add_argument("--eval_maps", type=str, default="")
    # per-episode agent shuffling (Random_StarCraft2_Env_Multi)
    extras.add_argument("--random_order", action="store_true")
    # battles each map's final evaluation plays to their end
    extras.add_argument("--eval_episodes", type=int, default=32)
    run, ppo, ns = parse_cli_with_extras(argv, extras=extras, overrides={
        "env_name": "StarCraft2Multi", "scenario": "multi", "episode_length": 60,
    })
    train_maps = _maps(ns.train_maps)
    eval_maps = _maps(ns.eval_maps) if ns.eval_maps else train_maps
    return run, ppo, train_maps, eval_maps, ns


def main(argv=None):
    run, ppo, train_maps, eval_maps, ns = parse(argv)
    runner = make_multi_map_runner(run, ppo, train_maps=train_maps, random_order=ns.random_order)
    runner.train_loop()
    info = runner.evaluate(maps=eval_maps, n_episodes=ns.eval_episodes)
    runner.log(f"final eval: {info}")
    return info


if __name__ == "__main__":
    main(sys.argv[1:])
