"""Export a training checkpoint of the PyTorch port as a weights-only policy.

The port's counterpart of ``scripts/export_policy.py``: restores the latest
(or ``--step``) full training state from a run's ``models/`` directory, loads
it into a model built from the run's flags (a shape mismatch fails there),
and writes the model's ``state_dict``, its ``MATConfig`` and the env's space
metadata with ``training/checkpoint.py::export_policy``.  A server
(``serving/engine.py::DecodeEngine.from_export``) reads that back without
optimizer or ValueNorm state.  The env is DCML's, or with ``--map_name`` a
SMAC-lite map's (``train_smac``; env_name ``StarCraft2``), or with
``--translated`` too the multi-map layout (``train_smac_multi``; env_name
``StarCraft2Multi``, scenario ``multi``).

Usage:
  python -m mat_dcml_tpu_torch.export_policy \\
      --model_dir results/DCML/AS/mat/check/models --out exports/dcml_as_mat \\
      [--step N] [model flags matching the run, e.g. --n_embd 64] [--device cpu]
  python -m mat_dcml_tpu_torch.export_policy --map_name 8m \\
      --model_dir results/StarCraft2/8m/mat/check/models --out exports/smac_8m_mat
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys

from mat_dcml_tpu_torch.config import parse_cli_with_extras
from mat_dcml_tpu_torch.device import resolve_device
from mat_dcml_tpu_torch.envs.dcml.env import DCMLEnv, DCMLEnvConfig
from mat_dcml_tpu_torch.envs.smac.maps import map_param_registry
from mat_dcml_tpu_torch.envs.smac.smaclite import SMACLiteConfig, SMACLiteEnv
from mat_dcml_tpu_torch.envs.smac.translation import TranslatedSMACEnv
from mat_dcml_tpu_torch.training.checkpoint import export_policy
from mat_dcml_tpu_torch.training.mujoco_runner import build_policy
from mat_dcml_tpu_torch.training.runner import build_mat_policy, restore_mat_policy
from mat_dcml_tpu_torch.training.smac_runner import SMAC_ALGOS


def main(argv=None) -> int:
    extras = argparse.ArgumentParser(add_help=False)
    extras.add_argument("--out", required=True, help="export directory")
    extras.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    extras.add_argument("--map_name", default=None, choices=sorted(map_param_registry),
                        help="a SMAC-lite policy of this map (default: DCML)")
    extras.add_argument("--translated", action="store_true",
                        help="with --map_name: the multi-map layout (train_smac_multi)")
    run, _, ns = parse_cli_with_extras(argv, extras=extras)
    if not run.model_dir:
        print("--model_dir is required (the run's models/ directory)", file=sys.stderr)
        return 2
    if ns.translated and ns.map_name is None:
        print("--translated needs --map_name (the layout's task embedding)", file=sys.stderr)
        return 2
    device = resolve_device(run.device)
    build = build_mat_policy
    if ns.map_name is None:
        env = DCMLEnv(DCMLEnvConfig(), device=device)
    else:
        cfg = SMACLiteConfig(map_name=ns.map_name)
        if ns.translated:
            env = TranslatedSMACEnv(cfg, device=device)
            run = dataclasses.replace(run, env_name="StarCraft2Multi", scenario="multi")
        else:
            env = SMACLiteEnv(cfg, device=device)
            run = dataclasses.replace(run, env_name="StarCraft2", scenario=ns.map_name)
        build = functools.partial(build_policy, algorithms=SMAC_ALGOS)
    try:
        policy, step = restore_mat_policy(run, env, run.model_dir, ns.step, device=device,
                                          build=build)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    space_meta = {
        "env_name": run.env_name,
        "scenario": run.scenario,
        "algorithm_name": run.algorithm_name,
        "n_agents": env.n_agents,
        "obs_dim": env.obs_dim,
        "share_obs_dim": env.share_obs_dim,
        "action_dim": env.action_dim,
        "checkpoint_step": int(step),
    }
    out = export_policy(ns.out, policy.model.state_dict(), policy.cfg, space_meta)
    n_params = sum(p.numel() for p in policy.model.parameters())
    print(f"exported step {step} ({n_params} params) -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
