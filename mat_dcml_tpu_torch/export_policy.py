"""Export a training checkpoint of the PyTorch port as a weights-only policy.

The port's counterpart of ``scripts/export_policy.py``: restores the latest
(or ``--step``) full training state from a run's ``models/`` directory, loads
it into a model built from the run's flags (a shape mismatch fails there),
and writes the model's ``state_dict``, its ``MATConfig`` and the DCML space
metadata with ``training/checkpoint.py::export_policy``.  A server
(``serving/engine.py::DecodeEngine.from_export``) reads that back without
optimizer or ValueNorm state.

Usage:
  python -m mat_dcml_tpu_torch.export_policy \\
      --model_dir results/DCML/AS/mat/check/models --out exports/dcml_as_mat \\
      [--step N] [model flags matching the run, e.g. --n_embd 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from mat_dcml_tpu_torch.config import parse_cli_with_extras
from mat_dcml_tpu_torch.device import resolve_device
from mat_dcml_tpu_torch.envs.dcml.env import DCMLEnv, DCMLEnvConfig
from mat_dcml_tpu_torch.training.checkpoint import export_policy
from mat_dcml_tpu_torch.training.runner import restore_mat_policy


def main(argv=None) -> int:
    extras = argparse.ArgumentParser(add_help=False)
    extras.add_argument("--out", required=True, help="export directory")
    extras.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    run, _, ns = parse_cli_with_extras(argv, extras=extras)
    if not run.model_dir:
        print("--model_dir is required (the run's models/ directory)", file=sys.stderr)
        return 2
    device = resolve_device(run.device)
    env = DCMLEnv(DCMLEnvConfig(), device=device)
    try:
        policy, step = restore_mat_policy(run, env, run.model_dir, ns.step, device=device)
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
