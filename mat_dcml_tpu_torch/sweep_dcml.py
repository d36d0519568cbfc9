"""DCML evaluation sweep: deterministic preset replay with the PyTorch port.

The port's counterpart of the repository's ``benchmark_dcml.py`` (the
reference's ``DCML_MAT_ALT_Benchmark.py``), named ``sweep`` so that no one
takes it for a performance benchmark.  It loads a trained policy, sweeps one
env factor over ``--n_iter`` settings (default: worker disable rate = i * 8),
runs ``--n_steps`` deterministic-policy steps per setting on one env
replaying a preset fixture (``Sample_<k>``) with the stride decode
(``--stride``, default 10), and writes the mean completion-time and payment
arrays to ``<out>.npy`` (two stacked ``np.save`` calls, ``(n_iter, 1)``
each, the reference's ``dcml_BMAT_*.npy`` layout) plus one JSON line a
setting to ``<out>.jsonl``.

``--model_dir`` is a run's checkpoint directory (``models/``; ``--ckpt_step``
picks a step, the model flags must match the run) or a weights-only export
(a directory holding ``policy_manifest.json``, whose config is used).
Without it the policy is random-init, from ``--seed``.  The ``dmomat``
widening of the JAX script is not ported (``n_objective`` is not).

Usage:
  python -m mat_dcml_tpu_torch.sweep_dcml --model_dir exports/dcml_as_mat \\
      --sweep disable_rate --n_steps 1000 --stride 10 --out results/bmat [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.device import resolve_device
from mat_dcml_tpu_torch.envs.dcml.env import DATA_DIR, DCMLEnv, DCMLEnvConfig
from mat_dcml_tpu_torch.envs.dcml.preset import PresetData, load_sample, modify_preset
from mat_dcml_tpu_torch.models.policy import TransformerPolicy
from mat_dcml_tpu_torch.training.checkpoint import POLICY_MANIFEST, load_policy
from mat_dcml_tpu_torch.training.runner import build_mat_policy, restore_mat_policy

# the sweeps of the benchmark script's (partly commented) variants
# (DCML_MAT_ALT_Benchmark.py:115-123): the setting of iteration i
SWEEPS = {
    "disable_rate": lambda i: dict(disable_rate=i * 8),
    "R": lambda i: dict(r=round((i + 1) * (2**20) / 10), c=2**9),
    "C": lambda i: dict(r=2**19, c=(i + 1) * (2**10) / 10),
    "Pr": lambda i: dict(r=2**19, c=2**9, pr=i * 0.1),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DCML deterministic evaluation sweep",
                                allow_abbrev=False)
    p.add_argument("--model_dir", default=None,
                   help="checkpoint directory or policy export (random-init if omitted)")
    p.add_argument("--ckpt_step", type=int, default=None, help="checkpoint step (default: latest)")
    p.add_argument("--sweep", choices=sorted(SWEEPS), default="disable_rate")
    p.add_argument("--n_iter", type=int, default=11)
    p.add_argument("--n_steps", type=int, default=1000)
    p.add_argument("--stride", type=int, default=10)
    p.add_argument("--sample", type=int, default=1, help="which Sample_<k> fixture to replay")
    p.add_argument("--data_dir", default=str(DATA_DIR))
    p.add_argument("--out", default="results/dcml_benchmark_sweep")
    p.add_argument("--seed", type=int, default=1)
    # model hyperparameters (must match a checkpoint)
    p.add_argument("--n_block", type=int, default=2)
    p.add_argument("--n_embd", type=int, default=64)
    p.add_argument("--n_head", type=int, default=2)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_sweep_policy(args, env: DCMLEnv) -> TransformerPolicy:
    """The policy the sweep replays: an export's, a checkpoint's (model
    flags from ``args``), or random-init from ``args.seed``."""
    device = env.device
    if args.model_dir and (Path(args.model_dir) / POLICY_MANIFEST).exists():
        params, cfg, _ = load_policy(args.model_dir, device=device)
        policy = TransformerPolicy(cfg, device=device)
        policy.model.load_state_dict(params)
        print(f"loaded policy export from {args.model_dir}")
        return policy
    run = RunConfig(n_block=args.n_block, n_embd=args.n_embd, n_head=args.n_head,
                    device=str(device))
    if args.model_dir:
        policy, step = restore_mat_policy(run, env, args.model_dir, args.ckpt_step,
                                          device=device)
        print(f"restored checkpoint step {step} from {args.model_dir}")
        return policy
    print("WARNING: no --model_dir, sweeping a random-init policy")
    return build_mat_policy(run, env, device=device,
                            generator=torch.Generator().manual_seed(args.seed))


def make_sweep_run(env: DCMLEnv, policy: TransformerPolicy, n_steps: int, stride: int):
    """One sweep runner reused across the settings (``benchmark_dcml.py::
    make_sweep_run``): ``run(data, generator=None, draws=None)`` replays
    ``data`` on ``env`` (one env, ``preset`` mode) from episode 0 for
    ``n_steps`` stride-decoded steps and returns ``(rewards, cts, payments)``,
    each ``(n_steps,)`` numpy.  The env's draws come from ``generator``, or
    from ``draws = (ResetDraws, [StepDraws] * n_steps)`` (a test replays the
    JAX key chain so)."""

    @torch.no_grad()
    def run(data: PresetData, generator=None, draws=None):
        env.set_preset(data)
        if draws is None:
            draws = (env.draw_reset(1, generator),
                     [env.draw_step(1, generator) for _ in range(n_steps)])
        reset_draws, step_draws = draws
        state, ts = env.reset(reset_draws, 0)
        out = []
        for t in range(n_steps):
            action = policy.act_stride(ts.share_obs, ts.obs, ts.available_actions,
                                       stride=stride).action
            state, ts = env.step(state, action, step_draws[t])
            out.append(torch.stack([ts.reward[0, 0, 0], ts.delay[0], ts.payment[0]]))
        rewards, cts, payments = torch.stack(out).cpu().numpy().T
        return rewards, cts, payments

    return run


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    base = load_sample(Path(args.data_dir) / "dcml_benchmark", sample=args.sample)
    env = DCMLEnv(DCMLEnvConfig(preset=True), data_dir=args.data_dir, device=device, preset=base)
    policy = load_sweep_policy(args, env)
    out_prefix = Path(args.out)
    out_prefix.parent.mkdir(parents=True, exist_ok=True)
    sweep_run = make_sweep_run(env, policy, args.n_steps, args.stride)
    w_cts, w_payments, records = [], [], []
    t0 = time.time()
    for i in range(args.n_iter):
        setting = SWEEPS[args.sweep](i)
        data = modify_preset(base, **setting)
        t_set = time.perf_counter()
        # the same draws for every setting, as the JAX script's one key
        rewards, cts, payments = sweep_run(
            data, generator=torch.Generator(device=device).manual_seed(args.seed))
        rec = {
            "sweep": args.sweep, "iter": i, "setting": setting,
            "reward": float(rewards.mean()), "ct": float(cts.mean()),
            "payment": float(payments.mean()), "n_steps": args.n_steps,
            "wall_s": time.perf_counter() - t_set,
        }
        records.append(rec)
        w_cts.append([rec["ct"]])
        w_payments.append([rec["payment"]])
        print(f"[{i + 1}/{args.n_iter}] {setting} -> reward {rec['reward']:.3f} "
              f"ct {rec['ct']:.4f} payment {rec['payment']:.3f} ({rec['wall_s']:.2f}s)")
    # the reference's output layout: two stacked saves, (N_ITER, 1) each
    with open(f"{out_prefix}.npy", "wb") as recorder:
        np.save(recorder, np.array(w_cts))
        np.save(recorder, np.array(w_payments))
    with open(f"{out_prefix}.jsonl", "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(f"saved {out_prefix}.npy / .jsonl in {time.time() - t0:.1f}s")
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
