"""HATRPO's sequential factor at DCML's 101 agents: the JAX package and the
PyTorch port, on the CPU, from the same weights, trajectory and draws.

HAPPO and HATRPO weight each agent's surrogate by ``factor``, the product
over the agents trained before it of their policies' probability ratios on
the rollout's actions.  At 101 agents HATRPO's factor can grow by orders of
magnitude within one update; this script shows whether the JAX reference's
does the same as the port's.  It builds the JAX ``hatrpo`` components on
the full DCML env (100 workers and the master) at a cut rollout (``--envs``
x ``--steps``), collects one chunk with the JAX collector from the JAX
initialisation, runs one JAX update, then the port's update on the CPU from
the bridged weights, the converted trajectory and the replayed agent order
and row permutations, and prints one JSON line: both sides' update metrics
(``factor_mean`` is the mean over the 101 turns of the factor's mean after
each turn) and the port's factor mean after each turn.  Not collected by
pytest; run from the repo root:

    JAX_PLATFORMS=cpu python -m tests.hatrpo_factor_probe --envs 2 --steps 8 --hidden 64
"""

import argparse
import json
from pathlib import Path

import jax
import numpy as np
import torch

from mat_dcml_tpu.config import RunConfig as JaxRunConfig
from mat_dcml_tpu.envs.dcml.env import DCMLEnv as JaxEnv
from mat_dcml_tpu.envs.dcml.env import DCMLEnvConfig as JaxEnvConfig
from mat_dcml_tpu.training.mappo import Bootstrap as JaxBootstrap
from mat_dcml_tpu.training.ppo import PPOConfig as JaxPPOConfig
from mat_dcml_tpu.training.runner import build_dcml_components
from mat_dcml_tpu_torch.bridge import ac_params_from_jax
from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.envs.dcml import env as tenv
from mat_dcml_tpu_torch.training.ac_rollout import ACTrajectory
from mat_dcml_tpu_torch.training.mappo import Bootstrap
from mat_dcml_tpu_torch.training.ppo import PPOConfig
from mat_dcml_tpu_torch.training.runner import build_ac_components

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--num_mini_batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ns = ap.parse_args(argv)
    E, T = ns.envs, ns.steps
    ppo_kw = dict(num_mini_batch=ns.num_mini_batch)

    jrun = JaxRunConfig(algorithm_name="hatrpo", n_rollout_threads=E, episode_length=T,
                        n_embd=ns.hidden)
    env = JaxEnv(JaxEnvConfig(), data_dir=ROOT / "data")
    _, jtr, jcol, _ = build_dcml_components(jrun, JaxPPOConfig(**ppo_kw), env)
    params = jtr.init_params(jax.random.key(ns.seed))
    rs1, traj = jax.jit(jcol.collect)(params, jcol.init_state(jax.random.key(ns.seed + 1), E))
    key = jax.random.key(ns.seed + 2)
    jstate, jmet = jax.jit(jtr.train)(jtr.init_state(params), traj,
                                      JaxBootstrap(rs1.share_obs, rs1.critic_h, rs1.mask), key)

    run = RunConfig(algorithm_name="hatrpo", n_rollout_threads=E, episode_length=T,
                    n_embd=ns.hidden, device="cpu")
    pol, tr, _ = build_ac_components(run, PPOConfig(**ppo_kw), tenv.DCMLEnv(
        tenv.DCMLEnvConfig(), device="cpu"), device="cpu")
    pol.load_tree(ac_params_from_jax(params))
    A = pol.n_stack
    # the JAX update's draws: the agent order, then one row order an agent
    k_perm, k_train = jax.random.split(key)
    order = torch.from_numpy(np.asarray(jax.random.permutation(k_perm, A))).long()
    perms = torch.from_numpy(np.stack([[np.asarray(jax.random.permutation(k, T * E))]
                                       for k in jax.random.split(k_train, A)])).long()
    ttraj = ACTrajectory(**{k: torch.from_numpy(np.array(getattr(traj, k)))
                            for k in ACTrajectory._fields if k != "chunk_stats"}, chunk_stats={})
    boot = Bootstrap(*(torch.from_numpy(np.array(x)) for x in (rs1.share_obs, rs1.critic_h,
                                                                rs1.mask)))
    state = tr.init_state()
    data = tr.prepare(state, ttraj, boot)
    factor = torch.ones(1, T * E, 1)
    turns = []
    for j, i in enumerate(order.tolist()):
        factor, m = tr.turn(state, data, i, factor, perms[j:j + 1])
        turns.append({k: float(v) for k, v in m.items()})
    port = {k: float(np.mean([t[k] for t in turns])) for k in turns[0]}
    out = {"agents": A, "envs": E, "steps": T, "hidden": ns.hidden,
           "num_mini_batch": ns.num_mini_batch,
           "jax": {k: float(v) for k, v in jmet._asdict().items()},
           "port": port,
           "port_factor_mean_by_turn": [t["factor_mean"] for t in turns]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
