"""HAPPO's and HATRPO's agent turns replayed as CUDA graphs, on the card.

Marked ``cuda``; skips without a CUDA device (decided inside the fixture).
On the card each agent's turn replays as one captured graph
(``training/graphs.py``); here the first turns of one update, graphed,
against the same turns run eagerly from copies of the same state: the
weights, both Adam states, the ValueNorm, the factor and the turn's metrics
equal bit for bit (the same kernels in the same order).  This file imports
no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_ac_cuda.py
"""

import copy

import pytest
import torch

from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.envs.dcml.constants import DCMLConsts
from mat_dcml_tpu_torch.envs.dcml.env import DCMLEnvConfig
from mat_dcml_tpu_torch.training import graphs
from mat_dcml_tpu_torch.training.mappo import bootstrap_input
from mat_dcml_tpu_torch.training.ppo import PPOConfig
from mat_dcml_tpu_torch.training.runner import DCMLRunner

pytestmark = pytest.mark.cuda

TURNS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _turns(trainer, state, data, order, perms, T, E):
    factor = torch.ones(1, T * E, 1, device=trainer.policy.device)
    metrics = []
    for j, i in enumerate(order[:TURNS]):
        factor, m = trainer.turn(state, data, i, factor, perms[j:j + 1])
        metrics.append(m)
    torch.cuda.synchronize()
    return factor, metrics


@pytest.mark.parametrize("algo", ["happo", "hatrpo"])
def test_graphed_turns_equal_eager_turns(cuda, tmp_path, monkeypatch, algo):
    T, E = 4, 2
    run = RunConfig(algorithm_name=algo, n_rollout_threads=E, episode_length=T, n_embd=16,
                    num_env_steps=T * E, save_interval=0, run_dir=str(tmp_path))
    env = DCMLEnvConfig(consts=DCMLConsts(worker_number_max=8, sob_dim=10))
    r = DCMLRunner(run, PPOConfig(ppo_epoch=2, num_mini_batch=2, lr=1e-3),
                   log_fn=lambda *_: None, env_config=env)
    state, rollout = r.setup()
    rollout, traj = r.collector.collect(rollout, generator=r.generator)
    boot = bootstrap_input(r.collector, rollout)
    order = r.trainer.draw_order(r.generator).tolist()
    perms = r.trainer.draw_permutations(T * E, r.generator)
    eager_policy, eager_state = copy.deepcopy(r.policy), copy.deepcopy(state)
    eager = type(r.trainer)(eager_policy, r.trainer.cfg, r.trainer.n_agents)

    with monkeypatch.context() as m:       # the eager reference: no capture
        m.setattr(graphs.CapturedCall, "__call__", lambda self, *args: self.fn(*args))
        f_eager, m_eager = _turns(eager, eager_state, eager.prepare(eager_state, traj, boot),
                                  order, perms, T, E)
    f_graph, m_graph = _turns(r.trainer, state, r.trainer.prepare(state, traj, boot), order,
                              perms, T, E)
    assert len(r.trainer._graphs) == 1          # captured once, replayed every turn
    assert torch.equal(f_graph, f_eager)
    for a, b in zip(m_graph, m_eager):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(r.policy.actor_flat, eager_policy.actor_flat)
    assert torch.equal(r.policy.critic_flat, eager_policy.critic_flat)
    for x, y in zip((*state.actor_opt, *state.critic_opt, *state.value_norm),
                    (*eager_state.actor_opt, *eager_state.critic_opt, *eager_state.value_norm)):
        assert torch.equal(x, y)
