"""The actor-critic family through the PyTorch port's runner and CLI, on
the CPU.

- ``DCMLRunner.evaluate``'s actor-critic branch (``ppo``: the joint view;
  ``happo``: one policy an agent) against the JAX runner's on the same
  weights and replayed env draws (the small env: 8 workers and the master,
  E = 2, 6 steps): the record's step means and episode means rtol 1e-5 (a
  few env steps on deterministic actions of f32 heads).
- ``happo``: 2 uninterrupted episodes against 1, a SIGTERM, the emergency
  checkpoint, exit 75 and ``resume="auto"`` for the 2nd, bit for bit: the
  weights, both Adam states a agent, the ValueNorms, the update count, the
  run's generator and the records (all but the wall-clock fields).
- ``train_dcml --algorithm_name {ppo,mappo,ippo,happo,hatrpo} --device
  cpu`` trains 2 episodes at DCML's 101 agents (``hatrpo``: the small
  env's 9, its turns being the costliest) with finite records; the
  recurrent names raise ``NotImplementedError`` naming ROADMAP.md's item;
  without ``--device cpu`` the CLI needs a card.
"""

import json
import math
import os
import signal
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from mat_dcml_tpu.config import RunConfig as JaxRunConfig
from mat_dcml_tpu.envs.dcml.constants import DCMLConsts as JaxConsts
from mat_dcml_tpu.envs.dcml.env import DCMLEnv as JaxEnv
from mat_dcml_tpu.envs.dcml.env import DCMLEnvConfig as JaxEnvConfig
from mat_dcml_tpu.training.ppo import PPOConfig as JaxPPOConfig
from mat_dcml_tpu.training.runner import DCMLRunner as JaxDCMLRunner
from mat_dcml_tpu.training.runner import build_dcml_components
from mat_dcml_tpu_torch import train_dcml
from mat_dcml_tpu_torch.bridge import ac_params_from_jax
from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.envs.dcml import env as tenv
from mat_dcml_tpu_torch.envs.dcml.constants import DCMLConsts
from mat_dcml_tpu_torch.training.ppo import PPOConfig
from mat_dcml_tpu_torch.training.resilience import EXIT_PREEMPTED
from mat_dcml_tpu_torch.training.runner import DCMLRunner
from tests.test_torch_ac_training import redraw
from tests.torch_port_helpers import (
    assert_states_equal,
    jax_reset_draws,
    jax_step_draws,
    one_torch_thread,  # noqa: F401
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
W, E, T = 8, 2, 4
N_STEPS = 6
CLOCK_KEYS = ("fps", "step_time_collect", "step_time_train")
SMALL_ENV = tenv.DCMLEnvConfig(consts=DCMLConsts(worker_number_max=W, sob_dim=W + 2))


def _runner(algo, run_dir, episodes=2, log_fn=lambda *_: None, **kw):
    run = RunConfig(device="cpu", algorithm_name=algo, n_rollout_threads=E, episode_length=T,
                    n_embd=16, num_env_steps=episodes * T * E, log_interval=1, save_interval=1,
                    run_dir=str(run_dir), **kw)
    return DCMLRunner(run, PPOConfig(ppo_epoch=2, num_mini_batch=2, lr=1e-3), log_fn=log_fn,
                      env_config=SMALL_ENV)


@pytest.mark.parametrize("algo", ["ppo", "happo"])
def test_evaluate_matches_jax(tmp_path, algo):
    jc, tc = JaxConsts(worker_number_max=W, sob_dim=W + 2), SMALL_ENV.consts
    jrun = JaxRunConfig(algorithm_name=algo, n_rollout_threads=E, episode_length=T, n_embd=16)
    policy, trainer, collector, is_mat = build_dcml_components(
        jrun, JaxPPOConfig(), JaxEnv(JaxEnvConfig(consts=jc), data_dir=ROOT / "data"))
    # the JAX runner's evaluate on the parts it reads (no run directory)
    jr = SimpleNamespace(run_cfg=jrun, policy=policy, collector=collector, is_mat=is_mat)
    init = trainer.init_params if hasattr(trainer, "init_params") else policy.init_params
    params = redraw(jax.eval_shape(init, jax.random.key(0)), seed=3)
    ref = JaxDCMLRunner.evaluate(jr, SimpleNamespace(params=params), n_steps=N_STEPS, seed=0)

    # the JAX evaluation's draws: the reset from key(13), then each env's chain
    rs0 = jr.collector.init_state(jax.random.key(13), E)
    _, k_reset = jax.random.split(jax.random.key(13))
    reset = jax_reset_draws(jax.random.split(k_reset, E), tc)
    steps, rng = [], rs0.env_states.rng
    for _ in range(N_STEPS):
        rng, d = jax_step_draws(rng, tc)
        steps.append(d)
    runner = _runner(algo, tmp_path / "port")
    runner.policy.load_tree(ac_params_from_jax(params))
    runner.env.draw_reset = lambda n, g=None: reset
    it = iter(steps)
    runner.env.draw_step = lambda n, g=None: next(it)
    info = runner.evaluate(n_steps=N_STEPS, seed=0)
    assert set(info) == set(ref)
    for k, v in ref.items():
        if k != "eval_inference_sec_per_call":
            np.testing.assert_allclose(info[k], v, rtol=1e-5, err_msg=k)


def _records(runner):
    return [{k: v for k, v in r.items() if k not in CLOCK_KEYS} for r in runner.records]


def _final(runner, state):
    return {**runner.trainer.state_dict(state), "generator": runner.generator.get_state()}


def test_happo_stop_and_resume_equals_uninterrupted_run(tmp_path):
    ref = _runner("happo", tmp_path / "a")
    ref_state, _ = ref.train_loop()

    def sigterm_after_0(msg):
        if msg.startswith("ep 0 "):
            os.kill(os.getpid(), signal.SIGTERM)

    first = _runner("happo", tmp_path / "b", log_fn=sigterm_after_0)
    with pytest.raises(SystemExit) as exc:
        first.train_loop()
    assert exc.value.code == EXIT_PREEMPTED
    assert first.emergency.all_steps() == [1]
    resumed = _runner("happo", tmp_path / "b", resume="auto")
    state, rollout = resumed.setup()
    assert resumed.start_episode == 1
    state, _ = resumed.train_loop(train_state=state, rollout_state=rollout)
    assert_states_equal(_final(resumed, state), _final(ref, ref_state))
    assert _records(first) + _records(resumed) == _records(ref)
    opt = state.actor_opt
    assert opt.mu.shape[0] == W + 1 and opt.count.tolist() == [8] * (W + 1)   # 2 episodes x 2 x 2


@pytest.mark.parametrize("algo", ["ppo", "mappo", "ippo", "happo", "hatrpo"])
def test_train_dcml_cli_trains(tmp_path, monkeypatch, algo):
    if algo == "hatrpo":    # 101 agents' natural-gradient turns take ~12 s: 9 agents here
        monkeypatch.setattr(DCMLRunner, "make_env",
                            lambda self: tenv.DCMLEnv(SMALL_ENV, device=self.device))
    train_dcml.main(["--device", "cpu", "--algorithm_name", algo, "--num_env_steps", "16",
                     "--n_rollout_threads", "2", "--episode_length", "4", "--n_embd", "16",
                     "--log_interval", "1", "--ppo_epoch", "1", "--num_mini_batch", "1",
                     "--save_interval", "0", "--run_dir", str(tmp_path)])
    lines = (tmp_path / "DCML" / "AS" / algo / "check" / "metrics.jsonl").read_text().splitlines()
    records = [json.loads(x) for x in lines]
    assert [r["episode"] for r in records] == [0, 1]
    assert all(math.isfinite(v) for r in records for v in r.values())
    if algo in ("happo", "hatrpo"):
        assert {"factor_mean", "kl", "accepted"} <= set(records[0])


@pytest.mark.parametrize("algo", ["rmappo", "rhappo", "rhatrpo"])
def test_recurrent_names_raise(tmp_path, algo):
    with pytest.raises(NotImplementedError, match="item 9"):
        train_dcml.main(["--device", "cpu", "--algorithm_name", algo, "--run_dir",
                         str(tmp_path)])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CLI without a card")
def test_cli_needs_a_card_without_device_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_dcml.main(["--algorithm_name", "happo", "--run_dir", str(tmp_path)])
