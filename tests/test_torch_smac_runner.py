"""The port's SMAC runners, checkpoints, export and entry points on the CPU.

- ``SMACMultiRunner`` trains two episodes on (2m, 3m) round-robin and
  evaluates a held-out map, as JAX's ``test_multi_map_runner_trains`` does;
  ``make_multi_map_runner`` routes a same-shape roster (8m, 3s5z) to an
  error naming ROADMAP item 10 unless ``random_order`` is on; ``model_dir``
  restores the weights alone (few-shot transfer).
- A SMAC run (3m, ``random_order`` on, so the carry holds the permutation
  wrapper's state) stopped by SIGTERM after its second episode and resumed
  equals the uninterrupted 3-episode run bit for bit: weights, Adam, the
  ValueNorm, the generator and the records (``tests/test_torch_resume.py``'s
  contract).
- The export of a SMAC run (``export_policy --map_name``) and of a
  multi-map run (``--translated``): the manifest equal to the one JAX's
  ``export_policy`` writes for the same weights and config, field by field;
  ``DecodeEngine.from_export`` serves it with per-request availability masks
  from the env, ``cached`` and ``scan``, bit for bit the in-memory weights'
  decode, every served action available.
- ``train_smac`` and ``train_smac_multi`` on ``--device cpu`` for a short
  run; without ``--device`` they ask for CUDA; ``--backend sc2`` exits with
  JAX's message.
"""

import json
import math
import os
import signal

import numpy as np
import pytest
import torch

from mat_dcml_tpu.config import RunConfig as JaxRunConfig
from mat_dcml_tpu.envs.smac import SMACLiteConfig as JaxSMACConfig
from mat_dcml_tpu.envs.smac import SMACLiteEnv as JaxSMACEnv
from mat_dcml_tpu.envs.smac import TranslatedSMACEnv as JaxTranslated
from mat_dcml_tpu.training import checkpoint as jckpt
from mat_dcml_tpu.training.generic_runner import build_discrete_policy
from mat_dcml_tpu_torch import export_policy as export_cli
from mat_dcml_tpu_torch import train_smac, train_smac_multi
from mat_dcml_tpu_torch.bridge import params_to_jax
from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.envs.smac import smaclite
from mat_dcml_tpu_torch.serving.engine import DecodeEngine, EngineConfig
from mat_dcml_tpu_torch.training import checkpoint as ckpt
from mat_dcml_tpu_torch.training.ppo import PPOConfig
from mat_dcml_tpu_torch.training.resilience import EXIT_PREEMPTED
from mat_dcml_tpu_torch.training.smac_runner import (
    SMACMultiRunner,
    SMACRunner,
    make_multi_map_runner,
)
from tests.torch_port_helpers import assert_states_equal, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CLOCK_KEYS = ("fps", "step_time_collect", "step_time_train")
QUIET = dict(log_fn=lambda *_: None)


def _multi_run(tmp_path, **kw):
    kw = {"algorithm_name": "mat", "save_interval": 1000, **kw}
    return RunConfig(device="cpu", env_name="SMACMulti", scenario="multi", n_rollout_threads=4,
                     episode_length=20, n_embd=32, n_block=1, run_dir=str(tmp_path),
                     log_interval=1, **kw)


def test_multi_map_runner_trains(tmp_path):
    runner = SMACMultiRunner(_multi_run(tmp_path), PPOConfig(ppo_epoch=2, num_mini_batch=1),
                             train_maps=("2m", "3m"), **QUIET)
    state, rss = runner.train_loop(num_episodes=2)
    assert state.update_step == 2 and set(rss) == {"2m", "3m"}
    assert [r["map"] for r in runner.records] == ["2m", "3m"]
    assert all(math.isfinite(v) for r in runner.records for v in r.values()
               if not isinstance(v, str))
    evals = runner.evaluate(maps=("2m", "8m"), n_episodes=4)
    assert set(evals) == {"eval_win_rate_2m", "eval_win_rate_8m"}


def test_same_shape_roster_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 10"):
        make_multi_map_runner(_multi_run(tmp_path), PPOConfig(), ("8m", "3s5z"), **QUIET)
    # per-episode shuffling takes the host-cycled runner, as in JAX
    runner = make_multi_map_runner(_multi_run(tmp_path), PPOConfig(), ("8m", "3s5z"),
                                   random_order=True, **QUIET)
    assert isinstance(runner, SMACMultiRunner)
    # the recipe's roster is heterogeneous
    assert isinstance(make_multi_map_runner(_multi_run(tmp_path), PPOConfig(), ("2m", "3m"),
                                            **QUIET), SMACMultiRunner)


def test_few_shot_restore_takes_the_weights_alone(tmp_path):
    ppo = PPOConfig(ppo_epoch=1, num_mini_batch=1)
    first = SMACMultiRunner(_multi_run(tmp_path / "a"), ppo, ("2m", "3m"), **QUIET)
    first.train_loop(num_episodes=1)
    weights = {k: v.clone() for k, v in first.policy.model.state_dict().items()}
    second = SMACMultiRunner(_multi_run(tmp_path / "b", model_dir=str(first.ckpt.directory),
                                        seed=9), ppo, ("3m", "8m"), **QUIET)
    state, _ = second.setup()
    for k, v in second.policy.model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    assert state.update_step == 0 and not state.optimizer.state


def test_unsupported_algorithm_raises(tmp_path):
    run = RunConfig(device="cpu", algorithm_name="mappo", run_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 9"):
        SMACRunner(run, PPOConfig(), **QUIET)


# ----------------------------------------------------------------- resume

E, T = 2, 8


def _runner(run_dir, episodes=3, log_fn=lambda *_: None, **kw):
    run = RunConfig(device="cpu", env_name="StarCraft2", scenario="3m", n_rollout_threads=E,
                    episode_length=T, n_embd=16, n_block=1, num_env_steps=episodes * T * E,
                    log_interval=1, save_interval=1, run_dir=str(run_dir), **kw)
    return SMACRunner(run, PPOConfig(ppo_epoch=1, num_mini_batch=2, lr=1e-3),
                      smaclite.SMACLiteConfig(map_name="3m"), random_order=True, log_fn=log_fn)


def _records(runner):
    return [{k: v for k, v in r.items() if k not in CLOCK_KEYS} for r in runner.records]


def _final(runner, state):
    return {**runner.trainer.state_dict(state), "generator": runner.generator.get_state()}


def test_stop_and_resume_equals_uninterrupted_run(tmp_path):
    ref = _runner(tmp_path / "a")
    ref_state, ref_rollout = ref.train_loop()

    def stop_after_1(msg):
        if msg.startswith("ep 1 "):
            os.kill(os.getpid(), signal.SIGTERM)

    first = _runner(tmp_path / "b", log_fn=stop_after_1)
    previous = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        first.train_loop()
    assert exc.value.code == EXIT_PREEMPTED
    assert signal.getsignal(signal.SIGTERM) is previous
    resumed = _runner(tmp_path / "b", resume="auto")
    state, rollout = resumed.setup()
    assert resumed.start_episode == 2
    state, rollout = resumed.train_loop(train_state=state, rollout_state=rollout)
    assert_states_equal(_final(resumed, state), _final(ref, ref_state))
    assert torch.equal(rollout.env_states.perm, ref_rollout.env_states.perm)
    assert torch.equal(rollout.env_states.inner.ally_pos, ref_rollout.env_states.inner.ally_pos)
    assert _records(first)[:2] + _records(resumed) == _records(ref)


# ------------------------------------------------------------ export, serving

def _jax_manifest(tmp_path, runner, jax_env, space_meta):
    """The manifest JAX's ``export_policy`` writes for the same weights, the
    config JAX's ``build_discrete_policy`` makes from the same run flags and
    env, and the same space metadata."""
    run = runner.run_cfg
    jrun = JaxRunConfig(algorithm_name=run.algorithm_name, n_embd=run.n_embd,
                        n_block=run.n_block, n_head=run.n_head)
    jcfg = build_discrete_policy(jrun, jax_env).cfg
    params = params_to_jax({k: v.cpu() for k, v in runner.policy.model.state_dict().items()})
    jckpt.export_policy(tmp_path / "jax_export", params, jcfg, space_meta)
    return jckpt.read_manifest(tmp_path / "jax_export")


@pytest.mark.parametrize("variant", ["3m", "translated_2m"])
def test_export_serves_with_live_masks(tmp_path, variant):
    translated = variant.startswith("translated")
    if translated:
        runner = SMACMultiRunner(_multi_run(tmp_path, algorithm_name="mat_dec"),
                                 PPOConfig(ppo_epoch=1, num_mini_batch=1), ("2m",), **QUIET)
        runner.train_loop(num_episodes=1)
        flags = ["--map_name", "2m", "--translated", "--algorithm_name", "mat_dec"]
    else:
        runner = _runner(tmp_path / "run", episodes=1)
        runner.train_loop()
        flags = ["--map_name", "3m"]
    out = tmp_path / "export"
    assert export_cli.main(["--device", "cpu", "--n_embd", str(runner.run_cfg.n_embd),
                            "--n_block", "1", "--model_dir", str(runner.ckpt.directory),
                            "--out", str(out), *flags]) == 0
    pm = ckpt.read_manifest(out)
    env = runner.env
    assert pm["space_meta"]["n_agents"] == env.n_agents
    assert pm["space_meta"]["action_dim"] == env.action_dim
    jax_env = (JaxTranslated(JaxSMACConfig(map_name="2m")) if translated
               else JaxSMACEnv(JaxSMACConfig(map_name="3m")))
    assert (pm["space_meta"]["obs_dim"], pm["space_meta"]["share_obs_dim"]) == (
        jax_env.obs_dim, jax_env.share_obs_dim)
    jm = _jax_manifest(tmp_path, runner, jax_env, pm["space_meta"])
    assert jm.keys() == pm.keys() and jm["space_meta"] == pm["space_meta"]
    for k in jm["mat_config"].keys() & pm["mat_config"].keys():
        assert pm["mat_config"][k] == jm["mat_config"][k], k

    g = torch.Generator().manual_seed(3)
    _, ts = env.reset(env.draw_reset(8, g))
    state, obs, avail = (x.numpy().copy() for x in (ts.share_obs, ts.obs, ts.available_actions))
    for mode in ("cached", "scan"):
        ecfg = EngineConfig(buckets=(1, 8), decode_mode=mode)
        eng = DecodeEngine.from_export(out, ecfg, device="cpu", **QUIET)
        live = DecodeEngine(runner.policy.model.state_dict(), runner.policy.cfg, ecfg,
                            device="cpu", **QUIET)
        a, lp = eng.decode(state, obs, avail)
        b, lq = live.decode(state, obs, avail)
        assert np.array_equal(a, b) and np.array_equal(lp, lq), mode
        picked = np.take_along_axis(avail, a.astype(int), -1)
        assert (picked == 1).all(), mode


# ----------------------------------------------------------------- the CLIs

def test_train_smac_runs_on_the_cpu(tmp_path):
    info = train_smac.main(["--device", "cpu", "--map_name", "3m", "--num_env_steps", "40",
                            "--n_rollout_threads", "2", "--episode_length", "10",
                            "--n_embd", "16", "--n_block", "1", "--ppo_epoch", "1",
                            "--num_mini_batch", "1", "--log_interval", "1",
                            "--eval_episodes", "2", "--decode_mode", "scan",
                            "--run_dir", str(tmp_path)])
    path = tmp_path / "StarCraft2" / "3m" / "mat" / "check" / "metrics.jsonl"
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(records) == 2
    assert info["eval_episodes"] >= 2 and 0.0 <= info["eval_win_rate"] <= 1.0


def test_train_smac_multi_runs_on_the_cpu(tmp_path):
    info = train_smac_multi.main(["--device", "cpu", "--train_maps", "2m,3m",
                                  "--eval_maps", "2m,8m", "--random_order",
                                  "--num_env_steps", "40", "--n_rollout_threads", "2",
                                  "--episode_length", "10", "--n_embd", "16", "--n_block", "1",
                                  "--ppo_epoch", "1", "--num_mini_batch", "1",
                                  "--log_interval", "1", "--eval_episodes", "2",
                                  "--run_dir", str(tmp_path)])
    path = tmp_path / "StarCraft2Multi" / "multi" / "mat" / "check" / "metrics.jsonl"
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["map"] for r in records] == ["2m", "3m"]
    assert set(info) == {"eval_win_rate_2m", "eval_win_rate_8m"}


@pytest.mark.parametrize("cli", [train_smac, train_smac_multi], ids=["smac", "smac_multi"])
def test_entry_points_ask_for_cuda_by_default(cli, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--run_dir", str(tmp_path)])


def test_train_smac_defaults_and_sc2_backend():
    run, ppo, ns = train_smac.parse([])
    assert (run.env_name, run.scenario, run.episode_length, run.device) == (
        "StarCraft2", "3m", 60, "cuda")
    with pytest.raises(SystemExit, match="external smac package"):
        train_smac.parse(["--backend", "sc2"])
    run, _, train_maps, eval_maps, ns = train_smac_multi.parse([])
    assert (run.env_name, run.scenario, train_maps, eval_maps, ns.random_order,
            ns.eval_episodes) == ("StarCraft2Multi", "multi", ["3m", "8m"], ["3m", "8m"], False,
                                  32)
