"""The DCML evaluation protocol of the PyTorch port against the JAX package,
on the CPU: the preset fixtures and sweep settings, the ``preset``,
``fixed`` and ``fixed_upload_retry`` env modes, ``act_stride``,
``DCMLRunner.evaluate``'s record, the preset-replay sweep and the random
baseline.

Both sides get the same inputs: weights transplanted with ``bridge.py``
(redrawn at O(1) scale, so near-ties are rare), env draws replayed from the
JAX key chain (``tests/torch_port_helpers.py``), the random baseline's
Gumbel and uniform draws replayed from its key.

Tolerances.  Fixture arrays equal.  Env: integers (availability, done, the
episode cursor) equal, obs atol 1e-6, delay, payment and reward rtol 1e-6,
as ``tests/test_torch_env.py`` (f32 in the same order, sums over workers in
another).  ``act_stride``: log-probs and values atol 1e-5 (f32 summation
order), actions equal except past a top-2 margin below 1e-5.  The sweep's
per-step reward, completion time and payment rtol 1e-5: a few steps of the
env on the actions of the stride decode, whose differences above compound.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmark_dcml
from mat_dcml_tpu.config import RunConfig as JaxRunConfig
from mat_dcml_tpu.envs.dcml.constants import DCMLConsts as JaxConsts
from mat_dcml_tpu.envs.dcml.env import DCMLEnv as JaxEnv
from mat_dcml_tpu.envs.dcml.env import DCMLEnvConfig as JaxEnvConfig
from mat_dcml_tpu.envs.dcml.preset import load_sample as jax_load_sample
from mat_dcml_tpu.envs.dcml.preset import modify_preset as jax_modify_preset
from mat_dcml_tpu.models.policy import TransformerPolicy as JaxPolicy
from mat_dcml_tpu.training.ppo import PPOConfig as JaxPPOConfig
from mat_dcml_tpu.training.random_baseline import RandomPolicy as JaxRandomPolicy
from mat_dcml_tpu.training.runner import DCMLRunner as JaxDCMLRunner
from mat_dcml_tpu.training.runner import build_dcml_components
from mat_dcml_tpu_torch import train_mujoco
from mat_dcml_tpu_torch.bridge import params_from_jax
from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.envs.dcml import env as tenv
from mat_dcml_tpu_torch.envs.dcml import preset as tpreset
from mat_dcml_tpu_torch.envs.dcml.constants import DCMLConsts
from mat_dcml_tpu_torch.models.policy import TransformerPolicy
from mat_dcml_tpu_torch.sweep_dcml import SWEEPS, make_sweep_run
from mat_dcml_tpu_torch.training.ppo import PPOConfig
from mat_dcml_tpu_torch.training.random_baseline import RandomPolicy
from mat_dcml_tpu_torch.training.runner import DCMLRunner
from tests.torch_port_helpers import (
    SMALL,
    assert_decodes_agree,
    configs,
    inputs,
    jax_params,
    jax_reset_draws,
    jax_step_draws,
    one_torch_thread,  # noqa: F401
    reference_logits,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "data" / "dcml_benchmark"
E = 4
STEPS = 3
RTOL = 1e-6
OBS_ATOL = 1e-6
ATOL = 1e-5
SWEEP_RTOL = 1e-5
# the full DCML width at a small trunk: the env fixes 101 agents
DCML_SMALL = dict(SMALL, n_agent=101, n_block=1)


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_load_sample_and_modify_preset_match_jax(sweep):
    base = tpreset.load_sample(BENCH, 1)
    jbase = jax_load_sample(BENCH, 1)
    for a, b in ((base.master, jbase.master), (base.worker_prs, jbase.worker_prs),
                 (base.disable_rates, jbase.disable_rates)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert set(SWEEPS) == set(benchmark_dcml.SWEEPS)
    for i in range(11):
        setting = SWEEPS[sweep](i)
        assert setting == benchmark_dcml.SWEEPS[sweep](i)
        mine, ref = tpreset.modify_preset(base, **setting), jax_modify_preset(jbase, **setting)
        np.testing.assert_array_equal(mine.master, ref.master)
        np.testing.assert_array_equal(mine.worker_prs, ref.worker_prs)
        np.testing.assert_array_equal(mine.disable_rates, ref.disable_rates)


def test_save_preset_round_trip(tmp_path):
    data = tpreset.generate_preset_data(np.random.default_rng(0), 5, disable_rate=7)
    tpreset.save_preset(data, tmp_path, prefix="Sample_9")
    back = tpreset.load_sample(tmp_path, 9)
    np.testing.assert_array_equal(back.master, data.master)
    np.testing.assert_array_equal(back.worker_prs, data.worker_prs)
    np.testing.assert_array_equal(back.disable_rates, data.disable_rates)
    assert back.n_episodes == 5 and (back.disable_rates == 7).all()


def _compare(ts, jts):
    np.testing.assert_array_equal(ts.available_actions.numpy(), np.asarray(jts.available_actions))
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(jts.obs), atol=OBS_ATOL, rtol=0)
    np.testing.assert_allclose(ts.share_obs.numpy(), np.asarray(jts.share_obs), atol=OBS_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(jts.done))
    np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward), rtol=RTOL)
    np.testing.assert_allclose(ts.delay.numpy(), np.asarray(jts.delay), rtol=RTOL)
    np.testing.assert_allclose(ts.payment.numpy(), np.asarray(jts.payment), rtol=RTOL, atol=1e-6)


MODES = {
    "preset": dict(preset=True),
    "fixed": dict(fixed=True),
    "fixed_upload_retry": dict(fixed_upload_retry=True),
    "preset_fixed": dict(preset=True, fixed=True, fixed_upload_retry=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_env_modes_match_jax(mode):
    """Reset and steps of each mode under replayed draws; the preset cursor
    starts at 0, mid-fixture, at its last row and one past it (wrap)."""
    flags = MODES[mode]
    consts = DCMLConsts()
    jenv = JaxEnv(JaxEnvConfig(**flags), data_dir=ROOT / "data")
    env = tenv.DCMLEnv(tenv.DCMLEnvConfig(**flags), device="cpu")
    keys = jax.random.split(jax.random.key(7), E)
    idx = np.array([0, 17, 1000, 1001])
    jstate, jts = jax.vmap(jenv.reset)(keys, jnp.asarray(idx, jnp.int32))
    state, ts = env.reset(jax_reset_draws(keys, consts), torch.from_numpy(idx))
    _compare(ts, jts)
    np.testing.assert_array_equal(state.episode_idx.numpy(), np.asarray(jstate.episode_idx))
    np.testing.assert_array_equal(state.disable_rate.numpy(), np.asarray(jstate.disable_rate))
    np.testing.assert_array_equal(state.r_rows.numpy(), np.asarray(jstate.r_rows))
    rng = np.random.default_rng(3)
    jstep = jax.jit(jax.vmap(jenv.step))
    for _ in range(STEPS):
        sel = (rng.uniform(size=(E, 100)) < 0.5).astype(np.float32)
        act = np.concatenate([sel, rng.uniform(size=(E, 1)).astype(np.float32)], 1)[..., None]
        nxt, draws = jax_step_draws(jstate.rng, consts,
                                    fixed_upload_retry=flags.get("fixed_upload_retry", False))
        jstate, jts = jstep(jstate, jnp.asarray(act))
        np.testing.assert_array_equal(jax.random.key_data(nxt), jax.random.key_data(jstate.rng))
        state, ts = env.step(state, None if flags.get("fixed") else torch.from_numpy(act), draws)
        _compare(ts, jts)
        np.testing.assert_array_equal(state.episode_idx.numpy(), np.asarray(jstate.episode_idx))
        np.testing.assert_array_equal(state.worker_prs.numpy(), np.asarray(jstate.worker_prs))


def test_shannon_still_raises():
    with pytest.raises(NotImplementedError, match="item 5"):
        tenv.DCMLEnvConfig(shannon_enable=True)


def _policies(shape):
    jcfg, tcfg = configs(shape)
    params = jax_params(jcfg)
    policy = TransformerPolicy(tcfg, device="cpu")
    policy.model.load_state_dict(params_from_jax(params))
    return jcfg, params, JaxPolicy(jcfg), policy


@pytest.mark.parametrize("stride", [2, 10])
def test_act_stride_matches_jax(stride):
    jcfg, params, jpolicy, policy = _policies(SMALL)
    state, obs, avail = inputs(jcfg, 4)
    ref = jpolicy.act_stride(params, state, obs, avail, stride=stride)
    with torch.no_grad():
        out = policy.act_stride(*(torch.from_numpy(x) for x in (state, obs, avail)),
                                stride=stride)
    np.testing.assert_allclose(out.value.numpy(), np.asarray(ref.value), atol=ATOL)
    logits = reference_logits(jcfg, params, state, obs, avail, ref.action, None)
    assert_decodes_agree(out.action.numpy(), out.log_prob.numpy(), ref.action, ref.log_prob,
                         logits, jcfg.n_discrete_agents, ATOL)


def _tiny_run(tmp_path, **kw):
    run = RunConfig(device="cpu", n_rollout_threads=2, episode_length=4, n_embd=16, n_block=1,
                    run_dir=str(tmp_path), **kw)
    return run, PPOConfig(ppo_epoch=1, num_mini_batch=2)


@pytest.fixture(scope="module")
def jax_eval_record():
    """JAX ``DCMLRunner.evaluate``'s record, from its own method on the JAX
    runner's parts, on 10 workers (the record's keys do not depend on the
    width, and the narrow env compiles in seconds) with the stride decode."""
    jrun = JaxRunConfig(n_rollout_threads=2, episode_length=4, n_embd=16, n_block=1)
    jenv = JaxEnv(JaxEnvConfig(consts=JaxConsts(worker_number_max=10, sob_dim=12)),
                  data_dir=ROOT / "data")
    jpolicy, _, jcollector, _ = build_dcml_components(jrun, JaxPPOConfig(), jenv)
    fake = SimpleNamespace(run_cfg=jrun, collector=jcollector, is_mat=True, policy=jpolicy)
    jstate = SimpleNamespace(params=jpolicy.init_params(jax.random.key(0)))
    return JaxDCMLRunner.evaluate(fake, jstate, n_steps=3, stride=10)


@pytest.mark.parametrize("stride", [None, 10], ids=["policy_decode", "stride"])
def test_evaluate_record_keys_match_jax(tmp_path, jax_eval_record, stride):
    """The port's ``DCMLRunner.evaluate`` record, with the policy's decode
    and with the stride decode, has JAX's keys and finite values."""
    run, ppo = _tiny_run(tmp_path)
    runner = DCMLRunner(run, ppo, log_fn=lambda *_: None)
    info = runner.evaluate(n_steps=3, stride=stride)
    assert set(info) == set(jax_eval_record)
    assert all(np.isfinite(v) for v in info.values())
    assert info["eval_inference_sec_per_call"] > 0


def test_sweep_steps_match_jax():
    """A few steps of the sweep (stride 10, one SWEEPS setting on Sample_1)
    against ``benchmark_dcml.make_sweep_run`` on the same weights, with the
    env draws replayed from the JAX key."""
    n_steps, seed = 3, 1
    consts = DCMLConsts()
    jcfg, params, jpolicy, policy = _policies(DCML_SMALL)
    jenv = JaxEnv(JaxEnvConfig(preset=True), data_dir=ROOT / "data")
    data = jax_modify_preset(jax_load_sample(BENCH, 1), **SWEEPS["disable_rate"](3))
    jrun = benchmark_dcml.make_sweep_run(jenv, jpolicy, n_steps, 10)
    key = jax.random.key(seed)
    ref = jrun(params, key, jnp.asarray(data.master, jnp.float32),
               jnp.asarray(data.worker_prs, jnp.float32),
               jnp.asarray(data.disable_rates, jnp.int32))

    reset_draws = jax_reset_draws(key[None], consts)
    rngs = jenv.reset(key, 0)[0].rng[None]
    step_draws = []
    for _ in range(n_steps):
        rngs, d = jax_step_draws(rngs, consts)
        step_draws.append(d)
    env = tenv.DCMLEnv(tenv.DCMLEnvConfig(preset=True), device="cpu")
    mine = make_sweep_run(env, policy, n_steps, 10)(tpreset.modify_preset(
        tpreset.load_sample(BENCH, 1), **SWEEPS["disable_rate"](3)),
        draws=(reset_draws, step_draws))
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=SWEEP_RTOL)


def test_random_baseline_matches_jax():
    """The random baseline's actions on the uniforms JAX draws from its key:
    equal, and every one valid (an available worker action, a tail in
    [0, 1))."""
    B, A, adim = 3, 101, 2
    state, obs, avail = inputs(SimpleNamespace(n_agent=A, state_dim=102, obs_dim=7,
                                               action_dim=adim), B, seed=5)
    key = jax.random.key(9)
    ref = JaxRandomPolicy(A, adim).get_actions({}, key, state, obs, avail)
    k_disc, k_cont = jax.random.split(key)
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(k_disc, (B, A, adim))))
    uniform = torch.from_numpy(np.array(jax.random.uniform(k_cont, (B, A))))
    out = RandomPolicy(A, adim, device="cpu").get_actions(
        torch.from_numpy(state), torch.from_numpy(obs), torch.from_numpy(avail),
        gumbel=gumbel, tail_noise=uniform)
    np.testing.assert_array_equal(out.action.numpy(), np.asarray(ref.action))
    act = out.action.numpy()[..., 0]
    picked = np.take_along_axis(avail[:, :-1], act[:, :-1, None].astype(int), -1)
    assert (picked == 1).all()
    assert ((act[:, -1] >= 0) & (act[:, -1] < 1)).all()
    assert not out.value.any() and not out.log_prob.any()


def test_random_runner_trains_and_saves_nothing(tmp_path):
    run, ppo = _tiny_run(tmp_path, algorithm_name="random", save_interval=1, log_interval=1,
                         num_env_steps=16)
    runner = DCMLRunner(run, ppo, log_fn=lambda *_: None)
    runner.train_loop()
    assert [r["episode"] for r in runner.records] == [0, 1]
    assert runner.ckpt.all_steps() == []
    with pytest.raises(NotImplementedError, match="item 9"):   # recurrent: not ported yet
        DCMLRunner(RunConfig(device="cpu", algorithm_name="rmappo"), ppo)


@pytest.mark.parametrize("flags", [["--algorithm_name", "random"], ["--use_eval", "true"]],
                         ids=["random", "use_eval"])
def test_train_mujoco_rejects_what_only_dcml_has(tmp_path, flags):
    """The random baseline and evaluation are DCML's: MuJoCo's entry point
    rejects both before it trains."""
    with pytest.raises(NotImplementedError):
        train_mujoco.main(["--device", "cpu", "--run_dir", str(tmp_path), *flags])
    assert not (tmp_path / "mujoco").exists()
