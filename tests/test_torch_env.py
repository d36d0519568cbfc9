"""The port's batched DCML env against ``jax.vmap`` of the JAX env, on the CPU.

Both sides get the same draws: the JAX env's own key chain is replayed into
the port's ``ResetDraws`` / ``StepDraws`` (``tests/torch_port_helpers.py``).
Actions come from numpy with a seed and include envs that select no worker
(the standalone branch) and coding ratios outside [0, 1].

Tolerances.  Integers (availability, the done flag, the obs features that
are ranks or copies of draws) must be equal.  The rest is f32 arithmetic in
the same order on both sides, except the sums over workers (the master
agent's means, the payment), which XLA and torch reduce in different orders:
obs to atol 1e-6, delay, payment and reward to rtol 1e-6 (a few ulps).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.envs.dcml.env import DCMLEnv as JaxEnv
from mat_dcml_tpu.envs.dcml.env import DCMLEnvConfig as JaxEnvConfig
from mat_dcml_tpu_torch.envs.dcml import env as tenv
from mat_dcml_tpu_torch.envs.dcml.constants import DCMLConsts
from tests.torch_port_helpers import jax_reset_draws, jax_step_draws

ROOT = Path(__file__).resolve().parent.parent
E = 6
STEPS = 4
RTOL = 1e-6
OBS_ATOL = 1e-6


@pytest.fixture(scope="module")
def envs():
    jenv = JaxEnv(JaxEnvConfig(), data_dir=ROOT / "data")
    return jenv, tenv.DCMLEnv(tenv.DCMLEnvConfig(), device="cpu")


def _actions(rng, W):
    sel = (rng.uniform(size=(E, W)) < rng.uniform(0.1, 0.9, size=(E, 1))).astype(np.float32)
    sel[0] = 0.0                      # standalone: no worker selected
    ratio = rng.uniform(-0.2, 1.2, size=(E, 1)).astype(np.float32)
    return np.concatenate([sel, ratio], axis=1)[..., None]


def _compare(ts, jts):
    np.testing.assert_array_equal(ts.available_actions.numpy(), np.asarray(jts.available_actions))
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(jts.obs), atol=OBS_ATOL, rtol=0)
    np.testing.assert_allclose(ts.share_obs.numpy(), np.asarray(jts.share_obs), atol=OBS_ATOL, rtol=0)
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(jts.done))
    np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward), rtol=RTOL)
    np.testing.assert_allclose(ts.delay.numpy(), np.asarray(jts.delay), rtol=RTOL)
    np.testing.assert_allclose(ts.payment.numpy(), np.asarray(jts.payment), rtol=RTOL, atol=1e-6)


def test_reset_matches_jax(envs):
    jenv, env = envs
    keys = jax.random.split(jax.random.key(0), E)
    jstate, jts = jax.vmap(jenv.reset)(keys, jnp.zeros(E, jnp.int32))
    state, ts = env.reset(jax_reset_draws(keys, DCMLConsts()))
    _compare(ts, jts)
    np.testing.assert_array_equal(state.unavailable.numpy(), np.asarray(jstate.unavailable))
    np.testing.assert_array_equal(state.trace.numpy(), np.asarray(jstate.trace))
    np.testing.assert_array_equal(state.r_rows.numpy(), np.asarray(jstate.r_rows))
    np.testing.assert_array_equal(state.episode_idx.numpy(), np.asarray(jstate.episode_idx))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_steps_match_jax(envs, seed):
    jenv, env = envs
    consts = DCMLConsts()
    keys = jax.random.split(jax.random.key(seed), E)
    jstate, _ = jax.vmap(jenv.reset)(keys, jnp.zeros(E, jnp.int32))
    state, _ = env.reset(jax_reset_draws(keys, consts))
    rng = np.random.default_rng(seed)
    jstep = jax.jit(jax.vmap(jenv.step))
    for _ in range(STEPS):
        act = _actions(rng, consts.worker_number_max)
        nxt, draws = jax_step_draws(jstate.rng, consts)
        jstate, jts = jstep(jstate, jnp.asarray(act))
        assert (jax.random.key_data(nxt) == jax.random.key_data(jstate.rng)).all()
        state, ts = env.step(state, torch.from_numpy(act), draws)
        _compare(ts, jts)


def test_draws_have_the_shapes_and_ranges_of_jax(envs):
    """The port's own draws (from a torch.Generator) against the replayed
    JAX draws: same shapes, dtypes and supports."""
    consts = DCMLConsts()
    _, draws = jax_step_draws(jax.random.split(jax.random.key(5), E), consts)
    mine = envs[1].draw_step(E, torch.Generator().manual_seed(0))
    for a, b in zip(jax.tree_util.tree_leaves(tuple(mine)), jax.tree_util.tree_leaves(tuple(draws))):
        assert a.shape == b.shape and a.dtype == b.dtype
    r = mine.reset
    assert int(r.disable_rate.min()) >= 1 and int(r.disable_rate.max()) <= 80
    assert int(r.r_rows.max()) < tenv.R_END and int(r.c_cols.max()) < tenv.C_END
    assert float(mine.geom_u.min()) > 0.0 and float(r.trace_noise.min()) >= 0.8
    assert tenv.R_END == round(consts.r_max * 1.1) + 1
    assert tenv.C_END == round(consts.c_max * 1.1) + 1


def test_off_recipe_flags_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tenv.DCMLEnvConfig(shannon_enable=True)
