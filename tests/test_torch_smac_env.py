"""SMAC-lite, its multi-map translation and the agent-permutation wrapper in
the port against the JAX package, on the CPU.

- The widths of all 11 maps.
- One step from identical states (seeded numpy states with dead units,
  shields, cooldowns and invalid submissions) on 2m, 3m, 2s3z and MMM:
  obs, share_obs atol 1e-6, availability and done equal, reward rtol 1e-6,
  won and dead ratio equal, and the next state.
- A 60-step rollout on 3m (E 4, two episodes end inside it) replayed from
  JAX's key chain, the actions drawn among the available ones: every step's
  time step as above, the state equal but for positions, which drift by
  ulps (``POS_DRIFT``).  Availability,
  sight and enemy fire compare distances with ranges, and ``sqrt(x^2 + y^2)``
  may round differently on each side near a range, so the test asserts that
  no compared distance lies within 1e-5 of its threshold (the comparison
  itself is exact, not loosened).
- The translated env (3m, 2s3z): obs 869, state 1754, the padded agents
  no-op only, every step against JAX.
- The permutation wrapper over 2m and over the translated 3m: rows in the
  drawn order, actions recovered into the inner env's order, a fresh order
  where an episode ends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.envs.permute import AgentPermutationWrapper as JaxPermute
from mat_dcml_tpu.envs.smac import SMACLiteConfig as JaxSMACConfig
from mat_dcml_tpu.envs.smac import SMACLiteEnv as JaxSMACEnv
from mat_dcml_tpu.envs.smac import TranslatedSMACEnv as JaxTranslated
from mat_dcml_tpu.envs.smac.smaclite import SMACLiteState as JaxState
from mat_dcml_tpu_torch.envs import permute
from mat_dcml_tpu_torch.envs.smac import maps, smaclite, translation
from tests.torch_port_helpers import (
    jax_permutations,
    smac_next_rngs,
    smac_reset_draws,
    smac_step_draws,
)

MARGIN = 1e-5
# a free rollout's positions: XLA computes a norm as fma(y, y, x * x) and
# divides by a constant through its reciprocal, the port with separate
# rounding, so an enemy's normalised advance may differ by an ulp (1.9e-6 at
# |x| 16-32) a step; the drift stays far below MARGIN
POS_DRIFT = 2e-5
STATE_FIELDS = ("ally_pos", "ally_hp", "ally_shield", "ally_cd", "enemy_pos", "enemy_hp",
                "enemy_shield", "enemy_cd", "last_actions", "t")


def _envs(map_name, translated=False):
    if translated:
        return (JaxTranslated(JaxSMACConfig(map_name=map_name)),
                translation.TranslatedSMACEnv(smaclite.SMACLiteConfig(map_name=map_name),
                                              device="cpu"))
    return (JaxSMACEnv(JaxSMACConfig(map_name=map_name)),
            smaclite.SMACLiteEnv(smaclite.SMACLiteConfig(map_name=map_name), device="cpu"))


def _assert_margins(env, ally_pos, enemy_pos):
    """No distance that the step or the obs compares with a range lies
    within MARGIN of it (ally-enemy vs the attack ranges and the sight
    range, ally-ally vs the sight range, positions +- the move vs the map's
    edges)."""
    ap, ep = np.asarray(ally_pos, np.float64), np.asarray(enemy_pos, np.float64)
    d_ae = np.sqrt(((ap[:, :, None] - ep[:, None]) ** 2).sum(-1))
    d_aa = np.sqrt(((ap[:, :, None] - ap[:, None]) ** 2).sum(-1))
    ranges = np.unique(np.concatenate([env.a_range.numpy(), env.e_range.numpy(),
                                       [smaclite.SIGHT_RANGE]]))
    for r in ranges:
        assert np.abs(d_ae - r).min() > MARGIN, f"an ally-enemy distance within {MARGIN} of {r}"
    off = ~np.eye(ap.shape[1], dtype=bool)
    assert np.abs(d_aa[:, off] - smaclite.SIGHT_RANGE).min() > MARGIN
    m = env.cfg.move_amount
    for edge in (0.0, env.map_w):
        assert np.abs(ap + m - edge).min() > MARGIN and np.abs(ap - m - edge).min() > MARGIN


def _compare_ts(ts, jts, what, atol=1e-6):
    for name in ("obs", "share_obs"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(jts, name)),
                                   atol=atol, err_msg=f"{name} {what}")
    for name in ("available_actions", "done", "delay", "payment"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(jts, name)),
                                      err_msg=f"{name} {what}")
    np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward), rtol=1e-6, atol=0,
                               err_msg=f"reward {what}")


def _compare_state(st, jst, what, pos_atol=1e-6):
    """Every field equal but the positions, within ``pos_atol``."""
    for name in STATE_FIELDS:
        atol = pos_atol if name.endswith("_pos") else 0.0
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(jst, name)),
                                   atol=atol, rtol=0, err_msg=f"{name} {what}")


def _actions(avail, rng, invalid_share=0.0):
    """One action id per agent ``(E, A, 1)``: uniform among the available
    ones, or with probability ``invalid_share`` any in-range id."""
    E, A, n = avail.shape
    acts = np.zeros((E, A), np.int64)
    for e in range(E):
        for a in range(A):
            ids = np.flatnonzero(avail[e, a])
            if rng.uniform() < invalid_share:
                ids = np.arange(n)
            acts[e, a] = rng.choice(ids)
    return acts[..., None]


@pytest.mark.parametrize("name", sorted(maps.map_param_registry))
def test_widths_match_jax(name):
    jenv, env = _envs(name)
    got = (env.n_agents, env.n_actions, env.obs_dim, env.share_obs_dim, env.episode_limit,
           env.shield_bits, env.unit_type_bits, env.reward_norm)
    assert got == (jenv.n_agents, jenv.n_actions, jenv.obs_dim, jenv.share_obs_dim,
                   jenv.episode_limit, jenv.shield_bits, jenv.unit_type_bits, jenv._reward_norm)


WIDTHS = {"2m": (2, 8, 20, 30, 40), "3m": (3, 9, 30, 48, 60), "8m": (8, 14, 80, 168, 120),
          "2s3z": (5, 11, 80, 120, 120), "MMM": (10, 16, 160, 290, 150),
          "27m_vs_30m": (27, 36, 285, 1170, 180)}


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_widths_of_the_slice(name):
    env = smaclite.SMACLiteEnv(smaclite.SMACLiteConfig(map_name=name), device="cpu")
    assert (env.n_agents, env.n_actions, env.obs_dim, env.share_obs_dim,
            env.episode_limit) == WIDTHS[name]


def _random_states(jenv, E, seed):
    """E seeded states (numpy): units within a few sight ranges of each
    other, some dead, partial health and shields, cooldowns, last actions
    and step counts, one env a step before the limit."""
    rng = np.random.default_rng(seed)
    A, Ne = jenv.n_agents, jenv.n_enemies

    def hp(hp0, dead_share):
        h = np.floor(rng.uniform(0.2, 1.0, (E, len(hp0))) * hp0)
        return np.where(rng.uniform(size=h.shape) < dead_share, 0.0, h).astype(np.float32)

    s = dict(
        ally_pos=rng.uniform(9, 23, (E, A, 2)).astype(np.float32),
        ally_hp=hp(np.asarray(jenv.a_hp0), 0.2),
        ally_shield=np.floor(rng.uniform(0, 1, (E, A)) * np.asarray(jenv.a_sh0)).astype(
            np.float32),
        ally_cd=rng.integers(0, 3, (E, A)).astype(np.float32),
        enemy_pos=rng.uniform(9, 23, (E, Ne, 2)).astype(np.float32),
        enemy_hp=hp(np.asarray(jenv.e_hp0), 0.2),
        enemy_shield=np.floor(rng.uniform(0, 1, (E, Ne)) * np.asarray(jenv.e_sh0)).astype(
            np.float32),
        enemy_cd=rng.integers(0, 3, (E, Ne)).astype(np.float32),
        last_actions=rng.integers(0, jenv.n_actions, (E, A)).astype(np.int32),
        t=rng.integers(0, jenv.episode_limit - 1, (E,)).astype(np.int32),
    )
    s["t"][0] = jenv.episode_limit - 1
    s["enemy_hp"][1 % E, 1:] = 0.0     # env 1 one kill from a win
    return s


@pytest.mark.parametrize("name", ["2m", "3m", "2s3z", "MMM"])
def test_one_step_from_identical_states(name):
    jenv, env = _envs(name)
    E = 6
    for seed in range(3):
        s = _random_states(jenv, E, seed)
        _assert_margins(env, s["ally_pos"], s["enemy_pos"])
        keys = jax.random.split(jax.random.key(100 + seed), E)
        jst = JaxState(rng=keys, **{k: jnp.asarray(v) for k, v in s.items()})
        st = smaclite.SMACLiteState(**{k: torch.from_numpy(v).long() if v.dtype == np.int32
                                       else torch.from_numpy(v) for k, v in s.items()})
        obs, share, avail = env._observe(st)
        jobs, jshare, javail = jax.jit(jax.vmap(jenv._observe))(jst)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-6)
        np.testing.assert_allclose(share.numpy(), np.asarray(jshare), atol=1e-6)
        np.testing.assert_array_equal(avail.numpy(), np.asarray(javail))

        act = _actions(avail.numpy(), np.random.default_rng(seed), invalid_share=0.3)
        _, draws = smac_step_draws(keys, env.n_agents, env.n_enemies)
        jst2, jts = jax.jit(jax.vmap(jenv.step))(jst, jnp.asarray(act))
        st2, ts = env.step(st, torch.from_numpy(act).float(), draws)
        _compare_ts(ts, jts, f"seed {seed}")
        _compare_state(st2, jst2, f"seed {seed}")
        assert ts.done.any() and not ts.done.all()      # the limit, a win, or neither


def test_rollout_replays_jax():
    jenv, env = _envs("3m")
    E, rng = 4, np.random.default_rng(0)
    keys = jax.random.split(jax.random.key(3), E)
    jst, jts = jax.jit(jax.vmap(jenv.reset))(keys)
    _, draws = smac_reset_draws(keys, env.n_agents, env.n_enemies)
    st, ts = env.reset(draws)
    step = jax.jit(jax.vmap(jenv.step))
    rngs, ends, wins = jst.rng, 0, 0
    for t in range(60):
        _compare_ts(ts, jts, f"at step {t}")
        _compare_state(st, jst, f"at step {t}", pos_atol=POS_DRIFT)
        _assert_margins(env, jst.ally_pos, jst.enemy_pos)
        act = _actions(np.asarray(jts.available_actions), rng)
        key_next, draws = smac_step_draws(rngs, env.n_agents, env.n_enemies)
        jst, jts = step(jst, jnp.asarray(act))
        st, ts = env.step(st, torch.from_numpy(act).float(), draws)
        rngs = smac_next_rngs(rngs, key_next, np.asarray(jts.done)[:, 0])
        # the replayed key chain is the env's own
        np.testing.assert_array_equal(jax.random.key_data(rngs), jax.random.key_data(jst.rng))
        ends += int(np.asarray(jts.done)[:, 0].sum())
        wins += int(np.asarray(jts.delay).sum())
    assert ends >= 2


@pytest.mark.parametrize("name", ["3m", "2s3z"])
def test_translated_env_matches_jax(name):
    jenv, env = _envs(name, translated=True)
    assert (env.n_agents, env.action_dim, env.obs_dim, env.share_obs_dim) == (
        jenv.n_agents, jenv.action_dim, jenv.obs_dim, jenv.share_obs_dim) == (27, 36, 869, 1754)
    E, rng = 3, np.random.default_rng(1)
    inner = env.env
    keys = jax.random.split(jax.random.key(5), E)
    jst, jts = jax.jit(jax.vmap(jenv.reset))(keys)
    _, draws = smac_reset_draws(keys, inner.n_agents, inner.n_enemies)
    st, ts = env.reset(draws)
    avail = ts.available_actions.numpy()
    assert (avail[:, inner.n_agents:, 0] == 1).all() and avail[:, inner.n_agents:, 1:].sum() == 0
    assert avail[:, :, 6 + inner.n_enemies:].sum() == 0
    step = jax.jit(jax.vmap(jenv.step))
    rngs = jst.rng
    for t in range(8):
        _compare_ts(ts, jts, f"at step {t}")
        act = _actions(np.asarray(jts.available_actions), rng)
        key_next, draws = smac_step_draws(rngs, inner.n_agents, inner.n_enemies)
        jst, jts = step(jst, jnp.asarray(act))
        st, ts = env.step(st, torch.from_numpy(act).float(), draws)
        rngs = smac_next_rngs(rngs, key_next, np.asarray(jts.done)[:, 0])


def test_out_of_range_attack_is_downgraded():
    """An attack id past the map's enemies (the translated layout's padding)
    is invalid in the port: stop for a living agent (module docstring)."""
    env = translation.TranslatedSMACEnv(smaclite.SMACLiteConfig(map_name="3m"), device="cpu")
    g = torch.Generator().manual_seed(0)
    st, ts = env.reset(env.draw_reset(2, g))
    act = torch.full((2, 27, 1), 35.0)
    st2, ts2 = env.step(st, act, env.draw_step(2, g))
    assert (st2.last_actions == 1).all()
    assert torch.equal(st2.enemy_hp, st.enemy_hp)


def _perm_reset(jenv, env, keys, inner_shape):
    """The wrapper's reset on both sides: ``k_in, k_perm, k_next =
    split(key, 3)`` (``permute.py:64``)."""
    parts = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    _, inner = smac_reset_draws(parts[:, 0], *inner_shape)
    draws = permute.ResetDraws(inner, jax_permutations(parts[:, 1], env.n_agents))
    jst, jts = jax.jit(jax.vmap(jenv.reset))(keys)
    st, ts = env.reset(draws)
    return jst, jts, st, ts


@pytest.mark.parametrize("translated", [False, True], ids=["2m", "translated_3m"])
def test_permutation_wrapper_matches_jax(translated):
    name = "3m" if translated else "2m"
    jinner, inner = _envs(name, translated=translated)
    jenv, env = JaxPermute(jinner), permute.AgentPermutationWrapper(inner)
    base = inner.env if translated else inner
    shape = (base.n_agents, base.n_enemies)
    E, rng = 4, np.random.default_rng(2)
    keys = jax.random.split(jax.random.key(9), E)
    jst, jts, st, ts = _perm_reset(jenv, env, keys, shape)
    step = jax.jit(jax.vmap(jenv.step))
    redrawn = 0
    for t in range(45 if not translated else 10):
        _compare_ts(ts, jts, f"at step {t}")
        np.testing.assert_array_equal(st.perm.numpy(), np.asarray(jst.perm))
        np.testing.assert_array_equal(st.inv.numpy(), np.asarray(jst.inv))
        jinner_st = jst.inner
        _compare_state(st.inner, jinner_st, f"inner at step {t}", pos_atol=POS_DRIFT)
        _assert_margins(base, jinner_st.ally_pos, jinner_st.enemy_pos)
        act = _actions(np.asarray(jts.available_actions), rng)
        # the inner env's draws from its own key; the wrapper's fresh order
        # from k_perm of split(st.rng) (permute.py:80)
        key_next, inner_draws = smac_step_draws(jinner_st.rng, *shape)
        k_perm = jax.vmap(jax.random.split)(jst.rng)[:, 0]
        draws = permute.StepDraws(inner_draws, jax_permutations(k_perm, env.n_agents))
        old_perm = st.perm.clone()
        jst, jts = step(jst, jnp.asarray(act))
        st, ts = env.step(st, torch.from_numpy(act).float(), draws)
        # action recovery: inner agent j took outward row inv[j]'s action
        # (all actions available, so none was downgraded)
        if not translated:
            moved = torch.from_numpy(act[..., 0]).gather(1, torch.argsort(old_perm, dim=1))
            keep = ~ts.done[:, 0]
            assert torch.equal(st.inner.last_actions[keep], moved[keep])
        redrawn += int(bool(ts.done.any()) and not torch.equal(old_perm, st.perm))
    assert translated or redrawn >= 1
