"""MAT's ``discrete`` family in the port against the JAX package, f32, on
the CPU, at SMAC widths with live availability masks.

The inputs are SMAC-lite's own: seeded battle states (dead units, units in
and out of range) observed by the port's env at the 8m widths (8 agents,
obs 80, state 168, 14 actions) and through the multi-map translation (27
agents, obs 869, state 1754, 36 actions, padded agents no-op only).  Weights
from the JAX init redrawn at O(1) scale (``tests/torch_port_helpers.py``),
carried across with ``bridge.py``.

- ``serve_decode`` in ``cached`` (one attention forward a position on the
  card), ``scan`` (one ``ar_decode`` launch with ``avail`` on the card; its
  plain twin here) and ``stride`` against JAX's, deterministic and on the
  noise replayed from JAX's key chain: values and log-probs atol 1e-5,
  actions equal except past a top-2 margin below 1e-5 (``PERF.md`` section
  6); the port's cached and scan decodes on the same noise agree likewise,
  and every action is available.  (The translated widths' decodes are held on
  the noise only: JAX's decode compiles slowly at 27 agents.)
- ``evaluate_actions`` (``parallel_act``: log-probs and entropy over logits
  masked to -1e10) against JAX's, atol 1e-5; a dead agent (no-op alone)
  reads log-prob 0 and entropy 0 on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.models.policy import TransformerPolicy as JaxPolicy
from mat_dcml_tpu_torch.envs.smac import smaclite, translation
from mat_dcml_tpu_torch.models.decode import serve_decode
from mat_dcml_tpu_torch.models.policy import TransformerPolicy
from tests.torch_port_helpers import (
    configs,
    jax_params,
    one_torch_thread,  # noqa: F401
    replay_noise,
    serve_decode_vs_jax,
    torch_model,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-5
SHAPES = {
    "8m": dict(n_agent=8, obs_dim=80, state_dim=168, action_dim=14, n_block=2, n_embd=16,
               n_head=2, action_type="discrete"),
    "translated_2s3z": dict(n_agent=27, obs_dim=869, state_dim=1754, action_dim=36, n_block=1,
                            n_embd=16, n_head=2, action_type="discrete"),
}


def smac_inputs(name, batch, seed=0):
    """``(state, obs, avail)`` numpy of ``batch`` seeded battle states on
    the map of ``name``: units in and out of range, a fifth of them dead."""
    translated = name.startswith("translated")
    cfg = smaclite.SMACLiteConfig(map_name=name.split("_")[-1])
    env = (translation.TranslatedSMACEnv(cfg, device="cpu") if translated
           else smaclite.SMACLiteEnv(cfg, device="cpu"))
    base = env.env if translated else env
    rng = np.random.default_rng(seed)
    A, Ne = base.n_agents, base.n_enemies

    def hp(hp0):
        h = np.floor(rng.uniform(0.2, 1.0, (batch, len(hp0))) * hp0)
        return torch.from_numpy(np.where(rng.uniform(size=h.shape) < 0.2, 0.0, h)).float()

    st = smaclite.SMACLiteState(
        ally_pos=torch.from_numpy(rng.uniform(9, 23, (batch, A, 2))).float(),
        ally_hp=hp(base.a_hp0.numpy()), ally_shield=base.a_sh0.expand(batch, -1).clone(),
        ally_cd=torch.zeros(batch, A),
        enemy_pos=torch.from_numpy(rng.uniform(9, 23, (batch, Ne, 2))).float(),
        enemy_hp=hp(base.e_hp0.numpy()), enemy_shield=base.e_sh0.expand(batch, -1).clone(),
        enemy_cd=torch.zeros(batch, Ne),
        last_actions=torch.from_numpy(rng.integers(0, base.n_actions, (batch, A))),
        t=torch.zeros(batch, dtype=torch.int64))
    st.ally_hp[0, 0] = 0.0                       # one dead agent at least
    obs, share, avail = base._observe(st)
    if translated:
        obs, share, avail = (env._translate_obs(obs), env._translate_state(share),
                             env._translate_avail(avail))
    return share.numpy().copy(), obs.numpy().copy(), avail.numpy().copy()


def _available(act, avail):
    idx = np.asarray(act)[..., 0].astype(int)
    return np.take_along_axis(np.asarray(avail), idx[..., None], -1).min() == 1.0


@functools.lru_cache(maxsize=None)
def _params(name):
    """The weights of ``SHAPES[name]``, made once a module (JAX's init is
    slow at these widths)."""
    return jax_params(configs(SHAPES[name])[0])


@pytest.mark.parametrize("name,mode,deterministic", [
    ("8m", "cached", True), ("8m", "cached", False), ("8m", "scan", True), ("8m", "scan", False),
    ("translated_2s3z", "cached", False), ("translated_2s3z", "scan", False),
])
def test_decode_matches_jax(name, mode, deterministic):
    data = smac_inputs(name, batch=4)
    res = serve_decode_vs_jax(SHAPES[name], deterministic, 4, mode, ATOL, data=data,
                              params=_params(name))
    assert _available(res.action, data[2])


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_stride_decode_matches_jax(name):
    data = smac_inputs(name, batch=3, seed=1)
    res = serve_decode_vs_jax(SHAPES[name], True, 3, "stride", ATOL, data=data,
                              params=_params(name), stride=3)
    assert _available(res.action, data[2])


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cached_and_scan_agree(name):
    """The port's two exact decodes on the same noise (on the card: the
    attention kernel a position against one ``ar_decode`` launch)."""
    jcfg, tcfg = configs(SHAPES[name])
    model = torch_model(tcfg, _params(name))
    state, obs, avail = smac_inputs(name, batch=6, seed=2)
    gumbel, _ = replay_noise(jax.random.key(3), 6, jcfg)
    out = {mode: serve_decode(model, state, obs, avail, deterministic=False, mode=mode,
                              device="cpu", gumbel=torch.from_numpy(gumbel))[1]
           for mode in ("cached", "scan")}
    assert torch.equal(out["cached"].action, out["scan"].action)
    np.testing.assert_allclose(out["scan"].log_prob.numpy(), out["cached"].log_prob.numpy(),
                               atol=ATOL)
    assert _available(out["scan"].action, avail)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_evaluate_actions_matches_jax(name):
    jcfg, tcfg = configs(SHAPES[name])
    params = _params(name)
    state, obs, avail = smac_inputs(name, batch=5, seed=3)
    rng = np.random.default_rng(4)
    act = np.array([[[rng.choice(np.flatnonzero(row))] for row in env_rows]
                    for env_rows in avail], np.float32)
    jv, jlogp, jent = JaxPolicy(jcfg, decode_mode="cached").evaluate_actions(
        params, jnp.asarray(state), jnp.asarray(obs), jnp.asarray(act), jnp.asarray(avail))
    policy = TransformerPolicy(tcfg, device="cpu")
    policy.model.load_state_dict(torch_model(tcfg, params).state_dict())
    with torch.no_grad():
        v, logp, ent = policy.evaluate_actions(*(torch.from_numpy(x) for x in (state, obs, act,
                                                                               avail)))
    for got, want, what in ((v, jv, "values"), (logp, jlogp, "log-probs"),
                            (ent, jent, "entropy")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=what)
    # a dead agent may only no-op: its log-prob and entropy are 0
    dead = (avail[..., 0] == 1) & (avail.sum(-1) == 1)
    assert dead.any()
    assert (logp.numpy()[dead] == 0).all() and (ent.numpy()[dead] == 0).all()
    assert (np.asarray(jlogp)[dead] == 0).all() and (np.asarray(jent)[dead] == 0).all()
