"""The port's decode step (``ops/decode_step.py``) and the continuous action
families' decodes against the JAX package, on the CPU.

- Packing: the port's ``pack_decode_weights`` of the bridged model equals
  JAX's on its unpadded part (the Pallas kernel pads the embedding to 8 rows
  and the head to 128 columns), exactly.
- One position, ``fused_decode_step`` on CPU tensors (its plain twin) against
  JAX ``fused_decode_step(..., interpret=True)``: logits and every cache
  within atol 2e-5, because the Pallas GELU uses a polynomial erf (error up
  to 1.5e-7); against JAX ``model.apply(..., method="decode_step")`` within
  atol 1e-5 (f32, summation order only).
- ``serve_decode`` in ``scan`` and ``cached`` mode for ``continuous`` and
  ``available_continuous``, deterministic and with the noise replayed from
  JAX's key chain at JAX's shapes, against JAX ``serve_decode`` on its XLA
  path (atol 1e-5) and, for ``scan``, on its Pallas path in interpret mode
  (``MAT_DCML_TPU_DECODE_IMPL=pallas_interpret``, atol 2e-5).  The one-hot of
  ``available_continuous`` must be equal, except past a position whose JAX
  top-2 score margin is below the near-tie margin (1e-5; 1e-4 against
  Pallas).
- ``parallel_act`` for both families (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.models.decode import parallel_act as jax_parallel_act
from mat_dcml_tpu.models.decode import serve_decode as jax_serve_decode
from mat_dcml_tpu.models.mat import MultiAgentTransformer as JaxMAT
from mat_dcml_tpu.ops.pallas_decode import fused_decode_step as jax_fused_decode_step
from mat_dcml_tpu.ops.pallas_decode import pack_decode_weights as jax_pack
from mat_dcml_tpu_torch.models.decode import parallel_act, serve_decode
from mat_dcml_tpu_torch.ops import decode_step as dst
from tests.torch_port_helpers import (
    DECODE_KEY,
    configs,
    jax_params,
    replay_family_noise,
    torch_model,
)

ATOL = 1e-5
PALLAS_ATOL = 2e-5
PALLAS_MARGIN = 1e-4
MARGIN = 1e-5

CONT = dict(n_agent=4, obs_dim=5, state_dim=6, action_dim=3, n_block=2, n_embd=16, n_head=2,
            action_type="continuous")
AVAIL_CONT = dict(CONT, action_dim=4, action_type="available_continuous", discrete_dim=2)
SHAPES = {"continuous": CONT, "available_continuous": AVAIL_CONT}
FAMILIES = list(SHAPES)


def _tiny(family):
    return dict(SHAPES[family], n_agent=3, n_embd=8)


def _inputs(cfg, batch, seed=1):
    """Seeded state, obs and availability; ``available_continuous`` masks
    only its one-hot dims (the first kept available), as the Gaussian dims
    are never unavailable."""
    rng = np.random.default_rng(seed)
    state = rng.normal(size=(batch, cfg.n_agent, cfg.state_dim)).astype(np.float32)
    obs = rng.normal(size=(batch, cfg.n_agent, cfg.obs_dim)).astype(np.float32)
    avail = np.ones((batch, cfg.n_agent, cfg.action_dim), np.float32)
    if cfg.action_type == "available_continuous":
        avail[..., 1:cfg.discrete_dim] = rng.uniform(
            size=(batch, cfg.n_agent, cfg.discrete_dim - 1)) > 0.3
    return state, obs, avail


def _check_decode(jcfg, params, state, obs, avail, ref, res, gumbel, atol, margin):
    """The port's decode against JAX's, row by row.  ``continuous``: actions
    and log-probs within ``atol``.  ``available_continuous``: the same up to
    the first position whose one-hot differs, which is allowed only where
    JAX's top-2 score there (masked logits plus noise, teacher-forced under
    JAX's actions) is below ``margin``."""
    act, logp = res.action.numpy(), res.log_prob.numpy()
    ref_act, ref_logp = np.asarray(ref.action), np.asarray(ref.log_prob)
    assert act.shape == ref_act.shape and logp.shape == ref_logp.shape
    if jcfg.action_type == "continuous":
        np.testing.assert_allclose(act, ref_act, atol=atol)
        np.testing.assert_allclose(logp, ref_logp, atol=atol)
        return
    dd = jcfg.discrete_dim
    np.testing.assert_array_equal(np.sort(act[..., :dd], -1)[..., -1], 1.0)   # one-hots
    scores = None
    for b in range(act.shape[0]):
        diff = np.flatnonzero((act[b, :, :dd] != ref_act[b, :, :dd]).any(-1))
        end = act.shape[1] if diff.size == 0 else int(diff[0])
        if diff.size:
            if scores is None:
                jm = JaxMAT(jcfg)
                _, rep = jm.apply(params, state, obs, method="encode")
                B, A = ref_act.shape[:2]
                sh = np.zeros((B, A, jcfg.action_input_dim), np.float32)
                sh[:, 0, 0] = 1.0
                sh[:, 1:, 1:] = ref_act[:, :-1]
                logits = np.asarray(jm.apply(params, sh, rep, obs, method="decode_full"))
                scores = np.where(avail[..., :dd] == 0, -1e10, logits[..., :dd])
                scores = scores + (0.0 if gumbel is None else gumbel)
            top2 = np.sort(scores[b, end])[-2:]
            assert top2[1] - top2[0] < margin, (
                f"row {b}: one-hot differs at position {end} with margin {top2[1] - top2[0]:.3g}")
        np.testing.assert_allclose(act[b, :end], ref_act[b, :end], atol=atol)
        np.testing.assert_allclose(logp[b, :end], ref_logp[b, :end], atol=atol)


def _serve_vs_jax(shape, mode, deterministic, batch, atol, margin):
    jcfg, tcfg = configs(shape)
    params = jax_params(jcfg)
    state, obs, avail = _inputs(jcfg, batch)
    v_ref, ref = jax_serve_decode(jcfg, params, jax.random.key(DECODE_KEY), state, obs, avail,
                                  deterministic=deterministic, mode=mode)
    gumbel = tail = None
    if not deterministic:
        gumbel, tail = replay_family_noise(jax.random.key(DECODE_KEY), batch, jcfg)
    v, res = serve_decode(
        torch_model(tcfg, params), state, obs, avail, deterministic=deterministic, mode=mode,
        device="cpu", gumbel=None if gumbel is None else torch.from_numpy(gumbel),
        tail_noise=None if tail is None else torch.from_numpy(tail),
    )
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=atol)
    _check_decode(jcfg, params, state, obs, avail, ref, res, gumbel, atol, margin)
    assert res.action.shape[-1] == tcfg.act_out_dim and res.log_prob.shape[-1] == tcfg.act_prob_dim
    return res


@pytest.mark.parametrize("family", FAMILIES)
def test_pack_matches_jax(family):
    jcfg, tcfg = configs(SHAPES[family])
    params = jax_params(jcfg)
    ref, adim = jax_pack(params, jcfg)
    got = dst.pack_decode_weights(torch_model(tcfg, params))
    in_dim = jcfg.action_input_dim
    unpad = {"embed_w": np.s_[:in_dim], "head_w2": np.s_[:, :adim], "head_b2": np.s_[:adim]}
    assert dst.DecodeStepWeights._fields == ref._fields
    for name in ref._fields:
        want = np.asarray(getattr(ref, name))[unpad.get(name, np.s_[:])]
        np.testing.assert_array_equal(getattr(got, name).numpy(), want, err_msg=name)


def _step_inputs(jcfg, B, seed=2):
    rng = np.random.default_rng(seed)
    A, D = jcfg.n_agent, jcfg.n_embd
    x_in = rng.normal(size=(B, jcfg.action_input_dim)).astype(np.float32)
    rep = rng.normal(size=(B, D)).astype(np.float32)
    caches = rng.normal(size=(4 * jcfg.n_block, A, B, D)).astype(np.float32)
    return x_in, rep, caches


def _port_step(tcfg, params, x_in, rep, caches, i):
    """The wrapper on CPU tensors (its plain twin), on a batch-major workspace."""
    work = dst.decode_caches(tcfg.n_block, tcfg.n_agent, x_in.shape[0], tcfg.n_embd, "cpu")
    work.copy_(torch.from_numpy(caches))
    logits = dst.fused_decode_step(
        dst.pack_decode_weights(torch_model(tcfg, params)), torch.from_numpy(x_in),
        torch.from_numpy(rep), work, i, n_head=tcfg.n_head, adim=tcfg.action_dim)
    return logits.numpy(), work.numpy()


@pytest.mark.parametrize("family", FAMILIES)
def test_step_matches_jax_fused_interpret(family):
    jcfg, tcfg = configs(_tiny(family))
    params = jax_params(jcfg)
    x_in, rep, caches = _step_inputs(jcfg, B=3)
    i = 1
    jw, adim = jax_pack(params, jcfg)
    ref_logits, ref_caches = jax_fused_decode_step(
        jw, jnp.asarray(x_in), jnp.asarray(rep), [jnp.asarray(c) for c in caches], jnp.int32(i),
        n_head=jcfg.n_head, adim=adim, interpret=True)
    logits, work = _port_step(tcfg, params, x_in, rep, caches, i)
    np.testing.assert_allclose(logits, np.asarray(ref_logits), atol=PALLAS_ATOL)
    np.testing.assert_allclose(work, np.stack([np.asarray(c) for c in ref_caches]),
                               atol=PALLAS_ATOL)


@pytest.mark.parametrize("i", [0, 2, 3])
@pytest.mark.parametrize("family", FAMILIES)
def test_step_matches_jax_decode_step(family, i):
    """Against the XLA twin the Pallas kernel is pinned to
    (``Decoder.decode_step``, caches ``(B, L, D)`` per block)."""
    jcfg, tcfg = configs(SHAPES[family])
    params = jax_params(jcfg)
    x_in, rep, caches = _step_inputs(jcfg, B=2)
    jc = [{k: jnp.asarray(caches[4 * b + c].transpose(1, 0, 2))
           for c, k in enumerate(("k1", "v1", "k2", "v2"))} for b in range(jcfg.n_block)]
    obs_i = jnp.zeros((2, 1, jcfg.obs_dim))
    ref_logits, ref_caches = JaxMAT(jcfg).apply(
        params, jnp.asarray(x_in)[:, None], jnp.asarray(rep)[:, None], obs_i, jc, i,
        method="decode_step")
    logits, work = _port_step(tcfg, params, x_in, rep, caches, i)
    np.testing.assert_allclose(logits, np.asarray(ref_logits)[:, 0], atol=ATOL)
    want = np.stack([np.asarray(rc[k]).transpose(1, 0, 2)
                     for rc in ref_caches for k in ("k1", "v1", "k2", "v2")])
    np.testing.assert_allclose(work, want, atol=ATOL)


@pytest.mark.parametrize("deterministic", [True, False], ids=["deterministic", "replayed_noise"])
@pytest.mark.parametrize("mode", ["scan", "cached"])
@pytest.mark.parametrize("family", FAMILIES)
def test_serve_decode_matches_jax_xla(family, mode, deterministic):
    _serve_vs_jax(SHAPES[family], mode, deterministic, batch=4, atol=ATOL, margin=MARGIN)


@pytest.mark.parametrize("deterministic", [True, False], ids=["deterministic", "replayed_noise"])
@pytest.mark.parametrize("family", FAMILIES)
def test_scan_matches_jax_pallas_kernel(monkeypatch, family, deterministic):
    """JAX's kernel configuration of this path: ``fused_decode_step`` (Pallas,
    interpret mode on the CPU) once per position."""
    monkeypatch.setenv("MAT_DCML_TPU_DECODE_IMPL", "pallas_interpret")
    _serve_vs_jax(_tiny(family), "scan", deterministic, batch=2, atol=PALLAS_ATOL,
                  margin=PALLAS_MARGIN)


@pytest.mark.parametrize("family", FAMILIES)
def test_scan_matches_cached_on_the_same_noise(family):
    jcfg, tcfg = configs(SHAPES[family])
    model = torch_model(tcfg, jax_params(jcfg))
    state, obs, avail = _inputs(jcfg, 3)
    res = {mode: serve_decode(model, state, obs, avail, deterministic=False, mode=mode,
                              device="cpu", generator=torch.Generator().manual_seed(5))[1]
           for mode in ("scan", "cached")}
    for a, b in zip(res["scan"], res["cached"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_parallel_act_matches_jax(family):
    jcfg, tcfg = configs(SHAPES[family])
    params = jax_params(jcfg)
    state, obs, avail = _inputs(jcfg, 3)
    # actions from a stochastic decode, so the Gaussian parts are off their means
    _, ref = jax_serve_decode(jcfg, params, jax.random.key(3), state, obs, avail,
                              deterministic=False, mode="cached")
    jm = JaxMAT(jcfg)
    _, rep = jm.apply(params, state, obs, method="encode")
    ref_logp, ref_ent = jax_parallel_act(jm, params, rep, obs, ref.action, avail)
    model = torch_model(tcfg, params)
    with torch.no_grad():
        _, trep = model.encode(torch.from_numpy(state), torch.from_numpy(obs))
        logp, ent = parallel_act(model, trep, torch.from_numpy(np.array(ref.action)),
                                 torch.from_numpy(avail))
    assert logp.shape[-1] == tcfg.act_prob_dim
    np.testing.assert_allclose(logp.numpy(), np.asarray(ref_logp), atol=ATOL)
    np.testing.assert_allclose(ent.numpy(), np.asarray(ref_ent), atol=ATOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(ref.log_prob), atol=ATOL)


def test_step_rejects_what_it_cannot_run():
    jcfg, tcfg = configs(CONT)
    w = dst.pack_decode_weights(torch_model(tcfg, jax_params(jcfg)))
    caches = dst.decode_caches(2, 4, 2, 16, "cpu")
    kw = dict(n_head=2, adim=3)
    with pytest.raises(ValueError, match="outside"):
        dst.fused_decode_step(w, torch.zeros(2, 3), torch.zeros(2, 16), caches, 4, **kw)
    with pytest.raises(ValueError, match="f32"):
        dst.fused_decode_step(w, torch.zeros(2, 3, dtype=torch.float64), torch.zeros(2, 16),
                              caches, 0, **kw)
    with pytest.raises(ValueError, match="embed_w"):
        dst.fused_decode_step(w, torch.zeros(2, 4), torch.zeros(2, 16), caches, 0, **kw)
    with pytest.raises(NotImplementedError, match="continuous families"):
        jcfg, tcfg = configs(dict(CONT, action_type="semi_discrete", action_dim=2))
        dst.pack_decode_weights(torch_model(tcfg, jax_params(jcfg)))
