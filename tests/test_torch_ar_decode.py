"""The port's whole decode (``mode="scan"``, ``ops/ar_decode.py``) and the
``stride`` decode against the JAX package, on the CPU.

- Packing: the port's ``pack_ar_decode_weights`` of the bridged model equals
  JAX's on its unpadded part, exactly.
- The plain twin against JAX ``fused_ar_decode(interpret=True)`` on the same
  packed inputs and noise, at ``TINY`` (interpret mode is slow): log-probs
  atol 2e-5, actions equal except past a near-tie of margin 1e-4, because the
  Pallas kernel's GELU uses a polynomial erf (error up to 1.5e-7).
- ``serve_decode(mode="scan")`` against JAX's scan decode on its XLA path at
  ``SMALL`` (atol 1e-5, summation order only) and on its Pallas path in
  interpret mode at ``TINY`` (as the plain twin above); against the port's
  cached decode on the same noise (atol 1e-5).
- ``mode="stride"`` (stride 2 and 3) against JAX's, and the policy's scan
  rollout against the JAX policy's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.models.mat import MultiAgentTransformer as JaxMAT
from mat_dcml_tpu.models.policy import TransformerPolicy as JaxPolicy
from mat_dcml_tpu.ops.pallas_decode import fused_ar_decode as jax_fused_ar_decode
from mat_dcml_tpu.ops.pallas_decode import pack_ar_decode_weights as jax_pack
from mat_dcml_tpu_torch.bridge import params_from_jax
from mat_dcml_tpu_torch.models.decode import serve_decode
from mat_dcml_tpu_torch.models.policy import TransformerPolicy
from mat_dcml_tpu_torch.ops import ar_decode as ard
from mat_dcml_tpu_torch.ops.distributions import gumbel_noise
from tests.torch_port_helpers import (
    DECODE_KEY,
    SMALL,
    TINY,
    assert_decodes_agree,
    configs,
    inputs,
    jax_params,
    reference_logits,
    replay_noise,
    serve_decode_vs_jax,
    torch_model,
)

ATOL = 1e-5
PALLAS_ATOL = 2e-5
PALLAS_MARGIN = 1e-4


def _jax_std(jcfg, params):
    return JaxMAT(jcfg).apply(params, method="action_std")


def test_pack_matches_jax():
    jcfg, tcfg = configs(SMALL)
    params = jax_params(jcfg)
    ref, adim = jax_pack(params, jcfg, _jax_std(jcfg, params))
    got = ard.pack_ar_decode_weights(torch_model(tcfg, params))
    unpad = {"embed_act": np.s_[:adim], "head_w2": np.s_[:, :adim], "head_b2": np.s_[:adim],
             "std_row": np.s_[:, :adim]}
    assert ard.ARDecodeWeights._fields == ref._fields
    for name in ref._fields:
        want = np.asarray(getattr(ref, name))[unpad.get(name, np.s_[:])]
        np.testing.assert_array_equal(getattr(got, name).numpy(), want, err_msg=name)


@pytest.mark.parametrize("masked", [True, False], ids=["avail", "avail_none"])
def test_plain_matches_jax_fused_interpret(masked):
    jcfg, tcfg = configs(TINY)
    params = jax_params(jcfg)
    B, A, adim = 3, jcfg.n_agent, jcfg.action_dim
    nd = jcfg.n_discrete_agents
    state, obs, avail = inputs(jcfg, B)
    _, rep = JaxMAT(jcfg).apply(params, state, obs, method="encode")
    rep = np.array(rep)
    rng = np.random.default_rng(3)
    gumbel = rng.gumbel(size=(B, A, adim)).astype(np.float32)
    normal = rng.normal(size=(B, A - nd, adim)).astype(np.float32)
    jw, _ = jax_pack(params, jcfg, _jax_std(jcfg, params))
    lanes = jw.embed_act.shape[0]

    def pad(x):
        return jnp.pad(x, ((0, 0), (0, 0), (0, lanes - adim)))

    ref_act, ref_logp = jax_fused_ar_decode(
        jw, rep, pad(gumbel), pad(normal), pad(avail) if masked else None,
        n_head=jcfg.n_head, adim=adim, nd=nd, interpret=True,
    )
    act, logp, scores = ard.ar_decode_plain(
        ard.pack_ar_decode_weights(torch_model(tcfg, params)), *map(torch.from_numpy, (
            rep, gumbel, normal)), torch.from_numpy(avail) if masked else None,
        n_head=tcfg.n_head, adim=adim, nd=nd, return_scores=True,
    )
    assert act.shape == logp.shape == (B, A) and scores.shape == (B, A, adim)
    assert_decodes_agree(act[..., None].numpy(), logp[..., None].numpy(),
                         np.asarray(ref_act)[..., None], np.asarray(ref_logp)[..., None],
                         scores.numpy(), nd, PALLAS_ATOL, margin=PALLAS_MARGIN)


@pytest.mark.parametrize("deterministic", [True, False], ids=["deterministic", "replayed_noise"])
def test_scan_serve_decode_matches_jax_xla(deterministic):
    res = serve_decode_vs_jax(SMALL, deterministic, 4, "scan", atol=ATOL)
    assert set(np.unique(res.action.numpy()[:, :-1])) <= {0.0, 1.0}


@pytest.mark.parametrize("deterministic", [True, False], ids=["deterministic", "replayed_noise"])
def test_scan_serve_decode_matches_jax_pallas_kernel(monkeypatch, deterministic):
    """JAX's scan decode through its whole-decode Pallas kernel (interpret
    mode on the CPU): the kernel this module ports."""
    monkeypatch.setenv("MAT_DCML_TPU_DECODE_IMPL", "pallas_interpret")
    serve_decode_vs_jax(TINY, deterministic, 2, "scan", atol=PALLAS_ATOL,
                        margin=PALLAS_MARGIN)


@pytest.mark.parametrize("deterministic", [True, False], ids=["deterministic", "replayed_noise"])
def test_scan_matches_cached_on_the_same_noise(deterministic):
    """The port's two exact decodes agree, as JAX's
    ``test_cached_bit_exact_vs_scan`` pins for the discrete families; without
    explicit noise both draw it from the generator in the same order."""
    jcfg, tcfg = configs(SMALL)
    params = jax_params(jcfg)
    model = torch_model(tcfg, params)
    state, obs, avail = inputs(jcfg, 4, seed=2)
    out = {}
    for mode in ("cached", "scan"):
        _, out[mode] = serve_decode(model, state, obs, avail, deterministic=deterministic,
                                    mode=mode, device="cpu",
                                    generator=torch.Generator().manual_seed(11))
    ref = out["cached"]
    gumbel = None
    if not deterministic:   # the generator's first draw, as both decodes took it
        gumbel = gumbel_noise((4, jcfg.n_agent, jcfg.action_dim),
                              torch.Generator().manual_seed(11), "cpu").numpy()
    logits = reference_logits(jcfg, params, state, obs, avail, ref.action.numpy(), gumbel)
    assert_decodes_agree(out["scan"].action.numpy(), out["scan"].log_prob.numpy(),
                         ref.action.numpy(), ref.log_prob.numpy(), logits,
                         jcfg.n_discrete_agents, ATOL)


@pytest.mark.parametrize("stride", [2, 3])
def test_stride_serve_decode_matches_jax(stride):
    serve_decode_vs_jax(SMALL, True, 3, "stride", atol=ATOL, stride=stride)


def test_scan_policy_get_actions_matches_jax():
    jcfg, tcfg = configs(SMALL)
    params = jax_params(jcfg)
    state, obs, avail = inputs(jcfg, 3, seed=4)
    key = jax.random.key(DECODE_KEY)
    ref = JaxPolicy(jcfg, decode_mode="scan").get_actions(params, key, state, obs, avail)
    gumbel, tail = replay_noise(key, 3, jcfg)
    policy = TransformerPolicy(tcfg, decode_mode="scan", device="cpu")
    policy.model.load_state_dict(params_from_jax(params))
    out = policy.get_actions(state, obs, avail, gumbel=torch.from_numpy(gumbel),
                             tail_noise=torch.from_numpy(tail))
    np.testing.assert_allclose(out.value.numpy(), np.asarray(ref.value), atol=ATOL)
    logits = reference_logits(jcfg, params, state, obs, avail, np.asarray(ref.action), gumbel)
    assert_decodes_agree(out.action.numpy(), out.log_prob.numpy(), ref.action, ref.log_prob,
                         logits, jcfg.n_discrete_agents, ATOL)
