"""The port's serving stack on the CPU: ContinuousBatcher -> DecodeEngine ->
serve_decode(mode="cached"), and the engine's scan and stride modes.

Padded-bucket results must equal a direct ``serve_decode`` on the same rows
exactly: the same code on the same device, so only the batch's row count
differs, and each row's arithmetic does not depend on its neighbours.
"""

import threading

import numpy as np
import pytest
import torch

from mat_dcml_tpu_torch.models.decode import serve_decode
from mat_dcml_tpu_torch.serving.batcher import BatcherConfig, ContinuousBatcher
from mat_dcml_tpu_torch.serving.engine import DecodeEngine, EngineConfig
from tests.torch_port_helpers import TINY, configs, inputs, jax_params, torch_model

BUCKETS = (1, 4)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs(TINY)
    model = torch_model(tcfg, jax_params(jcfg))
    params = model.state_dict()
    return tcfg, model, params


def _engine(tcfg, params, **kw):
    return DecodeEngine(params, tcfg, EngineConfig(buckets=BUCKETS), log_fn=lambda *_: None,
                        device="cpu", **kw)


def test_batcher_padded_buckets_match_direct_decode(setup):
    tcfg, model, params = setup
    eng = _engine(tcfg, params)
    eng.warmup()
    batcher = ContinuousBatcher(eng, BatcherConfig(max_batch_wait_ms=20.0), log_fn=lambda *_: None)
    n = 7
    state, obs, avail = inputs(tcfg, n, seed=5)
    try:
        futs = [batcher.submit(state[i], obs[i], avail[i]) for i in range(n)]
        results = [f.result(timeout=60) for f in futs]
    finally:
        batcher.close()
    _, direct = serve_decode(model, state, obs, avail, deterministic=True, device="cpu")
    for i, (act, logp) in enumerate(results):
        assert act.shape == (tcfg.n_agent, 1) and logp.shape == (tcfg.n_agent, 1)
        np.testing.assert_array_equal(act, direct.action[i].numpy())
        np.testing.assert_array_equal(logp, direct.log_prob[i].numpy())
    # every request took a bucket slot; a ragged tail rode in padded slots
    assert sum(b * c for b, c in eng.dispatch_counts.items()) >= n
    assert eng.telemetry.counters["serving_requests"] == n


@pytest.mark.parametrize("mode,stride", [("scan", 2), ("stride", 3)])
def test_engine_decode_modes_match_serve_decode(setup, mode, stride):
    """``EngineConfig.decode_mode`` and ``stride`` reach ``serve_decode``: a
    bucket dispatch equals the direct decode in that mode, exactly."""
    tcfg, model, params = setup
    eng = DecodeEngine(params, tcfg, EngineConfig(buckets=BUCKETS, decode_mode=mode,
                                                  stride=stride),
                       log_fn=lambda *_: None, device="cpu")
    state, obs, avail = inputs(tcfg, 4, seed=6)
    act, logp = eng.decode(state, obs, avail)
    _, direct = serve_decode(model, state, obs, avail, deterministic=True, mode=mode,
                             stride=stride, device="cpu")
    np.testing.assert_array_equal(act, direct.action.numpy())
    np.testing.assert_array_equal(logp, direct.log_prob.numpy())


def test_engine_rejects_non_bucket_batch(setup):
    tcfg, _, params = setup
    eng = _engine(tcfg, params)
    state, obs, avail = inputs(tcfg, 3)
    with pytest.raises(ValueError, match="not a bucket"):
        eng.decode(state, obs, avail)


def test_close_leaves_no_batcher_thread(setup):
    tcfg, _, params = setup
    batcher = ContinuousBatcher(_engine(tcfg, params), log_fn=lambda *_: None)
    batcher.close(timeout_s=5.0)
    assert not any(t.name == "serving-batcher" and t.is_alive() for t in threading.enumerate())
    state, obs, avail = inputs(tcfg, 1)
    with pytest.raises(Exception, match="closed"):
        batcher.submit(state[0], obs[0], avail[0])


def test_engine_without_device_needs_cuda(setup):
    tcfg, _, params = setup
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeEngine(params, tcfg)


def test_install_params_swaps_weights(setup):
    tcfg, model, params = setup
    eng = _engine(tcfg, params)
    state, obs, avail = inputs(tcfg, 1, seed=9)
    before = eng.decode(state, obs, avail)
    shifted = {k: v + 0.05 for k, v in params.items()}
    eng.install_params(shifted)
    after = eng.decode(state, obs, avail)
    assert not np.array_equal(before[1], after[1])
    assert eng.telemetry.counters["serving_weight_swaps"] == 1


@pytest.mark.parametrize("kw,err", [
    (dict(buckets=(4, 1)), ValueError),
    (dict(decode_mode="spec"), NotImplementedError),
    (dict(serve_dtype="f16"), ValueError),     # f32 and bf16 are the serve dtypes
])
def test_engine_config_rejects(kw, err):
    with pytest.raises(err):
        EngineConfig(**kw)


@pytest.mark.parametrize("mode", ["cached", "scan"])
@pytest.mark.parametrize("family", ["continuous", "available_continuous"])
def test_batcher_serves_continuous_families(family, mode):
    """The batcher and engine return ``(A, act_out_dim)`` actions and
    ``(A, act_prob_dim)`` log-probs per request, equal to a direct
    ``serve_decode`` of the same rows."""
    shape = dict(TINY, action_dim=4, action_type=family, semi_index=-1)
    jcfg, tcfg = configs(shape)
    model = torch_model(tcfg, jax_params(jcfg))
    eng = DecodeEngine(model.state_dict(), tcfg, EngineConfig(buckets=BUCKETS, decode_mode=mode),
                       log_fn=lambda *_: None, device="cpu")
    batcher = ContinuousBatcher(eng, BatcherConfig(max_batch_wait_ms=20.0), log_fn=lambda *_: None)
    state, obs, avail = inputs(tcfg, 3, seed=6)
    avail[..., 2:] = 1.0   # the Gaussian dims are always available
    try:
        results = [f.result(timeout=60) for f in
                   [batcher.submit(state[i], obs[i], avail[i]) for i in range(3)]]
    finally:
        batcher.close()
    _, direct = serve_decode(model, state, obs, avail, deterministic=True, mode=mode, device="cpu")
    for i, (act, logp) in enumerate(results):
        assert act.shape == (tcfg.n_agent, tcfg.act_out_dim)
        assert logp.shape == (tcfg.n_agent, tcfg.act_prob_dim)
        np.testing.assert_array_equal(act, direct.action[i].numpy())
        np.testing.assert_array_equal(logp, direct.log_prob[i].numpy())
