"""The port's checkpoints (``training/checkpoint.py``) on the CPU: exact
round trips of the whole training state, async saves that hold the state of
the moment they were called, retention, integrity and quarantine, and the
weights-only export against the JAX package's manifest and generation scan.

A small DCML runner (1 block, n_embd 16, E 2, T 4, one PPO epoch) makes the
state: one iteration, so Adam has moments and step counts and the ValueNorm
has moved.  Every comparison is bit for bit (``torch.equal``).
"""

import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.models.mat import MATConfig as JaxMATConfig
from mat_dcml_tpu.models.mat import MultiAgentTransformer as JaxMAT
from mat_dcml_tpu.training import checkpoint as jckpt
from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.models.decode import serve_decode
from mat_dcml_tpu_torch.models.mat import MATConfig, MultiAgentTransformer
from mat_dcml_tpu_torch.serving.engine import DecodeEngine, EngineConfig
from mat_dcml_tpu_torch.training import checkpoint as ckpt
from mat_dcml_tpu_torch.training.ppo import PPOConfig
from mat_dcml_tpu_torch.training.resilience import backoff_delay, pack_carry, unpack_tree
from mat_dcml_tpu_torch.training.runner import DCMLRunner
from tests.torch_port_helpers import (  # noqa: F401  (one_torch_thread: a fixture)
    TINY,
    assert_states_equal,
    inputs,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _runner(tmp_path, **kw):
    run = RunConfig(device="cpu", n_rollout_threads=2, episode_length=4, n_embd=16, n_block=1,
                    run_dir=str(tmp_path), **kw)
    return DCMLRunner(run, PPOConfig(ppo_epoch=1, num_mini_batch=2, lr=1e-3),
                      log_fn=lambda *_: None)


def _iterate(runner, state, rollout):
    state, rollout, *_ = runner.trainer.train_iteration(runner.collector, state, rollout,
                                                        generator=runner.generator)
    return state, rollout


@pytest.fixture
def trained(tmp_path):
    runner = _runner(tmp_path)
    state, rollout = _iterate(runner, *runner.setup())
    return runner, state, rollout


def test_round_trip_is_bit_exact(trained, tmp_path):
    """Save, then load into a fresh runner: the weights, Adam's moments and
    step counts, the ValueNorm and the update count are equal bit for bit,
    and Adam holds the fresh model's own parameters."""
    runner, state, _ = trained
    saved = {k: v for k, v in runner.trainer.state_dict(state).items()}
    runner.ckpt.save(0, saved, blocking=True)
    opt_state = saved["optimizer"]["state"]
    assert len(opt_state) > 0 and all(float(s["step"]) == 2 for s in opt_state.values())

    fresh = _runner(tmp_path / "fresh")
    fstate = fresh.trainer.init_state()
    fresh.trainer.load_state_dict(fstate, ckpt.CheckpointManager(runner.ckpt.directory).restore(0))
    assert_states_equal(fresh.trainer.state_dict(fstate), runner.trainer.state_dict(state))
    params = list(fresh.policy.model.parameters())
    assert all(p is q for p, q in zip(fstate.optimizer.param_groups[0]["params"], params))
    # the restored run continues as the original does
    fresh.generator.set_state(runner.generator.get_state())
    for r, st in ((fresh, fstate), (runner, state)):
        _iterate(r, st, r.collector.init_state(2, generator=torch.Generator().manual_seed(5)))
    assert_states_equal(fresh.trainer.state_dict(fstate), runner.trainer.state_dict(state))


def test_async_save_holds_the_state_from_before_the_next_update(trained, monkeypatch):
    """The write is held back until one more update has changed the weights
    in place: the checkpoint still holds the state of the save's call."""
    runner, state, rollout = trained
    release = threading.Event()
    real_write = ckpt._write_durable

    def held_write(path, obj):
        assert release.wait(600)
        real_write(path, obj)

    monkeypatch.setattr(ckpt, "_write_durable", held_write)
    before = {k: v.clone() for k, v in runner.policy.model.state_dict().items()}
    runner.ckpt.save(3, runner.trainer.state_dict(state))
    _iterate(runner, state, rollout)
    release.set()
    runner.ckpt.finish()
    restored = runner.ckpt.restore(3)
    assert restored["update_step"] == 1 and state.update_step == 2
    after = runner.policy.model.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
    for k, v in before.items():
        assert torch.equal(restored["model"][k], v), k


def _small_state(i):
    return {"w": torch.full((3,), float(i)), "step": i}


def test_max_to_keep_holds(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, max_to_keep=2)
    for step in range(5):
        mgr.save(step, _small_state(step))
    mgr.finish()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(p.name for p in (tmp_path / "integrity").iterdir()) == ["3.json", "4.json"]
    assert mgr.restore()["step"] == 4 and mgr.restore(3)["step"] == 3


def _flip_byte(path: Path, at: int = -20):
    data = bytearray(path.read_bytes())
    data[at] ^= 0xFF
    path.write_bytes(bytes(data))


def test_corrupt_newest_step_is_quarantined(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, log=lambda *_: None)
    for step in range(3):
        mgr.save(step, _small_state(step), blocking=True)
    _flip_byte(tmp_path / "2" / "state.pt")
    assert mgr.verify_step(2)[0] == "bad" and mgr.verify_step(1) == ("ok", "verified")
    step, state = mgr.restore_latest_valid()
    assert step == 1 and state["step"] == 1 and torch.equal(state["w"], torch.full((3,), 1.0))
    assert mgr.all_steps() == [0, 1]
    (quarantined,) = (tmp_path / "quarantine").iterdir()
    assert quarantined.name.startswith("2.") and (quarantined / "state.pt").exists()
    for step in (0, 1):
        _flip_byte(tmp_path / str(step) / "state.pt")
    assert mgr.restore_latest_valid() == (None, None)
    assert mgr.all_steps() == []


def test_unverified_step_restores_and_io_is_retried(tmp_path):
    """A step without a manifest restores (unverified); a failing write is
    retried with backoff, then raises the typed error."""
    mgr = ckpt.CheckpointManager(tmp_path, log=lambda *_: None, sleep=lambda s: None)
    mgr.save(0, _small_state(0), blocking=True)
    (tmp_path / "integrity" / "0.json").unlink()
    assert mgr.verify_step(0)[0] == "unverified" and mgr.restore_latest_valid()[0] == 0
    calls = []

    def failing():
        calls.append(1)
        raise OSError("disk gone")

    with pytest.raises(ckpt.CheckpointIOError, match="4 times"):
        mgr._io_retry("save", failing)
    assert len(calls) == ckpt.IO_RETRIES + 1
    assert backoff_delay(1, 50.0, rand=lambda: 0.0) == pytest.approx(0.025)
    assert backoff_delay(3, 50.0, rand=lambda: 1.0) == pytest.approx(0.3)


def test_emergency_slot_quarantines_a_corrupt_payload(trained, tmp_path):
    """The emergency carry in a one-slot manager, as the runner keeps it:
    the newest episode only, the carry back bit for bit (the rollout state
    rebuilt as its NamedTuple), and a damaged slot quarantined."""
    runner, state, rollout = trained
    slot = ckpt.CheckpointManager(tmp_path / "emergency", max_to_keep=1, log=lambda *_: None)
    for episode in (3, 4):
        slot.save(episode, pack_carry(runner.trainer.state_dict(state), rollout,
                                      runner.generator), blocking=True)
    assert slot.all_steps() == [4]
    episode, carry = slot.restore_latest_valid()
    assert episode == 4
    assert_states_equal(unpack_tree(carry["rollout_state"], rollout), rollout)
    assert_states_equal(carry["train_state"], runner.trainer.state_dict(state))
    assert torch.equal(carry["generator"], runner.generator.get_state())
    _flip_byte(tmp_path / "emergency" / "4" / "state.pt")
    assert slot.restore_latest_valid() == (None, None)
    assert [p.name.split(".")[0] for p in (tmp_path / "emergency" / "quarantine").iterdir()] \
        == ["4"]


def _tiny_cfg():
    return MATConfig(**TINY)


def test_export_then_load_gives_identical_actions(tmp_path):
    cfg = _tiny_cfg()
    model = MultiAgentTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    meta = {"env_name": "DCML", "n_agents": cfg.n_agent}
    out = ckpt.export_policy(tmp_path / "gen", model.state_dict(), cfg, meta)
    params, cfg2, meta2 = ckpt.load_policy(out)
    assert cfg2 == cfg and meta2 == meta
    loaded = MultiAgentTransformer(cfg2, device="cpu")
    loaded.load_state_dict(params)
    state, obs, avail = inputs(cfg, 5)
    with torch.no_grad():
        for mode in ("cached", "scan"):
            a = serve_decode(model, state, obs, avail, mode=mode, device="cpu")[1]
            b = serve_decode(loaded, state, obs, avail, mode=mode, device="cpu")[1]
            assert torch.equal(a.action, b.action) and torch.equal(a.log_prob, b.log_prob)
    ecfg = EngineConfig(buckets=(1, 8), decode_mode="scan")
    eng = DecodeEngine.from_export(out, ecfg, log_fn=lambda *_: None, device="cpu")
    ref = DecodeEngine(model.state_dict(), cfg, ecfg, log_fn=lambda *_: None, device="cpu")
    assert eng.space_meta == meta and ref.space_meta == {}
    batch = tuple(np.concatenate([x, x[:3]]) for x in (state, obs, avail))
    for x, y in zip(eng.decode(*batch), ref.decode(*batch)):
        np.testing.assert_array_equal(x, y)


def test_manifest_matches_jax_export(tmp_path):
    """The port's manifest against the one JAX's ``export_policy`` writes
    for the same config: same top-level keys, and every ``mat_config``
    field both configs have equal."""
    jcfg = JaxMATConfig(**TINY)
    A = jcfg.n_agent
    params = JaxMAT(jcfg).init(jax.random.key(0), jnp.zeros((1, A, jcfg.state_dim)),
                               jnp.zeros((1, A, jcfg.obs_dim)),
                               jnp.zeros((1, A, jcfg.action_input_dim)))
    meta = {"env_name": "DCML", "obs_dim": 7}
    jckpt.export_policy(tmp_path / "jax" / "a", params, jcfg, meta, generation=3)
    ckpt.export_policy(tmp_path / "port" / "a", {}, _tiny_cfg(), meta, generation=3)
    jm = jckpt.read_manifest(tmp_path / "jax" / "a")
    pm = ckpt.read_manifest(tmp_path / "port" / "a")
    assert jm.keys() == pm.keys()
    assert (pm["format"], pm["generation"], pm["space_meta"]) == (
        ckpt.POLICY_FORMAT, jm["generation"], jm["space_meta"])
    shared = jm["mat_config"].keys() & pm["mat_config"].keys()
    assert shared == pm["mat_config"].keys()
    for k in shared:
        assert pm["mat_config"][k] == jm["mat_config"][k], k


def test_jax_generation_scan_reads_port_exports(tmp_path):
    cfg = _tiny_cfg()
    root = tmp_path / "exports"
    assert ckpt.latest_export(root) is None and ckpt.next_generation(root) == 1
    for name in ("a", "b", "c"):
        ckpt.export_policy(root / name, {}, cfg)
    ckpt.export_policy(root / "old", {}, cfg, generation=0)
    (root / "torn").mkdir()
    (root / "torn" / ckpt.POLICY_MANIFEST).write_text("{not json")
    manifest = json.loads((root / "c" / ckpt.POLICY_MANIFEST).read_text())
    assert manifest["generation"] == 3
    assert ckpt.latest_export(root) == jckpt.latest_export(root) == ((root / "c").absolute(), 3)
    assert ckpt.next_generation(root) == jckpt.next_generation(root) == 4
