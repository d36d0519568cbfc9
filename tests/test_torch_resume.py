"""Resume of the port's runner on the CPU: a run stopped by SIGTERM and
resumed from its emergency checkpoint equals the uninterrupted run bit for
bit, a regular step resumes at the next episode, and the resume modes'
edges.

Small DCML runs (1 block, n_embd 16, E 2, T 4, one PPO epoch of 2
minibatches, a checkpoint every episode).  Compared bit for bit: the
weights, Adam's moments and step counts, the ValueNorm, the update count,
the run's generator state and the metrics records (all but the wall-clock
fields ``fps`` and ``step_time_*``).
"""

import json
import os
import signal

import pytest
import torch

from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.training.ppo import PPOConfig
from mat_dcml_tpu_torch.training.resilience import EXIT_PREEMPTED, GracefulStopHandler
from mat_dcml_tpu_torch.training.runner import DCMLRunner
from tests.torch_port_helpers import assert_states_equal, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

E, T = 2, 4
CLOCK_KEYS = ("fps", "step_time_collect", "step_time_train")


def _runner(run_dir, episodes=3, log_fn=lambda *_: None, **kw):
    run = RunConfig(device="cpu", n_rollout_threads=E, episode_length=T, n_embd=16, n_block=1,
                    num_env_steps=episodes * T * E, log_interval=1, save_interval=1,
                    run_dir=str(run_dir), **kw)
    return DCMLRunner(run, PPOConfig(ppo_epoch=1, num_mini_batch=2, lr=1e-3), log_fn=log_fn)


def _records(runner):
    return [{k: v for k, v in r.items() if k not in CLOCK_KEYS} for r in runner.records]


def _final(runner, state):
    return {**runner.trainer.state_dict(state), "generator": runner.generator.get_state()}


def _sigterm_after_episode_1(msg):
    if msg.startswith("ep 1 "):
        os.kill(os.getpid(), signal.SIGTERM)


def test_stop_and_resume_equals_uninterrupted_run(tmp_path):
    """3 uninterrupted episodes against 2, a SIGTERM, an emergency
    checkpoint, exit 75, and a ``resume="auto"`` run of the last episode."""
    ref = _runner(tmp_path / "a")
    ref_state, _ = ref.train_loop()

    first = _runner(tmp_path / "b", log_fn=_sigterm_after_episode_1)
    previous = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        first.train_loop()
    assert exc.value.code == EXIT_PREEMPTED == 75
    assert first.stop.stop_requested and first.stop.reason == "SIGTERM"
    assert signal.getsignal(signal.SIGTERM) is previous          # handler uninstalled
    assert first.emergency.all_steps() == [2]
    assert first.ckpt.all_steps() == [0, 1]
    lines = [json.loads(x) for x in first.metrics_path.read_text().splitlines()]
    assert lines[-1]["emergency_checkpoint"] == "SIGTERM" and lines[-1]["episode"] == 2

    resumed = _runner(tmp_path / "b", resume="auto")
    state, _ = resumed.train_loop()
    assert resumed.start_episode == 2
    assert_states_equal(_final(resumed, state), _final(ref, ref_state))
    assert _records(first) + _records(resumed) == _records(ref)
    assert resumed.ckpt.all_steps() == [0, 1, 2]
    assert_states_equal(resumed.ckpt.restore(2), ref.ckpt.restore(2))


def test_regular_step_resumes_at_the_next_episode(tmp_path):
    """Without an emergency slot, the newest regular step S resumes at S + 1
    with its full state, and ``total_steps`` continues from there."""
    first = _runner(tmp_path / "a", episodes=2)
    state, _ = first.train_loop()
    saved = first.trainer.state_dict(state)

    resumed = _runner(tmp_path / "b", episodes=3, model_dir=str(first.ckpt.directory))
    rstate, rollout = resumed.setup()
    assert resumed.start_episode == 2
    assert_states_equal(resumed.trainer.state_dict(rstate), saved)
    resumed.train_loop(train_state=rstate, rollout_state=rollout)
    assert [r["episode"] for r in resumed.records] == [2]
    assert resumed.records[0]["total_steps"] == 3 * T * E
    assert rstate.update_step == 3


def test_corrupt_emergency_carry_falls_back_to_the_regular_step(tmp_path):
    """A damaged emergency carry is quarantined and the run resumes from the
    newest regular step, with a fresh rollout state and generator."""
    first = _runner(tmp_path, log_fn=_sigterm_after_episode_1)
    with pytest.raises(SystemExit):
        first.train_loop()
    payload = first.emergency.directory / "2" / "state.pt"
    data = bytearray(payload.read_bytes())
    data[len(data) // 2] ^= 0xFF
    payload.write_bytes(bytes(data))
    logs = []
    resumed = _runner(tmp_path, resume="auto", log_fn=logs.append)
    state, _ = resumed.setup()
    assert resumed.start_episode == 2 and state.update_step == 2
    assert resumed.emergency.all_steps() == []
    assert (resumed.emergency.directory / "quarantine").is_dir()
    assert any(m.startswith("restored checkpoint step 1 ") for m in logs)
    fresh = _runner(tmp_path / "fresh")
    fresh.setup()
    assert torch.equal(resumed.generator.get_state(), fresh.generator.get_state())


def test_auto_with_nothing_saved_starts_fresh(tmp_path):
    runner = _runner(tmp_path, resume="auto")
    state, _ = runner.setup()
    assert runner.start_episode == 0 and state.update_step == 0
    fresh = _runner(tmp_path / "fresh")
    assert_states_equal(runner.trainer.state_dict(state),
                         fresh.trainer.state_dict(fresh.setup()[0]))


def test_strict_with_nothing_saved_raises(tmp_path):
    runner = _runner(tmp_path, model_dir=str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        runner.setup()
    with pytest.raises(ValueError, match="resume"):
        _runner(tmp_path, resume="sometimes")


def test_first_signal_sets_the_flag():
    """The first SIGTERM only requests the stop; uninstall restores the
    handler that was there."""
    stop = GracefulStopHandler(log=lambda *_: None)
    previous = signal.getsignal(signal.SIGTERM)
    assert stop.install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop.stop_requested and stop.reason == "SIGTERM" and stop.latency_s() >= 0.0
    finally:
        stop.uninstall()
    assert signal.getsignal(signal.SIGTERM) is previous


def test_resume_past_the_budget_trains_nothing(tmp_path):
    first = _runner(tmp_path, episodes=2)
    first.train_loop()
    again = _runner(tmp_path, episodes=2, resume="auto")
    state, _ = again.train_loop()
    assert again.start_episode == 2 and again.records == [] and state.update_step == 2


def test_cli_takes_the_resume_flags():
    """The new run fields through the strict CLI: ``--model_dir`` (default
    None) as a path, the rest typed by their defaults."""
    from mat_dcml_tpu_torch.config import parse_cli

    run, _ = parse_cli([])
    assert (run.model_dir, run.resume, run.save_interval, run.eval_interval, run.use_eval,
            run.graceful_stop) == (None, "strict", 50, 25, False, True)
    run, _ = parse_cli(["--model_dir", "runs/x/models", "--resume", "auto", "--save_interval",
                        "3", "--use_eval", "true", "--eval_interval", "2",
                        "--graceful_stop", "false"])
    assert (run.model_dir, run.resume, run.save_interval, run.eval_interval, run.use_eval,
            run.graceful_stop) == ("runs/x/models", "auto", 3, 2, True, False)
