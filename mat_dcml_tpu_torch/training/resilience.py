"""Preemption-safe training: graceful stop and the emergency carry.

Port of the part of ``mat_dcml_tpu/training/resilience.py`` that resume
needs:

- :func:`backoff_delay`, the jittered exponential backoff that checkpoint IO
  retries with;
- :class:`GracefulStopHandler` turns SIGTERM / SIGINT into a stop *request*
  that the training loop honours at the next episode boundary, where the
  carry is whole;
- :func:`pack_carry` is that carry: weights, Adam, the ValueNorm, the
  rollout state (env states, obs, share_obs, available actions, mask,
  episode sums) and the run's ``torch.Generator`` state.  The runner saves
  it, blocking, as step ``episode`` of a one-slot
  ``training/checkpoint.py::CheckpointManager`` beside the regular steps, so
  it has their atomic write, CRC manifest and quarantine.  Resuming from it
  re-enters the loop at the captured boundary, so a stopped run continues
  exactly as an uninterrupted one would.

The carry is saved with ``torch.save`` and read back with
``torch.load(weights_only=True)``, so it holds only tensors and plain
containers: :func:`to_host` turns NamedTuples into dicts of their fields
and :func:`unpack_tree` rebuilds them against a template of the same type.

Exit code ``EXIT_PREEMPTED`` (75, BSD EX_TEMPFAIL) tells a supervisor that
the stop was a clean preemption.  The dispatch watchdog, elastic
re-placement and the relaunch supervisor are not ported (ROADMAP.md queue 1,
items 12-13).
"""

from __future__ import annotations

import os
import random
import signal
import time
from typing import Any, Callable, Dict, Optional

import torch

EXIT_PREEMPTED = 75   # EX_TEMPFAIL: graceful stop, relaunch and resume


def backoff_delay(attempt: int, base_ms: float,
                  rand: Callable[[], float] = random.random) -> float:
    """Bounded jittered exponential backoff, in seconds:
    ``base * 2^(attempt-1) * (0.5 + rand())``, attempt counting from 1."""
    return (base_ms / 1e3) * (2 ** (attempt - 1)) * (0.5 + rand())


class PreemptedExit(SystemExit):
    """Raised by the runner after a graceful-stop emergency checkpoint; the
    process exits ``EXIT_PREEMPTED``."""

    def __init__(self, code: int = EXIT_PREEMPTED):
        super().__init__(code)


# --------------------------------------------------------------------- carry

def to_host(tree):
    """A deep copy of ``tree`` with every tensor copied into host memory
    (a fresh buffer also for a CPU tensor); NamedTuples become dicts of
    their fields, other containers keep their type, other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if hasattr(tree, "_fields"):
        return {k: to_host(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def unpack_tree(data, template):
    """Rebuild ``template``'s structure (NamedTuples of tensors, nested) from
    the dicts :func:`to_host` made of one, every tensor on the template's
    device.  A field the template has and the data lacks raises."""
    if isinstance(template, torch.Tensor):
        return data.to(template.device)
    if hasattr(template, "_fields"):
        return type(template)(*(unpack_tree(data[k], t)
                                for k, t in zip(template._fields, template)))
    return data


def pack_carry(train_state: Dict[str, Any], rollout_state,
               generator: torch.Generator) -> Dict[str, Any]:
    """The full training carry at an episode boundary: ``train_state`` as
    the trainer's ``state_dict``, the rollout state, and the generator's
    state (a CPU byte tensor, also for a CUDA generator).  Live tensors:
    ``CheckpointManager.save`` takes the host copy."""
    return {
        "train_state": train_state,
        "rollout_state": rollout_state,
        "generator": generator.get_state(),
    }


# ------------------------------------------------------------- graceful stop

class GracefulStopHandler:
    """SIGTERM / SIGINT -> a stop request the loop polls at boundaries.

    The first signal only sets a flag (and its arrival time); the second
    restores the previous handler and re-sends itself, so a repeated Ctrl-C
    or kill still ends a wedged run.  ``install`` is a no-op off the main
    thread (Python allows signal handlers only there): the loop then never
    sees a stop request."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, log=print):
        self.log = log
        self.stop_requested = False
        self.reason: Optional[str] = None
        self._requested_at: Optional[float] = None
        self._previous: Dict[int, Any] = {}
        self.installed = False

    def install(self) -> bool:
        try:
            for sig in self.SIGNALS:
                self._previous[sig] = signal.signal(sig, self._handle)
        except ValueError:       # not the main thread
            self._previous.clear()
            return False
        self.installed = True
        return True

    def uninstall(self) -> None:
        if not self.installed:
            return
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._previous.clear()
        self.installed = False

    def _handle(self, signum, frame) -> None:
        name = signal.Signals(signum).name
        if self.stop_requested:
            prev = self._previous.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            self.log(f"[resilience] second {name}: restoring default handling")
            os.kill(os.getpid(), signum)
            return
        self.stop_requested = True
        self.reason = name
        self._requested_at = time.monotonic()
        self.log(f"[resilience] {name} received: stopping at the next episode boundary "
                 "(emergency checkpoint will be taken)")

    def latency_s(self) -> float:
        """Seconds since the stop request (0 when none came)."""
        if self._requested_at is None:
            return 0.0
        return time.monotonic() - self._requested_at
