"""Checkpoints of the full training state, and weights-only policy export.

Port of ``mat_dcml_tpu/training/checkpoint.py``.  A step holds the trainer's
whole state (``MATTrainer.state_dict``: the model's ``state_dict``, Adam's
``state_dict`` with its step counts, the ValueNorm's tensors, the update
count), written with ``torch.save`` as ``<dir>/<step>/state.pt`` and read back
with ``torch.load(weights_only=True, map_location=device)``; the caller loads
it *into* the live model and optimizer (``MATTrainer.load_state_dict``), so
Adam's parameter references stay the model's own.

- **async saves**: ``save(..., blocking=False)`` (the default) copies the
  state into host memory on the caller's thread, then writes on a
  background thread and returns.  The copy comes first because Adam updates
  the weights in place: a write that held the live tensors would save a
  later step's weights.  At most one save is in flight; the next save,
  :meth:`CheckpointManager.finish`, :meth:`CheckpointManager.close` and every
  restore wait for it.  A step directory appears (by one rename) only
  once its payload is complete.
- **integrity manifests**: each finalized step gets a CRC32-per-file manifest
  ``<dir>/integrity/<step>.json``.  :meth:`CheckpointManager.restore_latest_valid`
  walks the steps newest first, quarantines any step whose files are
  missing, truncated or changed (or that does not deserialize) into
  ``<dir>/quarantine/``, and restores the newest step that checks out.
- **weights-only export**: :func:`export_policy` / :func:`load_policy` write
  and read a model ``state_dict`` and a JSON manifest (the ``MATConfig``
  fields, the obs/act space metadata and a generation counter) in the JAX
  package's manifest layout, so a server restores a policy without
  optimizer or ValueNorm state and without importing a trainer.

Checkpoint IO is retried on ``OSError`` with :func:`backoff_delay`.  The
JAX package's chaos hooks are not ported (ROADMAP.md queue 1, item 13).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from mat_dcml_tpu_torch.models.mat import MATConfig
from mat_dcml_tpu_torch.training.resilience import backoff_delay, to_host

POLICY_MANIFEST = "policy_manifest.json"
POLICY_FORMAT = "mat_dcml_tpu_torch/policy/v1"
_PARAMS_FILE = "params.pt"
_STATE_FILE = "state.pt"

INTEGRITY_FORMAT = "mat_dcml_tpu_torch/ckpt-integrity/v1"
IO_RETRIES = 3              # retries of a failing checkpoint read or write
IO_BACKOFF_BASE_MS = 50.0   # backoff_delay's base
_INTEGRITY_SUBDIR = "integrity"
_QUARANTINE_SUBDIR = "quarantine"


def _crc32_file(path: Path, chunk: int = 1 << 20) -> int:
    crc = 0
    with path.open("rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _write_durable(path: Path, obj) -> None:
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


class CheckpointIOError(RuntimeError):
    """Checkpoint IO kept failing after the retry budget."""


class CheckpointManager:
    """Numbered checkpoint steps under ``directory``, ``max_to_keep`` newest
    kept; restores put tensors on ``device`` (the CPU by default).

    ``last_blocking_s`` is what the caller of the last :meth:`save` waited
    for: the previous write, if still running, and the host copy."""

    def __init__(self, directory, max_to_keep: int = 5, log=print, device=None,
                 sleep: Callable[[float], None] = time.sleep,
                 rand: Callable[[], float] = random.random):
        self.directory = Path(directory).absolute()   # made by the first save
        self.max_to_keep = int(max_to_keep)
        self.log = log
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self._sleep = sleep
        self._rand = rand
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.last_blocking_s = 0.0

    def _io_retry(self, op_name: str, fn: Callable[[], Any]) -> Any:
        """Run one IO op, retrying ``OSError`` ``IO_RETRIES`` times with
        jittered backoff; exhaustion raises :class:`CheckpointIOError`.
        Anything else propagates untouched."""
        attempt = 0
        while True:
            try:
                return fn()
            except OSError as e:
                attempt += 1
                if attempt > IO_RETRIES:
                    raise CheckpointIOError(
                        f"checkpoint {op_name} failed {attempt} times (last: {e!r})") from e
                delay = backoff_delay(attempt, IO_BACKOFF_BASE_MS, rand=self._rand)
                self.log(f"[checkpoint] {op_name} attempt {attempt} failed ({e!r}); "
                         f"retrying in {delay * 1e3:.0f}ms")
                self._sleep(delay)

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: Dict[str, Any], blocking: bool = False) -> None:
        """Checkpoint ``state`` (nested dicts of tensors and plain values) at
        ``step``.  The host copy is taken before this returns; the write
        runs on a background thread unless ``blocking``."""
        t0 = time.perf_counter()
        self.finish()
        snapshot = to_host(state)
        self.last_blocking_s = time.perf_counter() - t0
        self._thread = threading.Thread(target=self._write_step, args=(int(step), snapshot),
                                        name=f"checkpoint-{int(step)}", daemon=True)
        self._thread.start()
        if blocking:
            self.finish()

    def _write_step(self, step: int, snapshot) -> None:
        try:
            tmp = self.directory / f".{step}.tmp"

            def write():
                shutil.rmtree(tmp, ignore_errors=True)
                tmp.mkdir(parents=True)
                _write_durable(tmp / _STATE_FILE, snapshot)

            self._io_retry("save", write)
            final = self._step_dir(step)
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._io_retry("integrity", lambda: self._write_integrity(step))
            self._prune()
        except Exception as e:    # surfaced by finish() on the caller's thread
            self._error = e

    def finish(self) -> None:
        """Wait for the save in flight, if any; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        """Wait for the save in flight (the manager holds nothing else)."""
        self.finish()

    def _prune(self) -> None:
        steps = self.all_steps()
        for step in steps[:-self.max_to_keep] if self.max_to_keep > 0 else ():
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            self._integrity_path(step).unlink(missing_ok=True)

    # --------------------------------------------------------------- restore

    def all_steps(self):
        """Finalized steps on disk, ascending."""
        if not self.directory.is_dir():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        """The newest finalized step (None when there is none)."""
        self.finish()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, step: int):
        return torch.load(self._step_dir(step) / _STATE_FILE, weights_only=True,
                          map_location=self.device)

    def restore(self, step: Optional[int] = None):
        """The state saved at ``step`` (default the newest), or None when
        there is no step."""
        self.finish()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return self._io_retry("restore", lambda: self._load(step))

    # ------------------------------------------------------------ integrity

    def _step_dir(self, step: int) -> Path:
        return self.directory / str(int(step))

    def _integrity_path(self, step: int) -> Path:
        return self.directory / _INTEGRITY_SUBDIR / f"{int(step)}.json"

    def _write_integrity(self, step: int) -> None:
        step_dir = self._step_dir(step)
        files = {}
        for path in sorted(step_dir.rglob("*")):
            if path.is_file():
                rel = path.relative_to(step_dir).as_posix()
                files[rel] = {"size": path.stat().st_size, "crc32": _crc32_file(path)}
        manifest = {"format": INTEGRITY_FORMAT, "step": int(step), "files": files}
        ipath = self._integrity_path(step)
        ipath.parent.mkdir(parents=True, exist_ok=True)
        tmp = ipath.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(manifest, indent=1))
        tmp.replace(ipath)

    def verify_step(self, step: int) -> Tuple[str, str]:
        """``("ok" | "unverified" | "bad", reason)`` for one step on disk:
        "unverified" when it has no integrity manifest (restorable, not
        CRC-attested), "bad" when it contradicts its manifest."""
        step_dir = self._step_dir(step)
        if not step_dir.is_dir():
            return "bad", "step directory missing"
        ipath = self._integrity_path(step)
        if not ipath.exists():
            return "unverified", "no integrity manifest"
        try:
            manifest = json.loads(ipath.read_text())
            if manifest.get("format") != INTEGRITY_FORMAT:
                return "unverified", f"unknown manifest format {manifest.get('format')!r}"
            for rel, want in manifest["files"].items():
                path = step_dir / rel
                if not path.is_file():
                    return "bad", f"missing file {rel}"
                if path.stat().st_size != want["size"]:
                    return "bad", f"size mismatch in {rel}"
                if _crc32_file(path) != want["crc32"]:
                    return "bad", f"CRC mismatch in {rel}"
        except (OSError, json.JSONDecodeError, KeyError, TypeError) as e:
            return "unverified", f"unreadable manifest: {e!r}"
        return "ok", "verified"

    def quarantine_step(self, step: int, reason: str) -> None:
        """Move a damaged step (and its manifest) into ``<dir>/quarantine/``."""
        qdir = self.directory / _QUARANTINE_SUBDIR / f"{int(step)}.{int(time.time())}"
        qdir.parent.mkdir(parents=True, exist_ok=True)
        step_dir = self._step_dir(step)
        if step_dir.exists():
            shutil.move(str(step_dir), str(qdir))
            (qdir / "quarantine_reason.txt").write_text(reason + "\n")
        ipath = self._integrity_path(step)
        if ipath.exists():
            qdir.mkdir(exist_ok=True)
            shutil.move(str(ipath), str(qdir / ipath.name))
        self.log(f"[checkpoint] quarantined step {step} ({reason}) -> {qdir}")

    def restore_latest_valid(self):
        """``(step, state)`` for the newest step that passes its integrity
        check and loads, quarantining every damaged step on the way down;
        ``(None, None)`` when no step is usable."""
        self.finish()
        for step in reversed(self.all_steps()):
            status, reason = self.verify_step(step)
            if status == "bad":
                self.quarantine_step(step, reason)
                continue
            if status == "unverified":
                self.log(f"[checkpoint] step {step} has no integrity manifest ({reason}); "
                         "restoring unverified")
            try:
                state = self._io_retry("restore", lambda: self._load(step))
            except Exception as e:
                self.quarantine_step(step, f"unreadable: {e!r}")
                continue
            return step, state
        return None, None


# ---------------------------------------------------------------------------
# Weights-only policy export (the serving artifact)
# ---------------------------------------------------------------------------

def export_policy(directory, params: Dict[str, torch.Tensor], mat_config: MATConfig,
                  space_meta: Optional[Dict[str, Any]] = None,
                  generation: Optional[int] = None) -> Path:
    """Write a serving artifact: ``params.pt`` (the model's ``state_dict``
    on the CPU) and ``policy_manifest.json`` (every ``MATConfig`` field,
    ``space_meta``, and ``generation``).  ``generation=None`` takes ``1 +``
    the highest generation of the exports beside ``directory``."""
    directory = Path(directory).absolute()
    if generation is None:
        generation = next_generation(directory.parent)
    directory.mkdir(parents=True, exist_ok=True)
    _write_durable(directory / _PARAMS_FILE, to_host(dict(params)))
    manifest = {
        "format": POLICY_FORMAT,
        "generation": int(generation),
        "mat_config": dataclasses.asdict(mat_config),
        "space_meta": space_meta or {},
    }
    tmp = directory / (POLICY_MANIFEST + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=2))
    tmp.replace(directory / POLICY_MANIFEST)
    return directory


def read_manifest(directory) -> Dict[str, Any]:
    """An export's manifest, without reading its weights."""
    manifest_path = Path(directory).absolute() / POLICY_MANIFEST
    if not manifest_path.exists():
        raise FileNotFoundError(f"no {POLICY_MANIFEST} under {directory}")
    return json.loads(manifest_path.read_text())


def next_generation(root) -> int:
    """1 + the highest generation of any export under ``root`` (1 if none);
    a manifest without a generation counts as 0."""
    newest = latest_export(root)
    return 1 if newest is None else newest[1] + 1


def latest_export(root) -> Optional[Tuple[Path, int]]:
    """``(path, generation)`` of the export under ``root`` (``<root>/*/``)
    with the highest generation, or None.  Unreadable manifests (an export
    half written) are skipped."""
    root = Path(root).absolute()
    if not root.is_dir():
        return None
    best: Optional[Tuple[Path, int]] = None
    for manifest_path in root.glob(f"*/{POLICY_MANIFEST}"):
        try:
            generation = int(json.loads(manifest_path.read_text()).get("generation", 0))
        except (json.JSONDecodeError, OSError, TypeError, ValueError):
            continue
        if best is None or generation > best[1]:
            best = (manifest_path.parent, generation)
    return best


def load_policy(directory, device="cpu") -> Tuple[Dict[str, torch.Tensor], MATConfig,
                                                   Dict[str, Any]]:
    """``(params, MATConfig, space_meta)`` of an export, the weights on
    ``device``."""
    manifest = read_manifest(directory)
    if manifest.get("format") != POLICY_FORMAT:
        raise ValueError(f"unrecognized policy export format: {manifest.get('format')!r}")
    cfg = MATConfig(**manifest["mat_config"])
    params = torch.load(Path(directory).absolute() / _PARAMS_FILE, weights_only=True,
                        map_location=device)
    return params, cfg, manifest.get("space_meta", {})
