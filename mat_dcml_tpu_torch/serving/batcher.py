"""Host-side continuous batching over a bounded, thread-safe request queue.

Port of ``mat_dcml_tpu/serving/batcher.py`` (tracing and fault injection
are not ported yet).  Request threads :meth:`ContinuousBatcher.submit` joint
observations and wait on per-request futures; one dispatcher thread drains
the queue — waiting at most ``max_batch_wait_ms`` for stragglers once a first
request is in hand, or until the largest bucket fills — pads the batch to the
smallest fitting bucket with copies of its last row, runs the engine, and
hands each request its row.

- **admission control**: the queue is bounded (``max_queue``); an over-full
  submit fails at once with :class:`QueueFullError`.
- **deadlines**: a request that expires while queued fails with
  :class:`DeadlineExceededError` and is never dispatched.
- **graceful degradation**: if a bucket dispatch raises, the batch is retried
  one request at a time at the smallest bucket; only requests that still
  fail get :class:`EngineFailureError`.

The dispatcher is a daemon thread; :meth:`close` stops and joins it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional

import numpy as np

from mat_dcml_tpu_torch.serving.engine import DecodeEngine
from mat_dcml_tpu_torch.telemetry import Telemetry


class ServingError(Exception):
    """Base class for typed serving rejections."""


class QueueFullError(ServingError):
    """The bounded request queue is at capacity.  ``retry_after_s`` is the
    back-off hint, from the measured queue wait."""

    def __init__(self, msg: str = "queue full", retry_after_s: int = 1):
        super().__init__(msg)
        self.retry_after_s = int(retry_after_s)


class DeadlineExceededError(ServingError):
    """The request's deadline elapsed before it could be dispatched."""


class EngineFailureError(ServingError):
    """The engine failed this request even at the degraded smallest bucket."""


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    max_queue: int = 256          # bounded admission; beyond this, shed
    max_batch_wait_ms: float = 2.0  # straggler window after the first request
    default_timeout_s: Optional[float] = None  # per-request deadline default


@dataclasses.dataclass
class _Request:
    state: np.ndarray             # (A, state_dim)
    obs: np.ndarray               # (A, obs_dim)
    avail: np.ndarray             # (A, action_dim)
    deadline: Optional[float]     # absolute time.monotonic() or None
    future: Future
    enqueued_at: float


class ContinuousBatcher:
    def __init__(
        self,
        engine: DecodeEngine,
        cfg: BatcherConfig = BatcherConfig(),
        telemetry: Optional[Telemetry] = None,
        log_fn=print,
    ):
        self.engine = engine
        self.cfg = cfg
        self.telemetry = telemetry if telemetry is not None else engine.telemetry
        self.log = log_fn
        self._queue: deque[_Request] = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._ema_ms_per_req: Optional[float] = None   # service-time estimate
        self._ema_queue_wait_ms: Optional[float] = None  # Retry-After source
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="serving-batcher", daemon=True
        )
        self._thread.start()

    # ----------------------------------------------------------- client side

    def submit(
        self,
        state: np.ndarray,
        obs: np.ndarray,
        avail: Optional[np.ndarray] = None,
        timeout_s: Optional[float] = None,
    ) -> Future:
        """Enqueue one joint observation; returns a future resolving to
        ``(action (A, act_out_dim), log_prob (A, act_prob_dim))`` numpy arrays
        (the model config's widths), or raising a typed :class:`ServingError`."""
        cfg = self.engine.cfg
        state = np.asarray(state, np.float32)
        obs = np.asarray(obs, np.float32)
        if state.shape != (cfg.n_agent, cfg.state_dim):
            raise ValueError(f"state shape {state.shape} != {(cfg.n_agent, cfg.state_dim)}")
        if obs.shape != (cfg.n_agent, cfg.obs_dim):
            raise ValueError(f"obs shape {obs.shape} != {(cfg.n_agent, cfg.obs_dim)}")
        if avail is None:
            avail = np.ones((cfg.n_agent, cfg.action_dim), np.float32)
        else:
            avail = np.asarray(avail, np.float32)
            if avail.shape != (cfg.n_agent, cfg.action_dim):
                raise ValueError(
                    f"available_actions shape {avail.shape} != {(cfg.n_agent, cfg.action_dim)}"
                )
        timeout_s = timeout_s if timeout_s is not None else self.cfg.default_timeout_s
        now = time.monotonic()
        req = _Request(
            state=state, obs=obs, avail=avail,
            deadline=(now + timeout_s) if timeout_s is not None else None,
            future=Future(), enqueued_at=now,
        )
        with self._not_empty:
            if self._closed:
                raise ServingError("batcher is closed")
            if len(self._queue) >= self.cfg.max_queue:
                self.telemetry.count("serving_shed")
                raise QueueFullError(
                    f"queue at capacity ({self.cfg.max_queue}); shedding",
                    retry_after_s=self._retry_after_locked(),
                )
            self._queue.append(req)
            self.telemetry.count("serving_requests")
            self.telemetry.gauge("serving_queue_depth", float(len(self._queue)))
            self._not_empty.notify()
        return req.future

    def _retry_after_locked(self) -> int:
        """Seconds a shed client should back off, at least 1 (callers hold
        ``_lock``): the EMA of measured queue wait, or before any request was
        served, queue depth times the service-time estimate."""
        if self._ema_queue_wait_ms is not None:
            return max(1, int(self._ema_queue_wait_ms / 1e3 + 0.999))
        ms = self._ema_ms_per_req if self._ema_ms_per_req is not None else 10.0
        return max(1, int(len(self._queue) * ms / 1e3 + 0.999))

    def retry_after_s(self) -> int:
        with self._lock:
            return self._retry_after_locked()

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop and join the dispatcher; pending requests fail with
        ServingError."""
        with self._not_empty:
            if self._closed:
                return
            self._closed = True
            pending = list(self._queue)
            self._queue.clear()
            self._not_empty.notify_all()
        for req in pending:
            req.future.set_exception(ServingError("batcher closed"))
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():
            raise ServingError(f"dispatcher thread still running after {timeout_s}s")

    # ------------------------------------------------------- dispatcher side

    def _collect_batch(self):
        """Block for the first request, then linger ``max_batch_wait_ms`` (or
        until the largest bucket fills) for stragglers."""
        with self._not_empty:
            while not self._queue and not self._closed:
                self._not_empty.wait(timeout=0.1)
            if self._closed:
                return None
            deadline = time.monotonic() + self.cfg.max_batch_wait_ms / 1e3
            while len(self._queue) < self.engine.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._not_empty.wait(timeout=remaining)
                if self._closed:
                    return None
            n = min(len(self._queue), self.engine.max_batch)
            batch = [self._queue.popleft() for _ in range(n)]
            self.telemetry.gauge("serving_queue_depth", float(len(self._queue)))
            return batch

    def _dispatch_loop(self):
        while True:
            batch = self._collect_batch()
            if batch is None:
                return
            try:
                self._dispatch(batch)
            except Exception as e:  # never kill the dispatcher thread
                self.log(f"[serving] dispatcher error: {e!r}")
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(EngineFailureError(repr(e)))

    def _expire(self, batch):
        """Fail queued-past-deadline requests; return the live remainder."""
        now = time.monotonic()
        live = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                self.telemetry.count("serving_deadline_misses")
                req.future.set_exception(DeadlineExceededError(
                    f"deadline exceeded after {now - req.enqueued_at:.3f}s in queue"
                ))
            elif not req.future.done():   # a cancelled request takes no slot
                live.append(req)
        return live

    def _run_bucket(self, batch, degraded: bool = False):
        """Pad ``batch`` to its bucket, run the engine, hand out the rows.
        ``degraded`` marks the single-request retry path, counted apart."""
        n = len(batch)
        b = self.engine.bucket_for(n)
        pad = b - n
        now_mono = time.monotonic()
        waits_ms = [(now_mono - r.enqueued_at) * 1e3 for r in batch]
        state = np.stack([r.state for r in batch] + [batch[-1].state] * pad)
        obs = np.stack([r.obs for r in batch] + [batch[-1].obs] * pad)
        avail = np.stack([r.avail for r in batch] + [batch[-1].avail] * pad)
        t0 = time.perf_counter()
        action, log_prob = self.engine.decode(state, obs, avail)
        dt = time.perf_counter() - t0
        tel = self.telemetry
        with self._lock:   # the EMAs feed Retry-After, read under the same lock
            per_req = dt * 1e3 / n
            self._ema_ms_per_req = per_req if self._ema_ms_per_req is None \
                else 0.8 * self._ema_ms_per_req + 0.2 * per_req
            for w in waits_ms:
                self._ema_queue_wait_ms = w if self._ema_queue_wait_ms is None \
                    else 0.8 * self._ema_queue_wait_ms + 0.2 * w
        if degraded:
            tel.count("serving_degraded_ok", float(n))
        else:
            tel.count("serving_batches")
            tel.count(f"serving_bucket_{b}")
            tel.observe("serving_batch_fill", n / b)
            tel.observe("serving_engine_ms", dt * 1e3)
        for w in waits_ms:
            tel.hist("serving_queue_wait_ms", w)
        now = time.monotonic()
        for i, req in enumerate(batch):
            tel.observe("serving_latency_ms", (now - req.enqueued_at) * 1e3)
            if not req.future.done():
                req.future.set_result((action[i], log_prob[i]))

    def _dispatch(self, batch):
        batch = self._expire(batch)
        if not batch:
            return
        try:
            self._run_bucket(batch)
        except Exception as e:
            # retry one by one at the smallest bucket: a poisoned request
            # fails alone instead of sinking its batch
            self.telemetry.count("serving_degraded_batches")
            self.log(f"[serving] bucket dispatch failed ({e!r}); degrading to "
                     f"bucket {self.engine.min_bucket} singles")
            for req in batch:
                if req.future.done():
                    continue
                try:
                    self._run_bucket([req], degraded=True)
                except Exception as e1:
                    self.telemetry.count("serving_degraded_failed")
                    self.telemetry.count("serving_engine_failures")
                    req.future.set_exception(EngineFailureError(repr(e1)))
