"""Counter / gauge / histogram registry for the serving path.

A copy of the parts of ``mat_dcml_tpu/telemetry/registry.py`` that the
engine and batcher use (that module's package imports JAX, and the port
imports none of it).  Plain Python, no device work.

- **counters** are cumulative (``serving_requests``, ``serving_bucket_8``).
- **gauges** are last-value-wins samples.
- **observations** aggregate per flush: mean under the bare name plus
  ``_max`` and ``_sum``, then reset.
- **histograms** are cumulative log-spaced sketches emitting
  ``_p50/_p95/_p99/_count/_mean``.
"""

from __future__ import annotations

import math
from typing import Dict, List


class HistogramSketch:
    """Log-spaced latency histogram: bucket ``i`` covers
    ``[LO * BASE**i, LO * BASE**(i+1))``, at most ~10% relative quantile
    error.  Exact min and max are kept so a quantile never leaves the range
    actually seen."""

    LO = 1e-3      # 1 microsecond, in ms units
    BASE = 1.2
    NBUCKETS = 126  # covers ~1e-3 .. ~8.8e6 ms

    def __init__(self):
        self.buckets: List[int] = [0] * self.NBUCKETS
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _index(self, value: float) -> int:
        if value <= self.LO:
            return 0
        i = int(math.log(value / self.LO) / math.log(self.BASE))
        return min(max(i, 0), self.NBUCKETS - 1)

    def add(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v):
            return
        self.buckets[self._index(v)] += 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for i, n in enumerate(self.buckets):
            seen += n
            if seen >= target:
                # geometric midpoint of the bucket, clamped to observed range
                mid = self.LO * (self.BASE ** (i + 0.5))
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    def snapshot(self, name: str) -> Dict[str, float]:
        """Flat record fragment: ``<name>_p50/_p95/_p99/_count/_mean``."""
        return {
            name + "_p50": self.quantile(0.50),
            name + "_p95": self.quantile(0.95),
            name + "_p99": self.quantile(0.99),
            name + "_count": float(self.count),
            name + "_mean": self.mean,
        }


class Telemetry:
    def __init__(self):
        self.counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._obs: Dict[str, List[float]] = {}
        self.hists: Dict[str, HistogramSketch] = {}

    def count(self, name: str, n: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + n

    def gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        self._obs.setdefault(name, []).append(float(value))

    def hist(self, name: str, value: float) -> None:
        sk = self.hists.get(name)
        if sk is None:
            sk = self.hists[name] = HistogramSketch()
        sk.add(value)

    def flush(self) -> Dict[str, float]:
        """Counters and gauges as they stand, the interval's observations
        aggregated (then reset), and every histogram's quantiles."""
        rec: Dict[str, float] = dict(self.counters)
        rec.update(self._gauges)
        for name, series in self._obs.items():
            rec[name] = sum(series) / len(series)
            rec[name + "_max"] = max(series)
            rec[name + "_sum"] = sum(series)
        for name, sk in self.hists.items():
            if sk.count:
                rec.update(sk.snapshot(name))
        self._obs.clear()
        return rec
