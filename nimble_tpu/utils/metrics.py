"""Observability: throughput counters and profiler hooks.

The reference's only observability is println! progress markers (per-1M-read
blocks, `src/parse/bam.rs:121-127`) plus the forensic TSV itself.  This
build adds first-class counters (reads/s per stage) and an optional JAX
profiler trace hook for on-device analysis.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ThroughputMeter:
    """Monotonic counter with rate reporting.

    >>> m = ThroughputMeter("align")
    >>> with m.measure(1024): pass   # times the block, counts 1024 items
    >>> m.rate()  # items/sec over total measured time
    """

    name: str
    items: int = 0
    seconds: float = 0.0
    calls: int = 0

    @contextlib.contextmanager
    def measure(self, n_items: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.items += n_items
            self.calls += 1

    def add(self, n_items: int, seconds: float) -> None:
        self.items += n_items
        self.seconds += seconds
        self.calls += 1

    def rate(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0

    def summary(self) -> str:
        return (
            f"{self.name}: {self.items:,} items in {self.seconds:.2f}s "
            f"({self.rate():,.0f}/s over {self.calls} calls)"
        )


class MetricsRegistry:
    """Process-wide named meters (pipelines report at shutdown)."""

    def __init__(self) -> None:
        self.meters: Dict[str, ThroughputMeter] = {}

    def meter(self, name: str) -> ThroughputMeter:
        if name not in self.meters:
            self.meters[name] = ThroughputMeter(name)
        return self.meters[name]

    def report(self) -> str:
        return "\n".join(m.summary() for m in self.meters.values())


METRICS = MetricsRegistry()


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Wrap a region in a JAX profiler trace when ``log_dir`` is set.

    View with TensorBoard / xprof; no-op when log_dir is None.
    """
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
