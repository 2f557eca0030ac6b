"""Timing / fps instrumentation.

Analog of kfusion's ScopeTime and SampledScopeTime (include/kfusion/
types.hpp:70-90, src/kfusion/core.cpp:213-233): a RAII block timer and an
fps meter that prints the average frame time + fps every EACH_33 frames,
exactly like the reference's demo loop (demo.cpp:92-95).

`sync` blocks until the device work feeding its arguments has finished,
so a timer around a jitted call measures execution, not async dispatch.
"""

from __future__ import annotations

import time

import jax


def sync(*arrays) -> None:
    """Block until every array in `arrays` (any pytree) is computed."""
    jax.block_until_ready(arrays)


class ScopeTime:
    """with ScopeTime("name"): ... -> prints elapsed ms (types.hpp:70-77)."""

    def __init__(self, name: str, quiet: bool = False):
        self.name = name
        self.quiet = quiet
        self.ms = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self._t0) * 1e3
        if not self.quiet:
            print(f"Time({self.name}) = {self.ms:.2f} ms")
        return False


class SampledScopeTime:
    """Accumulates frame time; prints avg ms + fps every EACH frames
    (types.hpp:79-90, core.cpp:213-223: EACH = 33)."""

    EACH = 33

    def __init__(self):
        self.time_ms = 0.0
        self.i = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.time_ms += (time.perf_counter() - self._t0) * 1e3
        self.i += 1
        if self.i % self.EACH == 0:
            avg = self.time_ms / self.EACH
            print(f"Average frame time = {avg:.2f} ms ( {1000.0 / avg:.1f} fps )")
            self.time_ms = 0.0
        return False

    @property
    def fps(self) -> float:
        done = self.i % self.EACH or self.EACH
        return 1000.0 / (self.time_ms / done) if self.time_ms else 0.0
