"""Quality/rate metrics and stage timing (framework-free: a copy of
jpeg_tpu/utils/metrics.py)."""

from __future__ import annotations

import contextlib
import time

import numpy as np


def psnr(a, b, peak: float = 255.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def bits_per_pixel(jpeg_bytes: bytes, shape) -> float:
    return len(jpeg_bytes) * 8.0 / (shape[0] * shape[1])


class StageTimer:
    """Accumulates wall-clock per pipeline stage."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total*1e3:.1f} ms ({n}x)")
        return "\n".join(lines)
