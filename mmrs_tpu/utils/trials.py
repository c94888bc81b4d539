"""Multi-trial measurement summaries for the benches.

One timed pass cannot tell device variance from a real regression, so
every headline metric runs >= `n` independent trials and reports the
DISTRIBUTION (median / min / max / IQR); the headline value is the
median.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List


def summarize(samples: List[float]) -> Dict[str, float]:
    """Median / min / max / IQR for a list of per-trial measurements."""
    xs = sorted(float(x) for x in samples)
    n = len(xs)
    if n == 0:
        raise ValueError("no samples")

    def q(p: float) -> float:  # linear-interpolated quantile
        if n == 1:
            return xs[0]
        pos = p * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    return {
        "median": q(0.5),
        "min": xs[0],
        "max": xs[-1],
        "iqr": q(0.75) - q(0.25),
        "n": n,
        "trials": xs,
    }


def measure(fn: Callable[[], float], n: int = 5) -> Dict[str, float]:
    """Run a measurement callable n times and summarize. The callable
    owns its own warmup policy (run once before to exclude compiles)."""
    return summarize([fn() for _ in range(n)])


def fmt(label: str, s: Dict[str, float], unit: str = "ms",
        scale: float = 1.0) -> str:
    return (f"{label}: median {s['median'] * scale:.2f} {unit} "
            f"(min {s['min'] * scale:.2f}, max {s['max'] * scale:.2f}, "
            f"IQR {s['iqr'] * scale:.2f}, n={s['n']})")


def call_seconds(fn: Callable, *args, warmup: int = 2, n: int = 5,
                 reps: int = 1) -> Dict[str, float]:
    """Distribution over n trials of the seconds one call of fn(*args)
    takes, each trial timing `reps` calls that end in block_until_ready
    (JAX returns before the device finishes). The warmup calls absorb
    compilation."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))

    def one() -> float:
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps

    return measure(one, n)
