"""Tracing/profiling (SURVEY.md §5).

The reference's only observability is manual time.time() prints
(code/union_clip_llava2.py:163-168). Here:
  - `trace(...)`: context manager wrapping jax.profiler.TraceAnnotation for
    named device-timeline regions;
  - `profile_to(dir)`: captures a TensorBoard-loadable device trace;
  - `annotate_fn`: decorator version for pipeline stages.
StageStats (utils/stats.py) remains the lightweight wall-clock layer.
"""

from __future__ import annotations

import contextlib
from functools import wraps
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def profile_to(log_dir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Capture a device trace viewable in TensorBoard / Perfetto."""
    import jax

    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate_fn(name: Optional[str] = None):
    def deco(fn):
        label = name or fn.__qualname__

        @wraps(fn)
        def wrapper(*a, **kw):
            with trace(label):
                return fn(*a, **kw)

        return wrapper

    return deco


def _device_events(log_dir: str, device_substr: str) -> list:
    """Complete ('X') events on device tracks from the newest trace under
    log_dir: [(name, pid, ts, dur_us), ...]."""
    import glob
    import gzip
    import json

    files = sorted(glob.glob(
        f"{log_dir}/**/*.trace.json.gz", recursive=True))
    if not files:
        raise FileNotFoundError(f"no trace.json.gz under {log_dir!r}")
    with gzip.open(files[-1]) as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    track_names = {
        e["pid"]: e["args"].get("name", "")
        for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    return [
        (e["name"], e["pid"], e.get("ts", 0), e.get("dur", 0))
        for e in events
        if (e.get("ph") == "X"
            and device_substr in track_names.get(e["pid"], ""))
    ]


def trace_op_table(log_dir: str, device_substr: str = "/device:",
                   top: int = 25, within: Optional[str] = None) -> list:
    """Summarize a captured trace into per-op device-time totals.

    Reads the newest `*.trace.json.gz` under `log_dir` (the format
    `profile_to` / jax.profiler.trace writes) and returns
    [(op_name, total_ms), ...] sorted by time, restricted to device
    tracks matching `device_substr` (the default matches every
    accelerator track, e.g. "/device:GPU:0"; the host's are "/host:CPU").

    `within="while.63"` restricts the table to ops whose time interval
    nests inside an event of that name (XLA while/fusion bodies appear
    on sibling device rows, so interval containment attributes a loop
    body's ops to the loop) — how the decode step is itemized without
    guessing across the prefill/decode whiles.
    """
    from collections import Counter

    evs = _device_events(log_dir, device_substr)
    if within is not None:
        spans = [(pid, ts, ts + dur) for name, pid, ts, dur in evs
                 if name == within]
        if not spans:
            raise ValueError(f"no event named {within!r} in the trace")
        evs = [
            (name, pid, ts, dur) for name, pid, ts, dur in evs
            if name != within and any(
                pid == sp and ts >= s0 and ts + dur <= s1
                for sp, s0, s1 in spans)
        ]
    totals: Counter = Counter()
    for name, _pid, _ts, dur in evs:
        totals[name] += dur
    return [(name, us / 1e3) for name, us in totals.most_common(top)]
