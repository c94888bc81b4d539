"""trace capture + op-table summarization (CPU backend)."""

import jax
import jax.numpy as jnp
import numpy as np

from mmrs_tpu.utils.profiling import profile_to, trace_op_table


def test_trace_op_table(tmp_path):
    @jax.jit
    def f(x):
        return jnp.dot(x, x.T).sum()

    x = jnp.ones((256, 256))
    np.asarray(f(x))
    with profile_to(str(tmp_path)):
        np.asarray(f(x))
    rows = trace_op_table(str(tmp_path), device_substr="CPU")
    assert rows and all(isinstance(r[1], float) for r in rows)


def test_trace_op_table_within(tmp_path):
    """within= attributes ops by interval containment inside a named span
    (how the decode while body is itemized)."""
    import gzip
    import json
    import os

    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        # outer loop span 0..100, inner ops on a sibling row (same pid)
        {"ph": "X", "pid": 1, "tid": 1, "name": "while.9", "ts": 0,
         "dur": 100},
        {"ph": "X", "pid": 1, "tid": 2, "name": "fusion.1", "ts": 10,
         "dur": 30},
        {"ph": "X", "pid": 1, "tid": 2, "name": "fusion.2", "ts": 50,
         "dur": 40},
        # outside the span: must not be attributed
        {"ph": "X", "pid": 1, "tid": 2, "name": "fusion.3", "ts": 150,
         "dur": 20},
    ]
    d = tmp_path / "plugins"
    os.makedirs(d)
    with gzip.open(d / "x.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)

    rows = dict(trace_op_table(str(tmp_path), within="while.9"))
    assert rows == {"fusion.1": 0.030, "fusion.2": 0.040}
    flat = dict(trace_op_table(str(tmp_path)))
    assert "fusion.3" in flat and "while.9" in flat

    import pytest

    with pytest.raises(ValueError, match="no event named"):
        trace_op_table(str(tmp_path), within="while.404")


def test_stage_stats_percentiles():
    """Windowed p50/p99 over recent call durations (nearest-rank)."""
    from mmrs_tpu.utils.stats import StageStats

    st = StageStats()
    for ms in range(1, 101):                    # 1..100 ms
        st.record("stage", ms / 1000.0)
    d = st.as_dict()["stage"]
    assert abs(d["p50_seconds"] - 0.050) < 0.002
    assert abs(d["p99_seconds"] - 0.099) < 0.002
    # bounded window: old samples age out
    for _ in range(600):
        st.record("stage", 1.0)
    d = st.as_dict()["stage"]
    assert d["p50_seconds"] == 1.0 and d["p99_seconds"] == 1.0
    assert d["calls"] == 700                    # totals keep full history
