"""Cascade pipeline + zero-shot eval harness tests."""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from mmrs_tpu.cascade import CallableVerifier, CascadePipeline, StubVerifier, parse_yes_no
from mmrs_tpu.eval.sweep import pair_threshold_sweep, write_sweep_csv
from mmrs_tpu.eval.zeroshot import (
    binary_zeroshot,
    multiclass_zeroshot,
    write_multiclass_csv,
)


def test_parse_yes_no_reference_semantics():
    assert parse_yes_no("Yes")
    assert parse_yes_no("  YES, it does")
    assert parse_yes_no("The answer is yes.")
    assert not parse_yes_no("No")
    assert not parse_yes_no("It is a violin")


def test_callable_verifier_prompt():
    seen = {}

    def gen(path, prompt):
        seen["prompt"] = prompt
        return "yes"

    v = CallableVerifier(gen)
    assert v.verify("img.jpg", "lychee")
    assert seen["prompt"] == "Does this image contain a lychee?"


def test_cascade_gate_and_verifier():
    paths = [f"img{i}.jpg" for i in range(6)]
    # EN catches 0,1; CN catches 2; 5 is a gate false positive
    en = {p: s for p, s in zip(paths, [30.0, 28.0, 10.0, 5.0, 5.0, 26.0])}
    cn = {p: s for p, s in zip(paths, [3.0, 3.0, 12.0, 4.0, 4.0, 4.0])}
    labels = [True, True, True, False, False, False]

    verifier = StubVerifier(answers={"img5.jpg": False}, default=True)
    pipe = CascadePipeline(
        en_scorer=lambda ps: [en[p] for p in ps],
        cn_scorer=lambda ps: [cn[p] for p in ps],
        en_threshold=25.61,
        cn_threshold=10.0,
        verifier=verifier,
    )
    res = pipe.run(paths, "T-shirt", labels=labels)

    assert list(np.nonzero(res.gate_passed)[0]) == [0, 1, 2, 5]
    # verifier only sees gate survivors (the cascade's whole point)
    assert res.verifier_calls == 4
    assert sorted(p for p, _ in verifier.calls) == [
        "img0.jpg", "img1.jpg", "img2.jpg", "img5.jpg"]
    # img5 flipped to negative by the verifier
    assert list(np.nonzero(res.verified)[0]) == [0, 1, 2]
    assert res.metrics.f1 == pytest.approx(1.0)
    # stage stats recorded
    d = res.stats.as_dict()
    assert set(d) == {"en_clip", "cn_clip", "verifier"}
    assert d["verifier"]["count"] == 4


class _PackStubVerifier(StubVerifier):
    """StubVerifier that records fixed-batch packs like the LLaVA verifier."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.packs = []

    def verify_batch(self, image_paths, category, fixed_batch=None):
        n_real = len(image_paths)
        padded = list(image_paths)
        if fixed_batch is not None:
            padded += [image_paths[0]] * (fixed_batch - n_real)
        self.packs.append(len(padded))
        return [self.verify(p, category) for p in padded][:n_real]


def test_cascade_streaming_matches_run():
    """run_streaming == run, with the verifier dispatched in fixed packs."""
    rng = np.random.default_rng(0)
    paths = [f"img{i}.jpg" for i in range(23)]
    en = {p: float(s) for p, s in zip(paths, rng.uniform(0, 30, 23))}
    cn = {p: float(s) for p, s in zip(paths, rng.uniform(0, 15, 23))}
    labels = list(rng.uniform(0, 1, 23) > 0.5)
    answers = {p: bool(rng.integers(0, 2)) for p in paths}

    def build(verifier):
        return CascadePipeline(
            en_scorer=lambda ps: [en[p] for p in ps],
            cn_scorer=lambda ps: [cn[p] for p in ps],
            en_threshold=18.0, cn_threshold=9.0, verifier=verifier)

    ref = build(StubVerifier(answers=dict(answers))).run(
        paths, "cat", labels=labels)
    sv = _PackStubVerifier(answers=dict(answers))
    res = build(sv).run_streaming(paths, "cat", labels=labels,
                                  chunk_size=7, verify_batch=4)

    np.testing.assert_array_equal(res.gate_passed, ref.gate_passed)
    np.testing.assert_array_equal(res.verified, ref.verified)
    np.testing.assert_allclose(res.en_scores, ref.en_scores)
    assert res.verifier_calls == ref.verifier_calls
    assert res.metrics == ref.metrics
    # every dispatched pack has the fixed compiled shape
    assert all(p == 4 for p in sv.packs)


class _AsyncPackStubVerifier(_PackStubVerifier):
    """Adds the async dispatch/collect split the LLaVA verifier exposes, with
    deferred answer resolution so a premature (unpipelined) collect would
    be visible as max_in_flight == 1."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.open_handles = 0
        self.max_in_flight = 0

    def verify_batch_async(self, image_paths, category, fixed_batch=None):
        self.open_handles += 1
        self.max_in_flight = max(self.max_in_flight, self.open_handles)
        return (list(image_paths), category, fixed_batch)

    def collect(self, handle):
        paths, category, fixed_batch = handle
        self.open_handles -= 1
        return super().verify_batch(paths, category, fixed_batch=fixed_batch)


def test_cascade_streaming_pipelined_matches_sync():
    """Async gate->verify pipelining (verify_batch_async/collect) yields the
    same CascadeResult as the synchronous flush, keeps up to pipeline_depth
    packs in flight, and pipeline_depth=0 falls back to sync."""
    rng = np.random.default_rng(1)
    paths = [f"img{i}.jpg" for i in range(29)]
    en = {p: float(s) for p, s in zip(paths, rng.uniform(0, 30, 29))}
    labels = list(rng.uniform(0, 1, 29) > 0.5)
    answers = {p: bool(rng.integers(0, 2)) for p in paths}

    def build(verifier):
        return CascadePipeline(
            en_scorer=lambda ps: [en[p] for p in ps],
            en_threshold=12.0, verifier=verifier)

    ref = build(_PackStubVerifier(answers=dict(answers))).run_streaming(
        paths, "cat", labels=labels, chunk_size=5, verify_batch=3,
        pipeline_depth=0)
    av = _AsyncPackStubVerifier(answers=dict(answers))
    res = build(av).run_streaming(paths, "cat", labels=labels,
                                  chunk_size=5, verify_batch=3,
                                  pipeline_depth=2)

    np.testing.assert_array_equal(res.verified, ref.verified)
    np.testing.assert_array_equal(res.gate_passed, ref.gate_passed)
    assert res.verifier_calls == ref.verifier_calls
    assert res.metrics == ref.metrics
    assert av.max_in_flight >= 2          # actually pipelined
    assert av.open_handles == 0           # fully drained
    assert all(p == 3 for p in av.packs)
    assert "verifier_wait" in res.stats.stages


def test_cascade_streaming_no_verifier():
    paths = [f"img{i}.jpg" for i in range(5)]
    pipe = CascadePipeline(en_scorer=lambda ps: [float(len(p)) for p in ps],
                           en_threshold=0.0)
    res = pipe.run_streaming(paths, "cat", chunk_size=2)
    assert res.verified.all() and res.verifier_calls == 0


def test_cascade_single_tower():
    pipe = CascadePipeline(en_scorer=lambda ps: [1.0] * len(ps),
                           en_threshold=0.5)
    res = pipe.run(["a.jpg"], "cat")
    assert res.gate_passed.all() and res.verified.all()
    with pytest.raises(ValueError):
        CascadePipeline()


def _clustered(rng, proto, n, noise=0.25):
    f = proto + noise * rng.normal(size=(n, proto.shape[-1]))
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def test_multiclass_zeroshot_and_csv(tmp_path):
    rng = np.random.default_rng(0)
    d = 32
    protos = rng.normal(size=(3, d))
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    feats = np.concatenate([_clustered(rng, protos[c], 30) for c in range(3)])
    labels = np.repeat([0, 1, 2], 30)

    res = multiclass_zeroshot(
        jnp.asarray(feats.astype(np.float32)),
        jnp.asarray(protos.astype(np.float32)),
        labels, ["cat", "dog", "others"],
    )
    assert res.accuracy > 0.9
    assert set(res.per_class) == {"cat", "dog", "others"}
    np.testing.assert_allclose(res.probs.sum(1), 1.0, atol=1e-5)

    out = str(tmp_path / "lab1.csv")
    write_multiclass_csv(res, out)
    lines = open(out).read().splitlines()
    assert len(lines) == 1 + 3 + 2  # header + classes + acc + macro


def test_binary_zeroshot():
    rng = np.random.default_rng(1)
    d = 16
    pos_t = rng.normal(size=d); pos_t /= np.linalg.norm(pos_t)
    neg_t = -pos_t
    feats = np.concatenate([
        _clustered(rng, pos_t, 20, 0.2),
        _clustered(rng, neg_t, 20, 0.2),
    ]).astype(np.float32)
    labels = [True] * 20 + [False] * 20
    res = binary_zeroshot(
        {"baozi": jnp.asarray(feats)},
        {"baozi": jnp.asarray(pos_t.astype(np.float32))},
        {"baozi": jnp.asarray(neg_t.astype(np.float32))},
        {"baozi": labels},
    )
    assert res.per_target["baozi"].f1 > 0.95


def test_pair_sweep_and_csv(tmp_path):
    rng = np.random.default_rng(2)
    pos_sims = {"dog": rng.normal(0.7, 0.05, 100).clip(0, 1)}
    neg_sims = {"dog": rng.normal(0.4, 0.05, 100).clip(0, 1)}
    sweeps = pair_threshold_sweep(pos_sims, neg_sims, pairs=[("dog", "wolf")])
    assert sweeps["dog"].result.best_f1 > 0.99
    assert 0.4 < sweeps["dog"].result.best_threshold < 0.7

    summary = write_sweep_csv(sweeps, str(tmp_path))
    assert os.path.exists(summary)
    assert os.path.exists(str(tmp_path / "sweep_dog.csv"))
    rows = open(summary).read().splitlines()
    assert rows[1].startswith("dog,wolf,")


def _journal_fixture(n=23, seed=0):
    rng = np.random.default_rng(seed)
    paths = [f"img{i}.jpg" for i in range(n)]
    en = {p: float(s) for p, s in zip(paths, rng.uniform(0, 30, n))}
    cn = {p: float(s) for p, s in zip(paths, rng.uniform(0, 15, n))}
    labels = list(rng.uniform(0, 1, n) > 0.5)
    answers = {p: bool(rng.integers(0, 2)) for p in paths}

    def build(verifier, count_scores=None):
        def en_scorer(ps):
            if count_scores is not None:
                count_scores.extend(ps)
            return [en[p] for p in ps]

        return CascadePipeline(
            en_scorer=en_scorer,
            cn_scorer=lambda ps: [cn[p] for p in ps],
            en_threshold=18.0, cn_threshold=9.0, verifier=verifier)

    return paths, labels, answers, build


def test_cascade_journal_written_and_csv_roundtrip(tmp_path):
    """journal=FILE leaves a complete per-image ledger equal to the
    result; write_csv emits the same rows."""
    import csv

    paths, labels, answers, build = _journal_fixture()
    journal = str(tmp_path / "cascade.csv")
    res = build(StubVerifier(answers=dict(answers))).run_streaming(
        paths, "cat", labels=labels, chunk_size=7, verify_batch=4,
        journal=journal)

    def read(p):
        with open(p, newline="") as f:
            rows = {r[0]: r[1:] for r in csv.reader(f) if r[0] != "path"}
        return rows

    jrows = read(journal)
    assert set(jrows) == set(paths)
    for i, p in enumerate(paths):
        assert int(jrows[p][2]) == int(res.gate_passed[i])
        assert int(jrows[p][3]) == int(res.verified[i])

    out = str(tmp_path / "audit.csv")
    res.write_csv(out)
    assert read(out) == jrows


def test_cascade_journal_resume_skips_finalized(tmp_path):
    """A run that dies mid-way resumes from the journal: finalized images
    are neither re-scored nor re-verified, and the combined result equals
    a clean run."""
    paths, labels, answers, build = _journal_fixture()
    journal = str(tmp_path / "cascade.csv")

    class _DyingVerifier(StubVerifier):
        def __init__(self, *a, die_after=2, **kw):
            super().__init__(*a, **kw)
            self.batches = 0
            self.die_after = die_after

        def verify_batch(self, image_paths, category, fixed_batch=None):
            if self.batches >= self.die_after >= 0:
                raise RuntimeError("simulated crash")
            self.batches += 1
            return [self.answers.get(p, self.default)
                    for p in image_paths]

    dying = _DyingVerifier(answers=dict(answers), die_after=2)
    with pytest.raises(RuntimeError):
        build(dying).run_streaming(paths, "cat", chunk_size=7,
                                   verify_batch=4, journal=journal,
                                   pipeline_depth=0)

    # resume: the journal already holds every finalized row
    from mmrs_tpu.cascade.pipeline import _load_journal

    finalized = set(_load_journal(journal))
    assert finalized  # the crash happened after some rows landed

    scored = []
    v2 = _DyingVerifier(answers=dict(answers), die_after=-1)
    res = build(v2, count_scores=scored).run_streaming(
        paths, "cat", labels=labels, chunk_size=7, verify_batch=4,
        journal=journal, pipeline_depth=0)

    # finalized images were not re-scored on the resume pass
    assert not (set(scored) & finalized)

    ref = build(StubVerifier(answers=dict(answers))).run(
        paths, "cat", labels=labels)
    np.testing.assert_array_equal(res.verified, ref.verified)
    np.testing.assert_array_equal(res.gate_passed, ref.gate_passed)
    assert res.metrics == ref.metrics


def test_cascade_journal_ignores_torn_tail(tmp_path):
    """A torn (partial) last line — the crash case fsync can leave — is
    ignored and that image is redone."""
    paths, labels, answers, build = _journal_fixture()
    journal = str(tmp_path / "cascade.csv")
    res1 = build(StubVerifier(answers=dict(answers))).run_streaming(
        paths, "cat", chunk_size=7, verify_batch=4, journal=journal)
    with open(journal, "a", newline="") as f:
        f.write("imgX.jpg,12.")           # torn write
    res = build(StubVerifier(answers=dict(answers))).run_streaming(
        paths, "cat", labels=labels, chunk_size=7, verify_batch=4,
        journal=journal)
    np.testing.assert_array_equal(res.verified, res1.verified)


def test_cascade_journal_rethreshold_resume(tmp_path):
    """Resuming with DIFFERENT thresholds re-gates the stored scores:
    newly-failing rows flip negative, newly-passing rows are actually
    re-verified (a verdict is never invented), and the result equals a
    clean run at the new thresholds."""
    rng = np.random.default_rng(0)
    paths = [f"img{i}.jpg" for i in range(23)]
    en = {p: float(s) for p, s in zip(paths, rng.uniform(0, 30, 23))}
    cn = {p: float(s) for p, s in zip(paths, rng.uniform(0, 15, 23))}
    labels = list(rng.uniform(0, 1, 23) > 0.5)
    answers = {p: bool(rng.integers(0, 2)) for p in paths}

    def build(verifier, en_thr):
        return CascadePipeline(
            en_scorer=lambda ps: [en[p] for p in ps],
            cn_scorer=lambda ps: [cn[p] for p in ps],
            en_threshold=en_thr, cn_threshold=9.0, verifier=verifier)

    journal = str(tmp_path / "cascade.csv")
    build(StubVerifier(answers=dict(answers)), 18.0).run_streaming(
        paths, "cat", chunk_size=7, verify_batch=4, journal=journal)
    old_gate = build(StubVerifier(answers=dict(answers)), 18.0).run(
        paths, "cat").gate_passed

    # resume at a LOWER EN threshold: some former gate-failures pass now
    v = _PackStubVerifier(answers=dict(answers))
    res = build(v, 10.0).run_streaming(
        paths, "cat", labels=labels, chunk_size=7, verify_batch=4,
        journal=journal)
    clean = build(StubVerifier(answers=dict(answers)), 10.0).run(
        paths, "cat", labels=labels)

    np.testing.assert_array_equal(res.gate_passed, clean.gate_passed)
    np.testing.assert_array_equal(res.verified, clean.verified)
    # scores restored from the journal are bit-exact (%.9g round-trip)
    np.testing.assert_array_equal(res.en_scores, clean.en_scores)
    # only the NEWLY-passing images hit the verifier on the resume run
    expect = {paths[i] for i in range(len(paths))
              if clean.gate_passed[i] and not old_gate[i]}
    assert expect  # the threshold change actually exposed new survivors
    assert {p for p, _ in v.calls} == expect


def test_cascade_journal_append_after_torn_tail(tmp_path):
    """A torn tail WITHOUT a trailing newline must not swallow the first
    row appended by the resume run."""
    paths, labels, answers, build = _journal_fixture()
    journal = str(tmp_path / "cascade.csv")
    half = paths[:14]
    build(StubVerifier(answers=dict(answers))).run_streaming(
        half, "cat", chunk_size=7, verify_batch=4, journal=journal)
    with open(journal, "a", newline="") as f:
        f.write("imgTORN.jpg,1")          # torn write, no newline
    res = build(StubVerifier(answers=dict(answers))).run_streaming(
        paths, "cat", labels=labels, chunk_size=7, verify_batch=4,
        journal=journal)
    from mmrs_tpu.cascade.pipeline import _load_journal

    rows = _load_journal(journal)
    assert set(rows) == set(paths)        # nothing merged/swallowed
    ref = build(StubVerifier(answers=dict(answers))).run(
        paths, "cat", labels=labels)
    np.testing.assert_array_equal(res.verified, ref.verified)
