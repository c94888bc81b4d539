"""Drive the retrieval stack's main path once on one GPU and check it.

    python chip_smoke.py              # one card, every phase
    python chip_smoke.py --chips 4    # only the multi-card paths, 4 cards

Phases (one process, one card):
  device    JAX devices, JAX version, compile-cache directory, and the card's
            name and power limit (nvidia-smi).
  kernels   each Pallas kernel that stays (ops/dispatch.GPU_CHOICE), compiled
            for the GPU at the benchmark's widths, compared once with its
            plain reference and timed beside the XLA form.
  embed     pipeline.build_towers(Config()) — ViT-B/32 + CLIP text B/32, random
            weights — in bf16 and with model.dtype="int8", against a float32
            HIGHEST run of the same weights.
  index     index/gallery.build_index through the towers, GalleryIndex.load,
            then SearchEngine on a 1,048,576 x 512 bf16 gallery made on the
            device: exact bf16, int8 gallery, IVF at nprobe == C (must equal
            exact) and at the serving nprobe (recall@10 printed).
  serve     SearchService + make_server on 127.0.0.1: POST /v1/search (text,
            and image upload when Pillow imports), GET /healthz, GET /v1/stats.
  dedup     govern/dedup.embedding_dedup at 131,072 x 512 with planted
            duplicates: keepers and duplicates must equal the planted truth.
  verifier  TPULLaVAVerifier at LLaVA-v1.5-7B widths (random bf16 weights
            made on the device) with the CLI's serving options (int8 KV
            cache, layers="fori", prefill chunks of 64): a few verify packs,
            and the first-step logits against a float32 HIGHEST forward of
            the same weights.

With --chips 4 the script runs only what exists across cards, each compared
with the single-card result in the same process: the row-sharded exact
top-k and the slot-sharded IVF over a 4,194,304 x 512 gallery, ring dedup at
131,072 rows, and a TP=4 decode at 7B widths (depth cut to
`Sizes.multi_layers` decoder and vision layers) against TP=1.

Tolerances (stated here and printed with each comparison):
  top-k     values within 1e-4 absolute of the HIGHEST f32 reference on the
            same bf16 inputs; indices equal except where the reference's
            k-th and (k+1)-th scores lie within 1e-4;
  int8      values within 1e-5 relative of `_topk_quant_xla`, same index rule;
  first-match  bit-equal, on data with planted duplicates (cos >= 0.999)
            and every other pair far below tau;
  embed     row cosine to the f32 run >= 0.99 (bf16), >= 0.97 (int8);
  verifier  first-step logits: cosine >= 0.99 and max |diff| <= 0.1 * max
            |ref| against the f32 HIGHEST forward.

Every phase failure makes the script exit non-zero; a failure is caught only
to report it. Without a GPU it fails at once. The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import numpy as np

TOPK_ATOL = 1e-4
INT8_RTOL = 1e-5
EMBED_MIN_COS = {"bfloat16": 0.99, "int8": 0.97}
LOGIT_MIN_COS = 0.99
LOGIT_MAX_REL = 0.1


@dataclass(frozen=True)
class Sizes:
    """Widths and scales of one run. FULL is what the script runs on the
    card; the tests run TINY with the kernels in interpret mode."""

    d: int = 512
    topk_n: int = 1_048_576
    topk_q: tuple = (8, 64)
    k: int = 10
    dedup_n: int = 131_072
    ivf_n: int = 262_144
    ivf_c: int = 512
    ivf_nprobe: int = 32
    ivf_q: int = 8
    image_tower: str = "vit_b32"
    embed_batch: int = 64
    index_images: int = 4096
    search_n: int = 1_048_576
    search_q: int = 8
    verifier_lm: str = "7b"
    verifier_packs: int = 2
    verifier_pack: int = 4
    multi_n: int = 4_194_304
    multi_layers: int = 4       # decoder and vision depth of the TP check
    timing_reps: int = 10


FULL = Sizes()
TINY = Sizes(d=64, topk_n=3000, topk_q=(3, 20), k=5, dedup_n=600,
             ivf_n=2048, ivf_c=16, ivf_nprobe=4, ivf_q=3,
             image_tower="vit_tiny", embed_batch=4, index_images=24,
             search_n=4096, search_q=3, verifier_lm="tiny",
             verifier_packs=1, verifier_pack=2, multi_n=4096,
             timing_reps=1)


def say(*a):
    print(*a, flush=True)


def check(ok, message=""):
    """A comparison this script makes; raises when it fails (kept under
    `python -O`, unlike assert)."""
    if not ok:
        raise AssertionError(message)


def unit_rows(key, n, d, dtype):
    """n random unit rows [n, d] made on the device."""
    import jax
    import jax.numpy as jnp

    x = jax.random.normal(key, (n, d), jnp.float32)
    return (x / jnp.linalg.norm(x, axis=1, keepdims=True)).astype(dtype)


def clustered_rows(key, n, d, n_anchors=4096):
    """n unit rows around random anchors (an embedding-like corpus with
    cluster structure), bf16, made on the device."""
    import jax
    import jax.numpy as jnp

    k1, k2, k3 = jax.random.split(key, 3)
    anchors = unit_rows(k1, n_anchors, d, jnp.float32)
    which = jax.random.randint(k2, (n,), 0, n_anchors)
    x = anchors[which] + (0.9 / d ** 0.5) * jax.random.normal(
        k3, (n, d), jnp.float32)
    return (x / jnp.linalg.norm(x, axis=1, keepdims=True)).astype(
        jnp.bfloat16)


def seconds(fn, *args, reps=10):
    """Median seconds per call of fn(*args) (block_until_ready timing,
    two warmup calls)."""
    from mmrs_tpu.utils.trials import call_seconds

    return call_seconds(fn, *args, warmup=2, n=3, reps=reps)["median"]


def check_topk(got_v, got_i, ref_v, ref_i, atol, rtol=0.0, label=""):
    """The top-k tolerance rule above; ref_* carry k+1 columns."""
    got_v, got_i = np.asarray(got_v), np.asarray(got_i)
    ref_v, ref_i = np.asarray(ref_v), np.asarray(ref_i)
    k = got_v.shape[1]
    err = np.abs(got_v - ref_v[:, :k])
    tol = atol + rtol * np.abs(ref_v[:, :k])
    check((err <= tol).all(), f"{label}: values off by {err.max():.3g}")
    exact_rows = 0
    for r in range(got_i.shape[0]):
        if set(got_i[r]) == set(ref_i[r, :k]):
            exact_rows += (got_i[r] == ref_i[r, :k]).all()
            continue
        gap = ref_v[r, k - 1] - ref_v[r, k]
        check(gap <= max(atol, rtol * abs(ref_v[r, k])), (
            f"{label}: row {r} ids differ with a k-th/(k+1)-th gap {gap:.3g}"))
    return float(err.max()), int(exact_rows)


# -- phases -------------------------------------------------------------------


def phase_device(sz, impl):
    import jax

    from mmrs_tpu.utils.compile_cache import enable_compile_cache

    devs = jax.devices()
    say(f"[device] devices: {devs}")
    say(f"[device] kind: {devs[0].device_kind}, jax {jax.__version__}")
    say(f"[device] compile cache: {enable_compile_cache()}")
    if impl == "pallas":
        from mmrs_tpu.utils.device import card_name_and_power

        say(f"[device] card: {card_name_and_power()}")
    for mod in ("PIL", "regex", "yaml"):
        try:
            __import__(mod)
            say(f"[device] optional module {mod}: present")
        except ImportError:
            say(f"[device] optional module {mod}: absent")


def phase_kernels(sz, impl):
    import jax
    import jax.numpy as jnp

    from mmrs_tpu.index.ivf import build_ivf_streaming, ivf_topk
    from mmrs_tpu.ops.allpairs import _first_match_blocked_xla, first_match
    from mmrs_tpu.ops.quant import (_topk_quant_xla, cosine_topk_quantized,
                                    quantize_rows)
    from mmrs_tpu.ops.topk import _cosine_topk_xla, cosine_topk

    d, n, k = sz.d, sz.topk_n, sz.k
    g = unit_rows(jax.random.key(0), n, d, jnp.bfloat16)
    gq, gs = quantize_rows(g)
    ref = jax.jit(_cosine_topk_xla, static_argnums=2)
    for qn in sz.topk_q:
        q = unit_rows(jax.random.key(qn), qn, d, jnp.bfloat16)
        v, i = cosine_topk(q, g, k, impl=impl)
        rv, ri = ref(q, g, k + 1)
        err, exact = check_topk(v, i, rv, ri, TOPK_ATOL, label="topk")
        t_k = seconds(lambda q: cosine_topk(q, g, k, impl=impl), q,
                      reps=sz.timing_reps)
        t_x = seconds(lambda q: ref(q, g, k), q, reps=sz.timing_reps)
        say(f"[kernels] topk bf16 N={n} D={d} Q={qn} k={k}: max|dv| "
            f"{err:.2e} (tol {TOPK_ATOL}), {exact}/{qn} rows in identical "
            f"order; kernel {t_k * 1e3:.4f} ms, xla {t_x * 1e3:.4f} ms")

        q_q, q_s = quantize_rows(q)
        v8, i8 = cosine_topk_quantized(q, gq, gs, k, impl=impl)
        rv8, ri8 = jax.jit(_topk_quant_xla, static_argnums=4)(
            q_q, q_s, gq, gs, k + 1)
        err, exact = check_topk(v8, i8, rv8, ri8, 0.0, INT8_RTOL,
                                label="topk int8")
        t_k = seconds(lambda q: cosine_topk_quantized(q, gq, gs, k,
                                                      impl=impl), q,
                      reps=sz.timing_reps)
        t_x = seconds(lambda q: cosine_topk_quantized(q, gq, gs, k,
                                                      impl="xla"), q,
                      reps=sz.timing_reps)
        say(f"[kernels] topk int8 N={n} D={d} Q={qn} k={k}: max|dv| "
            f"{err:.2e} (rtol {INT8_RTOL}), {exact}/{qn} rows in identical "
            f"order; kernel {t_k * 1e3:.4f} ms, xla {t_x * 1e3:.4f} ms")
    del g, gq, gs

    # first-match: planted duplicates, everything else far below tau
    nd = sz.dedup_n
    x, truth = planted_duplicates(jax.random.key(3), nd, d)
    tau = 0.9
    fm = np.asarray(first_match(x, x, tau, intra=True, impl=impl))
    fx = np.asarray(jax.jit(_first_match_blocked_xla, static_argnums=(3,))(
        x, x, tau, True))
    check((fm == fx).all(), "first_match kernel != blocked XLA form")
    check((fm == truth).all(), "first_match != planted truth")
    t_k = seconds(lambda x: first_match(x, x, tau, intra=True, impl=impl),
                  x, reps=1)
    t_x = seconds(lambda x: first_match(x, x, tau, intra=True, impl="xla"),
                  x, reps=1)
    say(f"[kernels] first_match intra N={nd} D={d}: bit-equal to the "
        f"blocked XLA form and to the {int((truth >= 0).sum())} planted "
        f"duplicates; kernel {t_k * 1e3:.3f} ms, xla {t_x * 1e3:.3f} ms")
    del x

    # IVF probe at the benchmark's shape
    chunk = min(65536, sz.ivf_n)
    keys = [jax.random.key(100 + i) for i in range(sz.ivf_n // chunk)]

    def chunks():
        for kk in keys:
            yield clustered_rows(kk, chunk, d)

    ivf = build_ivf_streaming(chunks, sz.ivf_n, d, n_clusters=sz.ivf_c,
                              iters=5, chunk=chunk, dtype=jnp.bfloat16)
    q = clustered_rows(jax.random.key(999), sz.ivf_q, d)
    kw = dict(k=k, nprobe=sz.ivf_nprobe)
    v, i = ivf_topk(q, ivf, impl=impl, **kw)
    rv, ri = ivf_topk(q, ivf, impl="xla", **kw)
    err = float(np.abs(np.asarray(v) - np.asarray(rv)).max())
    check(err <= TOPK_ATOL, f"ivf probe values off by {err:.3g}")
    same = int((np.asarray(i) == np.asarray(ri)).all(axis=1).sum())
    t_k = seconds(lambda q: ivf_topk(q, ivf, impl=impl, **kw), q,
                  reps=sz.timing_reps)
    t_x = seconds(lambda q: ivf_topk(q, ivf, impl="xla", **kw), q,
                  reps=sz.timing_reps)
    say(f"[kernels] ivf probe N={sz.ivf_n} C={sz.ivf_c} "
        f"nprobe={sz.ivf_nprobe} Q={sz.ivf_q} cap={ivf.bucket_cap}: max|dv| "
        f"{err:.2e} (tol {TOPK_ATOL}), {same}/{sz.ivf_q} rows with equal "
        f"ids; kernel {t_k * 1e3:.4f} ms, xla {t_x * 1e3:.4f} ms")


def planted_duplicates(key, n, d):
    """[n, d] bf16 unit rows where every 97th row (from row 1000 on, or
    n//10 on small n) is a near-copy (cos >= 0.999) of an earlier row;
    returns (rows, first-match truth [n] with -1 for keepers)."""
    import jax
    import jax.numpy as jnp

    x = np.array(unit_rows(key, n, d, jnp.float32))
    rng = np.random.default_rng(0)
    truth = np.full(n, -1, np.int64)
    start = min(1000, n // 10)
    for i in range(start, n, 97):
        src = int(rng.integers(0, start))
        while truth[src] >= 0:
            src = int(truth[src])
        y = x[src] + 1e-3 * rng.standard_normal(d).astype(np.float32)
        x[i] = y / np.linalg.norm(y)
        truth[i] = src
    # a row's first match is its keeper's first copy only if that copy is
    # earlier than the keeper itself — never, since copies come later
    xb = jnp.asarray(x, jnp.bfloat16)
    xf = np.asarray(xb, np.float32)
    xf /= np.linalg.norm(xf, axis=1, keepdims=True)
    dups = truth >= 0
    cos = np.sum(xf[dups] * xf[truth[dups]], axis=1)
    check(cos.min() >= 0.999, cos.min())
    del jax
    return xb, truth


def phase_embed(sz, impl):
    import jax
    import jax.numpy as jnp

    from mmrs_tpu.config import Config
    from mmrs_tpu.models.tokenizer import CLIPTokenizer
    from mmrs_tpu.pipeline import build_towers

    def towers(dtype):
        cfg = Config()
        cfg.model.image_tower = sz.image_tower
        cfg.model.dtype = dtype
        return build_towers(cfg, tokenizer=CLIPTokenizer(merges=[]))

    size = towers_size(sz)
    rng = np.random.default_rng(0)
    pixels = rng.integers(0, 256, (sz.embed_batch, size, size, 3), np.uint8)
    texts = ["a photo of a cat", "a lychee", "一张吉他的图片", "x"]
    with jax.default_matmul_precision("highest"):
        ref = towers("float32")
        ref_img = ref.image_encode(pixels)
        ref_txt = ref.text_encode(texts)
    for dtype in ("bfloat16", "int8"):
        t = towers(dtype)
        img = t.image_encode(pixels)
        cos = np.sum(img * ref_img, axis=1) / (
            np.linalg.norm(img, axis=1) * np.linalg.norm(ref_img, axis=1))
        check(cos.min() >= EMBED_MIN_COS[dtype], (dtype, cos.min()))
        check(img.shape == (sz.embed_batch, ref_img.shape[1]))
        check(np.isfinite(img).all())
        txt = t.text_encode(texts)
        tcos = np.sum(txt * ref_txt, axis=1) / (
            np.linalg.norm(txt, axis=1) * np.linalg.norm(ref_txt, axis=1))
        u8 = jnp.asarray(pixels)
        dt = seconds(lambda u: t.encode_fn(t.params, u), u8, reps=3)
        say(f"[embed] {sz.image_tower} {dtype}: image cos to f32 min "
            f"{cos.min():.5f} (need >= {EMBED_MIN_COS[dtype]}), text cos "
            f"min {tcos.min():.5f}; {sz.embed_batch / dt:.1f} images/s at "
            f"batch {sz.embed_batch}")


def towers_size(sz):
    from mmrs_tpu.models.configs import IMAGE_TOWERS

    return IMAGE_TOWERS[sz.image_tower].image_size


class SyntheticImages:
    """FolderDataset's interface over seeded uint8 images (no files, no
    decoder): what build_index streams through the towers."""

    def __init__(self, n, size, seed=0):
        self.samples = [(f"synthetic/{i:06d}.png", f"c{i % 7}")
                        for i in range(n)]
        self.size = size
        self.seed = seed

    def batches(self, batch_size):
        from mmrs_tpu.io.dataset import Batch

        rng = np.random.default_rng(self.seed)
        for a in range(0, len(self.samples), batch_size):
            chunk = self.samples[a:a + batch_size]
            px = rng.integers(0, 256, (len(chunk), self.size, self.size, 3),
                              np.uint8)
            yield Batch(pixels=px, labels=[c for _, c in chunk],
                        paths=[p for p, _ in chunk],
                        ok=np.ones(len(chunk), bool))


def phase_index(sz, impl, state):
    import jax

    from mmrs_tpu.config import Config, SearchConfig
    from mmrs_tpu.index.gallery import GalleryIndex, build_index
    from mmrs_tpu.index.ivf import auto_clusters, auto_nprobe
    from mmrs_tpu.models.tokenizer import CLIPTokenizer
    from mmrs_tpu.pipeline import build_towers
    from mmrs_tpu.search.engine import SearchEngine

    cfg = Config()
    cfg.model.image_tower = sz.image_tower
    towers = build_towers(cfg, tokenizer=CLIPTokenizer(merges=[]))
    out = tempfile.mkdtemp(prefix="mmrs_index_")
    t0 = time.perf_counter()
    built = build_index(SyntheticImages(sz.index_images, towers_size(sz)),
                        towers.image_encode, out, batch_size=256,
                        shard_rows=max(1, sz.index_images // 3))
    dt = time.perf_counter() - t0
    idx = GalleryIndex.load(out)
    check(len(idx) == len(built) == sz.index_images)
    emb = np.asarray(idx.embeddings)
    check(np.isfinite(emb).all())
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-3)
    say(f"[index] build_index + load: {len(idx)} rows x {idx.dim} in "
        f"{len(GalleryIndex.load(out).paths)} paths, {dt:.1f} s "
        f"(host-side images, towers on the device)")
    state.update(index_dir=out, towers=towers, cfg=cfg)

    # SearchEngine at gallery scale: rows made on the device
    n, d, k = sz.search_n, idx.dim, sz.k
    g = clustered_rows(jax.random.key(5), n, d)
    big = GalleryIndex(g, [f"row{i}" for i in range(n)], ["c"] * n)
    q = np.asarray(clustered_rows(jax.random.key(6), sz.search_q, d),
                   np.float32)

    def ranked(engine):
        """(cosines [Q, k+1], row ids [Q, k+1]) from the engine's hits."""
        hits = engine.query_vectors(q, top_k=k + 1)
        vals = np.asarray([[h.score / 100.0 for h in row] for row in hits])
        ids = np.asarray([[int(h.path[3:]) for h in row] for row in hits])
        return vals, ids

    ev, ei = ranked(SearchEngine(big, SearchConfig(top_k=k)))
    qv, qi = ranked(SearchEngine(big, SearchConfig(top_k=k),
                                 quantize="int8"))
    check(np.abs(qv - ev).max() <= 0.02, np.abs(qv - ev).max())
    overlap8 = np.mean([len(set(a[:k]) & set(b[:k])) / k
                        for a, b in zip(qi, ei)])
    c = auto_clusters(n)
    fv, fi = ranked(SearchEngine(big, SearchConfig(top_k=k, ann="ivf",
                                                   ann_nprobe=c)))
    err, same = check_topk(fv[:, :k], fi[:, :k], ev, ei, TOPK_ATOL,
                           label="ivf nprobe=C vs exact")
    sv, si = ranked(SearchEngine(big, SearchConfig(top_k=k, ann="ivf")))
    recall = np.mean([len(set(a[:k]) & set(b[:k])) / k
                      for a, b in zip(si, ei)])
    say(f"[index] SearchEngine N={n} D={d} Q={sz.search_q}: int8 top-{k} "
        f"overlap with exact {overlap8:.3f}; IVF C={c} nprobe=C equals "
        f"exact (max|dv| {err:.2e}, {same}/{sz.search_q} rows in identical "
        f"order); serving nprobe={auto_nprobe(c)} recall@{k} {recall:.3f}")


def phase_serve(sz, impl, state):
    import base64
    import io
    import threading
    import urllib.request

    from mmrs_tpu.index.gallery import GalleryIndex
    from mmrs_tpu.search.engine import SearchEngine
    from mmrs_tpu.serve import SearchService, make_server

    engine = SearchEngine(GalleryIndex.load(state["index_dir"]),
                          state["cfg"].search)
    service = SearchService(engine, state["towers"],
                            image_size=towers_size(sz))
    server = make_server(service, host="127.0.0.1", port=0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()

    def call(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=data,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            check(r.status == 200, (path, r.status))
            return json.loads(r.read())

    try:
        health = call("/healthz")
        texts = ["a photo of a cat", "a red car", "一张荔枝的图片",
                 "a dog on grass"]
        lat = []
        for t in texts:
            t0 = time.perf_counter()
            out = call("/v1/search", {"text": t, "k": 5})
            lat.append(time.perf_counter() - t0)
            check(len(out["hits"][0]) == 5, out)
        batch = call("/v1/search", {"texts": texts, "k": 3})
        check(len(batch["hits"]) == len(texts))
        try:
            from PIL import Image
        except ImportError:
            say("[serve] image upload skipped: Pillow is not installed "
                "(host-side decode, not the device path)")
        else:
            buf = io.BytesIO()
            Image.fromarray(np.full((64, 64, 3), 128, np.uint8)).save(
                buf, format="PNG")
            out = call("/v1/search", {
                "image_b64": base64.b64encode(buf.getvalue()).decode(),
                "k": 5})
            check(len(out["hits"][0]) == 5)
            say("[serve] image upload answered")
        stats = call("/v1/stats")
        say(f"[serve] /healthz {health.get('status', health)}; "
            f"{len(texts)} text searches, median "
            f"{np.median(lat) * 1e3:.1f} ms each (first includes compile); "
            f"/v1/stats stages {sorted(stats.get('stages', stats))}")
    finally:
        server.shutdown()
        server.server_close()
        service.close()


def phase_dedup(sz, impl):
    import jax

    from mmrs_tpu.govern.dedup import embedding_dedup

    n, d = sz.dedup_n, sz.d
    xb, truth = planted_duplicates(jax.random.key(11), n, d)
    emb = np.asarray(xb, np.float32)
    paths = [f"img{i:06d}.jpg" for i in range(n)]
    t0 = time.perf_counter()
    rep = embedding_dedup(emb, paths, tau=0.9, impl=impl)
    dt = time.perf_counter() - t0
    got = {(a, b) for a, b in rep.duplicates}
    want = {(paths[i], paths[truth[i]]) for i in np.nonzero(truth >= 0)[0]}
    check(got == want, (len(got), len(want)))
    keepers = set(paths) - {a for a, _ in got}
    check(len(keepers) == int((truth < 0).sum()))
    say(f"[dedup] embedding_dedup N={n} D={d} tau=0.9: {len(got)} "
        f"duplicates and {len(keepers)} keepers equal the planted truth; "
        f"{dt:.2f} s end to end (f32 rows, first call compiles)")


class ToyTokenizer:
    """A byte-level stand-in for the LLaMA tokenizer (ids 3..258)."""

    def encode(self, text, add_bos=True):
        ids = [3 + b for b in text.encode()]
        return ([1] if add_bos else []) + ids

    def decode(self, ids):
        return bytes(max(0, min(255, i - 3)) for i in ids).decode(
            errors="replace")


def verifier_config(sz, layers=0):
    """LLaVA-v1.5-7B widths (`layers` > 0 cuts the depth of the decoder
    and the vision tower), or a tiny config for the CPU tests."""
    import dataclasses

    from mmrs_tpu.models import llava
    from mmrs_tpu.models.configs import VIT_L14_336, VITConfig
    from mmrs_tpu.models.llama import LLAMA2_7B, LlamaConfig

    if sz.verifier_lm == "7b":
        lm, vis = LLAMA2_7B, VIT_L14_336
        if layers:
            lm = dataclasses.replace(lm, layers=layers)
            vis = dataclasses.replace(vis, layers=layers)
        return llava.LLaVAConfig(vision=vis, lm=lm)
    lm = LlamaConfig(vocab_size=320, dim=64, layers=2, heads=8, kv_heads=8,
                     mlp_dim=128, max_seq=256)
    vis = VITConfig(image_size=32, patch_size=8, width=48, layers=2, heads=4,
                    embed_dim=32)
    return llava.LLaVAConfig(vision=vis, lm=lm)


def make_verifier_params(cfg, seed=0):
    """Random bf16 LLaVA weights, made on the device."""
    import jax
    import jax.numpy as jnp

    from mmrs_tpu.models import llava

    return jax.jit(lambda key: llava.init(key, cfg, jnp.bfloat16))(
        jax.random.key(seed))


def first_step_logits(params, cfg, pixels, pre, post, dtype, kv_dtype,
                      layers, prefill_chunk):
    """The logits of the first generated token: vision tower + projector +
    decoder prefill, as llava.generate runs them. The weights are cast to
    `dtype` where they are used."""
    import jax
    import jax.numpy as jnp

    from mmrs_tpu.models import llama, llava
    from mmrs_tpu.ops.preprocess import normalize_images

    def fwd(params, pixels, pre, post):
        images = normalize_images(pixels, dtype=dtype)
        img = llava.encode_images(params, images, cfg, dtype)
        emb = llava.build_multimodal_embeds(params, pre, img, post, dtype)
        t = emb.shape[1]
        cache_len = ((t + 8 + 63) // 64) * 64
        logits, _ = llama.prefill(params["lm"], emb, cfg.lm, cache_len,
                                  dtype, kv_dtype, layers, prefill_chunk)
        return logits[:, -1, :].astype(jnp.float32)

    return jax.jit(fwd)(params, pixels, pre, post)


def verifier_inputs(cfg, verifier, n, seed=0):
    import jax.numpy as jnp

    from mmrs_tpu.cascade.verifier import llava_v1_prompt_parts

    size = cfg.vision.image_size
    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 256, (n, size, size, 3), np.uint8)
    prompt = verifier.prompt_template.format(category="cat")
    pre_t, post_t = llava_v1_prompt_parts(prompt)
    tok = verifier.tokenizer
    pre = jnp.asarray([tok.encode(pre_t, add_bos=True)] * n, jnp.int32)
    post = jnp.asarray([tok.encode(post_t, add_bos=False)] * n, jnp.int32)
    return jnp.asarray(pixels), pre, post


def compare_logits(got, ref, label):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    check(np.isfinite(got).all(), label)
    cos = np.sum(got * ref, axis=1) / (
        np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    check(cos.min() >= LOGIT_MIN_COS and rel <= LOGIT_MAX_REL, (
        label, cos.min(), rel))
    return float(cos.min()), float(rel)


SERVING = dict(layers="fori", prefill_chunk=64)


def phase_verifier(sz, impl):
    import jax
    import jax.numpy as jnp

    from mmrs_tpu.cascade.verifier import TPULLaVAVerifier

    cfg = verifier_config(sz)
    params = make_verifier_params(cfg)
    v = TPULLaVAVerifier(params, cfg, ToyTokenizer(), max_new_tokens=8,
                         eos_token=2, image_size=cfg.vision.image_size,
                         kv_dtype=jnp.int8, **SERVING)
    pixels, pre, post = verifier_inputs(cfg, v, sz.verifier_pack)
    answers = v.verify_pixels(pixels, "cat")        # compiles
    check(len(answers) == sz.verifier_pack)
    t0 = time.perf_counter()
    for _ in range(sz.verifier_packs):
        answers = v.verify_pixels(pixels, "cat")
    dt = (time.perf_counter() - t0) / sz.verifier_packs
    toks = sz.verifier_pack * v.max_new_tokens
    prompt = pre.shape[1] + post.shape[1] + (
        (cfg.vision.image_size // cfg.vision.patch_size) ** 2)
    say(f"[verifier] {sz.verifier_packs} verify packs of "
        f"{sz.verifier_pack} at prompt ~{prompt} tokens: {dt * 1e3:.1f} ms "
        f"per pack, {toks / dt:.1f} tok/s (prefill included, "
        f"{v.max_new_tokens} new tokens per row)")

    got = first_step_logits(params, cfg, pixels[:1], pre[:1], post[:1],
                            jnp.bfloat16, jnp.int8, **SERVING)
    del v
    with jax.default_matmul_precision("highest"):
        ref = first_step_logits(params, cfg, pixels[:1], pre[:1], post[:1],
                                jnp.float32, None, "scan", None)
    cos, rel = compare_logits(got, ref, "first-step logits")
    say(f"[verifier] first-step logits vs f32 HIGHEST forward of the same "
        f"weights: cosine {cos:.5f} (need >= {LOGIT_MIN_COS}), max|diff| / "
        f"max|ref| {rel:.4f} (need <= {LOGIT_MAX_REL})")


# -- four cards -----------------------------------------------------------------


def phase_multi(sz, impl):
    """Multi-card paths against one card, in this process."""
    import jax
    import jax.numpy as jnp

    from mmrs_tpu.config import MeshConfig
    from mmrs_tpu.index.ivf import build_ivf_streaming, ivf_topk
    from mmrs_tpu.ops.allpairs import first_match
    from mmrs_tpu.ops.topk import cosine_topk
    from mmrs_tpu.parallel.dedup import sharded_first_match
    from mmrs_tpu.parallel.ivf import sharded_ivf_topk
    from mmrs_tpu.parallel.mesh import make_mesh
    from mmrs_tpu.parallel.topk import place_gallery, sharded_cosine_topk

    devs = jax.devices()
    nd = len(devs)
    mesh = make_mesh(MeshConfig(data_size=nd, model_size=1))
    d, k, n = sz.d, sz.k, sz.multi_n
    one = devs[0]

    # row-sharded exact top-k vs one card
    chunk = min(n, 1_048_576)
    parts = [clustered_rows(jax.random.key(200 + i), chunk, d)
             for i in range(n // chunk)]
    q = clustered_rows(jax.random.key(299), sz.search_q, d)
    g1 = jax.device_put(jnp.concatenate(parts), one)
    v1, i1 = cosine_topk(jax.device_put(q, one), g1, k, impl=impl)
    v1, i1 = np.asarray(v1), np.asarray(i1)
    del g1
    gs = place_gallery(jnp.concatenate(parts), mesh)
    vs, is_ = sharded_cosine_topk(q, gs, k, mesh, impl=impl)
    del gs
    err = float(np.abs(np.asarray(vs) - v1).max())
    check(err <= TOPK_ATOL and (np.asarray(is_) == i1).all(), (
        "sharded top-k != one card", err))
    say(f"[multi] row-sharded exact top-{k} over {n} x {d} on {nd} cards "
        f"equals one card (ids equal, max|dv| {err:.2e})")

    # slot-sharded IVF vs one card: same centroids and placement
    def chunks():
        yield from parts

    ivfs = build_ivf_streaming(chunks, n, d, iters=5, chunk=chunk,
                               dtype=jnp.bfloat16, mesh=mesh)
    cents = jax.device_put(ivfs.centroids[:, :d].astype(jnp.float32), one)
    ivf1 = build_ivf_streaming(chunks, n, d, chunk=chunk,
                               dtype=jnp.bfloat16, centroids=cents,
                               bucket_cap=ivfs.bucket_cap)   # card 0
    a1 = ivf_topk(jax.device_put(q, one), ivf1, k=k, impl=impl)
    del ivf1
    a4 = sharded_ivf_topk(q, ivfs, k=k, mesh=mesh, impl=impl)
    err = float(np.abs(np.asarray(a4[0]) - np.asarray(a1[0])).max())
    same = set(np.asarray(a4[1]).ravel()) == set(np.asarray(a1[1]).ravel())
    check(err <= TOPK_ATOL and same, ("sharded IVF != one card", err))
    say(f"[multi] slot-sharded IVF (C={ivfs.n_clusters}) over {n} x {d} "
        f"equals one card (same ids, max|dv| {err:.2e})")
    del ivfs, parts

    # ring dedup vs one card
    xb, truth = planted_duplicates(jax.random.key(13), sz.dedup_n, d)
    f1 = np.asarray(first_match(jax.device_put(xb, one),
                                jax.device_put(xb, one), 0.9, intra=True,
                                impl=impl))
    f4 = np.asarray(sharded_first_match(xb, 0.9, mesh, impl=impl))
    check((f1 == f4).all() and (f1 == truth).all(), "ring dedup != one card")
    say(f"[multi] ring dedup N={sz.dedup_n} on {nd} cards equals one card "
        f"and the planted truth")

    # TP=nd 7B decode vs TP=1
    from mmrs_tpu.cascade.verifier import TPULLaVAVerifier

    cfg = verifier_config(sz, sz.multi_layers)
    params = make_verifier_params(cfg)
    kw = dict(max_new_tokens=8, eos_token=2,
              image_size=cfg.vision.image_size, kv_dtype=jnp.int8,
              **SERVING)
    solo = TPULLaVAVerifier(jax.device_put(params, one), cfg,
                            ToyTokenizer(), **kw)
    pixels, pre, post = verifier_inputs(cfg, solo, sz.verifier_pack)
    ids1 = np.asarray(solo._dispatch(
        solo_images(solo, pixels), "cat", sz.verifier_pack)[0])
    del solo
    tp_mesh = make_mesh(MeshConfig(data_size=1, model_size=nd))
    tp = TPULLaVAVerifier(params, cfg, ToyTokenizer(), mesh=tp_mesh, **kw)
    ids4 = np.asarray(tp._dispatch(
        solo_images(tp, pixels), "cat", sz.verifier_pack)[0])
    agree = float((ids1 == ids4).mean())
    first = float((ids1[:, 0] == ids4[:, 0]).mean())
    check(first == 1.0, ("TP first tokens differ", ids1[:, 0], ids4[:, 0]))
    say(f"[multi] TP={nd} decode vs TP=1 (7B widths, "
        f"{cfg.lm.layers} decoder layers): first tokens equal, "
        f"{agree:.3f} of all {ids1.size} greedy tokens equal")


def solo_images(v, pixels):
    from mmrs_tpu.ops.preprocess import normalize_images

    return normalize_images(pixels, dtype=v.compute_dtype)


PHASES = ("device", "kernels", "embed", "index", "serve", "dedup",
          "verifier")


def run(phases, sz=FULL, impl="pallas"):
    """Run the named phases; returns the names of those that failed."""
    state = {}
    failed = []
    for name in phases:
        fn = {"device": phase_device, "kernels": phase_kernels,
              "embed": phase_embed, "dedup": phase_dedup,
              "verifier": phase_verifier, "multi": phase_multi,
              "index": lambda s, i: phase_index(s, i, state),
              "serve": lambda s, i: phase_serve(s, i, state)}[name]
        t0 = time.perf_counter()
        try:
            fn(sz, impl)
        except Exception:  # reported, and the run fails
            traceback.print_exc(file=sys.stdout)
            failed.append(name)
            say(f"[{name}] FAILED")
        say(f"[{name}] {time.perf_counter() - t0:.1f} s")
    return failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chips", type=int, default=1,
                   help="1: every single-card phase; 4: only the "
                        "multi-card paths, compared with one card")
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of the single-card phases")
    args = p.parse_args(argv)

    from mmrs_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from mmrs_tpu.utils.device import card_name_and_power, device_record

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs}; this script measures the card "
              f"and has no CPU fallback", file=sys.stderr)
        return 2
    if len(devs) != args.chips:
        print(f"--chips {args.chips} but JAX sees {len(devs)} devices",
              file=sys.stderr)
        return 2
    if args.chips == 1:
        phases = [ph for ph in args.phases.split(",") if ph]
        unknown = set(phases) - set(PHASES)
        if unknown:
            p.error(f"unknown phases {sorted(unknown)}")
    else:
        phases = ["device", "multi"]
    failed = run(phases)
    say(f"card: {card_name_and_power()}")
    if failed:
        say(f"FAILED phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": device_record()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
