"""HTTP serving layer: healthz + text/image search over a tiny index."""

import base64
import io
import json
import threading
import urllib.request

import numpy as np
import pytest


@pytest.fixture(scope="module")
def server():
    from PIL import Image

    from mmrs_tpu.config import Config
    from mmrs_tpu.index.gallery import GalleryIndex, build_index
    from mmrs_tpu.io.dataset import FolderDataset
    from mmrs_tpu.models.tokenizer import CLIPTokenizer
    from mmrs_tpu.pipeline import build_towers
    from mmrs_tpu.search.engine import SearchEngine
    from mmrs_tpu.serve import SearchService, make_server
    import tempfile, os

    tmp = tempfile.TemporaryDirectory()
    root, out = os.path.join(tmp.name, "data"), os.path.join(tmp.name, "idx")
    rng = np.random.default_rng(0)
    blobs = {}
    for cls, color in [("red", (220, 30, 30)), ("blue", (30, 30, 220))]:
        os.makedirs(os.path.join(root, cls))
        for i in range(4):
            arr = np.clip(np.full((32, 32, 3), color, int)
                          + rng.integers(-20, 20, (32, 32, 3)), 0, 255)
            img = Image.fromarray(arr.astype(np.uint8))
            img.save(os.path.join(root, cls, f"{cls}{i}.jpg"))
            buf = io.BytesIO()
            img.save(buf, format="JPEG")
            blobs[cls] = buf.getvalue()

    cfg = Config()
    cfg.model.image_tower = "vit_tiny"
    towers = build_towers(cfg, tokenizer=CLIPTokenizer(merges=[]))
    build_index(FolderDataset.from_root(root), towers.image_encode, out,
                batch_size=8)
    engine = SearchEngine(GalleryIndex.load(out), cfg.search)

    class ColorVerifier:
        """Answers by opening the (temp-file) image: yes iff mostly red.
        Exercises the /v1/verify blob->tempfile->Verifier path."""

        def __init__(self):
            self.calls = []

        def verify(self, image_path, category):
            self.calls.append((image_path, category))
            arr = np.asarray(Image.open(image_path).convert("RGB"), float)
            return bool(arr[..., 0].mean() > arr[..., 2].mean())

    verifier = ColorVerifier()
    srv = make_server(SearchService(engine, towers, verifier=verifier,
                                    batch_window=0.05),
                      port=0)  # ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", blobs, verifier
    srv.shutdown()
    tmp.cleanup()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_healthz(server):
    base, *_ = server
    h = _get(base + "/healthz")
    assert h["ok"] and h["rows"] == 8
    # deployment shape: single-device bf16 gallery, plain verifier
    assert h["gallery_shards"] == 1 and h["gallery_int8"] is False
    assert h["verifier"]["kind"] == "ColorVerifier"
    assert "tp" not in h["verifier"] and "draft" not in h["verifier"]


def test_image_search_ranks_same_class_first(server):
    base, blobs, _ = server
    out = _post(base + "/v1/search",
                {"image_b64": base64.b64encode(blobs["red"]).decode(), "k": 3})
    hits = out["hits"][0]
    assert len(hits) == 3
    assert hits[0]["cls"] == "red" and hits[0]["score"] > hits[-1]["score"]


def test_text_search_and_batched(server):
    base, *_ = server
    out = _post(base + "/v1/search", {"texts": ["red thing", "blue thing"],
                                      "k": 2})
    assert len(out["hits"]) == 2 and all(len(h) == 2 for h in out["hits"])


def test_bad_request(server):
    base, *_ = server
    req = urllib.request.Request(
        base + "/v1/search", data=b"{}",
        headers={"Content-Type": "application/json"})
    try:
        urllib.request.urlopen(req, timeout=60)
        assert False, "expected 400"
    except urllib.error.HTTPError as e:
        assert e.code == 400


def test_verify_endpoint_cascade(server):
    """/v1/verify: gate scores + survivor-only VLM verify over uploads."""
    base, blobs, verifier = server
    imgs = [base64.b64encode(blobs["red"]).decode(),
            base64.b64encode(blobs["blue"]).decode()]

    n0 = len(verifier.calls)
    out = _post(base + "/v1/verify",
                {"images_b64": imgs, "category": "red", "threshold": -1e9})
    res = out["results"]
    assert len(res) == 2 and all(r["gate_passed"] for r in res)
    assert res[0]["verified"] is True and res[1]["verified"] is False
    assert len(verifier.calls) - n0 == 2
    assert all(c[1] == "red" for c in verifier.calls[n0:])

    # gate rejects everything -> the VLM is never called, verified is null
    n1 = len(verifier.calls)
    out = _post(base + "/v1/verify",
                {"images_b64": imgs, "category": "red", "threshold": 1e9})
    res = out["results"]
    assert all(not r["gate_passed"] and r["verified"] is None for r in res)
    assert len(verifier.calls) == n1


def test_verify_images_fixed_packs():
    """Batched verifiers get FIXED-size packs (one compiled VLM shape per
    deployment, not one per survivor count) and results map back to the
    right images."""
    import io as _io

    from PIL import Image
    from mmrs_tpu.serve import SearchService

    def blob(v):
        buf = _io.BytesIO()
        Image.fromarray(np.full((8, 8, 3), v, np.uint8)).save(buf, "JPEG")
        return buf.getvalue()

    blobs = [blob(10 * i) for i in range(5)]

    class Towers:
        # scores 0..4 under logit_scale 1.0: embeddings = e_i scaled
        def image_encode(self, pixels):
            n = len(pixels)
            out = np.zeros((n, 8), np.float32)
            for i in range(n):
                out[i, 0] = float(i)
            return out

        def text_encode(self, texts):
            e = np.zeros((1, 8), np.float32)
            e[0, 0] = 1.0
            return e

    class PackVerifier:
        def __init__(self):
            self.packs = []

        def verify_batch(self, paths, category, fixed_batch=None):
            assert fixed_batch == 2
            self.packs.append(len(paths))
            # odd-indexed survivors verify True (by recorded order)
            return [j % 2 == 1 for j in range(len(paths))]

    pv = PackVerifier()
    svc = SearchService(engine=None, towers=Towers(), verifier=pv,
                        verify_batch=2, logit_scale=1.0)
    res = svc.verify_images(blobs, "cat", threshold=2.0)  # survivors: 2,3,4
    assert [r["gate_passed"] for r in res] == [False, False, True, True, True]
    assert pv.packs == [2, 1]          # fixed packs of verify_batch
    assert [r["verified"] for r in res] == [None, None, False, True, False]


def test_stats_endpoint(server):
    base, blobs, _ = server
    _post(base + "/v1/search",
          {"image_b64": base64.b64encode(blobs["red"]).decode(), "k": 2})
    out = _get(base + "/v1/stats")
    st = out["stages"]
    for stage in ("decode", "image_encode", "query"):
        assert stage in st and st[stage]["count"] >= 1, st
        assert "items_per_call" in st[stage]


def test_empty_batch_requests(server):
    """Explicit empty texts/images_b64 lists return empty results, not 400."""
    base, *_ = server
    assert _post(base + "/v1/search", {"texts": []}) == {"hits": []}
    assert _post(base + "/v1/search", {"images_b64": []}) == {"hits": []}
    assert _post(base + "/v1/verify",
                 {"images_b64": [], "category": "red"}) == {"results": []}


def test_http_concurrent_requests_batch(server):
    """≥8 concurrent HTTP searches coalesce: device dispatches < requests
    (observed via /v1/stats call counts), and nothing deadlocks."""
    base, *_ = server
    st0 = _get(base + "/v1/stats")["stages"].get("query", {})
    calls0, count0 = st0.get("calls", 0), st0.get("count", 0)

    n = 10
    barrier = threading.Barrier(n)
    errors = []

    def one(i):
        try:
            barrier.wait(timeout=30)
            out = _post(base + "/v1/search", {"text": f"thing {i}", "k": 2})
            assert len(out["hits"]) == 1 and len(out["hits"][0]) == 2
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    st1 = _get(base + "/v1/stats")["stages"]["query"]
    assert st1["count"] - count0 == n
    # the barrier releases all 10 at once; with a 50 ms batch window the
    # single device worker must fold them into fewer dispatches
    assert st1["calls"] - calls0 < n, (st1, calls0)


# ---- service-level micro-batching tests (stub towers/engine) ---------------

from types import SimpleNamespace  # noqa: E402


def _stub_towers(dim=8):
    def text_encode(texts):
        out = np.zeros((len(texts), dim), np.float32)
        out[:, 0] = 1.0
        return out

    def image_encode(pixels):
        out = np.zeros((len(pixels), dim), np.float32)
        # score = mean red intensity (deterministic gate scores)
        out[:, 0] = np.asarray(pixels)[..., 0].mean(axis=(1, 2)) / 255.0
        return out

    return SimpleNamespace(text_encode=text_encode,
                           image_encode=image_encode)


class _FakeEngine:
    """query_* returns one hit per query row; index is unused."""

    index = SimpleNamespace(dim=8, paths=[], classes=[])

    def query_text(self, vecs, top_k=None):
        return [[SimpleNamespace(path=f"t{i}", score=1.0, rank=0, cls="c")]
                for i in range(len(vecs))]

    query_image = query_text


def _jpeg_blob(value):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((8, 8, 3), value, np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


def test_vlm_packs_across_requests():
    """Survivors from CONCURRENT /v1/verify requests share fixed verify
    packs: 2 requests x 3 survivors -> packs [4, 2], not [3], [3]."""
    from mmrs_tpu.serve import SearchService

    class AsyncPackVerifier:
        def __init__(self):
            self.packs = []

        def verify_batch_async(self, paths, category, fixed_batch=None):
            self.packs.append(len(paths))
            return [True] * len(paths)

        def collect(self, handle):
            return handle

    pv = AsyncPackVerifier()
    svc = SearchService(engine=None, towers=_stub_towers(), verifier=pv,
                        verify_batch=4, logit_scale=1.0, batch_window=0.25)
    blobs = [_jpeg_blob(200)] * 3  # all pass a low threshold
    barrier = threading.Barrier(2)
    results = [None, None]

    def one(slot):
        barrier.wait(timeout=30)
        results[slot] = svc.verify_images(blobs, "cat", threshold=0.0)

    threads = [threading.Thread(target=one, args=(s,)) for s in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    svc.close()
    for res in results:
        assert res is not None
        assert [r["verified"] for r in res] == [True, True, True]
    # 6 survivors packed into fixed packs of 4: at least one pack larger
    # than any single request's survivor count proves cross-request packing
    assert sum(pv.packs) == 6 and max(pv.packs) == 4, pv.packs
    st = svc.stats.as_dict()["verifier"]
    assert st["count"] == 6 and st["calls"] == 2  # packed, not per-request


def test_search_not_blocked_by_slow_verify():
    """A search completes while a verify's VLM collect is still in
    flight — the 7B decode never blocks search requests behind a global
    lock."""
    from mmrs_tpu.serve import SearchService

    dispatched = threading.Event()
    release = threading.Event()

    class SlowVerifier:
        def verify_batch_async(self, paths, category, fixed_batch=None):
            dispatched.set()
            return [True] * len(paths)

        def collect(self, handle):
            assert release.wait(timeout=60), "never released"
            return handle

    svc = SearchService(engine=_FakeEngine(), towers=_stub_towers(),
                        verifier=SlowVerifier(), verify_batch=2,
                        logit_scale=1.0, batch_window=0.005)
    verify_result = []

    def do_verify():
        verify_result.append(
            svc.verify_images([_jpeg_blob(200)], "cat", threshold=0.0))

    t = threading.Thread(target=do_verify)
    t.start()
    assert dispatched.wait(timeout=60)
    # VLM collect is now blocked; searches must still be served
    hits = svc.search_texts(["a query"], k=1)
    assert len(hits) == 1 and hits[0][0]["path"] == "t0"
    assert not verify_result  # verify genuinely still in flight
    release.set()
    t.join(timeout=60)
    svc.close()
    assert verify_result and verify_result[0][0]["verified"] is True


@pytest.mark.slow
def test_verify_with_tp_hosted_verifier_matches_single_device():
    """SearchService.verify_images with a TP-mesh TPULLaVAVerifier (the
    --tp serving config): the VLM worker thread drives the TP jit and the
    verdicts equal the single-device verifier's."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mmrs_tpu.cascade.verifier import TPULLaVAVerifier
    from mmrs_tpu.models import llava
    from mmrs_tpu.models.configs import VITConfig
    from mmrs_tpu.models.llama import LlamaConfig
    from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from mmrs_tpu.serve import SearchService

    class Tok:
        def encode(self, t):
            return [3 + (ord(c) % 60) for c in t][:12]

        def decode(self, ids):
            # deterministic parse: "yes" iff the first id is even
            return "yes" if ids and ids[0] % 2 == 0 else "no"

    lcfg = LlamaConfig(vocab_size=128, dim=64, layers=2, heads=4,
                       kv_heads=2, mlp_dim=128, max_seq=128)
    vcfg = VITConfig(image_size=32, patch_size=8, width=48, layers=2,
                     heads=4, embed_dim=32)
    cfg = llava.LLaVAConfig(vision=vcfg, lm=lcfg)
    params = llava.init(jax.random.key(0), cfg)
    kw = dict(max_new_tokens=3, eos_token=-1, image_size=32,
              compute_dtype=jnp.float32)
    ref_v = TPULLaVAVerifier(params, cfg, Tok(), **kw)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                (DATA_AXIS, MODEL_AXIS))
    tp_v = TPULLaVAVerifier(params, cfg, Tok(), mesh=mesh, **kw)

    blobs = [_jpeg_blob(v) for v in (40, 120, 220)]
    want, got = [], []
    for verifier, sink in ((ref_v, want), (tp_v, got)):
        svc = SearchService(engine=None, towers=_stub_towers(),
                            verifier=verifier, verify_batch=4,
                            logit_scale=1.0, batch_window=0.05)
        try:
            sink.extend(svc.verify_images(blobs, "cat", threshold=0.0))
        finally:
            svc.close()
    assert [r["verified"] for r in got] == [r["verified"] for r in want]


def test_stats_surface_speculative_acceptance():
    """/v1/stats includes the verifier's realized speculative acceptance
    when it decodes with a draft (and omits the key otherwise)."""
    from mmrs_tpu.serve import SearchService, make_server

    class SpecVerifier:
        def verify(self, image_path, category):
            return True

        def speculative_stats(self):
            return {"rounds": 7, "tokens": 21, "utilization": 0.75}

    svc = SearchService(engine=None, towers=_stub_towers(),
                        verifier=SpecVerifier(), batch_window=0.01)
    srv = make_server(svc, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        body = _get(f"http://127.0.0.1:{srv.server_address[1]}/v1/stats")
        assert body["speculative"] == {"rounds": 7, "tokens": 21,
                                       "utilization": 0.75}
    finally:
        srv.shutdown()
        svc.close()


def test_cli_search_server_mode(server, tmp_path, capsys):
    """`mmrs search --server URL` queries a running serve instance over
    HTTP — no local engine, no tower compile (r4 ops surface)."""
    from mmrs_tpu.cli.main import main

    base, blobs, _ = server
    img = tmp_path / "q.jpg"
    img.write_bytes(blobs["red"])
    with pytest.raises(SystemExit) as e:
        main(["search", "--server", base, "--image", str(img), "-k", "3"])
    assert e.value.code == 0
    lines = [ln.split("\t") for ln in capsys.readouterr().out.splitlines()]
    assert len(lines) == 3
    assert lines[0][3] == "red"          # top hit is the query's class

    # no index and no server is a usage error, not a traceback
    with pytest.raises(SystemExit) as e:
        main(["search", "--text", "x"])
    assert e.value.code == 2

    # unreachable server reports cleanly
    with pytest.raises(SystemExit) as e:
        main(["search", "--server", "http://127.0.0.1:9", "--text", "x"])
    assert e.value.code == 2
