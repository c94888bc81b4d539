"""TPULLaVAVerifier end-to-end with a tiny random VLM + toy tokenizer."""

import numpy as np
import pytest
import jax
from PIL import Image

from mmrs_tpu.cascade.verifier import (
    LLAVA_V1_SYSTEM,
    LLAVA_V15_POST,
    LLAVA_V15_PRE,
    TPULLaVAVerifier,
    llava_v1_prompt_parts,
)
from mmrs_tpu.models import llava
from mmrs_tpu.models.configs import VITConfig
from mmrs_tpu.models.llama import LlamaConfig


class ToyTokenizer:
    """Char-level tokenizer with a controllable decode table."""

    def __init__(self):
        self.decode_map = {}

    def encode(self, text):
        return [3 + (ord(c) % 60) for c in text][:12]

    def decode(self, ids):
        return "".join(self.decode_map.get(i, "x") for i in ids)


@pytest.fixture(scope="module")
def verifier(tmp_path_factory):
    import jax.numpy as jnp

    lcfg = LlamaConfig(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2,
                       mlp_dim=128, max_seq=128)
    vcfg = VITConfig(image_size=32, patch_size=8, width=48, layers=2, heads=4,
                     embed_dim=32)
    cfg = llava.LLaVAConfig(vision=vcfg, lm=lcfg)
    params = llava.init(jax.random.key(0), cfg)
    tok = ToyTokenizer()
    v = TPULLaVAVerifier(params, cfg, tok, max_new_tokens=4, eos_token=-1,
                         image_size=32, compute_dtype=jnp.float32)
    img_dir = tmp_path_factory.mktemp("imgs")
    p = img_dir / "q.jpg"
    Image.fromarray(np.full((40, 40, 3), 128, np.uint8)).save(p)
    return v, tok, str(p)


@pytest.mark.slow
def test_verifier_runs_and_parses(verifier):
    v, tok, img = verifier
    out = v.generate_text(img, "Does this image contain a cat?")
    assert isinstance(out, str) and len(out) > 0

    # whatever tokens the random model produces, map them to yes/no and the
    # reference parse must follow
    first_ids = None

    class Capture(ToyTokenizer):
        def decode(self, ids):
            nonlocal first_ids
            first_ids = ids
            return super().decode(ids)

    cap = Capture()
    v.tokenizer = cap
    try:
        v.generate_text(img, "prompt")
        assert first_ids is not None

        cap.decode_map = {i: "yes" for i in first_ids}
        assert v.verify(img, "cat") is True
        cap.decode_map = {i: "no" for i in first_ids}
        assert v.verify(img, "cat") is False
    finally:
        # the fixture is module-scoped: later tests compare generate_text
        # output against this verifier, so the tokenizer must go back
        v.tokenizer = tok


def test_prompt_framing(verifier):
    # llava_v1 template: "{system} USER: <image>\n{query} ASSISTANT:"
    # (reference: code/union_clip_llava2.py:104-126 via llava conv templates)
    pre, post = llava_v1_prompt_parts("Is it a cat?")
    rendered = pre + "<image>" + post
    assert rendered == (
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the human's questions. "
        "USER: <image>\nIs it a cat? ASSISTANT:"
    )
    assert LLAVA_V15_PRE == LLAVA_V1_SYSTEM + " USER: "
    assert "ASSISTANT" in LLAVA_V15_POST


def test_prompt_ids_bos_handling(verifier):
    """Pre-image chunk carries BOS; post-image chunk must not (mirrors
    llava's tokenizer_image_token BOS stripping on non-first chunks)."""
    v, tok, img = verifier

    class BosTok(ToyTokenizer):
        def encode(self, text, add_bos=True):
            ids = [3 + (ord(c) % 60) for c in text][:12]
            return ([1] + ids) if add_bos else ids

    old = v.tokenizer
    try:
        v.tokenizer = BosTok()
        pre_ids, post_ids = v._prompt_ids("q?")
        assert pre_ids[0] == 1
        assert 1 not in post_ids[:1]
    finally:
        v.tokenizer = old


@pytest.mark.slow
def test_verify_batch_matches_sequential(verifier, tmp_path):
    v, tok, img = verifier
    img2 = tmp_path / "q2.jpg"
    Image.fromarray(np.full((40, 40, 3), 30, np.uint8)).save(img2)
    paths = [img, str(img2)]

    seq = [v.verify(p, "cat") for p in paths]
    batch = v.verify_batch(paths, "cat")
    assert batch == seq
    assert v.verify_batch([], "cat") == []


def test_cascade_uses_verify_batch():
    from mmrs_tpu.cascade import CascadePipeline

    class BatchSpy:
        def __init__(self):
            self.batch_calls = []

        def verify(self, path, cat):
            raise AssertionError("sequential path should not be used")

        def verify_batch(self, paths, cat):
            self.batch_calls.append(list(paths))
            return [p != "bad.jpg" for p in paths]

    spy = BatchSpy()
    pipe = CascadePipeline(en_scorer=lambda ps: [1.0] * len(ps),
                           en_threshold=0.5, verifier=spy)
    res = pipe.run(["a.jpg", "bad.jpg", "c.jpg"], "cat")
    assert spy.batch_calls == [["a.jpg", "bad.jpg", "c.jpg"]]
    assert list(res.verified) == [True, False, True]
    assert res.verifier_calls == 3


@pytest.mark.slow
def test_verifier_with_draft_matches_plain(verifier, tmp_path):
    """A draft VLM routes decode through speculative_generate; the parsed
    answers and generated text must be identical to the plain verifier
    (the speculative guarantee, models/speculative.py)."""
    import jax.numpy as jnp

    v, tok, img = verifier
    # a smaller draft with the SAME vision grid (32px/8 -> same token count)
    dlcfg = LlamaConfig(vocab_size=128, dim=32, layers=1, heads=2,
                        kv_heads=1, mlp_dim=64, max_seq=128)
    dvcfg = VITConfig(image_size=32, patch_size=8, width=32, layers=1,
                      heads=2, embed_dim=16)
    dcfg = llava.LLaVAConfig(vision=dvcfg, lm=dlcfg)
    dparams = llava.init(jax.random.key(5), dcfg)

    vs = TPULLaVAVerifier(v.params, v.cfg, tok, max_new_tokens=4,
                          eos_token=-1, image_size=32,
                          compute_dtype=jnp.float32, draft_params=dparams,
                          draft_cfg=dcfg, draft_tokens=2)
    want = v.generate_text(img, "Does this image contain a cat?")
    got = vs.generate_text(img, "Does this image contain a cat?")
    assert got == want

    img2 = tmp_path / "d2.jpg"
    Image.fromarray(np.full((40, 40, 3), 77, np.uint8)).save(img2)
    paths = [img, str(img2)]
    assert vs.verify_batch(paths, "cat") == v.verify_batch(paths, "cat")

    # realized-acceptance counters accumulated across both decodes
    st = vs.speculative_stats()
    assert st is not None and st["rounds"] >= 2
    assert st["tokens"] >= 2 and 0.0 < st["utilization"] <= 1.0
    assert v.speculative_stats() is None      # no draft -> no stats


def test_tp_hosted_verifier_matches_single_device(verifier, tmp_path):
    """mesh= hosts the decoder TP-sharded (tower replicated); generated
    text and parsed answers must equal the single-device verifier's."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

    v, tok, img = verifier
    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, (DATA_AXIS, MODEL_AXIS))
    vt = TPULLaVAVerifier(v.params, v.cfg, tok, max_new_tokens=4,
                          eos_token=-1, image_size=32,
                          compute_dtype=jnp.float32, mesh=mesh)
    q = "Does this image contain a cat?"
    assert vt.generate_text(img, q) == v.generate_text(img, q)

    img2 = tmp_path / "tp2.jpg"
    Image.fromarray(np.full((40, 40, 3), 99, np.uint8)).save(img2)
    paths = [img, str(img2)]
    assert vt.verify_batch(paths, "cat") == v.verify_batch(paths, "cat")


@pytest.mark.slow
def test_tp_hosted_verifier_with_draft_matches_single_device(verifier):
    """TP mesh + draft VLM: the speculative TP path keeps greedy
    exactness, with the (non-divisible kv_heads=1) draft auto-replicated."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

    v, tok, img = verifier
    dlcfg = LlamaConfig(vocab_size=128, dim=32, layers=1, heads=2,
                        kv_heads=1, mlp_dim=64, max_seq=128)
    dvcfg = VITConfig(image_size=32, patch_size=8, width=32, layers=1,
                      heads=2, embed_dim=16)
    dcfg = llava.LLaVAConfig(vision=dvcfg, lm=dlcfg)
    dparams = llava.init(jax.random.key(5), dcfg)

    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, (DATA_AXIS, MODEL_AXIS))
    vt = TPULLaVAVerifier(v.params, v.cfg, tok, max_new_tokens=4,
                          eos_token=-1, image_size=32,
                          compute_dtype=jnp.float32, mesh=mesh,
                          draft_params=dparams, draft_cfg=dcfg,
                          draft_tokens=2)
    assert vt.shard_draft is False     # kv_heads=1 can't split the axis
    q = "Does this image contain a cat?"
    assert vt.generate_text(img, q) == v.generate_text(img, q)


@pytest.mark.slow
def test_tp_hosted_verifier_int8_weights(verifier):
    """mesh= + quantize_llava int8 weights (the --verifier-int8 --tp CLI
    config): answers match the single-device int8 verifier."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mmrs_tpu.models.quantize import quantize_llava
    from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

    v, tok, img = verifier
    qparams = quantize_llava(v.params)
    kw = dict(max_new_tokens=4, eos_token=-1, image_size=32,
              compute_dtype=jnp.float32, kv_dtype=jnp.int8)
    vq = TPULLaVAVerifier(qparams, v.cfg, tok, **kw)
    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, (DATA_AXIS, MODEL_AXIS))
    vt = TPULLaVAVerifier(qparams, v.cfg, tok, mesh=mesh, **kw)
    q = "Does this image contain a cat?"
    assert vt.generate_text(img, q) == vq.generate_text(img, q)


def test_tp_shard_draft_true_rejected_when_not_divisible(verifier):
    """Explicit shard_draft=True with a non-divisible draft fails with a
    clear error at construction, not an opaque device_put failure."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

    v, tok, _ = verifier
    dlcfg = LlamaConfig(vocab_size=128, dim=32, layers=1, heads=2,
                        kv_heads=1, mlp_dim=64, max_seq=128)
    dvcfg = VITConfig(image_size=32, patch_size=8, width=32, layers=1,
                      heads=2, embed_dim=16)
    dcfg = llava.LLaVAConfig(vision=dvcfg, lm=dlcfg)
    dparams = llava.init(jax.random.key(5), dcfg)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                (DATA_AXIS, MODEL_AXIS))
    with pytest.raises(ValueError, match="shard_draft"):
        TPULLaVAVerifier(v.params, v.cfg, tok, compute_dtype=jnp.float32,
                         image_size=32, mesh=mesh, draft_params=dparams,
                         draft_cfg=dcfg, shard_draft=True)


@pytest.mark.slow
def test_streaming_cascade_with_draft_verifier_matches_plain(verifier,
                                                             tmp_path):
    """CascadePipeline.run_streaming with a speculative-draft verifier
    (async packs + pipelining + journal) produces the same verdicts as
    the plain verifier — the full serving composition."""
    import jax.numpy as jnp

    from mmrs_tpu.cascade.pipeline import CascadePipeline

    v, tok, img = verifier
    dlcfg = LlamaConfig(vocab_size=128, dim=32, layers=1, heads=2,
                        kv_heads=1, mlp_dim=64, max_seq=128)
    dvcfg = VITConfig(image_size=32, patch_size=8, width=32, layers=1,
                      heads=2, embed_dim=16)
    dcfg = llava.LLaVAConfig(vision=dvcfg, lm=dlcfg)
    dparams = llava.init(jax.random.key(5), dcfg)
    vs = TPULLaVAVerifier(v.params, v.cfg, tok, max_new_tokens=4,
                          eos_token=-1, image_size=32,
                          compute_dtype=jnp.float32, draft_params=dparams,
                          draft_cfg=dcfg, draft_tokens=2)

    paths = []
    for i, val in enumerate((60, 90, 150, 210)):
        p = tmp_path / f"s{i}.jpg"
        Image.fromarray(np.full((40, 40, 3), val, np.uint8)).save(p)
        paths.append(str(p))
    scores = {p: float(i * 10) for i, p in enumerate(paths)}

    def build(ver):
        return CascadePipeline(
            en_scorer=lambda ps: [scores[p] for p in ps],
            cn_scorer=lambda ps: [0.0 for _ in ps],
            en_threshold=5.0, cn_threshold=99.0, verifier=ver)

    want = build(v).run_streaming(paths, "cat", chunk_size=2,
                                  verify_batch=2)
    got = build(vs).run_streaming(paths, "cat", chunk_size=2,
                                  verify_batch=2, pipeline_depth=2,
                                  journal=str(tmp_path / "j.csv"))
    np.testing.assert_array_equal(np.asarray(got.verified),
                                  np.asarray(want.verified))
    st = vs.speculative_stats()
    assert st is not None and st["rounds"] > 0


@pytest.mark.slow
def test_speculative_utilization_pins_at_one_for_self_draft(verifier):
    """draft == target with max_new_tokens ≡ 1 (mod k+1): the prefill's
    free first token must not count against verification slots, so
    utilization reads exactly 1.0 (the review found 1.033 here)."""
    import jax.numpy as jnp

    from mmrs_tpu.cascade.verifier import speculative_stats_of

    v, tok, img = verifier
    vs = TPULLaVAVerifier(v.params, v.cfg, tok, max_new_tokens=31,
                          eos_token=-1, image_size=32,
                          compute_dtype=jnp.float32, draft_params=v.params,
                          draft_cfg=v.cfg, draft_tokens=4)
    vs.verify(img, "cat")
    st = speculative_stats_of(vs)
    assert st == {"rounds": 6, "tokens": 30, "utilization": 1.0}, st


@pytest.mark.slow
def test_dp_tp_verifier_pads_odd_batches(verifier, tmp_path):
    """A 2-D (data x model) mesh shards verify batches over the data axis;
    odd batch sizes pad internally and single-row generate_text tiles —
    verdicts and text match the single-device verifier."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

    v, tok, img = verifier
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                (DATA_AXIS, MODEL_AXIS))
    vt = TPULLaVAVerifier(v.params, v.cfg, tok, max_new_tokens=4,
                          eos_token=-1, image_size=32,
                          compute_dtype=jnp.float32, mesh=mesh)
    paths = [img]
    for i, val in enumerate((60, 200)):
        p = tmp_path / f"dp{i}.jpg"
        Image.fromarray(np.full((40, 40, 3), val, np.uint8)).save(p)
        paths.append(str(p))
    assert vt.verify_batch(paths, "cat") == v.verify_batch(paths, "cat")
    q = "Does this image contain a cat?"
    assert vt.generate_text(img, q) == v.generate_text(img, q)
