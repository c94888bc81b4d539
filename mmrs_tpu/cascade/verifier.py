"""Pluggable VLM verifier stage.

The reference's LLaVA gate (code/union_clip_llava2.py:104-130): prompt the
VLM "Does this image contain a {category}?", decode greedily at temperature
0, and treat the answer as positive iff "yes" appears in the lowercased
output (:127-130). SURVEY.md §7 stages the 7B VLM itself as a pluggable
interface (endpoint or stub) first; the cascade semantics live here so any
backend — a device-hosted VLM, an HTTP endpoint, or a test stub — slots in.
"""

from __future__ import annotations

from typing import Callable, Dict, Protocol

DEFAULT_PROMPT = "Does this image contain a {category}?"
STRICT_PROMPT = (
    "Does this image contain a {category}? "
    "Answer with ONLY a single word: 'yes' or 'no'."
)


def parse_yes_no(output: str) -> bool:
    """The reference's answer parse: `"yes" in output.lower()`
    (code/union_clip_llava2.py:127-130)."""
    return "yes" in output.lower()


def speculative_stats_of(verifier):
    """Duck-typed probe for a verifier's realized speculative acceptance
    (shared by `mmrs cascade` and /v1/stats): None unless the verifier
    exposes `speculative_stats()` and has decoded with a draft."""
    fn = getattr(verifier, "speculative_stats", None)
    return fn() if callable(fn) else None


class Verifier(Protocol):
    def verify(self, image_path: str, category: str) -> bool:
        """True iff the VLM confirms the image contains the category."""
        ...


class StubVerifier:
    """Deterministic test/bring-up stub: answers from a lookup, default yes.

    Keys: (image_path, category) first, then image_path alone."""

    def __init__(self, answers: Dict = None, default: bool = True):
        self.answers = answers or {}
        self.default = default
        self.calls: list = []

    def verify(self, image_path: str, category: str) -> bool:
        self.calls.append((image_path, category))
        if (image_path, category) in self.answers:
            return self.answers[(image_path, category)]
        if image_path in self.answers:
            return self.answers[image_path]
        return self.default


class CallableVerifier:
    """Adapts any `generate(image_path, prompt) -> str` function (an HTTP
    endpoint client, a local VLM decode loop) into the Verifier protocol,
    applying the reference prompt template and yes-parse."""

    def __init__(self, generate: Callable[[str, str], str],
                 prompt_template: str = DEFAULT_PROMPT):
        self.generate = generate
        self.prompt_template = prompt_template

    def verify(self, image_path: str, category: str) -> bool:
        prompt = self.prompt_template.format(category=category)
        return parse_yes_no(self.generate(image_path, prompt))


# LLaVA-v1.5 conversation framing used by the reference's eval_model call
# (code/union_clip_llava2.py:104-126): conv_mode=None with model name
# "llava-v1.5-7b" resolves to the llava_v1 template — system prompt +
# SeparatorStyle.TWO (sep " ", sep2 "</s>") — and the query is prefixed with
# "<image>\n". The rendered single-turn prompt is therefore
#   "{system} USER: <image>\n{query} ASSISTANT:"
# split at the <image> position into a pre-image and post-image text chunk
# (llava's tokenizer_image_token does the same split).
LLAVA_V1_SYSTEM = (
    "A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the human's questions."
)
LLAVA_V15_PRE = LLAVA_V1_SYSTEM + " USER: "
LLAVA_V15_POST = " ASSISTANT:"


def llava_v1_prompt_parts(query: str,
                          system: str = LLAVA_V1_SYSTEM
                          ) -> "tuple[str, str]":
    """(pre_image_text, post_image_text) for the llava_v1 template.

    The newline between <image> and the query comes from llava's
    DEFAULT_IMAGE_TOKEN + "\\n" + qs framing, so it belongs to the
    post-image chunk."""
    return system + " USER: ", "\n" + query + LLAVA_V15_POST


class TPULLaVAVerifier:
    """The VLM verifier hosted on the accelerator via models/llava.py.

    Needs: converted llava params, an LLaMA text tokenizer exposing
    `encode(text) -> List[int]` and `decode(ids) -> str` (e.g. a
    SentencePiece wrapper), and the CLIP-normalized image preprocessor.
    Greedy decode at temperature 0; answer parsed with the reference's
    "yes"-substring test.
    """

    def __init__(self, params, cfg, tokenizer,
                 prompt_template: str = DEFAULT_PROMPT,
                 max_new_tokens: int = 32,
                 eos_token: int = 2,
                 image_size: int = 336,
                 compute_dtype=None,
                 kv_dtype=None,
                 layers: str = "scan",
                 prefill_chunk: int | None = None,
                 decode_window: int | None = None,
                 early_stop: bool = True,
                 draft_params=None,
                 draft_cfg=None,
                 draft_tokens: int = 4,
                 mesh=None,
                 shard_draft: bool | None = None):
        import jax.numpy as jnp

        # int8 KV cache (llama.QKVCache) halves per-step KV traffic and
        # device residency of the ~600-token multimodal prompts; layers=
        # "fori" (in-place stacked-cache layer loop) + prefill_chunk are
        # the serving decode options (see models/llama.greedy_generate)
        self.kv_dtype = kv_dtype
        self.layers = layers
        self.prefill_chunk = prefill_chunk
        self.decode_window = decode_window
        # halt the decode while_loop once every row has answered (yes/no
        # answers finish in ~3 of max_new=8 steps; bit-identical output)
        self.early_stop = early_stop
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.prompt_template = prompt_template
        self.max_new_tokens = max_new_tokens
        self.eos_token = eos_token
        self.image_size = image_size
        self.compute_dtype = compute_dtype or jnp.bfloat16
        # optional draft VLM: routes decode through models/speculative.py
        # (same greedy output, the draft only sets speed — the weight
        # stream is amortized over each accepted draft run). decode_window
        # does not apply to the speculative path; early-stop is inherent
        # (the round loop exits when every row has answered).
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.draft_tokens = draft_tokens
        # optional TP hosting: a jax.sharding.Mesh with a "model" axis
        # shards the 7B decoder Megatron-style across its chips (vision
        # tower/projector replicated — parallel/vlm.py). Params (and the
        # draft, replicated unless shard_draft) are re-placed here; the
        # jitted TP generate is built lazily on first use.
        self.mesh = mesh
        self.shard_draft = shard_draft
        self._tp_gen = None
        self._solo_gen = None
        # realized speculative acceptance (the number draft_tokens is
        # tuned against): accumulated at collect() time, exposed via
        # speculative_stats() and /v1/stats. The lock keeps the triple
        # consistent when a stats poll races the VLM worker's update.
        import threading

        self._spec_lock = threading.Lock()
        self._spec_rounds = 0
        self._spec_tokens = 0
        self._spec_slots = 0
        if mesh is not None:
            from mmrs_tpu.parallel.vlm import (
                draft_tp_divisible, replicate_llama_params,
                shard_llava_params,
            )

            self.params = shard_llava_params(params, mesh)
            if draft_params is not None:
                divisible = draft_tp_divisible(draft_cfg.lm, mesh)
                if shard_draft is None:
                    self.shard_draft = divisible
                elif shard_draft and not divisible:
                    raise ValueError(
                        "shard_draft=True but the draft's heads/kv-heads/"
                        "mlp/vocab don't divide the mesh's model axis — "
                        "use shard_draft=False (replicated draft)")
                if self.shard_draft:
                    self.draft_params = shard_llava_params(draft_params, mesh)
                else:  # whole draft VLM replicated
                    self.draft_params = replicate_llama_params(
                        draft_params, mesh)

    def _tp_generate(self, images, pre, post):
        if self._tp_gen is None:
            from mmrs_tpu.parallel.vlm import (
                make_tp_llava_generate, make_tp_llava_speculative_generate,
            )

            if self.draft_params is not None:
                fn = make_tp_llava_speculative_generate(
                    self.cfg, self.draft_cfg, self.mesh,
                    self.max_new_tokens, self.draft_tokens, self.eos_token,
                    self.compute_dtype,
                    kv_dtype=self.kv_dtype, layers=self.layers,
                    prefill_chunk=self.prefill_chunk, return_stats=True)
                self._tp_gen = lambda im, pr, po: fn(
                    self.params, self.draft_params, im, pr, po)
            else:
                fn = make_tp_llava_generate(
                    self.cfg, self.mesh, self.max_new_tokens,
                    self.eos_token, self.compute_dtype, kv_dtype=self.kv_dtype,
                    layers=self.layers, prefill_chunk=self.prefill_chunk,
                    decode_window=self.decode_window,
                    early_stop=self.early_stop)
                self._tp_gen = lambda im, pr, po: fn(
                    self.params, im, pr, po)
        return self._tp_gen(images, pre, post)

    def _generate(self, images, pre, post):
        """Returns (tokens, speculative_stats_or_None) — stats are still
        device-side async values; fetch them where the tokens are fetched."""
        from mmrs_tpu.models import llava

        if self.mesh is not None:
            out = self._tp_generate(images, pre, post)
            return out if self.draft_params is not None else (out, None)
        if self._solo_gen is None:
            # one jitted program per verifier: the prefill chunks and the
            # decode loop compile once, not op by op on every pack
            import jax

            if self.draft_params is not None:
                self._solo_gen = jax.jit(
                    lambda p, d, im, pr, po: llava.generate_speculative(
                        p, d, im, pr, po, self.cfg, self.draft_cfg,
                        self.max_new_tokens, self.draft_tokens,
                        self.eos_token, self.compute_dtype,
                        kv_dtype=self.kv_dtype, layers=self.layers,
                        prefill_chunk=self.prefill_chunk,
                        return_stats=True))
            else:
                self._solo_gen = jax.jit(
                    lambda p, im, pr, po: (llava.generate(
                        p, im, pr, po, self.cfg, self.max_new_tokens,
                        self.eos_token, self.compute_dtype,
                        kv_dtype=self.kv_dtype, layers=self.layers,
                        prefill_chunk=self.prefill_chunk,
                        decode_window=self.decode_window,
                        early_stop=self.early_stop), None))
        if self.draft_params is not None:
            return self._solo_gen(self.params, self.draft_params, images,
                                  pre, post)
        return self._solo_gen(self.params, images, pre, post)

    def _record_spec(self, stats, batch_rows: int) -> None:
        """Fold one generate's speculative stats into the realized-
        acceptance counters (fetches the device values)."""
        import numpy as np

        if stats is None:
            return
        rounds = int(np.asarray(stats["rounds"]))
        if rounds == 0:        # every row hit EOS on the prefill's token
            return
        # the first token per row comes free from the prefill (not a
        # verification slot) — count only round-emitted tokens so a
        # fully-agreeing draft reads exactly 1.0
        emitted = int(np.asarray(stats["emitted"]).sum())
        tokens = max(emitted - batch_rows, 0)
        with self._spec_lock:
            self._spec_rounds += rounds
            self._spec_tokens += tokens
            self._spec_slots += rounds * batch_rows * (self.draft_tokens + 1)

    def speculative_stats(self):
        """Realized speculative acceptance, or None when no draft is
        configured / nothing decoded yet.

        `utilization` = round-emitted tokens / (rounds × batch × (k+1)) —
        the fraction of each verification pass's k+1 slots that actually
        shipped. 1.0 means the draft always agrees (the measured ceiling);
        tune `draft_tokens` until utilization stops paying for the extra
        draft steps."""
        with self._spec_lock:
            rounds, tokens, slots = (self._spec_rounds, self._spec_tokens,
                                     self._spec_slots)
        if self.draft_params is None or rounds == 0:
            return None
        return {
            "rounds": rounds,
            "tokens": tokens,
            "utilization": tokens / max(slots, 1),
        }

    def _load_image(self, image_path: str):
        import jax.numpy as jnp
        import numpy as np

        from mmrs_tpu.io.images import load_image
        from mmrs_tpu.ops.preprocess import normalize_images

        r = load_image(image_path, size=self.image_size, stack="hf")
        u8 = jnp.asarray(np.asarray(r.pixels)[None])
        return normalize_images(u8, dtype=self.compute_dtype)

    def _prompt_ids(self, prompt: str):
        """Tokenize the llava_v1 template around the <image> slot: BOS only
        on the pre-image chunk; the post-image chunk keeps the SP dummy
        prefix (matching HF legacy slow-tokenizer chunk encoding inside
        llava's tokenizer_image_token)."""
        pre_text, post_text = llava_v1_prompt_parts(prompt)
        try:
            pre_ids = self.tokenizer.encode(pre_text, add_bos=True)
            post_ids = self.tokenizer.encode(post_text, add_bos=False)
        except TypeError:  # tokenizer without the add_bos kwarg
            pre_ids = self.tokenizer.encode(pre_text)
            post_ids = self.tokenizer.encode(post_text)
        return pre_ids, post_ids

    def _data_size(self) -> int:
        """Width of the mesh's data axis (batch rows must divide it)."""
        if self.mesh is None:
            return 1
        from mmrs_tpu.parallel.mesh import DATA_AXIS

        shape = self.mesh.shape
        return int(shape[DATA_AXIS]) if DATA_AXIS in shape else 1

    def generate_text(self, image_path: str, prompt: str) -> str:
        import jax.numpy as jnp
        import numpy as np

        pre_ids, post_ids = self._prompt_ids(prompt)
        images = self._load_image(image_path)
        # batch-DP meshes shard the batch dim; tile the single row up to
        # the data-axis width (the replicas decode copies, row 0 is read)
        d = self._data_size()
        if d > 1:
            images = jnp.tile(images, (d, 1, 1, 1))
        pre = jnp.tile(jnp.asarray([pre_ids], jnp.int32), (max(d, 1), 1))
        post = jnp.tile(jnp.asarray([post_ids], jnp.int32), (max(d, 1), 1))
        out, spec = self._generate(images, pre, post)
        ids = [int(t) for t in np.asarray(out)[0] if int(t) != self.eos_token]
        self._record_spec(spec, out.shape[0])
        return self.tokenizer.decode(ids)

    def verify(self, image_path: str, category: str) -> bool:
        prompt = self.prompt_template.format(category=category)
        return parse_yes_no(self.generate_text(image_path, prompt))

    def verify_batch_async(self, image_paths, category: str,
                           fixed_batch: int | None = None):
        """Dispatch one batched VQA decode WITHOUT waiting for the result.

        Returns an opaque handle for `collect()`. The device array inside
        is an async JAX dispatch: the device computes while the host goes on
        to load/gate the next chunk — on one chip the device work is
        serial either way, but host-side image decode (the other big cost
        on this 1-core box) then overlaps it (gate->verify pipelining)."""
        import jax.numpy as jnp

        if not image_paths:
            return ([], None, 0)
        n_real = len(image_paths)
        if fixed_batch is not None:
            if n_real > fixed_batch:
                raise ValueError(f"{n_real} paths > fixed_batch {fixed_batch}")
            image_paths = list(image_paths) + [image_paths[0]] * (
                fixed_batch - n_real)
        # batch-DP meshes shard the batch dim: pad to the data-axis width
        d = self._data_size()
        if len(image_paths) % d:
            image_paths = list(image_paths) + [image_paths[0]] * (
                d - len(image_paths) % d)
        images = jnp.concatenate(
            [self._load_image(p) for p in image_paths], axis=0)
        return self._dispatch(images, category, n_real)

    def _dispatch(self, images, category: str, n_real: int):
        import jax.numpy as jnp

        prompt = self.prompt_template.format(category=category)
        pre_ids, post_ids = self._prompt_ids(prompt)
        b = images.shape[0]
        out, spec = self._generate(
            images,
            jnp.tile(jnp.asarray([pre_ids], jnp.int32), (b, 1)),
            jnp.tile(jnp.asarray([post_ids], jnp.int32), (b, 1)))
        return (out, spec, n_real)

    def verify_pixels(self, pixels_u8, category: str):
        """verify_batch for decoded images: uint8 [B, S, S, 3] at
        `image_size` (no file decode on the host)."""
        import jax.numpy as jnp

        from mmrs_tpu.ops.preprocess import normalize_images

        images = normalize_images(jnp.asarray(pixels_u8),
                                  dtype=self.compute_dtype)
        n_real = images.shape[0]
        d = self._data_size()
        if n_real % d:
            images = jnp.concatenate(
                [images, jnp.repeat(images[:1], d - n_real % d, axis=0)])
        return self.collect(self._dispatch(images, category, n_real))

    def collect(self, handle):
        """Fetch + parse an async verify dispatch (see verify_batch_async)."""
        import numpy as np

        out, spec, n_real = handle
        if n_real == 0:
            return []
        results = []
        for row in np.asarray(out):
            ids = [int(t) for t in row if int(t) != self.eos_token]
            results.append(parse_yes_no(self.tokenizer.decode(ids)))
        self._record_spec(spec, len(results))
        return results[:n_real]

    def verify_batch(self, image_paths, category: str,
                     fixed_batch: int | None = None):
        """Batched VQA decode: one device dispatch for all gate survivors
        (vs the reference's one-image-at-a-time LLaVA loop,
        code/union_clip_llava2.py:172-260). Same prompt for every image, so
        the prompt tokens are shared and only images vary.

        `fixed_batch` pads the batch (repeating the first image) to a fixed
        compiled shape — a streaming cascade otherwise triggers one XLA
        compile per distinct survivor count (minutes each for the 7B
        decoder through this environment's remote compiler)."""
        return self.collect(
            self.verify_batch_async(image_paths, category,
                                    fixed_batch=fixed_batch))
