"""int8 serving quantization for the towers (opt-in, serving only).

Tensor cores execute int8 x int8 -> int32 at twice the bf16 rate, and
the tower matmuls carry ~98% of the embed FLOPs, so quantizing the six
block kernels (+patch embedding) can halve matmul time per image. Weights get
per-output-channel symmetric scales at load time; activations are
dynamically quantized per row inside `layers.dense` (see
`layers._dense_int8`). Everything else — LayerNorm, softmax, residuals,
embeddings, the final projection — stays in the bf16/f32 serving mix, so
the numerics that decide ranking (f32 accumulation, f32 logits) are
unchanged.

Accuracy contract: int8-vs-f32 embedding cosine and top-k rank parity are
gated in tests/test_quantized_tower.py; the bf16-vs-f32 gate in
eval/parity.py covers the gallery side. The reference has no quantized
path (torch fp16 everywhere, e.g. code/search_image.py); this is
serving headroom, not a parity feature.
"""

from __future__ import annotations

from typing import Any, Dict

from mmrs_tpu.models.layers import QTensor, quantize_weight

Params = Dict[str, Any]

# kernel leaf names eligible for int8 (matmul right-hand sides [.., K, N])
_QUANT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w1", "w2", "patch_kernel"}
)


def quantize_tree(params: Params, keys=_QUANT_KEYS) -> Params:
    """Return a copy of a param tree with eligible kernels as QTensors.

    Works on any of our towers (ViT, text transformer, BERT): stacked
    per-layer kernels ([L, K, N]) quantize per (layer, out-channel) and
    still scan, since QTensor is a pytree.
    """

    def walk(node):
        if isinstance(node, dict):
            return {
                k: quantize_weight(v)
                if k in keys and not isinstance(v, (dict, QTensor))
                else walk(v)
                for k, v in node.items()
            }
        return node

    return walk(params)


def quantize_clip_visual(params: Params) -> Params:
    """CLIP param tree with the vision tower quantized, text left as-is."""
    out = dict(params)
    out["visual"] = quantize_tree(params["visual"])
    return out


# LLaMA adds the gated MLP + the (large: dim x vocab) lm_head; embeddings
# stay full precision (lookup, not a matmul)
_LM_KEYS = _QUANT_KEYS | frozenset({"w_gate", "w_up", "w_down", "lm_head"})


def quantize_llama(params: Params) -> Params:
    """LLaMA decoder with int8 serving weights. Decode is weight-bandwidth
    bound at verifier batch sizes, so halving the bytes ~doubles tokens/s
    (the reference serves its verifier in 8-bit too: load_8bit=True,
    code/test_llava.py:13 / union_clip_llava2.py)."""
    return quantize_tree(params, _LM_KEYS)


def quantize_llava(params: Params) -> Params:
    """LLaVA: int8 vision tower + int8 decoder; the 2-layer projector and
    embeddings stay bf16/f32 (negligible traffic, run once per image)."""
    out = dict(params)
    out["visual"] = quantize_tree(params["visual"])
    out["lm"] = quantize_llama(params["lm"])
    return out


def quantize_llama_int4(params: Params, group: int = 128,
                        keys=_LM_KEYS) -> Params:
    """LLaMA decoder with int4 grouped-quant serving weights (QTensor4,
    models/layers.py): HALF the int8 weight stream — the decode
    bandwidth floor. Group-wise
    scales along K (default 128, AWQ/GPTQ convention). Flows through the
    same `matmul` dispatch, so every decode form (fori/unroll/chunked
    prefill/speculative/TP) works unchanged. Quality at int4 requires a
    real-weight gate (like the int8 rank gates) before production use."""
    from mmrs_tpu.models.layers import QTensor4, quantize_weight_int4

    def walk(node):
        if isinstance(node, dict):
            return {
                k: quantize_weight_int4(v, group)
                if (k in keys
                    and not isinstance(v, (dict, QTensor, QTensor4)))
                else walk(v)
                for k, v in node.items()
            }
        return node

    return walk(params)
