"""LLaVA-style VLM: CLIP ViT features -> MLP projector -> LLaMA decoder.

The device-hosted implementation of the reference's verifier model
(liuhaotian/llava-v1.5-7b, code/test_llava.py:6-13): the image is encoded by
the CLIP ViT penultimate layer (patch tokens, CLS dropped — LLaVA's
`vision_feature_layer=-2`, `vision_feature_select_strategy="default"`),
projected into the decoder's embedding space by a 2-layer GELU MLP, spliced
into the prompt at the <image> position, and decoded greedily.

Weight converter maps the HF `LlavaForConditionalGeneration` layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from mmrs_tpu.models import llama, vit
from mmrs_tpu.models.configs import VITConfig
from mmrs_tpu.models.layers import dense, gelu, layer_norm, quick_gelu, scan_blocks
from mmrs_tpu.models.llama import LlamaConfig

Params = Dict[str, Any]


@dataclass(frozen=True)
class LLaVAConfig:
    vision: VITConfig
    lm: LlamaConfig
    vision_feature_layer: int = -2   # penultimate encoder layer
    drop_cls: bool = True


def vision_tokens(
    visual_params: Params,
    images: jnp.ndarray,             # [B, H, W, 3] normalized
    cfg: LLaVAConfig,
    compute_dtype=jnp.bfloat16,
) -> jnp.ndarray:                    # [B, N(, +1), W]
    """Hidden states after layer (layers + vision_feature_layer + 1) —
    i.e. -2 selects the output of the second-to-last block, matching HF's
    hidden_states indexing."""
    vcfg = cfg.vision
    x = vit.patchify(images, vcfg.patch_size)
    x = dense(x, visual_params["patch_kernel"], None, compute_dtype)
    cls = visual_params["class_embedding"].astype(compute_dtype)
    cls = jnp.broadcast_to(cls[None, None, :], (x.shape[0], 1, vcfg.width))
    x = jnp.concatenate([cls, x], axis=1)
    x = x + visual_params["positional_embedding"].astype(compute_dtype)[None]
    x = layer_norm(x, visual_params["ln_pre_scale"], visual_params["ln_pre_bias"])

    n_run = vcfg.layers + cfg.vision_feature_layer + 1
    sliced = jax.tree.map(lambda a: a[:n_run], visual_params["blocks"])
    act = quick_gelu if vcfg.quick_gelu else gelu
    x = scan_blocks(x, sliced, vcfg.heads, None, act, compute_dtype)
    if cfg.drop_cls:
        x = x[:, 1:, :]
    return x


def project(params: Params, feats: jnp.ndarray, compute_dtype=jnp.bfloat16):
    h = dense(feats, params["proj_w1"], params["proj_b1"], compute_dtype)
    h = gelu(h)
    return dense(h, params["proj_w2"], params["proj_b2"], compute_dtype)


def encode_images(params: Params, images: jnp.ndarray, cfg: LLaVAConfig,
                  compute_dtype=jnp.bfloat16) -> jnp.ndarray:
    feats = vision_tokens(params["visual"], images, cfg, compute_dtype)
    return project(params, feats, compute_dtype)      # [B, N, lm_dim]


def build_multimodal_embeds(
    params: Params,
    pre_tokens: jnp.ndarray,        # [B, T1] tokens before <image>
    image_embeds: jnp.ndarray,      # [B, N, D] projected image tokens
    post_tokens: jnp.ndarray,       # [B, T2] tokens after <image>
    compute_dtype=jnp.bfloat16,
) -> jnp.ndarray:
    emb = params["lm"]["embed"]
    pre = emb[pre_tokens].astype(compute_dtype)
    post = emb[post_tokens].astype(compute_dtype)
    return jnp.concatenate(
        [pre, image_embeds.astype(compute_dtype), post], axis=1
    )


def generate(
    params: Params,
    images: jnp.ndarray,
    pre_tokens: jnp.ndarray,
    post_tokens: jnp.ndarray,
    cfg: LLaVAConfig,
    max_new_tokens: int = 32,
    eos_token: int = 2,
    compute_dtype=jnp.bfloat16,
    kv_dtype=None,
    layers: str = "scan",
    prefill_chunk: int | None = None,
    decode_window: int | None = None,
    early_stop: bool = False,
) -> jnp.ndarray:
    """Greedy VQA decode (temp 0), the cascade verifier's contract.

    `kv_dtype=jnp.int8` serves the decoder with a quantized KV cache
    (llama.QKVCache): half the KV bytes per decode step, which at the
    ~600-token multimodal prompts (576 image tokens + text) is a large
    share of the per-step HBM traffic. `layers`/`prefill_chunk`/
    `decode_window` pass through to llama.greedy_generate (unrolled
    in-place cache decode / chunked causal prefill / segment-sliced
    decode cache reads — all matter most at exactly these prompt
    lengths)."""
    img = encode_images(params, images, cfg, compute_dtype)
    embeds = build_multimodal_embeds(params, pre_tokens, img, post_tokens,
                                     compute_dtype)
    return llama.greedy_generate(params["lm"], embeds, cfg.lm,
                                 max_new_tokens, eos_token, compute_dtype,
                                 kv_dtype=kv_dtype, layers=layers,
                                 prefill_chunk=prefill_chunk,
                                 decode_window=decode_window,
                                 early_stop=early_stop)


def generate_speculative(
    params: Params,
    draft_params: Params,
    images: jnp.ndarray,
    pre_tokens: jnp.ndarray,
    post_tokens: jnp.ndarray,
    cfg: LLaVAConfig,
    draft_cfg: LLaVAConfig,
    max_new_tokens: int = 32,
    draft_tokens: int = 4,
    eos_token: int = 2,
    compute_dtype=jnp.bfloat16,
    kv_dtype=None,
    layers: str = "scan",
    prefill_chunk: int | None = None,
    return_stats: bool = False,
) -> jnp.ndarray:
    """Greedy VQA decode accelerated by a smaller draft VLM.

    Both models encode the SAME image and prompt through their own vision
    tower / projector / embedding table, so the multimodal sequences are
    position-aligned (the vision grids must produce the same token count
    — e.g. any 336px/14 pair — and the models must share a tokenizer).
    The emitted tokens are the TARGET model's exact greedy output
    (models/speculative.py); the draft only sets the speed, which is what
    makes a 1B-class draft next to the 7B verifier safe to deploy.
    """
    from mmrs_tpu.models.speculative import speculative_generate

    img_t = encode_images(params, images, cfg, compute_dtype)
    emb_t = build_multimodal_embeds(params, pre_tokens, img_t, post_tokens,
                                    compute_dtype)
    img_d = encode_images(draft_params, images, draft_cfg, compute_dtype)
    emb_d = build_multimodal_embeds(draft_params, pre_tokens, img_d,
                                    post_tokens, compute_dtype)
    return speculative_generate(
        params["lm"], draft_params["lm"], emb_t, emb_d, cfg.lm,
        draft_cfg.lm, max_new_tokens=max_new_tokens,
        draft_tokens=draft_tokens, eos_token=eos_token,
        compute_dtype=compute_dtype, kv_dtype=kv_dtype, layers=layers,
        prefill_chunk=prefill_chunk, return_stats=return_stats)


def init(key: jax.Array, cfg: LLaVAConfig, dtype=jnp.float32) -> Params:
    kv, kp1, kp2, kl = jax.random.split(key, 4)
    return {
        "visual": vit.init(kv, cfg.vision, dtype),
        "proj_w1": (jax.random.normal(kp1, (cfg.vision.width, cfg.lm.dim))
                    * 0.02).astype(dtype),
        "proj_b1": jnp.zeros((cfg.lm.dim,), dtype),
        "proj_w2": (jax.random.normal(kp2, (cfg.lm.dim, cfg.lm.dim))
                    * 0.02).astype(dtype),
        "proj_b2": jnp.zeros((cfg.lm.dim,), dtype),
        "lm": llama.init(kl, cfg.lm, dtype),
    }


# --------------------------------------------------------------------------
# HF converters
# --------------------------------------------------------------------------

def hf_llama(sd, cfg: LlamaConfig, prefix: str = "model") -> Params:
    """HF LlamaForCausalLM state dict -> llama params."""
    def g(i, name):
        return sd[f"{prefix}.layers.{i}.{name}"]

    L = cfg.layers

    def stack_t(name):
        return jnp.asarray(np.stack([g(i, name).T for i in range(L)]))

    def stack(name):
        return jnp.asarray(np.stack([g(i, name) for i in range(L)]))

    embed = jnp.asarray(sd[f"{prefix}.embed_tokens.weight"])
    lm_head = (jnp.asarray(sd["lm_head.weight"].T)
               if "lm_head.weight" in sd else embed.T)
    return {
        "embed": embed,
        "blocks": {
            "attn_norm": stack("input_layernorm.weight"),
            "wq": stack_t("self_attn.q_proj.weight"),
            "wk": stack_t("self_attn.k_proj.weight"),
            "wv": stack_t("self_attn.v_proj.weight"),
            "wo": stack_t("self_attn.o_proj.weight"),
            "mlp_norm": stack("post_attention_layernorm.weight"),
            "w_gate": stack_t("mlp.gate_proj.weight"),
            "w_up": stack_t("mlp.up_proj.weight"),
            "w_down": stack_t("mlp.down_proj.weight"),
        },
        "final_norm": jnp.asarray(sd[f"{prefix}.norm.weight"]),
        "lm_head": lm_head,
    }


def hf_llava(sd, cfg: LLaVAConfig) -> Params:
    """HF LlavaForConditionalGeneration state dict -> llava params.

    Accepts both HF key layouts: the llava-v1.5 release layout
    ("vision_tower....", "language_model.model....",
    "language_model.lm_head.weight") and the transformers >= 4.52 layout
    (everything under "model.", lm_head hoisted to the top level)."""
    from mmrs_tpu.models.convert import hf_clip_vision

    sd = {k.replace("model.vision_tower.vision_tower.", "vision_tower.")
           .replace("model.vision_tower.", "vision_tower.")
           .replace("model.multi_modal_projector.",
                    "multi_modal_projector.")
           .replace("model.language_model.", "language_model.model.")
          : v for k, v in sd.items()}

    # vision tower keys are nested under vision_tower.
    vt = {k[len("vision_tower."):]: v for k, v in sd.items()
          if k.startswith("vision_tower.")}
    # hf_clip_vision expects a visual_projection; LLaVA has none — fake it
    # (proj unused because we take layer -2 features).
    vt["visual_projection.weight"] = np.zeros(
        (cfg.vision.embed_dim, cfg.vision.width), np.float32)
    visual = hf_clip_vision(vt, cfg.vision)

    lm_sd = {k[len("language_model."):]: v for k, v in sd.items()
             if k.startswith("language_model.")}
    # llava-v1.5's lm_head is UNTIED; the >=4.52 layout hoists it to the
    # top level, where the prefix strip above would lose it and hf_llama
    # would silently fall back to tied embeddings — wrong logits.
    if "lm_head.weight" not in lm_sd and "lm_head.weight" in sd:
        lm_sd["lm_head.weight"] = sd["lm_head.weight"]
    return {
        "visual": visual,
        "proj_w1": jnp.asarray(sd["multi_modal_projector.linear_1.weight"].T),
        "proj_b1": jnp.asarray(sd["multi_modal_projector.linear_1.bias"]),
        "proj_w2": jnp.asarray(sd["multi_modal_projector.linear_2.weight"].T),
        "proj_b2": jnp.asarray(sd["multi_modal_projector.linear_2.bias"]),
        "lm": hf_llama(lm_sd, cfg.lm),
    }
