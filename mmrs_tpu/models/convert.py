"""Torch/HF state-dict -> mmrs_tpu param-pytree converters.

The reference loads pretrained weights via `clip.load("ViT-B/32")`
(code/test_clip.py:6) and HF `CLIPModel`/`BertForSequenceClassification`
(code/test_taiyi.py:11-17). These converters map either checkpoint format
into our stacked-layer JAX pytrees so the same weights run in JAX.

All inputs are plain dicts of numpy arrays (call `.numpy()` on torch tensors
first, or use `state_dict_to_numpy`). Golden-parity tests construct a
randomly-initialized HF model offline, convert it, and assert embedding
equality — no network needed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import jax.numpy as jnp
import numpy as np

from mmrs_tpu.models.configs import BertConfig, TextConfig, VITConfig

Params = Dict[str, Any]
StateDict = Mapping[str, np.ndarray]


def state_dict_to_numpy(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Detach a torch state dict to numpy without importing torch here."""
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().float().numpy()
        out[k] = np.asarray(v)
    return out


def _stack(arrs) -> jnp.ndarray:
    return jnp.asarray(np.stack(arrs, axis=0))


def _lin(w: np.ndarray) -> jnp.ndarray:
    """torch Linear weight [out, in] -> kernel [in, out]."""
    return jnp.asarray(w.T)


def _conv_patch(w: np.ndarray) -> jnp.ndarray:
    """torch Conv2d weight [W, C, P, P] -> patchify kernel [P*P*C, W].

    Must match vit.patchify's (ph, pw, c) flatten order.
    """
    out, c, p, _ = w.shape
    return jnp.asarray(w.transpose(2, 3, 1, 0).reshape(p * p * c, out))


# --------------------------------------------------------------------------
# HF CLIPModel
# --------------------------------------------------------------------------

def _hf_blocks(sd: StateDict, prefix: str, layers: int) -> Params:
    def g(i, name):
        return sd[f"{prefix}.layers.{i}.{name}"]

    return {
        "ln1_scale": _stack([g(i, "layer_norm1.weight") for i in range(layers)]),
        "ln1_bias": _stack([g(i, "layer_norm1.bias") for i in range(layers)]),
        "ln2_scale": _stack([g(i, "layer_norm2.weight") for i in range(layers)]),
        "ln2_bias": _stack([g(i, "layer_norm2.bias") for i in range(layers)]),
        "attn": {
            "wq": _stack([g(i, "self_attn.q_proj.weight").T for i in range(layers)]),
            "bq": _stack([g(i, "self_attn.q_proj.bias") for i in range(layers)]),
            "wk": _stack([g(i, "self_attn.k_proj.weight").T for i in range(layers)]),
            "bk": _stack([g(i, "self_attn.k_proj.bias") for i in range(layers)]),
            "wv": _stack([g(i, "self_attn.v_proj.weight").T for i in range(layers)]),
            "bv": _stack([g(i, "self_attn.v_proj.bias") for i in range(layers)]),
            "wo": _stack([g(i, "self_attn.out_proj.weight").T for i in range(layers)]),
            "bo": _stack([g(i, "self_attn.out_proj.bias") for i in range(layers)]),
        },
        "mlp": {
            "w1": _stack([g(i, "mlp.fc1.weight").T for i in range(layers)]),
            "b1": _stack([g(i, "mlp.fc1.bias") for i in range(layers)]),
            "w2": _stack([g(i, "mlp.fc2.weight").T for i in range(layers)]),
            "b2": _stack([g(i, "mlp.fc2.bias") for i in range(layers)]),
        },
    }


def hf_clip_vision(sd: StateDict, cfg: VITConfig) -> Params:
    """HF CLIPModel vision half (+ visual_projection) -> vit params."""
    # HF has a historical typo: "pre_layrnorm" in some versions.
    pre_ln = "vision_model.pre_layrnorm" if "vision_model.pre_layrnorm.weight" in sd \
        else "vision_model.pre_layernorm"
    return {
        "patch_kernel": _conv_patch(sd["vision_model.embeddings.patch_embedding.weight"]),
        "class_embedding": jnp.asarray(sd["vision_model.embeddings.class_embedding"]),
        "positional_embedding": jnp.asarray(
            sd["vision_model.embeddings.position_embedding.weight"]
        ),
        "ln_pre_scale": jnp.asarray(sd[f"{pre_ln}.weight"]),
        "ln_pre_bias": jnp.asarray(sd[f"{pre_ln}.bias"]),
        "blocks": _hf_blocks(sd, "vision_model.encoder", cfg.layers),
        "ln_post_scale": jnp.asarray(sd["vision_model.post_layernorm.weight"]),
        "ln_post_bias": jnp.asarray(sd["vision_model.post_layernorm.bias"]),
        "proj": _lin(sd["visual_projection.weight"]),
    }


def hf_clip_text(sd: StateDict, cfg: TextConfig) -> Params:
    return {
        "token_embedding": jnp.asarray(sd["text_model.embeddings.token_embedding.weight"]),
        "positional_embedding": jnp.asarray(
            sd["text_model.embeddings.position_embedding.weight"]
        ),
        "blocks": _hf_blocks(sd, "text_model.encoder", cfg.layers),
        "ln_final_scale": jnp.asarray(sd["text_model.final_layer_norm.weight"]),
        "ln_final_bias": jnp.asarray(sd["text_model.final_layer_norm.bias"]),
        "text_projection": _lin(sd["text_projection.weight"]),
    }


def hf_clip(sd: StateDict, vision_cfg: VITConfig, text_cfg: TextConfig) -> Params:
    return {
        "visual": hf_clip_vision(sd, vision_cfg),
        "text": hf_clip_text(sd, text_cfg),
        "logit_scale": jnp.asarray(np.float32(sd["logit_scale"])),
    }


# --------------------------------------------------------------------------
# OpenAI clip package checkpoints (clip.load("ViT-B/32") state dict)
# --------------------------------------------------------------------------

def _openai_blocks(sd: StateDict, prefix: str, layers: int, width: int) -> Params:
    def g(i, name):
        return sd[f"{prefix}.resblocks.{i}.{name}"]

    wq, wk, wv, bq, bk, bv = [], [], [], [], [], []
    for i in range(layers):
        in_w = g(i, "attn.in_proj_weight")   # [3W, W]
        in_b = g(i, "attn.in_proj_bias")     # [3W]
        wq.append(in_w[:width].T); wk.append(in_w[width:2 * width].T)
        wv.append(in_w[2 * width:].T)
        bq.append(in_b[:width]); bk.append(in_b[width:2 * width])
        bv.append(in_b[2 * width:])
    return {
        "ln1_scale": _stack([g(i, "ln_1.weight") for i in range(layers)]),
        "ln1_bias": _stack([g(i, "ln_1.bias") for i in range(layers)]),
        "ln2_scale": _stack([g(i, "ln_2.weight") for i in range(layers)]),
        "ln2_bias": _stack([g(i, "ln_2.bias") for i in range(layers)]),
        "attn": {
            "wq": _stack(wq), "bq": _stack(bq),
            "wk": _stack(wk), "bk": _stack(bk),
            "wv": _stack(wv), "bv": _stack(bv),
            "wo": _stack([g(i, "attn.out_proj.weight").T for i in range(layers)]),
            "bo": _stack([g(i, "attn.out_proj.bias") for i in range(layers)]),
        },
        "mlp": {
            "w1": _stack([g(i, "mlp.c_fc.weight").T for i in range(layers)]),
            "b1": _stack([g(i, "mlp.c_fc.bias") for i in range(layers)]),
            "w2": _stack([g(i, "mlp.c_proj.weight").T for i in range(layers)]),
            "b2": _stack([g(i, "mlp.c_proj.bias") for i in range(layers)]),
        },
    }


def openai_clip(sd: StateDict, vision_cfg: VITConfig, text_cfg: TextConfig) -> Params:
    """OpenAI `clip` package checkpoint -> full dual-tower params."""
    visual = {
        "patch_kernel": _conv_patch(sd["visual.conv1.weight"]),
        "class_embedding": jnp.asarray(sd["visual.class_embedding"]),
        "positional_embedding": jnp.asarray(sd["visual.positional_embedding"]),
        "ln_pre_scale": jnp.asarray(sd["visual.ln_pre.weight"]),
        "ln_pre_bias": jnp.asarray(sd["visual.ln_pre.bias"]),
        "blocks": _openai_blocks(sd, "visual.transformer", vision_cfg.layers,
                                 vision_cfg.width),
        "ln_post_scale": jnp.asarray(sd["visual.ln_post.weight"]),
        "ln_post_bias": jnp.asarray(sd["visual.ln_post.bias"]),
        "proj": jnp.asarray(sd["visual.proj"]),  # already [W, D]
    }
    text = {
        "token_embedding": jnp.asarray(sd["token_embedding.weight"]),
        "positional_embedding": jnp.asarray(sd["positional_embedding"]),
        "blocks": _openai_blocks(sd, "transformer", text_cfg.layers, text_cfg.width),
        "ln_final_scale": jnp.asarray(sd["ln_final.weight"]),
        "ln_final_bias": jnp.asarray(sd["ln_final.bias"]),
        "text_projection": jnp.asarray(sd["text_projection"]),  # [W, D]
    }
    return {
        "visual": visual,
        "text": text,
        "logit_scale": jnp.asarray(np.float32(sd["logit_scale"])),
    }


# --------------------------------------------------------------------------
# HF BertForSequenceClassification (Taiyi text tower)
# --------------------------------------------------------------------------

def hf_bert_classifier(sd: StateDict, cfg: BertConfig) -> Params:
    def g(i, name):
        return sd[f"bert.encoder.layer.{i}.{name}"]

    layers = cfg.layers
    blocks = {
        "attn": {
            "wq": _stack([g(i, "attention.self.query.weight").T for i in range(layers)]),
            "bq": _stack([g(i, "attention.self.query.bias") for i in range(layers)]),
            "wk": _stack([g(i, "attention.self.key.weight").T for i in range(layers)]),
            "bk": _stack([g(i, "attention.self.key.bias") for i in range(layers)]),
            "wv": _stack([g(i, "attention.self.value.weight").T for i in range(layers)]),
            "bv": _stack([g(i, "attention.self.value.bias") for i in range(layers)]),
            "wo": _stack([g(i, "attention.output.dense.weight").T for i in range(layers)]),
            "bo": _stack([g(i, "attention.output.dense.bias") for i in range(layers)]),
        },
        "attn_ln_scale": _stack([g(i, "attention.output.LayerNorm.weight") for i in range(layers)]),
        "attn_ln_bias": _stack([g(i, "attention.output.LayerNorm.bias") for i in range(layers)]),
        "mlp": {
            "w1": _stack([g(i, "intermediate.dense.weight").T for i in range(layers)]),
            "b1": _stack([g(i, "intermediate.dense.bias") for i in range(layers)]),
            "w2": _stack([g(i, "output.dense.weight").T for i in range(layers)]),
            "b2": _stack([g(i, "output.dense.bias") for i in range(layers)]),
        },
        "out_ln_scale": _stack([g(i, "output.LayerNorm.weight") for i in range(layers)]),
        "out_ln_bias": _stack([g(i, "output.LayerNorm.bias") for i in range(layers)]),
    }
    return {
        "word_embeddings": jnp.asarray(sd["bert.embeddings.word_embeddings.weight"]),
        "position_embeddings": jnp.asarray(sd["bert.embeddings.position_embeddings.weight"]),
        "token_type_embeddings": jnp.asarray(sd["bert.embeddings.token_type_embeddings.weight"]),
        "emb_ln_scale": jnp.asarray(sd["bert.embeddings.LayerNorm.weight"]),
        "emb_ln_bias": jnp.asarray(sd["bert.embeddings.LayerNorm.bias"]),
        "blocks": blocks,
        "pooler_kernel": _lin(sd["bert.pooler.dense.weight"]),
        "pooler_bias": jnp.asarray(sd["bert.pooler.dense.bias"]),
        "classifier_kernel": _lin(sd["classifier.weight"]),
        "classifier_bias": jnp.asarray(sd["classifier.bias"]),
    }
