"""Speculative greedy decoding: draft-model proposals, target verification.

The 7B verifier's decode step is weight-bandwidth-bound (each step
streams the int8 weights + KV once per emitted token). Speculative decoding amortizes that stream: a small DRAFT model
proposes `k` tokens autoregressively (cheap — its weights are ~5% of the
target's), then the target verifies all k in ONE forward over k+1
positions — the same weight/KV traffic as a single decode step, but up to
k+1 tokens emitted. For greedy (temperature-0) decoding — the reference
verifier's config, code/test_llava.py:27-29 — acceptance is an exact
argmax comparison, so the OUTPUT IS IDENTICAL to plain greedy decode of
the target model for ANY draft model; the draft only affects speed
(tested: tests/test_speculative.py).

Mechanics:
  - the whole generate runs in one jit: a lax.while_loop over speculation
    rounds, each round = k unrolled draft steps + one target forward at
    T=k+1 (which uses the tensor cores far better than T=1). Draft step 0 runs at
    T=2 starting one slot back, repairing the frontier KV slot a
    fully-accepted round leaves unwritten — at zero extra weight traffic
    (the draft is bandwidth-bound). Round 0 seeds that first position
    with the prompt tail's embedding (an identical recompute), keeping a
    SINGLE traced round body;
  - batch rows DESYNCHRONIZE: each row accepts its own draft prefix
    length, so positions, cache writes, RoPE phases, and causal masks are
    all per-row ([B] pos_offset, threaded through llama.forward). Cache
    slots past a row's accepted frontier hold stale drafts, but every
    round rewrites [pos, pos+k] starting exactly at the frontier before
    any query can attend to them — no rollback pass is ever needed;
  - static shapes throughout: the output buffer carries `max_new + k + 1`
    slots so a round may overshoot, and the final mask restores greedy's
    EOS padding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mmrs_tpu.models.llama import (
    LlamaConfig, Params, embed_tokens, forward, prefill,
)


def speculative_generate(
    target_params: Params,
    draft_params: Params,
    target_embeds: jnp.ndarray,      # [B, T, D_target]
    draft_embeds: jnp.ndarray,       # [B, T, D_draft] — same T (aligned
                                     # positions; for LLaVA both models
                                     # must splice the same image slots)
    target_cfg: LlamaConfig,
    draft_cfg: LlamaConfig,
    max_new_tokens: int = 32,
    draft_tokens: int = 4,
    eos_token: int = 2,
    compute_dtype=jnp.bfloat16,
    kv_dtype=None,
    layers: str = "scan",
    prefill_chunk: int | None = None,
    return_stats: bool = False,
) -> jnp.ndarray:
    """Greedy decode of the TARGET model, accelerated by a draft model.

    Returns [B, max_new_tokens] int32, EOS-padded after finish — the same
    tokens `llama.greedy_generate(target_params, ...)` returns (argmax
    near-ties under different matmul tilings are the only possible
    divergence, same caveat as prefill_chunk).

    `draft_tokens` (k) is the speculation depth. Per round each active
    row emits between 1 (first draft rejected — the target's own argmax
    is emitted, so progress never stalls) and k+1 tokens (all drafts
    accepted + the verification pass's bonus token).

    `return_stats=True` additionally returns
    `{"rounds": [] int32, "emitted": [B] int32}` — speculation rounds
    executed and tokens emitted per row; `emitted / (rounds * (k+1))` is
    the realized per-round utilization, the number to watch when tuning
    k against a deployed draft.
    """
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError("target and draft must share a vocabulary")
    if target_embeds.shape[1] != draft_embeds.shape[1]:
        raise ValueError("target and draft prompts must be position-aligned")
    b, t, _ = target_embeds.shape
    k = int(draft_tokens)
    need = t + max_new_tokens + k
    for name, cfg in (("target", target_cfg), ("draft", draft_cfg)):
        if need > cfg.max_seq:
            raise ValueError(
                f"prompt ({t}) + max_new_tokens ({max_new_tokens}) + "
                f"draft_tokens ({k}) exceeds {name} max_seq ({cfg.max_seq})")
    cache_len = ((need + 63) // 64) * 64
    cd = compute_dtype

    tl, tcache = prefill(target_params, target_embeds, target_cfg,
                         min(target_cfg.max_seq, cache_len), cd, kv_dtype,
                         layers, prefill_chunk)
    _, dcache = prefill(draft_params, draft_embeds, draft_cfg,
                        min(draft_cfg.max_seq, cache_len), cd, kv_dtype,
                        layers, prefill_chunk)
    g0 = jnp.argmax(tl[:, -1, :], axis=-1).astype(jnp.int32)

    buf_len = max_new_tokens + k + 1
    out_buf = jnp.full((b, buf_len), eos_token, jnp.int32)
    out_buf = out_buf.at[:, 0].set(g0)

    # The round body's draft step 0 runs at T=2 starting one slot back
    # (see below); its first position re-derives the KV at slot pos-1
    # from that position's input EMBEDDING, carried in state. Seeding it
    # with the prompt tail's embedding makes round 0 identical to every
    # other round (single traced body): the rewrite of slot t-1 is a
    # recompute of the same inputs, hence the same KV.
    prev_emb0 = draft_embeds[:, -1, :]

    state = (
        g0,                                    # last emitted token [B]
        prev_emb0,                             # draft-embedding of the
                                               # token at slot pos-1 [B,D]
        jnp.full((b,), t, jnp.int32),          # next cache slot [B]
        jnp.ones((b,), jnp.int32),             # tokens emitted [B]
        g0 == eos_token,                       # finished [B]
        jnp.zeros((), jnp.int32),              # rounds executed
        tcache, dcache, out_buf,
    )

    def cond(state):
        return ~jnp.all(state[4])

    def round_body(state):
        (last_tok, prev_emb, pos, n_emitted, finished, rounds,
         tcache, dcache, out_buf) = state

        # --- draft: k autoregressive proposals at per-row positions ---
        # Step 0 at T=2 starting one slot back. A FULLY-accepted round
        # leaves slot pos-1 (= old pos+k, d_k's slot) at its init zeros —
        # without repair every later draft softmax sees a permanent
        # zero-KV hole and acceptance silently degrades in exactly the
        # high-alpha regime speculation targets (measured: identical
        # draft==target needed 14-20 rounds for 60 tokens instead of the
        # ideal 12). Folding the repair into this step's first position
        # makes it free: the draft is weight-bandwidth-bound, so T=2
        # streams the same weights as T=1 (an end-of-round backfill
        # forward — the first fix — cost one extra full draft pass per
        # round). For partially-accepted rows (and round 0) slot pos-1
        # was already written with the same inputs; the rewrite is a
        # numerically-identical no-op.
        e_last = embed_tokens(draft_params, last_tok[:, None])     # [B,1,D]
        emb = jnp.concatenate(
            [prev_emb[:, None, :].astype(e_last.dtype), e_last], axis=1)
        lg, dcache = forward(draft_params, emb, dcache, pos - 1,
                             draft_cfg, cd, layers=layers)
        cur = jnp.argmax(lg[:, -1, :], axis=-1).astype(jnp.int32)
        drafts = [cur]
        for j in range(1, k):               # static unroll
            emb = embed_tokens(draft_params, cur[:, None])
            lg, dcache = forward(draft_params, emb, dcache, pos + j,
                                 draft_cfg, cd,
                                 layers=layers)
            cur = jnp.argmax(lg[:, -1, :], axis=-1).astype(jnp.int32)
            drafts.append(cur)
        d = jnp.stack(drafts, axis=1)       # [B, k]

        # --- target: ONE forward over [last_tok, d_1..d_k] ---
        seq = jnp.concatenate([last_tok[:, None], d], axis=1)  # [B, k+1]
        # T=k+1 verification forward (per-row positions supported)
        lg, tcache = forward(target_params,
                             embed_tokens(target_params, seq),
                             tcache, pos, target_cfg, cd, layers=layers)
        g = jnp.argmax(lg, axis=-1).astype(jnp.int32)      # [B, k+1]
        # g[:, i] is the target's greedy choice after consuming
        # seq[:, :i+1] — g[:, 0] is what plain greedy would emit after
        # last_tok.

        # longest accepted draft prefix: d_i counts iff it equals the
        # target's choice at the same point
        match = (d == g[:, :k]).astype(jnp.int32)          # [B, k]
        a = jnp.cumprod(match, axis=1).sum(axis=1)         # [B] in [0,k]

        # emitted this round: g[:, :a+1] (accepted drafts + bonus),
        # cut at the first EOS inside that prefix
        idx = jnp.arange(k + 1)[None, :]
        eos_in_valid = (g == eos_token) & (idx <= a[:, None])
        has_eos = jnp.any(eos_in_valid, axis=1)
        first_eos = jnp.argmax(eos_in_valid, axis=1)
        last_idx = jnp.where(has_eos, first_eos, a)        # [B]
        n_new = jnp.where(finished, 0, last_idx + 1)

        # per-row append; slots >= the new n_emitted are stale but
        # every later round (and the final mask) overwrites them.
        # Finished rows must not write at all: their n_emitted can sit
        # near the buffer end, where dynamic_update_slice's
        # start-clamping would drag the (garbage) update window back
        # over valid tokens.
        out_buf = jax.vmap(
            lambda row, vals, s, fin: jnp.where(
                fin, row, jax.lax.dynamic_update_slice(row, vals, (s,)))
        )(out_buf, g, n_emitted, finished)

        new_last = g[jnp.arange(b), last_idx]
        # Token now at the new frontier-1 (slot pos+last_idx): last_tok
        # itself for last_idx==0, else the accepted draft d_{last_idx}.
        # The next round's T=2 step 0 re-derives its KV there from this
        # embedding.
        at_frontier = jnp.where(
            last_idx == 0, last_tok,
            jnp.take_along_axis(
                d, jnp.clip(last_idx - 1, 0, k - 1)[:, None],
                axis=1)[:, 0])
        new_prev = embed_tokens(draft_params, at_frontier[:, None])[:, 0]
        prev_emb = jnp.where(finished[:, None], prev_emb,
                             new_prev.astype(prev_emb.dtype))
        last_tok = jnp.where(finished, last_tok, new_last)
        pos = pos + n_new
        n_emitted = n_emitted + n_new
        finished = finished | has_eos | (n_emitted >= max_new_tokens)
        return (last_tok, prev_emb, pos, n_emitted, finished,
                rounds + 1, tcache, dcache, out_buf)

    state = jax.lax.while_loop(cond, round_body, state)
    n_emitted, rounds, out_buf = state[3], state[5], state[8]
    idx = jnp.arange(buf_len)[None, :]
    out = jnp.where(idx < n_emitted[:, None], out_buf, eos_token)
    out = out[:, :max_new_tokens]
    if return_stats:
        return out, {"rounds": rounds, "emitted": jnp.minimum(
            n_emitted, max_new_tokens)}
    return out
