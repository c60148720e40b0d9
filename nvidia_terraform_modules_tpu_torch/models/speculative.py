# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""Prompt-lookup speculative decoding — the port of the reference's
``models/speculative.py``.

Draft ``k`` tokens by bigram lookup in the context (no draft model), verify
them in ONE cached ``[1, k+1]`` forward, and accept the longest prefix that
the model's own argmax chain agrees with, plus the model's next token. The
tokens EQUAL ``greedy_decode``'s (the acceptance tests argmax equality;
the caveat, as in the reference, is that a ``[1, k+1]`` product may round
differently from the ``[1, 1]`` step's, so a bf16 near-tie may resolve
otherwise; at f32 on the CPU they are equal). The cache rolls back by
setting ``pos`` only: rows past it are masked and later overwritten.

:func:`_ngram_draft` and :func:`accept_drafts` take a leading batch
dimension, so the serve engine's speculative iteration
(``models/serving.py``) runs them over all slots at once.

The reference's loop is a device ``while_loop``; this one is a host loop
over the cached forward, one readback of the accepted count a
verification.

Under ``rules`` (a ``torch.distributed`` world) ``params`` are this
rank's shards and the cache holds its KV heads (``decode.init_cache``);
the batch of one is the same on every rank, so every rank drafts from the
same context and takes the same number of verification steps — which the
collectives of each step (the ``tp`` all-reduces, the MoE exchange over
``ep``) need. The batch being replicated, each ``ep`` member runs its
experts on the one row as it is (``decode._moe_ffn``'s ``replicated``:
nothing gathered over ``ep``), and whole ``wk``/``wv`` where ``tp`` does
not divide the KV heads are gathered once a call (``paged_params``).
"""

from __future__ import annotations

import torch

from ..telemetry import get_registry
from .burnin import BurnInConfig, _check_params, check_device
from .decode import (
    _forward_cached,
    _select_prefill_impl,
    init_cache,
    paged_params,
)


def _ngram_draft(ctx, cur_len, k: int, vocab: int):
    """Draft ``k`` tokens by bigram lookup in ``ctx`` ``[..., L]`` with
    ``cur_len`` ``[...]`` valid tokens: the LATEST ``i < cur_len - 2`` with
    ``ctx[i:i+2] == ctx[cur_len-2:cur_len]`` proposes ``ctx[i+2:i+2+k]``;
    no match repeats from the last token. Indices clip to the row, tokens
    to the vocabulary."""
    ctx = torch.as_tensor(ctx)
    cur = torch.as_tensor(cur_len, device=ctx.device).long()
    length = ctx.shape[-1]
    idx = torch.arange(length, device=ctx.device)
    nxt = torch.roll(ctx, -1, dims=-1)                 # nxt[i] = ctx[i+1]
    suf0 = torch.gather(ctx, -1, (cur - 2).clamp_min(0)[..., None])
    suf1 = torch.gather(ctx, -1, (cur - 1).clamp_min(0)[..., None])
    match = (ctx == suf0) & (nxt == suf1) & (idx + 2 < cur[..., None])
    pos = torch.where(match, idx, -1).amax(dim=-1)
    start = torch.where(pos >= 0, pos + 2, (cur - 1).clamp_min(0))
    at = (start[..., None] + torch.arange(k, device=ctx.device)).clamp(
        0, length - 1)
    return torch.gather(ctx, -1, at).clamp(0, vocab - 1)


def accept_drafts(draft, preds):
    """The acceptance core shared with the serve engine: the longest
    prefix of ``draft`` ``[..., k]`` agreeing with the model's argmax chain
    ``preds`` ``[..., k+1]``, with the model's next token spliced in behind
    it. Returns ``(new_toks [..., k+1], n_acc [...])``."""
    agree = draft == preds[..., :-1]
    stop = torch.cat([agree, torch.zeros_like(agree[..., :1])], dim=-1)
    n_acc = stop.int().argmin(dim=-1)                  # the first False
    new_toks = torch.cat([draft, torch.zeros_like(draft[..., :1])], dim=-1)
    new_toks = new_toks.scatter(-1, n_acc[..., None],
                                torch.gather(preds, -1, n_acc[..., None]))
    return new_toks, n_acc


@torch.no_grad()
def speculative_greedy_decode(params, prompt, n_new: int, cfg: BurnInConfig,
                              rules=None, k: int = 4,
                              max_len: int | None = None,
                              prefill: str = "auto", *, device="cuda"):
    """Greedy generation through prompt-lookup speculation. Returns
    ``(tokens [1, n_new], steps)``, ``steps`` the verification forwards
    run (``n_new / steps`` is the realised speedup over greedy decode's
    one forward a token). Batch must be 1; under ``rules`` every rank
    passes the same prompt (module docstring)."""
    dev = check_device(device)
    _check_params(params, dev)
    params = paged_params(params, cfg, rules)
    prompt = torch.as_tensor(prompt, device=dev).long()
    if prompt.shape[0] != 1:
        raise ValueError(
            f"speculative decode is a latency lever: batch must be 1, got "
            f"{prompt.shape[0]} (use greedy_decode for throughput batching)")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    t0 = prompt.shape[1]
    if max_len is None:
        max_len = t0 + n_new + k          # k rows of verification headroom
    if t0 + n_new + k > max_len:
        raise ValueError(
            f"prompt ({t0}) + n_new ({n_new}) + k ({k}) exceeds max_len "
            f"({max_len}) — speculation writes up to k draft rows past the "
            f"accepted position")
    cache = init_cache(cfg, 1, max_len, rules, device=dev)
    logits, cache = _forward_cached(
        params, prompt, cache, cfg, rules,
        _select_prefill_impl(cfg, t0, prefill, dev), replicated=True)
    ctx = torch.zeros((max_len,), dtype=torch.long, device=dev)
    ctx[:t0] = prompt[0]
    ctx[t0] = logits[0, -1].argmax()
    n_out, steps = 1, 0
    while n_out < n_new:
        cur = t0 + n_out                  # valid context length
        draft = _ngram_draft(ctx, cur, k, cfg.vocab)
        block = torch.cat([ctx[cur - 1:cur], draft])[None]      # [1, k+1]
        # "cached": a mid-stream T > 1 forward over the cache, never a
        # pos-0 prefill
        logits, cache = _forward_cached(params, block, cache, cfg, rules,
                                        "cached", replicated=True)
        new_toks, n_acc = accept_drafts(draft, logits[0].argmax(dim=-1))
        emit = min(int(n_acc) + 1, n_new - n_out)
        ctx[cur:cur + emit] = new_toks[:emit]
        # roll back: the new last token is not forwarded yet, so the cache
        # holds rows [0, cur + emit - 1); stale draft rows past it are
        # masked and later overwritten
        cache["pos"] = cur + emit - 1
        n_out += emit
        steps += 1
    return ctx[t0:t0 + n_new][None], steps


def make_speculative_decoder(cfg: BurnInConfig, rules=None, n_new: int = 32,
                             k: int = 4, max_len: int | None = None,
                             telemetry=None, *, device="cuda"):
    """The speculative greedy decoder: ``decoder(params, prompt) →
    (tokens [1, n_new], steps)``.

    With telemetry enabled (``telemetry=`` injection or
    ``TPU_TELEMETRY_DIR``) each call emits a ``spec_decode`` span and
    counts verification steps and accepted draft tokens: every
    verification emits one model token plus its accepted drafts, so
    ``n_new - steps`` is the draft-token count speculation bought (the
    reference's count). ``steps`` is a host integer here (the loop reads
    the accepted count back each verification), so the span adds no
    readback; disabled, the bare decoder is returned."""
    dev = check_device(device)

    def decoder(params, prompt):
        return speculative_greedy_decode(params, prompt, n_new, cfg, rules,
                                         k=k, max_len=max_len, device=dev)

    reg = telemetry if telemetry is not None else get_registry()
    if not reg.enabled:
        return decoder

    def instrumented(params, prompt):
        t0 = reg.clock()
        toks, steps = decoder(params, prompt)
        t1 = reg.clock()
        reg.emit_span("spec_decode", t0, t1, n_new=n_new,
                      verify_steps=steps)
        reg.counter("spec_verify_steps").inc(steps)
        reg.counter("spec_accepted_draft_tokens").inc(max(0, n_new - steps))
        return toks, steps

    return instrumented
