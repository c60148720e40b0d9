# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the decode entry points' signatures against the
reference's: the same parameter names in the same order, each of the same
kind (positional or keyword-only), with the port's keyword-only ``device``
set aside. A call written for the reference — ``greedy_decode(params,
prompt, 4, cfg, rules)``, ``make_decoder(cfg, rules)`` — then binds each
argument as the reference does. A planted signature with ``rules`` moved
must fail the comparison. ``forward_cached``'s ``int8_kernel``, there for
the reference's signature, routes nothing: ``False`` gives the reference's
logits under its ``int8_kernel=False``.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import decode as jdecode
from nvidia_terraform_modules_tpu.models import quantize as jquant
from nvidia_terraform_modules_tpu.models import speculative as jspec
from nvidia_terraform_modules_tpu_torch.models import (
    BurnInConfig,
    decode,
    params_from_numpy,
)
from nvidia_terraform_modules_tpu_torch.models import speculative as spec

# the package exports a function ``quantize`` under the module's name
quantize = importlib.import_module(
    "nvidia_terraform_modules_tpu_torch.models.quantize")

ENTRY_POINTS = [
    (decode, jdecode, "init_cache"),
    (decode, jdecode, "forward_cached"),
    (decode, jdecode, "greedy_decode"),
    (decode, jdecode, "sample_decode"),
    (decode, jdecode, "make_decoder"),
    (spec, jspec, "speculative_greedy_decode"),
    (spec, jspec, "make_speculative_decoder"),
    (quantize, jquant, "make_quantized_decoder"),
]


def _params(fn) -> list[tuple[str, str]]:
    """``(name, kind)`` of each parameter, the keyword-only ``device``
    set aside."""
    return [(p.name, p.kind.name)
            for p in inspect.signature(fn).parameters.values()
            if not (p.name == "device" and p.kind is p.KEYWORD_ONLY)]


def _mismatch(port_fn, ref_fn) -> list:
    """The first differing ``(name, kind)`` pairs, ``[]`` when the two
    signatures agree."""
    got, want = _params(port_fn), _params(ref_fn)
    if got == want:
        return []
    return [(g, w) for g, w in zip(got + [None] * len(want),
                                   want + [None] * len(got)) if g != w][:3]


@pytest.mark.parametrize("port,ref,name", ENTRY_POINTS,
                         ids=[e[2] for e in ENTRY_POINTS])
def test_decode_entry_point_matches_reference_signature(port, ref, name):
    assert _mismatch(getattr(port, name), getattr(ref, name)) == []
    assert "rules" in inspect.signature(getattr(port, name)).parameters


def test_device_stays_keyword_only():
    for port, _, name in ENTRY_POINTS:
        p = inspect.signature(getattr(port, name)).parameters.get("device")
        assert p is None or p.kind is p.KEYWORD_ONLY, name


def test_planted_moved_rules_fails_the_comparison():
    """``rules`` after ``max_len`` — the port's old order, under which the
    reference smoketest's ``greedy_decode(params, prompt, 4, cfg, rules)``
    bound the rules to ``max_len`` — is caught."""
    def planted(params, prompt, n_new, cfg, max_len=None, rules=None,
                prefill="auto", cache_dtype="bf16", *, device="cuda"):
        raise AssertionError("never called")

    assert _mismatch(planted, jdecode.greedy_decode)[0] == (
        ("max_len", "POSITIONAL_OR_KEYWORD"),
        ("rules", "POSITIONAL_OR_KEYWORD"))
    bound = inspect.signature(planted).bind("p", "x", 4, "cfg", "rules")
    assert bound.arguments["max_len"] == "rules"
    bound = inspect.signature(decode.greedy_decode).bind("p", "x", 4, "cfg",
                                                         "rules")
    assert bound.arguments["rules"] == "rules"


def test_forward_cached_int8_kernel_keyword_as_the_reference():
    """``forward_cached(int8_kernel=False)``, the reference's keyword
    (which guards its pallas kernel on mesh-sharded operands and routes
    nothing here): a prefill and one T=1 step over an int8 cache give the
    reference's logits under the same keyword, within 1e-5 (f32)."""
    kw = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
              seq_len=16, batch=2)
    jcfg = jburnin.BurnInConfig(**kw, dtype=jnp.float32)
    cfg = BurnInConfig(**kw, dtype=torch.float32)
    jp = jburnin.init_params(jax.random.PRNGKey(4), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    toks = np.random.default_rng(5).integers(0, 64, (2, 6)).astype(np.int32)
    jcache = jdecode.init_cache(jcfg, 2, 6, cache_dtype="int8")
    cache = decode.init_cache(cfg, 2, 6, cache_dtype="int8", device="cpu")
    want, got = [], []
    for part in (toks[:, :-1], toks[:, -1:]):
        lg, jcache = jdecode.forward_cached(jp, jnp.asarray(part), jcache,
                                            jcfg, int8_kernel=False)
        want.append(np.asarray(lg))
        lg, cache = decode.forward_cached(params, torch.from_numpy(part),
                                          cache, cfg,
                                          int8_kernel=False)
        got.append(lg.numpy())
    np.testing.assert_allclose(np.concatenate(got, 1),
                               np.concatenate(want, 1), rtol=1e-5,
                               atol=1e-5)
