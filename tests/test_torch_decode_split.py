# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the decode kernels' split of a row's keys (flash-decoding
over fixed spans, ``csrc/decode_tiles.cuh``), on the CPU: the host-side
rule — the span count and the partials' shape follow from the buffer's
width and ``DECODE_SPAN`` alone, never from ``pos`` or the batch — the
scratch of partials and counters, and the split fold's arithmetic (spans of
``DECODE_SPAN`` keys, each folded by four warps over 8-key slices of
32-key chunks, merged in warp order and combined in span order) against
the plain version at positions on either side of each span boundary.

Tolerance: 1e-5 in f32 (the split folds in another order than the plain
one-pass softmax).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nvidia_terraform_modules_tpu_torch.ops import kv_decode_attention_ref
from nvidia_terraform_modules_tpu_torch.ops.decode_attention import (
    DECODE_SPAN,
    _span_scratch,
    decode_spans,
    decode_workspace_shape,
)

CSRC = (Path(__file__).resolve().parents[1] / "nvidia_terraform_modules_tpu_torch"
        / "csrc" / "decode_tiles.cuh")
NEG_INF = -1e30


def test_decode_span_is_the_kernels_constant():
    """The wrapper sizes the grid and the partials with the kernel's own
    span: one compile-time constant, from {64, 128, 256}."""
    src = CSRC.read_text()
    (span,) = re.findall(r"constexpr int kSpan = (\d+);", src)
    assert int(span) == DECODE_SPAN
    assert DECODE_SPAN in (64, 128, 256)


@pytest.mark.parametrize("rows", [1, DECODE_SPAN - 1, DECODE_SPAN,
                                  DECODE_SPAN + 1, 464, 768, 3840])
def test_decode_spans_follow_the_buffer_width(rows):
    assert decode_spans(rows) == -(-rows // DECODE_SPAN)
    assert (decode_spans(rows) - 1) * DECODE_SPAN < rows \
        <= decode_spans(rows) * DECODE_SPAN


def test_decode_spans_refuse_an_empty_buffer():
    with pytest.raises(ValueError, match="at least one key"):
        decode_spans(0)


@pytest.mark.parametrize("h,kv,d,rows", [(16, 16, 128, 464),
                                         (8, 2, 64, 300), (4, 1, 32, 70)])
def test_decode_workspace_follows_width_and_span_alone(h, kv, d, rows):
    """The partials: [B, KV, spans, (H / KV)·(D + 2)] — the same per row
    at any batch, and with no position among its inputs."""
    one = decode_workspace_shape(1, h, kv, d, rows)
    four = decode_workspace_shape(4, h, kv, d, rows)
    assert one == (1, kv, decode_spans(rows), h // kv * (d + 2))
    assert four == (4,) + one[1:]


def test_span_scratch_is_allocated_once_and_grown():
    """The partials and the counters: one scratch per device and stream,
    reused while it is large enough, grown (counters zeroed) when a launch
    needs more."""
    dev = torch.device("cpu")
    shape = decode_workspace_shape(4, 16, 16, 128, 464)
    ws, cnt = _span_scratch(dev, 12345, shape, 64)
    assert ws.dtype == torch.float32 and ws.numel() == np.prod(shape)
    assert cnt.dtype == torch.int32 and cnt.numel() >= 64
    assert not cnt.any()
    small = decode_workspace_shape(1, 16, 16, 128, 64)
    again = _span_scratch(dev, 12345, small, 16)
    assert again[0] is ws and again[1] is cnt             # reused
    wide = decode_workspace_shape(4, 16, 16, 128, 3840)
    ws2, cnt2 = _span_scratch(dev, 12345, wide, cnt.numel() + 1)
    assert ws2.numel() == np.prod(wide) and cnt2.numel() > cnt.numel()
    assert not cnt2.any()
    other = _span_scratch(dev, 54321, small, 16)
    assert other[0] is not ws2 and other[1] is not cnt2    # per stream


def _split_fold(q, k, v, pos, scale, chunk=32, warps=4):
    """The kernels' fold of one (row, KV head), in numpy f32: spans of
    DECODE_SPAN keys; in each span, chunks of ``chunk`` keys whose
    ``chunk / warps``-key slices each warp folds into its own (m, l, acc);
    the warps merged in warp order, the spans combined in span order."""
    rep, d = q.shape
    live = pos + 1
    sl = chunk // warps
    spans = []
    for s_lo in range(0, live, DECODE_SPAN):
        s_hi = min(s_lo + DECODE_SPAN, live)
        m = np.full((warps, rep), NEG_INF, np.float32)
        l = np.zeros((warps, rep), np.float32)
        acc = np.zeros((warps, rep, d), np.float32)
        for c0 in range(s_lo, s_hi, chunk):
            for w in range(warps):
                keys = np.arange(c0 + w * sl, min(c0 + (w + 1) * sl, s_hi))
                if keys.size == 0:
                    continue
                s = (q @ k[keys].T).astype(np.float32) * np.float32(scale)
                m_new = np.maximum(m[w], s.max(1))
                corr = np.exp(m[w] - m_new)
                p = np.exp(s - m_new[:, None])
                l[w] = l[w] * corr + p.sum(1)
                acc[w] = acc[w] * corr[:, None] + p @ v[keys]
                m[w] = m_new
        mm = m.max(0)
        e = np.exp(m - mm)
        spans.append((mm, (l * e).sum(0), (acc * e[:, :, None]).sum(0)))
    mm = np.max([s[0] for s in spans], 0)
    num = sum(a * np.exp(m_ - mm)[:, None] for m_, _, a in spans)
    den = sum(l_ * np.exp(m_ - mm) for m_, l_, _ in spans)
    return num / den[:, None]


@pytest.mark.parametrize("pos", [0, DECODE_SPAN - 1, DECODE_SPAN,
                                 DECODE_SPAN + 1, 2 * DECODE_SPAN + 5])
def test_split_fold_matches_plain_across_span_boundaries(pos):
    """The split's arithmetic (per-warp slices, warp merge, span combine)
    against the plain masked softmax, f32, GQA rep 2; keys past pos hold
    planted values that a read would show."""
    rng = np.random.default_rng(pos + 3)
    s_total, kv, rep, d = 3 * DECODE_SPAN, 2, 2, 16
    q = rng.normal(size=(1, kv * rep, d)).astype(np.float32)
    k = rng.normal(size=(1, s_total, kv, d)).astype(np.float32)
    v = rng.normal(size=(1, s_total, kv, d)).astype(np.float32)
    k[0, pos + 1:] = 1e4
    v[0, pos + 1:] = -1e4
    scale = d ** -0.5
    want = kv_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor([pos], dtype=torch.int32), scale=scale).numpy()
    for h in range(kv):
        got = _split_fold(q[0, h * rep:(h + 1) * rep], k[0, :, h],
                          v[0, :, h], pos, scale)
        np.testing.assert_allclose(got, want[0, h * rep:(h + 1) * rep],
                                   atol=1e-5, rtol=0)
