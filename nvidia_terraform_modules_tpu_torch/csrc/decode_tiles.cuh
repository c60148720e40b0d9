// SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
// SPDX-License-Identifier: Apache-2.0
//
// The T=1 decode fold shared by the contiguous-cache kernel (kv_decode.cu,
// K6) and the paged kernel (paged_decode.cu, K7 and its int8 variant): the
// port of the reference's `_tile_fold` in
// nvidia_terraform_modules_tpu/ops/decode_attention.py, which both of its
// kernels call so that the paged kernel is the contiguous kernel run on the
// gathered view. Here too the two entry points differ only in where a key's
// row lives (ContiguousRows, TableRows); the split of a row's keys, the
// staging, the scores, the online softmax, the PV product and the combine
// are this one function, so their results agree bit for bit on the same
// keys.
//
// Element types: T is q's and the output's (bf16 or f32), C the cache's (T
// itself, or int8 with per-vector f32 scales when kQuant). The scales fold
// where `_tile_fold` folds them: the k-scale into the f32 scores after the
// product and `scale`, the v-scale into P BEFORE P is rounded to T for the
// PV product. The l-sum takes the unscaled P.
//
// What bounds it: bytes (about one FLOP per cache byte, see the entry
// points). A T=1 step has few (row, KV head) pairs — 64 at the flagship
// serve wave — so one CTA per pair walking its keys in series leaves most
// of the card idle and waits out one memory latency per chunk. The design
// (flash-decoding over fixed spans):
// - a row's live keys 0..pos are cut into spans of kSpan keys from key 0.
//   The grid is (KV heads, rows, the spans of the row's whole buffer —
//   the table's width or S — never pos, so the host reads nothing from the
//   card); a CTA whose span starts past pos returns at once, so traffic
//   follows the live keys, and keys past pos (the buffer's tail, recycled
//   blocks, garbage block 0) are never read;
// - inside a span the keys come in chunks of kChunk through two
//   shared-memory stages filled by cp.async (16-byte copies; the rows'
//   table entries and scales with them): chunk c + 1 is in flight while
//   chunk c is folded, and one __syncthreads a chunk hands the stages
//   round;
// - every warp folds its own kSlice keys of each chunk with its own
//   (m, l, acc) per query head of the KV head's group, so all four warps
//   work at any GQA group size: a lane holds 4 dims (8-byte bf16, 4-byte
//   int8 or 16-byte f32 reads of a staged row), a key's score is a warp
//   sum, and the PV product is a lane's 4 dims over the slice's keys — no
//   thread walks the chunk's keys in series;
// - at the span's end the warps' states merge in warp order; a row with
//   one span writes its output at once, and otherwise each span writes its
//   unnormalised f32 (acc, m, l) to a workspace and the last CTA of the
//   (row, KV head) to arrive (an atomic counter, which it resets to 0)
//   combines the spans in span order 0, 1, 2, ... — in the same launch.
// kSpan is one constant, not derived from the batch, the grid or the card,
// and every sum runs in a fixed order, so a row's bits depend only on its
// own keys and position.

#pragma once

#include "common.cuh"

namespace decode_tiles {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 64;                   // keys one CTA folds
constexpr int kChunk = 32;                  // keys staged at a time
constexpr int kSlice = kChunk / kWarps;     // keys of a chunk each warp folds
constexpr int kGroups = 2;                  // a lane's 4-dim groups: d <= 256
static_assert(kSpan % kChunk == 0, "whole chunks in a span");

// Key s of batch row b, KV head kvh, in a contiguous [B, S, KV, (D)] cache:
// row (b·S + s)·KV + kvh. The scale sidecar [B, S, KV] has the same index.
struct ContiguousRows {
  long long base;   // b · S
  int kv_heads, kvh;
  __device__ long long row(int s) const {
    return (base + s) * kv_heads + kvh;
  }
};

// Key s through the block tables: block table[s / bs], row s % bs of a
// [num_blocks, bs, KV, (D)] pool; the sidecar [num_blocks, bs, KV] is read
// through the same entry. Each copy reads its own entry (through L1: the
// copies of one block share it), so any block size works.
struct TableRows {
  const int* table;   // this batch row's NT entries
  int bs, kv_heads, kvh;
  __device__ long long row(int s) const {
    return (static_cast<long long>(__ldg(table + s / bs)) * bs + s % bs) *
               kv_heads + kvh;
  }
};

// The number of spans of a buffer of `rows` keys: the grid's third
// dimension and the workspace's span count.
__host__ __device__ constexpr int spans_of(int rows) {
  return (rows + kSpan - 1) / kSpan;
}

// Dynamic shared memory of one CTA (the layout decode_span carves).
template <typename C>
inline size_t smem_bytes(int rep, int d, bool quant) {
  return 2 * 2 * static_cast<size_t>(kChunk) * d * sizeof(C)   // K, V stages
         + (quant ? 2 * 2 * kChunk * sizeof(float) : 0)        // their scales
         + static_cast<size_t>(rep) * d * sizeof(float)         // q
         + static_cast<size_t>(kWarps) * rep * (d + 2) * sizeof(float);
}

// 4 consecutive values of a staged row, widened to f32.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  x[0] = __low2float(lo);
  x[1] = __high2float(lo);
  x[2] = __low2float(hi);
  x[3] = __high2float(hi);
}
__device__ __forceinline__ void load4(const int8_t* p, float (&x)[4]) {
  const char4 u = *reinterpret_cast<const char4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}

// One warp's fold of its kSlice keys [s0, s0 + nk) of a staged chunk (kb,
// vb: the slice's rows; ksc, vsc: their scales) into its running (m, l)
// `ml` and `acc` for each of the rep query heads of its group.
template <typename T, typename C, bool kQuant>
__device__ __forceinline__ void fold_slice(const float* qs, const C* kb,
                                           const C* vb, const float* ksc,
                                           const float* vsc, int nk, int rep,
                                           int d, float scale, float* acc,
                                           float* ml, int lane) {
  for (int g = 0; g < rep; ++g) {
    // scores: f32 from the exact values of q and the cache, times scale,
    // times the k-scale; keys past the slice's live ones are masked
    float qv[kGroups][4];
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int c = 4 * lane + 128 * i;
      if (c < d) {
        load4(qs + g * d + c, qv[i]);
      } else {
        qv[i][0] = qv[i][1] = qv[i][2] = qv[i][3] = 0.f;
      }
    }
    float s[kSlice];
#pragma unroll
    for (int j = 0; j < kSlice; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int c = 4 * lane + 128 * i;
        if (c < d) {
          float kx[4];
          load4(kb + j * d + c, kx);
#pragma unroll
          for (int e = 0; e < 4; ++e) part = fmaf(qv[i][e], kx[e], part);
        }
      }
      part = warp_sum(part);
      float x = part * scale;
      if (kQuant) x = x * ksc[j];
      s[j] = j < nk ? x : kNegInf;
    }
    // the online-softmax fold of the slice, the same on every lane
    float* mg = ml + 2 * g;
    const float m_prev = mg[0], l_prev = mg[1];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kSlice; ++j) mx = fmaxf(mx, s[j]);
    const float m_new = fmaxf(m_prev, mx);
    const float corr = expf(m_prev - m_new);
    float psum = 0.f, pr[kSlice];
#pragma unroll
    for (int j = 0; j < kSlice; ++j) {
      const float p = (s[j] <= kNegInf * 0.5f) ? 0.f : expf(s[j] - m_new);
      psum += p;
      // P (v-scale folded in first) in q's dtype for the PV product
      pr[j] = round_to<T>(kQuant ? p * vsc[j] : p);
    }
    // PV: the lane's 4 dims of each group over the slice's keys
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int c = 4 * lane + 128 * i;
      if (c >= d) continue;
      float* ag = acc + g * d + c;
      float a[4];
      load4(ag, a);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] *= corr;
#pragma unroll
      for (int j = 0; j < kSlice; ++j) {
        float vx[4];
        load4(vb + j * d + c, vx);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = fmaf(pr[j], vx[e], a[e]);
      }
      *reinterpret_cast<float4*>(ag) = make_float4(a[0], a[1], a[2], a[3]);
    }
    __syncwarp();   // every lane has read (m, l)
    if (lane == 0) {
      mg[0] = m_new;
      mg[1] = l_prev * corr + psum;
    }
    __syncwarp();
  }
}

// One CTA's T=1 attention for batch row b and KV head kvh over its span
// (blockIdx.z) of keys 0 .. live-1: q [B, H, D] and out [B, H, D] in T;
// k/v rows of D values of C found through `rows`; k_scale/v_scale read at
// the same row index when kQuant. ws: the f32 partials [B, KV, spans,
// rep·(D + 2)] (spans = gridDim.z); counters: [B, KV] ints, zero between
// launches.
template <typename T, typename C, bool kQuant, typename Rows>
__device__ __forceinline__ void decode_span(
    const T* __restrict__ q, const C* __restrict__ k,
    const C* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, Rows rows, int live, int b, int kvh,
    int heads, int kv_heads, int d, float scale, T* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ counters,
    unsigned char* smem) {
  const int span = blockIdx.z;
  const int s_lo = span * kSpan;
  // a span past pos has nothing to fold (span 0 always runs: a row that
  // sees no key writes 0 / 0, as a fold over no keys would)
  if (span > 0 && s_lo >= live) return;
  const int n_spans = max(1, (live + kSpan - 1) / kSpan);
  const int s_hi = min(s_lo + kSpan, live);
  const int rep = heads / kv_heads;
  C* kst = reinterpret_cast<C*>(smem);                      // [2][kChunk][d]
  C* vst = kst + 2 * kChunk * d;                            // [2][kChunk][d]
  float* sc = reinterpret_cast<float*>(vst + 2 * kChunk * d);  // [2][2][kChunk]
  float* qs = sc + (kQuant ? 4 * kChunk : 0);               // [rep][d]
  float* acc = qs + rep * d;                                // [kWarps][rep][d]
  float* ml = acc + kWarps * rep * d;                       // [kWarps][rep][2]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h0 = kvh * rep;
  const int n_chunks = max(0, (s_hi - s_lo + kChunk - 1) / kChunk);

  // stage keys [s0, s0 + n) of chunk c into stage `buf`; rows past them are
  // zero-filled (src-size 0) and their table entries never read
  auto stage = [&](int c, int buf) {
    const int s0 = s_lo + c * kChunk, n = min(kChunk, s_hi - s0);
    constexpr int kVec = 16 / sizeof(C);
    const int vpr = d / kVec;
    C* kd = kst + buf * kChunk * d;
    C* vd = vst + buf * kChunk * d;
    for (int i = tid; i < kChunk * vpr; i += kThreads) {
      const int r = i / vpr, col = (i - r * vpr) * kVec;
      const bool ok = r < n;
      const long long row = ok ? rows.row(s0 + r) : 0;
      cp_async16(smem_addr(kd + r * d + col), ok ? k + row * d + col : k, ok);
      cp_async16(smem_addr(vd + r * d + col), ok ? v + row * d + col : v, ok);
    }
    if (kQuant) {
      float* ks = sc + buf * 2 * kChunk;
      for (int j = tid; j < kChunk; j += kThreads) {
        const bool ok = j < n;
        const long long row = ok ? rows.row(s0 + j) : 0;
        cp_async4(smem_addr(ks + j), ok ? k_scale + row : k_scale, ok);
        cp_async4(smem_addr(ks + kChunk + j), ok ? v_scale + row : v_scale,
                  ok);
      }
    }
  };
  if (n_chunks > 0) stage(0, 0);
  cp_async_commit();
  for (int i = tid; i < rep * d; i += kThreads)
    qs[i] = to_f32(q[(static_cast<long long>(b) * heads + h0) * d + i]);
  for (int i = tid; i < kWarps * rep * d; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < kWarps * rep; i += kThreads) {
    ml[2 * i] = kNegInf;
    ml[2 * i + 1] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    cp_async_wait<0>();   // chunk c is here (this thread's copies)
    __syncthreads();      // ... everyone's; chunk c - 1 is folded
    if (c + 1 < n_chunks) stage(c + 1, buf ^ 1);
    cp_async_commit();
    // this warp's slice of the chunk: keys [s0, s0 + nk)
    const int j0 = warp * kSlice;
    const int nk = min(kSlice, s_hi - (s_lo + c * kChunk + j0));
    if (nk > 0) {
      const float* ks = sc + buf * 2 * kChunk + j0;
      fold_slice<T, C, kQuant>(
          qs, kst + (buf * kChunk + j0) * d, vst + (buf * kChunk + j0) * d,
          ks, ks + kChunk, nk, rep, d, scale, acc + warp * rep * d,
          ml + warp * rep * 2, lane);
    }
  }
  cp_async_wait<0>();   // the last (empty) group
  __syncthreads();      // every warp's (m, l, acc) is in place

  // the span's (m, l, acc): the warps' states merged in warp order, then
  // either the output (one span) or this span's partials
  float* part = ws + ((static_cast<long long>(b) * kv_heads + kvh) *
                          gridDim.z + span) * rep * (d + 2);
  T* orow = out + (static_cast<long long>(b) * heads + h0) * d;
  for (int i = tid; i < rep * d; i += kThreads) {
    const int g = i / d;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, ml[2 * (w * rep + g)]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(ml[2 * (w * rep + g)] - m);
      a = fmaf(acc[w * rep * d + i], e, a);
      l = fmaf(ml[2 * (w * rep + g) + 1], e, l);
    }
    if (n_spans == 1) {
      orow[i] = from_f32<T>(a / l);
    } else {
      part[i] = a;
      if (i - g * d == 0) {
        part[rep * d + 2 * g] = m;
        part[rep * d + 2 * g + 1] = l;
      }
    }
  }
  if (n_spans == 1) return;

  // the last span of this (row, KV head) to arrive combines them all
  __shared__ int last;
  __threadfence();      // this span's partials are visible to the others
  __syncthreads();
  if (tid == 0) {
    int* count = counters + static_cast<long long>(b) * kv_heads + kvh;
    last = atomicAdd(count, 1) == n_spans - 1;
    if (last) *count = 0;   // every span is in: ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* part0 = ws + (static_cast<long long>(b) * kv_heads + kvh) *
                                gridDim.z * rep * (d + 2);
  const long long stride = static_cast<long long>(rep) * (d + 2);
  for (int i = tid; i < rep * d; i += kThreads) {
    const int g = i / d;
    float m = kNegInf;
    for (int j = 0; j < n_spans; ++j)
      m = fmaxf(m, __ldcg(part0 + j * stride + rep * d + 2 * g));
    float a = 0.f, l = 0.f;
    for (int j = 0; j < n_spans; ++j) {
      const float* pj = part0 + j * stride;
      const float e = expf(__ldcg(pj + rep * d + 2 * g) - m);
      a = fmaf(__ldcg(pj + i), e, a);
      l = fmaf(__ldcg(pj + rep * d + 2 * g + 1), e, l);
    }
    orow[i] = from_f32<T>(a / l);
  }
}

// The element-type checks both entry points share: a 16-byte vector holds
// whole rows' worth of values, d <= 256, GQA divides.
inline bool shape_ok(int heads, int kv_heads, int d, int batch, bool quant) {
  return !(d % (quant ? 16 : 8) || d < 8 || d > 128 * kGroups ||
           kv_heads < 1 || heads % kv_heads || batch < 1);
}

}  // namespace decode_tiles
