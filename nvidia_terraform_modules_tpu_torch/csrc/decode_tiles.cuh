// SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
// SPDX-License-Identifier: Apache-2.0
//
// The T=1 decode fold shared by the contiguous-cache kernel (kv_decode.cu,
// K6) and the paged kernel (paged_decode.cu, K7 and its int8 variant): the
// port of the reference's `_tile_fold` in
// nvidia_terraform_modules_tpu/ops/decode_attention.py, which both of its
// kernels call so that the paged kernel is the contiguous kernel run on the
// gathered view. Here too the two entry points differ only in where a key's
// row lives (ContiguousRows, TableRows); the staging, the scores, the
// online softmax and the PV product are this one function, with the same
// 64-key chunks from key 0 in the same order, so their results agree bit
// for bit on the same keys.
//
// Element types: T is q's and the output's (bf16 or f32), C the cache's (T
// itself, or int8 with per-vector f32 scales when kQuant). The scales fold
// where `_tile_fold` folds them: the k-scale into the f32 scores after the
// product and `scale`, the v-scale into P BEFORE P is rounded to T for the
// PV product. The l-sum takes the unscaled P.
//
// What bounds it: bytes (about one FLOP per cache byte, see the entry
// points). The CTA walks only the live keys s <= pos (rows past pos — the
// buffer's tail, recycled blocks, garbage block 0 — are never loaded), one
// CTA per (row, KV head) so a staged row serves every query head of its
// group, and rows are staged with 16-byte loads (8 bf16, 4 f32 or 16 int8
// values a thread), several in flight per thread.

#pragma once

#include "common.cuh"

namespace decode_tiles {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;   // keys staged per fold: two per lane of a warp

// Stage `rows` rows of `d` elements into the dense [rows, d] tile `dst`
// with 16-byte accesses, all kThreads threads of the block taking part;
// `src_row(r)` gives row r's source. Sources must be 16-byte aligned and
// d * sizeof(E) a multiple of 16 (the wrappers check contiguity and head
// dim). Each thread issues kBatch loads before its first store, so a chunk
// waits out about one memory latency, not one per row.
template <typename E, typename RowFn>
__device__ __forceinline__ void stage_rows(E* dst, int rows, int d,
                                           RowFn src_row) {
  constexpr int kVec = 16 / sizeof(E);
  constexpr int kBatch = 8;
  const int vpr = d / kVec;
  const int total = rows * vpr;
  for (int base = 0; base < total; base += kThreads * kBatch) {
    uint4 val[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + static_cast<int>(threadIdx.x);
      // set on every path, or ptxas keeps val on the stack
      val[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total) {
        const int r = i / vpr;
        val[u] = __ldg(reinterpret_cast<const uint4*>(src_row(r) +
                                                      (i - r * vpr) * kVec));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + static_cast<int>(threadIdx.x);
      if (i < total) {
        const int r = i / vpr;
        *reinterpret_cast<uint4*>(dst + r * d + (i - r * vpr) * kVec) =
            val[u];
      }
    }
  }
}

// Key s of batch row b, KV head kvh, in a contiguous [B, S, KV, (D)] cache:
// row (b·S + s)·KV + kvh. The scale sidecar [B, S, KV] has the same index.
struct ContiguousRows {
  long long base;   // b · S
  int kv_heads, kvh;
  __device__ void stage_chunk(int, int, int*) {}
  __device__ long long row(int s) const {
    return (base + s) * kv_heads + kvh;
  }
};

// Key s through the block tables: block table[s / bs], row s % bs of a
// [num_blocks, bs, KV, (D)] pool; the sidecar [num_blocks, bs, KV] is read
// through the same entry. The chunk's entries are staged in shared memory
// first, so a key's address costs no dependent global load of its own.
struct TableRows {
  const int* table;   // this batch row's NT entries
  int bs, kv_heads, kvh;
  int* blk;           // shared: the chunk's entries
  int e0;             // the chunk's first entry
  __device__ void stage_chunk(int s0, int n, int* scratch) {
    blk = scratch;
    e0 = s0 / bs;
    for (int i = threadIdx.x; i <= (s0 + n - 1) / bs - e0; i += kThreads)
      blk[i] = table[e0 + i];
  }
  __device__ long long row(int s) const {
    return (static_cast<long long>(blk[s / bs - e0]) * bs + s % bs) *
               kv_heads + kvh;
  }
};

// Dynamic shared memory of one CTA (the layout decode_fold carves).
template <typename C>
inline size_t smem_bytes(int rep, int d, bool quant, bool paged) {
  size_t bytes = 2 * static_cast<size_t>(kChunk) * d * sizeof(C) +
                 (2 * static_cast<size_t>(rep) * d +
                  static_cast<size_t>(rep) * kChunk + 3 * rep) * 4;
  if (quant) bytes += 2 * kChunk * 4;
  if (paged) bytes += (kChunk + 1) * 4;
  return bytes;
}

// One CTA's T=1 attention for batch row b and KV head kvh over keys
// 0 .. live-1: q [B, H, D] and out [B, H, D] in T; k/v rows of D values of
// C found through `rows`; k_scale/v_scale read at the same row index when
// kQuant.
template <typename T, typename C, bool kQuant, typename Rows>
__device__ __forceinline__ void decode_fold(
    const T* __restrict__ q, const C* __restrict__ k,
    const C* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, Rows rows, int live, int b, int kvh,
    int heads, int kv_heads, int d, float scale, T* __restrict__ out,
    unsigned char* smem) {
  const int rep = heads / kv_heads;
  C* ks = reinterpret_cast<C*>(smem);                      // [kChunk, d]
  C* vs = ks + kChunk * d;                                 // [kChunk, d]
  float* qs = reinterpret_cast<float*>(vs + kChunk * d);   // [rep, d]
  float* acc = qs + rep * d;                               // [rep, d]
  float* sc = acc + rep * d;                               // [rep, kChunk]
  float* m_s = sc + rep * kChunk;                          // [rep]
  float* l_s = m_s + rep;                                  // [rep]
  float* c_s = l_s + rep;                                  // [rep]
  float* ksc = c_s + rep;                  // [kChunk] when kQuant
  float* vsc = ksc + (kQuant ? kChunk : 0);                // [kChunk]
  int* scratch = reinterpret_cast<int*>(vsc + (kQuant ? kChunk : 0));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = kvh * rep;

  for (int i = threadIdx.x; i < rep * d; i += kThreads) {
    qs[i] = to_f32(q[(static_cast<long long>(b) * heads + h0) * d + i]);
    acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < rep; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  for (int s0 = 0; s0 < live; s0 += kChunk) {
    const int n = min(kChunk, live - s0);
    __syncthreads();   // the previous chunk's readers are done
    rows.stage_chunk(s0, n, scratch);
    __syncthreads();
    // stage keys s0 .. s0+n-1 of this KV head (and their scales)
    stage_rows(ks, n, d, [&](int j) -> const C* {
      return k + rows.row(s0 + j) * d;
    });
    stage_rows(vs, n, d, [&](int j) -> const C* {
      return v + rows.row(s0 + j) * d;
    });
    if (kQuant) {
      for (int j = threadIdx.x; j < n; j += kThreads) {
        const long long r = rows.row(s0 + j);
        ksc[j] = k_scale[r];
        vsc[j] = v_scale[r];
      }
    }
    __syncthreads();
    // scores: one warp per key, every query head of the group; f32 from
    // the exact f32 values of q and the cache, times scale, times k-scale
    for (int j = warp; j < n; j += kWarps) {
      for (int g = 0; g < rep; ++g) {
        float part = 0.f;
        for (int c = lane; c < d; c += 32)
          part = fmaf(qs[g * d + c], to_f32(ks[j * d + c]), part);
        part = warp_sum(part);
        if (lane == 0) {
          float s = part * scale;
          if (kQuant) s = s * ksc[j];
          sc[g * kChunk + j] = s;
        }
      }
    }
    __syncthreads();
    // online-softmax fold, one warp per query head: lane owns keys lane
    // and lane + 32 of the chunk (kChunk = 64)
    for (int g = warp; g < rep; g += kWarps) {
      float* sg = sc + g * kChunk;
      float s[2], p[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        s[jj] = j < n ? sg[j] : kNegInf;
      }
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        p[jj] = (s[jj] <= kNegInf * 0.5f) ? 0.f : expf(s[jj] - m_new);
        const int j = lane + 32 * jj;
        // P (v-scale folded in first) in q's dtype for the PV product
        if (j < n) sg[j] = round_to<T>(kQuant ? p[jj] * vsc[j] : p[jj]);
      }
      const float psum = warp_sum(p[0] + p[1]);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    // PV: one thread per (head, dim) output element
    for (int i = threadIdx.x; i < rep * d; i += kThreads) {
      const int g = i / d, c = i - g * d;
      const float* pg = sc + g * kChunk;
      float a = acc[i] * c_s[g];
      for (int j = 0; j < n; ++j) a = fmaf(pg[j], to_f32(vs[j * d + c]), a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rep * d; i += kThreads) {
    const int g = i / d;
    out[(static_cast<long long>(b) * heads + h0) * d + i] =
        from_f32<T>(acc[i] / l_s[g]);
  }
}

// The element-type checks both entry points share: a 16-byte vector holds
// whole rows' worth of values, d <= 256, GQA divides.
inline bool shape_ok(int heads, int kv_heads, int d, int batch, bool quant) {
  return !(d % (quant ? 16 : 8) || d < 8 || d > 256 || kv_heads < 1 ||
           heads % kv_heads || batch < 1);
}

}  // namespace decode_tiles
