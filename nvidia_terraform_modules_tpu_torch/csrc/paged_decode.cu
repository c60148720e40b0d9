// SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
// SPDX-License-Identifier: Apache-2.0
//
// Paged decode attention for Hopper (sm_90a): one T=1 decode step read
// straight through the block tables.
//
// Replaces the TPU kernel nvidia_terraform_modules_tpu/ops/decode_attention.py
// `paged_decode_attention` (pallas_call of `_paged_kernel`, with `_tile_fold`
// and `_block_diag_q`): q [B, H, D] attends over the physical pool
// [num_blocks, block_size, KV, D] through tables [B, NT] and per-row
// positions pos [B] (keys at logical s <= pos take part); bf16 and f32 pools.
//
// What bounds it on the H100: bytes. Each live cache row is read once and
// used for rep = H / KV query heads — about one FLOP per byte, far below
// the ~295 FLOP/byte at which the tensor cores would become the limit — so
// the floor is live K/V bytes / 3.35 TB/s.
//
// What the design does about it:
// - the CTA loads its row's position and table entries itself (the TPU's
//   scalar prefetch) and walks only the live keys s <= pos[b]: entries past
//   pos — the reserved garbage block 0 and blocks already recycled to
//   another request — are never read, so traffic scales with live tokens,
//   not with the pool;
// - one CTA per (row b, KV head): each staged K/V row (stride KV·D in the
//   pool) serves all rep query heads of its group, so GQA reads the cache
//   once per KV head;
// - keys are staged 64 at a time in shared memory with 16-byte loads, each
//   thread keeping several in flight; the chunk's table entries are staged
//   first, so a key's address costs no dependent load of its own. Any block
//   size works, since each key finds its own block;
// - the softmax fold runs one warp per query head, two keys per lane.
// Numerics follow `_tile_fold`: f32 scores scaled after the product, an
// online softmax in f32, P rounded to q's dtype before the PV product.
// Known limit, left for a later change: at the flagship wave (4 slots x 16
// KV heads) the grid is 64 CTAs on 132 SMs; splitting a row's keys across
// CTAs with a combine pass (flash-decoding) would fill the card.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;   // keys staged per fold: two per lane of a warp

// Stage `rows` rows of `d` elements into the dense [rows, d] tile `dst`
// with 16-byte accesses, all kThreads threads of the block taking part;
// `src_row(r)` gives row r's source. Sources must be 16-byte aligned and
// d * sizeof(T) a multiple of 16 (the wrapper checks contiguity and head
// dim). Each thread issues kBatch loads before its first store, so a chunk
// waits out about one memory latency, not one per row as a load-store loop
// would.
template <typename T, typename RowFn>
__device__ __forceinline__ void stage_rows(T* dst, int rows, int d,
                                           RowFn src_row) {
  constexpr int kVec = 16 / sizeof(T);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, T* __restrict__ out,
                    int heads, int kv_heads, int d, int bs, int nt,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rep = heads / kv_heads;
  T* ks = reinterpret_cast<T*>(smem);                  // [kChunk, d]
  T* vs = ks + kChunk * d;                             // [kChunk, d]
  float* qs = reinterpret_cast<float*>(vs + kChunk * d);   // [rep, d]
  float* acc = qs + rep * d;                           // [rep, d]
  float* sc = acc + rep * d;                           // [rep, kChunk]
  float* m_s = sc + rep * kChunk;                      // [rep]
  float* l_s = m_s + rep;                              // [rep]
  float* c_s = l_s + rep;                              // [rep]
  int* blk_s = reinterpret_cast<int*>(c_s + rep);      // [kChunk + 1]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = kvh * rep;
  const int live = min(pos[b] + 1, nt * bs);   // keys 0..pos[b]
  const int* row_table = tables + static_cast<long long>(b) * nt;

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
    const int e0 = s0 / bs;                  // first table entry of the chunk
    __syncthreads();   // the previous chunk's readers are done
    for (int i = threadIdx.x; i <= (s0 + n - 1) / bs - e0; i += kThreads)
      blk_s[i] = row_table[e0 + i];
    __syncthreads();
    // stage keys s0 .. s0+n-1 of this KV head, each from its own block
    auto row_of = [&](int j) {
      const int s = s0 + j;
      return (static_cast<long long>(blk_s[s / bs - e0]) * bs + s % bs) *
                 kv_heads + kvh;
    };
    stage_rows(ks, n, d, [&](int j) -> const T* {
      return k_pool + row_of(j) * d;
    });
    stage_rows(vs, n, d, [&](int j) -> const T* {
      return v_pool + row_of(j) * d;
    });
    __syncthreads();
    // scores: one warp per key, every query head of the group
    for (int j = warp; j < n; j += kWarps) {
      for (int g = 0; g < rep; ++g) {
        float part = 0.f;
        for (int c = lane; c < d; c += 32)
          part = fmaf(qs[g * d + c], to_f32(ks[j * d + c]), part);
        part = warp_sum(part);
        if (lane == 0) sc[g * kChunk + j] = part * scale;
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
        if (j < n) sg[j] = round_to<T>(p[jj]);   // P in q's dtype for PV
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

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* pos, void* out, int batch,
           int heads, int kv_heads, int d, int bs, int nt, float scale,
           cudaStream_t stream) {
  const int rep = heads / kv_heads;
  const size_t smem = 2 * static_cast<size_t>(kChunk) * d * sizeof(T) +
                      (2 * static_cast<size_t>(rep) * d +
                       static_cast<size_t>(rep) * kChunk + 3 * rep +
                       kChunk + 1) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(kv_heads, batch);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, pos, static_cast<T*>(out),
      heads, kv_heads, d, bs, nt, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tk_paged_decode(const void* q, const void* k_pool,
                               const void* v_pool, const void* tables,
                               const void* pos, void* out, int batch,
                               int heads, int kv_heads, int d, int bs,
                               int nt, float scale, int dtype, void* stream) {
  if (d % 8 || d < 8 || d > 256 || kv_heads < 1 || heads % kv_heads ||
      bs < 1 || nt < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tb, ps, out, batch,
                                 heads, kv_heads, d, bs, nt, scale, st);
  if (dtype == kF32)
    return launch<float>(q, k_pool, v_pool, tb, ps, out, batch, heads,
                         kv_heads, d, bs, nt, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
