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
// positions pos [B] (keys at logical s <= pos take part). bf16 and f32
// pools, and int8 pools whose k_scale/v_scale [num_blocks, block_size, KV]
// f32 sidecars are read through the same table entry as their rows (the
// int8 variant, its own template instance).
//
// What bounds it on the H100: bytes. Each live cache row is read once and
// used for rep = H / KV query heads — about one FLOP per byte, far below
// the ~295 FLOP/byte at which the tensor cores would become the limit — so
// the floor is live K/V bytes (and scales) / 3.35 TB/s.
//
// What the design does about it (the fold is decode_tiles.cuh, shared with
// the contiguous kernel kv_decode.cu, so this kernel on the pool equals
// that one on the gathered view bit for bit):
// - flash-decoding over fixed spans: the grid is (KV heads, rows, spans of
//   kSpan keys over the table's width NT·bs), 512 CTAs at the flagship wave
//   (4 slots x 16 KV heads x 8 spans) where one CTA per (row, KV head) gave
//   64 on 132 SMs. A CTA whose span starts past pos[b] returns at once, so
//   traffic follows the live keys; the spans of a row are combined in span
//   order by the last of its CTAs to finish, in this launch;
// - each CTA reads its row's position and, per key copy, the key's table
//   entry itself (the TPU's scalar prefetch): entries past pos — the
//   reserved garbage block 0 and blocks already recycled to another
//   request, with their sidecars — are never read, and any block size
//   works, since each key finds its own block;
// - a staged K/V row (stride KV·D in the pool) serves all rep query heads
//   of its group, so GQA reads the cache once per KV head;
// - keys come through two cp.async stages of 32, so the next chunk's
//   copies overlap this chunk's fold, and all four warps fold their own
//   slice of each chunk.
// Numerics follow `_tile_fold`: f32 scores scaled after the product (then
// by the k-scale), an online softmax in f32, P (times the v-scale) rounded
// to q's dtype before the PV product.

#include "decode_tiles.cuh"

namespace {

using namespace decode_tiles;

template <typename T, typename C, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const C* __restrict__ k_pool,
                    const C* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, T* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters,
                    int heads, int kv_heads, int d, int bs, int nt,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  TableRows rows{tables + static_cast<long long>(b) * nt, bs, kv_heads, kvh};
  const int live = min(pos[b] + 1, nt * bs);   // keys 0..pos[b]
  decode_span<T, C, kQuant>(q, k_pool, v_pool, k_scale, v_scale, rows, live,
                            b, kvh, heads, kv_heads, d, scale, out, ws,
                            counters, smem);
}

template <typename T, typename C, bool kQuant>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* ks, const float* vs, const int* tables,
           const int* pos, void* out, float* ws, int* counters, int batch,
           int heads, int kv_heads, int d, int bs, int nt, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<C>(heads / kv_heads, d, kQuant);
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_kernel<T, C, kQuant>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(kv_heads, batch, spans_of(nt * bs));
  paged_decode_kernel<T, C, kQuant><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k_pool),
      static_cast<const C*>(v_pool), ks, vs, tables, pos,
      static_cast<T*>(out), ws, counters, heads, kv_heads, d, bs, nt, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k_pool, v_pool, k_scale, v_scale (null for bf16/f32 pools: then the
// pools have q's dtype; given: the pools are int8), tables, pos, out, ws
// (f32 [B, KV, spans, (H / KV)·(D + 2)]), counters (int [B, KV], zero);
// spans must be the split of the table's width, ceil(nt·bs / kSpan).
extern "C" int tk_paged_decode(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* tables,
                               const void* pos, void* out, void* ws,
                               void* counters, int batch, int heads,
                               int kv_heads, int d, int bs, int nt,
                               int spans, float scale, int dtype,
                               void* stream) {
  const bool quant = k_scale != nullptr;
  if (!shape_ok(heads, kv_heads, d, batch, quant) || bs < 1 || nt < 1 ||
      quant != (v_scale != nullptr) || spans != spans_of(nt * bs) ||
      spans > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  float* w = static_cast<float*>(ws);
  int* cn = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && quant)
    return launch<__nv_bfloat16, int8_t, true>(q, k_pool, v_pool, ks, vs, tb,
                                               ps, out, w, cn, batch, heads,
                                               kv_heads, d, bs, nt, scale,
                                               st);
  if (dtype == kF32 && quant)
    return launch<float, int8_t, true>(q, k_pool, v_pool, ks, vs, tb, ps,
                                       out, w, cn, batch, heads, kv_heads, d,
                                       bs, nt, scale, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pool, v_pool, nullptr, nullptr, tb, ps, out, w, cn, batch,
        heads, kv_heads, d, bs, nt, scale, st);
  if (dtype == kF32)
    return launch<float, float, false>(q, k_pool, v_pool, nullptr, nullptr,
                                       tb, ps, out, w, cn, batch, heads,
                                       kv_heads, d, bs, nt, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
