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
// - the CTA loads its row's position and table entries itself (the TPU's
//   scalar prefetch) and walks only the live keys s <= pos[b]: entries past
//   pos — the reserved garbage block 0 and blocks already recycled to
//   another request, with their sidecars — are never read, so traffic
//   scales with live tokens, not with the pool;
// - one CTA per (row b, KV head): each staged K/V row (stride KV·D in the
//   pool) serves all rep query heads of its group, so GQA reads the cache
//   once per KV head;
// - keys are staged 64 at a time in shared memory with 16-byte loads, each
//   thread keeping several in flight; the chunk's table entries are staged
//   first, so a key's address costs no dependent load of its own. Any block
//   size works, since each key finds its own block;
// - the softmax fold runs one warp per query head, two keys per lane.
// Numerics follow `_tile_fold`: f32 scores scaled after the product (then
// by the k-scale), an online softmax in f32, P (times the v-scale) rounded
// to q's dtype before the PV product.
// Known limit, left for a later change: at the flagship wave (4 slots x 16
// KV heads) the grid is 64 CTAs on 132 SMs; splitting a row's keys across
// CTAs with a combine pass (flash-decoding) would fill the card.

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
                    int heads, int kv_heads, int d, int bs, int nt,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  TableRows rows{tables + static_cast<long long>(b) * nt, bs, kv_heads, kvh,
                 nullptr, 0};
  const int live = min(pos[b] + 1, nt * bs);   // keys 0..pos[b]
  decode_fold<T, C, kQuant>(q, k_pool, v_pool, k_scale, v_scale, rows, live,
                            b, kvh, heads, kv_heads, d, scale, out, smem);
}

template <typename T, typename C, bool kQuant>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* ks, const float* vs, const int* tables,
           const int* pos, void* out, int batch, int heads, int kv_heads,
           int d, int bs, int nt, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<C>(heads / kv_heads, d, kQuant, true);
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_kernel<T, C, kQuant>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(kv_heads, batch);
  paged_decode_kernel<T, C, kQuant><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k_pool),
      static_cast<const C*>(v_pool), ks, vs, tables, pos,
      static_cast<T*>(out), heads, kv_heads, d, bs, nt, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k_pool, v_pool, k_scale, v_scale (null for bf16/f32 pools: then the
// pools have q's dtype; given: the pools are int8), tables, pos, out.
extern "C" int tk_paged_decode(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* tables,
                               const void* pos, void* out, int batch,
                               int heads, int kv_heads, int d, int bs,
                               int nt, float scale, int dtype, void* stream) {
  const bool quant = k_scale != nullptr;
  if (!shape_ok(heads, kv_heads, d, batch, quant) || bs < 1 || nt < 1 ||
      quant != (v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && quant)
    return launch<__nv_bfloat16, int8_t, true>(q, k_pool, v_pool, ks, vs, tb,
                                               ps, out, batch, heads,
                                               kv_heads, d, bs, nt, scale,
                                               st);
  if (dtype == kF32 && quant)
    return launch<float, int8_t, true>(q, k_pool, v_pool, ks, vs, tb, ps,
                                       out, batch, heads, kv_heads, d, bs,
                                       nt, scale, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pool, v_pool, nullptr, nullptr, tb, ps, out, batch, heads,
        kv_heads, d, bs, nt, scale, st);
  if (dtype == kF32)
    return launch<float, float, false>(q, k_pool, v_pool, nullptr, nullptr,
                                       tb, ps, out, batch, heads, kv_heads,
                                       d, bs, nt, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
