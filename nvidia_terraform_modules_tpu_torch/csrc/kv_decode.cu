// SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
// SPDX-License-Identifier: Apache-2.0
//
// Contiguous-cache decode attention for Hopper (sm_90a): one T=1 decode
// step over a [B, S, KV, D] cache, int8 with per-vector f32 scales (the
// int8 KV cache's decode step) or bf16/f32.
//
// Replaces the TPU kernel nvidia_terraform_modules_tpu/ops/decode_attention.py
// `kv_decode_attention` / `int8_kv_decode_attention` (pallas_call of
// `_kernel`, which folds each S-tile with `_tile_fold`): q [B, H, D] attends
// over keys s <= pos[b] of row b; with k_scale/v_scale [B, S, KV] the cache
// is int8 and the scales fold after the products (scale-after-dot).
//
// What bounds it on the H100: bytes. Each live cache row is read once and
// serves rep = H / KV query heads, about one FLOP per byte against the ~295
// at which the tensor cores would set the pace, so the floor is the live
// K/V bytes (plus 4 bytes of scale a row when int8) over 3.35 TB/s. An
// int8 cache moves (D + 4) / (2 D) of a bf16 cache's bytes.
//
// What the design does about it (decode_tiles.cuh, shared with the paged
// kernel): flash-decoding over fixed spans — the grid is (KV heads, rows,
// spans of kSpan keys over S), and a CTA whose span starts past pos[b]
// returns at once, so blocks past pos, the buffer's 256-row tail included,
// are never loaded (the reference's `pl.when` skip) while the live keys of
// even a batch of 8 fill the card (1,152 live CTAs at 8 x 16 KV heads x
// 9 spans of the decode step); the spans of a row are combined in span
// order by the last of its CTAs, in this launch. A staged row serves every
// query head of its group (GQA without repeating the cache); int8 rows
// load 16 values per 16-byte copy and convert to f32 at the product.

#include "decode_tiles.cuh"

namespace {

using namespace decode_tiles;

template <typename T, typename C, bool kQuant>
__global__ void __launch_bounds__(kThreads)
kv_decode_kernel(const T* __restrict__ q, const C* __restrict__ k,
                 const C* __restrict__ v, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale,
                 const int* __restrict__ pos, T* __restrict__ out,
                 float* __restrict__ ws, int* __restrict__ counters,
                 int heads, int kv_heads, int d, int s_total, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  ContiguousRows rows{static_cast<long long>(b) * s_total, kv_heads, kvh};
  const int live = min(pos[b] + 1, s_total);   // keys 0..pos[b]
  decode_span<T, C, kQuant>(q, k, v, k_scale, v_scale, rows, live, b, kvh,
                            heads, kv_heads, d, scale, out, ws, counters,
                            smem);
}

template <typename T, typename C, bool kQuant>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* pos, void* out, float* ws,
           int* counters, int batch, int heads, int kv_heads, int d,
           int s_total, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<C>(heads / kv_heads, d, kQuant);
  cudaError_t e = cudaFuncSetAttribute(
      kv_decode_kernel<T, C, kQuant>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(kv_heads, batch, spans_of(s_total));
  kv_decode_kernel<T, C, kQuant><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), ks, vs, pos, static_cast<T*>(out), ws,
      counters, heads, kv_heads, d, s_total, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, k_scale, v_scale (null unless quant), pos, out, ws (f32
// [B, KV, spans, (H / KV)·(D + 2)]), counters (int [B, KV], zero); quant
// = 1: the cache is int8 and the scales are given, 0: the cache has q's
// dtype; spans must be the split of S, ceil(S / kSpan).
extern "C" int tk_kv_decode(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* pos, void* out, void* ws,
                            void* counters, int batch, int heads,
                            int kv_heads, int d, int s_total, int spans,
                            float scale, int dtype, int quant,
                            void* stream) {
  if (!shape_ok(heads, kv_heads, d, batch, quant) || s_total < 1 ||
      (quant && (k_scale == nullptr || v_scale == nullptr)) ||
      spans != spans_of(s_total) || spans > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* ps = static_cast<const int*>(pos);
  float* w = static_cast<float*>(ws);
  int* cn = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && quant)
    return launch<__nv_bfloat16, int8_t, true>(q, k, v, ks, vs, ps, out, w,
                                               cn, batch, heads, kv_heads, d,
                                               s_total, scale, st);
  if (dtype == kF32 && quant)
    return launch<float, int8_t, true>(q, k, v, ks, vs, ps, out, w, cn,
                                       batch, heads, kv_heads, d, s_total,
                                       scale, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k, v, nullptr, nullptr, ps, out, w, cn, batch, heads, kv_heads, d,
        s_total, scale, st);
  if (dtype == kF32)
    return launch<float, float, false>(q, k, v, nullptr, nullptr, ps, out, w,
                                       cn, batch, heads, kv_heads, d,
                                       s_total, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
