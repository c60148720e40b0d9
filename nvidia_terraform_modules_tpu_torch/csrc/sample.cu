// SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
// SPDX-License-Identifier: Apache-2.0
//
// D1: the keyed Gumbel-max draw for Hopper (sm_90a) — one token a row of
// tempered, filtered f32 logits [S, V], with JAX's threefry-2x32 bits.
//
// Not the port of a TPU kernel: the reference draws in XLA
// (nvidia_terraform_modules_tpu/models/decode.py `make_sampler`,
// `jax.random.categorical`), which fuses the generator, the Gumbel transform
// and the argmax into its jitted step. Eager PyTorch spends some two hundred
// elementwise launches on the same draw (ops/sampling.py `draw_ref`); this
// is one.
//
// What it computes, bit for bit as JAX does (jax_threefry_partitionable):
// row s's key is keys[s] (or the shared key), folded with (request,
// position) when `fold` is given — fold_in(k, d) = threefry(k, (0, d));
// element v's bits are x0 ^ x1 of threefry(key, (hi, lo)) of its count
// offsets[s] + v; u = max(tiny, (f - 1) * (1 - tiny) + tiny) with f the
// bits' top 23 as a mantissa of [1, 2); g = -log(-log(u)); the token is
// the first index of the largest logit + g (jnp.argmax: a NaN wins, ties go
// to the lowest index, a -inf logit never beats a finite one).
//
// What bounds it on the H100: neither bytes nor operations at the serve
// wave's shape. The bytes are the logits, 4 x 8192 x 4 = 128 KB at 4
// slots (0.04 us over 3.35 TB/s); the work, ~120 integer operations and two
// logf an element, is ~4 M operations. So the floor is the launch and one
// CTA's dependent chain. The design keeps it one launch: one CTA a row of
// 1024 threads (8 elements a thread at V = 8192), each thread keeps its
// own running best, then a warp-shuffle and a shared-memory reduction over
// (score, index). The build has no fast-math (ops/_build.py): logf here is
// libdevice's, which is what torch's CUDA log calls, so on the card the
// kernel gives the plain version's scores bit for bit.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kTiny = 1.17549435082228750797e-38f;   // FLT_MIN

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, in place on the counter words (x0, x1)
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// (s, i) beats (best, best_i): jnp.argmax's order — NaN first, then the
// larger score, then the lower index
__device__ __forceinline__ bool beats(float s, int i, float best,
                                      int best_i) {
  const bool sn = isnan(s), bn = isnan(best);
  if (sn || bn) return sn && (!bn || i < best_i);
  return s > best || (s == best && i < best_i);
}

__global__ void __launch_bounds__(kThreads)
sample_draw_kernel(const float* __restrict__ logits,
                   const long long* __restrict__ keys, int key_stride,
                   const long long* __restrict__ offsets,
                   const long long* __restrict__ fold,
                   long long* __restrict__ out, float* __restrict__ scores,
                   int v) {
  __shared__ float warp_best[kWarps];
  __shared__ int warp_idx[kWarps];
  const int row = blockIdx.x;
  uint32_t k0 = static_cast<uint32_t>(keys[row * key_stride]);
  uint32_t k1 = static_cast<uint32_t>(keys[row * key_stride + 1]);
  if (fold != nullptr) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t y0 = 0u, y1 = static_cast<uint32_t>(fold[2 * row + j]);
      threefry(k0, k1, y0, y1);
      k0 = y0;
      k1 = y1;
    }
  }
  const unsigned long long base =
      offsets != nullptr ? static_cast<unsigned long long>(offsets[row]) : 0ull;
  const float* lrow = logits + static_cast<size_t>(row) * v;
  float best = -INFINITY;
  int best_i = INT_MAX;
  for (int i = threadIdx.x; i < v; i += kThreads) {
    const unsigned long long c = base + static_cast<unsigned long long>(i);
    uint32_t x0 = static_cast<uint32_t>(c >> 32);
    uint32_t x1 = static_cast<uint32_t>(c);
    threefry(k0, k1, x0, x1);
    const uint32_t bits = x0 ^ x1;
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u);
    const float u = fmaxf(kTiny, (f - 1.0f) * (1.0f - kTiny) + kTiny);
    const float g = -logf(-logf(u));
    const float s = lrow[i] + g;
    if (scores != nullptr) scores[static_cast<size_t>(row) * v + i] = s;
    if (beats(s, i, best, best_i)) {
      best = s;
      best_i = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (beats(ob, oi, best, best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_best[warp] = best;
    warp_idx[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best = warp_best[lane];
    best_i = warp_idx[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      if (beats(ob, oi, best, best_i)) {
        best = ob;
        best_i = oi;
      }
    }
    if (lane == 0) out[row] = best_i;
  }
}

}  // namespace

// logits f32 [S, V]; keys int64, row stride 0 (one key) or 2 ([S, 2]);
// offsets int64 [S] or null (0); fold int64 [S, 2] (request, position) or
// null; out int64 [S]; scores f32 [S, V] or null (the debug copy).
extern "C" int tk_sample_draw(const void* logits, const void* keys,
                              int key_stride, const void* offsets,
                              const void* fold, void* out, void* scores,
                              int rows, int v, void* stream) {
  if (rows < 1 || rows > 65535 || v < 1 || (key_stride != 0 && key_stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  sample_draw_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const long long*>(keys),
      key_stride, static_cast<const long long*>(offsets),
      static_cast<const long long*>(fold), static_cast<long long*>(out),
      static_cast<float*>(scores), v);
  return static_cast<int>(cudaGetLastError());
}
