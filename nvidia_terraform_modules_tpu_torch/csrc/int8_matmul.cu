// SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
// SPDX-License-Identifier: Apache-2.0
//
// int8-weight matrix product for Hopper (sm_90a): out = (x @ w_int8) * scale,
// x [M, K] bf16/f32 (M <= 64, the decode regime), w int8 in its storage
// orientation — [K, N], or [N, K] for the tied head (transpose) — and one f32
// scale per output channel, applied after the f32 accumulation.
//
// Replaces the TPU kernel nvidia_terraform_modules_tpu/ops/int8_matmul.py
// `int8_matmul` (pallas_call of `_kernel`): int8 tiles converted in the
// kernel right before the product, f32 accumulation, the per-channel scale
// in the epilogue. No transposed or dequantised copy of w is ever made.
//
// What bounds it on the H100: bytes. At M <= 64 a weight byte takes part in
// at most 2·64 operations, under the ~295 per byte at which the tensor
// cores would set the pace, so the floor is the int8 weight bytes over
// 3.35 TB/s — half of what a bf16 weight moves.
//
// What the design does about it:
// - every weight byte crosses HBM once per call, whatever M is: a CTA owns
//   a 64-column slice of N and a slice of K for ALL M rows, staging its
//   [ks, 64] int8 tile in shared memory once (16-byte loads along the
//   storage's contiguous axis: N for [K, N], K for the head's [N, K], which
//   is transposed into the tile while staging);
// - K is split across CTAs (ks = 256, or 128 when K is not a multiple of
//   256) so the flagship shapes put 256 (N = 2048, K = 2048) to 1,024 CTAs
//   on the 132 SMs where 64-column slices alone would give 32; a second
//   pass sums the slices' f32 partials in slice order and applies the scale;
// - each output element is one thread's f32 sum over its slice in
//   ascending k, and the slices add in a fixed order, so a row's result is
//   the same bits whatever M is (the serve wave's rows equal solo decode's).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;        // output columns per CTA
constexpr int kBatch = 4;      // 16-byte loads in flight per thread

// One CTA: partial[slice][m][n0 .. n0+63] over k in [k0, k0 + ks).
template <typename T, bool kTrans>
__global__ void __launch_bounds__(kThreads)
int8_mm_partial(const T* __restrict__ x, const int8_t* __restrict__ w,
                float* __restrict__ part, int m, int k, int n, int ks) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ws = reinterpret_cast<int8_t*>(smem);             // [ks, kBN]
  float* xs = reinterpret_cast<float*>(smem + ks * kBN);    // [m, ks]
  const int n0 = blockIdx.x * kBN, k0 = blockIdx.y * ks;
  const int tid = threadIdx.x;

  // the weight tile, 16 bytes a load, kBatch loads before the stores
  const int total = ks * kBN / 16;
  for (int base = 0; base < total; base += kThreads * kBatch) {
    uint4 val[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + tid;
      val[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total) {
        const int8_t* src;
        if (kTrans) {   // row n0 + r of [N, K], k0 + 16 c onwards
          const int c = i / kBN, r = i - c * kBN;
          src = w + static_cast<long long>(n0 + r) * k + k0 + 16 * c;
        } else {        // row k0 + r of [K, N], n0 + 16 c onwards
          const int r = i / (kBN / 16), c = i - r * (kBN / 16);
          src = w + static_cast<long long>(k0 + r) * n + n0 + 16 * c;
        }
        val[u] = __ldg(reinterpret_cast<const uint4*>(src));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + tid;
      if (i >= total) continue;
      if (kTrans) {     // 16 consecutive k of column r: a column of ws
        const int c = i / kBN, r = i - c * kBN;
        const unsigned int word[4] = {val[u].x, val[u].y, val[u].z,
                                      val[u].w};
#pragma unroll
        for (int e = 0; e < 16; ++e)   // byte e of the load (little endian)
          ws[(16 * c + e) * kBN + r] =
              static_cast<int8_t>((word[e / 4] >> (8 * (e % 4))) & 0xffu);
      } else {
        const int r = i / (kBN / 16), c = i - r * (kBN / 16);
        *reinterpret_cast<uint4*>(ws + r * kBN + 16 * c) = val[u];
      }
    }
  }
  // x's slice, widened to f32 (exact)
  for (int i = tid; i < m * ks; i += kThreads) {
    const int r = i / ks;
    xs[i] = to_f32(x[static_cast<long long>(r) * k + k0 + (i - r * ks)]);
  }
  __syncthreads();

  const int col = tid % kBN;
  for (int r = tid / kBN; r < m; r += kThreads / kBN) {
    const float* xr = xs + r * ks;
    float acc = 0.f;
    for (int kk = 0; kk < ks; ++kk)
      acc = fmaf(xr[kk], to_f32(ws[kk * kBN + col]), acc);
    part[(static_cast<long long>(blockIdx.y) * m + r) * n + n0 + col] = acc;
  }
}

// out[m][n] = (sum over slices, in order, of the partials) * scale[n]
template <typename T>
__global__ void int8_mm_finish(const float* __restrict__ part,
                               const float* __restrict__ scale,
                               T* __restrict__ out, int m, int n,
                               int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * n) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p)
    s += part[static_cast<long long>(p) * m * n + i];
  out[i] = from_f32<T>(s * scale[i % n]);
}

template <typename T, bool kTrans>
int launch(const void* x, const void* w, const float* scale, float* part,
           void* out, int m, int k, int n, int ks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(ks) * kBN +
                      static_cast<size_t>(m) * ks * 4;
  cudaError_t e = cudaFuncSetAttribute(
      int8_mm_partial<T, kTrans>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n / kBN, k / ks);
  int8_mm_partial<T, kTrans><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), part, m, k, n,
      ks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int outs = m * n;
  int8_mm_finish<T><<<(outs + 255) / 256, 256, 0, stream>>>(
      part, scale, static_cast<T*>(out), m, n, k / ks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, w, scale, part (f32 [K / ks, M, N] workspace), out; M, K, N, ks (the
// K slice: 128 or 256, dividing K), transpose (w is [N, K]), dtype code of
// x and out, stream.
extern "C" int tk_int8_matmul(const void* x, const void* w, const void* scale,
                              void* part, void* out, int m, int k, int n,
                              int ks, int transpose, int dtype,
                              void* stream) {
  if (m < 1 || m > 64 || (ks != 128 && ks != 256) || k < ks || k % ks ||
      n < kBN || n % kBN)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return transpose
               ? launch<__nv_bfloat16, true>(x, w, sc, pt, out, m, k, n, ks,
                                             st)
               : launch<__nv_bfloat16, false>(x, w, sc, pt, out, m, k, n, ks,
                                              st);
  if (dtype == kF32)
    return transpose
               ? launch<float, true>(x, w, sc, pt, out, m, k, n, ks, st)
               : launch<float, false>(x, w, sc, pt, out, m, k, n, ks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
