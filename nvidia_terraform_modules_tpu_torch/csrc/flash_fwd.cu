// SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
// SPDX-License-Identifier: Apache-2.0
//
// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel nvidia_terraform_modules_tpu/ops/flash_attention.py
// `_fwd` (pallas_call of `_fwd_kernel`, with `_fwd_sweep`, `_tile_scores`,
// `_fold_scores`): block-sparse causal / full / sliding-window attention on
// [B, S, H, D] with an online softmax, O in the input dtype and the f32
// log-sum-exp LSE = m + log(max(l, 1e-30)).
//
// What bounds it on the H100: at the serve path's prompt lengths (128-512
// tokens, D = 128) the work is the two tile products, 4·S²/2·D FLOPs per
// (batch, head) — compute-bound against the 989 TFLOP/s bf16 tensor-core
// peak once S is in the hundreds; the bytes (Q, K, V read once, O written
// once) are a few MB.
//
// What the design does about it:
// - the TPU's sequential k grid becomes a loop inside the CTA: one CTA per
//   (b·h, 64-row q block), 4 warps, each warp owning 16 query rows; K/V
//   tiles of 64 rows are staged in shared memory and the [S, S] score
//   matrix never reaches device memory;
// - the loop stops at the causal diagonal and starts at the window's
//   first live key: dead tiles (the reference's block_liveness DEAD class)
//   are never loaded or multiplied;
// - bf16 tile products run on the tensor cores (nvcuda::wmma 16x16x16,
//   f32 accumulate); the f32 variant (the exactness path) uses CUDA-core
//   FMAs, since wmma has no full-f32 mode;
// - GQA reads KV head h / (H / KV) directly — K/V are never repeated;
// - Q/K/V/O are read and written through their strides, so the [B,S,H,D]
//   layout needs no transpose copy; a ragged S tail is zero-filled and
//   masked.
// Numerics follow `_fold_scores` / `_masked_exp` exactly: finite -1e30
// masking, p = 0 where s <= -1e30 / 2, the scale applied to the f32 scores
// after the product, P rounded to the value dtype before the PV product.
// Not yet done (later work): wgmma, TMA, a multi-stage K/V pipeline.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 64;             // key rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kBQ / kWarps;   // 16: one wmma row band
enum Mask { kCausal = 0, kFull = 1, kWindow = 2 };

struct Strides {   // element strides of the b, s and h dimensions
  long long b, s, h;
};

// Stage rows [row0, row0 + 64) of one head into a dense [64, d] tile,
// zero-filling rows past the sequence end.
template <typename T>
__device__ void load_tile(T* dst, const T* base, long long row_stride,
                          int row0, int seq, int d) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = d / kVec;
  for (int i = threadIdx.x; i < kBK * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq)
      val = *reinterpret_cast<const uint4*>(
          base + static_cast<long long>(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * d + c) = val;
  }
}

// S[16 rows of this warp, 64] = Q_w · K^T (f32), bf16 on the tensor cores.
__device__ void tile_scores(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                            float* ss, int d, int warp, int /*lane*/) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBK / 16];
#pragma unroll
  for (int n = 0; n < kBK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
  const __nv_bfloat16* qw = qs + warp * kRowsPerWarp * d;
  for (int kk = 0; kk < d; kk += 16) {
    wmma::load_matrix_sync(a, qw + kk, d);
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      // K^T as a col-major matrix: element (dim, key) at ks[key * d + dim]
      wmma::load_matrix_sync(b, ks + n * 16 * d + kk, d);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kBK / 16; ++n)
    wmma::store_matrix_sync(ss + warp * kRowsPerWarp * kBK + n * 16, acc[n],
                            kBK, wmma::mem_row_major);
}

// The f32 variant on the CUDA cores. Each lane walks the head dim from its
// own offset, so the 32 lanes' K rows hit 32 different banks.
__device__ void tile_scores(const float* qs, const float* ks, float* ss,
                            int d, int warp, int lane) {
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const float* qr = qs + r * d;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = lane + 32 * jj;
      const float* kr = ks + j * d;
      float acc = 0.f;
      int c = lane % d;
      for (int t = 0; t < d; ++t) {
        acc = fmaf(qr[c], kr[c], acc);
        c = (c + 1 == d) ? 0 : c + 1;
      }
      ss[r * kBK + j] = acc;
    }
  }
}

// O_w[16, d] += P_w[16, 64] · V[64, d], accumulator kept in shared memory.
__device__ void tile_pv(const __nv_bfloat16* ps, const __nv_bfloat16* vs,
                        float* os, int d, int warp, int /*lane*/) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      a[kBK / 16];
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wmma::load_matrix_sync(a[kk], ps + warp * kRowsPerWarp * kBK + kk * 16,
                           kBK);
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
  float* ow = os + warp * kRowsPerWarp * d;
  for (int n = 0; n < d; n += 16) {
    wmma::load_matrix_sync(o, ow + n, d, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::load_matrix_sync(b, vs + kk * 16 * d + n, d);
      wmma::mma_sync(o, a[kk], b, o);
    }
    wmma::store_matrix_sync(ow + n, o, d, wmma::mem_row_major);
  }
}

__device__ void tile_pv(const float* ps, const float* vs, float* os, int d,
                        int warp, int lane) {
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const float* pr = ps + r * kBK;
    for (int c = lane; c < d; c += 32) {
      float acc = os[r * d + c];
      for (int j = 0; j < kBK; ++j) acc = fmaf(pr[j], vs[j * d + c], acc);
      os[r * d + c] = acc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq, int heads, int kv_heads,
                 int d, Strides tq, Strides tk, Strides tv, Strides to,
                 float scale, int mask, int window) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBQ * d;
  T* vs = ks + kBK * d;
  float* ss = reinterpret_cast<float*>(vs + kBK * d);
  T* ps = reinterpret_cast<T*>(ss + kBQ * kBK);
  float* os = reinterpret_cast<float*>(ps + kBQ * kBK);
  float* m_s = os + kBQ * d;
  float* l_s = m_s + kBQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + b * tq.b + h * tq.h;
  const T* kb = k + b * tk.b + kvh * tk.h;
  const T* vb = v + b * tv.b + kvh * tv.h;

  for (int i = threadIdx.x; i < kBQ * d; i += kThreads) os[i] = 0.f;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  load_tile(qs, qb, tq.s, q0, seq, d);

  // keys any row of this block can see: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, seq) - 1;
  const int k_hi = (mask == kFull) ? seq : q_last + 1;
  const int k_lo = (mask == kWindow) ? max(0, q0 - (window - 1)) : 0;

  for (int kt = k_lo / kBK; kt * kBK < k_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done
    load_tile(ks, kb, tk.s, k0, seq, d);
    load_tile(vs, vb, tv.s, k0, seq, d);
    __syncthreads();
    tile_scores(qs, ks, ss, d, warp, lane);
    __syncwarp();
    // online-softmax fold of this warp's 16 rows; lane owns keys lane and
    // lane + 32 of the tile
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qp = q0 + r;
      float s[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int kp = k0 + lane + 32 * jj;
        bool keep = kp < seq;
        if (mask != kFull) keep = keep && kp <= qp;
        if (mask == kWindow) keep = keep && (qp - kp) < window;
        const float x = ss[r * kBK + lane + 32 * jj] * scale;
        s[jj] = keep ? x : kNegInf;
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float p = (s[jj] <= kNegInf * 0.5f) ? 0.f : expf(s[jj] - m_new);
        psum += p;
        ps[r * kBK + lane + 32 * jj] = from_f32<T>(p);
      }
      psum = warp_sum(psum);
      const float corr = expf(m_prev - m_new);
      for (int c = lane; c < d; c += 32) os[r * d + c] *= corr;
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
      }
    }
    __syncwarp();
    tile_pv(ps, vs, os, d, warp, lane);
  }
  __syncwarp();
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int qp = q0 + r;
    if (qp >= seq) break;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = o + b * to.b + static_cast<long long>(qp) * to.s + h * to.h;
    for (int c = lane; c < d; c += 32) orow[c] = from_f32<T>(os[r * d + c] / l);
    if (lane == 0) lse[static_cast<long long>(bh) * seq + qp] = m_s[r] + logf(l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int seq, int heads, int kv_heads, int d, Strides tq,
           Strides tk, Strides tv, Strides to, float scale, int mask,
           int window, cudaStream_t stream) {
  const size_t elt = sizeof(T);
  const size_t smem = static_cast<size_t>(kBQ + 2 * kBK) * d * elt  // Q, K, V
                      + static_cast<size_t>(kBQ) * kBK * (4 + elt)  // S, P
                      + static_cast<size_t>(kBQ) * d * 4            // O acc
                      + 2 * kBQ * 4;                                // m, l
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * heads);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seq, heads,
      kv_heads, d, tq, tk, tv, to, scale, mask, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tk_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int batch, int seq,
                            int heads, int kv_heads, int d, long long q_sb,
                            long long q_ss, long long q_sh, long long k_sb,
                            long long k_ss, long long k_sh, long long v_sb,
                            long long v_ss, long long v_sh, long long o_sb,
                            long long o_ss, long long o_sh, float scale,
                            int mask, int window, int dtype, void* stream) {
  if (d % 16 || d < 16 || d > 128 || kv_heads < 1 || heads % kv_heads ||
      seq < 1 || batch < 1 || (mask == kWindow && window < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides tq{q_sb, q_ss, q_sh}, tk{k_sb, k_ss, k_sh},
      tv{v_sb, v_ss, v_sh}, to{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, o, l, batch, seq, heads, kv_heads,
                                 d, tq, tk, tv, to, scale, mask, window, st);
  if (dtype == kF32)
    return launch<float>(q, k, v, o, l, batch, seq, heads, kv_heads, d, tq,
                         tk, tv, to, scale, mask, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* tk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
