// SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
// SPDX-License-Identifier: Apache-2.0
//
// Flash-attention forward for Hopper (sm_90a): two kernels of one sweep.
//
// Replaces the TPU kernels of nvidia_terraform_modules_tpu/ops/flash_attention.py
// - K1 `_fwd` (pallas_call of `_fwd_kernel`, with `_fwd_sweep`,
//   `_tile_scores`, `_fold_scores`): block-sparse causal / full /
//   sliding-window attention on [B, S, H, D] with an online softmax, O in
//   the input dtype and the f32 log-sum-exp LSE = m + log(max(l, 1e-30));
// - K2 `flash_partial` (pallas_call of `_fwd_partial_kernel`): the same
//   sweep of q over one visiting K/V block of ring attention (whose length
//   may differ from q's; causal masks in local positions) WITHOUT the
//   normalisation: the f32 accumulator, the running max m and the running
//   sum l, which the ring folds across blocks exactly.
// The two are one template (`kPartial`), as the reference shares
// `_fwd_sweep` between its two kernels: only the epilogue differs, so K2's
// acc / max(l, 1e-30), rounded to q's dtype, equals K1's output bit for bit.
//
// What bounds them on the H100: the two tile products, 4·Sq·Sk·D FLOPs per
// (batch, head) over the live part of the mask — compute-bound against the
// 989 TFLOP/s bf16 tensor-core peak once S is in the hundreds; the bytes
// (Q, K, V read once, O or the f32 accumulator written once) are a few MB
// to tens of MB.
//
// What the design does about it:
// - the TPU's sequential k grid becomes a loop inside the CTA: one CTA per
//   (b·h, 64-row q block), 4 warps, each warp owning 16 query rows; K/V
//   tiles of 64 rows are staged in shared memory and the [Sq, Sk] score
//   matrix never reaches device memory;
// - the loop stops at the causal diagonal and starts at the window's
//   first live key: dead tiles (the reference's block_liveness DEAD class)
//   are never loaded or multiplied;
// - bf16 tile products run on the tensor cores (nvcuda::wmma 16x16x16,
//   f32 accumulate); the f32 variant (the exactness path) uses CUDA-core
//   FMAs, since wmma has no full-f32 mode;
// - GQA reads KV head h / (H / KV) directly — K/V are never repeated;
// - Q/K/V/O are read and written through their strides, so the [B,S,H,D]
//   layout needs no transpose copy; a ragged Sq or Sk tail is zero-filled
//   and masked.
// Numerics follow `_fold_scores` / `_masked_exp` exactly: finite -1e30
// masking, p = 0 where s <= -1e30 / 2, the scale applied to the f32 scores
// after the product, P rounded to the value dtype before the PV product.
// Not yet done (later work): wgmma, TMA, a multi-stage K/V pipeline.

#include <type_traits>

#include "flash_tiles.cuh"

namespace {

constexpr int kWarps = 4;   // one 16-row band of the q block each
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kBQ / kWarps;

// K1 (kPartial = false): o in T through the strides `to`, lse [B, H, seq].
// K2 (kPartial = true): o is the f32 accumulator, contiguous [B, seq, H, d],
// lse receives m and l_out l, both [B, H, seq].
template <typename T, bool kPartial>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v,
                 std::conditional_t<kPartial, float, T>* __restrict__ o,
                 float* __restrict__ lse, float* __restrict__ l_out,
                 int seq, int kseq, int heads, int kv_heads, int d,
                 Strides tq, Strides tk, Strides tv, Strides to, float scale,
                 int mask, int window) {
  const int ldt = ld_tile<T>(d), lda = ld_acc<T>(d);
  constexpr int lds = ld_score<T>(), ldp = ld_prob<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBQ * ldt;
  T* vs = ks + kBK * ldt;
  float* ss = reinterpret_cast<float*>(vs + kBK * ldt);
  T* ps = reinterpret_cast<T*>(ss + kBQ * lds);
  float* os = reinterpret_cast<float*>(ps + kBQ * ldp);
  float* m_s = os + kBQ * lda;
  float* l_s = m_s + kBQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + b * tq.b + h * tq.h;
  const T* kb = k + b * tk.b + kvh * tk.h;
  const T* vb = v + b * tv.b + kvh * tv.h;

  for (int i = threadIdx.x; i < kBQ * lda; i += kThreads) os[i] = 0.f;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  load_tile<kThreads>(qs, qb, tq.s, q0, seq, d, ldt);

  // keys any row of this block can see: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, seq) - 1;
  const int k_hi = (mask == kFull) ? kseq : min(kseq, q_last + 1);
  const int k_lo = (mask == kWindow) ? max(0, q0 - (window - 1)) : 0;

  for (int kt = k_lo / kBK; kt * kBK < k_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done
    load_tile<kThreads>(ks, kb, tk.s, k0, kseq, d, ldt);
    load_tile<kThreads>(vs, vb, tv.s, k0, kseq, d, ldt);
    __syncthreads();
    tile_scores<kBK / 16>(qs, ks, ss, d, ldt, lds, warp, 0, lane);
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
        bool keep = kp < kseq;
        if (mask != kFull) keep = keep && kp <= qp;
        if (mask == kWindow) keep = keep && (qp - kp) < window;
        const float x = ss[r * lds + lane + 32 * jj] * scale;
        s[jj] = keep ? x : kNegInf;
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float p = (s[jj] <= kNegInf * 0.5f) ? 0.f : expf(s[jj] - m_new);
        psum += p;
        ps[r * ldp + lane + 32 * jj] = from_f32<T>(p);
      }
      psum = warp_sum(psum);
      const float corr = expf(m_prev - m_new);
      for (int c = lane; c < d; c += 32) os[r * lda + c] *= corr;
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
      }
    }
    __syncwarp();
    tile_pv(ps, vs, os, ldp, ldt, lda, warp, 0, d, lane);
  }
  __syncwarp();
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int qp = q0 + r;
    if (qp >= seq) break;
    auto* orow = o + b * to.b + static_cast<long long>(qp) * to.s + h * to.h;
    const long long row = static_cast<long long>(bh) * seq + qp;
    if constexpr (kPartial) {
      for (int c = lane; c < d; c += 32) orow[c] = os[r * lda + c];
      if (lane == 0) {
        lse[row] = m_s[r];
        l_out[row] = l_s[r];
      }
    } else {
      const float l = fmaxf(l_s[r], 1e-30f);
      for (int c = lane; c < d; c += 32)
        orow[c] = from_f32<T>(os[r * lda + c] / l);
      if (lane == 0) lse[row] = m_s[r] + logf(l);
    }
  }
}

template <typename T, bool kPartial>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           float* l_out, int batch, int seq, int kseq, int heads,
           int kv_heads, int d, Strides tq, Strides tk, Strides tv,
           Strides to, float scale, int mask, int window,
           cudaStream_t stream) {
  const size_t elt = sizeof(T);
  const size_t smem =
      static_cast<size_t>(kBQ + 2 * kBK) * ld_tile<T>(d) * elt   // Q, K, V
      + static_cast<size_t>(kBQ) * ld_score<T>() * 4              // S
      + static_cast<size_t>(kBQ) * ld_prob<T>() * elt             // P
      + static_cast<size_t>(kBQ) * ld_acc<T>(d) * 4               // O acc
      + 2 * kBQ * 4;                                              // m, l
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kPartial>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  using TO = std::conditional_t<kPartial, float, T>;
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * heads);
  flash_fwd_kernel<T, kPartial><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<TO*>(o), lse, l_out, seq, kseq,
      heads, kv_heads, d, tq, tk, tv, to, scale, mask, window);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int batch, int seq, int kseq, int heads, int kv_heads, int d,
           int mask, int window) {
  return d % 16 == 0 && d >= 16 && d <= 128 && kv_heads >= 1 &&
         heads % kv_heads == 0 && seq >= 1 && kseq >= 1 && batch >= 1 &&
         mask >= kCausal && mask <= kWindow &&
         (mask != kWindow || window >= 1);
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
  if (!valid(batch, seq, seq, heads, kv_heads, d, mask, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides tq{q_sb, q_ss, q_sh}, tk{k_sb, k_ss, k_sh},
      tv{v_sb, v_ss, v_sh}, to{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, false>(q, k, v, o, l, nullptr, batch, seq,
                                        seq, heads, kv_heads, d, tq, tk, tv,
                                        to, scale, mask, window, st);
  if (dtype == kF32)
    return launch<float, false>(q, k, v, o, l, nullptr, batch, seq, seq,
                                heads, kv_heads, d, tq, tk, tv, to, scale,
                                mask, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2: acc is f32 contiguous [B, seq, H, d]; m and l are f32 [B, H, seq].
extern "C" int tk_flash_partial(const void* q, const void* k, const void* v,
                                void* acc, void* m, void* l, int batch,
                                int seq, int kseq, int heads, int kv_heads,
                                int d, long long q_sb, long long q_ss,
                                long long q_sh, long long k_sb,
                                long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss,
                                long long v_sh, float scale, int mask,
                                int window, int dtype, void* stream) {
  if (!valid(batch, seq, kseq, heads, kv_heads, d, mask, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides tq{q_sb, q_ss, q_sh}, tk{k_sb, k_ss, k_sh},
      tv{v_sb, v_ss, v_sh},
      to{static_cast<long long>(seq) * heads * d,
         static_cast<long long>(heads) * d, d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, true>(q, k, v, acc, mp, lp, batch, seq,
                                       kseq, heads, kv_heads, d, tq, tk, tv,
                                       to, scale, mask, window, st);
  if (dtype == kF32)
    return launch<float, true>(q, k, v, acc, mp, lp, batch, seq, kseq,
                               heads, kv_heads, d, tq, tk, tv, to, scale,
                               mask, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* tk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
