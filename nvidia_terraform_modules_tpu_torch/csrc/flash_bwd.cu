// SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
// SPDX-License-Identifier: Apache-2.0
//
// Flash-attention backward for Hopper (sm_90a): three kernels.
//
// Replaces the TPU kernels of nvidia_terraform_modules_tpu/ops/flash_attention.py
// - flash_bwd_fused (+ dq_finalize): `flash_dqdkv` (pallas_call of
//   `_fused_bwd_kernel`, with `_fused_sub_tile`) — dQ, dK, dV in one pass;
// - flash_dq: `flash_dq` (pallas_call of `_dq_kernel`) — the split path's dQ;
// - flash_dkv: `flash_dkv` (pallas_call of `_dkv_kernel`) — its dK, dV.
// All three share `_bwd_tile`'s math: S recomputed as f32 from input-dtype
// operands with the scale after the product and finite -1e30 masking,
// P = exp(S - LSE) from the forward's saved LSE (not a running max), forced
// to 0 where S <= -1e30 / 2, dP = dO V^T in f32, dS = P (dP - delta) in f32;
// P is rounded to dO's dtype before dV = P^T dO, dS to q's / k's dtype
// before dK = dS^T Q and dQ = dS K, and the scale multiplies dQ and dK at
// finalize. Inputs are MHA [B, S, H, D] (contiguous); LSE and delta are
// [B, H, S] f32. The gradients are written in the inputs' dtype or, for
// ring attention's per-block calls (`out_dtype=jnp.float32` in the
// reference's ring backward), in f32: the output type TO is a template
// parameter, so dq_finalize writes ws·scale as f32 and dK/dV leave their
// f32 accumulators uncast.
//
// What bounds them on the H100: per (batch, head) the fused pass does five
// 64x64xD tile products per live tile (2.5x the forward's FLOPs), the split
// pair seven (3 in flash_dq, 4 in flash_dkv); at the train step's
// [2, 4096, 16, 128] that is 344 / 206 / 275 GFLOP against a few tens of MB
// of Q, K, V, dO, dQ, dK, dV — compute-bound against the 989 TFLOP/s bf16
// tensor-core peak.
//
// What the design does about it:
// - the TPU's sequential grid becomes a loop inside the CTA. flash_dq: one
//   CTA per (b·h, 64-row q block), Q/dO/LSE/delta staged once, a loop over
//   the live k blocks. flash_dkv and flash_bwd_fused: one CTA per (b·h,
//   64-row k block), K/V resident in shared memory, a loop over the live q
//   blocks (for causal, from the block's diagonal to the end; for a window,
//   up to the last query that sees the block). Dead tiles (block_liveness's
//   DEAD class) are never loaded;
// - the TPU keeps full-length f32 dK/dV scratch (2·S·d·4 B) in VMEM, which
//   does not fit an SM at S = 4096. Here a CTA owns ONE k block, so its dK
//   and dV accumulators are [64, d] f32 in shared memory; the fused kernel
//   instead spreads dQ: each tile's dS K is added with atomicAdd into a
//   zeroed f32 workspace [B, S, H, D], and dq_finalize writes
//   (ws · scale) in q's dtype. The atomics make dQ's summation order vary
//   from run to run: the fused dQ holds against its plain version at a
//   tolerance, not bitwise. flash_dq and flash_dkv are deterministic;
// - tiles are computed transposed where that keeps row ownership: the k-
//   block kernels form S^T = K Q^T and dP^T = V dO^T, so the same warps own
//   the same keys' rows in every product and in dK/dV; the fused dQ reads
//   dS^T as a column-major operand;
// - 8 warps per CTA: each 16-row band of a product is split between two
//   warps by columns, so each SM scheduler has a second warp to switch to
//   while the first waits on a synchronous wmma load from shared memory;
// - bf16 products run on the tensor cores (wmma 16x16x16, f32 accumulate),
//   the f32 variant (the exactness path) on the CUDA cores; f32 keeps 64-row
//   tiles by writing P and dS over S and dP in place (224.5 KB of shared
//   memory at d = 128, under the 227 KB a CTA may take). bf16 takes 186.5 KB
//   with its rows padded against bank conflicts (flash_tiles.cuh): one CTA
//   per SM, the first thing later perf work must change;
// - a ragged S tail is zero-filled and masked; its rows are never written.
// Not yet done (later work): wgmma, TMA, a pipelined Q/dO stage, the
// accumulators in registers so that two CTAs fit an SM.

#include "flash_tiles.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// Which part of a tile product warp w computes: the 16-row band w % 4 and
// half (w / 4) of the output's columns — [16·nb0, 16·nb0 + 32) of a
// 64-column score tile, [c0, c1) of a d-column product.
struct Share {
  int band, nb0, c0, c1;
};

__device__ __forceinline__ Share share_of(int warp, int d) {
  const int band = warp % kBands, half = warp / kBands;
  const int blocks = (d / 16 + 1) / 2;   // 16-column blocks per half
  return {band, 2 * half, min(d, 16 * blocks * half),
          min(d, 16 * blocks * (half + 1))};
}

// dQ[16 q of the band, c0..c1) = dS[band, 64 k] · K[64 k, c0..c1), added
// into the f32 workspace `ws` (row stride `ss`) with atomics. dS is read
// column-major out of the dS^T tile; the product goes through `scr`.
__device__ void dq_atomic(const __nv_bfloat16* dst, const __nv_bfloat16* ks,
                          float* scr, float* ws, long long ss, int q0,
                          int seq, int d, const Share& w, int lane) {
  const int ldt = ld_tile<__nv_bfloat16>(d), lda = ld_acc<__nv_bfloat16>(d);
  constexpr int ldp = ld_prob<__nv_bfloat16>();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>
      a[kBK / 16];
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wmma::load_matrix_sync(a[kk], dst + kk * 16 * ldp + w.band * 16, ldp);
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
  float* sw = scr + w.band * 16 * lda;
  for (int n = w.c0; n < w.c1; n += 16) {
    wmma::fill_fragment(o, 0.f);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::load_matrix_sync(b, ks + kk * 16 * ldt + n, ldt);
      wmma::mma_sync(o, a[kk], b, o);
    }
    wmma::store_matrix_sync(sw + n, o, lda, wmma::mem_row_major);
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int qp = q0 + w.band * 16 + rr;
    if (qp >= seq) break;
    float* row = ws + qp * ss;
    for (int c = w.c0 + lane; c < w.c1; c += 32)
      atomicAdd(row + c, sw[rr * lda + c]);
  }
}

// The f32 variant: each lane forms its own elements and adds them directly.
__device__ void dq_atomic(const float* dst, const float* ks, float* /*scr*/,
                          float* ws, long long ss, int q0, int seq, int d,
                          const Share& w, int lane) {
  const int ldt = ld_tile<float>(d);
  constexpr int ldp = ld_prob<float>();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = w.band * 16 + rr;
    const int qp = q0 + r;
    if (qp >= seq) break;
    float* row = ws + qp * ss;
    for (int c = w.c0 + lane; c < w.c1; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < kBK; ++j)
        acc = fmaf(dst[j * ldp + r], ks[j * ldt + c], acc);
      atomicAdd(row + c, acc);
    }
  }
}

__device__ __forceinline__ bool live(int qp, int kp, int seq, int mask,
                                     int window) {
  bool keep = qp < seq && kp < seq;
  if (mask != kFull) keep = keep && kp <= qp;
  if (mask == kWindow) keep = keep && (qp - kp) < window;
  return keep;
}

// `_bwd_tile`'s elementwise middle for one score element: s (unscaled f32
// product), dp, and the row's LSE and delta give P and dS.
__device__ __forceinline__ void p_ds(float s_raw, float dp, bool keep,
                                     float scale, float lse, float delta,
                                     float& p, float& ds) {
  const float s = keep ? s_raw * scale : kNegInf;
  p = (s <= kNegInf * 0.5f) ? 0.f : expf(s - lse);
  ds = p * (dp - delta);
}

__device__ void load_rows(float* lse_s, float* delta_s, const float* lse,
                          const float* delta, long long row0, int q0,
                          int seq) {
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const bool in = q0 + i < seq;
    lse_s[i] = in ? lse[row0 + q0 + i] : 0.f;
    delta_s[i] = in ? delta[row0 + q0 + i] : 0.f;
  }
}

// flash_dkv (kFused = false) and flash_bwd_fused (kFused = true): one CTA per
// (64-row k block, b·h).
template <typename T, typename TO, bool kFused>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ ws,
                    TO* __restrict__ dk, TO* __restrict__ dv, int seq,
                    int heads, int d, float scale, int mask, int window) {
  constexpr bool kInPlace = sizeof(T) == sizeof(float);
  const int ldt = ld_tile<T>(d), lda = ld_acc<T>(d);
  constexpr int lds = ld_score<T>(), ldp = ld_prob<T>();
  static_assert(!kInPlace || lds == ldp, "P/dS overwrite S/dP in place");
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kBK * ldt;
  T* qs = vs + kBK * ldt;
  T* dos = qs + kBQ * ldt;
  float* st = reinterpret_cast<float*>(dos + kBQ * ldt);   // S^T  [k, q]
  float* dpt = st + kBK * lds;                             // dP^T [k, q]
  // P^T and dS^T in T: over S^T / dP^T for f32, beside them for bf16
  T* pt = kInPlace ? reinterpret_cast<T*>(st)
                   : reinterpret_cast<T*>(dpt + kBK * lds);
  T* dst = kInPlace ? reinterpret_cast<T*>(dpt) : pt + kBK * ldp;
  float* dk_acc = kInPlace ? dpt + kBK * lds
                           : reinterpret_cast<float*>(dst + kBK * ldp);
  float* dv_acc = dk_acc + kBK * lda;
  float* lse_s = dv_acc + kBK * lda;
  float* delta_s = lse_s + kBQ;

  const int lane = threadIdx.x % 32;
  const Share w = share_of(threadIdx.x / 32, d);
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int k0 = blockIdx.x * kBK;
  const long long ss = static_cast<long long>(heads) * d;   // row stride
  const long long base = static_cast<long long>(b) * seq * ss + h * d;
  const long long row0 = static_cast<long long>(bh) * seq;  // LSE/delta row

  for (int i = threadIdx.x; i < kBK * lda; i += kThreads) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  load_tile<kThreads>(ks, k + base, ss, k0, seq, d, ldt);
  load_tile<kThreads>(vs, v + base, ss, k0, seq, d, ldt);

  // queries that see any key of this block: [q_lo, q_hi)
  const int k_last = min(k0 + kBK, seq) - 1;
  const int q_lo = (mask == kFull) ? 0 : k0;
  const int q_hi = (mask == kWindow) ? min(seq, k_last + window) : seq;

  for (int qt = q_lo / kBQ; qt * kBQ < q_hi; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();   // the previous tile's readers are done
    load_tile<kThreads>(qs, q + base, ss, q0, seq, d, ldt);
    load_tile<kThreads>(dos, dout + base, ss, q0, seq, d, ldt);
    load_rows(lse_s, delta_s, lse, delta, row0, q0, seq);
    __syncthreads();
    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 queries
    tile_scores<2>(ks, qs, st, d, ldt, lds, w.band, w.nb0, lane);
    tile_scores<2>(vs, dos, dpt, d, ldt, lds, w.band, w.nb0, lane);
    __syncwarp();
    // P and dS on the same elements; lane owns one query of each key row
    for (int rr = 0; rr < 16; ++rr) {
      const int r = w.band * 16 + rr;
      const int c = w.nb0 * 16 + lane;
      float p, ds;
      p_ds(st[r * lds + c], dpt[r * lds + c],
           live(q0 + c, k0 + r, seq, mask, window), scale, lse_s[c],
           delta_s[c], p, ds);
      pt[r * ldp + c] = from_f32<T>(p);
      dst[r * ldp + c] = from_f32<T>(ds);
    }
    __syncthreads();   // both halves of every P^T / dS^T row are in place
    tile_pv(pt, dos, dv_acc, ldp, ldt, lda, w.band, w.c0, w.c1, lane);  // dV += P^T dO
    tile_pv(dst, qs, dk_acc, ldp, ldt, lda, w.band, w.c0, w.c1, lane);  // dK += dS^T Q
    if (kFused) {
      // S^T / dP^T are dead since the barrier (bf16 keeps P, dS apart), so
      // their 2·64·68 floats hold the [64, d + 4] dQ product
      dq_atomic(dst, ks, st, ws + base, ss, q0, seq, d, w, lane);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBK * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int kp = k0 + r;
    if (kp >= seq) break;
    dk[base + kp * ss + c] = from_f32<TO>(dk_acc[r * lda + c] * scale);
    dv[base + kp * ss + c] = from_f32<TO>(dv_acc[r * lda + c]);
  }
}

// flash_dq: one CTA per (64-row q block, b·h).
template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                TO* __restrict__ dq, int seq, int heads, int d, float scale,
                int mask, int window) {
  constexpr bool kInPlace = sizeof(T) == sizeof(float);
  const int ldt = ld_tile<T>(d), lda = ld_acc<T>(d);
  constexpr int lds = ld_score<T>(), ldp = ld_prob<T>();
  static_assert(!kInPlace || lds == ldp, "dS overwrites S in place");
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kBQ * ldt;
  T* ks = dos + kBQ * ldt;
  T* vs = ks + kBK * ldt;
  float* ss_ = reinterpret_cast<float*>(vs + kBK * ldt);   // S  [q, k]
  float* dps = ss_ + kBQ * lds;                             // dP [q, k]
  T* dss = kInPlace ? reinterpret_cast<T*>(ss_)
                    : reinterpret_cast<T*>(dps + kBQ * lds);
  float* dq_acc = kInPlace ? dps + kBQ * lds
                           : reinterpret_cast<float*>(dss + kBQ * ldp);
  float* lse_s = dq_acc + kBQ * lda;
  float* delta_s = lse_s + kBQ;

  const int lane = threadIdx.x % 32;
  const Share w = share_of(threadIdx.x / 32, d);
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * kBQ;
  const long long ss = static_cast<long long>(heads) * d;
  const long long base = static_cast<long long>(b) * seq * ss + h * d;
  const long long row0 = static_cast<long long>(bh) * seq;

  for (int i = threadIdx.x; i < kBQ * lda; i += kThreads) dq_acc[i] = 0.f;
  load_tile<kThreads>(qs, q + base, ss, q0, seq, d, ldt);
  load_tile<kThreads>(dos, dout + base, ss, q0, seq, d, ldt);
  load_rows(lse_s, delta_s, lse, delta, row0, q0, seq);

  // keys any row of this block can see: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, seq) - 1;
  const int k_hi = (mask == kFull) ? seq : q_last + 1;
  const int k_lo = (mask == kWindow) ? max(0, q0 - (window - 1)) : 0;

  for (int kt = k_lo / kBK; kt * kBK < k_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done
    load_tile<kThreads>(ks, k + base, ss, k0, seq, d, ldt);
    load_tile<kThreads>(vs, v + base, ss, k0, seq, d, ldt);
    __syncthreads();
    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 32 keys
    tile_scores<2>(qs, ks, ss_, d, ldt, lds, w.band, w.nb0, lane);
    tile_scores<2>(dos, vs, dps, d, ldt, lds, w.band, w.nb0, lane);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = w.band * 16 + rr;
      const int c = w.nb0 * 16 + lane;
      float p, ds;
      p_ds(ss_[r * lds + c], dps[r * lds + c],
           live(q0 + r, k0 + c, seq, mask, window), scale, lse_s[r],
           delta_s[r], p, ds);
      dss[r * ldp + c] = from_f32<T>(ds);
    }
    __syncthreads();   // both halves of every dS row are in place
    tile_pv(dss, ks, dq_acc, ldp, ldt, lda, w.band, w.c0, w.c1, lane);  // dQ += dS K
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int qp = q0 + r;
    if (qp >= seq) break;
    dq[base + qp * ss + c] = from_f32<TO>(dq_acc[r * lda + c] * scale);
  }
}

template <typename TO>
__global__ void dq_finalize_kernel(const float* __restrict__ ws,
                                   TO* __restrict__ dq, long long n,
                                   float scale) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    dq[i] = from_f32<TO>(ws[i] * scale);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int batch, seq, heads, d;
  float scale;
  int mask, window;
  cudaStream_t stream;
};

template <typename T>
size_t kv_smem(int d) {
  constexpr size_t elt = sizeof(T);
  return 4 * static_cast<size_t>(kBK) * ld_tile<T>(d) * elt  // K, V, Q, dO
         + 2 * static_cast<size_t>(kBK) * ld_score<T>() * 4  // S^T, dP^T
         + (elt == 4 ? 0 : 2 * static_cast<size_t>(kBK) * ld_prob<T>() * elt)
         + 2 * static_cast<size_t>(kBK) * ld_acc<T>(d) * 4   // dK, dV acc
         + 2 * kBQ * 4;                                      // LSE, delta
}

template <typename T, typename TO, bool kFused>
int launch_kv(const Args& a, float* ws, void* dk, void* dv) {
  const size_t smem = kv_smem<T>(a.d);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kv_kernel<T, TO, kFused>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.seq + kBK - 1) / kBK, a.batch * a.heads);
  flash_bwd_kv_kernel<T, TO, kFused><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, ws, static_cast<TO*>(dk), static_cast<TO*>(dv), a.seq,
      a.heads, a.d, a.scale, a.mask, a.window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TO>
int launch_fused(const Args& a, float* ws, void* dq, void* dk, void* dv) {
  const long long n = static_cast<long long>(a.batch) * a.seq * a.heads * a.d;
  cudaError_t e = cudaMemsetAsync(ws, 0, n * sizeof(float), a.stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = launch_kv<T, TO, true>(a, ws, dk, dv);
  if (rc) return rc;
  const long long blocks = (n + 255) / 256;
  dq_finalize_kernel<TO><<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                           256, 0, a.stream>>>(ws, static_cast<TO*>(dq), n,
                                               a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TO>
int launch_dq(const Args& a, void* dq) {
  constexpr size_t elt = sizeof(T);
  const size_t smem =
      4 * static_cast<size_t>(kBQ) * ld_tile<T>(a.d) * elt     // Q, dO, K, V
      + 2 * static_cast<size_t>(kBQ) * ld_score<T>() * 4       // S, dP
      + (elt == 4 ? 0 : static_cast<size_t>(kBQ) * ld_prob<T>() * elt)  // dS
      + static_cast<size_t>(kBQ) * ld_acc<T>(a.d) * 4          // dQ acc
      + 2 * kBQ * 4;                                           // LSE, delta
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel<T, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.seq + kBQ - 1) / kBQ, a.batch * a.heads);
  flash_dq_kernel<T, TO><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<TO*>(dq), a.seq, a.heads, a.d, a.scale, a.mask,
      a.window);
  return static_cast<int>(cudaGetLastError());
}

// the inputs' dtype and the gradients': (bf16, bf16), (bf16, f32) or
// (f32, f32)
bool valid(const Args& a, int dtype, int out_dtype) {
  return a.d % 16 == 0 && a.d >= 16 && a.d <= 128 && a.seq >= 1 &&
         a.batch >= 1 && a.heads >= 1 && a.mask >= kCausal &&
         a.mask <= kWindow && (a.mask != kWindow || a.window >= 1) &&
         (dtype == kF32 || dtype == kBF16) &&
         (out_dtype == dtype || out_dtype == kF32);
}

// Instantiate `Launch` for the (input, output) element types of the codes.
template <template <typename, typename> class Launch, typename... A>
int dispatch(int dtype, int out_dtype, A&&... args) {
  if (dtype == kF32) return Launch<float, float>::run(args...);
  if (out_dtype == kF32)
    return Launch<__nv_bfloat16, float>::run(args...);
  return Launch<__nv_bfloat16, __nv_bfloat16>::run(args...);
}

template <typename T, typename TO>
struct Fused {
  static int run(const Args& a, float* ws, void* dq, void* dk, void* dv) {
    return launch_fused<T, TO>(a, ws, dq, dk, dv);
  }
};
template <typename T, typename TO>
struct Dkv {
  static int run(const Args& a, void* dk, void* dv) {
    return launch_kv<T, TO, false>(a, nullptr, dk, dv);
  }
};
template <typename T, typename TO>
struct Dq {
  static int run(const Args& a, void* dq) { return launch_dq<T, TO>(a, dq); }
};

}  // namespace

// q, k, v, dout: contiguous [B, S, H, D]; lse, delta: [B, H, S] f32;
// outputs in the inputs' layout, in the dtype of `out_dtype`; ws: f32
// [B, S, H, D] scratch.
extern "C" int tk_flash_bwd_fused(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* ws, void* dq, void* dk, void* dv,
                                  int batch, int seq, int heads, int d,
                                  float scale, int mask, int window,
                                  int dtype, int out_dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), batch, seq, heads, d,
               scale, mask, window, static_cast<cudaStream_t>(stream)};
  if (!valid(a, dtype, out_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Fused>(dtype, out_dtype, a, static_cast<float*>(ws), dq,
                         dk, dv);
}

extern "C" int tk_flash_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int batch,
                            int seq, int heads, int d, float scale, int mask,
                            int window, int dtype, int out_dtype,
                            void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), batch, seq, heads, d,
               scale, mask, window, static_cast<cudaStream_t>(stream)};
  if (!valid(a, dtype, out_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Dkv>(dtype, out_dtype, a, dk, dv);
}

extern "C" int tk_flash_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int batch, int seq,
                           int heads, int d, float scale, int mask,
                           int window, int dtype, int out_dtype,
                           void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), batch, seq, heads, d,
               scale, mask, window, static_cast<cudaStream_t>(stream)};
  if (!valid(a, dtype, out_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Dq>(dtype, out_dtype, a, dq);
}
