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
// tensor-core peak. Per warp and tile the bf16 sweep below also reads its
// mma operands out of shared memory (ldmatrix), about as many bytes per
// FLOP as the forward's, and K5 adds 64 x d f32 atomics per live tile.
//
// The bf16 key-block sweep (`flash_bwd_kv_mma`: K5, and K4 without the dQ;
// bf16 or f32 outputs):
// - one CTA of 4 warps per (b·h, 64-key block); each warp owns 16 keys for
//   the whole sweep: their rows of S^T and dP^T and of dK and dV. The TPU's
//   sequential q grid is a loop inside the CTA over the live 64-row q tiles
//   (causal: from the block's diagonal to the end; window: up to the last
//   query that sees the block);
// - S^T = K Q^T and dP^T = V dO^T run on mma.sync m16n8k16 with f32
//   accumulators in registers — the forward's S = Q K^T with the roles
//   swapped: K and V are the A operands, taken by ldmatrix from the
//   resident shared tiles, Q and dO the B operands. P = exp(S·scale - LSE)
//   (base 2, the scale folded into one fma) and dS = P (dP - delta) are
//   formed on those registers from the staged LSE and delta of each
//   column's query, then packed into bf16 A fragments (the accumulators of
//   two n-tiles are one k-step's A operand) for dV += P^T dO and
//   dK += dS^T Q, whose B operands come by ldmatrix.trans. dK and dV
//   (16 x d f32 a warp each) stay in registers for the whole sweep and are
//   written once, dK · scale, in TO. S^T and dP^T are formed 32 queries at
//   a time (a register sub-tile of the 64-row q tile);
// - K5's dQ: each warp stores its dS^T rows (bf16) in a shared tile; after
//   a barrier each warp forms dS K for 16 queries of the tile over the
//   block's 64 keys (A by ldmatrix.trans from the dS^T tile, B by
//   ldmatrix.trans from the resident K), 32 columns at a time, and adds the
//   accumulators into a zeroed f32 workspace with vector atomics (atomicAdd
//   on float2: red.global.add.v2.f32); dq_finalize writes ws · scale. The
//   atomics make dQ's summation order vary from run to run: the fused dQ
//   holds against its plain version at a tolerance, not bitwise. K4 is
//   deterministic: each CTA sums its q tiles in a fixed order;
// - Q, dO, LSE and delta come through two shared-memory stages filled by
//   cp.async: tile t + 1 is in flight while tile t's products run, and one
//   __syncthreads a tile hands the stages round (K5 adds one for its dS^T
//   tile). Rows are padded by 16 bytes so that the eight rows of every
//   ldmatrix 8x8 fall in different banks. At d = 128 that is 112 KB for K5
//   (K and V 34 KB, two Q/dO stages 68 KB, LSE/delta 1 KB, dS^T 9 KB) and
//   103 KB for K4: two CTAs per SM;
// - heaviest first: the linear block index runs (b, h) fastest and the key
//   blocks from the first, which under a causal mask sees every q tile, so
//   the long CTAs start first and the short ones fill the tail;
// - each warp classifies every sub-tile against its own 16 keys: dead
//   (skipped; K5 writes its dS^T rows as zeros), fully visible (no mask
//   arithmetic), or masked (a diagonal or window-edge tile, a ragged tail).
//   A row's arithmetic does not depend on the batch or the grid slot;
// - head dims: compile-time instances for 64 and 128; a smaller d (a
//   multiple of 16) is zero-padded to the next one in shared memory — zero
//   columns add nothing to S^T, dP^T or dQ and are never stored.
//
// The f32 instances of K5/K4 (CUDA cores: the exactness path of the train
// and ring checks) and flash_dq (K3, both types) keep the first port's
// kernels:
// - one CTA of 8 warps per (b·h, 64-row block): flash_dq loops over the
//   live k blocks with Q/dO/LSE/delta staged once; the f32 key-block kernel
//   keeps K/V resident and loops over the live q blocks; dead tiles
//   (block_liveness's DEAD class) are never loaded;
// - the tiles are computed transposed where that keeps row ownership (S^T
//   = K Q^T in the key-block kernel); the accumulators ([64, d] f32) live
//   in shared memory; each 16-row band of a product is split between two
//   warps by columns;
// - bf16 products (flash_dq) run on wmma 16x16x16 out of shared memory,
//   f32 ones on the CUDA cores; f32 keeps 64-row tiles by writing P and dS
//   over S and dP in place (224.5 KB of shared memory at d = 128);
// - the f32 fused dQ adds each tile's dS K with atomicAdd into the
//   workspace, as above;
// - a ragged S tail is zero-filled and masked; its rows are never written.
// Not done here: wgmma and TMA; flash_dq's redesign on the sweep above.

#include "flash_tiles.cuh"
#include "mma_tiles.cuh"

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

// The f32 kernel's fused dQ: dQ[16 q of the band, c0..c1) = dS[band, 64 k]
// · K[64 k, c0..c1), added into the f32 workspace `ws` (row stride `ss`)
// with atomics; each lane forms its own elements from the dS^T tile.
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

// The f32 instances of flash_dkv (kFused = false) and flash_bwd_fused
// (kFused = true): one CTA per (64-row k block, b·h).
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

// ------------------------------------------------- bf16 key-block sweep

// The bf16 instances of K5 (kFused) and K4: CTAs of 4 warps, each warp
// owning 16 keys of the CTA's 64-key block for the whole sweep.
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
static_assert(16 * kMmaWarps == kBK, "a warp per 16 keys of the block");
static_assert(kMmaThreads == 2 * kBQ, "a thread per LSE or delta row");
// S^T and dP^T are formed 32 queries at a time (two sub-tiles of a q
// tile): at d = 128 the dK/dV accumulators take 128 registers a thread,
// and a whole 64-query tile of S^T and dP^T (64 more) made K5 5 % slower
// at the train shape (PERF.md)
constexpr int kQS = 32;

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  float* ws;          // the fused dQ's f32 workspace (kFused only)
  void *dk, *dv;
  int batch, seq, heads, d, mask, window;
  float scale, scale_log2;   // scale, and scale · log2(e)
};

// dynamic shared memory: K and V resident, two stages of Q and dO, two of
// LSE and delta, and (fused) the bf16 dS^T tile
template <int kD, bool kFused>
constexpr size_t kv_mma_smem() {
  return 6 * static_cast<size_t>(kBK) * (kD + 8) * sizeof(bf16) +
         2 * 2 * kBQ * sizeof(float) +
         (kFused ? static_cast<size_t>(kBK) * (kBQ + 8) * sizeof(bf16) : 0);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

// `_bwd_tile`'s elementwise middle on one warp's S^T and dP^T registers:
// thread (g = lane / 4, t = lane % 4) holds keys kw0 + g and kw0 + g + 8,
// queries qa + 8 j + 2 t + {0, 1} of n-tile j. P = exp(S scale - LSE),
// taken in base 2, and dS = P (dP - delta) overwrite s and dp; lse_s and
// delta_s are the staged rows from query qa. With kMask, elements outside
// the mask or past the sequence get P = 0 (the reference forces P to 0
// where its masked score is -1e30); a fully visible tile skips the test.
template <int kNT, bool kMask>
__device__ __forceinline__ void p_ds_tile(float (&s)[kNT][4],
                                          float (&dp)[kNT][4],
                                          const float* lse_s,
                                          const float* delta_s,
                                          float scale_log2, int qa, int kw0,
                                          int seq, int mask, int window,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float2 l2 =
        *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
    const float2 dl =
        *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse = (e & 1) ? l2.y : l2.x;
      const float delta = (e & 1) ? dl.y : dl.x;
      float p = exp2f(fmaf(s[j][e], scale_log2, -lse * kLog2e));
      if constexpr (kMask) {
        const int qp = qa + 8 * j + 2 * t + (e & 1);
        const int kp = kw0 + g + 8 * (e >> 1);
        bool keep = qp < seq && kp < seq;
        if (mask != kFull) keep = keep && kp <= qp;
        if (mask == kWindow) keep = keep && qp - kp < window;
        p = keep ? p : 0.f;
      }
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - delta);
    }
  }
}

// The fused dQ of one q tile: warp w's 16 queries [q0 + 16 w, +16) of
// dS K over the block's 64 keys. A comes by ldmatrix.trans from the dS^T
// tile, B by ldmatrix.trans from the resident K; each 32-column chunk is
// added to the f32 workspace (row stride ss) straight from its
// accumulators, one vector atomic (red.global.add.v2.f32) per pair.
template <int kD>
__device__ __forceinline__ void add_dq(const bf16* dst, const bf16* ks,
                                       float* ws, long long ss, int q0,
                                       int seq, int d, int warp, int lane) {
  constexpr int kLd = kD + 8, kLdS = kBQ + 8;
  const int g = lane >> 2, t = lane & 3;
  const int qr = q0 + 16 * warp;
  if (qr >= seq) return;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane >> 4) * 8 + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 8;
  uint32_t da[kBK / 16][4];
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    ldsm_x4_trans(da[kk], smem_addr(dst + (16 * kk + b_row) * kLdS +
                                    16 * warp + b_col));
#pragma unroll
  for (int c = 0; c < kD; c += 32) {
    if (c >= d) break;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, smem_addr(ks + (16 * kk + a_row) * kLd + c +
                                    16 * np + a_col));
        mma_bf16(acc[2 * np], da[kk], bk[0], bk[1]);
        mma_bf16(acc[2 * np + 1], da[kk], bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c + 8 * j + 2 * t;
      if (col >= d) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qp = qr + g + 8 * i;
        if (qp < seq)
          atomicAdd(reinterpret_cast<float2*>(ws + qp * ss + col),
                    make_float2(acc[j][2 * i], acc[j][2 * i + 1]));
      }
    }
  }
}

// The bf16 key-block sweep. kD: the padded head dim (64 or 128); TO: the
// gradients' type; kFused: K5 (dQ by atomics into a.ws) or K4.
template <int kD, typename TO, bool kFused>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_bwd_kv_mma(BwdArgs a) {
  constexpr int kLd = kD + 8;          // padded row: 16 bytes past kD
  constexpr int kTile = kBK * kLd;     // one [64, kD] tile
  constexpr int kLdS = kBQ + 8;        // padded dS^T row
  constexpr int kKS = kD / 16;         // k-steps over the head dim
  constexpr int kNT = kQS / 8;         // 8-query n-tiles of a sub-tile
  constexpr int kOT = kD / 8;          // 8-column n-tiles of dK, dV
  static_assert(kBQ % kQS == 0 && kQS % 16 == 0, "whole sub-tiles");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTile;
  bf16* ring = vs + kTile;             // two stages of [Q; dO]
  float* rows = reinterpret_cast<float*>(ring + 2 * 2 * kTile);
  bf16* dst = reinterpret_cast<bf16*>(rows + 2 * 2 * kBQ);   // dS^T

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // heaviest first: (b, h) fastest, then the key blocks from the first,
  // which under a causal mask sees every q tile
  const int bhn = a.batch * a.heads;
  const int bh = blockIdx.x % bhn;
  const int k0 = (blockIdx.x / bhn) * kBK;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const long long ss = static_cast<long long>(a.heads) * a.d;
  const long long base = static_cast<long long>(b) * a.seq * ss +
                         static_cast<long long>(h) * a.d;
  const long long row0 = static_cast<long long>(bh) * a.seq;
  const int kw0 = k0 + 16 * warp;      // this warp's keys [kw0, kw0 + 16)

  // queries that see any key of this block: tiles [t_lo, t_hi)
  const int k_last = min(k0 + kBK, a.seq) - 1;
  const int q_lo = a.mask == kFull ? 0 : k0;
  const int q_hi = a.mask == kWindow ? min(a.seq, k_last + a.window) : a.seq;
  const int t_lo = q_lo / kBQ, t_hi = (q_hi + kBQ - 1) / kBQ;

  auto load_q = [&](int qt, int stage) {
    bf16* st = ring + stage * 2 * kTile;
    cp_tile<kBQ, kD, kMmaThreads>(st, a.q + base, ss, qt * kBQ, a.seq, a.d);
    cp_tile<kBQ, kD, kMmaThreads>(st + kTile, a.dout + base, ss, qt * kBQ,
                                  a.seq, a.d);
    // LSE rows by threads [0, 64), delta rows by [64, 128)
    const int i = threadIdx.x, qp = qt * kBQ + i % kBQ;
    const bool ok = qp < a.seq;
    const float* src = i < kBQ ? a.lse : a.delta;
    cp_async4(smem_addr(rows + stage * 2 * kBQ + i),
              ok ? src + row0 + qp : src, ok);
  };
  // prologue: K, V and the first q tile in one group
  cp_tile<kBK, kD, kMmaThreads>(ks, a.k + base, ss, k0, a.seq, a.d);
  cp_tile<kBK, kD, kMmaThreads>(vs, a.v + base, ss, k0, a.seq, a.d);
  load_q(t_lo, 0);
  cp_async_commit();

  float dk[kOT][4], dv[kOT][4];
#pragma unroll
  for (int j = 0; j < kOT; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  // per-lane ldmatrix offsets, as flash_fwd_mma's: (a_row, a_col) the A
  // fragment of a row-major tile, and with .trans two n-tiles' B fragments
  // of a tile stored one k per row; (b_row, b_col) two n-tiles' B
  // fragments of a tile stored one n per row
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane >> 4) * 8 + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 8;

  for (int qt = t_lo; qt < t_hi; ++qt) {
    const int stage = (qt - t_lo) & 1;
    cp_async_wait<0>();   // tile qt is here (this thread's copies)
    __syncthreads();      // ... everyone's; tile qt - 1 is read out
    if (qt + 1 < t_hi) load_q(qt + 1, stage ^ 1);
    cp_async_commit();
    const bf16* qs = ring + stage * 2 * kTile;
    const bf16* dos = qs + kTile;
    const float* lse_s = rows + stage * 2 * kBQ;
    const float* delta_s = lse_s + kBQ;
    const int q0 = qt * kBQ;
#pragma unroll
    for (int c0 = 0; c0 < kBQ; c0 += kQS) {
      // this warp's keys against the sub-tile's queries [qa, qz]: dead
      // (skip), fully visible, or masked
      const int qa = q0 + c0, qz = qa + kQS - 1, kz = kw0 + 15;
      const bool dead = kw0 >= a.seq || qa >= a.seq ||
                        (a.mask != kFull && kw0 > qz) ||
                        (a.mask == kWindow && qa - kz >= a.window);
      if (dead) {
        if constexpr (kFused) {   // its dS^T rows are zeros for the dQ
#pragma unroll
          for (int kk = 0; kk < kQS / 16; ++kk) {
            bf16* row = dst + (16 * warp + g) * kLdS + c0 + 16 * kk + 2 * t;
            *reinterpret_cast<uint32_t*>(row) = 0u;
            *reinterpret_cast<uint32_t*>(row + 8 * kLdS) = 0u;
            *reinterpret_cast<uint32_t*>(row + 8) = 0u;
            *reinterpret_cast<uint32_t*>(row + 8 * kLdS + 8) = 0u;
          }
        }
        continue;
      }
      const bool visible =
          qz < a.seq && kz < a.seq &&
          (a.mask == kFull ||
           (kz <= qa && (a.mask != kWindow || qz - kw0 < a.window)));
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x kQS queries each
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t ka[4], va[4];
        const int aoff = (16 * warp + a_row) * kLd + 16 * kk + a_col;
        ldsm_x4(ka, smem_addr(ks + aoff));
        ldsm_x4(va, smem_addr(vs + aoff));
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bq[4], bo[4];
          const int boff = (c0 + 16 * np + b_row) * kLd + 16 * kk + b_col;
          ldsm_x4(bq, smem_addr(qs + boff));
          ldsm_x4(bo, smem_addr(dos + boff));
          mma_bf16(s[2 * np], ka, bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
          mma_bf16(dp[2 * np], va, bo[0], bo[1]);
          mma_bf16(dp[2 * np + 1], va, bo[2], bo[3]);
        }
      }
      if (visible)
        p_ds_tile<kNT, false>(s, dp, lse_s + c0, delta_s + c0, a.scale_log2,
                              qa, kw0, a.seq, a.mask, a.window, lane);
      else
        p_ds_tile<kNT, true>(s, dp, lse_s + c0, delta_s + c0, a.scale_log2,
                             qa, kw0, a.seq, a.mask, a.window, lane);
      // dV += P^T dO and dK += dS^T Q, 16 queries a k-step: P^T and dS^T
      // are packed from the accumulators into bf16 A fragments
#pragma unroll
      for (int kk = 0; kk < kQS / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t da[4] = {
            pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
            pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
            pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
        if constexpr (kFused) {   // dS^T into its tile for the dQ product
          bf16* row = dst + (16 * warp + g) * kLdS + c0 + 16 * kk + 2 * t;
          *reinterpret_cast<uint32_t*>(row) = da[0];
          *reinterpret_cast<uint32_t*>(row + 8 * kLdS) = da[1];
          *reinterpret_cast<uint32_t*>(row + 8) = da[2];
          *reinterpret_cast<uint32_t*>(row + 8 * kLdS + 8) = da[3];
        }
#pragma unroll
        for (int np = 0; np < kOT / 2; ++np) {
          uint32_t bo[4], bq[4];
          const int off = (c0 + 16 * kk + a_row) * kLd + 16 * np + a_col;
          ldsm_x4_trans(bo, smem_addr(dos + off));
          ldsm_x4_trans(bq, smem_addr(qs + off));
          mma_bf16(dv[2 * np], pa, bo[0], bo[1]);
          mma_bf16(dv[2 * np + 1], pa, bo[2], bo[3]);
          mma_bf16(dk[2 * np], da, bq[0], bq[1]);
          mma_bf16(dk[2 * np + 1], da, bq[2], bq[3]);
        }
      }
    }
    if constexpr (kFused) {
      __syncthreads();   // every warp's dS^T rows are in place
      add_dq<kD>(dst, ks, a.ws + base, ss, q0, a.seq, a.d, warp, lane);
    }
  }
  cp_async_wait<0>();   // the last (empty) group

  // dK · scale and dV in TO, straight from the accumulators
  TO* dk_out = static_cast<TO*>(a.dk) + base;
  TO* dv_out = static_cast<TO*>(a.dv) + base;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = kw0 + g + 8 * i;
    if (kp >= a.seq) continue;
#pragma unroll
    for (int j = 0; j < kOT; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= a.d) continue;
      const long long off = kp * ss + col;
      store2(dk_out + off, dk[j][2 * i] * a.scale,
             dk[j][2 * i + 1] * a.scale);
      store2(dv_out + off, dv[j][2 * i], dv[j][2 * i + 1]);
    }
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

template <int kD, typename TO, bool kFused>
cudaError_t kv_mma_attrs() {
  auto kernel = flash_bwd_kv_mma<kD, TO, kFused>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_mma_smem<kD, kFused>()));
  if (e != cudaSuccess) return e;
  // all of the SM's 228 KB as shared memory: two CTAs of K5 need 2 x 113 KB
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int kD, typename TO, bool kFused>
int launch_kv_mma_at(const BwdArgs& a, cudaStream_t stream) {
  cudaError_t e = kv_mma_attrs<kD, TO, kFused>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = static_cast<long long>(a.batch) * a.heads *
                           ((a.seq + kBK - 1) / kBK);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = kv_mma_smem<kD, kFused>();
  flash_bwd_kv_mma<kD, TO, kFused>
      <<<static_cast<unsigned>(blocks), kMmaThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO, bool kFused>
int launch_kv_mma(const Args& a, float* ws, void* dk, void* dv) {
  const BwdArgs b{static_cast<const bf16*>(a.q),
                  static_cast<const bf16*>(a.k),
                  static_cast<const bf16*>(a.v),
                  static_cast<const bf16*>(a.dout),
                  a.lse, a.delta, ws, dk, dv, a.batch, a.seq, a.heads, a.d,
                  a.mask, a.window, a.scale, a.scale * kLog2e};
  return a.d <= 64 ? launch_kv_mma_at<64, TO, kFused>(b, a.stream)
                   : launch_kv_mma_at<128, TO, kFused>(b, a.stream);
}

// registers a thread, local (spill) bytes a thread, dynamic shared memory
// and resident CTAs per SM of one instance of the bf16 key-block sweep
template <int kD, typename TO, bool kFused>
int kv_mma_info(int* out) {
  cudaError_t e = kv_mma_attrs<kD, TO, kFused>();
  cudaFuncAttributes fa;
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&fa, flash_bwd_kv_mma<kD, TO, kFused>);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, flash_bwd_kv_mma<kD, TO, kFused>, kMmaThreads,
        kv_mma_smem<kD, kFused>());
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(kv_mma_smem<kD, kFused>());
  out[3] = ctas;
  return 0;
}

template <typename T>
size_t kv_smem(int d) {
  constexpr size_t elt = sizeof(T);
  return 4 * static_cast<size_t>(kBK) * ld_tile<T>(d) * elt  // K, V, Q, dO
         + 2 * static_cast<size_t>(kBK) * ld_score<T>() * 4  // S^T, dP^T
         + (elt == 4 ? 0 : 2 * static_cast<size_t>(kBK) * ld_prob<T>() * elt)
         + 2 * static_cast<size_t>(kBK) * ld_acc<T>(d) * 4   // dK, dV acc
         + 2 * kBQ * 4;                                      // LSE, delta
}

// The key-block kernels: the bf16 sweep, or the f32 CUDA-core kernel.
template <typename T, typename TO, bool kFused>
int launch_kv(const Args& a, float* ws, void* dk, void* dv) {
  if constexpr (sizeof(T) == 2) {
    return launch_kv_mma<TO, kFused>(a, ws, dk, dv);
  } else {
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

// Resources of the bf16 key-block sweep's instance for head dim d (padded
// to 64 or 128), fused (K5) or split (K4), with outputs of `out_dtype`:
// out[0] registers a thread, out[1] local (spill) bytes a thread, out[2]
// dynamic shared memory, out[3] resident CTAs per SM. Returns a CUDA error
// code.
extern "C" int tk_flash_bwd_kv_info(int d, int fused, int out_dtype,
                                    int* out) {
  if (d % 16 || d < 16 || d > 128 || (out_dtype != kF32 && out_dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = out_dtype == kF32;
  if (d <= 64) {
    if (fused)
      return f32 ? kv_mma_info<64, float, true>(out)
                 : kv_mma_info<64, bf16, true>(out);
    return f32 ? kv_mma_info<64, float, false>(out)
               : kv_mma_info<64, bf16, false>(out);
  }
  if (fused)
    return f32 ? kv_mma_info<128, float, true>(out)
               : kv_mma_info<128, bf16, true>(out);
  return f32 ? kv_mma_info<128, float, false>(out)
             : kv_mma_info<128, bf16, false>(out);
}
