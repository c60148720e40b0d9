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
//   may differ from q's) WITHOUT the normalisation: the f32 accumulator,
//   the running max m and the running sum l, which the ring folds across
//   blocks exactly. Its causal and window masks take a key offset,
//   `q_offset` = the global row of q's first row less that of the block's
//   first key: key kp is live for query qp iff qp + q_offset >= kp (and,
//   under a window, qp + q_offset - kp < window), so a block before a
//   sequence shard's own carries the window; the tile bounds and classes
//   move by the same offset. q_offset = 0 is the local mask of the
//   diagonal block, and K1 always passes 0.
// The two are one template (`kPartial`), as the reference shares
// `_fwd_sweep` between its two kernels: only the epilogue differs, so K2's
// acc / max(l, 1e-30), rounded to q's dtype, equals K1's output bit for bit.
//
// What bounds them on the H100: the two tile products, 4·Sq·Sk·D FLOPs per
// (batch, head) over the live part of the mask — compute-bound against the
// 989 TFLOP/s bf16 tensor-core peak once S is in the hundreds; the bytes
// (Q, K, V read once, O or the f32 accumulator written once) are a few MB
// to tens of MB. Per 16-row warp band the sweep also reads every K and V
// tile out of shared memory once (0.0625 B per FLOP at d = 128), which
// caps it near half the tensor-core peak, and it spends one exp2 per score
// on the SFU. Short prompts (serve: 48–112 CTAs) are bound by latency.
//
// The bf16 sweep (`flash_fwd_mma`):
// - one CTA of 4 warps per (b·h, 64-row q block); each warp owns its 16
//   query rows for the whole sweep. The TPU's sequential k grid is a loop
//   inside the CTA over 64-key tiles. On the H100, 128-row CTAs of 8 warps
//   were no faster at the train shape and 128-key tiles spilled registers
//   (PERF.md);
// - registers hold everything of the sweep: Q as mma A fragments (loaded
//   once with ldmatrix), S and O as mma.sync m16n8k16 f32 accumulators.
//   The online softmax runs on the S registers — a row lives in the 4
//   lanes of a quad, so its max takes two __shfl_xor steps; each lane keeps
//   its own partial row sum, reduced once at the end — the rescale
//   multiplies the O registers (skipped when no row max of the warp
//   moved), and P is packed from the S registers straight into bf16 A
//   fragments (the m16n8k16 accumulator layout of two n-tiles is the A
//   layout of one k-step). S, P and O never touch shared memory; K
//   fragments come by ldmatrix, V fragments by ldmatrix.trans;
// - K and V go through a ring of three shared-memory stages filled by
//   cp.async.cg 16-byte copies (commit_group / wait_group): tiles t + 1
//   and t + 2 are in flight while tile t's products run, and one
//   __syncthreads a tile hands the stages round. Q is staged once in the
//   third stage before its first use. Rows are padded by 16 bytes, so the
//   eight rows of every ldmatrix 8x8 fall in different banks;
// - heaviest first: the linear block index runs (b, h) fastest and, under
//   a causal or window mask, the q blocks from the last (most live tiles)
//   down, so the long CTAs start first and the short ones fill the tail;
// - each warp classifies every tile against its own 16 rows: dead tiles
//   (past the diagonal, before the window) are skipped, fully visible
//   tiles skip the mask arithmetic, and only a diagonal tile, a window's
//   edge tile or a ragged key tail apply it. A row's arithmetic does not
//   depend on the batch or the grid slot;
// - the scores are scaled by scale·log2(e) and exponentiated with exp2f
//   (on a fully visible tile as exp2f(fma(s, scale·log2 e, -m))); m is kept
//   in that base-2 unit and turned back to natural log (m·ln 2) for the
//   stored m and LSE;
// - head dims: compile-time instances for 64 and 128; a smaller d (a
//   multiple of 16) is zero-padded to the next one in shared memory — zero
//   Q/K columns add nothing to the scores, zero V columns are not stored;
// - K1's epilogue stages each warp's bf16 rows in its own Q rows of shared
//   memory and stores 16-byte chunks; K2 stores its f32 accumulator
//   directly (a quad writes whole 32-byte sectors);
// - GQA reads KV head h / (H / KV) directly; Q/K/V/O are read and written
//   through their strides; ragged Sq and Sk tails are zero-filled by the
//   copies (src-size 0) and masked.
// The f32 instance (CUDA cores; the exactness path of the ring and train
// checks) keeps the first port's sweep, `flash_fwd_kernel`: 64-row tiles,
// 4 warps, S, P and O in shared memory.
// Numerics follow `_fold_scores` / `_masked_exp`: finite -1e30 masking,
// p = 0 where s <= -1e30 / 2, the scale applied to the f32 scores after
// the product, P rounded to bf16 before the PV product, l floored at
// 1e-30, LSE in natural log. The bf16 sweep gets p = 0 for masked scores
// by subtracting 0 instead of a row max that is itself masked: then every
// masked score exponentiates to exactly 0, as with the reference's test.
// Not done here: wgmma (Hopper's warpgroup product) and TMA. A wgmma
// version of this sweep (one or two consumer warpgroups, K/V in no-swizzle
// core-matrix layouts, with and without a cp.async producer warp) was
// measured and did not beat this one at the train shape; see PERF.md and
// ROADMAP.md.

#include "flash_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

// Both sweeps: CTAs of 4 warps, each one 16-row band of the 64-row q block.
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kBQ / kWarps;
static_assert(kRowsPerWarp == 16, "16 query rows a warp");

// ------------------------------------------------------------------ f32

// K1 (kPartial = false): o through the strides `to`, lse [B, H, seq].
// K2 (kPartial = true): o is the accumulator, contiguous [B, seq, H, d],
// lse receives m and l_out l, both [B, H, seq]. f32 tiles are unpadded.
template <bool kPartial>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, float* __restrict__ l_out,
                 int seq, int kseq, int heads, int kv_heads, int d,
                 Strides tq, Strides tk, Strides tv, Strides to, float scale,
                 int mask, int window, int q_offset) {
  const int ldt = d, lda = d;
  constexpr int lds = kBK, ldp = kBK;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kBQ * ldt;
  float* vs = ks + kBK * ldt;
  float* ss = vs + kBK * ldt;
  float* ps = ss + kBQ * lds;
  float* os = ps + kBQ * ldp;
  float* m_s = os + kBQ * lda;
  float* l_s = m_s + kBQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = blockIdx.x * kBQ;
  const float* qb = q + b * tq.b + h * tq.h;
  const float* kb = k + b * tk.b + kvh * tk.h;
  const float* vb = v + b * tv.b + kvh * tv.h;

  for (int i = threadIdx.x; i < kBQ * lda; i += kThreads) os[i] = 0.f;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  load_tile<kThreads>(qs, qb, tq.s, q0, seq, d, ldt);

  // keys any row of this block can see: [k_lo, k_hi), in the keys' rows
  const int q_last = min(q0 + kBQ, seq) - 1;
  const int k_hi =
      (mask == kFull) ? kseq : min(kseq, q_last + q_offset + 1);
  const int k_lo =
      (mask == kWindow) ? max(0, q0 + q_offset - (window - 1)) : 0;

  for (int kt = k_lo / kBK; k_lo < k_hi && kt * kBK < k_hi; ++kt) {
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
      const int qp = q0 + r + q_offset;   // in the keys' rows
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
        ps[r * ldp + lane + 32 * jj] = p;
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
    float* orow = o + b * to.b + static_cast<long long>(qp) * to.s + h * to.h;
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
        orow[c] = os[r * lda + c] / l;
      if (lane == 0) lse[row] = m_s[r] + logf(l);
    }
  }
}

// ----------------------------------------------------------------- bf16

struct FwdArgs {
  const bf16 *q, *k, *v;
  void* o;
  float *lse, *l_out;
  int batch, seq, kseq, heads, kv_heads, d, mask, window;
  Strides tq, tk, tv, to;
  float scale_log2;   // scale · log2(e)
  int q_offset;       // q's first row in the keys' rows (K1: 0)
};

// One tile's online-softmax fold on the S registers of a warp: thread
// (g = lane / 4, t = lane % 4) holds rows g and g + 8 of the warp's band,
// keys 8 j + 2 t + {0, 1} of n-tile j. Scales to base 2, masks when kMask
// (key `k0 + ...` against query `r0 + ...`, r0 in the keys' rows), folds
// the row max across the quad, rescales O and the lane's partial sums, and
// leaves P in s. A fully visible tile (no kMask) takes its max on the raw
// scores (rounding is monotonic, so max(fl(s c)) = fl(max(s) c)) and
// exponentiates fma(s, c, -m) in one rounding. O is rescaled only when a
// row max of the warp moved: multiplying by 1 changes nothing.
template <int kNT, int kOT, bool kMask>
__device__ __forceinline__ void fold_tile(float (&s)[kNT][4],
                                          float (&o)[kOT][4], float (&m)[2],
                                          float (&l)[2], float scale_log2,
                                          int r0, int k0, int kseq, int mask,
                                          int window, int lane) {
  constexpr bool kRaw = !kMask;
  const int g = lane >> 2, t = lane & 3;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = kRaw ? s[j][e] : s[j][e] * scale_log2;
      if constexpr (kMask) {
        const int qp = r0 + g + (e >> 1) * 8;
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        bool keep = kp < kseq;
        if (mask != kFull) keep = keep && kp <= qp;
        if (mask == kWindow) keep = keep && qp - kp < window;
        x = keep ? x : kNegInf;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float mu[2], corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    if constexpr (kRaw) mx[i] *= scale_log2;
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
    // a row whose max is itself masked exponentiates against 0, so every
    // masked score (-1e30) gives exactly 0 — the reference's p = 0 where
    // s <= -1e30 / 2; a live max sends masked scores to 0 by itself
    mu[i] = m_new <= kNegInf * 0.5f ? 0.f : m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = kRaw ? exp2f(fmaf(s[j][e], scale_log2, -mu[e >> 1]))
                           : exp2f(s[j][e] - mu[e >> 1]);
      l[e >> 1] += p;
      s[j][e] = p;
    }
  }
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int j = 0; j < kOT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
    }
  }
}

// The bf16 sweep's epilogue for one warp's 16 rows from r0: the
// quad's partial row sums, then K1's normalised bf16 O (staged through
// `so`, the warp's own 16 Q rows of shared memory, read once at the start,
// into 16-byte stores) and LSE, or K2's f32 accumulator, m and l.
template <int kD, bool kPartial>
__device__ __forceinline__ void store_fwd(const FwdArgs& a, bf16* so,
                                          float (&o)[kD / 8][4],
                                          float (&m)[2], float (&l)[2],
                                          int r0, int b, int h, int bh,
                                          int lane) {
  constexpr int kLd = kD + 8, kOT = kD / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  float m_nat[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    m_nat[i] = m[i] <= kNegInf * 0.5f ? kNegInf : m[i] * kLn2;
  const long long stat_row = static_cast<long long>(bh) * a.seq;
  if constexpr (kPartial) {
    float* acc = static_cast<float*>(a.o);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = r0 + g + 8 * i;
      if (qp >= a.seq) continue;
      float* row = acc + b * a.to.b + static_cast<long long>(qp) * a.to.s
                   + h * a.to.h;
#pragma unroll
      for (int j = 0; j < kOT; ++j) {
        const int c = 8 * j + 2 * t;
        if (c < a.d)
          *reinterpret_cast<float2*>(row + c) =
              make_float2(o[j][2 * i], o[j][2 * i + 1]);
      }
      if (t == 0) {
        a.lse[stat_row + qp] = m_nat[i];
        a.l_out[stat_row + qp] = l[i];
      }
    }
  } else {
    float lf[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) lf[i] = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kOT; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(so + (g + 8 * i) * kLd + 8 * j + 2 * t) =
            pack_bf16(o[j][2 * i] / lf[i], o[j][2 * i + 1] / lf[i]);
    }
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qp = r0 + g + 8 * i;
        if (qp < a.seq) a.lse[stat_row + qp] = m_nat[i] + logf(lf[i]);
      }
    }
    __syncwarp();
    bf16* out = static_cast<bf16*>(a.o);
    constexpr int kChunks = kD / 8;
#pragma unroll
    for (int it = 0; it < 16 * kChunks / 32; ++it) {
      const int i = it * 32 + lane;
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const int qp = r0 + r;
      if (qp < a.seq && c < a.d)
        *reinterpret_cast<uint4*>(out + b * a.to.b +
                                  static_cast<long long>(qp) * a.to.s +
                                  h * a.to.h + c) =
            *reinterpret_cast<const uint4*>(so + r * kLd + c);
    }
  }
}

// The bf16 sweep. kD: the padded head dim (64 or 128); 4 warps of 16
// query rows each; 64 keys per tile. K1 (kPartial = false) writes O
// in bf16 through `to` and LSE [B, H, seq]; K2 writes the f32 accumulator
// (contiguous [B, seq, H, d]), m into `lse` and l into `l_out`.
template <int kD, bool kPartial>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma(FwdArgs a) {
  constexpr int kLd = kD + 8;          // padded row: 16 bytes past kD
  constexpr int kKS = kD / 16;         // k-steps of the QK^T product
  constexpr int kNT = kBK / 8;        // 8-key n-tiles of S
  constexpr int kOT = kD / 8;          // 8-column n-tiles of O
  constexpr int kStages = 3;
  constexpr int kStage = 2 * kBK * kLd;   // one stage: K then V
  static_assert(kBQ <= 2 * kBK, "Q fits in a K/V stage");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // a ring of 3 K/V stages; Q is staged in the third, which is free until
  // the loop's first prefetch into it, after Q is in registers
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* sq = ring + 2 * kStage;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // heaviest first: (b, h) fastest; causal and window blocks from the last
  const int bhn = a.batch * a.heads;
  const int nq = (a.seq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % bhn;
  int qb = blockIdx.x / bhn;
  if (a.mask != kFull) qb = nq - 1 - qb;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int kvh = h / (a.heads / a.kv_heads);
  const int q0 = qb * kBQ;
  const bf16* qbase = a.q + b * a.tq.b + h * a.tq.h;
  const bf16* kbase = a.k + b * a.tk.b + kvh * a.tk.h;
  const bf16* vbase = a.v + b * a.tv.b + kvh * a.tv.h;

  // keys any row of this block can see: tiles [t_lo, t_hi), in the keys'
  // rows (a row qp is key row qp + q_offset)
  const int q_last = min(q0 + kBQ, a.seq) - 1;
  const int k_hi =
      a.mask == kFull ? a.kseq : min(a.kseq, q_last + a.q_offset + 1);
  const int k_lo =
      a.mask == kWindow ? max(0, q0 + a.q_offset - (a.window - 1)) : 0;
  const int t_lo = k_lo / kBK;
  const int t_hi = k_lo < k_hi ? (k_hi + kBK - 1) / kBK : t_lo;

  auto load_k = [&](int kt, int stage) {
    cp_tile<kBK, kD, kThreads>(ring + stage * kStage, kbase, a.tk.s,
                                 kt * kBK, a.kseq, a.d);
  };
  auto load_v = [&](int kt, int stage) {
    cp_tile<kBK, kD, kThreads>(ring + stage * kStage + kBK * kLd, vbase,
                                 a.tv.s, kt * kBK, a.kseq, a.d);
  };
  // prologue: group 1 = Q and tile t_lo, group 2 = tile t_lo + 1
  cp_tile<kBQ, kD, kThreads>(sq, qbase, a.tq.s, q0, a.seq, a.d);
  if (t_lo < t_hi) {
    load_k(t_lo, 0);
    load_v(t_lo, 0);
  }
  cp_async_commit();
  if (t_lo + 1 < t_hi) {
    load_k(t_lo + 1, 1);
    load_v(t_lo + 1, 1);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // this warp's rows [r0, r0 + 16): Q as A fragments, once
  const int r0 = q0 + 16 * warp;
  uint32_t qf[kKS][4];
  {
    const bf16* base = sq + (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8)
                       * kLd + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) ldsm_x4(qf[kk], smem_addr(base + 16 * kk));
  }
  float o[kOT][4];
#pragma unroll
  for (int j = 0; j < kOT; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // per-lane ldmatrix row offsets: K (non-transposed) and V (transposed)
  const int k_row = (lane >> 4) * 8 + (lane & 7), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = (lane >> 4) * 8;

  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int stage = (kt - t_lo) % kStages;
    const bf16* ks = ring + stage * kStage;
    const bf16* vs = ks + kBK * kLd;
    cp_async_wait<1>();   // tile kt is here (this thread's copies)
    __syncthreads();      // ... everyone's; and tile kt - 1 is read out
    // prefetch tile kt + 2 into tile kt - 1's stage
    if (kt + 2 < t_hi) {
      load_k(kt + 2, (stage + 2) % kStages);
      load_v(kt + 2, (stage + 2) % kStages);
    }
    cp_async_commit();

    // this warp against the tile: dead (skip), fully visible, or masked;
    // g0, g1 are the warp's first and last rows in the keys' rows
    const int k0 = kt * kBK, k1 = k0 + kBK - 1;
    const int g0 = r0 + a.q_offset, g1 = g0 + 15;
    const bool dead = r0 >= a.seq || (a.mask != kFull && k0 > g1) ||
                      (a.mask == kWindow && g0 - k1 >= a.window);
    const bool visible = k1 < a.kseq &&
        (a.mask == kFull ||
         (k1 <= g0 && (a.mask != kWindow || g1 - k0 < a.window)));
    if (!dead) {
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, smem_addr(ks + (16 * np + k_row) * kLd + 16 * kk + k_col));
          mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        }
      }
      if (visible)
        fold_tile<kNT, kOT, false>(s, o, m, l, a.scale_log2, g0, k0, a.kseq,
                                   a.mask, a.window, lane);
      else
        fold_tile<kNT, kOT, true>(s, o, m, l, a.scale_log2, g0, k0, a.kseq,
                                  a.mask, a.window, lane);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < kOT / 2; ++np) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, smem_addr(vs + (16 * kk + v_row) * kLd + 16 * np
                                      + v_col));
          mma_bf16(o[2 * np], pa, bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }

  // K1 stages O in Q's rows, which lie in the ring that other warps may
  // still read
  cp_async_wait<0>();
  __syncthreads();
  store_fwd<kD, kPartial>(a, sq + 16 * warp * kLd, o, m, l, r0, b, h, bh,
                          lane);
}

template <int kD, bool kPartial>
int launch_mma(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(3 * 2 * kBK) * (kD + 8) *
                      sizeof(bf16);   // three K/V stages, Q in the third
  auto kernel = flash_fwd_mma<kD, kPartial>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = static_cast<long long>(a.batch) * a.heads *
                           ((a.seq + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPartial>
int dispatch_bf16(const FwdArgs& a, cudaStream_t stream) {
  return a.d <= 64 ? launch_mma<64, kPartial>(a, stream)
                   : launch_mma<128, kPartial>(a, stream);
}

template <bool kPartial>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, float* l_out, int batch, int seq, int kseq,
               int heads, int kv_heads, int d, Strides tq, Strides tk,
               Strides tv, Strides to, float scale, int mask, int window,
               int q_offset, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(kBQ + 2 * kBK) * d  // Q, K, V
                       + 2 * static_cast<size_t>(kBQ) * kBK     // S, P
                       + static_cast<size_t>(kBQ) * d           // O acc
                       + 2 * kBQ) * 4;                          // m, l
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<kPartial>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * heads);
  flash_fwd_kernel<kPartial><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, l_out, seq,
      kseq, heads, kv_heads, d, tq, tk, tv, to, scale, mask, window,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int batch, int seq, int kseq, int heads, int kv_heads, int d,
           int mask, int window, int q_offset) {
  return d % 16 == 0 && d >= 16 && d <= 128 && kv_heads >= 1 &&
         q_offset >= 0 &&
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
                            int mask, int window, int dtype,
                            void* stream) {
  if (!valid(batch, seq, seq, heads, kv_heads, d, mask, window, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides tq{q_sb, q_ss, q_sh}, tk{k_sb, k_ss, k_sh},
      tv{v_sb, v_ss, v_sh}, to{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kBF16) {
    const FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), o, l, nullptr, batch, seq,
                    seq, heads, kv_heads, d, mask, window, tq, tk, tv, to,
                    scale * kLog2e, 0};
    return dispatch_bf16<false>(a, st);
  }
  if (dtype == kF32)
    return launch_f32<false>(q, k, v, o, l, nullptr, batch, seq, seq,
                              heads, kv_heads, d, tq, tk, tv, to, scale,
                              mask, window, 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2: acc is f32 contiguous [B, seq, H, d]; m and l are f32 [B, H, seq];
// q_offset >= 0 moves the causal / window mask (q row qp is key row
// qp + q_offset).
extern "C" int tk_flash_partial(const void* q, const void* k, const void* v,
                                void* acc, void* m, void* l, int batch,
                                int seq, int kseq, int heads, int kv_heads,
                                int d, long long q_sb, long long q_ss,
                                long long q_sh, long long k_sb,
                                long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss,
                                long long v_sh, float scale, int mask,
                                int window, int q_offset, int dtype,
                                void* stream) {
  if (!valid(batch, seq, kseq, heads, kv_heads, d, mask, window, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides tq{q_sb, q_ss, q_sh}, tk{k_sb, k_ss, k_sh},
      tv{v_sb, v_ss, v_sh},
      to{static_cast<long long>(seq) * heads * d,
         static_cast<long long>(heads) * d, d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  if (dtype == kBF16) {
    const FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), acc, mp, lp, batch, seq,
                    kseq, heads, kv_heads, d, mask, window, tq, tk, tv, to,
                    scale * kLog2e, q_offset};
    return dispatch_bf16<true>(a, st);
  }
  if (dtype == kF32)
    return launch_f32<true>(q, k, v, acc, mp, lp, batch, seq, kseq,
                             heads, kv_heads, d, tq, tk, tv, to, scale,
                             mask, window, q_offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* tk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
