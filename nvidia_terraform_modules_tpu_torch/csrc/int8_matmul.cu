// SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
// SPDX-License-Identifier: Apache-2.0
//
// int8-weight matrix product for Hopper (sm_90a): out = (x @ w_int8) * scale,
// x [M, K] bf16/f32 (M <= 64, the decode regime), w int8 in its storage
// orientation — [K, N], or [N, K] for the tied head (transpose) — and one
// f32 scale per output channel, applied after the f32 accumulation.
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
// What the design does about it — one launch a product:
// - the grid is (channel blocks of kBN = 128, K slices, row groups of 8);
//   the K split (int8_slices in ops/int8_matmul.py: a function of K and N
//   alone, a divisor of kBN up to kMaxSlices, one CTA an SM) puts each of
//   the flagship's 4-16 MB weights on 128 SMs;
// - each CTA fills all kStages cp.async stages at once (16 KB of weight and
//   x's 8 rows a stage) and refills a stage as soon as its tile is
//   multiplied, so a slice of up to four tiles is requested in one go;
// - bf16 x: the products run on the tensor cores (mma.sync m16n8k16, bf16
//   in, f32 out) with the output channels on the A side (16 a fragment)
//   and x's rows on B's n = 8; each of the 4 warps takes 32 of a tile's
//   128 k for all 128 channels, and the warps' sums add in warp order. The
//   int8 bytes are read from shared memory 16 (or 8) at a time and
//   converted to bf16 in registers, exactly, with one PRMT, two LOP3s and
//   one bf16x2 FMA a pair — on this card the integer pipe, which runs at
//   half the FMA pipe's rate, paces the tile;
// - channels and k sit in a fixed permutation inside a tile, the same for
//   A and B, chosen so the fragments fill from 16-byte reads of a [K, N]
//   tile and 8-byte reads of an [N, K] tile (the head's rows are already
//   k-contiguous: no transpose); the shared tiles and the warps' sums are
//   XOR-swizzled so those reads and stores are free of bank conflicts;
// - f32 x (off the main path) stays a CUDA-core sweep over the same stages:
//   TF32 would break its 1e-5 limit;
// - the K slices of a channel block are one thread-block cluster and are
//   combined inside the launch through distributed shared memory: CTA j of
//   the cluster owns kBN / slices of the channels, every CTA stores its
//   f32 sums of that share (and the first its scales, read while the
//   weights stream in) into CTA j's shared memory, one cluster barrier,
//   then CTA j adds the slices in ascending order, applies the scale and
//   casts. Each CTA arrives on the cluster barrier as it starts and waits
//   on it before its first remote store, so no CTA writes into the shared
//   memory of a CTA that has not started (the wait is met long before the
//   sweep ends).
//   Nothing but the operands and the output touches global memory: no
//   partials, no counters, no fence. With one slice the CTA writes the
//   output at once.
//
// Bits: the split, the tile order and every accumulation order are
// functions of K, N and the orientation only — a row's sum never depends
// on M or on the other rows (each row group is its own computation, and an
// mma's columns are independent) — so the rows of an M = 4 call equal
// M = 1 calls bit for bit, and two calls give the same bits.

#include <cooperative_groups.h>

#include <atomic>
#include <type_traits>

#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 128;     // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;          // output channels per CTA
constexpr int kBK = 128;          // k per stage
constexpr int kRows = 8;          // x rows per CTA: one n-tile of the mma
constexpr int kStages = 4;
constexpr int kMaxSlices = 8;     // a portable cluster: K slices a launch
constexpr int kWBytes = kBK * kBN;   // one stage's int8 weight tile
static_assert(kBK == 32 * kWarps, "each warp takes two 16-deep k-steps");
static_assert(kThreads == kBN, "one thread a channel at the end");

template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return kWBytes + kRows * kBK * static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<T>();
}
static_assert(kWarps * kRows * kBN * 4 <= smem_bytes<bf16>(),
              "the warps' sums fit the stages");

// Byte offset of 16-byte chunk c (of 8) of row r of a weight tile (128
// bytes a row). [K, N] rows are k: warp w reads rows 32w + 8t + 4s + e at
// chunk g, so the chunk is XORed with 2·((r >> 3) & 3) = 2t; [N, K] rows
// are channels: lanes read 8 bytes of rows g (and g + 8) at chunk 2w + t /
// 2, so the chunk is XORed with 2·(r & 3).
template <bool kTrans>
__device__ __forceinline__ int w_off(int r, int c) {
  const int x = kTrans ? (r & 3) << 1 : ((r >> 3) & 3) << 1;
  return r * 128 + ((c ^ x) << 4);
}

// Byte offset of 16-byte chunk c of row r of the x tile (kBK values of T a
// row). Lanes read 16 bytes of rows g at chunk 4w + t (bf16), so odd rows
// XOR the chunk with 4.
template <typename T>
__device__ __forceinline__ int x_off(int r, int c) {
  return kWBytes + r * kBK * static_cast<int>(sizeof(T)) +
         ((c ^ ((r & 1) << 2)) << 4);
}

// Stage the weight tile [k0, k0 + kBK) x [n0, n0 + kBN) and x's rows
// [r0, r0 + kRows) at k0; channels past n and rows past m are zero-filled.
template <typename T, bool kTrans>
__device__ __forceinline__ void load_stage(unsigned char* st,
                                           const int8_t* __restrict__ w,
                                           const T* __restrict__ x, int m,
                                           int k, int n, int n0, int k0,
                                           int r0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int it = 0; it < kWBytes / 16 / kThreads; ++it) {
    const int i = it * kThreads + tid;
    const int r = i >> 3, c = i & 7;
    bool ok;
    const int8_t* src;
    if (kTrans) {      // row n0 + r of [N, K], k0 + 16 c onwards
      ok = n0 + r < n;
      src = w + static_cast<long long>(n0 + r) * k + k0 + 16 * c;
    } else {           // row k0 + r of [K, N], n0 + 16 c onwards
      ok = n0 + 16 * c < n;
      src = w + static_cast<long long>(k0 + r) * n + n0 + 16 * c;
    }
    cp_async16(smem_addr(st + w_off<kTrans>(r, c)), ok ? src : w, ok);
  }
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));   // values a chunk
  constexpr int kChunks = kBK / kPer;                       // chunks a row
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < m;
    const T* src = x + static_cast<long long>(r0 + r) * k + k0 + c * kPer;
    cp_async16(smem_addr(st + x_off<T>(r, c)), ok ? src : x, ok);
  }
}

// Two int8 values at bytes 0 and 2 of v → two bf16, exactly: with l = v &
// 127, bf16 0x4300 | l is 128 + l, and 0x4300 | (v & 128) is 128, or 256
// when v < 0; their difference is v.
// (a & b) | c in one LOP3: the integer pipe, half the FMA pipe's rate on
// Hopper, is what the conversion spends most.
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b,
                                          uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t v) {
  const uint32_t lo = and_or(v, 0x007f007fu, 0x43004300u);
  const uint32_t hi = and_or(v, 0x00800080u, 0x43004300u);
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(hi), "r"(0xbf80bf80u), "r"(lo));   // lo - hi
  return d;
}

// byte p of a at byte 0, byte q of b at byte 2, as a bf16 pair
__device__ __forceinline__ uint32_t pair(uint32_t a, int p, uint32_t b,
                                         int q) {
  return i8x2_bf16x2(__byte_perm(a, b, p | ((4 + q) << 8)));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One stage on the tensor cores: warp w multiplies k [32w, 32w + 32) of the
// tile, two k-steps of 16, into acc[i] (m-tile i: 16 channels by the 8 x
// rows). Slots {2t, 2t + 1, 2t + 8, 2t + 9} of k-step s hold k = 32w + 8t
// + 4s + {0, 1, 2, 3} — in A and B alike.
//   [K, N]: m-tile i holds channels 16g + 2i (A row g) and 16g + 2i + 1
//   (row g + 8): a lane's 16-byte read of row k, chunk g, serves 8
//   m-tiles.
//   [N, K]: m-tile i holds channels 16i + g and 16i + g + 8: a lane's
//   8-byte read of a channel row serves both k-steps.
template <bool kTrans>
__device__ __forceinline__ void mma_stage(const unsigned char* st,
                                          float (&acc)[8][4], int warp,
                                          int g, int t) {
  const uint4 xv = *reinterpret_cast<const uint4*>(
      st + x_off<bf16>(g, 4 * warp + t));
  if (!kTrans) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint4 l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        l[e] = *reinterpret_cast<const uint4*>(
            st + (32 * warp + 8 * t + 4 * s + e) * 128 + ((g ^ (2 * t)) << 4));
      const uint32_t b0 = s ? xv.z : xv.x, b1 = s ? xv.w : xv.y;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = i >> 1, p = 2 * (i & 1);
        const uint32_t a[4] = {
            pair(word(l[0], q), p, word(l[1], q), p),
            pair(word(l[0], q), p + 1, word(l[1], q), p + 1),
            pair(word(l[2], q), p, word(l[3], q), p),
            pair(word(l[2], q), p + 1, word(l[3], q), p + 1)};
        mma_bf16(acc[i], a, b0, b1);
      }
    }
  } else {
    const int c = 2 * warp + (t >> 1), half = (t & 1) << 3;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 16 * i + g;
      const uint2 lo = *reinterpret_cast<const uint2*>(
          st + w_off<true>(r, c) + half);
      const uint2 hi = *reinterpret_cast<const uint2*>(
          st + w_off<true>(r + 8, c) + half);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t wl = s ? lo.y : lo.x, wh = s ? hi.y : hi.x;
        const uint32_t a[4] = {pair(wl, 0, wl, 1), pair(wh, 0, wh, 1),
                               pair(wl, 2, wl, 3), pair(wh, 2, wh, 3)};
        mma_bf16(acc[i], a, s ? xv.z : xv.x, s ? xv.w : xv.y);
      }
    }
  }
}

// One stage on the CUDA cores (f32 x): thread c owns channel c and sums
// the tile's k in ascending order for the 8 rows.
template <bool kTrans>
__device__ __forceinline__ void fma_stage(const unsigned char* st,
                                          float (&acc)[kRows], int c) {
  const float* xs = reinterpret_cast<const float*>(st + kWBytes);
#pragma unroll 4
  for (int kk = 0; kk < kBK; ++kk) {
    const int8_t wq = static_cast<int8_t>(
        kTrans ? st[w_off<true>(c, kk >> 4) + (kk & 15)]
               : st[w_off<false>(kk, c >> 4) + (c & 15)]);
    const float wv = to_f32(wq);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      acc[r] = fmaf(xs[r * kBK + (((kk >> 2) ^ ((r & 1) << 2)) << 2) +
                       (kk & 3)],
                    wv, acc[r]);
  }
}

// Column of channel ch in row r of the warps' sums ([warp][row][channel]):
// a permutation within the row that spreads a warp's stores of its
// accumulators over the 32 banks (the reads, one channel a thread, stay
// conflict-free).
template <bool kTrans>
__device__ __forceinline__ int red_col(int r, int ch) {
  return ch ^ (kTrans ? ((r >> 1) & 3) << 3
                      : (((ch >> 5) & 3) << 2) | ((r >> 1) & 3));
}

// The cluster barrier in its two halves: arrive (relaxed: it orders no
// memory, it only says this CTA runs) and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_tiles(int pending) {
  if constexpr (kPending > 0) {
    if (pending < kPending) return wait_tiles<kPending - 1>(pending);
  }
  cp_async_wait<kPending>();
}

// One CTA: channel block blockIdx.x, K slice blockIdx.y (of gridDim.y),
// row group blockIdx.z.
template <typename T, bool kTrans>
__global__ void __launch_bounds__(kThreads)
int8_mm(const T* __restrict__ x, const int8_t* __restrict__ w,
        const float* __restrict__ scale, T* __restrict__ out, int m, int k,
        int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr int kStage = stage_bytes<T>();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = tid;             // the epilogue's channel
  const int n0 = blockIdx.x * kBN, r0 = blockIdx.z * kRows;
  const int slices = gridDim.y;
  // every CTA of the cluster must run before another writes into its
  // shared memory: announce this one now, check the others before the
  // combine
  if (slices > 1) cluster_arrive_relaxed();
  const int tiles = k / kBK / slices;
  const int kb = blockIdx.y * tiles * kBK;
  // the scale of channel c, read while the weights stream in
  const float sc = n0 + c < n ? __ldg(scale + n0 + c) : 0.f;

  // every stage is filled at once; a stage is refilled at the top of the
  // sweep step after the one that read it
  const int first = min(tiles, kStages);
  for (int i = 0; i < first; ++i) {
    load_stage<T, kTrans>(smem + i * kStage, w, x, m, k, n, n0,
                          kb + i * kBK, r0);
    cp_async_commit();
  }
  float acc[8][4] = {};           // bf16: the warp's m-tiles
  float facc[kRows] = {};         // f32: channel c's rows
  int issued = first;
  for (int i = 0; i < tiles; ++i) {
    wait_tiles<kStages - 1>(issued - i - 1);   // tile i is here
    __syncthreads();                // ... everyone's; tile i - 1 is done
    if (i > 0 && issued < tiles) {  // refill the stage tile i - 1 used
      load_stage<T, kTrans>(smem + (issued % kStages) * kStage, w, x, m, k,
                            n, n0, kb + issued * kBK, r0);
      cp_async_commit();
      ++issued;
    }
    if constexpr (kMma)
      mma_stage<kTrans>(smem + (i % kStages) * kStage, acc, warp, g, t);
    else
      fma_stage<kTrans>(smem + (i % kStages) * kStage, facc, c);
  }
  __syncthreads();

  // channel c's sums over the slice: the warps' in warp order (bf16)
  float v[kRows];
  if constexpr (kMma) {
    float* red = reinterpret_cast<float*>(smem);   // [warp][row][channel]
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ca = kTrans ? 16 * i + g : 16 * g + 2 * i;
      const int cb = kTrans ? ca + 8 : ca + 1;
      float* rw = red + (warp * kRows + 2 * t) * kBN;
      rw[red_col<kTrans>(2 * t, ca)] = acc[i][0];
      rw[kBN + red_col<kTrans>(2 * t + 1, ca)] = acc[i][1];
      rw[red_col<kTrans>(2 * t, cb)] = acc[i][2];
      rw[kBN + red_col<kTrans>(2 * t + 1, cb)] = acc[i][3];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int col = red_col<kTrans>(r, c);
      float s = red[r * kBN + col];
#pragma unroll
      for (int wi = 1; wi < kWarps; ++wi)
        s += red[(wi * kRows + r) * kBN + col];
      v[r] = s;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = facc[r];
  }

  const int rows = min(kRows, m - r0);
  if (slices == 1) {
    if (n0 + c >= n) return;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows)
        out[static_cast<long long>(r0 + r) * n + n0 + c] =
            from_f32<T>(v[r] * sc);
    return;
  }

  // The slices of a (channel block, row group) are one cluster. CTA j of
  // the cluster owns channels [j·width, (j + 1)·width), width = kBN /
  // slices: every CTA stores its sums of those channels (and the first CTA
  // their scales) into CTA j's shared memory, one cluster barrier, then
  // CTA j adds the slices in ascending order. recv holds the slices'
  // [slices][kRows][width] sums — kRows · kBN floats at any slice count —
  // and then the share's scales.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float recv[kRows * kBN + kBN];   // apart from the stages
  const int width = kBN / slices;
  const int own = c / width;                  // the owner of channel c
  float* peer = cluster.map_shared_rank(recv, own);
  float* dst = peer + blockIdx.y * kRows * width + (c - own * width);
  cluster_wait();       // every CTA of the cluster has started
#pragma unroll
  for (int r = 0; r < kRows; ++r) dst[r * width] = v[r];
  if (blockIdx.y == 0) peer[kRows * kBN + c - own * width] = sc;
  cluster.sync();       // every slice's sums are in their owners' memory
  const int c0 = blockIdx.y * width;
  for (int i = tid; i < width * kRows; i += kThreads) {
    const int r = i / width, cc = i % width;
    if (r >= rows || n0 + c0 + cc >= n) continue;
    float sv[kMaxSlices];     // every slice's load in flight at once
#pragma unroll
    for (int q = 0; q < kMaxSlices; ++q)
      if (q < slices) sv[q] = recv[(q * kRows + r) * width + cc];
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSlices; ++q)
      if (q < slices) sum += sv[q];
    out[static_cast<long long>(r0 + r) * n + n0 + c0 + cc] =
        from_f32<T>(sum * recv[kRows * kBN + cc]);
  }
}

// The dynamic shared memory attribute, set once per instance and device.
template <typename T, bool kTrans>
cudaError_t smem_attr() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(int8_mm<T, kTrans>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes<T>());
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// The shapes and slice counts the kernel takes: K in whole tiles split
// evenly, and a slice count that divides kBN within one portable cluster.
bool takes(int m, int k, int n, int slices) {
  return m >= 1 && m <= 64 && k >= kBK && k % kBK == 0 && n >= 64 &&
         n % 64 == 0 && slices >= 1 && slices <= kMaxSlices &&
         kBN % slices == 0 && (k / kBK) % slices == 0;
}

// (channel blocks, K slices, row groups)
dim3 launch_grid(int m, int n, int slices) {
  return dim3((n + kBN - 1) / kBN, slices, (m + kRows - 1) / kRows);
}

template <typename T, bool kTrans>
int launch(const void* x, const void* w, const float* scale, void* out,
           int m, int k, int n, int slices, cudaStream_t stream) {
  cudaError_t e = smem_attr<T, kTrans>();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = launch_grid(m, n, slices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<T>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = slices;   // the slices of a channel block
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, int8_mm<T, kTrans>, static_cast<const T*>(x),
                         static_cast<const int8_t*>(w), scale,
                         static_cast<T*>(out), m, k, n);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTrans>
int info(int* out) {
  cudaError_t e = smem_attr<T, kTrans>();
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, int8_mm<T, kTrans>);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, int8_mm<T, kTrans>, kThreads, smem_bytes<T>());
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = smem_bytes<T>() + static_cast<int>(fa.sharedSizeBytes);
  out[3] = ctas;
  return 0;
}

}  // namespace

// x, w, scale, out; M, K, N, slices (a divisor of kBN, at most kMaxSlices,
// that divides K / kBK), transpose (w is [N, K]), dtype code of x and out,
// stream.
extern "C" int tk_int8_matmul(const void* x, const void* w, const void* scale,
                              void* out, int m, int k, int n, int slices,
                              int transpose, int dtype, void* stream) {
  if (!takes(m, k, n, slices)) return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return transpose ? launch<bf16, true>(x, w, sc, out, m, k, n, slices, st)
                     : launch<bf16, false>(x, w, sc, out, m, k, n, slices,
                                           st);
  if (dtype == kF32)
    return transpose ? launch<float, true>(x, w, sc, out, m, k, n, slices,
                                           st)
                     : launch<float, false>(x, w, sc, out, m, k, n, slices,
                                            st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// M, K, N, slices, int[3] out: the grid tk_int8_matmul launches for them
// (channel blocks, K slices, row groups of kRows).
extern "C" int tk_int8_matmul_grid(int m, int k, int n, int slices,
                                   int* out) {
  if (!takes(m, k, n, slices)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 g = launch_grid(m, n, slices);
  out[0] = static_cast<int>(g.x);
  out[1] = static_cast<int>(g.y);
  out[2] = static_cast<int>(g.z);
  return 0;
}

// transpose, dtype code, int[4] out: registers a thread, local (spill)
// bytes a thread, shared memory (dynamic and static) and resident CTAs per
// SM of the instance that takes those operands.
extern "C" int tk_int8_matmul_info(int transpose, int dtype, int* out) {
  if (dtype == kBF16)
    return transpose ? info<bf16, true>(out) : info<bf16, false>(out);
  if (dtype == kF32)
    return transpose ? info<float, true>(out) : info<float, false>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}
