// SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
// SPDX-License-Identifier: Apache-2.0
//
// Tile helpers shared by the flash-attention forward (flash_fwd.cu) and
// backward (flash_bwd.cu) kernels: the 64-row tiling, staging of a [64, d]
// tile out of a [B, S, H, D] tensor, and the two tile products every kernel
// is built from, each in a bf16 tensor-core variant (nvcuda::wmma 16x16x16,
// f32 accumulate) and an f32 CUDA-core variant (wmma has no full-f32 mode).
//
// A tile product's output is cut into 16-row bands; each warp computes a
// band, or half of one (see below).
#pragma once

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;             // query rows per tile
constexpr int kBK = 64;             // key rows per tile
constexpr int kBands = kBQ / 16;    // 16-row wmma bands of a tile
static_assert(kBQ == kBK, "the products below take square 64-row tiles");
enum Mask { kCausal = 0, kFull = 1, kWindow = 2 };

struct Strides {   // element strides of the b, s and h dimensions
  long long b, s, h;
};

// Shared-memory row strides, in elements. The bf16 rows are padded (tiles
// and P by 16 bytes, f32 scores and accumulators by 16 bytes) so the rows
// of a 16x16 wmma fragment fall in different banks: unpadded, every row of
// a 128-wide tile starts in the same bank and each fragment load or store
// serialises. The f32 variant (CUDA cores, the exactness path) stays dense:
// the f32 backward needs nearly all of a CTA's shared memory.
template <typename T>
__host__ __device__ constexpr bool padded() { return sizeof(T) == 2; }
template <typename T>   // [64, d] tiles of T (Q, K, V, dO)
__host__ __device__ constexpr int ld_tile(int d) {
  return d + (padded<T>() ? 8 : 0);
}
template <typename T>   // [64, 64] f32 score tiles (S, dP)
__host__ __device__ constexpr int ld_score() {
  return kBK + (padded<T>() ? 4 : 0);
}
template <typename T>   // [64, 64] tiles of T (P, dS)
__host__ __device__ constexpr int ld_prob() {
  return kBK + (padded<T>() ? 8 : 0);
}
template <typename T>   // [64, d] f32 accumulators (O, dQ, dK, dV)
__host__ __device__ constexpr int ld_acc(int d) {
  return d + (padded<T>() ? 4 : 0);
}

// Stage rows [row0, row0 + 64) of one head into a [64, d] tile of row
// stride `ld`, zero-filling rows past the sequence end; all kNT threads of
// the CTA take part. kNT is a compile-time stride so the loop unrolls and
// each thread's loads issue back to back (a runtime stride serialises one
// memory latency per load: K1 ran 33 % slower with blockDim.x here).
template <int kNT, typename T>
__device__ void load_tile(T* dst, const T* base, long long row_stride,
                          int row0, int seq, int d, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = d / kVec;
  for (int i = threadIdx.x; i < kBK * vpr; i += kNT) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq)
      val = *reinterpret_cast<const uint4*>(
          base + static_cast<long long>(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The two tile products. Each call computes one warp's share: rows
// [16 band, 16 band + 16) of the output and a range of its columns, so a
// 4-warp CTA gives each warp whole rows and an 8-warp CTA splits every
// row band between two warps by columns.

// S[16 rows of `band`, 16 kNB columns from block nb0] = A · B^T (f32), for
// two [64, d] tiles of row stride `ldt`, into a score tile of row stride
// `lds`; bf16 on the tensor cores.
template <int kNB>
__device__ void tile_scores(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                            float* ss, int d, int ldt, int lds, int band,
                            int nb0, int /*lane*/) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kNB];
#pragma unroll
  for (int n = 0; n < kNB; ++n) wmma::fill_fragment(acc[n], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
  const __nv_bfloat16* qw = qs + band * 16 * ldt;
  for (int kk = 0; kk < d; kk += 16) {
    wmma::load_matrix_sync(a, qw + kk, ldt);
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      // B^T as a col-major matrix: element (dim, row) at ks[row * ldt + dim]
      wmma::load_matrix_sync(b, ks + (nb0 + n) * 16 * ldt + kk, ldt);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kNB; ++n)
    wmma::store_matrix_sync(ss + band * 16 * lds + (nb0 + n) * 16, acc[n],
                            lds, wmma::mem_row_major);
}

// The f32 variant on the CUDA cores: each lane owns 16 kNB / 32 columns.
// Each lane walks the head dim from its own offset, so the 32 lanes' B rows
// hit 32 different banks.
template <int kNB>
__device__ void tile_scores(const float* qs, const float* ks, float* ss,
                            int d, int ldt, int lds, int band, int nb0,
                            int lane) {
  static_assert(kNB % 2 == 0, "a warp covers 32 columns at a time");
  for (int rr = 0; rr < 16; ++rr) {
    const int r = band * 16 + rr;
    const float* qr = qs + r * ldt;
#pragma unroll
    for (int jj = 0; jj < kNB / 2; ++jj) {
      const int j = nb0 * 16 + lane + 32 * jj;
      const float* kr = ks + j * ldt;
      float acc = 0.f;
      int c = lane % d;
      for (int t = 0; t < d; ++t) {
        acc = fmaf(qr[c], kr[c], acc);
        c = (c + 1 == d) ? 0 : c + 1;
      }
      ss[r * lds + j] = acc;
    }
  }
}

// O[16 rows of `band`, columns c0..c1) += P[band, 64] · V[64, c0..c1), the
// accumulator kept in shared memory; row strides `ldp` (P), `ldt` (V) and
// `lda` (O); c0 and c1 are multiples of 16.
__device__ void tile_pv(const __nv_bfloat16* ps, const __nv_bfloat16* vs,
                        float* os, int ldp, int ldt, int lda, int band,
                        int c0, int c1, int /*lane*/) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      a[kBK / 16];
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wmma::load_matrix_sync(a[kk], ps + band * 16 * ldp + kk * 16, ldp);
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
  float* ow = os + band * 16 * lda;
  for (int n = c0; n < c1; n += 16) {
    wmma::load_matrix_sync(o, ow + n, lda, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::load_matrix_sync(b, vs + kk * 16 * ldt + n, ldt);
      wmma::mma_sync(o, a[kk], b, o);
    }
    wmma::store_matrix_sync(ow + n, o, lda, wmma::mem_row_major);
  }
}

__device__ void tile_pv(const float* ps, const float* vs, float* os, int ldp,
                        int ldt, int lda, int band, int c0, int c1,
                        int lane) {
  for (int rr = 0; rr < 16; ++rr) {
    const int r = band * 16 + rr;
    const float* pr = ps + r * ldp;
    for (int c = c0 + lane; c < c1; c += 32) {
      float acc = os[r * lda + c];
      for (int j = 0; j < kBK; ++j) acc = fmaf(pr[j], vs[j * ldt + c], acc);
      os[r * lda + c] = acc;
    }
  }
}

}  // namespace
