// SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
// SPDX-License-Identifier: Apache-2.0
//
// Register-level helpers shared by the bf16 flash sweeps of flash_fwd.cu
// (K1, K2) and flash_bwd.cu (K5, K4, K3): cp.async staging into padded
// shared-memory tiles (the copies themselves are common.cuh's), ldmatrix
// fragment loads, and the mma.sync m16n8k16 bf16 product with f32
// accumulators.
//
// Fragment layouts of m16n8k16 (lane = 4 g + t): the A operand (16 x 16,
// row-major) holds rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9;
// the B operand (16 x 8, column-major) rows 2t, 2t + 1 and 2t + 8, 2t + 9
// of column g; the f32 accumulator (16 x 8) rows g and g + 8, columns 2t
// and 2t + 1. So the accumulators of two 8-column n-tiles, packed to bf16,
// are the A operand of one 16-deep k-step.
#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c[16x8 f32] += a[16x16 bf16, row] · b[16x8 bf16, col]
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats → one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + kRows) of one head (row stride `stride`
// elements, d valid columns) into a [kRows, kLd] shared tile with cp.async,
// by all kThreads threads of the CTA; rows past `rows` and columns past d
// are zero-filled.
template <int kRows, int kD, int kThreads>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* base,
                                        long long stride, int row0, int rows,
                                        int d) {
  constexpr int kLd = kD + 8, kChunks = kD / 8;
  static_assert(kRows * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = row0 + r < rows && c < d;
    const bf16* src =
        ok ? base + static_cast<long long>(row0 + r) * stride + c : base;
    cp_async16(smem_addr(dst + r * kLd + c), src, ok);
  }
}

}  // namespace
