// Register-level building blocks shared by csrc/flash_fwd.cu and
// csrc/flash_bwd.cu: cp.async copies into shared memory, ldmatrix, and the
// bf16 mma.sync.m16n8k16 tensor-core product, as PTX. Their lane layouts,
// written out beside each helper, are what the kernels' correctness rests
// on: every kernel that keeps its state in registers relies on the C layout
// of two adjacent n8 tiles being the A layout of one k16 step.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src into shared memory, or 16 zero bytes where !valid (src
// is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of lane l holds row l/4, columns 2(l%4), 2(l%4)+1 of it
// (of its transpose with .trans)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// two matrices, addresses from lanes 0-15
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col), c
// 16x8 fp32. Lane (g, t) = (lane/4, lane%4) holds a0..a3 = A[g][2t..],
// A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]; b0, b1 = B[2t..][g],
// B[2t+8..][g]; c0..c3 = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16, lo in the low half: two adjacent columns of an
// A fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0+ROWS) of one head into a (ROWS x LD) bf16 tile by cp.async;
// rows >= n and columns >= d are zero-filled
template <int DP, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void cp_async_rows(bf16* dst, const bf16* src, long long row_stride,
                                              int r0, int n, int d) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool valid = r0 + r < n && c < d;
    cp_async16(dst + r * LD + c, valid ? src + (long long)(r0 + r) * row_stride + c : src, valid);
  }
}

// o += P V for one warp, the product of every kernel here whose A operand
// comes from registers (P V in the forward; dS K, P^T dO and dS^T Q in the
// backward): P as k16 A fragments, V a (keys x LD) bf16 tile from column
// c0, NO n8 tiles of which those at columns < d are computed
template <int KSTEPS, int NO, int LD>
__device__ __forceinline__ void pv_product(float (&o)[NO][4], const uint32_t (&p)[KSTEPS][4],
                                           const bf16* v, int c0, int d) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    // lanes 0-15: keys kk*16 + 0..15 at column tile j; lanes 16-31: tile j+1
    const bf16* row = v + (kk * 16 + lane % 16) * LD + c0 + (lane / 16) * 8;
#pragma unroll
    for (int j = 0; j < NO; j += 2) {
      if (c0 + j * 8 >= d) break;
      if (j + 1 < NO && c0 + j * 8 + 8 < d) {
        uint32_t b[4];
        ldsm_x4_trans(b, row + j * 8);
        mma_bf16(o[j], p[kk], b[0], b[1]);
        mma_bf16(o[j + 1], p[kk], b[2], b[3]);
      } else {
        uint32_t b[2];
        ldsm_x2_trans(b, row + j * 8);
        mma_bf16(o[j], p[kk], b[0], b[1]);
      }
    }
  }
}

}  // namespace
