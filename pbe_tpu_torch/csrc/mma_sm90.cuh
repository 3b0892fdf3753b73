// Register-level building blocks shared by csrc/flash_fwd.cu,
// csrc/flash_variants.cu and csrc/flash_bwd.cu: cp.async copies into shared
// memory, ldmatrix, and the bf16 mma.sync.m16n8k16 tensor-core product, as
// PTX. Their lane layouts, written out beside each helper, are what the
// kernels' correctness rests on: every kernel that keeps its state in
// registers relies on the C layout of two adjacent n8 tiles being the A
// layout of one k16 step. Then the forward kernels' operands, online-softmax
// step and epilogue, and the mbarrier, bulk-copy and cluster helpers of the
// resident kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

// the exp2 of the online-softmax step; scripts/sweep_flash_tiles.py's ftz
// setting defines it as ex2.approx.ftz before including this file
#ifndef PBE_SOFTMAX_EXP2
#define PBE_SOFTMAX_EXP2 exp2f
#endif

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


// --- the forward kernels' operands, softmax step and epilogue (flash_fwd.cu
// and flash_variants.cu)

// A launch's operands: q, k, v bf16 (B, N, H, D), each with element strides
// (batch, seq, head) and a unit head-dim stride; o bf16 (B, N, H, D)
// contiguous; lse fp32 (B*H, N) or null.
struct Operands {
  const bf16 *q, *k, *v;
  bf16* o;
  float* lse;
  int B, N, H, D;
  long long st[9];  // strides of q, k, v in that order
  float scale;      // d^-1/2 * log2(e), the q prescale
};

// row 0 of head bh's (N, D) slice of q, k or v (i = 0, 1, 2)
__device__ __forceinline__ const bf16* head(const Operands& a, int i, int bh) {
  const bf16* base = i == 0 ? a.q : i == 1 ? a.k : a.v;
  return base + (bh / a.H) * a.st[3 * i] + (bh % a.H) * a.st[3 * i + 2];
}

// rows [r0, r0+rows) of one head into a (rows x LD) bf16 tile; rows >= n and
// columns >= d are zero. 16-byte chunks: d % 8 == 0 and 16-byte aligned rows
// are checked by the wrapper. With scale != 0 the values are multiplied by
// scale in fp32 and rounded back to bf16 (the q prescale). THREADS threads
// share the copy.
template <int DP, int LD, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long row_stride,
                                          int r0, int rows, int n, int d, float scale) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n && c < d) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + c);
      if (scale != 0.f) {
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float2 f = __bfloat1622float2(h2[j]);
          h2[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// S of the keys at or past kv (relative to the tile's first key) to -inf
template <int NT>
__device__ __forceinline__ void mask_keys(float (&s)[NT][4], int kv) {
  const int t = threadIdx.x % 4;
  if (kv >= NT * 8) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (nt * 8 + 2 * t + (e & 1) >= kv) s[nt][e] = -INFINITY;
}

// this thread's share of the running row max of rows g and g+8
template <int NT>
__device__ __forceinline__ void row_max(const float (&s)[NT][4], float (&m)[2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m[0] = fmaxf(m[0], fmaxf(s[nt][0], s[nt][1]));
    m[1] = fmaxf(m[1], fmaxf(s[nt][2], s[nt][3]));
  }
}

// the row max over the quad that holds a row
__device__ __forceinline__ void quad_max(float (&m)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
  }
}

// One warp's online-softmax step for its 16 rows over a key tile of NT n8
// tiles, S in the C layout (s[nt][0..1] row g, s[nt][2..3] row g+8), kv
// valid keys: masks the keys past kv, takes the new max m over the quad,
// rescales l and the NO accumulator tiles o by exp2(m_old - m_new), adds
// this thread's share of rowsum(P) to l (summed over the quad at the end),
// and leaves P = exp2(S - m) as bf16 A fragments in p, one per k16 step.
template <int NT, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], uint32_t (&p)[NT / 2][4],
                                             float (&o)[NO][4], float (&m)[2], float (&l)[2],
                                             int kv) {
  mask_keys<NT>(s, kv);
  float mx[2] = {m[0], m[1]};
  row_max<NT>(s, mx);
  quad_max(mx);
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    alpha[i] = PBE_SOFTMAX_EXP2(m[i] - mx[i]);  // 0 at the first tile (m = -inf)
    m[i] = mx[i];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float p0 = PBE_SOFTMAX_EXP2(s[nt][0] - m[0]), p1 = PBE_SOFTMAX_EXP2(s[nt][1] - m[0]);
    const float p2 = PBE_SOFTMAX_EXP2(s[nt][2] - m[1]), p3 = PBE_SOFTMAX_EXP2(s[nt][3] - m[1]);
    sum[0] += p0 + p1;
    sum[1] += p2 + p3;
    // n8 tiles 2k and 2k+1 are columns 0-7 and 8-15 of k16 step k
    p[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
    p[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
}

// The epilogue of one warp: its 16 rows [row0, row0+16) of head bh, columns
// [c0, c0 + 8*NO) of O, from the accumulator and l (summed over the quad
// here) as bf16 O / l, staged in the (16 x LD) tile `stage` that no other
// warp touches, then written as 16-byte chunks to o, (B, N, H, D)
// contiguous; the LSE m + log2(l) by one lane of each quad where lse_too.
template <int NO, int LD>
__device__ __forceinline__ void store_rows(float (&o)[NO][4], const float (&m)[2], float (&l)[2],
                                           bf16* stage, const Operands& a, int bh, int row0,
                                           int c0, bool lse_too) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n = a.N, h = a.H, d = a.D, b = bh / h, hh = bh % h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (c0 + j * 8 >= d) break;
    *reinterpret_cast<uint32_t*>(stage + g * LD + j * 8 + 2 * t) =
        pack_bf16(o[j][0] / l[0], o[j][1] / l[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + j * 8 + 2 * t) =
        pack_bf16(o[j][2] / l[1], o[j][3] / l[1]);
  }
  __syncwarp();
  constexpr int CH = NO;  // 16-byte chunks of a row
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    if (row0 + r < n && c0 + c < d)
      *reinterpret_cast<uint4*>(a.o + ((long long)(b * n + row0 + r) * h + hh) * d + c0 + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
  if (lse_too && a.lse != nullptr && t == 0) {
    if (row0 + g < n) a.lse[(long long)bh * n + row0 + g] = m[0] + log2f(l[0]);
    if (row0 + g + 8 < n) a.lse[(long long)bh * n + row0 + g + 8] = m[1] + log2f(l[1]);
  }
}

// a's fields from an entry's arguments; cudaErrorInvalidValue for a shape no
// launch takes
inline cudaError_t operands(Operands* a, const void* q, const void* k, const void* v, void* o,
                            void* lse, int B, int N, int H, int D, const long long* st,
                            float scale) {
  if (B <= 0 || N <= 0 || H <= 0 || D % 8 != 0 || B * H > 65535) return cudaErrorInvalidValue;
  *a = Operands{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
                B, N, H, D, {}, scale};
  for (int i = 0; i < 9; ++i) a->st[i] = st[i];
  return cudaSuccess;
}

// --- mbarriers, bulk copies and clusters (sm_90)

// an mbarrier in shared memory expecting `count` arrivals a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// the initialised barriers, and the generic-proxy writes before them, are
// visible to the cluster and to the async proxy (bulk copies)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival that also expects `bytes` more of copies this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra.uni WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one arrival on the barrier at the same offset as `bar` in the shared
// memory of the cluster's block `rank`
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster arrives; then waits for all
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();  // .aligned: the whole warp executes each barrier instruction
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into this block's shared memory at dst, completing on `bar`; with
// `mask` != 0 into the same offset in every block of the cluster that mask
// names, each copy completing on the barrier at bar's offset in its block
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint16_t mask) {
  if (mask == 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
        : "memory");
}

}  // namespace
