// Register-level building blocks shared by csrc/flash_fwd.cu,
// csrc/flash_variants.cu and csrc/flash_bwd.cu: cp.async copies into shared
// memory, ldmatrix, and the bf16 mma.sync.m16n8k16 tensor-core product, as
// PTX. Their lane layouts, written out beside each helper, are what the
// kernels' correctness rests on: every kernel that keeps its state in
// registers relies on the C layout of two adjacent n8 tiles being the A
// layout of one k16 step. Then the forward kernels' operands, online-softmax
// step and epilogue; the mbarrier, bulk-copy and cluster helpers of the
// resident kernel and of the d = 512 backward pair; that pair's TMA
// tensor copies, 128-byte swizzle and wgmma (sm_90a), whose accumulator
// layout is mma_bf16's C layout in n8 tiles; and the fp32 kernels' 3xTF32
// mma.sync.m16n8k8.
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

// one arrival on a barrier of this block (release at block scope)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// mbar_arrive_remote without release semantics: for a reader telling the
// writer in another block that a buffer may be written again, once the
// values it read from there have been used (a release arrival at cluster
// scope waits for this thread's memory accesses to complete first)
__device__ __forceinline__ void mbar_arrive_remote_relaxed(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// `bytes` (a multiple of 16) of this block's shared memory at src into the
// cluster's block `rank`, at the offset that `dst` has here, completing
// that block's barrier at the offset of `bar` by the bytes: the copy engine
// moves them, so the issuing thread waits on no acknowledgement; the
// receiver expects them (mbar_expect_tx) and reads once the phase completes
__device__ __forceinline__ void bulk_copy_peer(const void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 rd, rb;\n"
      "mapa.shared::cluster.u32 rd, %0, %3;\n"
      "mapa.shared::cluster.u32 rb, %2, %3;\n"
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [rd], [%1], %4, "
      "[rb];\n"
      "}\n" ::"r"(smem_addr(dst)),
      "r"(smem_addr(src)), "r"(smem_addr(bar)), "r"(rank), "r"(bytes)
      : "memory");
}

// the bulk copies this thread issued since the last commit form one group
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups have not yet read
// their source (it may be overwritten then)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// a barrier among `count` threads (a multiple of 32) of this block, by id
// 1..15 (0 is __syncthreads'): the consumer warpgroups of a block meet here
// without the producer
__device__ __forceinline__ void named_barrier(uint32_t id, uint32_t count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy that wgmma and the bulk copies read it through; the writing
// threads fence before they signal the readers
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- TMA tensor copies and wgmma (sm_90a)

// One box of a 4-d tensor map (dims innermost first; here (d, n, h, b) of a
// (B, N, H, D) operand, encoded on the host with cuTensorMapEncodeTiled)
// at coordinates (c0, c1, c2, c3) into this block's shared memory at dst,
// completing `bar`'s transaction count by the box's bytes. Elements outside
// the tensor (rows past N, columns past D) arrive as zeros, and the box
// lands in the map's swizzle (128-byte here: sw128 below).
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tmap, int c0, int c1, int c2,
                                            int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// Byte offset of bf16 element (row, col), col < 64, in a panel of 64
// columns stored in the 128-byte swizzle that TMA writes and wgmma reads:
// rows of 128 bytes, and the 16-byte chunk c of row r at chunk c ^ (r % 8),
// so 8 rows form a 1 KB atom (the panel starts 1 KB aligned). The 8 rows a
// warp's quad-pairs write in an mma fragment then hit 8 distinct chunks.
__host__ __device__ constexpr uint32_t sw128(int row, int col) {
  return row * 128 + ((((col * 2) >> 4) ^ (row & 7)) << 4) + ((col * 2) & 15);
}

// The shared-memory matrix descriptor of a wgmma operand in the 128-byte
// swizzle (PTX "matrix-descriptor-encode"): bits 0-13 the start address /
// 16, 16-29 the leading byte offset / 16, 32-45 the stride byte offset / 16,
// 62-63 the layout (1: 128-byte swizzle). K-major (the k16 slice of each
// row lies along a 128-byte row): SBO is the step between 8-row groups (1024
// B); LBO is unused; a k16 step inside the atom moves the start by 32 bytes.
// MN-major (transposed: the operand's rows run along k): SBO is the step
// between groups of 8 k rows (1024 B), LBO the step between 64-column
// panels; a k16 step moves the start by 2 KB.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// wgmma.fence: the warpgroup's register writes (accumulators, A fragments)
// are ordered before the wgmma.mma_async that follow; needed before the
// first wgmma of a batch whose registers ordinary code has touched
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// the wgmma.mma_async issued since the last commit form one group
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are in flight: their accumulators
// are written and their shared-memory and register operands read
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of x across the
// asynchronous product (its registers are written when the group completes)
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 in, fp32 accumulate, for the warpgroup:
// D (64 x N) = A (64 x 16) B (16 x N) + (acc ? D : 0). Thread t of the
// warpgroup holds rows 16 (t/32) + g and + 8 (g = t%32/4) of D; d[4j..4j+3]
// are columns 8j + 2(t%4), +1 of those two rows, so the accumulator is
// mma_bf16's C layout in n8 tiles, and n8 tiles 2k, 2k+1 rounded to bf16
// are the A fragment of k16 step k of a following product from registers.
// m64n32k16 with A and B both from shared memory, K-major (descriptors).
__device__ __forceinline__ void wgmma_m64n32_ss(float (&d)[16], uint64_t da, uint64_t db,
                                                int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// m64n32k16 with A from registers (mma_bf16's A fragment of the thread's
// rows) and B from shared memory K-major
__device__ __forceinline__ void wgmma_m64n32_rs(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// m64n128k16 and m64n256k16 with A from registers (a[0..3]: mma_bf16's A
// fragment of the thread's rows, as above) and B from shared memory
// MN-major (imm-trans-b = 1: the tile's rows run along k)
__device__ __forceinline__ void wgmma_m64n128_rs_t(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256_rs_t(float (&d)[128], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// --- the fp32 kernels' tensor-core product (csrc/flash_fp32.cu,
// csrc/flash_anyd.cu): an fp32 operand split into a tf32 high part and its
// remainder, and mma.sync.m16n8k8 in 3xTF32 (lo hi + hi lo + hi hi with
// fp32 accumulation), which keeps an fp32 product to about 2^-21 of each
// term where 1xTF32 keeps ~3 decimal digits; and a C-layout tile's trip
// through shared memory

// x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero:
// the bits of cvt.rna.tf32.f32 for finite x, in one integer add and one
// mask, which issue faster than the conversion
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo: hi = tf32(x) and lo = x - hi (exact) as it stands; the
// tensor cores read a tf32 operand's top 19 bits, so lo is truncated to 11
// significant bits there: hi + lo keeps x to 2^-21 of |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b for one m16n8k8 tile: a 16x8 tf32 (row), b 8x8 tf32 (col), c
// 16x8 fp32. Lane (g, t) = (lane/4, lane%4) holds a0..a3 = A[g][t],
// A[g+8][t], A[g][t+4], A[g+8][t+4]; b0, b1 = B[t][g], B[t+4][g]; c0..c3 =
// C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b in 3xTF32, (ah + al)(bh + bl) less al bl: ah bh into `big`, the
// small terms into `small` (two chains of dependent mma, not one)
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(small, al, bh[0], bh[1]);
  mma_tf32(small, ah, bl[0], bl[1]);
  mma_tf32(big, ah, bh[0], bh[1]);
}

// a 16 x 8 NT C-layout tile into shared memory at X (pitch LDX), and back
template <int NT, int LDX>
__device__ __forceinline__ void store_c(float* X, const float (&s)[NT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<float2*>(X + g * LDX + 8 * nt + 2 * t) = make_float2(s[nt][0], s[nt][1]);
    *reinterpret_cast<float2*>(X + (g + 8) * LDX + 8 * nt + 2 * t) =
        make_float2(s[nt][2], s[nt][3]);
  }
}

template <int NT, int LDX>
__device__ __forceinline__ void load_c(float (&s)[NT][4], const float* X) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 x = *reinterpret_cast<const float2*>(X + g * LDX + 8 * nt + 2 * t);
    const float2 y = *reinterpret_cast<const float2*>(X + (g + 8) * LDX + 8 * nt + 2 * t);
    s[nt][0] = x.x, s[nt][1] = x.y, s[nt][2] = y.x, s[nt][3] = y.y;
  }
}

}  // namespace
