// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax state:
// four kernels of one function.
//
// Replaces the four Pallas forward kernels of pbe_tpu/ops/flash_attention.py:
//   pbe_flash_fwd_bf16        what the models call: flash_fwd_kernel for
//                             _flash_kernel_rowblock (K1, :85; UNet
//                             self-attention, (B*8, N, d) = (16, 4096, 40),
//                             (16, 1024, 80), (16, 256, 160), (16, 64, 160))
//                             and flash_fwd_wide_kernel for _flash_kernel,
//                             the streamed variant (K2, :218; VAE mid-block
//                             attention, (1, 4096, 512));
//   pbe_flash_resident_bf16   _flash_kernel_resident (:182);
//   pbe_flash_pipelined_bf16  _flash_kernel_pipelined (:111).
// The last two are reached only by an explicit variant of
// ops/flash_attention.py flash_forward (the attention microbenchmark); the
// JAX package's `auto` picks neither at any shape. Same contracts for all:
//   * q is prescaled by d^-1/2 * log2(e) in fp32 and rounded to bf16, so the
//     scores come out of the product in the exp2 domain (exp2f below);
//   * P is cast to bf16 before the PV product; the output is divided by l;
//   * optional LSE = m + log2(l), fp32, (B*H, N), log2 domain.
// Inputs are (B, N, H, D) with explicit strides: no transpose copy. Head dims
// are padded to a multiple of 16 in shared memory only, by zero-filled loads
// (40 -> 48); ragged sequence tails are zero-filled and their scores masked
// to -inf, so no padded copy exists in device memory.
//
// flash_fwd_kernel (K1, and the tiny configs' d = 8..32) and
// flash_fwd_wide_kernel (K2, d = 512), the kernels pbe_flash_fwd_bf16
// dispatches to by padded head dim. They follow FlashAttention-2 on
// mma.sync.m16n8k16 (bf16 in, fp32 out), whose register layouts are
// documented, so that the online-softmax state never leaves registers:
//   * a warp owns 16 whole query rows; thread (g = lane/4, t = lane%4)
//     holds rows g and g+8 of every 16x8 tile of S and of O, so the row
//     max and row sum are taken in-thread and then over the quad (2
//     shuffles), m and l are two registers, and O is rescaled by
//     exp2(m_old - m_new) in registers;
//   * P = exp2(S - m) is rounded to bf16 in registers and fed straight
//     back as the A operand of the PV product: the C layout of two
//     adjacent n8 tiles of S is the A layout of one k16 step;
//   * K and V tiles arrive by cp.async (16-byte copies, zero-filled past N
//     and past d) into a ring of 2 stages: the copy of key tile j+1 is in
//     flight while tile j is computed, with one __syncthreads a tile. The
//     bf16 row pitch of DP+8 makes every ldmatrix (Q and K as they are, V
//     through .trans) free of bank conflicts;
//   * only QK^T runs over the padded head dim; the PV product runs over
//     the n8 tiles that hold d (5 at d = 40, not 6), and only the last key
//     tile masks scores;
//   * the epilogue stages O / l as bf16 over the warp's own rows of the
//     dead Q tile and writes 16-byte coalesced rows; one lane of each quad
//     writes the LSE.
// flash_fwd_kernel: q tile 16*WARPS rows, key tile BK, by padded head dim
//   (warps, BK): 16 and 32 (4, 64), 48 (16, 128), 80 (8, 128), 160 (4, 64);
//   the fastest of the settings scripts/sweep_flash_tiles.py builds (ds1
//   on an H100: 0.2922 ms at (16, 128), 0.4045 at (4, 64)). A smaller q
//   tile that fills more of the 132 SMs lost at ds4: (2 warps, 64) ran 128
//   blocks in 0.0244 ms, (4, 64) 64 blocks in 0.0227. Grids at the edit's
//   shapes (CFG batch 2, 8 heads): ds1 (4096, 40) 16 x 16 = 256 blocks of
//   16 warps, ds2 (1024, 80) 128 of 8, ds4 (256, 160) 64 of 4, ds8 (64,
//   160) 16 of 4. Shared memory (the q tile, then K and V of 2 stages):
//   15,360 / 25,600 / 86,016 / 112,640 / 107,520 bytes at DP 16 / 32 / 48
//   / 80 / 160. At DP 160 O takes 80 accumulator registers a thread.
// ptxas (-Xptxas -v, nvcc 12.9, sm_90a), registers a thread and spill
// bytes: flash_fwd_kernel at DP 16 / 32 / 48 / 80 / 160: 95 / 113 / 128 /
// 210 / 222, no spills; flash_fwd_wide_kernel 146, no spills. The file
// builds in about 50 s (chip_smoke.py phase 1 prints the time).
// flash_fwd_wide_kernel: at d = 512, 16 rows x 512 fp32 would be 256
//   registers a thread, so the head dim is split: 8 warps, 2 row groups x
//   4 column slices of 128 (64 accumulator registers), a q tile of 32 rows
//   and key tiles of 32. For S, warp (rg, c) takes row group rg and keys
//   [8c, 8c+8), Q through ldmatrix from shared memory, and writes its
//   16x8 fp32 tile to shared memory; after a barrier each warp reads its
//   row group's 16x32 S back in the C layout and takes the row statistics
//   and bf16 P in registers (the 4 slice warps of a row group do the same
//   exact arithmetic, so m and l agree), then multiplies by its slice of V.
//   Two __syncthreads a key tile. Shared memory: Q 33,280 + S 5,120 + K
//   and V of 2 stages 133,120 = 171,520 bytes (<= 232,448), one block of
//   8 warps an SM; grid 128 blocks at the edit's (1, 4096, 1, 512), 512
//   at training batch 4.
// What bounds them on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the
// function is 4*BH*N^2*d FLOP; at d = 40 the BH*N^2 exp2 (268M per ds1
// call at ~3.9 T/s of special-function throughput, 69 us) bind before the
// products (43 us), the tensor-core rate binds at ds2 and the VAE shape,
// the bytes at ds4/ds8. The design takes every shared-memory round trip of
// the online-softmax state off the loop, so exp2 and mma.sync are what is
// left; wgmma, TMA and warp specialisation are later work.
//
// flash_resident_kernel and flash_pipelined_kernel (K3, K4) run on
// nvcuda::wmma bf16 16x16x16 fragments, 4 warps a block, with the q tile of
// by_head_dim; Tile, copy_tile, start_q_tile, scores, online_softmax,
// accumulate_pv and write_out are theirs alone.
//
// flash_resident_kernel. On the TPU, "resident" keeps a head's whole (N, dp)
// K and V in VMEM and runs the online softmax over block_k slices of them.
// One SM's 227 KB cannot hold the UNet's K and V (896 KB at N = 4096, d = 40
// padded to 48 with a row pitch of 56), but the C blocks of a thread-block
// cluster, on neighbouring SMs, can read each other's shared memory. One
// cluster per batch*head. C (1, 2, 4 or 8, the portable sizes) and each
// block's share of `rows` rows (a multiple of the key block) are the
// caller's: ops/flash_attention.py resident_cluster_size mirrors the layout
// below, and pbe_flash_resident_smem reports it for chip_smoke.py to check.
// Block r loads rows [r*rows, (r+1)*rows) of K and V into its own shared
// memory once, the cluster syncs, and the blocks walk the head's q tiles r,
// r+C, .... For each key block a block copies K, then V, from the owning
// block's shared memory (distributed shared memory, 16-byte loads through
// map_shared_rank) into one local staging tile, and runs the wmma online
// softmax below. One staging tile for K and V in turn is what lets d = 512
// fit at all (N <= 256); the VAE's N = 4096 needs 8.5 MB and is refused by
// the wrapper. A last cluster sync keeps every share alive until no block
// reads it.
//
// flash_pipelined_kernel. The TPU kernel cuts the rowblock kernel into key
// chunks of block_c so that its matrix and vector units overlap across
// chunks. Here: one block per (batch*head, q tile) and two loops over the key
// chunks. Pass 1 computes S chunk by chunk and keeps only the running row
// max, taking no exp. Pass 2 recomputes S, takes P = exp2(S - m) against the
// final max, adds rowsum(P) to l and P V to the accumulator. Because m is
// final before pass 2, the accumulator is never rescaled, so it stays in wmma
// accumulator fragments in registers across the loop and goes through shared
// memory once, for the epilogue, over the dead S, P, K and V tiles where it
// fits. At d = 512 the q tile is 32 rows, so a warp holds 16 accumulator
// fragments (128 registers).
//
// K3 and K4 have the bound given above. The pipelined kernel does a second QK^T on top, 1.5x the function's
// tensor-core FLOP, and reads K twice; the resident kernel reads K and V
// from device memory once per head instead of once per q tile.
// Both are first versions, simple, not fast: S and P round-trip through
// shared memory and loads are synchronous; the resident kernel runs BH
// clusters of C blocks, one block an SM (16 x 8 = 128 blocks at ds1 but
// 16 x 2 = 32 at ds4, of 132 SMs), and copies every key block out of
// distributed shared memory before its product. wgmma/TMA pipelining is
// later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "mma_sm90.cuh"

namespace cg = cooperative_groups;
using namespace nvcuda;

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemPerBlock = 232448;  // bytes of shared memory a block can use

// One block's tiles: a q tile of BQ rows, key blocks of BK, head dim DP
// (padded), over 4 warps: warp (rt, wc) owns 16-row tile rt of the q tile
// and every WC-th 16-column tile of S and of O. Shared memory starts with the
// q tile, m and l, S (fp32), P (bf16) and, where SMEM_O, the fp32
// accumulator, each 128-byte aligned; each kernel puts its key tiles at END.
template <int DP, int BQ, int BK, bool SMEM_O = true>
struct Tile {
  static constexpr int LDQ = DP + 8;              // bf16 row pitch of Q, K and V
  static constexpr int LDS = BK + 4;              // fp32 row pitch of S
  static constexpr int LDP = BK + 8;              // bf16 row pitch of P
  static constexpr int LDO = DP + 4;              // fp32 row pitch of O
  static constexpr int RT = BQ / 16;              // 16-row tiles of the q tile
  static constexpr int WC = kWarps / RT;          // warps sharing one row tile
  static constexpr int CTO = DP / 16;             // column tiles of O
  static constexpr int NS = BK / 16 / WC;         // S tiles a warp
  static constexpr int NO = (CTO + WC - 1) / WC;  // O tiles a warp (at most)
  static constexpr size_t OFF_Q = 0;
  static constexpr size_t OFF_M = align128(size_t(BQ) * LDQ * 2);
  static constexpr size_t OFF_L = OFF_M + size_t(BQ) * 4;
  static constexpr size_t OFF_S = align128(OFF_L + size_t(BQ) * 4);
  static constexpr size_t OFF_P = align128(OFF_S + size_t(BQ) * LDS * 4);
  static constexpr size_t OFF_O = align128(OFF_P + size_t(BQ) * LDP * 2);
  static constexpr size_t END = align128(OFF_O + (SMEM_O ? size_t(BQ) * LDO * 4 : 0));
  // bytes of a (rows x DP) bf16 tile of K or V
  __host__ __device__ static constexpr size_t rows_bytes(int rows) {
    return align128(size_t(rows) * LDQ * 2);
  }
  static_assert(DP % 16 == 0 && BQ % 16 == 0 && BK % 32 == 0, "tile shape");
  static_assert(kWarps % RT == 0 && (BK / 16) % WC == 0, "warp layout");
};

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
template <int DP, int LD, int THREADS = kThreads>
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

// a (ROWS x DP) tile of pitch LD from src, another block's shared memory seen
// through a distributed-shared-memory pointer, in 16-byte chunks
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    *reinterpret_cast<uint4*>(dst + r * LD + c) = *reinterpret_cast<const uint4*>(src + r * LD + c);
  }
}

// the start of a q tile: rows [q0, q0+BQ) of q prescaled into sQ, m = -inf,
// l = 0
template <int DP, int BQ, int BK>
__device__ __forceinline__ void start_q_tile(const Operands& a, int bh, int q0, bf16* sQ,
                                             float* sM, float* sL) {
  load_rows<DP, Tile<DP, BQ, BK>::LDQ>(sQ, head(a, 0, bh), a.st[1], q0, BQ, a.N, a.D, a.scale);
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }
}

// S = Q K^T for one key block into sS (fp32): this warp's row tile rt,
// column tiles wc, wc+WC, ...
template <int DP, int BQ, int BK>
__device__ __forceinline__ void scores(const bf16* sQ, const bf16* sK, float* sS) {
  using T = Tile<DP, BQ, BK>;
  const int warp = threadIdx.x / 32, rt = warp % T::RT, wc = warp / T::RT;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::NS];
#pragma unroll
  for (int j = 0; j < T::NS; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, sQ + rt * 16 * T::LDQ + kk, T::LDQ);
#pragma unroll
    for (int j = 0; j < T::NS; ++j) {
      // K^T as a col-major (d x keys) operand is K row-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, sK + (wc + j * T::WC) * 16 * T::LDQ + kk, T::LDQ);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < T::NS; ++j)
    wmma::store_matrix_sync(sS + rt * 16 * T::LDS + (wc + j * T::WC) * 16, acc[j], T::LDS,
                            wmma::mem_row_major);
}

// online softmax over a key block of kv valid keys, one warp per row: new
// max, P = exp2(S - m) as bf16, l = l * alpha + rowsum(P) in fp32, and the
// accumulator row scaled by alpha
template <int DP, int BQ, int BK>
__device__ __forceinline__ void online_softmax(const float* sS, bf16* sP, float* sO, float* sM,
                                               float* sL, int kv) {
  using T = Tile<DP, BQ, BK>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BQ; r += kWarps) {
    float s[BK / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      const int c = lane + 32 * j;
      s[j] = c < kv ? sS[r * T::LDS + c] : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_old = sM[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      const float p = exp2f(s[j] - m_new);
      sum += p;
      sP[r * T::LDP + lane + 32 * j] = __float2bfloat16(p);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float alpha = exp2f(m_old - m_new);
    float4* orow = reinterpret_cast<float4*>(sO + r * T::LDO);
    for (int c4 = lane; c4 < DP / 4; c4 += 32) {
      float4 x = orow[c4];
      x.x *= alpha; x.y *= alpha; x.z *= alpha; x.w *= alpha;
      orow[c4] = x;
    }
    __syncwarp();  // every lane has read sM[r] before it changes
    if (lane == 0) {
      sM[r] = m_new;
      sL[r] = sL[r] * alpha + sum;
    }
  }
}

// O += P V with O in shared memory: this warp's row tile rt, column tiles
// wc, wc+WC, ... in chunks of CHUNK fragments loaded from and stored back to sO
template <int DP, int BQ, int BK>
__device__ __forceinline__ void accumulate_pv(const bf16* sP, const bf16* sV, float* sO) {
  using T = Tile<DP, BQ, BK>;
  constexpr int CHUNK = 4;  // O fragments held in registers at once
  const int warp = threadIdx.x / 32, rt = warp % T::RT, wc = warp / T::RT;
#pragma unroll
  for (int j0 = 0; j0 < T::NO; j0 += CHUNK) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int ct = wc + (j0 + j) * T::WC;
      if (j0 + j < T::NO && ct < T::CTO)
        wmma::load_matrix_sync(acc[j], sO + rt * 16 * T::LDO + ct * 16, T::LDO,
                               wmma::mem_row_major);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sP + rt * 16 * T::LDP + kk, T::LDP);
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int ct = wc + (j0 + j) * T::WC;
        if (j0 + j < T::NO && ct < T::CTO) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, sV + kk * T::LDQ + ct * 16, T::LDQ);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int ct = wc + (j0 + j) * T::WC;
      if (j0 + j < T::NO && ct < T::CTO)
        wmma::store_matrix_sync(sO + rt * 16 * T::LDO + ct * 16, acc[j], T::LDO,
                                wmma::mem_row_major);
    }
  }
}

// the epilogue of q tile [q0, q0+BQ) of head bh: O / l to bf16 into o, (B, N,
// H, D) contiguous; the LSE in the log2 domain
template <int DP, int BQ, int BK>
__device__ __forceinline__ void write_out(const float* sO, const float* sM, const float* sL,
                                          const Operands& a, int bh, int q0) {
  using T = Tile<DP, BQ, BK>;
  const int n = a.N, h = a.H, d = a.D, b = bh / h, hh = bh % h;
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < BQ * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    if (q0 + r >= n || c >= d) continue;
    const float l = sL[r];
    const float* src = sO + r * T::LDO + c;
    uint4 val;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
    for (int j = 0; j < 4; ++j) h2[j] = __floats2bfloat162_rn(src[2 * j] / l, src[2 * j + 1] / l);
    *reinterpret_cast<uint4*>(a.o + ((long long)(b * n + q0 + r) * h + hh) * d + c) = val;
  }
  if (a.lse != nullptr)
    for (int r = threadIdx.x; r < BQ; r += kThreads)
      if (q0 + r < n) a.lse[(long long)bh * n + q0 + r] = sM[r] + log2f(sL[r]);
}

#define PBE_SMEM_POINTERS(T)                                           \
  extern __shared__ __align__(128) unsigned char smem[];              \
  bf16* sQ = reinterpret_cast<bf16*>(smem + T::OFF_Q);                \
  float* sM = reinterpret_cast<float*>(smem + T::OFF_M);              \
  float* sL = reinterpret_cast<float*>(smem + T::OFF_L);              \
  float* sS = reinterpret_cast<float*>(smem + T::OFF_S);              \
  bf16* sP = reinterpret_cast<bf16*>(smem + T::OFF_P);                \
  float* sO = reinterpret_cast<float*>(smem + T::OFF_O)

// --- flash_fwd_kernel and flash_fwd_wide_kernel: mma.sync, state in registers
// (cp.async, ldmatrix, mma_bf16, pack_bf16, cp_async_rows and pv_product are
// csrc/mma_sm90.cuh's, shared with the backward)

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
  const int t = threadIdx.x % 4;
  if (kv < NT * 8) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (nt * 8 + 2 * t + (e & 1) >= kv) s[nt][e] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = exp2f(m[i] - mx[i]);  // 0 at the first tile (m = -inf)
    m[i] = mx[i];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float p0 = exp2f(s[nt][0] - m[0]), p1 = exp2f(s[nt][1] - m[0]);
    const float p2 = exp2f(s[nt][2] - m[1]), p3 = exp2f(s[nt][3] - m[1]);
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

// flash_fwd_kernel's tiles: WARPS warps of 16 query rows, key tiles of BK,
// head dim DP (padded); shared memory holds the q tile, then K and V of
// stages 0 and 1
template <int DP, int WARPS, int BK>
struct FwdTile {
  static constexpr int THREADS = 32 * WARPS, BQ = 16 * WARPS;
  static constexpr int LD = DP + 8;  // bf16 row pitch: conflict-free ldmatrix
  static constexpr int KS = DP / 16;  // k16 steps of Q K^T
  static constexpr int NT = BK / 8;   // n8 tiles of S
  static constexpr int NO = DP / 8;   // n8 tiles of O (those past d are skipped)
  static constexpr size_t TILE = size_t(BK) * LD * 2;  // one K or V tile
  static constexpr size_t OFF_KV = align128(size_t(BQ) * LD * 2);
  static constexpr size_t SMEM = OFF_KV + 4 * TILE;
  static_assert(DP % 16 == 0 && BK % 16 == 0 && NO % 2 == 0, "tile shape");
  static_assert(SMEM <= kSmemPerBlock, "shared memory per block");
};

template <int DP, int WARPS, int BK>
__global__ void __launch_bounds__(32 * WARPS, 1) flash_fwd_kernel(const Operands a) {
  using T = FwdTile<DP, WARPS, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = reinterpret_cast<bf16*>(smem + T::OFF_KV);  // K0, V0, K1, V1
  constexpr int TE = BK * T::LD;                           // elements of one tile
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N, d = a.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* kb = head(a, 1, bh);
  const bf16* vb = head(a, 2, bh);
  const int tiles = (n + BK - 1) / BK;

  // key tile 0 is in flight while Q is loaded, prescaled, and taken into
  // registers
  cp_async_rows<DP, T::LD, BK, T::THREADS>(sKV, kb, a.st[4], 0, n, d);
  cp_async_rows<DP, T::LD, BK, T::THREADS>(sKV + TE, vb, a.st[7], 0, n, d);
  cp_async_commit();
  load_rows<DP, T::LD, T::THREADS>(sQ, head(a, 0, bh), a.st[1], q0, T::BQ, n, d, a.scale);
  __syncthreads();
  bf16* sQw = sQ + warp * 16 * T::LD;  // this warp's rows
  uint32_t qf[T::KS][4];
#pragma unroll
  for (int kk = 0; kk < T::KS; ++kk) ldsm_x4(qf[kk], sQw + (lane % 16) * T::LD + kk * 16 + (lane / 16) * 8);

  float o[T::NO][4];
#pragma unroll
  for (int j = 0; j < T::NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < tiles; ++j) {
    cp_async_wait_all();
    // tile j is visible to every thread, and every warp is done with tile
    // j-1, whose stage the next copy overwrites
    __syncthreads();
    if (j + 1 < tiles) {
      bf16* nxt = sKV + ((j + 1) & 1) * 2 * TE;
      cp_async_rows<DP, T::LD, BK, T::THREADS>(nxt, kb, a.st[4], (j + 1) * BK, n, d);
      cp_async_rows<DP, T::LD, BK, T::THREADS>(nxt + TE, vb, a.st[7], (j + 1) * BK, n, d);
      cp_async_commit();
    }
    const bf16* sK = sKV + (j & 1) * 2 * TE;

    // S = Q K^T: lanes 0-7 / 8-15 give keys 0-7 of an n8 pair at head-dim
    // columns +0 / +8 (b0, b1 of tile nt), lanes 16-31 keys 8-15 (tile nt+1)
    float s[T::NT][4];
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const bf16* krow = sK + ((lane % 8) + (lane / 16) * 8) * T::LD + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < T::KS; ++kk)
#pragma unroll
      for (int nt = 0; nt < T::NT; nt += 2) {
        uint32_t b[4];
        ldsm_x4(b, krow + nt * 8 * T::LD + kk * 16);
        mma_bf16(s[nt], qf[kk], b[0], b[1]);
        mma_bf16(s[nt + 1], qf[kk], b[2], b[3]);
      }

    uint32_t p[T::NT / 2][4];
    softmax_step<T::NT, T::NO>(s, p, o, m, l, n - j * BK);
    pv_product<T::NT / 2, T::NO, T::LD>(o, p, sK + TE, 0, d);
  }
  // only this warp read its rows of sQ, so they take its output
  store_rows<T::NO, T::LD>(o, m, l, sQw, a, bh, q0 + warp * 16, 0, true);
}

template <int DP, int WARPS, int BK>
cudaError_t launch_fwd(const Operands& a, cudaStream_t stream) {
  using T = FwdTile<DP, WARPS, BK>;
  auto kern = flash_fwd_kernel<DP, WARPS, BK>;
  // once per instantiation (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return attr;
  kern<<<dim3((a.N + T::BQ - 1) / T::BQ, a.B * a.H), T::THREADS, T::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// flash_fwd_wide_kernel's tiles at d = 512: 8 warps, warp w in row group
// w / 4 (16 of the 32 query rows) and slice w % 4 (key columns [8c, 8c+8)
// of S, head-dim columns [128c, 128c+128) of O); shared memory holds Q, S
// (fp32) and K and V of stages 0 and 1
struct WideTile {
  static constexpr int DP = 512, BQ = 32, BK = 32, WARPS = 8, THREADS = 32 * WARPS;
  static constexpr int LD = DP + 8;    // bf16 row pitch of Q, K and V
  static constexpr int LDS = BK + 8;   // fp32 row pitch of S: conflict-free float2
  static constexpr int SLICE = DP / 4;  // columns of O a warp
  static constexpr int NO = SLICE / 8;  // its n8 tiles
  static constexpr size_t TILE = size_t(BK) * LD * 2;
  static constexpr size_t OFF_S = align128(size_t(BQ) * LD * 2);
  static constexpr size_t OFF_KV = align128(OFF_S + size_t(BQ) * LDS * 4);
  static constexpr size_t SMEM = OFF_KV + 4 * TILE;
  static_assert(SMEM <= kSmemPerBlock, "shared memory per block");
};

__global__ void __launch_bounds__(WideTile::THREADS) flash_fwd_wide_kernel(const Operands a) {
  using T = WideTile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  float* sS = reinterpret_cast<float*>(smem + T::OFF_S);
  bf16* sKV = reinterpret_cast<bf16*>(smem + T::OFF_KV);  // K0, V0, K1, V1
  constexpr int TE = T::BK * T::LD;
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N, d = a.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg = warp / 4, slice = warp % 4;
  const bf16* kb = head(a, 1, bh);
  const bf16* vb = head(a, 2, bh);
  const int tiles = (n + T::BK - 1) / T::BK;

  cp_async_rows<T::DP, T::LD, T::BK, T::THREADS>(sKV, kb, a.st[4], 0, n, d);
  cp_async_rows<T::DP, T::LD, T::BK, T::THREADS>(sKV + TE, vb, a.st[7], 0, n, d);
  cp_async_commit();
  load_rows<T::DP, T::LD, T::THREADS>(sQ, head(a, 0, bh), a.st[1], q0, T::BQ, n, d, a.scale);

  float o[T::NO][4];
#pragma unroll
  for (int j = 0; j < T::NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // Q rows of this row group (A fragments), K rows of this slice's 8 keys
  // at head-dim columns +0, +8, +16, +24 (b0, b1 of two k16 steps)
  const bf16* qrow = sQ + (rg * 16 + lane % 16) * T::LD + (lane / 16) * 8;
  const int koff = (slice * 8 + lane % 8) * T::LD + (lane / 8) * 8;

  for (int j = 0; j < tiles; ++j) {
    cp_async_wait_all();
    // tile j (and at j = 0 the Q tile) is visible to every thread; every
    // warp is done with tile j-1's stage and with sS
    __syncthreads();
    if (j + 1 < tiles) {
      bf16* nxt = sKV + ((j + 1) & 1) * 2 * TE;
      cp_async_rows<T::DP, T::LD, T::BK, T::THREADS>(nxt, kb, a.st[4], (j + 1) * T::BK, n, d);
      cp_async_rows<T::DP, T::LD, T::BK, T::THREADS>(nxt + TE, vb, a.st[7], (j + 1) * T::BK, n,
                                                     d);
      cp_async_commit();
    }
    const bf16* sK = sKV + (j & 1) * 2 * TE;

    // this warp's 16x8 tile of S over the whole head dim, in 4 independent
    // accumulators (shorter dependent chains), summed at the end
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T::DP / 16; kk += 2) {
      uint32_t b[4], qa[4], qb[4];
      ldsm_x4(b, sK + koff + kk * 16);
      ldsm_x4(qa, qrow + kk * 16);
      ldsm_x4(qb, qrow + kk * 16 + 16);
      mma_bf16(acc[kk % 4], qa, b[0], b[1]);
      mma_bf16(acc[(kk + 1) % 4], qb, b[2], b[3]);
    }
    float* srow = sS + (rg * 16 + g) * T::LDS + slice * 8 + 2 * t;
    *reinterpret_cast<float2*>(srow) = make_float2(acc[0][0] + acc[1][0] + acc[2][0] + acc[3][0],
                                                   acc[0][1] + acc[1][1] + acc[2][1] + acc[3][1]);
    *reinterpret_cast<float2*>(srow + 8 * T::LDS) =
        make_float2(acc[0][2] + acc[1][2] + acc[2][2] + acc[3][2],
                    acc[0][3] + acc[1][3] + acc[2][3] + acc[3][3]);
    __syncthreads();  // the row group's 16x32 S is whole

    // every warp of the row group reads all of its S back in the C layout
    float s[T::BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < T::BK / 8; ++nt) {
      const float* r = sS + (rg * 16 + g) * T::LDS + nt * 8 + 2 * t;
      const float2 x = *reinterpret_cast<const float2*>(r);
      const float2 y = *reinterpret_cast<const float2*>(r + 8 * T::LDS);
      s[nt][0] = x.x;
      s[nt][1] = x.y;
      s[nt][2] = y.x;
      s[nt][3] = y.y;
    }
    uint32_t p[T::BK / 16][4];
    softmax_step<T::BK / 8, T::NO>(s, p, o, m, l, n - j * T::BK);
    pv_product<T::BK / 16, T::NO, T::LD>(o, p, sK + TE, slice * T::SLICE, d);
  }
  // sQ is dead since the last tile's barrier: each warp stages its 16 x 128
  // block of O in its own rows and columns of it
  store_rows<T::NO, T::LD>(o, m, l, sQ + rg * 16 * T::LD + slice * T::SLICE, a, bh,
                           q0 + rg * 16, slice * T::SLICE, slice == 0);
}

cudaError_t launch_fwd_wide(const Operands& a, cudaStream_t stream) {
  using T = WideTile;
  // once (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return attr;
  flash_fwd_wide_kernel<<<dim3((a.N + T::BQ - 1) / T::BQ, a.B * a.H), T::THREADS, T::SMEM,
                          stream>>>(a);
  return cudaGetLastError();
}

// --- flash_resident_kernel: K and V held by a thread-block cluster ---------

// the key blocks instantiated at each padded head dim (past these, the
// working tiles leave no room for a share of K and V of one key block);
// ops/flash_attention.py RESIDENT_BLOCKS lists the same
constexpr bool resident_instantiated(int dp, int bk) {
  return (bk < 128 || dp <= 80) && (dp < 512 || bk == 32);
}

// the working tiles, one staging tile of K or V, and the block's shares of K
// and of V, `rows` rows each
template <int DP, int BQ, int BK>
constexpr size_t resident_smem(int rows) {
  using T = Tile<DP, BQ, BK>;
  return T::END + T::rows_bytes(BK) + 2 * T::rows_bytes(rows);
}

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_resident_kernel(const Operands a, int rows) {
  using T = Tile<DP, BQ, BK>;
  PBE_SMEM_POINTERS(T);
  bf16* sKV = reinterpret_cast<bf16*>(smem + T::END);
  bf16* sKs = reinterpret_cast<bf16*>(smem + T::END + T::rows_bytes(BK));
  bf16* sVs = reinterpret_cast<bf16*>(smem + T::END + T::rows_bytes(BK) + T::rows_bytes(rows));

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)gridDim.x;  // the grid is one cluster wide
  const int bh = blockIdx.y, n = a.N;

  // this block's share of the head's K and V, loaded once
  load_rows<DP, T::LDQ>(sKs, head(a, 1, bh), a.st[4], rank * rows, rows, n, a.D, 0.f);
  load_rows<DP, T::LDQ>(sVs, head(a, 2, bh), a.st[7], rank * rows, rows, n, a.D, 0.f);
  cluster.sync();

  for (int q0 = rank * BQ; q0 < n; q0 += csize * BQ) {
    __syncthreads();  // the previous q tile's epilogue is done with sQ, sO, sM, sL
    start_q_tile<DP, BQ, BK>(a, bh, q0, sQ, sM, sL);
    for (int i = threadIdx.x; i < BQ * T::LDO; i += kThreads) sO[i] = 0.f;
    for (int k0 = 0; k0 < n; k0 += BK) {
      // the key block lies whole in one share: rows is a multiple of BK
      const int owner = k0 / rows;
      const long long koff = (long long)(k0 - owner * rows) * T::LDQ;
      const bf16* rk = cluster.map_shared_rank(sKs, owner) + koff;
      const bf16* rv = cluster.map_shared_rank(sVs, owner) + koff;
      __syncthreads();  // previous PV product done with sKV / sP
      copy_tile<BK, DP, T::LDQ>(sKV, rk);
      __syncthreads();
      scores<DP, BQ, BK>(sQ, sKV, sS);
      __syncthreads();
      copy_tile<BK, DP, T::LDQ>(sKV, rv);  // V over K: the S product is done with it
      online_softmax<DP, BQ, BK>(sS, sP, sO, sM, sL, min(BK, n - k0));
      __syncthreads();
      accumulate_pv<DP, BQ, BK>(sP, sKV, sO);
    }
    __syncthreads();
    write_out<DP, BQ, BK>(sO, sM, sL, a, bh, q0);
  }
  cluster.sync();  // no block leaves while another may still read its share
}

template <int DP, int BQ, int BK>
cudaError_t launch_resident(const Operands& a, int cluster, int rows, cudaStream_t stream) {
  static_assert(resident_smem<DP, BQ, BK>(BK) <= kSmemPerBlock, "shared memory per block");
  const size_t smem = resident_smem<DP, BQ, BK>(rows);
  if (smem > kSmemPerBlock) return cudaErrorInvalidValue;
  auto kern = flash_resident_kernel<DP, BQ, BK>;
  // once per instantiation (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemPerBlock);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute dims[1];
  dims[0].id = cudaLaunchAttributeClusterDimension;
  dims[0].val.clusterDim.x = cluster;
  dims[0].val.clusterDim.y = 1;
  dims[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, a.B * a.H);  // one cluster per batch*head
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = dims;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a, rows);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// --- flash_pipelined_kernel: two passes, the final max, O in registers -----

// the key chunks instantiated at each padded head dim (at d = 512, K and V
// chunks of 128 rows do not fit beside the rest); ops/flash_attention.py
// PIPELINED_BLOCKS lists the same
constexpr bool pipelined_instantiated(int dp, int bc) { return bc < 128 || dp <= 160; }

// Shared memory past the Tile's (which holds no O): K and V chunks, then O
// for the epilogue, over S, P, K and V where it fits
template <int DP, int BQ, int BC>
struct PipelinedSmem {
  using T = Tile<DP, BQ, BC, false>;
  static constexpr size_t KV_END = T::END + 2 * T::rows_bytes(BC);
  static constexpr size_t O_BYTES = size_t(BQ) * T::LDO * 4;
  static constexpr bool O_OVER = O_BYTES <= KV_END - T::OFF_S;
  static constexpr size_t OFF_O = O_OVER ? T::OFF_S : KV_END;
  static constexpr size_t SMEM = O_OVER ? KV_END : KV_END + O_BYTES;
  static_assert(SMEM <= kSmemPerBlock, "shared memory per block");
};

template <int DP, int BQ, int BC>
__global__ void __launch_bounds__(kThreads) flash_pipelined_kernel(const Operands a) {
  using T = Tile<DP, BQ, BC, false>;
  using L = PipelinedSmem<DP, BQ, BC>;
  PBE_SMEM_POINTERS(T);
  (void)sO;  // no accumulator in shared memory until the epilogue's, at L::OFF_O
  bf16* sK = reinterpret_cast<bf16*>(smem + T::END);
  bf16* sV = reinterpret_cast<bf16*>(smem + T::END + T::rows_bytes(BC));
  float* sOut = reinterpret_cast<float*>(smem + L::OFF_O);
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ, n = a.N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rt = warp % T::RT, wc = warp / T::RT;
  const bf16* kb = head(a, 1, bh);
  const bf16* vb = head(a, 2, bh);

  start_q_tile<DP, BQ, BC>(a, bh, q0, sQ, sM, sL);

  // pass 1: the final row max, one warp per row
  for (int k0 = 0; k0 < n; k0 += BC) {
    __syncthreads();  // the previous chunk's max is done with sS, its product with sK
    load_rows<DP, T::LDQ>(sK, kb, a.st[4], k0, BC, n, a.D, 0.f);
    __syncthreads();
    scores<DP, BQ, BC>(sQ, sK, sS);
    __syncthreads();
    const int kv = min(BC, n - k0);
    for (int r = warp; r < BQ; r += kWarps) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BC / 32; ++j) {
        const int c = lane + 32 * j;
        if (c < kv) mx = fmaxf(mx, sS[r * T::LDS + c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) sM[r] = fmaxf(sM[r], mx);
    }
  }

  // pass 2: P = exp2(S - m) against the final max, l += rowsum(P), O += P V
  // with O in registers: nothing is rescaled
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::NO];
#pragma unroll
  for (int j = 0; j < T::NO; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = 0; k0 < n; k0 += BC) {
    __syncthreads();  // previous PV product done with sV / sP; pass 1 done with sM
    load_rows<DP, T::LDQ>(sK, kb, a.st[4], k0, BC, n, a.D, 0.f);
    load_rows<DP, T::LDQ>(sV, vb, a.st[7], k0, BC, n, a.D, 0.f);
    __syncthreads();
    scores<DP, BQ, BC>(sQ, sK, sS);
    __syncthreads();
    const int kv = min(BC, n - k0);
    for (int r = warp; r < BQ; r += kWarps) {
      const float m = sM[r];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BC / 32; ++j) {
        const int c = lane + 32 * j;
        const float p = c < kv ? exp2f(sS[r * T::LDS + c] - m) : 0.f;
        sum += p;
        sP[r * T::LDP + c] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) sL[r] += sum;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sP + rt * 16 * T::LDP + kk, T::LDP);
#pragma unroll
      for (int j = 0; j < T::NO; ++j) {
        const int ct = wc + j * T::WC;
        if (ct < T::CTO) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, sV + kk * T::LDQ + ct * 16, T::LDQ);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with sS, sP, sK, sV before O lands over them
#pragma unroll
  for (int j = 0; j < T::NO; ++j) {
    const int ct = wc + j * T::WC;
    if (ct < T::CTO)
      wmma::store_matrix_sync(sOut + rt * 16 * T::LDO + ct * 16, acc[j], T::LDO,
                              wmma::mem_row_major);
  }
  __syncthreads();
  write_out<DP, BQ, BC>(sOut, sM, sL, a, bh, q0);
}

template <int DP, int BQ, int BC>
cudaError_t launch_pipelined(const Operands& a, cudaStream_t stream) {
  constexpr size_t smem = PipelinedSmem<DP, BQ, BC>::SMEM;
  auto kern = flash_pipelined_kernel<DP, BQ, BC>;
  // once per instantiation (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  kern<<<dim3((a.N + BQ - 1) / BQ, a.B * a.H), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// --- dispatch ---------------------------------------------------------------

template <int DP_, int BQ_>
struct HeadDim {
  static constexpr int DP = DP_, BQ = BQ_;
};

// f(HeadDim<DP, BQ>) at D's padded head dim DP and the q tile BQ of the
// resident and pipelined kernels there: 48/80/160/512 serve configs/v1.yaml (d = 40, 80, 160 and the
// VAE's 512), 16/32 configs/tiny.yaml (ops/flash_attention.py
// SUPPORTED_HEAD_DIMS and BLOCK_Q list the same)
template <class F>
cudaError_t by_head_dim(int D, F f) {
  switch ((D + 15) / 16 * 16) {
    case 16:  return f(HeadDim<16, 64>{});
    case 32:  return f(HeadDim<32, 64>{});
    case 48:  return f(HeadDim<48, 64>{});
    case 80:  return f(HeadDim<80, 64>{});
    case 160: return f(HeadDim<160, 64>{});
    case 512: return f(HeadDim<512, 32>{});
    default:  return cudaErrorInvalidValue;
  }
}

// f(HeadDim, std::integral_constant<int, BK>) at D's head dim and a key
// block BK = block of 32, 64 or 128
template <class F>
cudaError_t by_tiles(int D, int block, F f) {
  return by_head_dim(D, [&](auto hd) -> cudaError_t {
    switch (block) {
      case 32:  return f(hd, std::integral_constant<int, 32>{});
      case 64:  return f(hd, std::integral_constant<int, 64>{});
      case 128: return f(hd, std::integral_constant<int, 128>{});
      default:  return cudaErrorInvalidValue;
    }
  });
}

cudaError_t operands(Operands* a, const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int N, int H, int D, const long long* st, float scale) {
  if (B <= 0 || N <= 0 || H <= 0 || D % 8 != 0 || B * H > 65535) return cudaErrorInvalidValue;
  *a = Operands{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
                B, N, H, D, {}, scale};
  for (int i = 0; i < 9; ++i) a->st[i] = st[i];
  return cudaSuccess;
}

}  // namespace

// Every entry: q, k, v bf16 (B, N, H, D), each with element strides (batch,
// seq, head) in `st` (q, k, v in that order) and a unit head-dim stride; o
// bf16 (B, N, H, D) contiguous; lse fp32 (B*H, N) or null; scale the q
// prescale d^-1/2 * log2(e). Launches on `stream`; returns the cudaError_t
// of the launch.

// The models' forward: flash_fwd_kernel (warps, key tile) by padded head
// dim, flash_fwd_wide_kernel at 512; ops/flash_attention.py
// SUPPORTED_HEAD_DIMS lists the same head dims.
extern "C" int pbe_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int N, int H, int D, const long long* st,
                                  float scale, void* stream) {
  Operands a;
  cudaError_t err = operands(&a, q, k, v, o, lse, B, N, H, D, st, scale);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16:  return (int)launch_fwd<16, 4, 64>(a, s);
    case 32:  return (int)launch_fwd<32, 4, 64>(a, s);
    case 48:  return (int)launch_fwd<48, 16, 128>(a, s);
    case 80:  return (int)launch_fwd<80, 8, 128>(a, s);
    case 160: return (int)launch_fwd<160, 4, 64>(a, s);
    case 512: return (int)launch_fwd_wide(a, s);
    default:  return (int)cudaErrorInvalidValue;
  }
}

// K3: block_k the key block (resident_instantiated); cluster the blocks per
// cluster (1, 2, 4 or 8); rows each block's share of K and of V, a multiple
// of block_k with rows * cluster >= N.
extern "C" int pbe_flash_resident_bf16(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int N, int H, int D,
                                       const long long* st, float scale, int block_k,
                                       int cluster, int rows, void* stream) {
  Operands a;
  cudaError_t err = operands(&a, q, k, v, o, lse, B, N, H, D, st, scale);
  if (err != cudaSuccess) return (int)err;
  if ((cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || rows <= 0 ||
      rows % block_k != 0 || (long long)rows * cluster < N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_tiles(D, block_k, [&](auto hd, auto bk) -> cudaError_t {
    constexpr int DP = decltype(hd)::DP, BQ = decltype(hd)::BQ, BK = decltype(bk)::value;
    if constexpr (resident_instantiated(DP, BK)) return launch_resident<DP, BQ, BK>(a, cluster, rows, s);
    return cudaErrorInvalidValue;
  });
}

// Bytes of shared memory a block of pbe_flash_resident_bf16 takes at head
// dim D, key block block_k and a share of `rows` rows; -1 where that key
// block is not instantiated. ops/flash_attention.py resident_smem computes
// the same.
extern "C" long long pbe_flash_resident_smem(int D, int block_k, int rows) {
  long long bytes = -1;
  by_tiles(D, block_k, [&](auto hd, auto bk) -> cudaError_t {
    constexpr int DP = decltype(hd)::DP, BQ = decltype(hd)::BQ, BK = decltype(bk)::value;
    if constexpr (resident_instantiated(DP, BK)) bytes = (long long)resident_smem<DP, BQ, BK>(rows);
    return cudaSuccess;
  });
  return bytes;
}

// K4: block_c the key chunk (pipelined_instantiated).
extern "C" int pbe_flash_pipelined_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int N, int H, int D,
                                        const long long* st, float scale, int block_c,
                                        void* stream) {
  Operands a;
  cudaError_t err = operands(&a, q, k, v, o, lse, B, N, H, D, st, scale);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_tiles(D, block_c, [&](auto hd, auto bc) -> cudaError_t {
    constexpr int DP = decltype(hd)::DP, BQ = decltype(hd)::BQ, BC = decltype(bc)::value;
    if constexpr (pipelined_instantiated(DP, BC)) return launch_pipelined<DP, BQ, BC>(a, s);
    return cudaErrorInvalidValue;
  });
}
