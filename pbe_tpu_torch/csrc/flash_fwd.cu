// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax state:
// three kernels of one function.
//
// Replaces the four Pallas forward kernels of pbe_tpu/ops/flash_attention.py:
//   pbe_flash_fwd_bf16        _flash_kernel_rowblock (:85; UNet self-attention,
//                             (B*8, N, d) = (16, 4096, 40), (16, 1024, 80),
//                             (16, 256, 160), (16, 64, 160)) and _flash_kernel,
//                             the streamed variant (:218; VAE mid-block
//                             attention, (1, 4096, 512)): what the models call;
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
// to -inf, so no padded copy exists in device memory. Products run on the
// tensor cores through nvcuda::wmma bf16 16x16x16 fragments, 4 warps a block.
//
// flash_fwd_kernel. One block per (batch*head, q tile); a loop over key tiles
// inside the block takes the place of the TPU's sequential grid axis, with
// the online-softmax state (m, l, O accumulator) in fp32 shared memory: the
// wmma accumulator layout is opaque, so O cannot be rescaled in registers.
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
// map_shared_rank) into one local staging tile, and runs flash_fwd_kernel's
// online softmax. One staging tile for K and V in turn is what lets d = 512
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
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the function is
// 4*BH*N^2*d FLOP (ds1 42.9 GFLOP -> 43 us; VAE 34.4 GFLOP -> 35 us); the
// tensor-core rate binds at ds2 and the VAE shape and the bytes at ds4/ds8;
// at d=40 the BH*N^2 = 268M exp2 per ds1 call at ~3.9 TFLOP/s of
// special-function throughput (69 us) binds before the products. The
// pipelined kernel does a second QK^T on top, 1.5x the function's
// tensor-core FLOP, and reads K twice; the resident kernel reads K and V
// from device memory once per head instead of once per q tile.
// These first versions are simple, not fast: S and P round-trip through
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

namespace cg = cooperative_groups;
using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemPerBlock = 232448;  // bytes of shared memory a block can use

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

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
// scale in fp32 and rounded back to bf16 (the q prescale).
template <int DP, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long row_stride,
                                          int r0, int rows, int n, int d, float scale) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < rows * CH; i += kThreads) {
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

// --- flash_fwd_kernel: key tiles streamed from device memory --------------

template <int DP, int BQ, int BK>
constexpr size_t fwd_smem() {
  return Tile<DP, BQ, BK>::END + 2 * Tile<DP, BQ, BK>::rows_bytes(BK);  // + K, V
}

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Operands a) {
  using T = Tile<DP, BQ, BK>;
  PBE_SMEM_POINTERS(T);
  bf16* sK = reinterpret_cast<bf16*>(smem + T::END);
  bf16* sV = reinterpret_cast<bf16*>(smem + T::END + T::rows_bytes(BK));
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ, n = a.N;
  const bf16* kb = head(a, 1, bh);
  const bf16* vb = head(a, 2, bh);

  start_q_tile<DP, BQ, BK>(a, bh, q0, sQ, sM, sL);
  for (int i = threadIdx.x; i < BQ * T::LDO; i += kThreads) sO[i] = 0.f;
  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // previous PV product done with sV / sP
    load_rows<DP, T::LDQ>(sK, kb, a.st[4], k0, BK, n, a.D, 0.f);
    load_rows<DP, T::LDQ>(sV, vb, a.st[7], k0, BK, n, a.D, 0.f);
    __syncthreads();
    scores<DP, BQ, BK>(sQ, sK, sS);
    __syncthreads();
    online_softmax<DP, BQ, BK>(sS, sP, sO, sM, sL, min(BK, n - k0));
    __syncthreads();
    accumulate_pv<DP, BQ, BK>(sP, sV, sO);
  }
  __syncthreads();
  write_out<DP, BQ, BK>(sO, sM, sL, a, bh, q0);
}

template <int DP, int BQ, int BK>
cudaError_t launch_fwd(const Operands& a, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<DP, BQ, BK>();
  static_assert(smem <= kSmemPerBlock, "shared memory per block");
  auto kern = flash_fwd_kernel<DP, BQ, BK>;
  // once per instantiation (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  kern<<<dim3((a.N + BQ - 1) / BQ, a.B * a.H), kThreads, smem, stream>>>(a);
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

// f(HeadDim<DP, BQ>) at D's padded head dim DP and the q tile BQ of every
// kernel there: 48/80/160/512 serve configs/v1.yaml (d = 40, 80, 160 and the
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

// The models' forward: key tiles of 64, 32 at a padded head dim of 160 or more.
extern "C" int pbe_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int N, int H, int D, const long long* st,
                                  float scale, void* stream) {
  Operands a;
  cudaError_t err = operands(&a, q, k, v, o, lse, B, N, H, D, st, scale);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_head_dim(D, [&](auto hd) {
    using HD = decltype(hd);
    return launch_fwd<HD::DP, HD::BQ, (HD::DP >= 160 ? 32 : 64)>(a, s);
  });
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
