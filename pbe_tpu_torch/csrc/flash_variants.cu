// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax state:
// the resident and pipelined variants.
//
// Replaces two Pallas forward kernels of pbe_tpu/ops/flash_attention.py:
//   pbe_flash_resident_bf16   _flash_kernel_resident (K3, :182);
//   pbe_flash_pipelined_bf16  _flash_kernel_pipelined (K4, :111).
// Only a named variant of ops/flash_attention.py flash_forward reaches them
// (the attention microbenchmark, scripts/bench_attention.py); the JAX
// package's `auto` picks neither at any shape, and neither the edit nor the
// training step launches them. They keep the contracts of the models'
// kernels (csrc/flash_fwd.cu): q prescaled by d^-1/2 * log2(e) in fp32 and
// rounded to bf16, P rounded to bf16 before the PV product, O divided by l,
// the optional fp32 log2-domain LSE (B*H, N), (B, N, H, D) inputs with
// strides, head dims padded to 16 in shared memory only. Both are built on
// the models' kernel's mma.sync.m16n8k16 register layouts and share its
// code (csrc/mma_sm90.cuh: softmax_step, pv_product, store_rows): a warp
// owns 16 query rows; S, P, m, l and O stay in registers; P is the A
// operand of the PV product.
//
// flash_pipelined_kernel (K4). The TPU kernel cuts the key axis into chunks
// of block_c so that its matrix and vector units overlap across chunks; pass
// 1 takes the final row max, pass 2 sums P = exp2(S - m_final) and P V, so
// nothing is ever rescaled. Here one block of 8 warps (16 at d <= 48; 16
// query rows a warp) walks 2 x chunks steps: step i < chunks is pass 1 over chunk i (its K tile
// only), step i >= chunks is pass 2 over chunk i - chunks (K and V). Tiles
// arrive by cp.async into a ring of 2 stages, the next step's copy in
// flight while this one is computed, one __syncthreads a step. Pass 1 forms
// S in registers and keeps this thread's share of the row max in two
// registers (taken over the quad once, when pass 1 ends): no exp2 and no
// shared memory. Pass 2 recomputes S, forms P in registers and feeds it to
// the PV product; l is summed in registers and O is never rescaled. A chunk
// is computed in register tiles of at most 64 keys, which is exact here
// (no running max), so block_c 128 costs no more registers than 64. Many
// warps an SM let one warp's exp2 run beside another's mma.sync, as Mosaic
// staggers chunks on the TPU: at d = 48 the kernel takes 142 registers at
// block_c 64 and 128, so 8-warp blocks ran one to an SM, and 16-warp blocks
// (128 registers) ran ds1 in 0.41 / 0.37 ms instead of 0.68 / 0.58 (H100,
// scripts/sweep_flash_tiles.py --variants).
// At d = 512 (flash_pipelined_wide_kernel) 16 rows x 512 fp32 do not fit a
// warp's registers, so the head dim is split as flash_fwd_wide_kernel
// splits it: 8 warps, 2 row groups of 16 rows x 4 column slices of 128. In
// pass 1 warp (rg, c) scores its row group against keys [c*bc/4,
// (c+1)*bc/4) of the chunk over all 512 columns and keeps the max in
// registers; the 4 slices' maxima meet once, through shared memory, when
// pass 1 ends. In pass 2 each slice warp needs P over the whole chunk, so
// the 4 warps' S tiles meet in shared memory (fp32, one barrier a chunk) and
// each warp forms P from the whole chunk in registers: the 4 slice warps
// repeat the same exact arithmetic, so they agree on P and l, and the
// alternative (each warp recomputing the 512-deep S of the whole chunk)
// would take 4x the QK^T products. block_c 64 leaves room for one stage of
// K and V beside Q and S, so that chunk is copied while no warp computes.
// Bound: the function's 4*BH*N^2*d FLOP, or its exp2 or bytes; the kernel
// does 6*BH*N^2*DP tensor-core FLOP (the second QK^T) and reads K twice.
//
// flash_resident_kernel (K3). On the TPU, "resident" fetches a head's K
// and V into VMEM once and runs the online softmax over block_k slices for
// every q tile. On this card a head's K and V already sit in the 50 MB L2 at
// every bench shape; what each q tile re-reads is L2 -> SM traffic and load
// instructions. So a thread-block cluster of C blocks (1, 2 or 4, along
// the q-tile axis of one head) shares each key tile: block r of the cluster
// copies rows r, r+C, ... of the tile's K and V, one bulk copy a row
// (cp.async.bulk ... multicast::cluster), into the same offset of all C
// blocks' shared memory, so each tile leaves global memory once per cluster
// instead of once per q tile. A row at a time keeps the row pitch of DP+8
// that makes ldmatrix conflict-free. Each block holds a ring of 3 stages (2
// at d = 512), so a cluster's blocks may drift a tile apart;
// a stage's "full" mbarrier expects the tile's bytes, its "empty" mbarrier
// counts the C x 4 consumer warps of the cluster that have released it
// (remote arrives through mapa), and a block refills a stage in its peers
// only once its own empty barrier has them all. One producer warp a block
// waits and copies; 4 consumer warps (64 query rows) run the models'
// kernel's online softmax (m, l, O in registers, rescaled by exp2(m_old -
// m_new)) over block_k key tiles. Bulk copies do not zero-fill, so the ring
// is zeroed once before the first copy: the pad columns d..DP stay zero,
// and V rows past N hold zeros or an earlier tile's finite values, which
// P = 0 cancels. Every block of a cluster takes part in every tile's copies
// and barriers, also one whose q tile lies wholly past N, and a cluster
// sync at the end keeps every block alive until no peer can still copy into
// it or arrive on its barriers. At d = 512 (flash_resident_wide_kernel) the
// consumers are 8 warps split as above, their S tiles meeting in shared
// memory (double-buffered, one named barrier a tile), and block_k is 32.
// Nothing of a head's K and V is held beyond the ring, so every shape
// fits; ops/flash_attention.py picks C from the head's q-tile count.
// Bound: the function's FLOP, exp2 or bytes, as the models' kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr size_t kSmemPerBlock = 232448;  // bytes of shared memory a block can use

// --- register tiles of one warp (16 query rows): S = Q K^T and the row
// statistics, in the C layout (s[nt][0..1] row g, s[nt][2..3] row g+8 of
// n8 tile nt; thread (g, t) = (lane/4, lane%4) holds keys 8nt + 2t, +1)

// the warp's Q rows (pitch LD) as A fragments of KS k16 steps
template <int KS, int LD>
__device__ __forceinline__ void load_q(uint32_t (&qf)[KS][4], const bf16* sQw) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], sQw + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
}

// S over NT*8 keys from row 0 of sK: lanes 0-7 / 8-15 give keys 0-7 of an
// n8 pair at head-dim columns +0 / +8, lanes 16-31 keys 8-15
template <int KS, int NT, int LD>
__device__ __forceinline__ void qk_scores(float (&s)[NT][4], const uint32_t (&qf)[KS][4],
                                          const bf16* sK) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  const bf16* krow = sK + ((lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldsm_x4(b, krow + nt * 8 * LD + kk * 16);
      mma_bf16(s[nt], qf[kk], b[0], b[1]);
      mma_bf16(s[nt + 1], qf[kk], b[2], b[3]);
    }
}

// pass 2 of the pipelined kernel: P = exp2(S - m) against the final row max
// (masked keys give 0), this thread's share of rowsum(P) added to l (summed
// over the quad by store_rows), P as bf16 A fragments, one per k16 step
template <int NT>
__device__ __forceinline__ void final_max_step(const float (&s)[NT][4], uint32_t (&p)[NT / 2][4],
                                               const float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float p0 = exp2f(s[nt][0] - m[0]), p1 = exp2f(s[nt][1] - m[0]);
    const float p2 = exp2f(s[nt][2] - m[1]), p3 = exp2f(s[nt][3] - m[1]);
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    p[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
    p[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
}

// --- the d = 512 split: 8 warps, warp w in row group w / 4 (16 of the 32
// query rows) and slice w % 4 (head-dim columns [128c, 128c+128) of O)

constexpr int kWideLD = 512 + 8;  // bf16 row pitch of Q, K and V at d = 512

// this warp's 16 x 8NW tile of S over all 512 columns: row group rg's Q rows
// and keys [key0, key0 + 8NW) of sK, both through ldmatrix; two independent
// accumulators a tile (shorter dependent chains), summed at the end
template <int NW>
__device__ __forceinline__ void wide_scores(float (&s)[NW][4], const bf16* sQ, const bf16* sK,
                                            int rg, int key0) {
  const int lane = threadIdx.x % 32;
  const bf16* qrow = sQ + (rg * 16 + lane % 16) * kWideLD + (lane / 16) * 8;
  // K rows of the tile at head-dim columns +0, +8, +16, +24 (b0, b1 of two
  // k16 steps)
  const bf16* krow = sK + (key0 + lane % 8) * kWideLD + (lane / 8) * 8;
  float acc[NW][2][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[w][0][e] = acc[w][1][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 32; kk += 2) {
    uint32_t qa[4], qb[4];
    ldsm_x4(qa, qrow + kk * 16);
    ldsm_x4(qb, qrow + kk * 16 + 16);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      uint32_t b[4];
      ldsm_x4(b, krow + w * 8 * kWideLD + kk * 16);
      mma_bf16(acc[w][0], qa, b[0], b[1]);
      mma_bf16(acc[w][1], qb, b[2], b[3]);
    }
  }
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[w][e] = acc[w][0][e] + acc[w][1][e];
}

// this warp's S tile (keys [key0, key0 + 8NW)) into row group rg's rows of
// the fp32 tile sS (pitch LDS); then, after a barrier, the whole row
// group's S is read back by exchange_read
template <int NW, int LDS>
__device__ __forceinline__ void exchange_write(float* sS, const float (&s)[NW][4], int rg,
                                               int key0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    float* row = sS + (rg * 16 + g) * LDS + key0 + w * 8 + 2 * t;
    *reinterpret_cast<float2*>(row) = make_float2(s[w][0], s[w][1]);
    *reinterpret_cast<float2*>(row + 8 * LDS) = make_float2(s[w][2], s[w][3]);
  }
}

template <int NT, int LDS>
__device__ __forceinline__ void exchange_read(float (&s)[NT][4], const float* sS, int rg) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float* r = sS + (rg * 16 + g) * LDS + nt * 8 + 2 * t;
    const float2 x = *reinterpret_cast<const float2*>(r);
    const float2 y = *reinterpret_cast<const float2*>(r + 8 * LDS);
    s[nt][0] = x.x;
    s[nt][1] = x.y;
    s[nt][2] = y.x;
    s[nt][3] = y.y;
  }
}

// --- flash_pipelined_kernel (d <= 160)

// the largest padded head dim at which flash_pipelined_kernel runs 16 warps
// a block (8 above it); scripts/sweep_flash_tiles.py --variants times both
constexpr int kPipelined16WarpsDP = 48;

// the key chunks instantiated at each padded head dim; ops/flash_attention.py
// PIPELINED_BLOCKS lists the same
constexpr bool pipelined_instantiated(int dp, int bc) { return dp <= 160 || bc <= 64; }

template <int DP, int BC>
struct PipeTile {
  static constexpr int WARPS = DP <= kPipelined16WarpsDP ? 16 : 8;
  static constexpr int THREADS = 32 * WARPS, BQ = 16 * WARPS;
  static constexpr int LD = DP + 8;                // bf16 row pitch: conflict-free ldmatrix
  static constexpr int KS = DP / 16;               // k16 steps of Q K^T
  static constexpr int NO = DP / 8;                // n8 tiles of O (those past d are skipped)
  static constexpr int SUB = BC < 64 ? BC : 64;    // keys of a register tile of S
  static constexpr int NT = SUB / 8;
  static constexpr int TE = BC * LD;               // elements of one K or V chunk
  static constexpr size_t OFF_KV = align128(size_t(BQ) * LD * 2);
  static constexpr size_t SMEM = OFF_KV + 4 * size_t(TE) * 2;  // K, V of 2 stages
  static_assert(DP % 16 == 0 && BC % 32 == 0 && NO % 2 == 0, "tile shape");
  static_assert(SMEM <= kSmemPerBlock, "shared memory per block");
};

template <int DP, int BC>
__global__ void __launch_bounds__(PipeTile<DP, BC>::THREADS, 1)
    flash_pipelined_kernel(const Operands a) {
  using T = PipeTile<DP, BC>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = reinterpret_cast<bf16*>(smem + T::OFF_KV);  // K0, V0, K1, V1
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N, d = a.D;
  const int warp = threadIdx.x / 32;
  const bf16* kb = head(a, 1, bh);
  const bf16* vb = head(a, 2, bh);
  const int chunks = (n + BC - 1) / BC, steps = 2 * chunks;

  // step i's chunk into stage i % 2: K, and in pass 2 V
  auto issue = [&](int i) {
    bf16* stage = sKV + (i & 1) * 2 * T::TE;
    const int k0 = (i % chunks) * BC;
    cp_async_rows<DP, T::LD, BC, T::THREADS>(stage, kb, a.st[4], k0, n, d);
    if (i >= chunks) cp_async_rows<DP, T::LD, BC, T::THREADS>(stage + T::TE, vb, a.st[7], k0, n, d);
    cp_async_commit();
  };
  issue(0);
  load_rows<DP, T::LD, T::THREADS>(sQ, head(a, 0, bh), a.st[1], q0, T::BQ, n, d, a.scale);
  __syncthreads();
  bf16* sQw = sQ + warp * 16 * T::LD;  // this warp's rows
  uint32_t qf[T::KS][4];
  load_q<T::KS, T::LD>(qf, sQw);

  float o[T::NO][4];
#pragma unroll
  for (int j = 0; j < T::NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int i = 0; i < steps; ++i) {
    cp_async_wait_all();
    // step i's chunk is visible to every thread, and every warp is done
    // with step i-1's stage, which the next copy overwrites
    __syncthreads();
    if (i + 1 < steps) issue(i + 1);
    const bf16* sK = sKV + (i & 1) * 2 * T::TE;
    const int kv = n - (i % chunks) * BC;  // keys of the chunk before N (may exceed BC)
    if (i == chunks) quad_max(m);          // pass 1 is done: m is the final row max
#pragma unroll
    for (int k0 = 0; k0 < BC; k0 += T::SUB) {
      if (k0 >= kv) break;
      float s[T::NT][4];
      qk_scores<T::KS, T::NT, T::LD>(s, qf, sK + k0 * T::LD);
      mask_keys<T::NT>(s, kv - k0);
      if (i < chunks) {
        row_max<T::NT>(s, m);
      } else {
        uint32_t p[T::NT / 2][4];
        final_max_step<T::NT>(s, p, m, l);
        pv_product<T::NT / 2, T::NO, T::LD>(o, p, sK + T::TE + k0 * T::LD, 0, d);
      }
    }
  }
  // only this warp read its rows of sQ, so they take its output
  store_rows<T::NO, T::LD>(o, m, l, sQw, a, bh, q0 + warp * 16, 0, true);
}

// --- flash_pipelined_wide_kernel (d = 512)

template <int BC>
struct PipeWideTile {
  static constexpr int DP = 512, BQ = 32, WARPS = 8, THREADS = 32 * WARPS;
  static constexpr int LD = kWideLD, LDS = BC + 8;  // fp32 row pitch of S: conflict-free float2
  static constexpr int SLICE = DP / 4, NO = SLICE / 8;
  static constexpr int NW = BC / 32;  // n8 tiles of S a warp: keys [c*BC/4, (c+1)*BC/4)
  // K and V chunks of 64 rows fit once beside Q and S: one stage
  static constexpr int STAGES = BC == 32 ? 2 : 1;
  static constexpr int TE = BC * LD;
  static constexpr size_t OFF_S = align128(size_t(BQ) * LD * 2);
  static constexpr size_t OFF_M = align128(OFF_S + size_t(BQ) * LDS * 4);
  static constexpr size_t OFF_KV = align128(OFF_M + size_t(BQ) * 4 * 4);
  static constexpr size_t SMEM = OFF_KV + STAGES * 2 * size_t(TE) * 2;
  static_assert(SMEM <= kSmemPerBlock, "shared memory per block");
};

template <int BC>
__global__ void __launch_bounds__(PipeWideTile<BC>::THREADS, 1)
    flash_pipelined_wide_kernel(const Operands a) {
  using T = PipeWideTile<BC>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  float* sS = reinterpret_cast<float*>(smem + T::OFF_S);
  float* sM = reinterpret_cast<float*>(smem + T::OFF_M);  // (32 rows, 4 slices)
  bf16* sKV = reinterpret_cast<bf16*>(smem + T::OFF_KV);
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N, d = a.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg = warp / 4, slice = warp % 4, key0 = slice * (BC / 4);
  const bf16* kb = head(a, 1, bh);
  const bf16* vb = head(a, 2, bh);
  const int chunks = (n + BC - 1) / BC, steps = 2 * chunks;

  auto issue = [&](int i) {
    bf16* stage = sKV + (i % T::STAGES) * 2 * T::TE;
    const int k0 = (i % chunks) * BC;
    cp_async_rows<T::DP, T::LD, BC, T::THREADS>(stage, kb, a.st[4], k0, n, d);
    if (i >= chunks)
      cp_async_rows<T::DP, T::LD, BC, T::THREADS>(stage + T::TE, vb, a.st[7], k0, n, d);
    cp_async_commit();
  };
  issue(0);
  load_rows<T::DP, T::LD, T::THREADS>(sQ, head(a, 0, bh), a.st[1], q0, T::BQ, n, d, a.scale);

  float o[T::NO][4];
#pragma unroll
  for (int j = 0; j < T::NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int i = 0; i < steps; ++i) {
    cp_async_wait_all();
    // step i's chunk (and at i = 0 the Q tile) is visible to every thread;
    // every warp is done with step i-1's stage and with sS
    __syncthreads();
    if (T::STAGES > 1 && i + 1 < steps) issue(i + 1);
    const bf16* sK = sKV + (i % T::STAGES) * 2 * T::TE;
    const int kv = n - (i % chunks) * BC;
    if (i == chunks) {
      // pass 1 is done: the final row max over the row group's 4 slices
      quad_max(m);
      if (t == 0) {
        sM[(rg * 16 + g) * 4 + slice] = m[0];
        sM[(rg * 16 + g + 8) * 4 + slice] = m[1];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* x = sM + (rg * 16 + g + 8 * r) * 4;
        m[r] = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
      }
    }
    float part[T::NW][4];
    wide_scores<T::NW>(part, sQ, sK, rg, key0);
    if (i < chunks) {
      mask_keys<T::NW>(part, kv - key0);
      row_max<T::NW>(part, m);
    } else {
      exchange_write<T::NW, T::LDS>(sS, part, rg, key0);
      __syncthreads();  // the row group's S over the whole chunk is in sS
      float s[BC / 8][4];
      exchange_read<BC / 8, T::LDS>(s, sS, rg);
      mask_keys<BC / 8>(s, kv);
      uint32_t p[BC / 16][4];
      final_max_step<BC / 8>(s, p, m, l);
      pv_product<BC / 16, T::NO, T::LD>(o, p, sK + T::TE, slice * T::SLICE, d);
    }
    if (T::STAGES == 1 && i + 1 < steps) {
      __syncthreads();  // every warp is done with the one stage
      issue(i + 1);
    }
  }
  // sQ is dead since the last chunk's barrier: each warp stages its 16 x 128
  // block of O in its own rows and columns of it
  store_rows<T::NO, T::LD>(o, m, l, sQ + rg * 16 * T::LD + slice * T::SLICE, a, bh,
                           q0 + rg * 16, slice * T::SLICE, slice == 0);
}

template <int DP, int BC>
cudaError_t launch_pipelined(const Operands& a, cudaStream_t stream) {
  using T = std::conditional_t<DP == 512, PipeWideTile<BC>, PipeTile<DP, BC>>;
  void (*kern)(const Operands);
  if constexpr (DP == 512)
    kern = flash_pipelined_wide_kernel<BC>;
  else
    kern = flash_pipelined_kernel<DP, BC>;
  // once per instantiation (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return attr;
  kern<<<dim3((a.N + T::BQ - 1) / T::BQ, a.B * a.H), T::THREADS, T::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// --- flash_resident_kernel: key tiles shared by a cluster

// the key blocks instantiated at each padded head dim (past these, S of a
// whole key tile leaves too few registers); ops/flash_attention.py
// RESIDENT_BLOCKS lists the same
constexpr bool resident_instantiated(int dp, int bk) {
  return (bk < 128 || dp <= 80) && (dp < 512 || bk == 32);
}

// consumer warps and ring stages of flash_resident_kernel (d <= 160; at
// d = 512 8 warps and 2 stages, as a third does not fit);
// scripts/sweep_flash_tiles.py --variants times the alternatives
constexpr int kResidentWarps = 4;
constexpr int kResidentStages = 3;

// shared memory of a resident kernel past its working tiles: the ring of
// STAGES stages of K and V tiles of BK rows, pitch LD, then the stages'
// full and empty barriers
template <int BK_, int LD_, int STAGES_>
struct Ring {
  static constexpr int BK = BK_, LD = LD_, STAGES = STAGES_;
  static constexpr int TE = BK * LD;  // elements of one K or V tile
  static constexpr size_t BYTES = STAGES * 2 * size_t(TE) * 2;
  static constexpr size_t SMEM_PAST = BYTES + 2 * STAGES * 8;
};

// Block set-up of a resident kernel: the ring zeroed (bulk copies write only
// columns [0, d) of the rows before N), the barriers initialised (full: one
// arrival, this block's expect_tx; empty: the cluster's consumer warps) and
// the q tile loaded, prescaled; then a cluster sync, after which any block
// may copy into any other's ring and arrive on its barriers.
template <class R, int DP, int BQ, int THREADS, int CONSUMERS>
__device__ __forceinline__ void resident_setup(bf16* sQ, bf16* sKV, uint64_t* bars,
                                               const Operands& a, int bh, int q0) {
  uint4* ring = reinterpret_cast<uint4*>(sKV);
  for (int i = threadIdx.x; i < int(R::BYTES / 16); i += THREADS)
    ring[i] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0)
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&bars[s], 1);
      mbar_init(&bars[R::STAGES + s], cluster_blocks() * CONSUMERS);
    }
  load_rows<DP, R::LD, THREADS>(sQ, head(a, 0, bh), a.st[1], q0, BQ, a.N, a.D, a.scale);
  fence_barrier_init();
  cluster_sync();
}

// The producer warp of a resident kernel: key tiles [0, tiles) of head bh's
// K and V into stage j % STAGES of the ring (K at 2*stage*TE, V at +TE).
// This block (rank r of C) copies rows r, r+C, ... of the tile's K, then of
// its V, one bulk copy a row multicast to all C blocks; each block's full
// barrier expects the whole tile's bytes. A stage is refilled once this
// block's empty barrier has had every consumer warp of the cluster.
template <class R>
__device__ __forceinline__ void resident_produce(bf16* sKV, uint64_t* bars, const Operands& a,
                                                 int bh) {
  const int lane = threadIdx.x % 32, n = a.N;
  const int rank = (int)cluster_rank(), csize = (int)cluster_blocks();
  const uint16_t mask = csize == 1 ? 0 : (uint16_t)((1u << csize) - 1);
  const bf16* kb = head(a, 1, bh);
  const bf16* vb = head(a, 2, bh);
  const uint32_t row_bytes = a.D * 2;  // a multiple of 16: d % 8 == 0
  constexpr int BK = R::BK, LD = R::LD, STAGES = R::STAGES;
  const int tiles = (n + BK - 1) / BK;
  for (int j = 0; j < tiles; ++j) {
    const int s = j % STAGES, rows = min(BK, n - j * BK);
    if (j >= STAGES) mbar_wait(&bars[STAGES + s], (j / STAGES - 1) & 1);
    if (lane == 0) mbar_expect_tx(&bars[s], 2 * rows * row_bytes);
    bf16* stage = sKV + s * 2 * R::TE;
    for (int i = rank + csize * lane; i < 2 * rows; i += 32 * csize) {
      const bool is_v = i >= rows;
      const int r = is_v ? i - rows : i;
      const long long row = j * BK + r;
      bulk_copy(stage + (is_v ? R::TE : 0) + r * LD,
                is_v ? vb + row * a.st[7] : kb + row * a.st[4], row_bytes, &bars[s], mask);
    }
  }
}

// a consumer warp is done with a stage: one arrival on its empty barrier in
// every block of the cluster
__device__ __forceinline__ void release_stage(uint64_t* empty) {
  __syncwarp();
  const uint32_t lane = threadIdx.x % 32;
  if (lane < cluster_blocks()) mbar_arrive_remote(empty, lane);
}

template <int DP, int BK>
struct ResidentTile {
  static constexpr int WARPS = kResidentWarps, BQ = 16 * WARPS;  // consumer warps, q tile
  static constexpr int THREADS = 32 * (WARPS + 1);   // and one producer warp
  static constexpr int LD = DP + 8, KS = DP / 16, NT = BK / 8, NO = DP / 8;
  using R = Ring<BK, LD, kResidentStages>;
  static constexpr size_t OFF_KV = align128(size_t(BQ) * LD * 2);
  static constexpr size_t OFF_BAR = OFF_KV + R::BYTES;
  static constexpr size_t SMEM = OFF_KV + R::SMEM_PAST;
  static_assert(DP % 16 == 0 && BK % 16 == 0 && NO % 2 == 0, "tile shape");
  static_assert(SMEM <= kSmemPerBlock, "shared memory per block");
};

template <int DP, int BK>
__global__ void __launch_bounds__(ResidentTile<DP, BK>::THREADS, 1)
    flash_resident_kernel(const Operands a) {
  using T = ResidentTile<DP, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = reinterpret_cast<bf16*>(smem + T::OFF_KV);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + T::OFF_BAR);  // full[2], empty[2]
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N;
  const int warp = threadIdx.x / 32;
  using R = typename T::R;
  resident_setup<R, DP, T::BQ, T::THREADS, T::WARPS>(sQ, sKV, bars, a, bh, q0);

  if (warp == T::WARPS) {
    resident_produce<R>(sKV, bars, a, bh);
  } else {
    bf16* sQw = sQ + warp * 16 * T::LD;
    uint32_t qf[T::KS][4];
    load_q<T::KS, T::LD>(qf, sQw);
    float o[T::NO][4];
#pragma unroll
    for (int j = 0; j < T::NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const int tiles = (n + BK - 1) / BK;
    for (int j = 0; j < tiles; ++j) {
      const int s = j % R::STAGES;
      mbar_wait(&bars[s], (j / R::STAGES) & 1);
      const bf16* sK = sKV + s * 2 * R::TE;
      float sc[T::NT][4];
      qk_scores<T::KS, T::NT, T::LD>(sc, qf, sK);
      uint32_t p[T::NT / 2][4];
      softmax_step<T::NT, T::NO>(sc, p, o, m, l, n - j * BK);
      pv_product<T::NT / 2, T::NO, T::LD>(o, p, sK + R::TE, 0, a.D);
      release_stage(&bars[R::STAGES + s]);
    }
    store_rows<T::NO, T::LD>(o, m, l, sQw, a, bh, q0 + warp * 16, 0, true);
  }
  cluster_sync();  // no block leaves while a peer may still copy into it
}

// flash_resident_wide_kernel's tiles at d = 512: 8 consumer warps split as
// above and one producer warp, a q tile of 32 rows, key tiles of 32, S
// double-buffered
struct ResidentWideTile {
  static constexpr int DP = 512, BQ = 32, BK = 32, WARPS = 8;
  static constexpr int THREADS = 32 * (WARPS + 1);
  static constexpr int LD = kWideLD, LDS = BK + 8, SLICE = DP / 4, NO = SLICE / 8;
  using R = Ring<BK, LD, 2>;
  static constexpr size_t OFF_S = align128(size_t(BQ) * LD * 2);
  static constexpr size_t OFF_KV = align128(OFF_S + 2 * size_t(BQ) * LDS * 4);
  static constexpr size_t OFF_BAR = OFF_KV + R::BYTES;
  static constexpr size_t SMEM = OFF_KV + R::SMEM_PAST;
  static_assert(SMEM <= kSmemPerBlock, "shared memory per block");
};

__global__ void __launch_bounds__(ResidentWideTile::THREADS, 1)
    flash_resident_wide_kernel(const Operands a) {
  using T = ResidentWideTile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  float* sS = reinterpret_cast<float*>(smem + T::OFF_S);
  bf16* sKV = reinterpret_cast<bf16*>(smem + T::OFF_KV);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + T::OFF_BAR);
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N;
  const int warp = threadIdx.x / 32;
  using R = T::R;
  resident_setup<R, T::DP, T::BQ, T::THREADS, T::WARPS>(sQ, sKV, bars, a, bh, q0);

  if (warp == T::WARPS) {
    resident_produce<R>(sKV, bars, a, bh);
  } else {
    const int rg = warp / 4, slice = warp % 4;
    float o[T::NO][4];
#pragma unroll
    for (int j = 0; j < T::NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const int tiles = (n + T::BK - 1) / T::BK;
    for (int j = 0; j < tiles; ++j) {
      const int s = j % R::STAGES;
      mbar_wait(&bars[s], (j / R::STAGES) & 1);
      const bf16* sK = sKV + s * 2 * R::TE;
      float part[1][4];
      wide_scores<1>(part, sQ, sK, rg, slice * 8);
      float* sSj = sS + (j & 1) * T::BQ * T::LDS;
      exchange_write<1, T::LDS>(sSj, part, rg, slice * 8);
      // the consumer warps' barrier: the row group's 16x32 S is whole
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * T::WARPS) : "memory");
      float sc[T::BK / 8][4];
      exchange_read<T::BK / 8, T::LDS>(sc, sSj, rg);
      uint32_t p[T::BK / 16][4];
      softmax_step<T::BK / 8, T::NO>(sc, p, o, m, l, n - j * T::BK);
      pv_product<T::BK / 16, T::NO, T::LD>(o, p, sK + R::TE, slice * T::SLICE, a.D);
      release_stage(&bars[R::STAGES + s]);
    }
    // no warp reads sQ past the last tile's barrier
    store_rows<T::NO, T::LD>(o, m, l, sQ + rg * 16 * T::LD + slice * T::SLICE, a, bh,
                             q0 + rg * 16, slice * T::SLICE, slice == 0);
  }
  cluster_sync();
}

template <int DP, int BK>
cudaError_t launch_resident(const Operands& a, int cluster, cudaStream_t stream) {
  using T = std::conditional_t<DP == 512, ResidentWideTile, ResidentTile<DP, BK>>;
  void (*kern)(const Operands);
  if constexpr (DP == 512)
    kern = flash_resident_wide_kernel;
  else
    kern = flash_resident_kernel<DP, BK>;
  // once per instantiation (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return attr;
  const int q_tiles = (a.N + T::BQ - 1) / T::BQ;
  cudaLaunchAttribute dims[1];
  dims[0].id = cudaLaunchAttributeClusterDimension;
  dims[0].val.clusterDim.x = cluster;
  dims[0].val.clusterDim.y = 1;
  dims[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  // C neighbouring q tiles of one head a cluster; the last cluster's blocks
  // past N take part in its copies
  cfg.gridDim = dim3((q_tiles + cluster - 1) / cluster * cluster, a.B * a.H);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cfg.attrs = dims;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// f(DP, BLOCK) as std::integral_constants at D's padded head dim (16/32
// serve configs/tiny.yaml, 48/80/160/512 configs/v1.yaml; ops/flash_attention.py
// SUPPORTED_HEAD_DIMS lists the same) and a key block of 32, 64 or 128
template <class F>
cudaError_t by_tiles(int D, int block, F f) {
  auto with_block = [&](auto dp) -> cudaError_t {
    switch (block) {
      case 32:  return f(dp, std::integral_constant<int, 32>{});
      case 64:  return f(dp, std::integral_constant<int, 64>{});
      case 128: return f(dp, std::integral_constant<int, 128>{});
      default:  return cudaErrorInvalidValue;
    }
  };
  switch ((D + 15) / 16 * 16) {
    case 16:  return with_block(std::integral_constant<int, 16>{});
    case 32:  return with_block(std::integral_constant<int, 32>{});
    case 48:  return with_block(std::integral_constant<int, 48>{});
    case 80:  return with_block(std::integral_constant<int, 80>{});
    case 160: return with_block(std::integral_constant<int, 160>{});
    case 512: return with_block(std::integral_constant<int, 512>{});
    default:  return cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entries: q, k, v bf16 (B, N, H, D), each with element strides (batch,
// seq, head) in `st` (q, k, v in that order) and a unit head-dim stride; o
// bf16 (B, N, H, D) contiguous; lse fp32 (B*H, N) or null; scale the q
// prescale d^-1/2 * log2(e). Launch on `stream`; return the cudaError_t of
// the launch.

// K3: block_k the key block (resident_instantiated); cluster the blocks of a
// cluster (1, 2 or 4), each on its own q tile of the same head.
extern "C" int pbe_flash_resident_bf16(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int N, int H, int D,
                                       const long long* st, float scale, int block_k,
                                       int cluster, void* stream) {
  Operands a;
  cudaError_t err = operands(&a, q, k, v, o, lse, B, N, H, D, st, scale);
  if (err != cudaSuccess) return (int)err;
  if (cluster != 1 && cluster != 2 && cluster != 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_tiles(D, block_k, [&](auto dp, auto bk) -> cudaError_t {
    constexpr int DP = decltype(dp)::value, BK = decltype(bk)::value;
    if constexpr (resident_instantiated(DP, BK)) return launch_resident<DP, BK>(a, cluster, s);
    return cudaErrorInvalidValue;
  });
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
  return (int)by_tiles(D, block_c, [&](auto dp, auto bc) -> cudaError_t {
    constexpr int DP = decltype(dp)::value, BC = decltype(bc)::value;
    if constexpr (pipelined_instantiated(DP, BC)) return launch_pipelined<DP, BC>(a, s);
    return cudaErrorInvalidValue;
  });
}
