// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax state:
// the models' kernels.
//
// pbe_flash_fwd_bf16 replaces two Pallas forward kernels of
// pbe_tpu/ops/flash_attention.py: flash_fwd_kernel for
// _flash_kernel_rowblock (K1, :85; UNet self-attention, (B*8, N, d) =
// (16, 4096, 40), (16, 1024, 80), (16, 256, 160), (16, 64, 160)) and
// flash_fwd_wide_kernel for _flash_kernel, the streamed variant (K2, :218;
// VAE mid-block attention, (1, 4096, 512)). The resident and pipelined
// variants (K3, K4) are csrc/flash_variants.cu's. Same contracts for all:
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
// 210 / 222, no spills; flash_fwd_wide_kernel 146, no spills (chip_smoke.py
// phase 1 prints this report and the build time).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr size_t kSmemPerBlock = 232448;  // bytes of shared memory a block can use

// --- flash_fwd_kernel and flash_fwd_wide_kernel: mma.sync, state in registers
// (cp.async, ldmatrix, mma_bf16, pack_bf16, cp_async_rows, pv_product,
// Operands, load_rows, softmax_step and store_rows are csrc/mma_sm90.cuh's,
// shared with the resident and pipelined kernels and the backward)

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
