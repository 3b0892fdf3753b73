// Flash-attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel, bf16 in and out, fp32 inside.
//
// Replaces the Pallas backward kernels of pbe_tpu/ops/flash_attention.py,
// _flash_bwd_dq_kernel (K5, :408) and _flash_bwd_dkv_kernel (K6, :445),
// which _flash_bwd_bhnd launches (:512, :531) from the flash_attention
// custom VJP. The v1 training step reaches them at the UNet self-attention
// shapes (B*8, N, d) = (32, 4096, 40), (32, 1024, 80), (32, 256, 160) and
// (32, 64, 160) at batch 4; first-stage training (training/vae_train.py) at
// the VAE's single-head mid attention, (4, 1024, 512) at 256^2 and batch 4.
// Same contracts as the forward (csrc/flash_fwd.cu) and the Pallas kernels:
//   q2 = round_bf16(q * d^-1/2 * log2(e))     the forward's own prescale, so
//   P  = exp2(q2 K^T - L2)                    P is the forward's P (L2: its
//                                             log2-domain LSE, (B*H, N) fp32)
//   dS = P * (dO V^T - D) * d^-1/2            D = rowsum(dO * O), fp32, given
//   dQ = round(sum_k round_bf16(dS) K)                                  (dQ)
//   dV = round(sum_q round_bf16(P)^T dO),  dK = round(sum_q round_bf16(dS)^T Q)
// with Q unscaled in dK.
//
// Design: FlashAttention-2's backward on mma.sync.m16n8k16 (bf16 in, fp32
// out) with the forward kernel's register layouts (csrc/mma_sm90.cuh).
// Blocks run in no order, so the TPU's sequential grid axis becomes a loop
// inside the block, and every output tile has one owner: nothing is summed
// across blocks, there are no atomics, and a repeated launch gives the same
// bits. Both kernels keep S, dP, P, dS and their accumulators in registers:
//   * flash_bwd_dq_kernel: a block of WARPS warps takes 16*WARPS query rows
//     of one head, each warp 16 whole rows (no column split), and loops
//     over key tiles of BK. The warp's prescaled q2 and dO fragments are
//     taken by ldmatrix (held in registers where HOLD, else read again each
//     tile), and its rows' L2 and D sit in 4 registers a thread. Per tile:
//     S = q2 K^T and dP = dO V^T in registers (K and V read as the forward
//     reads K); P = exp2(S - L2) and dS = P (dP - D) d^-1/2 in-thread, with
//     no running max and no rescale; dS is rounded to bf16 and packed
//     straight into A fragments (the C layout of two n8 tiles is the A
//     layout of one k16 step); dQ += dS K with K through ldmatrix.trans, as
//     the forward reads V. The dQ accumulator skips n8 tiles past d (5 at
//     d = 40, not 6).
//   * flash_bwd_dkv_kernel: a block takes 16*WARPS/SPLIT key rows, each
//     warp 16 whole rows and 1/SPLIT of the head dim of dK and dV, and
//     loops over q tiles of BQ. K and V fragments (held where HOLD, else
//     read again from the block's K and V tiles) and the dK and dV
//     accumulators stay put across the loop. Per tile: S^T = K q2^T and
//     dP^T = V dO^T in registers; P^T = exp2(S^T - L2[q]) and dS^T =
//     P^T (dP^T - D[q]) d^-1/2, where L2 and D are indexed by column, so
//     thread t reads columns 2t, 2t+1 of each n8 tile from shared memory;
//     P^T and dS^T packed as A fragments; dV += P^T dO and dK += dS^T Q with
//     dO and the unscaled Q through ldmatrix.trans. The prescale: S^T must
//     use the forward's bf16-rounded q2, or P would not be the forward's P
//     (at peaked scores one rounding of q moves S visibly), so a stage
//     holds Q as it came and q2 made from it: after its cp.async copies
//     have landed, each thread rounds q * d^-1/2 log2(e) to bf16 for the
//     very 16-byte chunks it copied, before the tile's one barrier, so the
//     prescale costs no barrier of its own.
//   * Tiles arrive by zero-filling 16-byte cp.async (and 4-byte ones for L2
//     and D) into a ring of 2 stages: the copy of tile j+1 is in flight
//     while tile j is computed, one __syncthreads a tile, as in the
//     forward. The bf16 row pitch of DP+8 keeps every ldmatrix free of bank
//     conflicts. Only the last tile masks: keys (dQ) or queries (dK/dV)
//     past N get P = 0 and so dS = 0, and rows past N are never stored.
//   * Epilogues stage the bf16 result over shared-memory rows only the warp
//     reads (its q2 rows; its K and V rows) and write 16-byte rows.
// Inputs are (B, N, H, D) with explicit strides: no transpose copy.
//
// At d = 512 (flash_bwd_dq_wide_kernel and flash_bwd_dkv_wide_kernel: K5
// and K6 at the VAE's head dim) the products run on wgmma, sm_90a's
// warpgroup product, with operands in shared memory in the 128-byte swizzle
// that the TMA tensor copies write (mma_sm90.cuh). wgmma takes 64 rows a
// warpgroup, and 64 rows of fp32 accumulator at d = 512 are 128 KB for dQ
// and 256 KB for dK and dV together, the register file of an SM. So the
// head dim is split across a cluster of two blocks (recomputing the scores
// per column half instead would cost 1.5x the products): block r of a pair
// owns columns [256 r, 256 r + 256) of every operand and output for 64
// rows (queries for dQ, keys for dK/dV), computes the scores' partials over
// its half, and the pair adds its partials, exchanged through distributed
// shared memory. 384 threads: a producer warpgroup (one thread issues every
// tensor copy, its other 3 warps make dK/dV's q2; setmaxnreg 40) and two
// consumer warpgroups (232 registers). Role 0 computes S (dK/dV: S^T), role
// 1 dP (dP^T), each a 64 x 32 fp32 partial of 16 m64n32k16 steps, and
// writes it to a slot that the other role reads and that 4 bulk copies (2
// KB a warp) carry into the partner block, completing a barrier there by
// their bytes.
// Both roles then add the pair's partials (this block's first, in both
// blocks alike: the pair agrees bit for bit), make P and dS in registers
// and run their product with A from registers (the C layout of two n8
// tiles is the A layout of a k16 step, as with mma.sync) and B the streamed
// tile MN-major (a transposed descriptor: one swizzled tile is the K-major
// B of the scores and the MN-major B of the product):
//   dQ:    role r' adds dS K into 128 of the block's 256 columns
//          (m64n128k16); q2 (made from q as it is loaded) and dO sit in
//          registers (64 a thread), so the scores read only K and V from
//          shared memory;
//   dK/dV: role 0 dV += P^T dO, role 1 dK += dS^T Q (m64n256k16; with 128
//          accumulators a thread, K and V stay in shared memory).
// Tiles of 32 rows stream through a 3-stage ring (K and V; or Q and dO),
// 32 KB of tensor copies a stage. dK/dV prescales each Q tile in place into
// q2 for S^T (the producer's warps; bit for bit the forward's prescale) and
// copies Q in again, unscaled, for dK once role 0 has read q2: that saves a
// third 16 KB tile a stage. The exchange is pipelined by a tile: iteration
// j pushes tile j's partial and finishes tile j - 1, whose partner partial
// has been in flight since; slots are double-buffered by tile parity, and
// the reader frees them with a relaxed arrival on the writer's barrier (a
// release at cluster scope stalls the warp). Ragged N: the tensor copies
// zero-fill rows past N, P is 0 for keys (dQ) or queries (dK/dV) past N,
// and rows past N are not stored. Shared memory 231,328 B a block, one
// block an SM: a pair of blocks for every 64 rows of each head.

// Tiles: launch_dq<DP, WARPS, BK, HOLD, MINB> and launch_dkv<DP, WARPS, BQ,
// HOLD, SPLIT, MINB> in the entries below; MINB blocks an SM caps ptxas at
// 64K / (32 * WARPS * MINB) registers a thread, so that 16 warps share an
// SM at d = 40 (on an H100 at 700 W the sweep ran ds1 in 1.02 + 1.46 ms
// with 8 warps an SM at 184 and 207 registers, in 0.75 + 1.14 ms with 16
// warps at 128). Chosen with
// scripts/sweep_flash_tiles.py --bwd (the fastest setting without spills at
// each head dim); the grid at the training shapes (batch 4, 8 heads), shared
// memory, and ptxas (nvcc 12.9, sm_90a, -Xptxas -v) registers a thread, all
// without spills:
//   kernel  DP  warps tile HOLD SPLIT MINB  grid ds1/ds2/ds4/ds8  smem B  regs
//   dq      16    4   64   yes   -     1    (tiny config)       18,432   126
//   dq      32    4   64   yes   -     1    (tiny config)       30,720   183
//   dq      48   16   32   yes   -     1    512                 71,680   128
//   dq      80    8   32   no    -     2    256                 67,584   126
//   dq     160    4   64   no    -     1    128 / 32           129,024   238
//   dkv     16    4   64   yes   1     1    (tiny config)       25,600   135
//   dkv     32    4   64   yes   1     1    (tiny config)       41,984   174
//   dkv     48    8   32   yes   1     2    1024                50,688   128
//   dkv     80    8   64   yes   1     1    256                113,664   242
//   dkv    160    4   32   no    2     1    256 / 64            86,528   196
//   dq     512   12   32   regs  2     1    (VAE) 128 / 256    231,328   168
//   dkv    512   12   32   -     2     1    (VAE) 128 / 256    231,328   168
// (tile: key tile BK for dq, q tile BQ for dkv. The wide rows: 4 producer
// and 8 consumer warps, SPLIT the cluster's 2 head-dim halves, HOLD "regs"
// the scores' A operand in registers; their grids in blocks at (4, 1024, 1,
// 512) and (2, 4096, 1, 512); ptxas reports the launch's 168 registers, and
// the consumers run at setmaxnreg's 232.) chip_smoke.py phase 1 prints the
// file's build time and the ptxas report.

// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the dQ kernel
// does 6*BH*N^2*d FLOP, the dK/dV kernel 8*BH*N^2*d, and each BH*N^2 exp2
// at ~3.9 T/s of special-function throughput. At (32, 4096, 40) the
// exponentials bind the dQ kernel (0.138 ms) and the products the dK/dV
// kernel (0.174 ms); at (32, 1024, 80) the products bind both; at the
// short sequences (256 and 64) the bytes bind. The design takes every
// shared-memory round trip of S, dP, P and dS off the loop and overlaps the
// loads with the products, so exp2 and mma.sync issue are what is left;
// the exp2 of each (q, k) pair is still taken in both kernels, which the
// two-kernel, atomic-free split costs. At d = 512 the products bind the
// pair: K5 0.0130 ms and K6 0.0174 at (4, 1024, 1, 512), 0.1042 and 0.1390
// at (2, 4096, 1, 512) (6 and 8 B*H*N^2*d FLOP at 989 TFLOP/s). There the
// wgmma design reads each operand from shared memory once a product (the
// mma.sync kernels it replaced read every A row again for each 16x8 score
// tile), but a tile's iteration is still a chain: the scores, the push of
// the partial (a shared-memory write, a proxy fence, the copies), the
// partner's partial, the element-wise step, the product; the exchange adds
// 112 KB (dQ) or 96 KB (dK/dV) of shared-memory traffic a tile (the slots'
// writes and reads, the copies out and in) beside the operands', and
// dK/dV's scores read K and V again from shared memory each tile. What that leaves
// against the bound is in PERF.md (phase 17's times).

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "mma_sm90.cuh"

namespace {

constexpr size_t kSmemPerBlock = 232448;  // bytes of shared memory a block can use

struct Strides {  // element strides (batch, seq, head) of q, k, v, dO
  long long q[3], k[3], v[3], o[3];
};

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *dd;
  bf16 *out0, *out1;  // dQ; or dK and dV
  int B, N, H, D;
  Strides st;
  float scale_log2, scale;
};

// row 0 of head bh's (N, D) slice of x with strides st
__device__ __forceinline__ const bf16* head_of(const bf16* x, const long long (&st)[3], int bh,
                                               int h) {
  return x + (long long)(bh / h) * st[0] + (long long)(bh % h) * st[2];
}

// 4 bytes from src into shared memory, or 4 zero bytes where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// entries [r0, r0+ROWS) of one head's fp32 row statistic, zero past n
template <int ROWS, int THREADS>
__device__ __forceinline__ void cp_async_stat(float* dst, const float* src, int r0, int n) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    const bool valid = r0 + i < n;
    cp_async4(dst + i, valid ? src + r0 + i : src, valid);
  }
}

// round_bf16(x * scale) for the 8 bf16 in v: the q prescale, bit for bit the
// forward's (load_rows)
__device__ __forceinline__ void scale8(uint4& v, float scale) {
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    h2[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
  }
}

// dst = round_bf16(src * scale) over the 16-byte chunks of a (ROWS x LD)
// tile that this thread copied with cp_async_rows<DP, LD, ROWS, THREADS>:
// once the thread's copies have landed (cp_async_wait_all), they are visible
// to it, so no barrier is needed before this pass. dst may be src.
template <int DP, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void prescale_own(bf16* dst, const bf16* src, float scale) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int off = (i / CH) * LD + (i % CH) * 8;
    uint4 val = *reinterpret_cast<const uint4*>(src + off);
    scale8(val, scale);
    *reinterpret_cast<uint4*>(dst + off) = val;
  }
}

// S += A B^T for one warp over KS k16 steps: A the warp's 16 rows (k16 A
// fragments, from `held` where HOLD, else by ldmatrix from `arow`, its row
// lane%16 at column (lane/16)*8), B an (8*NT x LD) bf16 row-major tile:
// lanes 0-7 / 8-15 give rows 0-7 of an n8 pair at columns +0 / +8 (b0, b1
// of tile nt), lanes 16-31 rows 8-15 (tile nt+1), as the forward reads K
template <int KS, int NT, int LD, bool HOLD>
__device__ __forceinline__ void abt_product(float (&s)[NT][4],
                                            const uint32_t (&held)[HOLD ? KS : 1][4],
                                            const bf16* arow, const bf16* b) {
  const int lane = threadIdx.x % 32;
  const bf16* brow = b + ((lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    if constexpr (HOLD) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = held[kk][i];
    } else {
      ldsm_x4(a, arow + kk * 16);
    }
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, brow + nt * 8 * LD + kk * 16);
      mma_bf16(s[nt], a, bf[0], bf[1]);
      mma_bf16(s[nt + 1], a, bf[2], bf[3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// two n8 tiles of C (fp32) rounded to bf16 as the A fragment of one k16
// step: n8 tiles 2k and 2k+1 are columns 0-7 and 8-15 of step k
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    a[nt / 2][(nt % 2) * 2] = pack_bf16(c[nt][0], c[nt][1]);
    a[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(c[nt][2], c[nt][3]);
  }
}

// The epilogue of one warp: its NO n8 accumulator tiles (rows [row0,
// row0+16), columns [c0, c0 + 8*NO)) as bf16, staged in the (16 x LD) tile
// `stage` that no other warp touches, then written as 16-byte chunks to
// out, (B, N, H, D) contiguous; rows >= n and columns >= d are not written.
template <int NO, int LD>
__device__ __forceinline__ void store_acc(const float (&o)[NO][4], bf16* stage, bf16* out,
                                          const Args& a, int bh, int row0, int c0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n = a.N, h = a.H, d = a.D, b = bh / h, hh = bh % h;
  __syncwarp();  // every lane is done reading the rows it stages over
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (c0 + j * 8 >= d) break;
    *reinterpret_cast<uint32_t*>(stage + g * LD + j * 8 + 2 * t) = pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + j * 8 + 2 * t) =
        pack_bf16(o[j][2], o[j][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * NO; i += 32) {
    const int r = i / NO, c = (i % NO) * 8;
    if (row0 + r < n && c0 + c < d)
      *reinterpret_cast<uint4*>(out + ((long long)(b * n + row0 + r) * h + hh) * d + c0 + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

// --- flash_bwd_dq_kernel (K5) -------------------------------------------------

// WARPS warps of 16 query rows, key tiles of BK, head dim DP (padded);
// shared memory holds q2, dO, then K and V of stages 0 and 1
template <int DP, int WARPS, int BK, bool HOLD>
struct DqTile {
  static constexpr int THREADS = 32 * WARPS, BQ = 16 * WARPS;
  static constexpr int LD = DP + 8;   // bf16 row pitch: conflict-free ldmatrix
  static constexpr int KS = DP / 16;  // k16 steps of S and dP
  static constexpr int NT = BK / 8;   // n8 tiles of S and dP
  static constexpr int NO = DP / 8;   // n8 tiles of dQ (those past d are skipped)
  static constexpr size_t ROWS = align128(size_t(BQ) * LD * 2);  // q2 or dO
  static constexpr size_t TILE = size_t(BK) * LD * 2;            // one K or V tile
  static constexpr size_t SMEM = 2 * ROWS + 4 * TILE;
  static_assert(DP % 16 == 0 && BK % 16 == 0 && NO % 2 == 0, "tile shape");
  static_assert(SMEM <= kSmemPerBlock, "shared memory per block");
};

template <int DP, int WARPS, int BK, bool HOLD, int MINB>
__global__ void __launch_bounds__(32 * WARPS, MINB) flash_bwd_dq_kernel(const Args a) {
  using T = DqTile<DP, WARPS, BK, HOLD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // q2 after the prologue
  bf16* sDO = reinterpret_cast<bf16*>(smem + T::ROWS);
  bf16* sKV = reinterpret_cast<bf16*>(smem + 2 * T::ROWS);  // K0, V0, K1, V1
  constexpr int TE = BK * T::LD;                             // elements of one tile
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N, d = a.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bf16* kb = head_of(a.k, a.st.k, bh, a.H);
  const bf16* vb = head_of(a.v, a.st.v, bh, a.H);
  const int tiles = (n + BK - 1) / BK;

  // q, dO and key tile 0 in one group; q prescaled in place once it lands
  cp_async_rows<DP, T::LD, T::BQ, T::THREADS>(sQ, head_of(a.q, a.st.q, bh, a.H), a.st.q[1],
                                              q0, n, d);
  cp_async_rows<DP, T::LD, T::BQ, T::THREADS>(sDO, head_of(a.dout, a.st.o, bh, a.H),
                                              a.st.o[1], q0, n, d);
  cp_async_rows<DP, T::LD, BK, T::THREADS>(sKV, kb, a.st.k[1], 0, n, d);
  cp_async_rows<DP, T::LD, BK, T::THREADS>(sKV + TE, vb, a.st.v[1], 0, n, d);
  cp_async_commit();
  // L2 and D of this thread's rows g and g+8 (0 past n, where dO is 0 too)
  const int row0 = q0 + warp * 16;
  float l2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    l2[i] = r < n ? a.lse[(long long)bh * n + r] : 0.f;
    dd[i] = r < n ? a.dd[(long long)bh * n + r] : 0.f;
  }
  cp_async_wait_all();
  prescale_own<DP, T::LD, T::BQ, T::THREADS>(sQ, sQ, a.scale_log2);
  __syncthreads();

  // this warp's rows of q2 and dO as A fragments
  const bf16* qrow = sQ + (warp * 16 + lane % 16) * T::LD + (lane / 16) * 8;
  const bf16* orow = sDO + (warp * 16 + lane % 16) * T::LD + (lane / 16) * 8;
  uint32_t qf[HOLD ? T::KS : 1][4], of[HOLD ? T::KS : 1][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kk = 0; kk < T::KS; ++kk) {
      ldsm_x4(qf[kk], qrow + kk * 16);
      ldsm_x4(of[kk], orow + kk * 16);
    }
  }
  float acc[T::NO][4];
  zero(acc);

  for (int j = 0; j < tiles; ++j) {
    if (j > 0) {
      cp_async_wait_all();
      // tile j is visible to every thread, and every warp is done with tile
      // j-1, whose stage the next copy overwrites
      __syncthreads();
    }
    if (j + 1 < tiles) {
      bf16* nxt = sKV + ((j + 1) & 1) * 2 * TE;
      cp_async_rows<DP, T::LD, BK, T::THREADS>(nxt, kb, a.st.k[1], (j + 1) * BK, n, d);
      cp_async_rows<DP, T::LD, BK, T::THREADS>(nxt + TE, vb, a.st.v[1], (j + 1) * BK, n, d);
      cp_async_commit();
    }
    const bf16* sK = sKV + (j & 1) * 2 * TE;

    float s[T::NT][4], dp[T::NT][4];
    zero(s);
    zero(dp);
    abt_product<T::KS, T::NT, T::LD, HOLD>(s, qf, qrow, sK);        // S  = q2 K^T
    abt_product<T::KS, T::NT, T::LD, HOLD>(dp, of, orow, sK + TE);  // dP = dO V^T

    // rows are queries (g, g+8), columns keys (2t, 2t+1 of each n8 tile)
    const int kv = n - j * BK;  // valid keys of this tile
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] - l2[e / 2]);
        if (kv < BK && nt * 8 + 2 * t + (e & 1) >= kv) p = 0.f;
        dp[nt][e] = p * (dp[nt][e] - dd[e / 2]) * a.scale;
      }
    uint32_t ds[T::NT / 2][4];
    pack_a<T::NT>(ds, dp);
    pv_product<T::NT / 2, T::NO, T::LD>(acc, ds, sK, 0, d);  // dQ += dS K
  }
  // only this warp read its rows of sQ, so they take its output
  store_acc<T::NO, T::LD>(acc, sQ + warp * 16 * T::LD, a.out0, a, bh, row0, 0);
}

template <int DP, int WARPS, int BK, bool HOLD, int MINB>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  using T = DqTile<DP, WARPS, BK, HOLD>;
  auto kern = flash_bwd_dq_kernel<DP, WARPS, BK, HOLD, MINB>;
  // once per instantiation (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return attr;
  kern<<<dim3((a.N + T::BQ - 1) / T::BQ, a.B * a.H), T::THREADS, T::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// --- flash_bwd_dkv_kernel (K6) ------------------------------------------------

// WARPS warps over 16*WARPS/SPLIT key rows (warp w: row tile w / SPLIT,
// head-dim slice w % SPLIT), q tiles of BQ, head dim DP (padded); shared
// memory holds K and V, then 2 stages of Q, q2, dO, L2 and D
template <int DP, int WARPS, int BQ, bool HOLD, int SPLIT>
struct DkvTile {
  static constexpr int THREADS = 32 * WARPS, BKV = 16 * WARPS / SPLIT;
  static constexpr int LD = DP + 8;
  static constexpr int KS = DP / 16;          // k16 steps of S^T and dP^T
  static constexpr int NT = BQ / 8;           // n8 tiles of S^T and dP^T
  static constexpr int SLICE = DP / SPLIT;    // columns of dK and dV a warp
  static constexpr int NO = SLICE / 8;        // its n8 tiles
  static constexpr size_t KV = align128(size_t(BKV) * LD * 2);  // K or V
  static constexpr size_t TILE = align128(size_t(BQ) * LD * 2);  // Q, q2 or dO
  static constexpr size_t STAT = align128(size_t(BQ) * 4);       // L2 or D
  static constexpr size_t STAGE = 3 * TILE + 2 * STAT;
  static constexpr size_t SMEM = 2 * KV + 2 * STAGE;
  static_assert(DP % 16 == 0 && BQ % 16 == 0 && WARPS % SPLIT == 0 && SLICE % 8 == 0,
                "tile shape");
  static_assert(SMEM <= kSmemPerBlock, "shared memory per block");
};

template <int DP, int WARPS, int BQ, bool HOLD, int SPLIT, int MINB>
__global__ void __launch_bounds__(32 * WARPS, MINB) flash_bwd_dkv_kernel(const Args a) {
  using T = DkvTile<DP, WARPS, BQ, HOLD, SPLIT>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + T::KV);
  unsigned char* ring = smem + 2 * T::KV;  // stage s at ring + s * STAGE
  const int bh = blockIdx.y, k0 = blockIdx.x * T::BKV, n = a.N, d = a.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int rt = warp / SPLIT, c0 = (warp % SPLIT) * T::SLICE;
  const bf16* qb = head_of(a.q, a.st.q, bh, a.H);
  const bf16* ob = head_of(a.dout, a.st.o, bh, a.H);
  const float* lb = a.lse + (long long)bh * n;
  const float* db = a.dd + (long long)bh * n;
  const int tiles = (n + BQ - 1) / BQ;

  // q tile j into stage j & 1: Q at +0, q2 at +TILE (made on arrival), dO
  // at +2 TILE, L2 and D after them
  auto issue = [&](int j) {
    unsigned char* st = ring + (j & 1) * T::STAGE;
    cp_async_rows<DP, T::LD, BQ, T::THREADS>(reinterpret_cast<bf16*>(st), qb, a.st.q[1],
                                             j * BQ, n, d);
    cp_async_rows<DP, T::LD, BQ, T::THREADS>(reinterpret_cast<bf16*>(st + 2 * T::TILE), ob,
                                             a.st.o[1], j * BQ, n, d);
    cp_async_stat<BQ, T::THREADS>(reinterpret_cast<float*>(st + 3 * T::TILE), lb, j * BQ, n);
    cp_async_stat<BQ, T::THREADS>(reinterpret_cast<float*>(st + 3 * T::TILE + T::STAT), db,
                                  j * BQ, n);
    cp_async_commit();
  };
  // q tile j has landed and its q2 is made: visible to every thread, and
  // every warp is done with tile j-1, whose stage the next copy overwrites
  auto arrive = [&](int j) {
    cp_async_wait_all();
    bf16* st = reinterpret_cast<bf16*>(ring + (j & 1) * T::STAGE);
    prescale_own<DP, T::LD, BQ, T::THREADS>(st + T::TILE / 2, st, a.scale_log2);
    __syncthreads();
  };

  cp_async_rows<DP, T::LD, T::BKV, T::THREADS>(sK, head_of(a.k, a.st.k, bh, a.H), a.st.k[1], k0,
                                               n, d);
  cp_async_rows<DP, T::LD, T::BKV, T::THREADS>(sV, head_of(a.v, a.st.v, bh, a.H), a.st.v[1], k0,
                                               n, d);
  issue(0);
  arrive(0);

  // this warp's 16 key rows of K and V as A fragments
  const bf16* krow = sK + (rt * 16 + lane % 16) * T::LD + (lane / 16) * 8;
  const bf16* vrow = sV + (rt * 16 + lane % 16) * T::LD + (lane / 16) * 8;
  uint32_t kf[HOLD ? T::KS : 1][4], vf[HOLD ? T::KS : 1][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kk = 0; kk < T::KS; ++kk) {
      ldsm_x4(kf[kk], krow + kk * 16);
      ldsm_x4(vf[kk], vrow + kk * 16);
    }
  }
  float dk[T::NO][4], dv[T::NO][4];
  zero(dk);
  zero(dv);

  for (int j = 0; j < tiles; ++j) {
    if (j > 0) arrive(j);
    if (j + 1 < tiles) issue(j + 1);
    unsigned char* st = ring + (j & 1) * T::STAGE;
    const bf16* sQ = reinterpret_cast<const bf16*>(st);
    const bf16* sQ2 = reinterpret_cast<const bf16*>(st + T::TILE);
    const bf16* sDO = reinterpret_cast<const bf16*>(st + 2 * T::TILE);
    const float* sL = reinterpret_cast<const float*>(st + 3 * T::TILE);
    const float* sD = reinterpret_cast<const float*>(st + 3 * T::TILE + T::STAT);

    // rows are keys (g, g+8), columns queries (2t, 2t+1 of each n8 tile).
    // P^T first, and its bf16 copy into dV at once, so that only P^T (fp32,
    // for dS^T) is live beside dP^T
    const int qv = n - j * BQ;  // valid queries of this tile
    float s[T::NT][4];
    zero(s);
    abt_product<T::KS, T::NT, T::LD, HOLD>(s, kf, krow, sQ2);  // S^T = K q2^T
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(sL + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - ((e & 1) ? l2.y : l2.x));
        if (qv < BQ && nt * 8 + 2 * t + (e & 1) >= qv) s[nt][e] = 0.f;
      }
    }
    {
      uint32_t pf[T::NT / 2][4];
      pack_a<T::NT>(pf, s);
      pv_product<T::NT / 2, T::NO, T::LD>(dv, pf, sDO, c0, d);  // dV += P^T dO
    }
    float dp[T::NT][4];
    zero(dp);
    abt_product<T::KS, T::NT, T::LD, HOLD>(dp, vf, vrow, sDO);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      const float2 dd = *reinterpret_cast<const float2*>(sD + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = s[nt][e] * (dp[nt][e] - ((e & 1) ? dd.y : dd.x)) * a.scale;
    }
    uint32_t ds[T::NT / 2][4];
    pack_a<T::NT>(ds, dp);
    pv_product<T::NT / 2, T::NO, T::LD>(dk, ds, sQ, c0, d);  // dK += dS^T Q
  }
  // every warp is done reading K and V (a row tile's slice warps share its
  // rows), so each warp's own rows and columns of them take its output
  __syncthreads();
  store_acc<T::NO, T::LD>(dk, sK + rt * 16 * T::LD + c0, a.out0, a, bh, k0 + rt * 16, c0);
  store_acc<T::NO, T::LD>(dv, sV + rt * 16 * T::LD + c0, a.out1, a, bh, k0 + rt * 16, c0);
}

template <int DP, int WARPS, int BQ, bool HOLD, int SPLIT, int MINB>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  using T = DkvTile<DP, WARPS, BQ, HOLD, SPLIT>;
  auto kern = flash_bwd_dkv_kernel<DP, WARPS, BQ, HOLD, SPLIT, MINB>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return attr;
  kern<<<dim3((a.N + T::BKV - 1) / T::BKV, a.B * a.H), T::THREADS, T::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// --- the d = 512 pair on wgmma: flash_bwd_dq_wide_kernel (K5) and
// flash_bwd_dkv_wide_kernel (K6), the VAE's single-head mid attention -----

// cuTensorMapEncodeTiled, fetched from the driver at run time (the library
// links only the runtime)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The pair's tiles (the note at the top of the file): a cluster of two
// blocks on ROWS rows, the block of cluster rank r owning head-dim columns
// [HALF r, HALF r + HALF) of every operand and output; 384 threads, a
// producer warpgroup and two consumer warpgroups (roles 0 and 1). Shared
// memory (offsets from a 1 KB aligned base): the two resident operands
// (dQ: q and dO; dK/dV: K and V), a ring of 3 streamed tiles (dQ: K, V;
// dK/dV: Q, prescaled in place to q2 for the scores and copied in again
// unscaled for dK, and dO), the score exchange, the row statistics of
// each stage (dK/dV: L2 and D of its queries) and the barriers: 64 + 96 +
// 64 KB and 928 B, 231,328 B with the alignment slack.
struct WideBwd {
  static constexpr int ROWS = 64;           // a block's rows: the M of one wgmma
  static constexpr int TR = 32;             // rows of a streamed tile: the scores' N
  static constexpr int HALF = 256;          // head-dim columns a block owns
  static constexpr int PANELS = HALF / 64;  // 128-byte swizzled panels of 64 columns
  static constexpr int THREADS = 384;
  static constexpr int STAGES = 3;
  static constexpr uint32_t RES = ROWS * HALF * 2;  // 32,768: a resident operand's half
  static constexpr uint32_t TILE = TR * HALF * 2;   // 16,384: a streamed operand's half
  static constexpr uint32_t SLOT = ROWS * TR * 4;   // 8,192: a warpgroup's fp32 scores
  static constexpr uint32_t STAGE = 2 * TILE;
  static constexpr uint32_t OFF_RING = 2 * RES;
  static constexpr uint32_t OFF_X = OFF_RING + STAGES * STAGE;  // 4 slots for each of 2 tiles
  static constexpr uint32_t OFF_STAT = OFF_X + 2 * 4 * SLOT;    // per stage: L2, D (TR fp32 each)
  static constexpr uint32_t OFF_BAR = OFF_STAT + STAGES * 2 * TR * 4;
  static constexpr int BARS = 20;
  static constexpr uint32_t SMEM = OFF_BAR + BARS * 8 + 1024;
  static_assert(SMEM <= kSmemPerBlock, "shared memory per block");
  static_assert(STAGE % 1024 == 0 && OFF_X % 1024 == 0, "panels start on 1 KB swizzle atoms");
  static_assert(STAGES * STAGE >= 2 * ROWS * HALF * 2, "the epilogue stages in the ring");
};

// The barriers: resident operands landed; per stage, the ring full (one
// arrival + the copies' bytes) and empty (the 8 consumer warps);
// dK/dV's q2 and statistics made (96 prescale threads), q2 read (role 0's 4
// warps) and Q in again (one arrival + bytes); per tile parity, the
// exchange slots full (one arrival + the partner's 16 KB) and free (the
// partner's 8 warps)
enum {
  B_RES = 0, B_FULL = 1, B_EMPTY = 4, B_Q2FULL = 7, B_Q2DONE = 10, B_QFULL = 13, B_XFULL = 16,
  B_XFREE = 18
};

constexpr int kPrescalers = 96, kProducerRegs = 40, kConsumerRegs = 232;

// `bytes` of a swizzled operand prescaled in place, 16 bytes a step by
// threads [0, kPrescalers): the swizzle moves whole 16-byte chunks, so an
// element-wise map keeps it; then the writes are made visible to wgmma
__device__ __forceinline__ void prescale_panels(unsigned char* p, uint32_t bytes, float scale,
                                                int pt) {
  for (uint32_t i = pt; i < bytes / 16; i += kPrescalers) {
    uint4 v = reinterpret_cast<const uint4*>(p)[i];
    scale8(v, scale);
    reinterpret_cast<uint4*>(p)[i] = v;
  }
  fence_proxy_async();
}

// rows [r0, r0 + R) of this block's half (columns [c0, c0 + HALF)) of the
// operand that map m describes into dst: PANELS panels of R rows x 128
// bytes, each R / TR boxes, completing on bar
template <int R>
__device__ __forceinline__ void tma_half(unsigned char* dst, const CUtensorMap* m, int c0, int r0,
                                         int hh, int b, uint64_t* bar) {
#pragma unroll
  for (int p = 0; p < WideBwd::PANELS; ++p)
#pragma unroll
    for (int i = 0; i < R / WideBwd::TR; ++i)
      tma_load_4d(dst + (p * R + i * WideBwd::TR) * 128, m, c0 + 64 * p, r0 + i * WideBwd::TR, hh, b,
                  bar);
}

// A B^T over the block's HALF columns into sc, fp32 in wgmma's accumulator
// layout (16 k16 steps, 4 a panel): B the TR rows of a streamed tile in
// PANELS panels, K-major; A the ROWS resident rows, from shared memory
// (K-major, as B) or, where ap is given, from registers (its k16 A
// fragments)
__device__ __forceinline__ void scores_half(float (&sc)[16], const unsigned char* A,
                                            const uint32_t (*ap)[4], const unsigned char* B) {
  const uint32_t a0 = smem_addr(A), b0 = smem_addr(B);
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = 0.f;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const uint64_t db = sw128_desc(b0 + (kk / 4) * WideBwd::TR * 128 + (kk % 4) * 32, 16, 1024);
    if (ap != nullptr)
      wgmma_m64n32_rs(sc, ap[kk], db, kk > 0);
    else
      wgmma_m64n32_ss(sc, sw128_desc(a0 + (kk / 4) * WideBwd::ROWS * 128 + (kk % 4) * 32, 16, 1024),
                      db, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
}

// x (16 fp32 in the accumulator layout, columns = the tile's TR rows)
// rounded to bf16 as the A fragments of the two k16 steps over those rows
__device__ __forceinline__ void pack_tile(uint32_t (&af)[2][4], const float (&x)[16]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) af[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// Both kernels. Block (2 i + r, bh) of cluster i: rows [64 i, 64 i + 64) of
// head bh (queries for dQ, keys for dK/dV), head-dim half r.
template <bool DKV>
__device__ __forceinline__ void wide_bwd(const Args& a, const CUtensorMap* tq,
                                         const CUtensorMap* tk, const CUtensorMap* tv,
                                         const CUtensorMap* to) {
  using T = WideBwd;
  constexpr int OUT_COLS = DKV ? T::HALF : T::HALF / 2;  // output columns a consumer warpgroup
  constexpr int NACC = OUT_COLS / 2;  // its accumulator registers a thread
  constexpr int S = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + T::OFF_BAR);
  unsigned char* res0 = smem;           // dQ: q; dK/dV: K
  unsigned char* res1 = smem + T::RES;  // dQ: dO; dK/dV: V
  // stage s: dQ K at +0, V at +TILE; dK/dV Q (q2) at +0, dO at +TILE
  auto stage = [&](int j) { return smem + T::OFF_RING + (j % S) * T::STAGE; };
  auto stat = [&](int j) {
    return reinterpret_cast<float*>(smem + T::OFF_STAT) + (j % S) * 2 * T::TR;
  };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t peer = cluster_rank() ^ 1;
  const int c0 = (peer ^ 1) * T::HALF;
  const int bh = blockIdx.y, hh = bh % a.H, b = bh / a.H, n = a.N;
  const int r0 = (blockIdx.x / 2) * T::ROWS;
  const int tiles = (n + T::TR - 1) / T::TR;

  if (tid == 0) {
    mbar_init(&bar[B_RES], 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&bar[B_FULL + s], 1);
      mbar_init(&bar[B_EMPTY + s], 8);
      mbar_init(&bar[B_Q2FULL + s], kPrescalers);
      mbar_init(&bar[B_Q2DONE + s], 4);
      mbar_init(&bar[B_QFULL + s], 1);
    }
    for (int p = 0; p < 2; ++p) {
      mbar_init(&bar[B_XFULL + p], 1);
      mbar_init(&bar[B_XFREE + p], 8);
    }
  }
  // the barriers are initialised before the partner block arrives on them
  fence_barrier_init();
  cluster_sync();

  if (warp < 4) {
    // the producer warpgroup: thread 0 issues every copy, warps 1-3 make
    // dK/dV's q2
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      const CUtensorMap *m0 = DKV ? tk : tq, *m1 = DKV ? tv : to;  // resident
      const CUtensorMap *s0 = DKV ? tq : tk, *s1 = DKV ? to : tv;  // streamed
      mbar_expect_tx(&bar[B_RES], 2 * T::RES);
      tma_half<T::ROWS>(res0, m0, c0, r0, hh, b, &bar[B_RES]);
      tma_half<T::ROWS>(res1, m1, c0, r0, hh, b, &bar[B_RES]);
      auto load = [&](int j) {
        const int s = j % S;
        if (j >= S) mbar_wait(&bar[B_EMPTY + s], (j / S - 1) & 1);
        mbar_expect_tx(&bar[B_FULL + s], 2 * T::TILE);
        tma_half<T::TR>(stage(j), s0, c0, j * T::TR, hh, b, &bar[B_FULL + s]);
        tma_half<T::TR>(stage(j) + T::TILE, s1, c0, j * T::TR, hh, b, &bar[B_FULL + s]);
      };
      for (int j = 0; j < S && j < tiles; ++j) load(j);
      for (int j = 0; j < tiles; ++j) {
        if constexpr (DKV) {
          // Q again, unscaled, once role 0's scores have read q2
          const int s = j % S;
          mbar_wait(&bar[B_Q2DONE + s], (j / S) & 1);
          mbar_expect_tx(&bar[B_QFULL + s], T::TILE);
          tma_half<T::TR>(stage(j), s0, c0, j * T::TR, hh, b, &bar[B_QFULL + s]);
        }
        if (j + S < tiles) load(j + S);
      }
    } else if (DKV && warp > 0) {
      const int pt = tid - 32;
      for (int j = 0; j < tiles; ++j) {
        const int s = j % S;
        mbar_wait(&bar[B_FULL + s], (j / S) & 1);
        prescale_panels(stage(j), T::TILE, a.scale_log2, pt);
        // L2 and D of the tile's queries, 0 past N
        if (pt < 2 * T::TR) {
          const int c = j * T::TR + pt % T::TR;
          const float* src = pt < T::TR ? a.lse : a.dd;
          stat(j)[pt] = c < n ? src[(long long)bh * n + c] : 0.f;
        }
        mbar_arrive(&bar[B_Q2FULL + s]);
      }
    }
    cluster_sync();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // role 0 computes the scores S (dK/dV: S^T), role 1 dP (dP^T), over this
  // block's half; both then hold the whole of both, added over the pair
  const int ct = tid - 128, role = ct / 128, t = ct % 128, w = t / 32, g = lane / 4, qd = lane % 4;
  const bool need_dp = !DKV || role == 1;  // dK/dV's role 0 (dV) needs P alone
  const unsigned char* aop = role ? res1 : res0;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  // dQ: L2 and D of this thread's query rows 16 w + g and + 8 (0 past N)
  float l2r[2] = {0.f, 0.f}, ddr[2] = {0.f, 0.f};
  if constexpr (!DKV) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 16 * w + g + 8 * i;
      if (r < n) {
        l2r[i] = a.lse[(long long)bh * n + r];
        ddr[i] = a.dd[(long long)bh * n + r];
      }
    }
  }
  mbar_wait(&bar[B_RES], 0);
  // dQ: the scores' A operand in registers for the whole loop, warp w's 16
  // rows by ldmatrix from the swizzled panels: role 0's q2 made from q on
  // the way (round_bf16(q * d^-1/2 log2 e), bit for bit the forward's
  // prescale), role 1's dO as it is (dK/dV's 128 accumulators a thread
  // leave no room for them)
  uint32_t ap[DKV ? 1 : 16][4];
  if constexpr (!DKV) {
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const int row = 16 * w + lane % 16, col = (kk % 4) * 16 + (lane / 16) * 8;
      ldsm_x4(ap[kk],
              reinterpret_cast<const bf16*>(aop + (kk / 4) * T::ROWS * 128 + sw128(row, col)));
      if (role == 0) {
        uint4 v = make_uint4(ap[kk][0], ap[kk][1], ap[kk][2], ap[kk][3]);
        scale8(v, a.scale_log2);
        ap[kk][0] = v.x, ap[kk][1] = v.y, ap[kk][2] = v.z, ap[kk][3] = v.w;
      }
    }
  }

  // The exchange of tile j's partials, slots of tile parity j & 1: R_S,
  // R_D (the partner's, copied in by it) and O_S, O_D (this block's: read
  // by the other warpgroup, copied out to the partner's R slot); a slot
  // holds warp w's 2 KB at w * 128 float4, float4 i of lane l at + 32 i + l.
  // Tile j's copy is in flight while this warpgroup finishes tile j - 1:
  // iteration j pushes j and consumes j - 1.
  constexpr int SL = T::SLOT / 16;  // float4 a slot
  const int fo = w * 128 + lane;    // this thread's float4 in a slot, + 32 i
  for (int j = 0; j <= tiles; ++j) {
    if (j < tiles) {
      const int s = j % S, xp = j & 1;
      const uint32_t ph = (j / S) & 1, xph = (j >> 1) & 1;
      mbar_wait(&bar[B_FULL + s], ph);
      if (DKV && role == 0) mbar_wait(&bar[B_Q2FULL + s], ph);
      // this block's partial scores: dQ S = q2 K^T, dP = dO V^T; dK/dV S^T
      // = K q2^T, dP^T = V dO^T
      float sc[16];
      scores_half(sc, aop, DKV ? nullptr : ap, stage(j) + role * T::TILE);
      if (DKV && role == 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&bar[B_Q2DONE + s]);  // Q may come in again
      }
      float4* slot = reinterpret_cast<float4*>(smem + T::OFF_X + xp * 4 * T::SLOT);
      if (ct == 0) mbar_expect_tx(&bar[B_XFULL + xp], 2 * T::SLOT);  // the partner's copies
      if (lane == 0) bulk_wait_read<1>();  // this warp's copy of tile j - 2 has read its source
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i)
        slot[(2 + role) * SL + fo + 32 * i] =
            make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        if (j >= 2) mbar_wait(&bar[B_XFREE + xp], xph ^ 1);  // the partner read R[xp]
        bulk_copy_peer(slot + role * SL + w * 128, slot + (2 + role) * SL + w * 128,
                       T::SLOT / 4, &bar[B_XFULL + xp], peer);
        bulk_commit();
      }
    }
    if (j > 0) {
      const int jt = j - 1, s = jt % S, xp = jt & 1;
      const uint32_t ph = (jt / S) & 1, xph = (jt >> 1) & 1;
      const float4* slot = reinterpret_cast<const float4*>(smem + T::OFF_X + xp * 4 * T::SLOT);
      mbar_wait(&bar[B_XFULL + xp], xph);
      // S = this block's + the partner's partial, in that order in both
      // blocks' warpgroups alike (a + b == b + a): the pair agrees bit for bit
      float sv[16], dv[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 os = slot[2 * SL + fo + 32 * i], rs = slot[fo + 32 * i];
        sv[4 * i] = os.x + rs.x;
        sv[4 * i + 1] = os.y + rs.y;
        sv[4 * i + 2] = os.z + rs.z;
        sv[4 * i + 3] = os.w + rs.w;
        if (need_dp) {
          const float4 od = slot[3 * SL + fo + 32 * i], rd = slot[SL + fo + 32 * i];
          dv[4 * i] = od.x + rd.x;
          dv[4 * i + 1] = od.y + rd.y;
          dv[4 * i + 2] = od.z + rd.z;
          dv[4 * i + 3] = od.w + rd.w;
        }
      }
      // the partner may copy into this block's R slots of parity xp again
      __syncwarp();
      if (lane == 0) mbar_arrive_remote_relaxed(&bar[B_XFREE + xp], peer);
      if constexpr (DKV) mbar_wait(&bar[B_Q2FULL + s], ph);  // the tile's L2 and D
      const float* st2 = stat(jt);

      // P = exp2(S - L2), 0 past N, and dS = P (dP - D) d^-1/2 in fp32;
      // element 4 i + e: row 16 w + g + 8 (e / 2), column 8 i + 2 qd + e % 2
      // of the 64 x TR tile (dQ: rows queries, columns keys; dK/dV: rows
      // keys, columns queries)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * i + 2 * qd + (e & 1);
          const float l2 = DKV ? st2[col] : l2r[e / 2];
          const float dd = DKV ? (need_dp ? st2[T::TR + col] : 0.f) : ddr[e / 2];
          const float p = jt * T::TR + col < n ? exp2f(sv[4 * i + e] - l2) : 0.f;
          sv[4 * i + e] = p;
          if (need_dp) dv[4 * i + e] = p * (dv[4 * i + e] - dd) * a.scale;
        }
      // the product into this warpgroup's accumulator, A from registers
      // (the tile's TR rows are its k), B the streamed tile MN-major:
      //   dQ: both roles dQ += dS K, role r on columns [128 r, 128 r + 128)
      //   dK/dV: role 0 dV += P^T dO, role 1 dK += dS^T Q (Q in again, unscaled)
      uint32_t af[2][4];
      if (DKV && role == 0)
        pack_tile(af, sv);
      else
        pack_tile(af, dv);
      if (DKV && role == 1) mbar_wait(&bar[B_QFULL + s], ph);
      const uint32_t ob =
          smem_addr(stage(jt)) + (DKV ? (role ? 0 : T::TILE) : role * 2 * T::TR * 128);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t db = sw128_desc(ob + kk * 2048, T::TR * 128, 1024);
        if constexpr (DKV)
          wgmma_m64n256_rs_t(acc, af[kk], db);
        else
          wgmma_m64n128_rs_t(acc, af[kk], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(af[0]);
      fence_regs(af[1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar[B_EMPTY + s]);
    }
    // both warpgroups are done with the O slots of tile j - 1 (their
    // parity is written again at tile j + 1) and have written tile j's
    named_barrier(1, 256);
  }
  // every exchange of the pair is over; the ring is free for the epilogue
  cluster_sync();

  // the epilogue: this warpgroup's 64 x OUT_COLS block as bf16, staged in
  // the 128-byte swizzle (panels of 64 columns; conflict-free for the
  // fragment's rows) and written as 16-byte chunks, rows past N and columns
  // past d left out
  unsigned char* out_stage = smem + T::OFF_RING + role * T::ROWS * OUT_COLS * 2;
#pragma unroll
  for (int i = 0; i < NACC / 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * w + g + 8 * h, col = 8 * i + 2 * qd;
      *reinterpret_cast<uint32_t*>(out_stage + (col / 64) * T::ROWS * 128 + sw128(row, col % 64)) =
          pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  named_barrier(2 + role, 128);
  bf16* out = DKV ? (role ? a.out0 : a.out1) : a.out0;  // dQ; dK (role 1), dV (role 0)
  const int oc = c0 + (DKV ? 0 : role * OUT_COLS);
  constexpr int CH = OUT_COLS / 8;  // 16-byte chunks of a row
  for (int k = t; k < T::ROWS * CH; k += 128) {
    const int row = k / CH, cc = k % CH, col = oc + 8 * cc;
    if (r0 + row < n && col < a.D)
      *reinterpret_cast<uint4*>(out + ((long long)(b * n + r0 + row) * a.H + hh) * a.D + col) =
          *reinterpret_cast<const uint4*>(out_stage + (cc / 8) * T::ROWS * 128 + row * 128 +
                                          (((cc % 8) ^ (row & 7)) << 4));
  }
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(WideBwd::THREADS, 1)
    flash_bwd_dq_wide_kernel(const Args a, const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap to) {
  wide_bwd<false>(a, &tq, &tk, &tv, &to);
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(WideBwd::THREADS, 1)
    flash_bwd_dkv_wide_kernel(const Args a, const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap to) {
  wide_bwd<true>(a, &tq, &tk, &tv, &to);
}

// The tensor map of one (B, N, H, D) bf16 operand with element strides st
// (batch, seq, head) and a unit head-dim stride: dims (d, n, h, b), boxes
// of 64 columns x TR rows in the 128-byte swizzle, zeros outside. false
// where the driver refuses it (strides not multiples of 16 bytes, a base
// not 16-byte aligned: the wrapper's layout_error checks both first).
bool operand_map(CUtensorMap* m, const bf16* x, const long long (&st)[3], const Args& a) {
  static const EncodeTiled encode = []() -> EncodeTiled {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(fn);
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)a.D, (cuuint64_t)a.N, (cuuint64_t)a.H, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, WideBwd::TR, 1, 1}, unit[4] = {1, 1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(x), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// a cluster pair of blocks per 64 rows of each head
template <bool DKV>
cudaError_t launch_wide(const Args& a, cudaStream_t stream) {
  using T = WideBwd;
  auto kern = DKV ? flash_bwd_dkv_wide_kernel : flash_bwd_dq_wide_kernel;
  // once per kernel (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap m[4];
  const bf16* x[4] = {a.q, a.k, a.v, a.dout};
  const long long(*st[4])[3] = {&a.st.q, &a.st.k, &a.st.v, &a.st.o};
  for (int i = 0; i < 4; ++i)
    if (!operand_map(&m[i], x[i], *st[i], a)) return cudaErrorInvalidValue;
  kern<<<dim3(2 * ((a.N + T::ROWS - 1) / T::ROWS), a.B * a.H), T::THREADS, T::SMEM, stream>>>(
      a, m[0], m[1], m[2], m[3]);
  return cudaGetLastError();
}

cudaError_t make_args(Args* a, const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dd, void* out0, void* out1, int B, int N,
                      int H, int D, const long long* st, float scale_log2, float scale) {
  if (B <= 0 || N <= 0 || H <= 0 || D % 8 != 0 || B * H > 65535) return cudaErrorInvalidValue;
  a->q = static_cast<const bf16*>(q);
  a->k = static_cast<const bf16*>(k);
  a->v = static_cast<const bf16*>(v);
  a->dout = static_cast<const bf16*>(dout);
  a->lse = static_cast<const float*>(lse);
  a->dd = static_cast<const float*>(dd);
  a->out0 = static_cast<bf16*>(out0);
  a->out1 = static_cast<bf16*>(out1);
  a->B = B; a->N = N; a->H = H; a->D = D;
  for (int i = 0; i < 3; ++i) {
    a->st.q[i] = st[i];
    a->st.k[i] = st[3 + i];
    a->st.v[i] = st[6 + i];
    a->st.o[i] = st[9 + i];
  }
  a->scale_log2 = scale_log2;
  a->scale = scale;
  return cudaSuccess;
}

}  // namespace

// q, k, v, dout: bf16 (B, N, H, D), each with element strides (batch, seq,
// head) in `st` (q, k, v, dout in that order) and a unit head-dim stride;
// lse, dd: fp32 (B*H, N) contiguous; outputs bf16 (B, N, H, D) contiguous.
// scale_log2 = d^-1/2 * log2(e) (the q prescale), scale = d^-1/2. Launch on
// `stream`; return the cudaError_t of the launch. Padded head dims: 48/80/160
// serve configs/v1.yaml's UNet, 16/32 configs/tiny.yaml, 512 the VAE's mid
// attention when the first stage is trained (ops/flash_attention.py
// SUPPORTED_HEAD_DIMS and tuned_head_dim; flash_anyd.cu takes the others).
extern "C" int pbe_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* dd,
                                     void* dq, int B, int N, int H, int D,
                                     const long long* st, float scale_log2, float scale,
                                     void* stream) {
  Args a;
  cudaError_t err = make_args(&a, q, k, v, dout, lse, dd, dq, nullptr, B, N, H, D, st,
                              scale_log2, scale);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16:  return (int)launch_dq<16, 4, 64, true, 1>(a, s);
    case 32:  return (int)launch_dq<32, 4, 64, true, 1>(a, s);
    case 48:  return (int)launch_dq<48, 16, 32, true, 1>(a, s);
    case 80:  return (int)launch_dq<80, 8, 32, false, 2>(a, s);
    case 160: return (int)launch_dq<160, 4, 64, false, 1>(a, s);
    case 512: return (int)launch_wide<false>(a, s);
    default:  return (int)cudaErrorInvalidValue;
  }
}

extern "C" int pbe_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* dd,
                                      void* dk, void* dv, int B, int N, int H, int D,
                                      const long long* st, float scale_log2, float scale,
                                      void* stream) {
  Args a;
  cudaError_t err = make_args(&a, q, k, v, dout, lse, dd, dk, dv, B, N, H, D, st, scale_log2,
                              scale);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16:  return (int)launch_dkv<16, 4, 64, true, 1, 1>(a, s);
    case 32:  return (int)launch_dkv<32, 4, 64, true, 1, 1>(a, s);
    case 48:  return (int)launch_dkv<48, 8, 32, true, 1, 2>(a, s);
    case 80:  return (int)launch_dkv<80, 8, 64, true, 1, 1>(a, s);
    case 160: return (int)launch_dkv<160, 4, 32, false, 2, 1>(a, s);
    case 512: return (int)launch_wide<true>(a, s);
    default:  return (int)cudaErrorInvalidValue;
  }
}
