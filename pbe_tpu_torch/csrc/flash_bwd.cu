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
// At d = 512 (flash_bwd_dq_wide_kernel, flash_bwd_dkv_wide_kernel) the
// accumulators of 16 whole rows would be 256 fp32 registers a thread for dQ
// and 512 for dK + dV, so the head dim is split across warps, as the wide
// forward splits O: 8 warps, 32 rows a block, tiles of 32 streamed through
// 2 stages. Per tile, warp (rg, c) computes the 16x8 tiles of both scores
// (S and dP, or S^T and dP^T) for row group rg and columns [8c, 8c+8) over
// all 512 columns (abt_tile), turns them into P and dS in registers,
// writes them as bf16 to a (32 x 40) shared tile, and after a barrier
// multiplies its row group's 16x32 of them into its 128-column slice of
// the accumulators (pv_product): 64 fp32 registers for dQ, 128 for dK and
// dV. Two barriers a tile. The dK/dV kernel makes q2 in registers from the
// unscaled Q tile that dK needs (bit for bit the forward's prescale), which
// saves a third 33 KB tile a stage; shared memory 202,240 B (dQ) and
// 205,312 B (dK/dV), one block an SM.
//
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
//   dq     512    8   32   wide  -     1    (VAE) 128 / 256    202,240   186
//   dkv    512    8   32   wide  -     1    (VAE) 128 / 256    205,312   245
// (tile: key tile BK for dq, q tile BQ for dkv; the wide rows' grids at
// (4, 1024, 1, 512) and (2, 4096, 1, 512).) The file builds in 9-11 s with
// the d = 512 pair, beside flash_fwd.cu's 6-8 s (nvcc 12.9; chip_smoke.py
// phase 1 prints both times and the ptxas report).

// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the dQ kernel
// does 6*BH*N^2*d FLOP, the dK/dV kernel 8*BH*N^2*d, and each BH*N^2 exp2
// at ~3.9 T/s of special-function throughput. At (32, 4096, 40) the
// exponentials bind the dQ kernel (0.138 ms) and the products the dK/dV
// kernel (0.174 ms); at (32, 1024, 80) the products bind both; at the
// short sequences (256 and 64) the bytes bind. The design takes every
// shared-memory round trip of S, dP, P and dS off the loop and overlaps the
// loads with the products, so exp2 and mma.sync issue are what is left;
// the exp2 of each (q, k) pair is still taken in both kernels, which the
// two-kernel, atomic-free split costs. wgmma, TMA and warp specialisation
// are later work. At d = 512 the products bind (K5 0.0130 ms, K6 0.0174 at
// (4, 1024, 1, 512)); there each warp reads its A rows and B columns from
// shared memory by ldmatrix for every 16x8 score tile (3 ldmatrix a pair of
// mma), which a wgmma design would take off.

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
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      h2[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
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

// --- the d = 512 kernels: flash_bwd_dq_wide_kernel (K5) and
// flash_bwd_dkv_wide_kernel (K6), the VAE's single-head mid attention -----

// One warp's 16x8 tile of A B^T over the DP columns, fp32 in the C layout
// (c[0..1] row g, columns 2t, 2t+1; c[2..3] row g+8): A the warp's 16 rows
// (arow: its row lane%16 at column (lane/16)*8), B 8 rows (brow: row lane%8
// at column (lane/8)*8, so that one ldmatrix.x4 gives b0, b1 of two k16
// steps). Where SCALE_B, every B element is first rounded to
// bf16(b * bscale) in registers: the dK/dV kernel's q2, bit for bit the
// forward's prescale, made from the unscaled Q tile that dK needs as it is.
// Four independent accumulators keep the dependent mma chains short.
template <int DP, bool SCALE_B>
__device__ __forceinline__ void abt_tile(float (&c)[4], const bf16* arow, const bf16* brow,
                                         float bscale) {
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; kk += 2) {
    uint32_t b[4], a0[4], a1[4];
    ldsm_x4(b, brow + kk * 16);
    ldsm_x4(a0, arow + kk * 16);
    ldsm_x4(a1, arow + kk * 16 + 16);
    if constexpr (SCALE_B) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b[i]));
        b[i] = pack_bf16(f.x * bscale, f.y * bscale);
      }
    }
    mma_bf16(acc[kk % 4], a0, b[0], b[1]);
    mma_bf16(acc[(kk + 1) % 4], a1, b[2], b[3]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = acc[0][e] + acc[1][e] + acc[2][e] + acc[3][e];
}

// k16 A fragments of a warp's 16 rows (from row0) of a bf16 (rows x LDP)
// tile over its KS * 16 columns
template <int KS, int LDP>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const bf16* tile, int row0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(a[kk], tile + (row0 + lane % 16) * LDP + kk * 16 + (lane / 16) * 8);
}

// The tiles of both wide kernels: 8 warps, warp w in row group w / 4 (16 of
// the block's 32 rows) and slice w % 4. Per streamed tile of 32 rows, warp
// (rg, c) computes the 16x8 tiles of the two scores over the whole head dim
// for columns [8c, 8c+8) of the tile, turns them into bf16 P and dS in
// registers and writes them to shared memory; after a barrier it multiplies
// its row group's 16x32 of them into its slice [128c, 128c+128) of the
// accumulators (64 fp32 registers each).
struct WideBwdTile {
  static constexpr int DP = 512, ROWS = 32, WARPS = 8, THREADS = 32 * WARPS;
  static constexpr int LD = DP + 8;     // bf16 row pitch of the (32 x 512) tiles
  static constexpr int LDP = ROWS + 8;  // bf16 row pitch of P and dS: conflict-free
  static constexpr int SLICE = DP / 4;  // accumulator columns a warp
  static constexpr int NO = SLICE / 8;  // its n8 tiles
  static constexpr size_t TILE = align128(size_t(ROWS) * LD * 2);   // 33,280 bytes
  static constexpr size_t PDS = align128(size_t(ROWS) * LDP * 2);   // P or dS
  static constexpr size_t STAT = align128(size_t(ROWS) * 4);        // L2 or D
};

// dQ at d = 512: the block's 32 query rows (q2, made in place once, and dO)
// stay in shared memory; key tiles of 32 (K, V) stream through 2 stages.
// Shared memory: q2 + dO + 2 x (K + V) + dS = 202,240 bytes, one block an SM
struct DqWide : WideBwdTile {
  static constexpr size_t SMEM = 6 * TILE + PDS;
  static_assert(SMEM <= kSmemPerBlock, "shared memory per block");
};

__global__ void __launch_bounds__(WideBwdTile::THREADS, 1) flash_bwd_dq_wide_kernel(const Args a) {
  using T = DqWide;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // q2 after the prologue
  bf16* sDO = reinterpret_cast<bf16*>(smem + T::TILE);
  unsigned char* ring = smem + 2 * T::TILE;  // K0, V0, K1, V1
  bf16* sDS = reinterpret_cast<bf16*>(smem + 6 * T::TILE);
  const int bh = blockIdx.y, q0 = blockIdx.x * T::ROWS, n = a.N, d = a.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg = warp / 4, c = warp % 4;
  const bf16* kb = head_of(a.k, a.st.k, bh, a.H);
  const bf16* vb = head_of(a.v, a.st.v, bh, a.H);
  const int tiles = (n + T::ROWS - 1) / T::ROWS;
  auto stage = [&](int j, int which) {  // K (0) or V (1) of key tile j
    return reinterpret_cast<bf16*>(ring + ((j & 1) * 2 + which) * T::TILE);
  };
  auto issue = [&](int j) {
    cp_async_rows<T::DP, T::LD, T::ROWS, T::THREADS>(stage(j, 0), kb, a.st.k[1], j * T::ROWS,
                                                     n, d);
    cp_async_rows<T::DP, T::LD, T::ROWS, T::THREADS>(stage(j, 1), vb, a.st.v[1], j * T::ROWS,
                                                     n, d);
    cp_async_commit();
  };

  cp_async_rows<T::DP, T::LD, T::ROWS, T::THREADS>(sQ, head_of(a.q, a.st.q, bh, a.H),
                                                   a.st.q[1], q0, n, d);
  cp_async_rows<T::DP, T::LD, T::ROWS, T::THREADS>(sDO, head_of(a.dout, a.st.o, bh, a.H),
                                                   a.st.o[1], q0, n, d);
  issue(0);
  // L2 and D of this thread's rows g and g+8 of its row group (0 past n)
  const int row0 = q0 + rg * 16;
  float l2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    l2[i] = r < n ? a.lse[(long long)bh * n + r] : 0.f;
    dd[i] = r < n ? a.dd[(long long)bh * n + r] : 0.f;
  }
  cp_async_wait_all();
  prescale_own<T::DP, T::LD, T::ROWS, T::THREADS>(sQ, sQ, a.scale_log2);

  // A rows of this row group (q2, dO); B rows of keys [8c, 8c+8) of a tile
  const int aoff = (rg * 16 + lane % 16) * T::LD + (lane / 16) * 8;
  const int boff = (c * 8 + lane % 8) * T::LD + (lane / 8) * 8;
  float acc[T::NO][4];
  zero(acc);

  for (int j = 0; j < tiles; ++j) {
    if (j > 0) cp_async_wait_all();
    // tile j (and at j = 0 q2) is visible to every thread; every warp is
    // done with tile j-1's stage, which the next copy overwrites, and with
    // sDS
    __syncthreads();
    if (j + 1 < tiles) issue(j + 1);
    const bf16* sK = stage(j, 0);

    float s[4], dp[4];
    abt_tile<T::DP, false>(s, sQ + aoff, sK + boff, 0.f);          // S  = q2 K^T
    abt_tile<T::DP, false>(dp, sDO + aoff, stage(j, 1) + boff, 0.f);  // dP = dO V^T
    // rows: queries g, g+8 of the row group; columns: keys 8c + 2t, +1
    const int kv = n - j * T::ROWS;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(s[e] - l2[e / 2]);
      if (c * 8 + 2 * t + (e & 1) >= kv) p = 0.f;
      dp[e] = p * (dp[e] - dd[e / 2]) * a.scale;
    }
    bf16* w = sDS + (rg * 16 + g) * T::LDP + c * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(w) = pack_bf16(dp[0], dp[1]);
    *reinterpret_cast<uint32_t*>(w + 8 * T::LDP) = pack_bf16(dp[2], dp[3]);
    __syncthreads();  // the block's 32x32 dS is whole

    uint32_t ds[T::ROWS / 16][4];
    load_a<T::ROWS / 16, T::LDP>(ds, sDS, rg * 16);
    pv_product<T::ROWS / 16, T::NO, T::LD>(acc, ds, sK, c * T::SLICE, d);  // dQ += dS K
  }
  // q2 has not been read since the last tile's second barrier: each warp
  // stages its 16 x 128 block of dQ in its own rows and columns of it
  store_acc<T::NO, T::LD>(acc, sQ + rg * 16 * T::LD + c * T::SLICE, a.out0, a, bh, row0,
                          c * T::SLICE);
}

// dK and dV at d = 512: the block's 32 key rows (K, V) stay in shared
// memory; q tiles of 32 (the unscaled Q, dO, L2 and D) stream through 2
// stages. q2 = bf16(q * d^-1/2 log2 e) is made in registers from Q as the
// scores' B operand (abt_tile<.., true>), which saves a third (32 x 512)
// tile a stage: shared memory K + V + 2 x (Q + dO + L2 + D) + P + dS =
// 205,312 bytes, one block an SM. Each warp holds 16 x 128 of dK and of dV
// (128 fp32 registers).
struct DkvWide : WideBwdTile {
  static constexpr size_t STAGE = 2 * TILE + 2 * STAT;
  static constexpr size_t SMEM = 2 * TILE + 2 * STAGE + 2 * PDS;
  static_assert(SMEM <= kSmemPerBlock, "shared memory per block");
};

__global__ void __launch_bounds__(WideBwdTile::THREADS, 1) flash_bwd_dkv_wide_kernel(const Args a) {
  using T = DkvWide;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + T::TILE);
  unsigned char* ring = smem + 2 * T::TILE;  // stage s at ring + s * STAGE
  bf16* sP = reinterpret_cast<bf16*>(ring + 2 * T::STAGE);
  bf16* sDS = reinterpret_cast<bf16*>(ring + 2 * T::STAGE + T::PDS);
  const int bh = blockIdx.y, k0 = blockIdx.x * T::ROWS, n = a.N, d = a.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg = warp / 4, c = warp % 4;
  const bf16* qb = head_of(a.q, a.st.q, bh, a.H);
  const bf16* ob = head_of(a.dout, a.st.o, bh, a.H);
  const float* lb = a.lse + (long long)bh * n;
  const float* db = a.dd + (long long)bh * n;
  const int tiles = (n + T::ROWS - 1) / T::ROWS;

  // q tile j into stage j & 1: Q at +0, dO at +TILE, L2 and D after them
  auto issue = [&](int j) {
    unsigned char* st = ring + (j & 1) * T::STAGE;
    cp_async_rows<T::DP, T::LD, T::ROWS, T::THREADS>(reinterpret_cast<bf16*>(st), qb,
                                                     a.st.q[1], j * T::ROWS, n, d);
    cp_async_rows<T::DP, T::LD, T::ROWS, T::THREADS>(reinterpret_cast<bf16*>(st + T::TILE), ob,
                                                     a.st.o[1], j * T::ROWS, n, d);
    cp_async_stat<T::ROWS, T::THREADS>(reinterpret_cast<float*>(st + 2 * T::TILE), lb,
                                       j * T::ROWS, n);
    cp_async_stat<T::ROWS, T::THREADS>(reinterpret_cast<float*>(st + 2 * T::TILE + T::STAT), db,
                                       j * T::ROWS, n);
    cp_async_commit();
  };

  cp_async_rows<T::DP, T::LD, T::ROWS, T::THREADS>(sK, head_of(a.k, a.st.k, bh, a.H),
                                                   a.st.k[1], k0, n, d);
  cp_async_rows<T::DP, T::LD, T::ROWS, T::THREADS>(sV, head_of(a.v, a.st.v, bh, a.H),
                                                   a.st.v[1], k0, n, d);
  issue(0);

  // A rows of this row group (K, V); B rows of queries [8c, 8c+8) of a tile
  const int aoff = (rg * 16 + lane % 16) * T::LD + (lane / 16) * 8;
  const int boff = (c * 8 + lane % 8) * T::LD + (lane / 8) * 8;
  float dk[T::NO][4], dv[T::NO][4];
  zero(dk);
  zero(dv);

  for (int j = 0; j < tiles; ++j) {
    cp_async_wait_all();
    // q tile j (and at j = 0 K and V) is visible to every thread; every
    // warp is done with tile j-1's stage, which the next copy overwrites,
    // and with sP and sDS
    __syncthreads();
    if (j + 1 < tiles) issue(j + 1);
    unsigned char* st = ring + (j & 1) * T::STAGE;
    const bf16* sQ = reinterpret_cast<const bf16*>(st);
    const bf16* sDO = reinterpret_cast<const bf16*>(st + T::TILE);
    const float* sL = reinterpret_cast<const float*>(st + 2 * T::TILE);
    const float* sD = reinterpret_cast<const float*>(st + 2 * T::TILE + T::STAT);

    float s[4], dp[4];
    abt_tile<T::DP, true>(s, sK + aoff, sQ + boff, a.scale_log2);  // S^T  = K q2^T
    abt_tile<T::DP, false>(dp, sV + aoff, sDO + boff, 0.f);       // dP^T = V dO^T
    // rows: keys g, g+8 of the row group; columns: queries 8c + 2t, +1,
    // whose L2 and D sit side by side
    const int qv = n - j * T::ROWS;
    const int col = c * 8 + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(sL + col);
    const float2 dd = *reinterpret_cast<const float2*>(sD + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(s[e] - ((e & 1) ? l2.y : l2.x));
      if (col + (e & 1) >= qv) p = 0.f;
      s[e] = p;
      dp[e] = p * (dp[e] - ((e & 1) ? dd.y : dd.x)) * a.scale;
    }
    const int off = (rg * 16 + g) * T::LDP + col;
    *reinterpret_cast<uint32_t*>(sP + off) = pack_bf16(s[0], s[1]);
    *reinterpret_cast<uint32_t*>(sP + off + 8 * T::LDP) = pack_bf16(s[2], s[3]);
    *reinterpret_cast<uint32_t*>(sDS + off) = pack_bf16(dp[0], dp[1]);
    *reinterpret_cast<uint32_t*>(sDS + off + 8 * T::LDP) = pack_bf16(dp[2], dp[3]);
    __syncthreads();  // the block's 32x32 P^T and dS^T are whole

    {
      uint32_t pf[T::ROWS / 16][4];
      load_a<T::ROWS / 16, T::LDP>(pf, sP, rg * 16);
      pv_product<T::ROWS / 16, T::NO, T::LD>(dv, pf, sDO, c * T::SLICE, d);  // dV += P^T dO
    }
    uint32_t ds[T::ROWS / 16][4];
    load_a<T::ROWS / 16, T::LDP>(ds, sDS, rg * 16);
    pv_product<T::ROWS / 16, T::NO, T::LD>(dk, ds, sQ, c * T::SLICE, d);  // dK += dS^T Q
  }
  // K and V have not been read since the last tile's second barrier: each
  // warp stages its 16 x 128 blocks of dK and dV in its own rows and
  // columns of them
  store_acc<T::NO, T::LD>(dk, sK + rg * 16 * T::LD + c * T::SLICE, a.out0, a, bh,
                          k0 + rg * 16, c * T::SLICE);
  store_acc<T::NO, T::LD>(dv, sV + rg * 16 * T::LD + c * T::SLICE, a.out1, a, bh,
                          k0 + rg * 16, c * T::SLICE);
}

template <typename T>
cudaError_t launch_wide(void (*kern)(const Args), const Args& a, cudaStream_t stream) {
  // once per kernel (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return attr;
  kern<<<dim3((a.N + T::ROWS - 1) / T::ROWS, a.B * a.H), T::THREADS, T::SMEM, stream>>>(a);
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
// BWD_HEAD_DIMS lists the same).
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
    case 512: return (int)launch_wide<DqWide>(flash_bwd_dq_wide_kernel, a, s);
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
    case 512: return (int)launch_wide<DkvWide>(flash_bwd_dkv_wide_kernel, a, s);
    default:  return (int)cudaErrorInvalidValue;
  }
}
