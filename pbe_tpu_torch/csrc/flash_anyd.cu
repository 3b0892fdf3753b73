// Flash attention at any head dim d, 1 <= d <= 1024, for Hopper (sm_90a):
// the forward, dQ and dK/dV kernels for bf16 and for fp32 operands, the
// head dim a run-time argument.
//
// They serve the head dims that the kernels tuned per padded head dim
// (csrc/flash_fwd.cu, flash_bwd.cu and flash_fp32.cu: a multiple of 8
// padding to 16, 32, 48, 80, 160 or 512) do not instantiate, as
// ops/flash_attention.py's kernel_entry picks them, and replace there the
// Pallas kernels of pbe_tpu/ops/flash_attention.py, which pad any d to 128
// lanes:
//   flash_fwd_anyd      _flash_kernel_rowblock (K1, :85) and _flash_kernel
//                       (K2, :218, streamed): one function, O and the LSE
//   flash_bwd_dq_anyd   _flash_bwd_dq_kernel (K5, :408)
//   flash_bwd_dkv_anyd  _flash_bwd_dkv_kernel (K6, :445), dK and dV in one
// Their contracts are the tuned kernels' (ops/flash_attention.py:12-31):
//   * q2 = round_T(q * d^-1/2 log2(e)), the product in fp32; S = q2 K^T in
//     fp32, in the exp2 domain;
//   * P = exp2(S - m) is rounded to T before P V; O = round_T(acc / l); the
//     LSE m + log2(l), fp32, (B*H, N);
//   * backward: P = exp2(S - LSE), dS = P (dP - D) d^-1/2, dQ = round_T(
//     round_T(dS) K), dV = round_T(round_T(P)^T dO), dK = round_T(round_T(
//     dS)^T Q), D = rowsum(dO * O) given (a torch pass, as for the tuned
//     kernels).
// Scores: at fp32 (every round_T does nothing) every score, in all three
// kernels, is one fmaf chain over the head dim from column 0 (scores_fma in
// the fp32 forward and dK/dV, score_chunk in the SIMT dQ), so the backward
// recomputes P from the forward's S bit for bit. At bf16 all three take S
// on the tensor cores (mma.sync, fp32 accumulate) in one k-order, chunk by
// chunk and k16 step by k16 step from column 0 (chunk_scores), so dQ's P
// and dK/dV's P^T are the forward's P bit for bit.
//
// Layout: q, k, v (and dO) are (B, N, H, D) with any (batch, seq, head)
// strides and a unit head-dim stride, read in place: a packed q at d = 28
// has rows of 28 elements. The SIMT dQ reads one element a load. The
// tensor-core kernels copy pieces of at most 16 bytes (8, 4, 2 or 1 bf16
// elements, 4, 2 or 1 fp32: 16-, 8- or 4-byte cp.async, or a 2-byte load):
// the widest that divides d and every operand's base and strides
// (load_log2; a packed bf16 view at d = 28 or 100 reads 8-byte pieces, a
// contiguous d = 256 16-byte ones). Outputs are (B, N, H, D) contiguous.
// Rows past N are read as zeros and their keys (or queries) masked (P =
// 0); columns past d are zeros.
//
// The SIMT kernel (the fp32 dQ: it keeps cuBLAS's summation order, which
// phase 20's rising-max dQ check allows alone, PERF.md section 7). A block
// of 256 threads owns 64 query rows, the keys
// streamed in tiles of 64 (the JAX pair's grid order), and up to 256
// output columns; a wider head is split over grid.z, each split
// recomputing S. Thread (tr, tc) = (tid / 16, tid % 16) holds rows 4 tr +
// i (i < 4) and, of S, the keys 4 tc + j (j < 4), of the output columns 4
// tc + 64 g + e (g, e < 4): each operand of a product step is one 16-byte
// shared-memory load (8 FMA a load in S, 12.8 in P V). S (and dP) build
// over the head dim in chunks of 32 columns staged transposed in shared
// memory, the next chunk's loads in flight (in registers) while the
// current one is multiplied; dS goes to shared memory, and the output
// tile, in registers for the whole kernel (64 rows x 256 columns: 64 a
// thread), takes dS K in steps of 16 keys, every column group alike
// (columns past d are zeros: branching on d cost more than the products it
// skipped). One block an SM.
//
// The bf16 kernels (flash_fwd_anyd_mma, flash_bwd_dq_anyd_mma,
// flash_bwd_dkv_anyd_mma) follow the tuned kernels' FlashAttention-2 on
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with their register layouts
// (csrc/mma_sm90.cuh): a warp owns 16 whole rows, so the row statistics are
// taken over the quad and m and l sit in registers; P (and dS) are rounded
// to bf16 and fed straight back as A fragments (the C layout of two n8
// tiles is the A layout of a k16 step). The head dim stays a run-time
// argument, padded to a multiple of 16 in shared memory only: the streamed
// operands come in chunks of KC = 64 columns through a cp.async ring of 3
// slots (one __syncthreads a chunk; the copies of chunk i + 2 in flight
// while chunk i is multiplied), so a slot's size does not grow with d, and
// S builds over the chunks in order.
//   * forward: a block of kFwdWarps warps (4 at N <= 64, or where the q
//     tile does not fit: d > 784) owns 16 kFwdWarps query rows, its q2 tile
//     resident at the padded head dim (made once, by the threads that
//     copied each piece: bit for bit the tuned prescale), and an output
//     slice of 128 columns (d <= 128) or kFwdSlice (a wider head splits
//     over grid.z, each split recomputing S). Per key tile of 64: K's
//     chunks, S in registers, the online-softmax step, then the slice's V
//     chunks, P V into the chunk's O tiles. The body (fwd_mma) takes the key
//     block and K4's two passes as template arguments: the forward is K3 at
//     block 64, and csrc/flash_variants_anyd.cu's K3 and K4 run it at blocks
//     32, 64 and 128 (the fp32 forward's fwd_tf32 alike).
//   * dQ: the forward's shape with two score products. A block of kDqWarps
//     warps (4 at N <= 64 or where the tiles do not fit: d > 336; 2 past d
//     = 672) owns 16 kDqWarps query rows, its q2 and dO tiles resident at
//     the padded head dim, and an output slice of 128 columns (d <= 128) or
//     kDqSlice. Per key tile of 64: each slot brings chunk c of K and of V,
//     S = q2 K^T and dP = dO V^T in registers (S in the forward's k-order);
//     dS = P (dP - D) d^-1/2 with P = exp2(S - L2), L2 and D of the warp's
//     rows in registers for the whole kernel, rounded to bf16 as A
//     fragments; then the slice's K chunks come again through the ring
//     (re-streamed: keeping a key tile's K chunks for both uses would take
//     64 (dp + 8) more bf16 a block, 34 KB at d = 256, and the warps or the
//     ring with it), and dQ += dS K through ldmatrix.trans. dQ stays in
//     registers across the loop (256 columns: 128 a thread).
//   * dK/dV: a block owns 16 RT key rows, each row tile shared by SPLIT
//     warps that own 128 columns of dK and dV each (kDkvSplit past d = 128,
//     1 below; grid.z splits a wider head), and loops over q tiles of 32.
//     K and V of the block's rows stay in shared memory at the padded head
//     dim (RT = 4, or 2 where that does not fit: d > 672). Per q tile: the
//     chunks of q (prescaled on arrival) and dO, S^T = K q2^T and dP^T = V
//     dO^T in registers (S^T in the forward's k-order); P^T = exp2(S^T -
//     L2[q]) and dS^T = P^T (dP^T - D[q]) d^-1/2, L2 and D copied with the
//     tile's first chunk; then the warps' slices of q and dO in chunks of
//     64 columns (each split's in one slot), dV += P^T dO and dK += dS^T Q
//     through ldmatrix.trans. dK and dV stay in registers across the loop
//     (128 columns: 128 a thread); each split warp recomputes the scores.
//   * the loop's code stays small (the ring advances at one place a loop,
//     a chunk's O tiles are picked by an unrolled compare, and 16-byte
//     copies take compile-time indices): a first build with the copy code
//     inlined at every unrolled chunk ran ~19K instructions a kernel and
//     stalled on the instruction cache.
//
// The fp32 dK/dV (flash_bwd_dkv_anyd_tf32), flash_fp32.cu's dK/dV
// (flash_bwd_dkv_f32_kernel) at any head dim: S^T on the SIMT cores' FMA,
// the three products on the tensor cores in 3xTF32 (csrc/mma_sm90.cuh:
// each operand split into hi = tf32(x) and lo = x - hi, a product lo hi +
// hi lo + hi hi with fp32 accumulation; 1xTF32 keeps ~3 decimal digits,
// past phase 29's fp32 tolerances, tests/test_torch_flash_anyd.py).
//   * S^T stays one fmaf chain a score over the head dim (scores_fma, in
//     mma_tf32's C layout), so P^T is the fp32 forward's P bit for bit and
//     meets dP^T in registers. dP^T = V dO^T runs in 3xTF32 too: its
//     emulation in the kernel's order stays within a third of phase 29's
//     tolerances on the randn, peaked and rising-max inputs at d = 28 to
//     1024, so it takes the tensor cores beside dV and dK (decided once,
//     by that test).
//   * The tensor cores add with truncation, so every product sums a
//     bounded run of k8 steps into a zeroed partial that then joins its
//     result in fp32: dP^T one pair of partials (hi hi; lo hi and hi lo)
//     a chunk of KC = 64 columns, dV and dK one partial (all three terms)
//     a q tile of 32 queries.
//   * A block owns 16 RT key rows; each row tile has two warps, warp kind
//     0 owning dK's and kind 1 dV's columns [CW z, + CW) (CW = 128 up to
//     d = 128, 256 past it; grid.z splits a wider head), and loops over q
//     tiles of 32. K and V of the block's rows stay in shared memory at
//     pitch dp + 4 (dp = d padded to 8; RT = kDkvF32Rows = 4, 2 past d =
//     304, 1 past 656). Per q tile, through the ring of 3 slots of
//     q and dO panels of KC columns (pieces of 16, 8 or 4 bytes): the score
//     chunks, each warp scoring half the queries (S^T and dP^T for 16
//     queries: the row tile's scores are computed once); P^T and dS^T go
//     to shared memory, where the next barrier shows each warp the
//     fragment it multiplies (dS^T for kind 0, P^T for kind 1, over all 32
//     queries); then the chunks of the block's columns, dK += dS^T Q (q
//     unscaled) or dV += P^T dO. The C fragment of P^T or dS^T is the A
//     fragment of a k8 step as it stands (slot t takes query 2t, slot t +
//     4 query 2t + 1), split into hi and lo at each use: held split, it
//     spilled beside the 128 accumulator registers of a 256-column warp.
//   * FFMA and TF32 mma.sync share issue slots on this card (PR 13), so
//     S's FMA does not hide behind the products; one warp owning one
//     output keeps its working set to one A fragment.
//
// The fp32 forward (flash_fwd_anyd_tf32; the body fwd_tf32, which
// csrc/flash_variants_anyd.cu's fp32 K3 and K4 run too): flash_fp32.cu's
// forward (flash_fwd_f32_kernel) at any head dim, S on FMA, P V on the
// tensor cores in 3xTF32.
//   * A block of kFwdF32Warps warps (4 at N <= 64) owns 16 rows a warp and
//     an output slice of 128 columns (d <= 128, and at key blocks of 128)
//     or kFwdF32Slice (a wider head splits over grid.z, each split
//     recomputing S). q2 is made once a block, by the threads that copy
//     each piece, and stays resident at pitch dp + 4 (dp = d padded to 8)
//     where it fits beside the ring (d <= 344 at 8 warps and tiles of 64
//     keys), else its 64-column panels come through the ring beside each K
//     panel, made q2 on arrival by the threads that copied them (with a
//     slice of 192 columns: the extra copies' registers spilled at 256).
//   * Per key tile of PK = max(BK, 64) keys (a tile of 64 holds two key
//     blocks of 32): the tile's K panels (PK keys x KC columns at pitch PF)
//     through the ring's STAGES slots, one barrier a panel; S = q2
//     K^T on FMA, summed by lane pairs (scores_pair_fma: lanes g and g ^ 1
//     each take 4 rows x 8 keys, 12 shared-memory reads a column for 32
//     fmaf where the C layout's 2 rows x 16 keys read 18; S's FMA is bound
//     by those reads), then swapped into mma_tf32's C layout by 4 shuffles
//     a pair of n8 tiles (pair_to_c). Each score is one fmaf chain over the
//     head dim from column 0, so the fp32 backward's S, K4's second S and
//     this S agree bit for bit. The row max and sum over the quad, m, l and
//     O in registers; P stays in the C layout, which is the A layout of a
//     k8 step, and never touches shared memory; then the slice's V panels,
//     O += P V (pv_panel_tf32: 3xTF32; the panel's 8 n8 tiles in halves of
//     four, one zeroed partial a tile and run of up to 64 keys within a key
//     block, joined to O in fp32; 1xTF32, or dropping either small term,
//     misses the fp32 tolerances, tests/test_torch_flash_variants_anyd.py).
//   * K3 (and the forward) is one online-softmax step a key block, O and l
//     rescaled by exp2(m_old - m_new) (O as P V meets it); K4 takes the
//     tiles' K panels and the row max first (O not yet live), then S
//     again, P = exp2(S - m_final) and O += P V, never rescaled.
//   * FFMA and TF32 mma.sync share issue slots, and mma.sync's TF32 rate is
//     a fraction of wgmma's: at (128, 256, 1, 256) the ring, S and P V
//     each take about a third of the time and add up (ablations, PERF.md
//     section 6).
//
// Nothing is atomic: each output element has one owner, so a launch is
// bitwise repeatable.
// The tiles are the fastest of `python -m pbe_tpu_torch.scripts
// .sweep_flash_tiles --anyd` at the DDPM shape and at d = 64, 128 and
// 1024 (N = 256, batch 128; PERF.md section 6 has the times): 8 forward
// warps against 4 tie at d = 256 and win by ~9% at d = 128 (each K and V
// chunk serves twice the query rows); 4 ring slots against 3 tie; a
// 128-column slice against 256 costs 1.4x at d = 256 (S twice) and split 1
// against 2 saves ~2% of dK/dV at d = 256 but costs 2.2x at 1024 (S per
// 128 columns). dQ: 8 warps against 4 win by 1.65x at d = 256 (0.127
// against 0.209 ms) and a 256-column slice against 128 by 1.45x (S and dP
// twice). The fp32 dK/dV: 4 row tiles against 2 win by 1.6x at d = 256 (2
// with 2 ring slots, two blocks an SM, by 1.1x); 2 or 4 ring slots against
// 3 tie; q tiles of 16 (no spills with held A fragments) cost 1.28x. The
// fp32 forward, K3 and K4 (forward / K3 / K4 ms, H100 at 700 W): 8 warps
// 0.2996 / 0.3182 / 0.4531 at d = 256, against 4 warps 0.4477 / 0.4900 /
// 0.6850 (and 1-3% slower at d = 64, 128 and ds1, the geometry (2, 4096, 8,
// 64)); a 256-column slice against 128 (0.3970 / 0.3979 / 0.6386; 1.3x at d
// = 1024: S per 128 columns); 3 ring slots against 2 or 4 tie (within 1%);
// q2 resident against streamed (0.4895 / 0.4991 / 0.8953; 1.3x at ds1);
// the SIMT body these replace took 0.4506 / 0.6006 / 0.8990 at d = 256 and
// 6.1094 / 15.5610 / 30.3156 at d = 1024, where these take 4.7145 /
// 4.8271 / 9.5225 (192-column slices where q2 streams).
// What bounds them: at the DDPM UNet's (128, 256, 1, 256) the bf16
// forward is 8.6 GFLOP of products and 67 MB of bf16 operands (0.020 ms at
// 3.35 TB/s), dQ 12.9 GFLOP and 84 MB, dK/dV 17.2 GFLOP and 101 MB: bytes
// bind them on this card. They run several times their byte bound: every
// warp reads its operands through ldmatrix from shared memory (all warps
// of a block the same K chunk), 128 accumulator registers a thread leave 8
// warps an SM to hide the ldmatrix and mma.sync latencies, each split
// recomputes S, and every block of a head re-reads the streamed operands
// from L2 (K and V each q block, q and dO each key block), which stalls the
// cp.async issue. wgmma (operands read from shared memory once a
// warpgroup, accumulators of 64 rows) is the next step. The fp32 dK/dV is
// bound by S on FMA (4.3 GFLOP, 0.064 ms at 67 TFLOP/s) beside 3 x 12.9
// GFLOP of TF32 products (0.078 ms at 495 TFLOP/s); on the card its time
// splits (ablations, PERF.md section 6) into the ring and its barriers with
// q and dO streamed twice from L2 a key block (~0.19 ms), S on FMA
// (~0.17), dP^T (~0.10) and the two products (~0.18). The SIMT kernels are
// bound by the fp32 FMA rate (67 TFLOP/s). chip_smoke.py phase 29 times
// each kernel beside its bound, its plain version and SDPA, and logs
// ptxas's registers and spills, the build time and the HMMA count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int THREADS = 256;  // 16 x 16: tr = tid / 16 (rows), tc = tid % 16 (columns)
constexpr int BR = 64;        // a block's own rows: queries (forward, dQ), keys (dK/dV)
constexpr int BT = 64;        // rows of a streamed tile: keys (forward, dQ), queries (dK/dV)
constexpr int DC = 32;        // head-dim columns of a score chunk
constexpr int SUB = 16;       // streamed rows of an output step
constexpr int LD = BT + 4;    // pitch of the transposed chunks and of P / dS (16-byte rows)
constexpr int MAX_D = 1024;
// output columns a thread, and a block (grid.z splits a wider head)
constexpr int NJ = 16, COLS = 16 * NJ;
// dQ's dynamic shared memory (floats): the score chunks, dS, the streamed
// rows of the output step
constexpr size_t DQ_SMEM = (4 * DC * LD + BT * LD + SUB * COLS) * sizeof(float);
static_assert(DQ_SMEM <= 232448, "shared memory per block");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }
// x rounded to T (nearest even) and back
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// A launch's operands
template <typename T>
struct Args {
  const T* in[4];    // q, k, v, dO (null in the forward)
  long long st[12];  // (batch, seq, head) element strides of each
  const float* lse;  // backward: the forward's LSE, (B*H, N)
  const float* dd;   // backward: D = rowsum(dO * O), (B*H, N)
  T* out[2];         // O | dQ | dK, dV: (B, N, H, D) contiguous
  float* lse_out;    // forward: the LSE, or null
  int B, N, H, D;
  int lw;            // mma kernels: log2 of the elements a copied piece (load_log2)
  float scale_log2;  // d^-1/2 log2(e): the q prescale
  float scale;       // d^-1/2: dS's factor
};

// the rows of one head of operand i
template <typename T>
struct Head {
  const T* p;
  long long rs;
  __device__ __forceinline__ Head(const Args<T>& a, int i, int bh)
      : p(a.in[i] + (long long)(bh / a.H) * a.st[3 * i] + (long long)(bh % a.H) * a.st[3 * i + 2]),
        rs(a.st[3 * i + 1]) {}
};

// A ROWS x COLS tile of one head, rows [r0, r0 + ROWS) and columns [c0, c0 +
// COLS), through registers: fetch() starts the loads, put() / put_t() store
// the values to shared memory once its readers are done. Rows >= n and
// columns >= d are 0; with prescale != 0 each value is round_T(x *
// prescale) (q2).
template <typename T, int ROWS, int COLS>
struct Stage {
  static constexpr int PER = ROWS * COLS / THREADS;
  // thread t holds column t % COLS of rows t / COLS + STEP e (e < PER)
  static constexpr int STEP = THREADS / COLS;
  static_assert(THREADS % COLS == 0 && ROWS * COLS % THREADS == 0 && ROWS <= LD, "tile");
  float v[PER];

  __device__ __forceinline__ void fetch(const Head<T>& h, int r0, int c0, int n, int d,
                                        float prescale) {
    const int r = r0 + threadIdx.x / COLS, c = c0 + threadIdx.x % COLS;
    const T* p = h.p + (long long)r * h.rs + c;
    const long long step = STEP * h.rs;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      float x = 0.f;
      if (r + STEP * e < n && c < d) {
        x = to_f(p[e * step]);
        if (prescale != 0.f) x = round_to<T>(x * prescale);
      }
      v[e] = x;
    }
  }
  // row-major, pitch COLS
  __device__ __forceinline__ void put(float* dst) const {
#pragma unroll
    for (int e = 0; e < PER; ++e) dst[threadIdx.x + THREADS * e] = v[e];
  }
  // transposed: column c of row r at dst[c * LD + r]
  __device__ __forceinline__ void put_t(float* dst) const {
    float* q = dst + (threadIdx.x % COLS) * LD + threadIdx.x / COLS;
#pragma unroll
    for (int e = 0; e < PER; ++e) q[STEP * e] = v[e];
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// the rows 4 tr + i and the streamed rows (of S) 4 tc + j of this thread
__device__ __forceinline__ int row_of(int i) { return 4 * (threadIdx.x / 16) + i; }
__device__ __forceinline__ int key_of(int j) { return 4 * (threadIdx.x % 16) + j; }
// output column j < NJ of this thread (groups of 4 columns, 64 apart)
__device__ __forceinline__ int col_of(int j) {
  return 4 * (threadIdx.x % 16) + 64 * (j / 4) + j % 4;
}

// s[i][j] += A[k][4 tr + i] * B[k][4 tc + j] for the chunk's kn columns k
// (both at pitch LD), one fmaf a column in column order: with s at 0 before
// column 0, every score of every fp32 kernel here is one fmaf chain over the
// head dim, in the order cuBLAS's fp32 product (the plain version's) takes
// too; partial sums a chunk, added after, moved the fp32 backward past its
// tolerance on peaked scores at d = 100 (rel L2 2.9e-5 against 1e-5 on the
// card)
__device__ __forceinline__ void score_chunk(float (&s)[4][4], const float* A, const float* B,
                                            int kn) {
  const float* a = A + row_of(0);
  const float* b = B + key_of(0);
  auto step = [&](int k) {
    const float4 x4 = ld4(a + k * LD), y4 = ld4(b + k * LD);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w}, y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  };
  if (kn == DC) {
#pragma unroll
    for (int k = 0; k < DC; ++k) step(k);
  } else {
    for (int k = 0; k < kn; ++k) step(k);
  }
}

// acc[i][j] += sum over u < SUB of W[u][4 tr + i] X[u][col_of(j)] (W pitch
// LD, X pitch COLS); columns past d are zeros in X, their sums never stored
__device__ __forceinline__ void out_step(float (&acc)[4][NJ], const float* W, const float* X) {
  const float* w0 = W + row_of(0);
  const float* x0 = X + key_of(0);
#pragma unroll 4
  for (int u = 0; u < SUB; ++u) {
    const float4 w4 = ld4(w0 + u * LD);
    const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int g = 0; g < NJ / 4; ++g) {
      const float4 x4 = ld4(x0 + u * COLS + 64 * g);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][4 * g + e] = fmaf(w[i], x[e], acc[i][4 * g + e]);
    }
  }
}

// out (B, N, H, D) contiguous, rows r0 + 4 tr + i of head bh, columns c0 +
// col_of(j): round_T(acc / div)
template <typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[4][NJ], const float (&div)[4], T* out,
                                           const Args<T>& a, int bh, int r0, int c0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + row_of(i);
    if (row >= a.N) continue;
    T* dst = out + ((long long)(bh / a.H) * a.N + row) * a.H * a.D + (long long)(bh % a.H) * a.D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = c0 + col_of(j);
      if (col < a.D) dst[col] = from_f<T>(acc[i][j] / div[i]);
    }
  }
}

// S (q2 K^T) and dP (dO V^T) of query rows qr0.. and key rows kr0.., i over
// queries and j over keys, built over the head dim in chunks
template <typename T>
__device__ __forceinline__ void scores_and_dp(float (&s)[4][4], float (&dp)[4][4], const Args<T>& a,
                                              const Head<T>& q, const Head<T>& k,
                                              const Head<T>& v, const Head<T>& dout, int qr0,
                                              int kr0, float* sQ, float* sK, float* sO,
                                              float* sV) {
  const int n = a.N, d = a.D, chunks = (d + DC - 1) / DC;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  Stage<T, BR, DC> qs, os;
  Stage<T, BT, DC> ks, vs;
  qs.fetch(q, qr0, 0, n, d, a.scale_log2);
  ks.fetch(k, kr0, 0, n, d, 0.f);
  os.fetch(dout, qr0, 0, n, d, 0.f);
  vs.fetch(v, kr0, 0, n, d, 0.f);
  for (int c = 0; c < chunks; ++c) {
    __syncthreads();  // every thread is done with the previous chunk and output step
    qs.put_t(sQ);
    ks.put_t(sK);
    os.put_t(sO);
    vs.put_t(sV);
    __syncthreads();
    if (c + 1 < chunks) {
      qs.fetch(q, qr0, (c + 1) * DC, n, d, a.scale_log2);
      ks.fetch(k, kr0, (c + 1) * DC, n, d, 0.f);
      os.fetch(dout, qr0, (c + 1) * DC, n, d, 0.f);
      vs.fetch(v, kr0, (c + 1) * DC, n, d, 0.f);
    }
    const int kn = min(DC, d - c * DC);
    score_chunk(s, sQ, sK, kn);
    score_chunk(dp, sO, sV, kn);
  }
}

// dQ (K5): query rows r0 = 64 blockIdx.x, key tiles streamed, output
// columns from 256 blockIdx.z
template <typename T>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_anyd(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;           // the score chunks, transposed [DC][LD]: q2, K, dO, V
  float* sK = sQ + DC * LD;
  float* sO = sK + DC * LD;
  float* sV = sO + DC * LD;
  float* sS = sV + DC * LD;   // round_T(dS), key-major [BT][LD]
  float* sX = sS + BT * LD;   // K rows [SUB][COLS]
  const int bh = blockIdx.y, r0 = blockIdx.x * BR, c0 = blockIdx.z * COLS;
  const int n = a.N, d = a.D;
  const Head<T> q(a, 0, bh), k(a, 1, bh), v(a, 2, bh), dout(a, 3, bh);
  float lse[4], dd[4], acc[4][NJ];
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + row_of(i);
    lse[i] = row < n ? a.lse[(long long)bh * n + row] : 0.f;
    dd[i] = row < n ? a.dd[(long long)bh * n + row] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  for (int t0 = 0; t0 < n; t0 += BT) {
    float s[4][4], dp[4][4];
    scores_and_dp(s, dp, a, q, k, v, dout, r0, t0, sQ, sK, sO, sV);
    // s becomes round_T(dS)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float ds = 0.f;
        if (r0 + row_of(i) < n && t0 + key_of(j) < n) {
          const float p = exp2f(s[i][j] - lse[i]);
          ds = p * (dp[i][j] - dd[i]) * a.scale;
        }
        s[i][j] = round_to<T>(ds);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st4(sS + key_of(j) * LD + row_of(0), s[0][j], s[1][j], s[2][j], s[3][j]);
    // dQ += dS K, 16 keys a step
    Stage<T, SUB, COLS> xs;
    xs.fetch(k, t0, c0, n, d, 0.f);
    for (int u = 0; u < BT; u += SUB) {
      __syncthreads();  // sS is whole (u = 0); every thread is done with sX
      xs.put(sX);
      __syncthreads();
      if (u + SUB < BT) xs.fetch(k, t0 + u + SUB, c0, n, d, 0.f);
      out_step(acc, sS + u * LD, sX);
    }
  }
  store_rows<T>(acc, one, a.out[0], a, bh, r0, c0);
}

// log2 of the widest piece of at most 16 bytes (8, 4, 2 or 1 bf16
// elements; 4, 2 or 1 fp32) that divides d and every operand's base (in
// elements) and (batch, seq, head) strides; the stride of a dimension of
// size 1 is never stepped and does not count
template <typename T>
int load_log2(const Args<T>& a, int nin) {
  for (int lw = sizeof(T) == 2 ? 3 : 2; lw > 0; --lw) {
    const long long w = 1LL << lw;
    bool ok = a.D % w == 0;
    for (int i = 0; i < nin && ok; ++i)
      ok = reinterpret_cast<uintptr_t>(a.in[i]) % (w * sizeof(T)) == 0 &&
           (a.B == 1 || a.st[3 * i] % w == 0) && (a.N == 1 || a.st[3 * i + 1] % w == 0) &&
           (a.H == 1 || a.st[3 * i + 2] % w == 0);
    if (ok) return lw;
  }
  return 0;
}

// a's fields from an entry's arguments (nin operands, 3 strides each);
// cudaErrorInvalidValue for a shape no launch takes
template <typename T>
cudaError_t make_args(Args<T>* a, const void* const* in, int nin, const long long* st,
                      const void* lse, const void* dd, void* o0, void* o1, void* lse_out, int B,
                      int N, int H, int D, float scale_log2, float scale) {
  if (B <= 0 || N <= 0 || H <= 0 || D < 1 || D > MAX_D || (long long)B * H > 65535)
    return cudaErrorInvalidValue;
  *a = Args<T>{};
  for (int i = 0; i < nin; ++i) {
    a->in[i] = static_cast<const T*>(in[i]);
    for (int j = 0; j < 3; ++j) a->st[3 * i + j] = st[3 * i + j];
  }
  a->lse = static_cast<const float*>(lse);
  a->dd = static_cast<const float*>(dd);
  a->out[0] = static_cast<T*>(o0);
  a->out[1] = static_cast<T*>(o1);
  a->lse_out = static_cast<float*>(lse_out);
  a->B = B;
  a->N = N;
  a->H = H;
  a->D = D;
  a->scale_log2 = scale_log2;
  a->scale = scale;
  a->lw = load_log2(*a, nin);
  return cudaSuccess;
}

// grid: (64-row blocks, B*H, head-dim splits of COLS columns)
template <typename T>
cudaError_t launch(void (*kern)(Args<T>), cudaError_t attr, size_t smem, const Args<T>& a,
                   void* stream) {
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.N + BR - 1) / BR, a.B * a.H, (a.D + COLS - 1) / COLS);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

template <typename T>
int run_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* dd, void* dq, int B, int N, int H, int D, const long long* st,
           float scale_log2, float scale, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_anyd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DQ_SMEM);
  const void* in[4] = {q, k, v, dout};
  Args<T> a;
  const cudaError_t err = make_args(&a, in, 4, st, lse, dd, dq, nullptr, nullptr, B, N, H, D,
                                    scale_log2, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<T>(flash_bwd_dq_anyd<T>, attr, DQ_SMEM, a, stream);
}

// --- bf16: the forward, dQ and dK/dV on mma.sync tensor cores ---------------

constexpr int KC = 64;           // head-dim columns of a chunk
constexpr int PITCH = KC + 8;    // bf16 row pitch of a chunk's panel: conflict-free ldmatrix
constexpr int STAGES = 3;        // slots of the cp.async ring
constexpr size_t SMEM_MAX = 232448;  // bytes of shared memory a block can use
// the tiles (chosen by timing, the file's header): the forward's warps of
// 16 query rows a block and its output columns a block past d = 128
// (128 up to it); dK/dV's warps sharing a row tile past d = 128, each
// owning 128 columns (1 up to it)
constexpr int kFwdWarps = 8;
constexpr int kFwdSlice = 256;
constexpr int kDkvSplit = 2;
// dQ's warps of 16 query rows a block and its output columns a block past
// d = 128 (128 up to it)
constexpr int kDqWarps = 8;
constexpr int kDqSlice = 256;

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + rows) and columns [c0, c0 + cols) of one head (row stride
// rs) into a (rows x pitch) tile of T at dst, in pieces of 1 << lw
// elements shared by nthr threads: cp.async of 16, 8 or 4 bytes, or a
// plain 2-byte copy (a bf16 at lw = 0). Rows >= n and columns >= d are
// zero (d is a multiple of the piece, so a piece is all in or all out).
// For the rows a block holds (the forward's q, dQ's q and dO, dK/dV's K
// and V), once a block.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int pitch, const T* src, long long rs, int r0,
                                          int rows, int c0, int cols, int n, int d, int lw,
                                          int nthr) {
  const int per_row = cols >> lw, total = rows * per_row, bytes = int(sizeof(T)) << lw;
  for (int i = threadIdx.x; i < total; i += nthr) {
    const int r = i / per_row, c = (i - r * per_row) << lw;
    const bool valid = r0 + r < n && c0 + c < d;
    const T* s = valid ? src + (long long)(r0 + r) * rs + c0 + c : src;
    T* t = dst + r * pitch + c;
    if (bytes == 16)
      cp_async16(t, s, valid);
    else if (bytes == 8)
      cp_async8(t, s, valid);
    else if (bytes == 4)
      cp_async4(t, s, valid);
    else
      *t = valid ? *s : from_f<T>(0.f);
  }
}

// q2 = round_T(q * scale) in place over the pieces of a (rows x pitch)
// tile that this thread copied with copy_tile (the same rows, cols, lw and
// nthr): its own copies are visible to it once they have landed, so no
// barrier comes before this pass. Bit for bit the tuned kernels' prescale.
template <typename T>
__device__ __forceinline__ void prescale_tile(T* tile, int pitch, int rows, int cols, int lw,
                                              int nthr, float scale) {
  const int per_row = cols >> lw, total = rows * per_row;
  for (int i = threadIdx.x; i < total; i += nthr) {
    const int r = i / per_row;
    T* t = tile + r * pitch + ((i - r * per_row) << lw);
    for (int e = 0; e < (1 << lw); ++e) t[e] = from_f<T>(to_f(t[e]) * scale);
  }
}

// A panel of KC columns of one head, rows [r0, r0 + ROWS) from column
// c0, at the pitch KC + 16 bytes (PITCH for bf16, PF for fp32), by THREADS
// threads, in copy_tile's pieces: piece i = tid + e THREADS is piece i % P
// of row i / P (P = KC >> lw pieces a row), so the indices are shifts, and
// the 16-byte case unrolls at compile time (or, with UNROLL false, stays a
// loop, whose addresses hold fewer registers at once)
template <int ROWS, int THREADS, typename T, bool UNROLL = true>
__device__ __forceinline__ void copy_panel(T* dst, const T* src, long long rs, int r0, int c0,
                                           int n, int d, int lw) {
  constexpr int W = 16 / sizeof(T), LD = KC + W;  // elements a 16-byte piece; the pitch
  if (lw == (W == 8 ? 3 : 2)) {
    constexpr int PER = KC / W, STEP = THREADS / PER;
    static_assert(THREADS % PER == 0 && ROWS % STEP == 0, "panel");
    const int r = threadIdx.x / PER, c = (threadIdx.x % PER) * W;
    const bool col = c0 + c < d;
    const T* s = src + (long long)(r0 + r) * rs + c0 + c;
    auto piece = [&](int e) {
      const bool valid = col && r0 + r + e * STEP < n;
      cp_async16(dst + (r + e * STEP) * LD + c, valid ? s + e * STEP * rs : src, valid);
    };
    if constexpr (UNROLL) {
#pragma unroll
      for (int e = 0; e < ROWS / STEP; ++e) piece(e);
    } else {
#pragma unroll 1
      for (int e = 0; e < ROWS / STEP; ++e) piece(e);
    }
    return;
  }
  const int shift = 6 - lw, bytes = int(sizeof(T)) << lw;  // log2 of the pieces a row
  for (int i = threadIdx.x; i < (ROWS << shift); i += THREADS) {
    const int r = i >> shift, c = (i & ((1 << shift) - 1)) << lw;
    const bool valid = r0 + r < n && c0 + c < d;
    const T* s = valid ? src + (long long)(r0 + r) * rs + c0 + c : src;
    T* t = dst + r * LD + c;
    if (bytes == 8)
      cp_async8(t, s, valid);
    else if (bytes == 4)
      cp_async4(t, s, valid);
    else
      *t = valid ? *s : from_f<T>(0.f);
  }
}

// q2 = round_T(q * scale) in place over the pieces of a panel that this
// thread copied with copy_panel<ROWS, THREADS> (the same shift-indexed
// pieces): bit for bit the forward's q2
template <int ROWS, int THREADS, typename T>
__device__ __forceinline__ void prescale_own(T* panel, int lw, float scale) {
  constexpr int LD = KC + 16 / sizeof(T);
  const int shift = 6 - lw;
  for (int i = threadIdx.x; i < (ROWS << shift); i += THREADS) {
    T* t = panel + (i >> shift) * LD + ((i & ((1 << shift) - 1)) << lw);
    if constexpr (sizeof(T) == 2) {
      if (lw == 3) {
        uint4 val = *reinterpret_cast<const uint4*>(t);
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h2[j]);
          h2[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
        *reinterpret_cast<uint4*>(t) = val;
        continue;
      }
    }
    for (int e = 0; e < (1 << lw); ++e) t[e] = from_f<T>(to_f(t[e]) * scale);
  }
}

// s += A B^T over the first ks k16 steps (ks <= KC / 16) of one chunk: A
// the warp's 16 rows (arow: its row lane % 16 at the chunk's column
// (lane / 16) * 8), B an (8 NT x PITCH) panel, its rows the n8 tiles:
// lanes 0-7 / 8-15 give rows 0-7 of an n8 pair at columns +0 / +8 (b0, b1
// of tile nt), lanes 16-31 rows 8-15 (tile nt + 1), as the forward reads K.
// Called chunk by chunk from column 0, every score sums its k16 steps in
// one order, the forward's S and dK/dV's S^T alike.
template <int NT>
__device__ __forceinline__ void chunk_scores(float (&s)[NT][4], const bf16* arow,
                                             const bf16* panel, int ks) {
  const int lane = threadIdx.x % 32;
  const bf16* brow = panel + ((lane % 8) + (lane / 16) * 8) * PITCH + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    if (kk >= ks) break;
    uint32_t a[4];
    ldsm_x4(a, arow + kk * 16);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldsm_x4(b, brow + nt * 8 * PITCH + kk * 16);
      mma_bf16(s[nt], a, b[0], b[1]);
      mma_bf16(s[nt + 1], a, b[2], b[3]);
    }
  }
}

// o[base + j] += P X for the n8 tiles j < KC / 8 of one chunk whose columns
// lie below dv (the chunk's columns below d): P the A fragments of KS k16
// steps of streamed rows, X a (16 KS x PITCH) panel of those rows, read
// through ldmatrix.trans (pv_product's layout)
template <int KS, int NO>
__device__ __forceinline__ void pv_chunk(float (&o)[NO][4], const uint32_t (&p)[KS][4],
                                         const bf16* panel, int base, int dv) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const bf16* row = panel + (kk * 16 + lane % 16) * PITCH + (lane / 16) * 8;
#pragma unroll
    for (int j = 0; j < KC / 8; j += 2) {
      if (j * 8 >= dv) break;
      if (j * 8 + 8 < dv) {
        uint32_t b[4];
        ldsm_x4_trans(b, row + j * 8);
        mma_bf16(o[base + j], p[kk], b[0], b[1]);
        mma_bf16(o[base + j + 1], p[kk], b[2], b[3]);
      } else {
        uint32_t b[2];
        ldsm_x2_trans(b, row + j * 8);
        mma_bf16(o[base + j], p[kk], b[0], b[1]);
      }
    }
  }
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

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// two adjacent output elements at p (even index): one 4- or 8-byte store
__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}
__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// rows row0 + g and row0 + g + 8 (lane (g, t)) of head bh of out, (B, N,
// H, D) contiguous, columns c0 + 8 j + 2 t and + 1 of the NO n8 tiles:
// round_T(x / div[i]) for the rows below n and the columns below d (one
// store of the pair where d is even, so every pair is aligned)
template <int NO, typename T>
__device__ __forceinline__ void store_tiles(const float (&x)[NO][4], const float (&div)[2], T* out,
                                            const Args<T>& a, int bh, int row0, int c0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, d = a.D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= a.N) continue;
    T* dst = out + ((long long)(bh / a.H) * a.N + row) * a.H * d + (long long)(bh % a.H) * d;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = c0 + 8 * j + 2 * t;
      if (col >= d) break;
      const float lo = x[j][2 * i] / div[i], hi = x[j][2 * i + 1] / div[i];
      if (d % 2 == 0) {
        store_pair(dst + col, lo, hi);
      } else {
        dst[col] = from_f<T>(lo);
        if (col + 1 < d) dst[col + 1] = from_f<T>(hi);
      }
    }
  }
}

// The forward's tiles: WARPS warps of 16 query rows, key tiles (K1/K2/K3)
// or chunks (K4) of BK keys, output columns [CS z, CS z + CS) of block z.
// Shared memory: the block's q2 rows at the padded head dim (pitch dp + 8),
// then the ring, whose slots hold a chunk of K or of V (BK rows).
template <int WARPS, int CS, int BK>
struct FwdMma {
  static constexpr int THREADS = 32 * WARPS, BQ = 16 * WARPS;
  static constexpr int NT = BK / 8;   // n8 tiles of S
  static constexpr int NO = CS / 8;   // n8 tiles of O
  static constexpr int NV = CS / KC;  // V chunks of a whole slice
  static constexpr int SLOT = BK * PITCH;  // bf16 elements
  static_assert(CS % KC == 0 && NT % 2 == 0, "tile");
  static __host__ __device__ constexpr size_t smem(int dp) {
    return (size_t(BQ) * (dp + 8) + size_t(STAGES) * SLOT) * 2;
  }
};

// K4's pass 2 over one chunk, S in the C layout with kv valid keys: P =
// exp2(S - m) against the final row max m (0 at the keys past kv), this
// thread's share of the chunk's row sums added to l (summed over the quad
// at the end), P rounded to bf16 as the A fragments of P V
template <int NT>
__device__ __forceinline__ void final_p(float (&s)[NT][4], uint32_t (&p)[NT / 2][4],
                                        const float (&m)[2], float (&l)[2], int kv) {
  mask_keys<NT>(s, kv);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float p0 = exp2f(s[nt][0] - m[0]), p1 = exp2f(s[nt][1] - m[0]);
    const float p2 = exp2f(s[nt][2] - m[1]), p3 = exp2f(s[nt][3] - m[1]);
    sum[0] += p0 + p1;
    sum[1] += p2 + p3;
    p[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
    p[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
  l[0] += sum[0];
  l[1] += sum[1];
}

// One block of the forward: K1/K2/K3 (TWO_PASS false) or K4, query rows q0
// = BQ blockIdx.x of head blockIdx.y, output columns from CS blockIdx.z. K3
// is one online-softmax step a key tile of BK, P rounded against the
// running max of that tile (the any-head-dim forward is K3 at BK = 64); K4
// takes S and the row max over chunks of BK, then S again, P = exp2(S -
// m_final) and O += P V a chunk, never rescaled.
template <int WARPS, int CS, int BK, bool TWO_PASS>
__device__ __forceinline__ void fwd_mma(const Args<bf16>& a) {
  using T = FwdMma<WARPS, CS, BK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, c0 = blockIdx.z * CS;
  const int n = a.N, d = a.D, lw = a.lw, dp = (d + 15) / 16 * 16, pq = dp + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = sQ + T::BQ * pq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Head<bf16> q(a, 0, bh), k(a, 1, bh), v(a, 2, bh);
  const int nc = (d + KC - 1) / KC;                // score chunks of a key tile
  const int nv = (min(CS, d - c0) + KC - 1) / KC;  // V chunks of this slice
  const int tiles = (n + BK - 1) / BK;

  const bf16* arow = sQ + (warp * 16 + lane % 16) * pq + (lane / 16) * 8;
  // The ring: items in order into slot ps, one cp.async group an item
  // (empty past the last): K4's first pass brings the nc K chunks of each
  // key chunk (pass 0), then K3's only pass and K4's second (pass 1) the nc
  // K chunks and the nv V chunks of each, chunk pc of key tile pj; the item
  // consumed is in slot cs. The code that advances it appears once for the
  // score chunks and once for the V chunks, so the loop stays small enough
  // for the instruction cache.
  int pass = TWO_PASS ? 0 : 1, pj = 0, pc = 0, ps = 0, cs = 0;
  auto issue = [&]() {
    if (pj < tiles) {
      bf16* slot = ring + ps * T::SLOT;
      const int col = pc < nc ? pc * KC : c0 + (pc - nc) * KC;
      copy_panel<BK, T::THREADS>(slot, pc < nc ? k.p : v.p, pc < nc ? k.rs : v.rs, pj * BK, col,
                                 n, d, lw);
      if (++pc == (!TWO_PASS || pass ? nc + nv : nc)) {
        pc = 0;
        if (++pj == tiles && TWO_PASS && pass == 0) pj = 0, pass = 1;
      }
    }
    ps = ps + 1 == STAGES ? 0 : ps + 1;
    cp_async_commit();
  };
  // the next item has landed: visible to every thread after the barrier,
  // by which every thread is also done with the item before, whose slot
  // the next issue takes -> the item's slot
  auto arrive = [&]() {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue();
    const bf16* slot = ring + cs * T::SLOT;
    cs = cs + 1 == STAGES ? 0 : cs + 1;
    return slot;
  };
  // S = q2 K^T of the next key tile, chunk by chunk from column 0
  auto scores = [&](float (&s)[T::NT][4]) {
    zero(s);
    for (int c = 0; c < nc; ++c)
      chunk_scores<T::NT>(s, arow + c * KC, arrive(), min(KC, dp - c * KC) / 16);
  };
  float o[T::NO][4];
  // O += P V, a V chunk of the slice at a time
  auto pv = [&](const uint32_t (&p)[T::NT / 2][4]) {
    for (int vc = 0; vc < nv; ++vc) {
      const bf16* slot = arrive();
      const int dv = d - c0 - vc * KC;
#pragma unroll
      for (int u = 0; u < T::NV; ++u)  // chunk vc's O tiles, at compile-time indices
        if (u == vc) pv_chunk<T::NT / 2, T::NO>(o, p, slot, u * (KC / 8), dv);
    }
  };

  // q lands with the first item; each thread makes q2 of the pieces it
  // copied (bit for bit the tuned kernels' prescale), which the first
  // item's barrier shows every thread
  copy_tile(sQ, pq, q.p, q.rs, q0, T::BQ, 0, dp, n, d, lw, T::THREADS);
#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) issue();
  cp_async_wait<STAGES - 2>();
  prescale_tile(sQ, pq, T::BQ, dp, lw, T::THREADS, a.scale_log2);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if constexpr (TWO_PASS) {
    for (int j = 0; j < tiles; ++j) {  // pass 1: this thread's share of the row max
      float s[T::NT][4];
      scores(s);
      mask_keys<T::NT>(s, n - j * BK);
      row_max<T::NT>(s, m);
    }
    quad_max(m);
    zero(o);
    for (int j = 0; j < tiles; ++j) {  // pass 2: P against the final max
      float s[T::NT][4];
      scores(s);
      uint32_t p[T::NT / 2][4];
      final_p<T::NT>(s, p, m, l, n - j * BK);
      pv(p);
    }
  } else {
    zero(o);
    for (int j = 0; j < tiles; ++j) {  // the online softmax, a step a key tile
      float s[T::NT][4];
      scores(s);
      uint32_t p[T::NT / 2][4];
      softmax_step<T::NT, T::NO>(s, p, o, m, l, n - j * BK);
      pv(p);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int row0 = q0 + warp * 16;
  store_tiles<T::NO>(o, l, a.out[0], a, bh, row0, c0);
  if (a.lse_out != nullptr && blockIdx.z == 0 && lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + lane / 4 + 8 * i;
      if (row < n) a.lse_out[(long long)bh * n + row] = m[i] + log2f(l[i]);
    }
  }
}

// The forward (K1/K2): key tiles of 64
template <int WARPS, int CS>
__global__ void __launch_bounds__(32 * WARPS, 1) flash_fwd_anyd_mma(const Args<bf16> a) {
  fwd_mma<WARPS, CS, 64, false>(a);
}

template <int V>
using Int = std::integral_constant<int, V>;

// The bf16 forward's launch plan at key block BK: go(Int<WARPS>, Int<CS>)
// launches the kernel of FwdMma<WARPS, CS, BK>'s tiles. kFwdWarps warps, or
// 4 at N <= 64 (one 64-row block) or where the q2 tile of kFwdWarps warps
// does not fit beside the ring (d > 784 at BK = 64); the output slice of
// 128 columns up to d = 128 and at BK = 128 (S of 128 keys beside 256
// accumulator columns would leave no registers), else kFwdSlice.
template <int BK, typename Go>
cudaError_t fwd_mma_plan(const Args<bf16>& a, Go go) {
  const int dp = (a.D + 15) / 16 * 16;
  auto slice = [&](auto cs) {
    if (a.N > 64 && FwdMma<kFwdWarps, decltype(cs)::value, BK>::smem(dp) <= SMEM_MAX)
      return go(Int<kFwdWarps>{}, cs);
    return go(Int<4>{}, cs);
  };
  if constexpr (BK == 128) {
    return slice(Int<128>{});
  } else {
    if (a.D <= 128) return slice(Int<128>{});
    return slice(Int<kFwdSlice>{});
  }
}

// one launch of a bf16 forward kernel of FwdMma<WARPS, CS, BK>'s tiles
template <int WARPS, int CS, int BK>
cudaError_t launch_fwd_tiles(void (*kern)(Args<bf16>), cudaError_t attr, const Args<bf16>& a,
                             cudaStream_t stream) {
  using T = FwdMma<WARPS, CS, BK>;
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.N + T::BQ - 1) / T::BQ, a.B * a.H, (a.D + CS - 1) / CS);
  kern<<<grid, T::THREADS, T::smem((a.D + 15) / 16 * 16), stream>>>(a);
  return cudaGetLastError();
}

// dK/dV's tiles: RT row tiles of 16 keys, SPLIT warps each, warp (rt, sp)
// owning columns [CSB z + CW sp, + CW) of dK and dV; q tiles of BQ. Shared
// memory: K and V of the block's rows at pitch dp + 8, the ring (a slot:
// the q and dO panels of a score chunk, or of each split's columns), and
// L2 and D of a q tile by tile parity.
template <int RT, int SPLIT>
struct DkvMma {
  static constexpr int WARPS = RT * SPLIT, THREADS = 32 * WARPS, BKV = 16 * RT, BQ = 32;
  static constexpr int NT = BQ / 8;  // n8 tiles of S^T and dP^T
  static constexpr int CW = 128;     // columns of dK and dV a warp
  static constexpr int NO = CW / 8, NCW = CW / KC, CSB = SPLIT * CW;
  static constexpr int SLOT = 2 * SPLIT * BQ * PITCH;  // bf16 elements
  static constexpr size_t STATS = 2 * 2 * BQ * sizeof(float);
  static __host__ __device__ constexpr size_t smem(int dp) {
    return 2 * size_t(BKV) * (dp + 8) * 2 + size_t(STAGES) * SLOT * 2 + STATS;
  }
};

template <int RT, int SPLIT>
__global__ void __launch_bounds__(32 * RT * SPLIT, 1) flash_bwd_dkv_anyd_mma(const Args<bf16> a) {
  using T = DkvMma<RT, SPLIT>;
  constexpr int BQ = T::BQ;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int n = a.N, d = a.D, lw = a.lw, dp = (d + 15) / 16 * 16, pk = dp + 8;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + T::BKV * pk;
  bf16* ring = sV + T::BKV * pk;
  float* stats = reinterpret_cast<float*>(ring + STAGES * T::SLOT);  // [parity][L2, D][BQ]
  const int bh = blockIdx.y, k0 = blockIdx.x * T::BKV, c0 = blockIdx.z * T::CSB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int rt = warp / SPLIT, sp = warp % SPLIT, cw0 = c0 + sp * T::CW;
  const Head<bf16> q(a, 0, bh), k(a, 1, bh), v(a, 2, bh), dout(a, 3, bh);
  const float* lb = a.lse + (long long)bh * n;
  const float* db = a.dd + (long long)bh * n;
  const int nc = (d + KC - 1) / KC;                    // score chunks
  const int nv = min(T::NCW, (d - c0 + KC - 1) / KC);  // slice chunks
  const int tiles = (n + BQ - 1) / BQ;
  // L2 and D of q tile j into the statistics of parity j & 1
  auto copy_stats = [&](int j) {
    float* st = stats + (j & 1) * 2 * BQ;
    for (int i = threadIdx.x; i < 2 * BQ; i += T::THREADS) {
      const int r = j * BQ + i % BQ;
      const float* src = i < BQ ? lb : db;
      cp_async4(st + i, r < n ? src + r : src, r < n);
    }
  };
  float dk[T::NO][4], dv[T::NO][4];
  zero(dk);
  zero(dv);
  const int arow = (rt * 16 + lane % 16) * pk + (lane / 16) * 8;
  // rows are keys (g, g + 8), columns queries (2t, 2t + 1 of each n8
  // tile): S^T becomes round(P^T) and dP^T round(dS^T) as A fragments
  auto p_ds = [&](float (&s)[T::NT][4], float (&dps)[T::NT][4], int j,
                  uint32_t (&pf)[T::NT / 2][4], uint32_t (&dsf)[T::NT / 2][4]) {
    const float* st = stats + (j & 1) * 2 * BQ;
    const int qv = n - j * BQ;  // valid queries of this tile
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(st + nt * 8 + 2 * t);
      const float2 dd = *reinterpret_cast<const float2*>(st + BQ + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] - ((e & 1) ? l2.y : l2.x));
        if (nt * 8 + 2 * t + (e & 1) >= qv) p = 0.f;
        s[nt][e] = p;
        dps[nt][e] = p * (dps[nt][e] - ((e & 1) ? dd.y : dd.x)) * a.scale;
      }
    }
    pack_a<T::NT>(pf, s);
    pack_a<T::NT>(dsf, dps);
  };

  // K and V of the block's rows land with the first item
  copy_tile(sK, pk, k.p, k.rs, k0, T::BKV, 0, dp, n, d, lw, T::THREADS);
  copy_tile(sV, pk, v.p, v.rs, k0, T::BKV, 0, dp, n, d, lw, T::THREADS);
  // The ring as the forward's: chunk pc of q tile pj, q and dO of a score
  // chunk (the first nc; the first also L2 and D), then q and dO of chunk
  // pc - nc of each split's columns, into slot ps; consumed from slot cs
  const int per_tile = nc + nv;
  int pj = 0, pc = 0, ps = 0, cs = 0;
  auto issue = [&]() {
    if (pj < tiles) {
      bf16* slot = ring + ps * T::SLOT;
      if (pc < nc) {
        copy_panel<BQ, T::THREADS>(slot, q.p, q.rs, pj * BQ, pc * KC, n, d, lw);
        copy_panel<BQ, T::THREADS>(slot + BQ * PITCH, dout.p, dout.rs, pj * BQ, pc * KC, n, d,
                                   lw);
        if (pc == 0) copy_stats(pj);
      } else {
#pragma unroll
        for (int sp2 = 0; sp2 < SPLIT; ++sp2) {
          const int col = c0 + sp2 * T::CW + (pc - nc) * KC;
          copy_panel<BQ, T::THREADS>(slot + 2 * sp2 * BQ * PITCH, q.p, q.rs, pj * BQ, col, n,
                                     d, lw);
          copy_panel<BQ, T::THREADS>(slot + (2 * sp2 + 1) * BQ * PITCH, dout.p, dout.rs,
                                     pj * BQ, col, n, d, lw);
        }
      }
      if (++pc == per_tile) pc = 0, ++pj;
    }
    ps = ps + 1 == STAGES ? 0 : ps + 1;
    cp_async_commit();
  };
  auto arrive = [&](bool scores) {
    cp_async_wait<STAGES - 2>();
    bf16* slot = ring + cs * T::SLOT;
    if (scores) prescale_own<BQ, T::THREADS>(slot, lw, a.scale_log2);
    __syncthreads();
    issue();
    cs = cs + 1 == STAGES ? 0 : cs + 1;
    return slot;
  };
#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) issue();
  for (int j = 0; j < tiles; ++j) {
    float s[T::NT][4], dps[T::NT][4];
    zero(s);
    zero(dps);
    for (int c = 0; c < nc; ++c) {
      const bf16* slot = arrive(true);
      const int ks = min(KC, dp - c * KC) / 16;
      chunk_scores<T::NT>(s, sK + arow + c * KC, slot, ks);                 // S^T = K q2^T
      chunk_scores<T::NT>(dps, sV + arow + c * KC, slot + BQ * PITCH, ks);  // dP^T = V dO^T
    }
    uint32_t pf[T::NT / 2][4], dsf[T::NT / 2][4];
    p_ds(s, dps, j, pf, dsf);
    for (int vc = 0; vc < nv; ++vc) {  // dV += P^T dO, dK += dS^T Q
      const bf16* slot = arrive(false) + 2 * sp * BQ * PITCH;
      const int dvalid = d - cw0 - vc * KC;
#pragma unroll
      for (int u = 0; u < T::NCW; ++u) {  // chunk vc's tiles, at compile-time indices
        if (u == vc) {
          pv_chunk<T::NT / 2, T::NO>(dv, pf, slot + BQ * PITCH, u * (KC / 8), dvalid);
          pv_chunk<T::NT / 2, T::NO>(dk, dsf, slot, u * (KC / 8), dvalid);
        }
      }
    }
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_tiles<T::NO>(dk, one, a.out[0], a, bh, k0 + rt * 16, cw0);
  store_tiles<T::NO>(dv, one, a.out[1], a, bh, k0 + rt * 16, cw0);
}

// dQ's tiles: WARPS warps of 16 query rows, key tiles of BK, output
// columns [CS z, CS z + CS) of block z. Shared memory: the block's q2 and
// dO rows at the padded head dim (pitch dp + 8), then the ring, whose slots
// hold the K and V panels of a score chunk, or the K panel of a chunk of
// the slice.
template <int WARPS, int CS>
struct DqMma {
  static constexpr int THREADS = 32 * WARPS, BQ = 16 * WARPS, BK = 64;
  static constexpr int NT = BK / 8;   // n8 tiles of S and dP
  static constexpr int NO = CS / 8;   // n8 tiles of dQ
  static constexpr int NV = CS / KC;  // K chunks of a whole slice
  static constexpr int SLOT = 2 * BK * PITCH;  // bf16 elements
  static_assert(CS % KC == 0, "tile");
  static __host__ __device__ constexpr size_t smem(int dp) {
    return (2 * size_t(BQ) * (dp + 8) + size_t(STAGES) * SLOT) * 2;
  }
};

template <int WARPS, int CS>
__global__ void __launch_bounds__(32 * WARPS, 1) flash_bwd_dq_anyd_mma(const Args<bf16> a) {
  using T = DqMma<WARPS, CS>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, c0 = blockIdx.z * CS;
  const int n = a.N, d = a.D, lw = a.lw, dp = (d + 15) / 16 * 16, pq = dp + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + T::BQ * pq;
  bf16* ring = sO + T::BQ * pq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const Head<bf16> q(a, 0, bh), k(a, 1, bh), v(a, 2, bh), dout(a, 3, bh);
  const int nc = (d + KC - 1) / KC;                // score chunks of a key tile
  const int nv = (min(CS, d - c0) + KC - 1) / KC;  // K chunks of this slice
  const int per_tile = nc + nv, tiles = (n + T::BK - 1) / T::BK;
  // L2 and D of this lane's rows g and g + 8 (0 past n, where q2 and dO are
  // zeros and dS comes out 0)
  const int row0 = q0 + warp * 16;
  float l2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + lane / 4 + 8 * i;
    l2[i] = row < n ? a.lse[(long long)bh * n + row] : 0.f;
    dd[i] = row < n ? a.dd[(long long)bh * n + row] : 0.f;
  }
  float o[T::NO][4];
  zero(o);
  const int arow = (warp * 16 + lane % 16) * pq + (lane / 16) * 8;
  // The ring as the forward's: chunk pc of key tile pj, K and V of a score
  // chunk (the first nc), then K of chunk pc - nc of the slice, into slot
  // ps; consumed from slot cs
  int pj = 0, pc = 0, ps = 0, cs = 0;
  auto issue = [&]() {
    if (pj < tiles) {
      bf16* slot = ring + ps * T::SLOT;
      if (pc < nc) {
        copy_panel<T::BK, T::THREADS>(slot, k.p, k.rs, pj * T::BK, pc * KC, n, d, lw);
        copy_panel<T::BK, T::THREADS>(slot + T::BK * PITCH, v.p, v.rs, pj * T::BK, pc * KC, n,
                                      d, lw);
      } else {
        copy_panel<T::BK, T::THREADS>(slot, k.p, k.rs, pj * T::BK, c0 + (pc - nc) * KC, n, d,
                                      lw);
      }
      if (++pc == per_tile) pc = 0, ++pj;
    }
    ps = ps + 1 == STAGES ? 0 : ps + 1;
    cp_async_commit();
  };
  auto arrive = [&]() {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue();
    const bf16* slot = ring + cs * T::SLOT;
    cs = cs + 1 == STAGES ? 0 : cs + 1;
    return slot;
  };

  // q and dO land with the first item; each thread makes q2 of the pieces
  // it copied (bit for bit the forward's q2), which the first item's
  // barrier shows every thread
  copy_tile(sQ, pq, q.p, q.rs, q0, T::BQ, 0, dp, n, d, lw, T::THREADS);
  copy_tile(sO, pq, dout.p, dout.rs, q0, T::BQ, 0, dp, n, d, lw, T::THREADS);
#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) issue();
  cp_async_wait<STAGES - 2>();
  prescale_tile(sQ, pq, T::BQ, dp, lw, T::THREADS, a.scale_log2);
  for (int j = 0; j < tiles; ++j) {
    float s[T::NT][4], dps[T::NT][4];
    zero(s);
    zero(dps);
    for (int c = 0; c < nc; ++c) {
      const bf16* slot = arrive();
      const int ks = min(KC, dp - c * KC) / 16;
      chunk_scores<T::NT>(s, sQ + arow + c * KC, slot, ks);                  // S = q2 K^T
      chunk_scores<T::NT>(dps, sO + arow + c * KC, slot + T::BK * PITCH, ks);  // dP = dO V^T
    }
    // P = exp2(S - L2), 0 at keys past n; dS = P (dP - D) d^-1/2, rounded
    // to bf16 as the A fragments of dS K (rows the lane's g, g + 8)
    const int kv = n - j * T::BK;
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] - l2[e / 2]);
        if (nt * 8 + 2 * t + (e & 1) >= kv) p = 0.f;
        s[nt][e] = p * (dps[nt][e] - dd[e / 2]) * a.scale;
      }
    uint32_t dsf[T::NT / 2][4];
    pack_a<T::NT>(dsf, s);
    for (int vc = 0; vc < nv; ++vc) {  // dQ += dS K, a chunk of the slice at a time
      const bf16* slot = arrive();
      const int dv = d - c0 - vc * KC;
#pragma unroll
      for (int u = 0; u < T::NV; ++u)  // chunk vc's dQ tiles, at compile-time indices
        if (u == vc) pv_chunk<T::NT / 2, T::NO>(o, dsf, slot, u * (KC / 8), dv);
    }
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_tiles<T::NO>(o, one, a.out[0], a, bh, row0, c0);
}

// --- fp32: dK/dV with S^T on FMA and the products on 3xTF32 mma.sync ------

constexpr int PF = KC + 4;  // fp32 row pitch of a chunk's panel: conflict-free loads
// the fp32 dK/dV's row tiles of 16 keys a block where K and V fit beside
// the ring (chosen by timing, the file's header)
constexpr int kDkvF32Rows = 4;

__device__ __forceinline__ void fma4(float& acc, const float4& x, const float4& y) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  acc = fmaf(x.w, y.w, acc);
}

// s += A B^T over the chunk's kn columns (a multiple of 4) on FMA, in
// mma_tf32's C layout: s[nt][e] += A[g + 8 (e / 2)][c] B[8 nt + 2t + e % 2][c]
// for 16 rows of A (pitch lda) and 8 NT rows of B (a panel), one fmaf a
// column in column order: with s at 0 before column 0, each score is one
// fmaf chain over the head dim, score_chunk's order, so S^T is the fp32
// forward's S bit for bit
template <int NT>
__device__ __forceinline__ void scores_fma(float (&s)[NT][4], const float* A, int lda,
                                           const float* B, int kn) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* a0 = A + g * lda;
  const float* b = B + 2 * t * PF;
  auto step = [&](int c) {
    const float4 x0 = ld4(a0 + c), x1 = ld4(a0 + 8 * lda + c);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 y0 = ld4(b + 8 * nt * PF + c), y1 = ld4(b + (8 * nt + 1) * PF + c);
      fma4(s[nt][0], x0, y0);
      fma4(s[nt][1], x0, y1);
      fma4(s[nt][2], x1, y0);
      fma4(s[nt][3], x1, y1);
    }
  };
  if (kn == KC) {
#pragma unroll
    for (int c = 0; c < KC; c += 4) step(c);
  } else {
    for (int c = 0; c < kn; c += 4) step(c);
  }
}

// s += A B^T over the chunk's kn columns (k8 steps) in 3xTF32, into one
// pair of zeroed partials that then join s in fp32 (at most KC / 8 = 8
// steps a partial: the tensor cores add with truncation); operands and
// result as scores_fma's
template <int NT>
__device__ __forceinline__ void scores_tf32(float (&s)[NT][4], const float* A, int lda,
                                            const float* B, int kn) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* a = A + g * lda + t;
  const float* b = B + g * PF + t;
  float big[NT][4], small[NT][4];
  zero(big);
  zero(small);
  auto step = [&](int k) {
    uint32_t ah[4], al[4];
    split_tf32(a[k], ah[0], al[0]);
    split_tf32(a[8 * lda + k], ah[1], al[1]);
    split_tf32(a[k + 4], ah[2], al[2]);
    split_tf32(a[8 * lda + k + 4], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
      split_tf32(b[8 * nt * PF + k], bh[0], bl[0]);
      split_tf32(b[8 * nt * PF + k + 4], bh[1], bl[1]);
      mma_3xtf32(big[nt], small[nt], ah, al, bh, bl);
    }
  };
  if (kn == KC) {
#pragma unroll
    for (int k = 0; k < KC; k += 8) step(k);
  } else {
    for (int k = 0; k < kn; k += 8) step(k);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] += big[nt][e] + small[nt][e];
}

// o[base + j] += A X for the KC / 8 n8 tiles j of one chunk in 3xTF32: A
// a C-layout tile of NT n8 tiles (x), X an (8 NT x PF) panel of those
// rows. Slot t of k8 step ks takes column 8 ks + 2t and slot t + 4 column
// 8 ks + 2t + 1, so the C fragment is the A fragment as it stands (the B
// rows follow the same order); A splits into hi and lo at each use, and
// all three products of the NT steps go into one zeroed partial a tile
// (lo hi, hi lo, hi hi), then joined in fp32: held split, or in two
// partials, A spilled beside the 128 registers of a 256-column o. Columns
// past d are zeros in X, never stored.
template <int NT, int NO>
__device__ __forceinline__ void pv_tf32(float (&o)[NO][4], const float (&x)[NT][4],
                                        const float* panel, int base) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* r = panel + 2 * t * PF + g;
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      uint32_t bh[2], bl[2];
      split_tf32(r[8 * ks * PF + 8 * j], bh[0], bl[0]);
      split_tf32(r[(8 * ks + 1) * PF + 8 * j], bh[1], bl[1]);
      uint32_t ah[4], al[4];
      split_tf32(x[ks][0], ah[0], al[0]);  // row g, column 2t
      split_tf32(x[ks][2], ah[1], al[1]);  // row g + 8, column 2t
      split_tf32(x[ks][1], ah[2], al[2]);  // row g, column 2t + 1
      split_tf32(x[ks][3], ah[3], al[3]);  // row g + 8, column 2t + 1
      mma_3xtf32(part, part, ah, al, bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[base + j][e] += part[e];
  }
}

// o[base + j] = o[base + j] alpha_u + P_u X_u for the KC / 8 n8 tiles j of
// one V panel in 3xTF32, over the key blocks u of NTS n8 tiles that make up
// a tile of NT (alpha_u never read where RESCALE is false): P the
// forward's C-layout tile (NT n8 tiles, the k8 steps), X the (8 NT x PF)
// panel of its keys (pv_tf32's operands and order); the panel's n8 tiles
// in two halves of four, and for each k8
// step by k8 step, P's fragment split once a step a half and each n8 tile
// into its own zeroed partial (four independent chains of mma), the
// partials joining o after a run of at most 8 steps (64 keys) within a
// block. Columns past d are zeros in X, never stored.
template <int NT, int NTS, bool RESCALE, int NO>
__device__ __forceinline__ void pv_panel_tf32(float (&o)[NO][4], const float (&x)[NT][4],
                                              const float* panel, int base,
                                              const float (&alpha)[NT / NTS][2]) {
  constexpr int RUN = NTS < 8 ? NTS : 8;  // k8 steps a partial
  static_assert(NT % NTS == 0 && NTS % RUN == 0, "steps");
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* r = panel + 2 * t * PF + g;
#pragma unroll
  for (int k0 = 0; k0 < NT; k0 += RUN) {
#pragma unroll
    for (int j0 = 0; j0 < KC / 8; j0 += 4) {
      float part[4][4];
      zero(part);
#pragma unroll
      for (int ks = k0; ks < k0 + RUN; ++ks) {
        uint32_t ah[4], al[4];
        split_tf32(x[ks][0], ah[0], al[0]);  // row g, key 2t
        split_tf32(x[ks][2], ah[1], al[1]);  // row g + 8, key 2t
        split_tf32(x[ks][1], ah[2], al[2]);  // row g, key 2t + 1
        split_tf32(x[ks][3], ah[3], al[3]);  // row g + 8, key 2t + 1
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh[2], bl[2];
          split_tf32(r[8 * ks * PF + 8 * (j0 + j)], bh[0], bl[0]);
          split_tf32(r[(8 * ks + 1) * PF + 8 * (j0 + j)], bh[1], bl[1]);
          mma_3xtf32(part[j], part[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& y = o[base + j0 + j][e];
          if (RESCALE && k0 % NTS == 0) y *= alpha[k0 / NTS][e / 2];
          y += part[j][e];
        }
    }
  }
}

// The forward's S of a warp's 16 rows and 8 NT keys on FMA, summed by lane
// pairs: lane (g, t), p = g % 2, and its partner (g ^ 1, t) each take the
// four rows g, g + 8, g ^ 1, g ^ 1 + 8 over keys 2t and 2t + 1 of the n8
// tiles 2m + p (m < NT / 2), so a lane reads 12 shared-memory values a
// column for 32 fmaf (scores_fma's C layout reads 18: two rows and 16
// keys). Each score is one fmaf chain over the head dim in column order,
// scores_fma's bits. The sums stand in the registers of the C layout's
// tile, s[2m] the lane's own rows (g, key 2t + p; g, 2t + 1 - p; g + 8,
// 2t + p; g + 8, 2t + 1 - p), s[2m + 1] the same of the partner's rows g ^
// 1, g ^ 1 + 8, and pair_to_c swaps them into the C layout in place. A key
// pair is read 2t + p first, so the eight lanes of a quarter warp read
// eight rows of a K panel that differ mod 8 (no bank conflict at pitch PF).
template <int NT>
__device__ __forceinline__ void scores_pair_fma(float (&w)[NT][4], const float* A, int lda,
                                                const float* B, int kn) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, p = g % 2;
  const float* a0 = A + g * lda;
  const float* a1 = A + (g ^ 1) * lda;
  const float* b0 = B + (8 * p + 2 * t + p) * PF;
  const float* b1 = B + (8 * p + 2 * t + 1 - p) * PF;
  auto step = [&](int c) {
    const float4 u0 = ld4(a0 + c), u1 = ld4(a0 + 8 * lda + c);
    const float4 v0 = ld4(a1 + c), v1 = ld4(a1 + 8 * lda + c);
    const float x[4][4] = {{u0.x, u0.y, u0.z, u0.w}, {u1.x, u1.y, u1.z, u1.w},
                           {v0.x, v0.y, v0.z, v0.w}, {v1.x, v1.y, v1.z, v1.w}};
#pragma unroll
    for (int m = 0; m < NT / 2; ++m) {
      const float4 y0 = ld4(b0 + 16 * m * PF + c), y1 = ld4(b1 + 16 * m * PF + c);
      const float y[2][4] = {{y0.x, y0.y, y0.z, y0.w}, {y1.x, y1.y, y1.z, y1.w}};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int r = 0; r < 4; ++r)  // own g, own g + 8, partner's, partner's + 8
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            float& acc = w[2 * m + r / 2][2 * (r % 2) + k];
            acc = fmaf(x[r][cc], y[k][cc], acc);
          }
    }
  };
  if constexpr (NT > 8) {  // S of 128 keys: one step's operands at a time (two spilled)
#pragma unroll 1
    for (int c = 0; c < kn; c += 4) step(c);
  } else {
#pragma unroll 2
    for (int c = 0; c < kn; c += 4) step(c);
  }
}

// scores_pair_fma's sums into mma_tf32's C layout, in place: each lane
// hands its partner (lane ^ 4) the partner's rows and takes its own rows of
// the partner's tiles (4 shuffles a tile pair), then picks by p
template <int NT>
__device__ __forceinline__ void pair_to_c(float (&s)[NT][4]) {
  const bool p = (threadIdx.x / 4) % 2;
#pragma unroll
  for (int m = 0; m < NT / 2; ++m) {
    float w[4], r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      w[e] = s[2 * m][e];
      r[e] = __shfl_xor_sync(0xffffffffu, s[2 * m + 1][e], 4);
    }
    // own tile 2m + p, the partner's 2m + 1 - p; r: (g, 2t + 1 - p), (g,
    // 2t + p), (g + 8, 2t + 1 - p), (g + 8, 2t + p)
    s[2 * m][0] = p ? r[0] : w[0];
    s[2 * m][1] = p ? r[1] : w[1];
    s[2 * m][2] = p ? r[2] : w[2];
    s[2 * m][3] = p ? r[3] : w[3];
    s[2 * m + 1][0] = p ? w[1] : r[1];
    s[2 * m + 1][1] = p ? w[0] : r[0];
    s[2 * m + 1][2] = p ? w[3] : r[3];
    s[2 * m + 1][3] = p ? w[2] : r[2];
  }
}

// The fp32 forward's tiles (chosen by timing, the file's header): warps of
// 16 query rows a block, and output columns a block past d = 128 (128 up to
// it; fwd_tf32_plan narrows it at tiles of 128 keys and where q2 streams)
constexpr int kFwdF32Warps = 8;
constexpr int kFwdF32Slice = 256;

// WARPS warps of 16 query rows, key blocks (K3) or chunks (K4, TWO_PASS)
// of BK keys taken PK keys a tile: 64, or K3's block of 128 (S of 64 keys
// keeps the lane pairs' tiles of 4 rows x 8 keys; a tile of 64 is two
// blocks of 32, and K4, whose chunks only bound its partials, takes a chunk
// of 128 as two tiles: S of 128 keys beside O spills), output columns [CS
// z, CS z + CS) of block z. Shared memory (floats): with QRES the block's q2
// rows at pitch dp + 4 (dp = d padded to 8), then the ring, whose slots
// hold a K panel (with its chunk's q2 panel where q2 is not resident) or a
// V panel of PK rows x KC columns at pitch PF.
template <int WARPS, int CS, int BK, bool QRES, bool TWO_PASS>
struct FwdTf32 {
  static constexpr int THREADS = 32 * WARPS, BQ = 16 * WARPS;
  static constexpr int PK = BK < 64 || TWO_PASS ? 64 : BK;  // keys a tile
  static constexpr int NT = PK / 8;   // n8 tiles of S, k8 steps of P V
  static constexpr int NTS = (BK < PK ? BK : PK) / 8;  // ... of a key block (in a tile)
  static constexpr int NO = CS / 8;   // n8 tiles of O
  static constexpr int NV = CS / KC;  // V chunks of a whole slice
  static constexpr int SLOT = (QRES ? PK : PK + BQ) * PF;
  static_assert(CS % KC == 0 && (BK == 32 || BK == 64 || BK == 128), "tile");
  static __host__ __device__ constexpr size_t smem(int dp) {
    return ((QRES ? size_t(BQ) * (dp + 4) : 0) + size_t(STAGES) * SLOT) * 4;
  }
};

// 2^x for the softmax of a tile: exp2f, or at tiles of 128 keys (FTZ)
// ex2.approx.ftz, whose results below 2^-126 are 0 where exp2f's fix-up of
// them (a scaled input, a squared result) kept 64 values' temporaries live
// and spilled l
template <bool FTZ>
__device__ __forceinline__ float exp2_tile(float x) {
  if constexpr (FTZ) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  } else {
    return exp2f(x);
  }
}

// K3's online-softmax steps at fp32 for one warp's 16 rows over a tile of
// NT n8 tiles, S in the C layout with kv valid keys, a step a key block of
// NTS n8 tiles: the keys past kv masked, the new max m over the quad,
// alpha_u = exp2(m_old - m_new) for the block (O is rescaled by it where
// P V meets it, pv_panel_tf32) and l rescaled, this thread's share of
// rowsum(P) added to l (summed over the quad at the end), and P = exp2(S -
// m) left in s
template <int NT, int NTS>
__device__ __forceinline__ void softmax_steps_f32(float (&s)[NT][4], float (&alpha)[NT / NTS][2],
                                                  float (&m)[2], float (&l)[2], int kv) {
  mask_keys<NT>(s, kv);
#pragma unroll
  for (int u = 0; u < NT / NTS; ++u) {
    float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = u * NTS; nt < (u + 1) * NTS; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    quad_max(mx);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[u][i] = exp2_tile<(NT > 8)>(m[i] - mx[i]);  // 0 at the first block (m = -inf), 1 past n
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = u * NTS; nt < (u + 1) * NTS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2_tile<(NT > 8)>(s[nt][e] - m[e / 2]);
        sum[e / 2] += s[nt][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[u][i] + sum[i];
  }
}

// One block of the fp32 forward: K1/K2/K3 (TWO_PASS false) or K4, query
// rows q0 = BQ blockIdx.x of head blockIdx.y, output columns from CS
// blockIdx.z. A warp owns 16 query rows: S = q2 K^T of a tile of PK keys
// on FMA (scores_pair_fma, chunk by chunk from column 0: each score one
// fmaf chain over the head dim, the SIMT dQ's score_chunk order), turned
// into mma_tf32's C layout (pair_to_c), its row statistics over the quad
// and m, l and O in registers; P stays in the C layout as the A fragments
// of P V in 3xTF32 (pv_panel_tf32, one partial a run of up to 64 keys).
// K3 is one online-softmax step a key block of BK (the any-head-dim
// forward is K3 at BK = 64); K4 takes S and the row max over the tiles,
// then S again (bit for bit the first), P = exp2(S - m_final) and O += P V
// a tile, never rescaled.
template <int WARPS, int CS, int BK, bool QRES, bool TWO_PASS>
__device__ __forceinline__ void fwd_tf32(const Args<float>& a) {
  using T = FwdTf32<WARPS, CS, BK, QRES, TWO_PASS>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, c0 = blockIdx.z * CS;
  const int n = a.N, d = a.D, lw = a.lw, dp = (d + 7) / 8 * 8;
  const int pq = QRES ? dp + 4 : PF;  // q2's row pitch
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* ring = sQ + (QRES ? T::BQ * pq : 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = (d + KC - 1) / KC;                // score chunks of a key tile
  const int nv = (min(CS, d - c0) + KC - 1) / KC;  // V chunks of this slice
  const int tiles = (n + T::PK - 1) / T::PK;

  // The ring, as fwd_mma's: K4's first pass brings the nc K panels of each
  // key chunk (pass 0), then K3's only pass and K4's second (pass 1) the nc
  // K panels and the nv V panels of each, panel pc of key tile pj, into
  // slot ps, one cp.async group a panel (empty past the last); a K panel
  // brings its chunk's q panel too where q2 is not resident. The item
  // consumed is in slot cs. The heads are found again at each copy, from
  // the launch's arguments, and the copies stay loops, to keep the loop's
  // registers for O and P (the kernels run at up to 255 registers, where
  // unrolled copies' addresses spilled).
  int pass = TWO_PASS ? 0 : 1, pj = 0, pc = 0, ps = 0, cs = 0;
  auto issue = [&]() {
    if (pj < tiles) {
      float* slot = ring + ps * T::SLOT;
      const Head<float> src(a, pc < nc ? 1 : 2, bh);
      const int col = pc < nc ? pc * KC : c0 + (pc - nc) * KC;
      copy_panel<T::PK, T::THREADS, float, false>(slot, src.p, src.rs, pj * T::PK, col, n, d, lw);
      if constexpr (!QRES) {
        if (pc < nc) {
          const Head<float> q(a, 0, bh);
          copy_panel<T::BQ, T::THREADS, float, false>(slot + T::PK * PF, q.p, q.rs, q0, col, n, d,
                                                      lw);
        }
      }
      if (++pc == (!TWO_PASS || pass ? nc + nv : nc)) {
        pc = 0;
        if (++pj == tiles && TWO_PASS && pass == 0) pj = 0, pass = 1;
      }
    }
    ps = ps + 1 == STAGES ? 0 : ps + 1;
    cp_async_commit();
  };
  // the next item has landed (a streamed q panel made q2 by the threads
  // that copied it, bit for bit the resident prescale): visible to every
  // thread after the barrier, by which every thread is also done with the
  // item before, whose slot the next issue takes -> the item's slot
  auto arrive = [&](bool score) {
    cp_async_wait<STAGES - 2>();
    float* slot = ring + cs * T::SLOT;
    if constexpr (!QRES) {
      if (score) prescale_own<T::BQ, T::THREADS>(slot + T::PK * PF, lw, a.scale_log2);
    }
    __syncthreads();
    issue();
    cs = cs + 1 == STAGES ? 0 : cs + 1;
    return slot;
  };
  // S = q2 K^T of the next key tile, chunk by chunk from column 0
  auto scores = [&](float (&s)[T::NT][4]) {
    zero(s);
    for (int c = 0; c < nc; ++c) {
      const float* slot = arrive(true);
      const float* qa = QRES ? sQ + warp * 16 * pq + c * KC : slot + (T::PK + warp * 16) * PF;
      scores_pair_fma<T::NT>(s, qa, pq, slot, min(KC, dp - c * KC));
    }
    pair_to_c<T::NT>(s);
  };
  float o[T::NO][4];
  // O = O alpha + P V a key block, a V panel of the slice at a time
  auto pv = [&](const float (&p)[T::NT][4], const float (&alpha)[T::NT / T::NTS][2]) {
    for (int vc = 0; vc < nv; ++vc) {
      const float* slot = arrive(false);
#pragma unroll
      for (int u = 0; u < T::NV; ++u)  // chunk vc's O tiles, at compile-time indices
        if (u == vc)
          pv_panel_tf32<T::NT, T::NTS, !TWO_PASS>(o, p, slot, u * (KC / 8), alpha);
    }
  };

  if constexpr (QRES) {  // q lands with the first item, q2 made by the threads that copied it
    const Head<float> q(a, 0, bh);
    copy_tile(sQ, pq, q.p, q.rs, q0, T::BQ, 0, dp, n, d, lw, T::THREADS);
  }
#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) issue();
  if constexpr (QRES) {
    cp_async_wait<STAGES - 2>();
    prescale_tile(sQ, pq, T::BQ, dp, lw, T::THREADS, a.scale_log2);
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if constexpr (TWO_PASS) {
    for (int j = 0; j < tiles; ++j) {  // pass 1: this thread's share of the row max
      float s[T::NT][4];
      scores(s);
      mask_keys<T::NT>(s, n - j * T::PK);
      row_max<T::NT>(s, m);
    }
    quad_max(m);
    zero(o);  // (here, so that pass 1 runs without O's registers live)
    for (int j = 0; j < tiles; ++j) {  // pass 2: P against the final max
      float s[T::NT][4];
      scores(s);
      mask_keys<T::NT>(s, n - j * T::PK);
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2f(s[nt][e] - m[e / 2]);
          l[e / 2] += s[nt][e];
        }
      const float unused[T::NT / T::NTS][2] = {};  // K4 is never rescaled
      pv(s, unused);
    }
  } else {
    zero(o);
    for (int j = 0; j < tiles; ++j) {  // the online softmax, a step a key block
      float s[T::NT][4], alpha[T::NT / T::NTS][2];
      scores(s);
      softmax_steps_f32<T::NT, T::NTS>(s, alpha, m, l, n - j * T::PK);
      pv(s, alpha);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int row0 = q0 + warp * 16;
  store_tiles<T::NO>(o, l, a.out[0], a, bh, row0, c0);
  if (a.lse_out != nullptr && blockIdx.z == 0 && lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + lane / 4 + 8 * i;
      if (row < n) a.lse_out[(long long)bh * n + row] = m[i] + log2f(l[i]);
    }
  }
}

// The fp32 forward (K1/K2): key tiles of 64
template <int WARPS, int CS, bool QRES>
__global__ void __launch_bounds__(32 * WARPS, 1) flash_fwd_anyd_tf32(const Args<float> a) {
  fwd_tf32<WARPS, CS, 64, QRES, false>(a);
}

template <bool V>
using Bool = std::integral_constant<bool, V>;

// The fp32 forward's launch plan at key block BK (K4's where TWO_PASS):
// go(Int<WARPS>, Int<CS>, Bool<QRES>) launches the kernel of FwdTf32<WARPS,
// CS, BK, QRES, TWO_PASS>'s tiles. kFwdF32Warps warps, or 4 at N <= 64 (one
// block holds every row); the output slice of 128 columns up to d = 128
// and at tiles of 128 keys (S of 128 keys beside 256 accumulator columns
// would leave no registers), else kFwdF32Slice; q2 resident where its rows
// fit beside the ring (d <= 344 at 8 warps and tiles of 64 keys, 240 at
// 128), else streamed with the K panels by kFwdF32Warps warps, in a slice
// of 192 columns for 256 (or, at tiles of 128 keys, half of 128).
template <int BK, bool TWO_PASS, typename Go>
cudaError_t fwd_tf32_plan(const Args<float>& a, Go go) {
  constexpr int W = kFwdF32Warps, PK = FwdTf32<W, 128, BK, true, TWO_PASS>::PK;
  const int dp = (a.D + 7) / 8 * 8;
  auto slice = [&](auto warps, auto cs) {
    constexpr int WR = decltype(warps)::value, C = decltype(cs)::value;
    // the streamed q panels' copies add to the loop's registers, which a
    // narrower slice gives back (at 256 and 128 columns they spilled), and
    // 8 warps (4 spilled too at tiles of 128 keys)
    constexpr int CQ = PK == 128 ? C / 2 : C == 256 ? 192 : C;
    static_assert(FwdTf32<W, CQ, BK, false, TWO_PASS>::smem(0) <= SMEM_MAX, "the streamed ring");
    if (FwdTf32<WR, C, BK, true, TWO_PASS>::smem(dp) <= SMEM_MAX)
      return go(warps, cs, Bool<true>{});
    return go(Int<W>{}, Int<CQ>{}, Bool<false>{});
  };
  auto tiles = [&](auto warps) {
    if constexpr (PK == 128) {
      return slice(warps, Int<128>{});
    } else {
      static_assert(FwdTf32<W, 128, BK, true, TWO_PASS>::smem(128) <= SMEM_MAX,
                    "q2 resident up to d = 128");
      if (a.D <= 128) return go(warps, Int<128>{}, Bool<true>{});
      return slice(warps, Int<kFwdF32Slice>{});
    }
  };
  if (a.N <= 64) return tiles(Int<4>{});
  return tiles(Int<W>{});
}

// one launch of an fp32 forward kernel of FwdTf32<WARPS, CS, BK, QRES,
// TWO_PASS>'s tiles
template <int WARPS, int CS, int BK, bool QRES, bool TWO_PASS>
cudaError_t launch_fwd_tf32_tiles(void (*kern)(Args<float>), cudaError_t attr,
                                  const Args<float>& a, cudaStream_t stream) {
  using T = FwdTf32<WARPS, CS, BK, QRES, TWO_PASS>;
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.N + T::BQ - 1) / T::BQ, a.B * a.H, (a.D + CS - 1) / CS);
  kern<<<grid, T::THREADS, T::smem((a.D + 7) / 8 * 8), stream>>>(a);
  return cudaGetLastError();
}

// The fp32 dK/dV's tiles: RT row tiles of 16 keys, two warps each: warp
// (rt, kind) scores queries [16 kind, + 16) of each q tile of BQ = 32 and
// owns columns [CW z, + CW) of dK (kind 0) or dV (kind 1). Shared memory
// (floats): K and V of the block's rows at pitch dp + 4 (dp = d padded to
// 8), the ring (a slot: the q and dO panels of a chunk), L2 and D of a q
// tile by tile parity, and dS^T and P^T of the block's rows, where a row
// tile's two warps meet.
template <int RT, int CW>
struct DkvTf32 {
  static constexpr int WARPS = 2 * RT, THREADS = 32 * WARPS, BKV = 16 * RT, BQ = 32;
  static constexpr int QW = BQ / 2, NTW = QW / 8;  // queries a warp scores, their n8 tiles
  static constexpr int NT = BQ / 8;                 // k8 steps of a q tile
  static constexpr int NO = CW / 8, NCW = CW / KC;  // n8 tiles and chunks of a warp's columns
  static constexpr int SLOT = 2 * BQ * PF;
  static constexpr int STATS = 2 * 2 * BQ;
  static constexpr int LDX = BQ + 8;  // pitch of dS^T and P^T
  static constexpr int XCH = 2 * BKV * LDX;
  static_assert(CW % KC == 0, "tile");
  static __host__ __device__ constexpr size_t smem(int dp) {
    return (2 * size_t(BKV) * (dp + 4) + size_t(STAGES) * SLOT + STATS + XCH) * 4;
  }
};

template <int RT, int CW>
__global__ void __launch_bounds__(64 * RT, 1) flash_bwd_dkv_anyd_tf32(const Args<float> a) {
  using T = DkvTf32<RT, CW>;
  constexpr int BQ = T::BQ;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int n = a.N, d = a.D, lw = a.lw, dp = (d + 7) / 8 * 8, pk = dp + 4;
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + T::BKV * pk;
  float* ring = sV + T::BKV * pk;
  float* stats = ring + STAGES * T::SLOT;  // [parity][L2, D][BQ]
  float* sX = stats + T::STATS;            // [dS^T, P^T][BKV][LDX]
  const int bh = blockIdx.y, c0 = blockIdx.z * CW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int rt = warp / 2, kind = warp % 2;
  const int nc = (d + KC - 1) / KC;                 // score chunks
  const int nv = (min(CW, d - c0) + KC - 1) / KC;   // chunks of the columns
  const int tiles = (n + BQ - 1) / BQ;
  // the loops' state stays small (the score phase runs beside the 128
  // accumulators of a 256-column warp): the heads and the statistics'
  // rows are found again at each copy, from the launch's arguments
  auto copy_stats = [&](int j) {
    float* st = stats + (j & 1) * 2 * BQ;
    for (int i = threadIdx.x; i < 2 * BQ; i += T::THREADS) {
      const int r = j * BQ + i % BQ;
      const float* src = (i < BQ ? a.lse : a.dd) + (long long)bh * n;
      cp_async4(st + i, r < n ? src + r : src, r < n);
    }
  };
  float acc[T::NO][4];  // dK or dV
  zero(acc);

  {  // K and V of the block's rows land with the first item
    const Head<float> k(a, 1, bh), v(a, 2, bh);
    const int k0 = blockIdx.x * T::BKV;
    copy_tile(sK, pk, k.p, k.rs, k0, T::BKV, 0, dp, n, d, lw, T::THREADS);
    copy_tile(sV, pk, v.p, v.rs, k0, T::BKV, 0, dp, n, d, lw, T::THREADS);
  }
  // The ring: the q and dO panels of chunk pc of q tile pj, a score chunk
  // for the first nc (the first also brings L2 and D), then chunk pc - nc
  // of the block's columns, into slot ps; consumed from slot cs
  const int per_tile = nc + nv;
  int pj = 0, pc = 0, ps = 0, cs = 0;
  auto issue = [&]() {
    if (pj < tiles) {
      const Head<float> q(a, 0, bh), dout(a, 3, bh);
      float* slot = ring + ps * T::SLOT;
      const int col = pc < nc ? pc * KC : c0 + (pc - nc) * KC;
      copy_panel<BQ, T::THREADS>(slot, q.p, q.rs, pj * BQ, col, n, d, lw);
      copy_panel<BQ, T::THREADS>(slot + BQ * PF, dout.p, dout.rs, pj * BQ, col, n, d, lw);
      if (pc == 0) copy_stats(pj);
      if (++pc == per_tile) pc = 0, ++pj;
    }
    ps = ps + 1 == STAGES ? 0 : ps + 1;
    cp_async_commit();
  };
  auto arrive = [&](bool scores) {
    cp_async_wait<STAGES - 2>();
    float* slot = ring + cs * T::SLOT;
    if (scores) prescale_own<BQ, T::THREADS>(slot, lw, a.scale_log2);
    __syncthreads();
    issue();
    cs = cs + 1 == STAGES ? 0 : cs + 1;
    return slot;
  };
#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) issue();
  for (int j = 0; j < tiles; ++j) {
    float st[T::NTW][4], dpt[T::NTW][4];
    zero(st);
    zero(dpt);
    for (int c = 0; c < nc; ++c) {
      const float* slot = arrive(true) + kind * T::QW * PF;
      const int kn = min(KC, dp - c * KC);
      const int kv = rt * 16 * pk + c * KC;  // the warp's 16 keys, chunk c
      scores_fma<T::NTW>(st, sK + kv, pk, slot, kn);                // S^T = K q2^T
      scores_tf32<T::NTW>(dpt, sV + kv, pk, slot + BQ * PF, kn);  // dP^T = V dO^T
    }
    // P^T = exp2(S^T - L2[q]), 0 at queries past n; dS^T = P^T (dP^T -
    // D[q]) d^-1/2 (rows keys g, g + 8, columns the warp's queries); both
    // to shared memory, where the next barrier shows them the other warp
    const float* stt = stats + (j & 1) * 2 * BQ + kind * T::QW;
    const int qv = n - j * BQ - kind * T::QW;
#pragma unroll
    for (int nt = 0; nt < T::NTW; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(stt + nt * 8 + 2 * t);
      const float2 dd = *reinterpret_cast<const float2*>(stt + BQ + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(st[nt][e] - ((e & 1) ? l2.y : l2.x));
        if (nt * 8 + 2 * t + (e & 1) >= qv) p = 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? dd.y : dd.x)) * a.scale;
      }
    }
    float* xw = sX + rt * 16 * T::LDX + kind * T::QW;
    store_c<T::NTW, T::LDX>(xw, dpt);
    store_c<T::NTW, T::LDX>(xw + T::BKV * T::LDX, st);
    float x[T::NT][4];  // dS^T (kind 0) or P^T (kind 1) over the q tile
    for (int vc = 0; vc < nv; ++vc) {  // dK += dS^T Q, dV += P^T dO
      const float* slot = arrive(false);
      if (vc == 0) load_c<T::NT, T::LDX>(x, sX + (kind * T::BKV + rt * 16) * T::LDX);
#pragma unroll
      for (int u = 0; u < T::NCW; ++u)  // chunk vc's tiles, at compile-time indices
        if (u == vc) pv_tf32<T::NT, T::NO>(acc, x, slot + kind * BQ * PF, u * (KC / 8));
    }
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_tiles<T::NO>(acc, one, a.out[kind], a, bh, blockIdx.x * T::BKV + rt * 16, c0);
}

// csrc/flash_variants_anyd.cu includes this file for its device code, with
// PBE_ANYD_DEVICE_ONLY defined: the launch plans and entries below stay out
#ifndef PBE_ANYD_DEVICE_ONLY
template <int WARPS, int CS>
cudaError_t launch_fwd_mma(const Args<bf16>& a, cudaStream_t stream) {
  auto kern = flash_fwd_anyd_mma<WARPS, CS>;
  // once per instantiation (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  return launch_fwd_tiles<WARPS, CS, 64>(kern, attr, a, stream);
}

template <int RT, int SPLIT>
cudaError_t launch_dkv_mma(const Args<bf16>& a, int dp, cudaStream_t stream) {
  using T = DkvMma<RT, SPLIT>;
  auto kern = flash_bwd_dkv_anyd_mma<RT, SPLIT>;
  const size_t smem = T::smem(dp);
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.N + T::BKV - 1) / T::BKV, a.B * a.H, (a.D + T::CSB - 1) / T::CSB);
  kern<<<grid, T::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// the launch plans
cudaError_t launch_fwd_bf16(const Args<bf16>& a, cudaStream_t stream) {
  return fwd_mma_plan<64>(a, [&](auto warps, auto cs) {
    return launch_fwd_mma<decltype(warps)::value, decltype(cs)::value>(a, stream);
  });
}

cudaError_t launch_fwd_f32(const Args<float>& a, cudaStream_t stream) {
  return fwd_tf32_plan<64, false>(a, [&](auto warps, auto cs, auto qres) {
    constexpr int W = decltype(warps)::value, C = decltype(cs)::value;
    constexpr bool R = decltype(qres)::value;
    auto kern = flash_fwd_anyd_tf32<W, C, R>;
    static const cudaError_t attr =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    return launch_fwd_tf32_tiles<W, C, 64, R, false>(kern, attr, a, stream);
  });
}

cudaError_t launch_dkv_bf16(const Args<bf16>& a, cudaStream_t stream) {
  const int dp = (a.D + 15) / 16 * 16;
  if (a.D <= 128) return launch_dkv_mma<4, 1>(a, dp, stream);
  if (DkvMma<4, kDkvSplit>::smem(dp) <= SMEM_MAX) return launch_dkv_mma<4, kDkvSplit>(a, dp, stream);
  return launch_dkv_mma<2, kDkvSplit>(a, dp, stream);
}

template <int WARPS, int CS>
cudaError_t launch_dq_mma(const Args<bf16>& a, int dp, cudaStream_t stream) {
  using T = DqMma<WARPS, CS>;
  auto kern = flash_bwd_dq_anyd_mma<WARPS, CS>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.N + T::BQ - 1) / T::BQ, a.B * a.H, (a.D + CS - 1) / CS);
  kern<<<grid, T::THREADS, T::smem(dp), stream>>>(a);
  return cudaGetLastError();
}

// dQ's warps at (N, padded head dim dp): kDqWarps, or 4 at N <= 64 (one
// 64-row block) or where the q2 and dO tiles of 16 kDqWarps rows do not
// fit beside the ring, or 2 where those of 4 warps do not either (with the
// slice past d = 128 only)
template <int CS>
cudaError_t launch_dq_slice(const Args<bf16>& a, int dp, cudaStream_t stream) {
  if (a.N > 64 && DqMma<kDqWarps, CS>::smem(dp) <= SMEM_MAX)
    return launch_dq_mma<kDqWarps, CS>(a, dp, stream);
  if constexpr (CS == kDqSlice)
    if (DqMma<4, CS>::smem(dp) > SMEM_MAX) return launch_dq_mma<2, CS>(a, dp, stream);
  return launch_dq_mma<4, CS>(a, dp, stream);
}

cudaError_t launch_dq_bf16(const Args<bf16>& a, cudaStream_t stream) {
  const int dp = (a.D + 15) / 16 * 16;
  if (a.D <= 128) return launch_dq_slice<128>(a, dp, stream);
  return launch_dq_slice<kDqSlice>(a, dp, stream);
}

template <int RT, int CW>
cudaError_t launch_dkv_tf32(const Args<float>& a, int dp, cudaStream_t stream) {
  using T = DkvTf32<RT, CW>;
  auto kern = flash_bwd_dkv_anyd_tf32<RT, CW>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.N + T::BKV - 1) / T::BKV, a.B * a.H, (a.D + CW - 1) / CW);
  kern<<<grid, T::THREADS, T::smem(dp), stream>>>(a);
  return cudaGetLastError();
}

// the fp32 dK/dV: 128 columns a warp up to d = 128, 256 past it (grid.z
// splits a wider head); kDkvF32Rows row tiles a block, or 2, or 1 where K
// and V of those rows do not fit beside the ring
cudaError_t launch_dkv_f32(const Args<float>& a, cudaStream_t stream) {
  const int dp = (a.D + 7) / 8 * 8;
  if (a.D <= 128) return launch_dkv_tf32<kDkvF32Rows, 128>(a, dp, stream);
  if (DkvTf32<kDkvF32Rows, 256>::smem(dp) <= SMEM_MAX)
    return launch_dkv_tf32<kDkvF32Rows, 256>(a, dp, stream);
  if (DkvTf32<2, 256>::smem(dp) <= SMEM_MAX) return launch_dkv_tf32<2, 256>(a, dp, stream);
  return launch_dkv_tf32<1, 256>(a, dp, stream);
}
#endif  // PBE_ANYD_DEVICE_ONLY

}  // namespace

#ifndef PBE_ANYD_DEVICE_ONLY

// The entries, each with its tuned twin's parameters (csrc/flash_fwd.cu,
// flash_bwd.cu; flash_fp32.cu's for fp32); the bf16 forward, dQ and dK/dV
// run the mma.sync kernels, the fp32 dK/dV the 3xTF32 one, the fp32
// forward and dQ the SIMT ones: q, k, v (and dO) of T (B, N, H,
// D), element strides (batch, seq, head) of each in `st`, a unit head-dim
// stride; outputs (B, N, H, D) contiguous; the LSE and D fp32 (B*H, N);
// scale (the forward) and scale_log2 the q prescale d^-1/2 log2(e), scale
// (the backward) d^-1/2. Launches on `stream`; returns the cudaError_t of
// the launch (cudaErrorInvalidValue for d outside [1, 1024]).
extern "C" int pbe_flash_fwd_anyd_bf16(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int N, int H, int D,
                                       const long long* st, float scale, void* stream) {
  const void* in[3] = {q, k, v};
  Args<bf16> a;
  const cudaError_t err = make_args(&a, in, 3, st, nullptr, nullptr, o, nullptr, lse, B, N, H, D,
                                    scale, 0.f);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fwd_bf16(a, static_cast<cudaStream_t>(stream));
}

extern "C" int pbe_flash_fwd_anyd_f32(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int N, int H, int D,
                                      const long long* st, float scale, void* stream) {
  const void* in[3] = {q, k, v};
  Args<float> a;
  const cudaError_t err = make_args(&a, in, 3, st, nullptr, nullptr, o, nullptr, lse, B, N, H, D,
                                    scale, 0.f);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fwd_f32(a, static_cast<cudaStream_t>(stream));
}

extern "C" int pbe_flash_bwd_dq_anyd_bf16(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* dd,
                                          void* dq, int B, int N, int H, int D,
                                          const long long* st, float scale_log2, float scale,
                                          void* stream) {
  const void* in[4] = {q, k, v, dout};
  Args<bf16> a;
  const cudaError_t err = make_args(&a, in, 4, st, lse, dd, dq, nullptr, nullptr, B, N, H, D,
                                    scale_log2, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dq_bf16(a, static_cast<cudaStream_t>(stream));
}

extern "C" int pbe_flash_bwd_dq_anyd_f32(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* dd,
                                         void* dq, int B, int N, int H, int D,
                                         const long long* st, float scale_log2, float scale,
                                         void* stream) {
  return run_dq<float>(q, k, v, dout, lse, dd, dq, B, N, H, D, st, scale_log2, scale, stream);
}

extern "C" int pbe_flash_bwd_dkv_anyd_bf16(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* dd,
                                           void* dk, void* dv, int B, int N, int H, int D,
                                           const long long* st, float scale_log2, float scale,
                                           void* stream) {
  const void* in[4] = {q, k, v, dout};
  Args<bf16> a;
  const cudaError_t err = make_args(&a, in, 4, st, lse, dd, dk, dv, nullptr, B, N, H, D,
                                    scale_log2, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dkv_bf16(a, static_cast<cudaStream_t>(stream));
}

extern "C" int pbe_flash_bwd_dkv_anyd_f32(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* dd,
                                          void* dk, void* dv, int B, int N, int H, int D,
                                          const long long* st, float scale_log2, float scale,
                                          void* stream) {
  const void* in[4] = {q, k, v, dout};
  Args<float> a;
  const cudaError_t err = make_args(&a, in, 4, st, lse, dd, dk, dv, nullptr, B, N, H, D,
                                    scale_log2, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dkv_f32(a, static_cast<cudaStream_t>(stream));
}
#endif  // PBE_ANYD_DEVICE_ONLY
