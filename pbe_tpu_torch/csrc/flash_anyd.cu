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
// kernels, is one fmaf chain over the head dim from column 0 (score_chunk),
// so the backward recomputes P from the forward's S bit for bit, and every
// output element one fmaf chain over the streamed rows in order. At bf16
// the forward and dK/dV take S on the tensor cores (mma.sync, fp32
// accumulate) in one k-order, chunk by chunk and k16 step by k16 step from
// column 0, so dK/dV's P^T is the forward's P bit for bit; dQ's S stays an
// fmaf chain, so its P = exp2(S - LSE) differs from the forward's P by the
// fp32 rounding of S only, orders below the bf16 rounding of q.
//
// Layout: q, k, v (and dO) are (B, N, H, D) with any (batch, seq, head)
// strides and a unit head-dim stride, read in place: a packed q at d = 28
// has rows of 28 elements. The fp32 kernels and dQ read one element a
// load. The bf16 forward and dK/dV copy pieces of 8, 4, 2 or 1 elements
// (16-, 8- or 4-byte cp.async, or a 2-byte load): the widest that divides
// d and every operand's base and strides (load_log2; a packed view at
// d = 28 or 100 reads 8-byte pieces, a contiguous d = 256 16-byte ones).
// Outputs are (B, N, H, D) contiguous. Rows past N are read as zeros and
// their keys (or queries) masked (P = 0); columns past d are zeros.
//
// The SIMT kernels (fp32: all three; bf16: dQ, whose mma.sync form is
// later work, as are the fp32 products at fp32 accuracy). A block of 256
// threads owns 64 rows (queries for the forward and dQ, keys for dK/dV:
// the JAX pair's grid order, the other side streamed in tiles of 64) and
// up to 256 output columns; a wider head is split over grid.z, each split
// recomputing S. Thread (tr, tc) = (tid / 16, tid % 16) holds rows 4 tr +
// i (i < 4) and, of S, the streamed rows 4 tc + j (j < 4), of the output
// columns 4 tc + 64 g + e (g, e < 4): each operand of a product step is
// one 16-byte shared-memory load (8 FMA a load in S, 12.8 in P V). S (and
// dP) build over the head dim in chunks of 32 columns staged transposed in
// shared memory, the next chunk's loads in flight (in registers) while the
// current one is multiplied; the row statistics are taken over the 16
// threads of a row by shuffles; P (or dS) goes to shared memory, and the
// output tile (or dK and dV), in registers for the whole kernel (64 rows x
// 256 columns: 64 a thread), takes P V in steps of 16 streamed rows, every
// column group alike (columns past d are zeros: branching on d cost more
// than the products it skipped). The forward fits 128 registers, two
// blocks an SM; dQ (S and dP) and dK/dV (two accumulators) run one.
//
// The bf16 forward and dK/dV (flash_fwd_anyd_mma, flash_bwd_dkv_anyd_mma)
// follow the tuned kernels' FlashAttention-2 on mma.sync.m16n8k16 (bf16
// in, fp32 accumulate) with their register layouts (csrc/mma_sm90.cuh):
// a warp owns 16 whole rows, so the row statistics are taken over the
// quad and m and l sit in registers; P (and dS) are rounded to bf16 and
// fed straight back as A fragments (the C layout of two n8 tiles is the A
// layout of a k16 step). The head dim stays a run-time argument, padded to
// a multiple of 16 in shared memory only: the streamed operands come in
// chunks of KC = 64 columns through a cp.async ring of 3 slots (one
// __syncthreads a chunk; the copies of chunk i + 2 in flight while chunk
// i is multiplied), so a slot's size does not grow with d, and S builds
// over the chunks in order.
//   * forward: a block of kFwdWarps warps (4 at N <= 64, or where the q
//     tile does not fit: d > 784) owns 16 kFwdWarps query rows, its q2 tile
//     resident at the padded head dim (made once, by the threads that
//     copied each piece: bit for bit the tuned prescale), and an output
//     slice of 128 columns (d <= 128) or kFwdSlice (a wider head splits
//     over grid.z, each split recomputing S). Per key tile of 64: K's
//     chunks, S in registers, the online-softmax step, then the slice's V
//     chunks, P V into the chunk's O tiles.
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
// Nothing is atomic: each output element has one owner, so a launch is
// bitwise repeatable.
// The tiles are the fastest of `python -m pbe_tpu_torch.scripts
// .sweep_flash_tiles --anyd` at the DDPM shape and at d = 64, 128 and
// 1024 (N = 256, batch 128; PERF.md section 6 has the times): 8 warps
// against 4 tie at d = 256 and win by ~9% at d = 128 (each K and V chunk
// serves twice the query rows); 4 ring slots against 3 tie; a 128-column slice
// against 256 costs 1.4x at d = 256 (S twice) and split 1 against 2 saves
// ~2% of dK/dV at d = 256 but costs 2.2x at 1024 (S per 128 columns).
// What bounds them: at the DDPM UNet's (128, 256, 1, 256) the forward is
// 8.6 GFLOP of products and 67 MB of bf16 operands (0.020 ms at 3.35
// TB/s), dK/dV 17.2 GFLOP and 101 MB: bytes bind both on this card. These
// kernels run several times their byte bound: every warp reads its
// operands through ldmatrix from shared memory (all warps of a block the
// same K chunk), 128 accumulator registers a thread leave 8 warps an SM to
// hide the ldmatrix and mma.sync latencies, each split recomputes S, and
// every block of a head re-reads the streamed operands from L2 (K and V
// each q block, q and dO each key block), which stalls the cp.async issue.
// wgmma (operands read from shared memory once a warpgroup, accumulators
// of 64 rows) is the next step. The SIMT kernels
// are bound by the fp32 FMA rate (67 TFLOP/s). chip_smoke.py phase 29
// times each kernel beside its bound, its plain version and SDPA, and logs
// ptxas's registers and spills, the build time and the HMMA count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "mma_sm90.cuh"

namespace {

constexpr int THREADS = 256;  // 16 x 16: tr = tid / 16 (rows), tc = tid % 16 (columns)
constexpr int BR = 64;        // a block's own rows: queries (forward, dQ), keys (dK/dV)
constexpr int BT = 64;        // rows of a streamed tile: keys (forward, dQ), queries (dK/dV)
constexpr int DC = 32;        // head-dim columns of a score chunk
constexpr int SUB = 16;       // streamed rows of an output step
constexpr int LD = 68;        // pitch of the transposed chunks and of P / dS (16-byte rows)
constexpr int MAX_D = 1024;
// output columns a thread, and a block (grid.z splits a wider head)
constexpr int NJ = 16, COLS = 16 * NJ;
// dynamic shared memory (floats): the score chunks, P and/or dS, the
// streamed rows of the output step
constexpr size_t FWD_SMEM = (2 * DC * LD + BT * LD + SUB * COLS) * sizeof(float);
constexpr size_t DQ_SMEM = (4 * DC * LD + BT * LD + SUB * COLS) * sizeof(float);
constexpr size_t DKV_SMEM = (4 * DC * LD + 2 * BT * LD + 2 * SUB * COLS) * sizeof(float);
static_assert(DKV_SMEM <= 232448, "shared memory per block");

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
  int lw;            // bf16 mma kernels: log2 of the elements a copied piece (load_log2)
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

__device__ __forceinline__ void score_step(float (&s)[4][4], const float* a, const float* b) {
  const float4 x4 = ld4(a), y4 = ld4(b);
  const float x[4] = {x4.x, x4.y, x4.z, x4.w}, y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
}

// s[i][j] += A[k][4 tr + i] * B[k][4 tc + j] for the chunk's kn columns
// k, one fmaf a column in column order: with s at 0 before column 0, every
// score of every kernel here is one fmaf chain over the head dim, in the
// order cuBLAS's fp32 product (the plain version's) takes too; partial
// sums a chunk, added after, moved the fp32 backward past its tolerance on
// peaked scores at d = 100 (rel L2 2.9e-5 against 1e-5 on the card)
__device__ __forceinline__ void score_chunk(float (&s)[4][4], const float* A, const float* B,
                                            int kn) {
  const float* a = A + row_of(0);
  const float* b = B + key_of(0);
  if (kn == DC) {
#pragma unroll
    for (int k = 0; k < DC; ++k) score_step(s, a + k * LD, b + k * LD);
  } else {
    for (int k = 0; k < kn; ++k) score_step(s, a + k * LD, b + k * LD);
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

// over the 16 threads that hold a row (one half of a warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

// The forward (K1/K2): rows r0 = 64 blockIdx.x of head blockIdx.y, output
// columns from 256 blockIdx.z
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) flash_fwd_anyd(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;           // q2 chunk, transposed [DC][LD]
  float* sK = sQ + DC * LD;   // K chunk, transposed
  float* sP = sK + DC * LD;   // round_T(P), key-major [BT][LD]
  float* sV = sP + BT * LD;   // V rows [SUB][COLS]
  const int bh = blockIdx.y, r0 = blockIdx.x * BR, c0 = blockIdx.z * COLS;
  const int n = a.N, d = a.D;
  const Head<T> q(a, 0, bh), k(a, 1, bh), v(a, 2, bh);
  const int chunks = (d + DC - 1) / DC;

  float acc[4][NJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  for (int t0 = 0; t0 < n; t0 += BT) {
    float s[4][4] = {};
    Stage<T, BR, DC> qs;
    Stage<T, BT, DC> ks;
    qs.fetch(q, r0, 0, n, d, a.scale_log2);
    ks.fetch(k, t0, 0, n, d, 0.f);
    for (int c = 0; c < chunks; ++c) {
      // every thread is done with the previous chunk (at c = 0 with the
      // previous tile's sP and sV)
      __syncthreads();
      qs.put_t(sQ);
      ks.put_t(sK);
      __syncthreads();
      if (c + 1 < chunks) {
        qs.fetch(q, r0, (c + 1) * DC, n, d, a.scale_log2);
        ks.fetch(k, t0, (c + 1) * DC, n, d, 0.f);
      }
      score_chunk(s, sQ, sK, min(DC, d - c * DC));
    }
    // the online softmax of rows 4 tr + i over keys t0 + 4 tc + j; s
    // becomes round_T(P)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (t0 + key_of(j) >= n) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float alpha = exp2f(m[i] - mx);  // 0 at the first tile (m = -inf)
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - mx);
        sum += p;
        s[i][j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum(sum);
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st4(sP + key_of(j) * LD + row_of(0), s[0][j], s[1][j], s[2][j], s[3][j]);
    // O += P V, 16 keys a step
    Stage<T, SUB, COLS> vs;
    vs.fetch(v, t0, c0, n, d, 0.f);
    for (int u = 0; u < BT; u += SUB) {
      __syncthreads();  // sP is whole (u = 0); every thread is done with sV
      vs.put(sV);
      __syncthreads();
      if (u + SUB < BT) vs.fetch(v, t0 + u + SUB, c0, n, d, 0.f);
      out_step(acc, sP + u * LD, sV);
    }
  }
  store_rows<T>(acc, l, a.out[0], a, bh, r0, c0);
  if (a.lse_out != nullptr && blockIdx.z == 0 && threadIdx.x % 16 == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + row_of(i);
      if (row < n) a.lse_out[(long long)bh * n + row] = m[i] + log2f(l[i]);
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

// dK and dV (K6): key rows r0 = 64 blockIdx.x, query tiles streamed, output
// columns from 256 blockIdx.z
template <typename T>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_anyd(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;           // the score chunks, transposed [DC][LD]: q2, K, dO, V
  float* sK = sQ + DC * LD;
  float* sO = sK + DC * LD;
  float* sV = sO + DC * LD;
  float* sP = sV + DC * LD;   // round_T(P), query-major [BT][LD]
  float* sS = sP + BT * LD;   // round_T(dS), query-major
  float* sXo = sS + BT * LD;  // dO rows [SUB][COLS]
  float* sXq = sXo + SUB * COLS;  // q rows (unscaled)
  const int bh = blockIdx.y, r0 = blockIdx.x * BR, c0 = blockIdx.z * COLS;
  const int n = a.N, d = a.D;
  const Head<T> q(a, 0, bh), k(a, 1, bh), v(a, 2, bh), dout(a, 3, bh);
  float dk[4][NJ], dv[4][NJ];
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  for (int t0 = 0; t0 < n; t0 += BT) {
    float s[4][4], dp[4][4];
    // i over the query tile's rows t0 + 4 tr + i, j over this block's keys
    // r0 + 4 tc + j: the forward's S, element for element; s and dp become
    // round_T(P) and round_T(dS)
    scores_and_dp(s, dp, a, q, k, v, dout, t0, r0, sQ, sK, sO, sV);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = t0 + row_of(i);
      const float lse = row < n ? a.lse[(long long)bh * n + row] : 0.f;
      const float dd = row < n ? a.dd[(long long)bh * n + row] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = 0.f, ds = 0.f;
        if (row < n && r0 + key_of(j) < n) {
          p = exp2f(s[i][j] - lse);
          ds = p * (dp[i][j] - dd) * a.scale;
        }
        s[i][j] = round_to<T>(p);
        dp[i][j] = round_to<T>(ds);
      }
      st4(sP + row_of(i) * LD + key_of(0), s[i][0], s[i][1], s[i][2], s[i][3]);
      st4(sS + row_of(i) * LD + key_of(0), dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
    }
    // dV += P^T dO, dK += dS^T Q, 16 queries a step
    Stage<T, SUB, COLS> xo, xq;
    xo.fetch(dout, t0, c0, n, d, 0.f);
    xq.fetch(q, t0, c0, n, d, 0.f);
    for (int u = 0; u < BT; u += SUB) {
      __syncthreads();  // sP and sS are whole (u = 0); every thread is done with sXo, sXq
      xo.put(sXo);
      xq.put(sXq);
      __syncthreads();
      if (u + SUB < BT) {
        xo.fetch(dout, t0 + u + SUB, c0, n, d, 0.f);
        xq.fetch(q, t0 + u + SUB, c0, n, d, 0.f);
      }
      out_step(dv, sP + u * LD, sXo);
      out_step(dk, sS + u * LD, sXq);
    }
  }
  store_rows<T>(dk, one, a.out[0], a, bh, r0, c0);
  store_rows<T>(dv, one, a.out[1], a, bh, r0, c0);
}

// log2 of the widest piece (8, 4, 2 or 1 elements) that divides d and
// every operand's base (in elements) and (batch, seq, head) strides; the
// stride of a dimension of size 1 is never stepped and does not count
template <typename T>
int load_log2(const Args<T>& a, int nin) {
  for (int lw = 3; lw > 0; --lw) {
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
int run_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int N, int H,
            int D, const long long* st, float scale, void* stream) {
  // once per instantiation (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_anyd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  const void* in[3] = {q, k, v};
  Args<T> a;
  const cudaError_t err = make_args(&a, in, 3, st, nullptr, nullptr, o, nullptr, lse, B, N, H, D,
                                    scale, 0.f);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<T>(flash_fwd_anyd<T>, attr, FWD_SMEM, a, stream);
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

template <typename T>
int run_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* dd, void* dk, void* dv, int B, int N, int H, int D, const long long* st,
            float scale_log2, float scale, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_anyd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DKV_SMEM);
  const void* in[4] = {q, k, v, dout};
  Args<T> a;
  const cudaError_t err = make_args(&a, in, 4, st, lse, dd, dk, dv, nullptr, B, N, H, D,
                                    scale_log2, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<T>(flash_bwd_dkv_anyd<T>, attr, DKV_SMEM, a, stream);
}

// --- bf16: the forward and dK/dV on mma.sync tensor cores ---------------------

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
// rs) into a (rows x pitch) bf16 tile at dst, in pieces of 1 << lw
// elements shared by nthr threads: cp.async of 16, 8 or 4 bytes, or a
// plain 2-byte copy at lw = 0. Rows >= n and columns >= d are zero (d is a
// multiple of the piece, so a piece is all in or all out). For the rows a
// block holds (the forward's q, dK/dV's K and V), once a block.
__device__ __forceinline__ void copy_tile(bf16* dst, int pitch, const bf16* src, long long rs,
                                          int r0, int rows, int c0, int cols, int n, int d,
                                          int lw, int nthr) {
  const int per_row = cols >> lw, total = rows * per_row;
  for (int i = threadIdx.x; i < total; i += nthr) {
    const int r = i / per_row, c = (i - r * per_row) << lw;
    const bool valid = r0 + r < n && c0 + c < d;
    const bf16* s = valid ? src + (long long)(r0 + r) * rs + c0 + c : src;
    bf16* t = dst + r * pitch + c;
    if (lw == 3)
      cp_async16(t, s, valid);
    else if (lw == 2)
      cp_async8(t, s, valid);
    else if (lw == 1)
      cp_async4(t, s, valid);
    else
      *t = valid ? *s : __float2bfloat16_rn(0.f);
  }
}

// q2 = round_bf16(q * scale) in place over the pieces of a (rows x pitch)
// tile that this thread copied with copy_tile (the same rows, cols, lw and
// nthr): its own copies are visible to it once they have landed, so no
// barrier comes before this pass. Bit for bit the tuned kernels' prescale.
__device__ __forceinline__ void prescale_tile(bf16* tile, int pitch, int rows, int cols, int lw,
                                              int nthr, float scale) {
  const int per_row = cols >> lw, total = rows * per_row;
  for (int i = threadIdx.x; i < total; i += nthr) {
    const int r = i / per_row;
    bf16* t = tile + r * pitch + ((i - r * per_row) << lw);
    for (int e = 0; e < (1 << lw); ++e)
      t[e] = __float2bfloat16_rn(__bfloat162float(t[e]) * scale);
  }
}

// A (ROWS x PITCH) panel of KC columns of one head, rows [r0, r0 + ROWS)
// from column c0, by THREADS threads, in copy_tile's pieces: piece i = tid
// + e THREADS is piece i % P of row i / P (P = KC >> lw pieces a row), so
// the indices are shifts, and the 16-byte case (lw = 3) unrolls at
// compile time
template <int ROWS, int THREADS>
__device__ __forceinline__ void copy_panel(bf16* dst, const bf16* src, long long rs, int r0,
                                           int c0, int n, int d, int lw) {
  if (lw == 3) {
    constexpr int STEP = THREADS / 8;
    static_assert(THREADS % 8 == 0 && ROWS % STEP == 0, "panel");
    const int r = threadIdx.x / 8, c = (threadIdx.x % 8) * 8;
    const bool col = c0 + c < d;
    const bf16* s = src + (long long)(r0 + r) * rs + c0 + c;
#pragma unroll
    for (int e = 0; e < ROWS / STEP; ++e) {
      const bool valid = col && r0 + r + e * STEP < n;
      cp_async16(dst + (r + e * STEP) * PITCH + c, valid ? s + e * STEP * rs : src, valid);
    }
    return;
  }
  const int shift = 6 - lw;  // log2 of the pieces a row
  for (int i = threadIdx.x; i < (ROWS << shift); i += THREADS) {
    const int r = i >> shift, c = (i & ((1 << shift) - 1)) << lw;
    const bool valid = r0 + r < n && c0 + c < d;
    const bf16* s = valid ? src + (long long)(r0 + r) * rs + c0 + c : src;
    bf16* t = dst + r * PITCH + c;
    if (lw == 2)
      cp_async8(t, s, valid);
    else if (lw == 1)
      cp_async4(t, s, valid);
    else
      *t = valid ? *s : __float2bfloat16_rn(0.f);
  }
}

// prescale_tile over a (ROWS x PITCH) panel of KC columns that this thread
// copied with copy_panel<ROWS, THREADS>, in its shift-indexed pieces
template <int ROWS, int THREADS>
__device__ __forceinline__ void prescale_own(bf16* panel, int lw, float scale) {
  const int shift = 6 - lw;
  for (int i = threadIdx.x; i < (ROWS << shift); i += THREADS) {
    bf16* t = panel + (i >> shift) * PITCH + ((i & ((1 << shift) - 1)) << lw);
    if (lw == 3) {
      uint4 val = *reinterpret_cast<const uint4*>(t);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        h2[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      *reinterpret_cast<uint4*>(t) = val;
    } else {
      for (int e = 0; e < (1 << lw); ++e)
        t[e] = __float2bfloat16_rn(__bfloat162float(t[e]) * scale);
    }
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

// rows row0 + g and row0 + g + 8 (lane (g, t)) of head bh of out, (B, N,
// H, D) contiguous, columns c0 + 8 j + 2 t and + 1 of the NO n8 tiles:
// round_bf16(x / div[i]) for the rows below n and the columns below d (a
// 4-byte store of the pair where d is even, so every pair is aligned)
template <int NO>
__device__ __forceinline__ void store_tiles(const float (&x)[NO][4], const float (&div)[2],
                                            bf16* out, const Args<bf16>& a, int bh, int row0,
                                            int c0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, d = a.D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= a.N) continue;
    bf16* dst = out + ((long long)(bh / a.H) * a.N + row) * a.H * d + (long long)(bh % a.H) * d;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = c0 + 8 * j + 2 * t;
      if (col >= d) break;
      const float lo = x[j][2 * i] / div[i], hi = x[j][2 * i + 1] / div[i];
      if (d % 2 == 0) {
        *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(lo, hi);
      } else {
        dst[col] = __float2bfloat16_rn(lo);
        if (col + 1 < d) dst[col + 1] = __float2bfloat16_rn(hi);
      }
    }
  }
}

// The forward's tiles: WARPS warps of 16 query rows, key tiles of BK,
// output columns [CS z, CS z + CS) of block z. Shared memory: the block's
// q2 rows at the padded head dim (pitch dp + 8), then the ring, whose slots
// hold a chunk of K or of V (BK rows).
template <int WARPS, int CS>
struct FwdMma {
  static constexpr int THREADS = 32 * WARPS, BQ = 16 * WARPS, BK = 64;
  static constexpr int NT = BK / 8;   // n8 tiles of S
  static constexpr int NO = CS / 8;   // n8 tiles of O
  static constexpr int NV = CS / KC;  // V chunks of a whole slice
  static constexpr int SLOT = BK * PITCH;  // bf16 elements
  static_assert(CS % KC == 0, "tile");
  static __host__ __device__ constexpr size_t smem(int dp) {
    return (size_t(BQ) * (dp + 8) + size_t(STAGES) * SLOT) * 2;
  }
};

template <int WARPS, int CS>
__global__ void __launch_bounds__(32 * WARPS, 1) flash_fwd_anyd_mma(const Args<bf16> a) {
  using T = FwdMma<WARPS, CS>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, c0 = blockIdx.z * CS;
  const int n = a.N, d = a.D, lw = a.lw, dp = (d + 15) / 16 * 16, pq = dp + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = sQ + T::BQ * pq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Head<bf16> q(a, 0, bh), k(a, 1, bh), v(a, 2, bh);
  const int nc = (d + KC - 1) / KC;                // score chunks of a key tile
  const int nv = (min(CS, d - c0) + KC - 1) / KC;  // V chunks of this slice
  const int per_tile = nc + nv, tiles = (n + T::BK - 1) / T::BK;

  float o[T::NO][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  zero(o);
  const bf16* arow = sQ + (warp * 16 + lane % 16) * pq + (lane / 16) * 8;
  // The ring: items in order, chunk pc of key tile pj (K for the first nc,
  // then V) into slot ps, one cp.async group an item (empty past the
  // last); the item consumed is in slot cs. The code that advances it
  // appears once for the score chunks and once for the V chunks, so the
  // loop stays small enough for the instruction cache.
  int pj = 0, pc = 0, ps = 0, cs = 0;
  auto issue = [&]() {
    if (pj < tiles) {
      bf16* slot = ring + ps * T::SLOT;
      const int col = pc < nc ? pc * KC : c0 + (pc - nc) * KC;
      copy_panel<T::BK, T::THREADS>(slot, pc < nc ? k.p : v.p, pc < nc ? k.rs : v.rs,
                                    pj * T::BK, col, n, d, lw);
      if (++pc == per_tile) pc = 0, ++pj;
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

  // q lands with the first item; each thread makes q2 of the pieces it
  // copied (bit for bit the tuned kernels' prescale), which the first
  // item's barrier shows every thread
  copy_tile(sQ, pq, q.p, q.rs, q0, T::BQ, 0, dp, n, d, lw, T::THREADS);
#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) issue();
  cp_async_wait<STAGES - 2>();
  prescale_tile(sQ, pq, T::BQ, dp, lw, T::THREADS, a.scale_log2);
  for (int j = 0; j < tiles; ++j) {
    float s[T::NT][4];
    zero(s);
    for (int c = 0; c < nc; ++c)  // S = q2 K^T
      chunk_scores<T::NT>(s, arow + c * KC, arrive(), min(KC, dp - c * KC) / 16);
    uint32_t p[T::NT / 2][4];
    softmax_step<T::NT, T::NO>(s, p, o, m, l, n - j * T::BK);
    for (int vc = 0; vc < nv; ++vc) {  // O += P V, a chunk of the slice at a time
      const bf16* slot = arrive();
      const int dv = d - c0 - vc * KC;
#pragma unroll
      for (int u = 0; u < T::NV; ++u)  // chunk vc's O tiles, at compile-time indices
        if (u == vc) pv_chunk<T::NT / 2, T::NO>(o, p, slot, u * (KC / 8), dv);
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

template <int WARPS, int CS>
cudaError_t launch_fwd_mma(const Args<bf16>& a, size_t smem, cudaStream_t stream) {
  using T = FwdMma<WARPS, CS>;
  auto kern = flash_fwd_anyd_mma<WARPS, CS>;
  // once per instantiation (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.N + T::BQ - 1) / T::BQ, a.B * a.H, (a.D + CS - 1) / CS);
  kern<<<grid, T::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// the forward's warps at (N, padded head dim dp): kFwdWarps, or 4 at N <=
// 64 (one 64-row block) or where the q tile of 16 kFwdWarps rows does not
// fit beside the ring
template <int CS>
cudaError_t launch_fwd_slice(const Args<bf16>& a, int dp, cudaStream_t stream) {
  using Wide = FwdMma<kFwdWarps, CS>;
  if (a.N > 64 && Wide::smem(dp) <= SMEM_MAX)
    return launch_fwd_mma<kFwdWarps, CS>(a, Wide::smem(dp), stream);
  return launch_fwd_mma<4, CS>(a, FwdMma<4, CS>::smem(dp), stream);
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
  const int dp = (a.D + 15) / 16 * 16;
  if (a.D <= 128) return launch_fwd_slice<128>(a, dp, stream);
  return launch_fwd_slice<kFwdSlice>(a, dp, stream);
}

cudaError_t launch_dkv_bf16(const Args<bf16>& a, cudaStream_t stream) {
  const int dp = (a.D + 15) / 16 * 16;
  if (a.D <= 128) return launch_dkv_mma<4, 1>(a, dp, stream);
  if (DkvMma<4, kDkvSplit>::smem(dp) <= SMEM_MAX) return launch_dkv_mma<4, kDkvSplit>(a, dp, stream);
  return launch_dkv_mma<2, kDkvSplit>(a, dp, stream);
}

}  // namespace

// The entries, each with its tuned twin's parameters (csrc/flash_fwd.cu,
// flash_bwd.cu; flash_fp32.cu's for fp32); the bf16 forward and dK/dV run
// the mma.sync kernels, the rest the SIMT ones: q, k, v (and dO) of T (B, N, H,
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
  return run_fwd<float>(q, k, v, o, lse, B, N, H, D, st, scale, stream);
}

extern "C" int pbe_flash_bwd_dq_anyd_bf16(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* dd,
                                          void* dq, int B, int N, int H, int D,
                                          const long long* st, float scale_log2, float scale,
                                          void* stream) {
  return run_dq<bf16>(q, k, v, dout, lse, dd, dq, B, N, H, D, st, scale_log2, scale, stream);
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
  return run_dkv<float>(q, k, v, dout, lse, dd, dk, dv, B, N, H, D, st, scale_log2, scale,
                        stream);
}
