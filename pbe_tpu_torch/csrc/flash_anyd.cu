// Flash attention at any head dim d, 1 <= d <= 1024, for Hopper (sm_90a):
// the forward, dQ and dK/dV kernels for bf16 and for fp32 operands, the
// head dim a run-time argument (one instantiation per dtype and kernel).
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
// At fp32 every round_T does nothing. Every score, in all three kernels,
// is one fmaf chain over the head dim from column 0 (score_chunk), so the
// backward recomputes P from the forward's S bit for bit, and every output
// element one fmaf chain over the streamed rows in order.
//
// Layout: q, k, v (and dO) are (B, N, H, D) with any (batch, seq, head)
// strides and a unit head-dim stride, read in place one element a load
// (neighbouring threads on neighbouring columns), so no row or base needs
// any alignment: a packed q at d = 28 has rows of 28 elements. Outputs are
// (B, N, H, D) contiguous. Rows past N are read as zeros and their keys
// masked (P = 0); columns past d are zeros.
//
// Design (SIMT: fp32 FMA at both dtypes; the mma.sync / wgmma forms are
// later work). A block of 256 threads owns 64 rows (queries for the
// forward and dQ, keys for dK/dV: the JAX pair's grid order, the other
// side streamed in tiles of 64) and up to 256 output columns; a wider head
// is split over grid.z, each split recomputing S. Thread (tr, tc) = (tid /
// 16, tid % 16) holds rows 4 tr + i (i < 4) and, of S, the streamed rows
// 4 tc + j (j < 4), of the output columns 4 tc + 64 g + e (g, e < 4): each
// operand of a product step is one 16-byte shared-memory load (8 FMA a
// load in S, 12.8 in P V). S (and dP) build over the head dim in chunks of
// 32 columns staged transposed in shared memory, the next chunk's loads in
// flight (in registers) while the current one is multiplied; the row
// statistics are taken over the 16 threads of a row by shuffles; P (or dS)
// goes to shared memory, and the output tile (or dK and dV), in registers
// for the whole kernel (64 rows x 256 columns: 64 a thread), takes P V in
// steps of 16 streamed rows, every column group alike (columns past d are
// zeros: branching on d cost more than the products it skipped). The
// forward fits 128 registers, two blocks an SM; dQ (S and dP) and dK/dV
// (two accumulators) run one. Nothing is atomic: each output element has
// one owner, so a launch is bitwise repeatable.
// What bounds it: at the DDPM UNet's (128, 256, 1, 256) the work is 8.6
// GFLOP of products and 67 MB of bf16 operands (0.020 ms at 3.35 TB/s):
// bytes bind the bf16 forward on this card, the fp32 FMA rate (67 TFLOP/s,
// 0.128 ms) binds this design, which runs every product on FMA.
// chip_smoke.py phase 29 times each kernel beside its bound, its plain
// version and SDPA; the tile settings are the fastest of a few timed there
// by a scratch sweep (the column guard, two forward blocks an SM, dK/dV at
// 256 columns).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

typedef __nv_bfloat16 bf16;

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

}  // namespace

// The entries, each with its tuned twin's parameters (csrc/flash_fwd.cu,
// flash_bwd.cu; flash_fp32.cu's for fp32): q, k, v (and dO) of T (B, N, H,
// D), element strides (batch, seq, head) of each in `st`, a unit head-dim
// stride; outputs (B, N, H, D) contiguous; the LSE and D fp32 (B*H, N);
// scale (the forward) and scale_log2 the q prescale d^-1/2 log2(e), scale
// (the backward) d^-1/2. Launches on `stream`; returns the cudaError_t of
// the launch (cudaErrorInvalidValue for d outside [1, 1024]).
extern "C" int pbe_flash_fwd_anyd_bf16(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int N, int H, int D,
                                       const long long* st, float scale, void* stream) {
  return run_fwd<bf16>(q, k, v, o, lse, B, N, H, D, st, scale, stream);
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
  return run_dkv<bf16>(q, k, v, dout, lse, dd, dk, dv, B, N, H, D, st, scale_log2, scale, stream);
}

extern "C" int pbe_flash_bwd_dkv_anyd_f32(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* dd,
                                          void* dk, void* dv, int B, int N, int H, int D,
                                          const long long* st, float scale_log2, float scale,
                                          void* stream) {
  return run_dkv<float>(q, k, v, dout, lse, dd, dk, dv, B, N, H, D, st, scale_log2, scale,
                        stream);
}
