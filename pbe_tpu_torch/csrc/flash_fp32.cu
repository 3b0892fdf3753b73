// Flash attention at fp32 for Hopper (sm_90a): the forward, the dQ and the
// dK/dV kernels for fp32 operands, on the SIMT cores' fp32 FMA.
//
// The Pallas kernels of pbe_tpu/ops/flash_attention.py run in their
// operands' dtype: at fp32 (the JAX CLIs' --precision full) q/k/v stay fp32
// and the casts of P and dS before their products (:101, :159, :253, :436,
// :471, :480) do nothing. These kernels are that case:
//   pbe_flash_fwd_f32      K1 _flash_kernel_rowblock (:85) and K2
//                          _flash_kernel (:218), via _flash_fwd_bhnd (:282):
//                          the UNet's d = 40/80/160 and the VAE's 512
//   pbe_flash_bwd_dq_f32   K5 _flash_bwd_dq_kernel (:408), via
//                          _flash_bwd_bhnd (:490)
//   pbe_flash_bwd_dkv_f32  K6 _flash_bwd_dkv_kernel (:445)
// and compute, with every value fp32 and nothing rounded to a narrower type:
//   q2 = q * d^-1/2 * log2(e)
//   forward:  S = q2 K^T, P = exp2(S - m), O = (P V) / l, LSE = m + log2(l)
//   backward: P = exp2(q2 K^T - LSE), dS = P (dO V^T - D) d^-1/2,
//             dQ = dS K, dK = dS^T Q, dV = P^T dO   (D = rowsum(dO * O))
// ops/flash_attention.py's flash_attention_plain and
// flash_attention_bwd_plain compute the same at fp32. The arguments are
// the bf16 twins' (csrc/flash_fwd.cu, csrc/flash_bwd.cu): strided (B, N, H,
// D) operands, the LSE and D as (B*H, N) fp32 with the LSE in the log2
// domain, outputs contiguous (B, N, H, D).
//
// Design: a first kernel that is right, on fp32 FFMA (the tensor cores'
// TF32 keeps ~3 decimal digits, too few for an fp32 result). Each block
// takes one tile of rows of one head and loops over the other axis inside
// the block, as the bf16 kernels do; every output tile has one owner, so
// there are no atomics and a repeated launch gives the same bits.
//   * Tiles are fp32 in shared memory, row-major with a pitch of DP + 4
//     floats, read as float4. 256 threads: thread t = 16 ty + tx owns rows
//     ty + 16 i of every tile it computes and columns tx + 16 j (scores) or
//     VW tx + 16 VW j + e (head dim, VW = 4/2/1 by padded head dim), so
//     the 16 lanes sharing a row are one half-warp: row max and row sum
//     are 4 xor shuffles, and every lane ends with the same bits.
//   * abt: a product A B^T of two row-major tiles (S = q2 K^T, dP = dO V^T,
//     S^T = K q2^T, dP^T = V dO^T); per 4 columns of the head dim a thread
//     loads TM + TN float4 and does 4 TM TN FMA. The pitch DP + 4 (an odd
//     multiple of 4 floats over 32 banks) makes 8 neighbouring rows' float4
//     hit 8 distinct bank groups.
//   * ab: a product A B of a score tile and a row-major operand (P V,
//     dS K, P^T dO, dS^T q2) into the register accumulator.
//   * The forward keeps m, l and O in registers (online softmax); P goes
//     through a (rows x BK) shared tile between the two products. The dQ
//     kernel holds q2 and dO, the dK/dV kernel K and V, and streams the
//     other operands' tiles. The dK/dV kernel keeps only q2, the forward's
//     prescaled q bit for bit, and takes dK = (dS^T q2) / (d^-1/2 log2 e):
//     scaling S^T = K Q^T after the product instead moves an exponent of a
//     few hundred (peaked scores) by an ulp, which P then carries (rel L2
//     3e-5 on an H100), while the division moves dK by an ulp alone.
//   * Keys (forward, dQ) or queries (dK/dV) past N, all in the last tile,
//     get S = -inf or P = 0; rows past N are zero-filled and never stored.
//   * Tiles arrive by 16-byte cp.async copies, all of a tile in flight at
//     once, with three __syncthreads a tile (tiles in, P or dS written,
//     product done).
// Tiles (rows a block x streamed tile, 256 threads), shared memory:
//   forward  DP <= 80: 64 x 64;  160: 64 x 32;  512: 32 x 32  (202,752 B)
//   dQ       DP <= 80: 64 x 64;  160: 32 x 32;  512: 16 x 32  (200,448 B)
//   dK/dV    DP <= 80: 64 x 32;  160: 32 x 32;  512: 16 x 32  (203,008 B)
// At d = 512 a block holds three 32-row fp32 tiles of 66 KB, one block an
// SM; the accumulators are 64 registers a thread (O; dK + dV).
// Bound on an H100 SXM (fp32 FMA: 132 SMs x 128 lanes x 2 x 1.98 GHz =
// 66.9 TFLOP/s; 3.35 TB/s): the forward does 4 BH N^2 d FLOP, the dQ kernel
// 6 and the dK/dV kernel 8, so every shape of the edit and of training is
// bound by the FMA rate (K1 at (2, 4096, 8, 40): 42.9 GFLOP, 0.64 ms).
// chip_smoke.py phase 20 holds each kernel against its plain version and
// times it beside that bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr size_t kSmemPerBlock = 232448;  // bytes of shared memory a block can use
constexpr int CT = 16;                    // threads across a tile's columns (a half-warp)
constexpr int THREADS = 256;
constexpr int RT = THREADS / CT;          // threads across a tile's rows

struct Args {
  const float* in[4];  // q, k, v, dO (null in the forward)
  long long st[12];    // (batch, seq, head) element strides of each
  const float* lse;    // backward: the log2-domain LSE, (B*H, N)
  const float* dd;     // backward: D = rowsum(dO * O), (B*H, N)
  float* out[2];       // forward: O; dQ kernel: dQ; dK/dV kernel: dK, dV
  float* lse_out;      // forward: the LSE, or null
  int B, N, H, D;
  float scale_log2;    // d^-1/2 * log2(e), the q prescale
  float scale;         // d^-1/2
};

// the columns of a padded head dim DP a thread holds: VW-wide vectors at
// VW tx + CT VW j, j < NJ
template <int DP>
struct Cols {
  static constexpr int VW = DP % 64 == 0 ? 4 : DP % 32 == 0 ? 2 : 1;
  static constexpr int NJ = DP / (CT * VW);
  static constexpr int N = NJ * VW;
  static_assert(DP % CT == 0, "padded head dim");
  __device__ static int col(int tx, int j) { return VW * tx + CT * VW * j; }
};

template <int VW>
__device__ __forceinline__ void ldv(float (&y)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    y[0] = t.x, y[1] = t.y, y[2] = t.z, y[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    y[0] = t.x, y[1] = t.y;
  } else {
    y[0] = *p;
  }
}

template <int VW>
__device__ __forceinline__ void stv(float* p, const float* y) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(y[0], y[1]);
  } else {
    *p = y[0];
  }
}

__device__ __forceinline__ float lane4(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 1; o < CT; o *= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 1; o < CT; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// row 0 of head bh's (N, D) slice of operand i
__device__ __forceinline__ const float* head(const Args& a, int i, int bh) {
  return a.in[i] + (long long)(bh / a.H) * a.st[3 * i] +
         (long long)(bh % a.H) * a.st[3 * i + 2];
}

// 16 bytes from src into shared memory, or 16 zero bytes where !valid (src
// is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// rows [r0, r0 + ROWS) of operand i's head bh into a (ROWS x LD) tile,
// multiplied by mul; rows >= N and columns >= D are zero. 16-byte cp.async
// copies, all in flight at once (D % 8 == 0 and 16-byte aligned rows are
// checked by the wrapper); with mul != 1 each thread then scales the very
// chunks it copied, which its wait has made visible to it. The caller's
// next __syncthreads publishes the tile.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const Args& a, int i, int bh, int r0,
                                          float mul) {
  constexpr int LD = DP + 4, CH = DP / 4;
  const float* src = head(a, i, bh);
  const long long rs = a.st[3 * i + 1];
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 4;
    const bool valid = r0 + r < a.N && c < a.D;
    cp_async16(dst + r * LD + c, valid ? src + (long long)(r0 + r) * rs + c : src, valid);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (mul != 1.f) {
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
      float4* v = reinterpret_cast<float4*>(dst + (idx / CH) * LD + (idx % CH) * 4);
      *v = make_float4(v->x * mul, v->y * mul, v->z * mul, v->w * mul);
    }
  }
}

// acc[i][j] += sum_{c < kdim} A[ty + RT i][c] B[tx + CT j][c]: A B^T of two
// row-major tiles (pitches lda, ldb); kdim % 4 == 0
template <int TM, int TN>
__device__ __forceinline__ void abt(float (&acc)[TM][TN], const float* A, int lda,
                                    const float* B, int ldb, int kdim, int ty, int tx) {
#pragma unroll 2
  for (int c = 0; c < kdim; c += 4) {
    float4 x[TM], y[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      x[i] = *reinterpret_cast<const float4*>(A + (ty + RT * i) * lda + c);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      y[j] = *reinterpret_cast<const float4*>(B + (tx + CT * j) * ldb + c);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// acc[i][VW j + e] += sum_{k < KD} A[ty + RT i][k] B[k][VW tx + CT VW j + e]:
// a (rows x KD) score tile (pitch lda) times a row-major (KD x DP) operand
// (pitch ldb) into the thread's head-dim columns
template <int TM, int DP, int KD>
__device__ __forceinline__ void ab(float (&acc)[TM][Cols<DP>::N], const float* A, int lda,
                                   const float* B, int ldb, int ty, int tx) {
  using C = Cols<DP>;
#pragma unroll 2
  for (int k = 0; k < KD; k += 4) {
    float4 x[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      x[i] = *reinterpret_cast<const float4*>(A + (ty + RT * i) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* row = B + (k + kk) * ldb;
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        float y[C::VW];
        ldv<C::VW>(y, row + C::col(tx, j));
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int e = 0; e < C::VW; ++e)
            acc[i][C::VW * j + e] = fmaf(lane4(x[i], kk), y[e], acc[i][C::VW * j + e]);
      }
    }
  }
}

// rows [r0, r0 + RT TM) of a (B, N, H, D) contiguous output from the
// thread's accumulator, each value divided by div[i] (l, or 1); rows >= N
// and columns >= D are not written
template <int TM, int DP>
__device__ __forceinline__ void store_rows(float* out, const Args& a, int bh, int r0,
                                           const float (&acc)[TM][Cols<DP>::N],
                                           const float (&div)[TM], int ty, int tx) {
  using C = Cols<DP>;
  const int n = a.N, d = a.D, b = bh / a.H, hh = bh % a.H;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + ty + RT * i;
    if (row >= n) continue;
    float* dst = out + ((long long)(b * n + row) * a.H + hh) * d;
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) {
      if (C::col(tx, j) >= d) continue;  // d % 8 == 0: a vector is all in or all out
      float y[C::VW];
#pragma unroll
      for (int e = 0; e < C::VW; ++e) y[e] = acc[i][C::VW * j + e] / div[i];
      stv<C::VW>(dst + C::col(tx, j), y);
    }
  }
}

// --- the forward: q tile of BQ rows resident, key tiles of BK streamed
template <int DP, int BQ, int BK>
struct Fwd {
  static constexpr int TM = BQ / RT, TN = BK / CT, LD = DP + 4, LDP = BK + 4;
  static constexpr size_t SMEM = (size_t(BQ) * LD + 2 * size_t(BK) * LD + size_t(BQ) * LDP) * 4;
  static_assert(BQ % RT == 0 && BK % CT == 0 && SMEM <= kSmemPerBlock, "forward tile");
};

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(const Args a) {
  using T = Fwd<DP, BQ, BK>;
  using C = Cols<DP>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * T::LD;
  float* sV = sK + BK * T::LD;
  float* sP = sV + BK * T::LD;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ, n = a.N;
  const int tx = threadIdx.x % CT, ty = threadIdx.x / CT;
  load_tile<DP, BQ>(sQ, a, 0, bh, q0, a.scale_log2);
  float o[T::TM][C::N], m[T::TM], l[T::TM];
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::N; ++c) o[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += BK) {
    load_tile<DP, BK>(sK, a, 1, bh, k0, 1.f);
    load_tile<DP, BK>(sV, a, 2, bh, k0, 1.f);
    __syncthreads();
    float s[T::TM][T::TN] = {};
    abt<T::TM, T::TN>(s, sQ, T::LD, sK, T::LD, a.D, ty, tx);
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < T::TN; ++j) {
        if (k0 + tx + CT * j >= n) s[i][j] = -INFINITY;  // keys past N
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(mx));  // finite: key k0 < N is in
      const float alpha = exp2f(m[i] - mn);              // 0 at the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < T::TN; ++j) {
        const float p = exp2f(s[i][j] - mn);
        sP[(ty + RT * i) * T::LDP + tx + CT * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < C::N; ++c) o[i][c] *= alpha;
    }
    __syncthreads();  // P is whole
    ab<T::TM, DP, BK>(o, sP, T::LDP, sV, T::LD, ty, tx);
    __syncthreads();  // K, V and P are free for the next tile
  }
  store_rows<T::TM, DP>(a.out[0], a, bh, q0, o, l, ty, tx);
  if (a.lse_out != nullptr && tx == 0) {
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const int row = q0 + ty + RT * i;
      if (row < n) a.lse_out[(long long)bh * n + row] = m[i] + log2f(l[i]);
    }
  }
}

// --- dQ: q2 and dO tiles of BQ rows resident, K and V tiles of BK streamed
template <int DP, int BQ, int BK>
struct Dq {
  static constexpr int TM = BQ / RT, TN = BK / CT, LD = DP + 4, LDP = BK + 4;
  static constexpr size_t SMEM =
      (2 * size_t(BQ) * LD + 2 * size_t(BK) * LD + size_t(BQ) * LDP) * 4;
  static_assert(BQ % RT == 0 && BK % CT == 0 && SMEM <= kSmemPerBlock, "dQ tile");
};

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_f32_kernel(const Args a) {
  using T = Dq<DP, BQ, BK>;
  using C = Cols<DP>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + BQ * T::LD;  // dO
  float* sK = sO + BQ * T::LD;
  float* sV = sK + BK * T::LD;
  float* sS = sV + BK * T::LD;  // dS
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ, n = a.N;
  const int tx = threadIdx.x % CT, ty = threadIdx.x / CT;
  load_tile<DP, BQ>(sQ, a, 0, bh, q0, a.scale_log2);
  load_tile<DP, BQ>(sO, a, 3, bh, q0, 1.f);
  float lse[T::TM], dd[T::TM], acc[T::TM][C::N];
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int row = q0 + ty + RT * i;
    lse[i] = row < n ? a.lse[(long long)bh * n + row] : 0.f;
    dd[i] = row < n ? a.dd[(long long)bh * n + row] : 0.f;
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += BK) {
    load_tile<DP, BK>(sK, a, 1, bh, k0, 1.f);
    load_tile<DP, BK>(sV, a, 2, bh, k0, 1.f);
    __syncthreads();
    float s[T::TM][T::TN] = {}, dp[T::TM][T::TN] = {};
    abt<T::TM, T::TN>(s, sQ, T::LD, sK, T::LD, a.D, ty, tx);
    abt<T::TM, T::TN>(dp, sO, T::LD, sV, T::LD, a.D, ty, tx);
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j) {
        const float p = k0 + tx + CT * j < n ? exp2f(s[i][j] - lse[i]) : 0.f;
        sS[(ty + RT * i) * T::LDP + tx + CT * j] = p * (dp[i][j] - dd[i]) * a.scale;
      }
    __syncthreads();  // dS is whole
    ab<T::TM, DP, BK>(acc, sS, T::LDP, sK, T::LD, ty, tx);
    __syncthreads();
  }
  float ones[T::TM];
#pragma unroll
  for (int i = 0; i < T::TM; ++i) ones[i] = 1.f;
  store_rows<T::TM, DP>(a.out[0], a, bh, q0, acc, ones, ty, tx);
}

// --- dK/dV: K and V tiles of BK rows resident, Q and dO tiles of BQ streamed
template <int DP, int BK, int BQ>
struct Dkv {
  static constexpr int TM = BK / RT, TN = BQ / CT, LD = DP + 4, LDP = BQ + 4;
  static constexpr size_t SMEM = (2 * size_t(BK) * LD + 2 * size_t(BQ) * LD +
                                  2 * size_t(BK) * LDP + 2 * size_t(BQ)) * 4;
  static_assert(BK % RT == 0 && BQ % CT == 0 && SMEM <= kSmemPerBlock, "dK/dV tile");
};

template <int DP, int BK, int BQ>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_f32_kernel(const Args a) {
  using T = Dkv<DP, BK, BQ>;
  using C = Cols<DP>;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BK * T::LD;
  float* sQ = sV + BK * T::LD;   // q2
  float* sO = sQ + BQ * T::LD;   // dO
  float* sP = sO + BQ * T::LD;   // P^T
  float* sS = sP + BK * T::LDP;  // dS^T
  float* sL = sS + BK * T::LDP;  // the q tile's LSE
  float* sD = sL + BQ;           // and D
  const int bh = blockIdx.y, k0 = blockIdx.x * BK, n = a.N;
  const int tx = threadIdx.x % CT, ty = threadIdx.x / CT;
  load_tile<DP, BK>(sK, a, 1, bh, k0, 1.f);
  load_tile<DP, BK>(sV, a, 2, bh, k0, 1.f);
  float dk[T::TM][C::N], dv[T::TM][C::N];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int c = 0; c < C::N; ++c) dk[i][c] = dv[i][c] = 0.f;
  for (int q0 = 0; q0 < n; q0 += BQ) {
    load_tile<DP, BQ>(sQ, a, 0, bh, q0, a.scale_log2);  // q2
    load_tile<DP, BQ>(sO, a, 3, bh, q0, 1.f);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      sL[r] = q0 + r < n ? a.lse[(long long)bh * n + q0 + r] : 0.f;
      sD[r] = q0 + r < n ? a.dd[(long long)bh * n + q0 + r] : 0.f;
    }
    __syncthreads();
    float st[T::TM][T::TN] = {}, dpt[T::TM][T::TN] = {};
    abt<T::TM, T::TN>(st, sK, T::LD, sQ, T::LD, a.D, ty, tx);
    abt<T::TM, T::TN>(dpt, sV, T::LD, sO, T::LD, a.D, ty, tx);
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j) {
        const int qi = tx + CT * j;
        const float p = q0 + qi < n ? exp2f(st[i][j] - sL[qi]) : 0.f;
        sP[(ty + RT * i) * T::LDP + qi] = p;
        sS[(ty + RT * i) * T::LDP + qi] = p * (dpt[i][j] - sD[qi]) * a.scale;
      }
    __syncthreads();  // P^T and dS^T are whole
    ab<T::TM, DP, BQ>(dv, sP, T::LDP, sO, T::LD, ty, tx);
    ab<T::TM, DP, BQ>(dk, sS, T::LDP, sQ, T::LD, ty, tx);  // dS^T q2
    __syncthreads();
  }
  float ones[T::TM], q_scale[T::TM];
#pragma unroll
  for (int i = 0; i < T::TM; ++i) ones[i] = 1.f, q_scale[i] = a.scale_log2;
  store_rows<T::TM, DP>(a.out[0], a, bh, k0, dk, q_scale, ty, tx);
  store_rows<T::TM, DP>(a.out[1], a, bh, k0, dv, ones, ty, tx);
}

// one launch of `kernel` (tile config T: one kernel each) over (row tiles
// of `rows`, B*H) with T::SMEM bytes of dynamic shared memory
template <typename T>
cudaError_t launch(void (*kernel)(const Args), int rows, const Args& a, cudaStream_t stream) {
  // once per kernel (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3((a.N + rows - 1) / rows, a.B * a.H), THREADS, T::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <int DP, int BQ, int BK>
cudaError_t launch_fwd(const Args& a, cudaStream_t s) {
  return launch<Fwd<DP, BQ, BK>>(flash_fwd_f32_kernel<DP, BQ, BK>, BQ, a, s);
}

template <int DP, int BQ, int BK>
cudaError_t launch_dq(const Args& a, cudaStream_t s) {
  return launch<Dq<DP, BQ, BK>>(flash_bwd_dq_f32_kernel<DP, BQ, BK>, BQ, a, s);
}

template <int DP, int BK, int BQ>
cudaError_t launch_dkv(const Args& a, cudaStream_t s) {
  return launch<Dkv<DP, BK, BQ>>(flash_bwd_dkv_f32_kernel<DP, BK, BQ>, BK, a, s);
}

cudaError_t make_args(Args* a, const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dd, void* o0, void* o1, void* lse_out,
                      int B, int N, int H, int D, const long long* st, int nst,
                      float scale_log2, float scale) {
  if (B <= 0 || N <= 0 || H <= 0 || D % 8 != 0 || B * H > 65535) return cudaErrorInvalidValue;
  *a = Args{{static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<const float*>(dout)},
            {},
            static_cast<const float*>(lse),
            static_cast<const float*>(dd),
            {static_cast<float*>(o0), static_cast<float*>(o1)},
            static_cast<float*>(lse_out),
            B, N, H, D, scale_log2, scale};
  for (int i = 0; i < nst; ++i) a->st[i] = st[i];
  return cudaSuccess;
}

}  // namespace

// The forward: q, k, v fp32 (B, N, H, D), element strides (batch, seq,
// head) of q, k, v in `st` and a unit head-dim stride; o fp32 (B, N, H, D)
// contiguous; lse fp32 (B*H, N) or null; scale the q prescale d^-1/2 *
// log2(e). Launches on `stream`; returns the cudaError_t of the launch.
// Padded head dims: ops/flash_attention.py SUPPORTED_HEAD_DIMS.
extern "C" int pbe_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int B, int N, int H, int D, const long long* st,
                                 float scale, void* stream) {
  Args a;
  cudaError_t err = make_args(&a, q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse, B, N,
                              H, D, st, 9, scale, 0.f);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16:  return (int)launch_fwd<16, 64, 64>(a, s);
    case 32:  return (int)launch_fwd<32, 64, 64>(a, s);
    case 48:  return (int)launch_fwd<48, 64, 64>(a, s);
    case 80:  return (int)launch_fwd<80, 64, 64>(a, s);
    case 160: return (int)launch_fwd<160, 64, 32>(a, s);
    case 512: return (int)launch_fwd<512, 32, 32>(a, s);
    default:  return (int)cudaErrorInvalidValue;
  }
}

// The backward: q, k, v, dout fp32 (B, N, H, D), element strides (batch,
// seq, head) of q, k, v, dout in `st` and a unit head-dim stride; lse, dd
// fp32 (B*H, N) contiguous; outputs fp32 (B, N, H, D) contiguous.
// scale_log2 = d^-1/2 * log2(e), scale = d^-1/2. Padded head dims:
// ops/flash_attention.py BWD_HEAD_DIMS.
extern "C" int pbe_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* dd,
                                    void* dq, int B, int N, int H, int D,
                                    const long long* st, float scale_log2, float scale,
                                    void* stream) {
  Args a;
  cudaError_t err = make_args(&a, q, k, v, dout, lse, dd, dq, nullptr, nullptr, B, N, H, D,
                              st, 12, scale_log2, scale);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16:  return (int)launch_dq<16, 64, 64>(a, s);
    case 32:  return (int)launch_dq<32, 64, 64>(a, s);
    case 48:  return (int)launch_dq<48, 64, 64>(a, s);
    case 80:  return (int)launch_dq<80, 64, 64>(a, s);
    case 160: return (int)launch_dq<160, 32, 32>(a, s);
    case 512: return (int)launch_dq<512, 16, 32>(a, s);
    default:  return (int)cudaErrorInvalidValue;
  }
}

extern "C" int pbe_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* dd,
                                     void* dk, void* dv, int B, int N, int H, int D,
                                     const long long* st, float scale_log2, float scale,
                                     void* stream) {
  Args a;
  cudaError_t err = make_args(&a, q, k, v, dout, lse, dd, dk, dv, nullptr, B, N, H, D, st, 12,
                              scale_log2, scale);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16:  return (int)launch_dkv<16, 64, 32>(a, s);
    case 32:  return (int)launch_dkv<32, 64, 32>(a, s);
    case 48:  return (int)launch_dkv<48, 64, 32>(a, s);
    case 80:  return (int)launch_dkv<80, 64, 32>(a, s);
    case 160: return (int)launch_dkv<160, 32, 32>(a, s);
    case 512: return (int)launch_dkv<512, 16, 32>(a, s);
    default:  return (int)cudaErrorInvalidValue;
  }
}
