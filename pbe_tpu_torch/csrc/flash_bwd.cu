// Flash-attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel, bf16 in and out, fp32 inside.
//
// Replaces the Pallas backward kernels of pbe_tpu/ops/flash_attention.py,
// _flash_bwd_dq_kernel (:408) and _flash_bwd_dkv_kernel (:445), which
// _flash_bwd_bhnd launches from the flash_attention custom VJP. The v1
// training step reaches them at the UNet self-attention shapes (B*8, N, d) =
// (32, 4096, 40), (32, 1024, 80), (32, 256, 160) and (32, 64, 160) at batch 4.
// Same contracts as the forward (csrc/flash_fwd.cu) and the Pallas kernels:
//   q2 = round_bf16(q * d^-1/2 * log2(e))     the forward's own prescale, so
//   P  = exp2(q2 K^T - L2)                    P is the forward's P (L2: its
//                                             log2-domain LSE, (B*H, N) fp32)
//   dS = P * (dO V^T - D) * d^-1/2            D = rowsum(dO * O), fp32, given
//   dQ = round(sum_k round_bf16(dS) K)                                  (dQ)
//   dV = round(sum_q round_bf16(P)^T dO),  dK = round(sum_q round_bf16(dS)^T Q)
// with Q unscaled in dK.
//
// Design. Blocks run in no order, so the TPU's sequential grid axis becomes
// a loop inside the block, and every output tile has one owner: the dQ
// kernel takes one block per (batch*head, 64-row q tile) and loops over the
// k tiles; the dK/dV kernel one block per (batch*head, 64-row k tile) and
// loops over the q tiles. Nothing is summed across blocks, so there are no
// atomics and the result is the same from run to run. 8 warps: warp (rt, wc)
// owns the 16-row tile rt and every other 16-column tile (wc, wc+2, ...) of
// each product. The fp32 accumulators (dQ, or dK and dV) stay in wmma
// fragments in registers across the loop; S and dP go through shared memory
// in fp32 for the elementwise step, because the wmma accumulator layout is
// opaque, and P and dS come back as bf16 operands. Head dims are padded to
// a multiple of 16 in shared memory only, by zero-filled loads (40 -> 48);
// ragged sequence tails are zero-filled and their P and dS set to 0.
// Inputs are (B, N, H, D) with explicit strides: no transpose copy.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the dQ kernel
// does 6*BH*N^2*d FLOP, the dK/dV kernel 8*BH*N^2*d, and each BH*N^2 exp2
// at ~3.9 T/s of special-function throughput. At (32, 4096, 40) the
// exponentials bind the dQ kernel (0.138 ms) and the products the dK/dV
// kernel (0.174 ms); at the short sequences the bytes bind. This first
// version is simple, not fast: loads are synchronous, S and dP round-trip
// through shared memory, the exp2 of each (q, k) pair is taken in both
// kernels. wgmma/TMA pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cmath>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;                  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                      // rows of every q and k tile
constexpr int kRowTiles = kTile / 16;          // 16-row tiles of a 64-row tile
constexpr int kColWarps = kWarps / kRowTiles;  // warps sharing one row tile
static_assert(kWarps % kRowTiles == 0 && kRowTiles % kColWarps == 0, "warp layout");

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shared memory of one block: NT bf16 (64 x DP) operand tiles, S and dP in
// fp32, dS (and for dK/dV, P) in bf16, and the per-row L2 and D.
template <int DP, bool DKV>
struct Smem {
  static constexpr int LDQ = DP + 8;     // bf16 row pitch of the operand tiles
  static constexpr int LDS = kTile + 4;  // fp32 row pitch of S and dP
  static constexpr int LDP = kTile + 8;  // bf16 row pitch of P and dS
  static constexpr int NT = DKV ? 5 : 4;
  static constexpr size_t TILE = align128(size_t(kTile) * LDQ * 2);
  static constexpr size_t SQ = align128(size_t(kTile) * LDS * 4);
  static constexpr size_t SP = align128(size_t(kTile) * LDP * 2);
  static constexpr size_t OFF_S = NT * TILE;
  static constexpr size_t OFF_DP = OFF_S + SQ;
  static constexpr size_t OFF_DS = OFF_DP + SQ;
  static constexpr size_t OFF_P = OFF_DS + SP;  // dK/dV only
  static constexpr size_t OFF_L = OFF_P + (DKV ? SP : 0);
  static constexpr size_t OFF_D = OFF_L + kTile * 4;
  static constexpr size_t SMEM = OFF_D + kTile * 4;
  static_assert(DP % 16 == 0, "padded head dim");
  static_assert(SMEM <= 232448, "shared memory per block");
};

struct Strides {  // element strides (batch, seq, head) of q, k, v, dO
  long long q[3], k[3], v[3], o[3];
};

// rows [r0, r0+64) of one head into a (64 x LD) bf16 tile; rows >= n and
// columns >= d are zero. 16-byte chunks: d % 8 == 0 and 16-byte aligned
// rows are checked by the wrapper. With scale != 0 the values are
// multiplied by scale in fp32 and rounded back to bf16 (the q prescale).
template <int DP, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int r0, int n, int d, float scale) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < kTile * CH; i += kThreads) {
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

// per-row statistics of rows [r0, r0+64): L2 and D, zero past n
__device__ __forceinline__ void load_rows(float* sL, float* sD, const float* lse,
                                          const float* dd, long long base, int r0, int n) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool in = r0 + i < n;
    sL[i] = in ? lse[base + r0 + i] : 0.f;
    sD[i] = in ? dd[base + r0 + i] : 0.f;
  }
}

// C = A B^T (64 x 64, fp32, pitch LDS) for A, B (64 x DP) bf16 row-major
// tiles of pitch LDQ: warp (rt, wc) computes row tile rt, column tiles wc,
// wc + kColWarps, ...
template <int DP, int LDQ, int LDS>
__device__ __forceinline__ void mma_abt(float* c, const bf16* a, const bf16* b, int rt,
                                        int wc) {
  constexpr int NS = kRowTiles / kColWarps;
  Acc acc[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + rt * 16 * LDQ + kk, LDQ);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      // B^T as a col-major (DP x 64) operand is B row-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + (wc + j * kColWarps) * 16 * LDQ + kk, LDQ);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
    wmma::store_matrix_sync(c + rt * 16 * LDS + (wc + j * kColWarps) * 16, acc[j], LDS,
                            wmma::mem_row_major);
}

// acc += A B for A (64 x 64) bf16 of pitch LDP, B (64 x DP) bf16 of pitch
// LDQ: this warp's row tile rt, column tiles wc, wc + kColWarps, ... < DP/16
template <int DP, int LDQ, int LDP, int NO>
__device__ __forceinline__ void mma_ab_acc(Acc (&acc)[NO], const bf16* a, const bf16* b,
                                           int rt, int wc) {
  constexpr int CT = DP / 16;
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + rt * 16 * LDP + kk, LDP);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int ct = wc + j * kColWarps;
      if (ct < CT) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, b + kk * LDQ + ct * 16, LDQ);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
}

// the warp's accumulator tiles to bf16 rows [r0 + rt*16, +16) of head hh of a
// contiguous (B, N, H, D) output, through a 16 x 16 fp32 scratch of its own
template <int DP, int NO>
__device__ __forceinline__ void store_acc(bf16* out, Acc (&acc)[NO], float* scratch, int b,
                                          int hh, int h, int n, int d, int r0, int rt,
                                          int wc) {
  constexpr int CT = DP / 16;
  const int lane = threadIdx.x % 32;
  const int r = lane / 2, c = (lane % 2) * 8;  // 16 rows x two 8-column chunks
  const int row = r0 + rt * 16 + r;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int ct = wc + j * kColWarps;
    if (ct >= CT) continue;  // the same for the whole warp
    wmma::store_matrix_sync(scratch, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int col = ct * 16 + c;
    if (row < n && col < d) {
      const float* src = scratch + r * 16 + c;
      uint4 val;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e) h2[e] = __floats2bfloat162_rn(src[2 * e], src[2 * e + 1]);
      *reinterpret_cast<uint4*>(out + ((long long)(b * n + row) * h + hh) * d + col) = val;
    }
    __syncwarp();  // every lane has read the scratch before the next tile
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    bf16* __restrict__ dq, int n, int h, int d, Strides st,
                    float scale_log2, float scale) {
  using S = Smem<DP, false>;
  constexpr int NO = (DP / 16 + kColWarps - 1) / kColWarps;  // dQ tiles per warp

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ2 = reinterpret_cast<bf16*>(smem);
  bf16* sDO = reinterpret_cast<bf16*>(smem + S::TILE);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * S::TILE);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * S::TILE);
  float* sS = reinterpret_cast<float*>(smem + S::OFF_S);
  float* sDP = reinterpret_cast<float*>(smem + S::OFF_DP);
  bf16* sDS = reinterpret_cast<bf16*>(smem + S::OFF_DS);
  float* sL = reinterpret_cast<float*>(smem + S::OFF_L);
  float* sD = reinterpret_cast<float*>(smem + S::OFF_D);

  const int bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, rt = warp % kRowTiles, wc = warp / kRowTiles;

  const bf16* qb = q + b * st.q[0] + hh * st.q[2];
  const bf16* kb = k + b * st.k[0] + hh * st.k[2];
  const bf16* vb = v + b * st.v[0] + hh * st.v[2];
  const bf16* ob = dout + b * st.o[0] + hh * st.o[2];

  load_tile<DP, S::LDQ>(sQ2, qb, st.q[1], q0, n, d, scale_log2);
  load_tile<DP, S::LDQ>(sDO, ob, st.o[1], q0, n, d, 0.f);
  load_rows(sL, sD, lse, dd, (long long)bh * n, q0, n);

  Acc acc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the previous tile's products are done with sK and sDS
    load_tile<DP, S::LDQ>(sK, kb, st.k[1], k0, n, d, 0.f);
    load_tile<DP, S::LDQ>(sV, vb, st.v[1], k0, n, d, 0.f);
    __syncthreads();
    mma_abt<DP, S::LDQ, S::LDS>(sS, sQ2, sK, rt, wc);   // S  = q2 K^T
    mma_abt<DP, S::LDQ, S::LDS>(sDP, sDO, sV, rt, wc);  // dP = dO V^T
    __syncthreads();
    // rows are queries, columns keys
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      const bool valid = q0 + r < n && k0 + c < n;
      const float p = valid ? exp2f(sS[r * S::LDS + c] - sL[r]) : 0.f;
      sDS[r * S::LDP + c] = __float2bfloat16(p * (sDP[r * S::LDS + c] - sD[r]) * scale);
    }
    __syncthreads();
    mma_ab_acc<DP, S::LDQ, S::LDP, NO>(acc, sDS, sK, rt, wc);  // dQ += dS K
  }
  __syncthreads();  // sS becomes the epilogue's scratch
  store_acc<DP, NO>(dq, acc, sS + warp * 256, b, hh, h, n, d, q0, rt, wc);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dd,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int h, int d,
                     Strides st, float scale_log2, float scale) {
  using S = Smem<DP, true>;
  constexpr int NO = (DP / 16 + kColWarps - 1) / kColWarps;  // dK (and dV) tiles per warp

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + S::TILE);
  bf16* sQ2 = reinterpret_cast<bf16*>(smem + 2 * S::TILE);
  bf16* sDO = reinterpret_cast<bf16*>(smem + 3 * S::TILE);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 4 * S::TILE);
  float* sS = reinterpret_cast<float*>(smem + S::OFF_S);
  float* sDP = reinterpret_cast<float*>(smem + S::OFF_DP);
  bf16* sDS = reinterpret_cast<bf16*>(smem + S::OFF_DS);
  bf16* sP = reinterpret_cast<bf16*>(smem + S::OFF_P);
  float* sL = reinterpret_cast<float*>(smem + S::OFF_L);
  float* sD = reinterpret_cast<float*>(smem + S::OFF_D);

  const int bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, rt = warp % kRowTiles, wc = warp / kRowTiles;

  const bf16* qb = q + b * st.q[0] + hh * st.q[2];
  const bf16* kb = k + b * st.k[0] + hh * st.k[2];
  const bf16* vb = v + b * st.v[0] + hh * st.v[2];
  const bf16* ob = dout + b * st.o[0] + hh * st.o[2];

  load_tile<DP, S::LDQ>(sK, kb, st.k[1], k0, n, d, 0.f);
  load_tile<DP, S::LDQ>(sV, vb, st.v[1], k0, n, d, 0.f);

  Acc acc_dk[NO], acc_dv[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.f);
    wmma::fill_fragment(acc_dv[j], 0.f);
  }

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // the previous tile's products are done with the q-side tiles
    load_tile<DP, S::LDQ>(sQ2, qb, st.q[1], q0, n, d, scale_log2);
    load_tile<DP, S::LDQ>(sQ, qb, st.q[1], q0, n, d, 0.f);
    load_tile<DP, S::LDQ>(sDO, ob, st.o[1], q0, n, d, 0.f);
    load_rows(sL, sD, lse, dd, (long long)bh * n, q0, n);
    __syncthreads();
    mma_abt<DP, S::LDQ, S::LDS>(sS, sK, sQ2, rt, wc);   // S^T  = K q2^T
    mma_abt<DP, S::LDQ, S::LDS>(sDP, sV, sDO, rt, wc);  // dP^T = V dO^T
    __syncthreads();
    // rows are keys, columns queries
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      const bool valid = k0 + r < n && q0 + c < n;
      const float p = valid ? exp2f(sS[r * S::LDS + c] - sL[c]) : 0.f;
      sP[r * S::LDP + c] = __float2bfloat16(p);
      sDS[r * S::LDP + c] = __float2bfloat16(p * (sDP[r * S::LDS + c] - sD[c]) * scale);
    }
    __syncthreads();
    mma_ab_acc<DP, S::LDQ, S::LDP, NO>(acc_dv, sP, sDO, rt, wc);  // dV += P^T dO
    mma_ab_acc<DP, S::LDQ, S::LDP, NO>(acc_dk, sDS, sQ, rt, wc);  // dK += dS^T Q
  }
  __syncthreads();  // sS becomes the epilogue's scratch
  store_acc<DP, NO>(dk, acc_dk, sS + warp * 256, b, hh, h, n, d, k0, rt, wc);
  store_acc<DP, NO>(dv, acc_dv, sS + warp * 256, b, hh, h, n, d, k0, rt, wc);
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *dd;
  bf16 *out0, *out1;  // dQ; or dK and dV
  int B, N, H, D;
  Strides st;
  float scale_log2, scale;
};

template <int DP, bool DKV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = Smem<DP, DKV>::SMEM;
  dim3 grid((a.N + kTile - 1) / kTile, a.B * a.H);
  if constexpr (DKV) {
    auto kern = flash_bwd_dkv_kernel<DP>;
    // once per instantiation (thread-safe static init): allow > 48 KB dynamic smem
    static const cudaError_t attr =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    kern<<<grid, kThreads, smem, stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.dd, a.out0,
                                           a.out1, a.N, a.H, a.D, a.st, a.scale_log2,
                                           a.scale);
  } else {
    auto kern = flash_bwd_dq_kernel<DP>;
    static const cudaError_t attr =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    kern<<<grid, kThreads, smem, stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.dd, a.out0,
                                           a.N, a.H, a.D, a.st, a.scale_log2, a.scale);
  }
  return cudaGetLastError();
}

template <bool DKV>
int dispatch(const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.B <= 0 || a.N <= 0 || a.H <= 0 || a.D % 8 != 0 || a.B * a.H > 65535)
    return (int)cudaErrorInvalidValue;
  // padded head dims: 48/80/160 serve configs/v1.yaml's UNet, 16/32
  // configs/tiny.yaml (ops/flash_attention.py BWD_HEAD_DIMS lists the same);
  // the VAE's d=512 attention is frozen and has no backward
  switch ((a.D + 15) / 16 * 16) {
    case 16:  return (int)launch<16, DKV>(a, s);
    case 32:  return (int)launch<32, DKV>(a, s);
    case 48:  return (int)launch<48, DKV>(a, s);
    case 80:  return (int)launch<80, DKV>(a, s);
    case 160: return (int)launch<160, DKV>(a, s);
    default:  return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dd, void* out0, void* out1, int B, int N,
               int H, int D, const long long* st, float scale_log2, float scale) {
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dd = static_cast<const float*>(dd);
  a.out0 = static_cast<bf16*>(out0);
  a.out1 = static_cast<bf16*>(out1);
  a.B = B; a.N = N; a.H = H; a.D = D;
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = st[i];
    a.st.k[i] = st[3 + i];
    a.st.v[i] = st[6 + i];
    a.st.o[i] = st[9 + i];
  }
  a.scale_log2 = scale_log2;
  a.scale = scale;
  return a;
}

}  // namespace

// q, k, v, dout: bf16 (B, N, H, D), each with element strides (batch, seq,
// head) in `st` (q, k, v, dout in that order) and a unit head-dim stride;
// lse, dd: fp32 (B*H, N) contiguous; outputs bf16 (B, N, H, D) contiguous.
// scale_log2 = d^-1/2 * log2(e) (the q prescale), scale = d^-1/2. Launch on
// `stream`; return the cudaError_t of the launch.
extern "C" int pbe_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* dd,
                                     void* dq, int B, int N, int H, int D,
                                     const long long* st, float scale_log2, float scale,
                                     void* stream) {
  return dispatch<false>(
      make_args(q, k, v, dout, lse, dd, dq, nullptr, B, N, H, D, st, scale_log2, scale),
      stream);
}

extern "C" int pbe_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* dd,
                                      void* dk, void* dv, int B, int N, int H, int D,
                                      const long long* st, float scale_log2, float scale,
                                      void* stream) {
  return dispatch<true>(
      make_args(q, k, v, dout, lse, dd, dk, dv, B, N, H, D, st, scale_log2, scale),
      stream);
}
