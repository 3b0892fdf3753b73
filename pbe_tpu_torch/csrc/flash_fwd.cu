// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax state.
//
// Replaces the Pallas forward kernels of pbe_tpu/ops/flash_attention.py that
// the 512^2 edit reaches: _flash_kernel_rowblock (UNet self-attention,
// (B*8, N, d) = (16, 4096, 40), (16, 1024, 80), (16, 256, 160), (16, 64, 160))
// and _flash_kernel, the streamed variant (VAE mid-block attention,
// (1, 4096, 512)). Same function, same contracts:
//   * q is prescaled by d^-1/2 * log2(e) in fp32 and rounded to bf16, so the
//     scores come out of the product in the exp2 domain (exp2f below);
//   * P is cast to bf16 before the PV product; the output is divided by l;
//   * optional LSE = m + log2(l), fp32, (B*H, N), log2 domain.
//
// Design. One block of 4 warps per (batch*head, q-tile); a loop over k-tiles
// inside the block takes the place of the TPU's sequential grid axis, with
// the online-softmax state (m, l, O accumulator) in fp32 shared memory.
// Products run on the tensor cores through nvcuda::wmma bf16 16x16x16
// fragments. Head dims are padded to a multiple of 16 in shared memory only,
// by zero-filled loads (40 -> 48); ragged sequence tails are zero-filled and
// their scores masked to -inf, so no padded copy exists in device memory.
// Inputs are (B, N, H, D) with explicit strides: no transpose copy.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): 4*BH*N^2*d FLOP
// (ds1 42.9 GFLOP -> 43 us; VAE 34.4 GFLOP -> 35 us), the tensor-core rate
// binds at ds2 and the VAE shape and the bytes at ds4/ds8; at d=40 the
// BH*N^2 = 268M exp2 per ds1 call at ~3.9 TFLOP/s of special-function
// throughput (69 us) binds before the products.
// This first version is simple, not fast: S and P round-trip through shared
// memory, the accumulator lives in shared memory, loads are synchronous.
// wgmma/TMA pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cmath>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <int DP, int BQ, int BK>
struct Tile {
  static constexpr int LDQ = DP + 8;  // bf16 row pitch of Q/K/V tiles
  static constexpr int LDS = BK + 4;  // fp32 row pitch of S
  static constexpr int LDP = BK + 8;  // bf16 row pitch of P
  static constexpr int LDO = DP + 4;  // fp32 row pitch of the accumulator
  static constexpr size_t OFF_Q = 0;
  static constexpr size_t OFF_K = align128(OFF_Q + size_t(BQ) * LDQ * 2);
  static constexpr size_t OFF_V = align128(OFF_K + size_t(BK) * LDQ * 2);
  static constexpr size_t OFF_S = align128(OFF_V + size_t(BK) * LDQ * 2);
  static constexpr size_t OFF_P = align128(OFF_S + size_t(BQ) * LDS * 4);
  static constexpr size_t OFF_O = align128(OFF_P + size_t(BQ) * LDP * 2);
  static constexpr size_t OFF_M = align128(OFF_O + size_t(BQ) * LDO * 4);
  static constexpr size_t OFF_L = OFF_M + size_t(BQ) * 4;
  static constexpr size_t SMEM = OFF_L + size_t(BQ) * 4;
  static_assert(DP % 16 == 0 && BQ % 16 == 0 && BK % 32 == 0, "tile shape");
  static_assert(SMEM <= 232448, "shared memory per block");
};

// rows [r0, r0+ROWS) of one head into a (ROWS x LD) bf16 tile; rows >= n and
// columns >= d are zero. 16-byte chunks: d % 8 == 0 and 16-byte aligned rows
// are checked by the wrapper. With scale != 0 the values are multiplied by
// scale in fp32 and rounded back to bf16 (the q prescale).
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int r0, int n, int d, float scale) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
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

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int n, int h, int d,
                 long long q_sb, long long q_sn, long long q_sh,
                 long long k_sb, long long k_sn, long long k_sh,
                 long long v_sb, long long v_sn, long long v_sh, float scale) {
  using T = Tile<DP, BQ, BK>;
  constexpr int RT = BQ / 16;        // 16-row tiles of the q block
  constexpr int WC = kWarps / RT;    // warps sharing one row tile
  constexpr int CTS = BK / 16;       // column tiles of S
  constexpr int CTO = DP / 16;       // column tiles of O
  constexpr int NS = CTS / WC;       // S tiles per warp
  constexpr int NO = (CTO + WC - 1) / WC;  // O tiles per warp (at most)
  constexpr int CHUNK = 4;           // O fragments held in registers at once
  static_assert(kWarps % RT == 0 && CTS % WC == 0, "warp layout");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + T::OFF_Q);
  bf16* sK = reinterpret_cast<bf16*>(smem + T::OFF_K);
  bf16* sV = reinterpret_cast<bf16*>(smem + T::OFF_V);
  float* sS = reinterpret_cast<float*>(smem + T::OFF_S);
  bf16* sP = reinterpret_cast<bf16*>(smem + T::OFF_P);
  float* sO = reinterpret_cast<float*>(smem + T::OFF_O);
  float* sM = reinterpret_cast<float*>(smem + T::OFF_M);
  float* sL = reinterpret_cast<float*>(smem + T::OFF_L);

  const int bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rt = warp % RT, wc = warp / RT;

  const bf16* qb = q + b * q_sb + hh * q_sh;
  const bf16* kb = k + b * k_sb + hh * k_sh;
  const bf16* vb = v + b * v_sb + hh * v_sh;

  load_tile<BQ, DP, T::LDQ>(sQ, qb, q_sn, q0, n, d, scale);
  for (int i = threadIdx.x; i < BQ * T::LDO; i += kThreads) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // previous PV product done with sV / sP
    load_tile<BK, DP, T::LDQ>(sK, kb, k_sn, k0, n, d, 0.f);
    load_tile<BK, DP, T::LDQ>(sV, vb, v_sn, k0, n, d, 0.f);
    __syncthreads();

    // S = Q K^T: this warp's row tile rt, column tiles wc, wc+WC, ...
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sQ + rt * 16 * T::LDQ + kk, T::LDQ);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          // K^T as a col-major (d x keys) operand is K row-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, sK + (wc + j * WC) * 16 * T::LDQ + kk, T::LDQ);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
        wmma::store_matrix_sync(sS + rt * 16 * T::LDS + (wc + j * WC) * 16, acc[j],
                                T::LDS, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax, one warp per row: new max, P = exp2(S - m) as bf16,
    // l = l * alpha + rowsum(P) in fp32, and the accumulator row scaled by alpha
    const int kv = min(BK, n - k0);
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
    __syncthreads();

    // O += P V: this warp's row tile rt, column tiles wc, wc+WC, ... in
    // chunks of CHUNK fragments loaded from and stored back to sO
#pragma unroll
    for (int j0 = 0; j0 < NO; j0 += CHUNK) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int ct = wc + (j0 + j) * WC;
        if (j0 + j < NO && ct < CTO)
          wmma::load_matrix_sync(acc[j], sO + rt * 16 * T::LDO + ct * 16, T::LDO,
                                 wmma::mem_row_major);
      }
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sP + rt * 16 * T::LDP + kk, T::LDP);
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          const int ct = wc + (j0 + j) * WC;
          if (j0 + j < NO && ct < CTO) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, sV + kk * T::LDQ + ct * 16, T::LDQ);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int ct = wc + (j0 + j) * WC;
        if (j0 + j < NO && ct < CTO)
          wmma::store_matrix_sync(sO + rt * 16 * T::LDO + ct * 16, acc[j], T::LDO,
                                  wmma::mem_row_major);
      }
    }
  }
  __syncthreads();

  // epilogue: O / l to bf16, (B, N, H, D) contiguous; LSE in the log2 domain
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
    *reinterpret_cast<uint4*>(o + ((long long)(b * n + q0 + r) * h + hh) * d + c) = val;
  }
  if (lse != nullptr)
    for (int r = threadIdx.x; r < BQ; r += kThreads)
      if (q0 + r < n) lse[(long long)bh * n + q0 + r] = sM[r] + log2f(sL[r]);
}

template <int DP, int BQ, int BK>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                   int B, int N, int H, int D, const long long* st, float scale,
                   cudaStream_t stream) {
  using T = Tile<DP, BQ, BK>;
  auto kern = flash_fwd_kernel<DP, BQ, BK>;
  // once per instantiation (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kern<<<grid, kThreads, T::SMEM, stream>>>(q, k, v, o, lse, N, H, D, st[0], st[1], st[2],
                                             st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 (B, N, H, D) with element strides (batch, seq, head) each and a
// unit head-dim stride; o: bf16 (B, N, H, D) contiguous; lse: fp32 (B*H, N) or
// null. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int pbe_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int N, int H, int D,
                                  long long q_sb, long long q_sn, long long q_sh,
                                  long long k_sb, long long k_sn, long long k_sh,
                                  long long v_sb, long long v_sn, long long v_sh,
                                  float scale, void* stream) {
  const long long st[9] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || H <= 0 || D % 8 != 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  // padded head dims: 48/80/160/512 serve configs/v1.yaml, 16/32 configs/tiny.yaml
  // (ops/flash_attention.py SUPPORTED_HEAD_DIMS lists the same)
  switch ((D + 15) / 16 * 16) {
    case 16:  return (int)launch<16, 64, 64>(qp, kp, vp, op, lp, B, N, H, D, st, scale, s);
    case 32:  return (int)launch<32, 64, 64>(qp, kp, vp, op, lp, B, N, H, D, st, scale, s);
    case 48:  return (int)launch<48, 64, 64>(qp, kp, vp, op, lp, B, N, H, D, st, scale, s);
    case 80:  return (int)launch<80, 64, 64>(qp, kp, vp, op, lp, B, N, H, D, st, scale, s);
    case 160: return (int)launch<160, 64, 32>(qp, kp, vp, op, lp, B, N, H, D, st, scale, s);
    case 512: return (int)launch<512, 32, 32>(qp, kp, vp, op, lp, B, N, H, D, st, scale, s);
    default:  return (int)cudaErrorInvalidValue;
  }
}
