// Flash attention at fp32 for Hopper (sm_90a): the forward, its resident
// and pipelined variants, and the dQ and dK/dV kernels for fp32 operands.
//
// The Pallas kernels of pbe_tpu/ops/flash_attention.py run in their
// operands' dtype: at fp32 (the JAX CLIs' --precision full, and the JAX
// package's own tests of every variant) q/k/v stay fp32 and the casts of P
// and dS before their products (:101, :159, :253, :436, :471, :480) do
// nothing. These kernels are that case:
//   pbe_flash_fwd_f32        K1 _flash_kernel_rowblock (:85) and K2
//                            _flash_kernel (:218), via _flash_fwd_bhnd (:282):
//                            the UNet's d = 40/80/160 and the VAE's 512
//   pbe_flash_resident_f32   K3 _flash_kernel_resident (:182)
//   pbe_flash_pipelined_f32  K4 _flash_kernel_pipelined (:111)
//   pbe_flash_bwd_dq_f32     K5 _flash_bwd_dq_kernel (:408), via
//                            _flash_bwd_bhnd (:490)
//   pbe_flash_bwd_dkv_f32    K6 _flash_bwd_dkv_kernel (:445)
// and compute, with every value fp32 and nothing rounded to a narrower type:
//   q2 = q * d^-1/2 * log2(e)
//   forward:  S = q2 K^T, P = exp2(S - m), O = (P V) / l, LSE = m + log2(l)
//   backward: P = exp2(q2 K^T - LSE), dS = P (dO V^T - D) d^-1/2,
//             dQ = dS K, dK = dS^T Q, dV = P^T dO   (D = rowsum(dO * O))
// ops/flash_attention.py's flash_attention_plain and
// flash_attention_bwd_plain compute the same at fp32. The arguments are
// the bf16 twins' (csrc/flash_fwd.cu, csrc/flash_variants.cu,
// csrc/flash_bwd.cu): strided (B, N, H, D) operands, the LSE and D as (B*H,
// N) fp32 with the LSE in the log2 domain, outputs contiguous (B, N, H, D).
// Every output tile has one owner: no atomics, and a repeated launch gives
// the same bits.
//
// The forward (flash_fwd_f32_kernel at d <= 160, flash_fwd_wide_f32_kernel
// at 512) keeps S on the SIMT cores' fp32 FMA and puts P V on the tensor
// cores as 3xTF32:
//   * S stays on FFMA, bit for bit the backward's: every score is one fmaf
//     chain over the head dim from column 0 (score_step, in abt's and
//     scores_c's order), so the fp32 dQ and dK/dV kernels recompute the
//     forward's S exactly. A one-ulp shift of an exponent of a few hundred
//     (peaked scores) moves P past phase 20's tolerance, so S is never
//     re-associated or moved to the tensor cores (that would move the
//     backward's S with it).
//   * S is computed in the mma's C layout: a warp scores 16 MT rows x 8 NT
//     keys, lane (g, t) rows g + 8h (+ 16 mt) and keys 2t, 2t + 1 (+ 8 nt).
//     Per 4 head-dim columns a lane loads 2 MT + 2 NT float4 for 16 MT NT
//     FMA; the pitch DP + 4 puts the 8 A rows of a load (and the 4 B rows)
//     in distinct bank groups, one wavefront each.
//   * P V runs as mma.sync.m16n8k8 tf32 with fp32 accumulators in 3xTF32
//     (1xTF32 keeps ~3 decimal digits, too few for an fp32 result): each
//     operand splits into hi = tf32(x) and lo = x - hi, and a product is lo
//     hi + hi lo + hi hi. The tensor cores add with truncation, so each
//     output tile sums at most kChain = 8 k8 steps into a zeroed partial
//     (a key tile of <= 64 keys at d <= 160, one k8 step at 512), which
//     then joins O in fp32. P's C fragment is the A fragment as it stands
//     (a k8 step's slot t takes key 2t and slot t + 4 key 2t + 1), so with
//     SPLIT 1 P never leaves the registers; row max and row sum are xor
//     shuffles over the quad of lanes sharing a row.
//   * Where O's head dim is split over SPLIT warps (d = 80, 160, 512: O and
//     the partials would not fit one warp's registers), those warps score
//     1/SPLIT of each key tile, their row maxima meet in shared memory (one
//     group barrier a tile) and P goes there once; each warp multiplies
//     the group's P into its slice of O.
//   * The FMA and tensor-core work interleave in one instruction stream:
//     at d <= 160 the P V of key tile j runs one k8 step every CPK column
//     steps of tile j + 1's scores; at d = 512 each step of the ring holds
//     tile j + 1's K chunk s (64 keys x 64 columns) and tile j's V chunk s
//     (8 keys x 512 columns). m, l and O stay in registers.
//   * Key tiles arrive by cp.async (compile-time chunks a thread: index
//     arithmetic once, not per tile) into a ring: 3 stages at d <= 160
//     (tile j's V, tile j + 1's K, tile j + 2 in flight), 2 at 512 (the
//     next step in flight); one block barrier a tile (a step at 512).
//     Keys past N get S = -inf in the last tile; rows past N are
//     zero-filled and never stored.
//   * Exponentials run on the SFU (ex2.approx.ftz): a P below 2^-126 of its
//     row's maximum flushes to 0.
// K3, K4 and the dQ kernel run all their products on the SIMT cores' FMA:
//   * Tiles are fp32 in shared memory, row-major with a pitch of DP + 4
//     floats, read as float4. 256 threads: thread t = 16 ty + tx owns rows
//     ty + 16 i of every tile it computes and columns tx + 16 j (scores) or
//     VW tx + 16 VW j + e (head dim, VW = 4/2/1 by padded head dim), so
//     the 16 lanes sharing a row are one half-warp: row max and row sum
//     are 4 xor shuffles, and every lane ends with the same bits.
//   * abt: a product A B^T of two row-major tiles (S = q2 K^T); per 4
//     columns of the head dim a thread loads TM + TN float4 and does 4 TM
//     TN FMA, each score one fmaf chain over the head dim from column 0.
//     ab: a score tile times a row-major operand (P V) into the register
//     accumulator. m, l and O stay in registers (online softmax,
//     softmax_tile); P goes through a (rows x BK) shared tile between the
//     two products.
//   * K3 (flash_resident_f32_kernel): a thread-block cluster of C = 1, 2 or 4 blocks
//     (neighbouring q tiles of one head) shares each key tile: a producer
//     warp a block copies rows r, r + C, ... of the tile's K and V (rank r)
//     by cp.async.bulk ... multicast::cluster into the same offset of every
//     block's ring of up to 3 stages; full/empty mbarriers (empty released
//     by remote arrives of the C x 8 consumer warps); P double-buffered with
//     one named barrier of the 256 consumers a tile. The ring is zeroed
//     once, so rows past N hold zeros or an earlier tile's finite values.
//   * K4 (flash_pipelined_f32_kernel): pass 1 takes the row max over every
//     chunk of block_c keys (K only, no exp2), pass 2 forms P = exp2(S -
//     m_final) with no rescale and sums l and P V; chunks arrive by
//     cp.async into a 2-stage ring (1 where two do not fit), the next in
//     flight while this one is computed. At d = 512 with block_c 64, pass 2
//     takes each chunk's K and V in two halves of 32 keys, as 64 rows of
//     both do not fit beside q. It does the S product twice: 6 BH N^2 D.
// The backward:
//   * dQ (flash_bwd_dq_f32_kernel) keeps the plain version's order on FMA:
//     q2 and dO of BQ rows resident, S and dP by abt, dS through shared
//     memory, dQ += dS K by ab, each element one fmaf chain in key order
//     (cuBLAS's, so dQ is bit for bit the plain version's at the training
//     shapes). K and V tiles arrive by cp.async into a 2-stage ring, the
//     next in flight while this one is computed (one stage where two would
//     halve the blocks an SM), 2 barriers a tile. Its products stay off the
//     tensor cores: on chip_smoke.py phase 20's rising-max inputs a dS row
//     sums to 0 against a key column that grows with the key, and dQ there
//     sits past rel L2 1e-5 of the plain version under any other order of
//     the fp32 sums, 3xTF32 or not (phase 20 logs these controls).
//   * dK/dV (flash_bwd_dkv_f32_kernel) puts every product but S on the
//     tensor cores: dP^T = V dO^T, dV += P^T dO and dK += dS^T q2 as
//     mma.sync.m16n8k8 tf32 with fp32 accumulators in 3xTF32: each operand
//     splits into hi = tf32(x) (cvt.rna's rounding) and lo = x - hi, and a
//     product is lo hi + hi lo + hi hi. The tensor cores add with
//     truncation, so each product sums at most 8 k8 steps into zeroed
//     partials (hi hi in one, the small terms in another: two chains of
//     dependent mma), which join the result in fp32.
//   * S^T stays on FFMA and equals the forward's bit for bit: each score is
//     one fmaf chain over the head dim from column 0 (scores_c, abt's
//     order), q2 the forward's prescaled q. A one-ulp shift of an exponent
//     of a few hundred (peaked scores) moves P by far more than the
//     tolerance, so S is never re-associated or moved to the tensor cores.
//     scores_c computes S^T in the mma's C layout, so it meets dP^T in
//     registers; and as a k8 step's slot t may take query 2t and slot t + 4
//     query 2t + 1, the C fragment of P^T or dS^T is the A fragment of the
//     next product as it stands. A warp owns 16 keys; q tiles (q scaled
//     into q2 by the threads that copied it) with their LSE and D arrive by
//     cp.async into a 2-stage ring, one barrier a tile.
//   * At d = 160 and 512 the head dim of dK and dV is split over SPLIT
//     warps (2 or 4): each scores 1/SPLIT of the q tile, P^T and dS^T meet
//     in shared memory, and each warp multiplies them into its slice (at
//     512, 8 n8 tiles at a time). At d = 512 a block is 16 keys: K and V
//     take 66 KB, one stage of q2 and dO 132 KB, one block an SM.
// Tiles (rows a block x streamed rows; ring stages), shared memory:
//   forward  <DP, MT, RG, SPLIT, BK> / wide <MT, RG, SPLIT, CK, CW>; a
//            warp scores 16 MT rows x BK / SPLIT keys; shared-memory
//            wavefronts a clock when the FMA pipes run at their full rate
//            (4 warp FFMA a clock an SM), S's loads alone / with P V's
//            loads, P's trip through shared memory and the cp.async writes:
//     d 8, 16     128 x 32, 3 stages, 4 warps    25,600 B  0.38 / 0.56-0.63
//     d 24, 32    128 x 32, 3, 4                 46,080 B  0.38 / 0.56-0.58
//     d 40, 48    128 x 32, 3, 4                 66,560 B  0.38 / 0.56-0.58
//     d 72, 80    64 x 32, 3, 4 (SPLIT 2)       107,008 B  0.50 / 0.90-0.94
//     d 152, 160  N <= 256: 32 x 32, 3, 8 (MT 1, SPLIT 4)  157,696 B  1.00 / 1.63
//                 N > 256:  64 x 32, 3, 8 (SPLIT 4)        189,440 B  0.75 / 1.13
//     d 504, 512  64 x 64 in 8 steps, 2, 8 (SPLIT 4)       219,392 B  0.50 / 0.79;
//                 where 64-row tiles would number fewer than the SMs,
//                 32 x 64, 2, 8 (SPLIT 8)                  144,128 B  0.75 / 1.20
//            The tiles past one wavefront a clock won on the card where the
//            grid, not the FMA rate, binds (ds4 and ds8, the VAE at batch 1
//            and first-stage training): more warps an SM there beat fewer
//            loads a FMA. Wider score tiles at d >= 160 spill (O and its
//            partials take 8 MT NO registers).
//   dQ       DP <= 32: 64 x 64, 2;  48: 128 x 64, 2;  80: 64 x 64, 1;
//            160: 64 x 32, 2 (N <= 128: 32 x 32, 1);  512: 32 x 16, 1
//            (200,704 B)
//   dK/dV    DP <= 80: 64 x 32, 2 (4 warps);  160: 64 x 32, 2 (8 warps;
//            N <= 128: 32 x 32, 2, 4 warps);  512: 16 x 32, 1 (4 warps;
//            203,520 B)
// Bound on an H100 SXM at fp32 accuracy: S (2 BH N^2 d FLOP) on fp32 FMA
// (132 SMs x 128 lanes x 2 x 1.98 GHz = 66.9 TFLOP/s), the other products
// as 3xTF32 (495 TFLOP/s of TF32) beside it: the forward's P V (2 BH N^2 d)
// as 6, the dQ kernel's 4 BH N^2 d as 12, the dK/dV kernel's 6 as 18. S
// binds the forward (K1 at (2, 4096, 8, 40): 0.32 ms; all on FMA 0.64 ms)
// and the dQ kernel (0.64 ms at (4, 4096, 8, 40); all-FMA 1.93 ms); dK/dV
// 0.78 ms there. chip_smoke.py states these bounds (bound_3xtf32); phases
// 20 and 11 hold each kernel against its plain version and time it beside
// its bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"  // cp.async, mbarriers, bulk copies, clusters

namespace {

constexpr size_t kSmemPerBlock = 232448;  // bytes of shared memory a block can use
constexpr int kSms = 132;                 // SMs of an H100 SXM
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += x . y as four fmaf in column order
__device__ __forceinline__ void fma4(float& acc, const float4& x, const float4& y) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  acc = fmaf(x.w, y.w, acc);
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

// rows [r0, r0 + ROWS) of operand i's head bh into a (ROWS x DP + 4) tile
// by 16-byte cp.async copies issued by NT threads (this one at threadIdx.x
// < NT), not waited for; rows >= N and columns >= D are zero-filled (D % 8
// == 0 and 16-byte aligned rows are checked by the wrapper)
template <int DP, int ROWS, int NT = THREADS>
__device__ __forceinline__ void copy_tile(float* dst, const Args& a, int i, int bh, int r0) {
  constexpr int LD = DP + 4, CH = DP / 4;
  const float* src = head(a, i, bh);
  const long long rs = a.st[3 * i + 1];
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 4;
    const bool valid = r0 + r < a.N && c < a.D;
    cp_async16(dst + r * LD + c, valid ? src + (long long)(r0 + r) * rs + c : src, valid);
  }
}

// the chunks of a tile that this thread copied by copy_tile<DP, ROWS, NT>
// multiplied by mul, once its wait has made them visible to it
template <int DP, int ROWS, int NT = THREADS>
__device__ __forceinline__ void scale_tile(float* dst, float mul) {
  constexpr int LD = DP + 4, CH = DP / 4;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    float4* v = reinterpret_cast<float4*>(dst + (idx / CH) * LD + (idx % CH) * 4);
    *v = make_float4(v->x * mul, v->y * mul, v->z * mul, v->w * mul);
  }
}

// copy_tile, waited for, times mul; the caller's next barrier publishes it
template <int DP, int ROWS, int NT = THREADS>
__device__ __forceinline__ void load_tile(float* dst, const Args& a, int i, int bh, int r0,
                                          float mul) {
  copy_tile<DP, ROWS, NT>(dst, a, i, bh, r0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (mul != 1.f) scale_tile<DP, ROWS, NT>(dst, mul);
}

// 4 bytes from src into shared memory, or 0 where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
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
    for (int i = 0; i < TM; ++i) x[i] = ld4(A + (ty + RT * i) * lda + c);
#pragma unroll
    for (int j = 0; j < TN; ++j) y[j] = ld4(B + (tx + CT * j) * ldb + c);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) fma4(acc[i][j], x[i], y[j]);
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
    for (int i = 0; i < TM; ++i) x[i] = ld4(A + (ty + RT * i) * lda + k);
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

// One online-softmax step over a TM x TN score tile of keys from k0 (n
// keys in all): keys past n to -inf, the row max over the half-warp, l and
// o rescaled by exp2(m_old - m_new), P = exp2(S - m) into sP (pitch ldp)
// and its row sum added to l
template <int TM, int TN, int NC>
__device__ __forceinline__ void softmax_tile(float (&s)[TM][TN], float* sP, int ldp,
                                             float (&m)[TM], float (&l)[TM], float (&o)[TM][NC],
                                             int k0, int n, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (k0 + tx + CT * j >= n) s[i][j] = -INFINITY;  // keys past N
      mx = fmaxf(mx, s[i][j]);
    }
    const float mn = fmaxf(m[i], half_warp_max(mx));  // finite: key k0 < N is in
    const float alpha = exp2f(m[i] - mn);              // 0 at the first tile
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float p = exp2f(s[i][j] - mn);
      sP[(ty + RT * i) * ldp + tx + CT * j] = p;
      sum += p;
    }
    l[i] = l[i] * alpha + half_warp_sum(sum);
    m[i] = mn;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
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

// the forward's LSE m + log2(l) of rows [r0, r0 + RT TM), where asked for
template <int TM>
__device__ __forceinline__ void store_lse(const Args& a, int bh, int r0, const float (&m)[TM],
                                          const float (&l)[TM], int ty, int tx) {
  if (a.lse_out == nullptr || tx != 0) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + ty + RT * i;
    if (row < a.N) a.lse_out[(long long)bh * a.N + row] = m[i] + log2f(l[i]);
  }
}

// --- K3, resident: the forward's tiles and softmax step over key tiles of
// BK that the blocks of a cluster share

// the key blocks instantiated at each padded head dim; ops/flash_attention.py
// RESIDENT_BLOCKS_F32 lists the same
constexpr bool resident_f32_instantiated(int dp, int bk) {
  return (bk < 128 || dp <= 48) && (dp < 512 || bk == 32);
}

template <int DP, int BK>
struct ResF32 {
  static constexpr int BQ = DP == 512 ? 32 : 64, TM = BQ / RT, TN = BK / CT;
  static constexpr int LD = DP + 4, LDP = BK + 4, TE = BK * LD;  // TE: floats of a K or V tile
  static constexpr size_t STAGE = 2 * size_t(TE) * 4;             // bytes of K and V
  static constexpr size_t FIXED = (size_t(BQ) * LD + 2 * size_t(BQ) * LDP) * 4;  // q, P x 2
  static constexpr int STAGES = FIXED + 3 * (STAGE + 16) <= kSmemPerBlock   ? 3
                                : FIXED + 2 * (STAGE + 16) <= kSmemPerBlock ? 2
                                                                            : 1;
  static constexpr size_t OFF_KV = size_t(BQ) * LD * 4;
  static constexpr size_t OFF_P = OFF_KV + STAGES * STAGE;
  static constexpr size_t OFF_BAR = OFF_P + 2 * size_t(BQ) * LDP * 4;
  static constexpr size_t SMEM = OFF_BAR + 2 * STAGES * 8;
  static_assert(BQ % RT == 0 && BK % CT == 0 && SMEM <= kSmemPerBlock, "resident tile");
};

// The producer warp: key tiles [0, tiles) of head bh's K and V into stage j
// % STAGES of every block's ring (K at 2 stage TE, V at + TE). This block
// (rank r of C) copies rows r, r + C, ... of the tile's K, then of its V,
// one bulk copy a row multicast to all C blocks; each block's full barrier
// expects the whole tile's bytes. A stage is refilled once this block's
// empty barrier has had every consumer warp of the cluster.
template <int DP, int BK>
__device__ __forceinline__ void produce(float* ring, uint64_t* bars, const Args& a, int bh) {
  using T = ResF32<DP, BK>;
  constexpr int STAGES = T::STAGES;
  const int lane = threadIdx.x % 32, n = a.N;
  const int rank = (int)cluster_rank(), csize = (int)cluster_blocks();
  const uint16_t mask = csize == 1 ? 0 : (uint16_t)((1u << csize) - 1);
  const float* kb = head(a, 1, bh);
  const float* vb = head(a, 2, bh);
  const uint32_t row_bytes = a.D * 4;  // a multiple of 32: d % 8 == 0
  const int tiles = (n + BK - 1) / BK;
  for (int j = 0; j < tiles; ++j) {
    const int s = j % STAGES, rows = min(BK, n - j * BK);
    if (j >= STAGES) mbar_wait(&bars[STAGES + s], (j / STAGES - 1) & 1);
    if (lane == 0) mbar_expect_tx(&bars[s], 2 * rows * row_bytes);
    float* stage = ring + s * 2 * T::TE;
    for (int i = rank + csize * lane; i < 2 * rows; i += 32 * csize) {
      const bool is_v = i >= rows;
      const int r = is_v ? i - rows : i;
      const long long row = j * BK + r;
      bulk_copy(stage + (is_v ? T::TE : 0) + r * T::LD,
                is_v ? vb + row * a.st[7] : kb + row * a.st[4], row_bytes, &bars[s], mask);
    }
  }
}

template <int DP, int BK>
__global__ void __launch_bounds__(THREADS + 32, 1) flash_resident_f32_kernel(const Args a) {
  using T = ResF32<DP, BK>;
  using C = Cols<DP>;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* sQ = reinterpret_cast<float*>(smem);
  float* ring = reinterpret_cast<float*>(smem + T::OFF_KV);
  float* sP = reinterpret_cast<float*>(smem + T::OFF_P);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + T::OFF_BAR);  // full, then empty
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N;
  // set-up: the ring zeroed (bulk copies write only columns [0, d) of rows
  // before N), the barriers initialised (full: one arrival, this block's
  // expect_tx; empty: the cluster's consumer warps) and the q tile loaded
  // by the consumers; then a cluster sync, after which any block may copy
  // into any other's ring and arrive on its barriers
  for (int i = threadIdx.x; i < int(T::STAGES * T::STAGE / 16); i += THREADS + 32)
    smem4[T::OFF_KV / 16 + i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0)
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&bars[s], 1);
      mbar_init(&bars[T::STAGES + s], cluster_blocks() * (THREADS / 32));
    }
  if (threadIdx.x < THREADS) load_tile<DP, T::BQ>(sQ, a, 0, bh, q0, a.scale_log2);
  fence_barrier_init();
  cluster_sync();

  if (threadIdx.x >= THREADS) {
    produce<DP, BK>(ring, bars, a, bh);
  } else {
    const int tx = threadIdx.x % CT, ty = threadIdx.x / CT, lane = threadIdx.x % 32;
    float o[T::TM][C::N], m[T::TM], l[T::TM];
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < C::N; ++c) o[i][c] = 0.f;
    }
    const int tiles = (n + BK - 1) / BK;
    for (int j = 0; j < tiles; ++j) {
      const int s = j % T::STAGES;
      mbar_wait(&bars[s], (j / T::STAGES) & 1);
      const float* sK = ring + s * 2 * T::TE;
      float* sPj = sP + (j & 1) * T::BQ * T::LDP;  // P of tile j - 2 is read: the barrier below
      float sc[T::TM][T::TN] = {};
      abt<T::TM, T::TN>(sc, sQ, T::LD, sK, T::LD, a.D, ty, tx);
      softmax_tile<T::TM, T::TN, C::N>(sc, sPj, T::LDP, m, l, o, j * BK, n, ty, tx);
      // the consumers' barrier: P is whole
      asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
      ab<T::TM, DP, BK>(o, sPj, T::LDP, sK + T::TE, T::LD, ty, tx);
      // this warp is done with the stage: one arrival on its empty barrier
      // in every block of the cluster
      __syncwarp();
      if (lane < (int)cluster_blocks()) mbar_arrive_remote(&bars[T::STAGES + s], lane);
    }
    store_rows<T::TM, DP>(a.out[0], a, bh, q0, o, l, ty, tx);
    store_lse<T::TM>(a, bh, q0, m, l, ty, tx);
  }
  cluster_sync();  // no block leaves while a peer may still copy into it
}

// --- K4, pipelined: pass 1 the row max over chunks of BC keys, pass 2 P
// against the final max

// the key chunks instantiated at each padded head dim; ops/flash_attention.py
// PIPELINED_BLOCKS_F32 lists the same
constexpr bool pipelined_f32_instantiated(int dp, int bc) { return bc < 128 || dp <= 80; }

// shared memory of the pipelined kernel: q (bq rows), `stages` stages of a
// chunk of K (bc rows) or K and V of `sub` keys, and P (bq x sub)
constexpr size_t pipe_bytes(int dp, int bq, int bc, int sub, int stages) {
  return (size_t(bq) * (dp + 4) + size_t(stages) * (bc > 2 * sub ? bc : 2 * sub) * (dp + 4) +
          size_t(bq) * (sub + 4)) * 4;
}

template <int DP, int BC>
struct PipeF32 {
  static constexpr int BQ = DP == 512 ? 32 : 64, TM = BQ / RT, LD = DP + 4;
  // keys of a pass-2 step: the chunk, or half of it where its K and V do
  // not fit beside q
  static constexpr int SUB = pipe_bytes(DP, BQ, BC, BC, 1) <= kSmemPerBlock ? BC : BC / 2;
  static constexpr int STAGES = pipe_bytes(DP, BQ, BC, SUB, 2) <= kSmemPerBlock ? 2 : 1;
  static constexpr int TN1 = BC / CT, TN2 = SUB / CT, LDP = SUB + 4;
  static constexpr int STAGE = (BC > 2 * SUB ? BC : 2 * SUB) * LD;  // floats of a stage
  static constexpr size_t OFF_KV = size_t(BQ) * LD * 4;
  static constexpr size_t OFF_P = OFF_KV + size_t(STAGES) * STAGE * 4;
  static constexpr size_t SMEM = pipe_bytes(DP, BQ, BC, SUB, STAGES);
  static_assert(BQ % RT == 0 && SUB % CT == 0 && SMEM <= kSmemPerBlock, "pipelined tile");
};

template <int DP, int BC>
__global__ void __launch_bounds__(THREADS) flash_pipelined_f32_kernel(const Args a) {
  using T = PipeF32<DP, BC>;
  using C = Cols<DP>;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* sQ = reinterpret_cast<float*>(smem);
  float* ring = reinterpret_cast<float*>(smem + T::OFF_KV);
  float* sP = reinterpret_cast<float*>(smem + T::OFF_P);
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N;
  const int tx = threadIdx.x % CT, ty = threadIdx.x / CT;
  const int chunks = (n + BC - 1) / BC, subs = (n + T::SUB - 1) / T::SUB;
  const int steps = chunks + subs;  // pass 1 over chunks, pass 2 over SUB-key steps

  // step i's keys into stage i % STAGES: a chunk of K in pass 1, K and V
  // of SUB keys in pass 2
  auto issue = [&](int i) {
    float* stage = ring + (i % T::STAGES) * T::STAGE;
    if (i < chunks) {
      copy_tile<DP, BC>(stage, a, 1, bh, i * BC);
    } else {
      copy_tile<DP, T::SUB>(stage, a, 1, bh, (i - chunks) * T::SUB);
      copy_tile<DP, T::SUB>(stage + T::SUB * T::LD, a, 2, bh, (i - chunks) * T::SUB);
    }
    cp_async_commit();
  };
  issue(0);
  load_tile<DP, T::BQ>(sQ, a, 0, bh, q0, a.scale_log2);

  float o[T::TM][C::N], m[T::TM], l[T::TM];
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::N; ++c) o[i][c] = 0.f;
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait_all();
    // step i's keys are visible to every thread, and every thread is done
    // with step i - 1's stage and P
    __syncthreads();
    if (T::STAGES > 1 && i + 1 < steps) issue(i + 1);
    const float* stage = ring + (i % T::STAGES) * T::STAGE;
    if (i < chunks) {
      const int k0 = i * BC;
      float s[T::TM][T::TN1] = {};
      abt<T::TM, T::TN1>(s, sQ, T::LD, stage, T::LD, a.D, ty, tx);
#pragma unroll
      for (int r = 0; r < T::TM; ++r)
#pragma unroll
        for (int j = 0; j < T::TN1; ++j)
          if (k0 + tx + CT * j < n) m[r] = fmaxf(m[r], s[r][j]);
      if (i == chunks - 1)  // pass 1 is done: the final row max
#pragma unroll
        for (int r = 0; r < T::TM; ++r) m[r] = half_warp_max(m[r]);
    } else {
      const int k0 = (i - chunks) * T::SUB;
      float s[T::TM][T::TN2] = {};
      abt<T::TM, T::TN2>(s, sQ, T::LD, stage, T::LD, a.D, ty, tx);
#pragma unroll
      for (int r = 0; r < T::TM; ++r)
#pragma unroll
        for (int j = 0; j < T::TN2; ++j) {
          const float p = k0 + tx + CT * j < n ? exp2f(s[r][j] - m[r]) : 0.f;
          sP[(ty + RT * r) * T::LDP + tx + CT * j] = p;
          l[r] += p;
        }
      __syncthreads();  // P is whole
      ab<T::TM, DP, T::SUB>(o, sP, T::LDP, stage + T::SUB * T::LD, T::LD, ty, tx);
    }
    if (T::STAGES == 1 && i + 1 < steps) {
      __syncthreads();  // every thread is done with the one stage
      issue(i + 1);
    }
  }
#pragma unroll
  for (int r = 0; r < T::TM; ++r) l[r] = half_warp_sum(l[r]);
  store_rows<T::TM, DP>(a.out[0], a, bh, q0, o, l, ty, tx);
  store_lse<T::TM>(a, bh, q0, m, l, ty, tx);
}

// --- the forward and the backward: 3xTF32 tensor-core products beside S
// on FFMA

// x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero:
// the bits of cvt.rna.tf32.f32 for finite x, in one integer add and one
// mask, which issue faster than the conversion
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo: hi = tf32(x) and lo = x - hi (exact) as it stands; the
// tensor cores read a tf32 operand's top 19 bits, so lo is truncated to 11
// significant bits there: hi + lo keeps x to 2^-21 of |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b for one m16n8k8 tile: a 16x8 tf32 (row), b 8x8 tf32 (col), c
// 16x8 fp32. Lane (g, t) = (lane/4, lane%4) holds a0..a3 = A[g][t],
// A[g+8][t], A[g][t+4], A[g+8][t+4]; b0, b1 = B[t][g], B[t+4][g]; c0..c3 =
// C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b in 3xTF32, (ah + al)(bh + bl) less al bl: ah bh into `big`, the
// small terms into `small` (two chains of dependent mma, not one)
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(small, al, bh[0], bh[1]);
  mma_tf32(small, ah, bl[0], bl[1]);
  mma_tf32(big, ah, bh[0], bh[1]);
}

// S = A B^T over head-dim columns [0, kdim) in the C layout above: s[nt][e]
// = sum_c A[g + 8(e/2)][c] B[8nt + 2t + e%2][c], for 16 rows of A and 8 NT
// rows of B (row-major fp32, pitch LD), each element one fmaf chain over c
// = 0, 1, ... from 0: abt's order, so these are the forward's scores bit
// for bit. The 4 B rows a load reads (2t) fall in distinct bank groups.
template <int NT, int LD>
__device__ __forceinline__ void scores_c(float (&s)[NT][4], const float* A, const float* B,
                                         int kdim) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  const float* a0 = A + g * LD;
  const float* b = B + 2 * t * LD;
#pragma unroll 2
  for (int c = 0; c < kdim; c += 4) {
    const float4 x0 = ld4(a0 + c), x1 = ld4(a0 + 8 * LD + c);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 y0 = ld4(b + 8 * nt * LD + c), y1 = ld4(b + (8 * nt + 1) * LD + c);
      fma4(s[nt][0], x0, y0);
      fma4(s[nt][1], x0, y1);
      fma4(s[nt][2], x1, y0);
      fma4(s[nt][3], x1, y1);
    }
  }
}

// The tensor cores add into an fp32 accumulator with truncation, so a long
// chain of mma.sync drifts by up to an ulp of the running sum a step (rel
// L2 3e-5 over the 512 k8 steps of N = 4096 on an H100). Each product below
// therefore sums at most kChain k8 steps into a zeroed partial, which is
// then added to the result in fp32 (rounded to nearest).
constexpr int kChain = 8;

// c[nt] += A B^T in 3xTF32 over head-dim columns [0, kdim) (k8 steps; kdim
// % 8 == 0): 16 rows of A and 8 NT rows of B (row-major fp32, pitch LD),
// the result in the C layout of scores_c
template <int NT, int LD>
__device__ __forceinline__ void abt_tf32(float (&c)[NT][4], const float* A, const float* B,
                                         int kdim) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* a = A + g * LD + t;
  const float* b = B + g * LD + t;
  for (int k0 = 0; k0 < kdim; k0 += 8 * kChain) {
    float part[NT][4] = {}, small[NT][4] = {};
    const int k1 = min(kdim, k0 + 8 * kChain);
#pragma unroll 2
    for (int k = k0; k < k1; k += 8) {
      uint32_t ah[4], al[4];
      split_tf32(a[k], ah[0], al[0]);
      split_tf32(a[8 * LD + k], ah[1], al[1]);
      split_tf32(a[k + 4], ah[2], al[2]);
      split_tf32(a[8 * LD + k + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bh[2], bl[2];
        split_tf32(b[8 * nt * LD + k], bh[0], bl[0]);
        split_tf32(b[8 * nt * LD + k + 4], bh[1], bl[1]);
        mma_3xtf32(part[nt], small[nt], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nt][e] += part[nt][e] + small[nt][e];
  }
}

// o[j] += P B in 3xTF32: P (16 x 8 KT) in the C layout (p[ks][e] = P[g +
// 8(e/2)][8ks + 2t + e%2]), B row-major (8 KT rows, pitch LD), columns c0 +
// 8j of the NO n8 tiles below d. A k8 step's slot t takes key 2t and slot
// t + 4 key 2t + 1, so the C fragment is the A fragment as it stands; the 4
// B rows a load reads (2t, 2t+1) fall in distinct bank groups.
template <int KT, int NO, int LD>
__device__ __forceinline__ void ab_tf32(float (&o)[NO][4], const float (&p)[KT][4],
                                        const float* B, int c0, int d) {
  static_assert(KT <= kChain, "one partial a tile");
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float part[NO][4] = {}, small[NO][4] = {};
#pragma unroll
  for (int ks = 0; ks < KT; ++ks) {
    uint32_t ah[4], al[4];
    split_tf32(p[ks][0], ah[0], al[0]);  // row g, key 2t
    split_tf32(p[ks][2], ah[1], al[1]);  // row g + 8, key 2t
    split_tf32(p[ks][1], ah[2], al[2]);  // row g, key 2t + 1
    split_tf32(p[ks][3], ah[3], al[3]);  // row g + 8, key 2t + 1
    const float* r = B + (8 * ks + 2 * t) * LD + c0 + g;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      if (c0 + 8 * j >= d) break;
      uint32_t bh[2], bl[2];
      split_tf32(r[8 * j], bh[0], bl[0]);
      split_tf32(r[LD + 8 * j], bh[1], bl[1]);
      mma_3xtf32(part[j], small[j], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] += part[j][e] + small[j][e];
}

// a 16 x 8 NT C-layout tile into shared memory from X (pitch LDX), and back
template <int NT, int LDX>
__device__ __forceinline__ void store_c(float* X, const float (&s)[NT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<float2*>(X + g * LDX + 8 * nt + 2 * t) = make_float2(s[nt][0], s[nt][1]);
    *reinterpret_cast<float2*>(X + (g + 8) * LDX + 8 * nt + 2 * t) =
        make_float2(s[nt][2], s[nt][3]);
  }
}

template <int NT, int LDX>
__device__ __forceinline__ void load_c(float (&s)[NT][4], const float* X) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 x = *reinterpret_cast<const float2*>(X + g * LDX + 8 * nt + 2 * t);
    const float2 y = *reinterpret_cast<const float2*>(X + (g + 8) * LDX + 8 * nt + 2 * t);
    s[nt][0] = x.x, s[nt][1] = x.y, s[nt][2] = y.x, s[nt][3] = y.y;
  }
}

// rows [r0, r0 + 16) of a (B, N, H, D) contiguous output from a C-layout
// accumulator of NO n8 tiles at columns c0 + 8j, each value divided by div;
// rows >= N and columns >= D are not written
template <int NO>
__device__ __forceinline__ void store_c_rows(float* out, const Args& a, int bh, int r0, int c0,
                                             const float (&acc)[NO][4], float div) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n = a.N, d = a.D, b = bh / a.H, hh = bh % a.H;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= n) continue;
    float* dst = out + ((long long)(b * n + row) * a.H + hh) * d + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      if (c0 + 8 * j >= d) break;
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[j][2 * h] / div, acc[j][2 * h + 1] / div);
    }
  }
}

template <int NO>
__device__ __forceinline__ void zero(float (&x)[NO][4]) {
#pragma unroll
  for (int j = 0; j < NO; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

// --- the forward (K1/K2): S on FFMA in the mma's C layout, P V as 3xTF32
// mma.sync interleaved with it, m, l and O in registers, key tiles by a
// cp.async ring

// S += A B^T over columns [c, c + 4) for the warp's 16 MT rows of A (pitch
// LDA) and 8 NT rows of B (pitch LDB), in the C layout: s[mt][nt][e] =
// S[16 mt + g + 8(e/2)][8 nt + 2t + e%2]; A and B point at rows g and 2t of
// the warp's first. Called on columns 0, 4, 8, ... in turn (A and B may
// move to the next chunk of columns in between), each score is one fmaf
// chain in column order from 0 (abt's and scores_c's), so these are the
// fp32 backward's scores bit for bit. A lane loads 2 MT + 2 NT float4 (the
// 8 A rows of a load fall in distinct bank groups: one wavefront; the 4 B
// rows: half of one) for 16 MT NT FMA.
template <int MT, int NT, int LDA, int LDB>
__device__ __forceinline__ void score_step(float (&s)[MT][NT][4], const float* a, const float* b,
                                           int c) {
  float4 x[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    x[mt][0] = ld4(a + 16 * mt * LDA + c);
    x[mt][1] = ld4(a + (16 * mt + 8) * LDA + c);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float4 y0 = ld4(b + 8 * nt * LDB + c), y1 = ld4(b + (8 * nt + 1) * LDB + c);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      fma4(s[mt][nt][0], x[mt][0], y0);
      fma4(s[mt][nt][1], x[mt][0], y1);
      fma4(s[mt][nt][2], x[mt][1], y0);
      fma4(s[mt][nt][3], x[mt][1], y1);
    }
  }
}

// keys at or past kv (counted from the tile's first key: those past N) to
// -inf, then the row maxima mx[mt][h] of rows 16 mt + g + 8h over the keys
// and the quad of lanes that share the row
template <int MT, int NT>
__device__ __forceinline__ void tile_max(float (&s)[MT][NT][4], float (&mx)[MT][2], int kv) {
  const int t = threadIdx.x % 4;
  if (kv < 8 * NT) {  // the last tile only
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * nt + 2 * t + e % 2 >= kv) s[mt][nt][e] = -INFINITY;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) x = fmaxf(x, s[mt][nt][e]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      mx[mt][h] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    }
}

// 2^x by the SFU (ex2.approx.ftz: relative error ~2^-22, and a result
// below 2^-126, a P that small beside its row's maximum of 1, flushes to 0)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One online-softmax step on a C-layout tile: m to max(m, mx) (finite: the
// tile holds a key before N), l and o rescaled by exp2(m_old - m_new), P =
// exp2(S - m) in place and this lane's share of its row sums added to l
// (the quad's shares are summed once, at the end)
template <int MT, int NT, int NO>
__device__ __forceinline__ void softmax_c(float (&s)[MT][NT][4], const float (&mx)[MT][2],
                                          float (&m)[MT][2], float (&l)[MT][2],
                                          float (&o)[MT][NO][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[mt][h], mx[mt][h]);
      const float alpha = exp2_sfu(m[mt][h] - mn);  // 0 at the first tile
      m[mt][h] = mn;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[mt][nt][e] = exp2_sfu(s[mt][nt][e] - mn);
          sum += s[mt][nt][e];
        }
      l[mt][h] = l[mt][h] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NO; ++j) o[mt][j][2 * h] *= alpha, o[mt][j][2 * h + 1] *= alpha;
    }
}

// P's fragments from registers: the C-layout tile s of the warp's own keys
template <int MT, int NT>
struct FragRegs {
  const float (&s)[MT][NT][4];
  __device__ __forceinline__ void operator()(int ks, float (&p)[MT][4]) const {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[mt][e] = s[mt][ks][e];
  }
};

// P's fragments from a row-major tile in shared memory (pitch LDX, from the
// warp's first row and the first key of the product)
template <int MT, int LDX>
struct FragSmem {
  const float* x;
  __device__ __forceinline__ void operator()(int ks, float (&p)[MT][4]) const {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* r = x + (16 * mt + g) * LDX + 8 * ks + 2 * t;
      const float2 u = *reinterpret_cast<const float2*>(r);
      const float2 w = *reinterpret_cast<const float2*>(r + 8 * LDX);
      p[mt][0] = u.x, p[mt][1] = u.y, p[mt][2] = w.x, p[mt][3] = w.y;
    }
  }
};

// the warp's C-layout P into a row-major tile X (pitch LDX, from the warp's
// first row and key); with LDX % 32 == 8 the 16 lanes of a float2 store
// phase hit 32 distinct banks
template <int MT, int NT, int LDX>
__device__ __forceinline__ void store_p(float* X, const float (&s)[MT][NT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* r = X + (16 * mt + g) * LDX + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(r) = make_float2(s[mt][nt][0], s[mt][nt][1]);
      *reinterpret_cast<float2*>(r + 8 * LDX) = make_float2(s[mt][nt][2], s[mt][nt][3]);
    }
}

// the SPLIT warps of row group rg meet at named barrier 1 + rg (0 is
// __syncthreads)
template <int SPLIT>
__device__ __forceinline__ void group_sync(int rg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "n"(32 * SPLIT) : "memory");
}

// a row statistic of the group's rows r0 + 16 mt + g + 8h through X (SPLIT
// x BQ floats): put_rows writes this warp's (slice sl), and after a group
// barrier get_rows combines the SPLIT slices in slice order, by max or by +
template <int MT, int BQ>
__device__ __forceinline__ void put_rows(float* X, int sl, int r0, const float (&x)[MT][2]) {
  const int lane = threadIdx.x % 32, g = lane / 4;
  if (lane % 4 == 0)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) X[sl * BQ + r0 + 16 * mt + g + 8 * h] = x[mt][h];
}

template <int MT, int BQ, int SPLIT, bool MAX>
__device__ __forceinline__ void get_rows(float (&x)[MT][2], const float* X, int r0) {
  const int g = threadIdx.x % 32 / 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * mt + g + 8 * h;
      float y = X[r];
#pragma unroll
      for (int s = 1; s < SPLIT; ++s) y = MAX ? fmaxf(y, X[s * BQ + r]) : y + X[s * BQ + r];
      x[mt][h] = y;
    }
}

// rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of a head's (N, D)
// slice (row 0 at src, row stride rs) into a (ROWS x LDD) tile by 16-byte
// cp.async copies of the NT threads, not waited for; rows >= n and columns
// >= d are zero-filled. The chunks a thread copies are fixed at compile time
// (copy_tile's runtime loop spends more on its indices than on the copies)
template <int ROWS, int COLS, int LDD, int NT>
__device__ __forceinline__ void copy_chunks(float* dst, const float* src, long long rs, int r0,
                                            int c0, int n, int d) {
  constexpr int CH = COLS / 4, TOTAL = ROWS * CH;
#pragma unroll
  for (int k = 0; k < (TOTAL + NT - 1) / NT; ++k) {
    const int idx = threadIdx.x + k * NT;
    if (TOTAL % NT != 0 && idx >= TOTAL) break;
    const int r = idx / CH, c = idx % CH * 4;
    const bool valid = r0 + r < n && c0 + c < d;
    cp_async16(dst + r * LDD + c, valid ? src + (long long)(r0 + r) * rs + c0 + c : src, valid);
  }
}

// The end of the forward for the warp's rows r0 + 16 mt + g + 8h of the
// block's q tile: l summed over the quad (and, with SPLIT > 1, over the
// group's slices through X), O / l into columns c0 + 8j + 2t below d of the
// contiguous (B, N, H, D) output, and the LSE m + log2(l) where asked for
template <int MT, int NO, int BQ, int SPLIT>
__device__ __forceinline__ void finish_rows(const Args& a, int bh, int q0, int r0, int sl, int rg,
                                            int c0, const float (&o)[MT][NO][4],
                                            const float (&m)[MT][2], float (&l)[MT][2],
                                            float* X) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n = a.N, d = a.D, b = bh / a.H, hh = bh % a.H;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 1);
      l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 2);
    }
  if constexpr (SPLIT > 1) {
    put_rows<MT, BQ>(X, sl, r0, l);
    group_sync<SPLIT>(rg);
    get_rows<MT, BQ, SPLIT, false>(l, X, r0);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + r0 + 16 * mt + g + 8 * h;
      if (row >= n) continue;
      float* dst = a.out[0] + ((long long)(b * n + row) * a.H + hh) * d + c0 + 2 * t;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        if (c0 + 8 * j >= d) break;
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[mt][j][2 * h] / l[mt][h], o[mt][j][2 * h + 1] / l[mt][h]);
      }
      if (a.lse_out != nullptr && sl == 0 && t == 0)
        a.lse_out[(long long)bh * n + row] = m[mt][h] + log2f(l[mt][h]);
    }
}

// P's fragment p of one k8 step (C layout: p[mt][e] is row 16 mt + g +
// 8(e/2), key 2t + e%2) as the A fragments hi = tf32(p), lo = p - hi; slot
// t takes key 2t and slot t + 4 key 2t + 1 (ab_tf32's slots)
template <int MT>
__device__ __forceinline__ void split_p(const float (&p)[MT][4], uint32_t (&ah)[MT][4],
                                        uint32_t (&al)[MT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    split_tf32(p[mt][0], ah[mt][0], al[mt][0]);  // row g, key 2t
    split_tf32(p[mt][2], ah[mt][1], al[mt][1]);  // row g + 8, key 2t
    split_tf32(p[mt][1], ah[mt][2], al[mt][2]);  // row g, key 2t + 1
    split_tf32(p[mt][3], ah[mt][3], al[mt][3]);  // row g + 8, key 2t + 1
  }
}

// part[mt][j] += P V for one k8 step in 3xTF32, hi hi and the small terms
// in one partial (registers): P's split fragments, V row-major (pitch LD)
// from the step's first key, columns c0 + 8j of every n8 tile j < NO (V's
// columns past D are zero-filled, so a tile past D adds zeros). A partial
// sums at most kChain steps (3 kChain truncating adds) before it joins O
// in fp32.
template <int MT, int NO, int LD>
__device__ __forceinline__ void pv_mma(float (&part)[MT][NO][4], const uint32_t (&ah)[MT][4],
                                       const uint32_t (&al)[MT][4], const float* V, int c0) {
  const int lane = threadIdx.x % 32;
  const float* r = V + 2 * (lane % 4) * LD + c0 + lane / 4;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    uint32_t bh[2], bl[2];
    split_tf32(r[8 * j], bh[0], bl[0]);
    split_tf32(r[LD + 8 * j], bh[1], bl[1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_3xtf32(part[mt][j], part[mt][j], ah[mt], al[mt], bh, bl);
  }
}

// every cp.async group of this thread but the last committed one has landed
__device__ __forceinline__ void cp_async_wait_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The forward at a padded head dim DP <= 160 and head dim D (DP or DP - 8,
// instantiated, so that the column loop of the scores has a fixed count): a
// block holds RG row groups of 16 MT query rows. SPLIT warps score a
// group's rows, each over KW = BK / SPLIT keys of every BK-key tile, and
// each holds O's columns [SLICE sl, + SLICE) of OW (D; DP where SPLIT > 1,
// so that a slice is whole n8 tiles: V's columns past D are zeros). With
// SPLIT 1, P stays in the warp's registers; with SPLIT > 1 the group's row
// maxima meet in shared memory (one group barrier a tile) and P goes there
// (two buffers). Software-pipelined: the P V of tile j, KT = BK / 8 k8 steps
// on the tensor cores, is interleaved with the DP / 4 column steps of tile
// j + 1's scores on FMA (one k8 step every CPK column steps), so that the
// mma chains' latency lies under FMA work of the same warp. K and V tiles
// arrive by cp.async in a 3-stage ring (tile j's V, tile j + 1's K, tile j
// + 2 in flight), one block barrier a tile.
template <int DP, int D, int MT, int RG, int SPLIT, int BK>
struct FwdF32 {
  static constexpr int THREADS = 32 * RG * SPLIT, BQ = 16 * MT * RG, LD = DP + 4;
  static constexpr int KW = BK / SPLIT, NT = KW / 8, KT = BK / 8, LDX = BK + 8;
  static constexpr int SLICE = (SPLIT == 1 ? D : DP) / SPLIT, NO = SLICE / 8;
  static constexpr int CS = D / 4, CPK = CS / KT > 1 ? CS / KT : 1;
  static constexpr int STAGE = 2 * BK * LD;  // floats of a K and a V tile
  static constexpr size_t OFF_KV = size_t(BQ) * LD * 4;
  static constexpr size_t OFF_X = OFF_KV + 3 * size_t(STAGE) * 4;
  static constexpr size_t SMEM =
      OFF_X + (SPLIT > 1 ? (2 * size_t(BQ) * LDX + SPLIT * BQ) * 4 : 0);
  static_assert(KW % 8 == 0 && SLICE % 8 == 0 && D % 8 == 0 && D <= DP && KT <= kChain &&
                    SMEM <= kSmemPerBlock,
                "forward tile");
};

template <int DP, int D, int MT, int RG, int SPLIT, int BK>
__global__ void __launch_bounds__(32 * RG * SPLIT) flash_fwd_f32_kernel(const Args a) {
  using T = FwdF32<DP, D, MT, RG, SPLIT, BK>;
  using S = float[MT][T::NT][4];
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* sQ = reinterpret_cast<float*>(smem);  // q2
  float* ring = reinterpret_cast<float*>(smem + T::OFF_KV);
  float* sP = reinterpret_cast<float*>(smem + T::OFF_X);  // SPLIT > 1: P of tiles j, j + 1
  float* sX = sP + 2 * T::BQ * T::LDX;                     // and the row statistics
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N, d = D;
  const int warp = threadIdx.x / 32, rg = warp / SPLIT, sl = warp % SPLIT;
  const int r0 = rg * 16 * MT;  // the group's first row in the q tile
  const int tiles = (n + BK - 1) / BK;
  const float* kg = head(a, 1, bh);
  const float* vg = head(a, 2, bh);
  // tile j into stage j % 3 (K, then V), one cp.async group (empty past the
  // last tile)
  auto issue = [&](int j) {
    if (j < tiles) {
      float* stage = ring + (j % 3) * T::STAGE;
      copy_chunks<BK, DP, T::LD, T::THREADS>(stage, kg, a.st[4], j * BK, 0, n, d);
      copy_chunks<BK, DP, T::LD, T::THREADS>(stage + BK * T::LD, vg, a.st[7], j * BK, 0, n, d);
    }
    cp_async_commit();
  };
  const int lane = threadIdx.x % 32;
  const float* qw = sQ + (r0 + lane / 4) * T::LD;  // score_step's rows
  const int kb = (sl * T::KW + 2 * (lane % 4)) * T::LD;
  float o[MT][T::NO][4], m[MT][2], l[MT][2];
  S s0, s1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    zero(o[mt]);
    zero(s0[mt]);
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  // tile jn's P from its scores s: the row maxima (with SPLIT > 1 over the
  // group, through sX), the softmax step, and with SPLIT > 1 P into buffer
  // jn % 2, published by the next block barrier
  auto softmax_tile_c = [&](S& s, int jn) {
    float mx[MT][2];
    tile_max<MT, T::NT>(s, mx, n - jn * BK - sl * T::KW);
    if constexpr (SPLIT > 1) {
      put_rows<MT, T::BQ>(sX, sl, r0, mx);
      group_sync<SPLIT>(rg);
      get_rows<MT, T::BQ, SPLIT, true>(mx, sX, r0);
    }
    softmax_c<MT, T::NT, T::NO>(s, mx, m, l, o);
    if constexpr (SPLIT > 1)
      store_p<MT, T::NT, T::LDX>(sP + ((jn % 2) * T::BQ + r0) * T::LDX + sl * T::KW, s);
  };
  // tile j: its P V (P in registers sp, or in shared memory) interleaved
  // with tile j + 1's scores into sn, then tile j + 1's softmax step
  auto tile = [&](int j, S& sp, S& sn) {
    cp_async_wait_all();
    // tile j + 1 (and with SPLIT > 1 tile j's P) is visible to every
    // thread, and every thread is done with tile j - 1's stage
    __syncthreads();
    issue(j + 2);
    const float* sV = ring + (j % 3) * T::STAGE + BK * T::LD;
    const float* kn = ring + ((j + 1) % 3) * T::STAGE + kb;
    const bool next = j + 1 < tiles;
    float part[MT][T::NO][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) zero(sn[mt]), zero(part[mt]);
    auto pv = [&](int ks) {
      float f[MT][4];
      if constexpr (SPLIT == 1)
        FragRegs<MT, T::NT>{sp}(ks, f);
      else
        FragSmem<MT, T::LDX>{sP + ((j % 2) * T::BQ + r0) * T::LDX}(ks, f);
      uint32_t ah[MT][4], al[MT][4];
      split_p<MT>(f, ah, al);
      pv_mma<MT, T::NO, T::LD>(part, ah, al, sV + 8 * ks * T::LD, sl * T::SLICE);
    };
    if (next) {  // one branch a tile: the unrolled steps below are one block
#pragma unroll
      for (int cs = 0; cs < T::CS; ++cs) {
        if (cs % T::CPK == 0 && cs / T::CPK < T::KT) pv(cs / T::CPK);
        score_step<MT, T::NT, T::LD, T::LD>(sn, qw, kn, 4 * cs);
      }
#pragma unroll
      for (int ks = (T::CS + T::CPK - 1) / T::CPK; ks < T::KT; ++ks) pv(ks);
    } else {
#pragma unroll
      for (int ks = 0; ks < T::KT; ++ks) pv(ks);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jo = 0; jo < T::NO; ++jo)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][jo][e] += part[mt][jo][e];
    if (next) softmax_tile_c(sn, j + 1);
  };

  copy_chunks<T::BQ, DP, T::LD, T::THREADS>(sQ, head(a, 0, bh), a.st[1], q0, 0, n, d);
  issue(0);  // one group: q and tile 0
  issue(1);
  cp_async_wait_but_last();
  // q2: scale_tile scales the chunks this thread copied (copy_chunks' order)
  scale_tile<DP, T::BQ, T::THREADS>(sQ, a.scale_log2);
  __syncthreads();  // q2 and tile 0 are visible to every thread
#pragma unroll 2
  for (int c = 0; c < D; c += 4) score_step<MT, T::NT, T::LD, T::LD>(s0, qw, ring + kb, c);
  softmax_tile_c(s0, 0);
  // the score arrays take turns, so that P is never copied
  for (int j = 0; j < tiles; j += 2) {
    tile(j, s0, s1);
    if (j + 1 < tiles) tile(j + 1, s1, s0);
  }
  finish_rows<MT, T::NO, T::BQ, SPLIT>(a, bh, q0, r0, sl, rg, sl * T::SLICE, o, m, l, sX);
}

// The forward at d = 512 (K2, the VAE's single head): a q tile of BQ rows
// (132 KB at 64) leaves room for two ring stages of 34 KB. A key tile of
// 64 keys takes KC = 512 / CK steps; step s of tile j's iteration holds
// tile j + 1's K chunk s (64 keys x CK columns: the scores' fmaf chains go
// on from chunk to chunk in column order) and tile j's V chunk s (its 8
// keys of k8 step s x all columns), so that each warp's instruction stream
// interleaves its FMA scores of tile j + 1 with its 3xTF32 P V of tile j,
// one block barrier a step, the next step's chunks in flight. After tile
// j + 1's last chunk the group's row maxima meet in shared memory (the
// group barrier also frees P of tile j) and its P goes there; each warp
// holds O's SLICE columns of its group's rows, and its P V partials span
// one k8 step.
template <int MT, int RG, int SPLIT, int CK, int CW>
struct FwdWideF32 {
  static constexpr int DP = 512, LD = DP + 4, THREADS = 32 * RG * SPLIT, BQ = 16 * MT * RG;
  static constexpr int BK = 8 * DP / CK, KW = BK / SPLIT, NT = KW / 8, LDX = BK + 8;
  static constexpr int SLICE = DP / SPLIT, NO = SLICE / 8, KC = DP / CK, LDK = CK + 4;
  static constexpr int STAGE = BK * LDK + 8 * LD;  // floats: a K chunk, then a V chunk
  static constexpr size_t OFF_RING = size_t(BQ) * LD * 4;
  static constexpr size_t OFF_X = OFF_RING + 2 * size_t(STAGE) * 4;
  static constexpr size_t SMEM = OFF_X + (size_t(BQ) * LDX + SPLIT * BQ) * 4;
  static_assert(KW % 8 == 0 && SLICE % 8 == 0 && NO % CW == 0 && BK / 8 <= kChain &&
                    SMEM <= kSmemPerBlock,
                "d = 512 forward tile");
};

template <int MT, int RG, int SPLIT, int CK, int CW>
__global__ void __launch_bounds__(32 * RG * SPLIT, 1) flash_fwd_wide_f32_kernel(const Args a) {
  using T = FwdWideF32<MT, RG, SPLIT, CK, CW>;
  constexpr int BK = T::BK, KC = T::KC;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* sQ = reinterpret_cast<float*>(smem);  // q2
  float* ring = reinterpret_cast<float*>(smem + T::OFF_RING);
  float* sP = reinterpret_cast<float*>(smem + T::OFF_X);
  float* sX = sP + T::BQ * T::LDX;  // the row statistics
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N, d = a.D;
  const int warp = threadIdx.x / 32, rg = warp / SPLIT, sl = warp % SPLIT;
  const int r0 = rg * 16 * MT;
  const int tiles = (n + BK - 1) / BK, steps = (tiles + 1) * KC;
  const float* kg = head(a, 1, bh);
  const float* vg = head(a, 2, bh);
  // step i: K chunk i % KC of tile i / KC and V chunk i % KC of the tile
  // before, where they exist, into stage i % 2
  auto issue = [&](int i) {
    float* stage = ring + (i % 2) * T::STAGE;
    const int jk = i / KC, st = i % KC;
    if (jk < tiles)
      copy_chunks<BK, CK, T::LDK, T::THREADS>(stage, kg, a.st[4], jk * BK, st * CK, n, d);
    if (jk > 0)
      copy_chunks<8, T::DP, T::LD, T::THREADS>(stage + BK * T::LDK, vg, a.st[7],
                                                (jk - 1) * BK + 8 * st, 0, n, d);
    cp_async_commit();
  };
  copy_chunks<T::BQ, T::DP, T::LD, T::THREADS>(sQ, head(a, 0, bh), a.st[1], q0, 0, n, d);
  issue(0);
  cp_async_wait_all();
  scale_tile<T::DP, T::BQ, T::THREADS>(sQ, a.scale_log2);  // q2, as at d <= 160
  const int lane = threadIdx.x % 32;
  const float* qw = sQ + (r0 + lane / 4) * T::LD;  // score_step's rows
  const int kb = (sl * T::KW + 2 * (lane % 4)) * T::LDK;
  float o[MT][T::NO][4], m[MT][2], l[MT][2], s[MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    zero(o[mt]);
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait_all();
    // step i's chunks (at i = 0 q2 too; at a tile's first step its P) are
    // visible to every thread, and every thread is done with step i - 1's
    // stage
    __syncthreads();
    if (i + 1 < steps) issue(i + 1);
    const float* stage = ring + (i % 2) * T::STAGE;
    const int jk = i / KC, st = i % KC;
    if (jk > 0) {  // tile jk - 1's k8 step st, CW n8 tiles of partials at a time
      float f[MT][4];
      FragSmem<MT, T::LDX>{sP + r0 * T::LDX}(st, f);
      uint32_t ah[MT][4], al[MT][4];
      split_p<MT>(f, ah, al);
#pragma unroll
      for (int j0 = 0; j0 < T::NO; j0 += CW) {
        float part[MT][CW][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) zero(part[mt]);
        pv_mma<MT, CW, T::LD>(part, ah, al, stage + BK * T::LDK, sl * T::SLICE + 8 * j0);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int jj = 0; jj < CW; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[mt][j0 + jj][e] += part[mt][jj][e];
      }
    }
    if (jk < tiles) {  // tile jk's scores over the chunk's columns
      if (st == 0)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) zero(s[mt]);
      const int c0 = st * CK, cols = min(CK, d - c0);
#pragma unroll 2
      for (int c = 0; c < cols; c += 4)
        score_step<MT, T::NT, T::LD, T::LDK>(s, qw + c0, stage + kb, c);
      if (st == KC - 1) {
        float mx[MT][2];
        tile_max<MT, T::NT>(s, mx, n - jk * BK - sl * T::KW);
        put_rows<MT, T::BQ>(sX, sl, r0, mx);
        group_sync<SPLIT>(rg);  // the group is done with tile jk - 1's P too
        get_rows<MT, T::BQ, SPLIT, true>(mx, sX, r0);
        softmax_c<MT, T::NT, T::NO>(s, mx, m, l, o);
        store_p<MT, T::NT, T::LDX>(sP + r0 * T::LDX + sl * T::KW, s);
      }
    }
  }
  finish_rows<MT, T::NO, T::BQ, SPLIT>(a, bh, q0, r0, sl, rg, sl * T::SLICE, o, m, l, sX);
}

// --- dQ: q2 and dO tiles of BQ rows resident, K and V tiles of BK
// streamed through a ring of STAGES; S, dP and dQ on FFMA in the plain
// version's order (abt, then ab: each element one fmaf chain in key order)
template <int DP, int BQ, int BK, int STAGES>
struct Dq {
  static constexpr int TM = BQ / RT, TN = BK / CT, LD = DP + 4, LDP = BK + 4;
  static constexpr int TE = BK * LD;  // floats of a K or V tile
  static constexpr size_t OFF_KV = 2 * size_t(BQ) * LD * 4;
  static constexpr size_t OFF_S = OFF_KV + STAGES * 2 * size_t(TE) * 4;
  static constexpr size_t SMEM = OFF_S + size_t(BQ) * LDP * 4;
  static_assert(BQ % RT == 0 && BK % CT == 0 && SMEM <= kSmemPerBlock, "dQ tile");
};

template <int DP, int BQ, int BK, int STAGES>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_f32_kernel(const Args a) {
  using T = Dq<DP, BQ, BK, STAGES>;
  using C = Cols<DP>;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* sQ = reinterpret_cast<float*>(smem);  // q2
  float* sO = sQ + BQ * T::LD;                 // dO
  float* ring = reinterpret_cast<float*>(smem + T::OFF_KV);
  float* sS = reinterpret_cast<float*>(smem + T::OFF_S);  // dS
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ, n = a.N;
  const int tx = threadIdx.x % CT, ty = threadIdx.x / CT;
  const int tiles = (n + BK - 1) / BK;
  auto issue = [&](int j) {
    float* stage = ring + (j % STAGES) * 2 * T::TE;
    copy_tile<DP, BK>(stage, a, 1, bh, j * BK);
    copy_tile<DP, BK>(stage + T::TE, a, 2, bh, j * BK);
    cp_async_commit();
  };
  issue(0);
  copy_tile<DP, BQ>(sQ, a, 0, bh, q0);
  copy_tile<DP, BQ>(sO, a, 3, bh, q0);
  cp_async_commit();
  cp_async_wait_all();
  scale_tile<DP, BQ>(sQ, a.scale_log2);  // q2: the forward's, bit for bit
  float lse[T::TM], dd[T::TM], acc[T::TM][C::N];
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int row = q0 + ty + RT * i;
    lse[i] = row < n ? a.lse[(long long)bh * n + row] : 0.f;
    dd[i] = row < n ? a.dd[(long long)bh * n + row] : 0.f;
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[i][c] = 0.f;
  }
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait_all();
    // tile j (and at j = 0 the q2 and dO tiles) is visible to every thread,
    // and every thread is done with tile j - 1's stage and dS
    __syncthreads();
    if (STAGES > 1 && j + 1 < tiles) issue(j + 1);
    const float* sK = ring + (j % STAGES) * 2 * T::TE;
    const int k0 = j * BK;
    float s[T::TM][T::TN] = {}, dp[T::TM][T::TN] = {};
    abt<T::TM, T::TN>(s, sQ, T::LD, sK, T::LD, a.D, ty, tx);
    abt<T::TM, T::TN>(dp, sO, T::LD, sK + T::TE, T::LD, a.D, ty, tx);
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int jj = 0; jj < T::TN; ++jj) {
        const float p = k0 + tx + CT * jj < n ? exp2f(s[i][jj] - lse[i]) : 0.f;
        sS[(ty + RT * i) * T::LDP + tx + CT * jj] = p * (dp[i][jj] - dd[i]) * a.scale;
      }
    __syncthreads();  // dS is whole
    ab<T::TM, DP, BK>(acc, sS, T::LDP, sK, T::LD, ty, tx);
    if (STAGES == 1 && j + 1 < tiles) {
      __syncthreads();  // every thread is done with the one stage
      issue(j + 1);
    }
  }
  float ones[T::TM];
#pragma unroll
  for (int i = 0; i < T::TM; ++i) ones[i] = 1.f;
  store_rows<T::TM, DP>(a.out[0], a, bh, q0, acc, ones, ty, tx);
}

// --- dK/dV: K and V of 16 RG rows resident, q and dO tiles of BQ (with
// their LSE and D) streamed through a ring of STAGES; warp w is row group
// w / SPLIT and slice w % SPLIT: it scores queries [QW slice, + QW) of each
// tile in the mma's C layout (scores_c) and holds dK's and dV's columns
// [SLICE slice, + SLICE). With SPLIT 1, S^T, dP^T, P^T and dS^T never leave
// the warp's registers; with SPLIT > 1, P^T and dS^T meet in shared memory
template <int DP, int RG, int SPLIT, int BQ, int STAGES>
struct Dkv {
  static constexpr int THREADS = 32 * RG * SPLIT, BK = 16 * RG, LD = DP + 4;
  static constexpr int QW = BQ / SPLIT, NTW = QW / 8, SLICE = DP / SPLIT, NO = SLICE / 8;
  // dK's and dV's n8 tiles taken CW at a time, so that a product's two
  // partials stay at 2 x 8 tiles (the d = 512 slice has 16)
  static constexpr int NCH = NO > 8 && NO % 8 == 0 ? NO / 8 : 1, CW = NO / NCH;
  static constexpr int LDX = BQ + 8;               // pitch of P^T and dS^T in shared memory
  static constexpr int TE = BQ * LD;               // floats of a q2 or dO tile
  static constexpr int STAGE = 2 * TE + 2 * BQ;    // q2, dO, LSE, D
  static constexpr size_t OFF_RING = 2 * size_t(BK) * LD * 4;
  static constexpr size_t OFF_X = OFF_RING + STAGES * size_t(STAGE) * 4;
  static constexpr size_t SMEM = OFF_X + (SPLIT > 1 ? 2 * size_t(BK) * LDX * 4 : 0);
  static_assert(QW % 8 == 0 && SLICE % 8 == 0 && SMEM <= kSmemPerBlock, "dK/dV tile");
};

template <int DP, int RG, int SPLIT, int BQ, int STAGES>
__global__ void __launch_bounds__(32 * RG * SPLIT) flash_bwd_dkv_f32_kernel(const Args a) {
  using T = Dkv<DP, RG, SPLIT, BQ, STAGES>;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + T::BK * T::LD;
  float* ring = reinterpret_cast<float*>(smem + T::OFF_RING);
  float* sP = reinterpret_cast<float*>(smem + T::OFF_X);  // P^T and dS^T (SPLIT > 1)
  float* sS = sP + T::BK * T::LDX;
  const int bh = blockIdx.y, k0 = blockIdx.x * T::BK, n = a.N, d = a.D;
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  const int rg = warp / SPLIT, sl = warp % SPLIT;
  const int tiles = (n + BQ - 1) / BQ;
  auto issue = [&](int j) {
    float* stage = ring + (j % STAGES) * T::STAGE;
    const int q0 = j * BQ;
    copy_tile<DP, BQ, T::THREADS>(stage, a, 0, bh, q0);  // q, scaled into q2 on arrival
    copy_tile<DP, BQ, T::THREADS>(stage + T::TE, a, 3, bh, q0);
    for (int r = threadIdx.x; r < BQ; r += T::THREADS) {
      const bool valid = q0 + r < n;
      const long long at = (long long)bh * n + (valid ? q0 + r : 0);
      cp_async4(stage + 2 * T::TE + r, a.lse + at, valid);
      cp_async4(stage + 2 * T::TE + BQ + r, a.dd + at, valid);
    }
    cp_async_commit();
  };
  copy_tile<DP, T::BK, T::THREADS>(sK, a, 1, bh, k0);
  copy_tile<DP, T::BK, T::THREADS>(sV, a, 2, bh, k0);
  issue(0);
  float dk[T::NCH][T::CW][4], dv[T::NCH][T::CW][4];
#pragma unroll
  for (int ch = 0; ch < T::NCH; ++ch) zero(dk[ch]), zero(dv[ch]);
  const float* kw = sK + rg * 16 * T::LD;
  const float* vw = sV + rg * 16 * T::LD;
  for (int j = 0; j < tiles; ++j) {
    float* sQ = ring + (j % STAGES) * T::STAGE;  // q2
    cp_async_wait_all();
    scale_tile<DP, BQ, T::THREADS>(sQ, a.scale_log2);  // the chunks this thread copied
    // tile j (and at j = 0 K and V) is visible to every thread, and every
    // thread is done with tile j - 1's stage, P^T and dS^T
    __syncthreads();
    if (STAGES > 1 && j + 1 < tiles) issue(j + 1);
    const float* sO = sQ + T::TE;
    const float* sL = sQ + 2 * T::TE;
    const float* sD = sL + BQ;
    const int qv = n - j * BQ - sl * T::QW;  // queries before N from this warp's first
    float st[T::NTW][4], dpt[T::NTW][4], pt[T::NTW][4];
    scores_c<T::NTW, T::LD>(st, kw, sQ + sl * T::QW * T::LD, d);  // S^T = K q2^T
    zero(dpt);
    abt_tf32<T::NTW, T::LD>(dpt, vw, sO + sl * T::QW * T::LD, d);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < T::NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * nt + 2 * t + e % 2, at = sl * T::QW + qi;
        const float p = qi < qv ? exp2f(st[nt][e] - sL[at]) : 0.f;
        pt[nt][e] = p;
        st[nt][e] = p * (dpt[nt][e] - sD[at]) * a.scale;  // dS^T
      }
    if constexpr (SPLIT == 1) {
#pragma unroll
      for (int ch = 0; ch < T::NCH; ++ch) {
        ab_tf32<T::NTW, T::CW, T::LD>(dv[ch], pt, sO, 8 * T::CW * ch, d);
        ab_tf32<T::NTW, T::CW, T::LD>(dk[ch], st, sQ, 8 * T::CW * ch, d);
      }
    } else {
      store_c<T::NTW, T::LDX>(sP + rg * 16 * T::LDX + sl * T::QW, pt);
      store_c<T::NTW, T::LDX>(sS + rg * 16 * T::LDX + sl * T::QW, st);
      __syncthreads();  // the row group's P^T and dS^T over the whole q tile
      float x[BQ / 8][4];
      load_c<BQ / 8, T::LDX>(x, sP + rg * 16 * T::LDX);
#pragma unroll
      for (int ch = 0; ch < T::NCH; ++ch)
        ab_tf32<BQ / 8, T::CW, T::LD>(dv[ch], x, sO, sl * T::SLICE + 8 * T::CW * ch, d);
      load_c<BQ / 8, T::LDX>(x, sS + rg * 16 * T::LDX);
#pragma unroll
      for (int ch = 0; ch < T::NCH; ++ch)
        ab_tf32<BQ / 8, T::CW, T::LD>(dk[ch], x, sQ, sl * T::SLICE + 8 * T::CW * ch, d);
    }
    if (STAGES == 1 && j + 1 < tiles) {
      __syncthreads();  // every thread is done with the one stage
      issue(j + 1);
    }
  }
  // dK = (dS^T q2) / (d^-1/2 log2 e): q2 is the forward's, bit for bit
#pragma unroll
  for (int ch = 0; ch < T::NCH; ++ch) {
    const int c0 = sl * T::SLICE + 8 * T::CW * ch;
    store_c_rows<T::CW>(a.out[0], a, bh, k0 + rg * 16, c0, dk[ch], a.scale_log2);
    store_c_rows<T::CW>(a.out[1], a, bh, k0 + rg * 16, c0, dv[ch], 1.f);
  }
}

// one launch of KERNEL over (tiles of `rows`, B*H) with `threads` threads
// and `smem` bytes of dynamic shared memory
template <auto KERNEL>
cudaError_t launch(int rows, int threads, size_t smem, const Args& a, cudaStream_t stream) {
  // once per kernel (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  KERNEL<<<dim3((a.N + rows - 1) / rows, a.B * a.H), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// D % 8 == 0 (make_args), so D is DP or DP - 8
template <int DP, int MT, int RG, int SPLIT, int BK>
cudaError_t launch_fwd(const Args& a, cudaStream_t s) {
  using T = FwdF32<DP, DP, MT, RG, SPLIT, BK>;
  using T8 = FwdF32<DP, DP - 8, MT, RG, SPLIT, BK>;
  return a.D == DP ? launch<flash_fwd_f32_kernel<DP, DP, MT, RG, SPLIT, BK>>(T::BQ, T::THREADS,
                                                                            T::SMEM, a, s)
                   : launch<flash_fwd_f32_kernel<DP, DP - 8, MT, RG, SPLIT, BK>>(
                         T8::BQ, T8::THREADS, T8::SMEM, a, s);
}

template <int MT, int RG, int SPLIT, int CK, int CW>
cudaError_t launch_fwd_wide(const Args& a, cudaStream_t s) {
  using T = FwdWideF32<MT, RG, SPLIT, CK, CW>;
  return launch<flash_fwd_wide_f32_kernel<MT, RG, SPLIT, CK, CW>>(T::BQ, T::THREADS, T::SMEM, a,
                                                                   s);
}

template <int DP, int BQ, int BK, int STAGES>
cudaError_t launch_dq(const Args& a, cudaStream_t s) {
  return launch<flash_bwd_dq_f32_kernel<DP, BQ, BK, STAGES>>(BQ, THREADS,
                                                            Dq<DP, BQ, BK, STAGES>::SMEM, a, s);
}

template <int DP, int RG, int SPLIT, int BQ, int STAGES>
cudaError_t launch_dkv(const Args& a, cudaStream_t s) {
  using T = Dkv<DP, RG, SPLIT, BQ, STAGES>;
  return launch<flash_bwd_dkv_f32_kernel<DP, RG, SPLIT, BQ, STAGES>>(T::BK, T::THREADS, T::SMEM,
                                                                    a, s);
}

template <int DP, int BC>
cudaError_t launch_pipelined(const Args& a, cudaStream_t s) {
  using T = PipeF32<DP, BC>;
  return launch<flash_pipelined_f32_kernel<DP, BC>>(T::BQ, THREADS, T::SMEM, a, s);
}

template <int DP, int BK>
cudaError_t launch_resident(const Args& a, int cluster, cudaStream_t stream) {
  using T = ResF32<DP, BK>;
  void (*kern)(const Args) = flash_resident_f32_kernel<DP, BK>;
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
  cfg.blockDim = dim3(THREADS + 32);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cfg.attrs = dims;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// f(DP, BLOCK) as std::integral_constants at D's padded head dim
// (ops/flash_attention.py SUPPORTED_HEAD_DIMS) and a key block of 32, 64 or
// 128
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

// The forward entries: q, k, v fp32 (B, N, H, D), element strides (batch,
// seq, head) of q, k, v in `st` and a unit head-dim stride; o fp32 (B, N,
// H, D) contiguous; lse fp32 (B*H, N) or null; scale the q prescale d^-1/2
// * log2(e). Launch on `stream`; return the cudaError_t of the launch.
// Padded head dims: ops/flash_attention.py SUPPORTED_HEAD_DIMS.
extern "C" int pbe_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int B, int N, int H, int D, const long long* st,
                                 float scale, void* stream) {
  Args a;
  cudaError_t err = make_args(&a, q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse, B, N,
                              H, D, st, 9, scale, 0.f);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // <DP, MT, RG, SPLIT, BK> (FwdF32) and <MT, RG, SPLIT, CK, CW>
  // (FwdWideF32). Smaller q tiles where larger ones leave SMs idle: at d =
  // 160 32 rows for N <= 256 (ds4, ds8), else 64; at d = 512 32 rows where
  // 64-row tiles would be fewer than the SMs, else 64
  switch ((D + 15) / 16 * 16) {
    case 16:  return (int)launch_fwd<16, 2, 4, 1, 32>(a, s);
    case 32:  return (int)launch_fwd<32, 2, 4, 1, 32>(a, s);
    case 48:  return (int)launch_fwd<48, 2, 4, 1, 32>(a, s);
    case 80:  return (int)launch_fwd<80, 2, 2, 2, 32>(a, s);
    case 160: return (int)(N <= 256 ? launch_fwd<160, 1, 2, 4, 32>(a, s)
                                    : launch_fwd<160, 2, 2, 4, 32>(a, s));
    case 512: return (int)((long long)B * H * ((N + 63) / 64) < kSms
                               ? launch_fwd_wide<2, 1, 8, 64, 2>(a, s)
                               : launch_fwd_wide<2, 2, 4, 64, 2>(a, s));
    default:  return (int)cudaErrorInvalidValue;
  }
}

// K3: block_k the key block (resident_f32_instantiated); cluster the blocks
// of a cluster (1, 2 or 4), each on its own q tile of the same head.
extern "C" int pbe_flash_resident_f32(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int N, int H, int D,
                                      const long long* st, float scale, int block_k,
                                      int cluster, void* stream) {
  Args a;
  cudaError_t err = make_args(&a, q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse, B, N,
                              H, D, st, 9, scale, 0.f);
  if (err != cudaSuccess) return (int)err;
  if (cluster != 1 && cluster != 2 && cluster != 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_tiles(D, block_k, [&](auto dp, auto bk) -> cudaError_t {
    constexpr int DP = decltype(dp)::value, BK = decltype(bk)::value;
    if constexpr (resident_f32_instantiated(DP, BK)) return launch_resident<DP, BK>(a, cluster, s);
    return cudaErrorInvalidValue;
  });
}

// K4: block_c the key chunk (pipelined_f32_instantiated).
extern "C" int pbe_flash_pipelined_f32(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int N, int H, int D,
                                       const long long* st, float scale, int block_c,
                                       void* stream) {
  Args a;
  cudaError_t err = make_args(&a, q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse, B, N,
                              H, D, st, 9, scale, 0.f);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_tiles(D, block_c, [&](auto dp, auto bc) -> cudaError_t {
    constexpr int DP = decltype(dp)::value, BC = decltype(bc)::value;
    if constexpr (pipelined_f32_instantiated(DP, BC)) return launch_pipelined<DP, BC>(a, s);
    return cudaErrorInvalidValue;
  });
}

// The backward: q, k, v, dout fp32 (B, N, H, D), element strides (batch,
// seq, head) of q, k, v, dout in `st` and a unit head-dim stride; lse, dd
// fp32 (B*H, N) contiguous; outputs fp32 (B, N, H, D) contiguous.
// scale_log2 = d^-1/2 * log2(e), scale = d^-1/2. Padded head dims:
// ops/flash_attention.py BWD_HEAD_DIMS. The launch lines are <DP, row
// groups of 16, warps a row group, streamed tile rows, ring stages>.
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
    case 16:  return (int)launch_dq<16, 64, 64, 2>(a, s);
    case 32:  return (int)launch_dq<32, 64, 64, 2>(a, s);
    case 48:  return (int)launch_dq<48, 128, 64, 2>(a, s);
    case 80:  return (int)launch_dq<80, 64, 64, 1>(a, s);
    // N <= 128 (ds8): 64-row blocks would leave most SMs idle
    case 160: return (int)(N <= 128 ? launch_dq<160, 32, 32, 1>(a, s)
                                    : launch_dq<160, 64, 32, 2>(a, s));
    case 512: return (int)launch_dq<512, 32, 16, 1>(a, s);
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
    case 16:  return (int)launch_dkv<16, 4, 1, 32, 2>(a, s);
    case 32:  return (int)launch_dkv<32, 4, 1, 32, 2>(a, s);
    case 48:  return (int)launch_dkv<48, 4, 1, 32, 2>(a, s);
    case 80:  return (int)launch_dkv<80, 4, 1, 32, 2>(a, s);
    case 160: return (int)(N <= 128 ? launch_dkv<160, 2, 2, 32, 2>(a, s)
                                    : launch_dkv<160, 4, 2, 32, 2>(a, s));
    case 512: return (int)launch_dkv<512, 1, 4, 32, 1>(a, s);
    default:  return (int)cudaErrorInvalidValue;
  }
}
