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
// K3 and K4 run on the forward's core: S by score_step (abt's order, the
// mma's C layout), P V as 3xTF32 mma.sync.m16n8k8 with partials of at most
// kChain k8 steps (pv_mma; a key tile of 128 joins two), tile j's P V
// interleaved in each warp with tile j + 1's scores (pv_and_scores), m, l
// and O in registers, exp2 on the SFU; P stays in registers with SPLIT 1
// and crosses shared memory once where SPLIT warps share a row group:
//   * K3 (flash_resident_f32_kernel): the online softmax over key tiles of
//     block_k, m, l and O rescaled once a tile. A thread-block cluster of C
//     = 1, 2 or 4 blocks (neighbouring q tiles of one head) shares each key
//     tile: each block's producer warp copies rows r, r + C, ... (rank r)
//     by cp.async.bulk ... multicast::cluster, one copy a row, into every
//     block's ring; full and empty mbarriers a slot, the empty ones
//     released by remote arrives of the cluster's C x 8 consumer warps. At
//     d <= 160 K and V take two slots each (tile j's V and tile j + 1's K
//     are read while tile j + 1's V and tile j + 2's K land); at 512 the
//     wide forward's two stages (tile j + 1's K chunk and tile j's V chunk
//     a step). With SPLIT > 1, two group barriers a tile (named barriers 1
//     + rg; the producer joins none): the row maxima meet, then P is whole.
//     The producer's warpgroup hands its registers to the consumers
//     (setmaxnreg, kProducerWarps). The ring is zeroed once, so rows past N
//     hold zeros or an earlier tile's finite values (P is 0 there). A tensor
//     copy of each block's share of a tile (cp.async.bulk.tensor, a box of
//     DP + 4 columns, so the pitch stays and the columns past D come
//     zero-filled) was tried on an H100: it ran ds1 faster at C = 1 but
//     slower at C = 2, the plan's size there, so the rows stay.
//   * K4 (flash_pipelined_f32_kernel): pass 1 the row max over chunks of
//     block_c (scores and a running max, no exp2), pass 2 P = exp2(S -
//     m_final) with no rescale, l and P V, chunk j's P V interleaved with
//     chunk j + 1's scores. S is one code path, so pass 2's scores are pass
//     1's bit for bit and every P is <= 1. cp.async with compile-time chunk
//     indices (copy_chunks), one block barrier a chunk (a step at 512): pass
//     1 streams K alone through four slots, three in flight (at 512 four K
//     chunks in the space of pass 2's two stages); pass 2 two K and two V
//     slots (at 512 the wide forward's two stages).
// The dQ kernel runs all its products on the SIMT cores' FMA:
//   * Tiles are fp32 in shared memory, row-major with a pitch of DP + 4
//     floats, read as float4. 256 threads: thread t = 16 ty + tx owns rows
//     ty + 16 i of every tile it computes and columns tx + 16 j (scores) or
//     VW tx + 16 VW j + e (head dim, VW = 4/2/1 by padded head dim).
//   * abt: a product A B^T of two row-major tiles (S = q2 K^T); per 4
//     columns of the head dim a thread loads TM + TN float4 and does 4 TM
//     TN FMA, each score one fmaf chain over the head dim from column 0.
//     ab: a score tile times a row-major operand into the register
//     accumulator.
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
//   K3, K4   <DP, D, MT, RG, SPLIT, BK> (K3 at D = DP and DP - 8, K4 at D
//            = DP with the head dim at run time); a block of 8 consumer
//            warps (K3: and a producer warpgroup), a warp scoring 16 MT rows
//            x BK / SPLIT keys; S's wavefronts a clock at the full FMA rate:
//     K3 d <= 48   block_k 32/64: 128 x BK, 8 warps (MT 1)   20,544-79,936 B  0.62/0.56
//                  128: 64 x 128 (SPLIT 2)              81,472-155,200 B  0.56
//     K3 d 72, 80  128 x 32/64 (MT 2, SPLIT 2)          107,584/166,976 B  0.50/0.38
//     K3 d 152, 160  32 x 32/64 (MT 1, SPLIT 4)         110,656/198,720 B  1.00/0.75
//     K3 d 504, 512  64 x 32 in 4 steps, 2 (SPLIT 4)            210,208 B  0.75
//     K4 d <= 80   block_c 32/64: 128 x BK (MT 2, SPLIT 2)  41,984-166,912 B  0.50/0.38
//                  128: 64 x 128 (MT 1, SPLIT 2)        81,408-228,864 B  0.56
//     K4 d 152, 160  32 x 32/64 (MT 1, SPLIT 4)         110,592/198,656 B  1.00/0.75
//     K4 d 504, 512  64 x 32/64 in 4/8 steps (SPLIT 4)  210,944/221,184 B  0.75/0.50
//            32-row warps (MT 2) halve the A loads; they won for K4 and for
//            K3 at d = 80, and lost at K3's d <= 48 (PERF.md §6).
//            The tables keep their key blocks: K3's 128-key tiles from d
//            = 80 and K4's at 160 stay unbuilt (at 160 two K and two V
//            slots of 128 rows alone take 336 KB; K3's at 80 would fit).
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
// 0.78 ms there. K3 and K4 compute the forward's function and have its
// bound (0.32 ms at (2, 4096, 8, 40), 0.51 at (2, 4096, 1, 512)); K4's
// algorithm computes S twice, a floor of 4 BH N^2 d on FMA (0.64 and 1.03
// ms there). chip_smoke.py states these bounds (bound_3xtf32); phases 20
// and 11 hold each kernel against its plain version and time it beside its
// bound.

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

// --- the forward and the backward: 3xTF32 tensor-core products beside S
// on FFMA

// S = A B^T over head-dim columns [0, kdim) in mma_tf32's C layout: s[nt][e]
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

// --- K3 and K4 on the forward's core: S by score_step (abt's order, the
// mma's C layout) on FFMA, P V as 3xTF32 mma.sync interleaved with the next
// key tile's scores, m, l and O in registers

// every cp.async group of this thread but the last N committed ones has
// landed
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the key blocks instantiated at each padded head dim; ops/flash_attention.py
// RESIDENT_BLOCKS_F32 and PIPELINED_BLOCKS_F32 list the same
constexpr bool resident_f32_instantiated(int dp, int bk) {
  return (bk < 128 || dp <= 48) && (dp < 512 || bk == 32);
}
constexpr bool pipelined_f32_instantiated(int dp, int bc) { return bc < 128 || dp <= 80; }

// (MT, RG, SPLIT) of K3's (RES) and K4's tiles at d <= 160, 8 warps a
// block: with key blocks of 32 and 64 below d = 160, K4 and K3 at d = 80
// pair 32-row warps (MT 2, SPLIT 2: half the A loads a FMA); otherwise
// 16-row warps, one a row group where it holds O's whole row (d <= 48, key
// tiles <= 64), else SPLIT a group, each over 1/SPLIT of the key tile and
// of O's columns. K3 at d <= 48 ran faster on 16-row warps on an H100.
// ops/flash_attention.py variant_tile_f32 holds the same rule: K3's q tiles
// plan its clusters.
template <int DP, int BK, bool RES>
struct VarTile {
  static constexpr bool WIDE_MT = (!RES || DP == 80) && DP <= 80 && BK < 128;
  static constexpr int MT = WIDE_MT ? 2 : 1;
  static constexpr int SPLIT = WIDE_MT ? 2 : DP <= 48 ? (BK == 128 ? 2 : 1) : DP == 80 ? 2 : 4;
  static constexpr int RG = 8 / SPLIT;
};

// K3's producer is one warp of a warpgroup of kProducerWarps whose other
// warps idle, so that the warpgroup can hand its registers to the 8
// consumer warps: launched at 168 registers a thread (12 warps an SM), the
// producer's warpgroup drops to kProducerRegs and the consumers rise to
// kConsumerRegs (setmaxnreg, sm_90a). A lone producer warp would leave 9
// warps, 3 of them on one SM sub-partition's 16K registers: 168 a thread
// for good, and the consumers spilled.
constexpr int kProducerWarps = 4, kProducerRegs = 40, kConsumerRegs = 232;

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// K3 and K4 at a padded head dim DP <= 160 and head dims d up to D (DP or
// DP - 8; d % 8 == 0, so d is D or, where D = DP, DP - 8: the last two
// column steps of the scores run where d = D): a block of RG row groups of
// 16 MT query rows, as FwdF32, over key tiles
// (K4: chunks) of BK keys; KT = BK / 8 k8 steps of P V a tile, one partial
// of at most kChain steps joining O at a time. K and V take two slots each
// (K slots 0, 1, then V slots 0, 1): tile j's V and tile j + 1's K are read
// together while tile j + 1's V and tile j + 2's K land (K4's pass 1 runs K
// alone through all four). With SPLIT > 1, P
// goes through one (BQ x LDX) tile and the row statistics through sX. K3
// adds its mbarriers (full K, V; empty K, V) at OFF_BAR.
template <int DP_, int D_, int MT_, int RG_, int SPLIT_, int BK_>
struct VarF32 {
  static constexpr int DP = DP_, D = D_, MT = MT_, RG = RG_, SPLIT = SPLIT_, BK = BK_;
  static constexpr int WARPS = RG * SPLIT, BQ = 16 * MT * RG, LD = DP + 4;
  static constexpr int KW = BK / SPLIT, NT = KW / 8, KT = BK / 8, LDX = BK + 8;
  static constexpr int SLICE = (SPLIT == 1 ? D : DP) / SPLIT, NO = SLICE / 8;
  static constexpr int CS = D / 4, CPK = CS / KT > 1 ? CS / KT : 1;
  static constexpr int TILE = BK * LD;  // floats of a slot
  static constexpr size_t OFF_KV = size_t(BQ) * LD * 4;
  static constexpr size_t OFF_P = OFF_KV + 4 * size_t(TILE) * 4;
  static constexpr size_t OFF_BAR =
      OFF_P + (SPLIT > 1 ? (size_t(BQ) * LDX + size_t(SPLIT) * BQ) * 4 : 0);
  static constexpr size_t SMEM = OFF_BAR + 8 * 8;  // K4: OFF_BAR
  static_assert(KW % 8 == 0 && SLICE % 8 == 0 && D % 8 == 0 && D <= DP && SMEM <= kSmemPerBlock,
                "K3/K4 tile");
};

// o += P V of key tile j (KT k8 steps: V from V slot j % 2 of the ring, P
// from the registers sp with SPLIT 1, else from the group's rows xP of
// shared memory; O's columns sl SLICE + 8j), a zeroed partial of at most
// kChain steps joining o in fp32 at a time; where `next`, interleaved with
// tile j + 1's scores into sn (the warp's q2 rows at qw, its K rows kb into
// K slot (j + 1) % 2), one k8 step every CPK of the D / 4 column steps
// (with RUN_D, the head dim d at run time, the last two only where d = D),
// so that the mma chains' latency lies under FMA work of the same warp (the
// forward's tile step)
template <class T, bool RUN_D>
__device__ __forceinline__ void pv_and_scores(float (&o)[T::MT][T::NO][4],
                                              float (&sn)[T::MT][T::NT][4],
                                              const float (&sp)[T::MT][T::NT][4],
                                              const float* ring, const float* xP, int sl,
                                              const float* qw, int kb, int j, int d,
                                              bool next) {
  constexpr int MT = T::MT;
  const float* sV = ring + (2 + j % 2) * T::TILE;
  const float* kn = ring + ((j + 1) % 2) * T::TILE + kb;
  float part[MT][T::NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) zero(sn[mt]), zero(part[mt]);
  auto pv = [&](int ks) {
    float f[MT][4];
    if constexpr (T::SPLIT == 1)
      FragRegs<MT, T::NT>{sp}(ks, f);
    else
      FragSmem<MT, T::LDX>{xP}(ks, f);
    uint32_t ah[MT][4], al[MT][4];
    split_p<MT>(f, ah, al);
    pv_mma<MT, T::NO, T::LD>(part, ah, al, sV + 8 * ks * T::LD, sl * T::SLICE);
    if (ks % kChain == kChain - 1 || ks == T::KT - 1) {  // the partial joins O
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jo = 0; jo < T::NO; ++jo)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[mt][jo][e] += part[mt][jo][e], part[mt][jo][e] = 0.f;
    }
  };
  if (next) {  // one branch a tile: the unrolled steps below are one block
#pragma unroll
    for (int cs = 0; cs < T::CS; ++cs) {
      if (cs % T::CPK == 0 && cs / T::CPK < T::KT) pv(cs / T::CPK);
      if (!RUN_D || cs < T::CS - 2 || d == T::D) score_step<MT, T::NT, T::LD, T::LD>(sn, qw, kn, 4 * cs);
    }
#pragma unroll
    for (int ks = (T::CS + T::CPK - 1) / T::CPK; ks < T::KT; ++ks) pv(ks);
  } else {
#pragma unroll
    for (int ks = 0; ks < T::KT; ++ks) pv(ks);
  }
}

// a whole tile's scores into s (zeroed here): K4's pass 1 and each kernel's
// first tile
template <class T>
__device__ __forceinline__ void scores_tile(float (&s)[T::MT][T::NT][4], const float* qw,
                                            const float* kn, int d) {
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) zero(s[mt]);
#pragma unroll 2
  for (int c = 0; c < d; c += 4) score_step<T::MT, T::NT, T::LD, T::LD>(s, qw, kn, c);
}

// K4's pass 2 on a C-layout tile: keys at or past kv (those past N) to 0,
// P = exp2(S - m) against the final row max m in place (no rescale) and
// this lane's share of its row sums added to l
template <int MT, int NT>
__device__ __forceinline__ void p_final(float (&s)[MT][NT][4], const float (&m)[MT][2],
                                        float (&l)[MT][2], int kv) {
  const int t = threadIdx.x % 4;
  if (kv < 8 * NT)  // the last tile only
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * nt + 2 * t + e % 2 >= kv) s[mt][nt][e] = -INFINITY;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[mt][nt][e] = exp2_sfu(s[mt][nt][e] - m[mt][h]);  // 0 at -inf
          sum += s[mt][nt][e];
        }
      l[mt][h] += sum;
    }
}

// K3's producer warp (d <= 160): K and V of key tiles [0, tiles) of head bh
// into slot j % 2 of each ring (K slot s at ring + s TILE, V slot s at
// ring + (2 + s) TILE) of every block of the cluster. This block (rank r of
// C) copies rows r, r + C, ... of each tile, one bulk copy a row multicast
// to the C blocks; each block's full barrier expects the whole tile's bytes.
// A slot is refilled once this block's empty barrier has had every consumer
// warp of the cluster.
template <class T>
__device__ __forceinline__ void produce_tiles(float* ring, uint64_t* bars, const Args& a, int bh,
                                              int tiles) {
  const int lane = threadIdx.x % 32, n = a.N;
  const int rank = (int)cluster_rank(), csize = (int)cluster_blocks();
  const uint16_t mask = csize == 1 ? 0 : (uint16_t)((1u << csize) - 1);
  const uint32_t row_bytes = a.D * 4;  // a multiple of 32: d % 8 == 0
  for (int j = 0; j < tiles; ++j) {
    const int rows = min(T::BK, n - j * T::BK);
#pragma unroll
    for (int w = 0; w < 2; ++w) {  // K, then V
      const int slot = 2 * w + j % 2;
      if (j >= 2) mbar_wait(&bars[4 + slot], (j / 2 - 1) & 1);
      if (lane == 0) mbar_expect_tx(&bars[slot], rows * row_bytes);
      const float* src = head(a, 1 + w, bh);
      const long long rs = a.st[3 * w + 4];
      float* dst = ring + slot * T::TILE;
      for (int r = rank + csize * lane; r < rows; r += 32 * csize)
        bulk_copy(dst + r * T::LD, src + (long long)(j * T::BK + r) * rs, row_bytes, &bars[slot],
                  mask);
    }
  }
}

// this warp is done with a slot of the cluster's ring: one arrival on the
// empty barrier `bar` in every block of the cluster
__device__ __forceinline__ void release_slot(uint64_t* bar) {
  __syncwarp();
  const int lane = threadIdx.x % 32;
  if (lane < (int)cluster_blocks()) mbar_arrive_remote(bar, lane);
}

// K3 at d <= 160: a cluster of C = 1, 2 or 4 blocks (neighbouring q tiles
// of one head) shares each key tile, copied by the producer warps
// (produce_tiles); the consumer warps run the forward's online softmax over
// key tiles of BK, the rescale once a tile, with tile j's P V interleaved
// with tile j + 1's scores (pv_and_scores). The ring is zeroed once, so the
// rows past N of the last tile hold zeros or an earlier tile's finite
// values (their P is 0).
template <class T>
__device__ __forceinline__ void resident_narrow(const Args& a) {
  constexpr int MT = T::MT, BK = T::BK, CONSUMERS = 32 * T::WARPS;
  using S = float[MT][T::NT][4];
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* sQ = reinterpret_cast<float*>(smem);  // q2
  float* ring = reinterpret_cast<float*>(smem + T::OFF_KV);
  float* sP = reinterpret_cast<float*>(smem + T::OFF_P);  // SPLIT > 1: P
  float* sX = sP + T::BQ * T::LDX;                         // and the row statistics
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + T::OFF_BAR);  // full K, V; empty K, V
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N;
  const int tiles = (n + BK - 1) / BK;
  // set-up: the ring zeroed, the barriers initialised (full: one arrival,
  // this block's expect_tx; empty: the cluster's consumer warps) and q2
  // loaded by the consumers; then a cluster sync, after which any block may
  // copy into any other's ring and arrive on its barriers
  for (int i = threadIdx.x; i < T::TILE; i += CONSUMERS + 32 * kProducerWarps)  // TILE float4
    smem4[T::OFF_KV / 16 + i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0)
    for (int s = 0; s < 4; ++s) {
      mbar_init(&bars[s], 1);
      mbar_init(&bars[4 + s], cluster_blocks() * T::WARPS);
    }
  if (threadIdx.x < CONSUMERS) {
    copy_chunks<T::BQ, T::DP, T::LD, CONSUMERS>(sQ, head(a, 0, bh), a.st[1], q0, 0, n, T::D);
    cp_async_commit();
    cp_async_wait_all();
    scale_tile<T::DP, T::BQ, CONSUMERS>(sQ, a.scale_log2);  // the chunks this thread copied
  }
  fence_barrier_init();
  cluster_sync();

  if (threadIdx.x >= CONSUMERS) {
    producer_regs();
    if (threadIdx.x < CONSUMERS + 32) produce_tiles<T>(ring, bars, a, bh, tiles);
  } else {
    consumer_regs();
    const int warp = threadIdx.x / 32, rg = warp / T::SPLIT, sl = warp % T::SPLIT;
    const int r0 = rg * 16 * MT, lane = threadIdx.x % 32;
    const float* qw = sQ + (r0 + lane / 4) * T::LD;  // score_step's rows
    const int kb = (sl * T::KW + 2 * (lane % 4)) * T::LD;
    float o[MT][T::NO][4], m[MT][2], l[MT][2];
    S s0, s1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      zero(o[mt]);
      m[mt][0] = m[mt][1] = -INFINITY;
      l[mt][0] = l[mt][1] = 0.f;
    }
    // tile jn's online-softmax step on its scores s: the row maxima (with
    // SPLIT > 1 over the group through sX), m, l and o rescaled once, P =
    // exp2(S - m); with SPLIT > 1 P into sP, whole after a second group
    // barrier (which also frees sX)
    auto softmax = [&](S& s, int jn) {
      float mx[MT][2];
      tile_max<MT, T::NT>(s, mx, n - jn * BK - sl * T::KW);
      if constexpr (T::SPLIT > 1) {
        put_rows<MT, T::BQ>(sX, sl, r0, mx);
        group_sync<T::SPLIT>(rg);  // the group is done with tile jn - 1's P too
        get_rows<MT, T::BQ, T::SPLIT, true>(mx, sX, r0);
      }
      softmax_c<MT, T::NT, T::NO>(s, mx, m, l, o);
      if constexpr (T::SPLIT > 1) {
        store_p<MT, T::NT, T::LDX>(sP + r0 * T::LDX + sl * T::KW, s);
        group_sync<T::SPLIT>(rg);
      }
    };
    // tile j: its P V interleaved with tile j + 1's scores into sn, then
    // tile j + 1's softmax step; each slot is released once read
    auto tile = [&](int j, S& sp, S& sn) {
      const bool next = j + 1 < tiles;
      if (next) mbar_wait(&bars[(j + 1) % 2], ((j + 1) / 2) & 1);
      mbar_wait(&bars[2 + j % 2], (j / 2) & 1);
      pv_and_scores<T, false>(o, sn, sp, ring, sP + r0 * T::LDX, sl, qw, kb, j, T::D, next);
      release_slot(&bars[6 + j % 2]);
      if (next) {
        release_slot(&bars[4 + (j + 1) % 2]);
        softmax(sn, j + 1);
      }
    };
    mbar_wait(&bars[0], 0);
    scores_tile<T>(s0, qw, ring + kb, T::D);
    release_slot(&bars[4]);
    softmax(s0, 0);
    // the score arrays take turns, so that P is never copied
    for (int j = 0; j < tiles; j += 2) {
      tile(j, s0, s1);
      if (j + 1 < tiles) tile(j + 1, s1, s0);
    }
    finish_rows<MT, T::NO, T::BQ, T::SPLIT>(a, bh, q0, r0, sl, rg, sl * T::SLICE, o, m, l, sX);
  }
  cluster_sync();  // no block leaves while a peer may still copy into it or arrive on it
}

// K4 at d <= 160: pass 1 takes the row max over chunks of BK keys (scores
// and a running max, no exp2), pass 2 forms P = exp2(S - m_final) with no
// rescale and sums l and P V, chunk j's P V interleaved with chunk j + 1's
// scores. Pass 2's scores are pass 1's bit for bit (one code path), so
// every P is <= 1. Chunks arrive by cp.async (compile-time indices), one
// block barrier a chunk: in pass 1 K chunks alone through all four slots
// (three in flight), in pass 2 chunk j's K into K slot j % 2 and its V
// into V slot j % 2.
template <class T>
__device__ __forceinline__ void pipelined_narrow(const Args& a) {
  constexpr int MT = T::MT, BK = T::BK, NTH = 32 * T::WARPS;
  using S = float[MT][T::NT][4];
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* sQ = reinterpret_cast<float*>(smem);  // q2
  float* ring = reinterpret_cast<float*>(smem + T::OFF_KV);
  float* sP = reinterpret_cast<float*>(smem + T::OFF_P);  // SPLIT > 1: P
  float* sX = sP + T::BQ * T::LDX;                         // and the row statistics
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N, d = a.D;
  const int chunks = (n + BK - 1) / BK;
  const float* kg = head(a, 1, bh);
  const float* vg = head(a, 2, bh);
  auto copy_k = [&](int j, int slot) {  // chunk j's K into slot `slot` (0-3)
    if (j < chunks)
      copy_chunks<BK, T::DP, T::LD, NTH>(ring + slot * T::TILE, kg, a.st[4], j * BK, 0, n,
                                         d);
  };
  auto copy_v = [&](int j) {  // chunk j's V into V slot j % 2
    if (j < chunks)
      copy_chunks<BK, T::DP, T::LD, NTH>(ring + (2 + j % 2) * T::TILE, vg, a.st[7], j * BK, 0,
                                         n, d);
  };
  copy_chunks<T::BQ, T::DP, T::LD, NTH>(sQ, head(a, 0, bh), a.st[1], q0, 0, n, d);
#pragma unroll
  for (int i = 0; i < 3; ++i) copy_k(i, i), cp_async_commit();  // the first group holds q too
  cp_async_wait_group<2>();
  scale_tile<T::DP, T::BQ, NTH>(sQ, a.scale_log2);  // q2: the chunks this thread copied
  const int warp = threadIdx.x / 32, rg = warp / T::SPLIT, sl = warp % T::SPLIT;
  const int r0 = rg * 16 * MT, lane = threadIdx.x % 32;
  const float* qw = sQ + (r0 + lane / 4) * T::LD;
  const int kb = (sl * T::KW + 2 * (lane % 4)) * T::LD;
  float o[MT][T::NO][4], m[MT][2], l[MT][2];
  S s0, s1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    zero(o[mt]);
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  // pass 1: the row max
  for (int i = 0; i < chunks; ++i) {
    cp_async_wait_group<2>();
    // chunk i (at i = 0 q2 too) is visible to every thread, and every
    // thread is done with chunk i - 1's slot
    __syncthreads();
    copy_k(i + 3, (i + 3) % 4);
    cp_async_commit();
    scores_tile<T>(s0, qw, ring + (i % 4) * T::TILE + kb, d);
    float mx[MT][2];
    tile_max<MT, T::NT>(s0, mx, n - i * BK - sl * T::KW);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) m[mt][0] = fmaxf(m[mt][0], mx[mt][0]),
                                    m[mt][1] = fmaxf(m[mt][1], mx[mt][1]);
  }
  if constexpr (T::SPLIT > 1) {  // the final row max over the group
    put_rows<MT, T::BQ>(sX, sl, r0, m);
    group_sync<T::SPLIT>(rg);
    get_rows<MT, T::BQ, T::SPLIT, true>(m, sX, r0);
  }
  // pass 2: chunk 0's P, then chunk j's P V with chunk j + 1's scores
  auto pfinal = [&](S& s, int jn) {
    p_final<MT, T::NT>(s, m, l, n - jn * BK - sl * T::KW);
    if constexpr (T::SPLIT > 1) {
      group_sync<T::SPLIT>(rg);  // the group is done with chunk jn - 1's P
      store_p<MT, T::NT, T::LDX>(sP + r0 * T::LDX + sl * T::KW, s);
    }
  };
  cp_async_wait_all();
  __syncthreads();  // every thread is done with pass 1's slots (and the row statistics)
  copy_k(0, 0);
  copy_v(0);
  cp_async_commit();
  copy_k(1, 1);
  cp_async_commit();
  cp_async_wait_but_last();
  __syncthreads();  // chunk 0's K and V are visible to every thread
  scores_tile<T>(s0, qw, ring + kb, d);
  pfinal(s0, 0);
  auto tile = [&](int j, S& sp, S& sn) {
    cp_async_wait_all();
    // chunk j + 1's K and chunk j's V (and with SPLIT > 1 chunk j's P) are
    // visible to every thread, and every thread is done with chunk j's K
    // and chunk j - 1's V
    __syncthreads();
    copy_k(j + 2, j % 2);
    copy_v(j + 1);
    cp_async_commit();
    const bool next = j + 1 < chunks;
    pv_and_scores<T, true>(o, sn, sp, ring, sP + r0 * T::LDX, sl, qw, kb, j, d, next);
    if (next) pfinal(sn, j + 1);
  };
  for (int j = 0; j < chunks; j += 2) {
    tile(j, s0, s1);
    if (j + 1 < chunks) tile(j + 1, s1, s0);
  }
  finish_rows<MT, T::NO, T::BQ, T::SPLIT>(a, bh, q0, r0, sl, rg, sl * T::SLICE, o, m, l, sX);
}

// K3 and K4 at d = 512 run on the wide forward's step (FwdWideF32 with BK =
// 8 DP / CK: a key tile of BK keys takes KC = BK / 8 steps; step s of tile
// j's iteration holds tile j + 1's K chunk s (BK keys x CK columns) and
// tile j's V chunk s (8 keys x 512 columns)), 2 stages. K3's stages come
// from the cluster's producer warps (full and empty mbarriers after the
// forward's shared memory, a stage released by each warp once read); K4's
// by cp.async, one block barrier a step, through pass 1 (K chunks only) and
// pass 2.

// the wide forward's tile at d = 512 with key tiles of BK (CK = 8 DP / BK
// columns a K chunk, CW n8 tiles of partials at a time), K3's two full and
// two empty mbarriers after its shared memory
template <int MT_, int RG_, int SPLIT_, int BK_>
struct WideVar : FwdWideF32<MT_, RG_, SPLIT_, 8 * 512 / BK_, 2> {
  using F = FwdWideF32<MT_, RG_, SPLIT_, 8 * 512 / BK_, 2>;
  static constexpr int MT = MT_, RG = RG_, SPLIT = SPLIT_, CK = 8 * 512 / BK_, CW = 2;
  static constexpr size_t SMEM_RES = F::SMEM + 4 * 8;
  // K4's pass 1 streams K chunks alone through P1_SLOTS slots of KCH
  // floats in a ring region that also holds pass 2's two stages
  static constexpr int KCH = F::BK * F::LDK, P1_SLOTS = 4;
  static constexpr int RING = 2 * F::STAGE > P1_SLOTS * KCH ? 2 * F::STAGE : P1_SLOTS * KCH;
  static constexpr size_t OFF_X4 = F::OFF_RING + size_t(RING) * 4;
  static constexpr size_t SMEM4 = OFF_X4 + (size_t(F::BQ) * F::LDX + SPLIT * F::BQ) * 4;
  static_assert(SMEM_RES <= kSmemPerBlock && SMEM4 <= kSmemPerBlock, "K3/K4 tile at d = 512");
};

// o += the k8 step st of P V at d = 512 (the wide forward's step): P's
// fragment from the group's rows xP, V's 8 rows of the step at sV into O's
// columns sl SLICE + 8j, CW n8 tiles of partials at a time, each joining o
// in fp32
template <class T>
__device__ __forceinline__ void pv_step_wide(float (&o)[T::MT][T::NO][4], const float* xP,
                                             const float* sV, int sl, int st) {
  constexpr int MT = T::MT;
  float f[MT][4];
  FragSmem<MT, T::LDX>{xP}(st, f);
  uint32_t ah[MT][4], al[MT][4];
  split_p<MT>(f, ah, al);
#pragma unroll
  for (int j0 = 0; j0 < T::NO; j0 += T::CW) {
    float part[MT][T::CW][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) zero(part[mt]);
    pv_mma<MT, T::CW, T::LD>(part, ah, al, sV, sl * T::SLICE + 8 * j0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jj = 0; jj < T::CW; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][j0 + jj][e] += part[mt][jj][e];
  }
}

// a key tile's scores s at d = 512 over K chunk st's columns (zeroed at st
// 0), from the warp's K rows kn of the chunk
template <class T>
__device__ __forceinline__ void scores_chunk(float (&s)[T::MT][T::NT][4], const float* qw,
                                             const float* kn, int st, int d) {
  if (st == 0)
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) zero(s[mt]);
  const int c0 = st * T::CK, cols = min(T::CK, d - c0);
#pragma unroll 2
  for (int c = 0; c < cols; c += 4) score_step<T::MT, T::NT, T::LD, T::LDK>(s, qw + c0, kn, c);
}

// K3's producer warp at d = 512: step i's K chunk (tile i / KC, columns
// [CK (i % KC), + CK)) and V chunk (8 keys of tile i / KC - 1) into stage
// i % 2 of every block of the cluster, rows r, r + C, ... of the step by
// this block (rank r)
template <class T>
__device__ __forceinline__ void produce_steps(float* ring, uint64_t* bars, const Args& a, int bh,
                                              int tiles, int steps) {
  constexpr int BK = T::BK, KC = T::KC, CK = T::CK;
  const int lane = threadIdx.x % 32, n = a.N, d = a.D;
  const int rank = (int)cluster_rank(), csize = (int)cluster_blocks();
  const uint16_t mask = csize == 1 ? 0 : (uint16_t)((1u << csize) - 1);
  const float* kg = head(a, 1, bh);
  const float* vg = head(a, 2, bh);
  for (int i = 0; i < steps; ++i) {
    const int s = i % 2, jk = i / KC, st = i % KC;
    if (i >= 2) mbar_wait(&bars[2 + s], (i / 2 - 1) & 1);
    const int c0 = st * CK, v0 = (jk - 1) * BK + 8 * st;
    const int krows = jk < tiles ? min(BK, n - jk * BK) : 0;
    const int vrows = jk > 0 ? max(0, min(8, n - v0)) : 0;
    const uint32_t kbytes = min(CK, d - c0) * 4, vbytes = d * 4;  // multiples of 32
    if (lane == 0) mbar_expect_tx(&bars[s], krows * kbytes + vrows * vbytes);
    float* stage = ring + s * T::STAGE;
    for (int r = rank + csize * lane; r < krows + vrows; r += 32 * csize) {
      if (r < krows)
        bulk_copy(stage + r * T::LDK, kg + (long long)(jk * BK + r) * a.st[4] + c0, kbytes,
                  &bars[s], mask);
      else
        bulk_copy(stage + BK * T::LDK + (r - krows) * T::LD,
                  vg + (long long)(v0 + r - krows) * a.st[7], vbytes, &bars[s], mask);
    }
  }
}

template <class T>
__device__ __forceinline__ void resident_wide(const Args& a) {
  constexpr int MT = T::MT, BK = T::BK, KC = T::KC;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* sQ = reinterpret_cast<float*>(smem);  // q2
  float* ring = reinterpret_cast<float*>(smem + T::OFF_RING);
  float* sP = reinterpret_cast<float*>(smem + T::OFF_X);
  float* sX = sP + T::BQ * T::LDX;  // the row statistics
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + T::SMEM);  // full 0, 1; empty 0, 1
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N, d = a.D;
  const int tiles = (n + BK - 1) / BK, steps = (tiles + 1) * KC;
  for (int i = threadIdx.x; i < T::STAGE / 2; i += T::THREADS + 32 * kProducerWarps)
    smem4[T::OFF_RING / 16 + i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0)
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bars[s], 1);
      mbar_init(&bars[2 + s], cluster_blocks() * (T::THREADS / 32));
    }
  if (threadIdx.x < T::THREADS) {
    copy_chunks<T::BQ, T::DP, T::LD, T::THREADS>(sQ, head(a, 0, bh), a.st[1], q0, 0, n, d);
    cp_async_commit();
    cp_async_wait_all();
    scale_tile<T::DP, T::BQ, T::THREADS>(sQ, a.scale_log2);
  }
  fence_barrier_init();
  cluster_sync();

  if (threadIdx.x >= T::THREADS) {
    producer_regs();
    if (threadIdx.x < T::THREADS + 32) produce_steps<T>(ring, bars, a, bh, tiles, steps);
  } else {
    consumer_regs();
    const int warp = threadIdx.x / 32, rg = warp / T::SPLIT, sl = warp % T::SPLIT;
    const int r0 = rg * 16 * MT, lane = threadIdx.x % 32;
    const float* qw = sQ + (r0 + lane / 4) * T::LD;
    const int kb = (sl * T::KW + 2 * (lane % 4)) * T::LDK;
    float o[MT][T::NO][4], m[MT][2], l[MT][2], s[MT][T::NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      zero(o[mt]);
      m[mt][0] = m[mt][1] = -INFINITY;
      l[mt][0] = l[mt][1] = 0.f;
    }
    for (int i = 0; i < steps; ++i) {
      mbar_wait(&bars[i % 2], (i / 2) & 1);
      const float* stage = ring + (i % 2) * T::STAGE;
      const int jk = i / KC, st = i % KC;
      if (jk > 0) pv_step_wide<T>(o, sP + r0 * T::LDX, stage + BK * T::LDK, sl, st);
      if (jk < tiles) scores_chunk<T>(s, qw, stage + kb, st, d);
      release_slot(&bars[2 + i % 2]);
      if (jk < tiles && st == KC - 1) {  // tile jk's softmax step, P into sP
        float mx[MT][2];
        tile_max<MT, T::NT>(s, mx, n - jk * BK - sl * T::KW);
        put_rows<MT, T::BQ>(sX, sl, r0, mx);
        group_sync<T::SPLIT>(rg);  // the group is done with tile jk - 1's P too
        get_rows<MT, T::BQ, T::SPLIT, true>(mx, sX, r0);
        softmax_c<MT, T::NT, T::NO>(s, mx, m, l, o);
        store_p<MT, T::NT, T::LDX>(sP + r0 * T::LDX + sl * T::KW, s);
        group_sync<T::SPLIT>(rg);  // P is whole, and sX is free
      }
    }
    finish_rows<MT, T::NO, T::BQ, T::SPLIT>(a, bh, q0, r0, sl, rg, sl * T::SLICE, o, m, l, sX);
  }
  cluster_sync();
}

template <class T>
__device__ __forceinline__ void pipelined_wide(const Args& a) {
  constexpr int MT = T::MT, BK = T::BK, KC = T::KC, CK = T::CK, P1S = T::P1_SLOTS;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* sQ = reinterpret_cast<float*>(smem);  // q2
  float* ring = reinterpret_cast<float*>(smem + T::OFF_RING);
  float* sP = reinterpret_cast<float*>(smem + T::OFF_X4);
  float* sX = sP + T::BQ * T::LDX;  // the row statistics
  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ, n = a.N, d = a.D;
  const int chunks = (n + BK - 1) / BK, p1 = chunks * KC, steps = (chunks + 1) * KC;
  const float* kg = head(a, 1, bh);
  const float* vg = head(a, 2, bh);
  // pass 1's step i: K chunk i % KC of chunk i / KC into slot i % P1S (one
  // cp.async group, empty past the last step)
  auto issue1 = [&](int i) {
    if (i < p1)
      copy_chunks<BK, CK, T::LDK, T::THREADS>(ring + (i % P1S) * T::KCH, kg, a.st[4],
                                               i / KC * BK, i % KC * CK, n, d);
    cp_async_commit();
  };
  // pass 2's step i into stage i % 2, as the forward's: K chunk i % KC of
  // chunk i / KC and V chunk i % KC (8 keys) of the chunk before
  auto issue2 = [&](int i) {
    float* stage = ring + (i % 2) * T::STAGE;
    const int jk = i / KC, st = i % KC;
    if (jk < chunks)
      copy_chunks<BK, CK, T::LDK, T::THREADS>(stage, kg, a.st[4], jk * BK, st * CK, n, d);
    if (jk > 0)
      copy_chunks<8, T::DP, T::LD, T::THREADS>(stage + BK * T::LDK, vg, a.st[7],
                                                (jk - 1) * BK + 8 * st, 0, n, d);
    cp_async_commit();
  };
  copy_chunks<T::BQ, T::DP, T::LD, T::THREADS>(sQ, head(a, 0, bh), a.st[1], q0, 0, n, d);
#pragma unroll
  for (int i = 0; i < P1S - 1; ++i) issue1(i);  // the first group holds q too
  cp_async_wait_group<P1S - 2>();
  scale_tile<T::DP, T::BQ, T::THREADS>(sQ, a.scale_log2);
  const int warp = threadIdx.x / 32, rg = warp / T::SPLIT, sl = warp % T::SPLIT;
  const int r0 = rg * 16 * MT, lane = threadIdx.x % 32;
  const float* qw = sQ + (r0 + lane / 4) * T::LD;
  const int kb = (sl * T::KW + 2 * (lane % 4)) * T::LDK;
  float o[MT][T::NO][4], m[MT][2], l[MT][2], s[MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    zero(o[mt]);
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  // pass 1: the row max, P1S - 1 steps in flight
  for (int i = 0; i < p1; ++i) {
    cp_async_wait_group<P1S - 2>();
    // step i (at i = 0 q2 too) is visible to every thread, and every thread
    // is done with step i - 1's slot
    __syncthreads();
    issue1(i + P1S - 1);
    const int jk = i / KC, st = i % KC;
    scores_chunk<T>(s, qw, ring + (i % P1S) * T::KCH + kb, st, d);
    if (st == KC - 1) {
      float mx[MT][2];
      tile_max<MT, T::NT>(s, mx, n - jk * BK - sl * T::KW);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) m[mt][0] = fmaxf(m[mt][0], mx[mt][0]),
                                      m[mt][1] = fmaxf(m[mt][1], mx[mt][1]);
    }
  }
  // the final row max over the group
  put_rows<MT, T::BQ>(sX, sl, r0, m);
  group_sync<T::SPLIT>(rg);
  get_rows<MT, T::BQ, T::SPLIT, true>(m, sX, r0);
  cp_async_wait_all();
  __syncthreads();  // every thread is done with pass 1's slots and sX
  issue2(0);
  // pass 2: P against the final max, chunk jk - 1's P V with chunk jk's
  // scores, one block barrier a step, the next step in flight
  for (int i = 0; i < steps; ++i) {
    cp_async_wait_all();
    // step i's chunks (at a chunk's first step its P) are visible to every
    // thread, and every thread is done with step i - 1's stage
    __syncthreads();
    if (i + 1 < steps) issue2(i + 1);
    const float* stage = ring + (i % 2) * T::STAGE;
    const int jk = i / KC, st = i % KC;
    if (jk > 0) pv_step_wide<T>(o, sP + r0 * T::LDX, stage + BK * T::LDK, sl, st);
    if (jk < chunks) {
      scores_chunk<T>(s, qw, stage + kb, st, d);
      if (st == KC - 1) {  // P against the final max into sP
        p_final<MT, T::NT>(s, m, l, n - jk * BK - sl * T::KW);
        group_sync<T::SPLIT>(rg);  // the group is done with chunk jk - 1's P
        store_p<MT, T::NT, T::LDX>(sP + r0 * T::LDX + sl * T::KW, s);
      }
    }
  }
  finish_rows<MT, T::NO, T::BQ, T::SPLIT>(a, bh, q0, r0, sl, rg, sl * T::SLICE, o, m, l, sX);
}

// K3: <DP, D, MT, RG, SPLIT, BK> (VarF32 at DP <= 160; WideVar at 512,
// where D = DP and the head dim is the runtime one), a producer warpgroup
// beside 32 RG SPLIT consumer threads
template <int DP, int D, int MT, int RG, int SPLIT, int BK>
__global__ void __launch_bounds__(32 * (RG * SPLIT + kProducerWarps), 1)
    flash_resident_f32_kernel(const Args a) {
  if constexpr (DP == 512)
    resident_wide<WideVar<MT, RG, SPLIT, BK>>(a);
  else
    resident_narrow<VarF32<DP, D, MT, RG, SPLIT, BK>>(a);
}

// K4: the same template arguments (its own VarTile choice), no producer
template <int DP, int D, int MT, int RG, int SPLIT, int BK>
__global__ void __launch_bounds__(32 * RG * SPLIT, 1) flash_pipelined_f32_kernel(const Args a) {
  if constexpr (DP == 512)
    pipelined_wide<WideVar<MT, RG, SPLIT, BK>>(a);
  else
    pipelined_narrow<VarF32<DP, D, MT, RG, SPLIT, BK>>(a);
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

// one launch of K3's KERNEL in clusters of `cluster` blocks over (q tiles of
// `rows`, B*H) with `threads` threads and `smem` bytes of dynamic shared
// memory; C neighbouring q tiles of one head a cluster, the last cluster's
// blocks past N taking part in its copies
template <auto KERNEL>
cudaError_t launch_cluster(int rows, int threads, size_t smem, int cluster, const Args& a,
                           cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const int q_tiles = (a.N + rows - 1) / rows;
  cudaLaunchAttribute dims[1];
  dims[0].id = cudaLaunchAttributeClusterDimension;
  dims[0].val.clusterDim.x = cluster;
  dims[0].val.clusterDim.y = 1;
  dims[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((q_tiles + cluster - 1) / cluster * cluster, a.B * a.H);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = dims;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, KERNEL, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// K3 and K4 at a padded head dim DP and key block BK: VarTile's tile at DP
// <= 160, WideVar<2, 2, 4, BK> at 512. K3 is built at D = DP and DP - 8
// (as launch_fwd): with the head dim at run time it ran 3.4% slower at (2,
// 4096, 8, 40) and block_k 64 on an H100 (9% at 32; PERF.md §6). K4 is
// built at D = DP alone: it held within 1.7% there.
template <int DP, int BK>
cudaError_t launch_resident(const Args& a, int cluster, cudaStream_t s) {
  if constexpr (DP == 512) {
    using T = WideVar<2, 2, 4, BK>;
    return launch_cluster<flash_resident_f32_kernel<DP, DP, 2, 2, 4, BK>>(
        T::BQ, T::THREADS + 32 * kProducerWarps, T::SMEM_RES, cluster, a, s);
  } else {
    using W = VarTile<DP, BK, true>;
    using T = VarF32<DP, DP, W::MT, W::RG, W::SPLIT, BK>;
    return a.D == DP
               ? launch_cluster<flash_resident_f32_kernel<DP, DP, W::MT, W::RG, W::SPLIT, BK>>(
                     T::BQ, 32 * (T::WARPS + kProducerWarps), T::SMEM, cluster, a, s)
               : launch_cluster<flash_resident_f32_kernel<DP, DP - 8, W::MT, W::RG, W::SPLIT, BK>>(
                     T::BQ, 32 * (T::WARPS + kProducerWarps), T::SMEM, cluster, a, s);
  }
}

template <int DP, int BK>
cudaError_t launch_pipelined(const Args& a, cudaStream_t s) {
  if constexpr (DP == 512) {
    using T = WideVar<2, 2, 4, BK>;
    return launch<flash_pipelined_f32_kernel<DP, DP, 2, 2, 4, BK>>(T::BQ, T::THREADS, T::SMEM4,
                                                                   a, s);
  } else {
    using W = VarTile<DP, BK, false>;
    using T = VarF32<DP, DP, W::MT, W::RG, W::SPLIT, BK>;
    return launch<flash_pipelined_f32_kernel<DP, DP, W::MT, W::RG, W::SPLIT, BK>>(
        T::BQ, 32 * T::WARPS, T::OFF_BAR, a, s);
  }
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
// ops/flash_attention.py SUPPORTED_HEAD_DIMS (tuned_head_dim). The launch
// lines are <DP, row groups of 16, warps a row group, streamed tile rows,
// ring stages>.
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
