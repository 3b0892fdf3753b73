// The resident and pipelined flash-attention forward at any head dim d,
// 1 <= d <= 1024, for Hopper (sm_90a): bf16 and fp32 operands, the head dim
// a run-time argument.
//
// They serve the (head dim, key block) pairs that the tuned kernels
// (csrc/flash_variants.cu for bf16, csrc/flash_fp32.cu for fp32) do not
// instantiate, as ops/flash_attention.py's kernel_entry picks them, and
// replace there two Pallas kernels of pbe_tpu/ops/flash_attention.py, which
// pad any d to 128 lanes:
//   pbe_flash_resident_anyd_{bf16,f32}   _flash_kernel_resident (K3, :182)
//   pbe_flash_pipelined_anyd_{bf16,f32}  _flash_kernel_pipelined (K4, :111)
// Only a named variant of ops/flash_attention.py's flash_forward reaches
// them (the attention benchmark); no edit, training or model path does.
// They compute the forward's function (ops/flash_attention.py:12-18: q2 =
// round_T(q d^-1/2 log2(e)), S = q2 K^T in fp32 in the exp2 domain, P
// rounded to T before P V, O = round_T(acc / l), the LSE m + log2(l)) on
// the Pallas kernels' two schedules of the softmax:
//   * K3 (resident): key tiles of block_k, one online-softmax step a tile
//     (the new row max m, l and O rescaled by exp2(m_old - m_new)), P =
//     exp2(S - m) against the running max of its tile (the Pallas body).
//   * K4 (pipelined): two passes over key chunks of block_c. Pass 1 takes S
//     and the row max only (K alone is read); pass 2 takes S again, P =
//     exp2(S - m_final), l summed a chunk, and O += P V, never rescaled.
// The TPU kernel keeps a head's K and V resident in VMEM; on this card they
// stream from L2, and the tuned bf16 K3 shares each key tile over a
// thread-block cluster. These kernels run clusters of 1 (the entry refuses
// any other size): sharing key tiles at any head dim is later work.
//
// Their bodies are the any-head-dim forward's (csrc/flash_anyd.cu's
// fwd_mma and fwd_tf32, the key block a template argument, TWO_PASS
// choosing K4's schedule; flash_fwd_anyd_mma and flash_fwd_anyd_tf32 are
// K3 at block 64), included below with flash_anyd.cu's launch plans and
// entries left out (PBE_ANYD_DEVICE_ONLY). This file holds the kernels'
// names, their launch plans and the entries. The layout: any (batch, seq,
// head) strides, a unit head-dim stride; outputs (B, N, H, D) contiguous;
// rows past N read as zeros and their keys masked.
//   * bf16, on mma.sync.m16n8k16 (flash_resident_anyd_mma,
//     flash_pipelined_anyd_mma): a block of WARPS warps owns 16 WARPS query
//     rows, its q2 tile resident at the padded head dim (made by the
//     threads that copied each piece), and an output slice of CS columns (a
//     wider head splits over grid.z, each split computing S again). K and V
//     come in panels of BK keys x KC = 64 columns through the 3-slot
//     cp.async ring (pieces of 16/8/4/2 bytes by load_log2); S builds over
//     the panels in chunk_scores' k-order, in registers (BK / 8 n8 tiles),
//     and P is fed back as the A fragments of P V. K4's ring brings each
//     chunk's K panels in pass 1, then each chunk's K and V panels in pass 2.
//   * fp32, S on FMA and P V on 3xTF32 mma.sync.m16n8k8
//     (flash_resident_anyd_tf32, flash_pipelined_anyd_tf32): the same shape
//     of block, warps and ring, q2 resident where it fits beside the ring
//     (QRES) or streamed as panels beside each K panel (in slices of 192
//     columns, or 64 at tiles of 128 keys); S in mma_tf32's C
//     layout, each score one fmaf chain over the head dim from column 0
//     (so K4's second S is its first bit for bit), and P, in registers,
//     the A fragments of P V, one zeroed partial a run of up to 64 keys.
// Tiles (fwd_mma_plan and fwd_tf32_plan, shared with the any-head-dim
// forward): WARPS = 8, or 4 at N <= 64 (one 64-row block) or, at bf16,
// where the q2 tile of 8 warps does not fit beside the ring (d > 832, 784
// and 672 at BK = 32, 64 and 128), and 8 at fp32 where q2 streams; CS =
// 128 up to d = 128, else 256, and
// 128 at key tiles of 128 (S of 128 keys beside 256 accumulator columns
// would leave no registers): bf16 at BK = 128, fp32 K3 at BK = 128, as fp32
// takes tiles of 64 keys otherwise (a tile of 64 two blocks of 32, K4's
// chunk of 128 two tiles); at fp32 q2 resident up to d = 344 at tiles of 64
// and 240 at 128 (8 warps), streamed past that.
//
// What bounds them: the function's 4 B H N^2 d FLOP (bf16 tensor cores;
// at fp32 S's half on FMA beside P V's in 3xTF32), its B H N^2
// exponentials, or its bytes (q, k, v read once, o written once). At the
// DDPM UNet's (128, 256, 1, 256) bytes bind the
// bf16 pair (67 MB, 0.020 ms at 3.35 TB/s); at (2, 4096, 8, 64) the
// products and the exponentials (0.070 / 0.069 ms). K4 computes S twice
// (6 B H N^2 d in all). Both run well above their bounds for
// flash_fwd_anyd_mma's reasons (PERF.md section 6): ldmatrix and mma.sync
// at 8 warps an SM, each warp reading the whole K panel, every block of a
// head reading K and V again from L2. chip_smoke.py phase 30 checks them
// at every head dim of ANYD_DIMS and times them beside their bound, their
// plain version, SDPA and flash_fwd_anyd.
//
// Nothing is atomic: each output element has one owner, so a launch is
// bitwise repeatable.

#define PBE_ANYD_DEVICE_ONLY
#include "flash_anyd.cu"

namespace {

// --- the kernels: the any-head-dim forward's bodies at key blocks of BK ---------

template <int WARPS, int CS, int BK>
__global__ void __launch_bounds__(32 * WARPS, 1) flash_resident_anyd_mma(const Args<bf16> a) {
  fwd_mma<WARPS, CS, BK, false>(a);
}

template <int WARPS, int CS, int BK>
__global__ void __launch_bounds__(32 * WARPS, 1) flash_pipelined_anyd_mma(const Args<bf16> a) {
  fwd_mma<WARPS, CS, BK, true>(a);
}

template <int WARPS, int CS, int BK, bool QRES>
__global__ void __launch_bounds__(32 * WARPS, 1) flash_resident_anyd_tf32(const Args<float> a) {
  fwd_tf32<WARPS, CS, BK, QRES, false>(a);
}

template <int WARPS, int CS, int BK, bool QRES>
__global__ void __launch_bounds__(32 * WARPS, 1) flash_pipelined_anyd_tf32(const Args<float> a) {
  fwd_tf32<WARPS, CS, BK, QRES, true>(a);
}

// --- the launch plans ----------------------------------------------------------

template <bool TWO_PASS, int WARPS, int CS, int BK>
cudaError_t launch_mma(const Args<bf16>& a, cudaStream_t stream) {
  void (*kern)(Args<bf16>);
  if constexpr (TWO_PASS)
    kern = flash_pipelined_anyd_mma<WARPS, CS, BK>;
  else
    kern = flash_resident_anyd_mma<WARPS, CS, BK>;
  // once per instantiation (thread-safe static init): allow > 48 KB dynamic smem
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  return launch_fwd_tiles<WARPS, CS, BK>(kern, attr, a, stream);
}

// bf16: the any-head-dim forward's plan (fwd_mma_plan) at key blocks of BK
template <bool TWO_PASS, int BK>
cudaError_t launch_block(const Args<bf16>& a, cudaStream_t stream) {
  return fwd_mma_plan<BK>(a, [&](auto warps, auto cs) {
    return launch_mma<TWO_PASS, decltype(warps)::value, decltype(cs)::value, BK>(a, stream);
  });
}

// fp32: the any-head-dim forward's plan (fwd_tf32_plan) at key blocks of BK
template <bool TWO_PASS, int BK>
cudaError_t launch_block(const Args<float>& a, cudaStream_t stream) {
  return fwd_tf32_plan<BK, TWO_PASS>(a, [&](auto warps, auto cs, auto qres) {
    constexpr int W = decltype(warps)::value, C = decltype(cs)::value;
    constexpr bool R = decltype(qres)::value;
    void (*kern)(Args<float>);
    if constexpr (TWO_PASS)
      kern = flash_pipelined_anyd_tf32<W, C, BK, R>;
    else
      kern = flash_resident_anyd_tf32<W, C, BK, R>;
    static const cudaError_t attr =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    return launch_fwd_tf32_tiles<W, C, BK, R, TWO_PASS>(kern, attr, a, stream);
  });
}

// an entry's launch: key blocks of 32, 64 or 128 (cudaErrorInvalidValue
// for any other, or for a shape make_args refuses)
template <typename T, bool TWO_PASS>
int run_variant(const void* q, const void* k, const void* v, void* o, void* lse, int B, int N,
                int H, int D, const long long* st, float scale, int block, void* stream) {
  const void* in[3] = {q, k, v};
  Args<T> a;
  const cudaError_t err = make_args(&a, in, 3, st, nullptr, nullptr, o, nullptr, lse, B, N, H, D,
                                    scale, 0.f);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 32:
      return (int)launch_block<TWO_PASS, 32>(a, s);
    case 64:
      return (int)launch_block<TWO_PASS, 64>(a, s);
    case 128:
      return (int)launch_block<TWO_PASS, 128>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The entries, each with its tuned twin's parameters (csrc/flash_variants.cu;
// flash_fp32.cu's for fp32): q, k, v of T (B, N, H, D), element strides
// (batch, seq, head) of each in `st`, a unit head-dim stride; o (B, N, H, D)
// contiguous; the LSE fp32 (B*H, N) or null; scale the q prescale d^-1/2
// log2(e); the key block block_k (K3) or block_c (K4), 32, 64 or 128; K3's
// cluster, which must be 1. Launches on `stream`; returns the cudaError_t
// of the launch (cudaErrorInvalidValue for d outside [1, 1024], another
// block or cluster).
extern "C" int pbe_flash_resident_anyd_bf16(const void* q, const void* k, const void* v, void* o,
                                            void* lse, int B, int N, int H, int D,
                                            const long long* st, float scale, int block_k,
                                            int cluster, void* stream) {
  if (cluster != 1) return (int)cudaErrorInvalidValue;
  return run_variant<bf16, false>(q, k, v, o, lse, B, N, H, D, st, scale, block_k, stream);
}

extern "C" int pbe_flash_resident_anyd_f32(const void* q, const void* k, const void* v, void* o,
                                           void* lse, int B, int N, int H, int D,
                                           const long long* st, float scale, int block_k,
                                           int cluster, void* stream) {
  if (cluster != 1) return (int)cudaErrorInvalidValue;
  return run_variant<float, false>(q, k, v, o, lse, B, N, H, D, st, scale, block_k, stream);
}

extern "C" int pbe_flash_pipelined_anyd_bf16(const void* q, const void* k, const void* v, void* o,
                                             void* lse, int B, int N, int H, int D,
                                             const long long* st, float scale, int block_c,
                                             void* stream) {
  return run_variant<bf16, true>(q, k, v, o, lse, B, N, H, D, st, scale, block_c, stream);
}

extern "C" int pbe_flash_pipelined_anyd_f32(const void* q, const void* k, const void* v, void* o,
                                            void* lse, int B, int N, int H, int D,
                                            const long long* st, float scale, int block_c,
                                            void* stream) {
  return run_variant<float, true>(q, k, v, o, lse, B, N, H, D, st, scale, block_c, stream);
}
