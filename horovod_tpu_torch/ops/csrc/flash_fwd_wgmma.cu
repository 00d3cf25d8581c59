// Flash attention forward for Hopper (sm_90a): wgmma fed by a TMA/mbarrier
// ring, with one producer warp and one consumer warpgroup per CTA.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/flash_attention.py
// _fwd_kernel (line 67) on the wgmma route: bf16 or f16 operands at head
// dims 64, 128 and 256, on (batch*heads, seq, head_dim) tensors with f32
// accumulation:
//   O = softmax(Q K^T * scale) V,  lse = m + log(l) per query row,
// the same contract as flash_fwd_kernel in flash_attention.cu (which stays
// the route for float32 inputs up to head dim 128 and for head dim 32):
// non-causal and causal, any sequence length, keys past the end masked to
// -1e30. f16 inputs are computed in f16 (the .f16 form of wgmma, P packed
// as f16), never rounded to bf16.
//
// Bound on an H100 SXM at BERT-base shape (b*h = 96, s = 512, d = 64): the
// forward moves ~25 MB (~7.5 us at 3.35 TB/s) and does 6.4 GFLOP (~6.5 us
// at 989 TFLOP/s), so bytes and tensor-core operations bound it about
// equally. What the design does about each:
//  - Operands never pass through registers on their way to the tensor
//    cores: TMA copies Q once and the K/V tiles of a ring of stages into
//    128-byte-swizzled shared memory, and wgmma reads them there through
//    matrix descriptors. One elected thread of a producer warp starts every
//    copy; copies of the next stages are in flight while the consumers
//    compute on the current one.
//  - The consumer warpgroup owns 64 query rows. S = Q K^T is wgmma
//    m64n64k16 with A (Q) and B (K, K-major) in shared memory, d/16
//    k-steps. The online softmax runs on the f32 accumulator fragments
//    (row max and sum over the 4 lanes that share a row). O += P V is wgmma
//    with A = P in registers (the S fragment rounded to the operand type
//    and re-packed as the A fragment, never stored) and B = V from shared
//    memory, MN-major through the transpose bit; one n64 product per
//    64-column box of V (d / 64 of them; at d = 256 the O accumulator is
//    128 f32 registers a thread).
//  - Within the warpgroup the loop is software-pipelined: S of tile kt + 1
//    and P V of tile kt go to the tensor cores back to back, and the
//    softmax of tile kt + 1 overlaps the latter. Every wgmma call site is
//    unconditional and the warp index is made warp-uniform, so ptxas keeps
//    them asynchronous (a wgmma under a divergent branch, or an
//    accumulator read it cannot prove complete, serializes every wgmma of
//    the kernel).
//  - Stages: full barriers (the producer's expect_tx, completed by the TMA
//    byte count) and empty barriers (one arrival per consumer warp, after
//    the wgmma that read the stage has completed).
//  - One consumer warpgroup per CTA (64 query rows): at BERT-base shape that
//    is 768 CTAs, three resident per SM (109 registers, 57 KB of shared
//    memory each), about two full waves; 128-row CTAs of two warpgroups
//    left the second of 1.45 waves mostly idle.
//  - Ragged sequences: the tensor maps are 3-D (d, s, b*h), so a tile that
//    runs past s is zero-filled by TMA instead of reading the next head's
//    rows; those keys are masked and those rows are not stored.
//  - Causal: the key loop stops at the diagonal tile, which masks inside.
//
// Plain C interface for ctypes: the entry points (hvd_flash_fwd_wgmma for
// bf16, hvd_flash_fwd_wgmma_f16 for f16) build the three tensor maps
// (cuTensorMapEncodeTiled, looked up in libcuda.so.1 at first use), launch
// on the given stream, and return the cudaError_t of the launch, or a
// negative code (hvd_flash_fwd_wgmma_error_string).

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 64;         // query rows per CTA
constexpr int kBlockN = 64;         // keys per stage
constexpr int kThreads = 128 + 32;  // a consumer warpgroup + a producer warp
constexpr float kNegInf = -1e30f;

template <int D>
struct Config {
  static constexpr int kBoxes = D / kBoxCols;       // 64-column boxes per row
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kQBytes = kTileBytes;
  static constexpr int kBarrierOffset = kQBytes + kStages * kStageBytes;
  // + barriers, + slack to align the base to the 1024-byte swizzle atom
  static constexpr int kSmemBytes = kBarrierOffset + 256 + 1024;
};

// ---------------------------------------------------------------------------
// Grid (query tiles of kBlockM, b*h); kThreads threads: the consumer
// warpgroup first, then the producer warp. T is bf16 or f16.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tmap_q,
                       __grid_constant__ const CUtensorMap tmap_k,
                       __grid_constant__ const CUtensorMap tmap_v,
                       T* __restrict__ O, float* __restrict__ LSE, int s,
                       int causal, float scale) {
  using C = Config<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sKV = smem + C::kQBytes;  // stage st: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarrierOffset);
  uint64_t* empty = full + C::kStages;
  uint64_t* q_full = empty + C::kStages;

  const int tid = threadIdx.x, lane = tid & 31;
  // The warp index through a shuffle: the compiler then knows it is
  // uniform across the warp, so the role branch below is not a divergent
  // path (a wgmma in a divergent path is serialized).
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  int n_tiles = (s + kBlockN - 1) / kBlockN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBlockM, s) - 1) / kBlockN + 1);

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4);  // one arrival per consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: one thread starts every copy.
    if (lane == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      tma_load_tile<D>(sQ, &tmap_q, q_full, q0, head);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % C::kStages;
        // The first round finds every stage empty (parity 1 passes at once).
        mbar_wait(&empty[st], ((kt / C::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], C::kStageBytes);
        unsigned char* sK = sKV + st * C::kStageBytes;
        tma_load_tile<D>(sK, &tmap_k, &full[st], kt * kBlockN, head);
        tma_load_tile<D>(sK + C::kTileBytes, &tmap_v, &full[st],
                         kt * kBlockN, head);
      }
    }
    return;
  }

  // Consumers.
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const uint32_t q_addr = smem_u32(sQ);
  const float scale_log2 = scale * kLog2e;

  float acc[C::kBoxes][32];
#pragma unroll
  for (int c = 0; c < C::kBoxes; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  // The loop is software-pipelined within the warpgroup: the tensor cores
  // run S of tile kt + 1 and then P V of tile kt while the softmax of tile
  // kt + 1 waits only for the former, so it overlaps the latter.
  float sc[32];
  uint32_t pa[4][4] = {};
  mbar_wait(q_full, 0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  start_ss<T, D>(sc, q_addr, smem_u32(sKV));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  // One tile; with kNext it also starts S of tile kt + 1. The wgmma sites
  // stay unconditional, so that the compiler can track which wgmma group
  // each wait leaves pending (a wgmma under a runtime branch is
  // serialized).
  auto tile = [&](int kt, auto next_tag) {
    constexpr bool kNext = decltype(next_tag)::value;
    const int st = kt % C::kStages;
    // Online softmax on the fragments, in log2 units: m is the running
    // row max of s * scale * log2(e) and p = 2^(s * scale_log2 - m), one
    // FFMA and one ex2 per score. Only a ragged tile or one that reaches
    // past the tile's first row under the causal mask is masked.
    const int k0 = kt * kBlockN;
    if (k0 + kBlockN > s || (causal && k0 + kBlockN - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        const int row = row0 + ((i >> 1) & 1) * 8;
        if (col >= s || (causal && col > row)) sc[i] = kNegInf;
      }
    }
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r] * scale_log2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];  // this lane's share of the row sum
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = ex2(fmaf(sc[i], scale_log2, -m[r]));
      sc[i] = p;
      l[r] += p;
    }
    // P V of tile kt - 1 has completed: its stage, acc and pa are free.
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % C::kStages]);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
    // P as the A fragments of the four k16 steps over the keys.
    pack_a<T>(pa, sc);
    const int st_next = (kt + 1) % C::kStages;
    if constexpr (kNext) {
      mbar_wait(&full[st_next], ((kt + 1) / C::kStages) & 1);
    }
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    if constexpr (kNext) {
      start_ss<T, D>(sc, q_addr, smem_u32(sKV + st_next * C::kStageBytes));
      wgmma_commit();
    }
    // O += P V.
    start_rs<T, C::kBoxes>(
        acc, pa, smem_u32(sKV + st * C::kStageBytes + C::kTileBytes), 0);
    wgmma_commit();
    if constexpr (kNext) {
      wgmma_wait<1>();  // S of tile kt + 1; P V of tile kt may still run
      fence_regs(sc);
    }
  };
  for (int kt = 0; kt + 1 < n_tiles; ++kt) tile(kt, std::true_type{});
  tile(n_tiles - 1, std::false_type{});
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(pa);
  // (The last stage needs no release: nothing is loaded after it.)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // The row sum over the 4 lanes that share the row.
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= s) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f;  // fully masked rows
    const float inv = 1.f / safe;
    T* out = O + (static_cast<size_t>(head) * s + row) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(out + c * kBoxCols + j * 8) =
            pack2<T>(acc[c][4 * j + 2 * r] * inv,
                     acc[c][4 * j + 2 * r + 1] * inv);
      }
    }
    if (t == 0) {
      LSE[static_cast<size_t>(head) * s + row] =
          m[r] * kLn2 + logf(safe);  // m is in log2 units
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int s, int causal, float scale, cudaStream_t stream) {
  static_assert(kBlockM == kBoxRows && kBlockN == kBoxRows,
                "Q and K/V tiles are one 64-row box");
  CUtensorMap mq, mk, mv;
  int err = make_map<T>(&mq, q, bh, s, D);
  if (err == 0) err = make_map<T>(&mk, k, bh, s, D);
  if (err == 0) err = make_map<T>(&mv, v, bh, s, D);
  if (err != 0) return err;
  constexpr int smem = Config<D>::kSmemBytes;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((s + kBlockM - 1) / kBlockM, bh);
  flash_fwd_wgmma_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<T*>(o), static_cast<float*>(lse), s, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int bh, int s, int d, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, s, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, s, causal, scale, st);
    case 256: return launch<T, 256>(q, k, v, o, lse, bh, s, causal, scale, st);
    default: return kErrNoInstance;
  }
}

}  // namespace

extern "C" {

int hvd_flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int s, int d, int causal,
                        float scale, void* stream) {
  return dispatch<bf16>(q, k, v, o, lse, bh, s, d, causal, scale, stream);
}

int hvd_flash_fwd_wgmma_f16(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int s, int d,
                            int causal, float scale, void* stream) {
  return dispatch<f16>(q, k, v, o, lse, bh, s, d, causal, scale, stream);
}

const char* hvd_flash_fwd_wgmma_error_string(int code) {
  return hopper_error_string(code);
}

}  // extern "C"
