// Flash attention backward for Hopper (sm_90a): dQ and dK/dV kernels with
// wgmma fed by a TMA/mbarrier ring, one producer warp and one consumer
// warpgroup per CTA.
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/flash_attention.py on
// the wgmma route (bf16 or f16 operands at head dims 64, 128 and 256):
//   flash_dq_wgmma_kernel   <- _dq_kernel   (line 168, launched at 248)
//   flash_dkv_wgmma_kernel  <- _dkv_kernel  (line 199, launched at 265)
// and computes what they compute, on (batch*heads, seq, head_dim) tensors
// with f32 accumulation and outputs in the operand type:
//   dQ_i = sum_j p_ij (dO_i . V_j - delta_i) K_j * scale
//   dV_j = sum_i p_ij dO_i,  dK_j = sum_i ds_ij Q_i * scale
// with p_ij = exp(Q_i . K_j * scale - lse_i) recomputed from the saved row
// statistics and delta_i = dO_i . O_i computed by the caller: the contract
// (and C signature) of flash_dq_kernel / flash_dkv_kernel in
// flash_attention.cu, which stay the mma.sync route. Non-causal and causal,
// any sequence length.
//
// Bound on an H100 SXM at BERT-base shape (b*h = 96, s = 512, d = 64): dQ
// does 9.7 GFLOP and dK/dV 12.9 GFLOP (~9.8 and ~13.0 us at 989 TFLOP/s)
// against ~32 and ~38 MB of traffic (~9.4 and ~11.3 us at 3.35 TB/s), so
// both sit near the ridge, on the operations side. What the design does:
//  - Each CTA owns one 64-row tile (queries for dQ, keys for dK/dV) and
//    loops over the other side's tiles with every accumulator in
//    registers: no atomics, deterministic results, the reference's
//    two-kernel split.
//  - The resident tiles (Q and dO for dQ; K and V for dK/dV) are copied
//    once by TMA; the streamed tiles (K and V; Q and dO) pass through a
//    ring of 128-byte-swizzled stages, loaded by one elected thread of a
//    producer warp while the consumers compute on earlier stages (full
//    barriers complete on the TMA byte count, empty barriers take one
//    arrival per consumer warp after the wgmma that read the stage).
//  - dQ, per key tile: S = Q K^T and dP = dO V^T (wgmma, both operands in
//    shared memory, K-major), p = 2^(S scale log2e - lse log2e), dS =
//    p (dP - delta) on the accumulator fragments, then dQ += dS K with A =
//    dS re-packed in registers as the A fragment and B = K read MN-major
//    through the transpose bit. The scale is applied once, at the store.
//  - dK/dV, per query tile: S^T = K Q^T and dP^T = V dO^T (shared memory),
//    p^T with lse broadcast along the columns, dV += p^T dO, dS^T =
//    p^T (dP^T - delta), dK += dS^T Q (A in registers, B MN-major). The
//    tile's lse (in log2 units) and delta go into the stage beside Q and
//    dO: every lane of the producer warp stores two rows of each and
//    arrives on the stage's full barrier.
//  - Within the warpgroup the loop is software-pipelined as in the
//    forward: the score products of tile k + 1 and the accumulating
//    products of tile k go to the tensor cores back to back, so the
//    elementwise work of tile k + 1 overlaps the latter. Every wgmma issue
//    site is unconditional (the last tile is peeled through a compile-time
//    flag) and the warp index is warp-uniform, so ptxas keeps them
//    asynchronous.
//  - Accumulators: 64 f32 registers a thread per 64 output columns. At
//    d = 256, dQ splits its output columns in two halves over blockIdx.z;
//    dK/dV keeps 64 columns of each output per CTA at every d > 64
//    (blockIdx.z picks them). The score products are recomputed per part.
//  - Ragged sequences: the tensor maps are 3-D (d, s, b*h), so rows past s
//    are zero-filled by TMA. A key past s has a zero K and V row, so its dS
//    (nonzero) meets a zero K row in dQ += dS K; a query past s has a zero
//    dO row and p = 0 (its lse is taken as +1e30). Neither needs a mask;
//    rows past s are not stored.
//  - Causal: dQ stops at the diagonal key tile and dK/dV starts at the
//    diagonal query tile; only that tile is masked.
//
// Plain C interface for ctypes: the entry points (bf16; _f16 for f16)
// build the tensor maps (cuTensorMapEncodeTiled from libcuda.so.1), launch
// on the given stream and return the cudaError_t of the launch, or a
// negative code (hvd_flash_bwd_wgmma_error_string).

#include "hopper.cuh"

namespace {

constexpr int kBlock = 64;          // rows of a tile, either side
constexpr int kThreads = 128 + 32;  // a consumer warpgroup + a producer warp
constexpr float kNegInf = -1e30f;
constexpr float kPosHuge = 1e30f;   // lse (log2 units) of a query past s

// dQ: Q and dO resident, K and V streamed.
template <int D>
struct DqConfig {
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kSplit = D == 256 ? 2 : 1;     // over blockIdx.z
  static constexpr int kOutBoxes = kBoxes / kSplit;   // dQ columns / 64
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, V
  static constexpr int kResBytes = 2 * kTileBytes;    // Q, dO
  static constexpr int kBarrierOffset = kResBytes + kStages * kStageBytes;
  static constexpr int kSmemBytes = kBarrierOffset + 256 + 1024;
};

// dK/dV: K and V resident, Q, dO and the row statistics streamed; 64
// output columns of dK and dV per CTA.
template <int D>
struct DkvConfig {
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kSplit = kBoxes;  // over blockIdx.z
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;  // Q, dO
  static constexpr int kResBytes = 2 * kTileBytes;    // K, V
  static constexpr int kStatsOffset = kResBytes + kStages * kStageBytes;
  // per stage: lse * log2(e) and delta of the tile's 64 queries
  static constexpr int kBarrierOffset =
      kStatsOffset + kStages * 2 * kBlock * 4;
  static constexpr int kSmemBytes = kBarrierOffset + 256 + 1024;
};

template <typename T, int NC>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[NC][32],
                                           int r, float mult) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + c * kBoxCols + j * 8) =
          pack2<T>(acc[c][4 * j + 2 * r] * mult,
                   acc[c][4 * j + 2 * r + 1] * mult);
    }
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
}

// ---------------------------------------------------------------------------
// dQ: grid (query tiles, b*h, kSplit); loops over key tiles.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_wgmma_kernel(__grid_constant__ const CUtensorMap tmap_q,
                      __grid_constant__ const CUtensorMap tmap_k,
                      __grid_constant__ const CUtensorMap tmap_v,
                      __grid_constant__ const CUtensorMap tmap_do,
                      const float* __restrict__ LSE,
                      const float* __restrict__ DELTA, T* __restrict__ dQ,
                      int s, int causal, float scale) {
  using C = DqConfig<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sdO = smem + C::kTileBytes;
  unsigned char* sKV = smem + C::kResBytes;  // stage st: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarrierOffset);
  uint64_t* empty = full + C::kStages;
  uint64_t* res_full = empty + C::kStages;

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // warp-uniform
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBlock;
  const int cbox = blockIdx.z * C::kOutBoxes;  // first output column box
  int n_tiles = (s + kBlock - 1) / kBlock;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBlock, s) - 1) / kBlock + 1);

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4);  // one arrival per consumer warp
    }
    mbar_init(res_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: one thread starts every copy.
    if (lane == 0) {
      mbar_expect_tx(res_full, C::kResBytes);
      tma_load_tile<D>(sQ, &tmap_q, res_full, q0, head);
      tma_load_tile<D>(sdO, &tmap_do, res_full, q0, head);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % C::kStages;
        mbar_wait(&empty[st], ((kt / C::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], C::kStageBytes);
        unsigned char* sK = sKV + st * C::kStageBytes;
        tma_load_tile<D>(sK, &tmap_k, &full[st], kt * kBlock, head);
        tma_load_tile<D>(sK + C::kTileBytes, &tmap_v, &full[st], kt * kBlock,
                         head);
      }
    }
    return;
  }

  // Consumers: this lane's rows are row0 and row0 + 8.
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;
  const float scale_log2 = scale * kLog2e;
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const size_t at = static_cast<size_t>(head) * s + row;
    lse2[r] = row < s ? LSE[at] * kLog2e : 0.f;
    delta[r] = row < s ? DELTA[at] : 0.f;
  }
  const uint32_t q_addr = smem_u32(sQ), do_addr = smem_u32(sdO);

  float dq[C::kOutBoxes][32];
  zero(dq);
  float sc[32], dp[32];
  uint32_t da[4][4] = {};
  mbar_wait(res_full, 0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  start_ss<T, D>(sc, q_addr, smem_u32(sKV));
  start_ss<T, D>(dp, do_addr, smem_u32(sKV + C::kTileBytes));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  auto tile = [&](int kt, auto next_tag) {
    constexpr bool kNext = decltype(next_tag)::value;
    const int st = kt % C::kStages;
    const int k0 = kt * kBlock;
    if (causal && k0 + kBlock - 1 > q0) {  // the diagonal tile
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        if (col > row0 + ((i >> 1) & 1) * 8) sc[i] = kNegInf;
      }
    }
    // dS = p (dP - delta), in place of S.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ex2(fmaf(sc[i], scale_log2, -lse2[r])) * (dp[i] - delta[r]);
    }
    // dQ += dS K of tile kt - 1 has completed: its stage and da are free.
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(da);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % C::kStages]);
    pack_a<T>(da, sc);
    const int st_next = (kt + 1) % C::kStages;
    if constexpr (kNext) {
      mbar_wait(&full[st_next], ((kt + 1) / C::kStages) & 1);
    }
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
    if constexpr (kNext) {
      unsigned char* next = sKV + st_next * C::kStageBytes;
      start_ss<T, D>(sc, q_addr, smem_u32(next));
      start_ss<T, D>(dp, do_addr, smem_u32(next + C::kTileBytes));
      wgmma_commit();
    }
    start_rs<T, C::kOutBoxes>(dq, da, smem_u32(sKV + st * C::kStageBytes),
                              cbox);
    wgmma_commit();
    if constexpr (kNext) {
      wgmma_wait<1>();  // the score products of tile kt + 1
      fence_regs(sc);
      fence_regs(dp);
    }
  };
  for (int kt = 0; kt + 1 < n_tiles; ++kt) tile(kt, std::true_type{});
  tile(n_tiles - 1, std::false_type{});
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(da);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= s) continue;
    store_rows<T>(dQ + (static_cast<size_t>(head) * s + row) * D +
                      cbox * kBoxCols + 2 * t,
                  dq, r, scale);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: grid (key tiles, b*h, kSplit); loops over query tiles. A CTA
// computes the output columns [64 blockIdx.z, + 64) of its 64 keys.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_wgmma_kernel(__grid_constant__ const CUtensorMap tmap_q,
                       __grid_constant__ const CUtensorMap tmap_k,
                       __grid_constant__ const CUtensorMap tmap_v,
                       __grid_constant__ const CUtensorMap tmap_do,
                       const float* __restrict__ LSE,
                       const float* __restrict__ DELTA, T* __restrict__ dK,
                       T* __restrict__ dV, int s, int causal, float scale) {
  using C = DkvConfig<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + C::kTileBytes;
  unsigned char* sQdO = smem + C::kResBytes;  // stage st: Q, then dO
  float* stats = reinterpret_cast<float*>(smem + C::kStatsOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarrierOffset);
  uint64_t* empty = full + C::kStages;
  uint64_t* res_full = empty + C::kStages;

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // warp-uniform
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * kBlock;
  const int cbox = blockIdx.z;  // output column box
  const int n_q = (s + kBlock - 1) / kBlock;
  const int first = causal ? k0 / kBlock : 0;  // first query tile to see k0
  const int n_tiles = n_q - first;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < C::kStages; ++st) {
      // the producer warp's 32 lanes: the row statistics, and the TMA's
      // expect_tx by lane 0
      mbar_init(&full[st], 32);
      mbar_init(&empty[st], 4);  // one arrival per consumer warp
    }
    mbar_init(res_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // Producer warp: lane 0 starts every copy; every lane stores two rows
    // of the tile's row statistics into the stage.
    if (lane == 0) {
      mbar_expect_tx(res_full, C::kResBytes);
      tma_load_tile<D>(sK, &tmap_k, res_full, k0, head);
      tma_load_tile<D>(sV, &tmap_v, res_full, k0, head);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % C::kStages;
      const int q0 = (first + i) * kBlock;
      mbar_wait(&empty[st], ((i / C::kStages) & 1) ^ 1);
      float* lse2 = stats + st * 2 * kBlock;
#pragma unroll
      for (int r = lane; r < kBlock; r += 32) {
        const int q = q0 + r;
        const size_t at = static_cast<size_t>(head) * s + q;
        lse2[r] = q < s ? LSE[at] * kLog2e : kPosHuge;
        lse2[kBlock + r] = q < s ? DELTA[at] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[st], C::kStageBytes);
        unsigned char* sQ = sQdO + st * C::kStageBytes;
        tma_load_tile<D>(sQ, &tmap_q, &full[st], q0, head);
        tma_load_tile<D>(sQ + C::kTileBytes, &tmap_do, &full[st], q0, head);
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // Consumers: this lane's keys are key0 and key0 + 8; its queries within
  // a tile are the columns 8j + 2t and 8j + 2t + 1.
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g;
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);

  float dk[1][32], dv[1][32];
  zero(dk);
  zero(dv);
  float sc[32], dp[32];  // S^T and dP^T of a query tile
  uint32_t pa[4][4] = {}, sa[4][4] = {};
  mbar_wait(res_full, 0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  start_ss<T, D>(sc, k_addr, smem_u32(sQdO));
  start_ss<T, D>(dp, v_addr, smem_u32(sQdO + C::kTileBytes));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  auto tile = [&](int i, auto next_tag) {
    constexpr bool kNext = decltype(next_tag)::value;
    const int st = i % C::kStages;
    const float* lse2 = stats + st * 2 * kBlock;
    if (causal && i == 0) {  // the diagonal tile: query k0 + col, key k0 + row
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = (e >> 2) * 8 + 2 * t + (e & 1);
        if (warp * 16 + g + ((e >> 1) & 1) * 8 > col) sc[e] = kNegInf;
      }
    }
    // p^T into sc, dS^T = p^T (dP^T - delta) into dp.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(lse2 + j * 8 + 2 * t);
      const float2 dl =
          *reinterpret_cast<const float2*>(lse2 + kBlock + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        const float p = ex2(fmaf(sc[x], scale_log2, (e & 1) ? -l2.y : -l2.x));
        sc[x] = p;
        dp[x] = p * (dp[x] - ((e & 1) ? dl.y : dl.x));
      }
    }
    // The products of tile i - 1 have completed: its stage, pa and sa are
    // free.
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(sa);
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % C::kStages]);
    pack_a<T>(pa, sc);
    pack_a<T>(sa, dp);
    const int st_next = (i + 1) % C::kStages;
    if constexpr (kNext) {
      mbar_wait(&full[st_next], ((i + 1) / C::kStages) & 1);
    }
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(sa);
    wgmma_fence();
    if constexpr (kNext) {
      unsigned char* next = sQdO + st_next * C::kStageBytes;
      start_ss<T, D>(sc, k_addr, smem_u32(next));
      start_ss<T, D>(dp, v_addr, smem_u32(next + C::kTileBytes));
      wgmma_commit();
    }
    const uint32_t q_addr = smem_u32(sQdO + st * C::kStageBytes);
    start_rs<T, 1>(dv, pa, q_addr + C::kTileBytes, cbox);  // p^T dO
    start_rs<T, 1>(dk, sa, q_addr, cbox);                  // dS^T Q
    wgmma_commit();
    if constexpr (kNext) {
      wgmma_wait<1>();  // the score products of tile i + 1
      fence_regs(sc);
      fence_regs(dp);
    }
  };
  for (int i = 0; i + 1 < n_tiles; ++i) tile(i, std::true_type{});
  tile(n_tiles - 1, std::false_type{});
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  fence_regs(pa);
  fence_regs(sa);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    if (key >= s) continue;
    const size_t at = (static_cast<size_t>(head) * s + key) * D +
                      cbox * kBoxCols + 2 * t;
    store_rows<T>(dK + at, dk, r, scale);
    store_rows<T>(dV + at, dv, r, 1.f);
  }
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// The four tensor maps of q, k, v and dO.
template <typename T, int D>
int make_maps(CUtensorMap (&maps)[4], const void* const (&ptrs)[4], int bh,
              int s) {
  for (int i = 0; i < 4; ++i) {
    const int err = make_map<T>(&maps[i], ptrs[i], bh, s, D);
    if (err != 0) return err;
  }
  return 0;
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int s,
              int causal, float scale, cudaStream_t stream) {
  using C = DqConfig<D>;
  CUtensorMap m[4];
  int err = make_maps<T, D>(m, {q, k, v, dout}, bh, s);
  if (err == 0) err = prepare(flash_dq_wgmma_kernel<T, D>, C::kSmemBytes);
  if (err != 0) return err;
  const dim3 grid((s + kBlock - 1) / kBlock, bh, C::kSplit);
  flash_dq_wgmma_kernel<T, D><<<grid, kThreads, C::kSmemBytes, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), s, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int s, int causal, float scale, cudaStream_t stream) {
  using C = DkvConfig<D>;
  CUtensorMap m[4];
  int err = make_maps<T, D>(m, {q, k, v, dout}, bh, s);
  if (err == 0) err = prepare(flash_dkv_wgmma_kernel<T, D>, C::kSmemBytes);
  if (err != 0) return err;
  const dim3 grid((s + kBlock - 1) / kBlock, bh, C::kSplit);
  flash_dkv_wgmma_kernel<T, D><<<grid, kThreads, C::kSmemBytes, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), s, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, int bh, int s,
                int d, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, bh, s, causal,
                              scale, st);
    case 128:
      return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, bh, s, causal,
                               scale, st);
    case 256:
      return launch_dq<T, 256>(q, k, v, dout, lse, delta, dq, bh, s, causal,
                               scale, st);
    default: return kErrNoInstance;
  }
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int bh, int s, int d, int causal,
                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                               causal, scale, st);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                                causal, scale, st);
    case 256:
      return launch_dkv<T, 256>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                                causal, scale, st);
    default: return kErrNoInstance;
  }
}

}  // namespace

extern "C" {

int hvd_flash_dq_wgmma(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int bh, int s, int d, int causal, float scale,
                       void* stream) {
  return dispatch_dq<bf16>(q, k, v, dout, lse, delta, dq, bh, s, d, causal,
                           scale, stream);
}

int hvd_flash_dq_wgmma_f16(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int s, int d,
                           int causal, float scale, void* stream) {
  return dispatch_dq<f16>(q, k, v, dout, lse, delta, dq, bh, s, d, causal,
                          scale, stream);
}

int hvd_flash_dkv_wgmma(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int bh, int s, int d, int causal,
                        float scale, void* stream) {
  return dispatch_dkv<bf16>(q, k, v, dout, lse, delta, dk, dv, bh, s, d,
                            causal, scale, stream);
}

int hvd_flash_dkv_wgmma_f16(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh,
                            int s, int d, int causal, float scale,
                            void* stream) {
  return dispatch_dkv<f16>(q, k, v, dout, lse, delta, dk, dv, bh, s, d,
                           causal, scale, stream);
}

const char* hvd_flash_bwd_wgmma_error_string(int code) {
  return hopper_error_string(code);
}

}  // extern "C"
