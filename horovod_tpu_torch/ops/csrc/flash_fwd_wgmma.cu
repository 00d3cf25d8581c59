// Flash attention forward for Hopper (sm_90a): wgmma fed by a TMA/mbarrier
// ring, with one producer warp and one consumer warpgroup per CTA.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/flash_attention.py
// _fwd_kernel (line 67) on the bf16 route at head dims 64 and 128, on
// (batch*heads, seq, head_dim) bf16 tensors with f32 accumulation:
//   O = softmax(Q K^T * scale) V,  lse = m + log(l) per query row,
// the same contract as flash_fwd_kernel in flash_attention.cu (which stays
// the route for float32 inputs and head dim 32): non-causal and causal,
// any sequence length, keys past the end masked to -1e30.
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
//    with A = P in registers (the S fragment rounded to bf16 and re-packed
//    as the A fragment, never stored) and B = V from shared memory,
//    MN-major through the transpose bit; at d = 128 it is two n64 products,
//    one per 64-column box.
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
// Plain C interface for ctypes: the entry point builds the three tensor
// maps (cuTensorMapEncodeTiled, looked up in libcuda.so.1 at first
// use), launches on the given stream, and returns the cudaError_t of the
// launch, or a negative code (hvd_flash_fwd_wgmma_error_string).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockM = 64;                   // query rows per CTA
constexpr int kBlockN = 64;                   // keys per stage
constexpr int kThreads = 128 + 32;  // a consumer warpgroup + a producer warp
constexpr int kBoxCols = 64;                  // bf16 columns of a TMA box
constexpr int kBoxBytes = 64 * 128;           // 64 rows x 128 B
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kErrNoInstance = -1;
constexpr int kErrNoEncodeEntry = -2;
constexpr int kErrTensorMap = -3;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (col, row, head) of a 3-D tensor map into shared memory;
// its bytes count against the barrier's expected transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(head)
      : "memory");
}

// Matrix descriptor of a tile in 128-byte-swizzled shared memory whose
// 8-row groups lie 1024 B apart (SBO). `lbo` is the stride between 64-column
// atoms of an MN-major operand (unused by K-major ones). Layout type 1 is
// the 128-byte swizzle, matching the tensor maps' CU_TENSOR_MAP_SWIZZLE_128B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed wgmma groups are
// pending (the older ones have completed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of registers that an
// asynchronous wgmma reads or writes across its start and wait, and from
// reusing them before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

// d (64 x 64 f32, per thread 32 values) = A (64 x 16, shared, K-major)
// . B (16 x 64, shared, K-major), added to d when accumulate != 0.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t a,
                                                   uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) . B (16 x 64, shared,
// MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x (MUFU.EX2; flushes denormals, 0 for large negative x).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragments of a 64 x N wgmma accumulator: warp w of the warpgroup holds
// rows 16w..16w+15; lane (g = lane / 4, t = lane % 4) holds, for each
// 8-column block j, d[4j], d[4j+1] at row g, columns 8j + 2t, 8j + 2t + 1
// and d[4j+2], d[4j+3] at row g + 8 -- the mma.sync C layout. The A
// register fragment of a k16 step is the mma.sync A layout, so the S
// fragment of keys 16kk..16kk+15 re-packs as A without moving between
// lanes.

// S = Q K^T of one warpgroup's 64 rows against a 64-key tile, over d / 16
// k-steps: within a 64-column box a k-step is 32 bytes along the swizzled
// row. Starts the wgmmas; the caller fences, commits and waits.
template <int D>
__device__ __forceinline__ void start_scores(float (&sc)[32], uint32_t q_addr,
                                             uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_m64n64k16(sc, sw128_desc(q_addr + off, 16),
                       sw128_desc(k_addr + off, 16), kk);
  }
}

// ---------------------------------------------------------------------------
// Grid (query tiles of kBlockM, b*h); kThreads threads: the consumer
// warpgroups first, then the producer warp.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tmap_q,
                       __grid_constant__ const CUtensorMap tmap_k,
                       __grid_constant__ const CUtensorMap tmap_v,
                       bf16* __restrict__ O, float* __restrict__ LSE, int s,
                       int causal, float scale) {
  using C = Config<D>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzling is a function of the address bits: align the tiles
  // to the 1024-byte atom.
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: one thread starts every copy.
    if (lane == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < C::kBoxes; ++c) {
        tma_load(sQ + c * kBoxBytes, &tmap_q, q_full, c * kBoxCols, q0, head);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % C::kStages;
        // The first round finds every stage empty (parity 1 passes at once).
        mbar_wait(&empty[st], ((kt / C::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], C::kStageBytes);
        unsigned char* sK = sKV + st * C::kStageBytes;
        for (int c = 0; c < C::kBoxes; ++c) {
          tma_load(sK + c * kBoxBytes, &tmap_k, &full[st], c * kBoxCols,
                   kt * kBlockN, head);
          tma_load(sK + C::kTileBytes + c * kBoxBytes, &tmap_v, &full[st],
                   c * kBoxCols, kt * kBlockN, head);
        }
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
  start_scores<D>(sc, q_addr, smem_u32(sKV));
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
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) fence_regs(acc[c]);
    fence_regs(pa);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % C::kStages]);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
    // P as the bf16 A fragments of the four k16 steps over the keys.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    const int st_next = (kt + 1) % C::kStages;
    if constexpr (kNext) {
      mbar_wait(&full[st_next], ((kt + 1) / C::kStages) & 1);
    }
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) fence_regs(acc[c]);
    fence_regs(pa);
    wgmma_fence();
    if constexpr (kNext) {
      start_scores<D>(sc, q_addr, smem_u32(sKV + st_next * C::kStageBytes));
      wgmma_commit();
    }
    // O += P V: a k-step is 16 keys, 16 rows of 128 B down the V box.
    const uint32_t v_addr =
        smem_u32(sKV + st * C::kStageBytes + C::kTileBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c) {
        wgmma_rs_m64n64k16(
            acc[c], pa[kk],
            sw128_desc(v_addr + c * kBoxBytes + kk * 16 * 128, kBoxBytes));
      }
    }
    wgmma_commit();
    if constexpr (kNext) {
      wgmma_wait<1>();  // S of tile kt + 1; P V of tile kt may still run
      fence_regs(sc);
    }
  };
  for (int kt = 0; kt + 1 < n_tiles; ++kt) tile(kt, std::true_type{});
  tile(n_tiles - 1, std::false_type{});
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < C::kBoxes; ++c) fence_regs(acc[c]);
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
    bf16* out = O + (static_cast<size_t>(head) * s + row) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out + c * kBoxCols + j * 8) =
            __floats2bfloat162_rn(acc[c][4 * j + 2 * r] * inv,
                                  acc[c][4 * j + 2 * r + 1] * inv);
      }
    }
    if (t == 0) {
      LSE[static_cast<size_t>(head) * s + row] =
          m[r] * kLn2 + logf(safe);  // m is in log2 units
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda.so.1, not in the runtime: looked
// up once in the copy the CUDA runtime has already loaded, so the library
// links against nothing but the runtime.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiledFn>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// 3-D map (d, s, b*h) of a contiguous (b*h, s, d) bf16 tensor, in boxes of
// 64 columns x 64 rows x 1 head with the 128-byte swizzle; rows past s are
// zero-filled.
int make_map(CUtensorMap* map, const void* ptr, int bh, int s, int d) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncodeEntry;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * sizeof(bf16),
                                 static_cast<cuuint64_t>(s) * d * sizeof(bf16)};
  const cuuint32_t box[3] = {kBoxCols, kBlockN, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int s, int causal, float scale, cudaStream_t stream) {
  static_assert(kBlockM == kBlockN, "Q and K/V share the 64-row box");
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, bh, s, D);
  if (err == 0) err = make_map(&mk, k, bh, s, D);
  if (err == 0) err = make_map(&mv, v, bh, s, D);
  if (err != 0) return err;
  constexpr int smem = Config<D>::kSmemBytes;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((s + kBlockM - 1) / kBlockM, bh);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), s, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hvd_flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int s, int d, int causal,
                        float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(q, k, v, o, lse, bh, s, causal, scale, st);
    case 128: return launch<128>(q, k, v, o, lse, bh, s, causal, scale, st);
    default: return kErrNoInstance;
  }
}

const char* hvd_flash_fwd_wgmma_error_string(int code) {
  switch (code) {
    case kErrNoInstance: return "head dimension has no kernel instance";
    case kErrNoEncodeEntry:
      return "cuTensorMapEncodeTiled not found in libcuda.so.1";
    case kErrTensorMap: return "cuTensorMapEncodeTiled refused the tensor";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
