// Hopper (sm_90a) building blocks shared by the wgmma flash-attention
// kernels (flash_fwd_wgmma.cu, flash_bwd_wgmma.cu): mbarriers, TMA tensor
// loads and their tensor maps, wgmma matrix descriptors for 128-byte
// swizzled tiles, and the m64n64k16 wgmma products with bf16 or f16
// operands and f32 accumulators.
//
// Tile layout, common to every kernel that includes this header: a tile is
// 64 rows of one (b*h, s, d) tensor, held as d / 64 boxes of 64 rows x 64
// columns (128 bytes a row) with the 128-byte swizzle, as the TMA writes
// them; 8-row groups lie 1024 B apart.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;

constexpr int kBoxCols = 64;         // 16-bit columns of a TMA box
constexpr int kBoxRows = 64;         // rows of a TMA box (one tile)
constexpr int kBoxBytes = 64 * 128;  // 64 rows x 128 B
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kErrNoInstance = -1;
constexpr int kErrNoEncodeEntry = -2;
constexpr int kErrTensorMap = -3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory base rounded up to the 1024-byte swizzle atom
// (128-byte swizzling is a function of the address bits).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// An arrival; it releases this thread's earlier shared-memory writes to
// the threads that wait for the phase.
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

// The 64-row tile at `row` of one head: d / 64 boxes, one per 64 columns.
template <int D>
__device__ __forceinline__ void tma_load_tile(unsigned char* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row,
                                              int head) {
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c) {
    tma_load(dst + c * kBoxBytes, map, bar, c * kBoxCols, row, head);
  }
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

template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&d)[M][N]) {
#pragma unroll
  for (int j = 0; j < M; ++j) fence_regs(d[j]);
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
  }
}

#define HVD_WGMMA_ACC32                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define HVD_WGMMA_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64 f32, per thread 32 values) = A (64 x 16, shared, K-major)
// . B (16 x 64, shared, K-major), added to d when accumulate != 0.
// T is the operands' type: bf16 or f16.
template <typename T>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t a,
                                                   uint64_t b,
                                                   int accumulate) {
  if constexpr (std::is_same<T, f16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " HVD_WGMMA_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : HVD_WGMMA_ACC32
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    static_assert(std::is_same<T, bf16>::value, "bf16 or f16 operands");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_WGMMA_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : HVD_WGMMA_ACC32
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// d (64 x 64 f32) += A (64 x 16, registers) . B (16 x 64, shared, MN-major:
// the transpose bit is set).
template <typename T>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  if constexpr (std::is_same<T, f16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " HVD_WGMMA_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HVD_WGMMA_ACC32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    static_assert(std::is_same<T, bf16>::value, "bf16 or f16 operands");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_WGMMA_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HVD_WGMMA_ACC32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

#undef HVD_WGMMA_ACC32
#undef HVD_WGMMA_D32

// 2^x (MUFU.EX2; flushes denormals, 0 for large negative x).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to T and packed, `lo` in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, f16>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// Fragments of a 64 x 64 wgmma accumulator: warp w of the warpgroup holds
// rows 16w..16w+15; lane (g = lane / 4, t = lane % 4) holds, for each
// 8-column block j, d[4j], d[4j+1] at row g, columns 8j + 2t, 8j + 2t + 1
// and d[4j+2], d[4j+3] at row g + 8 -- the mma.sync C layout. The A
// register fragment of a k16 step is the mma.sync A layout, so the
// accumulator's columns 16kk..16kk+15 re-pack as the A fragment of k-step
// kk without moving between lanes.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack2<T>(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack2<T>(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack2<T>(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack2<T>(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// Starts acc = A B^T over a depth of D, A and B two 64-row tiles (K-major:
// a k-step is 32 bytes along the swizzled row, a box every 64 columns).
// The caller fences, commits and waits.
template <typename T, int D>
__device__ __forceinline__ void start_ss(float (&acc)[32], uint32_t a_addr,
                                         uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_m64n64k16<T>(acc, sw128_desc(a_addr + off, 16),
                          sw128_desc(b_addr + off, 16), kk);
  }
}

// Starts acc[c] += A B[:, cols of box c0 + c] for c < NC, A the 64 x 64
// register fragments (k = the B tile's 64 rows), B a 64-row tile read
// MN-major: a k-step is 16 rows of 128 B down a box.
template <typename T, int NC>
__device__ __forceinline__ void start_rs(float (&acc)[NC][32],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b_addr, int c0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      wgmma_rs_m64n64k16<T>(
          acc[c], a[kk],
          sw128_desc(b_addr + (c0 + c) * kBoxBytes + kk * 16 * 128,
                     kBoxBytes));
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
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiledFn>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// 3-D map (d, s, b*h) of a contiguous (b*h, s, d) tensor of T, in boxes of
// 64 columns x 64 rows x 1 head with the 128-byte swizzle; rows past s are
// zero-filled.
template <typename T>
int make_map(CUtensorMap* map, const void* ptr, int bh, int s, int d) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncodeEntry;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * sizeof(T),
                                 static_cast<cuuint64_t>(s) * d * sizeof(T)};
  const cuuint32_t box[3] = {kBoxCols, kBoxRows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapDataType type = std::is_same<T, f16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult res = encode(
      map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// Text of the codes the entry points return: the negative codes above, or
// a cudaError_t.
inline const char* hopper_error_string(int code) {
  switch (code) {
    case kErrNoInstance: return "head dimension has no kernel instance";
    case kErrNoEncodeEntry:
      return "cuTensorMapEncodeTiled not found in libcuda.so.1";
    case kErrTensorMap: return "cuTensorMapEncodeTiled refused the tensor";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // namespace
