// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of horovod_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- _fwd_kernel  (line 67)
//   flash_dq_kernel   <- _dq_kernel   (line 168)
//   flash_dkv_kernel  <- _dkv_kernel  (line 199)
// and computes what they compute, on (batch*heads, seq, head_dim) bf16
// tensors with f32 accumulation:
//   forward  O = softmax(Q K^T * scale) V, lse = m + log(l) per query row
//   dQ       dQ_i = sum_j p_ij (dO_i . V_j - delta_i) K_j * scale
//   dK/dV    dV_j = sum_i p_ij dO_i,  dK_j = sum_i ds_ij Q_i * scale
// with p_ij = exp(Q_i . K_j * scale - lse_i) recomputed from the saved row
// statistics (no seq x seq residual) and delta_i = dO_i . O_i computed by
// the caller.
//
// Design. The TPU kernels run a sequential grid and carry accumulators in
// VMEM scratch between grid steps. Here a CTA of 4 warps owns one 64-row
// tile (queries for the forward and dQ, keys for dK/dV) and loops over the
// other side's 64-row tiles itself, keeping its accumulators in registers.
// Tiles are staged through shared memory with 16-byte loads; the products
// run on the tensor cores as mma.sync m16n8k16 (bf16 in, f32 out), and the
// f32 score tile of one product is re-packed in registers as the bf16 A
// operand of the next (P V, dS K, P^T dO, dS^T Q), so scores never touch
// shared or device memory. Each warp owns 16 rows, so the row max and row
// sum of the online softmax reduce over the 4 lanes that share a row.
// Sequence lengths that are not a multiple of 64 are handled by zero-filled
// loads, masked scores and guarded stores. Causal attention skips the key
// tiles above the diagonal (forward, dQ) and the query tiles before it
// (dK/dV), as _kv_index and _q_index do on the TPU.
//
// Bound on an H100 SXM at BERT-base shape (b*h = 96, s = 512, d = 64):
// the forward moves ~25 MB and does 6.4 GFLOP, so it is bound by memory
// bytes (~7.5 us at 3.35 TB/s); the two backward kernels do ~23 GFLOP
// together and are bound by tensor-core operations. This first version
// keeps no copy in flight while it computes (no cp.async/TMA pipeline)
// and uses mma.sync, not wgmma; it relies on several resident CTAs per SM
// to hide load latency.
//
// Instances: head dims 32, 64 and 128 (the wrapper zero-pads other head
// dims up to the next one and rounds float32 inputs to bf16). At d = 128
// the tiles take more than the 48 KB of static shared memory, so every
// kernel takes its tiles as dynamic shared memory; dQ and dK/dV read the
// resident tile's A fragments from shared memory at each use instead of
// holding them in registers, and dK/dV splits its output columns over
// blockIdx.z (64 each, the score products recomputed per half) so that its
// accumulators stay at the d = 64 count. This file's kernels are the
// mma.sync route: bf16 at head dim 32 and float32 inputs up to head dim 128;
// the wgmma kernels of flash_fwd_wgmma.cu and flash_bwd_wgmma.cu take the
// rest.
//
// Plain C interface for ctypes: every entry point launches on the given
// stream and returns the cudaError_t of the launch (or -1 for a head
// dimension without an instance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockM = 64;  // query rows of a tile (4 warps x 16 rows)
constexpr int kBlockN = 64;  // key rows of a tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_two(const bf16* lo, const bf16* hi) {
  const uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row-major) * b (16x8, col-major); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A: a0 (row g, k 2t..2t+1), a1 (row g+8, same k), a2 (row g, k 2t+8..),
//      a3 (row g+8, k 2t+8..)
//   B: b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g)
//   C: c0,c1 (row g, cols 2t, 2t+1), c2,c3 (row g+8, cols 2t, 2t+1)

// A fragment: rows [r0, r0+16), cols [k0, k0+16) of a row-major tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int r0,
                                       int k0, int g, int t) {
  const bf16* p = s + (r0 + g) * LD + k0 + 2 * t;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * LD);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * LD + 8);
}

// B fragment (k0.., n0..) of B = X^T, where the tile holds X row-major
// (rows n, cols k): two contiguous pairs.
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t& b0, uint32_t& b1,
                                        const bf16* s, int n0, int k0, int g,
                                        int t) {
  const bf16* p = s + (n0 + g) * LD + k0 + 2 * t;
  b0 = ld_pair(p);
  b1 = ld_pair(p + 8);
}

// B fragment (k0.., n0..) of B = X, where the tile holds X row-major
// (rows k, cols n): pairs gathered from two rows.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* s, int k0, int n0, int g,
                                       int t) {
  const bf16* p = s + (k0 + 2 * t) * LD + n0 + g;
  b0 = ld_two(p, p + LD);
  b1 = ld_two(p + 8 * LD, p + 9 * LD);
}

// A fragment for k-step kk from a 16 x (8*NT) f32 tile in C layout.
template <int NT>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[NT][4],
                                       int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Rows [row0, row0 + ROWS) of a (s, D) bf16 matrix into shared memory with
// pitch D + 8 (conflict-free fragment loads); rows >= s are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int s, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int LD = D + 8;
  for (int c = tid; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < s) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + col) = v;
  }
}

// A fragment of k-step kk of a resident tile: from registers where the
// kernel holds them (HOLD), else loaded from the tile in shared memory.
template <int LD, bool HOLD, int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const uint32_t (&held)[N][4],
                                       const bf16* s, int r0, int kk, int g,
                                       int t) {
  if constexpr (HOLD) {
    a[0] = held[kk][0];
    a[1] = held[kk][1];
    a[2] = held[kk][2];
    a[3] = held[kk][3];
  } else {
    load_a<LD>(a, s, r0, kk * 16, g, t);
  }
}

// Dynamic shared memory of each kernel: its bf16 tiles at pitch D + 8
// (and the dK/dV kernel's row statistics).
template <int D>
constexpr int fwd_smem_bytes() {
  return (kBlockM + 2 * kBlockN) * (D + 8) * 2;
}
template <int D>
constexpr int dq_smem_bytes() {
  return (2 * kBlockM + 2 * kBlockN) * (D + 8) * 2;
}
template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kBlockM + 2 * kBlockN) * (D + 8) * 2 + 2 * kBlockM * 4;
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// Number of key tiles a query tile starting at q0 must visit.
__device__ __forceinline__ int key_tiles(int q0, int s, int causal) {
  int n = (s + kBlockN - 1) / kBlockN;
  if (causal) n = min(n, (min(q0 + kBlockM, s) - 1) / kBlockN + 1);
  return n;
}

// ---------------------------------------------------------------------------
// Forward: grid (query tiles, b*h).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                 const bf16* __restrict__ V, bf16* __restrict__ O,
                 float* __restrict__ LSE, int s, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;        // k-steps over the head dim
  constexpr int ND = D / 8;         // n-tiles over the head dim
  constexpr int NN = kBlockN / 8;   // n-tiles over a key tile
  constexpr int KN = kBlockN / 16;  // k-steps over a key tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBlockM * LD;
  bf16* sV = sK + kBlockN * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBlockM;
  const size_t base = (size_t)blockIdx.y * s * D;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8

  load_tile<D, kBlockM>(sQ, Q + base, q0, s, tid);
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a<LD>(qa[kk], sQ, warp * 16, kk * 16, g, t);

  float acc[ND][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int n_tiles = key_tiles(q0, s, causal);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();  // the previous tile is no longer read
    load_tile<D, kBlockN>(sK, K + base, k0, s, tid);
    load_tile<D, kBlockN>(sV, V + base, k0, s, tid);
    __syncthreads();

    float sc[NN][4];
    zero(sc);
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b0, b1;
        load_bt<LD>(b0, b1, sK, j * 8, kk * 16, g, t);
        mma16816(sc[j], qa[kk], b0, b1);
      }
    }

    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        float x = sc[j][e] * scale;
        if (col >= s || (causal && col > row)) x = kNegInf;
        sc[j][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(sc[j][e] - m[e >> 1]);
        sc[j][e] = p;
        rsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l[r] = l[r] * alpha[r] + rsum[r];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t pa[4];
      c_to_a<NN>(pa, sc, kk);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        uint32_t b0, b1;
        load_b<LD>(b0, b1, sV, kk * 16, j * 8, g, t);
        mma16816(acc[j], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= s) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f;  // fully masked rows
    const float inv = 1.f / safe;
    bf16* out = O + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
    if (t == 0) LSE[(size_t)blockIdx.y * s + row] = m[r] + logf(safe);
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (query tiles, b*h); loops over key tiles.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                const bf16* __restrict__ V, const bf16* __restrict__ dO,
                const float* __restrict__ LSE, const float* __restrict__ DELTA,
                bf16* __restrict__ dQ, int s, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int NN = kBlockN / 8;
  constexpr int KN = kBlockN / 16;
  constexpr bool kHold = D <= 64;  // Q and dO fragments held in registers
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kBlockM * LD;
  bf16* sK = sdO + kBlockM * LD;
  bf16* sV = sK + kBlockN * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBlockM;
  const size_t base = (size_t)blockIdx.y * s * D;
  const size_t row_base = (size_t)blockIdx.y * s;
  const int row0 = q0 + warp * 16 + g;

  load_tile<D, kBlockM>(sQ, Q + base, q0, s, tid);
  load_tile<D, kBlockM>(sdO, dO + base, q0, s, tid);
  __syncthreads();
  uint32_t qa[kHold ? KD : 1][4], da[kHold ? KD : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      load_a<LD>(qa[kk], sQ, warp * 16, kk * 16, g, t);
      load_a<LD>(da[kk], sdO, warp * 16, kk * 16, g, t);
    }
  }
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    lse[r] = row < s ? LSE[row_base + row] : 0.f;
    delta[r] = row < s ? DELTA[row_base + row] : 0.f;
  }

  float acc[ND][4];
  zero(acc);
  const int n_tiles = key_tiles(q0, s, causal);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();
    load_tile<D, kBlockN>(sK, K + base, k0, s, tid);
    load_tile<D, kBlockN>(sV, V + base, k0, s, tid);
    __syncthreads();

    float sc[NN][4], dp[NN][4];
    zero(sc);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ad[4];
      a_frag<LD, kHold>(aq, qa, sQ, warp * 16, kk, g, t);
      a_frag<LD, kHold>(ad, da, sdO, warp * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        uint32_t b0, b1;
        load_bt<LD>(b0, b1, sK, j * 8, kk * 16, g, t);
        mma16816(sc[j], aq, b0, b1);
        load_bt<LD>(b0, b1, sV, j * 8, kk * 16, g, t);
        mma16816(dp[j], ad, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        float p = 0.f;
        if (col < s && !(causal && col > row)) {
          p = __expf(sc[j][e] * scale - lse[e >> 1]);
        }
        sc[j][e] = p * (dp[j][e] - delta[e >> 1]);  // ds
      }
    }
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t a[4];
      c_to_a<NN>(a, sc, kk);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        uint32_t b0, b1;
        load_b<LD>(b0, b1, sK, kk * 16, j * 8, g, t);
        mma16816(acc[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= s) continue;
    bf16* out = dQ + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: grid (key tiles, b*h, D / DO); loops over query tiles. A CTA owns
// the output columns [blockIdx.z * DO, + DO) of its 64 keys.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                 const bf16* __restrict__ V, const bf16* __restrict__ dO,
                 const float* __restrict__ LSE, const float* __restrict__ DELTA,
                 bf16* __restrict__ dK, bf16* __restrict__ dV, int s,
                 int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int DO = D > 64 ? 64 : D;  // output columns of a CTA
  constexpr int NO = DO / 8;
  constexpr int NM = kBlockM / 8;   // n-tiles over a query tile
  constexpr int KM = kBlockM / 16;  // k-steps over a query tile
  constexpr bool kHold = D <= 64;   // K and V fragments held in registers
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBlockN * LD;
  bf16* sQ = sV + kBlockN * LD;
  bf16* sdO = sQ + kBlockM * LD;
  float* sL = reinterpret_cast<float*>(sdO + kBlockM * LD);
  float* sD = sL + kBlockM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBlockN;
  const int c0 = blockIdx.z * DO;
  const size_t base = (size_t)blockIdx.y * s * D;
  const size_t row_base = (size_t)blockIdx.y * s;
  const int krow0 = k0 + warp * 16 + g;  // this lane's keys: krow0, krow0 + 8

  load_tile<D, kBlockN>(sK, K + base, k0, s, tid);
  load_tile<D, kBlockN>(sV, V + base, k0, s, tid);
  __syncthreads();
  uint32_t ka[kHold ? KD : 1][4], va[kHold ? KD : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      load_a<LD>(ka[kk], sK, warp * 16, kk * 16, g, t);
      load_a<LD>(va[kk], sV, warp * 16, kk * 16, g, t);
    }
  }

  float dk[NO][4], dv[NO][4];
  zero(dk);
  zero(dv);
  const int nq = (s + kBlockM - 1) / kBlockM;
  const int first = causal ? k0 / kBlockM : 0;  // first query tile to see k0
  for (int qt = first; qt < nq; ++qt) {
    const int q0 = qt * kBlockM;
    __syncthreads();
    load_tile<D, kBlockM>(sQ, Q + base, q0, s, tid);
    load_tile<D, kBlockM>(sdO, dO + base, q0, s, tid);
    if (tid < kBlockM) {
      const bool in = q0 + tid < s;
      sL[tid] = in ? LSE[row_base + q0 + tid] : 0.f;
      sD[tid] = in ? DELTA[row_base + q0 + tid] : 0.f;
    }
    __syncthreads();

    // P^T tile: rows are this warp's 16 keys, columns the 64 queries; and
    // V dO^T for dS^T, both over the full head dim.
    float st[NM][4], ds[NM][4];
    zero(st);
    zero(ds);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ak[4], av[4];
      a_frag<LD, kHold>(ak, ka, sK, warp * 16, kk, g, t);
      a_frag<LD, kHold>(av, va, sV, warp * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < NM; ++j) {
        uint32_t b0, b1;
        load_bt<LD>(b0, b1, sQ, j * 8, kk * 16, g, t);
        mma16816(st[j], ak, b0, b1);
        load_bt<LD>(b0, b1, sdO, j * 8, kk * 16, g, t);
        mma16816(ds[j], av, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < NM; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);
        const int key = krow0 + (e >> 1) * 8;
        float p = 0.f;
        if (q0 + qi < s && !(causal && key > q0 + qi)) {
          p = __expf(st[j][e] * scale - sL[qi]);
        }
        st[j][e] = p;
        ds[j][e] = p * (ds[j][e] - sD[qi]);  // dS^T = P^T * (V dO^T - delta)
      }
    }
    // dV += P^T dO and dK += dS^T Q, over this CTA's output columns.
#pragma unroll
    for (int kk = 0; kk < KM; ++kk) {
      uint32_t ap[4], as[4];
      c_to_a<NM>(ap, st, kk);
      c_to_a<NM>(as, ds, kk);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        uint32_t b0, b1;
        load_b<LD>(b0, b1, sdO, kk * 16, c0 + j * 8, g, t);
        mma16816(dv[j], ap, b0, b1);
        load_b<LD>(b0, b1, sQ, kk * 16, c0 + j * 8, g, t);
        mma16816(dk[j], as, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = krow0 + r * 8;
    if (key >= s) continue;
    bf16* outk = dK + base + (size_t)key * D + c0 + 2 * t;
    bf16* outv = dV + base + (size_t)key * D + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(outk + j * 8) = __floats2bfloat162_rn(
          dk[j][2 * r] * scale, dk[j][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(outv + j * 8) =
          __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// Allows a kernel its dynamic shared memory (above 48 KB only by opt-in).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int bh, int s, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), s, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int s,
              int causal, float scale, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_dq_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBlockM - 1) / kBlockM, bh);
  flash_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), s, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int s, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBlockN - 1) / kBlockN, bh, D > 64 ? D / 64 : 1);
  flash_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int s, int d, int causal, float scale,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_fwd<32>(q, k, v, o, lse, bh, s, causal, scale, st);
    case 64: return launch_fwd<64>(q, k, v, o, lse, bh, s, causal, scale, st);
    case 128:
      return launch_fwd<128>(q, k, v, o, lse, bh, s, causal, scale, st);
    default: return -1;
  }
}

int hvd_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, int bh, int s,
                 int d, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_dq<32>(q, k, v, dout, lse, delta, dq, bh, s, causal,
                           scale, st);
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, s, causal,
                           scale, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, s, causal,
                            scale, st);
    default: return -1;
  }
}

int hvd_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int bh, int s, int d, int causal,
                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal,
                            scale, st);
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal,
                            scale, st);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                             causal, scale, st);
    default: return -1;
  }
}

const char* hvd_flash_error_string(int code) {
  if (code == -1) return "head dimension has no kernel instance";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
