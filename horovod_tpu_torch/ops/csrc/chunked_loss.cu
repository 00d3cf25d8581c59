// LM-head softmax cross-entropy for Hopper (sm_90a): forward, dx and dW/db.
//
// Replaces the three Pallas TPU kernels of horovod_tpu/ops/chunked_loss.py:
//   ce_fwd_kernel + ce_fwd_combine_kernel <- _ce_fwd_kernel (line 181)
//   ce_dx_kernel                          <- _ce_dx_kernel  (line 233)
//   ce_dw_kernel                          <- _ce_dw_kernel  (line 254)
// on x (n, h) bf16, the head W (v, h) bf16 -- torch's lm_head.weight layout,
// the transpose of the JAX kernel (h, v) -- a float32 bias b (v) and int64
// labels (n), with float32 accumulation:
//   forward  lse_i = logsumexp_j(x_i . W_j + b_j),
//            loss_i = lse_i - (x_i . W_l + b_l) for l = label_i
//   dx       dx_i = sum_j bf16(dlog_ij) W_j                     (bf16 out)
//   dW, db   dW_j = sum_i bf16(dlog_ij) x_i,  db_j = sum_i dlog_ij (f32 out)
// where dlog_ij = (exp(x_i . W_j + b_j - lse_i) - [j == label_i]) * g_i is
// recomputed from the saved lse, so the (n, v) logits never reach memory.
// A label outside [0, v) matches no column: its loss is lse - 0 and its
// gradient a pure softmax, as in the JAX kernels.
//
// Design. The TPU kernels run a sequential grid and carry accumulators in
// VMEM scratch across the inner axis. Here every kernel has one shape: a
// CTA of 8 warps keeps a tile of "resident" rows in shared memory (tokens
// of x for the forward and dx, vocabulary rows of W for dW) and streams the
// other operand through a double-buffered pair of 32-row tiles (cp.async,
// the next tile in flight while the current one is used). The scores of a
// tile, resident . streamed^T over the full depth h, come from mma.sync
// m16n8k16 (bf16 in, f32 out) with ldmatrix fragment loads; the row pitch
// h + 8 keeps ldmatrix free of bank conflicts.
//  - Forward (64 resident tokens): each lane runs its own online max/sum
//    over the vocabulary columns it owns; lanes and warps merge at the end.
//    The vocabulary is split over blockIdx.y so that short token counts
//    still fill the SMs; ce_fwd_combine_kernel merges the splits' (max, sum,
//    label logit) into lse and loss. The label's logit is taken by the one
//    lane that owns its column, so it is picked exactly once.
//  - dx and dW share one body. dlog of a 32 x 32 tile is rounded to bf16
//    into shared memory and multiplied by the streamed tile (ldmatrix.trans
//    gives its B fragments) into a 32 x h float32 accumulator held in
//    registers across the 8 warps (16 rows x h/4 columns each: h/8 floats
//    per thread, 96 at h = 768). For dW the scores are computed transposed,
//    W_tile . x_tile^T, so dlog^T comes out directly as the A operand, and
//    db is the row sum of the unrounded f32 dlog^T. One CTA owns its output
//    rows for the whole reduction: no atomics, deterministic, no workspace.
//  - Ragged edges: rows past n or v are zero-filled on load, their scores
//    are masked (no softmax mass, no gradient), and their outputs are not
//    stored. Rows with g = 0 give dlog = 0.
//
// Bound on an H100 SXM at BERT-base shape (n = 4096, h = 768, v = 30522):
// one product is 2 n h v = 192 GFLOP, so the forward is bound by operations
// at 0.194 ms and dx and dW (two products each) at 0.388 ms; the bytes
// (W in bf16 47 MB, x 6.3 MB, dW in f32 94 MB) take 0.02-0.04 ms. What keeps
// this first version above that: every CTA streams the whole other operand
// through L2 (forward 64 x 47 MB, dx 128 x 47 MB, dW 954 x 6.3 MB), one CTA
// per SM (the tiles take 150-200 KB of shared memory), and mma.sync rather
// than wgmma.
//
// Plain C interface for ctypes: every entry point launches on the given
// stream and returns the cudaError_t of the launch (or -1 for a hidden size
// without an instance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBS = 32;        // streamed rows per tile
constexpr float kNegInf = -1e30f;

// Resident rows of a CTA. Forward: 64 (4 row x 2 column warps), 32 at
// H = 1024, where 64 resident and two streamed tiles would exceed the 227 KB
// of shared memory. dx/dW: 32 (2 row x 4 column warps); at H = 1024, 16 (the
// 8 warps split the 1024 output columns, 64 accumulators per thread; 4 of
// them compute each 16 x 32 score tile).
template <int H>
__host__ __device__ constexpr int fwd_rows() {
  return H > 768 ? 32 : 64;
}
template <int H>
__host__ __device__ constexpr int bwd_rows() {
  return H > 768 ? 16 : 32;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that skips L1; writes zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row-major) * b (16x8, col-major); bf16 in, f32 accumulate.
// Fragments (g = lane / 4, t = lane % 4): C holds (row g, cols 2t, 2t+1) in
// c0, c1 and (row g+8, same cols) in c2, c3.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + ROWS) of a row-major (rows, H) bf16 matrix into shared
// memory with pitch H + 8; rows past the end are zero-filled. Asynchronous:
// the caller commits the group and waits for it.
template <int H, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int rows, int tid) {
  constexpr int kChunks = H / 8;  // 16-byte chunks per row
  static_assert((ROWS * kChunks) % kThreads == 0, "uneven tile load");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool valid = row0 + r < rows;
    cp_async16(dst + r * (H + 8) + col,
               src + static_cast<size_t>(valid ? row0 + r : 0) * H + col,
               valid);
  }
}

// Scores of 16 resident rows [r0, r0 + 16) against 8 * NT streamed rows
// [n0, n0 + 8 * NT): c = sR . sS^T over the full depth H. KS independent
// accumulator chains keep several mma.sync of one warp in flight.
template <int H, int NT>
__device__ __forceinline__ void score_tile(float (&c)[NT][4], const bf16* sR,
                                           const bf16* sS, int r0, int n0,
                                           int lane) {
  constexpr int LD = H + 8;
  constexpr int KS = 4 / NT;
  static_assert(H % (16 * KS) == 0, "depth must tile the k-steps");
  float part[KS][NT][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      part[s][j][0] = part[s][j][1] = part[s][j][2] = part[s][j][3] = 0.f;
  const bf16* pa = sR + (r0 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* pb =
      NT == 2 ? sS + (n0 + (lane & 7) + (lane >> 4) * 8) * LD +
                    ((lane >> 3) & 1) * 8
              : sS + (n0 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  // A partial unroll: unrolled over all of H = 768 the forward needs more
  // than 255 registers and spills.
#pragma unroll 4
  for (int k0 = 0; k0 < H; k0 += 16 * KS) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int k = k0 + 16 * s;
      uint32_t a[4];
      ldsm_x4(a, pa + k);
      if constexpr (NT == 2) {
        uint32_t b[4];
        ldsm_x4(b, pb + k);
        mma16816(part[s][0], a, b[0], b[1]);
        mma16816(part[s][1], a, b[2], b[3]);
      } else {
        uint32_t b[2];
        ldsm_x2(b, pb + k);
        mma16816(part[s][0], a, b[0], b[1]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sum = part[0][j][e];
#pragma unroll
      for (int s = 1; s < KS; ++s) sum += part[s][j][e];
      c[j][e] = sum;
    }
}

template <int H>
constexpr size_t fwd_smem_bytes() {
  return static_cast<size_t>(fwd_rows<H>() + 2 * kBS) * (H + 8) * sizeof(bf16);
}

template <int H>
constexpr size_t bwd_smem_bytes() {
  return static_cast<size_t>(bwd_rows<H>() + 2 * kBS) * (H + 8) *
             sizeof(bf16) +
         bwd_rows<H>() * (kBS + 8) * sizeof(bf16) +
         4 * bwd_rows<H>() * sizeof(float);
}

// ---------------------------------------------------------------------------
// Forward: grid (token tiles of fwd_rows<H>(), vocabulary splits). Writes each split's
// per-row (max, sum of exp, label logit) to PM/PL/PLBL[split][row].
// ---------------------------------------------------------------------------
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
ce_fwd_kernel(const bf16* __restrict__ X, const bf16* __restrict__ W,
              const float* __restrict__ B, const int64_t* __restrict__ L,
              float* __restrict__ PM, float* __restrict__ PL,
              float* __restrict__ PLBL, int n, int v, int tiles_per_split) {
  constexpr int BR = fwd_rows<H>();
  constexpr int RG = BR / 16;          // row groups of warps
  constexpr int CG = 8 / RG;           // column groups of warps
  constexpr int NT = kBS / (8 * CG);   // n-tiles of a warp's score slice
  constexpr int LD = H + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sR = reinterpret_cast<bf16*>(smem);
  bf16* sS = sR + BR * LD;
  __shared__ float sM[CG][BR], sL[CG][BR], sLbl[CG][BR];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % RG, cg = warp / RG;
  const int r0 = blockIdx.x * BR;
  const int n_tiles = (v + kBS - 1) / kBS;
  const int vt0 = blockIdx.y * tiles_per_split;
  const int vt1 = min(vt0 + tiles_per_split, n_tiles);

  int64_t lab[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + rg * 16 + g + 8 * r;
    lab[r] = row < n ? L[row] : -1;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, lbl[2] = {0.f, 0.f};

  load_rows<H, BR>(sR, X, r0, n, tid);
  if (vt0 < vt1) load_rows<H, kBS>(sS, W, vt0 * kBS, v, tid);
  cp_async_commit();
  for (int vt = vt0; vt < vt1; ++vt) {
    const int buf = (vt - vt0) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile vt is in; tile vt - 1's buffer is free
    if (vt + 1 < vt1) {
      load_rows<H, kBS>(sS + (buf ^ 1) * kBS * LD, W, (vt + 1) * kBS, v,
                        tid);
      cp_async_commit();
    }
    float c[NT][4];
    score_tile<H, NT>(c, sR, sS + buf * kBS * LD, rg * 16, cg * NT * 8, lane);

    const int col0 = vt * kBS + cg * NT * 8 + 2 * t;
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + j * 8 + (e & 1);
        const int r = e >> 1;
        float x = kNegInf;
        if (col < v) {
          x = c[j][e] + __ldg(B + col);
          if (col == lab[r]) lbl[r] += x;
        }
        c[j][e] = x;
        tmax[r] = fmaxf(tmax[r], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], tmax[r]);
      l[r] *= __expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col0 + j * 8 + (e & 1) < v) {
          l[e >> 1] += __expf(c[j][e] - m[e >> 1]);
        }
      }
    }
  }

  // Merge the 4 lanes of a row, then the CG warps of a row.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mn = fmaxf(m[r], mo);
      l[r] = l[r] * expf(m[r] - mn) + lo * expf(mo - mn);
      m[r] = mn;
      lbl[r] += __shfl_xor_sync(0xffffffffu, lbl[r], o);
    }
    if (t == 0) {
      const int i = rg * 16 + g + 8 * r;
      sM[cg][i] = m[r];
      sL[cg][i] = l[r];
      sLbl[cg][i] = lbl[r];
    }
  }
  __syncthreads();
  if (tid < BR && r0 + tid < n) {
    float mm = kNegInf;
#pragma unroll
    for (int c = 0; c < CG; ++c) mm = fmaxf(mm, sM[c][tid]);
    float ll = 0.f, bb = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      ll += sL[c][tid] * expf(sM[c][tid] - mm);
      bb += sLbl[c][tid];
    }
    const size_t o = static_cast<size_t>(blockIdx.y) * n + r0 + tid;
    PM[o] = mm;
    PL[o] = ll;
    PLBL[o] = bb;
  }
}

// lse = m + log(l) over the vocabulary splits (guarded against l = 0, as
// the JAX kernel's finalize is), loss = lse - label logit.
__global__ void ce_fwd_combine_kernel(const float* __restrict__ PM,
                                      const float* __restrict__ PL,
                                      const float* __restrict__ PLBL,
                                      float* __restrict__ LSE,
                                      float* __restrict__ LOSS, int n,
                                      int nsplit) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float m = kNegInf;
  for (int s = 0; s < nsplit; ++s) {
    m = fmaxf(m, PM[static_cast<size_t>(s) * n + row]);
  }
  float l = 0.f, lbl = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t o = static_cast<size_t>(s) * n + row;
    l += PL[o] * expf(PM[o] - m);
    lbl += PLBL[o];
  }
  const float lse = m + logf(l > 0.f ? l : 1.f);
  LSE[row] = lse;
  LOSS[row] = lse - lbl;
}

// ---------------------------------------------------------------------------
// Backward body shared by dx (resident tokens, streamed vocabulary) and
// dW/db (resident vocabulary rows, streamed tokens). Grid: resident tiles
// of bwd_rows<H>() rows; each CTA loops over every streamed tile.
// ---------------------------------------------------------------------------
template <int H, bool kDW>
__device__ __forceinline__ void ce_bwd_body(
    const bf16* __restrict__ X, const bf16* __restrict__ W,
    const float* __restrict__ B, const int64_t* __restrict__ L,
    const float* __restrict__ LSE, const float* __restrict__ G,
    void* __restrict__ OUT, float* __restrict__ DB, int n, int v,
    unsigned char* smem) {
  constexpr int BR = bwd_rows<H>();
  constexpr int RG = BR / 16;         // row groups of warps
  constexpr int CG = 8 / RG;          // column groups of warps
  // Column groups that compute the scores: at most one n-tile of 8
  // streamed rows each.
  constexpr int SCG = CG < kBS / 8 ? CG : kBS / 8;
  constexpr int NT = kBS / (8 * SCG);  // n-tiles of scores per scoring warp
  constexpr int LD = H + 8;
  constexpr int LDD = kBS + 8;
  constexpr int HW = H / CG;   // output columns of a warp
  constexpr int NH = HW / 8;   // their n-tiles
  static_assert(NH % 2 == 0, "hidden size must be a multiple of 64");
  bf16* sR = reinterpret_cast<bf16*>(smem);
  bf16* sS = sR + BR * LD;
  bf16* sD = sS + 2 * kBS * LD;
  float* sDB = reinterpret_cast<float*>(sD + BR * LDD);

  const bf16* R = kDW ? W : X;
  const bf16* S = kDW ? X : W;
  const int nr = kDW ? v : n;
  const int ns = kDW ? n : v;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % RG, cg = warp / RG;
  const int r0 = blockIdx.x * BR;

  // What each of this lane's two resident rows needs: the token's lse, g
  // and label (dx), or the vocabulary row's bias (dW).
  int rrow[2];
  float lse_r[2], g_r[2], bias_r[2];
  int64_t lab_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rrow[r] = r0 + rg * 16 + g + 8 * r;
    const bool in = rrow[r] < nr;
    lse_r[r] = !kDW && in ? LSE[rrow[r]] : 0.f;
    g_r[r] = !kDW && in ? G[rrow[r]] : 0.f;
    lab_r[r] = !kDW && in ? L[rrow[r]] : -1;
    bias_r[r] = kDW && in ? B[rrow[r]] : 0.f;
  }

  float acc[NH][4];
#pragma unroll
  for (int j = 0; j < NH; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float dbacc[2] = {0.f, 0.f};

  load_rows<H, BR>(sR, R, r0, nr, tid);
  load_rows<H, kBS>(sS, S, 0, ns, tid);
  cp_async_commit();
  const int n_tiles = (ns + kBS - 1) / kBS;
  for (int st = 0; st < n_tiles; ++st) {
    const int buf = st & 1;
    const bf16* sSb = sS + buf * kBS * LD;
    cp_async_wait_all();
    __syncthreads();  // tile st is in; the previous tile's reads are done
    if (st + 1 < n_tiles) {
      load_rows<H, kBS>(sS + (buf ^ 1) * kBS * LD, S, (st + 1) * kBS, ns,
                        tid);
      cp_async_commit();
    }
    if (cg < SCG) {
      float c[NT][4];
      score_tile<H, NT>(c, sR, sSb, rg * 16, cg * NT * 8, lane);

      const int col0 = st * kBS + cg * NT * 8 + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = col0 + j * 8 + (e & 1);
          const int r = e >> 1;
          const int token = kDW ? col : rrow[r];
          const int vocab = kDW ? rrow[r] : col;
          float d = 0.f;
          if (token < n && vocab < v) {
            float lse, gg, bias;
            int64_t lab;
            if (kDW) {
              lse = __ldg(LSE + col);
              gg = __ldg(G + col);
              lab = L[col];
              bias = bias_r[r];
            } else {
              lse = lse_r[r];
              gg = g_r[r];
              lab = lab_r[r];
              bias = __ldg(B + col);
            }
            const float p = __expf(c[j][e] + bias - lse);
            d = (p - (lab == vocab ? 1.f : 0.f)) * gg;
          }
          c[j][e] = d;
          if (kDW) dbacc[r] += d;
        }
      }
      // bf16(dlog) (rows resident, columns streamed): the A operand below.
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        bf16* p = sD + (rg * 16 + g) * LDD + cg * NT * 8 + j * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(c[j][0], c[j][1]);
        *reinterpret_cast<uint32_t*>(p + 8 * LDD) = pack_bf16(c[j][2], c[j][3]);
      }
    }
    __syncthreads();
    // acc += dlog[this warp's 16 rows, 0:kBS] . S[0:kBS, its HW columns]
#pragma unroll
    for (int kk = 0; kk < kBS / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sD + (rg * 16 + (lane & 15)) * LDD + kk * 16 + (lane >> 4) * 8);
      const bf16* pb = sSb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       cg * HW + (lane >> 4) * 8;
#pragma unroll
      for (int jj = 0; jj < NH / 2; ++jj) {
        uint32_t b[4];
        ldsm_x4_t(b, pb + jj * 16);
        mma16816(acc[2 * jj], a, b[0], b[1]);
        mma16816(acc[2 * jj + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rrow[r] >= nr) continue;
    const size_t off = static_cast<size_t>(rrow[r]) * H + cg * HW + 2 * t;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      if (kDW) {
        *reinterpret_cast<float2*>(static_cast<float*>(OUT) + off + j * 8) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(OUT) + off +
                                           j * 8) =
            __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
  if (kDW) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dbacc[r] += __shfl_xor_sync(0xffffffffu, dbacc[r], 1);
      dbacc[r] += __shfl_xor_sync(0xffffffffu, dbacc[r], 2);
      if (t == 0 && cg < SCG) sDB[cg * BR + rg * 16 + g + 8 * r] = dbacc[r];
    }
    __syncthreads();
    if (tid < BR && r0 + tid < v) {
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < SCG; ++c) sum += sDB[c * BR + tid];
      DB[r0 + tid] = sum;
    }
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
ce_dx_kernel(const bf16* __restrict__ X, const bf16* __restrict__ W,
             const float* __restrict__ B, const int64_t* __restrict__ L,
             const float* __restrict__ LSE, const float* __restrict__ G,
             bf16* __restrict__ DX, int n, int v) {
  extern __shared__ __align__(16) unsigned char smem[];
  ce_bwd_body<H, false>(X, W, B, L, LSE, G, DX, nullptr, n, v, smem);
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
ce_dw_kernel(const bf16* __restrict__ X, const bf16* __restrict__ W,
             const float* __restrict__ B, const int64_t* __restrict__ L,
             const float* __restrict__ LSE, const float* __restrict__ G,
             float* __restrict__ DW, float* __restrict__ DB, int n, int v) {
  extern __shared__ __align__(16) unsigned char smem[];
  ce_bwd_body<H, true>(X, W, B, L, LSE, G, DW, DB, n, v, smem);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int H>
int launch_fwd(const void* x, const void* w, const void* b, const void* lab,
               void* pm, void* pl, void* plbl, void* lse, void* loss, int n,
               int v, int nsplit, int tiles_per_split, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<H>();
  cudaError_t err = allow_smem(ce_fwd_kernel<H>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + fwd_rows<H>() - 1) / fwd_rows<H>(), nsplit);
  ce_fwd_kernel<H><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const int64_t*>(lab),
      static_cast<float*>(pm), static_cast<float*>(pl),
      static_cast<float*>(plbl), n, v, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_fwd_combine_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pl),
      static_cast<const float*>(plbl), static_cast<float*>(lse),
      static_cast<float*>(loss), n, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_dx(const void* x, const void* w, const void* b, const void* lab,
              const void* lse, const void* g, void* dx, int n, int v,
              cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<H>();
  cudaError_t err = allow_smem(ce_dx_kernel<H>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int rows = bwd_rows<H>();
  ce_dx_kernel<H><<<(n + rows - 1) / rows, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const int64_t*>(lab),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<bf16*>(dx), n, v);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_dw(const void* x, const void* w, const void* b, const void* lab,
              const void* lse, const void* g, void* dw, void* db, int n,
              int v, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<H>();
  cudaError_t err = allow_smem(ce_dw_kernel<H>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int rows = bwd_rows<H>();
  ce_dw_kernel<H><<<(v + rows - 1) / rows, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const int64_t*>(lab),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<float*>(dw), static_cast<float*>(db), n, v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hvd_ce_fwd(const void* x, const void* w, const void* b, const void* lab,
               void* pm, void* pl, void* plbl, void* lse, void* loss, int n,
               int v, int h, int nsplit, int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 256:
      return launch_fwd<256>(x, w, b, lab, pm, pl, plbl, lse, loss, n, v,
                             nsplit, tiles_per_split, st);
    case 512:
      return launch_fwd<512>(x, w, b, lab, pm, pl, plbl, lse, loss, n, v,
                             nsplit, tiles_per_split, st);
    case 768:
      return launch_fwd<768>(x, w, b, lab, pm, pl, plbl, lse, loss, n, v,
                             nsplit, tiles_per_split, st);
    case 1024:
      return launch_fwd<1024>(x, w, b, lab, pm, pl, plbl, lse, loss, n, v,
                              nsplit, tiles_per_split, st);
    default: return -1;
  }
}

int hvd_ce_dx(const void* x, const void* w, const void* b, const void* lab,
              const void* lse, const void* g, void* dx, int n, int v, int h,
              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 256: return launch_dx<256>(x, w, b, lab, lse, g, dx, n, v, st);
    case 512: return launch_dx<512>(x, w, b, lab, lse, g, dx, n, v, st);
    case 768: return launch_dx<768>(x, w, b, lab, lse, g, dx, n, v, st);
    case 1024: return launch_dx<1024>(x, w, b, lab, lse, g, dx, n, v, st);
    default: return -1;
  }
}

int hvd_ce_dw(const void* x, const void* w, const void* b, const void* lab,
              const void* lse, const void* g, void* dw, void* db, int n,
              int v, int h, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 256: return launch_dw<256>(x, w, b, lab, lse, g, dw, db, n, v, st);
    case 512: return launch_dw<512>(x, w, b, lab, lse, g, dw, db, n, v, st);
    case 768: return launch_dw<768>(x, w, b, lab, lse, g, dw, db, n, v, st);
    case 1024:
      return launch_dw<1024>(x, w, b, lab, lse, g, dw, db, n, v, st);
    default: return -1;
  }
}

const char* hvd_ce_error_string(int code) {
  if (code == -1) return "hidden size has no kernel instance";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
