// Chunkwise-parallel stabilized mLSTM forward for Hopper, sm_90a (K3).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mlstm_chunk/kernel.py::mlstm_chunk_pallas
// (body _mlstm_kernel) and computes the same function.  Per (batch, head)
// the sequence goes in chunks of L rows, carrying the matrix memory C
// (dh x dh), the normalizer n (dh) and the stabilizer m (NEG_BIG = -1e30
// at first).  Inside a chunk, with a = cumsum(lf), g = li - a,
// M_t = max(m_prev, cummax_{s<=t} g_s), m_t = a_t + M_t:
//   D[t,s] = exp(g_s - M_t) for s <= t, else 0 (selected, never a 0 mask
//            times an exp that may overflow);
//   h_t    = ((Q K^T . D) V + exp(m_prev - M_t) Q C)_t
//            / max(|q_t . n_tot_t|, exp(-m_t)),
//   where q_t . n_tot_t = sum_s (Q K^T . D)[t,s] + exp(m_prev - M_t) q_t . n
//   (the reference's n_intra = D K, dotted with q_t);
// then the carry update with w_s = exp(g_s - M_L), f_L = exp(m_prev - M_L):
//   C = f_L C + sum_s w_s k_s v_s^T,  n = f_L n + sum_s w_s k_s,
//   m = m_{L-1}.
// The result does not depend on the chunk length up to rounding, and every
// exponent above is <= 0, so the chunk may be long.  Any S >= 1: the last
// chunk is ragged.  q, k, v and the output are read and written in the
// model's (B, S, H, dh) layout through strides (the last dimension
// contiguous); li and lf are float32 (B, S, H), also through strides.
//
// Bound on the H100 at the serving path's shape (B*H = 24 heads of 2048 x
// 512, bf16): counted on what the function needs at the reference's chunk
// of 128 (the causal half of QK^T and (S.D)V, 2 * 2 L dh^2 for QC and
// K^T V, no D K product: q . n_intra is a row sum of QK^T . D), 5.8e10
// flops, 0.059 ms at 989 TFLOP/s bf16, against 0.20 GB moved, 0.060 ms at
// 3.35 TB/s: bytes, narrowly.
//
// bfloat16: three passes, the products on the tensor cores (TFLA's split
// of the xLSTM authors' Hopper kernels, Beck et al. 2025: a recurrent pass
// that only builds the chunk-boundary states, a parallel pass for the
// outputs, and a state chunk longer than the tiles).  The state does not
// fit an SM: C is 1 MiB of float32 a head at dh = 512 (the TPU kernel kept
// it whole in VMEM), and the chunk recurrence serialises a head.  So:
//   1. gates (mlstm_chunk_gates): a block a (b, h), a thread a row of a
//      chunk of 256; cumsum and cummax by warp shuffles, the chunks in
//      order; writes log2(e) g, log2(e) M, the decay exp(m_prev - M),
//      exp(-m), w and f_L to a float32 workspace;
//   2. states (mlstm_chunk_states): C and n at each boundary of a state
//      chunk of 256 rows; a block a (b, h, 128 x 128 tile of C), 384
//      blocks at the serving shape.  Warpgroup 0 feeds a ring of 64-row
//      stages: one thread loads K and V by TMA, three warps turn V into
//      w V split into bf16 hi and lo; two consumer warpgroups of 64 dk
//      rows keep the tile in wgmma accumulators, scaled by f_L once a
//      chunk, += K^T (w V)_hi + K^T (w V)_lo, one stage's products in
//      flight while the next is issued; each boundary goes out by TMA as
//      two bf16 planes, hi = bf16(C) and lo = bf16(C - hi) (together about
//      2^-17 relative), n likewise (7 boundaries x 24 heads x 512^2 x 4 B
//      = 176 MB at the serving shape);
//   3. outputs (mlstm_chunk_outputs): fully parallel over (128 query rows,
//      dv tile of 256, b*h); a producer warpgroup issues TMA, two consumer
//      warpgroups own 64 rows each: Q C_hi + Q C_lo and q . n from the
//      boundary's planes, then the key tiles of 64 up to the diagonal as
//      in flash attention: S = Q K^T (exact: bf16 inputs, float32 sums),
//      D applied in registers, P V with P from registers split into hi
//      and lo; the denominator is P's row sums plus decay (q . n); the
//      output is rounded to bf16 once.
// Every product runs on the tensor cores, every operand that is not bf16
// already (w V, P, C, n) is split into hi and lo, and QK^T is computed
// twice a query row (once a dv tile), not by every block of a head.  The
// extra traffic is the states, written once and read by each row tile:
// ~0.35 GB at a state chunk of 256, ~0.105 ms at 3.35 TB/s; with the
// function's 0.060 ms that is this design's floor, ~0.17 ms.
//
// float32: CUDA cores (FMA) in full float32, since tensor cores would
// round q and k to TF32 (mlstm_chunk_fwd): a v-split of the state across
// blocks (C[:, v0:v0+32] in shared memory, grid (dh / 32, B*H)), chunks
// of 64 rows walked inside the block, the gates' cumsum and cummax
// serially in one thread, one pass over dh a chunk.
//
// The bf16 tensor maps are encoded on the host at each launch by
// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so the library needs no -lcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct MlstmParams {
  const void* q;
  const void* k;
  const void* v;
  const float* li;
  const float* lf;
  void* o;
  float* gates;  // bf16 workspaces, allocated by the caller (see mlstm_fwd)
  void* states;
  void* norms;
  int64_t q_sb, q_ss, q_sh;  // strides in elements: batch, sequence, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t li_sb, li_ss, li_sh;
  int64_t lf_sb, lf_ss, lf_sh;
  int64_t o_sb, o_ss, o_sh;
  int32_t batch, seqlen, heads, head_dim;
};

namespace {

constexpr int kMaxHeadDim = 512;
constexpr float kNegBig = -1e30f;

// ---------------------------------------------------------------- float32
namespace f32 {

constexpr int kL = 64;        // chunk rows
constexpr int kVT = 32;       // v-tile width (columns of C a block owns)
constexpr int kDK = 32;       // dh slice staged in shared memory
constexpr int kThreads = 256;
constexpr int kQKStride = kDK + 1;  // padded rows: conflict-free columns
constexpr int kPStride = kL + 1;

// shared memory in floats for head_dim d
__host__ __device__ inline int rows_c(int d) { return (d + kDK - 1) / kDK * kDK; }
__host__ __device__ inline int smem_floats(int d) {
  return rows_c(d) * kVT      // C tile
         + rows_c(d)          // n
         + 2 * kL * kQKStride  // Q and K slices; P aliases them
         + 2 * kL * kVT       // V tile and w-scaled V tile
         + 9 * kL             // gates and per-row values
         + 4;                 // scalars
}

__global__ void __launch_bounds__(kThreads, 2)
    mlstm_chunk_fwd(const MlstmParams p) {
  extern __shared__ float smem[];
  const int d = p.head_dim;
  const int dp = rows_c(d);
  float* Cs = smem;                    // [dp][kVT]
  float* ns = Cs + dp * kVT;           // [dp]
  float* Qs = ns + dp;                 // [kL][kQKStride]
  float* Ks = Qs + kL * kQKStride;     // [kL][kQKStride]
  float* Ps = Qs;                      // [kL][kPStride], after the dh pass
  float* Vs = Ks + kL * kQKStride;     // [kL][kVT]
  float* WVs = Vs + kL * kVT;          // [kL][kVT]  w_s v_s
  float* lis = WVs + kL * kVT;         // [kL]
  float* lfs = lis + kL;               // [kL]
  float* gs = lfs + kL;                // [kL]  g_s
  float* Ms = gs + kL;                 // [kL]  M_t
  float* mts = Ms + kL;                // [kL]  m_t
  float* decs = mts + kL;              // [kL]  exp(m_prev - M_t)
  float* lows = decs + kL;             // [kL]  exp(-m_t)
  float* ws = lows + kL;               // [kL]  w_s (0 past the end)
  float* dens = ws + kL;               // [kL]  the denominator
  float* sc = dens + kL;               // m carry, m_prev, M_L, f_L

  const int v0 = blockIdx.x * kVT;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* lig = p.li + b * p.li_sb + h * p.li_sh;
  const float* lfg = p.lf + b * p.lf_sb + h * p.lf_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < dp * kVT; i += kThreads) Cs[i] = 0.f;
  for (int i = tid; i < dp; i += kThreads) ns[i] = 0.f;
  if (tid == 0) sc[0] = kNegBig;
  __syncthreads();

  const int nchunks = (p.seqlen + kL - 1) / kL;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kL;
    const int lc = min(kL, p.seqlen - t0);

    // ---- gates, and the V tile ----
    if (tid < kL) {
      const bool ok = tid < lc;
      lis[tid] = ok ? lig[int64_t(t0 + tid) * p.li_ss] : 0.f;
      lfs[tid] = ok ? lfg[int64_t(t0 + tid) * p.lf_ss] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kL * kVT / kThreads; ++r) {
      const int s = warp + 8 * r, col = v0 + lane;
      Vs[s * kVT + lane] = (s < lc && col < d)
                               ? vg[int64_t(t0 + s) * p.v_ss + col]
                               : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      // the reference's cumsum and cummax, in its order
      const float m_prev = sc[0];
      float a = 0.f, run = -INFINITY, m_last = 0.f, M_last = 0.f;
      for (int t = 0; t < kL; ++t) {
        a += lfs[t];
        const float g = lis[t] - a;
        run = fmaxf(run, g);
        const float M = fmaxf(m_prev, run);
        gs[t] = g;
        Ms[t] = M;
        mts[t] = a + M;
        if (t == lc - 1) {
          m_last = a + M;
          M_last = M;
        }
      }
      sc[1] = m_prev;
      sc[2] = M_last;
      sc[3] = expf(m_prev - M_last);
      sc[0] = m_last;
    }
    __syncthreads();
    if (tid < kL) {
      decs[tid] = expf(sc[1] - Ms[tid]);
      lows[tid] = expf(-mts[tid]);
      ws[tid] = tid < lc ? expf(gs[tid] - sc[2]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kL * kVT / kThreads; ++r) {
      const int s = warp + 8 * r;
      WVs[s * kVT + lane] = ws[s] * Vs[s * kVT + lane];
    }
    const float f_L = sc[3];

    // ---- one pass over dh: QK^T, Q C, q . n, then the carry update ----
    float sacc[4][4], oacc[4][2], qn = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
      oacc[i][0] = oacc[i][1] = 0.f;
    }
    for (int d0 = 0; d0 < dp; d0 += kDK) {
#pragma unroll
      for (int r = 0; r < kL * kDK / kThreads; ++r) {
        const int s = warp + 8 * r, col = d0 + lane;
        const bool ok = s < lc && col < d;
        Qs[s * kQKStride + lane] =
            ok ? qg[int64_t(t0 + s) * p.q_ss + col] : 0.f;
        Ks[s * kQKStride + lane] =
            ok ? kg[int64_t(t0 + s) * p.k_ss + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDK; ++kk) {
        float qv[4], kv[4], cv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * kQKStride + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * kQKStride + kk];
        cv[0] = Cs[(d0 + kk) * kVT + tx];
        cv[1] = Cs[(d0 + kk) * kVT + tx + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
          oacc[i][0] = fmaf(qv[i], cv[0], oacc[i][0]);
          oacc[i][1] = fmaf(qv[i], cv[1], oacc[i][1]);
        }
      }
      {  // q_t . n over this slice: four threads a row, eight columns each
        const int t = tid >> 2, c8 = (tid & 3) * 8;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          qn = fmaf(Qs[t * kQKStride + c8 + kk], ns[d0 + c8 + kk], qn);
      }
      __syncthreads();  // every read of C and n rows d0.. is done
      {  // C rows d0 + warp + 8 i, column lane: one w v load feeds four rows
        float acc[kDK / 8];
#pragma unroll
        for (int i = 0; i < kDK / 8; ++i) acc[i] = 0.f;
#pragma unroll 8
        for (int s = 0; s < kL; ++s) {
          const float wv = WVs[s * kVT + lane];
#pragma unroll
          for (int i = 0; i < kDK / 8; ++i)
            acc[i] = fmaf(Ks[s * kQKStride + warp + 8 * i], wv, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < kDK / 8; ++i) {
          float* cp = Cs + (d0 + warp + 8 * i) * kVT + lane;
          *cp = fmaf(*cp, f_L, acc[i]);
        }
      }
      if (warp == 0) {
        float acc = 0.f;
#pragma unroll 8
        for (int s = 0; s < kL; ++s)
          acc = fmaf(Ks[s * kQKStride + lane], ws[s], acc);
        ns[d0 + lane] = fmaf(ns[d0 + lane], f_L, acc);
      }
      __syncthreads();  // the next slice overwrites Q and K
    }

    // ---- P = QK^T . D, the denominator, and the output ----
    qn += __shfl_xor_sync(0xffffffffu, qn, 1);
    qn += __shfl_xor_sync(0xffffffffu, qn, 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx + 16 * j;
        Ps[t * kPStride + s] =
            (s <= t && t < lc) ? sacc[i][j] * expf(gs[s] - Ms[t]) : 0.f;
      }
    }
    __syncthreads();
    {
      const int t = tid >> 2, c16 = (tid & 3) * 16;
      float rs = 0.f;
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) rs += Ps[t * kPStride + c16 + kk];
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      if ((tid & 3) == 0)
        dens[t] = fmaxf(fabsf(rs + decs[t] * qn), lows[t]);
    }
    __syncthreads();
    float pacc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) pacc[i][0] = pacc[i][1] = 0.f;
#pragma unroll 8
    for (int s = 0; s < kL; ++s) {
      const float va = Vs[s * kVT + tx], vb = Vs[s * kVT + tx + 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = Ps[(ty + 16 * i) * kPStride + s];
        pacc[i][0] = fmaf(pv, va, pacc[i][0]);
        pacc[i][1] = fmaf(pv, vb, pacc[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      if (t >= lc) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = v0 + tx + 16 * j;
        if (col < d)
          og[int64_t(t0 + t) * p.o_ss + col] =
              (pacc[i][j] + oacc[i][j] * decs[t]) / dens[t];
      }
    }
    __syncthreads();  // the next chunk overwrites the gates, V and P
  }
}

int launch(const MlstmParams& p, cudaStream_t stream) {
  const size_t smem = size_t(smem_floats(p.head_dim)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.head_dim + kVT - 1) / kVT, p.batch * p.heads);
  mlstm_chunk_fwd<<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace f32

// --------------------------------------------------------------- bfloat16
namespace bf16 {

constexpr int kChunk = 256;      // rows a state chunk
constexpr int kTile = 64;        // rows of a query or key tile; a state tile
constexpr int kBox = 64;         // columns a TMA box: 128 bytes, the swizzle
constexpr int kRowBytes = 128;   // one box row in shared memory
constexpr int kBoxBytes = kTile * kRowBytes;  // a box of 64 rows
constexpr float kLog2e = 1.4426950408889634f;
// The gate workspace: per (b, h), kPlanes float32 rows of chunks(S) * 256
// entries (the padded rows past S hold values no stored output reads):
//   kG2    log2(e) g_s, -inf past S (so D = 0 there)
//   kM2    log2(e) M_t
//   kDecay exp(m_prev - M_t)
//   kLow   exp(-m_t)
//   kW     w_s = exp(g_s - M_L), 0 past S
//   kF     f_L = exp(m_prev - M_L), one a chunk (entry c)
enum { kG2 = 0, kM2, kDecay, kLow, kW, kF, kPlanes };

__host__ __device__ inline int chunks(int s) {
  return (s + kChunk - 1) / kChunk;
}
__host__ __device__ inline int pad64(int d) { return (d + 63) / 64 * 64; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));  // .x is the low half
}

// x - bf16(x), the part of x that its bf16 rounding drops
__device__ __forceinline__ float rest(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; the barrier counts its bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// One box from shared memory into a 4-D tensor map's tensor, in this
// thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// This thread's bulk stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Make this thread's generic-proxy stores to shared memory visible to the
// async proxy (TMA's reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) of `count` threads, here one warpgroup's.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start
// address, leading and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo) << 16) |
         (uint64_t(sbo) << 32) | (1ull << 62);
}

// The descriptors of the tiles TMA writes (64-column boxes, 128-byte
// rows, 16-byte chunks swizzled by row % 8, 8-row groups 1024 bytes
// apart).  K-major (the reduction dimension contiguous, as Q and K for
// Q K^T): k-step kk reads columns [16 kk, 16 kk + 16), box kk / 4, 32
// bytes into its rows; `box_bytes` apart.  MN-major (the reduction
// dimension along the rows, as V, C and w V): k-step kk starts 16 rows in;
// the boxes along M or N kBoxBytes apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk,
                                           uint32_t box_bytes) {
  return smem_desc(tile + (kk >> 2) * box_bytes + (kk & 3) * 32, 1, 64);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * kRowBytes, kBoxBytes / 16, 64);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving an accumulator across the asynchronous
// wgmma that writes it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 8) = A (64 x 16) B (16 x 8) (+ D), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n8(float (&d)[4], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) = A (64 x 16) B (16 x 64) (+ D), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) = A (64 x 16) B (16 x 64) (+ D), both MN-major in shared
// memory (A read transposed)
__device__ __forceinline__ void wgmma_ss_n64_tt(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128) = A (64 x 16) B (16 x 128) (+ D), both MN-major in shared
// memory (A read transposed)
__device__ __forceinline__ void wgmma_ss_n128_tt(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) = A (64 x 16, K-major) B (16 x 64, MN-major) (+ D), both in
// shared memory
__device__ __forceinline__ void wgmma_ss_n64_tb(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128) = A (64 x 16, K-major) B (16 x 128, MN-major) (+ D), both in
// shared memory
__device__ __forceinline__ void wgmma_ss_n128_tb(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 256) = A (64 x 16, K-major) B (16 x 256, MN-major) (+ D), both in
// shared memory
__device__ __forceinline__ void wgmma_ss_n256_tb(float (&d)[128], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) += A (64 x 16, registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128) += A (64 x 16, registers) B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256) += A (64 x 16, registers) B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_qc(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (N == 64) {
    wgmma_ss_n64_tb(d, da, db, 1);
  } else if constexpr (N == 128) {
    wgmma_ss_n128_tb(d, da, db, 1);
  } else {
    wgmma_ss_n256_tb(d, da, db, 1);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    wgmma_rs_n256(d, a, db);
  }
}

// ---- pass 1: the gates.  One block a (b, h), one thread a row of a
// chunk; the chunks in order, since each starts from the last one's m.
__global__ void __launch_bounds__(kChunk)
mlstm_chunk_gates(const MlstmParams p) {
  __shared__ float part_sum[kChunk / 32], part_max[kChunk / 32], last[2];
  const int bh = blockIdx.x, b = bh / p.heads, h = bh % p.heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sp = chunks(p.seqlen) * kChunk;
  const float* lig = p.li + b * p.li_sb + h * p.li_sh;
  const float* lfg = p.lf + b * p.lf_sb + h * p.lf_sh;
  float* G = p.gates + int64_t(bh) * kPlanes * sp;
  float m_prev = kNegBig;
  for (int c = 0; c * kChunk < p.seqlen; ++c) {
    const int t = c * kChunk + tid;
    const bool ok = t < p.seqlen;
    const float li = ok ? lig[int64_t(t) * p.li_ss] : 0.f;
    float a = ok ? lfg[int64_t(t) * p.lf_ss] : 0.f;
    // a = cumsum(lf) and then cummax(g): scans by shuffles inside each
    // warp, then over the warps before it
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, a, off);
      if (lane >= off) a += y;
    }
    if (lane == 31) part_sum[warp] = a;
    __syncthreads();
    for (int w = 0; w < warp; ++w) a += part_sum[w];
    const float g = li - a;
    float run = g;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, run, off);
      if (lane >= off) run = fmaxf(run, y);
    }
    if (lane == 31) part_max[warp] = run;
    __syncthreads();
    for (int w = 0; w < warp; ++w) run = fmaxf(run, part_max[w]);
    const float M = fmaxf(m_prev, run), m = a + M;
    if (tid == kChunk - 1) {
      last[0] = M;
      last[1] = m;
    }
    __syncthreads();
    const float M_L = last[0];
    G[kG2 * sp + t] = ok ? g * kLog2e : -INFINITY;
    G[kM2 * sp + t] = M * kLog2e;
    G[kDecay * sp + t] = expf(m_prev - M);
    G[kLow * sp + t] = expf(-m);
    G[kW * sp + t] = ok ? expf(g - M_L) : 0.f;
    if (tid == 0) G[kF * sp + c] = expf(m_prev - M_L);
    m_prev = last[1];
    __syncthreads();  // the next chunk writes part_sum, part_max, last
  }
}

// ---- pass 2: the states at the chunk boundaries.  One block a (b, h,
// T x T tile of C): T / 64 consumer warpgroups own 64 dk rows each, and
// warpgroup 0 feeds them: one thread keeps a ring of stages full by TMA (a
// stage: 64 rows of K's T dk columns and of V's T dv columns), and three
// warps turn each stage's V into w V, split into bf16 hi (in place) and
// lo (beside it) at the same swizzled places (w is one value a row, and
// the swizzle only moves 16-byte pieces within a row).  The tile lives in
// the wgmma accumulators: scaled by f_L at a chunk's start, then
// C[i, j] += K[:, i]^T (w V)_hi + K[:, i]^T (w V)_lo, K^T read as an
// MN-major A; each stage's products stay in flight while the next
// stage's are issued (a stage is freed when its group completes).  The
// blocks of the first dv tile also sum n[i] = sum_s w_s k_s in float32
// while the products run.  Each boundary's tile goes out by TMA as hi and
// lo planes (and n as two rows); the last chunk's state is never read, so
// it is not made.
constexpr int kStateStages = 3;
constexpr int kConverters = 96;  // warps 1-3 of warpgroup 0

template <int T>
struct StateLayout {
  static constexpr int kBoxes = T / kBox;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // 64 rows x T
  static constexpr int kStage = 3 * kTileBytes;  // K, V then (w V)_hi, lo
  // a consumer warpgroup's 64 x T hi and lo planes on their way out
  static constexpr int kOut = kStateStages * kStage;
  static constexpr int kOutWg = 2 * kTileBytes;
  static constexpr int kBar = kOut + kBoxes * kOutWg;
  // full (TMA landed), ready (w V made), empty (products done)
  static constexpr int kBytes = kBar + 24 * kStateStages;
  static constexpr int kLaunchBytes = kBytes + 1024;  // room to align
  static constexpr int kThreads = 128 * (1 + kBoxes);
  static_assert(kLaunchBytes <= 232448, "more than a block's shared memory");
};

template <int T>
__device__ __forceinline__ void wgmma_state(float (&d)[T / 2], uint64_t da,
                                            uint64_t db) {
  if constexpr (T == 64) {
    wgmma_ss_n64_tt(d, da, db, 1);
  } else {
    wgmma_ss_n128_tt(d, da, db, 1);
  }
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

template <int T>
__global__ void __launch_bounds__(StateLayout<T>::kThreads, 1)
mlstm_chunk_states(const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tc,
                   const MlstmParams p) {
  using L = StateLayout<T>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);  // generic address
  const uint32_t full = base + L::kBar;
  const uint32_t ready = full + 8 * kStateStages;
  const uint32_t empty = ready + 8 * kStateStages;

  // a head's tiles are neighbours in the grid, so its K and V boxes are
  // read from HBM about once and from L2 by the other tiles
  const int dp = pad64(p.head_dim), tiles = dp / T;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int ti = blockIdx.x / tiles, tj = blockIdx.x % tiles;
  const int i0 = ti * T, j0 = tj * T;
  const int nc = chunks(p.seqlen), sp = nc * kChunk, nb = nc - 1;
  const float* G = p.gates + int64_t(bh) * kPlanes * sp;
  // the boundary chunks are whole: stage n holds rows [64 n, 64 n + 64)
  const int total = nb * (kChunk / kTile);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStateStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, kConverters);
      mbar_init(empty + 8 * s, 128 * L::kBoxes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    // ---- loader: keeps the ring full
    for (int n = 0; n < total; ++n) {
      const int s = n % kStateStages;
      const uint32_t st = base + s * L::kStage;
      mbar_wait(empty + 8 * s, ((n / kStateStages) & 1) ^ 1);
      mbar_expect_tx(full + 8 * s, 2 * L::kTileBytes);
      for (int x = 0; x < L::kBoxes; ++x) {
        tma_load(st + x * kBoxBytes, &tk, full + 8 * s, i0 + x * kBox, h,
                 n * kTile, b);
        tma_load(st + L::kTileBytes + x * kBoxBytes, &tv, full + 8 * s,
                 j0 + x * kBox, h, n * kTile, b);
      }
    }
    return;
  }
  if (threadIdx.x < 32) return;
  if (threadIdx.x < 128) {
    // ---- converters: V -> (w V)_hi in place, (w V)_lo beside it
    const int id = threadIdx.x - 32;
    for (int n = 0; n < total; ++n) {
      const int s = n % kStateStages;
      unsigned char* vs = sbase + s * L::kStage + L::kTileBytes;
      const float* w = G + kW * sp + n * kTile;  // this stage's rows
      mbar_wait(full + 8 * s, (n / kStateStages) & 1);
      for (int piece = id; piece < L::kTileBytes / 16; piece += kConverters) {
        const float wr = __ldg(w + ((piece & 511) >> 3));
        uint4* at = reinterpret_cast<uint4*>(vs + 16 * piece);
        const uint4 x = *at;
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
          const float a = v2.x * wr, bb = v2.y * wr;
          hi[e] = pack_f32(a, bb);
          lo[e] = pack_f32(rest(a), rest(bb));
        }
        *at = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(vs + L::kTileBytes + 16 * piece) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      fence_proxy_async();  // for the consumers' wgmma reads
      mbar_arrive(ready + 8 * s);
    }
    return;
  }

  // ---- consumers: warpgroup cw owns dk rows [i0 + 64 cw, i0 + 64 cw + 64)
  const int tid = threadIdx.x - 128, cw = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[T / 2];
#pragma unroll
  for (int i = 0; i < T / 2; ++i) acc[i] = 0.f;
  // n: column ncol of this warpgroup's K box, rows [32 nhalf, 32 nhalf +
  // 32) of each stage; the two halves of a column in one warp
  const bool norms = tj == 0;
  const int ncol = warp * 16 + (lane & 15), nhalf = lane >> 4;
  float n_part = 0.f, n_state = 0.f, f = 0.f;
  __nv_bfloat16* nstore = static_cast<__nv_bfloat16*>(p.norms);
  const uint32_t out_s = base + L::kOut + cw * L::kOutWg;
  unsigned char* out_g = sbase + L::kOut + cw * L::kOutWg;
  const bool issuer = (tid & 127) == 0;  // the warpgroup's TMA thread

  for (int n = 0; n < total; ++n) {
    const int c = n / (kChunk / kTile), sub = n % (kChunk / kTile);
    const int s = n % kStateStages;
    const uint32_t st = base + s * L::kStage;
    if (sub == 0) {  // C <- f_L C before the chunk's sum (nothing in flight)
      f = G[kF * sp + c];
#pragma unroll
      for (int i = 0; i < T / 2; ++i) acc[i] *= f;
    }
    mbar_wait(ready + 8 * s, (n / kStateStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_state<T>(acc, mnmajor(st + cw * kBoxBytes, kk),
                     mnmajor(st + L::kTileBytes, kk));
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_state<T>(acc, mnmajor(st + cw * kBoxBytes, kk),
                     mnmajor(st + 2 * L::kTileBytes, kk));
    wgmma_commit();
    if (norms) {
      // K's column ncol: row r's 16-byte piece ncol / 8 sits at piece
      // (ncol / 8) ^ (r % 8) of the row
      const unsigned char* kb = sbase + s * L::kStage + cw * kBoxBytes;
      const float* w = G + kW * sp + n * kTile;
#pragma unroll 8
      for (int r = 32 * nhalf; r < 32 * nhalf + 32; ++r) {
        const int off = r * kRowBytes + (((ncol >> 3) ^ (r & 7)) << 4) +
                        ((ncol & 7) << 1);
        n_part = fmaf(__ldg(w + r), __bfloat162float(*reinterpret_cast<
                                        const __nv_bfloat16*>(kb + off)),
                      n_part);
      }
    }
    if (sub == 0) {
      pin(acc);
    } else {  // the previous stage's products are done: free it
      wgmma_wait_one();
      pin(acc);
      mbar_arrive(empty + 8 * ((n - 1) % kStateStages));
    }
    if (sub == kChunk / kTile - 1) {
      wgmma_wait_all();
      pin(acc);
      mbar_arrive(empty + 8 * s);
      // boundary c: the state after chunk c, its hi and lo planes through
      // shared memory (as TMA's 64 x 64 boxes, swizzled) and out by TMA.
      // Fragment: acc[4 q + 2 r + e] is row 16 warp + g + 8 r, column
      // 8 q + 2 t + e of the warpgroup's 64 x T part
      if (issuer) bulk_wait_read();  // the last boundary's planes have left
      bar_sync(1 + cw, 128);
#pragma unroll
      for (int q = 0; q < T / 8; ++q) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + g + 8 * r;
          const float a = acc[4 * q + 2 * r], bb = acc[4 * q + 2 * r + 1];
          unsigned char* at = out_g + (q >> 3) * kBoxBytes + row * kRowBytes +
                              (((q & 7) ^ (row & 7)) << 4) + 4 * t;
          *reinterpret_cast<uint32_t*>(at) = pack_f32(a, bb);
          *reinterpret_cast<uint32_t*>(at + L::kTileBytes) =
              pack_f32(rest(a), rest(bb));
        }
      }
      fence_proxy_async();
      bar_sync(1 + cw, 128);
      if (issuer) {
        for (int pl = 0; pl < 2; ++pl)
          for (int x = 0; x < L::kBoxes; ++x)
            tma_store(&tc, out_s + pl * L::kTileBytes + x * kBoxBytes,
                      j0 + x * kBox, i0 + 64 * cw, 2 * c + pl, bh);
        bulk_commit();
      }
      if (norms) {
        const float sum = n_part + __shfl_xor_sync(0xffffffffu, n_part, 16);
        n_part = 0.f;
        n_state = fmaf(n_state, f, sum);
        if (nhalf == 0) {
          __nv_bfloat16* nrow = nstore + (int64_t(bh) * nb + c) * 2 * dp +
                                i0 + 64 * cw + ncol;
          nrow[0] = __float2bfloat16_rn(n_state);
          nrow[dp] = __float2bfloat16_rn(rest(n_state));
        }
      }
    }
  }
  if (issuer) bulk_wait();  // shared memory outlives the stores
}

// ---- pass 3: the outputs.  One block a (128 query rows of one chunk, b,
// h, dv tile of NV = min(D, 256) columns); warpgroup 0 loads by TMA,
// warpgroups 1 and 2 own 64 rows each.  Q (128 x D) and the boundary's n
// (as an 8-row K-major tile, rows hi and lo, the rest zero-filled) are
// loaded once; then through a ring of two slabs: C_hi and C_lo in 64-row
// dk slices (O = Q C_hi + Q C_lo, q . n by one m64n8 product), then per
// key tile of 64 up to the diagonal K (in slabs of 256 dk columns) and V.
// S = Q K^T in float32; P = S . D in registers (D = exp2(g2_s - M2_t),
// the causal select on the diagonal tile); its row sums feed the
// denominator; O += P_hi V, then O += P_lo V, P's fragments the register
// A operand.  O = decay (Q C) + P V; h = O / max(|row sum + decay q . n|,
// exp(-m)), rounded to bf16 once.
constexpr int kOutRows = 128;
constexpr int kOutThreads = 384;   // producer warpgroup + 2 consumer ones
constexpr int kConsumers = 256;    // arrivals that free a slab
constexpr int kOutStages = 2;

template <int D>
struct OutLayout {
  static constexpr int kNV = D < 256 ? D : 256;  // dv columns; dk a K slab
  static constexpr int kQ = 0;
  static constexpr int kN = kQ + kOutRows * D * 2;
  static constexpr int kRing = kN + 8 * D * 2;
  static constexpr int kSlab = kTile * kNV * 2;
  static constexpr int kBar = kRing + kOutStages * kSlab;
  // q, full[kOutStages], empty[kOutStages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kOutStages);
  static constexpr int kLaunchBytes = kBytes + 1024;  // room to align
  static_assert(kLaunchBytes <= 232448, "more than a block's shared memory");
};

template <int D>
__global__ void __launch_bounds__(kOutThreads, 1)
mlstm_chunk_outputs(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tc,
                    const __grid_constant__ CUtensorMap tn,
                    const MlstmParams p) {
  using L = OutLayout<D>;
  constexpr int NV = L::kNV;
  constexpr int kKSlabs = D / NV;  // K slabs a key tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ, n_s = base + L::kN;
  const uint32_t ring = base + L::kRing;
  const uint32_t bar_q = base + L::kBar, full = bar_q + 8;
  const uint32_t empty = full + 8 * kOutStages;  // + 8 * stage each

  // the dv tiles of a row tile are neighbours in the grid (they read the
  // same Q and K), then the row tiles of a chunk (the same boundary state)
  const int r0 = blockIdx.x / (D / NV) * kOutRows;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int dv0 = blockIdx.x % (D / NV) * NV;
  const int c = r0 / kChunk;
  const int sp = chunks(p.seqlen) * kChunk;
  const int jt0 = c * kChunk / kTile;  // the chunk's first key tile
  const int jt1 = (min(r0 + kOutRows, p.seqlen) - 1) / kTile;
  const int slices = c > 0 ? D / kTile : 0;  // C's dk slices

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kOutStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kOutRows * D * 2 + (c > 0 ? 8 * D * 2 : 0));
      for (int x = 0; x < D / kBox; ++x)
        tma_load(q_s + x * kOutRows * kRowBytes, &tq, bar_q, x * kBox, h, r0,
                 b);
      if (c > 0)
        for (int x = 0; x < D / kBox; ++x)
          tma_load(n_s + x * 8 * kRowBytes, &tn, bar_q, x * kBox, 0, c - 1,
                   bh);
      int n = 0;
      // the consumers freed this slab's stage; its boxes go there
      auto slab = [&](int bytes) {
        const int s = n % kOutStages;
        mbar_wait(empty + 8 * s, ((n / kOutStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, bytes);
        ++n;
        return s;
      };
      for (int sl = 0; sl < slices; ++sl)
        for (int pl = 0; pl < 2; ++pl) {
          const int s = slab(kTile * NV * 2);
          for (int x = 0; x < NV / kBox; ++x)
            tma_load(ring + s * L::kSlab + x * kBoxBytes, &tc, full + 8 * s,
                     dv0 + x * kBox, sl * kTile, 2 * (c - 1) + pl, bh);
        }
      for (int j = jt0; j <= jt1; ++j) {
        for (int kh = 0; kh < kKSlabs; ++kh) {
          const int s = slab(kTile * NV * 2);
          for (int x = 0; x < NV / kBox; ++x)
            tma_load(ring + s * L::kSlab + x * kBoxBytes, &tk, full + 8 * s,
                     kh * NV + x * kBox, h, j * kTile, b);
        }
        const int s = slab(kTile * NV * 2);
        for (int x = 0; x < NV / kBox; ++x)
          tma_load(ring + s * L::kSlab + x * kBoxBytes, &tv, full + 8 * s,
                   dv0 + x * kBox, h, j * kTile, b);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows [q0w, q0w + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x - 128, cw = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int q0w = r0 + 64 * cw;
    const bool active = q0w < p.seqlen;  // rows past S are never stored
    const int jw1 = active ? (min(q0w + 64, p.seqlen) - 1) / kTile : -1;
    // this thread's rows of every fragment: row0 and row0 + 8
    const int row0 = q0w + 16 * warp + g;
    const float* G = p.gates + int64_t(bh) * kPlanes * sp;
    float m2[2], dec[2], low[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m2[r] = G[kM2 * sp + row0 + 8 * r];
      dec[r] = G[kDecay * sp + row0 + 8 * r];
      low[r] = G[kLow * sp + row0 + 8 * r];
    }
    const float* g2 = G + kG2 * sp;
    const uint32_t q_wg = q_s + cw * 64 * kRowBytes;
    constexpr uint32_t kQBox = kOutRows * kRowBytes;

    // O fragment: o[4 q + 2 r + e] is row row0 + 8 r, column 8 q + 2 t + e
    float o[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[i] = 0.f;
    float s[kTile / 2];
    float rsum[2] = {0.f, 0.f}, qn[2] = {0.f, 0.f};
    int n = 0;
    mbar_wait(bar_q, 0);

    if (c > 0) {
      if (active) {  // q . n_hi + q . n_lo: columns 0 and 1 of Q [n_hi n_lo]
        float nd[4] = {0.f, 0.f, 0.f, 0.f};
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n8(nd, kmajor(q_wg, kk, kQBox),
                      kmajor(n_s, kk, 8 * kRowBytes), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        pin(nd);
        const int src = lane & ~3;  // the quad's thread with columns 0, 1
        qn[0] = __shfl_sync(0xffffffffu, nd[0] + nd[1], src);
        qn[1] = __shfl_sync(0xffffffffu, nd[2] + nd[3], src);
      }
      for (int sl = 0; sl < slices; ++sl) {
        for (int pl = 0; pl < 2; ++pl, ++n) {
          const int st = n % kOutStages;
          mbar_wait(full + 8 * st, (n / kOutStages) & 1);
          if (active) {
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kTile / 16; ++kk)
              wgmma_qc<NV>(o, kmajor(q_wg, 4 * sl + kk, kQBox),
                           mnmajor(ring + st * L::kSlab, kk));
            wgmma_commit();
            wgmma_wait_all();
            pin(o);
          }
          mbar_arrive(empty + 8 * st);
        }
      }
#pragma unroll
      for (int i = 0; i < NV / 2; ++i) o[i] *= dec[(i >> 1) & 1];
      qn[0] *= dec[0];
      qn[1] *= dec[1];
    }

    for (int j = jt0; j <= jt1; ++j) {
      const bool need = j <= jw1;
      // S = Q K^T: s[i] is row row0 + 8 ((i >> 1) & 1), key
      // 8 (i >> 2) + 2 t + (i & 1) of the tile
      for (int kh = 0; kh < kKSlabs; ++kh, ++n) {
        const int st = n % kOutStages;
        mbar_wait(full + 8 * st, (n / kOutStages) & 1);
        if (need) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < NV / 16; ++kk)
            wgmma_ss_n64(s, kmajor(q_wg, kh * (NV / 16) + kk, kQBox),
                         kmajor(ring + st * L::kSlab, kk, kBoxBytes),
                         kh > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait_all();
          pin(s);
        }
        mbar_arrive(empty + 8 * st);
      }
      const int st = n % kOutStages;
      if (need) {
        const int k0 = j * kTile;
        const bool diag = k0 + kTile - 1 > q0w;  // some key past some row
#pragma unroll
        for (int x = 0; x < kTile / 8; ++x) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * x + 2 * t + e;
            const float gk = g2[key];  // -inf past S: D = 0
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * x + 2 * r + e;
              const float pv = s[i] * exp2f(gk - m2[r]);
              s[i] = (diag && key > row0 + 8 * r) ? 0.f : pv;
              rsum[r] += s[i];
            }
          }
        }
        // O += P_hi V, then O += P_lo V: the S fragments of keys
        // [16 kk, 16 kk + 16) are the A fragment of k-step kk
        uint32_t a[kTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[kk][e] = pack_f32(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        mbar_wait(full + 8 * st, (n / kOutStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          wgmma_pv<NV>(o, a[kk], mnmajor(ring + st * L::kSlab, kk));
        wgmma_commit();
        wgmma_wait_all();
        pin(o);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[kk][e] = pack_f32(rest(s[8 * kk + 2 * e]),
                                rest(s[8 * kk + 2 * e + 1]));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          wgmma_pv<NV>(o, a[kk], mnmajor(ring + st * L::kSlab, kk));
        wgmma_commit();
        wgmma_wait_all();
        pin(o);
      } else {
        mbar_wait(full + 8 * st, (n / kOutStages) & 1);  // pass it on
      }
      mbar_arrive(empty + 8 * st);
      ++n;
    }

    uint16_t* og = static_cast<uint16_t*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      const float den = fmaxf(fabsf(quad_sum(rsum[r]) + qn[r]), low[r]);
      if (!active || qpos >= p.seqlen) continue;
      uint16_t* orow = og + int64_t(qpos) * p.o_ss + dv0 + 2 * t;
#pragma unroll
      for (int q = 0; q < NV / 8; ++q) {
        if (dv0 + q * 8 < p.head_dim)
          *reinterpret_cast<uint32_t*>(orow + q * 8) =
              pack_f32(o[4 * q + 2 * r] / den, o[4 * q + 2 * r + 1] / den);
      }
    }
  }
}

}  // namespace bf16

// Codes past cudaError_t's: the tensor maps could not be made.
constexpr int kErrNoEncoder = 100000;  // no cuTensorMapEncodeTiled
constexpr int kErrEncode = 100001;     // it refused a tensor

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime: no link against
// libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D bf16 tensor map: sizes innermost first, the strides of the outer
// three in elements, boxes of 64 columns by box1 x box2 elements,
// 128-byte swizzle; elements past any end read as zero.
int make_map(CUtensorMap* map, const void* ptr, const int64_t (&dims)[4],
             const int64_t (&strides)[3], int box1, int box2) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t gdims[4] = {cuuint64_t(dims[0]), cuuint64_t(dims[1]),
                               cuuint64_t(dims[2]), cuuint64_t(dims[3])};
  const cuuint64_t gstrides[3] = {cuuint64_t(strides[0]) * 2,
                                  cuuint64_t(strides[1]) * 2,
                                  cuuint64_t(strides[2]) * 2};
  const cuuint32_t box[4] = {cuuint32_t(bf16::kBox), cuuint32_t(box1),
                             cuuint32_t(box2), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdims,
      gstrides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// q, k or v, (B, S, H, dh) through its strides, as a map over (dh, H, S,
// B) with boxes of `rows` rows.  A dimension of size 1 is never stepped,
// so it gets the stride a contiguous tensor would have (torch gives such
// a dimension any stride).
int qkv_map(CUtensorMap* map, const void* ptr, int64_t sb, int64_t ss,
            int64_t sh, const MlstmParams& p, int rows) {
  const int64_t dims[4] = {p.head_dim, p.heads, p.seqlen, p.batch};
  const int64_t given[3] = {sh, ss, sb};
  int64_t strides[3], nested = p.head_dim;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? nested : given[i];
    nested = strides[i] * dims[i + 1];
  }
  return make_map(map, ptr, dims, strides, 1, rows);
}

template <int D>
int launch_outputs(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const CUtensorMap& tc,
                   const CUtensorMap& tn, const MlstmParams& p,
                   cudaStream_t stream) {
  using namespace bf16;
  const int smem = OutLayout<D>::kLaunchBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_chunk_outputs<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return int(attr);
  const int row_tiles = (p.seqlen + kOutRows - 1) / kOutRows;
  const dim3 grid(row_tiles * (D / OutLayout<D>::kNV), p.batch * p.heads);
  mlstm_chunk_outputs<D>
      <<<grid, kOutThreads, smem, stream>>>(tq, tk, tv, tc, tn, p);
  return int(cudaGetLastError());
}

template <int T>
int launch_states(const CUtensorMap& tk, const CUtensorMap& tv,
                  const CUtensorMap& tc, const MlstmParams& p,
                  cudaStream_t stream) {
  using namespace bf16;
  using L = StateLayout<T>;
  const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_chunk_states<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kLaunchBytes);
  if (attr != cudaSuccess) return int(attr);
  const int tiles = pad64(p.head_dim) / T;
  const dim3 grid(tiles * tiles, p.batch * p.heads);
  mlstm_chunk_states<T>
      <<<grid, L::kThreads, L::kLaunchBytes, stream>>>(tk, tv, tc, p);
  return int(cudaGetLastError());
}

// Pass 0 (gates), 1 (states) or 2 (outputs) on `stream`; each reads what
// the passes before it wrote.
int launch_pass(const MlstmParams& p, int pass, cudaStream_t stream) {
  using namespace bf16;
  const int bh = p.batch * p.heads, dp = pad64(p.head_dim);
  const int nb = chunks(p.seqlen) - 1;
  if (pass == 0) {
    mlstm_chunk_gates<<<bh, kChunk, 0, stream>>>(p);
    return int(cudaGetLastError());
  }
  if (pass == 1 && nb == 0) return 0;  // one chunk: no boundary state
  CUtensorMap tq, tk, tv, tc, tn;
  int err = qkv_map(&tk, p.k, p.k_sb, p.k_ss, p.k_sh, p, kTile);
  if (err == 0) err = qkv_map(&tv, p.v, p.v_sb, p.v_ss, p.v_sh, p, kTile);
  if (err != 0) return err;
  if (nb > 0) {
    // states (bh, nb, 2, dp, dp) and norms (bh, nb, 2, dp), contiguous;
    // n's map reads 8 rows of which the 6 past its two are zero-filled
    const int64_t cdims[4] = {dp, dp, 2 * nb, bh};
    const int64_t cstrides[3] = {dp, int64_t(dp) * dp,
                                 int64_t(2) * nb * dp * dp};
    err = make_map(&tc, p.states, cdims, cstrides, kTile, 1);
    const int64_t ndims[4] = {dp, 2, nb, bh};
    const int64_t nstrides[3] = {dp, 2 * dp, int64_t(2) * nb * dp};
    if (err == 0) err = make_map(&tn, p.norms, ndims, nstrides, 8, 1);
    if (err != 0) return err;
  }
  if (pass == 1)
    return dp == 64 ? launch_states<64>(tk, tv, tc, p, stream)
                    : launch_states<128>(tk, tv, tc, p, stream);
  err = qkv_map(&tq, p.q, p.q_sb, p.q_ss, p.q_sh, p, kOutRows);
  if (err != 0) return err;
  if (nb == 0) {
    tc = tq;  // one chunk: no boundary state, never read
    tn = tq;
  }
  if (dp == 64) return launch_outputs<64>(tq, tk, tv, tc, tn, p, stream);
  if (dp == 128) return launch_outputs<128>(tq, tk, tv, tc, tn, p, stream);
  if (dp == 256) return launch_outputs<256>(tq, tk, tv, tc, tn, p, stream);
  return launch_outputs<512>(tq, tk, tv, tc, tn, p, stream);
}

// What the bf16 passes take (see mlstm_fwd).
bool bf16_ok(const MlstmParams& p) {
  const int dp = bf16::pad64(p.head_dim);
  return p.head_dim % 8 == 0 &&
         (dp == 64 || dp == 128 || dp == 256 || dp == 512) &&
         p.gates != nullptr &&
         (p.seqlen <= bf16::kChunk ||
          (p.states != nullptr && p.norms != nullptr));
}

bool shape_ok(const MlstmParams& p) {
  return p.batch > 0 && p.seqlen > 0 && p.heads > 0 && p.head_dim > 0 &&
         p.head_dim <= kMaxHeadDim && int64_t(p.batch) * p.heads <= 65535;
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (q, k, v and the output); li and lf are
// float32.  All on the current device, in (B, S, H, dh) / (B, S, H) with
// the last dimension of q, k, v and o contiguous.  1 <= dh <= 512.  For
// bfloat16, q, k and v 16-byte aligned with strides of multiples of 8
// elements (TMA's rule), dh a multiple of 8 and padded to 64 a width of
// 64, 128, 256 or 512 (``kernel.py`` pads q, k and v with zero columns
// otherwise), and the workspaces gates (B*H*6*chunks*256 float32),
// states (B*H*(chunks-1)*2*pad64(dh)^2 bf16) and norms (B*H*(chunks-1)*2*
// pad64(dh) bf16), chunks = ceil(S / 256).  Launches on `stream` (the
// float32 kernel, or the three bf16 passes) and does not synchronise.
// Returns the cudaError_t of the launches (0 on success) or one of the
// tensor-map codes above.
extern "C" int mlstm_fwd(const MlstmParams* params, int dtype, void* stream) {
  const MlstmParams p = *params;
  if (!shape_ok(p)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return f32::launch(p, st);
  if (dtype != 1 || !bf16_ok(p)) return int(cudaErrorInvalidValue);
  for (int pass = 0; pass < 3; ++pass) {
    const int err = launch_pass(p, pass, st);
    if (err != 0) return err;
  }
  return 0;
}

// One bf16 pass alone (0 gates, 1 states, 2 outputs), on
// workspaces the passes before it filled: for timing each pass.  As
// mlstm_fwd otherwise.
extern "C" int mlstm_bf16_pass(const MlstmParams* params, int pass,
                               void* stream) {
  const MlstmParams p = *params;
  if (!shape_ok(p) || !bf16_ok(p) || pass < 0 || pass > 2)
    return int(cudaErrorInvalidValue);
  return launch_pass(p, pass, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mlstm_error_string(int err) {
  if (err == kErrNoEncoder)
    return "cuTensorMapEncodeTiled not found through the runtime";
  if (err == kErrEncode)
    return "cuTensorMapEncodeTiled refused a tensor (its strides, "
           "alignment or sizes)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
