// Chunkwise-parallel stabilized mLSTM forward for Hopper, sm_90a (K3).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mlstm_chunk/kernel.py::mlstm_chunk_pallas
// (body _mlstm_kernel) and computes the same function.  Per (batch, head)
// it walks the chunks in order, carrying the matrix memory C (dh x dh),
// the normalizer n (dh) and the stabilizer m (NEG_BIG = -1e30 at first).
// Inside a chunk of L rows, with a = cumsum(lf), g = li - a,
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
// The result does not depend on the chunk length up to rounding, so this
// kernel takes chunks of L = 64 rows (the reference: 128), and takes any
// S >= 1: the last chunk is ragged, rows past the end load as zeros and
// get w_s = 0, and are not stored.
//
// q, k, v and the output are read and written in the model's (B, S, H, dh)
// layout through strides (the last dimension contiguous); li and lf are
// float32 (B, S, H), also through strides.  Inputs in float32 or bfloat16
// are widened to float32 on load; everything inside is float32 on CUDA
// cores (FMA; no TF32), and the output is rounded to q's dtype once.
//
// Bound on the H100: bytes, narrowly.  Counted on what the function needs
// at the reference's chunk of 128, each (b, h, chunk) costs 2 L(L+1)/2 dh
// flops each for QK^T and (S.D)V (D is lower-triangular) and 2 * 2 L dh^2
// for QC and K^T V, and nothing for D K (q . n_intra comes from the row
// sums below); at the serving path's shape (B*H = 24 heads of 2048 x 512)
// that is 5.8e10 flops, 0.059 ms at 989 TFLOP/s, against 0.20 GB moved in
// bf16, 0.060 ms at 3.35 TB/s.
// The state does not fit an SM: C is dh x dh float32, 1 MiB at dh = 512,
// against 227 KB of shared memory a block can use (the TPU kernel kept it
// whole in VMEM).  What the design does about it, simply first:
//   - the value dimension is split across blocks: a block owns the v-tile
//     C[:, v0:v0+32] (64 KB at dh = 512) in shared memory, and the grid is
//     (dh / 32 v-tiles, B*H), 384 blocks at the serving shape against 132
//     SMs, two resident on each (about 100 KB of shared memory apiece);
//   - the Pallas grid's sequential chunk axis becomes a loop over the
//     chunks inside the block; the gates' cumsum and cummax run serially
//     in one thread, the order of the reference's scan;
//   - one pass over dh in slices of 32 per chunk: each slice of Q and K
//     (64 x 32, staged in shared memory) feeds QK^T, Q C and q . n, and
//     then the carry update of the same 32 rows of C and n (rows the rest
//     of the pass does not read again), so Q and K are read once a chunk;
//   - every v-tile block recomputes QK^T and n (half of its flops at dh =
//     512); sharing them across the blocks of a head (a cluster, or a
//     first pass) and tensor cores for bf16 are later work.
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
  int64_t q_sb, q_ss, q_sh;  // strides in elements: batch, sequence, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t li_sb, li_ss, li_sh;
  int64_t lf_sb, lf_ss, lf_sh;
  int64_t o_sb, o_ss, o_sh;
  int32_t batch, seqlen, heads, head_dim;
};

namespace {

constexpr int kL = 64;        // chunk rows
constexpr int kVT = 32;       // v-tile width (columns of C a block owns)
constexpr int kDK = 32;       // dh slice staged in shared memory
constexpr int kThreads = 256;
constexpr int kMaxHeadDim = 512;
constexpr float kNegBig = -1e30f;
constexpr int kQKStride = kDK + 1;  // padded rows: conflict-free columns
constexpr int kPStride = kL + 1;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

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

template <typename T>
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
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* lig = p.li + b * p.li_sb + h * p.li_sh;
  const float* lfg = p.lf + b * p.lf_sb + h * p.lf_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

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
                               ? load_f(vg + int64_t(t0 + s) * p.v_ss + col)
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
            ok ? load_f(qg + int64_t(t0 + s) * p.q_ss + col) : 0.f;
        Ks[s * kQKStride + lane] =
            ok ? load_f(kg + int64_t(t0 + s) * p.k_ss + col) : 0.f;
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
          store_f(og + int64_t(t0 + t) * p.o_ss + col,
                  (pacc[i][j] + oacc[i][j] * decs[t]) / dens[t]);
      }
    }
    __syncthreads();  // the next chunk overwrites the gates, V and P
  }
}

template <typename T>
int launch(const MlstmParams& p, cudaStream_t stream) {
  const size_t smem = size_t(smem_floats(p.head_dim)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.head_dim + kVT - 1) / kVT, p.batch * p.heads);
  mlstm_chunk_fwd<T><<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (q, k, v and the output); li and lf are
// float32.  All on the current device, in (B, S, H, dh) / (B, S, H) with
// the last dimension of q, k, v and o contiguous.  1 <= dh <= 512.
// Launches on `stream` and does not synchronise.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int mlstm_fwd(const MlstmParams* params, int dtype, void* stream) {
  const MlstmParams p = *params;
  if (p.batch <= 0 || p.seqlen <= 0 || p.heads <= 0 || p.head_dim <= 0 ||
      p.head_dim > kMaxHeadDim || int64_t(p.batch) * p.heads > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* mlstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
