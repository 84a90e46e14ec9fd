// Flash attention forward for Hopper, sm_90a (K2).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_hmajor
// (body _attn_kernel) and computes the same function:
//   logits = (q * scale) . k^T in float32, scale = 1/sqrt(d);
//   optional softcap tanh(s / c) * c;
//   causal mask kpos <= qpos and window mask kpos > qpos - window, applied
//   as the finite NEG_INF = -2^30 (not -inf: a row whose first computed
//   tile is fully masked gets m = -2^30 and p = 1, and the tile holding
//   its diagonal wipes that out with corr = exp(-2^30 - m) = 0; with -inf
//   that would be exp(-inf - -inf) = NaN);
//   online softmax with float32 m, l and acc, denominator max(l, 1e-37);
//   GQA through kv head h / (H / KVH), with no copy of k or v;
//   output in q's dtype.
// q, k, v and o are read and written in the model's (B, S, heads, d)
// layout through strides (the last dimension contiguous), so the
// reference's head-major swapaxes copies are not needed.  S need not be a
// multiple of a tile: keys past the end are left out (p = 0 exactly) and
// rows past the end are not stored.
//
// Bound on the H100: operations.  Each unmasked (q, k) pair costs 4 d
// flops (QK^T and PV); at the serving path's shape (B*H = 96 heads of
// 2048 x 256, bf16) that is 2.06e11 flops for a global layer against
// about 0.3 GB moved, far above the card's ridge.  What the design does
// about it, simply first:
//   - one block per (batch, head, query tile), the grid's x reversed so
//     the longest causal rows start first; a loop inside the block over
//     exactly the key tiles the causal and window masks leave (the
//     reference's structural block skip, as a loop bound);
//   - bfloat16: tensor cores through mma.sync m16n8k16 (bf16 in, float32
//     accumulate).  Four warps each own 16 query rows of a 64-row tile;
//     the logits stay in registers and become the A operand of the PV
//     product directly (probabilities rounded to bf16 there, as flash
//     attention does; l sums the float32 values).  Tiles of 64 keys,
//     shared-memory rows padded by 16 bytes so ldmatrix reads hit 32
//     distinct banks; every fragment comes from one ldmatrix (.trans for
//     V), four registers an instruction.  Copies go through cp.async,
//     staged so that V's tile lands while QK^T runs and the next K tile
//     while PV runs (one buffer each: two blocks of 101 KB fit an SM).
//     No TMA or wgmma yet;
//   - float32: CUDA cores (FMA) in full float32, since tensor cores would
//     round q and k to TF32 (about three decimal digits).  Four threads
//     per query row, 32-row by 32-key tiles.
// The shared memory of either path is above 48 KB at d = 256, so each
// launch raises the kernel's dynamic shared-memory limit first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_ss, q_sh;  // strides in elements: batch, sequence, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int32_t batch, seqlen, heads, kv_heads, head_dim;
  int32_t causal, window;  // window 0: no window
  float softcap;           // 0: no softcap
  float scale;             // float32(1 / sqrt(d))
};

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's NEG_INF

// The key tiles [j0, j1] that hold any key some row of the query tile
// starting at q0 may see.
__device__ __forceinline__ void key_tiles(const FlashParams& p, int q0, int bq,
                                          int bk, int& j0, int& j1) {
  const int q_last = min(q0 + bq, p.seqlen) - 1;
  j1 = (p.causal ? q_last : p.seqlen - 1) / bk;
  j0 = 0;
  if (p.window > 0) {
    const int first = q0 - p.window + 1;
    if (first > 0) j0 = first / bk;
  }
}

__device__ __forceinline__ float mask_logit(const FlashParams& p, float s,
                                            int qpos, int kpos) {
  if (kpos >= p.seqlen) return -INFINITY;  // no such key: p = 0 exactly
  if (p.softcap != 0.f) s = tanhf(s / p.softcap) * p.softcap;
  bool keep = true;
  if (p.causal) keep = keep && kpos <= qpos;
  if (p.window > 0) keep = keep && kpos > qpos - p.window;
  return keep ? s : kNegInf;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- float32
namespace f32 {

constexpr int kBQ = 32, kBK = 32, kThreads = 128;

__host__ __device__ constexpr size_t smem_floats(int d, int dmax) {
  return size_t(kBQ) * (d + 1) + size_t(kBK) * (d + 1) + size_t(kBK) * dmax +
         size_t(kBQ) * (kBK + 1);
}

// Thread (r, qd) = (tid / 4, tid % 4) owns query row r of the tile: the
// logits of keys qd + 4i and the output columns qd + 4jj.
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const FlashParams p) {
  extern __shared__ float smem[];
  const int d = p.head_dim;
  const int ldq = d + 1, ldk = d + 1, ldp = kBK + 1;  // odd: no bank conflicts
  float* q_s = smem;              // kBQ x ldq, holds q * scale
  float* k_s = q_s + kBQ * ldq;   // kBK x ldk
  float* v_s = k_s + kBK * ldk;   // kBK x DMAX, columns >= d stay 0
  float* p_s = v_s + kBK * DMAX;  // kBQ x ldp, this tile's probabilities

  const int tid = threadIdx.x, r = tid >> 2, qd = tid & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int row = i / d, c = i - row * d, s = q0 + row;
    // q scaled in float32 before the product, as the reference does
    q_s[row * ldq + c] =
        s < p.seqlen ? qg[int64_t(s) * p.q_ss + c] * p.scale : 0.f;
  }
  for (int i = tid; i < kBK * (DMAX - d); i += kThreads) {
    const int row = i / (DMAX - d);
    v_s[row * DMAX + d + (i - row * (DMAX - d))] = 0.f;
  }

  float acc[DMAX / 4];
#pragma unroll
  for (int jj = 0; jj < DMAX / 4; ++jj) acc[jj] = 0.f;
  float m_row = kNegInf, l_row = 0.f;  // the same in the row's four threads
  const int qpos = q0 + r;
  int j0, j1;
  key_tiles(p, q0, kBQ, kBK, j0, j1);

  for (int j = j0; j <= j1; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the last tile's k_s, v_s and p_s are read
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int row = i / d, c = i - row * d, s = k0 + row;
      const bool ok = s < p.seqlen;
      k_s[row * ldk + c] = ok ? kg[int64_t(s) * p.k_ss + c] : 0.f;
      v_s[row * DMAX + c] = ok ? vg[int64_t(s) * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[kBK / 4];
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) s[i] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float qv = q_s[r * ldq + c];
#pragma unroll
      for (int i = 0; i < kBK / 4; ++i)
        s[i] = fmaf(qv, k_s[(qd + 4 * i) * ldk + c], s[i]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      s[i] = mask_logit(p, s[i], qpos, k0 + qd + 4 * i);
      mx = fmaxf(mx, s[i]);
    }
    const float m_new = fmaxf(m_row, quad_max(mx));
    const float corr = expf(m_row - m_new);
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      const float e = expf(s[i] - m_new);
      ps += e;
      p_s[r * ldp + qd + 4 * i] = e;
    }
    l_row = l_row * corr + quad_sum(ps);
    m_row = m_new;
    __syncwarp();  // the row's probabilities come from its own quad
#pragma unroll
    for (int jj = 0; jj < DMAX / 4; ++jj) acc[jj] *= corr;
    for (int kk = 0; kk < kBK; ++kk) {
      const float pv = p_s[r * ldp + kk];
      const float* vrow = v_s + kk * DMAX + qd;
#pragma unroll
      for (int jj = 0; jj < DMAX / 4; ++jj)
        acc[jj] = fmaf(pv, vrow[4 * jj], acc[jj]);
    }
  }

  if (qpos < p.seqlen) {
    const float denom = fmaxf(l_row, 1e-37f);
    float* orow = og + int64_t(qpos) * p.o_ss;
#pragma unroll
    for (int jj = 0; jj < DMAX / 4; ++jj) {
      const int c = qd + 4 * jj;
      if (c < d) orow[c] = acc[jj] / denom;
    }
  }
}

}  // namespace f32

// --------------------------------------------------------------- bfloat16
namespace bf16 {

constexpr int kBQ = 64, kBK = 64, kThreads = 128;  // 4 warps x 16 rows

__host__ __device__ constexpr size_t smem_bytes(int d) {
  return size_t(kBQ + 2 * kBK) * (d + 8) * sizeof(uint16_t);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix
// m, and register m of lane 4g + t holds row g, columns 2t and 2t+1 of
// matrix m (of its transpose with .trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// 16 bytes global -> shared without registers; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// D += A (16x16, row) * B (16x8, col), bf16 in, float32 accumulate.
// Fragments (lane = 4 g + t): A {row g, g+8} x {col 2t, 2t+1, 2t+8, 2t+9};
// B {row 2t, 2t+1, 2t+8, 2t+9} x col g; C/D {row g, g+8} x {col 2t, 2t+1}.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start copying rows [row0, row0 + rows) of a (seq, d) slice at `src`
// (row stride `ss` elements) into shared memory with row stride `ld`, 16
// bytes per copy; rows past the end are zero.  The caller commits.
__device__ __forceinline__ void load_tile_async(uint16_t* dst,
                                                const uint16_t* src,
                                                int64_t ss, int row0,
                                                int rows, int seqlen, int d,
                                                int ld) {
  const int vecs = d / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int row = i / vecs, c = (i - row * vecs) * 8, s = row0 + row;
    const bool ok = s < seqlen;
    cp_async16(dst + row * ld + c, ok ? src + int64_t(s) * ss + c : src,
               ok ? 16 : 0);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(const FlashParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.head_dim;
  const int ld = d + 8;  // 16-byte rows; ldmatrix rows hit distinct banks
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* k_s = q_s + kBQ * ld;
  uint16_t* v_s = k_s + kBK * ld;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const uint16_t* qg =
      static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const uint16_t* kg =
      static_cast<const uint16_t*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const uint16_t* vg =
      static_cast<const uint16_t*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  uint16_t* og = static_cast<uint16_t*>(p.o) + b * p.o_sb + h * p.o_sh;

  int j0, j1;
  key_tiles(p, q0, kBQ, kBK, j0, j1);
  load_tile_async(q_s, qg, p.q_ss, q0, kBQ, p.seqlen, d, ld);
  load_tile_async(k_s, kg, p.k_ss, j0 * kBK, kBK, p.seqlen, d, ld);
  cp_async_commit();

  float o_acc[DMAX / 8][4];
#pragma unroll
  for (int nd = 0; nd < DMAX / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[nd][e] = 0.f;
  // rows g and g + 8 of this warp's 16; the same in the row's four lanes
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int qrow = q0 + warp * 16 + g;
  // this lane's ldmatrix row addresses (see ldmatrix_x4): A of Q rows
  // lane % 16, column half lane / 16; B of K keys 8 (lane / 16) + lane % 8,
  // column half (lane / 8) % 2; B of V^T keys 8 ((lane / 8) % 2) +
  // lane % 8, column block lane / 16
  const uint16_t* qa = q_s + (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
  const uint16_t* kb =
      k_s + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
  const uint16_t* vb =
      v_s + (((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8;

  for (int j = j0; j <= j1; ++j) {
    const int k0 = j * kBK;
    cp_async_wait_all();
    __syncthreads();  // K_j is in; every warp is done with V_{j-1}
    load_tile_async(v_s, vg, p.v_ss, k0, kBK, p.seqlen, d, ld);
    cp_async_commit();  // V_j lands while QK^T runs

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 < d) {
        uint32_t a[4];
        ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
        for (int np = 0; np < kBK / 16; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kb + np * 16 * ld + kk * 16);
          mma(s[2 * np], a, bk[0], bk[1]);
          mma(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }

    // scale, softcap, mask; online softmax over rows g (i=0), g+8 (i=1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = mask_logit(p, s[nt][e] * p.scale, qrow + 8 * (e >> 1), kpos);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_r[i], quad_max(mx[i]));
      corr[i] = __expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = __expf(s[nt][e] - m_r[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + quad_sum(sum[i]);
#pragma unroll
    for (int nd = 0; nd < DMAX / 8; ++nd) {
      o_acc[nd][0] *= corr[0];
      o_acc[nd][1] *= corr[0];
      o_acc[nd][2] *= corr[1];
      o_acc[nd][3] *= corr[1];
    }

    cp_async_wait_all();
    __syncthreads();  // V_j is in; every warp is done with K_j
    if (j < j1) {
      load_tile_async(k_s, kg, p.k_ss, k0 + kBK, kBK, p.seqlen, d, ld);
      cp_async_commit();  // K_{j+1} lands while PV runs
    }

    // O += P V: the logits' C fragments of n-tiles 2kk, 2kk+1 are the A
    // fragment of keys [16 kk, 16 kk + 16)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                             pack_f32(s[2 * kk][2], s[2 * kk][3]),
                             pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DMAX / 16; ++dp) {
        if (dp * 16 < d) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vb + kk * 16 * ld + dp * 16);
          mma(o_acc[2 * dp], a, bv[0], bv[1]);
          mma(o_acc[2 * dp + 1], a, bv[2], bv[3]);
        }
      }
    }
  }

  const float den[2] = {fmaxf(l_r[0], 1e-37f), fmaxf(l_r[1], 1e-37f)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qrow + 8 * i;
    if (qpos >= p.seqlen) continue;
    uint16_t* orow = og + int64_t(qpos) * p.o_ss + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DMAX / 8; ++nd) {
      if (nd * 8 < d)
        *reinterpret_cast<uint32_t*>(orow + nd * 8) =
            pack_f32(o_acc[nd][2 * i] / den[i], o_acc[nd][2 * i + 1] / den[i]);
    }
  }
}

}  // namespace bf16

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           const FlashParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, threads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  q, k, v, o on the current device in
// (B, S, heads, d) with the last dimension contiguous; for bfloat16 the
// pointers 16-byte aligned and the strides multiples of 8 elements, and d
// a multiple of 16.  d <= 256.  Launches on `stream` and does not
// synchronise.  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_fwd(const FlashParams* params, int dtype, void* stream) {
  const FlashParams p = *params;
  if (p.batch <= 0 || p.seqlen <= 0 || p.heads <= 0) return 0;
  const int d = p.head_dim;
  if (p.kv_heads <= 0 || p.heads % p.kv_heads != 0 || d <= 0 || d > 256 ||
      p.window < 0 || p.batch > 65535 || p.heads > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using namespace f32;
    const dim3 grid((p.seqlen + kBQ - 1) / kBQ, p.heads, p.batch);
    if (d <= 64)
      return launch(flash_fwd_f32<64>, grid, kThreads,
                    smem_floats(d, 64) * sizeof(float), p, st);
    if (d <= 128)
      return launch(flash_fwd_f32<128>, grid, kThreads,
                    smem_floats(d, 128) * sizeof(float), p, st);
    return launch(flash_fwd_f32<256>, grid, kThreads,
                  smem_floats(d, 256) * sizeof(float), p, st);
  }
  if (dtype == 1) {
    using namespace bf16;
    if (d % 16 != 0) return int(cudaErrorInvalidValue);
    const dim3 grid((p.seqlen + kBQ - 1) / kBQ, p.heads, p.batch);
    if (d <= 64)
      return launch(flash_fwd_bf16<64>, grid, kThreads, smem_bytes(d), p, st);
    if (d <= 128)
      return launch(flash_fwd_bf16<128>, grid, kThreads, smem_bytes(d), p, st);
    return launch(flash_fwd_bf16<256>, grid, kThreads, smem_bytes(d), p, st);
  }
  return int(cudaErrorInvalidValue);
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
