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
// about 0.3 GB moved, far above the card's ridge.  So the bf16 path is
// built for the tensor cores' full rate, which only wgmma reaches:
//   - one block per (query tile of 128 rows, head, batch), the grid's x
//     reversed so the longest causal rows start first, and a loop over
//     exactly the key tiles of 64 the causal and window masks leave (the
//     reference's structural block skip, as a loop bound);
//   - three warpgroups a block, specialised: warpgroup 0 gives its
//     registers away (setmaxnreg 24) and one of its threads issues TMA
//     loads; warpgroups 1 and 2 (setmaxnreg 240) each own 64 query rows;
//   - TMA: q, k and v are 4-D tensor maps over (d, heads, S, B) with the
//     tensors' own strides, boxes of 64 columns (128 bytes, 128-byte
//     swizzle) by tile rows, four boxes to d = 256.  Q's 128 x d tile is
//     loaded once; K and V tiles go through a ring of two stages, with
//     full barriers (one for K, one for V, counting bytes) and an empty
//     barrier the 256 consumer threads arrive on once the wgmma reading
//     the stage has completed.  TMA's zero fill covers the ragged tail
//     and any d below the template's width (64, 128 or 256); no thread
//     spends an instruction on a copy;
//   - S = Q K^T: wgmma m64n64k16 with both operands in shared memory
//     (K-major descriptors over the swizzled layout TMA wrote), d / 16
//     k-steps into 32 float32 registers a thread.  The softmax runs on
//     those fragments (quad shuffles for the row max and sum); P is
//     rounded to bf16 in registers and is the register A operand of
//     O += P V, wgmma m64n{d}k16 reading V's tile as an MN-major B (no
//     transpose copy).  O is 64 x d float32 a warpgroup, d / 2 registers
//     a thread.  Each shared-memory byte read feeds 64 query rows, and Q
//     never passes through registers;
//   - masks only where they bind: a key tile fully kept for all 64 rows
//     of a warpgroup runs no mask code, only the diagonal, the window's
//     left edge and the ragged tail do; the softcap is one uniform branch
//     outside the element loop.
// Left for later: the ping-pong of the two consumer warpgroups' softmax
// against each other's GEMMs, overlapping a tile's softmax with the next
// tile's QK^T inside a warpgroup, packing a GQA group's query heads into
// one tile, fp8, and a backward kernel.
//
// float32: CUDA cores (FMA) in full float32, since tensor cores would
// round q and k to TF32 (about three decimal digits).  Four threads per
// query row, 32-row by 32-key tiles.
//
// The shared memory of either path is above 48 KB at d = 256, so each
// launch raises the kernel's dynamic shared-memory limit first.  The
// tensor maps are encoded on the host at each launch by the driver's
// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.
#include <cuda.h>
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

constexpr int kBQ = 128;         // query rows a block: 2 warpgroups x 64
constexpr int kBK = 64;          // keys a tile
constexpr int kStages = 2;       // depth of the K/V ring
constexpr int kThreads = 384;    // producer warpgroup + 2 consumer ones
constexpr int kConsumers = 256;  // arrivals that free a stage
constexpr int kBox = 64;         // columns a TMA box: 128 bytes, the swizzle
constexpr int kRowBytes = 128;   // one box row in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-byte aligned base: Q's tile, the K
// and V rings, then the mbarriers.  Box c of a tile of R rows starts at
// c * R * 128; its row r holds columns [64 c, 64 c + 64) of row r, the
// 16-byte chunks swizzled by r % 8 (TMA's 128-byte swizzle).
template <int D>
struct Layout {
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  // q, full_k[kStages], full_v[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages);
  static constexpr int kLaunchBytes = kBytes + 1024;  // room to align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
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

// One box of a 4-D tensor map (coordinates innermost first: column, head,
// row, batch) into shared memory; the barrier counts its bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row),
      "r"(batch), "r"(bar)
      : "memory");
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start
// address, leading and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo) << 16) |
         (uint64_t(sbo) << 32) | (1ull << 62);
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

// D (64 x 64, float32) = A (64 x 16) * B (16 x 64) (+ D when accumulate),
// both from shared memory through descriptors, both K-major
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

// D (64 x 64, float32) += A (64 x 16, registers) * B (16 x 64, shared,
// MN-major)
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

// D (64 x 128, float32) += A (64 x 16, registers) * B (16 x 128, shared,
// MN-major)
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

// D (64 x 256, float32) += A (64 x 16, registers) * B (16 x 256, shared,
// MN-major)
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

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64(o, a, db);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n256(o, a, db);
  }
}

// D: the template's head width (64, 128 or 256); p.head_dim <= D, the
// columns past it zero-filled by TMA and never stored.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const FlashParams p) {
  using L = Layout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * kStages;
  const uint32_t empty = full_v + 8 * kStages;  // + 8 * stage each

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  int jb0, jb1;  // the key tiles any row of the block sees
  key_tiles(p, q0, kBQ, kBK, jb0, jb1);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < D / kBox; ++c)
        tma_load(q_s + c * kBQ * kRowBytes, &tq, bar_q, c * kBox, h, q0, b);
      for (int j = jb0; j <= jb1; ++j) {
        const int n = j - jb0, s = n % kStages;
        // the consumers freed this stage's previous tile
        mbar_wait(empty + 8 * s, ((n / kStages) & 1) ^ 1);
        const uint32_t ks = k_s + s * L::kKVBytes, vs = v_s + s * L::kKVBytes;
        mbar_expect_tx(full_k + 8 * s, L::kKVBytes);
        for (int c = 0; c < D / kBox; ++c)
          tma_load(ks + c * kBK * kRowBytes, &tk, full_k + 8 * s, c * kBox,
                   kvh, j * kBK, b);
        mbar_expect_tx(full_v + 8 * s, L::kKVBytes);
        for (int c = 0; c < D / kBox; ++c)
          tma_load(vs + c * kBK * kRowBytes, &tv, full_v + 8 * s, c * kBox,
                   kvh, j * kBK, b);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows [q0w, q0w + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x - 128, cw = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int q0w = q0 + 64 * cw;
    const bool active = q0w < p.seqlen;  // rows past S are never stored
    int j0 = 0, j1 = -1;                 // this warpgroup's key tiles
    if (active) key_tiles(p, q0w, 64, kBK, j0, j1);
    // this thread's rows of every fragment: row0 and row0 + 8
    const int row0 = q0w + 16 * warp + g;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // S fragment: s[i] is row row0 + 8 ((i >> 1) & 1), key
    // 8 (i >> 2) + 2 t + (i & 1) of the tile
    float s[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
    const uint32_t q_wg = q_s + cw * 64 * kRowBytes;

    mbar_wait(bar_q, 0);
    for (int j = jb0; j <= jb1; ++j) {
      const int n = j - jb0, st = n % kStages;
      const uint32_t par = (n / kStages) & 1;
      const uint32_t ks = k_s + st * L::kKVBytes, vs = v_s + st * L::kKVBytes;
      mbar_wait(full_k + 8 * st, par);
      if (j >= j0 && j <= j1) {
        // S = Q K^T: k-step kk reads columns [16 kk, 16 kk + 16), box
        // kk / 4, 32 bytes into its swizzled rows; 8-row groups 1024
        // bytes apart
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk & 3) * 32;
          wgmma_ss_n64(s,
                       smem_desc(q_wg + (kk >> 2) * kBQ * kRowBytes + col, 1,
                                 64),
                       smem_desc(ks + (kk >> 2) * kBK * kRowBytes + col, 1,
                                 64),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(s);

        const int k0 = j * kBK;
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) s[i] *= p.scale;
        if (p.softcap != 0.f) {
#pragma unroll
          for (int i = 0; i < kBK / 2; ++i)
            s[i] = tanhf(s[i] / p.softcap) * p.softcap;
        }
        // a tile is fully kept for all 64 rows unless it holds keys past
        // S, keys past the first row's diagonal, or keys at or before the
        // last row's window edge
        const bool edge = k0 + kBK > p.seqlen ||
                          (p.causal && k0 + kBK - 1 > q0w) ||
                          (p.window > 0 && k0 <= q0w + 63 - p.window);
        if (edge) {
#pragma unroll
          for (int i = 0; i < kBK / 2; ++i) {
            const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            const int qpos = row0 + 8 * ((i >> 1) & 1);
            bool keep = true;
            if (p.causal) keep = keep && kpos <= qpos;
            if (p.window > 0) keep = keep && kpos > qpos - p.window;
            s[i] = kpos >= p.seqlen ? -INFINITY : (keep ? s[i] : kNegInf);
          }
        }

        // online softmax over rows row0 (r = 0) and row0 + 8 (r = 1)
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float corr[2], m_log2[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
          corr[r] = exp2f((m_r[r] - m_new) * kLog2e);
          m_r[r] = m_new;
          m_log2[r] = m_new * kLog2e;
        }
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          s[i] = exp2f(fmaf(s[i], kLog2e, -m_log2[(i >> 1) & 1]));
          sum[(i >> 1) & 1] += s[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          l_r[r] = l_r[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

        // O += P V: the S fragments of keys [16 kk, 16 kk + 16) are the A
        // fragment of k-step kk; V's rows 16 kk.. start 2048 bytes in,
        // its 64-column boxes 64 rows x 128 bytes apart (MN-major)
        uint32_t a[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          a[kk][0] = pack_f32(s[8 * kk + 0], s[8 * kk + 1]);
          a[kk][1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
          a[kk][2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
          a[kk][3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
        }
        mbar_wait(full_v + 8 * st, par);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_pv<D>(o, a[kk],
                      smem_desc(vs + kk * 16 * kRowBytes,
                                kBK * kRowBytes / 16, 64));
        wgmma_commit();
        wgmma_wait_all();
        pin(o);
      } else {
        mbar_wait(full_v + 8 * st, par);  // the tile is in; pass it on
      }
      mbar_arrive(empty + 8 * st);
    }

    const float den[2] = {fmaxf(l_r[0], 1e-37f), fmaxf(l_r[1], 1e-37f)};
    uint16_t* og = static_cast<uint16_t*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (!active || qpos >= p.seqlen) continue;
      uint16_t* orow = og + int64_t(qpos) * p.o_ss + 2 * t;
      // O fragment: o[4 c + 2 r], o[4 c + 2 r + 1] are columns 8 c + 2 t
      // and + 1 of row row0 + 8 r
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        if (c * 8 < p.head_dim)
          *reinterpret_cast<uint32_t*>(orow + c * 8) =
              pack_f32(o[4 * c + 2 * r] / den[r],
                       o[4 * c + 2 * r + 1] / den[r]);
      }
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

// Codes past cudaError_t's: the tensor maps could not be made.
constexpr int kErrNoEncoder = 100000;  // no cuTensorMapEncodeTiled
constexpr int kErrEncode = 100001;     // it refused the tensor

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's encoder, from the runtime: no link against libcuda.
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

// A bf16 (B, S, heads, d) tensor as a 4-D tensor map over (d, heads, S,
// B), boxes of 64 columns by `rows` rows, 128-byte swizzle; elements past
// any end read as zero.  A dimension of size 1 is never stepped, so it
// gets the stride a contiguous tensor would have (torch gives such a
// dimension any stride).
int make_map(CUtensorMap* map, const void* ptr, int64_t sb, int64_t ss,
             int64_t sh, int heads, const FlashParams& p, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {cuuint64_t(p.head_dim), cuuint64_t(heads),
                              cuuint64_t(p.seqlen), cuuint64_t(p.batch)};
  const int64_t given[3] = {sh, ss, sb};
  cuuint64_t strides[3];
  int64_t nested = p.head_dim;
  for (int i = 0; i < 3; ++i) {
    const int64_t st = dims[i + 1] == 1 ? nested : given[i];
    strides[i] = cuuint64_t(st) * 2;
    nested = st * int64_t(dims[i + 1]);
  }
  const cuuint32_t box[4] = {cuuint32_t(bf16::kBox), 1, cuuint32_t(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int D>
int launch_bf16(const FlashParams& p, cudaStream_t stream) {
  using namespace bf16;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, p.q, p.q_sb, p.q_ss, p.q_sh, p.heads, p, kBQ);
  if (err == 0)
    err = make_map(&tk, p.k, p.k_sb, p.k_ss, p.k_sh, p.kv_heads, p, kBK);
  if (err == 0)
    err = make_map(&tv, p.v, p.v_sb, p.v_ss, p.v_sh, p.kv_heads, p, kBK);
  if (err != 0) return err;
  const int smem = Layout<D>::kLaunchBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((p.seqlen + kBQ - 1) / kBQ, p.heads, p.batch);
  flash_fwd_bf16<D><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return int(cudaGetLastError());
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  q, k, v, o on the current device in
// (B, S, heads, d) with the last dimension contiguous; for bfloat16 the
// pointers 16-byte aligned and the strides multiples of 8 elements (TMA's
// 16-byte rule), and d a multiple of 16.  d <= 256.  Launches on `stream`
// and does not synchronise.  Returns the cudaError_t of the launch (0 on
// success) or one of the tensor-map codes above.
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
    if (d % 16 != 0) return int(cudaErrorInvalidValue);
    if (d <= 64) return launch_bf16<64>(p, st);
    if (d <= 128) return launch_bf16<128>(p, st);
    return launch_bf16<256>(p, st);
  }
  return int(cudaErrorInvalidValue);
}

extern "C" const char* flash_error_string(int err) {
  if (err == kErrNoEncoder)
    return "cuTensorMapEncodeTiled not found through the runtime";
  if (err == kErrEncode)
    return "cuTensorMapEncodeTiled refused a q/k/v tensor (its strides, "
           "alignment or sizes)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
