// Fused quantize-dequantize (fake quantization) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/quantize/kernel.py::quantize_dequantize_pallas
// (body _qdq_kernel).  Per row r of an (R, n) float32 operand:
//   out = clip(floor(x * inv + u), -qmax, qmax) * scale[r],
//   inv = 1 / scale[r]  (0 when scale[r] is not > 0).
// R is 1 for one tensor and U (the clients) under FedSim, where each
// client's tensor has its own absmax scale.  The scale reduction and the
// stochastic-rounding uniforms u stay outside the kernel, as they stay
// outside pallas_call on the JAX side.
//
// Bound on the H100: memory.  Each element reads x and u and writes out,
// 12 bytes, for 5 flops: far below the card's float32 ridge.  So the
// kernel is one streaming pass that keeps nothing and reads nothing
// twice: each thread moves 16 bytes of each array (one float4),
// neighbouring threads on neighbouring addresses.  A row tail that is not
// a multiple of 4, or a row that starts off a 16-byte boundary (n not a
// multiple of 4), takes a masked scalar path.
//
// Bit-exactness with the plain PyTorch version and the JAX reference: the
// multiply and the add are separate round-to-nearest operations
// (__fmul_rn, __fadd_rn), so nvcc cannot contract them into one FMA; the
// reciprocal is the correctly rounded __frcp_rn (1/s in IEEE); the clamp
// keeps NaN, as torch.clamp and jnp.clip do.  Never build with
// --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float qdq1(float x, float u, float s, float inv,
                                      float qmax) {
  float q = floorf(__fadd_rn(__fmul_rn(x, inv), u));
  q = q < -qmax ? -qmax : (q > qmax ? qmax : q);
  return __fmul_rn(q, s);
}

__global__ void __launch_bounds__(kThreads)
qdq_f32_kernel(const float* __restrict__ x, const float* __restrict__ u,
               const float* __restrict__ scale, float* __restrict__ out,
               int64_t n, int64_t groups_per_row, int64_t total_groups,
               float qmax) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= total_groups) return;
  const int64_t row = g / groups_per_row;
  const int64_t col = (g - row * groups_per_row) * 4;
  const float s = scale[row];
  const float inv = s > 0.f ? __frcp_rn(s) : 0.f;
  const int64_t off = row * n + col;
  const float* xp = x + off;
  const float* up = u + off;
  float* op = out + off;
  const uintptr_t align = reinterpret_cast<uintptr_t>(xp) |
                          reinterpret_cast<uintptr_t>(up) |
                          reinterpret_cast<uintptr_t>(op);
  if (col + 4 <= n && (align & 15) == 0) {
    // streaming loads and store: every byte is touched exactly once
    const float4 xv = __ldcs(reinterpret_cast<const float4*>(xp));
    const float4 uv = __ldcs(reinterpret_cast<const float4*>(up));
    float4 ov;
    ov.x = qdq1(xv.x, uv.x, s, inv, qmax);
    ov.y = qdq1(xv.y, uv.y, s, inv, qmax);
    ov.z = qdq1(xv.z, uv.z, s, inv, qmax);
    ov.w = qdq1(xv.w, uv.w, s, inv, qmax);
    __stcs(reinterpret_cast<float4*>(op), ov);
  } else {
    const int64_t m = n - col < 4 ? n - col : 4;
    for (int64_t i = 0; i < m; ++i) op[i] = qdq1(xp[i], up[i], s, inv, qmax);
  }
}

}  // namespace

// x, u, out: contiguous (rows, n) float32 on the current device; scale:
// (rows,) float32.  Launches on `stream` and does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int qdq_f32(const void* x, const void* u, const void* scale,
                       void* out, int64_t rows, int64_t n, float qmax,
                       void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int64_t groups_per_row = (n + 3) / 4;
  const int64_t total = rows * groups_per_row;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  qdq_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(scale), static_cast<float*>(out), n,
      groups_per_row, total, qmax);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qdq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
