// RG-LRU linear-recurrence scan for Hopper, sm_90a (K4).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru_scan/kernel.py::rglru_scan_pallas
// (body _rglru_kernel) and computes the same function:
//   h_t = exp(log_a_t) * h_{t-1} + b_t,   h_{-1} = h0,
// over (B, S, W), elementwise in W, with a float32 carry.  log_a and b are
// float32 or bfloat16 (each on its own), widened to float32 on load; h0 is
// float32 (B, W); the output takes log_a's dtype, rounded once per element
// (the Pallas kernel's out_shape).  The step is a product and then a sum,
// each rounded (__fmul_rn, __fadd_rn: the plain version's order, no FMA
// contraction), with expf (not the fast __expf).  Any S >= 1 and any W: the
// Pallas kernel's S % block_t == 0 and W % block_w == 0 are not needed.
//
// Layout: log_a, b and h are (B, S, W) and h0 (B, W), read and written
// through their batch and time strides in elements; the width dimension is
// contiguous.
//
// Bound on the H100: bytes.  The function reads log_a and b once and
// writes h once (12 B an element in float32) and does 3 flops an element
// (exp, multiply, add): at the serving path's shape (6, 2048, 2560) in
// float32 that is 3.77e8 B, 0.113 ms at 3.35 TB/s, against 9.4e7 flops.
//
// Design, simple first.  The TPU kernel walks (batch, width tile) blocks
// with the time tiles as a sequential grid axis and the carry in VMEM;
// here one thread owns one (b, w) channel and loops over all of S, the
// carry in a register, so nothing crosses blocks.  Channels are flattened
// (b * W + w) so neighbouring threads read neighbouring addresses of one
// time row (coalesced) and any W fills whole warps except at the end.
// The loads do not depend on h: each thread keeps a tile of kT time steps
// of log_a and b in registers and issues the next tile's loads before it
// runs the current tile's serial steps (the Pallas block_t idea, double
// buffered), so 2 * kT loads a thread are in flight while it computes.
// What bounds this design: at the serving shape there are only B * W =
// 15,360 channels, 120 blocks of 128 threads for 132 SMs (four warps an
// SM), so the bytes in flight, not the rate, set its speed; a chunked scan
// across time (a first pass of per-chunk products, a carry pass, a fix-up
// pass) would put more threads on the card and is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct RglruParams {
  const void* log_a;
  const void* b;
  const float* h0;
  void* h;
  int64_t la_sb, la_ss;  // strides in elements: batch, time
  int64_t b_sb, b_ss;
  int64_t h0_sb;
  int64_t h_sb, h_ss;
  int32_t batch, seqlen, width;
};

namespace {

constexpr int kThreads = 128;
constexpr int kT = 32;  // time steps a thread holds in registers per tile

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

template <typename TA, typename TB>
__device__ __forceinline__ void load_tile(const TA* la, const TB* bb,
                                          int64_t la_ss, int64_t b_ss,
                                          int t0, int seqlen, float (&las)[kT],
                                          float (&bs)[kT]) {
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int t = t0 + i;
    las[i] = t < seqlen ? load_f(la + int64_t(t) * la_ss) : 0.f;
    bs[i] = t < seqlen ? load_f(bb + int64_t(t) * b_ss) : 0.f;
  }
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_fwd(const RglruParams p) {
  const int64_t c = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= int64_t(p.batch) * p.width) return;
  const int64_t bi = c / p.width;
  const int64_t w = c - bi * p.width;
  const TA* la = static_cast<const TA*>(p.log_a) + bi * p.la_sb + w;
  const TB* bb = static_cast<const TB*>(p.b) + bi * p.b_sb + w;
  TA* out = static_cast<TA*>(p.h) + bi * p.h_sb + w;
  float h = p.h0[bi * p.h0_sb + w];

  float la_cur[kT], b_cur[kT], la_nxt[kT], b_nxt[kT];
  load_tile(la, bb, p.la_ss, p.b_ss, 0, p.seqlen, la_cur, b_cur);
  for (int t0 = 0; t0 < p.seqlen; t0 += kT) {
    if (t0 + kT < p.seqlen)  // the next tile's loads, ahead of the steps
      load_tile(la, bb, p.la_ss, p.b_ss, t0 + kT, p.seqlen, la_nxt, b_nxt);
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      if (t0 + i < p.seqlen) {
        h = __fadd_rn(__fmul_rn(expf(la_cur[i]), h), b_cur[i]);
        store_f(out + int64_t(t0 + i) * p.h_ss, h);
      }
    }
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      la_cur[i] = la_nxt[i];
      b_cur[i] = b_nxt[i];
    }
  }
}

template <typename TA, typename TB>
int launch(const RglruParams& p, cudaStream_t stream) {
  const int64_t channels = int64_t(p.batch) * p.width;
  const int64_t blocks = (channels + kThreads - 1) / kThreads;
  rglru_scan_fwd<TA, TB><<<unsigned(blocks), kThreads, 0, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// la_dtype, b_dtype: 0 float32, 1 bfloat16 (log_a and b; the output takes
// log_a's); h0 is float32.  All on the current device, (B, S, W) and
// (B, W) with the last dimension contiguous; S >= 1, W >= 1.  Launches on
// `stream` and does not synchronise.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int rglru_fwd(const RglruParams* params, int la_dtype,
                         int b_dtype, void* stream) {
  const RglruParams p = *params;
  if (p.batch <= 0 || p.seqlen <= 0 || p.width <= 0 ||
      (int64_t(p.batch) * p.width + kThreads - 1) / kThreads > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (la_dtype == 0 && b_dtype == 0) return launch<float, float>(p, st);
  if (la_dtype == 0 && b_dtype == 1)
    return launch<float, __nv_bfloat16>(p, st);
  if (la_dtype == 1 && b_dtype == 0)
    return launch<__nv_bfloat16, float>(p, st);
  if (la_dtype == 1 && b_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, st);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* rglru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
