// Hand-written Hopper (sm_90a) Mamba-1 selective scan:
//   h_t = dA_t * h_{t-1} + dBu_t,   y_t = sum_n C_{t,n} * h_{t,n}.
//
// Replaces the Pallas kernel _scan_kernel / mamba_scan_pallas of
// src/repro/kernels/mamba_scan/mamba_scan.py:29 (:52) and computes what
// ../ref.py computes:
//
//   ms_scan -> ms_kernel
//
// With a final-state pointer it also writes h_T [B, D, N], the state after
// the last step, which prefill keeps as the SSM cache (repro's ssm_scan_y,
// src/repro/models/ssm.py:94).
//
// On the TPU a sequential grid of 256-step time chunks carries h in VMEM
// scratch from one chunk to the next. Here one thread owns one state
// (b, d, n) and walks all of T itself, the carry in a register: no chunk
// boundary, no padding. The N states of one (b, d) are G = next power of
// two >= N neighbouring lanes of a warp (N <= 32), so y_t is a shuffle
// reduction inside the group, and lane n = 0 writes it. For each t the
// lanes of a warp read 32 neighbouring floats of dA and of dBu (128 bytes),
// so the loads are coalesced; each thread fetches kUnroll steps ahead
// before it computes them, which keeps enough bytes in flight to cover the
// memory latency. The recurrence rounds like the plain version's separate
// multiply and add (__fmul_rn, __fadd_rn); only the order of the sum over
// n differs.
//
// Bound on this card: bytes. dA and dBu are read once (8 bytes per state
// and step), C and y are small beside them, and 4 flops per state and step
// are far below the card's ratio of operations to bytes: device-memory
// bandwidth (3.35 TB/s on an H100 SXM) is the limit, about 0.66 ms at
// falcon_mamba_7b's widths (B = 1, T = 2048, D = 8192, N = 16).
//
// Plain C entry point, loaded with ctypes: launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kMaxState = 32;

__global__ void __launch_bounds__(kThreads)
ms_kernel(const float* __restrict__ dA, const float* __restrict__ dBu,
          const float* __restrict__ C, float* __restrict__ y,
          float* __restrict__ h_final, int T, int D, int N, long long BD,
          int log2g) {
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int G = 1 << log2g;
  const int n = static_cast<int>(gid & (G - 1));
  const long long bd = gid >> log2g;
  // Lanes past the last state still take part in the shuffles, with 0.
  const bool live = bd < BD && n < N;
  const long long b = live ? bd / D : 0;
  const long long d = live ? bd % D : 0;
  const long long step = static_cast<long long>(D) * N;  // t -> t + 1
  const long long base = (b * T * D + d) * N + n;
  const float* pc = C + b * T * N + n;
  float* py = y + b * T * D + d;
  const bool writer = live && n == 0;
  float h = 0.0f;
  for (int t0 = 0; t0 < T; t0 += kUnroll) {
    float a[kUnroll], u[kUnroll], c[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const bool in = live && t0 + k < T;
      const long long off = base + static_cast<long long>(t0 + k) * step;
      a[k] = in ? dA[off] : 0.0f;
      u[k] = in ? dBu[off] : 0.0f;
      c[k] = in ? pc[static_cast<long long>(t0 + k) * N] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (t0 + k >= T) break;  // uniform across the warp
      h = __fadd_rn(__fmul_rn(a[k], h), u[k]);
      float yv = c[k] * h;
      for (int off = G >> 1; off > 0; off >>= 1)
        yv += __shfl_xor_sync(0xffffffffu, yv, off, G);
      if (writer) py[static_cast<long long>(t0 + k) * D] = yv;
    }
  }
  if (h_final != nullptr && live) h_final[bd * N + n] = h;
}

}  // namespace

extern "C" {

int ms_max_state() { return kMaxState; }

const char* ms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dA, dBu: f32 [B, T, D, N]; C: f32 [B, T, N]; y: f32 [B, T, D]; all
// contiguous; 1 <= N <= 32. h_final: f32 [B, D, N], the state after step
// T - 1, or null to write none.
int ms_scan(const void* dA, const void* dBu, const void* C, void* y, int B,
            int T, int D, int N, void* h_final, void* stream) {
  if (N < 1 || N > kMaxState) return static_cast<int>(cudaErrorInvalidValue);
  int log2g = 0;
  while ((1 << log2g) < N) ++log2g;
  const long long BD = static_cast<long long>(B) * D;
  const long long threads = BD << log2g;
  if (threads > 0 && T > 0) {
    const long long blocks = (threads + kThreads - 1) / kThreads;
    ms_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dA), static_cast<const float*>(dBu),
        static_cast<const float*>(C), static_cast<float*>(y),
        static_cast<float*>(h_final), T, D, N, BD, log2g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
