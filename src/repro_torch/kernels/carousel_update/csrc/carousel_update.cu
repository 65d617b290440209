// Hand-written Hopper (sm_90a) kernels of the carousel tick, the paper's
// §4.1 transfer-manager update over N transfers on M links.
//
// They replace the two Pallas kernels of src/repro/kernels/carousel_update/
// carousel_update.py and compute what ../ref.py computes:
//
//   cu_count_kernel   <- count_kernel  (carousel_update.py:42)
//   cu_update_kernel  <- update_kernel (carousel_update.py:58)
//   cu_carousel_tick  <- carousel_tick_pallas (carousel_update.py:79)
//
// On the TPU the counts accumulate in one output block across a grid that
// runs in order, and the link lookups are one-hot products on the matrix
// unit. Here blocks run in no order: each block counts its transfers into a
// histogram in shared memory (warp-aggregated: the lanes of a warp that
// share a link add once), then adds its nonzero bins into the global counts
// with integer atomics. Integers make the counts exact and the same from
// run to run; no float atomic appears. The update pass stages the per-link
// rate (bw, or bw over the count) in shared memory once per block and
// advances one transfer per thread, a plain gather from that table.
//
// Bound on this card: per transfer the tick reads link id, active flag,
// done and total and writes new_done and the completion flag, 18 bytes,
// and does a few operations: device-memory bandwidth bounds it (3.35 TB/s
// on an H100 SXM, about 5.4 us at N = 1M), and at that size three launches
// (memset, count, update) cost as much as the bytes. Both passes read link
// and active (5 of 18 bytes twice): the price of blocks that cannot carry
// the counts from one to the next. Both grids are capped at a few blocks
// per SM and stride over the transfers, so the per-block histogram flush
// and rate table stay small beside the transfers.
//
// new_done feeds a >= test against total: the advance rounds like the plain
// version's separate ops (__fmul_rn / __fadd_rn / __fdiv_rn, no FMA
// contraction), so new_done and completed match it bitwise.
//
// Plain C entry point, loaded with ctypes: launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kDefaultSmem = 48 * 1024;  // without cudaFuncSetAttribute
// Links a block's shared table can hold: the 227 KB a Hopper block may use.
constexpr int kMaxLinks = (227 * 1024) / 4;

__global__ void __launch_bounds__(kThreads)
cu_count_kernel(const int32_t* __restrict__ link,
                const uint8_t* __restrict__ active, long long N, int M,
                int32_t* __restrict__ counts) {
  extern __shared__ int32_t hist[];
  for (int m = threadIdx.x; m < M; m += blockDim.x) hist[m] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // the loop bound is uniform across the block, so every lane of a warp
  // takes part in the ballot and the match
  for (long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x;
       i0 < N; i0 += stride) {
    const long long i = i0 + threadIdx.x;
    int l = -1;
    if (i < N && active[i]) l = link[i];
    const bool ok = l >= 0 && l < M;
    const unsigned live = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const unsigned peers = __match_any_sync(live, l);
      if (lane == __ffs(peers) - 1) atomicAdd(&hist[l], __popc(peers));
    }
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x)
    if (hist[m]) atomicAdd(&counts[m], hist[m]);
}

__global__ void __launch_bounds__(kThreads)
cu_update_kernel(const int32_t* __restrict__ link,
                 const uint8_t* __restrict__ active,
                 const float* __restrict__ done,
                 const float* __restrict__ total,
                 const float* __restrict__ bw, const int32_t* __restrict__ mode,
                 const int32_t* __restrict__ counts_i, float dt, long long N,
                 int M, float* __restrict__ new_done,
                 uint8_t* __restrict__ completed,
                 float* __restrict__ counts_f) {
  extern __shared__ float rate[];
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float c = static_cast<float>(counts_i[m]);  // exact below 2^24
    if (blockIdx.x == 0) counts_f[m] = c;
    rate[m] = mode[m] > 0 ? bw[m] : __fdiv_rn(bw[m], fmaxf(c, 1.0f));
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < N; i += stride) {
    const int l = link[i];
    const bool a = active[i] != 0;
    const float r = (l >= 0 && l < M) ? rate[l] : 0.0f;
    const float inc = __fmul_rn(__fmul_rn(a ? 1.0f : 0.0f, r), dt);
    const float tot = total[i];
    const float nd = fminf(tot, __fadd_rn(done[i], inc));
    new_done[i] = nd;
    completed[i] = (nd >= tot) && a;
  }
}

int grid_for(long long n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

extern "C" {

int cu_max_links() { return kMaxLinks; }

const char* cu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// counts_i: int32 [M] scratch; dt: seconds; outputs new_done f32 [N],
// completed bool [N], counts f32 [M].
int cu_carousel_tick(const void* link, const void* active, const void* done,
                     const void* total, const void* bw, const void* mode,
                     float dt, long long N, int M,
                     void* counts_i, void* new_done, void* completed,
                     void* counts_f, void* stream) {
  if (M < 1 || M > kMaxLinks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(int32_t) * static_cast<size_t>(M);
  cudaError_t err;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(cu_count_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(cu_update_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaMemsetAsync(counts_i, 0, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = grid_for(N);
  cu_count_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const int32_t*>(link), static_cast<const uint8_t*>(active),
      N, M, static_cast<int32_t*>(counts_i));
  cu_update_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const int32_t*>(link), static_cast<const uint8_t*>(active),
      static_cast<const float*>(done), static_cast<const float*>(total),
      static_cast<const float*>(bw), static_cast<const int32_t*>(mode),
      static_cast<const int32_t*>(counts_i),
      dt, N, M,
      static_cast<float*>(new_done), static_cast<uint8_t*>(completed),
      static_cast<float*>(counts_f));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
