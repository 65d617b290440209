// Hand-written Hopper (sm_90a) kernels of the sweep tick's tracing: device
// stamps between the tick's phases and device counters of its work,
// computing what ../ref.py computes on the host. A traced tick launches
// them inside its CUDA graph, so they replay with it and make no host
// sync; an untraced tick never launches them.
//
//   trk_stamp_kernel  <- ref.stamp  (one thread: %globaltimer, the time
//                                    since the previous stamp added to a
//                                    segment's sum, maximum and count)
//   trk_count_kernel  <- ref.count  (on ticks t % stride == 0 only: the
//                                    tick's GCS candidates, admitted
//                                    migrations, active transfers, waiting
//                                    files and queued link transfers a
//                                    lane)
//
// The stamps read %globaltimer, the card's nanosecond clock, which every
// SM sees alike (clock64 is an SM's own). The accumulator is one int64
// buffer: [0] the previous stamp (0: none, so the first stamp after a
// reset books nothing), then (sum, max, count) a segment. Stamps of one
// stream run one after another, so the buffer needs no atomics.
//
// The counter reads the tick index from the state's device counter, which
// the tick has already stepped (the tick that ended is tick[0] - 1), and
// returns at once on a tick it does not count. On a counted tick it
// streams the two flag planes (want_mig, wq_wait: 1 B a file) in 16-byte
// loads and counts their set flags with __popc (a bool is 0 or 1); the
// admitted migrations come from the tick-glue work buffer's n_direct and
// n_queued rows, which tg_migrate has already counted, and the active
// transfers (occ3, exact small floats) and queued link transfers
// (lq_next - lq_serve) from the [L, 3S] counters. Integer sums only: warp
// sums, one shared sum a block, one 64-bit integer atomic a block and
// count, so the counts are the same from run to run.
//
// Plain C entry points, loaded with ctypes: each launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError() so the wrapper
// can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The counts a lane (ref.COUNTS): GCS candidates, admitted migrations,
// active transfers, waiting files, queued link transfers, ticks counted.
constexpr int kCounts = 6;

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void trk_stamp_kernel(long long* acc, int row) {
  const long long now = global_ns();
  const long long prev = acc[0];
  if (prev != 0) {
    long long* r = acc + 1 + 3 * row;
    const long long d = now - prev;
    r[0] += d;
    if (d > r[1]) r[1] = d;
    r[2] += 1;
  }
  acc[0] = now;
}

__device__ __forceinline__ unsigned popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// The block's sum of each thread's `v` (thread 0 holds it).
__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* shared) {
  v = __reduce_add_sync(0xffffffffu, v);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) shared[warp] = v;
  __syncthreads();
  unsigned s = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) s += shared[w];
  }
  return s;
}

// Grid (blocks, L): blockIdx.y the lane, its n = S*F flags of each plane
// split over the blocks; block 0 of a lane also adds the lane's [3S] and
// [S] counters.
__global__ void __launch_bounds__(kThreads)
trk_count_kernel(const long long* tick, long long stride,
                 const uint8_t* want, const uint8_t* wait, long long n,
                 int vec, int S, const float* occ, const int32_t* lq_next,
                 const int32_t* lq_serve, const int32_t* n_direct,
                 const int32_t* n_queued,
                 unsigned long long* counts) {
  if ((tick[0] - 1) % stride != 0) return;
  __shared__ unsigned shared[2][kWarps];
  const long long lane = blockIdx.y;
  const uint8_t* w = want + lane * n;
  const uint8_t* q = wait + lane * n;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  unsigned c_want = 0, c_wait = 0;
  if (vec) {
    const uint4* w4 = reinterpret_cast<const uint4*>(w);
    const uint4* q4 = reinterpret_cast<const uint4*>(q);
    for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x;
         i < n / 16; i += step) {
      c_want += popc4(__ldcs(w4 + i));
      c_wait += popc4(__ldcs(q4 + i));
    }
  } else {
    for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x;
         i < n; i += step) {
      c_want += w[i] != 0;
      c_wait += q[i] != 0;
    }
  }
  const unsigned s_want = block_sum(c_want, shared[0]);
  const unsigned s_wait = block_sum(c_wait, shared[1]);
  unsigned long long* out = counts + lane * kCounts;
  if (threadIdx.x == 0) {
    if (s_want) atomicAdd(out + 0, static_cast<unsigned long long>(s_want));
    if (s_wait) atomicAdd(out + 3, static_cast<unsigned long long>(s_wait));
  }
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  long long mig = 0, active = 0, queued = 0;
  for (int s = 0; s < S; ++s) {
    mig += n_direct[lane * S + s] + n_queued[lane * S + s];
  }
  for (int k = 0; k < 3 * S; ++k) {
    const long long i = lane * 3 * S + k;
    active += __float2ll_rn(occ[i]);
    queued += lq_next[i] - lq_serve[i];
  }
  out[1] += static_cast<unsigned long long>(mig);
  out[2] += static_cast<unsigned long long>(active);
  out[4] += static_cast<unsigned long long>(queued);
  out[5] += 1;
}

}  // namespace

extern "C" {

const char* trk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// acc: int64, 1 + 3 x rows (ref.acc_size); row < rows. One thread.
int trk_stamp(void* acc, int row, void* stream) {
  if (row < 0) return static_cast<int>(cudaErrorInvalidValue);
  trk_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(acc), row);
  return static_cast<int>(cudaGetLastError());
}

// tick [1] int64 (stepped already); want and wait [L, S, F] bool; occ
// [L, 3S] f32; lq_next and lq_serve [L, 3S] int32; n_direct and n_queued
// [L*S] int32 (tg_migrate's counts of this tick); counts [L, 6] int64,
// added to. `blocks` blocks a lane.
int trk_count(const void* tick, long long stride, const void* want,
              const void* wait, int L, int S, long long F, int blocks,
              const void* occ, const void* lq_next, const void* lq_serve,
              const void* n_direct, const void* n_queued, void* counts,
              void* stream) {
  if (L < 0 || S < 1 || F < 0 || blocks < 1 || stride < 1 || L > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return static_cast<int>(cudaSuccess);
  const long long n = static_cast<long long>(S) * F;
  const int vec = n % 16 == 0 && aligned(want, 16) && aligned(wait, 16);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(L));
  trk_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(tick), stride,
      static_cast<const uint8_t*>(want), static_cast<const uint8_t*>(wait), n,
      vec, S, static_cast<const float*>(occ),
      static_cast<const int32_t*>(lq_next),
      static_cast<const int32_t*>(lq_serve),
      static_cast<const int32_t*>(n_direct),
      static_cast<const int32_t*>(n_queued),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
