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
// The tick engine (ops.simulate_ticks, repro's ops.py:50 simulate_ticks)
// runs one launch a tick, cu_engine_tick_kernel, over state it keeps on the
// card: done and active advanced in place, the per-link counts carried
// from tick to tick instead of recounted. Only a link's completions change
// its count between two ticks, so count(t) = count(t-1) - completions of
// tick t-1 by link, exact in integers; the engine's first tick counts from
// scratch (cu_engine_count: the memset and cu_count_kernel above). One
// launch then reads link, active, done and total once: it builds the rate
// table from the carried count, advances done, clears active where the
// transfer completed, and adds the completions into completions[t] (a
// block sum, then one integer atomic) and into the link's completion
// histogram (warp-aggregated into shared memory, then integer atomics).
//
// A block cannot read counts that other blocks of the same launch are
// still changing. Of a second one-block kernel that applies the histogram
// and buffers rotated by the tick, this takes the buffers, which keep the
// tick at one launch: counts C[2][M] and histograms D[3][M]. Launch t
// reads C[(t+1)%2] (the count of tick t-1) and D[(t+2)%3] (its
// completions), both finished by launch t-1; every block forms count(t)
// from them; block 0 stores it in C[t%2] and zeroes D[(t+1)%3], which
// launch t+1 accumulates into and no block of launch t touches; the blocks
// accumulate tick t's completions into D[t%3]. The tick index comes from
// device counters, not an argument, so a CUDA graph of a few ticks replays
// like fresh launches: block b of every launch reads and steps its own
// counter, ticks[b] (launches on one stream do not overlap, and the grid,
// cu_engine_blocks, depends on N alone), so every block of launch t reads
// t. One counter that every block stepped with an atomic cost 0.3-0.5 us a
// tick on an H100 at N = 1M (528 atomics on one address). No float atomic
// appears; the rates are the plain version's to the bit.
//
// Bound of an engine tick: the same 18 bytes a transfer as the tick above
// (link id, active, done and total read once; done and active written in
// place), 5.4 us at N = 1M on an H100 SXM. The 18 MB of state fit the
// 50 MB L2, so a steady run of ticks can read below that bound. Each
// thread takes four consecutive transfers with 16-byte loads (the engine
// owns or checks the alignment) and stores done only where it changed.
// Where the rate table and the histogram do not fit one block's shared
// memory together (M above 29,054) the histogram goes straight to
// D[t%3] with the same warp-aggregated integer atomics.
//
// Plain C entry points, loaded with ctypes: launch on the caller's stream,
// allocate nothing, return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kDefaultSmem = 48 * 1024;  // without cudaFuncSetAttribute
constexpr int kSmemBytes = 227 * 1024;  // what a Hopper block may use
// Links a block's shared table can hold.
constexpr int kMaxLinks = kSmemBytes / 4;
// The engine tick's shared memory: the launch's tick and completion count
// (kEngineHead bytes), the rate table, and the histogram where it fits.
constexpr int kEngineHead = 16;
constexpr int kEngineMaxLinks = (kSmemBytes - kEngineHead) / 4;

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

// Warp-aggregated add of one completion per lane that has `ok` on link l
// (every lane of the warp calls it).
__device__ __forceinline__ void add_completion(int* hist, bool ok, int l,
                                               int lane) {
  const unsigned live = __ballot_sync(0xffffffffu, ok);
  if (ok) {
    const unsigned peers = __match_any_sync(live, l);
    if (lane == __ffs(peers) - 1) atomicAdd(&hist[l], __popc(peers));
  }
}

// One engine tick; see the note at the top. counts: int32 [2][M], hist:
// int32 [3][M], completions: int32 [n_ticks], ticks: a counter per block.
__global__ void __launch_bounds__(kThreads)
cu_engine_tick_kernel(const int32_t* __restrict__ link,
                      uint8_t* __restrict__ active, float* __restrict__ done,
                      const float* __restrict__ total,
                      const float* __restrict__ bw,
                      const int32_t* __restrict__ mode, float dt,
                      long long N, int M, long long n_ticks,
                      int32_t* __restrict__ counts, int32_t* __restrict__ hist,
                      int32_t* __restrict__ completions,
                      long long* __restrict__ ticks, bool smem_hist) {
  extern __shared__ long long smem[];  // see kEngineHead
  long long& s_tick = smem[0];
  int& s_done = reinterpret_cast<int*>(smem)[2];
  float* rate = reinterpret_cast<float*>(smem) + kEngineHead / 4;  // [M]
  if (threadIdx.x == 0) {
    s_tick = ticks[blockIdx.x];
    ticks[blockIdx.x] = s_tick + 1;
    s_done = 0;
  }
  __syncthreads();
  const long long t = s_tick;
  const int32_t* c_prev = counts + ((t + 1) & 1) * M;
  const int32_t* d_prev = hist + ((t + 2) % 3) * M;
  int32_t* c_cur = counts + (t & 1) * M;
  int32_t* d_next = hist + ((t + 1) % 3) * M;
  int* bins = smem_hist ? reinterpret_cast<int*>(rate + M)
                        : hist + (t % 3) * M;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int32_t c = c_prev[m] - d_prev[m];
    if (blockIdx.x == 0) {
      c_cur[m] = c;
      d_next[m] = 0;
    }
    rate[m] = mode[m] > 0
                  ? bw[m]
                  : __fdiv_rn(bw[m], fmaxf(static_cast<float>(c), 1.0f));
    if (smem_hist) bins[m] = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  int n_comp = 0;
  const long long stride = 4LL * gridDim.x * blockDim.x;
  // uniform loop bound: every lane of a warp reaches the ballots
  for (long long i0 = 4LL * blockIdx.x * blockDim.x; i0 < N; i0 += stride) {
    const long long i = i0 + 4LL * threadIdx.x;
    int l[4] = {-1, -1, -1, -1};
    bool comp[4] = {false, false, false, false};
    if (i + 3 < N) {
      const int4 l4 = *reinterpret_cast<const int4*>(link + i);
      const uchar4 a4 = *reinterpret_cast<const uchar4*>(active + i);
      const float4 d4 = *reinterpret_cast<const float4*>(done + i);
      const float4 t4 = *reinterpret_cast<const float4*>(total + i);
      const int li[4] = {l4.x, l4.y, l4.z, l4.w};
      const bool ai[4] = {a4.x != 0, a4.y != 0, a4.z != 0, a4.w != 0};
      const float di[4] = {d4.x, d4.y, d4.z, d4.w};
      const float ti[4] = {t4.x, t4.y, t4.z, t4.w};
      float nd[4];
      bool changed = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float r = (li[j] >= 0 && li[j] < M) ? rate[li[j]] : 0.0f;
        const float inc = __fmul_rn(__fmul_rn(ai[j] ? 1.0f : 0.0f, r), dt);
        nd[j] = fminf(ti[j], __fadd_rn(di[j], inc));
        changed |= __float_as_uint(nd[j]) != __float_as_uint(di[j]);
        comp[j] = (nd[j] >= ti[j]) && ai[j];
        l[j] = li[j];
      }
      if (changed)
        *reinterpret_cast<float4*>(done + i) =
            make_float4(nd[0], nd[1], nd[2], nd[3]);
      if (comp[0] | comp[1] | comp[2] | comp[3])
        *reinterpret_cast<uchar4*>(active + i) =
            make_uchar4(ai[0] && !comp[0], ai[1] && !comp[1],
                        ai[2] && !comp[2], ai[3] && !comp[3]);
    } else {
      for (int j = 0; j < 4 && i + j < N; ++j) {
        const int lj = link[i + j];
        const bool a = active[i + j] != 0;
        const float r = (lj >= 0 && lj < M) ? rate[lj] : 0.0f;
        const float inc = __fmul_rn(__fmul_rn(a ? 1.0f : 0.0f, r), dt);
        const float d = done[i + j];
        const float tot = total[i + j];
        const float nd = fminf(tot, __fadd_rn(d, inc));
        if (__float_as_uint(nd) != __float_as_uint(d)) done[i + j] = nd;
        comp[j] = (nd >= tot) && a;
        if (comp[j]) active[i + j] = 0;
        l[j] = lj;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = comp[j] && l[j] >= 0 && l[j] < M;
      n_comp += comp[j];
      add_completion(bins, ok, l[j], lane);
    }
  }
  // the block's completions: a warp sum, one shared add per warp, one
  // global add per block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    n_comp += __shfl_xor_sync(0xffffffffu, n_comp, off);
  if (lane == 0 && n_comp) atomicAdd(&s_done, n_comp);
  __syncthreads();
  if (smem_hist) {
    int32_t* d_cur = hist + (t % 3) * M;
    for (int m = threadIdx.x; m < M; m += blockDim.x)
      if (bins[m]) atomicAdd(&d_cur[m], bins[m]);
  }
  if (threadIdx.x == 0 && s_done && t < n_ticks)
    atomicAdd(&completions[t], s_done);
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

int cu_engine_max_links() { return kEngineMaxLinks; }

// Blocks of an engine tick over N transfers: the length of its ticks.
int cu_engine_blocks(long long N) { return grid_for((N + 3) / 4); }

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

// The engine's first tick counts from scratch: counts_out int32 [M] (the
// slot C[1] that launch 0 reads) = active transfers per link.
int cu_engine_count(const void* link, const void* active, long long N, int M,
                    void* counts_out, void* stream) {
  if (M < 1 || M > kMaxLinks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(int32_t) * static_cast<size_t>(M);
  cudaError_t err;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(cu_count_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaMemsetAsync(counts_out, 0, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  cu_count_kernel<<<grid_for(N), kThreads, smem, st>>>(
      static_cast<const int32_t*>(link), static_cast<const uint8_t*>(active),
      N, M, static_cast<int32_t*>(counts_out));
  return static_cast<int>(cudaGetLastError());
}

// One engine tick, in place on active (bool [N]) and done (f32 [N]);
// counts int32 [2][M], hist int32 [3][M] (zero before the first tick but
// C[1], the first count), completions int32 [n_ticks] (zero before the
// first tick), ticks int64 [cu_engine_blocks(N)] (zero before the first
// tick). link and total must be 16-byte aligned, active 4-byte aligned.
int cu_engine_tick(const void* link, void* active, void* done,
                   const void* total, const void* bw, const void* mode,
                   float dt, long long N, int M, long long n_ticks,
                   void* counts, void* hist, void* completions, void* ticks,
                   void* stream) {
  if (M < 1 || M > kEngineMaxLinks)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool smem_hist = 2 * M <= kEngineMaxLinks;
  const size_t smem = kEngineHead + sizeof(float) *
                                        static_cast<size_t>(M) *
                                        (smem_hist ? 2 : 1);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        cu_engine_tick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cu_engine_tick_kernel<<<cu_engine_blocks(N), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(link), static_cast<uint8_t*>(active),
      static_cast<float*>(done), static_cast<const float*>(total),
      static_cast<const float*>(bw), static_cast<const int32_t*>(mode), dt,
      N, M, n_ticks, static_cast<int32_t*>(counts),
      static_cast<int32_t*>(hist), static_cast<int32_t*>(completions),
      static_cast<long long*>(ticks), smem_hist);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
