// Hand-written Hopper (sm_90a) kernels of the batched sweep tick.
//
// They replace the three Pallas kernels of src/repro/kernels/lane_tick/
// lane_tick.py and compute what the plain PyTorch versions in ../ref.py
// compute, with the lane axis explicit ([L, S, F] planes, row r = l*S + s):
//
//   lt_transfer_tick  <- transfer_kernel / transfer_tick   (lane_tick.py:81, :134)
//   lt_gcs_admit      <- gcs_admit_pass_kernel / gcs_admit (lane_tick.py:194, :235)
//   lt_window_admit   <- window_kernel / window_admit      (lane_tick.py:292, :318)
//
// On the TPU the site grid ran in order and carried sums from one step to
// the next. Here blocks run in parallel and in no order, so every sum that
// crosses blocks is a fixed-order two-stage reduction (per-block partials,
// then a finalize pass), counts use integer atomics only, and no float
// atomicAdd appears: a result is the same from run to run.
//
// Bound on this card: all three move bytes and do a handful of operations
// per byte, far below the card's ratio of operations to bytes, so each is
// bound by device-memory bandwidth (3.35 TB/s on an H100 SXM). What the
// designs do about it is stated above each kernel.
//
// Plain C entry points, loaded with ctypes (route (b) of the build): each
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;

// Fixed-order block reduction: warp shuffle tree, then warp 0 reduces the
// warp sums. The order depends only on blockDim, so the result is
// reproducible. Valid in thread 0. Every thread of the block must call it.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[32];
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & (kWarp - 1);
  const int wid = threadIdx.x / kWarp;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  const int nw = blockDim.x / kWarp;
  v = (static_cast<int>(threadIdx.x) < nw) ? warp_sums[threadIdx.x] : T(0);
  if (wid == 0)
    for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // warp_sums may be reused by the next call
  return v;
}

// Fixed-order block exclusive scan of one float per thread. Returns the
// thread's exclusive prefix and writes the block total to *total (every
// thread receives it). Every thread of the block must call it.
__device__ float block_exclusive_scan(float v, float* total) {
  __shared__ float warp_tot[32];
  __shared__ float warp_off[32];
  __shared__ float block_tot;
  const int lane = threadIdx.x & (kWarp - 1);
  const int wid = threadIdx.x / kWarp;
  float incl = v;
  for (int o = 1; o < kWarp; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = __fadd_rn(incl, up);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == kWarp - 1) warp_tot[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int nw = blockDim.x / kWarp;
    const float t = (lane < nw) ? warp_tot[lane] : 0.0f;
    float s = t;
    for (int o = 1; o < kWarp; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s = __fadd_rn(s, up);
    }
    float e = __shfl_up_sync(0xffffffffu, s, 1);
    if (lane == 0) e = 0.0f;
    if (lane < nw) warp_off[lane] = e;
    if (lane == nw - 1) block_tot = s;
  }
  __syncthreads();
  const float out = __fadd_rn(warp_off[wid], excl);
  *total = block_tot;
  __syncthreads();  // shared slots may be reused by the next call
  return out;
}

// ---------------------------------------------------------------------------
// transfer tick
//
// Replaces transfer_kernel (lane_tick.py:81). Per element it reads link id,
// active flag, done, total and size (17 bytes) and writes new_done and the
// completion flag (5 bytes); the per-link-type counts it needs first are a
// reduction over the whole site row. Design: pass 1 counts active
// transfers per (lane, site, link type) with one integer atomic per block
// and type (exact, order-free); pass 2 streams the row once more with
// coalesced loads, advances and classifies, and leaves per-block billing
// partials; pass 3, one block per lane, sums those partials in a fixed
// order. Passes 1 and 2 read link and active twice (5 of 22 bytes): the
// price of blocks that cannot carry counts from one to the next.
// new_done rounds like the plain version's separate ops (__fmul_rn /
// __fadd_rn / __fdiv_rn, no FMA contraction), so it matches bitwise.
// ---------------------------------------------------------------------------

constexpr int kTtThreads = 256;
constexpr int kTtItems = 4;
constexpr int kTtTile = kTtThreads * kTtItems;

__global__ void tt_count_kernel(const int32_t* __restrict__ link,
                                const uint8_t* __restrict__ active,
                                int64_t F, int32_t* __restrict__ counts) {
  const int64_t row = blockIdx.y;
  const int64_t base = row * F;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTtTile;
  int c0 = 0, c1 = 0, c2 = 0;
  for (int i = 0; i < kTtItems; ++i) {
    const int64_t f = start + static_cast<int64_t>(i) * kTtThreads + threadIdx.x;
    if (f < F && active[base + f]) {
      const int t = link[base + f] % 3;
      c0 += (t == 0);
      c1 += (t == 1);
      c2 += (t == 2);
    }
  }
  c0 = block_sum(c0);
  c1 = block_sum(c1);
  c2 = block_sum(c2);
  if (threadIdx.x == 0) {
    if (c0) atomicAdd(&counts[row * 3 + 0], c0);
    if (c1) atomicAdd(&counts[row * 3 + 1], c1);
    if (c2) atomicAdd(&counts[row * 3 + 2], c2);
  }
}

__global__ void tt_advance_kernel(
    const int32_t* __restrict__ link, const uint8_t* __restrict__ active,
    const float* __restrict__ done, const float* __restrict__ total,
    const float* __restrict__ sizes, const float* __restrict__ bw,
    const int32_t* __restrict__ mode, const float* __restrict__ dt_ptr,
    const int32_t* __restrict__ counts, int S, int64_t F,
    float* __restrict__ new_done, uint8_t* __restrict__ comp,
    float* __restrict__ part_bytes, int32_t* __restrict__ part_cnt) {
  const int64_t row = blockIdx.y;
  const int64_t lane_id = row / S;
  const int64_t site = row % S;
  const int64_t base = row * F;
  const int64_t link0 = lane_id * 3 * S + 3 * site;
  float rate[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const float b = bw[link0 + t];
    const float cnt = static_cast<float>(counts[row * 3 + t]);
    const float shared = __fdiv_rn(b, fmaxf(cnt, 1.0f));
    rate[t] = (mode[link0 + t] > 0) ? b : shared;
  }
  const float dt = *dt_ptr;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTtTile;
  float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
  int n1 = 0, n2 = 0;
  for (int i = 0; i < kTtItems; ++i) {
    const int64_t f = start + static_cast<int64_t>(i) * kTtThreads + threadIdx.x;
    if (f >= F) break;
    const int64_t idx = base + f;
    const bool a = active[idx] != 0;
    const int t = link[idx] % 3;
    const float r = (t == 0) ? rate[0] : ((t == 1) ? rate[1] : rate[2]);
    const float tot = total[idx];
    const float step = __fmul_rn(__fmul_rn(a ? 1.0f : 0.0f, r), dt);
    const float nd = fminf(tot, __fadd_rn(done[idx], step));
    const bool c = a && (nd >= tot);
    new_done[idx] = nd;
    comp[idx] = c ? 1 : 0;
    if (c) {
      const float s = sizes[idx];
      if (t == 0) b0 += s;
      else if (t == 1) { b1 += s; n1 += 1; }
      else { b2 += s; n2 += 1; }
    }
  }
  b0 = block_sum(b0);
  b1 = block_sum(b1);
  b2 = block_sum(b2);
  n1 = block_sum(n1);
  n2 = block_sum(n2);
  if (threadIdx.x == 0) {
    const int64_t p = row * gridDim.x + blockIdx.x;
    part_bytes[p * 3 + 0] = b0;
    part_bytes[p * 3 + 1] = b1;
    part_bytes[p * 3 + 2] = b2;
    part_cnt[p * 2 + 0] = n1;
    part_cnt[p * 2 + 1] = n2;
  }
}

// One block per lane: fixed-order sums of the per-block partials into the
// per-site byte totals and the lane's month deltas.
__global__ void tt_finalize_kernel(
    const float* __restrict__ part_bytes, const int32_t* __restrict__ part_cnt,
    int S, int n_tiles, const int32_t* __restrict__ month_ptr, int n_months,
    float* __restrict__ tape, float* __restrict__ recall, float* __restrict__ mig,
    float* __restrict__ egress, float* __restrict__ cls_a,
    float* __restrict__ cls_b) {
  const int64_t lane_id = blockIdx.x;
  float egress_sum = 0.0f;
  int64_t n1_sum = 0, n2_sum = 0;
  for (int s = 0; s < S; ++s) {
    const int64_t row = lane_id * S + s;
    float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
    int n1 = 0, n2 = 0;
    for (int j = threadIdx.x; j < n_tiles; j += blockDim.x) {
      const int64_t p = row * n_tiles + j;
      b0 += part_bytes[p * 3 + 0];
      b1 += part_bytes[p * 3 + 1];
      b2 += part_bytes[p * 3 + 2];
      n1 += part_cnt[p * 2 + 0];
      n2 += part_cnt[p * 2 + 1];
    }
    b0 = block_sum(b0);
    b1 = block_sum(b1);
    b2 = block_sum(b2);
    n1 = block_sum(n1);
    n2 = block_sum(n2);
    if (threadIdx.x == 0) {
      tape[row] = b0;
      recall[row] = b1;
      mig[row] = b2;
      egress_sum += b1;
      n1_sum += n1;
      n2_sum += n2;
    }
  }
  if (threadIdx.x == 0) {
    const int month = *month_ptr;
    for (int m = 0; m < n_months; ++m) {
      const bool on = (m == month);
      egress[lane_id * n_months + m] = on ? egress_sum : 0.0f;
      cls_a[lane_id * n_months + m] = on ? static_cast<float>(n2_sum) : 0.0f;
      cls_b[lane_id * n_months + m] = on ? static_cast<float>(n1_sum) : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// shared-GCS admission
//
// Replaces gcs_admit_pass_kernel (lane_tick.py:194), whose running cumsum
// was carried across the sequential site grid. Per pass, per element:
// the candidate flag, the previous admission and the size in, the
// admission out. Design: a deterministic multi-block scan per lane over
// the site-major S*F vector. The block totals of the first pass come from
// one streaming kernel; each pass then runs a per-lane kernel (exclusive
// scan of the block totals, and the fold of the previous pass's admitted
// bytes into the occupancy) and a streaming gate kernel (local scan plus
// offset, the gate, the admitted-bytes partial and the next pass's block
// totals, all from one read of the tile). Reading the planes once per pass
// is the cost over the bound, which counts one read in total.
// ---------------------------------------------------------------------------

constexpr int kGaThreads = 512;
constexpr int kGaItems = 8;
constexpr int kGaTile = kGaThreads * kGaItems;

// Block totals of sizes*want for the first pass (same scan order as the
// gate kernel, so offsets and local prefixes agree).
__global__ void ga_block_sums_kernel(const uint8_t* __restrict__ want,
                                     const float* __restrict__ sizes, int64_t N,
                                     float* __restrict__ bsum) {
  const int64_t lane_id = blockIdx.y;
  const int64_t base = lane_id * N;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kGaTile +
                        static_cast<int64_t>(threadIdx.x) * kGaItems;
  float s = 0.0f;
  for (int i = 0; i < kGaItems; ++i) {
    const int64_t e = first + i;
    if (e < N && want[base + e]) s = __fadd_rn(s, sizes[base + e]);
  }
  float tot;
  block_exclusive_scan(s, &tot);
  if (threadIdx.x == 0) bsum[lane_id * gridDim.x + blockIdx.x] = tot;
}

// One block per lane. pass > 0 folds the previous pass's admitted bytes
// into the occupancy; final writes the result and the GB-second delta;
// otherwise it writes the exclusive scan of the block totals.
__global__ void ga_lane_kernel(const float* __restrict__ bsum,
                               const float* __restrict__ npart, int n_tiles,
                               int pass, int final_pass,
                               const float* __restrict__ used_in,
                               float* __restrict__ used_cur,
                               float* __restrict__ boff,
                               const float* __restrict__ dt_ptr,
                               const int32_t* __restrict__ month_ptr,
                               int n_months, float* __restrict__ used_out,
                               float* __restrict__ gbsec) {
  const int64_t lane_id = blockIdx.x;
  __shared__ float used_s;
  if (pass == 0) {
    if (threadIdx.x == 0) used_s = used_in[lane_id];
  } else {
    float a = 0.0f;
    for (int j = threadIdx.x; j < n_tiles; j += blockDim.x)
      a += npart[lane_id * n_tiles + j];
    a = block_sum(a);
    if (threadIdx.x == 0) used_s = __fadd_rn(used_cur[lane_id], a);
  }
  __syncthreads();
  const float used = used_s;
  if (final_pass) {
    if (threadIdx.x == 0) {
      used_out[lane_id] = used;
      const float g = __fmul_rn(__fdiv_rn(used, 1e9f), *dt_ptr);
      const int month = *month_ptr;
      for (int m = 0; m < n_months; ++m)
        gbsec[lane_id * n_months + m] = (m == month) ? g : 0.0f;
    }
    return;
  }
  if (threadIdx.x == 0) used_cur[lane_id] = used;
  float carry = 0.0f;
  for (int j0 = 0; j0 < n_tiles; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const float v = (j < n_tiles) ? bsum[lane_id * n_tiles + j] : 0.0f;
    float tot;
    const float e = block_exclusive_scan(v, &tot);
    if (j < n_tiles) boff[lane_id * n_tiles + j] = __fadd_rn(carry, e);
    carry = __fadd_rn(carry, tot);
  }
}

__global__ void ga_gate_kernel(const uint8_t* __restrict__ want,
                               const float* __restrict__ sizes, int64_t N,
                               int pass, const float* __restrict__ limit,
                               const float* __restrict__ used_cur,
                               const float* __restrict__ boff,
                               uint8_t* __restrict__ adm,
                               float* __restrict__ npart,
                               float* __restrict__ bsum_next) {
  const int64_t lane_id = blockIdx.y;
  const int64_t base = lane_id * N;
  const int64_t p = lane_id * gridDim.x + blockIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kGaTile +
                        static_cast<int64_t>(threadIdx.x) * kGaItems;
  float v[kGaItems];
  bool rem[kGaItems];
  bool prev[kGaItems];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kGaItems; ++i) {
    const int64_t e = first + i;
    const bool in = e < N;
    prev[i] = in && pass > 0 && adm[base + e];
    rem[i] = in && want[base + e] && !prev[i];
    v[i] = rem[i] ? sizes[base + e] : 0.0f;
    s = __fadd_rn(s, v[i]);
  }
  float tot;
  const float excl = block_exclusive_scan(s, &tot);
  const float used = used_cur[lane_id];
  const float lim = limit[lane_id];
  float run = __fadd_rn(boff[p], excl);
  float nbytes = 0.0f;
  float s_next = 0.0f;
#pragma unroll
  for (int i = 0; i < kGaItems; ++i) {
    const int64_t e = first + i;
    run = __fadd_rn(run, v[i]);
    const bool nw = rem[i] && (__fadd_rn(used, run) <= lim);
    if (e < N) adm[base + e] = (prev[i] || nw) ? 1 : 0;
    if (nw) nbytes = __fadd_rn(nbytes, v[i]);
    if (rem[i] && !nw) s_next = __fadd_rn(s_next, v[i]);
  }
  nbytes = block_sum(nbytes);
  float tot_next;
  block_exclusive_scan(s_next, &tot_next);
  if (threadIdx.x == 0) {
    npart[p] = nbytes;
    bsum_next[p] = tot_next;
  }
}

// ---------------------------------------------------------------------------
// candidate windows
//
// Replaces window_kernel (lane_tick.py:292). One thread per (lane, site)
// walks its C candidates in order with the plain version's operation
// order ((used + extra) + size, then extra + size), so admission and
// extra bytes match bitwise. It moves C*5 + 12 bytes per row, a few
// hundred bytes per call, so its time is the launch itself; the design
// keeps it to one launch.
// ---------------------------------------------------------------------------

__global__ void wa_kernel(const uint8_t* __restrict__ live,
                          const float* __restrict__ size,
                          const float* __restrict__ used,
                          const float* __restrict__ limit, int64_t R, int C,
                          int fifo, uint8_t* __restrict__ adm,
                          float* __restrict__ extra_out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float u = used[r];
  const float lim = limit[r];
  float extra = 0.0f;
  bool blocked = false;
  for (int k = 0; k < C; ++k) {
    const float s = size[r * C + k];
    const bool lv = live[r * C + k] != 0;
    const bool fit = __fadd_rn(__fadd_rn(u, extra), s) <= lim;
    bool a;
    if (fifo) {
      a = lv && fit && !blocked;
      blocked = blocked || (lv && !fit);
    } else {
      a = lv && fit;
    }
    adm[r * C + k] = a ? 1 : 0;
    extra = __fadd_rn(extra, a ? s : 0.0f);
  }
  extra_out[r] = extra;
}

inline int tiles(int64_t n, int tile) {
  return static_cast<int>((n + tile - 1) / tile);
}

}  // namespace

extern "C" {

int lt_transfer_tiles(long long F) { return tiles(F, kTtTile); }

int lt_gcs_tiles(long long N) { return tiles(N, kGaTile); }

const char* lt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// counts: int32 [L*S*3] scratch; part_bytes: f32 [L*S, tiles, 3];
// part_cnt: int32 [L*S, tiles, 2] (tiles = lt_transfer_tiles(F)).
int lt_transfer_tick(const void* link, const void* active, const void* done,
                     const void* total, const void* sizes, const void* bw,
                     const void* mode, const void* dt, const void* month,
                     int L, int S, long long F, int n_months, void* counts,
                     void* part_bytes, void* part_cnt, void* new_done,
                     void* comp, void* tape, void* recall, void* mig,
                     void* egress, void* cls_a, void* cls_b, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = L * S;
  const int n_tiles = tiles(F, kTtTile);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * rows * 3, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tiles > 0) {
    const dim3 grid(n_tiles, rows);
    tt_count_kernel<<<grid, kTtThreads, 0, st>>>(
        static_cast<const int32_t*>(link), static_cast<const uint8_t*>(active),
        F, static_cast<int32_t*>(counts));
    tt_advance_kernel<<<grid, kTtThreads, 0, st>>>(
        static_cast<const int32_t*>(link), static_cast<const uint8_t*>(active),
        static_cast<const float*>(done), static_cast<const float*>(total),
        static_cast<const float*>(sizes), static_cast<const float*>(bw),
        static_cast<const int32_t*>(mode), static_cast<const float*>(dt),
        static_cast<const int32_t*>(counts), S, F,
        static_cast<float*>(new_done), static_cast<uint8_t*>(comp),
        static_cast<float*>(part_bytes), static_cast<int32_t*>(part_cnt));
  }
  tt_finalize_kernel<<<L, 256, 0, st>>>(
      static_cast<const float*>(part_bytes),
      static_cast<const int32_t*>(part_cnt), S, n_tiles,
      static_cast<const int32_t*>(month), n_months, static_cast<float*>(tape),
      static_cast<float*>(recall), static_cast<float*>(mig),
      static_cast<float*>(egress), static_cast<float*>(cls_a),
      static_cast<float*>(cls_b));
  return static_cast<int>(cudaGetLastError());
}

// N = S*F elements per lane; bsum/boff/npart: f32 [L, tiles] scratch
// (tiles = lt_gcs_tiles(N)); used_cur: f32 [L] scratch; n_passes >= 1.
int lt_gcs_admit(const void* want, const void* sizes, const void* used_in,
                 const void* limit, const void* dt, const void* month, int L,
                 long long N, int n_months, int n_passes, void* bsum,
                 void* boff, void* npart, void* used_cur, void* adm,
                 void* used_out, void* gbsec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = tiles(N, kGaTile);
  const dim3 grid(n_tiles, L);
  const float* dt_f = static_cast<const float*>(dt);
  const int32_t* month_i = static_cast<const int32_t*>(month);
  if (n_tiles > 0)
    ga_block_sums_kernel<<<grid, kGaThreads, 0, st>>>(
        static_cast<const uint8_t*>(want), static_cast<const float*>(sizes), N,
        static_cast<float*>(bsum));
  for (int pass = 0; pass < n_passes; ++pass) {
    ga_lane_kernel<<<L, 1024, 0, st>>>(
        static_cast<const float*>(bsum), static_cast<const float*>(npart),
        n_tiles, pass, 0, static_cast<const float*>(used_in),
        static_cast<float*>(used_cur), static_cast<float*>(boff), dt_f,
        month_i, n_months, static_cast<float*>(used_out),
        static_cast<float*>(gbsec));
    if (n_tiles > 0)
      ga_gate_kernel<<<grid, kGaThreads, 0, st>>>(
          static_cast<const uint8_t*>(want), static_cast<const float*>(sizes),
          N, pass, static_cast<const float*>(limit),
          static_cast<const float*>(used_cur), static_cast<const float*>(boff),
          static_cast<uint8_t*>(adm), static_cast<float*>(npart),
          static_cast<float*>(bsum));
  }
  ga_lane_kernel<<<L, 1024, 0, st>>>(
      static_cast<const float*>(bsum), static_cast<const float*>(npart),
      n_tiles, n_passes, 1, static_cast<const float*>(used_in),
      static_cast<float*>(used_cur), static_cast<float*>(boff), dt_f, month_i,
      n_months, static_cast<float*>(used_out), static_cast<float*>(gbsec));
  return static_cast<int>(cudaGetLastError());
}

// R = L*S rows of C candidates each.
int lt_window_admit(const void* live, const void* size, const void* used,
                    const void* limit, long long R, int C, int fifo, void* adm,
                    void* extra, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const int blocks = tiles(R, threads);
  if (blocks > 0)
    wa_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const uint8_t*>(live), static_cast<const float*>(size),
        static_cast<const float*>(used), static_cast<const float*>(limit), R, C,
        fifo, static_cast<uint8_t*>(adm), static_cast<float*>(extra));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
