// Hand-written Hopper (sm_90a) kernels of the batched sweep tick.
//
// They replace the three Pallas kernels of src/repro/kernels/lane_tick/
// lane_tick.py and compute what the plain PyTorch versions in ../ref.py
// compute, with the lane axis explicit ([L, S, F] planes, row r = l*S + s):
//
//   lt_transfer_tick  <- transfer_kernel / transfer_tick   (lane_tick.py:81, :134)
//   lt_gcs_admit      <- gcs_admit_pass_kernel / gcs_admit (lane_tick.py:194, :235)
//                        and the per-site migration rank taken right after
//                        it (src/repro/sim/batched.py:337)
//   lt_window_admit   <- window_kernel / window_admit      (lane_tick.py:292, :318)
//
// On the TPU the site grid ran in order and carried sums from one step to
// the next. Here blocks run in parallel and in no order, so every sum that
// crosses blocks is a fixed-order two-stage reduction (per-block partials,
// then a finalize pass) or a walk in order inside one block, counts are
// integers (atomics included), and no float atomicAdd appears: a result is
// the same from run to run.
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

struct AddF {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};
struct AddI {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct MaxI {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

// Fixed-order block exclusive scan of one value per thread under op, whose
// identity is id. Returns the thread's exclusive prefix and writes the
// block total to *total (every thread receives it). The order depends only
// on blockDim. Every thread of the block must call it.
template <typename T, typename Op>
__device__ T block_exclusive_scan(T v, T id, Op op, T* total) {
  __shared__ T warp_tot[32];
  __shared__ T warp_off[32];
  __shared__ T block_tot;
  const int lane = threadIdx.x & (kWarp - 1);
  const int wid = threadIdx.x / kWarp;
  T incl = v;
  for (int o = 1; o < kWarp; o <<= 1) {
    const T up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = op(up, incl);
  }
  T excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = id;
  if (lane == kWarp - 1) warp_tot[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int nw = blockDim.x / kWarp;
    const T t = (lane < nw) ? warp_tot[lane] : id;
    T s = t;
    for (int o = 1; o < kWarp; o <<= 1) {
      const T up = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s = op(up, s);
    }
    T e = __shfl_up_sync(0xffffffffu, s, 1);
    if (lane == 0) e = id;
    if (lane < nw) warp_off[lane] = e;
    if (lane == nw - 1) block_tot = s;
  }
  __syncthreads();
  const T out = op(warp_off[wid], excl);
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
// shared-GCS admission and migration ranks
//
// Replaces gcs_admit_pass_kernel / gcs_admit (lane_tick.py:194, :235),
// whose running cumsum was carried across the sequential site grid, and
// the per-site cumsum of the admitted mask that repro's tick takes right
// after it (repro/sim/batched.py:337; its queue ranks at :342 follow from
// that rank in the tick's glue).
//
// What bounds it: over the dense [L, S*F] plane the function only reads
// the candidate flag and writes the admission flag and the rank (6 bytes
// an element, 96 MB at 8 x 2 x 1M), so it is bound by device-memory
// bandwidth. Its candidates are sparse (in the tick, files whose last
// consumer just finished: a few a lane per tick), so the sizes, the scans
// and the passes concern a handful of 16 million elements. The design
// touches the dense plane once and runs the passes on an ordered list of
// the candidates:
//
//   ga_dense_kernel    one tile per block: read want with 16-byte loads,
//                      write adm = 0 and rank = -1 (block-striped 16-byte
//                      stores), and the tile's candidate count (the only
//                      pass over every element);
//   ga_compact_kernel  a block whose tile holds no candidate returns at
//                      once; the others take their offset in the lane's
//                      list from the earlier tiles' counts, read their
//                      tile again and write each candidate's flat index,
//                      in ascending order, and its size (sizes are read at
//                      candidates only);
//   ga_lane_kernel     one block per lane walks its list in chunks, in
//                      order, the carry in a register: the TPU's
//                      sequential grid axis moved inside one CTA. Each of
//                      the n_passes passes is an exclusive scan of the
//                      sizes still remaining against the pass-start
//                      occupancy; the admitted bytes are folded per chunk,
//                      then over the chunks, in a fixed order. Then used'
//                      and the GB-seconds, and one walk that scans the
//                      admitted flags, restarting at the first entry of
//                      each site, and scatters adm = 1 and the rank.
//
// Every count is an integer; every float sum is a fixed-order scan or
// tree, so two calls on the same inputs give the same bits. A pass that
// admits nothing ends the passes (the later ones would repeat it exactly).
// Every grid is sized from the shapes, so the wrapper reads nothing back.
// The one-block walk is latency-bound per chunk: above a few percent of
// candidates it is slower than a scan spread over blocks.
// ---------------------------------------------------------------------------

constexpr int kGaThreads = 256;                       // dense / compaction
constexpr int kGaVec = 16;                            // flags a thread reads
constexpr int kGaTile = kGaThreads * kGaVec;          // 4096 flags a block
constexpr int kGaLaneThreads = 1024;                  // list walk
constexpr int kGaItems = 8;                           // list entries a thread
constexpr int kGaChunk = kGaLaneThreads * kGaItems;   // 8192 a chunk
constexpr int kGaSharedChunks = 1024;  // per-chunk bytes kept in shared
constexpr int64_t kGaAlign = 256;                     // scratch regions

// The 16 candidate flags of a lane row from element e, one per byte of
// w[0..3] (0 past N). vec: one 16-byte load (N is a multiple of 16 and
// the row 16-byte aligned, so a group lies wholly inside or outside).
__device__ __forceinline__ void ga_load_flags(const uint8_t* __restrict__ row,
                                              int64_t e, int64_t N, int vec,
                                              uint32_t w[4]) {
  if (vec) {
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (e < N) q = *reinterpret_cast<const uint4*>(row + e);
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int64_t i = e + 4 * k + b;
      if (i < N && row[i]) w[k] |= 1u << (8 * b);
    }
  }
}

__device__ __forceinline__ int ga_count(const uint32_t w[4]) {
  return __popc(w[0]) + __popc(w[1]) + __popc(w[2]) + __popc(w[3]);
}

__device__ __forceinline__ bool ga_flag(const uint32_t w[4], int j) {
  return (w[j >> 2] >> (8 * (j & 3))) & 1u;
}

__global__ void __launch_bounds__(kGaThreads)
ga_dense_kernel(const uint8_t* __restrict__ want, int64_t N, int vec,
                uint8_t* __restrict__ adm, int32_t* __restrict__ rank,
                int32_t* __restrict__ tcount) {
  const int64_t lane_id = blockIdx.y;
  const int64_t base = lane_id * N;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kGaTile;
  const int64_t e = tile0 + static_cast<int64_t>(threadIdx.x) * kGaVec;
  uint32_t w[4];
  ga_load_flags(want + base, e, N, vec, w);
  if (vec) {
    // the stored values do not depend on the flags, so each store
    // instruction covers consecutive 16-byte pieces across the block
    if (e < N)
      *reinterpret_cast<uint4*>(adm + base + e) = make_uint4(0u, 0u, 0u, 0u);
    int4* r = reinterpret_cast<int4*>(rank + base + tile0);
    const int4 none = make_int4(-1, -1, -1, -1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = k * kGaThreads + threadIdx.x;  // int4 index in the tile
      if (tile0 + 4 * q < N) r[q] = none;
    }
  } else {
    for (int j = 0; j < kGaVec && e + j < N; ++j) {
      adm[base + e + j] = 0;
      rank[base + e + j] = -1;
    }
  }
  const int c = block_sum(ga_count(w));
  if (threadIdx.x == 0) tcount[lane_id * gridDim.x + blockIdx.x] = c;
}

__global__ void __launch_bounds__(kGaThreads)
ga_compact_kernel(const uint8_t* __restrict__ want,
                  const float* __restrict__ sizes, int64_t N, int64_t stride,
                  int vec, const int32_t* __restrict__ tcount,
                  int32_t* __restrict__ lidx, float* __restrict__ lsz) {
  const int64_t lane_id = blockIdx.y;
  const int32_t* counts = tcount + lane_id * gridDim.x;
  if (counts[blockIdx.x] == 0) return;  // the same for every thread
  __shared__ int s_before;
  int before = 0;  // candidates of the lane's earlier tiles
  for (int j = threadIdx.x; j < static_cast<int>(blockIdx.x); j += blockDim.x)
    before += counts[j];
  before = block_sum(before);
  if (threadIdx.x == 0) s_before = before;
  const int64_t base = lane_id * N;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kGaTile +
                    static_cast<int64_t>(threadIdx.x) * kGaVec;
  uint32_t w[4];
  ga_load_flags(want + base, e, N, vec, w);
  int tot;
  const int off = block_exclusive_scan(ga_count(w), 0, AddI(), &tot);
  int pos = s_before + off;  // s_before: visible after the scan's barriers
  int32_t* li = lidx + lane_id * stride;
  float* ls = lsz + lane_id * stride;
#pragma unroll
  for (int j = 0; j < kGaVec; ++j) {
    if (ga_flag(w, j)) {
      li[pos] = static_cast<int32_t>(e + j);
      ls[pos] = sizes[base + e + j];
      ++pos;
    }
  }
}

// One block per lane. lidx/lsz/ladm: the lane's list (stride entries a
// lane, a multiple of 16, so the vector loads below stay aligned and in
// bounds); part: f32 [L, n_chunks_max] per-chunk admitted bytes, used
// where they do not fit in shared memory.
__global__ void __launch_bounds__(kGaLaneThreads)
ga_lane_kernel(const int32_t* __restrict__ tcount, int n_tiles,
               const int32_t* __restrict__ lidx, const float* __restrict__ lsz,
               uint8_t* __restrict__ ladm, int64_t stride,
               float* __restrict__ part, int n_chunks_max, int64_t N,
               int64_t F, int n_passes, const float* __restrict__ used_in,
               const float* __restrict__ limit,
               const float* __restrict__ dt_ptr,
               const int32_t* __restrict__ month_ptr, int n_months,
               uint8_t* __restrict__ adm, int32_t* __restrict__ rank,
               float* __restrict__ used_out, float* __restrict__ gbsec) {
  constexpr int kWords = kGaItems / 4;  // flag words (4 flags each)
  const int64_t lane_id = blockIdx.x;
  const int tid = threadIdx.x;
  __shared__ int s_int;
  __shared__ float s_used;
  __shared__ float s_part[kGaSharedChunks];
  int n = 0;
  for (int j = tid; j < n_tiles; j += blockDim.x)
    n += tcount[lane_id * n_tiles + j];
  n = block_sum(n);
  if (tid == 0) {
    s_int = n;
    s_used = used_in[lane_id];
  }
  __syncthreads();
  const int total = s_int;  // candidates in the lane's list
  float used = s_used;      // pass-start occupancy
  const float lim = limit[lane_id];
  const int32_t* li = lidx + lane_id * stride;
  const float* ls = lsz + lane_id * stride;
  uint32_t* la = reinterpret_cast<uint32_t*>(ladm + lane_id * stride);
  float* lp = n_chunks_max <= kGaSharedChunks
                  ? s_part
                  : part + lane_id * n_chunks_max;
  const int n_chunks = (total + kGaChunk - 1) / kGaChunk;
  const uint32_t f_u32 = static_cast<uint32_t>(F);
  int remaining = total;

  // -- the admission passes
  for (int pass = 0; pass < n_passes && remaining > 0; ++pass) {
    float carry = 0.0f;  // sizes still remaining before this chunk
    int n_new = 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int first = c * kGaChunk + tid * kGaItems;
      const int n_valid = min(kGaItems, max(0, total - first));
      float sz[kGaItems] = {};
      uint32_t was[kWords] = {};
      if (n_valid > 0) {
        const float4* s4 = reinterpret_cast<const float4*>(ls + first);
#pragma unroll
        for (int q = 0; q < kWords; ++q) {
          const float4 v4 = s4[q];
          sz[4 * q] = v4.x;
          sz[4 * q + 1] = v4.y;
          sz[4 * q + 2] = v4.z;
          sz[4 * q + 3] = v4.w;
          if (pass > 0) was[q] = la[first / 4 + q];
        }
      }
      uint32_t rem = 0u;  // bit k: entry k still remains
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kGaItems; ++k) {
        if (k < n_valid && !((was[k / 4] >> (8 * (k & 3))) & 1u)) {
          rem |= 1u << k;
          s = __fadd_rn(s, sz[k]);
        }
      }
      float tot;
      float run = __fadd_rn(carry, block_exclusive_scan(s, 0.0f, AddF(), &tot));
      float nb = 0.0f;
      uint32_t now[kWords];
#pragma unroll
      for (int q = 0; q < kWords; ++q) now[q] = was[q];
#pragma unroll
      for (int k = 0; k < kGaItems; ++k) {
        const bool r = (rem >> k) & 1u;
        run = __fadd_rn(run, r ? sz[k] : 0.0f);
        if (r && __fadd_rn(used, run) <= lim) {
          nb = __fadd_rn(nb, sz[k]);
          ++n_new;
          now[k / 4] |= 1u << (8 * (k & 3));
        }
      }
      if (n_valid > 0) {
#pragma unroll
        for (int q = 0; q < kWords; ++q) la[first / 4 + q] = now[q];
      }
      nb = block_sum(nb);
      if (tid == 0) lp[c] = nb;
      carry = __fadd_rn(carry, tot);
    }
    n_new = block_sum(n_new);
    __syncthreads();  // thread 0's lp writes, for every thread
    float a = 0.0f;   // this pass's admitted bytes, chunks in a fixed order
    for (int j = tid; j < n_chunks; j += blockDim.x) a = __fadd_rn(a, lp[j]);
    a = block_sum(a);
    if (tid == 0) {
      s_used = __fadd_rn(used, a);
      s_int = n_new;
    }
    __syncthreads();
    used = s_used;
    const int admitted_now = s_int;
    remaining -= admitted_now;
    __syncthreads();  // s_used and s_int are written again next pass
    if (admitted_now == 0) break;  // a repeat would admit nothing either
  }

  if (tid == 0) {
    used_out[lane_id] = used;
    const float g = __fmul_rn(__fdiv_rn(used, 1e9f), *dt_ptr);
    const int month = *month_ptr;
    for (int m = 0; m < n_months; ++m)
      gbsec[lane_id * n_months + m] = (m == month) ? g : 0.0f;
  }
  if (remaining == total) return;  // nothing admitted: adm and rank stand

  // -- migration ranks: the admitted flags scanned in list order; the list
  // is site-major, and the scan restarts at each site's first entry (a
  // "head"): rank = admitted entries before this one - those before its
  // site's head. The latter is a max-scan over the heads, since the
  // admitted prefix never decreases along the list.
  __shared__ int s_last_site[kGaLaneThreads];
  __shared__ int s_prev_site;
  if (tid == 0) s_prev_site = -1;
  int carry_adm = 0;   // admitted entries before this chunk
  int carry_head = 0;  // admitted entries before the current site's head
  const int64_t base = lane_id * N;
  for (int c = 0; c < n_chunks; ++c) {
    const int first = c * kGaChunk + tid * kGaItems;
    const int n_valid = min(kGaItems, max(0, total - first));
    const int last_pos = min(total, (c + 1) * kGaChunk) - 1;
    int idx[kGaItems] = {};
    uint32_t flags[kWords] = {};
    if (n_valid > 0) {
      const int4* i4 = reinterpret_cast<const int4*>(li + first);
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        const int4 v4 = i4[q];
        idx[4 * q] = v4.x;
        idx[4 * q + 1] = v4.y;
        idx[4 * q + 2] = v4.z;
        idx[4 * q + 3] = v4.w;
        flags[q] = la[first / 4 + q];
      }
    }
    int cnt = 0, last_site = -2, chunk_last_site = -2;
    int site[kGaItems];
#pragma unroll
    for (int k = 0; k < kGaItems; ++k) {
      // 32-bit division: idx < 2^31 and F <= N
      site[k] = k < n_valid
                    ? static_cast<int>(static_cast<uint32_t>(idx[k]) / f_u32)
                    : -2;
      if (k >= n_valid) flags[k / 4] &= ~(0xffu << (8 * (k & 3)));
      cnt += static_cast<int>((flags[k / 4] >> (8 * (k & 3))) & 1u);
      if (k < n_valid) last_site = site[k];
      if (first + k == last_pos) chunk_last_site = site[k];
    }
    s_last_site[tid] = last_site;
    __syncthreads();  // also publishes s_prev_site from the last chunk
    int prev = tid == 0 ? s_prev_site : s_last_site[tid - 1];
    int tot_cnt;
    int p = carry_adm + block_exclusive_scan(cnt, 0, AddI(), &tot_cnt);
    int hmax = -1;
    uint32_t heads = 0u;
#pragma unroll
    for (int k = 0; k < kGaItems; ++k) {
      if (k < n_valid && site[k] != prev) {
        heads |= 1u << k;
        hmax = p;  // p never decreases: the last head is the largest
      }
      if (k < n_valid) prev = site[k];
      p += static_cast<int>((flags[k / 4] >> (8 * (k & 3))) & 1u);
    }
    int tot_head;
    int head =
        max(carry_head, block_exclusive_scan(hmax, -1, MaxI(), &tot_head));
    p -= cnt;  // back to this thread's first entry
#pragma unroll
    for (int k = 0; k < kGaItems; ++k) {
      if ((heads >> k) & 1u) head = p;
      if ((flags[k / 4] >> (8 * (k & 3))) & 1u) {
        adm[base + idx[k]] = 1;
        rank[base + idx[k]] = p - head;
        ++p;
      }
    }
    carry_adm += tot_cnt;
    carry_head = max(carry_head, tot_head);
    if (chunk_last_site >= 0)  // this thread holds the chunk's last entry
      s_prev_site = chunk_last_site;
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

// The byte offsets of the GCS admission's scratch regions for L lanes of
// N = S*F elements (see lt_gcs_admit); returns the total.
int64_t ga_layout(int L, int64_t N, int64_t off[5]) {
  const int64_t stride = (N + 15) / 16 * 16;
  const int64_t bytes[5] = {
      4 * static_cast<int64_t>(L) * tiles(N, kGaTile),   // tile counts
      4 * L * stride,                                     // list: indices
      4 * L * stride,                                     // list: sizes
      L * stride,                                         // list: admitted
      4 * static_cast<int64_t>(L) * tiles(N, kGaChunk)};  // chunk bytes
  int64_t at = 0;
  for (int i = 0; i < 5; ++i) {
    off[i] = at;
    at += (bytes[i] + kGaAlign - 1) / kGaAlign * kGaAlign;
  }
  return at;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

int lt_transfer_tiles(long long F) { return tiles(F, kTtTile); }

long long lt_gcs_scratch_bytes(int L, long long N) {
  int64_t off[5];
  return ga_layout(L, N, off);
}

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

// N = S*F elements per lane (below 2^31), F files per site; scratch: a
// device buffer of lt_gcs_scratch_bytes(L, N) bytes, 256-byte aligned;
// n_passes >= 1. Outputs: adm (bool) and rank (int32) [L, N], used_out
// [L], gbsec [L, n_months]. Three launches, none sized from the data.
int lt_gcs_admit(const void* want, const void* sizes, const void* used_in,
                 const void* limit, const void* dt, const void* month, int L,
                 long long N, long long F, int n_months, int n_passes,
                 void* scratch, void* adm, void* rank, void* used_out,
                 void* gbsec, void* stream) {
  if (L <= 0) return static_cast<int>(cudaSuccess);
  if (N < 0 || N >= (1LL << 31) || n_passes < 1 || (N > 0 && F <= 0) ||
      (F > 0 && N % F != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t off[5];
  ga_layout(L, N, off);
  char* base = static_cast<char*>(scratch);
  int32_t* tcount = reinterpret_cast<int32_t*>(base + off[0]);
  int32_t* lidx = reinterpret_cast<int32_t*>(base + off[1]);
  float* lsz = reinterpret_cast<float*>(base + off[2]);
  uint8_t* ladm = reinterpret_cast<uint8_t*>(base + off[3]);
  float* part = reinterpret_cast<float*>(base + off[4]);
  const int64_t stride = (N + 15) / 16 * 16;
  const int n_tiles = tiles(N, kGaTile);
  const int vec = N % 16 == 0 && aligned16(want) && aligned16(adm) &&
                  aligned16(rank);
  if (n_tiles > 0) {
    const dim3 grid(n_tiles, L);
    ga_dense_kernel<<<grid, kGaThreads, 0, st>>>(
        static_cast<const uint8_t*>(want), N, vec, static_cast<uint8_t*>(adm),
        static_cast<int32_t*>(rank), tcount);
    ga_compact_kernel<<<grid, kGaThreads, 0, st>>>(
        static_cast<const uint8_t*>(want), static_cast<const float*>(sizes), N,
        stride, vec, tcount, lidx, lsz);
  }
  ga_lane_kernel<<<L, kGaLaneThreads, 0, st>>>(
      tcount, n_tiles, lidx, lsz, ladm, stride, part, tiles(N, kGaChunk), N,
      F, n_passes, static_cast<const float*>(used_in),
      static_cast<const float*>(limit), static_cast<const float*>(dt),
      static_cast<const int32_t*>(month), n_months,
      static_cast<uint8_t*>(adm), static_cast<int32_t*>(rank),
      static_cast<float*>(used_out), static_cast<float*>(gbsec));
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
