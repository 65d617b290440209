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
//   lt_windows_admit  <- window_kernel / window_admit      (lane_tick.py:292, :318)
//                        called for both of the tick's windows, with the
//                        glue between them (src/repro/sim/batched.py:474-483)
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

// Fixed-order sum over the 32 lanes of a warp (valid in lane 0).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Fixed-order block reduction: warp shuffle tree, then warp 0 reduces the
// warp sums. The order depends only on blockDim, so the result is
// reproducible. Valid in thread 0. Every thread of the block must call it.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[32];
  v = warp_sum(v);
  const int lane = threadIdx.x & (kWarp - 1);
  const int wid = threadIdx.x / kWarp;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  const int nw = blockDim.x / kWarp;
  v = (static_cast<int>(threadIdx.x) < nw) ? warp_sums[threadIdx.x] : T(0);
  if (wid == 0) v = warp_sum(v);
  __syncthreads();  // warp_sums may be reused by the next call
  return v;
}

struct AddD {
  __device__ double operator()(double a, double b) const { return __dadd_rn(a, b); }
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
// Replaces transfer_kernel (lane_tick.py:81). What bounds it: for every
// element the function must read the active flag, done and total and
// write new_done and the completion flag (14 bytes); it needs the link id
// only of active transfers and the size only of completions. That is
// device-memory bandwidth (224 MB at 8 x 2 x 1M). The per-link-type active
// counts it needs before any rate are a reduction over the whole site
// row, so a pass that counts must end before any active transfer can
// advance. Active transfers are few in the sweep's tick (a few thousand of
// 16M) but may be all of them (unlimited link slots), so the design reads
// the link id and the size only where they are needed, at any share:
//
//   tt_count_kernel    one tile of 16384 elements of a row per block, 16
//                      block-striped groups of 4 a thread: the active flags
//                      (4-byte loads, 1 byte an element), the link id of
//                      active elements only; writes the tile's active count
//                      per link type. Its tile is 4 of the advance's, so
//                      that its blocks, which move little each, are few;
//   tt_advance_kernel  one tile of 4096 elements per block, 4 block-striped
//                      groups of 4 a thread (every warp instruction moves
//                      one contiguous line): flags, done and total of every
//                      element, the link id of active ones; writes new_done
//                      and comp once, reads the size of completions only.
//                      A tile whose counting tile holds an active element
//                      first sums its row's per-type counts (integers, no
//                      atomics; one warp) into the three rates. Billing
//                      partials are summed per warp, then over the warps,
//                      in a fixed order;
//   tt_fold_kernel     one block per lane folds the partials in a fixed
//                      order into the per-site bytes and the month rows.
//
// So the flags are read twice (16 of 240 MB at sparse shares), and so are
// the link ids of active elements. Finishing each warp's 512-element unit
// without an active transfer in the counting pass moves fewer bytes and
// was measured slower on an H100 (PERF.md): it leaves each tile's writes
// to two kernels, and the second kernel's blocks are bound by the latency
// of their dependent loads. A list of active indices would move more
// bytes than the tile above a few percent of active elements (an index
// written and read back, then scattered reads and writes of done, total
// and the outputs). new_done rounds like the plain version's
// separate ops (__fmul_rn / __fadd_rn / __fdiv_rn, no FMA contraction), so
// it matches bitwise; an inactive element's is min(total, done + 0), what
// the plain version computes at a finite rate. Every grid is sized from
// the shapes; the wrapper reads nothing back.
// ---------------------------------------------------------------------------

constexpr int kTtThreads = 256;
constexpr int kTtGroups = 4;                         // 4-element groups a thread
constexpr int kTtTile = kTtThreads * kTtGroups * 4;  // 4096 elements a block
constexpr int kTtCountSpan = 4;  // advance tiles a counting block covers
constexpr int kTtCountGroups = kTtGroups * kTtCountSpan;
constexpr int kTtCountTile = kTtTile * kTtCountSpan;  // 16384 elements

// The group of 4 elements of a row at f: element b's active flag in byte b
// (0 past F). vec: one 4-byte load (F % 4 == 0 and the rows aligned, so a
// group lies wholly inside or outside the row).
__device__ __forceinline__ uint32_t tt_flags(const uint8_t* __restrict__ row,
                                             int64_t f, int64_t F, int vec) {
  if (vec) return f < F ? *reinterpret_cast<const uint32_t*>(row + f) : 0u;
  uint32_t w = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (f + b < F && row[f + b]) w |= 1u << (8 * b);
  return w;
}

__device__ __forceinline__ bool tt_on(uint32_t w, int b) {
  return (w >> (8 * b)) & 1u;
}

// The link type (link id mod 3, as torch.remainder) of the active elements
// of the group at f; 0 elsewhere.
__device__ __forceinline__ void tt_types(const int32_t* __restrict__ row,
                                         int64_t f, int vec, uint32_t w,
                                         int t[4]) {
  int l[4] = {0, 0, 0, 0};
  if (vec) {
    const int4 q = *reinterpret_cast<const int4*>(row + f);
    l[0] = q.x;
    l[1] = q.y;
    l[2] = q.z;
    l[3] = q.w;
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (tt_on(w, b)) l[b] = row[f + b];
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int r = l[b] % 3;
    t[b] = tt_on(w, b) ? (r < 0 ? r + 3 : r) : 0;
  }
}

__device__ __forceinline__ void tt_load(const float* __restrict__ row,
                                        int64_t f, int64_t F, int vec,
                                        float x[4]) {
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(row + f);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
    return;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) x[b] = f + b < F ? row[f + b] : 0.0f;
}

// new_done of the group and its completion flags (one per byte).
__device__ __forceinline__ void tt_store(float* __restrict__ nd_row,
                                         uint8_t* __restrict__ comp_row,
                                         int64_t f, int64_t F, int vec,
                                         const float nd[4], uint32_t c) {
  if (vec) {
    *reinterpret_cast<float4*>(nd_row + f) =
        make_float4(nd[0], nd[1], nd[2], nd[3]);
    *reinterpret_cast<uint32_t*>(comp_row + f) = c;
    return;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (f + b < F) {
      nd_row[f + b] = nd[b];
      comp_row[f + b] = tt_on(c, b) ? 1 : 0;
    }
  }
}

__global__ void __launch_bounds__(kTtThreads)
tt_count_kernel(const int32_t* __restrict__ link,
                const uint8_t* __restrict__ active, int64_t F, int vec,
                int4* __restrict__ tcount) {
  const int64_t base = static_cast<int64_t>(blockIdx.y) * F;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTtCountTile;
  const int tid = threadIdx.x;
  // per-type counts packed in 16-bit fields: a tile holds at most 16384
  // elements, so no field carries into the next
  unsigned long long packed = 0ull;
#pragma unroll
  for (int g = 0; g < kTtCountGroups; ++g) {
    const int64_t f = tile0 + 4 * (g * kTtThreads + tid);
    const uint32_t w = tt_flags(active + base, f, F, vec);
    if (w) {
      int t[4];
      tt_types(link + base, f, vec, w, t);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (tt_on(w, b)) packed += 1ull << (16 * t[b]);
    }
  }
  packed = block_sum(packed);
  if (tid == 0) {
    const int c0 = static_cast<int>(packed & 0xffffu);
    const int c1 = static_cast<int>((packed >> 16) & 0xffffu);
    const int c2 = static_cast<int>((packed >> 32) & 0xffffu);
    tcount[static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x] =
        make_int4(c0, c1, c2, c0 + c1 + c2);
  }
}

__global__ void __launch_bounds__(kTtThreads)
tt_advance_kernel(const int32_t* __restrict__ link,
                  const uint8_t* __restrict__ active,
                  const float* __restrict__ done,
                  const float* __restrict__ total,
                  const float* __restrict__ sizes,
                  const float* __restrict__ bw,
                  const int32_t* __restrict__ mode,
                  const float* __restrict__ dt_ptr,
                  const int4* __restrict__ tcount, int n_ctiles, int S,
                  int64_t F, int vec, float* __restrict__ new_done,
                  uint8_t* __restrict__ comp, float4* __restrict__ pbytes,
                  int2* __restrict__ pcnt) {
  constexpr int kWarps = kTtThreads / kWarp;
  const int64_t row = blockIdx.y;
  const int4* rc = tcount + row * n_ctiles;
  const int64_t p = row * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid & (kWarp - 1);
  __shared__ float s_rate[3];
  __shared__ float s_bytes[kWarps][3];
  __shared__ int s_cnt[kWarps][2];
  // an active element in this tile's counting tile (the same for every
  // thread)
  const bool any = rc[blockIdx.x / kTtCountSpan].w > 0;
  if (any) {
    if (warp == 0) {
      // the row's active transfers per link type (integers), the rates
      const int64_t link0 = (row / S) * 3 * S + 3 * (row % S);
      int c0 = 0, c1 = 0, c2 = 0;
      for (int j = lane; j < n_ctiles; j += kWarp) {
        const int4 v = rc[j];
        c0 += v.x;
        c1 += v.y;
        c2 += v.z;
      }
      c0 = __shfl_sync(0xffffffffu, warp_sum(c0), 0);
      c1 = __shfl_sync(0xffffffffu, warp_sum(c1), 0);
      c2 = __shfl_sync(0xffffffffu, warp_sum(c2), 0);
      if (lane < 3) {
        const float b = bw[link0 + lane];
        const int cnt = lane == 0 ? c0 : (lane == 1 ? c1 : c2);
        const float shared =
            __fdiv_rn(b, fmaxf(static_cast<float>(cnt), 1.0f));
        s_rate[lane] = mode[link0 + lane] > 0 ? b : shared;
      }
    }
    __syncthreads();
  }
  const float r0 = any ? s_rate[0] : 0.0f;
  const float r1 = any ? s_rate[1] : 0.0f;
  const float r2 = any ? s_rate[2] : 0.0f;
  const float dt = *dt_ptr;
  const int64_t base = row * F;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTtTile;
  float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
  int n1 = 0, n2 = 0;
#pragma unroll
  for (int g = 0; g < kTtGroups; ++g) {
    const int64_t f = tile0 + 4 * (g * kTtThreads + tid);
    if (f >= F) break;
    const uint32_t w = tt_flags(active + base, f, F, vec);
    float d[4], tot[4], nd[4];
    int t[4] = {0, 0, 0, 0};
    tt_load(done + base, f, F, vec, d);
    tt_load(total + base, f, F, vec, tot);
    if (w) tt_types(link + base, f, vec, w, t);
    uint32_t c = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const bool a = tt_on(w, b);
      const float r = t[b] == 0 ? r0 : (t[b] == 1 ? r1 : r2);
      const float step = a ? __fmul_rn(r, dt) : 0.0f;
      nd[b] = fminf(tot[b], __fadd_rn(d[b], step));
      if (a && nd[b] >= tot[b]) {
        c |= 1u << (8 * b);
        const float sz = sizes[base + f + b];
        if (t[b] == 0) {
          b0 += sz;
        } else if (t[b] == 1) {
          b1 += sz;
          n1 += 1;
        } else {
          b2 += sz;
          n2 += 1;
        }
      }
    }
    tt_store(new_done + base, comp + base, f, F, vec, nd, c);
  }
  if (!any) {  // no completion in the tile
    if (tid == 0) {
      pbytes[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      pcnt[p] = make_int2(0, 0);
    }
    return;
  }
  // billing: each warp in a fixed order, then the warps in order
  b0 = warp_sum(b0);
  b1 = warp_sum(b1);
  b2 = warp_sum(b2);
  n1 = warp_sum(n1);
  n2 = warp_sum(n2);
  if (lane == 0) {
    s_bytes[warp][0] = b0;
    s_bytes[warp][1] = b1;
    s_bytes[warp][2] = b2;
    s_cnt[warp][0] = n1;
    s_cnt[warp][1] = n2;
  }
  __syncthreads();
  if (tid == 0) {
    float4 pb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int2 pc = make_int2(0, 0);
    for (int k = 0; k < kWarps; ++k) {
      pb.x += s_bytes[k][0];
      pb.y += s_bytes[k][1];
      pb.z += s_bytes[k][2];
      pc.x += s_cnt[k][0];
      pc.y += s_cnt[k][1];
    }
    pbytes[p] = pb;
    pcnt[p] = pc;
  }
}

// One block per lane: fixed-order sums of the per-tile partials into the
// per-site byte totals and the lane's month deltas.
__global__ void tt_fold_kernel(const float4* __restrict__ pbytes,
                               const int2* __restrict__ pcnt, int S,
                               int n_tiles, const int32_t* __restrict__ month_ptr,
                               int n_months, float* __restrict__ tape,
                               float* __restrict__ recall,
                               float* __restrict__ mig,
                               float* __restrict__ egress,
                               float* __restrict__ cls_a,
                               float* __restrict__ cls_b) {
  constexpr int kWarps = kTtThreads / kWarp;
  __shared__ float s_bytes[kWarps][3];
  __shared__ int s_cnt[kWarps][2];
  const int64_t lane_id = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  float egress_sum = 0.0f;
  int64_t n1_sum = 0, n2_sum = 0;
  for (int s = 0; s < S; ++s) {
    const int64_t row = lane_id * S + s;
    float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
    int n1 = 0, n2 = 0;
    for (int j = tid; j < n_tiles; j += kTtThreads) {
      const float4 v = pbytes[row * n_tiles + j];
      const int2 c = pcnt[row * n_tiles + j];
      b0 += v.x;
      b1 += v.y;
      b2 += v.z;
      n1 += c.x;
      n2 += c.y;
    }
    b0 = warp_sum(b0);
    b1 = warp_sum(b1);
    b2 = warp_sum(b2);
    n1 = warp_sum(n1);
    n2 = warp_sum(n2);
    if ((tid & (kWarp - 1)) == 0) {
      s_bytes[warp][0] = b0;
      s_bytes[warp][1] = b1;
      s_bytes[warp][2] = b2;
      s_cnt[warp][0] = n1;
      s_cnt[warp][1] = n2;
    }
    __syncthreads();
    if (tid == 0) {
      float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;
      for (int k = 0; k < kWarps; ++k) {
        t0 += s_bytes[k][0];
        t1 += s_bytes[k][1];
        t2 += s_bytes[k][2];
        n1_sum += s_cnt[k][0];
        n2_sum += s_cnt[k][1];
      }
      tape[row] = t0;
      recall[row] = t1;
      mig[row] = t2;
      egress_sum += t1;
    }
    __syncthreads();  // s_bytes and s_cnt are written again for the next row
  }
  if (tid == 0) {
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
// The prefix, the gate and the admitted bytes are float64, as in the plain
// version (ref.gcs_admit): a float32 prefix over hundreds of thousands of
// sizes drifts by about a hundred float32 ulps of the total with its
// summation order, so no float32 order can match torch.cumsum's decisions
// to within a few ulps of the limit; two float64 orders agree to about
// n * 2^-53 of the total. used' is the pass's float64 sum rounded to
// float32 once.
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
// bounds); part: f64 [L, n_chunks_max] per-chunk admitted bytes, used
// where they do not fit in shared memory.
__global__ void __launch_bounds__(kGaLaneThreads)
ga_lane_kernel(const int32_t* __restrict__ tcount, int n_tiles,
               const int32_t* __restrict__ lidx, const float* __restrict__ lsz,
               uint8_t* __restrict__ ladm, int64_t stride,
               double* __restrict__ part, int n_chunks_max, int64_t N,
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
  __shared__ double s_part[kGaSharedChunks];
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
  const double lim = limit[lane_id];
  const int32_t* li = lidx + lane_id * stride;
  const float* ls = lsz + lane_id * stride;
  uint32_t* la = reinterpret_cast<uint32_t*>(ladm + lane_id * stride);
  double* lp = n_chunks_max <= kGaSharedChunks
                  ? s_part
                  : part + lane_id * n_chunks_max;
  const int n_chunks = (total + kGaChunk - 1) / kGaChunk;
  const uint32_t f_u32 = static_cast<uint32_t>(F);
  int remaining = total;

  // -- the admission passes
  for (int pass = 0; pass < n_passes && remaining > 0; ++pass) {
    double carry = 0.0;  // sizes still remaining before this chunk
    const double used_d = used;
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
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < kGaItems; ++k) {
        if (k < n_valid && !((was[k / 4] >> (8 * (k & 3))) & 1u)) {
          rem |= 1u << k;
          s = __dadd_rn(s, sz[k]);
        }
      }
      double tot;
      double run = __dadd_rn(carry, block_exclusive_scan(s, 0.0, AddD(), &tot));
      double nb = 0.0;
      uint32_t now[kWords];
#pragma unroll
      for (int q = 0; q < kWords; ++q) now[q] = was[q];
#pragma unroll
      for (int k = 0; k < kGaItems; ++k) {
        const bool r = (rem >> k) & 1u;
        run = __dadd_rn(run, r ? static_cast<double>(sz[k]) : 0.0);
        if (r && __dadd_rn(used_d, run) <= lim) {
          nb = __dadd_rn(nb, sz[k]);
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
      carry = __dadd_rn(carry, tot);
    }
    n_new = block_sum(n_new);
    __syncthreads();  // thread 0's lp writes, for every thread
    double a = 0.0;   // this pass's admitted bytes, chunks in a fixed order
    for (int j = tid; j < n_chunks; j += blockDim.x) a = __dadd_rn(a, lp[j]);
    a = block_sum(a);
    if (tid == 0) {
      s_used = __double2float_rn(__dadd_rn(used_d, a));
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
// Replaces window_kernel (lane_tick.py:292), both of the tick's calls of
// it (src/repro/sim/batched.py:433, :485) and the glue between them
// (:474-483). One thread per (lane, site) row, in the plain version's
// operation order (ref.windows_admit):
//   1. the K window of job arrivals (no head blocking): fit is
//      (used + extra) + size <= limit, then extra + size;
//   2. used' = used + extra, rounded once;
//   3. stale heads: a W-window head is stale when its file is no longer
//      absent or a K slot just started it (K x W fid compares, kept as a
//      W-bit mask in a register while the K window is walked);
//   4. the W window of wait-queue heads against used', a live head that
//      does not fit blocking every head behind it.
// It moves 14 bytes per K slot and 16 per W slot, a few hundred bytes a
// call at the sweep's 16 rows, so its time is the launch and each row's
// serial chain: the design makes the tick's two windows one launch (the
// tick program replays it from a CUDA graph) and keeps the stale-head
// compares off that chain.
// ---------------------------------------------------------------------------

__global__ void wa_fused_kernel(
    const uint8_t* __restrict__ absent, const float* __restrict__ size_k,
    const int64_t* __restrict__ fid_k, const uint8_t* __restrict__ valid_w,
    const uint8_t* __restrict__ present_w, const float* __restrict__ size_w,
    const int64_t* __restrict__ idx_w, const float* __restrict__ used,
    const float* __restrict__ limit, int64_t R, int K, int W,
    uint8_t* __restrict__ started, uint8_t* __restrict__ admitted,
    uint8_t* __restrict__ stale, float* __restrict__ used_out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float lim = limit[r];
  const float u = used[r];
  const int64_t* idx = idx_w + r * W;
  float extra = 0.0f;
  uint32_t jumped = 0u;  // bit w: a started K slot holds head w's file
  for (int k = 0; k < K; ++k) {
    const int64_t i = r * K + k;
    const float s = size_k[i];
    const bool a = absent[i] != 0 && __fadd_rn(__fadd_rn(u, extra), s) <= lim;
    started[i] = a ? 1 : 0;
    extra = __fadd_rn(extra, a ? s : 0.0f);
    // the fid compares read inputs only, off the float chain
    const int64_t f = fid_k[i];
    for (int w = 0; w < W; ++w)
      if (a && idx[w] == f) jumped |= 1u << w;
  }
  const float u2 = __fadd_rn(u, extra);
  float extra_w = 0.0f;
  bool blocked = false;
  for (int w = 0; w < W; ++w) {
    const int64_t i = r * W + w;
    const bool valid = valid_w[i] != 0;
    const bool st = valid && (present_w[i] != 0 || ((jumped >> w) & 1u));
    const bool live = valid && !st;
    const float s = size_w[i];
    const bool fit = __fadd_rn(__fadd_rn(u2, extra_w), s) <= lim;
    const bool a = live && fit && !blocked;
    blocked = blocked || (live && !fit);
    stale[i] = st ? 1 : 0;
    admitted[i] = a ? 1 : 0;
    extra_w = __fadd_rn(extra_w, a ? s : 0.0f);
  }
  used_out[r] = __fadd_rn(u2, extra_w);
}

inline int tiles(int64_t n, int tile) {
  return static_cast<int>((n + tile - 1) / tile);
}

// The byte offsets of the transfer tick's scratch regions for L*S rows of
// F elements (see lt_transfer_tick); returns the total.
int64_t tt_layout(int L, int S, int64_t F, int64_t off[3]) {
  const int64_t rows = static_cast<int64_t>(L) * S;
  const int64_t n = rows * tiles(F, kTtTile);
  const int64_t bytes[3] = {16 * rows * tiles(F, kTtCountTile),  // counts
                            16 * n,   // billing bytes (float4) per tile
                            8 * n};   // billing counts (int2) per tile
  int64_t at = 0;
  for (int i = 0; i < 3; ++i) {
    off[i] = at;
    at += (bytes[i] + kGaAlign - 1) / kGaAlign * kGaAlign;
  }
  return at;
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
      8 * static_cast<int64_t>(L) * tiles(N, kGaChunk)};  // chunk bytes
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

long long lt_transfer_scratch_bytes(int L, int S, long long F) {
  int64_t off[3];
  return tt_layout(L, S, F, off);
}

long long lt_gcs_scratch_bytes(int L, long long N) {
  int64_t off[5];
  return ga_layout(L, N, off);
}

const char* lt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Planes [L, S, F] (row r = l*S + s), bw and mode [L, 3*S]; scratch: a
// device buffer of lt_transfer_scratch_bytes(L, S, F) bytes, 256-byte
// aligned. Outputs: new_done (f32) and comp (bool) [L, S, F], tape,
// recall, mig [L, S], egress, cls_a, cls_b [L, n_months]. Three launches,
// none sized from the data.
int lt_transfer_tick(const void* link, const void* active, const void* done,
                     const void* total, const void* sizes, const void* bw,
                     const void* mode, const void* dt, const void* month,
                     int L, int S, long long F, int n_months, void* scratch,
                     void* new_done, void* comp, void* tape, void* recall,
                     void* mig, void* egress, void* cls_a, void* cls_b,
                     void* stream) {
  if (L <= 0) return static_cast<int>(cudaSuccess);
  const int64_t rows = static_cast<int64_t>(L) * S;
  if (S < 0 || F < 0 || rows > 65535)  // rows are gridDim.y
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t off[3];
  tt_layout(L, S, F, off);
  char* base = static_cast<char*>(scratch);
  int4* tcount = reinterpret_cast<int4*>(base + off[0]);
  float4* pbytes = reinterpret_cast<float4*>(base + off[1]);
  int2* pcnt = reinterpret_cast<int2*>(base + off[2]);
  const int n_tiles = tiles(F, kTtTile);
  const uintptr_t a4 = reinterpret_cast<uintptr_t>(active) |
                       reinterpret_cast<uintptr_t>(comp);
  const int vec = F % 4 == 0 && (a4 & 3u) == 0 && aligned16(link) &&
                  aligned16(done) && aligned16(total) && aligned16(new_done);
  if (n_tiles > 0 && rows > 0) {
    const int n_ctiles = tiles(F, kTtCountTile);
    tt_count_kernel<<<dim3(n_ctiles, static_cast<unsigned>(rows)), kTtThreads,
                      0, st>>>(static_cast<const int32_t*>(link),
                               static_cast<const uint8_t*>(active), F, vec,
                               tcount);
    tt_advance_kernel<<<dim3(n_tiles, static_cast<unsigned>(rows)),
                        kTtThreads, 0, st>>>(
        static_cast<const int32_t*>(link), static_cast<const uint8_t*>(active),
        static_cast<const float*>(done), static_cast<const float*>(total),
        static_cast<const float*>(sizes), static_cast<const float*>(bw),
        static_cast<const int32_t*>(mode), static_cast<const float*>(dt),
        tcount, n_ctiles, S, F, vec, static_cast<float*>(new_done),
        static_cast<uint8_t*>(comp), pbytes, pcnt);
  }
  tt_fold_kernel<<<L, kTtThreads, 0, st>>>(
      pbytes, pcnt, S, n_tiles, static_cast<const int32_t*>(month), n_months,
      static_cast<float*>(tape), static_cast<float*>(recall),
      static_cast<float*>(mig), static_cast<float*>(egress),
      static_cast<float*>(cls_a), static_cast<float*>(cls_b));
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
  double* part = reinterpret_cast<double*>(base + off[4]);
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

// R = L*S rows, each with K job-window slots (absent, size_k, fid_k) and
// W wait-queue heads (valid_w, present_w, size_w, idx_w); masks are bytes,
// fids int64; W <= 32. Outputs: started [R, K], admitted and stale [R, W]
// (bytes), used_out [R]. One launch.
int lt_windows_admit(const void* absent, const void* size_k, const void* fid_k,
                     const void* valid_w, const void* present_w,
                     const void* size_w, const void* idx_w, const void* used,
                     const void* limit, long long R, int K, int W,
                     void* started, void* admitted, void* stale,
                     void* used_out, void* stream) {
  if (R < 0 || K < 0 || W < 0 || W > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const int blocks = tiles(R, threads);
  if (blocks > 0)
    wa_fused_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const uint8_t*>(absent), static_cast<const float*>(size_k),
        static_cast<const int64_t*>(fid_k), static_cast<const uint8_t*>(valid_w),
        static_cast<const uint8_t*>(present_w),
        static_cast<const float*>(size_w), static_cast<const int64_t*>(idx_w),
        static_cast<const float*>(used), static_cast<const float*>(limit), R, K,
        W, static_cast<uint8_t*>(started), static_cast<uint8_t*>(admitted),
        static_cast<uint8_t*>(stale), static_cast<float*>(used_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
