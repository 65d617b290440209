// Hand-written Hopper (sm_90a) kernels of the batched sweep tick's glue:
// the state updates between the three lane-tick kernels of a tick, one
// pass over the [L, S, F] planes each (row r = l*S + s), computing what
// ../ref.py computes:
//
//   tg_begin        <- ref.begin       (src/repro/sim/batched.py:205-206)
//   tg_complete     <- ref.complete    (:195, :227-279, :287, :295-300,
//                                       :332-333)
//   tg_link_admit   <- ref.link_admit  (:280-286)
//   tg_migrate      <- ref.migrate     (:331, :336-353)
//   tg_wait_select  <- ref.wait_select (:473-475, jax.lax.top_k)
//
// No TPU kernel holds this work: in the JAX package XLA fuses these lines
// of the jitted tick into a few passes. Run as PyTorch operations they
// were about ninety plane-sized kernels a tick, each reading and writing
// whole planes, and a torch.topk.
//
// Bound on this card: each element is read and written once and takes a
// handful of compares, so every kernel is bound by device-memory
// bandwidth (3.35 TB/s on an H100 SXM). The design reads densely only
// what every element needs (flags, the consumer counters, disk_state) in
// 16-byte loads (4-byte ones for tg_begin's and tg_complete's bool
// planes), and touches the other planes only where a mask is set:
// completions, held slots, queued transfers, candidates, migrations.
// tg_link_admit, tg_migrate and tg_wait_select read nothing densely but
// one flag plane: they stream it (see "flag streams" below) on a grid
// sized to the card and walk its set flags a warp at a time over
// consecutive elements, so their gathers and stores coalesce. Floats
// round as the plain version's separate operations do (__fadd_rn,
// __fsub_rn, the integer conversions of PyTorch's casts), so every output
// is bitwise the plain version's.
//
// Counts are integers: warp sums (__reduce_add_sync), a shared sum a
// block, one integer atomic a block and counter. A block cannot see the
// counts that its own launch changes, so the work on whole rows (the
// link-slot prologue and the disk_used sums in tg_complete, the migration
// queue's counters in tg_migrate, each row's merge in tg_wait_select)
// runs in the launch's last block: each block adds its counts or writes
// its partials, fences and takes a ticket, and the block with the last
// ticket sees every other block's results and the end of their reads.
// The counters and tickets live in one int32 buffer that tg_begin zeroes
// at the start of each tick (tg_work_ints), so a captured tick needs no
// memset; the per-block partials in scratch buffers that every block
// writes before it is read (tg_complete_scratch, tg_wait_scratch). No
// float atomics: every result is the same from run to run.
//
// disk_used loses each row's dropped and deleted bytes as sums in one
// fixed order, ref.row_sum's: the pairwise tree over the row zero-padded
// to a power of two. Sizes are >= 0 and a + 0.0 == a, so a tile of 4096
// elements reduced alone (a thread's four, warp shuffles, the block's 32
// warp-step sums), then the tree of the row's tile sums, gives those bits.
//
// tg_wait_select keys each file ticket * F + index (a file that does not
// wait has ticket 2^30), unique in its row, so "the W lowest keys" defines
// every output; integer only, so bitwise. Its bound is the flag plane
// (1 B a file) and the tickets of the waiting files; it streams the flags
// as the flag kernels do, gathers a ticket only where a file waits, and
// keys a file that does not wait only in the run where one can be among
// the W lowest (see "wait_select" below).
//
// Plain C entry points, loaded with ctypes: each launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError() so the wrapper
// can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;    // consecutive elements a thread takes per step
constexpr int kSteps = 4;  // steps a block
constexpr int64_t kTile = static_cast<int64_t>(kThreads) * kVec * kSteps;
constexpr int kWarps = kThreads / 32;
static_assert(kSteps * kWarps == 32, "a tile's warp-step sums fill a warp");

// tg_link_admit, tg_migrate and tg_wait_select ("flag streams" below):
// flags a load (one uint4), loads a thread a step, a block's flags a load
// and a step (a "run", ops.FLAG_RUN), the resident blocks an SM their grid
// is sized for (ops.FLAG_BLOCKS_PER_SM), rounds of set flags a warp
// gathers at once.
constexpr int kFlagVec = 16;
constexpr int kFlagLoads = 4;
constexpr int64_t kFlagSpan = static_cast<int64_t>(kThreads) * kFlagVec;
constexpr int64_t kFlagRun = kFlagSpan * kFlagLoads;
constexpr int kFlagBlocksPerSm = 4;
constexpr int kBatch = 8;

// tg_wait_select: the non-waiting ticket, the empty key, and the partial
// keys a lane of the last block loads before it inserts any (C = 32).
constexpr int64_t kBigTicket = int64_t(1) << 30;  // ref.BIG_TICKET
constexpr int64_t kNoKey = 0x7fffffffffffffffLL;
constexpr int kMergeLoads = 8;
// Rounds of waiting files a warp gathers at once: a load with many goes
// thread by thread (kDenseWait), so few rounds remain.
constexpr int kWaitBatch = 2;
// A load whose 512 flags in a warp hold this many waiting files is keyed
// thread by thread, each thread its own 16 files (see wait_select).
constexpr int kDenseWait = 32;

// File-location states; must match ../ref.py.
constexpr int32_t kAbsent = 0, kInFlight = 1, kPresent = 2;

// The work buffer (int32): the post-completion link occupancy [R, 3], the
// direct and queued migrations [R] each, the three launches' tickets.
struct Work {
  int32_t* occ;
  int32_t* n_direct;
  int32_t* n_queued;
  int32_t* ticket_complete;
  int32_t* ticket_migrate;
  int32_t* ticket_wait;
};

__host__ __device__ inline Work carve(int32_t* base, int64_t R) {
  return Work{base, base + 3 * R, base + 4 * R, base + 5 * R, base + 5 * R + 1,
              base + 5 * R + 2};
}

inline int64_t work_ints(int64_t R) { return 5 * R + 3; }

// Four consecutive elements from index i of a plane (n of them valid):
// one 16-byte (4-byte for bytes) load when vec, else element by element.
__device__ __forceinline__ void ld4(const float* __restrict__ p, int64_t i,
                                    int n, bool vec, float (&v)[4]) {
  if (vec) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    for (int k = 0; k < 4; ++k) v[k] = k < n ? p[i + k] : 0.f;
  }
}

__device__ __forceinline__ void ld4(const int32_t* __restrict__ p, int64_t i,
                                    int n, bool vec, int32_t (&v)[4]) {
  if (vec) {
    const int4 x = *reinterpret_cast<const int4*>(p + i);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    for (int k = 0; k < 4; ++k) v[k] = k < n ? p[i + k] : 0;
  }
}

__device__ __forceinline__ void ld4(const uint8_t* __restrict__ p, int64_t i,
                                    int n, bool vec, uint8_t (&v)[4]) {
  if (vec) {
    const uchar4 x = *reinterpret_cast<const uchar4*>(p + i);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    for (int k = 0; k < 4; ++k) v[k] = k < n ? p[i + k] : 0;
  }
}

__device__ __forceinline__ void st4(float* __restrict__ p, int64_t i, int n,
                                    bool vec, const float (&v)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; k < n; ++k) p[i + k] = v[k];
  }
}

__device__ __forceinline__ void st4(uint8_t* __restrict__ p, int64_t i, int n,
                                    bool vec, const uint8_t (&v)[4]) {
  if (vec) {
    *reinterpret_cast<uchar4*>(p + i) = make_uchar4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; k < n; ++k) p[i + k] = v[k];
  }
}

// Calls fn(i, n) for each group of kVec consecutive elements that this
// thread takes in its block's tile (tile blockIdx.x of row blockIdx.y):
// i the flat index of the group's first element, n <= kVec the number of
// them inside the row.
template <typename Fn>
__device__ __forceinline__ void for_each_group(int64_t F, Fn fn) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * F;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int64_t f = tile0 + static_cast<int64_t>(step) * kThreads * kVec +
                      static_cast<int64_t>(threadIdx.x) * kVec;
    if (f < F) fn(row0 + f, static_cast<int>(F - f < kVec ? F - f : kVec));
  }
}

// torch.remainder(x, 3) of a link id: the link type.
__device__ __forceinline__ int link_type(int32_t link) {
  const int m = link % 3;
  return m < 0 ? m + 3 : m;
}

// torch.clamp_min(x, 0.0) (x is never NaN here).
__device__ __forceinline__ float clamp0(float x) { return x > 0.f ? x : 0.f; }

// Adds each thread's N counts into dst[k]: warp sums, a shared sum, then
// thread 0 adds each nonzero block count with one integer atomic. Every
// thread of the block calls it.
template <int N>
__device__ void add_block_counts(const int (&c)[N], int32_t* const (&dst)[N]) {
  __shared__ int s[N];
  if (threadIdx.x < N) s[threadIdx.x] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int w = __reduce_add_sync(0xffffffffu, c[k]);
    if ((threadIdx.x & 31) == 0 && w != 0) atomicAdd(&s[k], w);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (s[k] != 0) atomicAdd(dst[k], s[k]);
  }
}

// ref.row_sum's tree, its lower levels. A thread's four consecutive
// values, then a warp's: the butterfly pairs lane l with l ^ m, so after
// the level of mask m every lane holds the sum of its aligned 2m lanes
// (a + b == b + a, so both lanes of a pair hold the same bits).
__device__ __forceinline__ float tree4(const float (&v)[4]) {
  return __fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3]));
}

__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int m = 1; m < 32; m <<= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// The tree of n values value(0..n-1) in one thread, n a power of two: each
// partial sum waits on a stack until its left neighbour's subtree is
// complete (a binary counter), so the grouping is ref.row_sum's.
template <typename Fn>
__device__ float serial_tree(int64_t n, Fn value) {
  float stack[40];
  int sp = 0;
  for (int64_t j = 0; j < n; ++j) {
    float x = value(j);
    for (int64_t m = j + 1; (m & 1) == 0; m >>= 1) x = __fadd_rn(stack[--sp], x);
    stack[sp++] = x;
  }
  return stack[0];
}

// The tree of a row's n tile sums p[0], p[stride], ... (zero-padded to a
// power of two, at least 32): each lane of the calling warp reduces an
// aligned run of them, then the warp's tree. Every lane returns the sum.
__device__ float row_tree(const float* p, int64_t n, int64_t stride) {
  int64_t width = 32;
  while (width < n) width <<= 1;
  const int64_t run = width / 32;
  const int64_t first = static_cast<int64_t>(threadIdx.x & 31) * run;
  return warp_tree(serial_tree(run, [&](int64_t j) {
    return first + j < n ? __ldcg(p + (first + j) * stride) : 0.f;
  }));
}

// True in every thread of the block that finishes the launch last. Thread
// 0 fences its block's count atomics and takes a ticket; the block with
// the last ticket fences again before it reads what the others added.
// Every thread of the block calls it, after the block's own work.
__device__ bool last_block(int32_t* ticket) {
  __shared__ bool s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const int total = static_cast<int>(gridDim.x * gridDim.y);
    s_last = atomicAdd(ticket, 1) == total - 1;
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// ---------------------------------------------------------------- begin
// t_active = tr_slot & (tr_start <= (now - dt) + 0.5): the slot flags
// dense, tr_start only where a slot is held. Zeroes the tick's work buffer.
__global__ void __launch_bounds__(kThreads)
tg_begin_kernel(const uint8_t* __restrict__ slot,
                const float* __restrict__ start, const float* __restrict__ now,
                const float* __restrict__ dt, int64_t F, int vec,
                uint8_t* __restrict__ active, int32_t* __restrict__ work,
                int64_t n_work) {
  const int64_t n_threads =
      static_cast<int64_t>(gridDim.x) * gridDim.y * blockDim.x;
  const int64_t gid =
      (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * blockDim.x +
      threadIdx.x;
  for (int64_t j = gid; j < n_work; j += n_threads) work[j] = 0;
  const float thr = __fadd_rn(__fsub_rn(*now, *dt), 0.5f);
  for_each_group(F, [&](int64_t i, int n) {
    uint8_t s[4], a[4];
    ld4(slot, i, n, vec, s);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      a[k] = (k < n && s[k]) ? static_cast<uint8_t>(start[i + k] <= thr) : 0;
    st4(active, i, n, vec, a);
  });
}

// ------------------------------------------------------------- complete
// Per element, from the tick's entry values of pend_cnt and fin_max: the
// consumer snapshot; the completion (disk_state / gcs_state PRESENT, the
// slot freed, tr_done from new_done, tr_total and tr_start inf); the hot
// copy dropped after a migration with no consumer; the pending jobs of an
// arrived file resolved; the deletion or migration candidacy on the
// updated disk_state. Counts the held slots by link type, and sums the
// dropped and the deleted copies' sizes over the block's tile in
// ref.row_sum's order (two float partials a block, in partials[R, nt, 2]).
// Its dense stream is what limits it on the sweep's state: 1.16x a copy of
// the same 368 MB there (scripts/bench_glue.py). Storing the densely read
// planes back a group of four at a time, where any value changed, was
// slower (145 -> 215 us there, 742 -> 2,055 us on a dense state).
// The last block runs the link-slot prologue: free = max(slots - occ, 0),
// admit = int(min(free, lq_next - lq_serve)), lq_serve += admit, occ3 =
// occ + admit; and takes each row's tree of its tile sums off disk_used,
// the dropped copies' first.
__global__ void __launch_bounds__(kThreads)
tg_complete_kernel(const float* __restrict__ now,
                   const float* __restrict__ new_done,
                   const uint8_t* __restrict__ comp,
                   const float* __restrict__ sizes,
                   const uint8_t* __restrict__ limited,
                   const uint8_t* __restrict__ gcs_en,
                   const uint8_t* __restrict__ pop_ok,
                   const float* __restrict__ slots,
                   const int32_t* __restrict__ lq_next,
                   const int32_t* __restrict__ tr_link, int S, int64_t F,
                   int vec, int32_t* __restrict__ disk_state,
                   int32_t* __restrict__ gcs_state,
                   uint8_t* __restrict__ tr_slot, float* __restrict__ tr_done,
                   float* __restrict__ tr_total, float* __restrict__ tr_start,
                   int32_t* __restrict__ pend_cnt,
                   float* __restrict__ pend_tail, float* __restrict__ fin_max,
                   int32_t* __restrict__ lq_serve,
                   float* __restrict__ disk_used, uint8_t* __restrict__ want,
                   float* __restrict__ occ3, float* __restrict__ partials,
                   int32_t* __restrict__ work_base) {
  __shared__ float s_sum[2][kSteps * kWarps];  // [dropped, deleted][step, warp]
  const int64_t R = static_cast<int64_t>(gridDim.y);
  const int64_t nt = static_cast<int64_t>(gridDim.x);
  const Work work = carve(work_base, R);
  const int r = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const float t_now = *now;
  const bool lim = limited[r] != 0;
  const bool gen = gcs_en[r / S] != 0;
  const float inf = __int_as_float(0x7f800000);
  const int64_t row0 = static_cast<int64_t>(r) * F;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  int held[3] = {0, 0, 0};
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    float dr[4] = {0.f, 0.f, 0.f, 0.f}, de[4] = {0.f, 0.f, 0.f, 0.f};
    const int64_t f = tile0 + static_cast<int64_t>(step) * kThreads * kVec +
                      static_cast<int64_t>(threadIdx.x) * kVec;
    if (f < F) {
      const int64_t i = row0 + f;
      const int n = static_cast<int>(F - f < kVec ? F - f : kVec);
      uint8_t cm[4], sl[4], w[4];
      int32_t pc[4], ds[4];
      float fm[4], nd[4];
      ld4(comp, i, n, vec, cm);
      ld4(tr_slot, i, n, vec, sl);
      ld4(pend_cnt, i, n, vec, pc);
      ld4(fin_max, i, n, vec, fm);
      ld4(disk_state, i, n, vec, ds);
      ld4(new_done, i, n, vec, nd);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = 0;
        if (k >= n) continue;
        const int64_t e = i + k;
        const bool no_cons = pc[k] == 0 && fm[k] <= t_now;
        int32_t d = ds[k];
        bool slot = sl[k] != 0;
        int32_t gs = -1;  // gcs_state, read where needed
        int lt = -1;
        if (cm[k]) {
          lt = link_type(tr_link[e]);
          if (lt != 2) {  // inbound: the file arrived on disk
            d = kPresent;
            if (pc[k] > 0) fin_max[e] = fmaxf(fm[k], __fadd_rn(t_now, pend_tail[e]));
            pend_cnt[e] = 0;
            pend_tail[e] = 0.f;
          } else {  // migrated: the cold copy exists
            gs = kPresent;
            gcs_state[e] = kPresent;
            if (no_cons && d == kPresent) {
              d = kAbsent;
              dr[k] = sizes[e];
            }
          }
          slot = false;
          tr_slot[e] = 0;
          nd[k] = 0.f;
          tr_total[e] = inf;
          tr_start[e] = inf;
        }
        if (slot) {
          if (lt < 0) lt = link_type(tr_link[e]);
          held[0] += lt == 0;  // constant indices: the counts stay in registers
          held[1] += lt == 1;
          held[2] += lt == 2;
        }
        if (no_cons && d == kPresent && lim) {
          if (gs < 0) gs = gcs_state[e];
          const bool pop = pop_ok[e] != 0;
          if (!gen || gs == kPresent || (gs == kAbsent && !pop)) {
            d = kAbsent;
            de[k] = sizes[e];
          } else if (gs == kAbsent) {  // gen && pop
            w[k] = 1;
          }
        }
        if (d != ds[k]) disk_state[e] = d;
      }
      st4(tr_done, i, n, vec, nd);
      st4(want, i, n, vec, w);
    }
    // the step's 1024 elements are 8 aligned runs of 128, one a warp
    const float d_sum = warp_tree(tree4(dr)), e_sum = warp_tree(tree4(de));
    if (lane == 0) {
      s_sum[0][step * kWarps + warp] = d_sum;
      s_sum[1][step * kWarps + warp] = e_sum;
    }
  }
  __syncthreads();
  if (warp == 0) {  // the tile's 32 runs of 128 in index order
    const float d_tile = warp_tree(s_sum[0][lane]);
    const float e_tile = warp_tree(s_sum[1][lane]);
    if (lane == 0) {  // thread 0, which fences before its ticket
      float* p = partials + 2 * (static_cast<int64_t>(r) * nt + blockIdx.x);
      p[0] = d_tile;
      p[1] = e_tile;
    }
  }
  int32_t* const dst[3] = {work.occ + 3 * r, work.occ + 3 * r + 1,
                           work.occ + 3 * r + 2};
  add_block_counts<3>(held, dst);
  if (!last_block(work.ticket_complete)) return;
  for (int64_t j = threadIdx.x; j < 3 * R; j += blockDim.x) {
    const float occ = __int2float_rn(__ldcg(work.occ + j));
    const float free = clamp0(__fsub_rn(slots[j], occ));
    const float n_q = __int2float_rn(lq_next[j] - lq_serve[j]);
    const int32_t admit = __float2int_rz(fminf(free, n_q));
    lq_serve[j] += admit;
    occ3[j] = __fadd_rn(occ, __int2float_rn(admit));
  }
  for (int64_t q = warp; q < R; q += kWarps) {  // a warp a row
    const float* p = partials + 2 * q * nt;
    const float d_row = row_tree(p, nt, 2);
    const float e_row = row_tree(p + 1, nt, 2);
    if (lane == 0) disk_used[q] = __fsub_rn(__fsub_rn(disk_used[q], d_row), e_row);
  }
}

// ---------------------------------------------------------- flag streams
// tg_link_admit, tg_migrate and tg_wait_select read one flag plane densely
// (lq_queued, mig, wq_wait) and touch the other planes only where a flag
// is set. On the sweep's state almost no flag is set, so each is a stream
// of 16 MB; 4-byte loads, each waited on before the next, on 4,096-flag
// blocks streamed it at 0.7-1.25 TB/s. Here a thread starts kFlagLoads 16-byte loads (streaming hint: the
// plane is read once a tick) before it uses any: a run of 16,384 flags a
// block step, on a grid of kFlagBlocksPerSm blocks an SM (the wrapper's
// flag_blocks; block b of a row's nb takes runs b, b + nb, ...,
// ops.flag_ranges), so at least half of a plane is asked for at once; a word
// of 16 flags with none set costs one compare, a step with none in its warp
// one vote. The row's constants are read only by a warp that finds a set
// flag, after its flags are in flight. Where a warp's 512 flags of a load
// hold set ones, the warp takes them 32 consecutive elements a round (lane j
// on element 32q + j, its flag by a shuffle of the loading lanes' bit
// masks), so every gather and store of the sparse work is one instruction
// over 32 consecutive elements; it starts the gathers of a batch of rounds
// (kBatch; kWaitBatch in tg_wait_select) before it applies any, so a dense
// row waits on memory once a batch, not once a round. Each element is
// loaded, and written, by one warp, and no step gathers from a plane it
// writes, so a lane's stores never meet a load of another lane's. In the
// sweep's replayed tick, ticks 60-100 (scripts/bench_tick.py, H100 SXM at
// 700 W): tg_link_admit 7.9-8.0 us, tg_migrate 9.4 us, against 4.8 us for
// 16 MB at 3.35 TB/s. The batch size
// (4 to 16 rounds), 8 loads a step and 2 to 8 blocks an SM moved neither
// kernel beyond the run-to-run spread on either of scripts/bench_glue.py's
// states.

// Bit k: byte k of w is nonzero (bytes made 0/1, then gathered by one
// multiply: byte 3 of the product is b0 + 2 b1 + 4 b2 + 8 b3).
__device__ __forceinline__ uint32_t nz_bits(uint32_t w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ uint32_t flag_bits(uint4 x) {
  return nz_bits(x.x) | nz_bits(x.y) << 4 | nz_bits(x.z) << 8 | nz_bits(x.w) << 12;
}

// The 16 flags of a row from f: one streaming 16-byte load when vec (F %
// 16 == 0 and the plane 16-byte aligned, so a word lies in the row or past
// it), else byte by byte; zero past F.
__device__ __forceinline__ uint4 load_flags(const uint8_t* row, int64_t f,
                                            int64_t F, bool vec) {
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  if (f >= F) return x;
  if (vec) return __ldcs(reinterpret_cast<const uint4*>(row + f));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const int n = static_cast<int>(F - f < kFlagVec ? F - f : kFlagVec);
  for (int b = 0; b < n; ++b) w[b / 4] |= uint32_t(row[f + b] != 0) << (8 * (b % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// For row blockIdx.y in this block's runs (runs blockIdx.x, + gridDim.x,
// ...): the step's kFlagLoads words a thread, loaded first; seen(run, x)
// with them, in every thread (run the row offset of the run's first flag,
// word u of the thread at run + u * kFlagSpan + 16 * threadIdx.x; a word
// it zeroes is taken no further); then, in a warp with a set flag,
// prepare() once (the row's constants), and for its set flags v =
// gather(e) over Batch rounds, then apply(e, v) for each (e the flat
// index). Every thread of the block calls it.
template <int Batch, typename Seen, typename Prepare, typename Gather,
          typename Apply>
__device__ __forceinline__ void for_each_flag(const uint8_t* flags, int64_t F,
                                              bool vec, Seen seen,
                                              Prepare prepare, Gather gather,
                                              Apply apply) {
  using Value = decltype(gather(int64_t(0)));
  static_assert(kFlagLoads * 16 <= 64, "a step's rounds fill one 64-bit mask");
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * F;
  const uint8_t* row = flags + row0;
  const int64_t mine = static_cast<int64_t>(threadIdx.x) * kFlagVec;
  const int64_t warp0 = static_cast<int64_t>(threadIdx.x / 32) * 32 * kFlagVec;
  bool prepared = false;  // the same in every lane of a warp
  for (int64_t run = static_cast<int64_t>(blockIdx.x) * kFlagRun; run < F;
       run += static_cast<int64_t>(gridDim.x) * kFlagRun) {
    uint4 x[kFlagLoads];
#pragma unroll
    for (int u = 0; u < kFlagLoads; ++u)
      x[u] = load_flags(row, run + u * kFlagSpan + mine, F, vec);
    seen(run, x);
    uint32_t any = 0u;
#pragma unroll
    for (int u = 0; u < kFlagLoads; ++u) any |= x[u].x | x[u].y | x[u].z | x[u].w;
    if (!__any_sync(full, any != 0u)) continue;
    if (!prepared) {
      prepare();
      prepared = true;
    }
    // lane q < 16 holds round q of each load: the bits of lanes 2q, 2q + 1;
    // todo bit 16u + q: round q of load u has a set flag
    uint32_t pair[kFlagLoads];
    uint64_t todo = 0u;
#pragma unroll
    for (int u = 0; u < kFlagLoads; ++u) {
      const uint32_t m16 = flag_bits(x[u]);
      const uint32_t lo = __shfl_sync(full, m16, (2 * lane) & 31);
      const uint32_t hi = __shfl_sync(full, m16, (2 * lane + 1) & 31);
      pair[u] = lo | hi << 16;
      const uint64_t b = __ballot_sync(full, lane < 16 && pair[u] != 0u);
      todo |= b << (16 * u);
    }
    const int64_t base = row0 + run + warp0 + lane;
    while (todo != 0u) {  // the same in every lane
      int bit[Batch];
      Value v[Batch];
#pragma unroll
      for (int k = 0; k < Batch; ++k) {
        bit[k] = -1;
        v[k] = Value{};
        if (todo == 0u) continue;
        const int b = __ffsll(static_cast<long long>(todo)) - 1;
        todo &= todo - 1;
        uint32_t p = pair[0];
#pragma unroll
        for (int u = 1; u < kFlagLoads; ++u) p = (b >> 4) == u ? pair[u] : p;
        if ((__shfl_sync(full, p, b & 15) >> lane) & 1u) {
          bit[k] = b;
          v[k] = gather(base + (b >> 4) * kFlagSpan + 32 * (b & 15));
        }
      }
#pragma unroll
      for (int k = 0; k < Batch; ++k)
        if (bit[k] >= 0) apply(base + (bit[k] >> 4) * kFlagSpan + 32 * (bit[k] & 15), v[k]);
    }
  }
}

// The same with nothing done on the loaded words, kBatch rounds a batch.
template <typename Prepare, typename Gather, typename Apply>
__device__ __forceinline__ void for_each_flag(const uint8_t* flags, int64_t F,
                                              bool vec, Prepare prepare,
                                              Gather gather, Apply apply) {
  for_each_flag<kBatch>(
      flags, F, vec, [](int64_t, const uint4(&)[kFlagLoads]) {}, prepare,
      gather, apply);
}

// ----------------------------------------------------------- link_admit
// lq_queued streamed; for each queued transfer its ticket against its
// link's serve counter (advanced by tg_complete): admitted ones take the
// slot, start at now + latency and leave the queue. The row's three serve
// counters and starts are read once a warp that finds a queued transfer.
__global__ void __launch_bounds__(kThreads, kFlagBlocksPerSm)
tg_link_admit_kernel(const float* __restrict__ now,
                     const int32_t* __restrict__ tr_link,
                     const int32_t* __restrict__ lq_ticket,
                     const int32_t* __restrict__ lq_serve,
                     const float* __restrict__ latency, int64_t F, int vec,
                     uint8_t* __restrict__ tr_slot,
                     float* __restrict__ tr_start,
                     uint8_t* __restrict__ lq_queued) {
  const int64_t r3 = 3 * static_cast<int64_t>(blockIdx.y);
  int32_t serve[3];
  float start[3];
  for_each_flag(
      lq_queued, F, vec,
      [&] {
        const float t_now = *now;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          serve[k] = lq_serve[r3 + k];
          start[k] = __fadd_rn(t_now, latency[r3 + k]);
        }
      },
      [&](int64_t e) { return make_int2(tr_link[e], lq_ticket[e]); },
      [&](int64_t e, int2 v) {  // v: the link id and the ticket
        const int lt = link_type(v.x);
        if (v.y < (lt == 0 ? serve[0] : lt == 1 ? serve[1] : serve[2])) {
          tr_slot[e] = 1;
          tr_start[e] = lt == 0 ? start[0] : lt == 1 ? start[1] : start[2];
          lq_queued[e] = 0;
        }
      });
}

// -------------------------------------------------------------- migrate
// mig streamed; each admitted migration goes IN_FLIGHT on the cold tier
// and onto its site's disk->gcs link: direct (slot held, start now) while
// the link queue is empty and its rank is below the free slots, else
// queued with ticket lq_next + rank - n_direct. For a queued file n_direct
// has a closed form: 0 while the queue is busy; else every rank below
// free_m is direct and the file's own rank is not, so n_direct =
// ceil(free_m). The row's counters are read once a warp that finds a
// migration; the block's direct and queued counts are summed in registers
// over its runs and added once; the last block adds the row counts:
// lq_next[.., 2] += queued, occ3[.., 2] += direct.
__global__ void __launch_bounds__(kThreads, kFlagBlocksPerSm)
tg_migrate_kernel(const float* __restrict__ now,
                  const uint8_t* __restrict__ mig,
                  const int32_t* __restrict__ rank,
                  const float* __restrict__ sizes,
                  const float* __restrict__ slots,
                  const int32_t* __restrict__ mig_link,
                  const int32_t* __restrict__ lq_serve, int S, int64_t F,
                  int vec, int32_t* __restrict__ gcs_state,
                  uint8_t* __restrict__ tr_slot, int32_t* __restrict__ tr_link,
                  float* __restrict__ tr_total, float* __restrict__ tr_done,
                  float* __restrict__ tr_start,
                  int32_t* __restrict__ lq_ticket,
                  uint8_t* __restrict__ lq_queued,
                  int32_t* __restrict__ lq_next, float* __restrict__ occ3,
                  int32_t* __restrict__ work_base) {
  const int64_t R = static_cast<int64_t>(gridDim.y);
  const Work work = carve(work_base, R);
  const int r = blockIdx.y;
  const int64_t j2 = 3 * static_cast<int64_t>(r) + 2;
  float t_now = 0.f, free_m = 0.f;
  int32_t lqn = 0, link = 0;
  bool q_empty = false;
  int counts[2] = {0, 0};  // direct, queued
  for_each_flag(
      mig, F, vec,
      [&] {
        t_now = *now;
        lqn = lq_next[j2];
        q_empty = lqn == lq_serve[j2];
        free_m = clamp0(__fsub_rn(slots[j2], occ3[j2]));
        link = mig_link[r % S];
      },
      [&](int64_t e) { return make_int2(rank[e], __float_as_int(sizes[e])); },
      [&](int64_t e, int2 v) {  // v: the rank and the size's bits
        const int32_t rk = v.x;
        gcs_state[e] = kInFlight;
        if (q_empty && __int2float_rn(rk) < free_m) {
          tr_slot[e] = 1;
          tr_start[e] = t_now;
          counts[0] += 1;
        } else {
          // here rk >= free_m when the queue is empty, so ceil is in range
          const int32_t n_direct = q_empty ? static_cast<int32_t>(ceilf(free_m)) : 0;
          lq_ticket[e] = lqn + (rk - n_direct);
          lq_queued[e] = 1;
          counts[1] += 1;
        }
        tr_link[e] = link;
        tr_total[e] = __int_as_float(v.y);
        tr_done[e] = 0.f;
      });
  int32_t* const dst[2] = {work.n_direct + r, work.n_queued + r};
  add_block_counts<2>(counts, dst);
  if (!last_block(work.ticket_migrate)) return;
  for (int64_t q = threadIdx.x; q < R; q += blockDim.x) {
    lq_next[3 * q + 2] += __ldcg(work.n_queued + q);
    occ3[3 * q + 2] =
        __fadd_rn(occ3[3 * q + 2], __int2float_rn(__ldcg(work.n_direct + q)));
  }
}

// ---------------------------------------------------------- wait_select
// The W lowest keys ticket * F + index of each row (a file that does not
// wait keyed with ticket 2^30), ascending: lowest = key / F, idx = key % F.
// wq_wait is streamed as a flag plane (for_each_flag, on tg_link_admit's
// grid). Each waiting file's key goes into one lane's list, the lane's C
// lowest keys sorted in registers (C >= W; C = 4 for W <= 4, the sweep's,
// else 32). Where a warp's 512 flags of a load hold few waiting files, the
// warp gathers their tickets 32 consecutive files a round, kWaitBatch
// rounds at once; where they hold kDenseWait or more, each thread keys its
// own waiting files (their tickets in its own 64 bytes) and the rounds
// skip the load. On the dense synthetic state the rounds alone took 97.9-
// 103.7 us, this 42.9-43.4 (scripts/bench_glue.py, H100 SXM at 700 W).
//
// The fill: only block 0 of a row keys files that do not wait, and only in
// run 0. Their keys, 2^30 F + f, are above every waiting key (tickets are
// below 2^30) and grow with the index f. So they enter a row's W lowest
// only when n < W files wait, and then as the W - n lowest indices of
// files that do not wait. Run 0 holds the row's first min(F, FLAG_RUN)
// flags, at least W of them (W <= F, FLAG_RUN = 16384 >= 32 >= W), at
// most n waiting: so those W - n indices all lie in run 0, which is block
// 0's first step. There each thread seeds its list with the first C keys
// of files that do not wait among its own 64 flags (a find-first-zero
// over its words, whose flags it takes in index order); one of the W - n
// that lies in a thread's flags has at most W - n - 1 <= C - 1 such files
// before it there, so it is among them. tests/test_torch_wait_select.py
// holds a model of this partition and fill to ref.wait_select.
//
// Then each warp's lowest, the block's (warp 0 over the warps' lists),
// written to keys[R, blocks, C] (a block with no key writes the empty
// list); the last block takes each row's lowest over its blocks' lists, a
// segment of G lanes a row (G = 16 for C = 4, 32 else). For C = 4 each of
// these is a butterfly of merges of two sorted lists of 4 (merge4), for C
// = 32 W rounds of a segment minimum. In the replayed tick this code runs
// cold, once a block, after the stream (scripts/trace_wait_select.py), so
// it is kept in loops: the last block's lists all loaded before the first
// merge, unrolled, took 15.35-15.44 us a tick against 14.51-14.52 for the
// loop below (two calls, the parents there 23.99-24.43), and a single
// loop each for a block's levels (shuffles, then shared memory) and for
// the last block's lists and levels 15.96-15.98 against 14.68-14.80 in
// one call (scripts/bench_tick.py).

// Inserts key into the ascending list k[0..C) if it is below k[C-1].
template <int C>
__device__ __forceinline__ void insert_key(int64_t (&k)[C], int64_t key) {
  if (key >= k[C - 1]) return;
#pragma unroll
  for (int j = C - 1; j > 0; --j) {
    const int64_t a = k[j - 1];
    k[j] = key < a ? a : (key < k[j] ? key : k[j]);
  }
  if (key < k[0]) k[0] = key;
}

// The W lowest keys over the lists of the warp's lanes, ascending: lane j
// < W returns the j-th (kNoKey past the last key). Each round takes the
// warp's least head; its one owner pops it (keys are unique in a row).
template <int C>
__device__ int64_t warp_lowest(int64_t (&k)[C], int W) {
  const int lane = threadIdx.x & 31;
  int64_t mine = kNoKey;
  for (int j = 0; j < W; ++j) {
    int64_t m = k[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int64_t x = __shfl_xor_sync(0xffffffffu, m, o);
      m = x < m ? x : m;
    }
    if (m == kNoKey) break;  // the same in every lane
    if (k[0] == m) {
#pragma unroll
      for (int i = 0; i + 1 < C; ++i) k[i] = k[i + 1];
      k[C - 1] = kNoKey;
    }
    if (lane == j) mine = m;
  }
  return mine;
}

__device__ __forceinline__ void cx(int64_t& x, int64_t& y) {
  const int64_t lo = x < y ? x : y;
  y = x < y ? y : x;
  x = lo;
}

// a = the 4 lowest of the ascending lists a and b, ascending: the lower
// half of a bitonic merge (min of a and b reversed is bitonic), sorted.
__device__ __forceinline__ void merge4(int64_t (&a)[4], const int64_t (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = a[i] < b[3 - i] ? a[i] : b[3 - i];
  cx(a[0], a[2]);
  cx(a[1], a[3]);
  cx(a[0], a[1]);
  cx(a[2], a[3]);
}

// The 4 lowest keys over the ascending lists of an aligned segment of G
// lanes, in every lane of it: a butterfly of merge4, kept a loop (its code
// is fetched once). Every lane of the warp calls it.
__device__ __forceinline__ void seg_lowest4(int64_t (&k)[4], int G) {
#pragma unroll 1
  for (int o = 1; o < G; o <<= 1) {
    int64_t b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = __shfl_xor_sync(0xffffffffu, k[i], o);
    merge4(k, b);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, C <= 4 ? kFlagBlocksPerSm : 1)
tg_wait_select_kernel(const uint8_t* __restrict__ wait,
                      const int32_t* __restrict__ ticket, int64_t F, int W,
                      int vec, int64_t* __restrict__ keys,
                      int32_t* __restrict__ lowest, int64_t* __restrict__ idx,
                      int32_t* __restrict__ work_base) {
  __shared__ int64_t s_keys[kWarps * C];
  const int64_t R = static_cast<int64_t>(gridDim.y);
  const int64_t nb = static_cast<int64_t>(gridDim.x);
  const Work work = carve(work_base, R);
  const int r = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int64_t row0 = static_cast<int64_t>(r) * F;
  int64_t k[C];
#pragma unroll
  for (int j = 0; j < C; ++j) k[j] = kNoKey;
  for_each_flag<kWaitBatch>(
      wait, F, vec,
      [&](int64_t run, uint4 (&x)[kFlagLoads]) {
        const int64_t mine = static_cast<int64_t>(threadIdx.x) * kFlagVec;
        if (run == 0) {  // the fill
          const int64_t big = kBigTicket * F;
          int taken = 0;
#pragma unroll
          for (int u = 0; u < kFlagLoads; ++u) {
            const int64_t f = u * kFlagSpan + mine;
            const int n = f >= F ? 0 : static_cast<int>(F - f < kFlagVec ? F - f : kFlagVec);
            // the files of the word that do not wait, bit b for file f + b
            uint32_t z = ~flag_bits(x[u]) & ((1u << n) - 1u);
            for (; z != 0u && taken < C; z &= z - 1u, ++taken)
              insert_key<C>(k, big + f + (__ffs(z) - 1));
          }
        }
        // a dense load: each thread keys its own waiting files
        uint32_t any = 0u;
#pragma unroll
        for (int u = 0; u < kFlagLoads; ++u) any |= x[u].x | x[u].y | x[u].z | x[u].w;
        if (!__any_sync(0xffffffffu, any != 0u)) return;
#pragma unroll
        for (int u = 0; u < kFlagLoads; ++u) {
          const uint32_t m = flag_bits(x[u]);
          if (__reduce_add_sync(0xffffffffu, __popc(m)) < kDenseWait) continue;
          x[u] = make_uint4(0u, 0u, 0u, 0u);
          const int64_t f = run + u * kFlagSpan + mine;
          const int32_t* t = ticket + row0 + f;
#pragma unroll 1
          for (uint32_t z = m; z != 0u; z &= z - 1u) {
            const int b = __ffs(z) - 1;
            insert_key<C>(k, static_cast<int64_t>(t[b]) * F + (f + b));
          }
        }
      },
      [] {},
      [&](int64_t e) { return ticket[e]; },
      [&](int64_t e, int32_t t) {
        insert_key<C>(k, static_cast<int64_t>(t) * F + (e - row0));
      });
  int64_t* part = keys + (static_cast<int64_t>(r) * nb + blockIdx.x) * C;
  if constexpr (C == 4) {
    // the warp's 4 lowest in each lane, then the block's in warp 0; thread
    // 0 writes them, and last_block's fence covers its stores. A block
    // with no key writes the empty list.
    if (__syncthreads_or(k[0] != kNoKey)) {
      seg_lowest4(k, 32);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s_keys[warp * 4 + i] = k[i];
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) k[i] = lane < kWarps ? s_keys[lane * 4 + i] : kNoKey;
        seg_lowest4(k, kWarps);
      }
    }
    if (threadIdx.x == 0) {
      reinterpret_cast<longlong2*>(part)[0] = make_longlong2(k[0], k[1]);
      reinterpret_cast<longlong2*>(part)[1] = make_longlong2(k[2], k[3]);
    }
  } else {
    // the warp's W lowest, then the block's (warp 0 over the warps' lists)
    const int64_t mine = warp_lowest<C>(k, W);
    if (lane < C) s_keys[warp * C + lane] = mine;
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int j = 0; j < C; ++j) k[j] = kNoKey;
      for (int j = lane; j < kWarps * C; j += 32) insert_key<C>(k, s_keys[j]);
      const int64_t best = warp_lowest<C>(k, W);
      if (lane < C) {
        part[lane] = best;
        __threadfence();  // each writer fences before thread 0 takes the ticket
      }
    }
  }
  if (!last_block(work.ticket_wait)) return;
  // a segment of G lanes a row: for C = 4 a lane's lists one at a time,
  // the next loaded while the last merges; for C = 32 kMergeLoads keys at
  // a time, all in flight before the first insert; then the segment's
  // lowest
  constexpr int G = C <= 4 ? 16 : 32;
  constexpr int kSegs = kThreads / G;
  const int j0 = threadIdx.x & (G - 1);
  for (int64_t q0 = 0; q0 < R; q0 += kSegs) {  // the same in every thread
    const int64_t q = q0 + threadIdx.x / G;
#pragma unroll
    for (int j = 0; j < C; ++j) k[j] = kNoKey;
    int64_t best;
    if constexpr (C == 4) {
      if (q < R) {  // lists j0, j0 + G, ...: the next one loaded while
                    // the last is merged
        const longlong2* p = reinterpret_cast<const longlong2*>(keys + q * nb * 4);
        const longlong2 none = make_longlong2(kNoKey, kNoKey);
        longlong2 a = j0 < nb ? __ldcg(p + 2 * j0) : none;
        longlong2 b = j0 < nb ? __ldcg(p + 2 * j0 + 1) : none;
#pragma unroll 1
        for (int64_t j = j0; j < nb; j += G) {
          const bool more = j + G < nb;
          const longlong2 na = more ? __ldcg(p + 2 * (j + G)) : none;
          const longlong2 nb2 = more ? __ldcg(p + 2 * (j + G) + 1) : none;
          const int64_t l[4] = {a.x, a.y, b.x, b.y};
          merge4(k, l);
          a = na;
          b = nb2;
        }
      }
      seg_lowest4(k, G);
      best = j0 == 0 ? k[0] : j0 == 1 ? k[1] : j0 == 2 ? k[2] : k[3];
    } else {
      if (q < R) {
        const int64_t* p = keys + q * nb * C;
        for (int64_t j = j0; j < nb * C; j += G * kMergeLoads) {
          int64_t v[kMergeLoads];
#pragma unroll
          for (int i = 0; i < kMergeLoads; ++i)
            v[i] = j + i * G < nb * C ? __ldcg(p + j + i * G) : kNoKey;
#pragma unroll
          for (int i = 0; i < kMergeLoads; ++i) insert_key<C>(k, v[i]);
        }
      }
      best = warp_lowest<C>(k, W);  // G = 32: a segment is a warp
    }
    if (q < R && j0 < W) {  // floor division, as ref's // and %
      int64_t t = best / F, i = best % F;
      if (i < 0) {
        i += F;
        t -= 1;
      }
      lowest[q * W + j0] = static_cast<int32_t>(t);
      idx[q * W + j0] = i;
    }
  }
}

inline int64_t tiles(int64_t n, int64_t tile) { return (n + tile - 1) / tile; }

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

// The launch grid: the tiles of a row (of `tile` elements) by the R = L*S
// rows; at least one tile a row, so that the last block of a launch
// exists at F = 0.
inline bool plane_grid(int L, int S, long long F, dim3* grid,
                       int64_t tile = kTile) {
  const int64_t R = static_cast<int64_t>(L) * S;
  if (L < 0 || S < 0 || F < 0 || R > 65535) return false;  // rows: gridDim.y
  const int64_t nt = tiles(F, tile) > 0 ? tiles(F, tile) : 1;
  if (nt * R > 0x7fffffff) return false;  // tickets count blocks in an int
  *grid = dim3(static_cast<unsigned>(nt), static_cast<unsigned>(R));
  return true;
}

// The flag streams' grid (tg_link_admit, tg_migrate, tg_wait_select):
// `blocks` blocks a row (from the wrapper, ops.flag_blocks), 1 to the
// row's runs of kFlagRun flags (1 at F = 0), by the R = L*S rows.
inline bool flag_grid(int L, int S, long long F, int blocks, dim3* grid) {
  if (!plane_grid(L, S, F, grid, kFlagRun)) return false;
  if (blocks < 1 || static_cast<unsigned>(blocks) > grid->x) return false;
  grid->x = static_cast<unsigned>(blocks);
  return true;
}

// The keys a thread keeps in tg_wait_select: C = 4 for W <= 4 (the sweep's
// W), else 32.
inline int wait_list(int W) { return W <= 4 ? 4 : 32; }

}  // namespace

extern "C" {

long long tg_work_ints(int L, int S) {
  return work_ints(static_cast<int64_t>(L) * S);
}

// Floats of tg_complete's partials: two a block, (L*S) x tiles(F) blocks.
long long tg_complete_scratch(int L, int S, long long F) {
  dim3 grid;
  if (!plane_grid(L, S, F, &grid)) return -1;
  return 2LL * grid.x * grid.y;
}

// int64 keys of tg_wait_select's partials: C a block, (L*S) x blocks
// blocks.
long long tg_wait_scratch(int L, int S, long long F, int W, int blocks) {
  dim3 grid;
  if (!flag_grid(L, S, F, blocks, &grid) || W < 1 || W > 32) return -1;
  return static_cast<long long>(wait_list(W)) * grid.x * grid.y;
}

const char* tg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Planes [L, S, F] (row r = l*S + s); now and dt 0-d f32. Outputs: active
// [L, S, F] (bool); work, tg_work_ints(L, S) int32, zeroed. One launch.
int tg_begin(const void* tr_slot, const void* tr_start, const void* now,
             const void* dt, int L, int S, long long F, void* active,
             void* work, void* stream) {
  dim3 grid;
  if (!plane_grid(L, S, F, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  if (grid.y == 0) return static_cast<int>(cudaSuccess);
  const int vec = F % 4 == 0 && aligned(tr_slot, 4) && aligned(active, 4) &&
                  aligned(tr_start, 16);
  tg_begin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tr_slot), static_cast<const float*>(tr_start),
      static_cast<const float*>(now), static_cast<const float*>(dt), F, vec,
      static_cast<uint8_t*>(active), static_cast<int32_t*>(work),
      work_ints(static_cast<int64_t>(L) * S));
  return static_cast<int>(cudaGetLastError());
}

// Planes [L, S, F]; limited [L, S] and gcs_en [L] (bool); slots, lq_next
// and lq_serve [L, 3S]; disk_used [L, S] (updated); work from tg_begin of
// the same tick; partials, tg_complete_scratch(L, S, F) floats. Outputs:
// want [L, S, F] (bool), occ3 [L, 3S] f32. One launch.
int tg_complete(const void* now, const void* new_done, const void* comp,
                const void* sizes, const void* limited, const void* gcs_en,
                const void* pop_ok, const void* slots, const void* lq_next,
                const void* tr_link, int L, int S, long long F,
                void* disk_state, void* gcs_state, void* tr_slot,
                void* tr_done, void* tr_total, void* tr_start, void* pend_cnt,
                void* pend_tail, void* fin_max, void* lq_serve,
                void* disk_used, void* want, void* occ3, void* partials,
                void* work, void* stream) {
  dim3 grid;
  if (!plane_grid(L, S, F, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  if (grid.y == 0) return static_cast<int>(cudaSuccess);
  const int vec = F % 4 == 0 && aligned(comp, 4) && aligned(tr_slot, 4) &&
                  aligned(want, 4) && aligned(new_done, 16) &&
                  aligned(pend_cnt, 16) && aligned(fin_max, 16) &&
                  aligned(disk_state, 16) && aligned(tr_done, 16);
  tg_complete_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(now), static_cast<const float*>(new_done),
      static_cast<const uint8_t*>(comp), static_cast<const float*>(sizes),
      static_cast<const uint8_t*>(limited), static_cast<const uint8_t*>(gcs_en),
      static_cast<const uint8_t*>(pop_ok), static_cast<const float*>(slots),
      static_cast<const int32_t*>(lq_next), static_cast<const int32_t*>(tr_link),
      S, F, vec, static_cast<int32_t*>(disk_state),
      static_cast<int32_t*>(gcs_state), static_cast<uint8_t*>(tr_slot),
      static_cast<float*>(tr_done), static_cast<float*>(tr_total),
      static_cast<float*>(tr_start), static_cast<int32_t*>(pend_cnt),
      static_cast<float*>(pend_tail), static_cast<float*>(fin_max),
      static_cast<int32_t*>(lq_serve), static_cast<float*>(disk_used),
      static_cast<uint8_t*>(want), static_cast<float*>(occ3),
      static_cast<float*>(partials), static_cast<int32_t*>(work));
  return static_cast<int>(cudaGetLastError());
}

// Planes [L, S, F]; lq_serve and latency [L, 3S]; blocks a row from
// ops.flag_blocks. Updates tr_slot, tr_start and lq_queued in place. One
// launch.
int tg_link_admit(const void* now, const void* tr_link, const void* lq_ticket,
                  const void* lq_serve, const void* latency, int L, int S,
                  long long F, int blocks, void* tr_slot, void* tr_start,
                  void* lq_queued, void* stream) {
  dim3 grid;
  if (!flag_grid(L, S, F, blocks, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid.y == 0) return static_cast<int>(cudaSuccess);
  const int vec = F % kFlagVec == 0 && aligned(lq_queued, 16);
  tg_link_admit_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(now), static_cast<const int32_t*>(tr_link),
      static_cast<const int32_t*>(lq_ticket),
      static_cast<const int32_t*>(lq_serve), static_cast<const float*>(latency),
      F, vec, static_cast<uint8_t*>(tr_slot), static_cast<float*>(tr_start),
      static_cast<uint8_t*>(lq_queued));
  return static_cast<int>(cudaGetLastError());
}

// Planes [L, S, F] (mig bool, rank int32 as gcs_admit returns them);
// slots, lq_serve and lq_next [L, 3S]; mig_link [S]; blocks a row from
// ops.flag_blocks; occ3 [L, 3S] from tg_complete; work from tg_begin of
// the same tick. One launch.
int tg_migrate(const void* now, const void* mig, const void* rank,
               const void* sizes, const void* slots, const void* mig_link,
               const void* lq_serve, int L, int S, long long F, int blocks,
               void* gcs_state, void* tr_slot, void* tr_link, void* tr_total,
               void* tr_done, void* tr_start, void* lq_ticket, void* lq_queued,
               void* lq_next, void* occ3, void* work, void* stream) {
  dim3 grid;
  if (!flag_grid(L, S, F, blocks, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid.y == 0) return static_cast<int>(cudaSuccess);
  const int vec = F % kFlagVec == 0 && aligned(mig, 16);
  tg_migrate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(now), static_cast<const uint8_t*>(mig),
      static_cast<const int32_t*>(rank), static_cast<const float*>(sizes),
      static_cast<const float*>(slots), static_cast<const int32_t*>(mig_link),
      static_cast<const int32_t*>(lq_serve), S, F, vec,
      static_cast<int32_t*>(gcs_state), static_cast<uint8_t*>(tr_slot),
      static_cast<int32_t*>(tr_link), static_cast<float*>(tr_total),
      static_cast<float*>(tr_done), static_cast<float*>(tr_start),
      static_cast<int32_t*>(lq_ticket), static_cast<uint8_t*>(lq_queued),
      static_cast<int32_t*>(lq_next), static_cast<float*>(occ3),
      static_cast<int32_t*>(work));
  return static_cast<int>(cudaGetLastError());
}

// wq_wait [L, S, F] (bool) and wq_ticket [L, S, F] int32; 1 <= W <= 32,
// W <= F; blocks a row from ops.flag_blocks; keys, tg_wait_scratch(L, S,
// F, W, blocks) int64; work from tg_begin of the same tick. Outputs:
// lowest [L, S, W] int32, idx [L, S, W] int64. One launch.
int tg_wait_select(const void* wq_wait, const void* wq_ticket, int L, int S,
                   long long F, int W, int blocks, void* keys, void* lowest,
                   void* idx, void* work, void* stream) {
  dim3 grid;
  if (!flag_grid(L, S, F, blocks, &grid) || W < 1 || W > 32 || W > F)
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid.y == 0) return static_cast<int>(cudaSuccess);
  const int vec = F % kFlagVec == 0 && aligned(wq_wait, 16) && aligned(wq_ticket, 16);
  const auto launch = W <= 4 ? tg_wait_select_kernel<4> : tg_wait_select_kernel<32>;
  launch<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wq_wait),
      static_cast<const int32_t*>(wq_ticket), F, W, vec,
      static_cast<int64_t*>(keys), static_cast<int32_t*>(lowest),
      static_cast<int64_t*>(idx), static_cast<int32_t*>(work));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
