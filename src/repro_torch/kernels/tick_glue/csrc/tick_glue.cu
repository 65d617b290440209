// Hand-written Hopper (sm_90a) kernels of the batched sweep tick's glue:
// the state updates between the three lane-tick kernels of a tick, one
// pass over the [L, S, F] planes each (row r = l*S + s), computing what
// ../ref.py computes:
//
//   tg_begin       <- ref.begin      (src/repro/sim/batched.py:205-206)
//   tg_complete    <- ref.complete   (:195, :227-279, :287, :295-300,
//                                     :332-333)
//   tg_link_admit  <- ref.link_admit (:280-286)
//   tg_migrate     <- ref.migrate    (:331, :336-353)
//
// No TPU kernel holds this work: in the JAX package XLA fuses these lines
// of the jitted tick into a few passes. Run as PyTorch operations they
// were about ninety plane-sized kernels a tick, each reading and writing
// whole planes.
//
// Bound on this card: each element is read and written once and takes a
// handful of compares, so every kernel is bound by device-memory
// bandwidth (3.35 TB/s on an H100 SXM). The design reads densely only
// what every element needs (flags, the consumer counters, disk_state) in
// 16-byte loads (4-byte ones for the bool planes), four elements a thread,
// and touches the other planes only where a mask is set: completions,
// held slots, queued transfers, candidates, migrations. Floats round as
// the plain version's separate operations do (__fadd_rn, __fsub_rn, the
// integer conversions of PyTorch's casts), so every output is bitwise the
// plain version's.
//
// Counts are integers: warp sums (__reduce_add_sync), a shared sum a
// block, one integer atomic a block and counter. A block cannot see the
// counts that its own launch changes, so the [L, 3S] work on whole-row
// counts (the link-slot prologue in tg_complete, the migration queue's
// counters in tg_migrate) runs in the launch's last block: each block's
// thread 0 adds its counts, fences and takes a ticket, and the block with
// the last ticket sees every other block's counts and the end of their
// reads. The counters and tickets live in one int32 buffer that tg_begin
// zeroes at the start of each tick (tg_work_ints), so a captured tick
// needs no memset. No float atomics: every result is the same from run to
// run.
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

// File-location states; must match ../ref.py.
constexpr int32_t kAbsent = 0, kInFlight = 1, kPresent = 2;

// The work buffer (int32): the post-completion link occupancy [R, 3], the
// direct and queued migrations [R] each, the two launches' tickets.
struct Work {
  int32_t* occ;
  int32_t* n_direct;
  int32_t* n_queued;
  int32_t* ticket_complete;
  int32_t* ticket_migrate;
};

__host__ __device__ inline Work carve(int32_t* base, int64_t R) {
  return Work{base, base + 3 * R, base + 4 * R, base + 5 * R, base + 5 * R + 1};
}

inline int64_t work_ints(int64_t R) { return 5 * R + 2; }

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
// updated disk_state. Writes the masked size planes of the dropped and
// the deleted copies (their row sums, taken by the wrapper with
// torch.sum, update disk_used as the plain version's do) and counts the
// held slots by link type. The last block runs the link-slot prologue:
// free = max(slots - occ, 0), admit = int(min(free, lq_next - lq_serve)),
// lq_serve += admit, occ3 = occ + admit.
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
                   int32_t* __restrict__ lq_serve, uint8_t* __restrict__ want,
                   float* __restrict__ drop, float* __restrict__ dele,
                   float* __restrict__ occ3, int32_t* __restrict__ work_base) {
  const int64_t R = static_cast<int64_t>(gridDim.y);
  const Work work = carve(work_base, R);
  const int r = blockIdx.y;
  const float t_now = *now;
  const bool lim = limited[r] != 0;
  const bool gen = gcs_en[r / S] != 0;
  const float inf = __int_as_float(0x7f800000);
  int held[3] = {0, 0, 0};
  for_each_group(F, [&](int64_t i, int n) {
    uint8_t cm[4], sl[4], w[4];
    int32_t pc[4], ds[4];
    float fm[4], nd[4], dr[4], de[4];
    ld4(comp, i, n, vec, cm);
    ld4(tr_slot, i, n, vec, sl);
    ld4(pend_cnt, i, n, vec, pc);
    ld4(fin_max, i, n, vec, fm);
    ld4(disk_state, i, n, vec, ds);
    ld4(new_done, i, n, vec, nd);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = 0;
      dr[k] = 0.f;
      de[k] = 0.f;
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
    st4(drop, i, n, vec, dr);
    st4(dele, i, n, vec, de);
  });
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
}

// ----------------------------------------------------------- link_admit
// lq_queued dense; for each queued transfer its ticket against its link's
// serve counter (advanced by tg_complete): admitted ones take the slot,
// start at now + latency and leave the queue.
__global__ void __launch_bounds__(kThreads)
tg_link_admit_kernel(const float* __restrict__ now,
                     const int32_t* __restrict__ tr_link,
                     const int32_t* __restrict__ lq_ticket,
                     const int32_t* __restrict__ lq_serve,
                     const float* __restrict__ latency, int64_t F, int vec,
                     uint8_t* __restrict__ tr_slot,
                     float* __restrict__ tr_start,
                     uint8_t* __restrict__ lq_queued) {
  const int64_t r3 = 3 * static_cast<int64_t>(blockIdx.y);
  const float t_now = *now;
  for_each_group(F, [&](int64_t i, int n) {
    uint8_t q[4];
    ld4(lq_queued, i, n, vec, q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= n || !q[k]) continue;
      const int64_t e = i + k;
      const int64_t j = r3 + link_type(tr_link[e]);
      if (lq_ticket[e] < lq_serve[j]) {
        tr_slot[e] = 1;
        tr_start[e] = __fadd_rn(t_now, latency[j]);
        lq_queued[e] = 0;
      }
    }
  });
}

// -------------------------------------------------------------- migrate
// mig dense; each admitted migration goes IN_FLIGHT on the cold tier and
// onto its site's disk->gcs link: direct (slot held, start now) while the
// link queue is empty and its rank is below the free slots, else queued
// with ticket lq_next + rank - n_direct. For a queued file n_direct has a
// closed form: 0 while the queue is busy; else every rank below free_m is
// direct and the file's own rank is not, so n_direct = ceil(free_m). The
// last block adds the row counts: lq_next[.., 2] += queued, occ3[.., 2] +=
// direct.
__global__ void __launch_bounds__(kThreads)
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
  const float t_now = *now;
  const int32_t lqn = lq_next[j2];
  const bool q_empty = lqn == lq_serve[j2];
  const float free_m = clamp0(__fsub_rn(slots[j2], occ3[j2]));
  const int32_t link = mig_link[r % S];
  int counts[2] = {0, 0};  // direct, queued
  for_each_group(F, [&](int64_t i, int n) {
    uint8_t m[4];
    ld4(mig, i, n, vec, m);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= n || !m[k]) continue;
      const int64_t e = i + k;
      const int32_t rk = rank[e];
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
      tr_total[e] = sizes[e];
      tr_done[e] = 0.f;
    }
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

inline int64_t tiles(int64_t n, int64_t tile) { return (n + tile - 1) / tile; }

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

// The launch grid: the tiles of a row by the R = L*S rows; at least one
// tile a row, so that the last block of a launch exists at F = 0.
inline bool plane_grid(int L, int S, long long F, dim3* grid) {
  const int64_t R = static_cast<int64_t>(L) * S;
  if (L < 0 || S < 0 || F < 0 || R > 65535) return false;  // rows: gridDim.y
  const int64_t nt = tiles(F, kTile) > 0 ? tiles(F, kTile) : 1;
  if (nt * R > 0x7fffffff) return false;  // tickets count blocks in an int
  *grid = dim3(static_cast<unsigned>(nt), static_cast<unsigned>(R));
  return true;
}

}  // namespace

extern "C" {

long long tg_work_ints(int L, int S) {
  return work_ints(static_cast<int64_t>(L) * S);
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
// and lq_serve [L, 3S]; work from tg_begin of the same tick. Outputs: want
// (bool), drop and dele (f32) [L, S, F], occ3 [L, 3S] f32. One launch.
int tg_complete(const void* now, const void* new_done, const void* comp,
                const void* sizes, const void* limited, const void* gcs_en,
                const void* pop_ok, const void* slots, const void* lq_next,
                const void* tr_link, int L, int S, long long F,
                void* disk_state, void* gcs_state, void* tr_slot,
                void* tr_done, void* tr_total, void* tr_start, void* pend_cnt,
                void* pend_tail, void* fin_max, void* lq_serve, void* want,
                void* drop, void* dele, void* occ3, void* work, void* stream) {
  dim3 grid;
  if (!plane_grid(L, S, F, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  if (grid.y == 0) return static_cast<int>(cudaSuccess);
  const int vec = F % 4 == 0 && aligned(comp, 4) && aligned(tr_slot, 4) &&
                  aligned(want, 4) && aligned(new_done, 16) &&
                  aligned(pend_cnt, 16) && aligned(fin_max, 16) &&
                  aligned(disk_state, 16) && aligned(tr_done, 16) &&
                  aligned(drop, 16) && aligned(dele, 16);
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
      static_cast<int32_t*>(lq_serve), static_cast<uint8_t*>(want),
      static_cast<float*>(drop), static_cast<float*>(dele),
      static_cast<float*>(occ3), static_cast<int32_t*>(work));
  return static_cast<int>(cudaGetLastError());
}

// Planes [L, S, F]; lq_serve and latency [L, 3S]. Updates tr_slot,
// tr_start and lq_queued in place. One launch.
int tg_link_admit(const void* now, const void* tr_link, const void* lq_ticket,
                  const void* lq_serve, const void* latency, int L, int S,
                  long long F, void* tr_slot, void* tr_start, void* lq_queued,
                  void* stream) {
  dim3 grid;
  if (!plane_grid(L, S, F, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  if (grid.y == 0) return static_cast<int>(cudaSuccess);
  const int vec = F % 4 == 0 && aligned(lq_queued, 4);
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
// slots, lq_serve and lq_next [L, 3S]; mig_link [S]; occ3 [L, 3S] from
// tg_complete; work from tg_begin of the same tick. One launch.
int tg_migrate(const void* now, const void* mig, const void* rank,
               const void* sizes, const void* slots, const void* mig_link,
               const void* lq_serve, int L, int S, long long F,
               void* gcs_state, void* tr_slot, void* tr_link, void* tr_total,
               void* tr_done, void* tr_start, void* lq_ticket, void* lq_queued,
               void* lq_next, void* occ3, void* work, void* stream) {
  dim3 grid;
  if (!plane_grid(L, S, F, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  if (grid.y == 0) return static_cast<int>(cudaSuccess);
  const int vec = F % 4 == 0 && aligned(mig, 4);
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

}  // extern "C"
