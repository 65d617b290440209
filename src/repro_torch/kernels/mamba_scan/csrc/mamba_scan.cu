// Hand-written Hopper (sm_90a) Mamba-1 selective scan:
//   h_t = dA_t * h_{t-1} + dBu_t,   y_t = sum_n C_{t,n} * h_{t,n},
// one kernel, ms_scan_kernel<kFused, TIn, kLog2G, kVec>, with two entries:
//
//   ms_scan           -> ms_scan_kernel<false, float, ...>: dA and dBu given,
//                        float32 [B, T, D, N] (the contract of ../ref.py's
//                        mamba_scan);
//   ms_selective_scan -> ms_scan_kernel<true, float | __nv_bfloat16, ...>: the
//                        recurrence's own inputs u, dt [B, T, D], A [D, N],
//                        B and C [B, T, N]; dA = expf(dt * A) and
//                        dBu = (dt * u) * B formed in registers, in the
//                        order of ../ref.py's scan_inputs (repro's
//                        _ssm_inputs, src/repro/models/ssm.py:67-69).
//
// Replaces the Pallas kernel _scan_kernel / mamba_scan_pallas of
// src/repro/kernels/mamba_scan/mamba_scan.py:29 (:52). With a final-state
// pointer either entry also writes h_T [B, D, N], the state after the last
// step, which prefill keeps as the SSM cache (repro's ssm_scan_y,
// src/repro/models/ssm.py:94).
//
// Bounds on this card (H100 SXM: 3.35 TB/s, 132 SMs x 128 lanes):
// - ms_scan: bytes. dA and dBu are 8 bytes a state and step, read once;
//   4 flops a state and step are far below the card's ratio. hymba_1_5b's
//   served layer (B 4, T 1536, D 3200, N 16, with h_T) needs 2.596 GB,
//   0.7751 ms; falcon_mamba_7b's widths (B 1, T 2048, D 8192, N 16)
//   2.215 GB, 0.6611 ms.
// - ms_selective_scan: operations. Its bytes are u, dt, B, C, A, y and
//   h_T, about 0.24 GB served (0.071 ms) and 0.20 GB at falcon's widths
//   (0.060 ms); every state and step runs an expf (one MUFU.EX2 and some
//   five float32 operations around it), two products for dA and dBu, the
//   recurrence and C's product and sum: 315 M (served) and 268 M
//   state-steps at some 13 operations each and one instruction a lane and
//   clock, about 0.12-0.14 ms. chip_smoke.py (scan_bound) takes the
//   count from this kernel's SASS: the float32 and MUFU instructions a
//   state-step of its hot loop. The loop's other instructions (shared-
//   memory loads, widening, shuffles, addresses, branches) are the
//   kernel's overhead, not the function's work, and stay out of the bound.
//
// The first version gave one thread one state and walked T with 8 steps of
// 4-byte loads in registers, then waited for them; at the served shape its
// 800 blocks ran in 4 rounds of 264, the last one 8 blocks long. Here:
//
// - No wave tail. The wrapper (ops.scan_geometry) sizes a block to the
//   card: the least warps a block (at most 16) for which the B x ceil(D /
//   tile) blocks fit on the SMs at one block each, so every state is
//   resident from the first cycle and no SM holds more than
//   ceil(warps / SMs) warps (served: 124 blocks of 13 warps; falcon: 128
//   of 8). A block owns one b and a tile of d; T stays whole in the block,
//   its carry in registers, so no step is read twice and no carry crosses
//   blocks.
// - One read of every input byte through a ring in shared memory. The
//   block's rows of a time step (contract: the tile's dA and dBu rows, each
//   one contiguous run of tile x N floats, and C's row; fused: the tile's
//   u and dt runs and the B and C rows) come in by cp.async, a stage's rows
//   of one kind dealt out to all the block's threads in 16-byte copies (8
//   or 4 where the rows' addresses or length are not multiples of 16; bf16
//   at an odd offset, below cp.async's 4 bytes, by the threads' own loads).
//   kStages stages of `steps` time steps make the
//   ring (one cp.async group a stage); while the block computes stage s,
//   stages s+1 .. s+kStages-1 are in flight. The wrapper takes `steps` as
//   large as 227 KB allows (served contract: 4 steps, 53.5 KB a stage, 160
//   KB in flight an SM; falcon: 7), so the bytes in flight come from the
//   ring and not from registers.
// - The steps of a stage are unrolled 8 deep and branch-free (loads
//   unmasked where N % 4 == 0, y stored by a predicated store), and a
//   step's y is summed across lanes and stored during the next step, so
//   the compiler overlaps the steps' expf and loads with the recurrence,
//   which alone runs in order.
// - Most of the sum over n in a thread. A thread holds kV = 4 states n = 4g
//   .. 4g+3 of one (b, d) (float4 loads from shared memory where N % 4 ==
//   0); the G = 2^kLog2G = 2^ceil(log2(ceil(N / 4))) threads of a (b, d)
//   are neighbouring lanes (N = 16: 4, two shuffles a step; N = 32: 8,
//   three), and lane g = 0 writes y. One instance for each G, and for N
//   % 4 == 0 or not.
// - The fused entry reads u, dt, B and C (bf16 u, B and C are widened in
//   the kernel, exactly) and keeps A's 4 values in registers; B and C are
//   column slices of the projection's output and come with their own batch
//   and row strides (no copy).
//
// The recurrence rounds like the plain version's separate multiply and add
// (__fmul_rn, __fadd_rn), and so do dt * A, dt * u and (dt * u) * B;
// expf, not __expf, without --use_fast_math. Only the order of the sum
// over n differs. No atomics, no state kept between calls; the kernel
// allocates nothing.
//
// Plain C entry points, loaded with ctypes: launch on the caller's stream,
// allocate nothing, return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxState = 32;
constexpr int kV = 4;          // states a thread holds: n = kV * g + v
constexpr int kStages = 4;     // ring stages, one cp.async group each
constexpr int kMaxWarps = 16;  // a block's warps, at most
constexpr int kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory

struct ScanArgs {
  const void* r0;  // contract: dA [B, T, D, N] f32 | fused: u [B, T, D]
  const void* r1;  // contract: dBu                | fused: dt [B, T, D] f32
  const void* bm;  // fused: B rows (TIn), strides b_batch, b_row
  const void* cm;  // C rows (contract: f32; fused: TIn), c_batch, c_row
  const float* A;  // fused: A [D, N] f32
  float* y;        // [B, T, D] f32
  float* h_final;  // [B, D, N] f32 or null
  long long b_batch, b_row, c_batch, c_row;  // element strides
  int T, D, N, tile, steps;  // tile: (b, d) pairs a block
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Byte offsets of a time step's four rows in a stage of the ring (each
// slot 16-byte aligned), and the step's size: contract dA, dBu, (none), C;
// fused u, dt, B, C.
struct StepLayout {
  int off1, off2, off3, bytes;  // row 0 at 0, each slot 16-byte aligned
  __host__ __device__ StepLayout(bool fused, int tile, int N, int esz)
      : off1(round16(fused ? tile * esz : tile * N * 4)),
        off2(off1 + round16(fused ? tile * 4 : tile * N * 4)),
        off3(off2 + round16(fused ? N * esz : 0)),
        bytes(off3 + round16(fused ? N * esz : N * 4)) {}
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block's threads start copying rows k = 0 .. kn-1 of one kind, row k
// from global `src` + k * `stride` to shared `dst` + k * `dst_stride`
// (16-byte aligned), `per_row` copies of SIZE bytes a row: the copies of
// all the rows are dealt out to the threads in turn, so a stage's small
// rows cost one copy a thread, not a row a warp. SIZE 2 (a bf16 row at an
// odd element offset, below cp.async's 4 bytes) loads and stores, which
// have landed by the stage's barrier.
template <int SIZE>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_stride,
                                          const unsigned char* src,
                                          long long stride, int per_row,
                                          int kn) {
  int k = threadIdx.x / per_row, c = threadIdx.x - k * per_row;
  const int dk = blockDim.x / per_row, dc = blockDim.x - dk * per_row;
  while (k < kn) {
    unsigned char* to = dst + k * dst_stride + c * SIZE;
    const unsigned char* from = src + k * stride + c * SIZE;
    if constexpr (SIZE >= 4)
      cp_async<SIZE>(to, from);
    else
      *reinterpret_cast<uint16_t*>(to) =
          *reinterpret_cast<const uint16_t*>(from);
    k += dk;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++k;
    }
  }
}

// copy_rows with the largest copy, 16, 8, 4 or 2 bytes, that divides
// every row's address and its length: the first row's address, the stride
// between rows and the row's bytes.
__device__ __forceinline__ void copy_kind(unsigned char* dst, int dst_stride,
                                          const unsigned char* src,
                                          long long stride, int bytes,
                                          int kn) {
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src)) |
                     static_cast<unsigned>(stride) |
                     static_cast<unsigned>(bytes);
  if ((a & 15u) == 0)
    copy_rows<16>(dst, dst_stride, src, stride, bytes >> 4, kn);
  else if ((a & 7u) == 0)
    copy_rows<8>(dst, dst_stride, src, stride, bytes >> 3, kn);
  else if ((a & 3u) == 0)
    copy_rows<4>(dst, dst_stride, src, stride, bytes >> 2, kn);
  else
    copy_rows<2>(dst, dst_stride, src, stride, bytes >> 1, kn);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// kV values from shared memory at `src` as float32: where kVec (N % 4 ==
// 0) one 16- or 8-byte load, else one at a time, those at or past `nv`
// zero.
template <bool kVec, typename T>
__device__ __forceinline__ void load_v(float (&out)[kV], const T* src,
                                       int nv) {
  if constexpr (kVec && sizeof(T) == 4) {
    static_assert(kV == 4 || kV == 2, "a float4 or a float2");
    if constexpr (kV == 4) {
      const float4 x = *reinterpret_cast<const float4*>(src);
      out[0] = x.x;
      out[1] = x.y;
      out[2] = x.z;
      out[3] = x.w;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(src);
      out[0] = x.x;
      out[1] = x.y;
    }
  } else if constexpr (kVec) {  // bf16: the high half of a float
    uint32_t x[kV / 2];
    if constexpr (kV == 4) {
      const uint2 w = *reinterpret_cast<const uint2*>(src);
      x[0] = w.x;
      x[1] = w.y;
    } else {
      x[0] = *reinterpret_cast<const uint32_t*>(src);
    }
#pragma unroll
    for (int i = 0; i < kV / 2; ++i) {
      out[2 * i] = __uint_as_float(x[i] << 16);
      out[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int v = 0; v < kV; ++v) out[v] = v < nv ? widen(src[v]) : 0.0f;
  }
}

// grid (tiles of d, B); blockDim.x = warps * 32 = tile << kLog2G threads,
// 2^kLog2G of them a (b, d). kVec: N % 4 == 0, so a thread's 4 states are
// all in the row or all past it; then its loads in the steps are
// unmasked and unbranched (a pair past the tile's last reads inside the
// tile's slot, a group past N reads the row's last 4 states), and what is
// not its own is dropped at the end of the step.
template <bool kFused, typename TIn, int kLog2G, bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ms_scan_kernel(const ScanArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  constexpr int G = 1 << kLog2G;
  const int T = p.T, D = p.D, N = p.N;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * p.tile;
  const int dn = min(p.tile, D - d0);  // pairs of this block
  const int pair = tid >> kLog2G;      // d - d0
  const int n0 = (tid & (G - 1)) * kV;
  const bool live = pair < dn;
  const bool on = live && n0 < N;                // this thread has states
  const int nv = on ? min(kV, N - n0) : 0;       // how many
  const int nl = kVec ? min(n0, N - kV) : n0;    // where its loads start
  constexpr int esz = kFused ? static_cast<int>(sizeof(TIn)) : 4;
  const StepLayout lay(kFused, p.tile, N, esz);
  const int stage_bytes = p.steps * lay.bytes;
  const int n_stage = (T + p.steps - 1) / p.steps;
  // This block's row (b, 0) of each kind (contract dA, dBu, C; fused u,
  // dt, B, C); rows 0 and 1 are `stride01` elements apart from t to t + 1
  // and `elems01` elements long.
  const long long at01 = (static_cast<long long>(b) * T * D + d0) *
                         (kFused ? 1 : N);
  const long long stride01 = static_cast<long long>(D) * (kFused ? 1 : N);
  const int elems01 = kFused ? dn : dn * N;
  const unsigned char* src0 =
      static_cast<const unsigned char*>(p.r0) + at01 * esz;
  const unsigned char* src1 =
      static_cast<const unsigned char*>(p.r1) + at01 * 4;
  const unsigned char* src2 =
      static_cast<const unsigned char*>(p.bm) + b * p.b_batch * esz;
  const unsigned char* src3 =
      static_cast<const unsigned char*>(p.cm) + b * p.c_batch * esz;

  // Start the copies of stage s into its slot; one group.
  auto issue = [&](int s) {
    if (s < n_stage) {
      unsigned char* slot = smem + (s % kStages) * stage_bytes;
      const int t0 = s * p.steps;
      const int kn = min(p.steps, T - t0);
      copy_kind(slot, lay.bytes, src0 + t0 * stride01 * esz, stride01 * esz,
                elems01 * esz, kn);
      copy_kind(slot + lay.off1, lay.bytes, src1 + t0 * stride01 * 4,
                stride01 * 4, elems01 * 4, kn);
      if constexpr (kFused)
        copy_kind(slot + lay.off2, lay.bytes, src2 + t0 * p.b_row * esz,
                  p.b_row * esz, N * esz, kn);
      copy_kind(slot + lay.off3, lay.bytes, src3 + t0 * p.c_row * esz,
                p.c_row * esz, N * esz, kn);
    }
    cp_async_commit();
  };

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  float h[kV], a[kV];  // the fused entry's A row, in registers
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    h[v] = 0.0f;
    a[v] = 0.0f;
    if (kFused && v < nv)
      a[v] = p.A[static_cast<long long>(d0 + pair) * N + n0 + v];
  }
  // A step's partial sum of y is summed over the G lanes of its (b, d) and
  // stored by lane g = 0 in the next step, in the shadow of that step's
  // work; `prev` points at the y of the step before.
  float* prev = p.y + static_cast<long long>(b) * T * D + d0 + pair - D;
  const bool writer = live && n0 == 0;
  float y_prev = 0.0f;  // the step before's partial sum
  bool any = false;     // a step before this one
  auto put_prev = [&]() {
    float r = y_prev;
#pragma unroll
    for (int off = G >> 1; off > 0; off >>= 1)
      r += __shfl_xor_sync(0xffffffffu, r, off);
    // a predicated store, no branch: the unrolled steps stay one block of
    // code the compiler can interleave
    if (writer && any) *prev = r;
  };

#pragma unroll 1
  for (int s = 0; s < n_stage; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage s landed
    __syncthreads();  // everyone's, and everyone is done with stage s - 1
    issue(s + kStages - 1);  // into stage s - 1's slot
    const unsigned char* slot = smem + (s % kStages) * stage_bytes;
    const int t0 = s * p.steps;
    const int kn = min(p.steps, T - t0);
#pragma unroll 8
    for (int k = 0; k < kn; ++k) {
      const unsigned char* row = slot + k * lay.bytes;
      float c[kV];
      float yv = 0.0f;
      if constexpr (kFused) {
        // pair < tile: inside the slot, whatever the tile's width
        const float dt = reinterpret_cast<const float*>(row + lay.off1)[pair];
        const float u = widen(reinterpret_cast<const TIn*>(row)[pair]);
        const float dtu = __fmul_rn(dt, u);
        float bv[kV];
        load_v<kVec>(bv, reinterpret_cast<const TIn*>(row + lay.off2) + nl,
                     nv);
        load_v<kVec>(c, reinterpret_cast<const TIn*>(row + lay.off3) + nl,
                     nv);
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const float da = expf(__fmul_rn(dt, a[v]));
          const float dbu = __fmul_rn(dtu, bv[v]);
          h[v] = __fadd_rn(__fmul_rn(da, h[v]), dbu);
          yv = fmaf(c[v], h[v], yv);
        }
      } else {
        const int at = pair * N + nl;
        float da[kV], dbu[kV];
        load_v<kVec>(da, reinterpret_cast<const float*>(row) + at, nv);
        load_v<kVec>(dbu, reinterpret_cast<const float*>(row + lay.off1) + at,
                     nv);
        load_v<kVec>(c, reinterpret_cast<const float*>(row + lay.off3) + nl,
                     nv);
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          h[v] = __fadd_rn(__fmul_rn(da[v], h[v]), dbu[v]);
          yv = fmaf(c[v], h[v], yv);
        }
      }
      put_prev();
      prev += D;
      y_prev = on ? yv : 0.0f;  // a select: what a thread without states read
      any = true;
    }
  }
  cp_async_wait<0>();  // the trailing groups are empty
  put_prev();  // the last step's y

  if (p.h_final != nullptr) {
    float* hf = p.h_final +
                (static_cast<long long>(b) * D + d0 + pair) * N + n0;
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (v < nv) hf[v] = h[v];
  }
}

int log2_group(int N) {
  int log2g = 0;
  while ((kV << log2g) < N) ++log2g;
  return log2g;
}

template <bool kFused, typename TIn, int kLog2G, bool kVec>
int launch(ScanArgs p, int B, int warps, cudaStream_t stream) {
  p.tile = (warps * 32) >> kLog2G;
  const StepLayout lay(kFused, p.tile, p.N, kFused ? sizeof(TIn) : 4);
  const long long smem = static_cast<long long>(kStages) * p.steps * lay.bytes;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      ms_scan_kernel<kFused, TIn, kLog2G, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.D + p.tile - 1) / p.tile, B);
  ms_scan_kernel<kFused, TIn, kLog2G, kVec>
      <<<grid, warps * 32, static_cast<int>(smem), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFused, typename TIn, int kLog2G>
int launch_vec(const ScanArgs& p, int B, int warps, cudaStream_t stream) {
  if (p.N % kV == 0)
    return launch<kFused, TIn, kLog2G, true>(p, B, warps, stream);
  return launch<kFused, TIn, kLog2G, false>(p, B, warps, stream);
}

// The instance of N: G = 1, 2, 4 or 8 threads a (b, d); N % 4 == 0 or not.
template <bool kFused, typename TIn>
int dispatch(const ScanArgs& p, int B, int warps, void* stream) {
  if (p.N < 1 || p.N > kMaxState || warps < 1 || warps > kMaxWarps ||
      p.steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || p.T == 0 || p.D == 0)
    return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (log2_group(p.N)) {
    case 0: return launch_vec<kFused, TIn, 0>(p, B, warps, st);
    case 1: return launch_vec<kFused, TIn, 1>(p, B, warps, st);
    case 2: return launch_vec<kFused, TIn, 2>(p, B, warps, st);
    default: return launch_vec<kFused, TIn, 3>(p, B, warps, st);
  }
}

}  // namespace

extern "C" {

int ms_max_state() { return kMaxState; }

const char* ms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dA, dBu: f32 [B, T, D, N]; C: f32 [B, T, N]; y: f32 [B, T, D]; all
// contiguous; 1 <= N <= 32. warps: a block's warps (1..16), steps: time
// steps a ring stage (ops.scan_geometry). h_final: f32 [B, D, N], the
// state after step T - 1, or null to write none.
int ms_scan(const void* dA, const void* dBu, const void* C, void* y, int B,
            int T, int D, int N, int warps, int steps, void* h_final,
            void* stream) {
  ScanArgs p = {};
  p.r0 = dA;
  p.r1 = dBu;
  p.cm = C;
  p.y = static_cast<float*>(y);
  p.h_final = static_cast<float*>(h_final);
  p.c_batch = static_cast<long long>(T) * N;
  p.c_row = N;
  p.T = T;
  p.D = D;
  p.N = N;
  p.steps = steps;
  return dispatch<false, float>(p, B, warps, stream);
}

// u: [B, T, D] f32 or bf16 (in_bf16), contiguous; dt: f32 [B, T, D],
// contiguous; A: f32 [D, N], contiguous; Bm, Cm: [B, T, N] of u's type,
// unit stride along N, element strides (b_batch, b_row) and (c_batch,
// c_row); y: f32 [B, T, D]; h_final as for ms_scan.
int ms_selective_scan(const void* u, const void* dt, const void* A,
                      const void* Bm, const void* Cm, void* y, int B, int T,
                      int D, int N, long long b_batch, long long b_row,
                      long long c_batch, long long c_row, int in_bf16,
                      int warps, int steps, void* h_final, void* stream) {
  ScanArgs p = {};
  p.r0 = u;
  p.r1 = dt;
  p.bm = Bm;
  p.cm = Cm;
  p.A = static_cast<const float*>(A);
  p.y = static_cast<float*>(y);
  p.h_final = static_cast<float*>(h_final);
  p.b_batch = b_batch;
  p.b_row = b_row;
  p.c_batch = c_batch;
  p.c_row = c_row;
  p.T = T;
  p.D = D;
  p.N = N;
  p.steps = steps;
  return in_bf16 ? dispatch<true, __nv_bfloat16>(p, B, warps, stream)
                 : dispatch<true, float>(p, B, warps, stream);
}

}  // extern "C"
