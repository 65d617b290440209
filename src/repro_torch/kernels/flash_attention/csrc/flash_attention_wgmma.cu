// Hand-written Hopper (sm_90a) attention forward in bfloat16: tensor cores
// through wgmma, K/V tiles through a ring in shared memory filled by a
// producer warpgroup (TMA, or cp.async from its threads), consumer
// warpgroups.
//
// Replaces the Pallas kernel _attn_kernel / flash_attention_pallas of
// src/repro/kernels/flash_attention/flash_attention.py:28 (:66) for
// bfloat16 inputs at any head width hd in 1..256, and computes what
// ../ref.py computes (the definition, attention_ref):
//
//   fa_wgmma_forward -> fa_wgmma_kernel<HDP, THREADS>
//
// float32 inputs go to flash_attention_tf32x3.cu; ../ops.py picks the
// kernel from dtype alone.
//
// Arithmetic (held to the float32 definition at one bf16 ulp): the
// scores Q.K^T are formed from the bf16 inputs in float32 and multiplied
// there by hd^-0.5 * log2(e) (Q is not pre-scaled, which would round once
// more; the softmax then runs on exp2); masks, running max, normaliser and
// the accumulator are float32, and the output is rounded to bf16 once. The
// probabilities p enter the second product as two bf16 halves, p_hi =
// bf16(p) and p_lo = bf16(p - p_hi), each its own wgmma into the same
// float32 accumulator: together they carry about 16 significant bits of p
// where one bf16 carries 8. Rounding p once to bf16 (as SDPA and a
// textbook FlashAttention-3 do) leaves some 40% of the outputs one ulp off
// the float32 definition; the two halves keep that share under the 1% the
// port holds its kernels to. The price is 6*hd flops per (query, key) pair
// instead of 4*hd.
//
// Bound on this card: operations, 4*hd flops per unmasked pair at the
// tensor cores' 989 TFLOP/s in bf16. What the design does about it:
// - one CTA per (query tile, head, batch), launched heaviest causal tile
//   first, the query heads of one kv head next to each other in launch
//   order so their K/V tiles are still in L2;
// - warp specialisation: consumer warpgroups of 64 query rows each run the
//   wgmmas and the softmax; the last warpgroup, the producer, fills Q once,
//   then K and V tiles of BK = 64 rows into a ring of up to 3 stages with
//   full/empty mbarrier pairs, so later tiles land while this one is
//   computed. Two consumers up to HDP 192, so one consumer's softmax runs
//   while the other's wgmmas keep the tensor cores busy; one for HDP 256,
//   whose accumulator (128 registers a thread) spills at 240;
// - each consumer starts S_i = Q.K_i^T and the P_{i-1}.V_{i-1} it owes for
//   the previous tile back to back, then the softmax of tile i (letting
//   that softmax overlap P_{i-1}.V_{i-1} inside the warpgroup, as
//   FlashAttention-3 does, measured no faster here);
// - S = Q.K^T as wgmma m64n64k16 with both operands K-major in shared
//   memory (no transpose), HDP/16 k-steps; O += P.V as wgmma m64nHDPk16
//   with P in registers (the S accumulator's fragment is the A fragment)
//   and V in shared memory read MN-major (the transpose bit);
// - shared tiles in the layout of a TMA box of 64 bf16 columns with
//   128-byte swizzle, which the wgmma descriptors read (SBO 1024 B between
//   8-row groups; LBO one 64-column chunk for V): element c of row r lies
//   in 64-column chunk c / 64, row r, 16-byte piece ((c % 64) / 8) ^ (r %
//   8). Rows past T or S read zeros, never the next head's rows, and so do
//   columns past hd up to the bucket width HDP. A key at s >= S still
//   scores -inf in registers: it weighs 0;
// - two loaders, one consumer. Where a row is a multiple of 16 bytes
//   (hd % 8 == 0; THREADS false), one producer thread starts TMA copies
//   through 3-D maps over [heads, rows, hd], whose fill gives the zeros
//   (hd 168 runs in the 192 bucket for free), and the full barriers count
//   one arrival and the bytes. TMA takes no other width (its global
//   strides are multiples of 16 bytes; a row of hd 100 is 200), so there
//   (THREADS true) all 128 producer threads copy into the same layout,
//   each a unit of a row in every P-th row (Walk): 4 values by an 8-byte
//   cp.async where hd % 4 == 0, 2 by a 4-byte one at even hd, and at odd
//   hd (cp.async has no 2-byte size) 4 values loaded one at a time into
//   registers, 2 rows of them in flight, and stored as 8 bytes (zeros
//   past hd). Rows past T or S are copied with source size 0 (zeros);
//   columns hd..HDP-1 are zeroed once at the start and no copy writes
//   values there. Each thread arrives on the full barrier when its copies
//   have landed (cp.async.mbarrier.arrive.noinc; after its stores at odd
//   hd), so those barriers count 128 arrivals, and a consumer orders the
//   copies, generic-proxy writes, before its wgmmas, async-proxy reads,
//   by fence.proxy.async after each wait. The producer walks its
//   addresses in 40 registers, taken from the consumers: 232 each where
//   the TMA instances give 240 and 24 (at 24 the walk spills). The
//   copies and their addresses take issue slots from the consumers: at
//   the same work a thread loader of 8-byte copies ran 1.3-1.4x TMA's
//   time on an H100 SXM at 700 W, one of 16-byte copies 1.1x;
// - templates on the bucket HDP in {64, 128, 192, 256} so the accumulator
//   holds HDP/2 registers a thread, not 128. BK = 64 in every bucket: at
//   128 keys the scores and P's halves (128 registers) spill beside the
//   accumulator, and qwen3_4b's case ran 1.3x slower. The 192 bucket still
//   spills 200 bytes a thread; with one consumer it spills none but ran
//   slower.
//
// Shared memory per CTA (Q + 3 x (K + V), bf16, + 1 KB alignment):
//   HDP  64, 128 rows: 16 KB + 3 x 16 KB =  64 KB
//   HDP 128, 128 rows: 32 KB + 3 x 32 KB = 128 KB
//   HDP 192, 128 rows: 48 KB + 3 x 48 KB = 192 KB
//   HDP 256,  64 rows: 32 KB + 3 x 64 KB = 224 KB   (of 227 KB)
// Registers of a consumer thread: HDP/2 for O, 32 for S, 32 for P's halves.
//
// Masks come from positions (rel = t - s): causal keeps rel >= 0, a window
// keeps rel < window; a masked pair scores exactly -1e30, so a row whose
// every key is masked averages all keys. Key tiles outside every row's mask
// are skipped only where each row of the query tile keeps a key (always
// so when T <= S): the skipped pairs would weigh exactly 0. At odd hd the
// output is stored one value at a time (a pair would cross a row).
//
// Plain C entry points, loaded with ctypes: launches on the caller's
// stream, allocates nothing, returns cudaGetLastError() or one of this
// file's own codes (fa_wgmma_error_string). cuTensorMapEncodeTiled is
// reached through cudaGetDriverEntryPoint, so nothing links libcuda.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowBytes = 128;  // one swizzled row: 64 bf16 columns
constexpr int kBK = 64;         // keys per K/V tile
constexpr int kSmemMax = 232448;  // shared memory a block may use (227 KB)
constexpr float kMasked = -1e30f;

constexpr int kProducers = 128;  // threads of the producer warpgroup
constexpr int kOddBatch = 2;  // rows of 4 loads in flight a thread, odd hd

// Codes of this file's own failures, above every cudaError_t.
constexpr int kErrEntryPoint = 20001;
constexpr int kErrEncode = 20002;
constexpr int kErrAlign = 20003;

// Tiling of a head-width bucket HDP: consumer warpgroups (64 query rows
// each) per CTA. The 256 bucket keeps one consumer: its 128 accumulator
// registers a thread spill at the 240 that setmaxnreg leaves each of two.
// With two, the registers each warpgroup keeps after setmaxnreg: 384
// threads launch at 168 each (64,512 in all), and 2 x 128 x 240 + 128 x 24
// and 2 x 128 x 232 + 128 x 40 both come to that sum.
template <int HDP, bool THREADS>
struct Bucket {
  static constexpr int kConsumers = HDP <= 192 ? 2 : 1;
  static constexpr int kBQ = 64 * kConsumers;  // query rows per CTA
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr uint32_t kProducerRegs = THREADS ? 40 : 24;
  static constexpr uint32_t kConsumerRegs = THREADS ? 232 : 240;
  static_assert(kConsumers == 1 || 2 * kConsumerRegs + kProducerRegs == 504,
                "registers: 384 threads launch at 168 each");
};

// Byte offsets of one CTA's shared memory (from a 1024-byte aligned base:
// the 128-byte swizzle repeats every 8 rows of 128 bytes): Q, then a ring
// of 3 K/V stages, then the mbarriers.
template <int HDP, int BK, int QROWS>
struct Smem {
  static constexpr int kStages = 3;
  static constexpr int kChunks = HDP / 64;           // 64-column chunks
  static constexpr int kQChunk = QROWS * kRowBytes;  // one Q chunk
  static constexpr int kKVChunk = BK * kRowBytes;    // one K or V chunk
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;  // one K or V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kBytes <= kSmemMax, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarrier and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of barrier `bar` has completed.
// A phase that never completes (a fault of the pipeline) traps after about
// 2^35 cycles (some 20 s), so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 35)) __trap();
  }
}

// One box of 64 columns x box rows x 1 head of a 3-D map into shared
// memory at `dst`; completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

// -- the thread loader ------------------------------------------------------

// Where a TMA box of 64 columns with 128-byte swizzle puts element (r, c)
// of a tile of R rows at `tile`: 64-column chunk c / 64, row r, 16-byte
// piece ((c % 64) / 8) ^ (r % 8), byte 2 * (c % 8) in it.
template <int R>
__device__ __forceinline__ uint32_t swizzled(uint32_t tile, int r, int c) {
  return tile + (c >> 6) * (R * kRowBytes) + r * kRowBytes +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst),
               "l"(src), "n"(BYTES), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void st_shared_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(0), "r"(0), "r"(0), "r"(0)
               : "memory");
}

// Order this thread's shared-memory writes (generic proxy) before reads by
// the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A producer thread's share of a tile, the same in every tile. Each row is
// cut into units of U values, n_u a row (U = 2 or 4 copied values; at odd
// hd U = 4 with the row read up to a multiple of 4, zeros past hd).
// Thread i takes unit i % n_u of rows i / n_u, i / n_u + P, ..., P = 128 /
// n_u rows at a time; threads from P * n_u on take none. Consecutive
// threads take consecutive units, so a warp reads one run of memory, and
// a thread's unit keeps its column: from row to row only the row's
// address and its swizzle change.
struct Walk {
  int c;     // first column of this thread's unit
  int r0;    // its first row, or 1 << 20: no unit
  int pass;  // P
};

__device__ __forceinline__ Walk make_walk(int tid, int hd, int u) {
  const int n_u = (hd + u - 1) / u;
  const int pass = kProducers / n_u;
  return Walk{(tid % n_u) * u, tid / n_u < pass ? tid / n_u : 1 << 20,
              pass};
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint32_t lo,
                                             uint32_t hi) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(addr), "r"(lo),
               "r"(hi)
               : "memory");
}

// This thread's units of a tile of R rows into the swizzled `tile`, from
// `src`, where `rows` of the R rows exist (the rest read zeros): BYTES a
// unit through cp.async, or at BYTES == 2 (odd hd) four values loaded one
// at a time into registers, kOddBatch rows of them in flight, and stored
// as one 8-byte unit.
template <int R, int BYTES>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* src, int rows,
                                          int hd, Walk w) {
  const int present = min(rows, R);
  // the unit's 64-column chunk, and its bytes into a 128-byte row before
  // the swizzle, which moves them by (r % 8) 16-byte pieces
  const uint32_t col = tile + (w.c >> 6) * (R * kRowBytes);
  const uint32_t piece = (w.c << 1) & 127;
  auto to = [&](int r) {
    return col + r * kRowBytes + (piece ^ ((r & 7) << 4));
  };
  if constexpr (BYTES > 2) {
    for (int r = w.r0; r < R; r += w.pass) {
      const bool in = r < present;
      cp_async<BYTES>(to(r), src + (in ? r * hd + w.c : 0), in ? BYTES : 0);
    }
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    const int nk = hd - w.c;  // values of the unit inside the row, 1..4+
    for (int r0 = w.r0; r0 < R; r0 += kOddBatch * w.pass) {
      uint32_t lo[kOddBatch], hi[kOddBatch];
#pragma unroll
      for (int b = 0; b < kOddBatch; ++b) {
        const int r = r0 + b * w.pass;
        const bool in = r < present;
        const unsigned short* p = s + (in ? r * hd + w.c : 0);
        const uint32_t x0 = in ? __ldg(p) : 0u;
        const uint32_t x1 = in && nk > 1 ? __ldg(p + 1) : 0u;
        const uint32_t x2 = in && nk > 2 ? __ldg(p + 2) : 0u;
        const uint32_t x3 = in && nk > 3 ? __ldg(p + 3) : 0u;
        lo[b] = x0 | (x1 << 16);
        hi[b] = x2 | (x3 << 16);
      }
#pragma unroll
      for (int b = 0; b < kOddBatch; ++b) {
        const int r = r0 + b * w.pass;
        if (r < R) st_shared_v2(to(r), lo[b], hi[b]);
      }
    }
  }
}

// This thread has issued its copies of a tile: its arrival on the full
// barrier `bar` comes when they have landed (cp.async), or now, after its
// stores (BYTES == 2).
template <int BYTES>
__device__ __forceinline__ void arrive_loaded(uint32_t bar) {
  if constexpr (BYTES > 2)
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                     bar)
                 : "memory");
  else
    mbar_arrive(bar);
}

// Zero the 16-byte pieces of each row of a tile of R rows from the one
// that holds column hd rounded down to 8 (a thread loader copies the
// values below hd over that one later): columns hd..HDP-1 read zeros, as
// TMA's fill gives them.
template <int HDP, int R>
__device__ __forceinline__ void zero_pad(uint32_t tile, int hd, int tid,
                                         int n_threads) {
  const int j0 = hd / 8, per_row = HDP / 8 - j0;
  for (int i = tid; i < R * per_row; i += n_threads) {
    const int r = i / per_row;
    st_shared_zero16(swizzled<R>(tile, r, 8 * (j0 + i % per_row)));
  }
}

// The operands for a thread loader, and its copy size in bytes (8, 4 or
// 2); unused by the TMA instances.
struct Ptrs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int copy;
};

// -- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte swizzled operand: start
// address, leading byte offset (unused for K-major; the stride between
// 64-column chunks for MN-major), stride byte offset 1024 (between groups
// of 8 rows), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Registers a wgmma reads or writes asynchronously: after the wait, tie
// each to this point so the compiler neither reads them earlier nor reuses
// them while the tensor cores may still touch them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// wgmma_ss<N>: d[64 x N] = (scale_d ? d : 0) + A[64 x 16] . B[N x 16]^T,
// A and B K-major in shared memory (descriptors da, db).
// wgmma_rs<N>: d[64 x N] += A[64 x 16] . B[16 x N], A in registers (four
// pairs of bf16 a thread), B MN-major in shared memory (transpose bit).
// Accumulator fragment of a thread of warp w, lane l: element j is row
// 16w + l/4 + 8*((j/2)%2), column 8*(j/4) + 2*(l%4) + j%2.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Start S = Q.K^T for one warpgroup's 64 query rows against BK keys, as
// one wgmma group: q and k are the shared addresses of chunk 0 of the Q
// rows and of the K tile; Q_CHUNK is the byte stride between Q's 64-column
// chunks.
template <int HDP, int BK, int Q_CHUNK>
__device__ __forceinline__ void qk_start(float (&s)[BK / 2], uint32_t q,
                                         uint32_t k) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < HDP / 64; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 columns (32 bytes) per k-step
      wgmma_ss<BK>(s, desc_sw128(q + c * Q_CHUNK + kk * 32, 16),
                   desc_sw128(k + c * BK * kRowBytes + kk * 32, 16),
                   (c | kk) != 0);
  wgmma_commit();
}

// Start acc += P_hi.V + P_lo.V over BK keys as one wgmma group; v is the
// shared address of the V tile. P's 16-key slice kk is registers
// 4kk..4kk+3 of each half.
template <int HDP, int BK>
__device__ __forceinline__ void pv_start(float (&acc)[HDP / 2],
                                         uint32_t (&p_hi)[BK / 4],
                                         uint32_t (&p_lo)[BK / 4],
                                         uint32_t v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = desc_sw128(v + kk * 16 * kRowBytes, BK * kRowBytes);
    wgmma_rs<HDP>(acc, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2],
                  p_hi[4 * kk + 3], db);
    wgmma_rs<HDP>(acc, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2],
                  p_lo[4 * kk + 3], db);
  }
  wgmma_commit();
}

// p -> p_hi = bf16(p), p_lo = bf16(p - p_hi), packed in pairs as the A
// fragment: the S accumulator's element pair (2i, 2i+1) is register i.
template <int BK>
__device__ __forceinline__ void split_p(const float (&p)[BK / 2],
                                        uint32_t (&p_hi)[BK / 4],
                                        uint32_t (&p_lo)[BK / 4]) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(p[2 * i], p[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(p[2 * i] - hf.x, p[2 * i + 1] - hf.y);
    p_hi[i] = reinterpret_cast<const uint32_t&>(h);
    p_lo[i] = reinterpret_cast<const uint32_t&>(l);
  }
}

// The softmax state of a consumer thread's two rows, ta and tb = ta + 8:
// running max m (log2 units), this thread's share of the normaliser l, and
// the factor corr the accumulator owes before the next P.V.
struct Rows {
  int ta, tb;
  float m_a, m_b, l_a, l_b, corr_a, corr_b;
};

// One tile's scores, in place, into probabilities relative to the updated
// running max: scale into log2 units, the masks where the tile crosses
// one, then the online max and normaliser. Element j of the fragment is
// row (j/2)%2 ? tb : ta, key s0 + 8*(j/4) + c0 + j%2.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], Rows& r,
                                             bool inside, int s0, int c0,
                                             int S, int causal, int window,
                                             float scale_log2) {
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) s[j] *= scale_log2;
  if (!inside) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int sp = s0 + 8 * (j / 4) + c0 + (j % 2);
      const int rel = ((j / 2) % 2 ? r.tb : r.ta) - sp;
      const bool keep =
          (!causal || rel >= 0) && (window <= 0 || rel < window);
      s[j] = sp >= S ? -INFINITY : (keep ? s[j] : kMasked);
    }
  }
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    if ((j / 2) % 2)
      mx_b = fmaxf(mx_b, s[j]);
    else
      mx_a = fmaxf(mx_a, s[j]);
  }
  // the four threads of a quad share a row
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(r.m_a, mx_a), mn_b = fmaxf(r.m_b, mx_b);
  r.corr_a = exp2f(r.m_a - mn_a);
  r.corr_b = exp2f(r.m_b - mn_b);
  r.m_a = mn_a;
  r.m_b = mn_b;
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    if ((j / 2) % 2) {
      s[j] = exp2f(s[j] - mn_b);
      sum_b += s[j];
    } else {
      s[j] = exp2f(s[j] - mn_a);
      sum_a += s[j];
    }
  }
  r.l_a = r.l_a * r.corr_a + sum_a;
  r.l_b = r.l_b * r.corr_b + sum_b;
}

// The producer of a THREADS instance, all 128 threads (tid 0..127): Q once,
// then each K/V tile into its ring stage once the consumers have released
// it, BYTES a copy.
template <int BYTES, int BQ, int STAGES, int KV_BYTES>
__device__ __forceinline__ void produce_threads(
    const Ptrs& src, uint32_t sq, uint32_t sk, uint32_t sv, uint32_t bar_q,
    int bh, int bkv, int t0, int Tq, int S, int hd, int kt0, int n_tiles,
    int tid) {
  const Walk w = make_walk(tid, hd, BYTES > 2 ? BYTES / 2 : 4);
  load_tile<BQ, BYTES>(sq, src.q + (static_cast<long long>(bh) * Tq + t0) * hd,
                       Tq - t0, hd, w);
  arrive_loaded<BYTES>(bar_q);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    mbar_wait(bar_q + 8 * (1 + 2 * STAGES + st),
              ((i / STAGES) & 1) ^ 1);  // stage released
    const int s0 = (kt0 + i) * kBK;
    const long long off = (static_cast<long long>(bkv) * S + s0) * hd;
    load_tile<kBK, BYTES>(sk + st * KV_BYTES, src.k + off, S - s0, hd, w);
    arrive_loaded<BYTES>(bar_q + 8 * (1 + st));
    load_tile<kBK, BYTES>(sv + st * KV_BYTES, src.v + off, S - s0, hd, w);
    arrive_loaded<BYTES>(bar_q + 8 * (1 + STAGES + st));
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <int HDP, bool THREADS>
__global__ void __launch_bounds__(Bucket<HDP, THREADS>::kThreads, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const Ptrs src,
                __nv_bfloat16* __restrict__ o, int nh, int group, int Tq,
                int S, int hd, int causal, int window, float scale) {
  constexpr int BK = kBK;
  using T = Bucket<HDP, THREADS>;
  constexpr int kConsumers = T::kConsumers;
  constexpr int kBQ = T::kBQ;
  using L = Smem<HDP, BK, kBQ>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  auto bar_k = [&](int st) { return bar_q + 8 * (1 + st); };
  auto bar_v = [&](int st) { return bar_q + 8 * (1 + kStages + st); };
  auto bar_e = [&](int st) { return bar_q + 8 * (1 + 2 * kStages + st); };

  const int h = blockIdx.x;                     // heads of a kv group adjoin
  const int t0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tile first
  const int b = blockIdx.z;
  const int bh = b * nh + h;
  const int bkv = b * (nh / group) + h / group;

  // Key tiles this query tile reads: those the masks leave to its rows,
  // when skipping the others is exact (every row keeps a key).
  const int t_last = min(t0 + kBQ, Tq) - 1;
  int lo = 0, hi = S;
  if (window <= 0 || static_cast<long long>(t_last) <=
                         static_cast<long long>(S) + window - 2) {
    if (causal) hi = min(S, t_last + 1);
    if (window > 0) lo = max(0, t0 - window + 1);
  }
  const int kt0 = lo / BK;
  const int n_tiles = (hi + BK - 1) / BK - kt0;

  if constexpr (THREADS) {
    zero_pad<HDP, kBQ>(sq, hd, threadIdx.x, T::kThreads);
    for (int st = 0; st < kStages; ++st) {
      zero_pad<HDP, BK>(sk + st * L::kKVBytes, hd, threadIdx.x, T::kThreads);
      zero_pad<HDP, BK>(sv + st * L::kKVBytes, hd, threadIdx.x, T::kThreads);
    }
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    // a full barrier counts TMA's one arrival (and its bytes) or one
    // arrival per producer thread
    constexpr uint32_t kFull = THREADS ? kProducers : 1;
    mbar_init(bar_q, kFull);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_k(st), kFull);
      mbar_init(bar_v(st), kFull);
      mbar_init(bar_e(st), kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, as a value the compiler sees is uniform in each warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    if constexpr (kConsumers == 2) setmaxnreg_dec<T::kProducerRegs>();
    if constexpr (THREADS) {
      // -- producer: its 128 threads copy every tile -----------------------
      const int tid = threadIdx.x - kConsumers * 128;
      if (src.copy == 8)
        produce_threads<8, kBQ, kStages, L::kKVBytes>(
            src, sq, sk, sv, bar_q, bh, bkv, t0, Tq, S, hd, kt0, n_tiles, tid);
      else if (src.copy == 4)
        produce_threads<4, kBQ, kStages, L::kKVBytes>(
            src, sq, sk, sv, bar_q, bh, bkv, t0, Tq, S, hd, kt0, n_tiles, tid);
      else
        produce_threads<2, kBQ, kStages, L::kKVBytes>(
            src, sq, sk, sv, bar_q, bh, bkv, t0, Tq, S, hd, kt0, n_tiles, tid);
    } else if (threadIdx.x == kConsumers * 128) {
      // -- producer: one thread starts every copy --------------------------
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(sq + c * L::kQChunk, &qmap, bar_q, c * 64, t0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(bar_e(st), ((i / kStages) & 1) ^ 1);  // stage released
        const int s0 = (kt0 + i) * BK;
        const uint32_t k_st = sk + st * L::kKVBytes;
        const uint32_t v_st = sv + st * L::kKVBytes;
        mbar_expect_tx(bar_k(st), L::kKVBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(k_st + c * L::kKVChunk, &kmap, bar_k(st), c * 64, s0,
                   bkv);
        mbar_expect_tx(bar_v(st), L::kKVBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(v_st + c * L::kKVChunk, &vmap, bar_v(st), c * 64, s0,
                   bkv);
      }
    }
  } else {
    // -- consumers: 64 query rows each -------------------------------------
    // Each step starts S_i = Q.K_i^T and the P_{i-1}.V_{i-1} owed for the
    // previous tile back to back, waits for both, then runs the softmax of
    // tile i; the other consumer's wgmmas fill the tensor cores meanwhile.
    if constexpr (kConsumers == 2) setmaxnreg_inc<T::kConsumerRegs>();
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int tw0 = t0 + wg * 64;  // first row of this warpgroup
    const int c0 = 2 * (lane % 4);  // its first column in each 8-column core
    const uint32_t q_wg = sq + wg * 64 * kRowBytes;
    // scores in log2 units: exp2 with log2(e) folded into the scale
    const float scale_log2 = scale * 1.44269504088896341f;
    Rows r{tw0 + warp * 16 + lane / 4, tw0 + warp * 16 + lane / 4 + 8,
           kMasked, kMasked, 0.0f, 0.0f, 1.0f, 1.0f};
    // no mask reaches a tile wholly inside S and inside every row's mask
    auto inside = [&](int s0) {
      return s0 + BK <= S && (!causal || s0 + BK - 1 <= tw0) &&
             (window <= 0 || tw0 + 63 - s0 < window);
    };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e(st));
    };
    // a tile has landed; copies by threads are ordered before the wgmmas
    auto wait_full = [&](uint32_t bar, uint32_t parity) {
      mbar_wait(bar, parity);
      if constexpr (THREADS) fence_proxy_async();
    };

    float acc[HDP / 2];
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) acc[j] = 0.0f;
    float s[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = 0.0f;
    uint32_t p_hi[BK / 4], p_lo[BK / 4];

    wait_full(bar_q, 0);
    wait_full(bar_k(0), 0);
    qk_start<HDP, BK, L::kQChunk>(s, q_wg, sk);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile<BK>(s, r, inside(kt0 * BK), kt0 * BK, c0, S, causal, window,
                     scale_log2);
    split_p<BK>(s, p_hi, p_lo);
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % kStages, prev = (i - 1) % kStages;
      const int s0 = (kt0 + i) * BK;
      wait_full(bar_k(st), (i / kStages) & 1);
      qk_start<HDP, BK, L::kQChunk>(s, q_wg, sk + st * L::kKVBytes);
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j)
        acc[j] *= (j / 2) % 2 ? r.corr_b : r.corr_a;
      wait_full(bar_v(prev), ((i - 1) / kStages) & 1);
      pv_start<HDP, BK>(acc, p_hi, p_lo, sv + prev * L::kKVBytes);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      release(prev);
      softmax_tile<BK>(s, r, inside(s0), s0, c0, S, causal, window,
                       scale_log2);
      split_p<BK>(s, p_hi, p_lo);
    }
    const int last = (n_tiles - 1) % kStages;
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j)
      acc[j] *= (j / 2) % 2 ? r.corr_b : r.corr_a;
    wait_full(bar_v(last), ((n_tiles - 1) / kStages) & 1);
    pv_start<HDP, BK>(acc, p_hi, p_lo, sv + last * L::kKVBytes);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    release(last);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      r.l_a += __shfl_xor_sync(0xffffffffu, r.l_a, off);
      r.l_b += __shfl_xor_sync(0xffffffffu, r.l_b, off);
    }
#pragma unroll
    for (int j = 0; j < HDP / 2; j += 2) {
      const int col = 8 * (j / 4) + c0;
      const bool second = (j / 2) % 2;
      const int t = second ? r.tb : r.ta;
      const float l = second ? r.l_b : r.l_a;
      if (t < Tq && col < hd) {
        __nv_bfloat16* at =
            o + (static_cast<long long>(bh) * Tq + t) * hd + col;
        if (THREADS && (hd & 1)) {
          // odd hd: the pair would cross into the next row, misaligned
          at[0] = __float2bfloat16_rn(acc[j] / l);
          if (col + 1 < hd) at[1] = __float2bfloat16_rn(acc[j + 1] / l);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(at) =
              __floats2bfloat162_rn(acc[j] / l, acc[j + 1] / l);
        }
      }
    }
  }
}

// Bring-up probe of the pieces above on one warpgroup: S = Q.K^T for 64
// query rows and BK keys, then O = S.V with S carried as two bf16 halves
// (no scale, mask or softmax), both written in float32 row-major, O with
// all HDP columns. The warpgroup loads its own tiles: TMA from thread 0,
// or every thread as a THREADS producer does. With small integer inputs
// every sum is exact, so both must equal the plain products bitwise, and
// O's columns from hd on must be 0.
template <int BYTES, int HDP>
__device__ __forceinline__ void probe_load(const Ptrs& src, uint32_t sq,
                                           uint32_t sk, uint32_t sv,
                                           uint32_t bar, int hd) {
  const Walk w = make_walk(threadIdx.x, hd, BYTES > 2 ? BYTES / 2 : 4);
  load_tile<64, BYTES>(sq, src.q, 64, hd, w);
  load_tile<kBK, BYTES>(sk, src.k, kBK, hd, w);
  load_tile<kBK, BYTES>(sv, src.v, kBK, hd, w);
  arrive_loaded<BYTES>(bar);
}

template <int HDP, bool THREADS>
__global__ void __launch_bounds__(128, 1)
fa_wgmma_tile_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const Ptrs src,
                     int hd, float* __restrict__ s_out,
                     float* __restrict__ o_out) {
  constexpr int BK = kBK;
  using L = Smem<HDP, BK, 64>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar = base + L::kBar;
  if constexpr (THREADS) {
    zero_pad<HDP, 64>(sq, hd, threadIdx.x, 128);
    zero_pad<HDP, BK>(sk, hd, threadIdx.x, 128);
    zero_pad<HDP, BK>(sv, hd, threadIdx.x, 128);
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    mbar_init(bar, THREADS ? kProducers : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if constexpr (THREADS) {
    if (src.copy == 8)
      probe_load<8, HDP>(src, sq, sk, sv, bar, hd);
    else if (src.copy == 4)
      probe_load<4, HDP>(src, sq, sk, sv, bar, hd);
    else
      probe_load<2, HDP>(src, sq, sk, sv, bar, hd);
  } else if (threadIdx.x == 0) {
    mbar_expect_tx(bar, L::kQBytes + 2 * L::kKVBytes);
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load(sq + c * L::kQChunk, &qmap, bar, c * 64, 0, 0);
      tma_load(sk + c * L::kKVChunk, &kmap, bar, c * 64, 0, 0);
      tma_load(sv + c * L::kKVChunk, &vmap, bar, c * 64, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  if constexpr (THREADS) fence_proxy_async();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ra = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  float s[BK / 2];
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) s[j] = 0.0f;
  qk_start<HDP, BK, L::kQChunk>(s, sq, sk);
  wgmma_wait<0>();
  fence_regs(s);
#pragma unroll
  for (int j = 0; j < BK / 2; ++j)
    s_out[(ra + 8 * ((j / 2) % 2)) * BK + 8 * (j / 4) + c0 + j % 2] = s[j];
  uint32_t p_hi[BK / 4], p_lo[BK / 4];
  split_p<BK>(s, p_hi, p_lo);
  float acc[HDP / 2];
#pragma unroll
  for (int j = 0; j < HDP / 2; ++j) acc[j] = 0.0f;
  pv_start<HDP, BK>(acc, p_hi, p_lo, sv);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(p_hi);
  fence_regs(p_lo);
#pragma unroll
  for (int j = 0; j < HDP / 2; ++j)
    o_out[(ra + 8 * ((j / 2) % 2)) * HDP + 8 * (j / 4) + c0 + j % 2] = acc[j];
}

// -- host ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 3-D map over a contiguous bf16 [heads, rows, hd] tensor: boxes of 64
// columns x box_rows rows x 1 head, 128-byte swizzle, zeros outside.
int make_map(CUtensorMap* map, const void* ptr, int hd, int rows, int heads,
             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrEntryPoint;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// Bytes a copy moves at head width hd: 16 (a TMA row is a multiple of 16
// bytes), else a thread loader's 8, 4 or (odd hd) 2. q, k and v must
// start on a multiple of it.
int copy_bytes(int hd) {
  return hd % 8 == 0 ? 16 : hd % 4 == 0 ? 8 : hd % 2 == 0 ? 4 : 2;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int HDP, bool THREADS>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int nh, int nkv, int Tq, int S, int hd, int causal, int window,
           float scale, cudaStream_t st) {
  using T = Bucket<HDP, THREADS>;
  using L = Smem<HDP, kBK, T::kBQ>;
  CUtensorMap qm{}, km{}, vm{};  // a thread loader reads none
  if constexpr (!THREADS) {
    int rc = make_map(&qm, q, hd, Tq, B * nh, T::kBQ);
    if (rc == 0) rc = make_map(&km, k, hd, S, B * nkv, kBK);
    if (rc == 0) rc = make_map(&vm, v, hd, S, B * nkv, kBK);
    if (rc != 0) return rc;
  }
  const Ptrs src{static_cast<const __nv_bfloat16*>(q),
                 static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), copy_bytes(hd)};
  const cudaError_t err = cudaFuncSetAttribute(
      fa_wgmma_kernel<HDP, THREADS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nh, (Tq + T::kBQ - 1) / T::kBQ, B);
  fa_wgmma_kernel<HDP, THREADS><<<grid, T::kThreads, L::kBytes, st>>>(
      qm, km, vm, src, static_cast<__nv_bfloat16*>(o), nh, nh / nkv, Tq, S,
      hd, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool THREADS>
int launch_bucket(const void* q, const void* k, const void* v, void* o,
                  int B, int nh, int nkv, int Tq, int S, int hd, int causal,
                  int window, float scale, cudaStream_t st) {
  if (hd <= 64)
    return launch<64, THREADS>(q, k, v, o, B, nh, nkv, Tq, S, hd, causal,
                               window, scale, st);
  if (hd <= 128)
    return launch<128, THREADS>(q, k, v, o, B, nh, nkv, Tq, S, hd, causal,
                                window, scale, st);
  if (hd <= 192)
    return launch<192, THREADS>(q, k, v, o, B, nh, nkv, Tq, S, hd, causal,
                                window, scale, st);
  return launch<256, THREADS>(q, k, v, o, B, nh, nkv, Tq, S, hd, causal,
                              window, scale, st);
}

template <int HDP, bool THREADS>
int launch_tile(const void* q, const void* k, const void* v, void* s_out,
                void* o_out, int hd, cudaStream_t st) {
  using L = Smem<HDP, kBK, 64>;
  CUtensorMap qm{}, km{}, vm{};
  if constexpr (!THREADS) {
    int rc = make_map(&qm, q, hd, 64, 1, 64);
    if (rc == 0) rc = make_map(&km, k, hd, kBK, 1, kBK);
    if (rc == 0) rc = make_map(&vm, v, hd, kBK, 1, kBK);
    if (rc != 0) return rc;
  }
  const Ptrs src{static_cast<const __nv_bfloat16*>(q),
                 static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), copy_bytes(hd)};
  const cudaError_t err = cudaFuncSetAttribute(
      fa_wgmma_tile_kernel<HDP, THREADS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_wgmma_tile_kernel<HDP, THREADS><<<1, 128, L::kBytes, st>>>(
      qm, km, vm, src, hd, static_cast<float*>(s_out),
      static_cast<float*>(o_out));
  return static_cast<int>(cudaGetLastError());
}

template <bool THREADS>
int launch_tile_bucket(const void* q, const void* k, const void* v,
                       void* s_out, void* o_out, int hd, cudaStream_t st) {
  if (hd <= 64) return launch_tile<64, THREADS>(q, k, v, s_out, o_out, hd, st);
  if (hd <= 128)
    return launch_tile<128, THREADS>(q, k, v, s_out, o_out, hd, st);
  if (hd <= 192)
    return launch_tile<192, THREADS>(q, k, v, s_out, o_out, hd, st);
  return launch_tile<256, THREADS>(q, k, v, s_out, o_out, hd, st);
}

}  // namespace

extern "C" {

const char* fa_wgmma_error_string(int code) {
  if (code == kErrEntryPoint)
    return "cuTensorMapEncodeTiled not found through "
           "cudaGetDriverEntryPoint (driver too old for TMA?)";
  if (code == kErrEncode)
    return "cuTensorMapEncodeTiled refused the tensor map (shape, stride "
           "or alignment)";
  if (code == kErrAlign)
    return "q, k or v does not start on a multiple of the loader's copy "
           "size (16 bytes at hd % 8 == 0, 8 at hd % 4 == 0, 4 at even hd)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/o: [B, nh, T, hd]; k/v: [B, nkv, S, hd], contiguous bfloat16, q, k and
// v starting on a multiple of copy_bytes(hd) and o on 4 bytes; nh % nkv ==
// 0, hd in 1..256, S >= 1, T >= 1; window <= 0 means no window; scale =
// hd^-0.5 as the caller rounds it to float32. hd goes to the narrowest
// bucket HDP in {64, 128, 192, 256}, through TMA at hd % 8 == 0 and the
// thread loader at other widths.
int fa_wgmma_forward(const void* q, const void* k, const void* v, void* o,
                     int B, int nh, int nkv, int Tq, int S, int hd,
                     int causal, int window, float scale, void* stream) {
  if (hd < 1 || hd > 256 || S < 1 || Tq < 1 || nkv < 1 || nh % nkv ||
      !aligned(o, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int copy = copy_bytes(hd);
  if (!aligned(q, copy) || !aligned(k, copy) || !aligned(v, copy))
    return kErrAlign;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (copy == 16)
    return launch_bucket<false>(q, k, v, o, B, nh, nkv, Tq, S, hd, causal,
                                window, scale, st);
  return launch_bucket<true>(q, k, v, o, B, nh, nkv, Tq, S, hd, causal,
                             window, scale, st);
}

// The probe: q [64, hd], k/v [64, hd] contiguous bfloat16 (aligned as for
// fa_wgmma_forward), hd in 1..256; s_out [64, 64] and o_out [64, HDP]
// float32, HDP the bucket of hd. Loads as fa_wgmma_forward does at hd.
int fa_wgmma_tile_check(const void* q, const void* k, const void* v,
                        void* s_out, void* o_out, int hd, void* stream) {
  if (hd < 1 || hd > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int copy = copy_bytes(hd);
  if (!aligned(q, copy) || !aligned(k, copy) || !aligned(v, copy))
    return kErrAlign;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (copy == 16)
    return launch_tile_bucket<false>(q, k, v, s_out, o_out, hd, st);
  return launch_tile_bucket<true>(q, k, v, s_out, o_out, hd, st);
}

}  // extern "C"
