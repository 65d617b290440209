// Hand-written Hopper (sm_90a) attention forward in float32 on the tensor
// cores: 3xTF32 products (split operands) through mma.sync, K/V tiles
// through a cp.async ring in shared memory.
//
// Replaces the Pallas kernel _attn_kernel / flash_attention_pallas of
// src/repro/kernels/flash_attention/flash_attention.py:28 (:66) for
// float32 inputs at any head width hd in 1..256, and computes what
// ../ref.py computes (the definition, attention_ref):
//
//   fa_tf32x3_forward -> fa_tf32x3_kernel<W>, W = hd rounded up to 8
//
// bfloat16 inputs go to flash_attention_wgmma.cu; ../ops.py picks the
// kernel from dtype alone.
//
// Arithmetic. One TF32 product keeps 10 mantissa bits of each operand, so
// scores would be off by about 5e-4 relative, far outside the 2e-5 bar of
// the float32 route. Each operand x is therefore split in registers as it
// is loaded: hi = x rounded to TF32 as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero), lo = x - hi truncated to TF32; each
// product is lo.hi' + hi.lo' + hi.hi' in float32 accumulators, about 21
// bits of each operand for 3 tensor products per multiply. In P.V the
// three go in that order (the small terms first, as CUTLASS's 3xTF32
// does) into one accumulator; in S = Q.K^T the two small ones go to an
// accumulator of their own, added to the scores after the tile. Q, K, V
// and the probabilities P are split per fragment as it is loaded: Q stays
// whole in shared memory, half the room of its two halves, which lets two
// CTAs share an SM with more keys a tile (measured faster than Q split
// once at hd 168 and 256, as fast elsewhere; PERF.md). The scores are
// multiplied by hd^-0.5 * log2(e) in registers after the product (Q is not
// pre-scaled, which would round once more); masks, running max,
// normaliser and the accumulator are float32, the softmax runs on exp2,
// and each output is divided by its normaliser once at the end.
//
// Bound on this card: operations. 2 products of 2*hd flops per unmasked
// (query, key) pair, each issued 3 times: 12*hd flops at the 495 TFLOP/s of
// dense TF32, an effective 165 TFLOP/s of float32 work against the 67 of
// any SIMT design. What the design does about it:
// - one CTA of 4 warps per (query tile of 64 rows, head, batch), launched
//   heaviest causal tile first, the query heads of one kv head next to
//   each other in launch order so their K/V tiles are still in L2;
// - each warp owns 16 query rows: S = Q.K^T as mma.sync m16n8k8 over
//   k-steps of 8 along hd, O += P.V over k-steps of 8 along the key tile.
//   mma.sync (not wgmma) because the threads load their own fragments, so
//   V is read [keys, hd] as it lies; tf32 wgmma takes only K-major
//   operands and would need V transposed in shared memory;
// - P enters P.V straight from the score accumulator: the k index of each
//   8-key step is permuted (slot c <-> key 2c, slot c+4 <-> key 2c+1) and
//   V's fragment rows are read in the same order, so no shuffle is needed;
// - K/V tiles come through cp.async: 16-byte copies where hd % 4 == 0 and
//   the pointers are 16-byte aligned, 4-byte copies otherwise (TMA would
//   need 16-byte rows). Columns hd..W-1 and rows past T or S are
//   zero-filled by the copies;
// - shared rows are W + 4 floats apart, so each fragment load of a warp
//   (Q and K along rows, V down two rows) hits 32 distinct banks;
// - one instance per W = 8, 16, ..., 256: every loop has a compile-time
//   trip count and no branch, so the compiler interleaves the products of
//   different column tiles (a branch per tile left each tile's three
//   dependent products back to back, 2x slower; PERF.md), and O takes
//   W/2 registers a thread;
// - the K/V ring (Tiles): 2 stages of 64 or 32 keys, 1 of 32, 2 of 16 or 1
//   of 16, the first whose shared memory (Q's 64 rows and the ring, rows
//   W + 4 floats apart) lets two CTAs share an SM: 8 warps hide each
//   other's latency (at hd 168, 2 CTAs an SM on 1 stage of 16 keys ran
//   1.4x faster than 1 on 2 stages of 32). W 64: 2 of 64 keys, 85 KB;
//   W 128: 2 of 32, 99 KB; W 168: 1 of 32, 86 KB; W 256: 1 of 16, 98 KB.
//
// Masks come from positions (rel = t - s): causal keeps rel >= 0, a window
// keeps rel < window; a masked pair scores exactly -1e30, so a row whose
// every key is masked averages all keys; a key at s >= S weighs 0. Key
// tiles outside every row's mask are skipped (by the CTA, and by a warp for
// its own 16 rows) only where each row of the query tile keeps a key
// (always so when T <= S): the skipped pairs would weigh exactly 0.
//
// Plain C entry points, loaded with ctypes: launch on the caller's stream,
// allocate nothing, return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per CTA: 4 warps of 16
constexpr int kThreads = 128;
constexpr int kMaxHd = 256;
constexpr int kProbeKeys = 16;  // keys of the bring-up probe
constexpr float kMasked = -1e30f;

// Shared bytes of a CTA at padded width W with `stages` K/V stages of bk
// keys: Q, then K and V per stage, every row W + 4 floats.
constexpr int smem_bytes(int w, int stages, int bk) {
  return 4 * (w + 4) * (kBQ + 2 * stages * bk);
}
// What an SM's 228 KB hold for each of two CTAs (each also reserves 1 KB).
constexpr int kTwoPerSm = 115712;

// The K/V ring of padded width W (hd rounded up to 8): the first of 2
// stages of 64 or 32 keys, 1 of 32, 2 of 16 or 1 of 16 that lets two CTAs
// share an SM (8 warps hide each other's latency; measured, PERF.md).
template <int W>
struct Tiles {
  static constexpr int pick() {  // stages * 1000 + keys
    const int options[5][2] = {{2, 64}, {2, 32}, {1, 32}, {2, 16}, {1, 16}};
    for (int i = 0; i < 5; ++i)
      if (smem_bytes(W, options[i][0], options[i][1]) <= kTwoPerSm)
        return options[i][0] * 1000 + options[i][1];
    return 0;
  }
  static constexpr int kStages = pick() / 1000, kBK = pick() % 1000;
  static constexpr int kBytes = smem_bytes(W, kStages, kBK);
  static_assert(kBK > 0, "two CTAs an SM");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- cp.async ----------------------------------------------------------------

// n of 16 bytes copied, the rest of the 16 zero-filled (n is 0 or 16)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// n of 4 bytes copied, the rest zero-filled (n is 0 or 4)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
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

// Start copying ROWS x W floats of a [*, hd] row-major source into dst
// (row stride W + 4): rows at or past `valid` and columns at or past hd
// read zeros. Every thread of the CTA takes part, walking the elements (or
// 16-byte chunks) in steps of the block size without a division each.
template <int W, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int valid, int hd, int vec16) {
  constexpr int ld = W + 4;
  const int per = vec16 ? 4 : 1;  // floats a copy
  const int cols = W / per;
  const int dr = blockDim.x / cols, dc = blockDim.x % cols;
  int r = threadIdx.x / cols, cc = threadIdx.x % cols;
  while (r < ROWS) {
    const int c = per * cc;
    const bool in = r < valid && c < hd;
    const float* from = in ? src + static_cast<long long>(r) * hd + c : src;
    if (vec16)
      cp_async16(dst + r * ld + c, from, in ? 16 : 0);
    else
      cp_async4(dst + r * ld + c, from, in ? 4 : 0);
    r += dr;
    cc += dc;
    if (cc >= cols) {
      cc -= cols;
      ++r;
    }
  }
}

// -- 3xTF32 on mma.sync --------------------------------------------------------

// x rounded to TF32 (10 mantissa bits) on its bits, to nearest with ties
// away from zero: what cvt.rna.tf32.f32 computes for every finite x, in two
// integer operations where the conversion costs more (measured, PERF.md).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32: lo carries the 13 bits hi drops, less the last
// 2 or 3 of them, truncated (one operation where rounding takes two; the
// error stays under 2^-21 of x either way; measured faster, PERF.md)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d[0..3] += a . b: m16n8k8, TF32 operands, float32 accumulator.
// Fragments (g = lane / 4, c = lane % 4): a0 (g, c), a1 (g+8, c),
// a2 (g, c+4), a3 (g+8, c+4); b0 (k c, n g), b1 (k c+4, n g);
// d0 (g, 2c), d1 (g, 2c+1), d2 (g+8, 2c), d3 (g+8, 2c+1).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in 3xTF32: the two small products first, hi.hi last
__device__ __forceinline__ void mma3(float* d, const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// A warp's scores for NJ groups of 8 keys: s[4j..4j+3] += Q[16 rows from
// row wr] . K[8j..8j+7]^T over the W/8 k-steps of 8 along hd, Q and K
// split as they are loaded (row stride W + 4). s[4j+e] is row
// g + 8*(e/2), key 8j + 2c + e%2 (g = lane / 4, c = lane % 4). The two
// small products go to an accumulator of their own, added at the end: with
// as few as 2 groups of keys, one accumulator a group would chain every
// product of the tile (measured faster, and closer to the definition,
// PERF.md).
template <int W, int NJ>
__device__ __forceinline__ void score_tile(float* s, const float* sq,
                                           const float* sk, int wr, int g,
                                           int c) {
  constexpr int ld = W + 4;
  const int r0 = (wr + g) * ld + c, r1 = r0 + 8 * ld;
  float small[4 * NJ] = {};
#pragma unroll
  for (int ks = 0; ks < W / 8; ++ks) {
    const int k0 = 8 * ks;
    uint32_t ah[4], al[4];
    split(sq[r0 + k0], ah[0], al[0]);
    split(sq[r1 + k0], ah[1], al[1]);
    split(sq[r0 + k0 + 4], ah[2], al[2]);
    split(sq[r1 + k0 + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* kr = sk + (8 * j + g) * ld + k0 + c;
      uint32_t bh[2], bl[2];
      split(kr[0], bh[0], bl[0]);
      split(kr[4], bh[1], bl[1]);
      mma_tf32(small + 4 * j, al, bh);
      mma_tf32(small + 4 * j, ah, bl);
      mma_tf32(s + 4 * j, ah, bh);
    }
  }
#pragma unroll
  for (int i = 0; i < 4 * NJ; ++i) s[i] += small[i];
}

// A warp's acc[4n..4n+3] += P . V[:, 8n..8n+7] for the W/8 column tiles,
// over NJ k-steps of 8 keys. P is the score fragment of score_tile
// (probabilities by then): its k index is permuted (slot c is key 2c,
// slot c+4 key 2c+1), so V's fragment reads rows 2c and 2c+1. No branch:
// one would split the tiles into blocks the compiler cannot interleave,
// leaving each tile's three dependent products to run back to back.
template <int W, int NJ>
__device__ __forceinline__ void pv_tile(float* acc, const float* p,
                                        const float* sv, int g, int c) {
  constexpr int ld = W + 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t ah[4], al[4];
    split(p[4 * j], ah[0], al[0]);
    split(p[4 * j + 2], ah[1], al[1]);
    split(p[4 * j + 1], ah[2], al[2]);
    split(p[4 * j + 3], ah[3], al[3]);
    const float* vr = sv + (8 * j + 2 * c) * ld + g;
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      uint32_t bh[2], bl[2];
      split(vr[8 * n], bh[0], bl[0]);
      split(vr[8 * n + ld], bh[1], bl[1]);
      mma3(acc + 4 * n, ah, al, bh, bl);
    }
  }
}

// -- the softmax -------------------------------------------------------------

// The softmax state of a thread's two rows, ta and tb = ta + 8: running
// max m (log2 units), this thread's share of the normaliser l, and the
// factor corr the accumulator owes before the next P.V.
struct Rows {
  int ta, tb;
  float m_a, m_b, l_a, l_b, corr_a, corr_b;
};

// One tile's scores, in place, into probabilities relative to the updated
// running max: scale into log2 units, the masks where the tile crosses
// one, then the online max and normaliser. Element j of the fragment is
// row (j/2)%2 ? tb : ta, key s0 + 8*(j/4) + c2 + j%2.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], Rows& r,
                                             bool inside, int s0, int c2,
                                             int S, int causal, int window,
                                             float scale_log2) {
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) s[j] *= scale_log2;
  if (!inside) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int sp = s0 + 8 * (j / 4) + c2 + (j % 2);
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

// -- the kernel --------------------------------------------------------------

template <int W>
__global__ void __launch_bounds__(kThreads, 2)
fa_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int nh,
                 int group, int Tq, int S, int hd, int causal, int window,
                 float scale, int vec16) {
  constexpr int BK = Tiles<W>::kBK, NS = Tiles<W>::kStages, ld = W + 4;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* skv = sq + kBQ * ld;
  auto stage_k = [&](int st) { return skv + st * 2 * BK * ld; };
  auto stage_v = [&](int st) { return skv + (st * 2 + 1) * BK * ld; };

  const int h = blockIdx.x;  // the heads of a kv group adjoin
  const int t0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tile first
  const int b = blockIdx.z;
  const float* qb = q + (static_cast<long long>(b) * nh + h) * Tq * hd;
  const long long kv_head = static_cast<long long>(b) * (nh / group) +
                            h / group;
  const float* kb = k + kv_head * S * hd;
  const float* vb = v + kv_head * S * hd;

  // Key tiles this query tile reads: those the masks leave to its rows,
  // when skipping the others is exact (every row keeps a key).
  const int t_last = min(t0 + kBQ, Tq) - 1;
  const bool every_row_keeps_a_key =
      window <= 0 || static_cast<long long>(t_last) <=
                         static_cast<long long>(S) + window - 2;
  int lo = 0, hi = S;
  if (every_row_keeps_a_key) {
    if (causal) hi = min(S, t_last + 1);
    if (window > 0) lo = max(0, t0 - window + 1);
  }
  const int kt0 = lo / BK;
  const int n_tiles = (hi + BK - 1) / BK - kt0;

  load_rows<W, kBQ>(sq, qb + static_cast<long long>(t0) * hd, Tq - t0, hd,
                    vec16);
  const long long first = static_cast<long long>(kt0) * BK * hd;
  load_rows<W, BK>(stage_k(0), kb + first, S - kt0 * BK, hd, vec16);
  load_rows<W, BK>(stage_v(0), vb + first, S - kt0 * BK, hd, vec16);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int wr = 16 * warp;  // the warp's first row in the tile
  const int tw0 = t0 + wr;
  // the keys this warp's rows may see, where skipping is exact
  int w_lo = 0, w_hi = S;
  if (every_row_keeps_a_key) {
    if (causal) w_hi = min(S, min(tw0 + 15, Tq - 1) + 1);
    if (window > 0) w_lo = max(0, tw0 - window + 1);
  }
  const bool has_rows = tw0 < Tq;
  // scores in log2 units: exp2 with log2(e) folded into the scale
  const float scale_log2 = scale * 1.44269504088896341f;
  Rows r{tw0 + g, tw0 + g + 8, kMasked, kMasked, 0.0f, 0.0f, 1.0f, 1.0f};

  float acc[W / 2];
#pragma unroll
  for (int j = 0; j < W / 2; ++j) acc[j] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = NS == 2 ? i & 1 : 0, s0 = (kt0 + i) * BK;
    if (NS == 2 && i + 1 < n_tiles) {  // the next tile into the other stage
      const long long next = static_cast<long long>(s0 + BK) * hd;
      load_rows<W, BK>(stage_k(st ^ 1), kb + next, S - s0 - BK, hd, vec16);
      load_rows<W, BK>(stage_v(st ^ 1), vb + next, S - s0 - BK, hd, vec16);
    }
    if (NS == 1 && i > 0) {  // one stage: this tile, after the last is done
      const long long here = static_cast<long long>(s0) * hd;
      load_rows<W, BK>(stage_k(0), kb + here, S - s0, hd, vec16);
      load_rows<W, BK>(stage_v(0), vb + here, S - s0, hd, vec16);
    }
    cp_async_commit();
    cp_async_wait<NS - 1>();  // this tile has landed
    __syncthreads();
    if (has_rows && s0 < w_hi && s0 + BK > w_lo) {
      float s[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] = 0.0f;
      score_tile<W, BK / 8>(s, sq, stage_k(st), wr, g, c);
      // no mask reaches a tile wholly inside S and every row's mask
      const bool inside = s0 + BK <= S && (!causal || s0 + BK - 1 <= tw0) &&
                          (window <= 0 || tw0 + 15 - s0 < window);
      softmax_tile<BK>(s, r, inside, s0, 2 * c, S, causal, window,
                       scale_log2);
#pragma unroll
      for (int j = 0; j < W / 2; ++j)
        acc[j] *= (j / 2) % 2 ? r.corr_b : r.corr_a;
      pv_tile<W, BK / 8>(acc, s, stage_v(st), g, c);
    }
    __syncthreads();  // this stage is free for the tile NS on
  }
  if (!has_rows) return;

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    r.l_a += __shfl_xor_sync(0xffffffffu, r.l_a, off);
    r.l_b += __shfl_xor_sync(0xffffffffu, r.l_b, off);
  }
  float* ob = o + (static_cast<long long>(b) * nh + h) * Tq * hd;
#pragma unroll
  for (int j = 0; j < W / 2; ++j) {
    const int col = 8 * (j / 4) + 2 * c + j % 2;
    const bool second = (j / 2) % 2;
    const int t = second ? r.tb : r.ta;
    if (t < Tq && col < hd)
      ob[static_cast<long long>(t) * hd + col] =
          acc[j] / (second ? r.l_b : r.l_a);
  }
}

// Bring-up probe of the pieces above on one warp, at the layout of W = 64:
// q, k and v [16, w] row-major float32 (w a multiple of 8 in 8..64; 16
// keys; columns w..63 zero-filled) go through load_rows, score_tile and
// pv_tile, with no scale, mask or softmax: S = q.k^T
// [16, 16] and O = S.v [16, w], S carried into the second product as the
// kernel carries P. With integer inputs whose every sum is exact and where
// no product of two low halves is nonzero, both must equal the plain
// products bitwise.
__global__ void __launch_bounds__(32)
fa_tf32x3_tile_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ s_out,
                      float* __restrict__ o_out, int w) {
  constexpr int W = 64, kRows = 16, ld = W + 4;
  __shared__ __align__(16) float smem[(kRows + 2 * kProbeKeys) * ld];
  float* sq = smem;
  float* sk = sq + kRows * ld;
  float* sv = sk + kProbeKeys * ld;
  load_rows<W, kRows>(sq, q, kRows, w, 1);
  load_rows<W, kProbeKeys>(sk, k, kProbeKeys, w, 1);
  load_rows<W, kProbeKeys>(sv, v, kProbeKeys, w, 1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  const int g = threadIdx.x / 4, c = threadIdx.x % 4;
  float s[kProbeKeys / 2] = {};
  score_tile<W, kProbeKeys / 8>(s, sq, sk, 0, g, c);
  float acc[W / 2] = {};
  pv_tile<W, kProbeKeys / 8>(acc, s, sv, g, c);
#pragma unroll
  for (int j = 0; j < kProbeKeys / 2; ++j)
    s_out[(g + 8 * ((j / 2) % 2)) * kProbeKeys + 8 * (j / 4) + 2 * c +
          j % 2] = s[j];
#pragma unroll
  for (int j = 0; j < W / 2; ++j) {
    const int col = 8 * (j / 4) + 2 * c + j % 2;
    if (col < w) o_out[(g + 8 * ((j / 2) % 2)) * w + col] = acc[j];
  }
}

template <int W>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int nh, int nkv, int Tq, int S, int hd, int causal, int window,
           float scale, cudaStream_t st) {
  constexpr int smem = Tiles<W>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa_tf32x3_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) %
                        16) == 0;
  const dim3 grid(nh, (Tq + kBQ - 1) / kBQ, B);
  fa_tf32x3_kernel<W><<<grid, kThreads, smem, st>>>(
      q, k, v, o, nh, nh / nkv, Tq, S, hd, causal, window, scale,
      static_cast<int>(aligned && hd % 4 == 0));
  return static_cast<int>(cudaGetLastError());
}

// The instance of the padded width hd rounds up to: W = 8, 16, ..., 256.
template <int W>
int dispatch(const float* q, const float* k, const float* v, float* o, int B,
             int nh, int nkv, int Tq, int S, int hd, int causal, int window,
             float scale, cudaStream_t st) {
  if constexpr (W < kMaxHd) {
    if (hd > W)
      return dispatch<W + 8>(q, k, v, o, B, nh, nkv, Tq, S, hd, causal,
                             window, scale, st);
  }
  return launch<W>(q, k, v, o, B, nh, nkv, Tq, S, hd, causal, window, scale,
                   st);
}

// Tiles of the instance hd rounds up to, as stages * 1000 + keys.
template <int W>
int tiles_of(int hd) {
  if constexpr (W < kMaxHd) {
    if (hd > W) return tiles_of<W + 8>(hd);
  }
  return Tiles<W>::kStages * 1000 + Tiles<W>::kBK;
}

}  // namespace

extern "C" {

const char* fa_tf32x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/o: [B, nh, T, hd]; k/v: [B, nkv, S, hd], contiguous float32;
// nh % nkv == 0, 1 <= hd <= 256, S >= 1, T >= 1; window <= 0 means no
// window; scale = hd^-0.5 as the caller rounds it to float32.
int fa_tf32x3_forward(const void* q, const void* k, const void* v, void* o,
                      int B, int nh, int nkv, int Tq, int S, int hd,
                      int causal, int window, float scale, void* stream) {
  if (hd < 1 || hd > kMaxHd || S < 1 || Tq < 1 || nkv < 1 || nh % nkv)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<8>(static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(o), B,
                     nh, nkv, Tq, S, hd, causal, window, scale,
                     static_cast<cudaStream_t>(stream));
}

// The K/V ring of the kernel at head width hd (1..256), as
// stages * 1000 + keys; -1 outside 1..256.
int fa_tf32x3_tiles(int hd) {
  if (hd < 1 || hd > kMaxHd) return -1;
  return tiles_of<8>(hd);
}

// The probe of fa_tf32x3_tile_kernel: q, k, v [16, w] float32 (w a
// multiple of 8 in 8..64, 16-byte aligned) -> s [16, 16], o [16, w].
int fa_tf32x3_tile_check(const void* q, const void* k, const void* v,
                         void* s, void* o, int w, void* stream) {
  if (w < 8 || w > 64 || w % 8) return static_cast<int>(cudaErrorInvalidValue);
  fa_tf32x3_tile_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(s),
      static_cast<float*>(o), w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
