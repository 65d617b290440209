// Hand-written Hopper (sm_90a) attention forward: blocked online softmax
// with causal and sliding-window masks and grouped-query heads.
//
// Replaces the Pallas kernel _attn_kernel / flash_attention_pallas of
// src/repro/kernels/flash_attention/flash_attention.py:28 (:66) and
// computes what ../ref.py computes (the definition, attention_ref):
//
//   fa_forward -> fa_kernel<float> or fa_kernel<__nv_bfloat16>
//
// Design (the simple, right kernel first): one block of 256 threads per
// (query tile of kBQ = 64 rows, head, batch). The block holds its query
// tile, pre-scaled by hd^-0.5, in shared memory as float32, then walks the
// key/value tiles of kBK = 32 rows: each is staged through shared memory
// as float32, the block forms the 64 x 32 scores (each thread a 4 x 2
// patch), keeps per row the running max, normaliser and a 4 x hd/16 patch
// of the accumulator in registers (float32 throughout), and adds P.V.
// The 16 threads that share a row sit in one half-warp, so the row max and
// sum are shuffles. Kv head = h / (nh / nkv). hd is a runtime width up to
// kMaxHd = 256 and need not be a power of two (168 is tested): the
// accumulator patch is sized for 256 and masked. Shared rows are padded to
// an odd stride so the score loop reads distinct banks.
//
// Masks come from positions (rel = t - s). A masked pair scores -1e30, as
// in the definition, so a row whose every key is masked averages them all;
// a key at s >= S is outside the sequence and weighs exactly 0 (the Pallas
// path instead pads S with zero keys, which enter the softmax when
// causal=false). Key tiles that lie wholly outside every row's mask are
// skipped when each row of the tile keeps at least one key (always so when
// T <= S): the skipped pairs would weigh exactly 0.
//
// Bound on this card: operations. 4*hd flops per unmasked (query, key)
// pair; at bf16 that is the tensor cores' 989 TFLOP/s, at f32 the 67
// TFLOP/s outside them. This kernel uses neither wgmma nor TMA and reads
// its operands from shared memory one float at a time, so shared-memory
// bandwidth, not the bound, limits it; wgmma and a TMA pipeline are later
// work.
//
// Plain C entry point, loaded with ctypes: launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 16 row groups x 16 column threads
constexpr int kMaxHd = 256;
constexpr int kCols = kMaxHd / 16;  // accumulator columns per thread
constexpr int kRows = kBQ / 16;     // query rows per thread
constexpr int kKeys = kBK / 16;     // score columns per thread
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as .to(bfloat16)
}

size_t smem_bytes(int hd) {
  const int ld = hd + 1;
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * ld + static_cast<size_t>(kBK) * ld +
          static_cast<size_t>(kBK) * hd + static_cast<size_t>(kBQ) * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int nh, int group,
          int Tq, int S, int hd, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* sq = smem;              // [kBQ][ld], scaled queries
  float* sk = sq + kBQ * ld;     // [kBK][ld]
  float* sv = sk + kBK * ld;     // [kBK][hd]
  float* sp = sv + kBK * hd;     // [kBQ][kBK + 1], probabilities
  const int t0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nkv = nh / group;
  const long long q_off = (static_cast<long long>(b) * nh + h) * Tq * hd;
  const long long kv_off =
      (static_cast<long long>(b) * nkv + h / group) * S * hd;
  const int tx = threadIdx.x & 15;  // column thread
  const int ty = threadIdx.x >> 4;  // row group: rows ty*4 .. ty*4+3

  for (int i = threadIdx.x; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    const long long g = q_off + static_cast<long long>(t0 + r) * hd + c;
    sq[r * ld + c] = (t0 + r < Tq) ? to_f32(q[g]) * scale : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  // Key range the masks leave to this tile's rows, when skipping is exact.
  const int t_last = min(t0 + kBQ, Tq) - 1;
  int lo = 0, hi = S;
  const bool every_row_keeps_a_key =
      window <= 0 || static_cast<long long>(t_last) <=
                         static_cast<long long>(S) + window - 2;
  if (every_row_keeps_a_key) {
    if (causal) hi = min(S, t_last + 1);
    if (window > 0) lo = max(0, t0 - window + 1);
  }
  const int kt_end = (hi + kBK - 1) / kBK;

  for (int kt = lo / kBK; kt < kt_end; ++kt) {
    const int s0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBK * hd; i += kThreads) {
      const int r = i / hd, c = i - r * hd;
      const bool in = s0 + r < S;
      const long long g = kv_off + static_cast<long long>(s0 + r) * hd + c;
      sk[r * ld + c] = in ? to_f32(k[g]) : 0.0f;
      sv[r * hd + c] = in ? to_f32(v[g]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sq[(ty * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = sk[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = t0 + ty * kRows + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int sp_ = s0 + tx + 16 * j;
        const int rel = t - sp_;
        const bool keep =
            (!causal || rel >= 0) && (window <= 0 || rel < window);
        // a key past the sequence weighs 0: -inf, never the row max
        s[i][j] = sp_ >= S ? -INFINITY : (keep ? s[i][j] : kMasked);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sp[(ty * kRows + i) * (kBK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = sp[(ty * kRows + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        if (c < hd) {
          const float vv = sv[kk * hd + c];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = t0 + ty * kRows + i;
    if (t >= Tq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < hd)
        o[q_off + static_cast<long long>(t) * hd + c] =
            from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int nh, int nkv, int Tq, int S, int hd, int causal, int window,
           float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + kBQ - 1) / kBQ, nh, B);
  fa_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), nh, nh / nkv, Tq, S, hd,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fa_max_head_dim() { return kMaxHd; }

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/o: [B, nh, T, hd]; k/v: [B, nkv, S, hd], contiguous, all float32
// (bf16 = 0) or all bfloat16 (bf16 = 1); nh % nkv == 0, 1 <= hd <= 256,
// S >= 1, T >= 1; window <= 0 means no window; scale = hd^-0.5 as the
// caller rounds it to float32.
int fa_forward(const void* q, const void* k, const void* v, void* o, int B,
               int nh, int nkv, int Tq, int S, int hd, int causal, int window,
               float scale, int bf16, void* stream) {
  if (hd < 1 || hd > kMaxHd || S < 1 || Tq < 1 || nkv < 1 || nh % nkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, o, B, nh, nkv, Tq, S, hd,
                                      causal, window, scale, st)
              : launch<float>(q, k, v, o, B, nh, nkv, Tq, S, hd, causal,
                              window, scale, st);
}

}  // extern "C"
