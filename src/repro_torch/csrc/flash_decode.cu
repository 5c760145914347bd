// Flash-decode: one query token per head against a KV cache of `length`
// valid positions, with an optional sliding window (decode attention of the
// serving path).
//
// Replaces repro/kernels/flash_decode.py::flash_decode_pallas (the Pallas
// TPU kernel K5).  Same function: out[b,h] = softmax over the positions
// p < length (and p >= length - window) of (q . k_p) / sqrt(hd), times v_p,
// with query head h reading KV head h / G.  Scores and sums are f32; masked
// scores are -1e30 as in the reference.
//
// Design.  As in the Pallas kernel, the G query heads of one KV head are
// handled together, so each (batch, KV head) reads its cache once for all G
// of them; G need not be a power of two (qwen2 has G = 7).  B x KV is small
// at decode (16 for qwen2 at batch 8) and the card has 132 SMs, so the
// sequence is split across blocks (split-K): block (split, kvh, b) stages a
// 64-position chunk of K and V in shared memory as f32, computes the G x 64
// scores, and writes a partial (m, l, acc) per query head.  A second kernel
// merges the partials of the live chunks by log-sum-exp.  `length` and
// `window` arrive by value; chunks wholly at or past `length`, or wholly
// below `length - window`, exit at once, and the tail is masked, so the
// cache length need not be a multiple of the chunk.
//
// Bound.  Decode reads the cache's live positions once: 2 * B * KV *
// positions * hd * sizeof(T) bytes, an HBM bound (3.35 TB/s on an H100 SXM);
// its operations are few.  This simple kernel loads with one element per
// thread (not 16-byte vectors) and has no cp.async/TMA pipeline; at serving
// sizes a call moves a few MB and its time is near launch overhead.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int CH = 64;    // cache positions per split
constexpr int NT = 128;   // threads per split block
constexpr int NW = NT / 32;

// The lowest live cache position for a given length and window.
__device__ __forceinline__ int live_lo(int length, int window) {
  return (window > 0 && length > window) ? length - window : 0;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, float* __restrict__ m_part,
                          float* __restrict__ l_part, float* __restrict__ acc_part,
                          int S, int H, int KV, int length, int window,
                          int num_splits, float scale) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int s0 = split * CH;
  const int lo = live_lo(length, window);
  if (s0 >= length || s0 + CH <= lo) return;   // no live position in this chunk

  const int G = H / KV;
  constexpr int LD = HD + 1;                    // padded: conflict-free row reads
  extern __shared__ float smem[];
  float* Qs = smem;                             // [G][HD], pre-scaled
  float* Ks = Qs + G * HD;                      // [CH][LD]
  float* Vs = Ks + CH * LD;                     // [CH][HD]
  float* Ps = Vs + CH * HD;                     // [G][CH]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < G * HD; i += NT)
    Qs[i] = to_float(q[((size_t)b * H + kvh * G) * HD + i]) * scale;
  for (int i = tid; i < CH * HD; i += NT) {
    const int p = i / HD, d = i % HD, pos = s0 + p;
    float kx = 0.f, vx = 0.f;
    if (pos < S) {
      const size_t off = (((size_t)b * S + pos) * KV + kvh) * HD + d;
      kx = to_float(k[off]);
      vx = to_float(v[off]);
    }
    Ks[p * LD + d] = kx;
    Vs[p * HD + d] = vx;
  }
  __syncthreads();

  for (int i = tid; i < G * CH; i += NT) {
    const int g = i / CH, p = i % CH, pos = s0 + p;
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) s = fmaf(Qs[g * HD + d], Ks[p * LD + d], s);
    Ps[i] = (pos < length && pos >= lo) ? s : NEG_INF;
  }
  __syncthreads();

  // One warp per query head: the chunk's max, its probabilities, their sum.
  // A live chunk holds at least one unmasked position, so the max is finite.
  const size_t part0 = ((size_t)b * KV + kvh) * G;
  for (int g = warp; g < G; g += NW) {
    float mx = NEG_INF;
    for (int p = lane; p < CH; p += 32) mx = fmaxf(mx, Ps[g * CH + p]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int p = lane; p < CH; p += 32) {
      const float e = expf(Ps[g * CH + p] - mx);
      Ps[g * CH + p] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_part[(part0 + g) * num_splits + split] = mx;
      l_part[(part0 + g) * num_splits + split] = sum;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float a = 0.f;
#pragma unroll 16
    for (int p = 0; p < CH; ++p) a = fmaf(Ps[g * CH + p], Vs[p * HD + d], a);
    acc_part[((part0 + g) * num_splits + split) * HD + d] = a;
  }
}

// One block per (batch, query head), one thread per output column.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
flash_decode_merge_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                          const float* __restrict__ acc_part, T* __restrict__ o,
                          int H, int length, int window, int num_splits) {
  const int h = blockIdx.x % H, b = blockIdx.x / H, d = threadIdx.x;
  const size_t row = (size_t)b * H + h;   // == (b * KV + kvh) * G + g
  const int first = live_lo(length, window) / CH, last = (length - 1) / CH;
  const float* mp = m_part + row * num_splits;
  const float* lp = l_part + row * num_splits;
  float mx = NEG_INF;
  for (int s = first; s <= last; ++s) mx = fmaxf(mx, mp[s]);
  float l = 0.f, a = 0.f;
  for (int s = first; s <= last; ++s) {
    const float w = expf(mp[s] - mx);
    l = fmaf(lp[s], w, l);
    a = fmaf(acc_part[(row * num_splits + s) * HD + d], w, a);
  }
  o[row * HD + d] = from_float<T>(a / fmaxf(l, 1e-30f));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* m_part,
                   float* l_part, float* acc_part, int B, int S, int H, int KV,
                   int length, int window, int num_splits, cudaStream_t stream) {
  static size_t granted = 0;
  const int G = H / KV;
  const size_t smem = (size_t)(G * HD + CH * (HD + 1) + CH * HD + G * CH) * sizeof(float);
  cudaError_t e = allow_smem(flash_decode_split_kernel<T, HD>, smem, &granted);
  if (e != cudaSuccess) return e;
  flash_decode_split_kernel<T, HD><<<dim3(num_splits, KV, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      m_part, l_part, acc_part, S, H, KV, length, window, num_splits,
      1.0f / sqrtf((float)HD));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_decode_merge_kernel<T, HD><<<B * H, HD, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<T*>(o), H, length, window, num_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o,
                     float* mp, float* lp, float* ap, int B, int S, int H, int KV,
                     int length, int window, int ns, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, mp, lp, ap, B, S, H, KV, length, window, ns, s);
    case 32: return launch<T, 32>(q, k, v, o, mp, lp, ap, B, S, H, KV, length, window, ns, s);
    case 64: return launch<T, 64>(q, k, v, o, mp, lp, ap, B, S, H, KV, length, window, ns, s);
    case 128: return launch<T, 128>(q, k, v, o, mp, lp, ap, B, S, H, KV, length, window, ns, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Positions per split; the wrapper sizes the partial buffers with it.
extern "C" int flash_decode_chunk() { return CH; }

// q [B, 1, H, hd], k/v cache [B, S, KV, hd], o [B, 1, H, hd], contiguous, of
// one dtype (0 = f32, 1 = bf16).  m_part/l_part [B, H, num_splits] and
// acc_part [B, H, num_splits, hd] are f32 scratch, num_splits = ceil(S / CH).
// 1 <= length <= S; window <= 0 means no window.  Launches both kernels on
// `stream` and returns cudaGetLastError().
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, void* o,
                                void* m_part, void* l_part, void* acc_part, int dtype,
                                int B, int S, int H, int KV, int hd, int length,
                                int window, int num_splits, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || length < 1 || length > S ||
      num_splits != (S + CH - 1) / CH)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  if (dtype == repro::DTYPE_F32)
    return dispatch<float>(hd, q, k, v, o, mp, lp, ap, B, S, H, KV, length, window, num_splits, s);
  if (dtype == repro::DTYPE_BF16)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, mp, lp, ap, B, S, H, KV, length, window,
                                   num_splits, s);
  return cudaErrorInvalidValue;
}
