// Causal flash-attention forward with GQA and an optional sliding window
// (prefill attention of the serving path).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (the
// Pallas TPU kernel K2).  Same function: out[b,q,h] = softmax over the keys
// k <= q (and k > q - window) of (q . k) / sqrt(hd), times v, with query head
// h reading KV head h / G.  Scores, running max m, running sum l and the
// accumulator are f32; masked scores are -1e30 as in the reference.
//
// Design.  One block of 128 threads per (batch, query head, 64-row query
// tile).  The TPU kernel's sequential KV grid axis becomes a loop inside the
// block; its first and last KV tiles come from the causal and window bounds,
// so fully masked tiles are never loaded.  The Q tile and each 64-key K/V
// tile are staged in shared memory as f32 (rows padded by one word, so that
// column reads hit distinct banks).  Each thread owns 4 query rows x 8 key
// columns of the score tile and 4 rows x hd/8 output columns; the 8 threads
// of a row group reduce the row max and sum by warp shuffles, and the
// probabilities pass through shared memory to the P.V product.  Ragged Sq
// and Sk are masked here, not padded by the caller.  G need not be a power
// of two (qwen2 has G = 7).
//
// Bound.  At prefill lengths the work is 4 * B * H * hd * (unmasked q,k
// pairs) operations, which on this card is a tensor-core bound (989 TFLOP/s
// bf16 dense on an H100 SXM).  This simple kernel runs its products as f32
// FMAs on the CUDA cores out of shared memory, so it leaves most of that on
// the table: no mma/wgmma, no TMA or cp.async pipeline, no warp
// specialisation, and bf16 inputs are widened to f32 on load.  That is work
// for a later change; PERF.md records its time against the bound.
#include "common.cuh"

namespace {
using namespace repro;

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per tile
constexpr int NT = 128;   // threads per block
constexpr int RPT = 4;    // query rows per thread
constexpr int CPT = 8;    // key columns per thread: c, c + 8, ..., c + 56
static_assert((NT / 8) * RPT == BQ && CPT * 8 == BK, "thread tiling");

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int Sq, int Sk, int H, int KV, int causal, int window,
                       float scale) {
  constexpr int LD = HD + 1;      // padded row stride of Q, K, V tiles
  constexpr int LP = BK + 1;      // padded row stride of the P tile
  constexpr int DPT = HD / 8;     // output columns per thread: c, c + 8, ...
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][LD], pre-scaled
  float* Ks = Qs + BQ * LD;       // [BK][LD]
  float* Vs = Ks + BK * LD;       // [BK][LD]
  float* Ps = Vs + BK * LD;       // [BQ][LP]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, r0 = (tid >> 3) * RPT, c = tid & 7;

  // KV range this tile can see: causal upper bound, window lower bound.
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, qp = q0 + r;
    Qs[r * LD + d] = qp < Sq
        ? to_float(q[(((size_t)b * Sq + qp) * H + h) * HD + d]) * scale : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.f;
  }

  for (int kt = (k_begin / BK) * BK; kt < k_end; kt += BK) {
    __syncthreads();  // Q is staged; the previous tile's K, V, P are consumed
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, kp = kt + r;
      float kx = 0.f, vx = 0.f;
      if (kp < Sk) {
        const size_t off = (((size_t)b * Sk + kp) * KV + kvh) * HD + d;
        kx = to_float(k[off]);
        vx = to_float(v[off]);
      }
      Ks[r * LD + d] = kx;
      Vs[r * LD + d] = vx;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(r0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(c + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Online softmax; the 8 threads of a row group are 8 adjacent lanes.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + r0 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = kt + c + 8 * j;
        const bool ok = kp < Sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = warp_max(mx, 8);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(r0 + i) * LP + c + 8 * j] = p;
        rs += p;
      }
      rs = warp_sum(rs, 8);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) acc[i][dd] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(r0 + i) * LP + j];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) vv[dd] = Vs[j * LD + c + 8 * dd];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = fmaf(pv[i], vv[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + r0 + i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * Sq + qp) * H + h) * HD;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) orow[c + 8 * dd] = from_float<T>(acc[i][dd] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int H, int KV, int causal, int window,
                   cudaStream_t stream) {
  static size_t granted = 0;
  const size_t smem = (size_t)(BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * (BK + 1)) * sizeof(float);
  cudaError_t e = allow_smem(flash_attention_kernel<T, HD>, smem, &granted);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KV, causal, window, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int KV, int causal, int window,
                     cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Sq, H, hd], k/v [B, Sk, KV, hd], o [B, Sq, H, hd], all contiguous and
// of one dtype (0 = f32, 1 = bf16).  window <= 0 means no window.  Launches
// on `stream` and returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Sk, int H, int KV,
                                   int hd, int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return dispatch<float>(hd, q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
  if (dtype == repro::DTYPE_BF16)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
  return cudaErrorInvalidValue;
}
