// Fused DuDe server round + optimizer step on the flat slabs: one pass over
// the parameter axis P of the [n, P] worker slabs and the [P] vectors.
//
// Replaces repro/kernels/dude_update.py::dude_round_apply_pallas (the Pallas
// TPU kernel K1; its body is _round_apply_kernel + _opt_apply).  Same
// function, for each column j of P:
//   g       = g_bar + (sum over i in row order of cm_i * (infl_i - gw_i)) / n
//   gw_i    = infl_i  where cm_i > 0    (the buffer value, copied)
//   infl_i  = fresh_i where sm_i        (rounded to nearest even into bf16)
//   g_bar   = g
//   w, slots: the SGD / momentum (nesterov) / AdamW step on g, in the op
//             order of optim.transforms.FlatOptimizer.update.
// The round writes in place: every element is read by the thread that owns
// its column before that thread writes it, and no two threads share a
// column.  (The reference returns new arrays and donates the old ones; at
// full width the slabs hold ~30 GiB, so out-of-place outputs do not fit.)
//
// Design.  One thread per column in a grid-stride loop; the thread walks
// the n rows and keeps the sum in a register, so the worker-axis reduction
// needs no second pass.  Neighbouring threads read neighbouring columns, so
// every load and store of a warp is coalesced.  Rows are taken R at a time
// with all 3 R loads issued before any use, to keep loads in flight.
// Indices are 64-bit: at full width n * P = 16 * 494,032,768 > 2^31.  The
// optimizer tail uses __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, so
// nvcc cannot contract it into FMAs and the order is the reference's.
// This first kernel streams every row whatever its mask bits; skipping
// rows whose bits are off, and 16-byte vector loads, are later work.
//
// Bound.  About one flop per byte: HBM.  Per column it reads fresh, gw and
// infl (n rows each), g_bar, w and the slots, and writes gw, infl, g_bar,
// w and the slots; at full width (n = 16, f32 fresh, bf16 buffers, SGD)
// that is 208 bytes, 102.8 GB per round, 30.7 ms at 3.35 TB/s.
#include "common.cuh"

#include <cstdint>

namespace {
using namespace repro;

constexpr int NT = 256;   // threads per block
constexpr int R = 4;      // rows loaded together by one thread

enum Kind { SGD = 0, MOMENTUM = 1, NESTEROV = 2, ADAMW = 3 };

struct Hparams {
  float lr, beta, b1, omb1, b2, omb2, eps, wd;   // omb = 1 - b, formed in double
};

template <typename B> __device__ __forceinline__ B latch(float x);
template <> __device__ __forceinline__ float latch<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 latch<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename F, typename B, int KIND>
__global__ void __launch_bounds__(NT)
dude_round_apply_kernel(const F* __restrict__ fresh, B* __restrict__ gw,
                        B* __restrict__ infl, float* __restrict__ gbar,
                        float* __restrict__ w, float* __restrict__ m_slot,
                        float* __restrict__ v_slot, const float* __restrict__ cm,
                        const uint8_t* __restrict__ sm, const float* __restrict__ bc,
                        int n, int64_t P, Hparams hp) {
  float bc1 = 1.f, bc2 = 1.f;
  if (KIND == ADAMW) {
    bc1 = bc[0];
    bc2 = bc[1];
  }
  const float nf = static_cast<float>(n);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NT;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; j < P; j += stride) {
    float acc = 0.f;
    for (int i0 = 0; i0 < n; i0 += R) {
      F f[R];
      B g[R], v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (i0 + r < n) {
          const int64_t idx = static_cast<int64_t>(i0 + r) * P + j;
          f[r] = fresh[idx];
          g[r] = gw[idx];
          v[r] = infl[idx];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (i0 + r < n) {
          const int i = i0 + r;
          const int64_t idx = static_cast<int64_t>(i) * P + j;
          const float c = cm[i];
          acc = __fadd_rn(acc, __fmul_rn(c, __fsub_rn(to_float(v[r]), to_float(g[r]))));
          if (c > 0.f) gw[idx] = v[r];
          if (sm[i]) infl[idx] = latch<B>(to_float(f[r]));
        }
      }
    }
    const float gj = __fadd_rn(gbar[j], __fdiv_rn(acc, nf));
    gbar[j] = gj;
    const float wj = w[j];
    if (KIND == SGD) {
      w[j] = __fsub_rn(wj, __fmul_rn(hp.lr, gj));
    } else if (KIND == MOMENTUM || KIND == NESTEROV) {
      const float m = __fadd_rn(__fmul_rn(hp.beta, m_slot[j]), gj);
      const float d = KIND == NESTEROV ? __fadd_rn(__fmul_rn(hp.beta, m), gj) : m;
      w[j] = __fsub_rn(wj, __fmul_rn(hp.lr, d));
      m_slot[j] = m;
    } else {
      const float m = __fadd_rn(__fmul_rn(hp.b1, m_slot[j]), __fmul_rn(hp.omb1, gj));
      const float v = __fadd_rn(__fmul_rn(hp.b2, v_slot[j]), __fmul_rn(hp.omb2, __fmul_rn(gj, gj)));
      const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), hp.eps);
      const float step = __fadd_rn(__fdiv_rn(__fdiv_rn(m, bc1), denom), __fmul_rn(hp.wd, wj));
      w[j] = __fsub_rn(wj, __fmul_rn(hp.lr, step));
      m_slot[j] = m;
      v_slot[j] = v;
    }
  }
}

int grid_for(int64_t P) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int64_t need = (P + NT - 1) / NT;
  const int64_t cap = static_cast<int64_t>(sms) * 8;   // 8 blocks of 256 fill an SM
  return static_cast<int>(need < cap ? need : cap);
}

template <typename F, typename B>
int launch(int kind, const void* fresh, void* gw, void* infl, float* gbar, float* w,
           float* m, float* v, const float* cm, const uint8_t* sm, const float* bc, int n,
           int64_t P, Hparams hp, cudaStream_t s) {
  const F* f = static_cast<const F*>(fresh);
  B* g = static_cast<B*>(gw);
  B* i = static_cast<B*>(infl);
  const int grid = grid_for(P);
  switch (kind) {
    case SGD:
      dude_round_apply_kernel<F, B, SGD><<<grid, NT, 0, s>>>(f, g, i, gbar, w, m, v, cm, sm, bc, n, P, hp);
      break;
    case MOMENTUM:
      dude_round_apply_kernel<F, B, MOMENTUM><<<grid, NT, 0, s>>>(f, g, i, gbar, w, m, v, cm, sm, bc, n, P, hp);
      break;
    case NESTEROV:
      dude_round_apply_kernel<F, B, NESTEROV><<<grid, NT, 0, s>>>(f, g, i, gbar, w, m, v, cm, sm, bc, n, P, hp);
      break;
    case ADAMW:
      dude_round_apply_kernel<F, B, ADAMW><<<grid, NT, 0, s>>>(f, g, i, gbar, w, m, v, cm, sm, bc, n, P, hp);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// fresh [n, P] (fresh_dtype), gw / infl [n, P] (buf_dtype), gbar / w / m / v
// [P] f32, cm [n] f32, sm [n] u8, bc [2] f32 (AdamW's 1 - b1^t, 1 - b2^t);
// all contiguous on the current device; dtype codes 0 = f32, 1 = bf16.
// kind: 0 sgd, 1 momentum, 2 nesterov momentum, 3 adamw; m is read for
// kinds 1-3, v and bc for kind 3, and may be null otherwise.  Updates gw,
// infl, gbar, w, m and v in place on `stream`; returns cudaGetLastError().
extern "C" int dude_round_apply(const void* fresh, void* gw, void* infl, void* gbar, void* w,
                                void* m, void* v, const void* cm, const void* sm,
                                const void* bc, int fresh_dtype, int buf_dtype, int kind,
                                int n, long long P, float lr, float beta, float b1, float omb1,
                                float b2, float omb2, float eps, float wd, void* stream) {
  if (n < 1 || P < 1 || kind < SGD || kind > ADAMW || (kind != SGD && m == nullptr) ||
      (kind == ADAMW && (v == nullptr || bc == nullptr)))
    return cudaErrorInvalidValue;
  const Hparams hp{lr, beta, b1, omb1, b2, omb2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gb = static_cast<float*>(gbar);
  float* wp = static_cast<float*>(w);
  float* mp = static_cast<float*>(m);
  float* vp = static_cast<float*>(v);
  const float* cmp = static_cast<const float*>(cm);
  const uint8_t* smp = static_cast<const uint8_t*>(sm);
  const float* bcp = static_cast<const float*>(bc);
  const int64_t p = static_cast<int64_t>(P);
  using BF = __nv_bfloat16;
  if (fresh_dtype == repro::DTYPE_F32 && buf_dtype == repro::DTYPE_F32)
    return launch<float, float>(kind, fresh, gw, infl, gb, wp, mp, vp, cmp, smp, bcp, n, p, hp, s);
  if (fresh_dtype == repro::DTYPE_F32 && buf_dtype == repro::DTYPE_BF16)
    return launch<float, BF>(kind, fresh, gw, infl, gb, wp, mp, vp, cmp, smp, bcp, n, p, hp, s);
  if (fresh_dtype == repro::DTYPE_BF16 && buf_dtype == repro::DTYPE_F32)
    return launch<BF, float>(kind, fresh, gw, infl, gb, wp, mp, vp, cmp, smp, bcp, n, p, hp, s);
  if (fresh_dtype == repro::DTYPE_BF16 && buf_dtype == repro::DTYPE_BF16)
    return launch<BF, BF>(kind, fresh, gw, infl, gb, wp, mp, vp, cmp, smp, bcp, n, p, hp, s);
  return cudaErrorInvalidValue;
}
