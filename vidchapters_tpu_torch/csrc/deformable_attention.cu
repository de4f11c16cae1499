// 1-D multi-scale deformable attention (PDVC's encoder self-attention and
// decoder cross-attention), forward and backward, float32.
//
// Replaces: vidchapters_tpu/ops/deformable_attention.py::_pallas_level (the
// pl.pallas_call at line 217) under deformable_attention_1d_pallas, and that
// function's custom VJP (_bwd, lines 266-277: the VJP of the dense-lerp
// form). Each layer of PDVC's encoder and decoder launches the forward once
// per forward pass and the backward once per train step.
//
// value [N, S, M, D] with S = the sum of the level lengths T_l (levels laid
// end to end from level_start[l]); loc, attn [N, Lq, M, L, P]; out
// [N, Lq, M, D]. For each (n, q, m) and each level l and point p, the sample
// position is px = loc * T_l - 0.5 (two roundings: a fused multiply-add would
// round once and, for a location at a pixel centre, floor(px) could pick the
// neighbouring pixel), x0 = floor(px), w1 = px - x0, w0 = 1 - w1, and both
// taps clamp to [0, T_l - 1] (edge clamping, as the JAX function and
// grid_sample(padding_mode="border") do; PDVC's own CUDA op pads with zeros
// instead). out = sum over (l, p) of attn * (w0 * v[x0] + w1 * v[x1]).
//
// Backward, from the output gradient g [N, Lq, M, D], per sample, with
// s0 = <g, v[x0]> and s1 = <g, v[x1]> over the D channels:
//   dattn = w0 * s0 + w1 * s1
//   dloc  = T_l * (attn * s1 - attn * s0)   (the gradient reaches loc only
//           through w1; where both taps clamp to one pixel, s1 = s0 and it is 0)
//   dv[x0] += attn * w0 * g,  dv[x1] += attn * w1 * g   (fp32 atomicAdd into a
//           zeroed dv: sums in an order that changes from run to run)
//
// What bounds it on the H100: a gather of 2 * L * P rows of D floats per
// (n, q, m) and a few operations per element, far below the arithmetic rate;
// the bytes it must move (value, loc, attn read once, out written once) are
// under 1 MB at PDVC's shapes (0.3 us at 3.35 TB/s), so one launch is bound
// by its latency, not by either rate.
//
// Design (the TPU kernel's band matrix times value on the MXU is not carried
// over): one warp per (n, q, m), lanes over the D channels (lane c holds
// channels c, c + 32, ...), a loop over the L * P samples. Each sample reads
// two contiguous rows of D floats of value, coalesced across the warp; loc
// and attn are read by all lanes at one address (a broadcast). The backward
// keeps the warp's g in registers and reduces s0 and s1 across the warp with
// shuffles; lane 0 writes dloc and dattn.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;       // warps per block
constexpr int MAX_LEVELS = 16;
constexpr int MAX_CPL = 4;     // channels per lane: D <= 128

struct Levels {
  int n;
  int t[MAX_LEVELS];
  int start[MAX_LEVELS];
};

struct Tap {
  int x0, x1;
  float w0, w1;
};

__device__ __forceinline__ Tap lerp_taps(float loc, int t) {
  const float px = __fadd_rn(__fmul_rn(loc, (float)t), -0.5f);
  const float x0f = floorf(px);
  Tap tap;
  tap.w1 = __fsub_rn(px, x0f);
  tap.w0 = __fsub_rn(1.f, tap.w1);
  // clamp before the conversion so that a far-off location cannot overflow
  // the int; after the clip to [0, t - 1] the taps are the same
  const int i0 = (int)fminf(fmaxf(x0f, -1.f), (float)t);
  tap.x0 = min(max(i0, 0), t - 1);
  tap.x1 = min(max(i0 + 1, 0), t - 1);
  return tap;
}

__global__ void __launch_bounds__(WARPS * 32)
deform_fwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                  const float* __restrict__ attn, float* __restrict__ out, int N, int S,
                  int Lq, int M, int D, int P, Levels lv) {
  const int lane = threadIdx.x & 31;
  const long w = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);  // (n, q, m)
  if (w >= (long)N * Lq * M) return;
  const int m = (int)(w % M);
  const int n = (int)(w / ((long)Lq * M));
  const long samp0 = w * lv.n * P;
  const float* vbase = value + ((long)n * S * M + m) * D;  // row r at vbase + r * M * D
  const long row = (long)M * D;
  float acc[MAX_CPL];
#pragma unroll
  for (int k = 0; k < MAX_CPL; ++k) acc[k] = 0.f;
  for (int l = 0; l < lv.n; ++l) {
    const int t = lv.t[l];
    const float* vl = vbase + (long)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const long si = samp0 + (long)l * P + p;
      const Tap tap = lerp_taps(loc[si], t);
      const float a = attn[si];
      const float aw0 = a * tap.w0, aw1 = a * tap.w1;
      const float* r0 = vl + tap.x0 * row;
      const float* r1 = vl + tap.x1 * row;
#pragma unroll
      for (int k = 0; k < MAX_CPL; ++k) {
        const int c = lane + 32 * k;
        if (c < D) acc[k] += aw0 * r0[c] + aw1 * r1[c];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < MAX_CPL; ++k) {
    const int c = lane + 32 * k;
    if (c < D) out[w * D + c] = acc[k];
  }
}

__global__ void __launch_bounds__(WARPS * 32)
deform_bwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                  const float* __restrict__ attn, const float* __restrict__ gout,
                  float* __restrict__ dvalue, float* __restrict__ dloc,
                  float* __restrict__ dattn, int N, int S, int Lq, int M, int D, int P,
                  Levels lv) {
  const int lane = threadIdx.x & 31;
  const long w = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= (long)N * Lq * M) return;
  const int m = (int)(w % M);
  const int n = (int)(w / ((long)Lq * M));
  const long samp0 = w * lv.n * P;
  const long off = ((long)n * S * M + m) * D;
  const long row = (long)M * D;
  float g[MAX_CPL];
#pragma unroll
  for (int k = 0; k < MAX_CPL; ++k) {
    const int c = lane + 32 * k;
    g[k] = c < D ? gout[w * D + c] : 0.f;
  }
  for (int l = 0; l < lv.n; ++l) {
    const int t = lv.t[l];
    const long lstart = off + (long)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const long si = samp0 + (long)l * P + p;
      const Tap tap = lerp_taps(loc[si], t);
      const float a = attn[si];
      const long o0 = lstart + tap.x0 * row, o1 = lstart + tap.x1 * row;
      const float aw0 = a * tap.w0, aw1 = a * tap.w1;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int k = 0; k < MAX_CPL; ++k) {
        const int c = lane + 32 * k;
        if (c < D) {
          s0 += g[k] * value[o0 + c];
          s1 += g[k] * value[o1 + c];
          atomicAdd(dvalue + o0 + c, aw0 * g[k]);
          atomicAdd(dvalue + o1 + c, aw1 * g[k]);
        }
      }
      s0 = vc::warp_sum(s0);
      s1 = vc::warp_sum(s1);
      if (lane == 0) {
        dattn[si] = tap.w0 * s0 + tap.w1 * s1;
        dloc[si] = (float)t * __fsub_rn(a * s1, a * s0);
      }
    }
  }
}

// Checks the sizes and fills the level table; false when they do not fit.
bool make_levels(Levels& lv, int S, int L, const int* shapes) {
  if (L < 1 || L > MAX_LEVELS || shapes == nullptr) return false;
  lv.n = L;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    if (shapes[l] < 1) return false;
    lv.t[l] = shapes[l];
    lv.start[l] = start;
    start += shapes[l];
  }
  return start == S;
}

bool bad_sizes(int N, int S, int Lq, int M, int D, int P) {
  return N < 1 || S < 1 || Lq < 1 || M < 1 || P < 1 || D < 1 || D > 32 * MAX_CPL;
}

unsigned grid_for(int N, int Lq, int M) {
  return (unsigned)(((long)N * Lq * M + WARPS - 1) / WARPS);
}

}  // namespace

// value [N, S, M, D], loc / attn [N, Lq, M, L, P], out [N, Lq, M, D]: float32,
// contiguous, on the device. shapes: L level lengths on the host, summing to S.
extern "C" int deformable_attention_fwd(const void* value, const void* loc, const void* attn,
                                        void* out, int N, int S, int Lq, int M, int D,
                                        int L, const int* shapes, int P, void* stream) {
  Levels lv;
  if (bad_sizes(N, S, Lq, M, D, P) || !make_levels(lv, S, L, shapes))
    return (int)cudaErrorInvalidValue;
  deform_fwd_kernel<<<grid_for(N, Lq, M), WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<float*>(out), N, S, Lq, M, D, P, lv);
  return (int)cudaGetLastError();
}

// As the forward, plus gout [N, Lq, M, D]; dvalue [N, S, M, D] zeroed by the
// caller; dloc / dattn [N, Lq, M, L, P], every element written.
extern "C" int deformable_attention_bwd(const void* value, const void* loc, const void* attn,
                                        const void* gout, void* dvalue, void* dloc,
                                        void* dattn, int N, int S, int Lq, int M, int D,
                                        int L, const int* shapes, int P, void* stream) {
  Levels lv;
  if (bad_sizes(N, S, Lq, M, D, P) || !make_levels(lv, S, L, shapes))
    return (int)cudaErrorInvalidValue;
  deform_bwd_kernel<<<grid_for(N, Lq, M), WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const float*>(gout),
      static_cast<float*>(dvalue), static_cast<float*>(dloc), static_cast<float*>(dattn), N, S,
      Lq, M, D, P, lv);
  return (int)cudaGetLastError();
}
