// Feature probes: seven small kernels, each computing the output of one of
// the TPU feature probes on this card's build, so that a run shows the
// compiler and the card take the same shapes of work the decode kernels use.
//
// Replaces: ops_probe_tpu.py::p1 ... p7 (the pl.pallas_call at lines 40, 58,
// 74, 94, 111, 126 and 143), one-shot probes of Mosaic lowerings.
//
//   probe_split_merge   p1: x [R, C] viewed [R, C/64, 64], doubled, merged back
//   probe_dot_2batch    p2: q [A, B, 1, D] . c [A, B, M, D] over D -> [A, B, 1, M]
//   probe_dot_1batch    p3: a [A, R, D] . b [A, D, M] -> [A, R, M]
//   probe_scratch       p4: a sequential (I x NB) grid walked by one block, whose
//                           shared scratch [NB][E] indexed by the cell's b
//                           persists across cells: xs[b] = x[b] at i = 0, then
//                           xs[b] += 1 and out[b] = xs[b] in every cell
//   probe_block_sum     p5: c [G, R, P, Q, S] bf16; out [R] = sum over P and Q
//                           of c[G-1][r][p][q][0] (the last cell's block wins)
//   probe_lane_slice    p6: out [R, 64] = x[:, 64:128]
//   probe_grid_cells    p7: one block per cell of a (12 x 8) grid, each one
//                           [8, 768] . [768, 768] float32 product with the
//                           weight of its row of cells (timed per cell)
//
// Every probe is bound by launch latency at these shapes (a few KB to a few
// MB); what each checks is that the build and the launch work and that the
// result is the known one.

#include "common.cuh"

namespace {

__global__ void split_merge(const float* x, float* out, int R, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * C) return;
  const int r = i / C, h = (i % C) / 64, dd = i % 64;  // [R, C/64, 64] coordinates
  out[(long)r * C + h * 64 + dd] = 2.f * x[(long)r * C + h * 64 + dd];
}

__global__ void dot_2batch(const float* q, const float* c, float* out, int A, int B, int M,
                           int D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A * B * M) return;
  const int ab = i / M, m = i % M;
  float s = 0.f;
  for (int dd = 0; dd < D; ++dd) s = fmaf(q[(long)ab * D + dd], c[((long)ab * M + m) * D + dd], s);
  out[i] = s;
}

__global__ void dot_1batch(const float* a, const float* b, float* out, int A, int R, int M,
                           int D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A * R * M) return;
  const int ai = i / (R * M), r = (i / M) % R, m = i % M;
  float s = 0.f;
  for (int dd = 0; dd < D; ++dd)
    s = fmaf(a[((long)ai * R + r) * D + dd], b[((long)ai * D + dd) * M + m], s);
  out[i] = s;
}

__global__ void scratch(const float* x, float* out, int I, int NB, int E) {
  extern __shared__ float xs[];  // [NB][E]
  for (int i = 0; i < I; ++i) {
    for (int b = 0; b < NB; ++b) {
      for (int e = threadIdx.x; e < E; e += blockDim.x) {
        if (i == 0) xs[b * E + e] = x[(long)b * E + e];
        xs[b * E + e] += 1.f;
        out[(long)b * E + e] = xs[b * E + e];
      }
      __syncthreads();
    }
  }
}

__global__ void block_sum(const __nv_bfloat16* c, float* out, int G, int R, int P, int Q, int S) {
  const int r = blockIdx.x;
  const __nv_bfloat16* cr = c + ((long)(G - 1) * R + r) * P * Q * S;
  float s = 0.f;
  for (int e = threadIdx.x; e < P * Q; e += blockDim.x) s += __bfloat162float(cr[(long)e * S]);
  s = vc::warp_sum(s);
  __shared__ float part[32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += part[w];
    out[r] = t;
  }
}

__global__ void lane_slice(const float* x, float* out, int R, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * 64) return;
  out[i] = x[(long)(i / 64) * C + 64 + i % 64];
}

// Cell (i, b): out[i * NB + b] = x[i * NB + b] [8, D] . w[i] [D, D]; threads
// take output columns, the 8 rows are held in registers.
__global__ void grid_cells(const float* x, const float* w, float* out, int NB, int D) {
  const int cell = blockIdx.x, i = cell / NB;
  const float* xc = x + (long)cell * 8 * D;
  const float* wi = w + (long)i * D * D;
  for (int o = threadIdx.x; o < D; o += blockDim.x) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < D; ++k) {
      const float wv = __ldg(wi + (long)k * D + o);
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = fmaf(__ldg(xc + r * D + k), wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) out[((long)cell * 8 + r) * D + o] = acc[r];
  }
}

int blocks(long n, int t) { return (int)((n + t - 1) / t); }

}  // namespace

extern "C" int probe_split_merge(const void* x, void* out, int R, int C, void* stream) {
  if (C % 64) return (int)cudaErrorInvalidValue;
  split_merge<<<blocks((long)R * C, 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, R, C);
  return (int)cudaGetLastError();
}

extern "C" int probe_dot_2batch(const void* q, const void* c, void* out, int A, int B, int M,
                                int D, void* stream) {
  dot_2batch<<<blocks((long)A * B * M, 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)c, (float*)out, A, B, M, D);
  return (int)cudaGetLastError();
}

extern "C" int probe_dot_1batch(const void* a, const void* b, void* out, int A, int R, int M,
                                int D, void* stream) {
  dot_1batch<<<blocks((long)A * R * M, 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, A, R, M, D);
  return (int)cudaGetLastError();
}

extern "C" int probe_scratch(const void* x, void* out, int I, int NB, int E, void* stream) {
  const size_t smem = sizeof(float) * (size_t)NB * E;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  scratch<<<1, 256, smem, (cudaStream_t)stream>>>((const float*)x, (float*)out, I, NB, E);
  return (int)cudaGetLastError();
}

extern "C" int probe_block_sum(const void* c, void* out, int G, int R, int P, int Q, int S,
                               void* stream) {
  block_sum<<<R, 256, 0, (cudaStream_t)stream>>>((const __nv_bfloat16*)c, (float*)out, G, R, P,
                                                 Q, S);
  return (int)cudaGetLastError();
}

extern "C" int probe_lane_slice(const void* x, void* out, int R, int C, void* stream) {
  if (C < 128) return (int)cudaErrorInvalidValue;
  lane_slice<<<blocks((long)R * 64, 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, R, C);
  return (int)cudaGetLastError();
}

extern "C" int probe_grid_cells(const void* x, const void* w, void* out, int NI, int NB, int D,
                                void* stream) {
  grid_cells<<<NI * NB, 256, 0, (cudaStream_t)stream>>>((const float*)x, (const float*)w,
                                                       (float*)out, NB, D);
  return (int)cudaGetLastError();
}
