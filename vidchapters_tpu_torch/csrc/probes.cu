// Feature probes: seven small kernels, each computing the output of one of
// the TPU feature probes on this card's build, so that a run shows the
// compiler and the card take the same shapes of work the decode kernels use.
//
// Replaces: ops_probe_tpu.py::p1 ... p7 (the pl.pallas_call at lines 40, 58,
// 74, 94, 111, 126 and 143), one-shot probes of Mosaic lowerings.
//
//   probe_split_merge   p1: x [R, C] viewed [R, C/64, 64], doubled, merged back
//   probe_dot_2batch    p2: q [A, B, 1, D] . c [A, B, M, D] over D -> [A, B, 1, M],
//                           a lane group per row of c, 16-byte loads issued
//                           together, partial dots summed by shuffles
//   probe_dot_1batch    p3: a [A, R, D] . b [A, D, M] -> [A, R, M]
//   probe_scratch       p4: a sequential (I x NB) grid walked by one block, whose
//                           shared scratch [NB][E] indexed by the cell's b
//                           persists across cells: xs[b] = x[b] at i = 0, then
//                           xs[b] += 1 and out[b] = xs[b] in every cell
//   probe_block_sum     p5: c [G, R, P, Q, S] bf16; out [R] = sum over P and Q
//                           of c[G-1][r][p][q][0] (the last cell's block wins)
//   probe_lane_slice    p6: out [R, 64] = x[:, 64:128]
//   probe_grid_cells    p7: a (12 x 8) grid of cells, each one [8, 768] .
//                           [768, 768] float32 product with the weight of its
//                           row of cells (timed per cell); the 8 cells of a
//                           row share their weight, so a block takes 64 rows
//                           (all 8 cells) x 32 columns of one weight, and
//                           every weight element is read once
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

// p2: a row of c is G lanes of 4 floats (16-byte loads, 16 lanes at D 64),
// a group of GP lanes, a power of two; each lane holds its 4 elements of q
// in registers, and a group's partial dots are summed by shuffles. A warp
// takes P2_U loads of 32 / GP rows, all issued before any is used, so a
// block of P2_WARPS warps covers 32 rows of one (a, b) at D 64, and the
// whole of c (786 KB at the probe's shape) is in flight at once.
constexpr int P2_WARPS = 4;
constexpr int P2_U = 4;

__global__ void __launch_bounds__(P2_WARPS * 32) dot_2batch(const float* __restrict__ q,
                                                             const float* __restrict__ c,
                                                             float* __restrict__ out, int M,
                                                             int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = D / 4;
  int GP = 1;
  while (GP < G) GP <<= 1;
  const int per_load = 32 / GP, slot = lane / GP, col = lane % GP;
  const bool on = col < G;
  const int rows = P2_WARPS * P2_U * per_load, tiles = (M + rows - 1) / rows;
  const int ab = blockIdx.x / tiles;
  const int m0 = (blockIdx.x % tiles) * rows + warp * P2_U * per_load + slot;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 qv = on ? *reinterpret_cast<const float4*>(q + (long)ab * D + col * 4) : zero;
  float4 cv[P2_U];
#pragma unroll
  for (int u = 0; u < P2_U; ++u) {
    const int m = m0 + u * per_load;
    cv[u] = on && m < M ? *reinterpret_cast<const float4*>(c + ((long)ab * M + m) * D + col * 4)
                        : zero;
  }
#pragma unroll
  for (int u = 0; u < P2_U; ++u) {
    float s = qv.x * cv[u].x;
    s = fmaf(qv.y, cv[u].y, s);
    s = fmaf(qv.z, cv[u].z, s);
    s = fmaf(qv.w, cv[u].w, s);
    for (int o = GP >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const int m = m0 + u * per_load;
    if (col == 0 && m < M) out[(long)ab * M + m] = s;
  }
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

// p7: cells (i, b) of weight i are rows [i R, (i + 1) R) of x viewed [NI R,
// D], R = 8 NB: out = x_i [R, D] . w[i] [D, D] in float32 on the CUDA cores.
// A block takes a G7R x G7C tile of one weight's output (grid: column tiles,
// row tiles, weights) and walks k in chunks of G7K: x's rows staged k-major
// (so a thread reads its 4 rows as one float4) and w's columns row-major in
// shared memory, zeros past the ends; the next chunk's loads are issued into
// registers before the current chunk's products. A thread holds a 4 x 4
// register tile and adds its products in k order with fmaf. VEC: D a
// multiple of 4, every load 16 bytes.
constexpr int G7R = 32, G7C = 32, G7K = 32, G7T = 64;
constexpr int G7XL = G7R * G7K / 4 / G7T;  // 16-byte loads of x a thread makes a chunk
constexpr int G7WL = G7K * G7C / 4 / G7T;  // and of w

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int col, int D) {
  if (VEC) return col < D ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(col < D ? __ldg(p) : 0.f, col + 1 < D ? __ldg(p + 1) : 0.f,
                     col + 2 < D ? __ldg(p + 2) : 0.f, col + 3 < D ? __ldg(p + 3) : 0.f);
}

template <bool VEC>
__global__ void __launch_bounds__(G7T) grid_cells(const float* x, const float* w, float* out,
                                                  int R, int D) {
  __shared__ __align__(16) float xs[G7K][G7R + 4];  // [k][row]; 4 floats of padding
  __shared__ __align__(16) float ws[G7K][G7C];      // [k][column]
  const int c0 = blockIdx.x * G7C, r0 = blockIdx.y * G7R, i = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / (G7C / 4), tx = tid % (G7C / 4);
  const float* xi = x + (long)i * R * D;
  const float* wi = w + (long)i * D * D;
  float4 xr[G7XL], wr[G7WL];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int l = 0; l < G7XL; ++l) {
      const int e = tid + l * G7T, r = e / (G7K / 4), k = k0 + 4 * (e % (G7K / 4));
      xr[l] = r0 + r < R ? load4<VEC>(xi + (long)(r0 + r) * D + k, k, D)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int l = 0; l < G7WL; ++l) {
      const int e = tid + l * G7T, k = k0 + e / (G7C / 4), c = c0 + 4 * (e % (G7C / 4));
      wr[l] = k < D ? load4<VEC>(wi + (long)k * D + c, c, D) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  float acc[4][4] = {};
  fetch(0);
  for (int k0 = 0; k0 < D; k0 += G7K) {
#pragma unroll
    for (int l = 0; l < G7XL; ++l) {
      const int e = tid + l * G7T, r = e / (G7K / 4), k = 4 * (e % (G7K / 4));
      xs[k][r] = xr[l].x;
      xs[k + 1][r] = xr[l].y;
      xs[k + 2][r] = xr[l].z;
      xs[k + 3][r] = xr[l].w;
    }
#pragma unroll
    for (int l = 0; l < G7WL; ++l) {
      const int e = tid + l * G7T;
      *reinterpret_cast<float4*>(&ws[e / (G7C / 4)][4 * (e % (G7C / 4))]) = wr[l];
    }
    __syncthreads();
    if (k0 + G7K < D) fetch(k0 + G7K);
#pragma unroll 8
    for (int k = 0; k < G7K; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = r0 + ty * 4 + p, c = c0 + tx * 4;
    if (r >= R) continue;
    float* o = out + ((long)i * R + r) * D + c;
    if (VEC && c < D) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c + q < D) o[q] = acc[p][q];
    }
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

// q [A, B, 1, D], c [A, B, M, D] float32, 16-byte aligned; D a multiple of 4, at
// most 128.
extern "C" int probe_dot_2batch(const void* q, const void* c, void* out, int A, int B, int M,
                                int D, void* stream) {
  if (A <= 0 || B <= 0 || M <= 0 || D < 4 || D > 128 || D % 4) return (int)cudaErrorInvalidValue;
  int GP = 1;
  while (GP < D / 4) GP <<= 1;
  const int rows = P2_WARPS * P2_U * (32 / GP);
  dot_2batch<<<A * B * ((M + rows - 1) / rows), P2_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)c, (float*)out, M, D);
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
  const int R = 8 * NB;
  const dim3 grid(blocks(D, G7C), blocks(R, G7R), NI);
  if (D % 4 == 0)
    grid_cells<true><<<grid, G7T, 0, (cudaStream_t)stream>>>((const float*)x, (const float*)w,
                                                           (float*)out, R, D);
  else
    grid_cells<false><<<grid, G7T, 0, (cudaStream_t)stream>>>((const float*)x, (const float*)w,
                                                            (float*)out, R, D);
  return (int)cudaGetLastError();
}
