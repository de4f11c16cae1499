// One T5 decoder step over all layers in one launch (the decode megakernel).
//
// Replaces: vidchapters_tpu/ops/decode_megakernel.py::mega_decode_step /
// _mega_kernel (the pl.pallas_call at line 519), launched once per decode step.
//
// Per layer, for every row (one row per beam of every example):
//   RMSNorm -> packed q/k/v product -> self-attention over the cache rows
//   < idx plus the current token (rel-pos bias row; bias0 for the current
//   token) -> output projection -> RMSNorm -> cross-attention over the
//   example's encoder K/V under its mask -> output projection -> RMSNorm ->
//   feed-forward (relu, or gated tanh-GELU with wi packed [d, 2*dff]).
// A final RMSNorm ends the step. Every product accumulates in fp32 and is
// rounded to the working type where the TPU kernel rounds it: after each
// weight product, each norm and each residual add, so the residual stream
// holds the working type through the step, as the TPU kernel's does.
//
// Beam search: with src, the previous step's beam permutation is applied
// here. Rows < idx of the caches are copied from row src[r] of the input
// caches into a second pair of buffers (ping-pong: reading and writing one
// buffer in place would race between beams), and row idx of the new
// buffers receives this step's k/v. Rows > idx of the new buffers are not
// written. Without src (greedy), row idx is written in place. The new k/v
// rows are also returned in k_new / v_new, as the TPU kernel returns them.
//
// What bounds it on the H100: at 8 examples x 4 beams, 12 layers, idx ~128
// and bf16, one step must read the decoder weights (~198 MB), the cross K/V
// (~340 MB) and the live self-cache rows, and write the permuted rows
// (~300 MB read + written): ~840 MB, ~0.25 ms at 3.35 TB/s. The arithmetic
// (a few GFLOP) is far below the card's rate, so the step is bound by bytes.
//
// Design: one thread-block cluster of CL = 8 blocks (512 threads each) per
// example. A row never depends on another example's rows, so no grid-wide
// synchronisation is needed and the whole step is one launch; the blocks of
// a cluster meet at the cluster barrier between phases (10 per layer). Each
// weight product is split by output columns across the cluster's blocks and
// by input rows across each block's threads (the partial sums are added in a
// fixed order, so results do not vary from run to run); every weight element
// read serves all beams of the example. Attention is split flash-decoding
// style: warps across the cluster each take one head and a range of keys
// (for cross-attention, all beams of the example at once, sharing each K/V
// row read), lanes take one key each for the scores, and a combine phase
// merges the partial softmax states. The small per-row vectors (residual
// stream, q, attention context, FF hidden, partial states) live in a global
// scratch that stays in L2, read past L1 after each barrier; each block
// stages a product's input rows in its shared memory. Eight examples keep 64
// of the 132 SMs busy, and every example still reads the whole weight set:
// reading each weight once for all examples is the next step.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 512;
constexpr int NWARPS = NT / 32;
constexpr int CL = 8;    // blocks per example (one cluster)
constexpr int GMAX = 8;  // rows per example (beams)
constexpr int DJ = 4;    // head width / 32, at most
constexpr int VW = 4;    // output columns per weight load
constexpr int MAXS = 16; // input-row split of a product within a block
constexpr int PMAX = 16; // key partitions of one (row, head) across warps

template <typename T>
struct Args {
  const T* x;            // [B, d]
  const float* ln;       // [N, 3, d]
  const T* wqkv;         // [N, d, 3 * inner]
  const T* wo_self;      // [N, inner, d]
  const T* wq_cross;     // [N, d, inner]
  const T* wo_cross;     // [N, inner, d]
  const T* wi;           // [N, d, dff] or [N, d, 2 * dff] when gated
  const T* wo_ff;        // [N, dff, d]
  const float* final_ln; // [d]
  const T* k_in;         // [B, N, L, inner]
  const T* v_in;
  T* k_att;              // caches that hold row idx and are attended: the new pair, or k_in / v_in
  T* v_att;
  const T* kx;           // [B0, N, Lenc, inner]
  const T* vx;
  const float* bias_row; // [L, H]: bias of query position idx against each key slot
  const float* bias0;    // [H]: bias of the current token against itself
  const int* enc_mask;   // [B0, Lenc]
  const int* src;        // [B] or null
  T* hidden;             // [B, d]
  T* k_new;              // [B, N, inner]
  T* v_new;
  float* ws;             // scratch: residual [B,d], q and context [B,inner], FF hidden [B,dff],
                         // partial softmax states [B,H,PMAX] x 2 and [B,H,PMAX,dkv]
  int B, N, L, Lenc, d, inner, H, dff, gated, group, idx;
  float eps;
};

// Loads of data that other blocks of the cluster wrote in this launch go past L1
// (ld.global.cg); read-only data takes the read-only path (ld.global.nc).
__device__ __forceinline__ float ld_fresh(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_fresh(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float ld_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_ro(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Four adjacent elements as floats; p aligned to four elements.
__device__ __forceinline__ void load4(const float* p, float* w) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* w) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}

// This block's share [c0, c1) of n output columns (multiples of VW).
__device__ __forceinline__ void slice(int n, int rank, int& c0, int& c1) {
  const int groups = n / VW;
  c0 = groups * rank / CL * VW;
  c1 = groups * (rank + 1) / CL * VW;
}

// out[r][i] = rnd(w[i] * (x[r][i] * rsqrt(mean(x[r]^2) + eps))) for the g rows of
// x (global, read past L1), one warp per row; into shared `out` or global `gout`.
template <typename T>
__device__ void rms_norm(const float* x, const float* w, int g, int d, float eps, float* out,
                         T* gout = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < g; r += NWARPS) {
    float ss = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float v = ld_fresh(x + r * d + i);
      ss += v * v;
    }
    ss = vc::warp_sum(ss);
    const float inv = rsqrtf(ss / (float)d + eps);
    for (int i = lane; i < d; i += 32) {
      const float y = vc::rnd<T>(w[i] * (ld_fresh(x + r * d + i) * inv));
      if (gout) gout[(long)r * d + i] = vc::from_f<T>(y);
      else out[r * d + i] = y;
    }
  }
}

// Stage g rows of width n from global (read past L1) into shared memory.
__device__ void stage(const float* src, int n, int g, float* dst) {
  for (int e = threadIdx.x; e < g * n; e += NT) dst[e] = ld_fresh(src + e);
}

// For r < g and each column o in [c0, c1) of W [n_in, ld]:
//   sink(r, o, rnd(sum_i in[r][i] W[i][o])).
// Work items are (VW-column group, input-row slice); with more than one slice the
// partial sums go through `part` (shared) and are added in slice order.
template <typename T, typename Sink>
__device__ void matvec(const float* in, int n_in, const T* __restrict__ W, int ld, int c0,
                       int c1, int g, float* part, Sink sink) {
  const int width = c1 - c0, nv = width / VW;
  if (nv <= 0) return;
  const int S = max(1, min(min(MAXS, NT / nv), n_in));
  const int klen = (n_in + S - 1) / S;
  for (int item = threadIdx.x; item < nv * S; item += NT) {
    const int cv = item % nv, ks = item / nv;
    const int k0 = ks * klen, k1 = min(n_in, k0 + klen);
    const T* wp = W + c0 + cv * VW;
    float acc[GMAX][VW];
#pragma unroll
    for (int r = 0; r < GMAX; ++r)
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[r][j] = 0.f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      float w[VW];
      load4(wp + (long)k * ld, w);
#pragma unroll
      for (int r = 0; r < GMAX; ++r) {
        if (r < g) {
          const float xv = in[r * n_in + k];
#pragma unroll
          for (int j = 0; j < VW; ++j) acc[r][j] = fmaf(xv, w[j], acc[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < GMAX; ++r) {
      if (r < g) {
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          if (S == 1) sink(r, c0 + cv * VW + j, vc::rnd<T>(acc[r][j]));
          else part[(ks * g + r) * width + cv * VW + j] = acc[r][j];
        }
      }
    }
  }
  if (S > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < g * width; e += NT) {
      const int r = e / width, o = e % width;
      float sum = 0.f;
      for (int ks = 0; ks < S; ++ks) sum += part[(ks * g + r) * width + o];
      sink(r, c0 + o, vc::rnd<T>(sum));
    }
  }
  __syncthreads();  // part and the input rows are free again
}

// Eight adjacent elements as floats; p aligned to eight elements. FRESH data was
// written in this launch by another block: read past L1.
template <bool FRESH>
__device__ __forceinline__ void load8(const float* p, float* w) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = FRESH ? __ldcg(q) : __ldg(q), b = FRESH ? __ldcg(q + 1) : __ldg(q + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w; w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
template <bool FRESH>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* w) {
  const uint4 u = FRESH ? __ldcg(reinterpret_cast<const uint4*>(p))
                        : __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned int parts[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&parts[i]));
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

// One warp, one head, keys [k0, k1), for nr query rows that share the keys: the
// partial softmax state of each row (running max m, sum den, unnormalised context
// acc), written to pm / pd / pa at row stride rs (pa: rs * dkv). Lanes take one key
// each for the scores (a whole K row per lane) and one head-dim column each for
// the context. q: this head's slice of row 0 in shared memory, rows qstride apart.
template <typename T, bool FRESH, typename Fix>
__device__ void warp_attend(const float* q, int qstride, int nr, int dkv, const T* __restrict__ K,
                            const T* __restrict__ V, long stride, int k0, int k1, Fix fix,
                            float* pw, float* pm, float* pd, float* pa, int rs) {
  const int lane = threadIdx.x & 31;
  float m[GMAX], den[GMAX], acc[GMAX][DJ];
#pragma unroll
  for (int r = 0; r < GMAX; ++r) {
    m[r] = -CUDART_INF_F;
    den[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;
  }
  for (int l0 = k0; l0 < k1; l0 += 32) {
    const int l = l0 + lane;
    const bool valid = l < k1;
    float s[GMAX];
#pragma unroll
    for (int r = 0; r < GMAX; ++r) s[r] = 0.f;
    if (valid) {
      const T* kr = K + (long)l * stride;
      for (int d0 = 0; d0 < dkv; d0 += 8) {
        float kv[8];
        load8<FRESH>(kr + d0, kv);
#pragma unroll
        for (int r = 0; r < GMAX; ++r) {
          if (r < nr) {
            const float4 qa = *reinterpret_cast<const float4*>(q + r * qstride + d0);
            const float4 qb = *reinterpret_cast<const float4*>(q + r * qstride + d0 + 4);
            s[r] = fmaf(qa.x, kv[0], s[r]); s[r] = fmaf(qa.y, kv[1], s[r]);
            s[r] = fmaf(qa.z, kv[2], s[r]); s[r] = fmaf(qa.w, kv[3], s[r]);
            s[r] = fmaf(qb.x, kv[4], s[r]); s[r] = fmaf(qb.y, kv[5], s[r]);
            s[r] = fmaf(qb.z, kv[6], s[r]); s[r] = fmaf(qb.w, kv[7], s[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < GMAX; ++r) {
      if (r < nr) {
        const float sr = valid ? fix(l, s[r]) : -CUDART_INF_F;
        const float mn = fmaxf(m[r], vc::warp_max(sr));  // lane 0's key is valid
        const float sc = expf(m[r] - mn);
        const float p = valid ? expf(sr - mn) : 0.f;
        den[r] = den[r] * sc + vc::warp_sum(p);
        m[r] = mn;
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[r][j] *= sc;
        pw[r * 32 + lane] = p;
      }
    }
    __syncwarp();
    const int nt = min(32, k1 - l0);
    for (int t = 0; t < nt; ++t) {
      const T* vr = V + (long)(l0 + t) * stride;
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        vv[j] = lane + 32 * j < dkv ? (FRESH ? ld_fresh(vr + lane + 32 * j) : ld_ro(vr + lane + 32 * j))
                                    : 0.f;
#pragma unroll
      for (int r = 0; r < GMAX; ++r) {
        if (r < nr) {
          const float p = pw[r * 32 + t];
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
        }
      }
    }
    __syncwarp();  // pw is rewritten by the next tile
  }
#pragma unroll
  for (int r = 0; r < GMAX; ++r) {
    if (r < nr) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        if (lane + 32 * j < dkv) pa[(long)r * rs * dkv + lane + 32 * j] = acc[r][j];
      if (lane == 0) {
        pm[r * rs] = m[r];
        pd[r * rs] = den[r];
      }
    }
  }
}

// Context of every (row, head) from its `parts` partial softmax states, spread over
// the cluster: ctx = sum_p e^(m_p - m) acc_p / sum_p e^(m_p - m) den_p, rounded.
template <typename T>
__device__ void combine(const float* pm, const float* pd, const float* pa, int parts, int g,
                        int H, int dkv, int rank, float* ctx) {
  const int inner = H * dkv;
  for (int e = rank * NT + threadIdx.x; e < g * inner; e += CL * NT) {
    const int r = e / inner, c = e % inner, h = c / dkv, dd = c % dkv;
    const int base = (r * H + h) * PMAX;
    float mx = -CUDART_INF_F;
    for (int p = 0; p < parts; ++p) mx = fmaxf(mx, ld_fresh(pm + base + p));
    float num = 0.f, den = 0.f;
    for (int p = 0; p < parts; ++p) {
      const float w = expf(ld_fresh(pm + base + p) - mx);
      den += w * ld_fresh(pd + base + p);
      num += w * ld_fresh(pa + (long)(base + p) * dkv + dd);
    }
    ctx[r * inner + c] = vc::rnd<T>(num / den);
  }
}

// Key partitions per (row group, head) so that `items` of them fill the cluster's warps.
__device__ __forceinline__ int key_parts(int items, int n_keys) {
  const int tiles = (n_keys + 31) / 32;
  return max(1, min(min(PMAX, tiles), CL * NWARPS / items));
}

// Keys [k0, k1) of partition p of n_keys (whole 32-key tiles).
__device__ __forceinline__ void key_range(int p, int parts, int n_keys, int& k0, int& k1) {
  const int tiles = (n_keys + 31) / 32;
  k0 = 32 * (tiles * p / parts);
  k1 = min(n_keys, 32 * (tiles * (p + 1) / parts));
}

template <typename T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT)
    mega_decode_kernel(Args<T> a) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = a.group, d = a.d, inner = a.inner, H = a.H, dkv = inner / H, dff = a.dff;
  const int idx = a.idx, L = a.L, N = a.N;
  const int ex = blockIdx.x / CL, rank = blockIdx.x % CL, row0 = ex * g;
  const int warp = threadIdx.x >> 5;
  const int wmax = max(max(d, inner), dff);
  float* vin = smem;                       // [g][wmax] a product's input rows, or q
  float* part = vin + g * wmax;            // split-K partial sums
  float* pw = part + NT * VW * g + warp * 32 * GMAX;  // this warp's attention weights
  float* xg = a.ws + (long)row0 * d;                                 // [g][d] residual
  float* qg = a.ws + (long)a.B * d + (long)row0 * inner;             // [g][inner] q
  float* cxg = a.ws + (long)a.B * (d + inner) + (long)row0 * inner;  // [g][inner] context
  float* fg = a.ws + (long)a.B * (d + 2 * inner) + (long)row0 * dff; // [g][dff] FF hidden
  // partial softmax states [g][H][PMAX] (m, den) and [g][H][PMAX][dkv] (acc)
  float* pm = a.ws + (long)a.B * (d + 2 * inner + dff) + (long)row0 * H * PMAX;
  float* pd = pm + (long)a.B * H * PMAX;
  float* pa = a.ws + (long)a.B * (d + 2 * inner + dff + 2 * H * PMAX) + (long)row0 * H * PMAX * dkv;
  int c0, c1;

  slice(d, rank, c0, c1);
  for (int e = threadIdx.x; e < g * (c1 - c0); e += NT) {
    const int r = e / (c1 - c0), o = c0 + e % (c1 - c0);
    xg[r * d + o] = vc::to_f(a.x[(long)(row0 + r) * d + o]);
  }
  cluster.sync();

  // the residual add, rounded through T as the TPU kernel's x + mm(...) rounds
  auto add_to_x = [&](int r, int o, float val) {
    xg[r * d + o] = vc::rnd<T>(ld_fresh(xg + r * d + o) + val);
  };

  for (int layer = 0; layer < N; ++layer) {
    const float* ln = a.ln + (long)layer * 3 * d;
    // ---- deferred beam permutation: rows < idx of the new caches ----
    if (a.src != nullptr && idx > 0) {
      const int vecs = inner * (int)sizeof(T) / 16;  // uint4 per cache row
      const long total = (long)g * idx * vecs;
      for (long e = (long)rank * NT + threadIdx.x; e < total; e += (long)CL * NT) {
        const int r = (int)(e / ((long)idx * vecs));
        const int rem = (int)(e % ((long)idx * vecs));
        const int l = rem / vecs, c = rem % vecs;
        const long dst = (((long)(row0 + r) * N + layer) * L + l) * inner;
        const long srcoff = (((long)a.src[row0 + r] * N + layer) * L + l) * inner;
        reinterpret_cast<uint4*>(a.k_att + dst)[c] = reinterpret_cast<const uint4*>(a.k_in + srcoff)[c];
        reinterpret_cast<uint4*>(a.v_att + dst)[c] = reinterpret_cast<const uint4*>(a.v_in + srcoff)[c];
      }
    }
    // ---- self-attention ----
    rms_norm<T>(xg, ln, g, d, a.eps, vin);
    __syncthreads();
    slice(3 * inner, rank, c0, c1);
    matvec<T>(vin, d, a.wqkv + (long)layer * d * 3 * inner, 3 * inner, c0, c1, g, part,
              [&](int r, int o, float val) {
                if (o < inner) {
                  qg[r * inner + o] = val;
                  return;
                }
                const bool is_k = o < 2 * inner;
                const int c = is_k ? o - inner : o - 2 * inner;
                const long row = row0 + r;
                const T tv = vc::from_f<T>(val);
                (is_k ? a.k_att : a.v_att)[((row * N + layer) * L + idx) * inner + c] = tv;
                (is_k ? a.k_new : a.v_new)[(row * N + layer) * inner + c] = tv;
              });
    cluster.sync();
    stage(qg, inner, g, vin);
    __syncthreads();
    {
      const int parts = key_parts(g * H, idx + 1);
      for (int it = rank * NWARPS + warp; it < g * H * parts; it += CL * NWARPS) {
        const int r = it / (H * parts), h = (it / parts) % H, p = it % parts;
        const long base = (((long)(row0 + r) * N + layer) * L) * inner + h * dkv;
        const float* br = a.bias_row;
        const float b0 = a.bias0[h];
        const int slot = (r * H + h) * PMAX + p;
        int k0, k1;
        key_range(p, parts, idx + 1, k0, k1);
        warp_attend<T, true>(vin + r * inner + h * dkv, inner, 1, dkv, a.k_att + base,
                             a.v_att + base, inner, k0, k1,
                             [&](int l, float s) { return s + (l == idx ? b0 : br[l * H + h]); },
                             pw, pm + slot, pd + slot, pa + (long)slot * dkv, H * PMAX);
      }
      cluster.sync();
      combine<T>(pm, pd, pa, parts, g, H, dkv, rank, cxg);
    }
    cluster.sync();
    stage(cxg, inner, g, vin);
    __syncthreads();
    slice(d, rank, c0, c1);
    matvec<T>(vin, inner, a.wo_self + (long)layer * inner * d, d, c0, c1, g, part, add_to_x);
    cluster.sync();
    // ---- cross-attention (the example's K/V, shared by its beams) ----
    rms_norm<T>(xg, ln + d, g, d, a.eps, vin);
    __syncthreads();
    slice(inner, rank, c0, c1);
    matvec<T>(vin, d, a.wq_cross + (long)layer * d * inner, inner, c0, c1, g, part,
              [&](int r, int o, float val) { qg[r * inner + o] = val; });
    cluster.sync();
    stage(qg, inner, g, vin);
    __syncthreads();
    {
      const int parts = key_parts(H, a.Lenc);
      for (int it = rank * NWARPS + warp; it < H * parts; it += CL * NWARPS) {
        const int h = it / parts, p = it % parts;
        const long base = (((long)ex * N + layer) * a.Lenc) * inner + h * dkv;
        const int* mask = a.enc_mask + (long)ex * a.Lenc;
        const int slot = h * PMAX + p;
        int k0, k1;
        key_range(p, parts, a.Lenc, k0, k1);
        warp_attend<T, false>(vin + h * dkv, inner, g, dkv, a.kx + base, a.vx + base, inner, k0,
                              k1, [&](int l, float s) { return mask[l] > 0 ? s : -1e9f; }, pw,
                              pm + slot, pd + slot, pa + (long)slot * dkv, H * PMAX);
      }
      cluster.sync();
      combine<T>(pm, pd, pa, parts, g, H, dkv, rank, cxg);
    }
    cluster.sync();
    stage(cxg, inner, g, vin);
    __syncthreads();
    slice(d, rank, c0, c1);
    matvec<T>(vin, inner, a.wo_cross + (long)layer * inner * d, d, c0, c1, g, part, add_to_x);
    cluster.sync();
    // ---- feed-forward ----
    rms_norm<T>(xg, ln + 2 * d, g, d, a.eps, vin);
    __syncthreads();
    slice(dff, rank, c0, c1);
    if (a.gated) {
      // gate half into fg, then the linear half: fg = rnd(gelu_tanh(gate) * linear)
      const T* wi = a.wi + (long)layer * d * 2 * dff;
      matvec<T>(vin, d, wi, 2 * dff, c0, c1, g, part,
                [&](int r, int o, float val) { fg[r * dff + o] = val; });
      matvec<T>(vin, d, wi + dff, 2 * dff, c0, c1, g, part, [&](int r, int o, float val) {
        const float x = ld_fresh(fg + r * dff + o);
        const float act = 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
        fg[r * dff + o] = vc::rnd<T>(act * val);
      });
    } else {
      matvec<T>(vin, d, a.wi + (long)layer * d * dff, dff, c0, c1, g, part,
                [&](int r, int o, float val) { fg[r * dff + o] = fmaxf(val, 0.f); });
    }
    cluster.sync();
    stage(fg, dff, g, vin);
    __syncthreads();
    slice(d, rank, c0, c1);
    matvec<T>(vin, dff, a.wo_ff + (long)layer * dff * d, d, c0, c1, g, part, add_to_x);
    cluster.sync();
  }
  if (rank == 0) rms_norm<T>(xg, a.final_ln, g, d, a.eps, nullptr, a.hidden + (long)row0 * d);
}

template <typename T>
int launch(const Args<T>& a, int B, cudaStream_t stream) {
  const int wmax = a.d > a.inner ? (a.d > a.dff ? a.d : a.dff) : (a.inner > a.dff ? a.inner : a.dff);
  const size_t smem =
      sizeof(float) * (size_t)(a.group * wmax + NT * VW * a.group + NWARPS * 32 * GMAX);
  cudaError_t err = cudaFuncSetAttribute(mega_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mega_decode_kernel<T><<<(B / a.group) * CL, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int fill_and_launch(const void* x, const void* ln, const void* wqkv, const void* wo_self,
                    const void* wq_cross, const void* wo_cross, const void* wi,
                    const void* wo_ff, const void* final_ln, const void* k_in, const void* v_in,
                    void* k_att, void* v_att, const void* kx, const void* vx,
                    const void* bias_row, const void* bias0, const void* enc_mask,
                    const void* src, void* hidden, void* k_new, void* v_new, void* ws, int B,
                    int N, int L, int Lenc, int d, int inner, int H, int dff, int gated,
                    int group, int idx, float eps, cudaStream_t stream) {
  Args<T> a;
  a.x = static_cast<const T*>(x);
  a.ln = static_cast<const float*>(ln);
  a.wqkv = static_cast<const T*>(wqkv);
  a.wo_self = static_cast<const T*>(wo_self);
  a.wq_cross = static_cast<const T*>(wq_cross);
  a.wo_cross = static_cast<const T*>(wo_cross);
  a.wi = static_cast<const T*>(wi);
  a.wo_ff = static_cast<const T*>(wo_ff);
  a.final_ln = static_cast<const float*>(final_ln);
  a.k_in = static_cast<const T*>(k_in);
  a.v_in = static_cast<const T*>(v_in);
  a.k_att = static_cast<T*>(k_att);
  a.v_att = static_cast<T*>(v_att);
  a.kx = static_cast<const T*>(kx);
  a.vx = static_cast<const T*>(vx);
  a.bias_row = static_cast<const float*>(bias_row);
  a.bias0 = static_cast<const float*>(bias0);
  a.enc_mask = static_cast<const int*>(enc_mask);
  a.src = static_cast<const int*>(src);
  a.hidden = static_cast<T*>(hidden);
  a.k_new = static_cast<T*>(k_new);
  a.v_new = static_cast<T*>(v_new);
  a.ws = static_cast<float*>(ws);
  a.B = B;
  a.N = N;
  a.L = L;
  a.Lenc = Lenc;
  a.d = d;
  a.inner = inner;
  a.H = H;
  a.dff = dff;
  a.gated = gated;
  a.group = group;
  a.idx = idx;
  a.eps = eps;
  return launch<T>(a, B, stream);
}

}  // namespace

// Shapes as in Args; all contiguous; d, inner and dff multiples of 4. With src == null,
// k_att / v_att must be k_in / v_in.
extern "C" int mega_decode_step(
    const void* x, const void* ln, const void* wqkv, const void* wo_self, const void* wq_cross,
    const void* wo_cross, const void* wi, const void* wo_ff, const void* final_ln,
    const void* k_in, const void* v_in, void* k_att, void* v_att, const void* kx,
    const void* vx, const void* bias_row, const void* bias0, const void* enc_mask,
    const void* src, void* hidden, void* k_new, void* v_new, void* ws, int B, int N, int L,
    int Lenc, int d, int inner, int H, int dff, int gated, int group, int idx, float eps,
    int dtype, void* stream) {
  const int esize = dtype == VC_DTYPE_F32 ? 4 : 2;
  if (group < 1 || group > GMAX || B % group != 0 || H < 1 || inner % H != 0 ||
      (inner / H) % 32 != 0 || inner / H > 32 * DJ || d % VW != 0 || inner % VW != 0 ||
      dff % VW != 0 ||
      (inner * esize) % 16 != 0 || idx < 0 || idx >= L || Lenc < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VC_DTYPE_F32)
    return fill_and_launch<float>(x, ln, wqkv, wo_self, wq_cross, wo_cross, wi, wo_ff, final_ln,
                                  k_in, v_in, k_att, v_att, kx, vx, bias_row, bias0, enc_mask,
                                  src, hidden, k_new, v_new, ws, B, N, L, Lenc, d, inner, H, dff,
                                  gated, group, idx, eps, s);
  if (dtype == VC_DTYPE_BF16)
    return fill_and_launch<__nv_bfloat16>(x, ln, wqkv, wo_self, wq_cross, wo_cross, wi, wo_ff,
                                          final_ln, k_in, v_in, k_att, v_att, kx, vx, bias_row,
                                          bias0, enc_mask, src, hidden, k_new, v_new, ws, B, N,
                                          L, Lenc, d, inner, H, dff, gated, group, idx, eps, s);
  return (int)cudaErrorInvalidValue;
}
