// One Whisper decoder step over all layers in one launch (the Whisper decode
// megakernel).
//
// Replaces: vidchapters_tpu/ops/whisper_megakernel.py::whisper_mega_step /
// _whisper_kernel (the pl.pallas_call at line 463), launched once per decode
// step of the ASR factory's transcriber.
//
// Per layer, for every row (one per window, or per beam of every window):
//   LayerNorm -> packed q|k|v product (float32 bias; q scaled by d_head^-0.5)
//   -> self-attention over the cache rows < idx plus the current token ->
//   output projection -> LayerNorm -> q product -> cross-attention over the
//   example's encoder K/V (int8 with per-lane scales, or the compute dtype;
//   the `group` beams of an example share it) -> output projection ->
//   LayerNorm -> fc1 -> exact GELU (erff) -> fc2. Every product accumulates
//   in float32, adds its float32 bias and is rounded to the working type T;
//   the residual stream is held in T and rounded after every add, as the TPU
//   kernel holds it. The kernel returns the hidden state before the final
//   LayerNorm and the new k/v rows; the final LayerNorm and the logits stay
//   outside.
//
// Beam search: with src, the previous step's beam permutation is applied
// here. Rows < idx of the caches are copied from row src[r] of the input
// caches into a second pair of buffers (ping-pong), while the self-attention
// reads them anyway, and row idx of the new buffers receives this step's
// k/v. Rows > idx of the new buffers are not written. Without src (greedy),
// row idx is written in place.
//
// What bounds it on the H100: at large-v2 (32 layers, d 1280, d_ff 5120) one
// step must read 1.47 GB of bf16 decoder weights, whatever the batch, plus
// the cross K/V (int8: 123 MB per example) and the live self-cache rows:
// bytes, ~0.73 ms at batch 8 at 3.35 TB/s. The arithmetic (~2 x rows x 0.73
// G multiply-adds) is far below the card's rate.
//
// Design: one persistent grid of one 512-thread block per SM (a cooperative
// launch), and a grid barrier between the phases of a layer (8 per layer).
// Each weight is read once per step for every RMAX (8) rows: the rows go
// through a product in passes of at most 8 (the accumulators one warp holds
// in registers), and each pass streams the whole weight matrix, so B rows
// read the weights ceil(B / 8) times (the beam rung of 2 examples, 10 rows,
// twice; batch 8 at beam 5, 40 rows, five times). A product is split by
// output columns over all the warps of the grid, CPW columns to a warp; the
// weights are stored [out, in], so a warp streams its columns' contiguous
// rows with 16-byte loads while every block holds the product's input rows
// (LayerNorm computed redundantly per block, or a copy of the context / FF
// rows) in its shared memory; lanes' partial sums meet in a shuffle tree.
// No output column has two writers and every sum is taken in a fixed order,
// so results do not vary from run to run. Attention takes one block per
// (row, head) (self) or (example, head) (cross): lanes take one key each for
// the scores, the block reduces max and sum, and warps stage 32-key tiles of
// V in shared memory with 16-byte loads for p.v, merged across warps in
// order.

#include "common.cuh"

namespace {

constexpr int NT = 512;
constexpr int NWARPS = NT / 32;
constexpr int RMAX = 8;   // rows of one product pass
constexpr int GMAX = 8;   // beams per example
constexpr int DJ = 4;     // head width / 32, at most
constexpr int TK = 32;    // keys of one staged V tile
constexpr float NEG = -1e9f;

template <typename T, typename KT>
struct Args {
  const T* x;              // [B, d]
  const float* ln_s;       // [N, 3, d]
  const float* ln_b;       // [N, 3, d]
  const T* w[6];           // wqkv [N,3i,d], wo_self [N,d,i], wq_cross [N,i,d], wo_cross [N,d,i],
                           // wi [N,dff,d], wo_ff [N,d,dff]
  const float* b[6];       // their biases [N, out]
  const T* k_in;           // [B, N, L, inner]
  const T* v_in;
  T* k_att;                // caches that receive rows <= idx: the new pair, or k_in / v_in
  T* v_att;
  const KT* kx;            // [B0, N, Lp, inner]
  const KT* vx;
  const float* kxs;        // [B0, N, inner] or null
  const float* vxs;
  const int* src;          // [B] or null
  T* hidden;               // [B, d]
  T* k_new;                // [B, N, inner]
  T* v_new;
  float* ws;               // residual [B,d], q [B,inner], context [B,inner], FF hidden [B,dff]
  unsigned* bar;           // grid barrier: arrivals, generation (zeroed)
  unsigned long long* timeline;  // [8 N + 2] %globaltimer ns after each barrier, or null
  int B, N, L, Lp, lenc, d, inner, H, dff, group, idx, smem;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(signed char v) { return (float)v; }

// The V elements of one 16-byte vector as floats.
__device__ __forceinline__ void unpack(const uint4& u, float* o, float) {
  o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* o, __nv_bfloat16) {
  const unsigned int parts[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&parts[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float* o, signed char) {
  const unsigned int parts[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[4 * i + j] = (float)(signed char)((parts[i] >> (8 * j)) & 0xFF);
}

template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// A value written in this launch by another block: read past L1.
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Grid-wide barrier of a cooperative launch: every block arrives, the last one
// resets the count and advances the generation the others wait on. Writes
// made before it are visible to loads after it that bypass L1 (__ldcg).
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// With a timeline, thread 0 of block 0 records %globaltimer (ns) in slot i:
// the end of a grid barrier is the end of the phase before it for every block.
__device__ __forceinline__ void mark(unsigned long long* timeline, int i) {
  if (timeline != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    timeline[i] = t;
  }
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = vc::warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = vc::warp_max(lane < NWARPS ? red[lane] : -CUDART_INF_F);
    if (lane == 0) red[NWARPS] = v;
  }
  __syncthreads();
  v = red[NWARPS];
  __syncthreads();
  return v;
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = vc::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = vc::warp_sum(lane < NWARPS ? red[lane] : 0.f);
    if (lane == 0) red[NWARPS] = v;
  }
  __syncthreads();
  v = red[NWARPS];
  __syncthreads();
  return v;
}

// Rows [r0, r0 + rows) of LayerNorm(x) (x: float32 rows in global memory
// written in this launch; scale / bias float32) into shared `out` as T.
template <typename T>
__device__ void stage_ln(const float* x, const float* s, const float* b, int r0, int rows, int d,
                         T* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += NWARPS) {
    const float* xr = x + (long)(r0 + r) * d;
    float sum = 0.f;
    for (int i = lane; i < d; i += 32) sum += __ldcg(xr + i);
    const float mu = vc::warp_sum(sum) / (float)d;
    float ss = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float c = __ldcg(xr + i) - mu;
      ss += c * c;
    }
    const float inv = rsqrtf(vc::warp_sum(ss) / (float)d + 1e-5f);
    for (int i = lane; i < d; i += 32)
      out[r * d + i] = vc::from_f<T>(s[i] * ((__ldcg(xr + i) - mu) * inv) + b[i]);
  }
}

// Rows [r0, r0 + rows) of a float32 activation [B, K] written in this launch
// (values already rounded to T) into shared `out` as T.
template <typename T>
__device__ void stage_rows(const float* src, int r0, int rows, int K, T* out) {
  for (int e = threadIdx.x; e < rows * K; e += NT)
    out[e] = vc::from_f<T>(__ldcg(src + (long)r0 * K + e));
}

// For every row r < rows of `in` (shared, [rows][K] in T) and every output
// column o of W [n_out][K]: sink(r0 + r, o, sum_k in[r][k] W[o][k]). Output
// columns go CPW at a time to the warps of the whole grid; lanes stride K in
// 16-byte vectors and their partial sums meet in a shuffle tree.
template <int CPW, typename T, typename Sink>
__device__ void gemv(const T* in, int rows, int K, const T* __restrict__ W, int n_out, int r0,
                     Sink sink) {
  constexpr int V = Vec<T>::n;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * NWARPS + (threadIdx.x >> 5), nw = gridDim.x * NWARPS;
  const int groups = (n_out + CPW - 1) / CPW;
  for (int cgp = gw; cgp < groups; cgp += nw) {
    const int o0 = cgp * CPW;
    float acc[RMAX][CPW];
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
#pragma unroll
      for (int c = 0; c < CPW; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int k = lane * V; k < K; k += 32 * V) {
      float w[CPW][V];
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        if (o0 + c < n_out) {
          unpack(ld16(W + (long)(o0 + c) * K + k), w[c], T());
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) w[c][e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < rows) {
          float xin[V];
          unpack(*reinterpret_cast<const uint4*>(in + r * K + k), xin, T());
#pragma unroll
          for (int c = 0; c < CPW; ++c)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[r][c] = fmaf(xin[e], w[c][e], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < rows) {
#pragma unroll
        for (int c = 0; c < CPW; ++c) {
          const float v = vc::warp_sum(acc[r][c]);
          if (lane == 0 && o0 + c < n_out) sink(r0 + r, o0 + c, v);
        }
      }
    }
  }
}

// A product over all B rows in passes of at most RMAX rows (as many as the
// shared memory holds): stage(r0, rows, buffer) fills the input rows.
template <int CPW, typename T, typename Stage, typename Sink>
__device__ void run_product(int B, int K, int smem, T* buf, const T* W, int n_out, Stage stage,
                            Sink sink) {
  const int cap = smem / (K * (int)sizeof(T));
  const int per = min(RMAX, min(B, cap));
  for (int r0 = 0; r0 < B; r0 += per) {
    const int rows = min(per, B - r0);
    stage(r0, rows, buf);
    __syncthreads();
    gemv<CPW>(buf, rows, K, W, n_out, r0, sink);
    __syncthreads();
  }
}

// p.v for g query rows sharing keys [0, n) of V (rows `stride` elements apart,
// head slice at V): warps take 32-key tiles, stage them in their shared `tile`
// with 16-byte loads (and copy them to `copy_to` when given), lanes take head
// columns; p [g][ldp] float32 in shared memory. Each warp's sums go to
// red[warp][g][dkv]; the caller adds them in warp order.
template <typename VT>
__device__ void pv_tiles(const float* p, int ldp, int g, int n, int dkv, const VT* V, long stride,
                         VT* copy_to, VT* tiles, float* red) {
  constexpr int VN = Vec<VT>::n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cpr = dkv / VN;  // 16-byte vectors per key row
  VT* tile = tiles + (long)warp * TK * dkv;
  float acc[GMAX][DJ];
#pragma unroll
  for (int j = 0; j < GMAX; ++j)
#pragma unroll
    for (int q = 0; q < DJ; ++q) acc[j][q] = 0.f;
  for (int t0 = warp * TK; t0 < n; t0 += NWARPS * TK) {
    const int nk = min(TK, n - t0);
    for (int ci = lane; ci < nk * cpr; ci += 32) {
      const int kk = ci / cpr, c = ci % cpr;
      const uint4 u = ld16(V + (long)(t0 + kk) * stride + c * VN);
      if (copy_to != nullptr)
        *reinterpret_cast<uint4*>(copy_to + (long)(t0 + kk) * stride + c * VN) = u;
      *reinterpret_cast<uint4*>(tile + kk * dkv + c * VN) = u;
    }
    __syncwarp();
    for (int kk = 0; kk < nk; ++kk) {
#pragma unroll
      for (int q = 0; q < DJ; ++q) {
        const int dd = lane + 32 * q;
        if (dd < dkv) {
          const float v = to_f(tile[kk * dkv + dd]);
#pragma unroll
          for (int j = 0; j < GMAX; ++j)
            if (j < g) acc[j][q] = fmaf(p[j * ldp + t0 + kk], v, acc[j][q]);
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < GMAX; ++j) {
    if (j < g) {
#pragma unroll
      for (int q = 0; q < DJ; ++q) {
        const int dd = lane + 32 * q;
        if (dd < dkv) red[(warp * g + j) * dkv + dd] = acc[j][q];
      }
    }
  }
}

// Scores s[j][l] = sum_d q[j][d] K[l][d] for keys l < n (rows `stride` apart),
// g query rows q [g][dkv] float32 in shared memory; one key per thread, K rows
// read in 16-byte vectors (and copied to `copy_to` when given).
template <typename KT>
__device__ void scores(const float* q, int g, int n, int dkv, const KT* K, long stride,
                       KT* copy_to, float* s, int lds) {
  constexpr int VN = Vec<KT>::n;
  for (int l = threadIdx.x; l < n; l += NT) {
    float acc[GMAX];
#pragma unroll
    for (int j = 0; j < GMAX; ++j) acc[j] = 0.f;
    const KT* kr = K + (long)l * stride;
    for (int c = 0; c < dkv; c += VN) {
      const uint4 u = ld16(kr + c);
      if (copy_to != nullptr) *reinterpret_cast<uint4*>(copy_to + (long)l * stride + c) = u;
      float kv[VN];
      unpack(u, kv, KT());
#pragma unroll
      for (int j = 0; j < GMAX; ++j)
        if (j < g)
#pragma unroll
          for (int e = 0; e < VN; ++e) acc[j] = fmaf(q[j * dkv + c + e], kv[e], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < GMAX; ++j)
      if (j < g) s[j * lds + l] = acc[j];
  }
}


template <typename T, typename KT, bool QUANT>
__global__ void __launch_bounds__(NT, 1) whisper_mega_kernel(Args<T, KT> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, N = a.N, L = a.L, d = a.d, inner = a.inner, H = a.H, dff = a.dff;
  const int dkv = inner / H, idx = a.idx, g = a.group, B0 = B / g;
  const float scale = (float)(1.0 / sqrt((double)dkv));
  float* xs = a.ws;                        // [B, d] residual (values in T)
  float* qs = xs + (long)B * d;            // [B, inner] q, pre-scaled
  float* cx = qs + (long)B * inner;        // [B, inner] attention context
  float* ff = cx + (long)B * inner;        // [B, dff] FF hidden
  T* buf = reinterpret_cast<T*>(smem);

  mark(a.timeline, 0);
  for (long e = (long)blockIdx.x * NT + threadIdx.x; e < (long)B * d; e += (long)gridDim.x * NT)
    xs[e] = vc::to_f(a.x[e]);
  grid_barrier(a.bar);
  mark(a.timeline, 1);
  // the barrier that ends phase p (0..7) of a layer, and its timeline slot
  auto phase_end = [&](int layer, int p) {
    grid_barrier(a.bar);
    mark(a.timeline, 2 + 8 * layer + p);
  };

  auto add_to_x = [&](int r, int o, float acc, const float* bias, bool last) {
    const float y = vc::rnd<T>(__ldcg(xs + (long)r * d + o) + vc::rnd<T>(acc + bias[o]));
    xs[(long)r * d + o] = y;
    if (last) a.hidden[(long)r * d + o] = vc::from_f<T>(y);
  };

  for (int layer = 0; layer < N; ++layer) {
    const bool last = layer == N - 1;
    const float* lns = a.ln_s + (long)layer * 3 * d;
    const float* lnb = a.ln_b + (long)layer * 3 * d;
    const T* W[6];
    const float* Bs[6];
    const long wsz[6] = {3L * inner * d, (long)d * inner, (long)inner * d, (long)d * inner,
                         (long)dff * d, (long)d * dff};
    const long bsz[6] = {3L * inner, d, inner, d, dff, d};
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      W[m] = a.w[m] + layer * wsz[m];
      Bs[m] = a.b[m] + layer * bsz[m];
    }

    // ---- P1: LayerNorm, packed q|k|v ----
    run_product<2>(B, d, a.smem, buf, W[0], 3 * inner,
                   [&](int r0, int rows, T* o) { stage_ln<T>(xs, lns, lnb, r0, rows, d, o); },
                   [&](int r, int o, float acc) {
                     const float v = vc::rnd<T>(acc + Bs[0][o]);
                     if (o < inner) {
                       qs[(long)r * inner + o] = vc::rnd<T>(v * scale);
                       return;
                     }
                     const bool is_k = o < 2 * inner;
                     const int c = o - (is_k ? inner : 2 * inner);
                     const T tv = vc::from_f<T>(v);
                     (is_k ? a.k_att : a.v_att)[(((long)r * N + layer) * L + idx) * inner + c] = tv;
                     (is_k ? a.k_new : a.v_new)[((long)r * N + layer) * inner + c] = tv;
                   });
    phase_end(layer, 0);

    // ---- P2: self-attention, one block per (row, head) ----
    {
      T* tiles = buf;
      float* red2 = reinterpret_cast<float*>(smem + align16((size_t)NWARPS * TK * dkv * sizeof(T)));
      float* sq = red2 + NWARPS * dkv;
      float* ss = sq + dkv;
      float* red = ss + L;
      for (int it = blockIdx.x; it < B * H; it += gridDim.x) {
        const int r = it / H, h = it % H;
        const int sr = a.src != nullptr ? a.src[r] : r;
        const long in_base = ((long)sr * N + layer) * L * inner + h * dkv;
        const long out_base = ((long)r * N + layer) * L * inner + h * dkv;
        const bool copy = a.src != nullptr;
        for (int t = threadIdx.x; t < dkv; t += NT) sq[t] = __ldcg(qs + (long)r * inner + h * dkv + t);
        __syncthreads();
        scores<T>(sq, 1, idx, dkv, a.k_in + in_base, inner, copy ? a.k_att + out_base : nullptr,
                  ss, L);
        __syncthreads();
        float mx = -CUDART_INF_F;
        for (int l = threadIdx.x; l < idx; l += NT) mx = fmaxf(mx, ss[l]);
        const float m = idx > 0 ? block_max(mx, red) : NEG;
        float part = 0.f;
        for (int l = threadIdx.x; l < idx; l += NT) {
          const float e = expf(ss[l] - m);
          part += e;
          ss[l] = vc::rnd<T>(e);  // probabilities in T for p.v
        }
        const float den = block_sum(part, red);
        pv_tiles<T>(ss, L, 1, idx, dkv, a.v_in + in_base, inner, copy ? a.v_att + out_base : nullptr,
                    tiles, red2);
        __syncthreads();
        // the current token (row idx, written in P1): an extra online-softmax row
        const long cur = ((long)r * N + layer) * L * inner + (long)idx * inner + h * dkv;
        if (threadIdx.x < 32) {
          float pr = 0.f;
          for (int t = threadIdx.x; t < dkv; t += 32)
            pr += vc::rnd<T>(sq[t] * ld_cg(a.k_att + cur + t));
          pr = vc::warp_sum(pr);
          if (threadIdx.x == 0) red[NWARPS + 1] = pr;
        }
        __syncthreads();
        const float s_new = red[NWARPS + 1];
        const float m2 = fmaxf(m, s_new), sc = expf(m - m2), e_new = expf(s_new - m2);
        const float denom = den * sc + e_new;
        for (int t = threadIdx.x; t < dkv; t += NT) {
          float acc = 0.f;
          for (int w = 0; w < NWARPS; ++w) acc += red2[w * dkv + t];
          const float vn = ld_cg(a.v_att + cur + t);
          cx[(long)r * inner + h * dkv + t] = vc::rnd<T>((acc * sc + e_new * vn) / denom);
        }
        __syncthreads();
      }
    }
    phase_end(layer, 1);

    // ---- P3: self-attention output projection, residual ----
    run_product<2>(B, inner, a.smem, buf, W[1], d,
                   [&](int r0, int rows, T* o) { stage_rows<T>(cx, r0, rows, inner, o); },
                   [&](int r, int o, float acc) { add_to_x(r, o, acc, Bs[1], false); });
    phase_end(layer, 2);

    // ---- P4: LayerNorm, cross-attention q ----
    run_product<2>(B, d, a.smem, buf, W[2], inner,
                   [&](int r0, int rows, T* o) {
                     stage_ln<T>(xs, lns + d, lnb + d, r0, rows, d, o);
                   },
                   [&](int r, int o, float acc) {
                     qs[(long)r * inner + o] = vc::rnd<T>(vc::rnd<T>(acc + Bs[2][o]) * scale);
                   });
    phase_end(layer, 3);

    // ---- P5: cross-attention, one block per (example, head) ----
    {
      KT* tiles = reinterpret_cast<KT*>(smem);
      float* red2 = reinterpret_cast<float*>(smem + align16((size_t)NWARPS * TK * dkv * sizeof(KT)));
      float* sq = red2 + NWARPS * g * dkv;
      float* ss = sq + g * dkv;
      float* red = ss + (long)g * a.lenc;
      for (int it = blockIdx.x; it < B0 * H; it += gridDim.x) {
        const int e = it / H, h = it % H;
        const long kv_base = ((long)e * N + layer) * a.Lp * inner + h * dkv;
        const long sc_base = ((long)e * N + layer) * inner + h * dkv;
        for (int t = threadIdx.x; t < g * dkv; t += NT) {
          const int j = t / dkv, dd = t % dkv;
          float qv = __ldcg(qs + (long)(e * g + j) * inner + h * dkv + dd);
          // int8 K: the per-lane k-scale folds into q (in T) before the product
          if (QUANT) qv = vc::rnd<T>(qv * vc::rnd<T>(a.kxs[sc_base + dd]));
          sq[t] = qv;
        }
        __syncthreads();
        scores<KT>(sq, g, a.lenc, dkv, a.kx + kv_base, inner, nullptr, ss, a.lenc);
        __syncthreads();
        for (int j = 0; j < g; ++j) {
          float* sj = ss + (long)j * a.lenc;
          float mx = -CUDART_INF_F;
          for (int l = threadIdx.x; l < a.lenc; l += NT) mx = fmaxf(mx, sj[l]);
          mx = block_max(mx, red);
          float part = 0.f;
          for (int l = threadIdx.x; l < a.lenc; l += NT) {
            const float ev = expf(sj[l] - mx);
            sj[l] = ev;
            part += ev;
          }
          const float sum = block_sum(part, red);
          for (int l = threadIdx.x; l < a.lenc; l += NT) sj[l] = vc::rnd<T>(sj[l] / sum);
        }
        __syncthreads();
        pv_tiles<KT>(ss, a.lenc, g, a.lenc, dkv, a.vx + kv_base, inner, nullptr, tiles, red2);
        __syncthreads();
        for (int t = threadIdx.x; t < g * dkv; t += NT) {
          const int j = t / dkv, dd = t % dkv;
          float acc = 0.f;
          for (int w = 0; w < NWARPS; ++w) acc += red2[(w * g + j) * dkv + dd];
          // int8 V: the per-lane v-scale multiplies the context after the product
          if (QUANT) acc *= a.vxs[sc_base + dd];
          cx[(long)(e * g + j) * inner + h * dkv + dd] = vc::rnd<T>(acc);
        }
        __syncthreads();
      }
    }
    phase_end(layer, 4);

    // ---- P6: cross-attention output projection, residual ----
    run_product<2>(B, inner, a.smem, buf, W[3], d,
                   [&](int r0, int rows, T* o) { stage_rows<T>(cx, r0, rows, inner, o); },
                   [&](int r, int o, float acc) { add_to_x(r, o, acc, Bs[3], false); });
    phase_end(layer, 5);

    // ---- P7: LayerNorm, fc1, exact GELU ----
    run_product<4>(B, d, a.smem, buf, W[4], dff,
                   [&](int r0, int rows, T* o) {
                     stage_ln<T>(xs, lns + 2 * d, lnb + 2 * d, r0, rows, d, o);
                   },
                   [&](int r, int o, float acc) {
                     const float v = acc + Bs[4][o];
                     ff[(long)r * dff + o] = vc::rnd<T>(0.5f * v * (1.f + erff(v * 0.7071067811865476f)));
                   });
    phase_end(layer, 6);

    // ---- P8: fc2, residual ----
    run_product<2>(B, dff, a.smem, buf, W[5], d,
                   [&](int r0, int rows, T* o) { stage_rows<T>(ff, r0, rows, dff, o); },
                   [&](int r, int o, float acc) { add_to_x(r, o, acc, Bs[5], last); });
    if (!last || a.timeline != nullptr) phase_end(layer, 7);
  }
}

// Shared memory of the attention phases and of one product row.
template <typename T, typename KT>
void smem_need(int B, int L, int lenc, int d, int inner, int H, int dff, int group,
               size_t& attn, size_t& row) {
  const int dkv = inner / H;
  const size_t self_b = align16((size_t)NWARPS * TK * dkv * sizeof(T)) +
                        sizeof(float) * ((size_t)NWARPS * dkv + dkv + L + NWARPS + 2);
  const size_t cross_b = align16((size_t)NWARPS * TK * dkv * sizeof(KT)) +
                         sizeof(float) * ((size_t)NWARPS * group * dkv + (size_t)group * dkv +
                                          (size_t)group * lenc + NWARPS + 2);
  attn = self_b > cross_b ? self_b : cross_b;
  int kmax = d > inner ? d : inner;
  kmax = kmax > dff ? kmax : dff;
  row = (size_t)kmax * sizeof(T);
  (void)B;
}

}  // namespace

template <typename T, typename KT, bool QUANT>
static int launch(Args<T, KT>& a, cudaStream_t stream) {
  size_t attn, row;
  smem_need<T, KT>(a.B, a.L, a.lenc, a.d, a.inner, a.H, a.dff, a.group, attn, row);
  const size_t limit = 232448;  // the most shared memory a block can use on sm_90
  size_t smem = row * (size_t)(a.B < RMAX ? a.B : RMAX);
  if (smem > limit) smem = limit;
  if (smem < row) smem = row;
  if (smem < attn) smem = attn;
  if (smem > limit) return (int)cudaErrorInvalidValue;
  a.smem = (int)smem;
  auto kernel = whisper_mega_kernel<T, KT, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms);  // one block per SM: every block resident, as the barrier needs
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, typename KT, bool QUANT>
static int fill_and_launch(void* const* p, const int* n, cudaStream_t stream) {
  Args<T, KT> a;
  a.x = static_cast<const T*>(p[0]);
  a.ln_s = static_cast<const float*>(p[1]);
  a.ln_b = static_cast<const float*>(p[2]);
  for (int m = 0; m < 6; ++m) {
    a.w[m] = static_cast<const T*>(p[3 + 2 * m]);
    a.b[m] = static_cast<const float*>(p[4 + 2 * m]);
  }
  a.k_in = static_cast<const T*>(p[15]);
  a.v_in = static_cast<const T*>(p[16]);
  a.k_att = static_cast<T*>(p[17]);
  a.v_att = static_cast<T*>(p[18]);
  a.kx = static_cast<const KT*>(p[19]);
  a.vx = static_cast<const KT*>(p[20]);
  a.kxs = static_cast<const float*>(p[21]);
  a.vxs = static_cast<const float*>(p[22]);
  a.src = static_cast<const int*>(p[23]);
  a.hidden = static_cast<T*>(p[24]);
  a.k_new = static_cast<T*>(p[25]);
  a.v_new = static_cast<T*>(p[26]);
  a.ws = static_cast<float*>(p[27]);
  a.bar = static_cast<unsigned*>(p[28]);
  a.timeline = static_cast<unsigned long long*>(p[29]);
  a.B = n[0]; a.N = n[1]; a.L = n[2]; a.Lp = n[3]; a.lenc = n[4]; a.d = n[5];
  a.inner = n[6]; a.H = n[7]; a.dff = n[8]; a.group = n[9]; a.idx = n[10];
  return launch<T, KT, QUANT>(a, stream);
}

// Shapes as in Args; all contiguous. kx / vx are int8 with float32 scales when
// quant is 1, else of the working type with null scales. With src == null,
// k_att / v_att must be k_in / v_in. timeline: null, or 8 N + 2 uint64 slots.
extern "C" int whisper_mega_step(
    const void* x, const void* ln_s, const void* ln_b, const void* wqkv, const void* bqkv,
    const void* wo_self, const void* bo_self, const void* wq_cross, const void* bq_cross,
    const void* wo_cross, const void* bo_cross, const void* wi, const void* bi, const void* wo_ff,
    const void* bo_ff, const void* k_in, const void* v_in, void* k_att, void* v_att,
    const void* kx, const void* vx, const void* kxs, const void* vxs, const void* src,
    void* hidden, void* k_new, void* v_new, void* ws, void* bar, void* timeline, int B, int N,
    int L, int Lp,
    int lenc, int d, int inner, int H, int dff, int group, int idx, int dtype, int quant,
    void* stream) {
  if (group < 1 || group > GMAX || B % group != 0 || H < 1 || inner % H != 0 ||
      (inner / H) % 16 != 0 || inner / H > 32 * DJ || d % 8 != 0 || dff % 8 != 0 ||
      idx < 0 || idx >= L || lenc < 1 || lenc > Lp || (quant && (kxs == nullptr || vxs == nullptr)))
    return (int)cudaErrorInvalidValue;
  void* const p[30] = {const_cast<void*>(x), const_cast<void*>(ln_s), const_cast<void*>(ln_b),
                       const_cast<void*>(wqkv), const_cast<void*>(bqkv),
                       const_cast<void*>(wo_self), const_cast<void*>(bo_self),
                       const_cast<void*>(wq_cross), const_cast<void*>(bq_cross),
                       const_cast<void*>(wo_cross), const_cast<void*>(bo_cross),
                       const_cast<void*>(wi), const_cast<void*>(bi), const_cast<void*>(wo_ff),
                       const_cast<void*>(bo_ff), const_cast<void*>(k_in),
                       const_cast<void*>(v_in), k_att, v_att, const_cast<void*>(kx),
                       const_cast<void*>(vx), const_cast<void*>(kxs), const_cast<void*>(vxs),
                       const_cast<void*>(src), hidden, k_new, v_new, ws, bar, timeline};
  const int n[11] = {B, N, L, Lp, lenc, d, inner, H, dff, group, idx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VC_DTYPE_F32)
    return quant ? fill_and_launch<float, signed char, true>(p, n, s)
                 : fill_and_launch<float, float, false>(p, n, s);
  if (dtype == VC_DTYPE_BF16)
    return quant ? fill_and_launch<__nv_bfloat16, signed char, true>(p, n, s)
                 : fill_and_launch<__nv_bfloat16, __nv_bfloat16, false>(p, n, s);
  return (int)cudaErrorInvalidValue;
}
