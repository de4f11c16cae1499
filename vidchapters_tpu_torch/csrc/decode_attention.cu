// One decoder layer's attention for one decode step: the self-attention over
// the cache (with this step's K/V written into it) and the cross-attention
// over the encoder K/V that the beams of an example share.
//
// Replaces: vidchapters_tpu/ops/decode_attention.py::decode_self_attention /
// _kernel (the pl.pallas_call at line 66) and ::decode_cross_attention /
// _cross_kernel (the pl.pallas_call at line 117), each launched once per
// decoder layer per step by the standard cached decode.
//
// decode_self_attention: q, k_new, v_new [R, H, 1, D]; caches [R, H, L, D];
// bias [1, H, 1, L], which the caller has already set to -1e9 past idx.
// Row idx of the caches receives k_new / v_new in place (the TPU kernel
// aliases the caches to its outputs and rewrites the whole [L, D] block only
// because Mosaic cannot store one dynamic sublane; this kernel writes the one
// row). The scores q.k + bias, their max, exp and sum are fp32, and the
// probabilities enter p.v in fp32, as in the TPU kernel. Keys past idx carry
// -1e9, whose exp underflows to exactly 0 in fp32, so the key loop stops at
// idx: the result is the same.
//
// decode_cross_attention: q [B0 * g, H, 1, D] (g beams per example, beam-
// major within the example), k / v [B0, H, Lk, D], key_mask [B0, Lk] int32.
// Masked keys score -1e9 (not -inf: a row whose keys are all masked gets the
// uniform average, as in the TPU kernel). The output is written straight in
// q's layout, with no [B0, H, g, D] round trip.
//
// What bounds it on the H100: both are reductions with two small products
// per (row, head), far below the card's arithmetic rate, so they are bound by
// the bytes of K/V they must read. At beam 4 and batch 8 (R = 32, H = 12,
// L = 256, D = 64, bf16) the self-attention reads at most the two caches,
// 25.2 MB (~7.5 us at 3.35 TB/s); the cross-attention reads each example's
// K/V once for its 4 beams, 28.3 MB at Lk = 1152 (~8.5 us). At these sizes
// the latency of the dependent steps of one block is what is left to cut.
//
// Self-attention design (decode_self_kernel): one block of 8 warps per (row,
// head, key split), and no staging through shared memory. A key row is held
// by a group of lanes, 16 bytes each (8 lanes at D 64 bf16, so one warp-wide
// load covers 4 keys); each warp takes its own stripe of the block's keys
// and issues all its K loads, then all its V loads (SU keys a lane) before
// it uses any. A group's score is its lanes' partial dot products summed by
// shuffles; each lane keeps the running max, sum and p.v accumulators of its
// own keys (online softmax, fp32) in registers, the lanes of a warp merge
// theirs by shuffles, and the block's warps merge through shared memory
// after a single __syncthreads. Key idx is read from k_new / v_new, never
// from the cache, and the one lane group that reads it writes it to row idx
// of both caches. When (row, head) units are few against the SMs (8 rows x
// 12 heads = 96 units at beam 1), the wrapper splits the keys over several
// blocks; each writes its max, sum and accumulators to a workspace, and the
// last block of a unit to arrive (a counter that this block sets back to 0,
// so no launch zeroes it) merges them in split order.
//
// Cross-attention design (decode_cross_kernel): one block of 128 threads per
// (example, head, key split). The block holds its g query rows in shared
// memory and streams its keys in tiles of 32. Each thread loads its share of
// the next tile (K and V in 16-byte vectors, and the tile's mask entries)
// into registers while the block works on the current tile, then stores it
// into shared memory as fp32, K/V rows padded by one float so that neither
// the score loop nor the p.v loop meets bank conflicts. Per tile the block
// computes the g x 32 scores, updates each query row's running max and sum
// (online softmax: one warp per row, one key per lane), and folds the tile
// into accumulators held in registers, one (row, dim) pair per thread slot.
// K/V rows are read from device memory once for all g beams. With one block
// per (example, head), 96 blocks at bs 8 walked 36 tiles each on 96 of the
// 132 SMs, and a tile's latency (about 2 us) set the time, so the keys are
// split across blocks: each split writes its running max, sum and
// accumulators to a workspace; the last split of an (example, head) to
// finish (a counter the wrapper zeroes) merges them in split order, so the
// result does not depend on which block ends last (PERF.md has the times of
// each step of this design).

#include "common.cuh"

namespace {

constexpr int NT = 128;
constexpr int NWARPS = NT / 32;
constexpr int TK = 32;     // keys per tile (one per lane in the softmax update)
constexpr int MAXD = 128;  // widest head
constexpr int MAXG = 8;    // most beams per example
constexpr int MAXACC = MAXG * MAXD / NT;    // accumulator slots per thread
constexpr int VEC = 8;                      // elements of one vector load
constexpr int MAXV = TK * MAXD / VEC / NT;  // vector loads of a K (or V) tile per thread

// 8 consecutive elements of T, loaded as 16-byte vectors and stored as floats.
template <typename T> struct Vec8;

template <> struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void store(float* dst) const {
    dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
    dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
  }
};

template <> struct Vec8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void store(float* dst) const {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

// part: per (example, head, split) g running maxima, g sums, then g x D
// accumulators (splits > 1 only); arrived: per (example, head), zeroed.
template <typename T>
__global__ void __launch_bounds__(NT) decode_cross_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ mask, T* __restrict__ out, float* part, int* arrived, int H, int L,
    int D, int g, int n_keys, int splits, int span) {
  __shared__ float qs[MAXG][MAXD];
  __shared__ float ks[TK][MAXD + 1];
  __shared__ float vs[TK][MAXD + 1];
  __shared__ float ps[MAXG][TK];
  __shared__ float adj[TK];  // 1 for a valid key, 0 for a masked one
  __shared__ float m_run[MAXG], l_run[MAXG], alpha[MAXG];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit = blockIdx.x / splits, sp = blockIdx.x % splits;
  const int e = unit / H, h = unit % H;
  const int k_lo = sp * span, k_hi = min(n_keys, k_lo + span);
  const long kv_base = ((long)e * H + h) * L * D;  // this (example, head)'s [L, D]

  for (int t = tid; t < g * D; t += NT) {
    const int gi = t / D, d = t % D;
    qs[gi][d] = vc::to_f(q[(((long)e * g + gi) * H + h) * D + d]);
  }
  if (tid < g) {
    m_run[tid] = -CUDART_INF_F;
    l_run[tid] = 0.f;
  }
  float acc[MAXACC];
#pragma unroll
  for (int a = 0; a < MAXACC; ++a) acc[a] = 0.f;

  // a tile in registers: vector slot s of thread tid is K/V row
  // (tid + s * NT) / dv, columns 8 * ((tid + s * NT) % dv) onwards; thread
  // tid < 32 also holds key tid's mask entry
  const int dv = D / VEC;
  Vec8<T> kr[MAXV], vr[MAXV];
  float adj_r = 0.f;
  auto load_tile = [&](int j0) {
#pragma unroll
    for (int s = 0; s < MAXV; ++s) {
      const int t = tid + s * NT, j = t / dv, c = t - j * dv, key = j0 + j;
      if (t < TK * dv && key < k_hi) {
        kr[s].load(k + kv_base + (long)key * D + c * VEC);
        vr[s].load(v + kv_base + (long)key * D + c * VEC);
      } else {
        kr[s].zero();
        vr[s].zero();
      }
    }
    if (tid < TK && j0 + tid < k_hi) adj_r = mask[(long)e * L + j0 + tid] > 0 ? 1.f : 0.f;
  };
  if (k_lo < k_hi) load_tile(k_lo);
  __syncthreads();

  for (int j0 = k_lo; j0 < k_hi; j0 += TK) {
#pragma unroll
    for (int s = 0; s < MAXV; ++s) {
      const int t = tid + s * NT, j = t / dv, c = t - j * dv;
      if (t < TK * dv) {
        kr[s].store(&ks[j][c * VEC]);
        vr[s].store(&vs[j][c * VEC]);
      }
    }
    if (tid < TK) adj[tid] = adj_r;
    __syncthreads();
    if (j0 + TK < k_hi) load_tile(j0 + TK);  // in flight while this tile is used
    for (int t = tid; t < g * TK; t += NT) {
      const int gi = t / TK, j = t % TK;
      float s = -CUDART_INF_F;  // past the last key: not a key at all
      if (j0 + j < k_hi) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qs[gi][d], ks[j][d], dot);
        s = adj[j] != 0.f ? dot : -1e9f;
      }
      ps[gi][j] = s;
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += NWARPS) {  // online softmax, one key per lane
      const float s = ps[gi][lane];
      const float m_old = m_run[gi];
      const float m_new = fmaxf(m_old, vc::warp_max(s));
      const float p = expf(s - m_new);
      const float sum = vc::warp_sum(p);
      ps[gi][lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_old - m_new);  // 0 on the first tile
        alpha[gi] = a;
        m_run[gi] = m_new;
        l_run[gi] = l_run[gi] * a + sum;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < MAXACC; ++a) {
      const int t = tid + a * NT;
      if (t < g * D) {
        const int gi = t / D, d = t % D;
        float sum = acc[a] * alpha[gi];
#pragma unroll 8
        for (int j = 0; j < TK; ++j) sum = fmaf(ps[gi][j], vs[j][d], sum);
        acc[a] = sum;
      }
    }
    __syncthreads();  // the next tile overwrites ks / vs / ps / adj
  }

  if (splits == 1) {
#pragma unroll
    for (int a = 0; a < MAXACC; ++a) {
      const int t = tid + a * NT;
      if (t < g * D) {
        const int gi = t / D, d = t % D;
        out[(((long)e * g + gi) * H + h) * D + d] = vc::from_f<T>(acc[a] / l_run[gi]);
      }
    }
    return;
  }
  // this split's state, then the last split of the (example, head) merges all
  const int stride = g * (D + 2);
  float* mine = part + ((long)unit * splits + sp) * stride;
  if (tid < g) {
    mine[tid] = m_run[tid];
    mine[g + tid] = l_run[tid];
  }
#pragma unroll
  for (int a = 0; a < MAXACC; ++a) {
    const int t = tid + a * NT;
    if (t < g * D) mine[2 * g + t] = acc[a];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&arrived[unit], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* all = part + (long)unit * splits * stride;
#pragma unroll
  for (int a = 0; a < MAXACC; ++a) {
    const int t = tid + a * NT;
    if (t < g * D) {
      const int gi = t / D, d = t % D;
      float m = -CUDART_INF_F;
      for (int s = 0; s < splits; ++s) m = fmaxf(m, __ldcg(all + s * stride + gi));
      float l = 0.f, o = 0.f;
      for (int s = 0; s < splits; ++s) {  // an empty split has m -inf: weight 0
        const float w = expf(__ldcg(all + s * stride + gi) - m);
        l = fmaf(__ldcg(all + s * stride + g + gi), w, l);
        o = fmaf(__ldcg(all + s * stride + 2 * g + t), w, o);
      }
      out[(((long)e * g + gi) * H + h) * D + d] = vc::from_f<T>(o / l);
    }
  }
}

// ---- the self-attention ----

constexpr int SNT = 256;  // threads of a self-attention block
constexpr int SNW = SNT / 32;
constexpr int SU = 4;     // keys a lane loads before it uses any

// 16 bytes of T: its elements as floats.
template <typename T> struct Vec16;

template <> struct Vec16<float> {
  static constexpr int N = 4;
  float4 u;
  __device__ __forceinline__ float at(int e) const {
    return e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w;
  }
};

template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  uint4 u;
  __device__ __forceinline__ float at(int e) const {
    const unsigned w = e < 2 ? u.x : e < 4 ? u.y : e < 6 ? u.z : u.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

// exp(m - m_to): the weight of a softmax state with max m in one with max
// m_to >= m; 0 for a state that has seen no key.
__device__ __forceinline__ float rescale(float m, float m_to) {
  return m == -CUDART_INF_F ? 0.f : expf(m - m_to);
}

// grid R * H * splits; part: per (row, head, split) the max, the sum and D
// accumulators (splits > 1 only); arrived: per (row, head), 0 between launches.
template <typename T>
__global__ void __launch_bounds__(SNT) decode_self_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new, T* k,
    T* v, const T* __restrict__ bias, T* __restrict__ out, float* part, int* arrived, int H,
    int L, int D, int idx, int splits, int span) {
  __shared__ float wm[SNW], wl[SNW];
  __shared__ float wacc[SNW][MAXD];
  __shared__ int last;

  using V = Vec16<T>;
  constexpr int E = V::N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit = blockIdx.x / splits, sp = blockIdx.x % splits, h = unit % H;
  const int k_lo = sp * span, k_hi = min(idx + 1, k_lo + span);
  const long base = (long)unit * L * D;  // this (row, head)'s [L, D] of the caches
  // a key row is G lanes of E elements; a group spans GP lanes, a power of two
  const int G = D / E;
  int GP = 1;
  while (GP < G) GP <<= 1;
  const int per_load = 32 / GP, slot = lane / GP, c = lane % GP;
  const bool on = c < G;

  float qf[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qf[e] = on ? vc::to_f(q[(long)unit * D + c * E + e]) : 0.f;
    acc[e] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  // the block's keys in groups of per_load; warp w takes groups w * SU ..
  // w * SU + SU - 1, then the same SNW * SU groups further on
  const int groups = (k_hi - k_lo + per_load - 1) / per_load;
  for (int g0 = warp * SU; g0 < groups; g0 += SNW * SU) {
    V kr[SU], vr[SU];
    int key[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      key[u] = k_lo + (g0 + u) * per_load + slot;
      if (g0 + u >= groups || key[u] >= k_hi) key[u] = -1;
      if (on && key[u] >= 0)
        kr[u].u = *reinterpret_cast<const decltype(kr[u].u)*>(
            key[u] == idx ? k_new + (long)unit * D + c * E : k + base + (long)key[u] * D + c * E);
    }
#pragma unroll
    for (int u = 0; u < SU; ++u)
      if (on && key[u] >= 0)
        vr[u].u = *reinterpret_cast<const decltype(vr[u].u)*>(
            key[u] == idx ? v_new + (long)unit * D + c * E : v + base + (long)key[u] * D + c * E);
    float s[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) s[u] = key[u] >= 0 ? vc::to_f(bias[(long)h * L + key[u]]) : 0.f;
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      if (on && key[u] == idx) {  // the one cache write of row idx
        *reinterpret_cast<decltype(kr[u].u)*>(k + base + (long)idx * D + c * E) = kr[u].u;
        *reinterpret_cast<decltype(vr[u].u)*>(v + base + (long)idx * D + c * E) = vr[u].u;
      }
      float dot = 0.f;
      if (on && key[u] >= 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qf[e], kr[u].at(e), dot);
      }
      for (int o = GP >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[u] = key[u] >= 0 ? dot + s[u] : -CUDART_INF_F;
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < SU; ++u) m_new = fmaxf(m_new, s[u]);
    if (m_new == -CUDART_INF_F) continue;  // no key of this lane's slot
    const float a = rescale(m, m_new);
    l *= a;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= a;
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      if (key[u] < 0) continue;
      const float p = expf(s[u] - m_new);
      l += p;
      if (on) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vr[u].at(e), acc[e]);
      }
    }
    m = m_new;
  }

  // the warp's slots merged into slot 0, then the block's warps
  for (int o = GP; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    const float m_new = fmaxf(m, mo);
    const float a = rescale(m, m_new), b = rescale(mo, m_new);
    l = l * a + lo * b;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = acc[e] * a + __shfl_xor_sync(0xffffffffu, acc[e], o) * b;
    m = m_new;
  }
  if (slot == 0 && on) {
#pragma unroll
    for (int e = 0; e < E; ++e) wacc[warp][c * E + e] = acc[e];
  }
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  float bm = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < SNW; ++w) bm = fmaxf(bm, wm[w]);
  float bl = 0.f, bo = 0.f;
  if (tid < D) {
#pragma unroll
    for (int w = 0; w < SNW; ++w) {
      const float a = rescale(wm[w], bm);
      bl = fmaf(wl[w], a, bl);
      bo = fmaf(wacc[w][tid], a, bo);
    }
  }
  if (splits == 1) {
    if (tid < D) out[(long)unit * D + tid] = vc::from_f<T>(bo / bl);
    return;
  }
  float* mine = part + ((long)unit * splits + sp) * (D + 2);
  if (tid < D) mine[2 + tid] = bo;
  if (tid == 0) {
    mine[0] = bm;
    mine[1] = bl;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&arrived[unit], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* all = part + (long)unit * splits * (D + 2);
  if (tid < D) {
    float gm = -CUDART_INF_F;
    for (int t = 0; t < splits; ++t) gm = fmaxf(gm, __ldcg(all + t * (D + 2)));
    float gl = 0.f, go = 0.f;
    for (int t = 0; t < splits; ++t) {
      const float a = rescale(__ldcg(all + t * (D + 2)), gm);
      gl = fmaf(__ldcg(all + t * (D + 2) + 1), a, gl);
      go = fmaf(__ldcg(all + t * (D + 2) + 2 + tid), a, go);
    }
    out[(long)unit * D + tid] = vc::from_f<T>(go / gl);
  }
  if (tid == 0) arrived[unit] = 0;
}

bool bad_width(int D) { return D < VEC || D > MAXD || D % VEC; }

template <typename T>
void launch_cross(const void* q, const void* k, const void* v, const int* mask, void* out,
                  float* part, int* arrived, int B0, int g, int H, int Lk, int D, int splits,
                  int span, cudaStream_t s) {
  decode_cross_kernel<T><<<B0 * H * splits, NT, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), part, arrived, H, Lk, D, g, Lk, splits, span);
}

template <typename T>
void launch_self(const void* q, const void* k_new, const void* v_new, void* k_cache,
                 void* v_cache, const void* bias, void* out, float* part, int* arrived, int R,
                 int H, int L, int D, int idx, int splits, int span, cudaStream_t s) {
  decode_self_kernel<T><<<R * H * splits, SNT, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), static_cast<const T*>(bias),
      static_cast<T*>(out), part, arrived, H, L, D, idx, splits, span);
}

}  // namespace

// q / k_new / v_new / out [R, H, 1, D], caches [R, H, L, D] (written at row idx),
// bias [1, H, 1, L]; all of one dtype and contiguous, k_new / v_new / caches 16-byte
// aligned; 0 <= idx < L; D a multiple of 8, at most 128. The keys 0..idx split into
// `splits` ranges of `span` keys; with splits > 1, part holds R * H * splits * (D + 2)
// floats and arrived R * H ints that are 0 (the kernel leaves them 0 again).
extern "C" int decode_self_attention(const void* q, const void* k_new, const void* v_new,
                                     void* k_cache, void* v_cache, const void* bias, void* out,
                                     void* part, void* arrived, int R, int H, int L, int D,
                                     int idx, int splits, int span, int dtype, void* stream) {
  if (R <= 0 || H <= 0 || bad_width(D) || idx < 0 || idx >= L || splits < 1 || span < 1 ||
      (long)splits * span < idx + 1 || (splits > 1 && (part == nullptr || arrived == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  int* a = static_cast<int*>(arrived);
  if (dtype == VC_DTYPE_F32)
    launch_self<float>(q, k_new, v_new, k_cache, v_cache, bias, out, p, a, R, H, L, D, idx,
                       splits, span, s);
  else if (dtype == VC_DTYPE_BF16)
    launch_self<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, bias, out, p, a, R, H, L, D,
                               idx, splits, span, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// q / out [B0 * g, H, 1, D], k / v [B0, H, Lk, D] of one dtype, key_mask [B0, Lk]
// int32; all contiguous, k / v 16-byte aligned; 1 <= g <= 8; D a multiple of 8, at
// most 128. The keys split into `splits` ranges of `span` keys (a multiple of 32);
// with splits > 1, part holds B0 * H * splits * g * (D + 2) floats and arrived
// B0 * H zeroed ints.
extern "C" int decode_cross_attention(const void* q, const void* k, const void* v,
                                      const void* key_mask, void* out, void* part,
                                      void* arrived, int B0, int g, int H, int Lk, int D,
                                      int splits, int span, int dtype, void* stream) {
  if (B0 <= 0 || H <= 0 || Lk <= 0 || g < 1 || g > MAXG || bad_width(D) || splits < 1 ||
      span < 1 || span % TK || (long)splits * span < Lk ||
      (splits > 1 && (part == nullptr || arrived == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(key_mask);
  float* p = static_cast<float*>(part);
  int* a = static_cast<int*>(arrived);
  if (dtype == VC_DTYPE_F32)
    launch_cross<float>(q, k, v, m, out, p, a, B0, g, H, Lk, D, splits, span, s);
  else if (dtype == VC_DTYPE_BF16)
    launch_cross<__nv_bfloat16>(q, k, v, m, out, p, a, B0, g, H, Lk, D, splits, span, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
