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
// live K/V once for its 4 beams, 19.3 MB for 6280 live keys of 8 x 1152
// (~5.8 us). At these sizes the latency of the dependent steps of one block
// is what is left to cut.
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
// Cross-attention design: each example's live keys only. They end at its
// last unmasked key, or are all Lk keys when it has none (every key then
// scores -1e9 alike and the output is V's mean, as in the TPU kernel); a key
// past the end would add exactly 0, so no K/V row beyond it is read. The
// ends come in as live [B0], found once per decode call (the wrapper's
// cross_live_ends), so the kernel reads 19.3 MB where all 1152 keys are 28.3
// MB at the timed shape. Work is split over the live keys: items are
// (example, head, chunk of live keys), and every block of a fixed grid (2 per
// SM, and at least B0 * H) finds its own from live (cross_item), so short
// examples leave no block idle and the launch replays in a CUDA graph. Two
// routes then read a chunk with its loads issued together and each K/V row
// read once for all g beams. bf16 at D 64 / 128 (decode_cross_tc_kernel):
// each warp stages its tiles of 16 keys into a cp.async ring and runs both
// products on mma.sync, the beams as the rows of the A operand (P as two
// bf16 halves, so p.v stays fp32). fp32 and other widths
// (decode_cross_kernel): a key row is held by a group of lanes, 16 bytes
// each, which compute its g scores from one K load and keep g online-softmax
// states in registers. The warps of a block merge through shared memory
// after one __syncthreads; with more than one chunk to an (example, head),
// each block writes its states to a workspace and the last block of the
// (example, head) to arrive (a counter it sets back to 0, so no launch zeroes
// it) merges them in chunk order, so the result does not depend on which
// block ends last (cross_finish).

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int MAXD = 128;  // widest head
constexpr int MAXG = 8;    // most beams per example
constexpr int VEC = 8;     // a head's width is a multiple of this

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

// ---- the cross-attention ----

constexpr int CNT = 256;       // threads of a cross-attention block
constexpr int CNW = CNT / 32;
constexpr int CHUNK_MIN = 64;  // the shortest chunk length the search tries

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Example e's live keys: live[e], or all L where it is out of [1, L].
__device__ __forceinline__ int live_keys(const int* live, int e, int L) {
  const int n = __ldg(live + e);
  return n >= 1 && n <= L ? n : L;
}

// A block's item: example e, head h, chunk ch of the (example, head)'s nch,
// keys [lo, hi); e = B0 for a block without one.
struct CrossItem {
  int e, h, ch, nch, lo, hi;
};

// Block b takes item b. Items run over examples, then heads, then chunks, so
// an (example, head)'s chunks are consecutive items. The longest chunk is the
// smallest multiple of 32, from CHUNK_MIN on, that leaves no item without a
// block (a chunk as long as the longest live range always does, since the
// grid has at least B0 * H blocks); an example's keys are then split into
// that many chunks of equal size. Warp 0 finds both: each lane tries one chunk a round,
// with the live ends of 32 examples at a time spread over the lanes; then a
// prefix sum over the examples' item counts places block b. Called by every
// thread of the block.
__device__ CrossItem cross_item(const int* live, int B0, int H, int L) {
  __shared__ int found[4];  // example, item within it, chunk, chunks a head
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    int chunk = 0x7fffffff;
    for (int base = CHUNK_MIN; chunk == 0x7fffffff; base += 32 * 32) {
      const int c = base + 32 * lane;
      long n = 0;
      for (int e0 = 0; e0 < B0; e0 += 32) {
        const int mine = e0 + lane < B0 ? live_keys(live, e0 + lane, L) : 0;
        for (int j = 0; j < 32 && e0 + j < B0; ++j)
          n += cdiv(__shfl_sync(0xffffffffu, mine, j), c);
      }
      int best = n * H <= (long)gridDim.x ? c : 0x7fffffff;
      for (int o = 16; o > 0; o >>= 1) best = min(best, __shfl_xor_sync(0xffffffffu, best, o));
      chunk = best;
    }
    const int b = blockIdx.x;
    int first = 0;
    if (lane == 0) found[0] = B0;
    __syncwarp();
    for (int e0 = 0; e0 < B0; e0 += 32) {
      const int e = e0 + lane;
      const int n = e < B0 ? cdiv(live_keys(live, e, L), chunk) * H : 0;
      int incl = n;  // the items of examples e0 .. e
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_sync(0xffffffffu, incl, max(lane - o, 0));
        if (lane >= o) incl += y;
      }
      if (n > 0 && b >= first + incl - n && b < first + incl) {
        found[0] = e;
        found[1] = b - (first + incl - n);
        found[2] = chunk;
        found[3] = n / H;
      }
      first += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  __syncthreads();
  CrossItem it;
  it.e = found[0];
  if (it.e >= B0) return it;
  it.nch = found[3];
  it.h = found[1] / it.nch;
  it.ch = found[1] % it.nch;
  const int n = live_keys(live, it.e, L), span = cdiv(n, it.nch);  // chunks of equal size
  it.lo = it.ch * span;
  it.hi = min(n, it.lo + span);
  return it;
}

// The end of a cross-attention block: its warps' softmax states merged (ws +
// w * wstride holds warp w's g maxima, g sums and g x D accumulators) and
// written out, or, for an (example, head) split over several chunks, written
// to part (per item g maxima, g sums, g x D accumulators), the last chunk of
// the (example, head) to arrive merging them in chunk order, so the result
// does not depend on which block ends last; that block sets its counter back
// to 0.
template <typename T>
__device__ void cross_finish(const float* ws, int wstride, const CrossItem& it, float* part,
                             int* arrived, T* out, int H, int D, int g) {
  __shared__ int last;
  const int tid = threadIdx.x, stride = g * (D + 2);
  float* mine = part + (long)blockIdx.x * stride;
  for (int t = tid; t < g * D; t += CNT) {
    const int b = t / D, d = t - b * D;
    float bm = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < CNW; ++w) bm = fmaxf(bm, ws[w * wstride + b]);
    float bl = 0.f, bo = 0.f;
#pragma unroll
    for (int w = 0; w < CNW; ++w) {
      const float a = rescale(ws[w * wstride + b], bm);
      bl = fmaf(ws[w * wstride + g + b], a, bl);
      bo = fmaf(ws[w * wstride + 2 * g + t], a, bo);
    }
    if (it.nch == 1) {
      out[(((long)it.e * g + b) * H + it.h) * D + d] = vc::from_f<T>(bo / bl);
    } else {
      mine[2 * g + t] = bo;
      if (d == 0) {
        mine[b] = bm;
        mine[g + b] = bl;
      }
    }
  }
  if (it.nch == 1) return;
  const int unit = it.e * H + it.h;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&arrived[unit], 1) == it.nch - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* all = part + (long)(blockIdx.x - it.ch) * stride;  // the unit's chunk 0
  for (int t = tid; t < g * D; t += CNT) {
    const int b = t / D, d = t - b * D;
    float gm = -CUDART_INF_F, gl = 0.f, go = 0.f;
    for (int x = 0; x < it.nch; ++x) {  // one pass, in chunk order
      const float mx = __ldcg(all + x * stride + b), lx = __ldcg(all + x * stride + g + b),
                  ox = __ldcg(all + x * stride + 2 * g + t);
      const float m_new = fmaxf(gm, mx), a = rescale(gm, m_new), c = rescale(mx, m_new);
      gl = gl * a + lx * c;
      go = go * a + ox * c;
      gm = m_new;
    }
    out[(((long)it.e * g + b) * H + it.h) * D + d] = vc::from_f<T>(go / gl);
  }
  if (tid == 0) arrived[unit] = 0;
}

// The CUDA-core route (fp32, and bf16 at other head widths than 64 and 128):
// a key row is held by a group of lanes, 16 bytes each; each warp takes its
// own stripe of the chunk and issues all its K loads, then all its V loads
// and mask entries (CU keys a lane), before it uses any. A lane group computes
// the g scores of its key from one K load and keeps g online-softmax states
// in registers (MG >= g of them), so each K/V row is read once for all g beams.
constexpr int CU = 4;  // keys a lane loads before it uses any

template <typename T, int MG>
__global__ void __launch_bounds__(CNT, MG <= 4 ? 2 : 1) decode_cross_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ mask, const int* __restrict__ live, T* __restrict__ out,
    float* part, int* arrived, int B0, int H, int L, int D, int g) {
  constexpr int WS = 2 * MG + MG * MAXD;  // a warp's softmax states
  __shared__ float ws[CNW * WS];

  using V = Vec16<T>;
  constexpr int E = V::N;
  const CrossItem it = cross_item(live, B0, H, L);
  if (it.e >= B0) return;  // more blocks than items
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long base = ((long)it.e * H + it.h) * L * D;  // this (example, head)'s [L, D]
  const int* mrow = mask + (long)it.e * L;
  // a key row is G lanes of E elements; a group spans GP lanes, a power of two
  const int G = D / E;
  int GP = 1;
  while (GP < G) GP <<= 1;
  const int per_load = 32 / GP, slot = lane / GP, c = lane % GP;
  const bool on = c < G;

  float qf[MG][E], acc[MG][E], m[MG], l[MG];
#pragma unroll
  for (int b = 0; b < MG; ++b) {
    m[b] = -CUDART_INF_F;
    l[b] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      qf[b][i] =
          on && b < g ? vc::to_f(q[(((long)it.e * g + b) * H + it.h) * D + c * E + i]) : 0.f;
      acc[b][i] = 0.f;
    }
  }

  // the chunk's keys in groups of per_load; warp w takes groups w * CU ..
  // w * CU + CU - 1, then the same CNW * CU groups further on
  const int groups = cdiv(it.hi - it.lo, per_load);
  for (int g0 = warp * CU; g0 < groups; g0 += CNW * CU) {
    V kr[CU], vr[CU];
    int key[CU];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      key[u] = it.lo + (g0 + u) * per_load + slot;
      if (g0 + u >= groups || key[u] >= it.hi) key[u] = -1;
      if (on && key[u] >= 0)
        kr[u].u = *reinterpret_cast<const decltype(kr[u].u)*>(k + base + (long)key[u] * D + c * E);
    }
#pragma unroll
    for (int u = 0; u < CU; ++u)
      if (on && key[u] >= 0)
        vr[u].u = *reinterpret_cast<const decltype(vr[u].u)*>(v + base + (long)key[u] * D + c * E);
    bool valid[CU];
#pragma unroll
    for (int u = 0; u < CU; ++u) valid[u] = key[u] >= 0 && mrow[key[u]] > 0;
    float s[CU][MG];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
#pragma unroll
      for (int b = 0; b < MG; ++b) {
        if (b >= g) break;
        float dot = 0.f;
        if (on && key[u] >= 0) {
#pragma unroll
          for (int i = 0; i < E; ++i) dot = fmaf(qf[b][i], kr[u].at(i), dot);
        }
        for (int o = GP >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        // a masked key scores -1e9; past the chunk's keys, no key at all
        s[u][b] = key[u] < 0 ? -CUDART_INF_F : valid[u] ? dot : -1e9f;
      }
    }
#pragma unroll
    for (int b = 0; b < MG; ++b) {
      if (b >= g) break;
      float m_new = m[b];
#pragma unroll
      for (int u = 0; u < CU; ++u) m_new = fmaxf(m_new, s[u][b]);
      if (m_new == -CUDART_INF_F) continue;  // no key of this lane's slot
      const float a = rescale(m[b], m_new);
      l[b] *= a;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[b][i] *= a;
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        if (key[u] < 0) continue;
        const float p = expf(s[u][b] - m_new);
        l[b] += p;
        if (on) {
#pragma unroll
          for (int i = 0; i < E; ++i) acc[b][i] = fmaf(p, vr[u].at(i), acc[b][i]);
        }
      }
      m[b] = m_new;
    }
  }

  // the warp's slots merged into slot 0, then the block's warps
  for (int o = GP; o < 32; o <<= 1) {
#pragma unroll
    for (int b = 0; b < MG; ++b) {
      if (b >= g) break;
      const float mo = __shfl_xor_sync(0xffffffffu, m[b], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[b], o);
      const float m_new = fmaxf(m[b], mo);
      const float x = rescale(m[b], m_new), y = rescale(mo, m_new);
      l[b] = l[b] * x + lo * y;
#pragma unroll
      for (int i = 0; i < E; ++i)
        acc[b][i] = acc[b][i] * x + __shfl_xor_sync(0xffffffffu, acc[b][i], o) * y;
      m[b] = m_new;
    }
  }
  float* mine = ws + warp * WS;
#pragma unroll
  for (int b = 0; b < MG; ++b) {
    if (b >= g) break;
    if (slot == 0 && on) {
#pragma unroll
      for (int i = 0; i < E; ++i) mine[2 * g + b * D + c * E + i] = acc[b][i];
    }
    if (lane == 0) {
      mine[b] = m[b];
      mine[g + b] = l[b];
    }
  }
  __syncthreads();
  cross_finish<T>(ws, WS, it, part, arrived, out, H, D, g);
}

// The tensor-core route (bf16, D 64 or 128). Each warp takes every CNW-th
// tile of 16 keys of the chunk and stages its K and V rows (bf16, rows padded
// by 16 bytes so that ldmatrix meets no bank conflict) and mask entries into
// its own ring of STAGES tiles of shared memory with cp.async, all of them
// before it uses any where the chunk is short enough (at most 352 keys at
// the timed shape: 3 tiles a warp). Per tile two products on
// mma.sync.m16n8k16: the scores S = Q K^T with the g beams as rows 0..g-1 of
// the 16-row A operand (held in registers for the whole chunk), then O +=
// P V, where P, fp32 after
// the online softmax, enters as two bf16 halves P_hi + P_lo (so P V keeps
// ~16 bits of P, the plain version's fp32 to within the output's bf16
// rounding). A lane holds row g = lane / 4's scores at keys 2t, 2t + 1, 8 +
// 2t, 9 + 2t (t = lane % 4), so a row's max and sum take two shuffles.
constexpr int TK = 16;     // keys of a tile
constexpr int STAGES = 3;  // tiles a warp has in flight

// A stage: K and V tiles (row stride D + 8) and their 16 mask entries.
template <int D>
__host__ __device__ constexpr int tc_stage_bytes() {
  return 2 * TK * (D + 8) * 2 + TK * 4;
}

template <int D>
__global__ void __launch_bounds__(CNT, D <= 64 ? 2 : 1) decode_cross_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
    const int* __restrict__ live, __nv_bfloat16* __restrict__ out, float* part, int* arrived,
    int B0, int H, int L, int g) {
  using namespace vc::tc;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = D + 8, KV = TK * LD, STAGE = tc_stage_bytes<D>();
  const CrossItem it = cross_item(live, B0, H, L);
  if (it.e >= B0) return;  // more blocks than items
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, t = lane & 3;
  unsigned char* wbase = smem + warp * STAGES * STAGE;
  const long base = ((long)it.e * H + it.h) * L * D;  // this (example, head)'s [L, D]
  const int* mrow = mask + (long)it.e * L;
  const int tiles = cdiv(it.hi - it.lo, TK);
  const int n_mine = tiles > warp ? cdiv(tiles - warp, CNW) : 0;  // tiles warp, warp + CNW, ..

  auto issue = [&](int i) {  // the warp's i-th tile into stage i % STAGES
    bf16* ks = reinterpret_cast<bf16*>(wbase + (i % STAGES) * STAGE);
    bf16* vs = ks + KV;
    int* ms = reinterpret_cast<int*>(vs + KV);
    const int key0 = it.lo + (warp + i * CNW) * TK;
    for (int c = lane; c < TK * D / 8; c += 32) {
      const int r = c / (D / 8), cc = c % (D / 8) * 8;
      const bool ok = key0 + r < it.hi;
      const long off = base + (long)(ok ? key0 + r : it.lo) * D + cc;
      cp_async16(ks + r * LD + cc, k + off, ok ? 16 : 0);
      cp_async16(vs + r * LD + cc, v + off, ok ? 16 : 0);
    }
    if (lane < TK) {
      const bool ok = key0 + lane < it.hi;
      cp_async4(ms + lane, mrow + (ok ? key0 + lane : it.lo), ok ? 4 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    if (i < n_mine) issue(i);
    cp_async_commit();
  }

  // Q as the A operand, k-step s: row gq (beam), d 16 s + 2t.. and 16 s + 2t + 8..
  uint32_t qa[D / 16][2];
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    const bf16* qr = q + (((long)it.e * g + gq) * H + it.h) * D + 16 * s + 2 * t;
    qa[s][0] = gq < g ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
    qa[s][1] = gq < g ? *reinterpret_cast<const uint32_t*>(qr + 8) : 0u;
  }
  float o[D / 8][4];  // O: n-tile j holds d 8j .. 8j + 7 (rows 8..15 stay 0)
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;  // row gq's running max; this lane's share of its sum

  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const bf16* ks = reinterpret_cast<const bf16*>(wbase + (i % STAGES) * STAGE);
    const bf16* vs = ks + KV;
    const int* ms = reinterpret_cast<const int*>(vs + KV);
    const int key0 = it.lo + (warp + i * CNW) * TK;
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};  // keys 0-7, 8-15
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      uint32_t b[4];
      load_b(b, ks, LD, 0, 16 * s);
      const uint32_t a[4] = {qa[s][0], 0u, qa[s][1], 0u};
      mma(s0, a, b[0], b[1]);
      mma(s1, a, b[2], b[3]);
    }
    float x[4] = {s0[0], s0[1], s1[0], s1[1]};  // keys 2t, 2t + 1, 8 + 2t, 9 + 2t
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = 2 * t + (j & 1) + 8 * (j >> 1);
      // a masked key scores -1e9; past the chunk's keys, no key at all
      x[j] = key0 + kk >= it.hi ? -CUDART_INF_F : ms[kk] > 0 ? x[j] : -1e9f;
    }
    float mt = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt), a = rescale(m, m_new);  // key0 is a key: mt is finite
    float p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = expf(x[j] - m_new);
    l = l * a + ((p[0] + p[1]) + (p[2] + p[3]));
    m = m_new;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= a;
      o[j][1] *= a;
    }
    const uint32_t h0 = pack(p[0], p[1]), h2 = pack(p[2], p[3]);
    const float2 f0 = unpack(h0), f2 = unpack(h2);
    const uint32_t ph[4] = {h0, 0u, h2, 0u};
    const uint32_t pl[4] = {pack(p[0] - f0.x, p[1] - f0.y), 0u, pack(p[2] - f2.x, p[3] - f2.y),
                            0u};
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t b[4];
      load_b_kn(b, vs, LD, 0, 16 * j);
      mma(o[2 * j], ph, b[0], b[1]);
      mma(o[2 * j], pl, b[0], b[1]);
      mma(o[2 * j + 1], ph, b[2], b[3]);
      mma(o[2 * j + 1], pl, b[2], b[3]);
    }
    __syncwarp();
    if (i + STAGES < n_mine) issue(i + STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warp's state over its own ring: g maxima, g sums, g x D accumulators
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* mine = reinterpret_cast<float*>(wbase);
  if (gq < g) {
    if (t == 0) {
      mine[gq] = m;
      mine[g + gq] = l;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      mine[2 * g + gq * D + 8 * j + 2 * t] = o[j][0];
      mine[2 * g + gq * D + 8 * j + 2 * t + 1] = o[j][1];
    }
  }
  __syncthreads();
  cross_finish<bf16>(reinterpret_cast<const float*>(smem), STAGES * STAGE / 4, it, part, arrived,
                     out, H, D, g);
}

bool bad_width(int D) { return D < VEC || D > MAXD || D % VEC; }

template <int D>
int launch_cross_tc(const void* q, const void* k, const void* v, const int* mask, const int* live,
                    void* out, float* part, int* arrived, int B0, int g, int H, int Lk, int blocks,
                    cudaStream_t s) {
  constexpr size_t bytes = (size_t)CNW * STAGES * tc_stage_bytes<D>();
  static const cudaError_t allowed = cudaFuncSetAttribute(
      decode_cross_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (allowed != 0) return (int)allowed;
  using bf = __nv_bfloat16;
  decode_cross_tc_kernel<D><<<blocks, CNT, bytes, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), mask, live,
      static_cast<bf*>(out), part, arrived, B0, H, Lk, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cross(const void* q, const void* k, const void* v, const int* mask, const int* live,
                 void* out, float* part, int* arrived, int B0, int g, int H, int Lk, int D,
                 int blocks, cudaStream_t s) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  T* o = static_cast<T*>(out);
  if (g <= 1)
    decode_cross_kernel<T, 1><<<blocks, CNT, 0, s>>>(qt, kt, vt, mask, live, o, part, arrived,
                                                     B0, H, Lk, D, g);
  else if (g <= 2)
    decode_cross_kernel<T, 2><<<blocks, CNT, 0, s>>>(qt, kt, vt, mask, live, o, part, arrived,
                                                     B0, H, Lk, D, g);
  else if (g <= 4)
    decode_cross_kernel<T, 4><<<blocks, CNT, 0, s>>>(qt, kt, vt, mask, live, o, part, arrived,
                                                     B0, H, Lk, D, g);
  else
    decode_cross_kernel<T, 8><<<blocks, CNT, 0, s>>>(qt, kt, vt, mask, live, o, part, arrived,
                                                     B0, H, Lk, D, g);
  return (int)cudaGetLastError();
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
// int32, live [B0] int32: each example's keys up to its last unmasked one, all Lk
// where it has none (a value outside [1, Lk] counts as Lk); all contiguous, k / v
// 16-byte aligned; 1 <= g <= 8; D a multiple of 8, at most 128. blocks >= B0 * H;
// part holds blocks * g * (D + 2) floats and arrived B0 * H ints that are 0 (the
// kernel leaves them 0 again).
extern "C" int decode_cross_attention(const void* q, const void* k, const void* v,
                                      const void* key_mask, const void* live, void* out,
                                      void* part, void* arrived, int B0, int g, int H, int Lk,
                                      int D, int blocks, int dtype, void* stream) {
  if (B0 <= 0 || H <= 0 || Lk <= 0 || g < 1 || g > MAXG || bad_width(D) ||
      (long)blocks < (long)B0 * H || part == nullptr || arrived == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(key_mask);
  const int* lv = static_cast<const int*>(live);
  float* p = static_cast<float*>(part);
  int* a = static_cast<int*>(arrived);
  if (dtype == VC_DTYPE_F32)
    return launch_cross<float>(q, k, v, m, lv, out, p, a, B0, g, H, Lk, D, blocks, s);
  if (dtype != VC_DTYPE_BF16) return (int)cudaErrorInvalidValue;
  if (D == 64) return launch_cross_tc<64>(q, k, v, m, lv, out, p, a, B0, g, H, Lk, blocks, s);
  if (D == 128) return launch_cross_tc<128>(q, k, v, m, lv, out, p, a, B0, g, H, Lk, blocks, s);
  return launch_cross<__nv_bfloat16>(q, k, v, m, lv, out, p, a, B0, g, H, Lk, D, blocks, s);
}
