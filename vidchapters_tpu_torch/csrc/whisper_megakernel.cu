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
//   kernel holds it. The attention probabilities are rounded to T before p.v
//   (normalised first in the cross-attention), as the plain version rounds
//   them. The kernel returns the hidden state before the final LayerNorm and
//   the new k/v rows; the final LayerNorm and the logits stay outside.
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
// bytes, ~0.78 ms at 8 rows and ~1.17 ms at 8 examples x 5 beams at 3.35
// TB/s. The arithmetic (~2 x rows x 0.73 G multiply-adds) is far below the
// tensor cores' rate.
//
// Design: one persistent grid of one 512-thread block per SM (a cooperative
// launch), 9 phases a layer with a grid barrier after each (q|k|v, self-
// attention, self out, cross q, cross scores, cross p.v, cross out, fc1,
// fc2).
//
// Products, norms and the grid barrier are persistent_step.cuh's (shared
// with the T5 decode kernel): each weight read once per step for up to 48
// rows on the tensor cores (the weight [out, in] is the mma's A operand), the
// LayerNorm's row statistics combined from the residual's tile statistics.
// An L2 prefetch of the next product's weights before each grid barrier (or
// at the start of a phase) was measured and dropped: it slowed the phase that
// issued it more than it sped the next (PERF.md). The V rows of the
// cross-attention are prefetched into L2 by the scores phase.
//
// Self-attention: (row, head) units, wpu warps to a unit (chosen on the host);
// lane groups hold 16 bytes of a key row, the unit's warps split the keys,
// scores go to shared memory, the unit's max is taken over all of them before
// the probabilities (rounded to T) meet V, and the warps' sums merge in warp
// order. The current token (row idx, written by the q|k|v phase) joins as an
// extra online-softmax row.
//
// Cross-attention: (example, head, key range) block items, nb key ranges to
// an (example, head); the block's warps split the range into chunks. Scores
// phase: lane groups hold 16 bytes of a K row (int8: 4 lanes a 64-byte row,
// 8 keys a warp-wide load), the k-scale folded into q; scores for the g beams
// go to a scratch buffer with each range's max and sum, the beams a loop
// over each batch of loaded keys. p.v phase: the example's max and sum over
// all ranges (in range order), probabilities exp(s - max) / sum rounded to
// T, then p.v: with one beam a lane group holds 16 bytes of a V row (as the
// scores read K), with several a lane holds 4 elements of a V row for every
// beam; the warps merge in warp order, the ranges in range order (the last
// block to arrive, a counter it resets), and the v-scale multiplies the
// context. No float atomics anywhere: every sum is taken in a fixed order,
// so results do not vary from run to run.

#include "persistent_step.cuh"

namespace {

using namespace vc::step;

constexpr int GMAX = 8;     // beams per example
constexpr int DMAX = 128;   // widest head
constexpr int NBMAX = 16;   // most key ranges of one (example, head)
constexpr int SU = 4;       // key rows a lane loads before it uses any
constexpr int SUV = 8;      // V pieces a lane loads before it uses any
constexpr int SUW = 8;      // V rows a lane loads before it uses any, one beam
constexpr int PHASES = 9;   // grid barriers a layer
constexpr float NEG = -1e9f;

struct Plans {
  ProdPlan prod[6];  // wqkv, wo_self, wq_cross, wo_cross, wi, wo_ff
  int rp;            // rows of one product pass: a multiple of 8, at most RMAX
  int wpu;           // self-attention: warps of one (row, head)
  int nb;            // cross-attention: key ranges of one (example, head)
  int pk;            // cross-attention: most keys of one warp
};

// Byte offsets into the workspace, and the counters after the grid barrier's.
struct Layout {
  size_t xs, qs, cx, ff, tst, part, sc, cst, cpart, total;
  int cnt_cross, n_counters;
};

inline bool make_plans(int B, int d, int inner, int H, int dff, int group, int lenc, int idx,
                       int esize, int G, Plans& pl) {
  const int outs[6] = {3 * inner, d, inner, d, dff, d};
  const int ins[6] = {d, inner, d, inner, d, dff};
  bool ok = false;
  for (pl.rp = ((B < RMAX ? B : RMAX) + 7) & ~7; pl.rp > 0 && !ok; pl.rp -= 8) {
    ok = true;
    for (int m = 0; m < 6; ++m)
      ok = ok && plan_product(outs[m], ins[m], pl.rp, esize, m % 2 == 0, G, pl.prod[m]);
    if (ok) break;
  }
  if (!ok) return false;
  // self-attention: fewest rounds of units, then the fewest key batches a warp
  const int U = B * H, keys = idx > 0 ? idx : 1;
  long best = -1;
  for (int wpu = NW; wpu >= 1; wpu >>= 1) {
    const long cost = (long)cdiv(U, G * (NW / wpu)) * (2 * cdiv(cdiv(keys, wpu), 16) + 3);
    if (best < 0 || cost < best) {
      best = cost;
      pl.wpu = wpu;
    }
  }
  // cross-attention: key ranges of an (example, head) against rounds of items
  const int units = (B / group) * H;
  best = -1;
  for (int nb = 1; nb <= NBMAX && nb <= lenc; ++nb) {
    const long cost = (long)cdiv(units * nb, G) * (cdiv(cdiv(lenc, nb), NW * 32) + 2);
    if (best < 0 || cost < best) {
      best = cost;
      pl.nb = nb;
    }
  }
  pl.pk = cdiv(cdiv(lenc, pl.nb), NW);
  return true;
}

inline Layout make_layout(int B, int d, int inner, int H, int dff, int group, int lenc,
                          int esize, const Plans& pl) {
  Layout o;
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off = align16(off + bytes);
    return at;
  };
  o.xs = take((size_t)B * d * esize);
  o.qs = take((size_t)B * inner * esize);
  o.cx = take((size_t)B * inner * esize);
  o.ff = take((size_t)B * dff * esize);
  o.tst = take((size_t)cdiv(d, TILE) * B * 8);
  size_t pmax = 0;
  int tmax = 0;
  for (int m = 0; m < 6; ++m) {
    const ProdPlan& p = pl.prod[m];
    if ((size_t)p.tiles * p.S * TILE * pl.rp > pmax) pmax = (size_t)p.tiles * p.S * TILE * pl.rp;
    if (p.tiles > tmax) tmax = p.tiles;
  }
  o.part = take(pmax * 4);
  const int units = (B / group) * H;
  o.sc = take((size_t)B * H * lenc * 4);
  o.cst = take((size_t)units * pl.nb * group * 8);
  o.cpart = take((size_t)units * pl.nb * group * (inner / H) * 4);
  o.total = off;
  o.cnt_cross = 1 + tmax;
  o.n_counters = 1 + tmax + units;
  return o;
}

// Shared memory of each phase kind; the kernel takes the largest.
inline size_t smem_bytes(const Plans& pl, int inner, int H, int L, int group, int esize) {
  size_t prod = 0;
  for (int m = 0; m < 6; ++m) {
    const size_t b = prod_smem(pl.rp, pl.prod[m].kch, esize, m % 2 == 0);
    if (b > prod) prod = b;
  }
  const int dkv = inner / H, upb = NW / pl.wpu;
  const size_t self_b = 16 + 4 * ((size_t)upb * dkv + (size_t)upb * L + NW * dkv + NW + 2 * upb);
  const size_t cross_a = 16 + 4 * ((size_t)GMAX * DMAX + NW * GMAX * 2 + (size_t)NW * GMAX * pl.pk);
  const size_t cross_b = 16 + 8 * GMAX + 4 * ((size_t)NW * GMAX * pl.pk + (size_t)NW * group * dkv);
  size_t s = prod;
  if (self_b > s) s = self_b;
  if (cross_a > s) s = cross_a;
  if (cross_b > s) s = cross_b;
  return s;
}

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
  unsigned char* ws;       // workspace, laid out by Layout
  unsigned* bar;           // the grid barrier's arrivals, then the merge counters; zeroed
  unsigned long long* timeline;  // [9 N + 2] %globaltimer ns after each barrier, or null
  int B, N, L, Lp, lenc, d, inner, H, dff, group, idx;
};

// Where a product's finished sums go: q|k|v (q scaled into qs, k / v into
// row idx of the caches and k_new / v_new), the residual (into xs, and
// hidden after the last layer), the cross q (scaled), or fc1 (exact GELU).
enum SinkKind { SINK_QKV, SINK_RESIDUAL, SINK_QCROSS, SINK_GELU };

template <typename T>
struct Sink {
  static constexpr bool kRms = false;    // LayerNorm'd inputs
  int kind;
  const float* bias;  // [n_out] of this layer
  T* out;             // qs, xs or ff
  T* hidden;          // the residual after the last layer, or null
  T* k_att;           // SINK_QKV: the caches' row idx and k_new / v_new of this layer
  T* v_att;
  T* k_new;
  T* v_new;
  float scale;
  int width;          // row width of out
  int inner;
  long cache_stride;  // elements between two rows' cache blocks (N L inner)
  long new_stride;    // and between two rows of k_new (N inner)

  __device__ float eps() const { return 1e-5f; }
  __device__ bool residual() const { return kind == SINK_RESIDUAL; }
  __device__ bool pairs() const { return false; }
  __device__ void pair(int, int, int, float, float) const {}

  // The value written for column o of row r (the residual's, for its tile
  // statistics).
  __device__ float operator()(int r, int o, float acc) const {
    if (kind == SINK_RESIDUAL) {
      T* x = out + (long)r * width + o;
      const float y = vc::rnd<T>(ld_cg(x) + vc::rnd<T>(acc + bias[o]));
      *x = vc::from_f<T>(y);
      if (hidden != nullptr) hidden[(long)r * width + o] = vc::from_f<T>(y);
      return y;
    }
    if (kind == SINK_GELU) {
      const float v = acc + bias[o];
      out[(long)r * width + o] = vc::from_f<T>(0.5f * v * (1.f + erff(v * 0.7071067811865476f)));
      return 0.f;
    }
    const float v = vc::rnd<T>(acc + bias[o]);
    if (kind == SINK_QCROSS || o < inner) {
      out[(long)r * width + o] = vc::from_f<T>(v * scale);
      return 0.f;
    }
    const bool is_k = o < 2 * inner;
    const int c = o - (is_k ? inner : 2 * inner);
    const T tv = vc::from_f<T>(v);
    (is_k ? k_att : v_att)[r * cache_stride + c] = tv;
    (is_k ? k_new : v_new)[r * new_stride + c] = tv;
    return 0.f;
  }
};

// ---- attention ----

// Self-attention of layer `layer` for every (row, head): units of wpu warps.
template <typename T, typename KT>
__device__ void self_attention(const Args<T, KT>& a, const Plans& pl, int layer, const T* qs, T* cx,
                               unsigned char* sm) {
  using V = V16<T>;
  constexpr int E = V::E;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, inner = a.inner, dkv = inner / H, L = a.L, idx = a.idx, U = a.B * H;
  const int wpu = pl.wpu, upb = NW / wpu, sub = warp / wpu, wi = warp % wpu;
  float* sq = reinterpret_cast<float*>(sm + 16);  // [upb][dkv] q
  float* ss = sq + upb * dkv;                     // [upb][L] scores, then probabilities
  float* wacc = ss + upb * L;                     // [NW][dkv]
  float* wden = wacc + NW * dkv;                  // [NW]
  float* msub = wden + NW;                        // [upb] the max over keys < idx
  float* snew = msub + upb;                       // [upb] the current token's score
  const int G = dkv / E;
  int GP = 1;
  while (GP < G) GP <<= 1;
  const int KPL = 32 / GP, slot = lane / GP, c = lane % GP;
  const bool on = c < G;
  const bool copy = a.src != nullptr;
  for (int ub = blockIdx.x; ub * upb < U; ub += gridDim.x) {
    const int unit = ub * upb + sub;
    const bool act = unit < U;
    const int r = act ? unit / H : 0, h = unit % H;
    const int sr = copy ? a.src[r] : r;
    const long in_base = ((long)sr * a.N + layer) * L * inner + h * dkv;
    const long out_base = ((long)r * a.N + layer) * L * inner + h * dkv;
    for (int t = tid; t < upb * dkv; t += NT) {
      const int u = ub * upb + t / dkv;
      if (u < U) sq[t] = ld_cg(qs + (long)(u / H) * inner + (u % H) * dkv + t % dkv);
    }
    __syncthreads();
    const int k_lo = idx * wi / wpu, k_hi = idx * (wi + 1) / wpu;
    const float* sqs = sq + sub * dkv;
    float* sss = ss + sub * L;
    // scores of the warp's keys, K rows copied to the new cache
    if (act) {
      float qf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) qf[e] = on ? sqs[c * E + e] : 0.f;
      for (int base = k_lo; base < k_hi; base += KPL * SU) {
        V kr[SU];
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int key = base + u * KPL + slot;
          kr[u].u = make_uint4(0u, 0u, 0u, 0u);
          if (on && key < k_hi) {
            kr[u].u = ld16(a.k_in + in_base + (long)key * inner + c * E);
            if (copy) *reinterpret_cast<uint4*>(a.k_att + out_base + (long)key * inner + c * E) = kr[u].u;
            if ((c * E * (int)sizeof(T)) % 128 == 0) prefetch_l2(a.v_in + in_base + (long)key * inner + c * E);
          }
        }
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int key = base + u * KPL + slot;
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qf[e], kr[u].at(e), dot);
          for (int o = GP >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (c == 0 && key < k_hi) sss[key] = dot;
        }
      }
    }
    __syncthreads();
    // the max over all keys < idx, then the warp's probabilities (rounded to T)
    float den = 0.f, m = NEG;
    if (act && idx > 0) {
      float mx = -CUDART_INF_F;
      for (int l = lane; l < idx; l += 32) mx = fmaxf(mx, sss[l]);
      m = vc::warp_max(mx);
    }
    __syncthreads();  // every warp of the unit has its max before any score is overwritten
    if (act && idx > 0) {
      for (int l = k_lo + lane; l < k_hi; l += 32) {
        const float ev = expf(sss[l] - m);
        den += ev;
        sss[l] = vc::rnd<T>(ev);
      }
      den = vc::warp_sum(den);
    }
    if (lane == 0) {
      wden[warp] = den;
      if (wi == 0) msub[sub] = m;
    }
    __syncwarp();
    // p.v of the warp's keys, V rows copied to the new cache
    if (act) {
      float acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.f;
      for (int base = k_lo; base < k_hi; base += KPL * SU) {
        V vr[SU];
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int key = base + u * KPL + slot;
          vr[u].u = make_uint4(0u, 0u, 0u, 0u);
          if (on && key < k_hi) {
            vr[u].u = ld16(a.v_in + in_base + (long)key * inner + c * E);
            if (copy) *reinterpret_cast<uint4*>(a.v_att + out_base + (long)key * inner + c * E) = vr[u].u;
          }
        }
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int key = base + u * KPL + slot;
          if (key < k_hi) {
            const float p = sss[key];
#pragma unroll
            for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vr[u].at(e), acc[e]);
          }
        }
      }
      for (int o = GP; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
      if (slot == 0 && on)
#pragma unroll
        for (int e = 0; e < E; ++e) wacc[warp * dkv + c * E + e] = acc[e];
      if (wi == 0) {  // the current token (row idx, written by the q|k|v phase)
        const long cur = ((long)r * a.N + layer) * L * inner + (long)idx * inner + h * dkv;
        float pr = 0.f;
        for (int t = lane; t < dkv; t += 32) pr += vc::rnd<T>(sqs[t] * ld_cg(a.k_att + cur + t));
        pr = vc::warp_sum(pr);
        if (lane == 0) snew[sub] = pr;
      }
    }
    __syncthreads();
    for (int t = tid; t < upb * dkv; t += NT) {
      const int su = t / dkv, dd = t % dkv, u = ub * upb + su;
      if (u >= U) continue;
      float acc = 0.f, dn = 0.f;
      for (int w = su * wpu; w < (su + 1) * wpu; ++w) {
        acc += wacc[w * dkv + dd];
        dn += wden[w];
      }
      const float mm = msub[su], s_new = snew[su];
      const float m2 = fmaxf(mm, s_new), sc = expf(mm - m2), e_new = expf(s_new - m2);
      const int ru = u / H, hu = u % H;
      const long cur = ((long)ru * a.N + layer) * L * inner + (long)idx * inner + hu * dkv;
      const float vn = ld_cg(a.v_att + cur + dd);
      cx[(long)ru * inner + hu * dkv + dd] = vc::from_f<T>((acc * sc + e_new * vn) / (dn * sc + e_new));
    }
    __syncthreads();
  }
}

// The (example, head, key range) of cross-attention item `it`.
struct CrossItem {
  int eh, part, e, h, kb, ke;
  __device__ CrossItem(int it, int nb, int H, int lenc) {
    eh = it / nb;
    part = it % nb;
    e = eh / H;
    h = eh % H;
    kb = (int)((long)lenc * part / nb);
    ke = (int)((long)lenc * (part + 1) / nb);
  }
};

// Cross-attention scores: s [eh][g][lenc] and each key range's (max, sum).
// A lane group holds 16 bytes of a K row (int8: 4 lanes a 64-byte row, 8
// keys a warp-wide load); the beams are a loop, so each key batch's loads
// serve all of them. The warp's scores go to shared memory, then to the
// scratch buffer and into the warp's (max, sum) for each beam.
template <bool QUANT, typename T, typename KT>
__device__ void cross_scores(const Args<T, KT>& a, const Plans& pl, int layer,
                                          const T* qs, float* sc, float2* cst, unsigned char* sm) {
  using V = V16<KT>;
  constexpr int E = V::E;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = a.group, H = a.H, inner = a.inner, dkv = inner / H, lenc = a.lenc, nb = pl.nb;
  const int pk = pl.pk;
  float* sq = reinterpret_cast<float*>(sm + 16);              // [g][dkv]
  float2* wst = reinterpret_cast<float2*>(sq + GMAX * DMAX);  // [NW][GMAX]
  float* sw = reinterpret_cast<float*>(wst + NW * GMAX);      // [NW][GMAX][pk] scores
  const int G = dkv / E;
  int GP = 1;
  while (GP < G) GP <<= 1;
  const int KPL = 32 / GP, slot = lane / GP, c = lane % GP;
  const bool on = c < G;
  const int units = (a.B / g) * H * nb;
  float* sww = sw + warp * GMAX * pk;
  for (int it = blockIdx.x; it < units; it += gridDim.x) {
    const CrossItem ci(it, nb, H, lenc);
    const int n = ci.ke - ci.kb;
    const int wk0 = ci.kb + n * warp / NW, wk1 = ci.kb + n * (warp + 1) / NW, nk = wk1 - wk0;
    const long kv_base = ((long)ci.e * a.N + layer) * a.Lp * inner + ci.h * dkv;
    const long s_base = ((long)ci.e * a.N + layer) * inner + ci.h * dkv;
    for (int t = tid; t < g * dkv; t += NT) {
      const int j = t / dkv, dd = t % dkv;
      float qv = ld_cg(qs + (long)(ci.e * g + j) * inner + ci.h * dkv + dd);
      // int8 K: the per-lane k-scale folds into q (in T) before the product
      if (QUANT) qv = vc::rnd<T>(qv * vc::rnd<T>(a.kxs[s_base + dd]));
      sq[t] = qv;
    }
    __syncthreads();
    for (int base = wk0; base < wk1; base += KPL * SU) {
      V kr[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int key = base + u * KPL + slot;
        kr[u].u = make_uint4(0u, 0u, 0u, 0u);
        if (on && key < wk1) kr[u].u = ld16(a.kx + kv_base + (long)key * inner + c * E);
      }
      float kf[SU][E];
#pragma unroll
      for (int u = 0; u < SU; ++u)
#pragma unroll
        for (int e = 0; e < E; ++e) kf[u][e] = kr[u].at(e);
#pragma unroll 1
      for (int j = 0; j < g; ++j) {
        float qf[E];
#pragma unroll
        for (int e = 0; e < E; ++e) qf[e] = on ? sq[j * dkv + c * E + e] : 0.f;
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qf[e], kf[u][e], dot);
          for (int o = GP >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          const int key = base + u * KPL + slot;
          if (c == 0 && key < wk1) sww[j * pk + (key - wk0)] = dot;
        }
      }
    }
    __syncwarp();
    // the warp's scores to the scratch buffer, and its (max, sum) per beam
#pragma unroll 1
    for (int j = 0; j < g; ++j) {
      float mx = -CUDART_INF_F;
      for (int k = lane; k < nk; k += 32) {
        const float v = sww[j * pk + k];
        sc[((long)ci.eh * g + j) * lenc + wk0 + k] = v;
        mx = fmaxf(mx, v);
      }
      mx = vc::warp_max(mx);
      float sum = 0.f;
      if (mx != -CUDART_INF_F)
        for (int k = lane; k < nk; k += 32) sum += expf(sww[j * pk + k] - mx);
      sum = vc::warp_sum(sum);
      if (lane == 0) wst[warp * GMAX + j] = make_float2(mx, sum);
    }
    // the V rows of this item, for the p.v phase
    for (int k = ci.kb + tid; k < ci.ke; k += NT) prefetch_l2(a.vx + kv_base + (long)k * inner);
    __syncthreads();
    if (tid < g) {  // the block's warps in warp order
      float bm = -CUDART_INF_F, bl = 0.f;
      for (int w = 0; w < NW; ++w) {
        const float2 st = wst[w * GMAX + tid];
        const float mn = fmaxf(bm, st.x);
        bl = bl * rescale(bm, mn) + st.y * rescale(st.x, mn);
        bm = mn;
      }
      cst[((long)ci.eh * nb + ci.part) * g + tid] = make_float2(bm, bl);
    }
    __syncthreads();
  }
}

// Cross-attention p.v: probabilities from the scores and the ranges' (max,
// sum), rounded to T; the context rounded to T into cx.
template <bool QUANT, typename T, typename KT>
__device__ void cross_pv(const Args<T, KT>& a, const Plans& pl, int layer, const float* sc,
                         const float2* cst, float* cpart, unsigned* cnt, T* cx, unsigned char* sm) {
  using V = V4<KT>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = a.group, H = a.H, inner = a.inner, dkv = inner / H, lenc = a.lenc, nb = pl.nb;
  const int pk = pl.pk;
  int* flag = reinterpret_cast<int*>(sm);
  float2* ms = reinterpret_cast<float2*>(sm + 16);       // [GMAX] the example's (max, sum)
  float* ps = reinterpret_cast<float*>(ms + GMAX);        // [NW][GMAX][pk]
  float* wacc = ps + NW * GMAX * pk;                      // [NW][g][dkv]
  const int LP = dkv / 4;
  int GP = 1;
  while (GP < LP) GP <<= 1;
  const int KPV = 32 / GP, slot = lane / GP, c = lane % GP;
  const bool on = c < LP;
  const int units = (a.B / g) * H * nb;
  for (int it = blockIdx.x; it < units; it += gridDim.x) {
    const CrossItem ci(it, nb, H, lenc);
    const int n = ci.ke - ci.kb;
    const int wk0 = ci.kb + n * warp / NW, wk1 = ci.kb + n * (warp + 1) / NW;
    const long kv_base = ((long)ci.e * a.N + layer) * a.Lp * inner + ci.h * dkv;
    const long s_base = ((long)ci.e * a.N + layer) * inner + ci.h * dkv;
    if (tid < g) {
      float bm = -CUDART_INF_F, bl = 0.f;
      for (int q = 0; q < nb; ++q) bm = fmaxf(bm, __ldcg(cst + ((long)ci.eh * nb + q) * g + tid).x);
      for (int q = 0; q < nb; ++q) {
        const float2 st = __ldcg(cst + ((long)ci.eh * nb + q) * g + tid);
        bl += st.y * rescale(st.x, bm);
      }
      ms[tid] = make_float2(bm, bl);
    }
    __syncthreads();
    float* pw = ps + warp * GMAX * pk;
    for (int j = 0; j < g; ++j) {
      const float* sj = sc + ((long)ci.eh * g + j) * lenc;
      for (int k0 = wk0 + lane; k0 < wk1; k0 += 4 * 32) {  // 4 scores a lane in flight
        float sv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) sv[q] = k0 + 32 * q < wk1 ? __ldcg(sj + k0 + 32 * q) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k0 + 32 * q < wk1)
            pw[j * pk + (k0 + 32 * q - wk0)] = vc::rnd<T>(expf(sv[q] - ms[j].x) / ms[j].y);
      }
    }
    __syncwarp();
    if (g == 1) {
      // one beam: a lane group holds 16 bytes of a V row, as the scores read K
      using W = V16<KT>;
      constexpr int E = W::E;
      const int G1 = dkv / E;
      int GP1 = 1;
      while (GP1 < G1) GP1 <<= 1;
      const int KPL = 32 / GP1, slot1 = lane / GP1, c1 = lane % GP1;
      const bool on1 = c1 < G1;
      float acc1[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc1[e] = 0.f;
      for (int base = wk0; base < wk1; base += KPL * SUW) {
        W vr[SUW];
#pragma unroll
        for (int u = 0; u < SUW; ++u) {
          const int key = base + u * KPL + slot1;
          vr[u].u = make_uint4(0u, 0u, 0u, 0u);
          if (on1 && key < wk1) vr[u].u = ld16(a.vx + kv_base + (long)key * inner + c1 * E);
        }
#pragma unroll
        for (int u = 0; u < SUW; ++u) {
          const int key = base + u * KPL + slot1;
          if (key < wk1) {
            const float pv = pw[key - wk0];
#pragma unroll
            for (int e = 0; e < E; ++e) acc1[e] = fmaf(pv, vr[u].at(e), acc1[e]);
          }
        }
      }
      for (int o = GP1; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < E; ++e) acc1[e] += __shfl_xor_sync(0xffffffffu, acc1[e], o);
      if (slot1 == 0 && on1)
#pragma unroll
        for (int e = 0; e < E; ++e) wacc[warp * dkv + c1 * E + e] = acc1[e];
    } else {
      float acc[GMAX][4];
#pragma unroll
      for (int j = 0; j < GMAX; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int base = wk0; base < wk1; base += KPV * SUV) {
        V vr[SUV];
#pragma unroll
        for (int u = 0; u < SUV; ++u) {
          const int key = base + u * KPV + slot;
          if (on && key < wk1) vr[u].load(a.vx + kv_base + (long)key * inner + c * 4);
        }
#pragma unroll
        for (int u = 0; u < SUV; ++u) {
          const int key = base + u * KPV + slot;
          if (on && key < wk1) {
#pragma unroll
            for (int j = 0; j < GMAX; ++j) {
              if (j < g) {
                const float p = pw[j * pk + (key - wk0)];
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(p, vr[u].at(e), acc[j][e]);
              }
            }
          }
        }
      }
      for (int o = GP; o < 32; o <<= 1)
#pragma unroll
        for (int j = 0; j < GMAX; ++j)
          if (j < g)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
      if (slot == 0 && on)
#pragma unroll
        for (int j = 0; j < GMAX; ++j)
          if (j < g)
#pragma unroll
            for (int e = 0; e < 4; ++e) wacc[(warp * g + j) * dkv + c * 4 + e] = acc[j][e];
    }
    __syncthreads();
    // int8 V: the per-lane v-scale multiplies the context after the product
    auto finish = [&](int t, float v) {
      const int j = t / dkv, dd = t % dkv;
      if (QUANT) v *= a.vxs[s_base + dd];
      cx[(long)(ci.e * g + j) * inner + ci.h * dkv + dd] = vc::from_f<T>(v);
    };
    float* mine = cpart + ((long)ci.eh * nb + ci.part) * g * dkv;
    for (int t = tid; t < g * dkv; t += NT) {
      const int j = t / dkv, dd = t % dkv;
      float v = 0.f;
      for (int w = 0; w < NW; ++w) v += wacc[(w * g + j) * dkv + dd];
      if (nb == 1) finish(t, v);
      else mine[t] = v;
    }
    if (nb > 1) {
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        const unsigned old = atomicAdd(cnt + ci.eh, 1u);
        flag[0] = old == (unsigned)nb - 1;
        if (old == (unsigned)nb - 1) cnt[ci.eh] = 0u;  // every range has arrived
      }
      __syncthreads();
      if (flag[0]) {
        __threadfence();
        const float* all = cpart + (long)ci.eh * nb * g * dkv;
        for (int t = tid; t < g * dkv; t += NT) {
          float v = 0.f;
          for (int q = 0; q < nb; ++q) v += __ldcg(all + (long)q * g * dkv + t);
          finish(t, v);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, typename KT, bool QUANT>
__global__ void __launch_bounds__(NT, 1) whisper_mega_kernel(Args<T, KT> a, Plans pl, Layout lo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, N = a.N, L = a.L, d = a.d, inner = a.inner, dff = a.dff;
  const int dkv = inner / a.H, idx = a.idx;
  const float scale = (float)(1.0 / sqrt((double)dkv));
  T* xs = reinterpret_cast<T*>(a.ws + lo.xs);        // [B, d] residual
  T* qs = reinterpret_cast<T*>(a.ws + lo.qs);        // [B, inner] q, pre-scaled
  T* cx = reinterpret_cast<T*>(a.ws + lo.cx);        // [B, inner] attention context
  T* ff = reinterpret_cast<T*>(a.ws + lo.ff);        // [B, dff] FF hidden
  float2* tst = reinterpret_cast<float2*>(a.ws + lo.tst);  // [d / 16][B] residual tile stats
  float* part = reinterpret_cast<float*>(a.ws + lo.part);
  float* sc = reinterpret_cast<float*>(a.ws + lo.sc);
  float2* cst = reinterpret_cast<float2*>(a.ws + lo.cst);
  float* cpart = reinterpret_cast<float*>(a.ws + lo.cpart);
  unsigned* cnt = a.bar + 1;
  unsigned* ccnt = a.bar + lo.cnt_cross;
  const long wsz[6] = {3L * inner * d, (long)d * inner, (long)inner * d, (long)d * inner,
                       (long)dff * d, (long)d * dff};
  const long bsz[6] = {3L * inner, d, inner, d, dff, d};
  auto weight = [&](int m, int layer) { return a.w[m] + layer * wsz[m]; };

  mark(a.timeline, 0);
  // set-up: the residual and its tile statistics for the first LayerNorm
  const int ntd = cdiv(d, TILE);
  for (int it = blockIdx.x * NT + threadIdx.x; it < ntd * B; it += gridDim.x * NT) {
    const int tile = it / B, r = it % B, o0 = tile * TILE, ncols = min(TILE, d - o0);
    float y[TILE], m = 0.f;
    for (int c = 0; c < ncols; ++c) {
      y[c] = vc::to_f(a.x[(long)r * d + o0 + c]);
      xs[(long)r * d + o0 + c] = a.x[(long)r * d + o0 + c];
      m += y[c];
    }
    m /= (float)ncols;
    float m2 = 0.f;
    for (int c = 0; c < ncols; ++c) m2 += (y[c] - m) * (y[c] - m);
    tst[(long)tile * B + r] = make_float2(m, m2);
  }
  GridBarrier bar(a.bar);
  bar.sync();
  mark(a.timeline, 1);
  auto phase_end = [&](int layer, int p) {
    bar.sync();
    mark(a.timeline, 2 + PHASES * layer + p);
  };
  Sink<T> sk;
  sk.scale = scale;
  sk.inner = inner;
  sk.cache_stride = (long)N * L * inner;
  sk.new_stride = (long)N * inner;
  auto sink = [&](int kind, const float* bias, T* out, int width, T* hidden) {
    sk.kind = kind;
    sk.bias = bias;
    sk.out = out;
    sk.width = width;
    sk.hidden = hidden;
    return sk;
  };

  // The 9 phases of a layer: the six products (m 0..5: q|k|v, self out,
  // cross q, cross out, fc1, fc2) go through one call site, so the kernel
  // holds one copy of their code.
  constexpr int kProduct[PHASES] = {0, -1, 1, 2, -1, -1, 3, 4, 5};
  for (int layer = 0; layer < N; ++layer) {
    const bool last = layer == N - 1;
    const float* lns = a.ln_s + (long)layer * 3 * d;
    const float* lnb = a.ln_b + (long)layer * 3 * d;
    for (int ph = 0; ph < PHASES; ++ph) {
      const int m = kProduct[ph];
      if (ph == 1) {
        self_attention(a, pl, layer, qs, cx, smem);
      } else if (ph == 4) {
        cross_scores<QUANT>(a, pl, layer, qs, sc, cst, smem);
      } else if (ph == 5) {
        cross_pv<QUANT>(a, pl, layer, sc, cst, cpart, ccnt, cx, smem);
      } else {
        // m: input (K, LayerNorm row or none) and sink
        const int K = m == 5 ? dff : (m == 1 || m == 3) ? inner : d;
        const int n_out = m == 0 ? 3 * inner : m == 2 ? inner : m == 4 ? dff : d;
        const T* src = m == 5 ? ff : (m == 1 || m == 3) ? cx : xs;
        const int ln = m == 0 ? 0 : m == 2 ? 1 : m == 4 ? 2 : -1;  // LayerNorm row
        const int kind = m == 0 ? SINK_QKV : m == 2 ? SINK_QCROSS : m == 4 ? SINK_GELU
                                                                            : SINK_RESIDUAL;
        T* out = m == 0 || m == 2 ? qs : m == 4 ? ff : xs;
        sk.k_att = a.k_att + ((long)layer * L + idx) * inner;
        sk.v_att = a.v_att + ((long)layer * L + idx) * inner;
        sk.k_new = a.k_new + (long)layer * inner;
        sk.v_new = a.v_new + (long)layer * inner;
        product(pl.prod[m], pl.rp, B, weight(m, layer), n_out, K, src,
                ln < 0 ? nullptr : lns + ln * d, ln < 0 ? nullptr : lnb + ln * d, smem, part, cnt,
                tst, bar,
                sink(kind, a.b[m] + layer * bsz[m], out, m == 0 ? inner : n_out,
                     m == 5 && last ? a.hidden : nullptr));
      }
      if (ph < PHASES - 1 || !last || a.timeline != nullptr) phase_end(layer, ph);
    }
  }
}

template <typename T, typename KT, bool QUANT>
int launch(Args<T, KT>& a, cudaStream_t stream) {
  int sms = 0;
  const int rc = sm_count(sms);
  if (rc != 0) return rc;
  Plans pl;
  if (!make_plans(a.B, a.d, a.inner, a.H, a.dff, a.group, a.lenc, a.idx, (int)sizeof(T), sms, pl))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(pl, a.inner, a.H, a.L, a.group, (int)sizeof(T));
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const Layout lo = make_layout(a.B, a.d, a.inner, a.H, a.dff, a.group, a.lenc, (int)sizeof(T), pl);
  return launch_cooperative(whisper_mega_kernel<T, KT, QUANT>, smem, stream, a, pl, lo);
}

template <typename T, typename KT, bool QUANT>
int fill_and_launch(void* const* p, const int* n, cudaStream_t stream) {
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
  a.ws = static_cast<unsigned char*>(p[27]);
  a.bar = static_cast<unsigned*>(p[28]);
  a.timeline = static_cast<unsigned long long*>(p[29]);
  a.B = n[0]; a.N = n[1]; a.L = n[2]; a.Lp = n[3]; a.lenc = n[4]; a.d = n[5];
  a.inner = n[6]; a.H = n[7]; a.dff = n[8]; a.group = n[9]; a.idx = n[10];
  return launch<T, KT, QUANT>(a, stream);
}

bool bad_shape(int B, int L, int Lp, int lenc, int d, int inner, int H, int dff, int group, int idx) {
  return group < 1 || group > GMAX || B < 1 || B % group != 0 || H < 1 || inner % H != 0 ||
         (inner / H) % 16 != 0 || inner / H > DMAX || d % 8 != 0 || dff % 8 != 0 || idx < 0 ||
         idx >= L || lenc < 1 || lenc > Lp;
}

}  // namespace

// The workspace a step needs at these shapes on the current device: its size
// in 4-byte words (counters 0), or the number of uint32 counters of `bar`
// (counters 1), which the caller zeroes; -1 for shapes the kernel does not take.
extern "C" int whisper_mega_workspace(int B, int L, int Lp, int lenc, int d, int inner, int H,
                                      int dff, int group, int dtype, int counters) {
  if (bad_shape(B, L, Lp, lenc, d, inner, H, dff, group, 0) ||
      (dtype != VC_DTYPE_F32 && dtype != VC_DTYPE_BF16))
    return -1;
  const int esize = dtype == VC_DTYPE_F32 ? 4 : 2;
  int sms = 0;
  if (sm_count(sms) != 0) return -1;
  Plans pl;
  if (!make_plans(B, d, inner, H, dff, group, lenc, 0, esize, sms, pl)) return -1;
  const Layout lo = make_layout(B, d, inner, H, dff, group, lenc, esize, pl);
  return counters ? lo.n_counters : (int)(lo.total / 4);
}

// Shapes as in Args; all contiguous. kx / vx are int8 with float32 scales when
// quant is 1, else of the working type with null scales. With src == null,
// k_att / v_att must be k_in / v_in. ws and bar as whisper_mega_workspace
// sizes them (bar zeroed). timeline: null, or 9 N + 2 uint64 slots.
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
  if (bad_shape(B, L, Lp, lenc, d, inner, H, dff, group, idx) || N < 1 ||
      (quant && (kxs == nullptr || vxs == nullptr)))
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
    return quant ? fill_and_launch<bf16, signed char, true>(p, n, s)
                 : fill_and_launch<bf16, bf16, false>(p, n, s);
  return (int)cudaErrorInvalidValue;
}

// n grid barriers and nothing else, on the step's grid (bar: a zeroed uint32;
// timeline: n + 1 uint64 slots): what the step's barriers cost alone.
extern "C" int whisper_mega_barriers(void* bar, void* timeline, int n, void* stream) {
  if (n < 0 || bar == nullptr || timeline == nullptr) return (int)cudaErrorInvalidValue;
  return launch_cooperative(barrier_kernel, 0, static_cast<cudaStream_t>(stream),
                            static_cast<unsigned*>(bar),
                            static_cast<unsigned long long*>(timeline), n);
}
