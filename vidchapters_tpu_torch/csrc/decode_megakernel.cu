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
//   feed-forward (relu, or gated tanh-GELU times linear).
// A final RMSNorm ends the step. Every product accumulates in fp32 and is
// rounded to the working type where the TPU kernel rounds it: after each
// weight product, each norm and each residual add, so the residual stream
// holds the working type through the step, as the TPU kernel's does. The
// attention probabilities are not rounded.
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
// of the live encoder keys and the live self-cache rows, and write the
// permuted rows: bytes, ~0.25 ms at 3.35 TB/s. The arithmetic (a few
// GFLOP) is far below the card's rate.
//
// Design: one persistent grid of one 512-thread block per SM (a cooperative
// launch) holds every row of every example; 8 phases a layer with a grid
// barrier after each (q|k|v, self-attention, self out, cross q,
// cross-attention, cross out, wi, wo_ff), then the final RMSNorm.
//
// Products: persistent_step.cuh's, on weights in the kernel layout [N, out,
// in] (made once on the host, with_kernel_layout): each weight read once a
// step for up to 48 rows, on the tensor cores in bf16 (fp32: CUDA cores in
// the same item layout), output tiles spread over the grid, small products
// split over k and merged in split order by the last block to arrive. The
// RMSNorm statistics come from the residual's tile statistics, written by
// the phase that adds to the residual. Gated feed-forward: the kernel layout
// interleaves wi's gate and linear halves 8 columns at a time, so each
// 16-column tile of the product holds 8 gate columns and their 8 linear
// columns, and its merge writes gelu_tanh(gate) * linear.
//
// Self-attention: (row, head) units, wpu warps to a unit (chosen on the
// host); each warp makes one pass over its share of the keys < idx with its
// own online softmax, a lane group holding 16 bytes of a key's K row and of
// its V row, loaded together; the unit's warps merge in warp order, and the
// current token (row idx, written by the q|k|v phase) joins the merge. With
// src, the unit reads its head's slice of rows < idx from row src[r] of the
// input caches once and writes it to the new caches as it attends to it: the
// beam copy costs no pass of its own.
//
// Cross-attention: one flash-decoding pass. Items are (example, head, key
// chunk) over each example's live keys (up to its last unmasked key), the
// chunk the shortest (64 to 512 keys) that gives every item a block of its
// own, from the live keys of the whole batch; the example's beams share
// every K/V row read. The block's warps split the chunk: scores for every
// beam into shared memory (the V rows prefetched into L2 meanwhile), the
// warp's max and sum per beam, then p.v with a lane holding 4 elements of a
// V row for every beam. The warps' states merge in warp order, the chunks'
// in chunk order (by the last block to arrive, a counter it resets). Masked
// keys are skipped: they would get
// probability exactly 0, as they do in the plain version, unless no key of
// the example is unmasked, when every key scores -1e9 and all are attended,
// as there.
//
// No float atomics anywhere: every sum is taken in a fixed order, so results
// do not vary from run to run. The grid barrier and the merge counters are
// left at 0, so a CUDA graph can replay the launch.

#include "persistent_step.cuh"

namespace {

using namespace vc::step;

constexpr int GMAX = 8;     // beams per example
constexpr int DMAX = 128;   // widest head
constexpr int CHMIN = 64;   // fewest keys of a cross-attention chunk
constexpr int CHMAX = 512;  // most keys of a cross-attention chunk (32 a warp)
constexpr int SU = 4;       // key rows a lane loads before it uses any
constexpr int SUV = 8;      // V pieces a lane loads before it uses any
constexpr int PHASES = 8;   // grid barriers a layer
constexpr float NEG = -1e9f;

struct Plans {
  ProdPlan prod[6];  // wqkv, wo_self, wq_cross, wo_cross, wi, wo_ff
  int rp;            // rows of one product pass: a multiple of 8, at most RMAX
  int wpu;           // self-attention: warps of one (row, head)
};

// Byte offsets into the workspace, and the counters after the grid barrier's.
struct Layout {
  size_t xs, qs, cx, ff, tst, part, live, cst, cpart, total;
  int cnt_cross, n_counters;
  size_t keep;  // shared memory: the phases' part ends here, the cross-attention's items follow
};

__host__ __device__ inline size_t self_smem(int upb, int dkv) {
  return 16 + 4 * (3 * (size_t)upb * dkv + NW * dkv + 2 * NW + upb);
}

__host__ __device__ inline size_t cross_smem(int group, int dkv) {
  return 16 + 4 * ((size_t)GMAX * DMAX + (size_t)NW * GMAX * 2 + (size_t)NW * GMAX * (CHMAX / NW) +
                   (size_t)NW * group * dkv);
}

inline bool make_plans(int B, int d, int inner, int H, int dff, int gated, int idx, int esize,
                       int G, Plans& pl) {
  const int outs[6] = {3 * inner, d, inner, d, gated ? 2 * dff : dff, d};
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
    const long cost = (long)cdiv(U, G * (NW / wpu)) * (cdiv(cdiv(keys, wpu), 16) + 2);
    if (best < 0 || cost < best) {
      best = cost;
      pl.wpu = wpu;
    }
  }
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
  const int b0 = B / group, units = b0 * H, parts = cdiv(lenc, CHMIN);
  o.live = take((size_t)b0 * 8);
  o.cst = take((size_t)units * parts * group * 8);
  o.cpart = take((size_t)units * parts * group * (inner / H) * 4);
  o.total = off;
  o.cnt_cross = 1 + tmax;
  o.n_counters = 1 + tmax + units;
  return o;
}

// Shared memory of each phase kind; the kernel takes the largest, and the
// cross-attention's items after it.
inline size_t smem_bytes(const Plans& pl, int inner, int H, int group, int esize) {
  size_t s = 0;
  for (int m = 0; m < 6; ++m) {
    const size_t b = prod_smem(pl.rp, pl.prod[m].kch, esize, m % 2 == 0);
    if (b > s) s = b;
  }
  const int dkv = inner / H;
  const size_t sa = self_smem(NW / pl.wpu, dkv), ca = cross_smem(group, dkv);
  if (sa > s) s = sa;
  if (ca > s) s = ca;
  return s;
}

template <typename T>
struct Args {
  const T* x;            // [B, d]
  const float* ln;       // [N, 3, d]
  const T* w[6];         // kernel layout: wqkv [N,3i,d], wo_self [N,d,i], wq_cross [N,i,d],
                         // wo_cross [N,d,i], wi [N,dff,d] or [N,2dff,d] interleaved, wo_ff [N,d,dff]
  const float* final_ln; // [d]
  const T* k_in;         // [B, N, L, inner]
  const T* v_in;
  T* k_att;              // caches that receive rows <= idx: the new pair, or k_in / v_in
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
  unsigned char* ws;     // workspace, laid out by Layout
  unsigned* bar;         // the grid barrier's arrivals, then the merge counters; 0, left 0
  unsigned long long* timeline;  // [8 N + 3] %globaltimer ns after each barrier, or null
  int B, N, L, lenc, d, inner, H, dff, gated, group, idx;
  float eps;
};

// Where a product's finished sums go: q|k|v (q into qs, k / v into row idx
// of the caches and k_new / v_new), the residual (into xs), the cross q, wi
// (relu), or the gated wi (pairs of gate and linear columns).
enum SinkKind { SINK_QKV, SINK_RESIDUAL, SINK_Q, SINK_RELU, SINK_GATED };

template <typename T>
struct Sink {
  static constexpr bool kRms = true;  // RMSNorm'd inputs
  float norm_eps;
  int kind;
  T* out;             // qs, xs or ff
  T* k_att;           // SINK_QKV: the caches' row idx and k_new / v_new of this layer
  T* v_att;
  T* k_new;
  T* v_new;
  int width;          // row width of out
  int inner;
  long cache_stride;  // elements between two rows' cache blocks (N L inner)
  long new_stride;    // and between two rows of k_new (N inner)

  __device__ float eps() const { return norm_eps; }
  __device__ bool residual() const { return kind == SINK_RESIDUAL; }
  __device__ bool pairs() const { return kind == SINK_GATED; }

  // The value written for column o of row r (the residual's, for its tile
  // statistics; the gated product's, for its pairs).
  __device__ float operator()(int r, int o, float acc) const {
    const float v = vc::rnd<T>(acc);
    if (kind == SINK_RESIDUAL) {
      T* x = out + (long)r * width + o;
      const float y = vc::rnd<T>(ld_cg(x) + v);
      *x = vc::from_f<T>(y);
      return y;
    }
    if (kind == SINK_GATED) return v;
    if (kind == SINK_RELU) {
      out[(long)r * width + o] = vc::from_f<T>(fmaxf(v, 0.f));
      return 0.f;
    }
    if (kind == SINK_Q || o < inner) {
      out[(long)r * width + o] = vc::from_f<T>(v);
      return 0.f;
    }
    const bool is_k = o < 2 * inner;
    const int c = o - (is_k ? inner : 2 * inner);
    const T tv = vc::from_f<T>(v);
    (is_k ? k_att : v_att)[r * cache_stride + c] = tv;
    (is_k ? k_new : v_new)[r * new_stride + c] = tv;
    return 0.f;
  }

  // Gated: column c of a tile is gate column 8 tile + c, column c + 8 its
  // linear column; the FF hidden is rnd(gelu_tanh(gate) * linear).
  __device__ void pair(int r, int tile, int c, float gate, float lin) const {
    const float act = 0.5f * gate *
                      (1.f + tanhf(0.7978845608028654f * (gate + 0.044715f * gate * gate * gate)));
    out[(long)r * width + (TILE / 2) * tile + c] = vc::from_f<T>(act * lin);
  }
};

// Self-attention of layer `layer` for every (row, head): units of wpu warps,
// each warp one pass over its share of the keys < idx with its own online
// softmax: a lane group holds 16 bytes of a K row and of the V row of the same
// key, loaded together (with src, from row src[r] of the input caches, and
// written to the new caches as they are used). The unit's warps and the
// current token (row idx, written by the q|k|v phase) merge in warp order.
template <typename T>
__device__ void self_attention(const Args<T>& a, const Plans& pl, int layer, const T* qs, T* cx,
                               unsigned char* sm) {
  using V = V16<T>;
  constexpr int E = V::E;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, inner = a.inner, dkv = inner / H, L = a.L, idx = a.idx, U = a.B * H;
  const int wpu = pl.wpu, upb = NW / wpu, sub = warp / wpu, wi = warp % wpu;
  float* sq = reinterpret_cast<float*>(sm + 16);  // [upb][dkv] q
  float* skn = sq + upb * dkv;                    // [upb][dkv] the current token's k
  float* svn = skn + upb * dkv;                   // [upb][dkv] and v
  float* wacc = svn + upb * dkv;                  // [NW][dkv] the warps' unnormalised contexts
  float2* wst = reinterpret_cast<float2*>(wacc + NW * dkv);  // [NW] (max, sum)
  float* snew = reinterpret_cast<float*>(wst + NW);          // [upb] the current token's score
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
      if (u >= U) continue;
      const long cur = ((long)(u / H) * a.N + layer) * L * inner + (long)idx * inner +
                       (u % H) * dkv + t % dkv;
      sq[t] = ld_cg(qs + (long)(u / H) * inner + (u % H) * dkv + t % dkv);
      skn[t] = ld_cg(a.k_att + cur);
      svn[t] = ld_cg(a.v_att + cur);
    }
    __syncthreads();
    const int k_lo = idx * wi / wpu, k_hi = idx * (wi + 1) / wpu;
    const float* sqs = sq + sub * dkv;
    float m = -CUDART_INF_F, den = 0.f, acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    if (act) {
      float qf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) qf[e] = on ? sqs[c * E + e] : 0.f;
      for (int base = k_lo; base < k_hi; base += KPL * SU) {
        V kr[SU], vr[SU];
        float bias[SU];
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int key = base + u * KPL + slot;
          kr[u].u = vr[u].u = make_uint4(0u, 0u, 0u, 0u);
          bias[u] = key < k_hi ? __ldg(a.bias_row + (long)key * H + h) : 0.f;
          if (on && key < k_hi) {
            const long off = (long)key * inner + c * E;
            kr[u].u = ld16(a.k_in + in_base + off);
            vr[u].u = ld16(a.v_in + in_base + off);
          }
        }
        if (copy) {
#pragma unroll
          for (int u = 0; u < SU; ++u) {
            const int key = base + u * KPL + slot;
            if (on && key < k_hi) {
              const long off = (long)key * inner + c * E;
              *reinterpret_cast<uint4*>(a.k_att + out_base + off) = kr[u].u;
              *reinterpret_cast<uint4*>(a.v_att + out_base + off) = vr[u].u;
            }
          }
        }
        float sc[SU], bmax = -CUDART_INF_F;
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int key = base + u * KPL + slot;
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qf[e], kr[u].at(e), dot);
          for (int o = GP >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          sc[u] = key < k_hi ? dot + bias[u] : -CUDART_INF_F;
          bmax = fmaxf(bmax, sc[u]);
        }
        const float mn = fmaxf(m, vc::warp_max(bmax));
        const float f = rescale(m, mn);
        den *= f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] *= f;
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const float p = sc[u] == -CUDART_INF_F ? 0.f : expf(sc[u] - mn);
          if (c == 0) den += p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vr[u].at(e), acc[e]);
        }
        m = mn;
      }
      for (int o = GP; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
      den = vc::warp_sum(den);
      if (slot == 0 && on)
#pragma unroll
        for (int e = 0; e < E; ++e) wacc[warp * dkv + c * E + e] = acc[e];
      if (lane == 0) wst[warp] = make_float2(m, den);
      if (wi == 0) {  // the current token (row idx, written by the q|k|v phase)
        float pr = 0.f;
        for (int t = lane; t < dkv; t += 32) pr = fmaf(sqs[t], skn[sub * dkv + t], pr);
        pr = vc::warp_sum(pr);
        if (lane == 0) snew[sub] = pr + a.bias0[h];
      }
    }
    __syncthreads();
    for (int t = tid; t < upb * dkv; t += NT) {
      const int su = t / dkv, dd = t % dkv, u = ub * upb + su;
      if (u >= U) continue;
      const float s_new = snew[su];
      float mx = s_new;
      for (int w = su * wpu; w < (su + 1) * wpu; ++w) mx = fmaxf(mx, wst[w].x);
      const int ru = u / H, hu = u % H;
      const float e_new = expf(s_new - mx);
      float num = e_new * svn[t], dn = e_new;
      for (int w = su * wpu; w < (su + 1) * wpu; ++w) {
        const float f = rescale(wst[w].x, mx);
        num += wacc[w * dkv + dd] * f;
        dn += wst[w].y * f;
      }
      cx[(long)ru * inner + hu * dkv + dd] = vc::from_f<T>(num / dn);
    }
    __syncthreads();
  }
}

// The cross-attention's items, set once a launch after the set-up in a
// region of shared memory that no phase touches: lv [b0] each example's live
// keys (live, from the set-up), first [b0 + 2] each example's first item, the
// item count and the key chunk: the smallest multiple of 32 in [CHMIN,
// CHMAX] that gives every (example, head, chunk) item a block of its own,
// else CHMAX (warp 0's lanes try one chunk each).
__device__ void cross_items(const int2* live, int b0, int H, int2* lv, int* first) {
  for (int e = threadIdx.x; e < b0; e += NT) lv[e] = make_int2(__ldcg(&live[e].x), __ldcg(&live[e].y));
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, cand = CHMIN + 32 * lane;
    int items = 0;
    if (cand < CHMAX)
      for (int e = 0; e < b0; ++e) items += cdiv(lv[e].x, cand) * H;
    int chunk = cand < CHMAX && items <= (int)gridDim.x ? cand : CHMAX;
    for (int o = 16; o > 0; o >>= 1) chunk = min(chunk, __shfl_xor_sync(0xffffffffu, chunk, o));
    if (lane == 0) {
      first[0] = 0;
      for (int e = 0; e < b0; ++e) first[e + 1] = first[e] + cdiv(lv[e].x, chunk) * H;
      first[b0 + 1] = chunk;
    }
  }
  __syncthreads();
}

// Cross-attention of layer `layer`, one pass: items are (example, head, key
// chunk) over each example's live keys, lv[e] = (end of the live keys,
// whether any key is unmasked), as cross_items set them. Partial softmax states (max, sum, unnormalised
// context) merge in warp order, then in chunk order by the last block of the
// (example, head) to arrive; the context is rounded to T.
template <typename T>
__device__ void cross_attention(const Args<T>& a, int layer, const T* qs, const int2* lv,
                                const int* first, float2* cst, float* cpart, unsigned* cnt, T* cx,
                                unsigned char* sm) {
  using V = V16<T>;
  using W = V4<T>;
  constexpr int E = V::E;
  constexpr int PK = CHMAX / NW;  // most keys of one warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = a.group, H = a.H, inner = a.inner, dkv = inner / H, lenc = a.lenc;
  const int b0 = a.B / g, pmax = cdiv(lenc, CHMIN);
  int* flag = reinterpret_cast<int*>(sm);
  float* sq = reinterpret_cast<float*>(sm + 16);              // [g][dkv] q
  float2* wst = reinterpret_cast<float2*>(sq + GMAX * DMAX);  // [NW][GMAX] (max, sum)
  float* sw = reinterpret_cast<float*>(wst + NW * GMAX);      // [NW][GMAX][PK] scores, then p
  float* wacc = sw + NW * GMAX * PK;                          // [NW][g][dkv]
  // scores: a lane group holds 16 bytes of a K row
  const int G = dkv / E;
  int GP = 1;
  while (GP < G) GP <<= 1;
  const int KPL = 32 / GP, slot = lane / GP, c = lane % GP;
  const bool on = c < G;
  // p.v: a lane holds 4 elements of a V row, for every beam
  const int LP = dkv / 4;
  int GV = 1;
  while (GV < LP) GV <<= 1;
  const int KPV = 32 / GV, vslot = lane / GV, vc4 = lane % GV;
  const bool von = vc4 < LP;
  const int items = first[b0], chunk = first[b0 + 1];
  float* sww = sw + warp * GMAX * PK;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    // the item's example, head and chunk
    int e = 0;
    while (it >= first[e + 1]) ++e;
    const int nch = cdiv(lv[e].x, chunk), rest = it - first[e];
    const int h = rest / nch, part = rest % nch, eh = e * H + h;
    const bool any = lv[e].y != 0;
    const int kb = part * chunk, ke = min(lv[e].x, kb + chunk), n = ke - kb;
    const int wk0 = kb + n * warp / NW, wk1 = kb + n * (warp + 1) / NW, nk = wk1 - wk0;
    const long kv_base = ((long)e * a.N + layer) * lenc * inner + h * dkv;
    // the warp's keys (at most 32): lane l holds the mask of key wk0 + l
    const int mreg = lane < nk ? __ldg(a.enc_mask + (long)e * lenc + wk0 + lane) : 0;
    for (int t = tid; t < g * dkv; t += NT)
      sq[t] = ld_cg(qs + (long)(e * g + t / dkv) * inner + h * dkv + t % dkv);
    __syncthreads();
    // scores of the warp's keys for every beam: -inf for a skipped key
    for (int base = wk0; base < wk1; base += KPL * SU) {
      V kr[SU];
      bool kept[SU], unmasked[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int key = base + u * KPL + slot;
        unmasked[u] = __shfl_sync(0xffffffffu, mreg, min(key - wk0, 31)) > 0 && key < wk1;
        kept[u] = key < wk1 && (unmasked[u] || !any);
        kr[u].u = make_uint4(0u, 0u, 0u, 0u);
        if (on && unmasked[u]) {
          kr[u].u = ld16(a.kx + kv_base + (long)key * inner + c * E);
          // the V row's slice into L2 for the p.v below
          if ((c * E * (int)sizeof(T)) % 128 == 0) prefetch_l2(a.vx + kv_base + (long)key * inner + c * E);
        }
      }
      float kf[SU][E];
#pragma unroll
      for (int u = 0; u < SU; ++u)
#pragma unroll
        for (int q = 0; q < E; ++q) kf[u][q] = kr[u].at(q);
#pragma unroll 1
      for (int j = 0; j < g; ++j) {
        float qf[E];
#pragma unroll
        for (int q = 0; q < E; ++q) qf[q] = on ? sq[j * dkv + c * E + q] : 0.f;
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int q = 0; q < E; ++q) dot = fmaf(qf[q], kf[u][q], dot);
          for (int o = GP >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          const int key = base + u * KPL + slot;
          if (c == 0 && key < wk1)
            sww[j * PK + (key - wk0)] = !kept[u] ? -CUDART_INF_F : unmasked[u] ? dot : NEG;
        }
      }
    }
    __syncwarp();
    // the warp's max and sum per beam; the scores become exp(s - max)
#pragma unroll 1
    for (int j = 0; j < g; ++j) {
      float mx = -CUDART_INF_F;
      for (int k = lane; k < nk; k += 32) mx = fmaxf(mx, sww[j * PK + k]);
      mx = vc::warp_max(mx);
      float sum = 0.f;
      for (int k = lane; k < nk; k += 32) {
        const float p = mx == -CUDART_INF_F ? 0.f : expf(sww[j * PK + k] - mx);
        sww[j * PK + k] = p;
        sum += p;
      }
      sum = vc::warp_sum(sum);
      if (lane == 0) wst[warp * GMAX + j] = make_float2(mx, sum);
    }
    __syncwarp();
    // p.v of the warp's keys for every beam
    float acc[GMAX][4];
#pragma unroll
    for (int j = 0; j < GMAX; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int base = wk0; base < wk1; base += KPV * SUV) {
      W vr[SUV];
      bool kept[SUV];
#pragma unroll
      for (int u = 0; u < SUV; ++u) {
        const int key = base + u * KPV + vslot;
        const bool unmasked = __shfl_sync(0xffffffffu, mreg, min(key - wk0, 31)) > 0;
        kept[u] = von && key < wk1 && (!any || unmasked);
        if (kept[u]) vr[u].load(a.vx + kv_base + (long)key * inner + vc4 * 4);
      }
#pragma unroll
      for (int u = 0; u < SUV; ++u) {
        if (kept[u]) {
          const int key = base + u * KPV + vslot;
#pragma unroll
          for (int j = 0; j < GMAX; ++j) {
            if (j < g) {
              const float p = sww[j * PK + (key - wk0)];
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[j][q] = fmaf(p, vr[u].at(q), acc[j][q]);
            }
          }
        }
      }
    }
    for (int o = GV; o < 32; o <<= 1)
#pragma unroll
      for (int j = 0; j < GMAX; ++j)
        if (j < g)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][q] += __shfl_xor_sync(0xffffffffu, acc[j][q], o);
    if (vslot == 0 && von)
#pragma unroll
      for (int j = 0; j < GMAX; ++j)
        if (j < g)
#pragma unroll
          for (int q = 0; q < 4; ++q) wacc[(warp * g + j) * dkv + vc4 * 4 + q] = acc[j][q];
    __syncthreads();
    // the block's state per beam: the warps merged in warp order
    float* mine = cpart + ((long)eh * pmax + part) * g * dkv;
    float2* mst = cst + ((long)eh * pmax + part) * g;
    for (int t = tid; t < g * dkv; t += NT) {
      const int j = t / dkv, dd = t % dkv;
      float bm = -CUDART_INF_F;
      for (int w = 0; w < NW; ++w) bm = fmaxf(bm, wst[w * GMAX + j].x);
      float num = 0.f, den = 0.f;
      for (int w = 0; w < NW; ++w) {
        const float2 st = wst[w * GMAX + j];
        const float f = rescale(st.x, bm);
        num += wacc[(w * g + j) * dkv + dd] * f;
        den += st.y * f;
      }
      if (nch == 1) {
        cx[(long)(e * g + j) * inner + h * dkv + dd] = vc::from_f<T>(num / den);
      } else {
        mine[t] = num;
        if (dd == 0) mst[j] = make_float2(bm, den);
      }
    }
    if (nch > 1) {
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        const unsigned old = atomicAdd(cnt + eh, 1u);
        flag[0] = old == (unsigned)nch - 1;
        if (old == (unsigned)nch - 1) cnt[eh] = 0u;  // every chunk has arrived
      }
      __syncthreads();
      if (flag[0]) {
        __threadfence();
        const float* all = cpart + (long)eh * pmax * g * dkv;
        const float2* sts = cst + (long)eh * pmax * g;
        for (int t = tid; t < g * dkv; t += NT) {
          const int j = t / dkv;
          float m = -CUDART_INF_F;
          for (int q = 0; q < nch; ++q) m = fmaxf(m, __ldcg(&sts[q * g + j].x));
          float num = 0.f, den = 0.f;
          for (int q = 0; q < nch; ++q) {
            const float f = rescale(__ldcg(&sts[q * g + j].x), m);
            num += __ldcg(all + (long)q * g * dkv + t) * f;
            den += __ldcg(&sts[q * g + j].y) * f;
          }
          cx[(long)(e * g + j) * inner + h * dkv + t % dkv] = vc::from_f<T>(num / den);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) mega_decode_kernel(Args<T> a, Plans pl, Layout lo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, N = a.N, L = a.L, d = a.d, inner = a.inner, dff = a.dff, idx = a.idx;
  T* xs = reinterpret_cast<T*>(a.ws + lo.xs);        // [B, d] residual
  T* qs = reinterpret_cast<T*>(a.ws + lo.qs);        // [B, inner] q
  T* cx = reinterpret_cast<T*>(a.ws + lo.cx);        // [B, inner] attention context
  T* ff = reinterpret_cast<T*>(a.ws + lo.ff);        // [B, dff] FF hidden
  float2* tst = reinterpret_cast<float2*>(a.ws + lo.tst);  // [d / 16][B] residual tile stats
  float* part = reinterpret_cast<float*>(a.ws + lo.part);
  int2* live = reinterpret_cast<int2*>(a.ws + lo.live);    // [B0] (live end, any unmasked)
  float2* cst = reinterpret_cast<float2*>(a.ws + lo.cst);
  float* cpart = reinterpret_cast<float*>(a.ws + lo.cpart);
  unsigned* cnt = a.bar + 1;
  unsigned* ccnt = a.bar + lo.cnt_cross;
  const int outs[6] = {3 * inner, d, inner, d, a.gated ? 2 * dff : dff, d};
  const int ins[6] = {d, inner, d, inner, d, dff};

  mark(a.timeline, 0);
  // set-up: the residual and its tile statistics for the first RMSNorm, and
  // each example's live keys
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
  {
    int* wmax = reinterpret_cast<int*>(smem);
    for (int e = blockIdx.x; e < B / a.group; e += gridDim.x) {
      int last = 0;
      for (int k = threadIdx.x; k < a.lenc; k += NT)
        if (a.enc_mask[(long)e * a.lenc + k] > 0) last = k + 1;
      for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
      if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = last;
      __syncthreads();
      if (threadIdx.x == 0) {
        int end = 0;
        for (int w = 0; w < NW; ++w) end = max(end, wmax[w]);
        live[e] = end > 0 ? make_int2(end, 1) : make_int2(a.lenc, 0);
      }
      __syncthreads();
    }
  }
  GridBarrier bar(a.bar);
  bar.sync();
  int2* clv = reinterpret_cast<int2*>(smem + lo.keep);  // the cross-attention's items
  int* cfirst = reinterpret_cast<int*>(clv + B / a.group);
  cross_items(live, B / a.group, a.H, clv, cfirst);
  mark(a.timeline, 1);

  Sink<T> sk;
  sk.norm_eps = a.eps;
  sk.inner = inner;
  sk.cache_stride = (long)N * L * inner;
  sk.new_stride = (long)N * inner;
  // The 8 phases of a layer: the six products (m 0..5: q|k|v, self out,
  // cross q, cross out, wi, wo_ff) go through one call site, so the kernel
  // holds one copy of their code.
  constexpr int kProduct[PHASES] = {0, -1, 1, 2, -1, 3, 4, 5};
  for (int layer = 0; layer < N; ++layer) {
    const float* ln = a.ln + (long)layer * 3 * d;
    for (int ph = 0; ph < PHASES; ++ph) {
      const int m = kProduct[ph];
      if (ph == 1) {
        self_attention(a, pl, layer, qs, cx, smem);
      } else if (ph == 4) {
        cross_attention(a, layer, qs, clv, cfirst, cst, cpart, ccnt, cx, smem);
      } else {
        const T* src = m == 5 ? ff : (m == 1 || m == 3) ? cx : xs;
        const int norm = m == 0 ? 0 : m == 2 ? 1 : m == 4 ? 2 : -1;  // RMSNorm row
        sk.kind = m == 0 ? SINK_QKV : m == 2 ? SINK_Q
                : m == 4 ? (a.gated ? SINK_GATED : SINK_RELU) : SINK_RESIDUAL;
        sk.out = m == 0 || m == 2 ? qs : m == 4 ? ff : xs;
        sk.width = m == 0 ? inner : m == 4 ? dff : outs[m];
        sk.k_att = a.k_att + ((long)layer * L + idx) * inner;
        sk.v_att = a.v_att + ((long)layer * L + idx) * inner;
        sk.k_new = a.k_new + (long)layer * inner;
        sk.v_new = a.v_new + (long)layer * inner;
        product(pl.prod[m], pl.rp, B, a.w[m] + (long)layer * outs[m] * ins[m], outs[m], ins[m],
                src, norm < 0 ? nullptr : ln + norm * d, nullptr, smem, part, cnt, tst, bar, sk);
      }
      bar.sync();
      mark(a.timeline, 2 + PHASES * layer + ph);
    }
  }
  // the final RMSNorm of every row, from the residual's tile statistics
  {
    float2* rs = reinterpret_cast<float2*>(smem);
    const int per = cdiv(B, gridDim.x), r0 = blockIdx.x * per, rows = min(per, B - r0);
    if (rows > 0) {
      row_stats<true>(tst, B, d, r0, rows, a.eps, rs);
      __syncthreads();
      for (int e = threadIdx.x; e < rows * d; e += NT) {
        const int r = e / d, i = e % d;
        const float v = ld_cg(xs + (long)(r0 + r) * d + i);
        a.hidden[(long)(r0 + r) * d + i] = vc::from_f<T>(a.final_ln[i] * (v * rs[r].y));
      }
    }
  }
  if (a.timeline != nullptr) {
    bar.sync();
    mark(a.timeline, 2 + PHASES * N);
  }
  bar.leave();
}

template <typename T>
int launch(Args<T>& a, cudaStream_t stream) {
  int sms = 0;
  const int rc = sm_count(sms);
  if (rc != 0) return rc;
  Plans pl;
  if (!make_plans(a.B, a.d, a.inner, a.H, a.dff, a.gated, a.idx, (int)sizeof(T), sms, pl))
    return (int)cudaErrorInvalidValue;
  Layout lo = make_layout(a.B, a.d, a.inner, a.H, a.dff, a.group, a.lenc, (int)sizeof(T), pl);
  lo.keep = align16(smem_bytes(pl, a.inner, a.H, a.group, (int)sizeof(T)));
  const int b0 = a.B / a.group;
  const size_t smem = lo.keep + 8 * (size_t)b0 + 4 * (size_t)(b0 + 2);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  return launch_cooperative(mega_decode_kernel<T>, smem, stream, a, pl, lo);
}

template <typename T>
int fill_and_launch(void* const* p, const int* n, float eps, cudaStream_t stream) {
  Args<T> a;
  a.x = static_cast<const T*>(p[0]);
  a.ln = static_cast<const float*>(p[1]);
  for (int m = 0; m < 6; ++m) a.w[m] = static_cast<const T*>(p[2 + m]);
  a.final_ln = static_cast<const float*>(p[8]);
  a.k_in = static_cast<const T*>(p[9]);
  a.v_in = static_cast<const T*>(p[10]);
  a.k_att = static_cast<T*>(p[11]);
  a.v_att = static_cast<T*>(p[12]);
  a.kx = static_cast<const T*>(p[13]);
  a.vx = static_cast<const T*>(p[14]);
  a.bias_row = static_cast<const float*>(p[15]);
  a.bias0 = static_cast<const float*>(p[16]);
  a.enc_mask = static_cast<const int*>(p[17]);
  a.src = static_cast<const int*>(p[18]);
  a.hidden = static_cast<T*>(p[19]);
  a.k_new = static_cast<T*>(p[20]);
  a.v_new = static_cast<T*>(p[21]);
  a.ws = static_cast<unsigned char*>(p[22]);
  a.bar = static_cast<unsigned*>(p[23]);
  a.timeline = static_cast<unsigned long long*>(p[24]);
  a.B = n[0]; a.N = n[1]; a.L = n[2]; a.lenc = n[3]; a.d = n[4]; a.inner = n[5];
  a.H = n[6]; a.dff = n[7]; a.gated = n[8]; a.group = n[9]; a.idx = n[10];
  a.eps = eps;
  return launch<T>(a, stream);
}

bool bad_shape(int B, int L, int lenc, int d, int inner, int H, int dff, int group, int idx) {
  return group < 1 || group > GMAX || B < 1 || B % group != 0 || H < 1 || inner % H != 0 ||
         (inner / H) % 8 != 0 || inner / H > DMAX || d % 8 != 0 || inner % 8 != 0 ||
         dff % 8 != 0 || idx < 0 || idx >= L || lenc < 1;
}

}  // namespace

// The workspace a step needs at these shapes on the current device: its size
// in 4-byte words (counters 0), or the number of uint32 counters of `bar`
// (counters 1), which start at 0 and which the kernel leaves at 0; -1 for
// shapes the kernel does not take.
extern "C" int mega_decode_workspace(int B, int L, int lenc, int d, int inner, int H, int dff,
                                     int gated, int group, int dtype, int counters) {
  if (bad_shape(B, L, lenc, d, inner, H, dff, group, 0) ||
      (dtype != VC_DTYPE_F32 && dtype != VC_DTYPE_BF16))
    return -1;
  const int esize = dtype == VC_DTYPE_F32 ? 4 : 2;
  int sms = 0;
  if (sm_count(sms) != 0) return -1;
  Plans pl;
  if (!make_plans(B, d, inner, H, dff, gated, 0, esize, sms, pl)) return -1;
  const Layout lo = make_layout(B, d, inner, H, dff, group, lenc, esize, pl);
  return counters ? lo.n_counters : (int)(lo.total / 4);
}

// Shapes as in Args; all contiguous; the weights in the kernel layout. With
// src == null, k_att / v_att must be k_in / v_in. ws and bar as
// mega_decode_workspace sizes them (bar at 0). timeline: null, or 8 N + 3
// uint64 slots.
extern "C" int mega_decode_step(
    const void* x, const void* ln, const void* wqkv, const void* wo_self, const void* wq_cross,
    const void* wo_cross, const void* wi, const void* wo_ff, const void* final_ln,
    const void* k_in, const void* v_in, void* k_att, void* v_att, const void* kx,
    const void* vx, const void* bias_row, const void* bias0, const void* enc_mask,
    const void* src, void* hidden, void* k_new, void* v_new, void* ws, void* bar,
    void* timeline, int B, int N, int L, int Lenc, int d, int inner, int H, int dff, int gated,
    int group, int idx, float eps, int dtype, void* stream) {
  if (bad_shape(B, L, Lenc, d, inner, H, dff, group, idx) || N < 1)
    return (int)cudaErrorInvalidValue;
  void* const p[25] = {const_cast<void*>(x), const_cast<void*>(ln), const_cast<void*>(wqkv),
                       const_cast<void*>(wo_self), const_cast<void*>(wq_cross),
                       const_cast<void*>(wo_cross), const_cast<void*>(wi),
                       const_cast<void*>(wo_ff), const_cast<void*>(final_ln),
                       const_cast<void*>(k_in), const_cast<void*>(v_in), k_att, v_att,
                       const_cast<void*>(kx), const_cast<void*>(vx),
                       const_cast<void*>(bias_row), const_cast<void*>(bias0),
                       const_cast<void*>(enc_mask), const_cast<void*>(src), hidden, k_new,
                       v_new, ws, bar, timeline};
  const int n[11] = {B, N, L, Lenc, d, inner, H, dff, gated, group, idx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VC_DTYPE_F32) return fill_and_launch<float>(p, n, eps, s);
  if (dtype == VC_DTYPE_BF16) return fill_and_launch<bf16>(p, n, eps, s);
  return (int)cudaErrorInvalidValue;
}

// n grid barriers and nothing else, on the step's grid (bar: a zeroed uint32;
// timeline: n + 1 uint64 slots): what the step's barriers cost alone.
extern "C" int mega_decode_barriers(void* bar, void* timeline, int n, void* stream) {
  if (n < 0 || bar == nullptr || timeline == nullptr) return (int)cudaErrorInvalidValue;
  return launch_cooperative(barrier_kernel, 0, static_cast<cudaStream_t>(stream),
                            static_cast<unsigned*>(bar),
                            static_cast<unsigned long long*>(timeline), n);
}
