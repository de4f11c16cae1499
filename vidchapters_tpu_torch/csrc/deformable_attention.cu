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
//   dv[x0] += attn * w0 * g,  dv[x1] += attn * w1 * g
//
// What bounds it on the H100: a gather of 2 * L * P rows of D floats per
// (n, q, m) and a few operations per element, far below the arithmetic rate;
// the bytes it must move (value, loc, attn read once, out written once) are
// under 1 MB at PDVC's shapes (0.3 us at 3.35 TB/s), so one launch is bound
// by its latency: the number of dependent trips to memory in a warp's path.
//
// Design (the TPU kernel's band matrix times value on the MXU is not carried
// over). One warp per (n, q, m) query row. Lane s of the warp computes the
// taps and weights of sample s (the L * P samples' locations and weights are
// contiguous), so they come from one load each. A row of D floats is G = D/4
// lanes of one float4, in a group of GP lanes (the power of two >= G), and
// the warp's 32 / GP groups gather several samples at once: each lane takes
// its samples' tap rows and weights from the computing lane by __shfl_sync
// and issues every row load of a pass (both taps of up to 16 samples, all
// 32 rows at D 64) before it uses any. A warp thus waits on two trips to
// memory (loc / attn, then the rows), not on one per sample.
//
// The backward does the same gather against g, reduces the (s0, s1) pairs
// of a pass across a group's lanes with one transpose-reduce (each step
// halves the pairs a lane holds, so 2 (GP - 1) shuffles for all of them),
// and hands each pair back to its sample's lane, which writes dloc and
// dattn (contiguous). dvalue takes one of two routes, chosen by size:
//
// - cluster (the slice [S, D] of one (n, m), and its queries' g rows and
//   tap weights fit in shared memory: 73 KB at PDVC's shapes): a
//   thread-block cluster of up to 8 blocks takes one (n, m), each block a
//   chunk of its queries. A warp writes its query's row of W [chunk, S],
//   W[q][x] the sum of attn * w over the query's taps at row x (taps of one
//   row come from one level's lanes and are merged there in lane order by
//   shuffles), and sets bit q of each row it hits. Then each (row, float4)
//   of the block's share W^T G sums only the queries whose bits are set, in
//   ascending order, and is stored into the shared memory of the block that
//   owns the row, at the writer's rank; after one cluster barrier each
//   block sums its rows over the ranks in order and stores them. No memset,
//   no float atomics, every element of dvalue written once, and the same
//   bits on every run. Measured slower on the H100 and dropped: shared-
//   memory float atomics, lane groups that own rows and scan the taps, the
//   dense W^T G, pulling the shares instead of pushing them, 16-block
//   clusters, 24 warps a block; and, 4-7% faster but summed in a varying
//   order, each block's share added into a zeroed dvalue with float4
//   atomics (PERF.md).
// - global (a larger slice): each group adds attn * w * g into dvalue with
//   fp32 atomics as it gathers, into a dvalue that the launch zeroes first
//   (sums in an order that changes from run to run).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_LEVELS = 16;
constexpr int FWD_WARPS = 4;       // warps of a forward block
constexpr int BWD_WARPS = 16;      // most warps of a backward block
constexpr int CLUSTER = 8;         // most blocks of a cluster (portable)
constexpr int SMEM_MAX = 232448;   // the H100's shared memory a block can take

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

// One sample of a query row, as its own lane computes it: the taps as rows of
// the (n, m) slice (level start added), the attention-folded weights, and
// what dloc / dattn need. Past the last sample: weight 0, row 0.
struct Sample {
  int x0, x1;
  float aw0, aw1, w0, w1, a, t;
};

__device__ __forceinline__ Sample sample_of(float loc, float attn, int s, int LP, int P,
                                            const Levels& lv) {
  Sample sm{0, 0, 0.f, 0.f, 0.f, 0.f, 0.f, 1.f};
  if (s < LP) {
    const int l = s / P, t = lv.t[l];
    const Tap tap = lerp_taps(loc, t);
    sm.a = attn;
    sm.x0 = lv.start[l] + tap.x0;
    sm.x1 = lv.start[l] + tap.x1;
    sm.w0 = tap.w0;
    sm.w1 = tap.w1;
    sm.aw0 = attn * tap.w0;
    sm.aw1 = attn * tap.w1;
    sm.t = (float)t;
  }
  return sm;
}

// Sample s's location and weight of the query row whose samples start at s0.
__device__ __forceinline__ float2 sample_in(const float* __restrict__ loc,
                                            const float* __restrict__ attn, long s0, int s,
                                            int LP) {
  return s < LP ? make_float2(__ldg(loc + s0 + s), __ldg(attn + s0 + s)) : make_float2(0.f, 0.f);
}

// The lanes of a warp for a row of D = 4 G floats in groups of GP lanes: NG
// groups a warp, U samples a group a pass, PASS = NG U samples a pass (a
// divisor of 32), and 2 U rows of float4 in flight a lane.
template <int GP> struct Lanes {
  static constexpr int NG = 32 / GP;
  static constexpr int U = GP / 2 < 1 ? 1 : (GP / 2 > 8 ? 8 : GP / 2);
  static constexpr int PASS = NG * U;
};

// The cluster barrier in two halves: arrive at the start, wait before the
// first store into another block's shared memory (which must have started).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float dot4(float4 g, float4 r) {
  return fmaf(g.w, r.w, fmaf(g.z, r.z, fmaf(g.y, r.y, g.x * r.x)));
}

__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

// Sums v over the O * 2 lanes of a group, K pairs at a time: while K > 1 a
// step sends half of the pairs to the partner lane and keeps the other half,
// so after log2(K) steps lane col holds the whole sum of pair col / (2 O / K).
template <int O, int K, int N>
__device__ __forceinline__ void transpose_reduce(float2 (&v)[N], int col) {
  if constexpr (O >= 1) {
    if constexpr (K > 1) {
      constexpr int H = K / 2;
      const bool up = (col & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float2 send = up ? v[i] : v[i + H];
        const float2 keep = up ? v[i + H] : v[i];
        v[i] = make_float2(keep.x + __shfl_xor_sync(FULL, send.x, O),
                           keep.y + __shfl_xor_sync(FULL, send.y, O));
      }
      transpose_reduce<O / 2, H>(v, col);
    } else {
      v[0].x += __shfl_xor_sync(FULL, v[0].x, O);
      v[0].y += __shfl_xor_sync(FULL, v[0].y, O);
      transpose_reduce<O / 2, 1>(v, col);
    }
  }
}

template <int GP>
__global__ void __launch_bounds__(FWD_WARPS * 32)
deform_fwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                  const float* __restrict__ attn, float* __restrict__ out, int N, int S,
                  int Lq, int M, int D, int P, Levels lv) {
  using Ln = Lanes<GP>;
  const int lane = threadIdx.x & 31, grp = lane / GP, col = lane % GP;
  const long w = (long)blockIdx.x * FWD_WARPS + (threadIdx.x >> 5);  // (n, q, m)
  if (w >= (long)N * Lq * M) return;
  const int m = (int)(w % M), n = (int)(w / ((long)Lq * M));
  const int LP = lv.n * P;
  const long row = (long)M * D;
  const float* vbase = value + ((long)n * S * M + m) * D + 4 * col;
  const bool on = 4 * col < D;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc = zero;
  for (int base = 0; base < LP; base += 32) {
    const float2 la = sample_in(loc, attn, w * LP, base + lane, LP);
    const Sample sm = sample_of(la.x, la.y, base + lane, LP, P, lv);
    const int cnt = min(32, LP - base);
    for (int j0 = 0; j0 < cnt; j0 += Ln::PASS) {
      float4 r0[Ln::U], r1[Ln::U];
      float a0[Ln::U], a1[Ln::U];
#pragma unroll
      for (int u = 0; u < Ln::U; ++u) {
        const int src = j0 + grp + Ln::NG * u;
        const int x0 = __shfl_sync(FULL, sm.x0, src), x1 = __shfl_sync(FULL, sm.x1, src);
        a0[u] = __shfl_sync(FULL, sm.aw0, src);
        a1[u] = __shfl_sync(FULL, sm.aw1, src);
        const bool ld = on && src < cnt;
        r0[u] = ld ? ld4(vbase + x0 * row) : zero;
        r1[u] = ld ? ld4(vbase + x1 * row) : zero;
      }
#pragma unroll
      for (int u = 0; u < Ln::U; ++u) acc = axpy4(a1[u], r1[u], axpy4(a0[u], r0[u], acc));
    }
  }
#pragma unroll
  for (int o = 16; o >= GP; o >>= 1) {
    acc.x += __shfl_xor_sync(FULL, acc.x, o);
    acc.y += __shfl_xor_sync(FULL, acc.y, o);
    acc.z += __shfl_xor_sync(FULL, acc.z, o);
    acc.w += __shfl_xor_sync(FULL, acc.w, o);
  }
  if (grp == 0 && on) *reinterpret_cast<float4*>(out + w * D + 4 * col) = acc;
}

struct BwdArgs {
  const float* value;
  const float* loc;
  const float* attn;
  const float* gout;
  float* dvalue;
  float* dloc;
  float* dattn;
  int N, S, Lq, M, D, P, QC;  // QC: queries a block
  Levels lv;
};

// Adds the attention-folded weights of query qi's samples base .. base +
// cnt - 1 (sample base + lane on lane lane) to its row of W, and marks the
// rows it hits in the query bits of each row of the slice. Taps of one row
// come only from samples of one level, which lie on neighbouring lanes:
// each lane sums, over its level's lanes in order, the taps that hit its
// own two rows, and the first tap of a row in (sample, tap) order writes
// the sum. So every entry of W is one sum in a fixed order, and no two
// lanes write one entry.
__device__ __forceinline__ void add_to_w(float* W, unsigned* bits, int S, int words, int qi,
                                         const Sample& sm, int base, int lane, int cnt, int P) {
  const int lvl = (base + lane) / P;
  const int g0 = max(lvl * P - base, 0), g1 = min((lvl + 1) * P - base, cnt);
  float sum0 = 0.f, sum1 = 0.f;
  bool own0 = lane < cnt, own1 = lane < cnt && sm.x1 != sm.x0;
  for (int k = 0; k < min(P, 32); ++k) {
    const int src = min(g0 + k, 31);
    const int ox0 = __shfl_sync(FULL, sm.x0, src), ox1 = __shfl_sync(FULL, sm.x1, src);
    const float oa0 = __shfl_sync(FULL, sm.aw0, src), oa1 = __shfl_sync(FULL, sm.aw1, src);
    if (g0 + k >= g1) continue;
    if (ox0 == sm.x0) sum0 += oa0;
    if (ox1 == sm.x0) sum0 += oa1;
    if (ox0 == sm.x1) sum1 += oa0;
    if (ox1 == sm.x1) sum1 += oa1;
    if (src < lane) {
      own0 = own0 && ox0 != sm.x0 && ox1 != sm.x0;
      own1 = own1 && ox0 != sm.x1 && ox1 != sm.x1;
    }
  }
  // a row's first entry of this query is stored, a later one (a level
  // across two rounds of 32 samples) added
  const unsigned bit = 1u << (qi & 31);
  float* wq = W + (long)qi * S;
  if (own0) {
    const bool seen = atomicOr(bits + sm.x0 * words + (qi >> 5), bit) & bit;
    wq[sm.x0] = seen ? wq[sm.x0] + sum0 : sum0;
  }
  if (own1) {
    const bool seen = atomicOr(bits + sm.x1 * words + (qi >> 5), bit) & bit;
    wq[sm.x1] = seen ? wq[sm.x1] + sum1 : sum1;
  }
}

// The backward of one chunk of QC queries of one (n, m) = (blockIdx.z,
// blockIdx.y), chunk blockIdx.x, a warp a query at a time. CLUSTERED: the
// blocks of a cluster are the chunks of one (n, m), and dvalue is summed in
// shared memory; else it is added to the zeroed dvalue with atomics.
template <int GP, bool CLUSTERED>
__global__ void __launch_bounds__(BWD_WARPS * 32) deform_bwd_kernel(BwdArgs p) {
  using Ln = Lanes<GP>;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int grp = lane / GP, col = lane % GP;
  const int m = blockIdx.y, n = blockIdx.z, S = p.S, D = p.D, M = p.M;
  const int LP = p.lv.n * p.P;
  const int q0 = blockIdx.x * p.QC, nq = max(0, min(p.Lq, q0 + p.QC) - q0);
  const long row = (long)M * D;
  const long slice = ((long)n * S * M + m) * D;  // (n, row 0, m, channel 0)
  const bool on = 4 * col < D;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // shared memory (cluster route): the cluster's shares of its rows of
  // dvalue, recv [ranks][RS][D] (RS = ceil(S / ranks) rows a block) | the
  // chunk's g rows [QC][D] | W [QC][S], W[q][x] the sum of attn * w over
  // the taps of query q at row x (set where bits says) | bits [S][words],
  // bit q of row x set where query q of the chunk hits row x
  const int ranks = CLUSTERED ? (int)gridDim.x : 1, RS = (S + ranks - 1) / ranks;
  const int words = (p.QC + 31) / 32;
  float* recv = smem;
  float* gs = recv + (long)ranks * RS * D;
  float* W = gs + (long)p.QC * D;
  unsigned* bits = reinterpret_cast<unsigned*>(W + (long)p.QC * S);
  if constexpr (CLUSTERED) {
    cluster_arrive();
    for (int i = threadIdx.x; i < S * words; i += blockDim.x) bits[i] = 0u;
    __syncthreads();
  }

  // phase 1: a warp per query: dloc, dattn, and the query's g row and W row.
  // The next query's g and first 32 samples are loaded before this one's
  // rows are gathered.
  auto inputs = [&](int qi, float4& g, float2& la) {
    if (qi < nq) {
      const long w = ((long)n * p.Lq + q0 + qi) * M + m;
      g = on ? ld4(p.gout + w * D + 4 * col) : zero;
      la = sample_in(p.loc, p.attn, w * LP, lane, LP);
    }
  };
  float4 g_next = zero;
  float2 la_next = make_float2(0.f, 0.f);
  inputs(warp, g_next, la_next);
  for (int qi = warp; qi < nq; qi += nwarps) {
    const long w = ((long)n * p.Lq + q0 + qi) * M + m;  // (n, q, m)
    const float4 g = g_next;
    float2 la = la_next;
    inputs(qi + nwarps, g_next, la_next);
    if (CLUSTERED && grp == 0 && on) *reinterpret_cast<float4*>(gs + qi * D + 4 * col) = g;
    for (int base = 0; base < LP; base += 32) {
      if (base > 0) la = sample_in(p.loc, p.attn, w * LP, base + lane, LP);
      const Sample sm = sample_of(la.x, la.y, base + lane, LP, p.P, p.lv);
      const int cnt = min(32, LP - base);
      if constexpr (CLUSTERED) add_to_w(W, bits, S, words, qi, sm, base, lane, cnt, p.P);
      for (int j0 = 0; j0 < cnt; j0 += Ln::PASS) {
        float4 r0[Ln::U], r1[Ln::U];
        int x0[Ln::U], x1[Ln::U];
        float a0[Ln::U], a1[Ln::U];
#pragma unroll
        for (int u = 0; u < Ln::U; ++u) {
          const int src = j0 + grp + Ln::NG * u;
          x0[u] = __shfl_sync(FULL, sm.x0, src);
          x1[u] = __shfl_sync(FULL, sm.x1, src);
          a0[u] = __shfl_sync(FULL, sm.aw0, src);
          a1[u] = __shfl_sync(FULL, sm.aw1, src);
          const bool ld = on && src < cnt;
          r0[u] = ld ? ld4(p.value + slice + x0[u] * row + 4 * col) : zero;
          r1[u] = ld ? ld4(p.value + slice + x1[u] * row + 4 * col) : zero;
        }
        float2 s[Ln::U];
#pragma unroll
        for (int u = 0; u < Ln::U; ++u) s[u] = make_float2(dot4(g, r0[u]), dot4(g, r1[u]));
        if constexpr (!CLUSTERED) {
#pragma unroll
          for (int u = 0; u < Ln::U; ++u) {
            if (!on || j0 + grp + Ln::NG * u >= cnt) continue;
            float* d0 = p.dvalue + slice + x0[u] * row + 4 * col;
            float* d1 = p.dvalue + slice + x1[u] * row + 4 * col;
            atomicAdd(d0, a0[u] * g.x);
            atomicAdd(d0 + 1, a0[u] * g.y);
            atomicAdd(d0 + 2, a0[u] * g.z);
            atomicAdd(d0 + 3, a0[u] * g.w);
            atomicAdd(d1, a1[u] * g.x);
            atomicAdd(d1 + 1, a1[u] * g.y);
            atomicAdd(d1 + 2, a1[u] * g.z);
            atomicAdd(d1 + 3, a1[u] * g.w);
          }
        }
        transpose_reduce<GP / 2, Ln::U>(s, col);
        // lane j0 + r takes sample r's pair: group r % NG, held by its lane
        // (r / NG) * (GP / U)
        const int r = lane - j0;
        const bool mine = r >= 0 && r < Ln::PASS && lane < cnt;
        const int src = mine ? (r % Ln::NG) * GP + (r / Ln::NG) * (GP / Ln::U) : lane;
        const float s0 = __shfl_sync(FULL, s[0].x, src), s1 = __shfl_sync(FULL, s[0].y, src);
        if (mine) {
          const long si = w * LP + base + lane;
          p.dattn[si] = sm.w0 * s0 + sm.w1 * s1;
          p.dloc[si] = sm.t * __fsub_rn(sm.a * s1, sm.a * s0);
        }
      }
    }
  }
  if constexpr (CLUSTERED) {
    __syncthreads();
    // phase 2: the chunk's share of dvalue, W^T G over the entries bits
    // marks, each element summed over the chunk's queries in order, stored
    // into the receive buffer of the block that owns its row (rows
    // [r RS, (r + 1) RS) for rank r), at this block's rank
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank(), quads = D / 4;
    cluster_wait();
    for (int i = threadIdx.x; i < S * quads; i += blockDim.x) {
      const int x = i / quads, c4 = i % quads;
      float4 t = zero;
      for (int wd = 0; wd < words; ++wd) {
        for (unsigned b = bits[x * words + wd]; b; b &= b - 1) {
          const int qi = 32 * wd + __ffs(b) - 1;
          t = axpy4(W[qi * S + x], *reinterpret_cast<const float4*>(gs + qi * D + 4 * c4), t);
        }
      }
      float* dst = recv + ((long)rank * RS + x % RS) * D + 4 * c4;
      *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, x / RS)) = t;
    }
    // phase 3: this block's rows, summed over the cluster's shares in rank
    // order, stored
    cluster.sync();
    const int x_lo = rank * RS, x_hi = min(S, x_lo + RS);
    for (int i = threadIdx.x; i < (x_hi - x_lo) * quads; i += blockDim.x) {
      const int xr = i / quads, c4 = i % quads;
      float4 t = *reinterpret_cast<const float4*>(recv + (long)xr * D + 4 * c4);
      for (int r2 = 1; r2 < ranks; ++r2) {
        const float4 v =
            *reinterpret_cast<const float4*>(recv + ((long)r2 * RS + xr) * D + 4 * c4);
        t = make_float4(t.x + v.x, t.y + v.y, t.z + v.z, t.w + v.w);
      }
      *reinterpret_cast<float4*>(p.dvalue + slice + (x_lo + xr) * row + 4 * c4) = t;
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

// D a multiple of 4 in [4, 128]; value, out, gout and dvalue 16-byte aligned.
bool bad_sizes(int N, int S, int Lq, int M, int D, int P) {
  return N < 1 || S < 1 || Lq < 1 || M < 1 || P < 1 || D < 4 || D > 128 || D % 4 ||
         (long)S * M * D >= (1L << 31);
}

// The lanes of a group for head width D: the power of two >= D / 4.
int group_lanes(int D) {
  int gp = 1;
  while (gp < D / 4) gp <<= 1;
  return gp;
}

void (*fwd_kernel(int gp))(const float*, const float*, const float*, float*, int, int, int, int,
                           int, int, Levels) {
  switch (gp) {
    case 1: return deform_fwd_kernel<1>;
    case 2: return deform_fwd_kernel<2>;
    case 4: return deform_fwd_kernel<4>;
    case 8: return deform_fwd_kernel<8>;
    case 16: return deform_fwd_kernel<16>;
    default: return deform_fwd_kernel<32>;
  }
}

void (*bwd_kernel(int gp, bool clustered))(BwdArgs) {
  switch (gp) {
    case 1: return clustered ? deform_bwd_kernel<1, true> : deform_bwd_kernel<1, false>;
    case 2: return clustered ? deform_bwd_kernel<2, true> : deform_bwd_kernel<2, false>;
    case 4: return clustered ? deform_bwd_kernel<4, true> : deform_bwd_kernel<4, false>;
    case 8: return clustered ? deform_bwd_kernel<8, true> : deform_bwd_kernel<8, false>;
    case 16: return clustered ? deform_bwd_kernel<16, true> : deform_bwd_kernel<16, false>;
    default: return clustered ? deform_bwd_kernel<32, true> : deform_bwd_kernel<32, false>;
  }
}

}  // namespace

// value [N, S, M, D], loc / attn [N, Lq, M, L, P], out [N, Lq, M, D]: float32,
// contiguous, on the device; value and out 16-byte aligned. shapes: L level
// lengths on the host, summing to S.
extern "C" int deformable_attention_fwd(const void* value, const void* loc, const void* attn,
                                        void* out, int N, int S, int Lq, int M, int D,
                                        int L, const int* shapes, int P, void* stream) {
  Levels lv;
  if (bad_sizes(N, S, Lq, M, D, P) || !make_levels(lv, S, L, shapes))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(((long)N * Lq * M + FWD_WARPS - 1) / FWD_WARPS);
  const auto kern = fwd_kernel(group_lanes(D));
  kern<<<grid, FWD_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<float*>(out), N, S, Lq, M, D, P, lv);
  return (int)cudaGetLastError();
}

// As the forward, plus gout [N, Lq, M, D] (16-byte aligned); dvalue
// [N, S, M, D] (16-byte aligned), dloc / dattn [N, Lq, M, L, P]: every
// element written, nothing needs zeroing. Takes the cluster route where a
// slice fits in shared memory, else zeroes dvalue and takes the global one.
extern "C" int deformable_attention_bwd(const void* value, const void* loc, const void* attn,
                                        const void* gout, void* dvalue, void* dloc,
                                        void* dattn, int N, int S, int Lq, int M, int D,
                                        int L, const int* shapes, int P, void* stream) {
  BwdArgs a;
  if (bad_sizes(N, S, Lq, M, D, P) || !make_levels(a.lv, S, L, shapes))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  a.value = static_cast<const float*>(value);
  a.loc = static_cast<const float*>(loc);
  a.attn = static_cast<const float*>(attn);
  a.gout = static_cast<const float*>(gout);
  a.dvalue = static_cast<float*>(dvalue);
  a.dloc = static_cast<float*>(dloc);
  a.dattn = static_cast<float*>(dattn);
  a.N = N;
  a.S = S;
  a.Lq = Lq;
  a.M = M;
  a.D = D;
  a.P = P;
  // the cluster: up to CLUSTER blocks of QC queries each
  a.QC = (Lq + min(CLUSTER, Lq) - 1) / min(CLUSTER, Lq);
  const int blocks = (Lq + a.QC - 1) / a.QC;
  const int warps = min(BWD_WARPS, a.QC);
  const long smem = 4L * ((long)(S + blocks - 1) / blocks * blocks * D + (long)a.QC * D +
                          (long)a.QC * S + (long)S * ((a.QC + 31) / 32));
  const bool clustered = smem <= SMEM_MAX;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.stream = st;
  if (clustered) {
    const int gp = group_lanes(D);
    auto kern = bwd_kernel(gp, true);
    // the largest shared memory asked of each instantiation so far: the
    // attribute is raised only when a launch needs more
    static long smem_set[33] = {};
    if (smem > smem_set[gp]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      smem_set[gp] = smem;
    }
    cfg.gridDim = dim3(blocks, M, N);
    cfg.blockDim = dim3(32 * warps, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }
  cudaError_t err = cudaMemsetAsync(dvalue, 0, sizeof(float) * (size_t)N * S * M * D, st);
  if (err != cudaSuccess) return (int)err;
  a.QC = BWD_WARPS;
  cfg.gridDim = dim3((Lq + BWD_WARPS - 1) / BWD_WARPS, M, N);
  cfg.blockDim = dim3(32 * BWD_WARPS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  err = cudaLaunchKernelEx(&cfg, bwd_kernel(group_lanes(D), false), a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
