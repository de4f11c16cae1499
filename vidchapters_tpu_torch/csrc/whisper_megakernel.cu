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
// Products (bf16): each weight is read once per step for up to RMAX = 48 rows
// (a pass); above that the rows go through in passes of 48, each of which
// streams the weights again (a grid barrier between passes). The weight is
// the mma's A operand, exactly as stored ([out, in], 16 output columns x 16 k
// of mma.sync.m16n8k16, bf16 in, fp32 accumulate), and the rows are B, 8 to
// an n-tile: lane (g, t) loads 16 bytes of weight rows g and g + 8 at k 8t of
// a 32-k chunk straight into registers, and the same 16 bytes of activation
// row g from shared memory. Both operands take k in the same permuted order,
// which leaves the sum unchanged. A block item is (a group of tg 16-column
// tiles, one of S k-splits); tg and S are chosen on the host for the grid so
// that the busiest block finishes first. The block's 16 warps split the
// k-split's chunks, each loading CHB chunks into registers before it uses
// any; while a tile's first loads fly, the block stages its k-split of every
// row in shared memory by cp.async (LayerNorm applied in place) or merges the
// previous tile. The warps' partial tiles meet in shared memory in warp
// order. With S > 1 each block writes its partial tile and the last block of
// the tile to arrive (a counter it sets back to 0) adds the S partials in
// split order. The float32 route keeps CUDA-core products in the same item
// layout. An L2 prefetch of the next product's weights before each grid
// barrier (or at the start of a phase) was measured and dropped: it slowed
// the phase that issued it more than it sped the next (PERF.md). The
// V rows of the cross-attention are prefetched into L2 by the scores phase.
//
// LayerNorm: the block that finishes a residual tile (16 columns) writes each
// row's mean and centred sum of squares over them; a LayerNorm's row
// statistics are those tile statistics combined in tile order (Chan's
// formula), no row read twice.
//
// Grid barrier: one arrival counter, never reset within a launch: a block
// adds one and waits for the number of blocks times the barriers so far.
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

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using vc::tc::bf16;

constexpr int NT = 512;
constexpr int NW = NT / 32;
constexpr int TILE = 16;    // output columns of one product tile (the mma's m)
constexpr int KC = 32;      // k of one weight chunk: two m16n8k16 steps
constexpr int RMAX = 48;    // rows of one product pass (6 n-tiles of 8)
constexpr int RPS = RMAX + 8;  // row stride of a warp's partial tile
constexpr int SMAX = 8;     // most k-splits of a product
constexpr int TGMAX = 4;    // most column tiles of one block item
constexpr int CHB = 4;      // weight chunks a warp loads before it uses any
constexpr int GMAX = 8;     // beams per example
constexpr int DMAX = 128;   // widest head
constexpr int NBMAX = 16;   // most key ranges of one (example, head)
constexpr int SU = 4;       // key rows a lane loads before it uses any
constexpr int SUV = 8;      // V pieces a lane loads before it uses any
constexpr int SUW = 8;      // V rows a lane loads before it uses any, one beam
constexpr int PHASES = 9;   // grid barriers a layer
constexpr float NEG = -1e9f;
constexpr int SMEM_LIMIT = 232448;  // the most shared memory a block can use on sm_90

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Fixed part of a product phase's shared memory: a flag, the row statistics,
// the tile of finished values, the warps' partial tiles; the activation follows.
constexpr size_t PROD_FIXED = 16 + RMAX * 8 + RMAX * 17 * 4 + (size_t)NW * TILE * RPS * 4;

// Row stride (elements) of a staged activation slice of kch chunks. bf16: 64
// bytes past a multiple of 128, so that the 8 rows one B-fragment load reads
// fall in distinct banks.
__host__ __device__ inline int act_stride(int kch, int esize) {
  const int k = kch * KC;
  if (esize == 2) return (k % 64 == 0) ? k + 32 : k;
  return k + 4;
}

// Shared memory of a product phase: the fixed part, rp staged rows of kch
// chunks and, for a LayerNorm'd input, the LayerNorm scale and bias slices.
__host__ __device__ inline size_t prod_smem(int rp, int kch, int esize, bool ln) {
  return PROD_FIXED + (size_t)rp * act_stride(kch, esize) * esize + (ln ? (size_t)8 * kch * KC : 0);
}

struct ProdPlan {
  int tiles;  // 16-column tiles
  int nkc;    // 32-k chunks of K
  int tg;     // tiles of one block item
  int S;      // k-splits
  int kch;    // chunks of the widest k-split
  int items;  // block items: ceil(tiles / tg) x S
};

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

// The product's block items for a grid of G blocks: the (tg, S) whose busiest
// block finishes first, by a model in ns of an SM's share of the card: an
// item stages its rows (0.5 us, then 60 bytes a ns from L2), each tile takes
// a load latency per round of CHB chunks a warp (0.7 us) and its weight bytes
// at 50 a ns, and a cross-block merge adds 1 us.
inline bool plan_product(int n_out, int K, int rp, int esize, bool ln, int G, ProdPlan& p) {
  p.tiles = cdiv(n_out, TILE);
  p.nkc = cdiv(K, KC);
  long best = -1;
  for (int S = 1; S <= SMAX && S <= p.nkc; ++S) {
    const int kch = cdiv(p.nkc, S);
    if (prod_smem(rp, kch, esize, ln) > (size_t)SMEM_LIMIT) continue;
    const long stage = 500 + (long)rp * kch * KC * esize / 60;
    const long tile = 300 + 700L * cdiv(cdiv(kch, NW), CHB) + (long)TILE * kch * KC * esize / 50;
    for (int tg = 1; tg <= TGMAX; ++tg) {
      const int items = cdiv(p.tiles, tg) * S;
      const long cost = (long)cdiv(items, G) * (stage + tg * tile) + (S > 1 ? 1000 : 0);
      if (best < 0 || cost < best) {
        best = cost;
        p.tg = tg;
        p.S = S;
        p.kch = kch;
        p.items = items;
      }
    }
  }
  return best >= 0;
}

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

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// A T value written in this launch by another block: read past L1.
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const bf16* p) {
  return __uint_as_float((unsigned)__ldcg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// exp(m - m_to): the weight of a softmax state with max m in one with max
// m_to >= m; 0 for a state that has seen no key.
__device__ __forceinline__ float rescale(float m, float m_to) {
  return m == -CUDART_INF_F ? 0.f : expf(m - m_to);
}

// Combine a (count, mean, centred sum of squares) with another (Chan et al.).
__device__ __forceinline__ void chan(float& n, float& m, float& m2, float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb, delta = mb - m;
  m += delta * (nb / nn);
  m2 += m2b + delta * delta * (n * nb / nn);
  n = nn;
}

// 16 bytes of T as floats.
template <typename T> struct V16;
template <> struct V16<float> {
  static constexpr int E = 4;
  uint4 u;
  __device__ __forceinline__ float at(int e) const {
    return __uint_as_float(e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w);
  }
};
template <> struct V16<bf16> {
  static constexpr int E = 8;
  uint4 u;
  __device__ __forceinline__ float at(int e) const {
    const unsigned w = e < 2 ? u.x : e < 4 ? u.y : e < 6 ? u.z : u.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};
// int8 -> float without a conversion instruction: the byte, its sign bit
// flipped, is the low mantissa byte of 2^23 + (v + 128).
__device__ __forceinline__ float i8f(unsigned w, int e) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440u + e)) - 8388736.f;
}
template <> struct V16<signed char> {
  static constexpr int E = 16;
  uint4 u;
  __device__ __forceinline__ float at(int e) const {
    const int i = e >> 2;
    return i8f(i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w, e & 3);
  }
};

// 4 consecutive elements of T.
template <typename T> struct V4;
template <> struct V4<float> {
  float4 u;
  __device__ __forceinline__ void load(const float* p) { u = __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ __forceinline__ float at(int e) const { return e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w; }
};
template <> struct V4<bf16> {
  uint2 u;
  __device__ __forceinline__ void load(const bf16* p) { u = __ldg(reinterpret_cast<const uint2*>(p)); }
  __device__ __forceinline__ float at(int e) const {
    const unsigned w = e < 2 ? u.x : u.y;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};
template <> struct V4<signed char> {
  unsigned u;
  __device__ __forceinline__ void load(const signed char* p) { u = __ldg(reinterpret_cast<const unsigned*>(p)); }
  __device__ __forceinline__ float at(int e) const { return i8f(u, e); }
};

// 8 consecutive T in shared memory, as floats.
template <typename T> struct Row8;
template <> struct Row8<bf16> {
  __device__ static void load(const bf16* p, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(bf16* p, const float* v) {
    uint4 u;
    u.x = vc::tc::pack(v[0], v[1]);
    u.y = vc::tc::pack(v[2], v[3]);
    u.z = vc::tc::pack(v[4], v[5]);
    u.w = vc::tc::pack(v[6], v[7]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};
template <> struct Row8<float> {
  __device__ static void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// Grid-wide barrier of a cooperative launch: every block adds one to the
// arrival count (zeroed by the caller, never reset within the launch) and
// waits until it reaches the number of blocks times the barriers so far.
// Writes made before it are visible to loads after it that bypass L1
// (__ldcg, cp.async.cg).
struct GridBarrier {
  unsigned* count;
  unsigned target = 0;
  __device__ explicit GridBarrier(unsigned* c) : count(c) {}
  __device__ void sync() {
    target += gridDim.x;
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(count, 1u);
      volatile unsigned* seen = count;
      while (*seen < target) __nanosleep(32);
      __threadfence();
    }
    __syncthreads();
  }
};

// With a timeline, thread 0 of block 0 records %globaltimer (ns) in slot i:
// the end of a grid barrier is the end of the phase before it for every block.
__device__ __forceinline__ void mark(unsigned long long* timeline, int i) {
  if (timeline != nullptr && blockIdx.x == 0 && threadIdx.x == 0) timeline[i] = global_ns();
}

// ---- products ----

// Chunks [w_lo, w_hi) of one 16-column tile (o0..) against the staged rows
// (act: chunk c_base first, row stride AS), on the tensor cores; the warp's
// partial tile into mbw [16 columns][RPS]. Lane (g, t) loads weight rows g and
// g + 8 and activation row g at k 8t of each chunk: k 8t + {0,1 | 2,3} feed
// the first m16n8k16 step as k 2t + {0,1 | 8,9}, 8t + {4..7} the second.
// before() runs once, after the first round of weight loads is issued and
// before any is used (the block's staging, which every warp joins).
template <typename Before>
__device__ void warp_tile(const bf16* W, int K, int n_out, int o0, int w_lo, int w_hi,
                          int c_base, const bf16* act, int AS, int nt, float* mbw, Before before) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[RMAX / 8][4];
#pragma unroll
  for (int j = 0; j < RMAX / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const bool ok0 = o0 + g < n_out, ok1 = o0 + g + 8 < n_out;
  const bf16* w0 = W + (long)(ok0 ? o0 + g : 0) * K + 8 * t;
  const bf16* w1 = W + (long)(ok1 ? o0 + g + 8 : 0) * K + 8 * t;
  int c0 = w_lo;
  do {
    uint4 a0[CHB], a1[CHB];
#pragma unroll
    for (int u = 0; u < CHB; ++u) {
      const int k = (c0 + u) * KC;
      const bool in = c0 + u < w_hi && k + 8 * t < K;
      a0[u] = in && ok0 ? ld16(w0 + k) : make_uint4(0u, 0u, 0u, 0u);
      a1[u] = in && ok1 ? ld16(w1 + k) : make_uint4(0u, 0u, 0u, 0u);
    }
    if (c0 == w_lo) before();
#pragma unroll
    for (int u = 0; u < CHB; ++u) {
      if (c0 + u < w_hi) {
        const bf16* ar = act + (c0 + u - c_base) * KC + 8 * t + g * AS;
        const uint32_t f0[4] = {a0[u].x, a1[u].x, a0[u].y, a1[u].y};
        const uint32_t f1[4] = {a0[u].z, a1[u].z, a0[u].w, a1[u].w};
#pragma unroll
        for (int j = 0; j < RMAX / 8; ++j) {
          if (j < nt) {
            const uint4 b = *reinterpret_cast<const uint4*>(ar + 8 * j * AS);
            vc::tc::mma(acc[j], f0, b.x, b.y);
            vc::tc::mma(acc[j], f1, b.z, b.w);
          }
        }
      }
    }
    c0 += CHB;
  } while (c0 < w_hi);
  // C of n-tile j: lane (g, t) holds columns g, g + 8 of rows 8j + 2t, 8j + 2t + 1
#pragma unroll
  for (int j = 0; j < RMAX / 8; ++j) {
    if (j < nt) {
      *reinterpret_cast<float2*>(mbw + g * RPS + 8 * j + 2 * t) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(mbw + (g + 8) * RPS + 8 * j + 2 * t) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// The float32 route: the same tile on the CUDA cores. Lane (c, half) owns
// column c and the rows of its parity.
template <typename Before>
__device__ void warp_tile(const float* W, int K, int n_out, int o0, int w_lo, int w_hi,
                          int c_base, const float* act, int AS, int nt, float* mbw, Before before) {
  before();
  const int lane = threadIdx.x & 31, c = lane & 15, half = lane >> 4;
  const int rows = nt * 8;
  float acc[RMAX / 2];
#pragma unroll
  for (int i = 0; i < RMAX / 2; ++i) acc[i] = 0.f;
  const bool ok = o0 + c < n_out;
  const float* wr = W + (long)(ok ? o0 + c : 0) * K;
  for (int ch = w_lo; ch < w_hi; ++ch) {
    const float* ar = act + (ch - c_base) * KC;
    for (int q = 0; q < KC; q += 4) {
      const int k = ch * KC + q;
      if (k >= K) break;
      const float4 w4 = ok ? __ldg(reinterpret_cast<const float4*>(wr + k))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < RMAX / 2; ++i) {
        const int r = 2 * i + half;
        if (r < rows) {
          const float4 a4 = *reinterpret_cast<const float4*>(ar + r * AS + q);
          acc[i] = fmaf(w4.w, a4.w, fmaf(w4.z, a4.z, fmaf(w4.y, a4.y, fmaf(w4.x, a4.x, acc[i]))));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RMAX / 2; ++i) {
    const int r = 2 * i + half;
    if (r < rows) mbw[c * RPS + r] = acc[i];
  }
}

// Each row's mean and rstd over d from the tile statistics tst [tiles][B]
// (mean, centred sum of squares of 16 columns), combined in tile order.
__device__ void row_stats(const float2* tst, int B, int d, int r0, int rows, float2* rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, ntd = cdiv(d, TILE);
  for (int r = warp; r < rows; r += NW) {
    float n = 0.f, m = 0.f, m2 = 0.f;
    for (int t = lane; t < ntd; t += 32) {
      const float2 s = __ldcg(tst + (long)t * B + r0 + r);
      chan(n, m, m2, (float)min(TILE, d - t * TILE), s.x, s.y);
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float n2 = __shfl_xor_sync(0xffffffffu, n, o);
      const float mb = __shfl_xor_sync(0xffffffffu, m, o);
      const float m2b = __shfl_xor_sync(0xffffffffu, m2, o);
      chan(n, m, m2, n2, mb, m2b);
    }
    if (lane == 0) rs[r] = make_float2(m, rsqrtf(m2 / (float)d + 1e-5f));
  }
}

// Rows [r0, r0 + rows) x k [kb, ke) of a T matrix [B, K] written in this
// launch into act (rp8 rows x kspan, stride AS, zeros past the ends), every
// 16 bytes a cp.async in flight at once. With lns (a LayerNorm'd input, K =
// d): the scale and bias slices come the same way into lnbuf, the row
// statistics rs are combined from the tile statistics while the copies fly,
// and the rows are normalised in place.
template <typename T>
__device__ void stage(const T* src, int K, int B, int r0, int rows, int rp8, int kb, int ke,
                      int kspan, T* act, int AS, const float2* tst, float2* rs, const float* lns,
                      const float* lnb, float* lnbuf) {
  constexpr int PE = 16 / (int)sizeof(T);
  const int per = kspan / PE;
  for (int e = threadIdx.x; e < rp8 * per; e += NT) {
    const int r = e / per, k = kb + PE * (e % per);
    const bool ok = r < rows && k < ke;
    vc::tc::cp_async16(act + r * AS + (k - kb), ok ? src + (long)(r0 + r) * K + k : src,
                       ok ? 16 : 0);
  }
  if (lns != nullptr) {
    const int per4 = kspan / 4;
    for (int e = threadIdx.x; e < 2 * per4; e += NT) {
      const float* s = e < per4 ? lns : lnb;
      const int k = kb + 4 * (e % per4);
      vc::tc::cp_async16(lnbuf + (e / per4) * kspan + (k - kb), k < ke ? s + k : s,
                         k < ke ? 16 : 0);
    }
  }
  vc::tc::cp_async_commit();
  if (lns != nullptr) row_stats(tst, B, K, r0, rows, rs);
  vc::tc::cp_async_wait<0>();
  __syncthreads();
  if (lns == nullptr) return;
  const int per8 = kspan / 8;
  for (int e = threadIdx.x; e < rows * per8; e += NT) {
    const int r = e / per8, k = 8 * (e % per8);
    if (kb + k >= ke) continue;
    T* p = act + r * AS + k;
    float v[8];
    Row8<T>::load(p, v);
    const float2 st = rs[r];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = lnbuf[k + i] * ((v[i] - st.x) * st.y) + lnbuf[kspan + k + i];
    Row8<T>::store(p, v);
  }
}

// Where a product's finished sums go: q|k|v (q scaled into qs, k / v into
// row idx of the caches and k_new / v_new), the residual (into xs, and
// hidden after the last layer), the cross q (scaled), or fc1 (exact GELU).
enum SinkKind { SINK_QKV, SINK_RESIDUAL, SINK_QCROSS, SINK_GELU };

template <typename T>
struct Sink {
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

// out[r][o] = sum_k in[r][k] W[o][k] for rows [0, B) and columns [0, n_out),
// through the sink (the residual's tile statistics kept in tst). in is src
// [B, K] (T), staged as it is or, with lns / lnb, LayerNorm'd by the tile
// statistics tst of the residual.
template <typename T>
__device__ void product(const ProdPlan& p, int rp, int B, const T* W, int n_out, int K,
                        const T* src, const float* lns, const float* lnb, unsigned char* sm,
                        float* part, unsigned* cnt, float2* tst, GridBarrier& bar,
                        const Sink<T>& sink) {
  const bool res = sink.kind == SINK_RESIDUAL;
  int* flag = reinterpret_cast<int*>(sm);
  float2* rs = reinterpret_cast<float2*>(sm + 16);
  float* yb = reinterpret_cast<float*>(sm + 16 + RMAX * 8);
  float* mb = yb + RMAX * 17;
  T* act = reinterpret_cast<T*>(mb + NW * TILE * RPS);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int AS = act_stride(p.kch, (int)sizeof(T));
  float* lnbuf = reinterpret_cast<float*>(act + rp * AS);
  for (int r0 = 0; r0 < B; r0 += rp) {
    if (r0 > 0) bar.sync();  // the counters and partials of the last pass are free
    const int rows = min(rp, B - r0), rp8 = (rows + 7) & ~7;
    for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
      const int grp = it / p.S, s = it % p.S;
      const int c_lo = p.nkc * s / p.S, c_hi = p.nkc * (s + 1) / p.S;
      const int n = c_hi - c_lo;
      const int w_lo = c_lo + n * warp / NW, w_hi = c_lo + n * (warp + 1) / NW;
      const int t_lo = grp * p.tg, t_hi = min(p.tiles, (grp + 1) * p.tg);
      // the partial tiles of the warps, summed in warp order (and with S > 1
      // the blocks' partials in split order, by the last block to arrive),
      // through the sink
      auto merge = [&](int tile) {
        const int o0 = tile * TILE, ncols = min(TILE, n_out - o0);
        if (p.S > 1) {
          float* mine = part + ((long)tile * p.S + s) * TILE * rp;
          for (int e = tid; e < TILE * rows; e += NT) {
            const int col = e % TILE, r = e / TILE;
            float acc = 0.f;
            for (int w = 0; w < NW; ++w) acc += mb[(w * TILE + col) * RPS + r];
            mine[r * TILE + col] = acc;
          }
          __threadfence();
          __syncthreads();
          if (tid == 0) {
            const unsigned old = atomicAdd(cnt + tile, 1u);
            flag[0] = old == (unsigned)p.S - 1;
            if (old == (unsigned)p.S - 1) cnt[tile] = 0u;  // every split has arrived
          }
          __syncthreads();
          if (!flag[0]) return;
          __threadfence();
        }
        const float* all = part + (long)tile * p.S * TILE * rp;
        for (int e = tid; e < TILE * rows; e += NT) {
          const int col = e % TILE, r = e / TILE;
          float acc = 0.f;
          if (p.S == 1) {
            for (int w = 0; w < NW; ++w) acc += mb[(w * TILE + col) * RPS + r];
          } else {
            for (int q = 0; q < p.S; ++q) acc += __ldcg(all + (long)q * TILE * rp + r * TILE + col);
          }
          if (col < ncols) {
            const float y = sink(r0 + r, o0 + col, acc);
            if (res) yb[r * 17 + col] = y;
          }
        }
        if (res) {
          __syncthreads();
          if (tid < rows) {
            float m = 0.f;
            for (int c = 0; c < ncols; ++c) m += yb[tid * 17 + c];
            m /= (float)ncols;
            float m2 = 0.f;
            for (int c = 0; c < ncols; ++c) {
              const float dv = yb[tid * 17 + c] - m;
              m2 += dv * dv;
            }
            tst[(long)tile * B + r0 + tid] = make_float2(m, m2);
          }
        }
        __syncthreads();
      };
      for (int tile = t_lo; tile < t_hi; ++tile) {
        // the item's rows are staged, or the last tile merged, while the
        // warps' first weight loads of this tile fly
        warp_tile(W, K, n_out, tile * TILE, w_lo, w_hi, c_lo, act, AS, rp8 / 8,
                  mb + warp * TILE * RPS, [&] {
                    if (tile != t_lo) {
                      merge(tile - 1);
                      return;
                    }
                    stage(src, K, B, r0, rows, rp8, c_lo * KC, min(c_hi * KC, K), n * KC, act, AS,
                          tst, rs, lns, lnb, lnbuf);
                    __syncthreads();
                  });
        __syncthreads();
      }
      merge(t_hi - 1);
    }
  }
}

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

// Only the grid barriers of a step: their cost alone, for the timeline.
__global__ void __launch_bounds__(NT, 1) barrier_kernel(unsigned* bar, unsigned long long* timeline,
                                                        int n) {
  GridBarrier b(bar);
  mark(timeline, 0);
  for (int i = 0; i < n; ++i) {
    b.sync();
    mark(timeline, i + 1);
  }
}

int sm_count(int& sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

template <typename K, typename... A>
int launch_cooperative(K kernel, size_t smem, cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  const int rc = sm_count(sms);
  if (rc != 0) return rc;
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
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
