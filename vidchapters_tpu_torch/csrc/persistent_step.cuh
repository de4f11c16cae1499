// Building blocks of the persistent decode-step kernels (the Whisper and the
// T5 decode kernels): one cooperative grid of one 512-thread block per SM
// runs a whole decoder step, its phases separated by grid barriers.
//
// Products (bf16): out[r][o] = sum_k in[r][k] W[o][k] with W stored [out, in].
// Each weight is read once per step for up to RMAX = 48 rows (a pass); above
// that the rows go through in passes of 48, each of which streams the weights
// again (a grid barrier between passes). The weight is the mma's A operand,
// exactly as stored (16 output columns x 16 k of mma.sync.m16n8k16, bf16 in,
// fp32 accumulate), and the rows are B, 8 to an n-tile: lane (g, t) loads 16
// bytes of weight rows g and g + 8 at k 8t of a 32-k chunk straight into
// registers, and the same 16 bytes of activation row g from shared memory.
// Both operands take k in the same permuted order, which leaves the sum
// unchanged. A block item is (a group of tg 16-column tiles, one of S
// k-splits); tg and S are chosen on the host for the grid so that the busiest
// block finishes first. The block's 16 warps split the k-split's chunks, each
// loading CHB chunks into registers before it uses any; while a tile's first
// loads fly, the block stages its k-split of every row in shared memory by
// cp.async (normalised in place) or merges the previous tile. The warps'
// partial tiles meet in shared memory in warp order. With S > 1 each block
// writes its partial tile and the last block of the tile to arrive (a counter
// it sets back to 0) adds the S partials in split order. The float32 route
// keeps CUDA-core products in the same item layout.
//
// Norms: the block that finishes a residual tile (16 columns) writes each
// row's mean and centred sum of squares over them; a norm's row statistics
// are those tile statistics combined in tile order (Chan's formula), no row
// read twice. LayerNorm takes the mean and variance, RMSNorm the mean square
// (variance + mean^2).
//
// Grid barrier: one arrival counter, never reset within a launch: a block
// adds one and waits for the number of blocks times the barriers so far.
// `leave` at the end of the kernel sets it back to 0 once every block has
// passed the last barrier, so a launch leaves its counters as it found them.
#pragma once

#include "common.cuh"
#include "tensor_core.cuh"

namespace vc {
namespace step {

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

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

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
  // After the kernel's last sync: each block adds one more, and the last of
  // them sets the count back to 0 (every block has passed every barrier).
  __device__ void leave() {
    if (threadIdx.x == 0) {
      const unsigned old = atomicAdd(count, 1u);
      if (old == target + gridDim.x - 1) atomicExch(count, 0u);
    }
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

// Each row's (mean, 1 / sqrt(variance + eps)) over d from the tile statistics
// tst [tiles][B] (mean, centred sum of squares of 16 columns), combined in
// tile order; RMS: (0, 1 / sqrt(mean square + eps)), the tiles' sums of
// squares (centred sum of squares + count mean^2) added in tile order.
template <bool RMS>
__device__ void row_stats(const float2* tst, int B, int d, int r0, int rows, float eps, float2* rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, ntd = cdiv(d, TILE);
  if (RMS) {
    for (int r = warp; r < rows; r += NW) {
      float ss = 0.f;
      for (int t = lane; t < ntd; t += 32) {
        const float2 s = __ldcg(tst + (long)t * B + r0 + r);
        ss += s.y + (float)min(TILE, d - t * TILE) * s.x * s.x;
      }
      ss = vc::warp_sum(ss);
      if (lane == 0) rs[r] = make_float2(0.f, rsqrtf(ss / (float)d + eps));
    }
    return;
  }
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
    if (lane == 0) rs[r] = make_float2(m, rsqrtf(m2 / (float)d + eps));
  }
}

// The items e = threadIdx.x, threadIdx.x + NT, ... of a [rows][per] grid as
// (r, c), stepped without a division an item: for (Walk w(per); w.r < rows;
// w.next()).
struct Walk {
  int r, c, dr, dc, per;
  __device__ explicit Walk(int per_)
      : r(threadIdx.x / per_), c(threadIdx.x % per_), dr(NT / per_), dc(NT % per_), per(per_) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
};

// Rows [r0, r0 + rows) x k [kb, ke) of a T matrix [B, K] written in this
// launch into act (rp8 rows x kspan, stride AS, zeros past the ends), every
// 16 bytes a cp.async in flight at once. With lns (a normalised input, K =
// d): the scale slice (and LayerNorm's bias slice) come the same way into
// lnbuf, the row statistics rs are combined from the tile statistics while
// the copies fly, and the rows are normalised in place: LayerNorm
// s ((x - mean) rstd) + b, RMSNorm s (x rstd), rounded to T.
template <bool RMS, typename T>
__device__ void stage(const T* src, int K, int B, int r0, int rows, int rp8, int kb, int ke,
                      int kspan, T* act, int AS, const float2* tst, float2* rs, const float* lns,
                      const float* lnb, float eps, float* lnbuf) {
  constexpr int PE = 16 / (int)sizeof(T);
  for (Walk w(kspan / PE); w.r < rp8; w.next()) {
    const int r = w.r, k = kb + PE * w.c;
    const bool ok = r < rows && k < ke;
    vc::tc::cp_async16(act + r * AS + (k - kb), ok ? src + (long)(r0 + r) * K + k : src,
                       ok ? 16 : 0);
  }
  if (lns != nullptr) {
    const int per4 = kspan / 4;
    for (int e = threadIdx.x; e < (RMS ? 1 : 2) * per4; e += NT) {
      const float* s = e < per4 ? lns : lnb;
      const int k = kb + 4 * (e % per4);
      vc::tc::cp_async16(lnbuf + (e / per4) * kspan + (k - kb), k < ke ? s + k : s,
                         k < ke ? 16 : 0);
    }
  }
  vc::tc::cp_async_commit();
  if (lns != nullptr) row_stats<RMS>(tst, B, K, r0, rows, eps, rs);
  vc::tc::cp_async_wait<0>();
  __syncthreads();
  if (lns == nullptr) return;
  for (Walk w(kspan / 8); w.r < rows; w.next()) {
    const int r = w.r, k = 8 * w.c;
    if (kb + k >= ke) continue;
    T* p = act + r * AS + k;
    float v[8];
    Row8<T>::load(p, v);
    const float2 st = rs[r];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = RMS ? lnbuf[k + i] * (v[i] * st.y)
                 : lnbuf[k + i] * ((v[i] - st.x) * st.y) + lnbuf[kspan + k + i];
    Row8<T>::store(p, v);
  }
}

// out[r][o] = sum_k in[r][k] W[o][k] for rows [0, B) and columns [0, n_out),
// through the sink: sink(r, o, sum) stores column o of row r and returns the
// value stored. in is src [B, K] (T), staged as it is or, with lns (/ lnb),
// normalised by the tile statistics tst of the residual (SinkT::kRms: RMSNorm,
// else LayerNorm; sink.eps()). Where sink.residual(), the stored values' tile
// statistics go to tst. Where sink.pairs(), each finished 16-column tile's
// values also go to sink.pair(r, tile, c, value of column c, of column c + 8)
// for c < 8.
template <typename T, typename SinkT>
__device__ void product(const ProdPlan& p, int rp, int B, const T* W, int n_out, int K,
                        const T* src, const float* lns, const float* lnb, unsigned char* sm,
                        float* part, unsigned* cnt, float2* tst, GridBarrier& bar,
                        const SinkT& sink) {
  const bool res = sink.residual(), pairs = sink.pairs();
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
            if (res || pairs) yb[r * 17 + col] = y;
          }
        }
        if (res || pairs) {
          __syncthreads();
          if (pairs)
            for (int e = tid; e < rows * (TILE / 2); e += NT) {
              const int r = e / (TILE / 2), c = e % (TILE / 2);
              sink.pair(r0 + r, tile, c, yb[r * 17 + c], yb[r * 17 + c + TILE / 2]);
            }
          if (res && tid < rows) {
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
                    stage<SinkT::kRms>(src, K, B, r0, rows, rp8, c_lo * KC, min(c_hi * KC, K),
                                       n * KC, act, AS, tst, rs, lns, lnb, sink.eps(), lnbuf);
                    __syncthreads();
                  });
        __syncthreads();
      }
      merge(t_hi - 1);
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

inline int sm_count(int& sms) {
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

}  // namespace step
}  // namespace vc
