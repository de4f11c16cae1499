// Small-k top-k over rows: values and indices of the k largest entries of each
// row, largest first, ties to the smallest index (lax.top_k's order), with the
// TPU kernel's behaviour on rows that hold fewer than k entries above
// finfo(T).min (below).
//
// Replaces: vidchapters_tpu/ops/decoding.py::_topk_pallas (the pl.pallas_call
// at line 269), reached through _topk_small once per beam-search step, and by
// the Whisper transcriber's beam once per decode step.
//
// What it computes: _topk_iterative, bit for bit. That function takes k
// argmax sweeps and overwrites each pick with finfo(T).min. While entries
// above finfo.min remain, a sweep picks the best of them by (value, -index),
// so the first picks are the row's sorted top-k. Once a entries (a < k) have
// been picked and none above finfo.min remains, every later sweep meets
// finfo.min at the picked entries and at the entries that held finfo.min from
// the start, and picks the smallest such index again and again (on a row of
// -inf only, pick 0 is (-inf, 0) and every later pick (finfo.min, 0)). So
// the result is the sorted top-k, except that from position 1 on each entry
// at or below finfo.min becomes (finfo.min, j*), where j* is the smallest
// index among the sorted top-k's entries at or above finfo.min (entry 0's
// index if there is none). NaN entries are not ranked.
//
// What bounds it on the H100: at the serving shape [8, 4 * 32200] f32 the
// call reads 4.1 MB once (~1.2 us at 3.35 TB/s) and does about one compare
// an element, so it is bound by bytes, and at these sizes by the latency of
// a few dependent steps.
//
// Design: each row is spread over S blocks of 256 threads (S from the
// wrapper, about two blocks an SM in all), each block a contiguous run of
// the row's 16-byte vectors; a row that does not start on a 16-byte boundary
// (N odd, as in every Whisper shape) takes its head and tail elements one by
// one in the first and the last block. A thread issues its loads (UNROLL
// vectors) before it consumes any, and keeps a sorted list of its k best
// entries in registers, k rounded up to 4, 8 or 16 slots; an element first
// meets one compare against the list's k-th entry, and one that passes is
// inserted by comparing it with every slot at once and shifting the slots
// it beats (no chain of dependent swaps). A warp merges its 32 lists by k
// rounds of arg-best over the lists' heads through shuffles (the winning
// lane pops its head), warp 0 merges the block's warp lists the same way,
// and with S > 1 the block writes its k candidates to a workspace. In the
// last block of a row to finish (a per-row counter, which that block sets
// back to 0, so no launch zeroes it and CUDA graphs can replay it), warp 0
// inserts the S blocks' candidates into its lanes' lists and merges them
// once more. Every comparison is on (value, -index), a total order, so the
// result does not depend on which block ends last. (The first version of
// this design, with 16-slot swap chains for every k and a block-wide final
// merge, took 0.0230 ms at the serving shape: PERF.md.)

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int MAXK = 16;
constexpr int MAXS = 256;  // most blocks a row
constexpr int UNROLL = 4;  // 16-byte loads a thread has in flight

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// finfo(T).min, the value _topk_iterative writes over a pick
template <typename T> __device__ __forceinline__ float lowest();
template <> __device__ __forceinline__ float lowest<float>() { return -3.40282346638528859812e38f; }
template <> __device__ __forceinline__ float lowest<__nv_bfloat16>() {
  return -3.38953138925153547590e38f;  // bf16 0xff7f
}

// A sorted list of the k best entries seen (best first), in registers; KB >=
// k slots, where the slots past k and the empty ones hold (-inf, INT_MAX),
// which every entry beats.
template <int KB>
struct TopList {
  float v[KB];
  int i[KB];
  float bar_v;  // entry k - 1: what a new entry must beat
  int bar_i;

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      v[j] = -CUDART_INF_F;
      i[j] = INT_MAX;
    }
    bar_v = -CUDART_INF_F;
    bar_i = INT_MAX;
  }

  // Insert (cv, ci) if it beats entry k - 1: every slot compares at once,
  // then each slot it beats takes its upper neighbour, or the new entry.
  __device__ __forceinline__ void push(float cv, int ci, int K) {
    if (!better(cv, ci, bar_v, bar_i)) return;
    bool beats[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j) beats[j] = j < K && better(cv, ci, v[j], i[j]);
#pragma unroll
    for (int j = KB - 1; j > 0; --j)
      if (beats[j]) {
        v[j] = beats[j - 1] ? v[j - 1] : cv;
        i[j] = beats[j - 1] ? i[j - 1] : ci;
      }
    if (beats[0]) {
      v[0] = cv;
      i[0] = ci;
    }
#pragma unroll
    for (int j = 0; j < KB; ++j)
      if (j == K - 1) {
        bar_v = v[j];
        bar_i = i[j];
      }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int j = 0; j + 1 < KB; ++j) {
      v[j] = v[j + 1];
      i[j] = i[j + 1];
    }
    v[KB - 1] = -CUDART_INF_F;
    i[KB - 1] = INT_MAX;
  }
};

// k rounds of arg-best over the heads of the warp's 32 lists: lane r < K
// receives round r's winner in (rv, ri).
template <int KB>
__device__ __forceinline__ void warp_merge(TopList<KB>& L, int K, float& rv, int& ri) {
  const int lane = threadIdx.x & 31;
  rv = -CUDART_INF_F;
  ri = INT_MAX;
  for (int r = 0; r < K; ++r) {
    float bv = L.v[0];
    int bi = L.i[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == r) {
      rv = bv;
      ri = bi;
    }
    if (L.i[0] == bi && L.v[0] == bv) L.pop();
  }
}

// Warp 0 writes the row's k entries, with _topk_iterative's picks past the
// last entry above finfo.min.
template <typename T>
__device__ __forceinline__ void write_row(float rv, int ri, int K, T* vals, int* idxs) {
  const int lane = threadIdx.x & 31;
  const float lo = lowest<T>();
  int j = (lane < K && rv >= lo) ? ri : INT_MAX;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) j = min(j, __shfl_xor_sync(0xffffffffu, j, o));
  const int first = __shfl_sync(0xffffffffu, ri, 0);
  if (j == INT_MAX) j = first;
  if (lane < K) {
    const bool repick = lane > 0 && rv <= lo;
    vals[lane] = vc::from_f<T>(repick ? lo : rv);
    idxs[lane] = repick ? j : ri;
  }
}

// 16 bytes of T: 4 floats or 8 bf16.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  float4 u;
  __device__ __forceinline__ float at(int e) const {
    return e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  uint4 u;
  __device__ __forceinline__ float at(int e) const {
    const unsigned w = e < 2 ? u.x : e < 4 ? u.y : e < 6 ? u.z : u.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

// grid (S, B); ws_v / ws_i [B, S, K] and count [B] (zero between launches)
// only with S > 1; K <= KB.
template <typename T, int KB>
__global__ void __launch_bounds__(NT) topk_kernel(const T* __restrict__ x, T* __restrict__ vals,
                                                  int* __restrict__ idxs, float* ws_v, int* ws_i,
                                                  int* count, int N, int K) {
  __shared__ float sv[NW * KB];
  __shared__ int si[NW * KB];
  __shared__ int last;

  constexpr int VEC = Vec<T>::N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = gridDim.x, s = blockIdx.x, b = blockIdx.y;
  const T* row = x + (long)b * N;
  // elements before the first 16-byte boundary, the aligned vectors, the tail
  const int head = min(N, (int)(((16u - ((uintptr_t)row & 15u)) & 15u) / sizeof(T)));
  const int nvec = (N - head) / VEC;
  const int tail0 = head + nvec * VEC;
  const int per = (nvec + S - 1) / S;
  const int v0 = min(nvec, s * per), v1 = min(nvec, v0 + per);

  TopList<KB> L;
  L.clear();
  if (s == 0 && tid < head) L.push(vc::to_f(row[tid]), tid, K);
  if (s == S - 1 && tail0 + tid < N) L.push(vc::to_f(row[tail0 + tid]), tail0 + tid, K);
  const Vec<T>* vp = reinterpret_cast<const Vec<T>*>(row + head);
  for (int base = v0 + tid; base < v1; base += NT * UNROLL) {
    Vec<T> buf[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (base + u * NT < v1) buf[u] = vp[base + u * NT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int vi = base + u * NT;
      if (vi < v1) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) L.push(buf[u].at(e), head + vi * VEC + e, K);
      }
    }
  }

  // the block's k best: each warp's, then warp 0 merges the warps' lists
  float rv;
  int ri;
  warp_merge(L, K, rv, ri);
  if (lane < K) {
    sv[warp * KB + lane] = rv;
    si[warp * KB + lane] = ri;
  }
  __syncthreads();
  if (warp == 0) {
    L.clear();
    if (lane < NW) {
#pragma unroll
      for (int j = 0; j < KB; ++j)
        if (j < K) {
          L.v[j] = sv[lane * KB + j];
          L.i[j] = si[lane * KB + j];
        }
    }
    warp_merge(L, K, rv, ri);
  }
  if (S == 1) {
    if (warp == 0) write_row<T>(rv, ri, K, vals + (long)b * K, idxs + (long)b * K);
    return;
  }
  if (warp == 0 && lane < K) {
    const long at = ((long)b * S + s) * K + lane;
    ws_v[at] = rv;
    ws_i[at] = ri;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(&count[b], 1) == S - 1;
  __syncthreads();
  if (!last || warp != 0) return;
  // the last block of the row: warp 0 merges the S blocks' k candidates
  __threadfence();
  L.clear();
  const float* cv = ws_v + (long)b * S * K;
  const int* ci = ws_i + (long)b * S * K;
  for (int c = lane; c < S * K; c += 32) L.push(__ldcg(cv + c), __ldcg(ci + c), K);
  warp_merge(L, K, rv, ri);
  if (lane == 0) count[b] = 0;
  write_row<T>(rv, ri, K, vals + (long)b * K, idxs + (long)b * K);
}

template <typename T, int KB>
void launch(const void* x, void* vals, void* idxs, float* ws_v, int* ws_i, int* count, int B,
            int N, int K, int S, cudaStream_t s) {
  topk_kernel<T, KB><<<dim3(S, B), NT, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(vals),
                                                static_cast<int*>(idxs), ws_v, ws_i, count, N,
                                                K);
}

// list slots: k rounded up to 4, 8 or 16, so that an insertion costs about k
template <typename T>
void launch(const void* x, void* vals, void* idxs, float* ws_v, int* ws_i, int* count, int B,
            int N, int K, int S, cudaStream_t s) {
  if (K <= 4)
    launch<T, 4>(x, vals, idxs, ws_v, ws_i, count, B, N, K, S, s);
  else if (K <= 8)
    launch<T, 8>(x, vals, idxs, ws_v, ws_i, count, B, N, K, S, s);
  else
    launch<T, 16>(x, vals, idxs, ws_v, ws_i, count, B, N, K, S, s);
}

}  // namespace

// x [B, N] contiguous, vals [B, K] of x's dtype, idxs [B, K] int32; 1 <= K <= 16 <= N;
// 1 <= S <= 256 blocks a row. With S > 1: ws_v (float) and ws_i (int) of B * S * K
// elements, and count, B ints that are 0 (the kernel leaves them 0 again).
extern "C" int topk(const void* x, void* vals, void* idxs, void* ws_v, void* ws_i, void* count,
                    int B, int N, int K, int S, int dtype, void* stream) {
  if (K < 1 || K > MAXK || N < K || B <= 0 || S < 1 || S > MAXS ||
      (S > 1 && (ws_v == nullptr || ws_i == nullptr || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wv = static_cast<float*>(ws_v);
  int* wi = static_cast<int*>(ws_i);
  int* c = static_cast<int*>(count);
  if (dtype == VC_DTYPE_F32)
    launch<float>(x, vals, idxs, wv, wi, c, B, N, K, S, st);
  else if (dtype == VC_DTYPE_BF16)
    launch<__nv_bfloat16>(x, vals, idxs, wv, wi, c, B, N, K, S, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
