// Fused bias-aware attention, forward:
//   out = dropout(softmax(q k^T + bias + (mask - 1) * 1e9)) v
// and, when asked (training), lse = m + log l per query row for the backward.
//
// Replaces: vidchapters_tpu/ops/fused_attention.py::_fused_forward / _fwd_kernel
// (the pl.pallas_call at line 163), with its in-kernel hash dropout
// (vc::keep_scale in common.cuh). Scores are unscaled, as in T5.
//
// Two routes, by dtype:
// - bfloat16, the compute dtype of every main path: fused_attention_fwd_tc,
//   on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32 accumulate).
// - float32: fused_attention_fwd_kernel, the first version on the fp32 CUDA
//   cores, unchanged. Only the checks that hold the card against the CPU at
//   1e-4 run fp32, and TF32 tensor cores (10-bit mantissa) would break them.
//
// What bounds it on the H100: at the T5-base encoder's shape (B=8, H=12,
// L=1024, D=64, bf16) one call does 4*B*H*L^2*D = 25.8 GFLOP and must move
// q, k, v, out (50 MB) plus the [1,H,L,L] bias (25 MB): 26 us of bf16
// tensor-core FLOPs at 989 TFLOP/s against 22 us of bytes, so both bounds
// are close. Beside the products, each of the B*H*L^2 = 101M scores takes an
// exp, the bias and mask adds and, with dropout, half a murmur3 hash (below):
// ~20 integer and float operations an element on the CUDA cores.
//
// Design of the tensor-core route: one block of 4 warps per (b, h, 64-row
// query tile); each warp owns 16 query rows. Q is loaded once into shared
// memory; 64-key tiles of K, V, the bias and the key mask stream through a
// two-stage cp.async ring, the next tile in flight while the current one is
// used. S = Q K^T runs on mma.sync with fp32 accumulators in registers; the
// bias (read with ldmatrix into the accumulator layout), the mask, the
// online softmax and the hash dropout act on those registers, with each
// accumulator element's absolute (row, key) from the fragment layout
// (tensor_core.cuh). P is rounded to bf16 in registers and is directly the A
// operand of O += P V, as JAX's kernel rounds probs to v's dtype
// (vidchapters_tpu/ops/fused_attention.py:136). Shared-memory rows are
// padded by 16 bytes so that ldmatrix reads are free of bank conflicts.
// Rows past Lq are loaded as zeros and never written. With dropout the
// kernel is instantiated with SPLIT: a tile's first 32 keys come from the
// lower half of Lk and its last 32 from the same span Lk/2 further on, so
// one hash gives both keep decisions (the mask's two 16-bit halves); the
// training form took 0.24 ms against 0.30 with tiles in key order, while
// without dropout the plain walk stayed the faster one (PERF.md). The TPU
// kernel held all of K/V in VMEM and ran a plain softmax; that does not fit a
// block's shared memory and is not copied. Next step: wgmma with TMA
// (ROADMAP.md).
//
// The fp32 route: one block of 256 threads per (b, h, 64-row query tile)
// streams 64-key K/V tiles through shared memory and keeps an online
// softmax per query row with an fp32 accumulator in registers (each thread
// owns 4 rows x D/16 columns), multiplying on the fp32 CUDA cores.
//
// Dropout: the keep mask multiplies p after the row sum, so the running sum
// l takes the undropped p and the accumulator the dropped one, which is
// probs = e / s; probs *= keep of the TPU kernel. The mask hashes the
// absolute query row and the key column over the (padded) Lk of the call.
// lse lets the backward rebuild p = exp(s - lse) in O(L) memory.

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per streamed tile
constexpr int NT = 256;  // threads: 16 x 16, thread (ty, tx) owns rows ty + 16 i, keys tx + 16 j

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) fused_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ bias, const int* __restrict__ key_mask, T* __restrict__ out,
    float* __restrict__ lse, int H, int Lq, int Lk, vc::Dropout dr) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);     // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D]
  float* Ps = Vs + BK * D;           // [BQ][BK + 1]
  constexpr int CD = D / 16;         // output columns per thread

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long bh = (long)b * H + h;
  const T* qp = q + bh * Lq * D;
  const T* kp = k + bh * Lk * D;
  const T* vp = v + bh * Lk * D;
  const T* bp = bias ? bias + (long)h * Lq * Lk : nullptr;
  const int* mp = key_mask + (long)b * Lk;
  const unsigned mixed = vc::dropout_mix(dr, b, h);

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    Qs[r * (D + 1) + d] = (q0 + r < Lq) ? vc::to_f(qp[(long)(q0 + r) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // the previous tile's Ks / Vs / Ps are no longer read
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, d = e % D;
      const long g = (long)(k0 + r) * D + d;
      Ks[r * (D + 1) + d] = vc::to_f(kp[g]);
      Vs[r * D + d] = vc::to_f(vp[g]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const float madd = ((float)mp[key] - 1.f) * 1e9f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (bp != nullptr && row < Lq) s[i][j] += vc::to_f(bp[(long)row * Lk + key]);
        s[i][j] += madd;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      const float sc = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        ps += p;  // the row sum takes p before dropout
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] =
            dr.on ? p * vc::keep_scale(dr, mixed, q0 + ty + 16 * i, k0 + tx + 16 * j, Lk) : p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * sc + ps;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= sc;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  T* op = out + bh * Lq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Lq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < CD; ++c)
      op[(long)row * D + tx + 16 * c] = vc::from_f<T>(acc[i][c] * inv);
    if (lse != nullptr && tx == 0) lse[bh * Lq + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* key_mask, void* out, void* lse, int B, int H, int Lq, int Lk,
           vc::Dropout dr, cudaStream_t stream) {
  auto kern = fused_attention_fwd_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), static_cast<const int*>(key_mask), static_cast<T*>(out),
      static_cast<float*>(lse), H, Lq, Lk, dr);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* bias,
               const void* key_mask, void* out, void* lse, int B, int H, int Lq, int Lk,
               int D, vc::Dropout dr, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, bias, key_mask, out, lse, B, H, Lq, Lk, dr, stream);
    case 64: return launch<T, 64>(q, k, v, bias, key_mask, out, lse, B, H, Lq, Lk, dr, stream);
    case 128: return launch<T, 128>(q, k, v, bias, key_mask, out, lse, B, H, Lq, Lk, dr, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core route
// ---------------------------------------------------------------------------

namespace tcfwd {

using vc::tc::bf16;
constexpr int BQ = 64;   // query rows per block, 16 per warp
constexpr int BK = 64;   // keys per streamed tile: BK / 2 from each half of Lk
constexpr int NT = 128;  // 4 warps
constexpr int LB = BK + 8;  // bias tile row stride (bf16)
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int LD = D + 8;  // q/k/v tile row stride (bf16)
  static constexpr int Q = 0;                       // [BQ][LD]
  static constexpr int K = Q + BQ * LD;             // [2][BK][LD]
  static constexpr int V = K + 2 * BK * LD;         // [2][BK][LD]
  static constexpr int B = V + 2 * BK * LD;         // [2][BQ][LB]
  static constexpr int M = B + 2 * BQ * LB;         // [2][BK] int32 (in bf16 units)
  static constexpr size_t bytes = 2 * (size_t)M + 2 * BK * sizeof(int);
};

template <int D, bool SPLIT>
__global__ void __launch_bounds__(NT) fused_attention_fwd_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ bias, const int* __restrict__ key_mask, bf16* __restrict__ out,
    float* __restrict__ lse, int H, int Lq, int Lk, vc::Dropout dr) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* Qs = sm + L::Q;
  int* Ms = reinterpret_cast<int*>(sm + L::M);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long bh = (long)b * H + h;
  const bf16* kp = k + bh * Lk * D;
  const bf16* vp = v + bh * Lk * D;
  const bf16* bp = bias ? bias + (long)h * Lq * Lk : nullptr;
  const int* mp = key_mask + (long)b * Lk;
  const unsigned mixed = vc::dropout_mix(dr, b, h);
  const int wr = warp * 16;  // the warp's first row in the tile
  const int nt = Lk / BK;

  // SPLIT (with dropout): tile kt holds keys [kt * BK/2, (kt + 1) * BK/2)
  // and the same span of the upper half of Lk, in its first and second BK/2
  // rows, and the hash of a key in the first half decides its partner Lk/2
  // further on too. Else tile kt holds keys [kt * BK, (kt + 1) * BK).
  const int lk_half = Lk >> 1;
  constexpr int kstep = SPLIT ? BK / 2 : BK;
  auto load_stage = [&](int st, int kt) {
    constexpr int PIECES = SPLIT ? 2 : 1, PK = BK / PIECES;  // keys a piece
#pragma unroll
    for (int pc = 0; pc < PIECES; ++pc) {
      const int k0 = kt * kstep + pc * lk_half, c0 = pc * PK;
      vc::tc::load_tile<PK, D, NT>(sm + L::K + (st * BK + c0) * LD, LD, kp, D, k0, Lk);
      vc::tc::load_tile<PK, D, NT>(sm + L::V + (st * BK + c0) * LD, LD, vp, D, k0, Lk);
      if (bp != nullptr)
        vc::tc::load_tile<BQ, PK, NT>(sm + L::B + st * BQ * LB + c0, LB, bp + k0, Lk, q0, Lq);
      if (tid < PK / 4) vc::tc::cp_async16(Ms + st * BK + c0 + 4 * tid, mp + k0 + 4 * tid, 16);
    }
  };
  vc::tc::load_tile<BQ, D, NT>(Qs, LD, q + bh * Lq * D, D, q0, Lq);
  load_stage(0, 0);
  vc::tc::cp_async_commit();

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int kt = 0; kt < nt; ++kt) {
    const int st = kt & 1, k0 = kt * kstep;  // the tile's first key
    if (kt + 1 < nt) {
      load_stage(st ^ 1, kt + 1);
      vc::tc::cp_async_commit();
      vc::tc::cp_async_wait<1>();
    } else {
      vc::tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = sm + L::K + st * BK * LD;
    const bf16* Vs = sm + L::V + st * BK * LD;
    const int* Mt = Ms + st * BK;

    // S = Q K^T: the warp's 16 rows x 64 keys, 8 n-tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      vc::tc::load_a(a, Qs, LD, wr, ks * 16);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bb[4];
        vc::tc::load_b(bb, Ks, LD, np * 16, ks * 16);
        vc::tc::mma(s[2 * np], a, bb[0], bb[1]);
        vc::tc::mma(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    // + bias, + (mask - 1) * 1e9, in the plain version's order
    if (bp != nullptr) {
      const bf16* Bs = sm + L::B + st * BQ * LB;
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bb[4];
        vc::tc::load_a(bb, Bs, LB, wr, np * 16);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 lo = vc::tc::unpack(bb[2 * half]), hi = vc::tc::unpack(bb[2 * half + 1]);
          float* c = s[2 * np + half];
          c[0] += lo.x;
          c[1] += lo.y;
          c[2] += hi.x;
          c[3] += hi.y;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float m0 = ((float)Mt[n * 8 + 2 * t] - 1.f) * 1e9f;
      const float m1 = ((float)Mt[n * 8 + 2 * t + 1] - 1.f) * 1e9f;
      s[n][0] += m0;
      s[n][1] += m1;
      s[n][2] += m0;
      s[n][3] += m1;
    }

    // online softmax; rows g (elements 0, 1) and g + 8 (elements 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx);
      const float sc = exp2f((m[r] - mn) * LOG2E);
      m[r] = mn;
      l[r] *= sc;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * r] *= sc;
        o[j][2 * r + 1] *= sc;
      }
      if constexpr (SPLIT) {
        // n-tile n (lower half) and n + BK/16 (its partners in the upper half)
        const int row = q0 + wr + g + 8 * r;
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float lo = exp2f((s[n][2 * r + e] - mn) * LOG2E);
            float hi = exp2f((s[n + BK / 16][2 * r + e] - mn) * LOG2E);
            l[r] += lo + hi;  // the row sum takes p before dropout
            const unsigned x = vc::keep_hash(mixed, row, k0 + n * 8 + 2 * t + e, lk_half);
            s[n][2 * r + e] = lo * vc::keep_bits(dr, x & 0xFFFFu);
            s[n + BK / 16][2 * r + e] = hi * vc::keep_bits(dr, x >> 16);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f((s[n][2 * r + e] - mn) * LOG2E);
            l[r] += p;
            s[n][2 * r + e] = p;
          }
        }
      }
    }

    // O += P V, P rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {vc::tc::pack(s[2 * kk][0], s[2 * kk][1]),
                             vc::tc::pack(s[2 * kk][2], s[2 * kk][3]),
                             vc::tc::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             vc::tc::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        vc::tc::load_b_kn(bb, Vs, LD, kk * 16, dp * 16);
        vc::tc::mma(o[2 * dp], a, bb[0], bb[1]);
        vc::tc::mma(o[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  bf16* op = out + bh * Lq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + wr + g + 8 * r;
    if (row >= Lq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + (long)row * D + j * 8 + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if (lse != nullptr && t == 0) lse[bh * Lq + row] = m[r] + logf(l[r]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* key_mask, void* out, void* lse, int B, int H, int Lq, int Lk,
           vc::Dropout dr, cudaStream_t stream) {
  // the split walk pays only where the hash runs (PERF.md, the kernel table)
  auto kern = dr.on ? fused_attention_fwd_tc<D, true> : fused_attention_fwd_tc<D, false>;
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(bias), static_cast<const int*>(key_mask),
      static_cast<bf16*>(out), static_cast<float*>(lse), H, Lq, Lk, dr);
  return (int)cudaGetLastError();
}

int dispatch_d(const void* q, const void* k, const void* v, const void* bias,
               const void* key_mask, void* out, void* lse, int B, int H, int Lq, int Lk,
               int D, vc::Dropout dr, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32>(q, k, v, bias, key_mask, out, lse, B, H, Lq, Lk, dr, stream);
    case 64: return launch<64>(q, k, v, bias, key_mask, out, lse, B, H, Lq, Lk, dr, stream);
    case 128: return launch<128>(q, k, v, bias, key_mask, out, lse, B, H, Lq, Lk, dr, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tcfwd

}  // namespace

// q [B,H,Lq,D], k/v [B,H,Lk,D], bias [1,H,Lq,Lk] or null, key_mask [B,Lk] int32,
// out [B,H,Lq,D], lse [B,H,Lq] float32 or null; all contiguous and 16-byte
// aligned, Lk a multiple of 64, D in {32, 64, 128}. Dropout when use_dropout:
// seed, the 16-bit threshold and the float32 scale of a kept probability;
// h0, the model's index of head 0 (a rank's first head under tensor
// parallelism), which the keep mask hashes.
extern "C" int fused_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* key_mask, void* out,
                                   void* lse, int B, int H, int Lq, int Lk, int D, int dtype,
                                   unsigned seed, int use_dropout, int thresh, float inv,
                                   int h0, void* stream) {
  if (Lk % BK != 0 || Lq <= 0 || B <= 0 || H <= 0 || h0 < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const vc::Dropout dr{seed, use_dropout, (unsigned)thresh, inv, h0};
  if (dtype == VC_DTYPE_F32)
    return dispatch_d<float>(q, k, v, bias, key_mask, out, lse, B, H, Lq, Lk, D, dr, s);
  if (dtype == VC_DTYPE_BF16)
    return tcfwd::dispatch_d(q, k, v, bias, key_mask, out, lse, B, H, Lq, Lk, D, dr, s);
  return (int)cudaErrorInvalidValue;
}
