// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of distributed_pytorch_example_tpu/ops/pallas/
// flash_attention.py: the forward `_fwd` / `_fwd_kernel` and its one-block
// variant `_fwd_single` / `_fwd_single_kernel`, and the backward `_bwd` /
// `_bwd_fused_kernel`, `_bwd_single` / `_bwd_single_kernel` and `_bwd_split`
// / `_dq_kernel` + `_dkv_kernel`. Those grid variants are VMEM scheduling
// choices for the TPU; here one forward kernel and one backward pair compute
// the same function at every shape the wrapper accepts.
//
// Semantics held exactly (each is a TPU-kernel contract):
//   - logits s = (q . k) * scale in float32; top-left causal mask row >= col;
//     kv_mask (B, Sk) float, a key counts when mask > 0;
//   - a masked logit is NEG_INF = -1e30, a finite value;
//   - P is cast to v's type before P.V (and to do/q/k's type in the
//     backward products); every product accumulates in float32;
//   - a row with no valid key (m == NEG_INF) gives output 0, lse NEG_INF
//     and zero gradients;
//   - GQA: query head n reads kv head n / group; dk/dv sum the group.
//
// Layouts. q, k, v, o, do, dq, dk, dv are (B, S, heads, H) with the head
// dimension contiguous; the other three strides come from the caller, so the
// (B, S, N, H) projections are read in place with no transpose. lse and
// delta are (B, N, Sq) float32.
//
// Design. A TPU grid walks k blocks in order on one core and carries
// m/l/acc in VMEM; CUDA blocks run in parallel and in no order. So:
//   - forward: one CTA per (q tile, head, batch) loops over k tiles up to
//     the diagonal, with the online-softmax state m, l and the output
//     accumulator in float32 shared memory;
//   - backward, two deterministic kernels and no atomics (the TPU's
//     `_bwd_split`): dq with one CTA per (q tile, head, batch) looping over
//     k tiles; dk/dv with one CTA per (k tile, kv head, batch) looping over
//     the group's query heads and their q tiles, which sums the GQA group in
//     place. delta = rowsum(dO * O) comes from a small kernel first.
// The products run on the tensor cores for bf16 (nvcuda::wmma 16x16x16,
// float32 accumulators) and as float32 FMAs for float32. Tiles are 64 rows,
// or 32 where 64 would not fit the 227 KB of shared memory (bf16 at head_dim
// 256, float32 at 128 and 256); above 48 KB the launch asks for dynamic
// shared memory with cudaFuncSetAttribute.
//
// Bound on this card: attention at GPT-2's shapes (S = 1024, H = 64) does
// 2*S*H flops per query per product against 8*H bytes of q/k/v/o per row,
// far above the H100's ~295 flop/byte ridge, so the bf16 tensor-core rate
// (989 TFLOP/s) bounds it. This first version is far from that: wmma goes
// through shared memory, every tile waits on its loads (no cp.async/TMA
// pipeline), and the causal diagonal leaves CTAs unbalanced. wgmma, TMA and
// warp specialisation come in a later version (ROADMAP.md, queue 2).
//
// Contract: no allocation, no synchronisation, launches on the caller's
// stream; each C entry returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments it does not take) so the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Tile geometry. Row pitches are padded by 16 bytes (T tiles) or 4 floats
// (float tiles): rows stay 16-byte aligned for vector loads and wmma, and
// neighbouring rows start in different shared-memory banks.
template <typename T, int H>
struct Cfg {
  static constexpr int kTile =
      sizeof(T) == 2 ? (H <= 128 ? 64 : 32) : (H <= 64 ? 64 : 32);
  static constexpr int kPad = 16 / (int)sizeof(T);
  static constexpr int kLd = H + kPad;       // T tiles of H columns
  static constexpr int kLdP = kTile + kPad;  // T tiles of kTile columns
  static constexpr int kLdS = kTile + 4;     // float tiles of kTile columns
  static constexpr int kLdO = H + 4;         // float tiles of H columns
};

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) & ~size_t(127);
}

__device__ __forceinline__ char* carve(char*& p, size_t bytes) {
  char* r = p;
  p += align128(bytes);
  return r;
}

template <typename T, int H>
constexpr size_t fwd_smem() {
  using C = Cfg<T, H>;
  return 3 * align128(sizeof(T) * C::kTile * C::kLd) +
         align128(sizeof(float) * C::kTile * C::kLdS) +
         align128(sizeof(T) * C::kTile * C::kLdP) +
         align128(sizeof(float) * C::kTile * C::kLdO) +
         4 * align128(sizeof(float) * C::kTile);
}

template <typename T, int H>
constexpr size_t dq_smem() {
  using C = Cfg<T, H>;
  return 4 * align128(sizeof(T) * C::kTile * C::kLd) +
         2 * align128(sizeof(float) * C::kTile * C::kLdS) +
         align128(sizeof(T) * C::kTile * C::kLdP) +
         align128(sizeof(float) * C::kTile * C::kLdO) +
         3 * align128(sizeof(float) * C::kTile);
}

template <typename T, int H>
constexpr size_t dkv_smem() {
  using C = Cfg<T, H>;
  return 4 * align128(sizeof(T) * C::kTile * C::kLd) +
         2 * align128(sizeof(float) * C::kTile * C::kLdS) +
         2 * align128(sizeof(T) * C::kTile * C::kLdP) +
         2 * align128(sizeof(float) * C::kTile * C::kLdO) +
         3 * align128(sizeof(float) * C::kTile);
}

// rows x H tile from global (row r at src + r * row_stride) into shared
// memory with pitch LD, 16 bytes per thread per step.
template <typename T, int H, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int rows) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kPerRow = H / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + c);
  }
}

// C[M x N] (float, pitch ldc) = (or +=, with ACC) A[M x K] * B[K x N], all
// operands in shared memory. A(i, k) is A[k * lda + i] when A_COL, else
// A[i * lda + k]; B(k, j) is B[j * ldb + k] when B_COL, else B[k * ldb + j].
// Every thread of the CTA calls it; the caller synchronises around it.
template <typename T, int M, int N, int K, bool A_COL, bool B_COL, bool ACC>
__device__ __forceinline__ void tile_mma(const T* A, int lda, const T* B,
                                         int ldb, float* C, int ldc) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using ALayout = typename std::conditional<A_COL, wmma::col_major,
                                              wmma::row_major>::type;
    using BLayout = typename std::conditional<B_COL, wmma::col_major,
                                              wmma::row_major>::type;
    constexpr int kFn = N / 16;
    constexpr int kFrags = (M / 16) * kFn;
    const int warp = threadIdx.x / 32;
    for (int f = warp; f < kFrags; f += kWarps) {
      const int i0 = (f / kFn) * 16;
      const int j0 = (f % kFn) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if constexpr (ACC) {
        wmma::load_matrix_sync(c, C + i0 * ldc + j0, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(c, 0.f);
      }
#pragma unroll 4
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b;
        wmma::load_matrix_sync(a, A_COL ? A + k0 * lda + i0 : A + i0 * lda + k0,
                               lda);
        wmma::load_matrix_sync(b, B_COL ? B + j0 * ldb + k0 : B + k0 * ldb + j0,
                               ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + i0 * ldc + j0, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int e = threadIdx.x; e < M * N; e += kThreads) {
      const int i = e / N;
      const int j = e - i * N;
      float s = ACC ? C[i * ldc + j] : 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        s += to_f(A_COL ? A[k * lda + i] : A[i * lda + k]) *
             to_f(B_COL ? B[j * ldb + k] : B[k * ldb + j]);
      }
      C[i * ldc + j] = s;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, w));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

// strides in elements, [batch, seq, head] per tensor
struct Strides {
  long long b, s, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;   // forward: output; backward: the forward's output
  const void* dout;
  const float* mask;  // (B, Sk) or null
  float* lse;         // (B, N, Sq)
  float* delta;       // (B, N, Sq), backward only
  void* out;          // forward: o; backward: dq
  void* dk;
  void* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int batch, heads, kv_heads, seq_q, seq_k, causal;
  float scale;
};

__device__ __forceinline__ bool key_masked(const Args& a, const float* smask,
                                           int q_pos, int k_pos, int c) {
  return (a.causal && k_pos > q_pos) || (a.mask && !(smask[c] > 0.f));
}

// ---------------------------------------------------------------------------
// forward: o and lse
// ---------------------------------------------------------------------------

template <typename T, int H>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  using C = Cfg<T, H>;
  constexpr int BT = C::kTile;
  constexpr int kPer = BT / 32;
  extern __shared__ __align__(128) char smem[];
  char* p = smem;
  T* sQ = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLd));
  T* sK = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLd));
  T* sV = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLd));
  float* sS = reinterpret_cast<float*>(carve(p, sizeof(float) * BT * C::kLdS));
  T* sP = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLdP));
  float* sO = reinterpret_cast<float*>(carve(p, sizeof(float) * BT * C::kLdO));
  float* sM = reinterpret_cast<float*>(carve(p, sizeof(float) * BT));
  float* sL = reinterpret_cast<float*>(carve(p, sizeof(float) * BT));
  float* sA = reinterpret_cast<float*>(carve(p, sizeof(float) * BT));
  float* sMask = reinterpret_cast<float*>(carve(p, sizeof(float) * BT));

  const int qt = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (a.heads / a.kv_heads);
  const int q0 = qt * BT;
  const T* qg = static_cast<const T*>(a.q) + b * a.sq.b + q0 * a.sq.s + n * a.sq.h;
  const T* kg = static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<T, H, C::kLd>(sQ, qg, a.sq.s, BT);
  for (int i = threadIdx.x; i < BT * H; i += kThreads) {
    sO[(i / H) * C::kLdO + i % H] = 0.f;
  }
  for (int i = threadIdx.x; i < BT; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }
  // causal: k tiles past the diagonal hold no visible key for this tile
  const int n_kt = a.causal ? min(a.seq_k / BT, qt + 1) : a.seq_k / BT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    load_tile<T, H, C::kLd>(sK, kg + k0 * a.sk.s, a.sk.s, BT);
    load_tile<T, H, C::kLd>(sV, vg + k0 * a.sv.s, a.sv.s, BT);
    if (a.mask) {
      for (int i = threadIdx.x; i < BT; i += kThreads) {
        sMask[i] = a.mask[(long long)b * a.seq_k + k0 + i];
      }
    }
    __syncthreads();
    tile_mma<T, BT, BT, H, false, true, false>(sQ, C::kLd, sK, C::kLd, sS,
                                               C::kLdS);
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < BT; r += kWarps) {
      float s[kPer];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int c = lane + 32 * t;
        const float x = sS[r * C::kLdS + c] * a.scale;
        s[t] = key_masked(a, sMask, q0 + r, k0 + c, c) ? kNegInf : x;
        mx = fmaxf(mx, s[t]);
      }
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const float pr = expf(s[t] - m_new);
        sum += pr;
        sP[r * C::kLdP + lane + 32 * t] = from_f<T>(pr);
      }
      sum = warp_sum(sum);  // every lane has read sM[r] by now
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BT * H; i += kThreads) {
      const int r = i / H;
      sO[r * C::kLdO + i % H] *= sA[r];
    }
    __syncthreads();
    tile_mma<T, BT, H, BT, false, false, true>(sP, C::kLdP, sV, C::kLd, sO,
                                               C::kLdO);
    __syncthreads();
  }
  T* og = static_cast<T*>(a.out) + b * a.so.b + q0 * a.so.s + n * a.so.h;
  for (int i = threadIdx.x; i < BT * H; i += kThreads) {
    const int r = i / H, d = i % H;
    const float l = sL[r];
    const float val =
        sM[r] == kNegInf ? 0.f : sO[r * C::kLdO + d] / (l == 0.f ? 1.f : l);
    og[r * a.so.s + d] = from_f<T>(val);
  }
  for (int r = threadIdx.x; r < BT; r += kThreads) {
    const float l = sL[r];
    a.lse[((long long)b * a.heads + n) * a.seq_q + q0 + r] =
        sM[r] == kNegInf ? kNegInf : sM[r] + logf(l == 0.f ? 1.f : l);
  }
}

// ---------------------------------------------------------------------------
// backward: delta, dq, dk/dv
// ---------------------------------------------------------------------------

template <typename T, int H>
__global__ void __launch_bounds__(kThreads) flash_delta_kernel(Args a) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const long long rows = (long long)a.batch * a.seq_q * a.heads;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int n = row % a.heads;
  const int s = (row / a.heads) % a.seq_q;
  const int b = row / ((long long)a.heads * a.seq_q);
  const T* o = static_cast<const T*>(a.o) + b * a.so.b + s * a.so.s + n * a.so.h;
  const T* d = static_cast<const T*>(a.dout) + b * a.sdo.b + s * a.sdo.s +
               n * a.sdo.h;
  float acc = 0.f;
  for (int i = lane; i < H; i += 32) acc += to_f(o[i]) * to_f(d[i]);
  acc = warp_sum(acc);
  if (lane == 0) a.delta[((long long)b * a.heads + n) * a.seq_q + s] = acc;
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  using C = Cfg<T, H>;
  constexpr int BT = C::kTile;
  extern __shared__ __align__(128) char smem[];
  char* p = smem;
  T* sQ = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLd));
  T* sDO = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLd));
  T* sK = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLd));
  T* sV = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLd));
  float* sS = reinterpret_cast<float*>(carve(p, sizeof(float) * BT * C::kLdS));
  float* sDP = reinterpret_cast<float*>(carve(p, sizeof(float) * BT * C::kLdS));
  T* sDS = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLdP));
  float* sDQ = reinterpret_cast<float*>(carve(p, sizeof(float) * BT * C::kLdO));
  float* sLse = reinterpret_cast<float*>(carve(p, sizeof(float) * BT));
  float* sDelta = reinterpret_cast<float*>(carve(p, sizeof(float) * BT));
  float* sMask = reinterpret_cast<float*>(carve(p, sizeof(float) * BT));

  const int qt = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (a.heads / a.kv_heads);
  const int q0 = qt * BT;
  const long long row0 = ((long long)b * a.heads + n) * a.seq_q + q0;
  load_tile<T, H, C::kLd>(
      sQ, static_cast<const T*>(a.q) + b * a.sq.b + q0 * a.sq.s + n * a.sq.h,
      a.sq.s, BT);
  load_tile<T, H, C::kLd>(
      sDO,
      static_cast<const T*>(a.dout) + b * a.sdo.b + q0 * a.sdo.s + n * a.sdo.h,
      a.sdo.s, BT);
  for (int i = threadIdx.x; i < BT * H; i += kThreads) {
    sDQ[(i / H) * C::kLdO + i % H] = 0.f;
  }
  for (int i = threadIdx.x; i < BT; i += kThreads) {
    sLse[i] = a.lse[row0 + i];
    sDelta[i] = a.delta[row0 + i];
  }
  const T* kg = static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int n_kt = a.causal ? min(a.seq_k / BT, qt + 1) : a.seq_k / BT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    load_tile<T, H, C::kLd>(sK, kg + k0 * a.sk.s, a.sk.s, BT);
    load_tile<T, H, C::kLd>(sV, vg + k0 * a.sv.s, a.sv.s, BT);
    if (a.mask) {
      for (int i = threadIdx.x; i < BT; i += kThreads) {
        sMask[i] = a.mask[(long long)b * a.seq_k + k0 + i];
      }
    }
    __syncthreads();
    tile_mma<T, BT, BT, H, false, true, false>(sQ, C::kLd, sK, C::kLd, sS,
                                               C::kLdS);
    tile_mma<T, BT, BT, H, false, true, false>(sDO, C::kLd, sV, C::kLd, sDP,
                                               C::kLdS);
    __syncthreads();
    // p from the saved lse (re-masked: a dead row's lse is NEG_INF), then
    // ds = p * (dp - delta) * scale
    for (int i = threadIdx.x; i < BT * BT; i += kThreads) {
      const int r = i / BT, c = i % BT;
      const float pr =
          key_masked(a, sMask, q0 + r, k0 + c, c)
              ? 0.f
              : expf(sS[r * C::kLdS + c] * a.scale - sLse[r]);
      sDS[r * C::kLdP + c] =
          from_f<T>(pr * (sDP[r * C::kLdS + c] - sDelta[r]) * a.scale);
    }
    __syncthreads();
    tile_mma<T, BT, H, BT, false, false, true>(sDS, C::kLdP, sK, C::kLd, sDQ,
                                               C::kLdO);
    __syncthreads();
  }
  T* dq = static_cast<T*>(a.out) + b * a.sdq.b + q0 * a.sdq.s + n * a.sdq.h;
  for (int i = threadIdx.x; i < BT * H; i += kThreads) {
    const int r = i / H, d = i % H;
    dq[r * a.sdq.s + d] = from_f<T>(sDQ[r * C::kLdO + d]);
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  using C = Cfg<T, H>;
  constexpr int BT = C::kTile;
  extern __shared__ __align__(128) char smem[];
  char* p = smem;
  T* sK = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLd));
  T* sV = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLd));
  T* sQ = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLd));
  T* sDO = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLd));
  float* sS = reinterpret_cast<float*>(carve(p, sizeof(float) * BT * C::kLdS));
  float* sDP = reinterpret_cast<float*>(carve(p, sizeof(float) * BT * C::kLdS));
  T* sP = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLdP));
  T* sDS = reinterpret_cast<T*>(carve(p, sizeof(T) * BT * C::kLdP));
  float* sDK = reinterpret_cast<float*>(carve(p, sizeof(float) * BT * C::kLdO));
  float* sDV = reinterpret_cast<float*>(carve(p, sizeof(float) * BT * C::kLdO));
  float* sLse = reinterpret_cast<float*>(carve(p, sizeof(float) * BT));
  float* sDelta = reinterpret_cast<float*>(carve(p, sizeof(float) * BT));
  float* sMask = reinterpret_cast<float*>(carve(p, sizeof(float) * BT));

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = a.heads / a.kv_heads;
  const int k0 = kt * BT;
  load_tile<T, H, C::kLd>(
      sK, static_cast<const T*>(a.k) + b * a.sk.b + k0 * a.sk.s + kvh * a.sk.h,
      a.sk.s, BT);
  load_tile<T, H, C::kLd>(
      sV, static_cast<const T*>(a.v) + b * a.sv.b + k0 * a.sv.s + kvh * a.sv.h,
      a.sv.s, BT);
  for (int i = threadIdx.x; i < BT * H; i += kThreads) {
    sDK[(i / H) * C::kLdO + i % H] = 0.f;
    sDV[(i / H) * C::kLdO + i % H] = 0.f;
  }
  if (a.mask) {
    for (int i = threadIdx.x; i < BT; i += kThreads) {
      sMask[i] = a.mask[(long long)b * a.seq_k + k0 + i];
    }
  }
  // causal: q tiles before this k tile's diagonal see none of its keys
  const int qt0 = a.causal ? kt : 0;
  for (int g = 0; g < group; ++g) {
    const int n = kvh * group + g;
    for (int qt = qt0; qt < a.seq_q / BT; ++qt) {
      const int q0 = qt * BT;
      const long long row0 = ((long long)b * a.heads + n) * a.seq_q + q0;
      load_tile<T, H, C::kLd>(
          sQ, static_cast<const T*>(a.q) + b * a.sq.b + q0 * a.sq.s + n * a.sq.h,
          a.sq.s, BT);
      load_tile<T, H, C::kLd>(sDO,
                              static_cast<const T*>(a.dout) + b * a.sdo.b +
                                  q0 * a.sdo.s + n * a.sdo.h,
                              a.sdo.s, BT);
      for (int i = threadIdx.x; i < BT; i += kThreads) {
        sLse[i] = a.lse[row0 + i];
        sDelta[i] = a.delta[row0 + i];
      }
      __syncthreads();
      tile_mma<T, BT, BT, H, false, true, false>(sQ, C::kLd, sK, C::kLd, sS,
                                                 C::kLdS);
      tile_mma<T, BT, BT, H, false, true, false>(sDO, C::kLd, sV, C::kLd, sDP,
                                                 C::kLdS);
      __syncthreads();
      for (int i = threadIdx.x; i < BT * BT; i += kThreads) {
        const int r = i / BT, c = i % BT;
        const float pr =
            key_masked(a, sMask, q0 + r, k0 + c, c)
                ? 0.f
                : expf(sS[r * C::kLdS + c] * a.scale - sLse[r]);
        sP[r * C::kLdP + c] = from_f<T>(pr);
        sDS[r * C::kLdP + c] =
            from_f<T>(pr * (sDP[r * C::kLdS + c] - sDelta[r]) * a.scale);
      }
      __syncthreads();
      // dv += p^T dO ; dk += ds^T q
      tile_mma<T, BT, H, BT, true, false, true>(sP, C::kLdP, sDO, C::kLd, sDV,
                                                C::kLdO);
      tile_mma<T, BT, H, BT, true, false, true>(sDS, C::kLdP, sQ, C::kLd, sDK,
                                                C::kLdO);
      __syncthreads();
    }
  }
  __syncthreads();  // the q loop may be empty (causal, seq_q < seq_k)
  T* dk = static_cast<T*>(a.dk) + b * a.sdk.b + k0 * a.sdk.s + kvh * a.sdk.h;
  T* dv = static_cast<T*>(a.dv) + b * a.sdv.b + k0 * a.sdv.s + kvh * a.sdv.h;
  for (int i = threadIdx.x; i < BT * H; i += kThreads) {
    const int r = i / H, d = i % H;
    dk[r * a.sdk.s + d] = from_f<T>(sDK[r * C::kLdO + d]);
    dv[r * a.sdv.s + d] = from_f<T>(sDV[r * C::kLdO + d]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes)
             : cudaSuccess;
}

template <typename T, int H>
int launch_fwd(const Args& a, cudaStream_t stream) {
  using C = Cfg<T, H>;
  constexpr size_t smem = fwd_smem<T, H>();
  static const cudaError_t err = allow_smem(flash_fwd_kernel<T, H>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.seq_q / C::kTile, a.heads, a.batch);
  flash_fwd_kernel<T, H><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int H>
int launch_bwd(const Args& a, cudaStream_t stream) {
  using C = Cfg<T, H>;
  constexpr size_t dq_bytes = dq_smem<T, H>();
  constexpr size_t dkv_bytes = dkv_smem<T, H>();
  static const cudaError_t dq_attr = allow_smem(flash_dq_kernel<T, H>, dq_bytes);
  static const cudaError_t dkv_attr =
      allow_smem(flash_dkv_kernel<T, H>, dkv_bytes);
  if (dq_attr != cudaSuccess) return (int)dq_attr;
  if (dkv_attr != cudaSuccess) return (int)dkv_attr;
  cudaError_t err;
  const long long rows = (long long)a.batch * a.seq_q * a.heads;
  flash_delta_kernel<T, H>
      <<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_dq_kernel<T, H><<<dim3(a.seq_q / C::kTile, a.heads, a.batch), kThreads,
                          dq_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_dkv_kernel<T, H><<<dim3(a.seq_k / C::kTile, a.kv_heads, a.batch),
                           kThreads, dkv_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int tile_for(int head_dim) {
  switch (head_dim) {
    case 64: return Cfg<T, 64>::kTile;
    case 128: return Cfg<T, 128>::kTile;
    case 256: return Cfg<T, 256>::kTile;
    default: return 0;
  }
}

// Cfg's kTile for this dtype and head_dim; 0 where no kernel is built.
int tile_of(int dtype, int head_dim) {
  if (dtype == 0) return tile_for<float>(head_dim);
  if (dtype == 1) return tile_for<__nv_bfloat16>(head_dim);
  return 0;
}

bool valid(int dtype, int head_dim, int batch, int heads, int kv_heads,
           int seq_q, int seq_k) {
  const int tile = tile_of(dtype, head_dim);
  if (tile == 0) return false;
  if (batch < 1 || kv_heads < 1 || heads % kv_heads != 0) return false;
  return seq_q > 0 && seq_k > 0 && seq_q % tile == 0 && seq_k % tile == 0;
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <int (*F32)(const Args&, cudaStream_t), int (*BF16)(const Args&, cudaStream_t)>
int pick(int dtype, const Args& a, cudaStream_t s) {
  return dtype == 0 ? F32(a, s) : BF16(a, s);
}

}  // namespace

// Rows per tile of the kernels for a dtype (0 = float32, 1 = bfloat16) and
// head_dim, or 0 where there is no kernel. Sequence lengths must divide by
// it; the Python wrapper reads it from here.
extern "C" int dpx_flash_tile(int dtype, int head_dim) {
  return tile_of(dtype, head_dim);
}

// dtype: 0 = float32, 1 = bfloat16; head_dim 64, 128 or 256; heads % kv_heads
// == 0; seq_q and seq_k multiples of dpx_flash_tile. strides: 12 int64,
// [batch, seq, head] for q, k, v, o. mask: (B, Sk) float32 or null. The
// Python wrapper checks all of this before calling.
extern "C" int dpx_flash_fwd(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, const float* mask,
                             void* o, float* lse, int batch, int heads,
                             int kv_heads, int seq_q, int seq_k,
                             const long long* strides, float scale, int causal,
                             void* stream) {
  if (!valid(dtype, head_dim, batch, heads, kv_heads, seq_q, seq_k)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.out = o;
  a.lse = lse;
  a.sq = strides_at(strides, 0);
  a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2);
  a.so = strides_at(strides, 3);
  a.batch = batch;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.seq_q = seq_q;
  a.seq_k = seq_k;
  a.causal = causal;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return pick<launch_fwd<float, 64>, launch_fwd<__nv_bfloat16, 64>>(dtype, a, s);
  if (head_dim == 128) return pick<launch_fwd<float, 128>, launch_fwd<__nv_bfloat16, 128>>(dtype, a, s);
  return pick<launch_fwd<float, 256>, launch_fwd<__nv_bfloat16, 256>>(dtype, a, s);
}

// Launches delta = rowsum(do * o), then the dq kernel, then the dk/dv
// kernel. strides: 24 int64, [batch, seq, head] for q, k, v, o, do, dq, dk,
// dv. delta: (B, N, Sq) float32 scratch.
extern "C" int dpx_flash_bwd(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, const void* o,
                             const void* dout, const float* lse,
                             const float* mask, float* delta, void* dq,
                             void* dk, void* dv, int batch, int heads,
                             int kv_heads, int seq_q, int seq_k,
                             const long long* strides, float scale, int causal,
                             void* stream) {
  if (!valid(dtype, head_dim, batch, heads, kv_heads, seq_q, seq_k)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.mask = mask;
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  a.out = dq;
  a.dk = dk;
  a.dv = dv;
  a.sq = strides_at(strides, 0);
  a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2);
  a.so = strides_at(strides, 3);
  a.sdo = strides_at(strides, 4);
  a.sdq = strides_at(strides, 5);
  a.sdk = strides_at(strides, 6);
  a.sdv = strides_at(strides, 7);
  a.batch = batch;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.seq_q = seq_q;
  a.seq_k = seq_k;
  a.causal = causal;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return pick<launch_bwd<float, 64>, launch_bwd<__nv_bfloat16, 64>>(dtype, a, s);
  if (head_dim == 128) return pick<launch_bwd<float, 128>, launch_bwd<__nv_bfloat16, 128>>(dtype, a, s);
  return pick<launch_bwd<float, 256>, launch_bwd<__nv_bfloat16, 256>>(dtype, a, s);
}
