// Paged flash-decode attention for Hopper (sm_90a): a split-KV sweep and a
// fixed-order combine.
//
// Replaces the TPU kernel `_decode_kernel` (launched by `paged_flash_decode`)
// in distributed_pytorch_example_tpu/ops/pallas/paged_attention.py: one query
// per batch row attends the keys at positions <= row_lens[b] of that row's
// paged KV pool, reached through its page table, with an online softmax in
// float32. Keys past the table (max_blocks * block_size - 1) are invisible,
// table entries are clamped into the pool, and a row whose softmax sum is 0
// gets an output of 0.
//
// Layouts (all contiguous):
//   q, out        (batch, num_heads, head_dim)               f32 or bf16
//   pages_k/v     (num_blocks, block_size, kv_heads, head_dim) same type as q
//   table         (batch, max_blocks) int32; dead entries -> scratch block 0
//   lens          (batch,) int32: absolute position of each row's query
//   partials      float32 scratch of batch * num_heads * S * (head_dim + 2):
//                 acc (batch, num_heads, S, head_dim), then m and l
//                 (batch, num_heads, S) each; unused when S == 1
//
// Bound on this card: every live K/V row is read once, with ~4 flops per
// element read, far below the H100's ~295 flop/byte ridge, so HBM bandwidth
// (3.35 TB/s) bounds it: the live K/V bytes + q + out + table + lens.
//
// Design. The TPU grid (batch, kv_heads, max_blocks) walks a row's blocks in
// order on one core and carries m/l/acc in VMEM across grid steps. On Hopper
// nothing carries between CTAs, and one CTA per (row, head) walking its row
// alone makes the longest row the kernel's time. So the sweep is split over
// CTAs (flash-decoding) and the partial softmax states are merged after:
//
// 1. paged_decode_split_kernel, grid (batch, kv_heads, S). The CTA reads
//    lens[b] itself: the row has n = ceil((min(pos, cap) + 1) / block_size)
//    live blocks (0 when pos < 0), cap = max_blocks * block_size - 1. With
//    c = ceil(n / S), split s takes the blocks [s*c, min(n, (s+1)*c)):
//    contiguous, at most c each, the live splits a prefix. An empty split
//    writes m = -1e30, l = 0 and acc = 0, and exits. The CTA loads lens[b],
//    the row's first 128 table entries (one per thread, into shared memory)
//    and its queries at once, so its first K/V loads wait on one round trip
//    to memory, not on lens and then the table in turn. Inside a split, the
//    threads form sub-warps of head_dim/8 lanes; each sub-warp takes one key
//    at a time, each lane 8 elements of its K and V rows (one 16-byte load
//    in bf16, two in f32), so a warp reads whole rows. Each lane issues the
//    K and V loads of kUnroll keys (4, or 2 for GQA groups, whose 8 queries'
//    states take the registers) before it uses the first, and rescales its
//    running state once per kUnroll keys (one exp per key plus one per
//    batch). The sub-warps' states merge through shared memory in order.
// 2. paged_decode_combine_kernel, one CTA per (row, head), launched by the
//    same C call on the same stream: M = max_s m_s, l = sum_s l_s e^(m_s-M),
//    o = sum_s acc_s e^(m_s-M) / (l == 0 ? 1 : l), the sums over s = 0 ..
//    S-1 in order. Every split's m, l and acc load at once into shared
//    memory first, so the merge waits on a few loads, not on 2 S in turn.
//    No atomics anywhere: two calls give the same bits.
//    With S == 1 the split kernel writes the output itself and the combine
//    is not launched.
//
// S comes from shapes only, never from the values in lens (a host read of
// lens would cost a sync per layer): the wrapper's rule
// (ops/paged_attention.py `decode_splits`) is
//     S = ceil(8 * SMs / (batch * kv_heads)), at most max_blocks, at most
//     ceil(max_blocks * block_size / 16) and at most 1024, at least 1:
// about 8 CTAs per SM, none thinner than 16 keys. At the serving shape (8
// rows x 12 heads, 64 blocks of 16, 132 SMs) S = 11 and a 1,024-key row is
// spread over 11 CTAs per head of 6 blocks each; one such row alone gets
// S = 64, one block per CTA.
//
// Why a second kernel and not a last-CTA merge behind a counter: the
// combine keeps no state between calls, so calls on other streams cannot
// share a counter and a faulted call cannot leave one stale. It costs one
// more launch inside the same C call; a last-CTA merge, timed beside it on
// the H100, was no faster (PERF.md).
//
// Contract: no allocation, no synchronisation, launches on the caller's
// stream; the C entry returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch. Out-of-range table entries are clamped into the
// pool rather than read out of bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 8;  // elements per lane of one K/V row
constexpr float kNegInf = -1e30f;  // finite: exp() underflows to 0
constexpr int kMaxSplits = 1024;  // the wrapper's rule never asks for more
constexpr int kChunk = 4096;      // acc floats the combine stages at once

__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D, int kMaxGroup>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ pages_k,
    const T* __restrict__ pages_v, const int* __restrict__ table,
    const int* __restrict__ lens, T* __restrict__ out,
    float* __restrict__ partials, int num_heads, int kv_heads,
    int block_size, int max_blocks, int num_blocks, float scale) {
  constexpr int kLanesPerKey = D / kVec;                 // 2 .. 16
  constexpr int kKeysPerPass = kThreads / kLanesPerKey;  // 64 .. 8
  constexpr int kUnroll = kMaxGroup == 1 ? 4 : 2;  // keys in flight a lane

  __shared__ float sm_m[kKeysPerPass][kMaxGroup];
  __shared__ float sm_l[kKeysPerPass][kMaxGroup];
  __shared__ float sm_acc[kKeysPerPass][kMaxGroup][D];
  __shared__ int sm_table[kThreads];  // the row's first kThreads entries

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int num_splits = gridDim.z;
  const int rows = gridDim.x * num_heads;
  const int group = num_heads / kv_heads;
  const int sub = threadIdx.x / kLanesPerKey;
  const int d0 = (threadIdx.x % kLanesPerKey) * kVec;

  // the row's first table entries, this kv head's group of queries and the
  // row's length load together, before anything waits on one of them
  const int* row_table = table + (size_t)b * max_blocks;
  const int entry = threadIdx.x < max_blocks ? row_table[threadIdx.x] : 0;
  float qr[kMaxGroup][kVec];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      load8(q + ((size_t)b * num_heads + h * group + g) * D + d0, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) qr[g][i] = 0.f;
    }
  }
  const int pos = lens[b];
  sm_table[threadIdx.x] = entry;

  // this row's live blocks and this split's contiguous share of them
  const int last = min(pos, max_blocks * block_size - 1);
  const int live_blocks = last < 0 ? 0 : last / block_size + 1;
  const int per_split = (live_blocks + num_splits - 1) / num_splits;
  const int kp_begin = s * per_split * block_size;
  const int kp_end = min((s + 1) * per_split * block_size - 1, last);

  // where (row, head h*group + g) writes: the output, or split s's partials
  float* part_acc = partials;
  float* part_m = partials + (size_t)rows * num_splits * D;
  float* part_l = part_m + (size_t)rows * num_splits;
  auto part = [&](int g) {
    return ((size_t)b * num_heads + h * group + g) * num_splits + s;
  };

  if (kp_begin > kp_end) {  // an empty split (or a row with no keys)
    for (int e = threadIdx.x; e < group * D; e += kThreads) {
      const int g = e / D;
      const int d = e - g * D;
      if (num_splits == 1) {
        store1(out + ((size_t)b * num_heads + h * group + g) * D + d, 0.f);
      } else {
        part_acc[part(g) * D + d] = 0.f;
        if (d == 0) {
          part_m[part(g)] = kNegInf;
          part_l[part(g)] = 0.f;
        }
      }
    }
    return;
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) qr[g][i] *= scale;
  }
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][kVec];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }

  __syncthreads();  // sm_table is in
  // uniform trip count across the CTA, so every lane reaches the shuffles
  for (int kp0 = kp_begin; kp0 <= kp_end; kp0 += kKeysPerPass * kUnroll) {
    // every load of the batch is issued before the first is used
    float kx[kUnroll][kVec], vx[kUnroll][kVec];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kp = kp0 + u * kKeysPerPass + sub;
      live[u] = kp <= kp_end;
      if (live[u]) {
        const int j = kp / block_size;
        const int o = kp - j * block_size;
        const int blk = min(
            max(j < kThreads ? sm_table[j] : row_table[j], 0), num_blocks - 1);
        const size_t off =
            (((size_t)blk * block_size + o) * kv_heads + h) * D + d0;
        load8(pages_k + off, kx[u]);
        load8(pages_v + off, vx[u]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kx[u][i] = vx[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {
        float sc[kUnroll];
        float m_new = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float t = 0.f;
#pragma unroll
          for (int i = 0; i < kVec; ++i) t += qr[g][i] * kx[u][i];
#pragma unroll
          for (int w = kLanesPerKey / 2; w > 0; w >>= 1)
            t += __shfl_xor_sync(0xffffffffu, t, w);
          sc[u] = t;
          if (live[u]) m_new = fmaxf(m_new, t);
        }
        const float alpha = expf(m[g] - m_new);
        l[g] *= alpha;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[g][i] *= alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (live[u]) {
            const float p = expf(sc[u] - m_new);
            l[g] += p;
#pragma unroll
            for (int i = 0; i < kVec; ++i) acc[g][i] += p * vx[u][i];
          }
        }
        m[g] = m_new;
      }
    }
  }

  // merge the sub-warps' partial softmax states, in sub-warp order
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      if (d0 == 0) {
        sm_m[sub][g] = m[g];
        sm_l[sub][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) sm_acc[sub][g][d0 + i] = acc[g][i];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < group * D; e += kThreads) {
    const int g = e / D;
    const int d = e - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int k = 0; k < kKeysPerPass; ++k) mx = fmaxf(mx, sm_m[k][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int k = 0; k < kKeysPerPass; ++k) {
      const float w = expf(sm_m[k][g] - mx);
      lsum += sm_l[k][g] * w;
      a += sm_acc[k][g][d] * w;
    }
    if (num_splits == 1) {
      const float safe_l = lsum == 0.f ? 1.f : lsum;
      store1(out + ((size_t)b * num_heads + h * group + g) * D + d,
             a / safe_l);
    } else {
      part_acc[part(g) * D + d] = a;
      if (d == 0) {
        part_m[part(g)] = mx;
        part_l[part(g)] = lsum;
      }
    }
  }
}

// One CTA per (row, head): merges the S partial states in split order. All
// m and l of the row load at once (one split per thread), then the acc rows
// in chunks of kChunk floats (up to kChunk / kThreads loads per thread in
// flight), so a merge costs a few memory latencies, not 2 S.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_combine_kernel(
    const float* __restrict__ partials, T* __restrict__ out, int rows,
    int head_dim, int num_splits) {
  __shared__ float sm_w[kMaxSplits];  // e^(m_s - M)
  __shared__ float sm_l[kMaxSplits];  // l_s e^(m_s - M)
  __shared__ float sm_max[kThreads / 32];
  __shared__ float sm_acc[kChunk];
  const int r = blockIdx.x;
  const float* acc = partials + (size_t)r * num_splits * head_dim;
  const float* m = partials + (size_t)rows * num_splits * head_dim +
                   (size_t)r * num_splits;
  const float* l = m + (size_t)rows * num_splits;

  float mx = kNegInf;
  for (int s = threadIdx.x; s < num_splits; s += kThreads) {
    sm_w[s] = m[s];
    sm_l[s] = l[s];
    mx = fmaxf(mx, sm_w[s]);
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
  if (threadIdx.x % 32 == 0) sm_max[threadIdx.x / 32] = mx;
  __syncthreads();
  mx = sm_max[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) mx = fmaxf(mx, sm_max[i]);
  for (int s = threadIdx.x; s < num_splits; s += kThreads) {
    const float w = expf(sm_w[s] - mx);
    sm_w[s] = w;
    sm_l[s] *= w;
  }

  const int d = threadIdx.x;  // head_dim <= kThreads
  const int per_chunk = kChunk / head_dim;
  float lsum = 0.f, a = 0.f;
  for (int s0 = 0; s0 < num_splits; s0 += per_chunk) {
    const int n = min(per_chunk, num_splits - s0);
    __syncthreads();  // the weights are in, the last chunk is used up
#pragma unroll
    for (int k = 0; k < kChunk / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < n * head_dim) sm_acc[i] = acc[(size_t)s0 * head_dim + i];
    }
    __syncthreads();
    if (d < head_dim) {
      for (int s = 0; s < n; ++s) {
        lsum += sm_l[s0 + s];
        a += sm_acc[s * head_dim + d] * sm_w[s0 + s];
      }
    }
  }
  if (d < head_dim) {
    store1(out + (size_t)r * head_dim + d, a / (lsum == 0.f ? 1.f : lsum));
  }
}

template <typename T, int D>
void launch(const void* q, const void* pk, const void* pv, const int* table,
            const int* lens, void* out, float* partials, int batch,
            int num_heads, int kv_heads, int block_size, int max_blocks,
            int num_blocks, int num_splits, float scale,
            cudaStream_t stream) {
  const dim3 grid(batch, kv_heads, num_splits);
  if (num_heads == kv_heads) {
    paged_decode_split_kernel<T, D, 1><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(pk),
        static_cast<const T*>(pv), table, lens, static_cast<T*>(out),
        partials, num_heads, kv_heads, block_size, max_blocks, num_blocks,
        scale);
  } else {
    paged_decode_split_kernel<T, D, 8><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(pk),
        static_cast<const T*>(pv), table, lens, static_cast<T*>(out),
        partials, num_heads, kv_heads, block_size, max_blocks, num_blocks,
        scale);
  }
  if (num_splits > 1) {
    const int rows = batch * num_heads;
    paged_decode_combine_kernel<T><<<rows, kThreads, 0, stream>>>(
        partials, static_cast<T*>(out), rows, D, num_splits);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 16, 32, 64 or 128. num_heads /
// kv_heads <= 8. 1 <= num_splits <= min(max_blocks, 1024); partials holds
// batch * num_heads * num_splits * (head_dim + 2) floats when num_splits > 1
// (it may be null otherwise). The Python wrapper checks all of this before
// calling.
extern "C" int dpx_paged_decode(int dtype, const void* q, const void* pages_k,
                                const void* pages_v, const int* table,
                                const int* lens, void* out, float* partials,
                                int batch, int num_heads, int kv_heads,
                                int head_dim, int block_size, int max_blocks,
                                int num_blocks, int num_splits, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || kv_heads < 1 || num_heads % kv_heads != 0 ||
      num_heads / kv_heads > 8 || block_size < 1 || max_blocks < 1 ||
      num_blocks < 1 || num_splits < 1 || num_splits > max_blocks ||
      num_splits > kMaxSplits ||
      (num_splits > 1 && partials == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dims[4] = {16, 32, 64, 128};
  if ((dtype != 0 && dtype != 1) ||
      (head_dim != dims[0] && head_dim != dims[1] && head_dim != dims[2] &&
       head_dim != dims[3])) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define DPX_LAUNCH(T, D)                                                     \
  launch<T, D>(q, pages_k, pages_v, table, lens, out, partials, batch,       \
               num_heads, kv_heads, block_size, max_blocks, num_blocks,      \
               num_splits, scale, s)
  if (dtype == 0) {
    if (head_dim == 16) DPX_LAUNCH(float, 16);
    else if (head_dim == 32) DPX_LAUNCH(float, 32);
    else if (head_dim == 64) DPX_LAUNCH(float, 64);
    else DPX_LAUNCH(float, 128);
  } else {
    if (head_dim == 16) DPX_LAUNCH(__nv_bfloat16, 16);
    else if (head_dim == 32) DPX_LAUNCH(__nv_bfloat16, 32);
    else if (head_dim == 64) DPX_LAUNCH(__nv_bfloat16, 64);
    else DPX_LAUNCH(__nv_bfloat16, 128);
  }
#undef DPX_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
