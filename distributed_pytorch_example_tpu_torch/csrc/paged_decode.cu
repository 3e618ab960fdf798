// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_flash_decode` / `_decode_kernel` in
// distributed_pytorch_example_tpu/ops/pallas/paged_attention.py: one query
// per batch row attends the keys at positions <= row_lens[b] of that row's
// paged KV pool, reached through its page table, with an online softmax in
// float32. Output is 0 for a row whose softmax sum is 0.
//
// Layouts (all contiguous):
//   q, out        (batch, num_heads, head_dim)               f32 or bf16
//   pages_k/v     (num_blocks, block_size, kv_heads, head_dim) same type as q
//   table         (batch, max_blocks) int32; dead entries -> scratch block 0
//   lens          (batch,) int32: absolute position of each row's query
//
// Design. The TPU grid walks the block table in order on one core and
// carries m/l/acc in VMEM scratch across grid steps. Here the grid is one
// CTA per (row b, kv head h); the sweep over the row's live blocks is a
// loop inside the CTA, and the CTA reads table[b, j] itself (Hopper has no
// scalar prefetch). The CTA's threads form sub-warps of head_dim/8 lanes;
// each sub-warp takes one key position at a time (keys kp, kp + K, ...
// for K sub-warps), each lane holding 8 of head_dim elements, so a K/V row
// is read as one 16-byte (bf16) or two 16-byte (f32) loads per lane. Every
// sub-warp keeps its own running max, sum and accumulator for each query of
// the GQA group, all in float32 registers; the sweep covers key positions
// 0 .. min(pos, max_blocks*block_size - 1), i.e. exactly the live blocks
// j < ceil((pos+1)/block_size), with the key_pos <= pos mask as the loop
// bound. At the end the sub-warps' partial softmax states are merged
// through shared memory and written as acc / l (l == 0 -> 1).
//
// Bound on this card: the kernel reads each live K/V row once and does
// ~4 flops per element read, far below the H100's ~295 flop/byte ridge, so
// HBM bandwidth (3.35 TB/s) bounds it: live KV bytes + q/out bytes.
//
// Known limitation: the grid is batch x kv_heads CTAs, 96 at the serving
// slice's 8 slots x 12 heads, fewer than the H100's 132 SMs, and each CTA
// walks its row's whole context alone. The fix is a flash-decoding split
// of the block sweep over several CTAs plus a combine pass (ROADMAP.md).
//
// Contract: no allocation, no synchronisation, launches on the caller's
// stream; the C entry returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch. Out-of-range table entries are clamped into
// the pool rather than read out of bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 8;  // elements per lane of one K/V row
constexpr float kNegInf = -1e30f;  // finite: exp() underflows to 0

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
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ pages_k,
    const T* __restrict__ pages_v, const int* __restrict__ table,
    const int* __restrict__ lens, T* __restrict__ out, int num_heads,
    int kv_heads, int block_size, int max_blocks, int num_blocks,
    float scale) {
  constexpr int kLanesPerKey = D / kVec;                 // 2 .. 16
  constexpr int kKeysPerPass = kThreads / kLanesPerKey;  // 64 .. 8

  __shared__ float sm_m[kKeysPerPass][kMaxGroup];
  __shared__ float sm_l[kKeysPerPass][kMaxGroup];
  __shared__ float sm_acc[kKeysPerPass][kMaxGroup][D];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int group = num_heads / kv_heads;
  const int sub = threadIdx.x / kLanesPerKey;
  const int d0 = (threadIdx.x % kLanesPerKey) * kVec;

  // this kv head's group of queries, pre-scaled, in registers
  float qr[kMaxGroup][kVec];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      load8(q + ((size_t)b * num_heads + h * group + g) * D + d0, qr[g]);
#pragma unroll
      for (int i = 0; i < kVec; ++i) qr[g][i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) qr[g][i] = 0.f;
    }
  }
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][kVec];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }

  // keys past the table width are invisible (the reference's key_pos range)
  const int last = min(lens[b], max_blocks * block_size - 1);
  const int* row_table = table + (size_t)b * max_blocks;
  // uniform trip count across the CTA, so every lane reaches the shuffles
  for (int kp0 = 0; kp0 <= last; kp0 += kKeysPerPass) {
    const int kp = kp0 + sub;
    const bool live = kp <= last;
    float kx[kVec], vx[kVec];
    if (live) {
      const int j = kp / block_size;
      const int o = kp - j * block_size;
      const int blk = min(max(row_table[j], 0), num_blocks - 1);
      const size_t off =
          (((size_t)blk * block_size + o) * kv_heads + h) * D + d0;
      load8(pages_k + off, kx);
      load8(pages_v + off, vx);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) kx[i] = vx[i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) s += qr[g][i] * kx[i];
#pragma unroll
        for (int w = kLanesPerKey / 2; w > 0; w >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, w);
        if (live) {
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[g][i] = acc[g][i] * alpha + p * vx[i];
          m[g] = m_new;
        }
      }
    }
  }

  // merge the sub-warps' partial softmax states
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
    for (int s = 0; s < kKeysPerPass; ++s) mx = fmaxf(mx, sm_m[s][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int s = 0; s < kKeysPerPass; ++s) {
      const float w = expf(sm_m[s][g] - mx);
      lsum += sm_l[s][g] * w;
      a += sm_acc[s][g][d] * w;
    }
    const float safe_l = lsum == 0.f ? 1.f : lsum;
    store1(out + ((size_t)b * num_heads + h * group + g) * D + d, a / safe_l);
  }
}

template <typename T, int D>
void launch(const void* q, const void* pk, const void* pv, const int* table,
            const int* lens, void* out, int batch, int num_heads,
            int kv_heads, int block_size, int max_blocks, int num_blocks,
            float scale, cudaStream_t stream) {
  const dim3 grid(batch, kv_heads);
  if (num_heads == kv_heads) {
    paged_decode_kernel<T, D, 1><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(pk),
        static_cast<const T*>(pv), table, lens, static_cast<T*>(out),
        num_heads, kv_heads, block_size, max_blocks, num_blocks, scale);
  } else {
    paged_decode_kernel<T, D, 8><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(pk),
        static_cast<const T*>(pv), table, lens, static_cast<T*>(out),
        num_heads, kv_heads, block_size, max_blocks, num_blocks, scale);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 16, 32, 64 or 128. num_heads /
// kv_heads <= 8. The Python wrapper checks all of this before calling.
extern "C" int dpx_paged_decode(int dtype, const void* q, const void* pages_k,
                                const void* pages_v, const int* table,
                                const int* lens, void* out, int batch,
                                int num_heads, int kv_heads, int head_dim,
                                int block_size, int max_blocks, int num_blocks,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || kv_heads < 1 || num_heads % kv_heads != 0 ||
      num_heads / kv_heads > 8 || block_size < 1 || max_blocks < 1 ||
      num_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dims[4] = {16, 32, 64, 128};
  if ((dtype != 0 && dtype != 1) ||
      (head_dim != dims[0] && head_dim != dims[1] && head_dim != dims[2] &&
       head_dim != dims[3])) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define DPX_LAUNCH(T, D)                                                     \
  launch<T, D>(q, pages_k, pages_v, table, lens, out, batch, num_heads,      \
               kv_heads, block_size, max_blocks, num_blocks, scale, s)
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
