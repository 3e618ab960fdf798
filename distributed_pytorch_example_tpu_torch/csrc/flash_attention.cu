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
//   - GQA: query head n reads kv head n / group; dk/dv sum the group;
//   - delta = rowsum(dO * O), the softmax backward's row term. The TPU
//     kernel takes it from the bf16 output O; the bf16 backward here sums
//     it as rowsum(P * dP) from the very p and dp it forms dS with (the
//     same value in exact arithmetic), so every row of dS sums to 0 to
//     float32 rounding. With the bf16 O, where every key's v is nearly the
//     same (a deep post-LN encoder at initialisation: BERT-base's upper
//     layers), dP - delta is a small difference that O's rounding shifts
//     by a constant per row; dQ and dK then gain a component along the
//     keys' and queries' shared direction, and BERT-base's layer-11 q/k
//     kernel gradients came out 1.9x their norm off a float32 step
//     (plain bf16 attention: 4.7e-2).
//
// Layouts. q, k, v, o, do, dq, dk, dv are (B, S, heads, H) with the head
// dimension contiguous; the other three strides come from the caller, so the
// (B, S, N, H) projections are read in place with no transpose. lse and
// delta are (B, N, Sq) float32.
//
// Bound on this card: attention at GPT-2's shapes (S = 1024, H = 64) does
// 2*S*H flops per query per product against 8*H bytes of q/k/v/o per row,
// far above the H100's ~295 flop/byte ridge, so the bf16 tensor-core rate
// (989 TFLOP/s) bounds it.
//
// bf16 design (the training path). A TPU grid walks k blocks in order on one
// core and carries m/l/acc in VMEM; CUDA blocks run in parallel and in no
// order, so each CTA loops over the tiles it needs itself:
//   - every product is mma.sync.m16n8k16 (bf16 in, float32 accumulators in
//     registers). A warp owns 16 rows of the output tile; operands come from
//     shared memory by ldmatrix (ldmatrix.trans where the product needs the
//     tile transposed), and an accumulator's register layout is the A
//     operand's layout of the next product, so S -> P -> P.V and
//     dS -> dS.K never leave registers. Tiles in shared memory are
//     row-major with their 16-byte chunks XOR-swizzled by row, so the eight
//     rows one ldmatrix phase reads sit in eight different bank groups;
//   - the streamed tiles (K/V in the forward and dq kernels, Q/dO/lse/delta
//     in the dk/dv kernel) pass through a two-stage ring filled by
//     cp.async.cg: tile j+1 is in flight while tile j computes;
//   - forward: one CTA per (head, batch, 128-row q tile); scale, masks, the
//     online-softmax max and sum (quad shuffles along a fragment row) and
//     the rescale of O happen in registers; O is divided by l at the end and
//     leaves through the warp's own rows of the Q tile in shared memory with
//     16-byte stores. Causal q tiles run heaviest first, masks are evaluated
//     only on tiles that straddle the diagonal, and a warp whose 16 rows all
//     precede a tile skips it;
//   - backward, the TPU's `_bwd_split` (deterministic, no atomics):
//     the dq kernel (one CTA per q tile) sweeps its k tiles twice: the
//     first recomputes S and dP to sum delta = rowsum(P * dP) for its own
//     rows and writes it, the second recomputes them again and accumulates
//     dQ += dS.K in registers; the dk/dv kernel (one CTA per k tile of a kv
//     head, launched after dq on the same stream, so delta is complete)
//     computes S^T = K.Q^T and dP^T = V.dO^T directly, so P^T and dS^T are
//     already the A operands of dV += P^T.dO and dK += dS^T.Q, and walks the
//     GQA group's heads and q tiles with dK/dV in registers;
//   - head_dim 256 halves the row tiles; its dk/dv warps split the head
//     dimension of dK/dV in two (both halves recompute S^T and dP^T).
// The float32 path (off the main path) keeps the first design: one CTA of
// 256 threads per tile, float32 FMAs through shared memory.
//
// Contract: no allocation, no synchronisation, launches on the caller's
// stream; each C entry returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments it does not take) so the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes)
             : cudaSuccess;
}

// ===========================================================================
// bf16: register-resident tensor-core tiles
// ===========================================================================

// Row tile of every bf16 kernel at this head_dim; sequence lengths divide by
// it (each kernel's own tiles below divide it).
constexpr int bf16_tile(int head_dim) { return head_dim <= 128 ? 128 : 64; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Element offset of (r, c) in a row-major tile of width H: the 16-byte chunk
// c / 8 of row r sits at chunk (c / 8) ^ (r % 8).
template <int H>
__device__ __forceinline__ int swz(int r, int c) {
  return r * H + ((((c >> 3) ^ (r & 7))) << 3) + (c & 7);
}

// ROWS x H tile from global (row r at src + r * stride) into a swizzled
// shared tile, 16 bytes per cp.async; NT threads share the work.
template <int H, int ROWS, int NT>
__device__ __forceinline__ void load_async(bf16* dst, const bf16* src,
                                           long long stride) {
  constexpr int kChunks = H / 8;
  static_assert(ROWS * kChunks % NT == 0, "tile chunks must split evenly");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    cp_async16(dst + swz<H>(r, c), src + r * stride + c);
  }
}

// s (16 x N) += A[a_row .. a_row + 16) . B[0 .. N)^T: A and B are swizzled
// row-major shared tiles of width H, contracted over H. Per warp.
template <int H, int N>
__device__ __forceinline__ void mma_abt(float (&s)[N / 8][4], const bf16* A,
                                        int a_row, const bf16* B, int lane) {
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, A + swz<H>(a_row + (lane & 15), kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t bf[4];
      ldsm_x4(bf, B + swz<H>(nn * 16 + (lane & 7) + ((lane >> 4) << 3),
                             kk * 16 + ((lane >> 3) & 1) * 8));
      mma16816(s[2 * nn], af, bf[0], bf[1]);
      mma16816(s[2 * nn + 1], af, bf[2], bf[3]);
    }
  }
}

// o (16 x D) += bf16(p) (16 x K) . B[0 .. K)[d0 .. d0 + D): p is a float
// accumulator tile of mma_abt (its layout is the A operand's once packed),
// B a swizzled row-major shared tile of width H read transposed. Per warp.
template <int H, int K, int D>
__device__ __forceinline__ void mma_pb(float (&o)[D / 8][4],
                                       const float (&p)[K / 8][4],
                                       const bf16* B, int d0, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t af[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]),
        pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]),
    };
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t bf[4];
      ldsm_x4_t(bf, B + swz<H>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                               d0 + dn * 16 + (lane >> 4) * 8));
      mma16816(o[2 * dn], af, bf[0], bf[1]);
      mma16816(o[2 * dn + 1], af, bf[2], bf[3]);
    }
  }
}

// Write a warp's 16 x H float accumulator (rows row0.., times inv per row
// half) as bf16 through the warp's own rows of the swizzled tile stage, then
// to global with 16-byte stores. The caller has finished reading those rows.
template <int H>
__device__ __forceinline__ void store_rows(const float (&acc)[H / 8][4],
                                           const float (&inv)[2], bf16* stage,
                                           int row0, bf16* dst,
                                           long long stride, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < H / 8; ++dt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<uint32_t*>(stage + swz<H>(row0 + g + 8 * h,
                                                  dt * 8 + 2 * t)) =
          pack_bf16(acc[dt][2 * h] * inv[h], acc[dt][2 * h + 1] * inv[h]);
    }
  }
  __syncwarp();
  constexpr int kChunks = H / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + (long long)r * stride + c) =
        *reinterpret_cast<const uint4*>(stage + swz<H>(row0 + r, c));
  }
}

// forward -------------------------------------------------------------------

template <int H>
struct Fwd16 {
  static constexpr int kBr = bf16_tile(H);        // q rows per CTA, 16 a warp
  static constexpr int kBc = H <= 128 ? 64 : 16;  // keys per streamed tile
  static constexpr int kThreads = kBr / 16 * 32;
  // Q, then two stages of K, then two of V
  static constexpr size_t kSmem = sizeof(bf16) * (kBr + 4 * kBc) * H;
  static constexpr int kMinBlocks = H == 64 ? 2 : 1;
};

template <int H>
__global__ void __launch_bounds__(Fwd16<H>::kThreads, Fwd16<H>::kMinBlocks)
    flash_fwd_bf16_kernel(Args a) {
  using F = Fwd16<H>;
  constexpr int kBr = F::kBr, kBc = F::kBc, kNT = F::kThreads;
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBr * H;
  bf16* sV = sK + 2 * kBc * H;

  const int n = blockIdx.x, b = blockIdx.y;
  // causal: the last q tiles have the most k tiles; start them first
  const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * kBr;
  const int kvh = n / (a.heads / a.kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int n_kt =
      a.causal ? min(a.seq_k, q0 + kBr) / kBc : a.seq_k / kBc;

  load_async<H, kBr, kNT>(
      sQ, static_cast<const bf16*>(a.q) + b * a.sq.b + q0 * a.sq.s + n * a.sq.h,
      a.sq.s);
  load_async<H, kBc, kNT>(sK, kg, a.sk.s);
  load_async<H, kBc, kNT>(sV, vg, a.sv.s);
  cp_commit();

  const float sl2 = a.scale * kLog2e;  // logits in log2 units for ex2
  const float* mrow = a.mask ? a.mask + (long long)b * a.seq_k : nullptr;
  float o[H / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {
      const int st = (j + 1) & 1;
      const long long k1 = (long long)(j + 1) * kBc;
      load_async<H, kBc, kNT>(sK + st * kBc * H, kg + k1 * a.sk.s, a.sk.s);
      load_async<H, kBc, kNT>(sV + st * kBc * H, vg + k1 * a.sv.s, a.sv.s);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = j * kBc;
    // a warp whose rows all precede this tile's keys has nothing to add
    if (!(a.causal && k0 > q0 + wr + 15)) {
      const bf16* tK = sK + (j & 1) * kBc * H;
      const bf16* tV = sV + (j & 1) * kBc * H;
      float s[kBc / 8][4] = {};
      mma_abt<H, kBc>(s, sQ, wr, tK, lane);
      const bool diag = a.causal && k0 + kBc - 1 > q0 + wr;
      const int r0 = q0 + wr + g;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kBc / 8; ++nt) {
        const int c = k0 + nt * 8 + 2 * t;
        float2 mk = make_float2(1.f, 1.f);
        if (mrow) mk = *reinterpret_cast<const float2*>(mrow + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool masked = (diag && c + (e & 1) > r0 + (e >> 1) * 8) ||
                              !(((e & 1) ? mk.y : mk.x) > 0.f);
          s[nt][e] = masked ? kNegInf : s[nt][e] * sl2;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        alpha[h] = exp2_fast(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < kBc / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2_fast(s[nt][e] - m[e >> 1]);
          rs[e >> 1] += s[nt][e];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
      for (int dt = 0; dt < H / 8; ++dt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];
      }
      mma_pb<H, kBc, H>(o, s, tV, 0, lane);
    }
    __syncthreads();
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    inv[h] = m[h] == kNegInf ? 0.f : 1.f / (l[h] == 0.f ? 1.f : l[h]);
  }
  store_rows<H>(o, inv, sQ, wr,
                static_cast<bf16*>(a.out) + b * a.so.b +
                    (long long)(q0 + wr) * a.so.s + n * a.so.h,
                a.so.s, lane);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float ll = l[h] == 0.f ? 1.f : l[h];
      a.lse[((long long)b * a.heads + n) * a.seq_q + q0 + wr + g + 8 * h] =
          m[h] == kNegInf ? kNegInf : (m[h] + log2f(ll)) * kLn2;
    }
  }
}

// backward: dq (and delta) -------------------------------------------------

template <int H>
struct Dq16 {
  static constexpr int kBr = bf16_tile(H);
  static constexpr int kBc = H == 64 ? 64 : (H == 128 ? 32 : 16);
  static constexpr int kThreads = kBr / 16 * 32;
  // Q, dO, two stages of K, two of V
  static constexpr size_t kSmem = sizeof(bf16) * (2 * kBr + 4 * kBc) * H;
};

template <int H>
__global__ void __launch_bounds__(Dq16<H>::kThreads)
    flash_dq_bf16_kernel(Args a) {
  using F = Dq16<H>;
  constexpr int kBr = F::kBr, kBc = F::kBc, kNT = F::kThreads;
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + kBr * H;
  bf16* sK = sDO + kBr * H;
  bf16* sV = sK + 2 * kBc * H;

  const int n = blockIdx.x, b = blockIdx.y;
  const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * kBr;
  const int kvh = n / (a.heads / a.kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const long long row0 = ((long long)b * a.heads + n) * a.seq_q + q0;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int n_kt =
      a.causal ? min(a.seq_k, q0 + kBr) / kBc : a.seq_k / kBc;

  load_async<H, kBr, kNT>(
      sQ, static_cast<const bf16*>(a.q) + b * a.sq.b + q0 * a.sq.s + n * a.sq.h,
      a.sq.s);
  load_async<H, kBr, kNT>(sDO,
                          static_cast<const bf16*>(a.dout) + b * a.sdo.b +
                              q0 * a.sdo.s + n * a.sdo.h,
                          a.sdo.s);
  load_async<H, kBc, kNT>(sK, kg, a.sk.s);
  load_async<H, kBc, kNT>(sV, vg, a.sv.s);
  cp_commit();

  float lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = a.lse[row0 + wr + g + 8 * h] * kLog2e;
  }
  const float sl2 = a.scale * kLog2e;
  const float* mrow = a.mask ? a.mask + (long long)b * a.seq_k : nullptr;
  // pass 0 sums delta = rowsum(P * dP) (each thread its columns of rows g
  // and g + 8, then the quad); pass 1 forms dS = P * (dP - delta) * scale
  // from the same p and dp, and dQ += dS.K
  float dl[2] = {0.f, 0.f};
  float dq[H / 8][4] = {};
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dl[h] = quad_sum(dl[h]);
        // the dk/dv kernel reads it after this kernel
        if (t == 0) a.delta[row0 + wr + g + 8 * h] = dl[h];
      }
      // tile 0 again; its stage is free since the last __syncthreads
      load_async<H, kBc, kNT>(sK, kg, a.sk.s);
      load_async<H, kBc, kNT>(sV, vg, a.sv.s);
      cp_commit();
    }
    for (int j = 0; j < n_kt; ++j) {
      if (j + 1 < n_kt) {
        const int st = (j + 1) & 1;
        const long long k1 = (long long)(j + 1) * kBc;
        load_async<H, kBc, kNT>(sK + st * kBc * H, kg + k1 * a.sk.s, a.sk.s);
        load_async<H, kBc, kNT>(sV + st * kBc * H, vg + k1 * a.sv.s, a.sv.s);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const int k0 = j * kBc;
      if (!(a.causal && k0 > q0 + wr + 15)) {
        const bf16* tK = sK + (j & 1) * kBc * H;
        const bf16* tV = sV + (j & 1) * kBc * H;
        float s[kBc / 8][4] = {}, dp[kBc / 8][4] = {};
        mma_abt<H, kBc>(s, sQ, wr, tK, lane);
        mma_abt<H, kBc>(dp, sDO, wr, tV, lane);
        const bool diag = a.causal && k0 + kBc - 1 > q0 + wr;
        const int r0 = q0 + wr + g;
        // p from the saved lse (re-masked: a dead row's lse is NEG_INF)
#pragma unroll
        for (int nt = 0; nt < kBc / 8; ++nt) {
          const int c = k0 + nt * 8 + 2 * t;
          float2 mk = make_float2(1.f, 1.f);
          if (mrow) mk = *reinterpret_cast<const float2*>(mrow + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const bool masked = (diag && c + (e & 1) > r0 + 8 * h) ||
                                !(((e & 1) ? mk.y : mk.x) > 0.f);
            const float p =
                masked ? 0.f : exp2_fast(s[nt][e] * sl2 - lse2[h]);
            if (pass == 0) {
              dl[h] += p * dp[nt][e];
            } else {
              s[nt][e] = p * (dp[nt][e] - dl[h]) * a.scale;
            }
          }
        }
        if (pass == 1) mma_pb<H, kBc, H>(dq, s, tK, 0, lane);
      }
      __syncthreads();
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows<H>(dq, one, sQ, wr,
                static_cast<bf16*>(a.out) + b * a.sdq.b +
                    (long long)(q0 + wr) * a.sdq.s + n * a.sdq.h,
                a.sdq.s, lane);
}

// backward: dk/dv -----------------------------------------------------------

template <int H>
struct Dkv16 {
  static constexpr int kBc = bf16_tile(H);        // keys per CTA, 16 a warp
  static constexpr int kBq = H <= 64 ? 64 : 32;   // q rows per streamed tile
  static constexpr int kSplit = H <= 128 ? 1 : 2; // warps sharing a key row
  static constexpr int kGroups = kBc / 16;
  static constexpr int kThreads = kGroups * kSplit * 32;
  static constexpr int kHs = H / kSplit;           // dK/dV columns a warp owns
  // one stage: Q, dO, lse, delta of a q tile
  static constexpr size_t kStage =
      sizeof(bf16) * 2 * kBq * H + sizeof(float) * 2 * kBq;
  static constexpr size_t kSmem = sizeof(bf16) * 2 * kBc * H + 2 * kStage;
};

template <int H>
__global__ void __launch_bounds__(Dkv16<H>::kThreads)
    flash_dkv_bf16_kernel(Args a) {
  using F = Dkv16<H>;
  constexpr int kBc = F::kBc, kBq = F::kBq, kNT = F::kThreads, kHs = F::kHs;
  extern __shared__ __align__(128) char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBc * H;
  char* ring = reinterpret_cast<char*>(sV + kBc * H);
  auto stage_q = [&](int st) {
    return reinterpret_cast<bf16*>(ring + st * F::kStage);
  };
  auto stage_f = [&](int st) {  // lse then delta, kBq floats each
    return reinterpret_cast<float*>(stage_q(st) + 2 * kBq * H);
  };

  // k tiles in ascending order: under the causal mask the first have the
  // most q tiles, so they start first
  const int kvh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int group = a.heads / a.kv_heads;
  const int k0 = kt * kBc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kw = (warp % F::kGroups) * 16;   // the warp's first key row
  const int d0 = (warp / F::kGroups) * kHs;  // its first dK/dV column
  // causal: q tiles before this k tile see none of its keys
  const int qt0 = a.causal ? k0 / kBq : 0;
  const int n_q = max(a.seq_q / kBq - qt0, 0);
  const int total = group * n_q;  // (head, q tile) pairs, head-major

  auto load_stage = [&](int it, int st) {
    const int n = kvh * group + it / n_q;
    const int q0 = (qt0 + it % n_q) * kBq;
    const long long row0 = ((long long)b * a.heads + n) * a.seq_q + q0;
    bf16* tQ = stage_q(st);
    load_async<H, kBq, kNT>(tQ,
                            static_cast<const bf16*>(a.q) + b * a.sq.b +
                                (long long)q0 * a.sq.s + n * a.sq.h,
                            a.sq.s);
    load_async<H, kBq, kNT>(tQ + kBq * H,
                            static_cast<const bf16*>(a.dout) + b * a.sdo.b +
                                (long long)q0 * a.sdo.s + n * a.sdo.h,
                            a.sdo.s);
    float* tF = stage_f(st);
    const int i = threadIdx.x;
    if (i < kBq / 4) {
      cp_async16(tF + 4 * i, a.lse + row0 + 4 * i);
    } else if (i < kBq / 2) {
      cp_async16(tF + 4 * i, a.delta + row0 + 4 * (i - kBq / 4));
    }
  };

  load_async<H, kBc, kNT>(sK,
                          static_cast<const bf16*>(a.k) + b * a.sk.b +
                              (long long)k0 * a.sk.s + kvh * a.sk.h,
                          a.sk.s);
  load_async<H, kBc, kNT>(sV,
                          static_cast<const bf16*>(a.v) + b * a.sv.b +
                              (long long)k0 * a.sv.s + kvh * a.sv.h,
                          a.sv.s);
  if (total > 0) load_stage(0, 0);
  cp_commit();

  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    valid[h] = !a.mask ||
               a.mask[(long long)b * a.seq_k + k0 + kw + g + 8 * h] > 0.f;
  }
  const float sl2 = a.scale * kLog2e;
  float dk[kHs / 8][4] = {}, dv[kHs / 8][4] = {};
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {
      load_stage(it + 1, (it + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt0 + it % n_q) * kBq;
    // a warp whose keys all follow this tile's queries has nothing to add
    if (!(a.causal && q0 + kBq - 1 < k0 + kw)) {
      const bf16* tQ = stage_q(it & 1);
      const bf16* tDO = tQ + kBq * H;
      const float* tLse = stage_f(it & 1);
      const float* tDelta = tLse + kBq;
      // rows are keys, columns queries: s^T = K.Q^T, dp^T = V.dO^T
      float s[kBq / 8][4] = {}, dp[kBq / 8][4] = {};
      mma_abt<H, kBq>(s, sK, kw, tQ, lane);
      mma_abt<H, kBq>(dp, sV, kw, tDO, lane);
      const bool diag = a.causal && k0 + kw + 15 > q0;
      const int r0 = k0 + kw + g;
#pragma unroll
      for (int nt = 0; nt < kBq / 8; ++nt) {
        const int c = nt * 8 + 2 * t;
        const float2 ls = *reinterpret_cast<const float2*>(tLse + c);
        const float2 dl = *reinterpret_cast<const float2*>(tDelta + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const bool masked =
              (diag && r0 + 8 * h > q0 + c + (e & 1)) || !valid[h];
          const float p =
              masked ? 0.f
                     : exp2_fast(s[nt][e] * sl2 -
                                 ((e & 1) ? ls.y : ls.x) * kLog2e);
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - ((e & 1) ? dl.y : dl.x)) * a.scale;
        }
      }
      // dv += p^T . dO ; dk += ds^T . q
      mma_pb<H, kBq, kHs>(dv, s, tDO, d0, lane);
      mma_pb<H, kBq, kHs>(dk, dp, tQ, d0, lane);
    }
    __syncthreads();
  }
  cp_wait<0>();     // the q loop may be empty (causal, seq_q < seq_k)
  __syncthreads();  // every warp is done with sK and sV
#pragma unroll
  for (int dt = 0; dt < kHs / 8; ++dt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = swz<H>(kw + g + 8 * h, d0 + dt * 8 + 2 * t);
      *reinterpret_cast<uint32_t*>(sK + off) =
          pack_bf16(dk[dt][2 * h], dk[dt][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(sV + off) =
          pack_bf16(dv[dt][2 * h], dv[dt][2 * h + 1]);
    }
  }
  __syncthreads();
  bf16* dkg = static_cast<bf16*>(a.dk) + b * a.sdk.b +
              (long long)k0 * a.sdk.s + kvh * a.sdk.h;
  bf16* dvg = static_cast<bf16*>(a.dv) + b * a.sdv.b +
              (long long)k0 * a.sdv.s + kvh * a.sdv.h;
  constexpr int kChunks = H / 8;
  for (int i = threadIdx.x; i < kBc * kChunks; i += kNT) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(dkg + r * a.sdk.s + c) =
        *reinterpret_cast<const uint4*>(sK + swz<H>(r, c));
    *reinterpret_cast<uint4*>(dvg + r * a.sdv.s + c) =
        *reinterpret_cast<const uint4*>(sV + swz<H>(r, c));
  }
}

template <int H>
int launch_fwd_bf16(const Args& a, cudaStream_t stream) {
  using F = Fwd16<H>;
  static const cudaError_t err = allow_smem(flash_fwd_bf16_kernel<H>, F::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.heads, a.batch, a.seq_q / F::kBr);
  flash_fwd_bf16_kernel<H><<<grid, F::kThreads, F::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int H>
int launch_bwd_bf16(const Args& a, cudaStream_t stream) {
  using Q = Dq16<H>;
  using K = Dkv16<H>;
  static_assert(bf16_tile(H) % Q::kBc == 0 && bf16_tile(H) % K::kBq == 0,
                "every bf16 tile divides the sequence tile");
  static const cudaError_t dq_attr =
      allow_smem(flash_dq_bf16_kernel<H>, Q::kSmem);
  static const cudaError_t dkv_attr =
      allow_smem(flash_dkv_bf16_kernel<H>, K::kSmem);
  if (dq_attr != cudaSuccess) return (int)dq_attr;
  if (dkv_attr != cudaSuccess) return (int)dkv_attr;
  flash_dq_bf16_kernel<H><<<dim3(a.heads, a.batch, a.seq_q / Q::kBr),
                            Q::kThreads, Q::kSmem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_dkv_bf16_kernel<H><<<dim3(a.kv_heads, a.batch, a.seq_k / K::kBc),
                             K::kThreads, K::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

// [threads, dynamic shared bytes, registers per thread, local (spill)
// bytes per thread, CTAs per SM] of one bf16 kernel, as the card reports them
template <typename Kernel>
int occupancy(Kernel kernel, int threads, size_t smem, int* out) {
  cudaError_t err = allow_smem(kernel, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = threads;
  out[1] = (int)smem;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = blocks;
  return 0;
}

template <int H>
int occupancy_bf16(int which, int* out) {
  if (which == 0) {
    return occupancy(flash_fwd_bf16_kernel<H>, Fwd16<H>::kThreads,
                     Fwd16<H>::kSmem, out);
  }
  if (which == 1) {
    return occupancy(flash_dq_bf16_kernel<H>, Dq16<H>::kThreads,
                     Dq16<H>::kSmem, out);
  }
  return occupancy(flash_dkv_bf16_kernel<H>, Dkv16<H>::kThreads,
                   Dkv16<H>::kSmem, out);
}

// ===========================================================================
// float32: FMAs through shared memory
// ===========================================================================

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Tile geometry. Row pitches are padded by 4 floats: rows stay 16-byte
// aligned for vector loads, and neighbouring rows start in different
// shared-memory banks.
template <int H>
struct Cfg {
  static constexpr int kTile = H <= 64 ? 64 : 32;
  static constexpr int kLd = H + 4;       // tiles of H columns
  static constexpr int kLdS = kTile + 4;  // tiles of kTile columns
};

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) & ~size_t(127);
}

__device__ __forceinline__ float* carve(char*& p, size_t floats) {
  float* r = reinterpret_cast<float*>(p);
  p += align128(sizeof(float) * floats);
  return r;
}

template <int H>
constexpr size_t fwd_smem() {
  using C = Cfg<H>;
  return 4 * align128(sizeof(float) * C::kTile * C::kLd) +
         2 * align128(sizeof(float) * C::kTile * C::kLdS) +
         4 * align128(sizeof(float) * C::kTile);
}

template <int H>
constexpr size_t dq_smem() {
  using C = Cfg<H>;
  return 5 * align128(sizeof(float) * C::kTile * C::kLd) +
         3 * align128(sizeof(float) * C::kTile * C::kLdS) +
         3 * align128(sizeof(float) * C::kTile);
}

template <int H>
constexpr size_t dkv_smem() {
  using C = Cfg<H>;
  return 6 * align128(sizeof(float) * C::kTile * C::kLd) +
         4 * align128(sizeof(float) * C::kTile * C::kLdS) +
         3 * align128(sizeof(float) * C::kTile);
}

// rows x H tile from global (row r at src + r * row_stride) into shared
// memory with pitch LD, 16 bytes per thread per step.
template <int H, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int rows) {
  constexpr int kPerRow = H / 4;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * 4;
    *reinterpret_cast<float4*>(dst + r * LD + c) =
        *reinterpret_cast<const float4*>(src + r * row_stride + c);
  }
}

// C[M x N] (pitch ldc) = (or +=, with ACC) A[M x K] * B[K x N], all operands
// in shared memory. A(i, k) is A[k * lda + i] when A_COL, else A[i * lda +
// k]; B(k, j) is B[j * ldb + k] when B_COL, else B[k * ldb + j]. Every
// thread of the CTA calls it; the caller synchronises around it.
template <int M, int N, int K, bool A_COL, bool B_COL, bool ACC>
__device__ __forceinline__ void tile_mma(const float* A, int lda,
                                         const float* B, int ldb, float* C,
                                         int ldc) {
  for (int e = threadIdx.x; e < M * N; e += kThreads) {
    const int i = e / N;
    const int j = e - i * N;
    float s = ACC ? C[i * ldc + j] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      s += (A_COL ? A[k * lda + i] : A[i * lda + k]) *
           (B_COL ? B[j * ldb + k] : B[k * ldb + j]);
    }
    C[i * ldc + j] = s;
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

__device__ __forceinline__ bool key_masked(const Args& a, const float* smask,
                                           int q_pos, int k_pos, int c) {
  return (a.causal && k_pos > q_pos) || (a.mask && !(smask[c] > 0.f));
}

template <int H>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(Args a) {
  using C = Cfg<H>;
  constexpr int BT = C::kTile;
  constexpr int kPer = BT / 32;
  extern __shared__ __align__(128) char smem[];
  char* p = smem;
  float* sQ = carve(p, BT * C::kLd);
  float* sK = carve(p, BT * C::kLd);
  float* sV = carve(p, BT * C::kLd);
  float* sS = carve(p, BT * C::kLdS);
  float* sP = carve(p, BT * C::kLdS);
  float* sO = carve(p, BT * C::kLd);
  float* sM = carve(p, BT);
  float* sL = carve(p, BT);
  float* sA = carve(p, BT);
  float* sMask = carve(p, BT);

  const int qt = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (a.heads / a.kv_heads);
  const int q0 = qt * BT;
  const float* qg = static_cast<const float*>(a.q) + b * a.sq.b + q0 * a.sq.s + n * a.sq.h;
  const float* kg = static_cast<const float*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const float* vg = static_cast<const float*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<H, C::kLd>(sQ, qg, a.sq.s, BT);
  for (int i = threadIdx.x; i < BT * H; i += kThreads) {
    sO[(i / H) * C::kLd + i % H] = 0.f;
  }
  for (int i = threadIdx.x; i < BT; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }
  // causal: k tiles past the diagonal hold no visible key for this tile
  const int n_kt = a.causal ? min(a.seq_k / BT, qt + 1) : a.seq_k / BT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    load_tile<H, C::kLd>(sK, kg + k0 * a.sk.s, a.sk.s, BT);
    load_tile<H, C::kLd>(sV, vg + k0 * a.sv.s, a.sv.s, BT);
    if (a.mask) {
      for (int i = threadIdx.x; i < BT; i += kThreads) {
        sMask[i] = a.mask[(long long)b * a.seq_k + k0 + i];
      }
    }
    __syncthreads();
    tile_mma<BT, BT, H, false, true, false>(sQ, C::kLd, sK, C::kLd, sS,
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
        sP[r * C::kLdS + lane + 32 * t] = pr;
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
      sO[r * C::kLd + i % H] *= sA[r];
    }
    __syncthreads();
    tile_mma<BT, H, BT, false, false, true>(sP, C::kLdS, sV, C::kLd, sO,
                                            C::kLd);
    __syncthreads();
  }
  float* og = static_cast<float*>(a.out) + b * a.so.b + q0 * a.so.s + n * a.so.h;
  for (int i = threadIdx.x; i < BT * H; i += kThreads) {
    const int r = i / H, d = i % H;
    const float l = sL[r];
    og[r * a.so.s + d] =
        sM[r] == kNegInf ? 0.f : sO[r * C::kLd + d] / (l == 0.f ? 1.f : l);
  }
  for (int r = threadIdx.x; r < BT; r += kThreads) {
    const float l = sL[r];
    a.lse[((long long)b * a.heads + n) * a.seq_q + q0 + r] =
        sM[r] == kNegInf ? kNegInf : sM[r] + logf(l == 0.f ? 1.f : l);
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads) flash_delta_f32_kernel(Args a) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const long long rows = (long long)a.batch * a.seq_q * a.heads;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int n = row % a.heads;
  const int s = (row / a.heads) % a.seq_q;
  const int b = row / ((long long)a.heads * a.seq_q);
  const float* o = static_cast<const float*>(a.o) + b * a.so.b + s * a.so.s + n * a.so.h;
  const float* d = static_cast<const float*>(a.dout) + b * a.sdo.b +
                   s * a.sdo.s + n * a.sdo.h;
  float acc = 0.f;
  for (int i = lane; i < H; i += 32) acc += o[i] * d[i];
  acc = warp_sum(acc);
  if (lane == 0) a.delta[((long long)b * a.heads + n) * a.seq_q + s] = acc;
}

template <int H>
__global__ void __launch_bounds__(kThreads) flash_dq_f32_kernel(Args a) {
  using C = Cfg<H>;
  constexpr int BT = C::kTile;
  extern __shared__ __align__(128) char smem[];
  char* p = smem;
  float* sQ = carve(p, BT * C::kLd);
  float* sDO = carve(p, BT * C::kLd);
  float* sK = carve(p, BT * C::kLd);
  float* sV = carve(p, BT * C::kLd);
  float* sS = carve(p, BT * C::kLdS);
  float* sDP = carve(p, BT * C::kLdS);
  float* sDS = carve(p, BT * C::kLdS);
  float* sDQ = carve(p, BT * C::kLd);
  float* sLse = carve(p, BT);
  float* sDelta = carve(p, BT);
  float* sMask = carve(p, BT);

  const int qt = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (a.heads / a.kv_heads);
  const int q0 = qt * BT;
  const long long row0 = ((long long)b * a.heads + n) * a.seq_q + q0;
  load_tile<H, C::kLd>(
      sQ, static_cast<const float*>(a.q) + b * a.sq.b + q0 * a.sq.s + n * a.sq.h,
      a.sq.s, BT);
  load_tile<H, C::kLd>(
      sDO,
      static_cast<const float*>(a.dout) + b * a.sdo.b + q0 * a.sdo.s + n * a.sdo.h,
      a.sdo.s, BT);
  for (int i = threadIdx.x; i < BT * H; i += kThreads) {
    sDQ[(i / H) * C::kLd + i % H] = 0.f;
  }
  for (int i = threadIdx.x; i < BT; i += kThreads) {
    sLse[i] = a.lse[row0 + i];
    sDelta[i] = a.delta[row0 + i];
  }
  const float* kg = static_cast<const float*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const float* vg = static_cast<const float*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int n_kt = a.causal ? min(a.seq_k / BT, qt + 1) : a.seq_k / BT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    load_tile<H, C::kLd>(sK, kg + k0 * a.sk.s, a.sk.s, BT);
    load_tile<H, C::kLd>(sV, vg + k0 * a.sv.s, a.sv.s, BT);
    if (a.mask) {
      for (int i = threadIdx.x; i < BT; i += kThreads) {
        sMask[i] = a.mask[(long long)b * a.seq_k + k0 + i];
      }
    }
    __syncthreads();
    tile_mma<BT, BT, H, false, true, false>(sQ, C::kLd, sK, C::kLd, sS,
                                            C::kLdS);
    tile_mma<BT, BT, H, false, true, false>(sDO, C::kLd, sV, C::kLd, sDP,
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
      sDS[r * C::kLdS + c] = pr * (sDP[r * C::kLdS + c] - sDelta[r]) * a.scale;
    }
    __syncthreads();
    tile_mma<BT, H, BT, false, false, true>(sDS, C::kLdS, sK, C::kLd, sDQ,
                                            C::kLd);
    __syncthreads();
  }
  float* dq = static_cast<float*>(a.out) + b * a.sdq.b + q0 * a.sdq.s + n * a.sdq.h;
  for (int i = threadIdx.x; i < BT * H; i += kThreads) {
    const int r = i / H, d = i % H;
    dq[r * a.sdq.s + d] = sDQ[r * C::kLd + d];
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads) flash_dkv_f32_kernel(Args a) {
  using C = Cfg<H>;
  constexpr int BT = C::kTile;
  extern __shared__ __align__(128) char smem[];
  char* p = smem;
  float* sK = carve(p, BT * C::kLd);
  float* sV = carve(p, BT * C::kLd);
  float* sQ = carve(p, BT * C::kLd);
  float* sDO = carve(p, BT * C::kLd);
  float* sS = carve(p, BT * C::kLdS);
  float* sDP = carve(p, BT * C::kLdS);
  float* sP = carve(p, BT * C::kLdS);
  float* sDS = carve(p, BT * C::kLdS);
  float* sDK = carve(p, BT * C::kLd);
  float* sDV = carve(p, BT * C::kLd);
  float* sLse = carve(p, BT);
  float* sDelta = carve(p, BT);
  float* sMask = carve(p, BT);

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = a.heads / a.kv_heads;
  const int k0 = kt * BT;
  load_tile<H, C::kLd>(
      sK, static_cast<const float*>(a.k) + b * a.sk.b + k0 * a.sk.s + kvh * a.sk.h,
      a.sk.s, BT);
  load_tile<H, C::kLd>(
      sV, static_cast<const float*>(a.v) + b * a.sv.b + k0 * a.sv.s + kvh * a.sv.h,
      a.sv.s, BT);
  for (int i = threadIdx.x; i < BT * H; i += kThreads) {
    sDK[(i / H) * C::kLd + i % H] = 0.f;
    sDV[(i / H) * C::kLd + i % H] = 0.f;
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
      load_tile<H, C::kLd>(
          sQ, static_cast<const float*>(a.q) + b * a.sq.b + q0 * a.sq.s + n * a.sq.h,
          a.sq.s, BT);
      load_tile<H, C::kLd>(sDO,
                           static_cast<const float*>(a.dout) + b * a.sdo.b +
                               q0 * a.sdo.s + n * a.sdo.h,
                           a.sdo.s, BT);
      for (int i = threadIdx.x; i < BT; i += kThreads) {
        sLse[i] = a.lse[row0 + i];
        sDelta[i] = a.delta[row0 + i];
      }
      __syncthreads();
      tile_mma<BT, BT, H, false, true, false>(sQ, C::kLd, sK, C::kLd, sS,
                                              C::kLdS);
      tile_mma<BT, BT, H, false, true, false>(sDO, C::kLd, sV, C::kLd, sDP,
                                              C::kLdS);
      __syncthreads();
      for (int i = threadIdx.x; i < BT * BT; i += kThreads) {
        const int r = i / BT, c = i % BT;
        const float pr =
            key_masked(a, sMask, q0 + r, k0 + c, c)
                ? 0.f
                : expf(sS[r * C::kLdS + c] * a.scale - sLse[r]);
        sP[r * C::kLdS + c] = pr;
        sDS[r * C::kLdS + c] = pr * (sDP[r * C::kLdS + c] - sDelta[r]) * a.scale;
      }
      __syncthreads();
      // dv += p^T dO ; dk += ds^T q
      tile_mma<BT, H, BT, true, false, true>(sP, C::kLdS, sDO, C::kLd, sDV,
                                             C::kLd);
      tile_mma<BT, H, BT, true, false, true>(sDS, C::kLdS, sQ, C::kLd, sDK,
                                             C::kLd);
      __syncthreads();
    }
  }
  __syncthreads();  // the q loop may be empty (causal, seq_q < seq_k)
  float* dk = static_cast<float*>(a.dk) + b * a.sdk.b + k0 * a.sdk.s + kvh * a.sdk.h;
  float* dv = static_cast<float*>(a.dv) + b * a.sdv.b + k0 * a.sdv.s + kvh * a.sdv.h;
  for (int i = threadIdx.x; i < BT * H; i += kThreads) {
    const int r = i / H, d = i % H;
    dk[r * a.sdk.s + d] = sDK[r * C::kLd + d];
    dv[r * a.sdv.s + d] = sDV[r * C::kLd + d];
  }
}

template <int H>
int launch_fwd_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<H>();
  static const cudaError_t err = allow_smem(flash_fwd_f32_kernel<H>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.seq_q / Cfg<H>::kTile, a.heads, a.batch);
  flash_fwd_f32_kernel<H><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int H>
int launch_bwd_f32(const Args& a, cudaStream_t stream) {
  constexpr int BT = Cfg<H>::kTile;
  constexpr size_t dq_bytes = dq_smem<H>();
  constexpr size_t dkv_bytes = dkv_smem<H>();
  static const cudaError_t dq_attr = allow_smem(flash_dq_f32_kernel<H>, dq_bytes);
  static const cudaError_t dkv_attr =
      allow_smem(flash_dkv_f32_kernel<H>, dkv_bytes);
  if (dq_attr != cudaSuccess) return (int)dq_attr;
  if (dkv_attr != cudaSuccess) return (int)dkv_attr;
  cudaError_t err;
  const long long rows = (long long)a.batch * a.seq_q * a.heads;
  flash_delta_f32_kernel<H>
      <<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_dq_f32_kernel<H><<<dim3(a.seq_q / BT, a.heads, a.batch), kThreads,
                           dq_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_dkv_f32_kernel<H><<<dim3(a.seq_k / BT, a.kv_heads, a.batch), kThreads,
                            dkv_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ===========================================================================
// dispatch
// ===========================================================================

// Rows per tile for a dtype (0 = float32, 1 = bfloat16) and head_dim, or 0
// where no kernel is built.
int tile_of(int dtype, int head_dim) {
  if (head_dim != 64 && head_dim != 128 && head_dim != 256) return 0;
  if (dtype == 0) return head_dim <= 64 ? Cfg<64>::kTile : Cfg<128>::kTile;
  if (dtype == 1) return bf16_tile(head_dim);
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

using Launch = int (*)(const Args&, cudaStream_t);

int run(Launch f32_64, Launch f32_128, Launch f32_256, Launch bf_64,
        Launch bf_128, Launch bf_256, int dtype, int head_dim, const Args& a,
        cudaStream_t s) {
  if (head_dim == 64) return dtype == 0 ? f32_64(a, s) : bf_64(a, s);
  if (head_dim == 128) return dtype == 0 ? f32_128(a, s) : bf_128(a, s);
  return dtype == 0 ? f32_256(a, s) : bf_256(a, s);
}

}  // namespace

// Rows per tile of the kernels for a dtype (0 = float32, 1 = bfloat16) and
// head_dim, or 0 where there is no kernel. Sequence lengths must divide by
// it; the Python wrapper reads it from here.
extern "C" int dpx_flash_tile(int dtype, int head_dim) {
  return tile_of(dtype, head_dim);
}

// The bf16 kernel `which` (0 forward, 1 dq, 2 dk/dv) at head_dim: writes
// [threads, dynamic shared bytes, registers, spill bytes, CTAs per SM] to
// out (5 ints). For reports; the kernels never call it.
extern "C" int dpx_flash_occupancy(int head_dim, int which, int* out) {
  if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  if (head_dim == 64) return occupancy_bf16<64>(which, out);
  if (head_dim == 128) return occupancy_bf16<128>(which, out);
  if (head_dim == 256) return occupancy_bf16<256>(which, out);
  return (int)cudaErrorInvalidValue;
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
  return run(launch_fwd_f32<64>, launch_fwd_f32<128>, launch_fwd_f32<256>,
             launch_fwd_bf16<64>, launch_fwd_bf16<128>, launch_fwd_bf16<256>,
             dtype, head_dim, a, static_cast<cudaStream_t>(stream));
}

// bf16: launches the dq kernel (which also writes delta = rowsum(do * o)),
// then the dk/dv kernel; float32: delta, dq, dk/dv. strides: 24 int64,
// [batch, seq, head] for q, k, v, o, do, dq, dk, dv. delta: (B, N, Sq)
// float32 scratch.
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
  return run(launch_bwd_f32<64>, launch_bwd_f32<128>, launch_bwd_f32<256>,
             launch_bwd_bf16<64>, launch_bwd_bf16<128>, launch_bwd_bf16<256>,
             dtype, head_dim, a, static_cast<cudaStream_t>(stream));
}
