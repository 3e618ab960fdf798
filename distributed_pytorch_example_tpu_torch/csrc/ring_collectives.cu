// All-gather (K3a) and reduce-scatter (K3b) over peer memory, for sm_90a:
// both one-shot pushes across the H100's all-to-all NVLink.
//
// Both replace TPU kernels of distributed_pytorch_example_tpu/ops/pallas/
// collectives.py: `_ring_all_gather` -> `_ag_kernel` (K3a) and
// `_ring_reduce_scatter` -> `_rs_kernel` (K3b). The TPU kernels walk a
// bidirectional ring of neighbours over ICI. On an HGX H100 every card
// reaches every other through NVSwitch at the full NVLink rate, so there
// is no ring to walk: every rank pushes what rank c needs straight into
// c's workspace, and c finishes the collective locally.
//
// What replaces the TPU's remote DMA plus semaphore: each rank owns one
// workspace in device memory, and every rank holds a table of every
// rank's workspace base pointer (CUDA IPC between processes, raw pointers
// between in-process ranks on one card). The data goes through the
// receiver's workspace, not straight into its output: a peer cannot reach
// another process's caching-allocator tensors without an IPC handle per
// call, and the workspace is the only memory the ranks share.
//
// The protocol, the same for both kernels (run_pieces). CTA k of rank me
// takes pieces k, k + G, k + 2G, ... of the payload (G the grid); a
// counter in its own workspace numbers its pieces g across calls, and
// piece g uses slot parity g % 2 and epoch g / 2 + 1.
//   - Push: the CTA waits until every receiver has acked the slot's
//     previous use, stores its piece with 16-byte vectors into every
//     receiver c's slot for (set, this CTA, sender offset j = me - c,
//     parity), then, after __syncthreads and a system fence
//     (__threadfence_system), releases one `full` flag per receiver with
//     st.release.sys. Stores over NVLink are posted: no round trip per
//     piece.
//   - Finish: the CTA waits (ld.acquire.sys) for the D - 1 `full` flags of
//     its piece, reads the slots through __ldcg (past L1, whose lines may
//     predate the peers' stores), finishes the piece and releases one
//     `ack` per sender.
//   - Pipeline: a CTA pushes piece i + 1 before it finishes piece i (two
//     slots per sender and CTA). Payloads larger than the slots (the whole
//     GPT-2 gradient) go through in pieces.
// Flags hold monotonic epochs, so no flag is ever reset; every rank issues
// the same collectives in the same order with the same grid, so the
// counters agree. There is no barrier at entry: the ack of a slot's
// previous use orders the calls.
//
// K3a: rank r's payload x (n bytes) lands in row r of every rank's out
// (D, n). The push reads each piece of x once and stores it into the
// D - 1 receivers' slots and into the sender's own row; the finish copies
// each sender's slot into its row. No rank forwards another rank's data.
// It moves bytes, so it takes any dtype; a piece is at least 4 KiB.
//
// K3b keeps the TPU kernel's result bit for bit, not its ring. Rank c gets
// out (n,) = the float32 sum over ranks r of x_r = parts_r[c], cast back
// to T, added in the ring's order (indices mod D):
//   low half [0, n/2):   ((x_{c+1} + x_{c+2}) + ...) + x_c
//   high half [n/2, n):  ((x_{c-1} + x_{c-2}) + ...) + x_c
// the clockwise partial seeded at c + 1 with an own-part add at every hop,
// and its counter-clockwise mirror. The push stores parts[c] in T (bf16
// stays bf16 on the wire) into rank c's slot; the finish sums the slots
// and the own part in float32 in the order above and writes out. A piece
// is at least 256 elements.
//
// What bounded the ring versions of K3a and K3b, and what this
// design does about it:
//   1. 16 CTAs on 132 SMs: the grid comes from the SM count and the
//      kernels' occupancy (the co-residency rule below).
//   2. D - 1 chained hops per slot part, each an ack wait, a staged copy
//      into the neighbour, a fence and a flag, a wait on its own flag and
//      a copy out, with no two pieces of a CTA in flight: one push and one
//      wait per piece, whatever D, and two pieces in flight per CTA.
//   3. A neighbour barrier per CTA per call: none.
//   4. A flag round trip costs a time slice between processes that share
//      a card: a call whose payload fits the slots waits for each peer
//      once per CTA, instead of once per hop and piece plus the barrier.
//
// Every wait is bounded with %globaltimer (`timeout_ns`, 10 s by
// default): a wait that expires writes an error code into the caller's
// device word `err` and the kernel returns; a kernel that finds `err`
// already set returns at once. The wrapper reads the word at the train
// step's host sync and raises, so a peer that never arrives is an error,
// not a hung card.
//
// Sets: collective ids 2 * stream (gather) and 2 * stream + 1 (scatter),
// stream taken modulo 4. Each kind has its own region of the workspace
// and each id its own counters, flags and slots there, so collectives of
// distinct ids can be in flight at once.
// Co-residency rule: every CTA of every rank in flight must be resident
// at once, since each spins on flags that the others set; a rank whose
// grid filled the SMs would starve the kernels it waits on, and the wait
// would time out. R ranks may share one card at once (in-process ranks:
// R = D; a ring over processes: R = 1, since processes that share a card
// run in separate contexts, which time-slice) and each may have all 8
// collective ids in flight on distinct CUDA streams, so one launch of
// either kernel takes at most SMs x occupancy / (8 R) CTAs, with the
// least occupancy of the three kernels. The wrapper registers R per ring
// (dpx_ring_card_ranks); an unregistered ring counts R = D. All three are
// built to 32 registers a thread (kMinCtas): 8 CTAs of 256 threads per
// SM.
// Slot layout: a slot's place and size depend on (kind, set, CTA, sender,
// parity), the ring (D, R) and the card, never on n, so calls of changing
// size never share a slot under another CTA's flags.
//
// Bound: across cards, the bytes over NVLink at 450 GB/s each way, with
// (D - 1) / D of the payload into each rank (K3b) or (D - 1) payloads out
// of each rank (K3a); for in-process ranks on one card, the card's memory
// traffic, each rank's input read once and output written once at
// 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <mutex>
#include <vector>

namespace {

typedef unsigned long long u64;

constexpr int kSets = 8;    // collective ids
constexpr int kThreads = 256;
constexpr int kMinCtas = 8;  // per SM: at most 32 registers a thread
constexpr int kCopyUnroll = 4;  // 16-byte vectors in flight per thread
constexpr int kFlagStride = 16;  // u64 words per flag: one 128-byte line

// One region per kind (gather, then scatter), each for its 4 sets
// (set >> 1): per-CTA piece counters, `full` flags, `ack` flags, then
// staging
constexpr int kKindSets = 4;
constexpr int kSlots = 2;       // per (sender, CTA): pieces in flight
constexpr int kFlags = 4096;    // flags of each kind per set
constexpr int kMaxCtas = kFlags / kSlots;
constexpr long long kSetBytes = 32LL << 20;  // staging per set
constexpr long long kMinSlotBytes = 4096;
constexpr long long kQuantum = 256;    // K3b piece granularity, elements
constexpr long long kAgQuantum = 256;  // K3a's, 16-byte vectors (4 KiB)
constexpr long long kFullOffset = (long long)kKindSets * kMaxCtas * 8;
constexpr long long kAckOffset =
    kFullOffset + (long long)kKindSets * kFlags * kFlagStride * 8;
constexpr long long kStagingOffset =
    kAckOffset + (long long)kKindSets * kFlags * kFlagStride * 8;
constexpr long long kRegionBytes =
    kStagingOffset + (long long)kKindSets * kSetBytes;
constexpr long long kWorkspaceBytes = 2 * kRegionBytes;

// error codes written into `err`
enum { kErrAck = 2, kErrFull = 3 };

struct PushArgs {
  const u64* peers;      // world workspace base pointers (device)
  int rank, world, set;  // set: the kind's set, 0..3
  long long region;      // the kind's region in every workspace, bytes
  const void* in;        // K3a: x; K3b: parts (world, n) of T
  void* out;             // K3a: (world, n vectors); K3b: (n,) of T
  long long n;           // K3a: 16-byte vectors of x; K3b: chunk elements
  long long piece;       // units of n per piece
  long long slot_bytes;  // one slot's bytes (fixed per ring and card)
  int* err;
  long long timeout_ns;
};

__device__ __forceinline__ u64 gtimer() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// One thread's bounded wait for *f >= want: false when this rank has
// already failed, or when the wait times out, which records `code` in
// `err` (first error wins).
__device__ bool spin_until(const u64* f, u64 want, int* err,
                           long long timeout_ns, int code) {
  const u64 start = gtimer();
  while (ld_acquire(f) < want) {
    if (*(volatile int*)err != 0) return false;
    if ((long long)(gtimer() - start) > timeout_ns) {
      atomicCAS(err, 0, code);
      return false;
    }
  }
  return true;
}

// rank's region of this kind
__device__ __forceinline__ char* workspace(const PushArgs& a, int rank) {
  return reinterpret_cast<char*>(a.peers[rank]) + a.region;
}

// index of the (CTA, peer offset j in 1..D-1, parity) slot and its flags;
// the sender is rank receiver + j
__device__ __forceinline__ long long slot_index(const PushArgs& a, int cta,
                                                int j, int parity) {
  return ((long long)cta * (a.world - 1) + (j - 1)) * kSlots + parity;
}

__device__ __forceinline__ u64* flag_at(const PushArgs& a, char* region,
                                        long long kind_offset,
                                        long long idx) {
  return reinterpret_cast<u64*>(region + kind_offset) +
         ((long long)a.set * kFlags + idx) * kFlagStride;
}

__device__ __forceinline__ u64* counter(const PushArgs& a, char* region,
                                        int cta) {
  return reinterpret_cast<u64*>(region) + (long long)a.set * kMaxCtas + cta;
}

__device__ __forceinline__ char* slot_at(const PushArgs& a, char* region,
                                         long long idx) {
  return region + kStagingOffset + a.set * kSetBytes + idx * a.slot_bytes;
}

// CTA-wide bounded wait: for every j in 1..D-1 one thread spins until
// the flag flag_of(j) >= want. True on every thread when all arrived.
template <typename FlagOf>
__device__ bool cta_wait_peers(const PushArgs& a, FlagOf flag_of, u64 want,
                               int code) {
  int good = 1;
  for (int j = 1 + threadIdx.x; good && j < a.world; j += kThreads)
    good = spin_until(flag_of(j), want, a.err, a.timeout_ns, code);
  return __syncthreads_and(good);
}

// The CTA's loads and stores so far, then __syncthreads, a system fence
// and flag_of(j) = v (release) by one thread per j in 1..D-1.
template <typename FlagOf>
__device__ void cta_release_peers(const PushArgs& a, FlagOf flag_of, u64 v) {
  __syncthreads();
  for (int j = 1 + threadIdx.x; j < a.world; j += kThreads) {
    __threadfence_system();
    st_release(flag_of(j), v);
  }
}

// The pipeline of both kernels: CTA k takes pieces k, k + G, ... and
// pushes piece i + 1 before it finishes piece i. push(parity, off) fills
// every receiver's slot (this CTA, parity) from the piece at offset `off`
// (units of n); finish(parity, off) consumes every sender's.
template <typename Push, typename Finish>
__device__ void run_pieces(const PushArgs& a, Push push, Finish finish) {
  const int D = a.world, me = a.rank, cta = blockIdx.x, grid = gridDim.x;
  char* wme = workspace(a, me);
  __shared__ u64 s_count;
  __shared__ int s_bail;
  if (threadIdx.x == 0) {
    s_bail = *(volatile int*)a.err != 0;
    s_count = *(volatile u64*)counter(a, wme, cta);
  }
  __syncthreads();
  if (s_bail) return;
  const u64 g0 = s_count;
  const long long pieces = (a.n + a.piece - 1) / a.piece;
  const long long mine = (pieces - cta + grid - 1) / grid;
  for (long long i = 0; i <= mine; ++i) {
    if (i < mine) {
      const u64 g = g0 + i;
      const int parity = (int)(g % kSlots);
      // every receiver me - j has read this slot's previous piece
      if (!cta_wait_peers(
              a,
              [&](int j) {
                return flag_at(a, wme, kAckOffset,
                               slot_index(a, cta, j, parity));
              },
              g / kSlots, kErrAck))
        return;
      push(parity, (cta + i * grid) * a.piece);
      cta_release_peers(
          a,
          [&](int j) {
            return flag_at(a, workspace(a, (me - j + D) % D), kFullOffset,
                           slot_index(a, cta, j, parity));
          },
          g / kSlots + 1);
    }
    if (i > 0) {
      const u64 g = g0 + i - 1;
      const int parity = (int)(g % kSlots);
      if (!cta_wait_peers(
              a,
              [&](int j) {
                return flag_at(a, wme, kFullOffset,
                               slot_index(a, cta, j, parity));
              },
              g / kSlots + 1, kErrFull))
        return;
      finish(parity, (cta + (i - 1) * grid) * a.piece);
      // the slots are read: each sender me + j may refill its own
      cta_release_peers(
          a,
          [&](int j) {
            return flag_at(a, workspace(a, (me + j) % D), kAckOffset,
                           slot_index(a, cta, j, parity));
          },
          g / kSlots + 1);
    }
  }
  if (threadIdx.x == 0) *(volatile u64*)counter(a, wme, cta) = g0 + mine;
}

// dst[v] = src[v] for the 16-byte vectors v in [0, nv), kCopyUnroll in
// flight per thread; kFromPeer reads past L1, whose lines may predate a
// peer's stores
template <bool kFromPeer>
__device__ __forceinline__ void copy_vectors(uint4* dst, const uint4* src,
                                             int nv) {
  for (int v0 = threadIdx.x; v0 < nv; v0 += kThreads * kCopyUnroll) {
    uint4 x[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < nv) x[u] = kFromPeer ? __ldcg(src + v) : src[v];
    }
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < nv) dst[v] = x[u];
    }
  }
}

// ---------------------------------------------------------------------------
// K3a
// ---------------------------------------------------------------------------

// out (D, n vectors) gets every rank's x (n vectors) in its row.
__global__ void __launch_bounds__(kThreads, kMinCtas)
all_gather_kernel(PushArgs a) {
  const int D = a.world, me = a.rank, cta = blockIdx.x;
  const uint4* x = reinterpret_cast<const uint4*>(a.in);
  uint4* out = reinterpret_cast<uint4*>(a.out);
  run_pieces(
      a,
      // x's piece, read once, into my row and every receiver me - j's slot
      [&](int parity, long long off) {
        const int nv = (int)min(a.piece, a.n - off);
        for (int v0 = threadIdx.x; v0 < nv; v0 += kThreads * kCopyUnroll) {
          uint4 r[kCopyUnroll];
#pragma unroll
          for (int u = 0; u < kCopyUnroll; ++u) {
            const int v = v0 + u * kThreads;
            if (v < nv) r[u] = x[off + v];
          }
          for (int j = 0; j < D; ++j) {  // j = 0: my own row
            uint4* dst =
                j == 0 ? out + me * a.n + off
                       : reinterpret_cast<uint4*>(slot_at(
                             a, workspace(a, (me - j + D) % D),
                             slot_index(a, cta, j, parity)));
#pragma unroll
            for (int u = 0; u < kCopyUnroll; ++u) {
              const int v = v0 + u * kThreads;
              if (v < nv) dst[v] = r[u];
            }
          }
        }
      },
      // each sender me + j's piece, from my slot, into its row
      [&](int parity, long long off) {
        const int nv = (int)min(a.piece, a.n - off);
        char* wme = workspace(a, me);
        for (int j = 1; j < D; ++j)
          copy_vectors<true>(
              out + (long long)((me + j) % D) * a.n + off,
              reinterpret_cast<const uint4*>(
                  slot_at(a, wme, slot_index(a, cta, j, parity))),
              nv);
      });
}

// ---------------------------------------------------------------------------
// K3b
// ---------------------------------------------------------------------------

// 16 bytes of T, as floats; kUnroll of them in flight per thread in the
// sum, within kMinCtas's register budget
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4, kUnroll = 2;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8, kUnroll = 1;
  __device__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&b);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// out[v] = ((slot_j0[v] + slot_{j0+step}[v]) + ...) + own[v] over the
// 16-byte vectors [beg, end), in float32: j0 = 1, step 1 for the low
// half (x_{c+1} first), j0 = D - 1, step -1 for the high half.
template <typename T>
__device__ void sum_range(const uint4* slot1, long long jstride,
                          const uint4* own, uint4* out, int beg, int end,
                          int D, int j0, int step) {
  constexpr int kN = Vec<T>::kN, kU = Vec<T>::kUnroll;
  for (int v0 = beg + threadIdx.x; v0 < end; v0 += kThreads * kU) {
    float acc[kU][kN];
    const uint4* s = slot1 + (j0 - 1) * jstride;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int v = v0 + u * kThreads;
      if (v < end) Vec<T>::unpack(__ldcg(s + v), acc[u]);
    }
    for (int t = 1; t < D; ++t) {  // D - 2 more peers, then the own part
      const uint4* src = t < D - 1 ? slot1 + (j0 - 1 + t * step) * jstride
                                   : own;
      uint4 x[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int v = v0 + u * kThreads;
        if (v < end) x[u] = t < D - 1 ? __ldcg(src + v) : src[v];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float f[kN];
        Vec<T>::unpack(x[u], f);
#pragma unroll
        for (int e = 0; e < kN; ++e) acc[u][e] += f[e];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int v = v0 + u * kThreads;
      if (v < end) out[v] = Vec<T>::pack(acc[u]);
    }
  }
}

// parts (D, n) of T, destination-major; out (n,) of T gets the float32
// sum over ranks of row `rank`, in the ring's order.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinCtas)
reduce_scatter_kernel(PushArgs a) {
  constexpr int kN = Vec<T>::kN;
  const int D = a.world, me = a.rank, cta = blockIdx.x;
  const T* parts = reinterpret_cast<const T*>(a.in);
  run_pieces(
      a,
      // each receiver c = me - j's part of the piece into its slot
      [&](int parity, long long off) {
        const int nv = (int)(min(a.piece, a.n - off) * sizeof(T) / 16);
        for (int j = 1; j < D; ++j) {
          const int c = (me - j + D) % D;
          copy_vectors<false>(
              reinterpret_cast<uint4*>(slot_at(
                  a, workspace(a, c), slot_index(a, cta, j, parity))),
              reinterpret_cast<const uint4*>(parts + c * a.n + off), nv);
        }
      },
      // every sender's slot and my own part, summed in the ring's order
      [&](int parity, long long off) {
        const int nv = (int)(min(a.piece, a.n - off) / kN);
        // vectors of this piece in the low half (n / 2 is a multiple of kN)
        const int nlow =
            (int)max(0LL, min((long long)nv, (a.n / 2 - off) / kN));
        // sender me + j's slot; consecutive j are kSlots slots apart
        const uint4* slot1 = reinterpret_cast<const uint4*>(
            slot_at(a, workspace(a, me), slot_index(a, cta, 1, parity)));
        const long long jstride = kSlots * a.slot_bytes / 16;
        const uint4* own =
            reinterpret_cast<const uint4*>(parts + me * a.n + off);
        uint4* out =
            reinterpret_cast<uint4*>(reinterpret_cast<T*>(a.out) + off);
        sum_range<T>(slot1, jstride, own, out, 0, nlow, D, 1, 1);
        sum_range<T>(slot1, jstride, own, out, nlow, nv, D, D - 1, -1);
      });
}

// Ranks of a ring that share one card at once (in-process ranks), by the
// ring's peer table; a ring not registered counts all its ranks.
std::mutex card_ranks_lock;
std::vector<std::pair<const void*, int>> card_ranks;

int ranks_on_card(const void* peers, int world) {
  std::lock_guard<std::mutex> hold(card_ranks_lock);
  for (const auto& entry : card_ranks)
    if (entry.first == peers) return entry.second;
  return world;
}

// The largest grid of either kernel on the current device for a ring of
// `world` ranks, `on_card` of them on this card (the co-residency rule,
// within the flags and the staging), and its slot size.
cudaError_t push_shape(int world, int on_card, int* grid_max,
                       long long* slot_bytes) {
  static int capacity[64];  // resident K3 CTAs per card, by device
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (capacity[dev] == 0) {
    int sms, occ[3];
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ[0], all_gather_kernel, kThreads, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ[1], reduce_scatter_kernel<float>, kThreads, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ[2], reduce_scatter_kernel<__nv_bfloat16>, kThreads, 0);
    if (e != cudaSuccess) return e;
    capacity[dev] = sms * std::min({occ[0], occ[1], occ[2]});
  }
  const long long peers = world - 1;
  long long g = capacity[dev] / (kSets * (long long)on_card);
  g = std::min(g, kMaxCtas / peers);
  g = std::min(g, kSetBytes / (peers * kSlots * kMinSlotBytes));
  if (g < 1) return cudaErrorInvalidValue;
  *grid_max = (int)g;
  *slot_bytes = kSetBytes / (g * peers * kSlots) / 1024 * 1024;
  return cudaSuccess;
}

bool valid(int rank, int world, int set, long long n) {
  return world >= 2 && rank >= 0 && rank < world && set >= 0 &&
         set < kSets && n > 0;
}

// The arguments of one launch: n units in pieces of at least `quantum`
// units that fit a slot (`unit_bytes` each), spread over the grid; the
// launch takes no more CTAs than pieces.
cudaError_t push_args(const void* peers, int rank, int world, int set,
                      int kind, const void* in, void* out, long long n,
                      long long unit_bytes, long long quantum, void* err,
                      long long timeout_ns, PushArgs* a, int* grid) {
  int grid_max;
  long long slot_bytes;
  const cudaError_t e = push_shape(world, ranks_on_card(peers, world),
                                   &grid_max, &slot_bytes);
  if (e != cudaSuccess) return e;
  const long long fit = slot_bytes / unit_bytes / quantum * quantum;
  const long long even = (n + grid_max - 1) / grid_max;
  a->peers = reinterpret_cast<const u64*>(peers);
  a->rank = rank;
  a->world = world;
  a->set = set >> 1;
  a->region = kind * kRegionBytes;
  a->in = in;
  a->out = out;
  a->n = n;
  a->piece = std::min(fit, (even + quantum - 1) / quantum * quantum);
  a->slot_bytes = slot_bytes;
  a->err = reinterpret_cast<int*>(err);
  a->timeout_ns = timeout_ns;
  *grid = (int)std::min((long long)grid_max, (n + a->piece - 1) / a->piece);
  return cudaSuccess;
}

}  // namespace

extern "C" {

int dpx_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// One zeroed workspace on `device` (cudaMalloc, so that it can be exported
// with CUDA IPC).
int dpx_ring_alloc(int device, void** out) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(out, kWorkspaceBytes);
  if (e == cudaSuccess) e = cudaMemset(*out, 0, kWorkspaceBytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

int dpx_ring_free(void* ptr) { return (int)cudaFree(ptr); }

// Register how many ranks of the ring with peer table `peers` run on one
// card at once (the kernels' grid divides the card among them); 0 forgets
// it.
int dpx_ring_card_ranks(const void* peers, int ranks) {
  std::lock_guard<std::mutex> hold(card_ranks_lock);
  for (auto it = card_ranks.begin(); it != card_ranks.end(); ++it) {
    if (it->first == peers) {
      card_ranks.erase(it);
      break;
    }
  }
  if (ranks > 0) card_ranks.emplace_back(peers, ranks);
  return 0;
}

int dpx_ipc_get_handle(void* ptr, void* handle_out) {
  return (int)cudaIpcGetMemHandle(
      reinterpret_cast<cudaIpcMemHandle_t*>(handle_out), ptr);
}

int dpx_ipc_open(int device, const void* handle, void** out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}

int dpx_ipc_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

// K3a. x: nbytes local payload (a multiple of 32); out: world * nbytes.
// Both 16-byte aligned. Gather ids are even: set >> 1 picks the buffers.
int dpx_ring_all_gather(const void* peers, int rank, int world, int set,
                        const void* x, void* out, long long nbytes, void* err,
                        long long timeout_ns, void* stream) {
  if (!valid(rank, world, set, nbytes) || nbytes % 32)
    return (int)cudaErrorInvalidValue;
  PushArgs a;
  int grid;
  const cudaError_t e = push_args(peers, rank, world, set, 0, x, out,
                                  nbytes / 16, 16, kAgQuantum, err,
                                  timeout_ns, &a, &grid);
  if (e != cudaSuccess) return (int)e;
  all_gather_kernel<<<grid, kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// K3b. dtype 0 = float32, 1 = bfloat16. parts: (world, n); out: (n,);
// n a multiple of 256 (two halves of 128-element rows); both 16-byte
// aligned. Scatter ids are odd: set >> 1 picks the buffers.
int dpx_ring_reduce_scatter(const void* peers, int rank, int world, int set,
                            int dtype, const void* parts, void* out,
                            long long n, void* err, long long timeout_ns,
                            void* stream) {
  if (!valid(rank, world, set, n) || n % kQuantum ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  PushArgs a;
  int grid;
  const cudaError_t e =
      push_args(peers, rank, world, set, 1, parts, out, n,
                dtype == 0 ? 4 : 2, kQuantum, err, timeout_ns, &a, &grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    reduce_scatter_kernel<float><<<grid, kThreads, 0, s>>>(a);
  } else {
    reduce_scatter_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
