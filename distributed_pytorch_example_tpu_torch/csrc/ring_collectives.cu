// Ring all-gather (K3a) and one-shot reduce-scatter (K3b) over peer
// memory, for sm_90a.
//
// Both replace TPU kernels of distributed_pytorch_example_tpu/ops/pallas/
// collectives.py: `_ring_all_gather` -> `_ag_kernel` (K3a) and
// `_ring_reduce_scatter` -> `_rs_kernel` (K3b).
//
// What replaces the TPU's remote DMA plus semaphore: each rank owns one
// workspace in device memory (flags, then staging slots), and every rank
// holds a table of every rank's workspace base pointer (CUDA IPC between
// processes, raw pointers between in-process ranks on one card). A
// transfer is two steps. The sender's CTA stores into the receiver's
// staging slot through the peer pointer; after __syncthreads() and a
// system fence (__threadfence_system), one thread stores the slot's epoch
// into the receiver's `full` flag with st.release.sys; the receiver waits
// with ld.acquire.sys. After reading the slot, the receiver stores the epoch
// into the sender's `ack` flag, and a sender waits for the ack of a slot's
// previous use before filling it again. Flags hold monotonic epochs,
// derived from a counter that each CTA keeps in its own workspace, so no
// flag is ever reset; every rank issues the same collectives in the same
// order, so the counters agree.
//
// Every wait is bounded with %globaltimer (`timeout_ns`, 10 s by
// default): a wait that expires writes an error code into the caller's
// device word `err` and the kernel returns; a kernel that finds `err`
// already set returns at once. The wrapper reads the word at the train
// step's host sync and raises, so a peer that never arrives is an error,
// not a hung card.
//
// Sets: collective ids 2 * stream (gather) and 2 * stream + 1 (scatter),
// stream taken modulo 4, each with its own staging slots and flags, so
// collectives of distinct stream ids can be in flight at once.
//
// K3a keeps the TPU kernel's ring. The local payload splits into two
// halves; the low half travels clockwise (to rank me + 1), the high half
// counter-clockwise; at hop h rank me forwards chunk (me - h) clockwise and
// chunk (me + h) counter-clockwise, through the receiver's slot (slots
// alternate by hop, the TPU kernel's double buffer), after a neighbour
// barrier per call (_ag_kernel lines 107-118). Each of its 8 CTAs per
// direction owns one contiguous range of every direction's half-payload
// and one fixed part of every staging slot (kCtaSlotBytes), which only its
// own flags guard.
//
// K3b keeps the TPU kernel's result bit for bit, not its ring. Rank c gets
// out (n,) = the float32 sum over ranks r of x_r = parts_r[c], cast back
// to T, added in the ring's order (indices mod D):
//   low half [0, n/2):   ((x_{c+1} + x_{c+2}) + ...) + x_c
//   high half [n/2, n):  ((x_{c-1} + x_{c-2}) + ...) + x_c
// the clockwise partial seeded at c + 1 with an own-part add at every hop,
// and its counter-clockwise mirror. On an HGX H100 every card reaches
// every other through NVSwitch at the full NVLink rate, so there is no
// ring to walk: every rank pushes parts[c] straight to rank c, and c adds
// what it received in that order.
//   - Push: a CTA reads its own parts[c] piece and stores it in T (bf16
//     stays bf16 on the wire) with 16-byte vectors into rank c's slot for
//     (this sender, this CTA, piece parity), then releases one epoch flag
//     per receiver. Stores over NVLink are posted: no round trip per piece.
//     Pushing, not pulling, because a peer cannot read another process's
//     caching-allocator tensors without an IPC handle per call; the
//     workspace is the only memory the ranks share.
//   - Reduce: the CTA waits for the D - 1 flags of a piece, sums its slots
//     (__ldcg, past L1, whose lines may predate the peers' stores) and its
//     own part in float32 in the order above, writes out and releases one
//     ack per sender.
//   - Pipeline: a CTA pushes piece i + 1 before it reduces piece i (two
//     slots per sender and CTA), and takes pieces k, k + G, k + 2G, ...
//     Payloads larger than the slots (the whole GPT-2 gradient) go through
//     in pieces; a piece is at least 256 elements.
// What bounded the ring version, and what this design does about it:
//   1. 16 CTAs on 132 SMs: the grid now comes from the SM count and the
//      kernel's occupancy (the co-residency rule below).
//   2. D - 1 chained hops, each an ack wait, a staged copy, a fence and a
//      flag, with no two pieces of a CTA in flight: one hop and one wait
//      per element, whatever D, and two pieces in flight per CTA.
//   3. A neighbour barrier per CTA per call, and float32 partials on the
//      wire: no barrier (the ack of a slot's previous use orders calls),
//      and parts cross in T.
//   4. A flag round trip costs a time slice between processes that share
//      a card: a call whose chunk fits the slots waits for each peer once
//      per CTA, instead of once per hop and piece plus the barrier.
// Co-residency rule: every CTA of every rank in flight must be resident
// at once, since each spins on flags that the others set; a rank whose
// grid filled the SMs would starve the kernels it waits on, and the wait
// would time out. R ranks may share one card at once (in-process ranks:
// R = D; a ring over processes: R = 1, since processes that share a card
// run in separate contexts, which time-slice) and each may have all 8
// collective ids in flight on distinct CUDA streams, so one K3b launch
// takes at most SMs x occupancy / (8 R) CTAs. The wrapper registers R per
// ring (dpx_ring_card_ranks); an unregistered ring counts R = D. K3b is
// built to 32 registers a thread (kMinCtas), so its occupancy is 8 CTAs of
// 256 threads per SM, as K3a's, and a K3a launch (16 CTAs) fits the same
// share up to R = 8.
// Slot layout: a slot's place and size depend on (set, CTA, sender,
// parity), the ring (D, R) and the card, never on n, so calls of changing
// size never share a slot part under another CTA's flags.
//
// Bound: across cards, the bytes over NVLink at 450 GB/s each way, with
// (D - 1) / D of the payload into each rank (K3b) or out of each
// direction's link (K3a); for in-process ranks on one card, the card's
// memory traffic, each rank's input read once and output written once at
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
constexpr int kFlagStride = 16;  // u64 words per flag: one 128-byte line

// K3a's region: flags, then staging, for the 4 gather sets (set >> 1)
constexpr int kAgSets = 4;
constexpr int kDirs = 2;
constexpr int kSlots = 2;
constexpr int kCtas = 8;  // CTAs per direction
constexpr long long kSlotBytes = 1LL << 20;
constexpr long long kCtaSlotBytes = kSlotBytes / kCtas;  // one CTA's part
enum { kFull, kAck, kBarLeft, kBarRight, kHops, kCalls, kKinds };
constexpr long long kFlagBytes =
    (long long)kAgSets * kDirs * kCtas * kSlots * kKinds * kFlagStride * 8;
constexpr long long kStagingOffset = (kFlagBytes + 4095) / 4096 * 4096;
constexpr long long kAgBytes =
    kStagingOffset + (long long)kAgSets * kDirs * kSlots * kSlotBytes;

// K3b's region, for the 4 scatter sets (set >> 1): per-CTA piece
// counters, `full` flags, `ack` flags, then staging
constexpr int kRsSets = 4;
constexpr int kRsSlots = 2;      // per (sender, CTA): pieces in flight
constexpr int kRsFlags = 4096;   // flags of each kind per set
constexpr int kRsMaxCtas = kRsFlags / kRsSlots;
constexpr long long kRsSetBytes = 32LL << 20;  // staging per set
constexpr long long kRsMinSlotBytes = 4096;
constexpr long long kQuantum = 256;  // piece granularity, elements
constexpr long long kRsCounterOffset = kAgBytes;
constexpr long long kRsFullOffset =
    kRsCounterOffset + (long long)kRsSets * kRsMaxCtas * 8;
constexpr long long kRsAckOffset =
    kRsFullOffset + (long long)kRsSets * kRsFlags * kFlagStride * 8;
constexpr long long kRsStagingOffset =
    kRsAckOffset + (long long)kRsSets * kRsFlags * kFlagStride * 8;
constexpr long long kWorkspaceBytes =
    kRsStagingOffset + (long long)kRsSets * kRsSetBytes;

// error codes written into `err`
enum { kErrBarrier = 1, kErrAck = 2, kErrFull = 3 };

struct RingArgs {
  const u64* peers;  // world workspace base pointers (device)
  int rank, world, set;
  const void* in;
  void* out;
  long long n;  // all-gather: local payload bytes
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

__device__ __forceinline__ u64* flag(char* base, int set, int dir, int cta,
                                     int slot, int kind) {
  const long long idx =
      ((((long long)set * kDirs + dir) * kCtas + cta) * kSlots + slot) *
          kKinds + kind;
  return reinterpret_cast<u64*>(base) + idx * kFlagStride;
}

// CTA `cta`'s part of a staging slot
__device__ __forceinline__ char* staging(char* base, int set, int dir,
                                         int slot, int cta) {
  return base + kStagingOffset +
         (((long long)set * kDirs + dir) * kSlots + slot) * kSlotBytes +
         cta * kCtaSlotBytes;
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

// CTA-wide bounded wait for *f >= want: thread 0 spins, and every thread
// gets its result.
__device__ bool cta_wait(const u64* f, u64 want, const RingArgs& a,
                         int code) {
  int good = 1;
  if (threadIdx.x == 0)
    good = spin_until(f, want, a.err, a.timeout_ns, code);
  return __syncthreads_and(good);
}

// every thread's stores to the peer become visible before the flag
__device__ __forceinline__ void cta_signal(u64* f, u64 v) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) st_release(f, v);
}

// this CTA's [a, b) share of `units` work units
__device__ __forceinline__ void cta_range(long long units, int cta,
                                          long long* a, long long* b) {
  const long long per = (units + kCtas - 1) / kCtas;
  *a = min(units, (long long)cta * per);
  *b = min(units, *a + per);
}

// bytes, a multiple of 16 at 16-byte aligned addresses; `from_peer` reads
// past L1, whose lines may predate the peer's stores
__device__ __forceinline__ void copy16(char* dst, const char* src,
                                       long long bytes, bool from_peer) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  const long long n = bytes >> 4;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    d[i] = from_peer ? __ldcg(s + i) : s[i];
  }
}

// Shared prologue: bail out if this rank already failed, read this CTA's
// hop and call counters, and run the neighbour barrier of this call.
struct Ring {
  int dir, cta, me, D;
  char *wme, *down, *up;  // mine; where my sends land; who sends to me
  u64 hops, call;
};

__device__ bool ring_enter(const RingArgs& a, Ring* r) {
  r->dir = blockIdx.x / kCtas;
  r->cta = blockIdx.x % kCtas;
  r->me = a.rank;
  r->D = a.world;
  const int right = (a.rank + 1) % a.world;
  const int left = (a.rank + a.world - 1) % a.world;
  r->wme = reinterpret_cast<char*>(a.peers[a.rank]);
  char* wright = reinterpret_cast<char*>(a.peers[right]);
  char* wleft = reinterpret_cast<char*>(a.peers[left]);
  r->down = r->dir == 0 ? wright : wleft;
  r->up = r->dir == 0 ? wleft : wright;
  __shared__ u64 s_hops, s_calls;
  __shared__ int s_bail;
  if (threadIdx.x == 0) {
    s_bail = *(volatile int*)a.err != 0;
    s_hops = *(volatile u64*)flag(r->wme, a.set, r->dir, r->cta, 0, kHops);
    s_calls = *(volatile u64*)flag(r->wme, a.set, r->dir, r->cta, 0, kCalls);
  }
  __syncthreads();
  if (s_bail) return false;
  r->hops = s_hops;
  r->call = s_calls + 1;
  if (threadIdx.x == 0) {
    // I am my right neighbour's left neighbour, and my left's right
    st_release(flag(wright, a.set, r->dir, r->cta, 0, kBarLeft), r->call);
    st_release(flag(wleft, a.set, r->dir, r->cta, 0, kBarRight), r->call);
  }
  return cta_wait(flag(r->wme, a.set, r->dir, r->cta, 0, kBarLeft), r->call,
                  a, kErrBarrier) &&
         cta_wait(flag(r->wme, a.set, r->dir, r->cta, 0, kBarRight), r->call,
                  a, kErrBarrier);
}

__device__ void ring_leave(const RingArgs& a, const Ring& r, u64 hops) {
  if (threadIdx.x == 0) {
    *(volatile u64*)flag(r.wme, a.set, r.dir, r.cta, 0, kHops) = hops;
    *(volatile u64*)flag(r.wme, a.set, r.dir, r.cta, 0, kCalls) = r.call;
  }
}

// K3a: out (D, n) bytes gets every rank's local payload x (n bytes).
__global__ void __launch_bounds__(kThreads)
ring_all_gather_kernel(RingArgs a) {
  Ring r;
  if (!ring_enter(a, &r)) return;
  const int D = r.D, me = r.me, dir = r.dir;
  const long long nbytes = a.n, half = nbytes / 2, hoff = dir * half;
  const char* x = reinterpret_cast<const char*>(a.in);
  char* out = reinterpret_cast<char*>(a.out);
  long long ua, ub;
  cta_range(half >> 4, r.cta, &ua, &ub);
  const long long beg = ua << 4, end = ub << 4;
  // seed my own row: no hop reads it (hop 0 sends from x)
  copy16(out + me * nbytes + hoff + beg, x + hoff + beg, end - beg, false);
  u64 g = r.hops;
  for (long long po = beg; po < end; po += kCtaSlotBytes) {
    const long long len = min(kCtaSlotBytes, end - po);
    for (int h = 0; h < D - 1; ++h, ++g) {
      const int slot = (int)(g & 1);
      const u64 ep = (g >> 1) + 1;
      const int c_send = dir == 0 ? (me - h + D) % D : (me + h) % D;
      const int c_recv =
          dir == 0 ? (me - 1 - h + 2 * D) % D : (me + 1 + h) % D;
      const char* src =
          (h == 0 ? x + hoff : out + c_send * nbytes + hoff) + po;
      if (!cta_wait(flag(r.wme, a.set, dir, r.cta, slot, kAck), ep - 1, a,
                    kErrAck))
        return;
      copy16(staging(r.down, a.set, dir, slot, r.cta), src, len, false);
      cta_signal(flag(r.down, a.set, dir, r.cta, slot, kFull), ep);
      if (!cta_wait(flag(r.wme, a.set, dir, r.cta, slot, kFull), ep, a,
                    kErrFull))
        return;
      copy16(out + c_recv * nbytes + hoff + po,
             staging(r.wme, a.set, dir, slot, r.cta), len, true);
      __syncthreads();
      if (threadIdx.x == 0)
        st_release(flag(r.up, a.set, dir, r.cta, slot, kAck), ep);
    }
  }
  ring_leave(a, r, g);
}

// ---------------------------------------------------------------------------
// K3b
// ---------------------------------------------------------------------------

struct RsArgs {
  const u64* peers;  // world workspace base pointers (device)
  int rank, world, set;  // set: the scatter set, 0..3
  const void* in;        // parts (world, n) of T
  void* out;             // (n,) of T
  long long n;           // chunk elements, a multiple of kQuantum
  long long piece;       // elements per piece, a multiple of kQuantum
  long long slot_bytes;  // one slot's bytes (fixed per ring and card)
  int* err;
  long long timeout_ns;
};

constexpr int kMinCtas = 8;  // per SM: at most 32 registers a thread
constexpr int kCopyUnroll = 4;  // 16-byte vectors in flight per thread

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

__device__ __forceinline__ char* workspace(const RsArgs& a, int rank) {
  return reinterpret_cast<char*>(a.peers[rank]);
}

// index of the (CTA, peer offset j in 1..D-1, parity) slot and its flags;
// the sender is rank receiver + j
__device__ __forceinline__ long long rs_index(const RsArgs& a, int cta,
                                              int j, int parity) {
  return ((long long)cta * (a.world - 1) + (j - 1)) * kRsSlots + parity;
}

__device__ __forceinline__ u64* rs_flag(char* base, long long kind_offset,
                                        int set, long long idx) {
  return reinterpret_cast<u64*>(base + kind_offset) +
         ((long long)set * kRsFlags + idx) * kFlagStride;
}

__device__ __forceinline__ u64* rs_counter(char* base, int set, int cta) {
  return reinterpret_cast<u64*>(base + kRsCounterOffset) +
         (long long)set * kRsMaxCtas + cta;
}

__device__ __forceinline__ char* rs_slot(const RsArgs& a, char* base,
                                         long long idx) {
  return base + kRsStagingOffset + a.set * kRsSetBytes + idx * a.slot_bytes;
}

// CTA-wide bounded wait: for every j in 1..D-1 one thread spins until
// the flag flag_of(j) >= want. True on every thread when all arrived.
template <typename FlagOf>
__device__ bool cta_wait_peers(const RsArgs& a, FlagOf flag_of, u64 want,
                               int code) {
  int good = 1;
  for (int j = 1 + threadIdx.x; good && j < a.world; j += kThreads)
    good = spin_until(flag_of(j), want, a.err, a.timeout_ns, code);
  return __syncthreads_and(good);
}

// The CTA's loads and stores so far, then __syncthreads, a system fence
// and flag_of(j) = v (release) by one thread per j in 1..D-1.
template <typename FlagOf>
__device__ void cta_release_peers(const RsArgs& a, FlagOf flag_of, u64 v) {
  __syncthreads();
  for (int j = 1 + threadIdx.x; j < a.world; j += kThreads) {
    __threadfence_system();
    st_release(flag_of(j), v);
  }
}

// Push the piece at chunk offset `off` (CTA piece count g) to every
// receiver c = me - j: its parts[c] slice into c's slot (this CTA, j).
template <typename T>
__device__ bool rs_push(const RsArgs& a, u64 g, long long off) {
  const int D = a.world, me = a.rank, cta = blockIdx.x;
  const int parity = (int)(g % kRsSlots);
  const u64 ep = g / kRsSlots + 1;
  char* wme = workspace(a, me);
  // every receiver has read this slot's previous piece
  if (!cta_wait_peers(
          a,
          [&](int j) {
            return rs_flag(wme, kRsAckOffset, a.set,
                           rs_index(a, cta, j, parity));
          },
          ep - 1, kErrAck))
    return false;
  const int nv = (int)(min(a.piece, a.n - off) * sizeof(T) / 16);
  const T* parts = reinterpret_cast<const T*>(a.in);
  for (int j = 1; j < D; ++j) {
    const int c = (me - j + D) % D;
    const uint4* src =
        reinterpret_cast<const uint4*>(parts + c * a.n + off);
    uint4* dst = reinterpret_cast<uint4*>(
        rs_slot(a, workspace(a, c), rs_index(a, cta, j, parity)));
    for (int v0 = threadIdx.x; v0 < nv; v0 += kThreads * kCopyUnroll) {
      uint4 x[kCopyUnroll];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int v = v0 + u * kThreads;
        if (v < nv) x[u] = src[v];
      }
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int v = v0 + u * kThreads;
        if (v < nv) dst[v] = x[u];
      }
    }
  }
  cta_release_peers(
      a,
      [&](int j) {
        return rs_flag(workspace(a, (me - j + D) % D), kRsFullOffset, a.set,
                       rs_index(a, cta, j, parity));
      },
      ep);
  return true;
}

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

// Reduce the piece at chunk offset `off` (CTA piece count g): wait for
// every sender's slot, sum in the ring's order, write out, ack.
template <typename T>
__device__ bool rs_reduce(const RsArgs& a, u64 g, long long off) {
  constexpr int kN = Vec<T>::kN;
  const int D = a.world, me = a.rank, cta = blockIdx.x;
  const int parity = (int)(g % kRsSlots);
  const u64 ep = g / kRsSlots + 1;
  char* wme = workspace(a, me);
  if (!cta_wait_peers(
          a,
          [&](int j) {
            return rs_flag(wme, kRsFullOffset, a.set,
                           rs_index(a, cta, j, parity));
          },
          ep, kErrFull))
    return false;
  const int nv = (int)(min(a.piece, a.n - off) / kN);
  // vectors of this piece in the low half (n / 2 is a multiple of kN)
  const int nlow = (int)max(0LL, min((long long)nv, (a.n / 2 - off) / kN));
  // sender me + j's slot; consecutive j are kRsSlots slots apart
  const uint4* slot1 = reinterpret_cast<const uint4*>(
      rs_slot(a, wme, rs_index(a, cta, 1, parity)));
  const long long jstride = kRsSlots * a.slot_bytes / 16;
  const uint4* own = reinterpret_cast<const uint4*>(
      reinterpret_cast<const T*>(a.in) + me * a.n + off);
  uint4* out = reinterpret_cast<uint4*>(reinterpret_cast<T*>(a.out) + off);
  sum_range<T>(slot1, jstride, own, out, 0, nlow, D, 1, 1);
  sum_range<T>(slot1, jstride, own, out, nlow, nv, D, D - 1, -1);
  // the slots are read: each sender may refill its own
  cta_release_peers(
      a,
      [&](int j) {
        return rs_flag(workspace(a, (me + j) % D), kRsAckOffset, a.set,
                       rs_index(a, cta, j, parity));
      },
      ep);
  return true;
}

// K3b: parts (D, n) of T, destination-major; out (n,) of T gets the
// float32 sum over ranks of row `rank`, in the ring's order. CTA k takes
// pieces k, k + G, ...; it pushes piece i + 1 before it reduces piece i.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinCtas)
reduce_scatter_kernel(RsArgs a) {
  const int cta = blockIdx.x, grid = gridDim.x;
  char* wme = workspace(a, a.rank);
  __shared__ u64 s_count;
  __shared__ int s_bail;
  if (threadIdx.x == 0) {
    s_bail = *(volatile int*)a.err != 0;
    s_count = *(volatile u64*)rs_counter(wme, a.set, cta);
  }
  __syncthreads();
  if (s_bail) return;
  const u64 g0 = s_count;
  const long long pieces = (a.n + a.piece - 1) / a.piece;
  const long long mine = (pieces - cta + grid - 1) / grid;
  for (long long i = 0; i <= mine; ++i) {
    if (i < mine && !rs_push<T>(a, g0 + i, (cta + i * grid) * a.piece))
      return;
    if (i > 0 &&
        !rs_reduce<T>(a, g0 + i - 1, (cta + (i - 1) * grid) * a.piece))
      return;
  }
  if (threadIdx.x == 0)
    *(volatile u64*)rs_counter(wme, a.set, cta) = g0 + mine;
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

// The largest K3b grid on the current device for a ring of `world` ranks,
// `on_card` of them on this card (the co-residency rule, within the flags
// and the staging), and its slot size.
cudaError_t rs_shape(int world, int on_card, int* grid_max,
                     long long* slot_bytes) {
  static int capacity[64];  // resident K3b CTAs per card, by device
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (capacity[dev] == 0) {
    int sms, occ_f32, occ_bf16;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ_f32, reduce_scatter_kernel<float>, kThreads, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ_bf16, reduce_scatter_kernel<__nv_bfloat16>, kThreads, 0);
    if (e != cudaSuccess) return e;
    capacity[dev] = sms * std::min(occ_f32, occ_bf16);
  }
  const long long peers = world - 1;
  long long g = capacity[dev] / (kSets * (long long)on_card);
  g = std::min(g, kRsMaxCtas / peers);
  g = std::min(g, kRsSetBytes / (peers * kRsSlots * kRsMinSlotBytes));
  if (g < 1) return cudaErrorInvalidValue;
  *grid_max = (int)g;
  *slot_bytes = kRsSetBytes / (g * peers * kRsSlots) / 1024 * 1024;
  return cudaSuccess;
}

bool valid(int rank, int world, int set, long long n) {
  return world >= 2 && rank >= 0 && rank < world && set >= 0 &&
         set < kSets && n > 0;
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
// card at once (K3b's grid divides the card among them); 0 forgets it.
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
  RingArgs a;
  a.peers = reinterpret_cast<const u64*>(peers);
  a.rank = rank;
  a.world = world;
  a.set = set >> 1;
  a.in = x;
  a.out = out;
  a.n = nbytes;
  a.err = reinterpret_cast<int*>(err);
  a.timeout_ns = timeout_ns;
  ring_all_gather_kernel<<<kDirs * kCtas, kThreads, 0,
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
  int grid_max;
  long long slot_bytes;
  const cudaError_t e = rs_shape(world, ranks_on_card(peers, world),
                                 &grid_max, &slot_bytes);
  if (e != cudaSuccess) return (int)e;
  const long long esize = dtype == 0 ? 4 : 2;
  const long long fit = slot_bytes / esize / kQuantum * kQuantum;
  const long long even = (n + grid_max - 1) / grid_max;
  RsArgs a;
  a.peers = reinterpret_cast<const u64*>(peers);
  a.rank = rank;
  a.world = world;
  a.set = set >> 1;
  a.in = parts;
  a.out = out;
  a.n = n;
  a.piece = std::min(fit, (even + kQuantum - 1) / kQuantum * kQuantum);
  a.slot_bytes = slot_bytes;
  a.err = reinterpret_cast<int*>(err);
  a.timeout_ns = timeout_ns;
  const int grid =
      (int)std::min((long long)grid_max, (n + a.piece - 1) / a.piece);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    reduce_scatter_kernel<float><<<grid, kThreads, 0, s>>>(a);
  } else {
    reduce_scatter_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
