// Ring all-gather (K3a) and ring reduce-scatter (K3b) over peer memory,
// for sm_90a.
//
// Replaces the TPU kernels of distributed_pytorch_example_tpu/ops/pallas/
// collectives.py: `_ring_all_gather` -> `_ag_kernel` (K3a) and
// `_ring_reduce_scatter` -> `_rs_kernel` (K3b). The ring, its two
// directions and its order of hops and chunks are the TPU kernels':
//
// - the local payload splits into two halves; the low half travels
//   clockwise (to rank me + 1), the high half counter-clockwise (to
//   me - 1), so both directions of every link carry bytes;
// - all-gather: at hop h, rank me forwards chunk (me - h) clockwise and
//   chunk (me + h) counter-clockwise; after D - 1 hops every rank holds
//   every chunk;
// - reduce-scatter: chunk c's clockwise partial starts at rank c + 1 as
//   that rank's own part, and each rank on the way adds its part in
//   float32 (received partial + own part), so rank c finishes its own
//   chunk after D - 1 hops; counter-clockwise mirrors it for the high
//   half. The float32 sum therefore follows the JAX ring's order, not
//   NCCL's.
//
// What replaces the TPU's remote DMA plus semaphore: each rank owns one
// workspace in device memory (flags, then staging slots), and every rank
// holds a table of every rank's workspace base pointer (CUDA IPC between
// processes, raw pointers between in-process ranks on one card). A hop
// is two steps. The sender stores into the receiver's staging slot
// through the peer pointer, runs __threadfence_system(), then stores the
// slot's epoch into the receiver's `full` flag with st.release.sys; the
// receiver waits with ld.acquire.sys. After reading the slot, the
// receiver stores the epoch into the sender's `ack` flag, and a sender
// waits for the ack of a slot's previous use before filling it again.
// Slots alternate by hop (the TPU kernels' double buffer by hop parity).
// Flags hold a monotonic epoch per (set, direction, slot, CTA), derived
// from a hop counter that each CTA keeps in its own workspace, so no flag
// is ever reset; every rank issues the same collectives in the same
// order, so the counters agree. The TPU kernels' neighbour barrier at
// entry (_ag_kernel lines 107-118) is an epoch flag per call as well.
// Each CTA owns one contiguous range of every direction's half-payload
// and one fixed part of every staging slot (kCtaSlotBytes), which only
// its own flags guard; its range goes through in pieces of that size.
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
// Bound: across cards, the bytes over NVLink at 450 GB/s each way, with
// (D - 1) / D of the payload on each direction's link; for in-process
// ranks on one card, the card's memory traffic: each rank at least
// reads and writes (D - 1) * n bytes, at 3.35 TB/s. This first version
// stages every hop through the receiver's slot (one extra copy) with 8
// CTAs per direction and 16-byte vectors; it is made to be right, not
// fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef unsigned long long u64;

constexpr int kSets = 8;
constexpr int kDirs = 2;
constexpr int kSlots = 2;
constexpr int kCtas = 8;  // CTAs per direction
constexpr int kThreads = 256;
constexpr long long kSlotBytes = 1LL << 20;
constexpr long long kCtaSlotBytes = kSlotBytes / kCtas;  // one CTA's part
constexpr int kFlagStride = 16;  // u64 words per flag: one 128-byte line
enum { kFull, kAck, kBarLeft, kBarRight, kHops, kCalls, kKinds };
constexpr long long kFlagBytes =
    (long long)kSets * kDirs * kCtas * kSlots * kKinds * kFlagStride * 8;
constexpr long long kStagingOffset = (kFlagBytes + 4095) / 4096 * 4096;
constexpr long long kWorkspaceBytes =
    kStagingOffset + (long long)kSets * kDirs * kSlots * kSlotBytes;

// error codes written into `err`
enum { kErrBarrier = 1, kErrAck = 2, kErrFull = 3 };

struct RingArgs {
  const u64* peers;  // world workspace base pointers (device)
  int rank, world, set;
  const void* in;
  void* out;
  long long n;  // all-gather: local payload bytes; reduce-scatter: chunk elements
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

// CTA-wide bounded wait for *f >= want. Thread 0 spins; on timeout it
// records `code` (first error wins) and every thread gets false.
__device__ bool cta_wait(const u64* f, u64 want, const RingArgs& a,
                         int code) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    int good = 1;
    const u64 start = gtimer();
    while (ld_acquire(f) < want) {
      if (*(volatile int*)a.err != 0) {  // this rank already failed
        good = 0;
        break;
      }
      if ((long long)(gtimer() - start) > a.timeout_ns) {
        atomicCAS(a.err, 0, code);
        good = 0;
        break;
      }
    }
    ok = good;
  }
  __syncthreads();
  const bool r = ok;
  __syncthreads();
  return r;
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

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float4 add4(float4 r, float4 m) {
  return make_float4(r.x + m.x, r.y + m.y, r.z + m.z, r.w + m.w);
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

// K3b: parts (D, n) of T, destination-major; out (n,) of T gets the
// float32 sum over ranks of row `rank`, in the ring's order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_reduce_scatter_kernel(RingArgs a) {
  Ring r;
  if (!ring_enter(a, &r)) return;
  const int D = r.D, me = r.me, dir = r.dir;
  const long long n = a.n, half = n / 2, hoff = dir * half;
  const T* parts = reinterpret_cast<const T*>(a.in);
  T* out = reinterpret_cast<T*>(a.out);
  constexpr long long kPiece = kCtaSlotBytes / 4;  // float32 partials
  long long qa, qb;
  cta_range(half >> 2, r.cta, &qa, &qb);
  const long long beg = qa << 2, end = qb << 2;
  u64 g = r.hops;
  for (long long po = beg; po < end; po += kPiece) {
    const long long quads = min(kPiece, end - po) >> 2;
    {  // hop 0's send: my own part of the chunk that starts its sum here
      const int slot = (int)(g & 1);
      const u64 ep = (g >> 1) + 1;
      const int c = dir == 0 ? (me - 1 + D) % D : (me + 1) % D;
      if (!cta_wait(flag(r.wme, a.set, dir, r.cta, slot, kAck), ep - 1, a,
                    kErrAck))
        return;
      const T* mine = parts + c * n + hoff + po;
      float* dst = reinterpret_cast<float*>(
          staging(r.down, a.set, dir, slot, r.cta));
      for (long long i = threadIdx.x; i < quads; i += kThreads)
        store4(dst + 4 * i, load4(mine + 4 * i));
      cta_signal(flag(r.down, a.set, dir, r.cta, slot, kFull), ep);
    }
    for (int h = 0; h < D - 1; ++h) {
      const u64 gr = g + h;  // the upstream's hop-h send
      const int slot = (int)(gr & 1);
      const u64 ep = (gr >> 1) + 1;
      if (!cta_wait(flag(r.wme, a.set, dir, r.cta, slot, kFull), ep, a,
                    kErrFull))
        return;
      const int c = dir == 0 ? (me - 2 - h + 2 * D) % D : (me + 2 + h) % D;
      const float* recv = reinterpret_cast<const float*>(
          staging(r.wme, a.set, dir, slot, r.cta));
      const T* mine = parts + c * n + hoff + po;
      if (h < D - 2) {  // fold in my part and send on
        const u64 gs = gr + 1;
        const int sslot = (int)(gs & 1);
        const u64 sep = (gs >> 1) + 1;
        if (!cta_wait(flag(r.wme, a.set, dir, r.cta, sslot, kAck), sep - 1,
                      a, kErrAck))
          return;
        float* dst = reinterpret_cast<float*>(
            staging(r.down, a.set, dir, sslot, r.cta));
        for (long long i = threadIdx.x; i < quads; i += kThreads) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(recv) + i);
          store4(dst + 4 * i, add4(v, load4(mine + 4 * i)));
        }
        cta_signal(flag(r.down, a.set, dir, r.cta, sslot, kFull), sep);
      } else {  // the received chunk is mine: this add completes it
        T* dst = out + hoff + po;
        for (long long i = threadIdx.x; i < quads; i += kThreads) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(recv) + i);
          store4(dst + 4 * i, add4(v, load4(mine + 4 * i)));
        }
        __syncthreads();
      }
      if (threadIdx.x == 0)
        st_release(flag(r.up, a.set, dir, r.cta, slot, kAck), ep);
    }
    g += D - 1;
  }
  ring_leave(a, r, g);
}

RingArgs make_args(const void* peers, int rank, int world, int set,
                   const void* in, void* out, long long n, void* err,
                   long long timeout_ns) {
  RingArgs a;
  a.peers = reinterpret_cast<const u64*>(peers);
  a.rank = rank;
  a.world = world;
  a.set = set;
  a.in = in;
  a.out = out;
  a.n = n;
  a.err = reinterpret_cast<int*>(err);
  a.timeout_ns = timeout_ns;
  return a;
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

// K3a. x: nbytes local payload (a multiple of 256 bytes... and of 2 * 128
// elements); out: world * nbytes. Both 16-byte aligned.
int dpx_ring_all_gather(const void* peers, int rank, int world, int set,
                        const void* x, void* out, long long nbytes, void* err,
                        long long timeout_ns, void* stream) {
  if (!valid(rank, world, set, nbytes) || nbytes % 32)
    return (int)cudaErrorInvalidValue;
  ring_all_gather_kernel<<<kDirs * kCtas, kThreads, 0,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      make_args(peers, rank, world, set, x, out, nbytes, err, timeout_ns));
  return (int)cudaGetLastError();
}

// K3b. dtype 0 = float32, 1 = bfloat16. parts: (world, n); out: (n,);
// n a multiple of 8.
int dpx_ring_reduce_scatter(const void* peers, int rank, int world, int set,
                            int dtype, const void* parts, void* out,
                            long long n, void* err, long long timeout_ns,
                            void* stream) {
  if (!valid(rank, world, set, n) || n % 8) return (int)cudaErrorInvalidValue;
  const RingArgs a =
      make_args(peers, rank, world, set, parts, out, n, err, timeout_ns);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    ring_reduce_scatter_kernel<float><<<kDirs * kCtas, kThreads, 0, s>>>(a);
  } else if (dtype == 1) {
    ring_reduce_scatter_kernel<__nv_bfloat16>
        <<<kDirs * kCtas, kThreads, 0, s>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
