#!/usr/bin/env python3
"""Can two processes on one NVIDIA card wait on each other's flags?

The ring collectives (``distributed_pytorch_example_tpu_torch/csrc/
ring_collectives.cu``) hand data between ranks through staging buffers in
device memory that each rank exports with CUDA IPC, and each hop waits on
a flag that the neighbour's kernel sets. When two ranks share one card,
that works only if (1) the card's compute mode lets two processes hold a
context on it, (2) ``cudaIpcOpenMemHandle`` of a buffer exported by the
other process succeeds on the same device, and (3) a kernel in process A
that spins on a flag set by a kernel in process B finishes, which needs
the card to time-slice between the two contexts. This script checks all
three and prints one JSON line:

    python3 scripts/probe_peer_ipc.py

- ``nvidia_smi``: ``name, power.limit, compute_mode`` as nvidia-smi gives
  them;
- ``ipc_open``: whether each process opened the other's handle;
- ``first_wait_us``: how long process A's kernel spun on its first flag,
  from its own start (this includes process B's launch delay);
- ``round_trip_us``: the mean time of one flag round trip A -> B -> A over
  ``ITERS`` round trips, both kernels resident, every wait bounded at
  10 s with ``%globaltimer``.

It builds its own small CUDA source with nvcc into the package's ignored
``build/`` directory. Exit code 0 when all three hold.
"""

from __future__ import annotations

import ctypes
import json
import multiprocessing
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ITERS = 1000
TIMEOUT_NS = 10_000_000_000

SOURCE = r"""
#include <cuda_runtime.h>
#include <string.h>

typedef unsigned long long u64;

__device__ __forceinline__ u64 gtimer() {
  u64 t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t;
}
__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// role 0 sets the peer's flag then waits on its own; role 1 waits, then
// sets. Flags count up from base + 1. result: [elapsed ns, status,
// ns spent in the first wait]
__global__ void pingpong(u64* mine, u64* peer, int role, u64 base, int iters,
                         long long timeout, long long* result) {
  u64 t0 = gtimer();
  long long first = -1;
  int status = 0;
  for (int i = 1; i <= iters && !status; ++i) {
    u64 want = base + i;
    if (role == 0) st_release(peer, want);
    u64 ts = gtimer();
    while (ld_acquire(mine) < want) {
      if ((long long)(gtimer() - ts) > timeout) { status = 1; break; }
    }
    if (first < 0) first = (long long)(gtimer() - t0);
    if (role == 1 && !status) st_release(peer, want);
  }
  result[0] = (long long)(gtimer() - t0);
  result[1] = status;
  result[2] = first;
}

extern "C" {
int probe_alloc(void** out) {
  cudaError_t e = cudaMalloc(out, 4096);
  if (e == cudaSuccess) e = cudaMemset(*out, 0, 4096);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
int probe_get_handle(void* ptr, void* out) {
  return (int)cudaIpcGetMemHandle((cudaIpcMemHandle_t*)out, ptr);
}
int probe_open(const void* handle, void** out) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}
int probe_pingpong(void* mine, void* peer, int role, unsigned long long base,
                   int iters, long long timeout, void* result) {
  pingpong<<<1, 1>>>((u64*)mine, (u64*)peer, role, base, iters, timeout,
                     (long long*)result);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
}
"""


def build() -> str:
    from distributed_pytorch_example_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "probe_peer_ipc.cu"
    lib = _build.BUILD_DIR / "libprobe_peer_ipc.so"
    src.write_text(SOURCE)
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return str(lib)


def _lib(path):
    lib = ctypes.CDLL(path)
    p = ctypes.c_void_p
    lib.probe_alloc.argtypes = [ctypes.POINTER(p)]
    lib.probe_get_handle.argtypes = [p, p]
    lib.probe_open.argtypes = [p, ctypes.POINTER(p)]
    lib.probe_pingpong.argtypes = [p, p, ctypes.c_int, ctypes.c_ulonglong,
                                   ctypes.c_int, ctypes.c_longlong, p]
    return lib


def worker(role, lib_path, handles, results, start):
    import torch

    torch.cuda.init()
    torch.zeros(1, device="cuda")  # the primary context, as torch uses it
    lib = _lib(lib_path)
    mine = ctypes.c_void_p()
    out = {"role": role}
    err = lib.probe_alloc(ctypes.byref(mine))
    if err:
        out["error"] = f"cudaMalloc {err}"
        results.put(out)
        return
    handle = ctypes.create_string_buffer(64)
    err = lib.probe_get_handle(mine, handle)
    handles[role].put(handle.raw if not err else None)
    peer_handle = handles[1 - role].get(timeout=120)
    if peer_handle is None:
        out["error"] = "peer could not export a handle"
        results.put(out)
        return
    peer = ctypes.c_void_p()
    err = lib.probe_open(peer_handle, ctypes.byref(peer))
    out["ipc_open"] = err == 0
    if err:
        out["error"] = f"cudaIpcOpenMemHandle {err}"
        results.put(out)
        return
    res = torch.zeros(3, dtype=torch.int64, device="cuda")
    start.wait(timeout=120)
    if role == 1:
        time.sleep(0.2)  # A spins first, B arrives late
    err = lib.probe_pingpong(mine, peer, role, 0, 1, TIMEOUT_NS,
                             ctypes.c_void_p(res.data_ptr()))
    first = res.tolist()
    err2 = lib.probe_pingpong(mine, peer, role, 1, ITERS, TIMEOUT_NS,
                              ctypes.c_void_p(res.data_ptr()))
    many = res.tolist()
    out.update(launch_err=[err, err2], first=first, many=many)
    results.put(out)


def main() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
         "--format=csv,noheader"], capture_output=True, text=True)
    report = {"nvidia_smi": smi.stdout.strip()}
    t0 = time.perf_counter()
    lib_path = build()
    report["build_s"] = round(time.perf_counter() - t0, 2)
    ctx = multiprocessing.get_context("spawn")
    handles = [ctx.Queue(), ctx.Queue()]
    results = ctx.Queue()
    start = ctx.Event()
    procs = [ctx.Process(target=worker,
                         args=(r, lib_path, handles, results, start))
             for r in range(2)]
    for p in procs:
        p.start()
    start.set()
    got = {}
    try:
        for _ in procs:
            out = results.get(timeout=300)
            got[out["role"]] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    report["workers"] = got
    a = got.get(0, {})
    ok = (all(got.get(r, {}).get("ipc_open") for r in (0, 1))
          and all(got.get(r, {}).get("launch_err") == [0, 0] for r in (0, 1))
          and a.get("first", [0, 1])[1] == 0 and a.get("many", [0, 1])[1] == 0)
    report["ipc_open"] = all(got.get(r, {}).get("ipc_open") for r in (0, 1))
    if ok:
        report["first_wait_us"] = a["first"][2] / 1e3
        report["round_trip_us"] = a["many"][0] / ITERS / 1e3
    report["ok"] = bool(ok)
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
