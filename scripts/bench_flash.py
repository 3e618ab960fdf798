#!/usr/bin/env python3
"""Time the flash-attention kernels (K1) of one source tree on the card.

Imports the port package from ``--root`` (a checkout, or a ``git archive``
copy of another commit), builds its kernels there, and times K1's forward
and backward with ``chip_smoke.time_cold`` (L2 flushed before every launch)
beside SDPA's forward and SDPA's backward alone (its forward outside the
timed window), at two shapes:

- ``train``: GPT-2 124M's attention, B 16, N 12, S 1024, H 64, bf16,
  causal (``chip_smoke.py`` phase 3);
- ``bert``: B 16, N 12, S 512, H 64, bf16, not causal, with a (B, S) key
  mask whose rows keep a seeded random length of 256-512 keys.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per shape with the times (ms), the kernels' max errors against their plain
versions, and the bound. To compare two commits on one card, run it for
each tree in one command, in turns (parent, change, change, parent)::

    python3 scripts/bench_flash.py --root .archive_check/base
    python3 scripts/bench_flash.py --root .
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shapes(torch):
    """(name, q, k, v, do, kv_mask, causal) at each timed shape."""
    out = []
    for name, seq, causal in (("train", 1024, True), ("bert", 512, False)):
        gen = torch.Generator().manual_seed(seq)
        q, k, v, do = (torch.randn(16, seq, 12, 64, generator=gen)
                       .to("cuda", torch.bfloat16) for _ in range(4))
        mask = None
        if not causal:
            lens = torch.randint(seq // 2, seq + 1, (16,), generator=gen)
            mask = (torch.arange(seq)[None, :] < lens[:, None]).float()
            mask = mask.to("cuda")
        out.append((name, q, k, v, do, mask, causal))
    return out


def report_occupancy(_build) -> None:
    """One JSON line per bf16 kernel and head_dim from the library's
    ``dpx_flash_occupancy``, then ``nvcc -Xptxas -v``'s register and spill
    lines for the bf16 kernels."""
    import ctypes

    fn = _build.load_library("flash_attention").dpx_flash_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keys = ("threads", "smem_bytes", "registers", "spill_bytes",
            "ctas_per_sm")
    for head_dim in (64, 128, 256):
        for which, name in enumerate(("fwd", "dq", "dkv")):
            out = (ctypes.c_int * 5)()
            err = fn(head_dim, which, out)
            if err:
                raise RuntimeError(f"dpx_flash_occupancy failed: {err}")
            print(json.dumps({"kernel": f"flash_{name}_bf16_kernel<{head_dim}>",
                              **dict(zip(keys, out))}), flush=True)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        log = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"),
             str(_build.CSRC_DIR / "flash_attention.cu")],
            capture_output=True, text=True, timeout=600,
        )
    entry = None
    for line in (log.stdout + log.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "bf16" in entry and ("registers" in line
                                            or "spill" in line):
            print(f"ptxas {entry}: {line.split(':')[-1].strip()}",
                  flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO,
                        help="tree whose distributed_pytorch_example_tpu_torch "
                             "is timed (default: this checkout)")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--occupancy", action="store_true",
                        help="also print each bf16 kernel's registers, spills, "
                             "shared memory and CTAs per SM (the card's "
                             "numbers, and nvcc -Xptxas -v's)")
    args = parser.parse_args()
    root = os.path.abspath(args.root)

    import torch

    if not torch.cuda.is_available():
        print("bench_flash: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke  # this checkout's timer and bounds, for every tree

    sys.path.insert(0, root)
    from distributed_pytorch_example_tpu_torch.ops import _build
    from distributed_pytorch_example_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    if not os.path.samefile(os.path.dirname(_build.PACKAGE_DIR), root):
        print(f"bench_flash: imported the port from {_build.PACKAGE_DIR}, "
              f"not from {root}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all(["flash_attention"])
    if args.occupancy:
        report_occupancy(_build)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, q, k, v, do, mask, causal in shapes(torch):
        kw = dict(causal=causal, kv_mask=mask, softmax_scale=64 ** -0.5)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        ro, _ = flash_attention_fwd_reference(q, k, v, **kw)
        rgrads = flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
        err = {"fwd": (o.float() - ro.float()).abs().max().item(),
               "bwd": max((g.float() - r.float()).abs().max().item()
                          for g, r in zip(grads, rgrads))}
        del ro, rgrads
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        sdpa_mask = None if mask is None else (mask > 0)[:, None, None, :]
        sdpa_out = sdpa(qt, kt, vt, attn_mask=sdpa_mask, is_causal=causal)
        ms = {}
        for label, fn in (
            ("fwd", lambda: flash_attention_fwd(q, k, v, **kw)),
            ("bwd", lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw)),
            ("sdpa_fwd", lambda: sdpa(qt, kt, vt, attn_mask=sdpa_mask,
                                      is_causal=causal)),
            ("sdpa_bwd", lambda: torch.autograd.grad(
                sdpa_out, (qt, kt, vt), dot, retain_graph=True)),
        ):
            ms[label] = chip_smoke.time_cold(torch, fn, iters=args.iters)
        B, S, N, H = q.shape
        # the (query, key) pairs this run's masks leave, times H
        keys = S * S if mask is None else S * int(mask.sum().item()) // B
        pairs = B * N * H * (S * (S + 1) // 2 if causal else keys)
        elem, row = B * S * N * H * 2, B * N * S * 4
        bound = {
            kind: max(nbytes / 3.35e12, 2 * n_prod * pairs / 989e12) * 1e3
            for kind, nbytes, n_prod in (("fwd", 4 * elem + row, 2),
                                         ("bwd", 8 * elem + row, 5))
        }
        print(json.dumps({"root": args.root, "shape": name,
                          "dims": [B, S, N, H], "causal": causal,
                          "kv_mask": mask is not None, "ms": ms,
                          "max_abs_err": err, "bound_ms": bound}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
