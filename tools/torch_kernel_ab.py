#!/usr/bin/env python3
"""Time the port's flash attention (K3) and WKV (K5) kernels against other
builds of the same C interface, in turns, on one CUDA card.

    python3 tools/torch_kernel_ab.py \\
        --cand k3:parent:OLD_FLASH_ATTENTION.cu \\
        --cand k5:parent:OLD_RWKV6.cu \\
        --cand k5:variant:VARIANT.cu:-DNAME=VALUE

A candidate is ``kernel:label:source[:flag...]``.  It is compiled with its
kernel's flags from ``repro_torch.kernels.build`` plus its own into
``build/kernel_ab/``, loaded with ctypes, and held to the plain version on
the timed inputs (K3 within ``chip_smoke.TOL_F32``, K5 bitwise), unless
its label starts with ``diag`` (a diagnostic build that leaves work out).
Then, at each main-path shape, the candidate and the kernel of the tree
(through its wrapper) are timed by ``chip_smoke.ColdTimer`` in the order
candidate, tree, tree, candidate; each gets the mean of its two medians.
At the decode shape K5 is also set beside one copy of its state (the
bytes the step must move).  The last line is one JSON object with every
time, beside the card's ``nvidia-smi --query-gpu=name,power.limit`` line.
Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rwkv6.ops import wkv  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv_ref  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "kernel_ab")
#: kernel -> (directory in kernels/, C entry, the main path's shapes)
KERNELS = {
    "k3": ("flash_attention", "repro_flash_attention",
           {"qwen3-4b": (4, 512, 32, 8, 128), "jamba": (4, 512, 64, 8, 128)}),
    "k5": ("rwkv6", "repro_wkv",
           {"prefill": (4, 512, 32, 64), "decode": (4, 1, 32, 64)}),
}
_P, _I = ctypes.c_void_p, ctypes.c_int


def compile_candidate(kernel: str, label: str, source: str, flags) -> str:
    name = KERNELS[kernel][0]
    os.makedirs(OUT_DIR, exist_ok=True)
    out = os.path.join(OUT_DIR, f"lib{name}-{label}.so")
    cmd = [build._nvcc(), *build.NVCC_FLAGS[name], *flags, "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{label}: nvcc failed\n{proc.stdout}"
                           f"{proc.stderr}")
    return out


def k3_inputs(gen, b, s, hq, hkv, hd):
    q = torch.randn(b, s, hq, hd, generator=gen, device="cuda")
    k, v = (torch.randn(b, s, hkv, hd, generator=gen, device="cuda")
            for _ in range(2))
    return q, k, v


def k5_inputs(gen, b, t, h, hd):
    r, k, v = (0.5 * torch.randn(b, t, h, hd, generator=gen, device="cuda")
               for _ in range(3))
    w = 0.7 + 0.299 * torch.rand(b, t, h, hd, generator=gen, device="cuda")
    u = 0.1 * torch.randn(h, hd, generator=gen, device="cuda")
    s0 = 0.1 * torch.randn(b, h, hd, hd, generator=gen, device="cuda")
    return r, k, v, w, u, s0


def k3_caller(lib, q, k, v):
    fn = lib.repro_flash_attention
    fn.restype = _I
    fn.argtypes = [_P] * 4 + [_I] * 9 + [ctypes.c_float, _P]
    b, sq, hq, hd = q.shape
    out = torch.empty_like(q)

    def call():
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, sq, k.shape[1], hq, k.shape[2], hd, 0, 1, 0,
                  1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return out
    return call


def k5_caller(lib, r, k, v, w, u, s0):
    fn = lib.repro_wkv
    fn.restype = _I
    fn.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    b, t, h, hd = r.shape
    y, sT = torch.empty_like(r), torch.empty_like(s0)

    def call():
        code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
                  b, t, h, hd, 0, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return y, sT
    return call


def compare(kernel, lib, shape, gen, checked=True):
    """(candidate's call, the tree's call, the bound) at ``shape``, after
    holding the candidate's output to the plain version (unless not
    ``checked``)."""
    if kernel == "k3":
        q, k, v = k3_inputs(gen, *shape)
        cand, tree = k3_caller(lib, q, k, v), lambda: flash_attention(q, k, v)
        want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2)).transpose(1, 2)
        got = cand()
        torch.cuda.synchronize()
        cs.check(not checked or cs._within(got, want, **cs.TOL_F32),
                 f"k3 candidate within {cs.TOL_F32}: max err "
                 f"{cs._max_err(got, want)}")
        return cand, tree, cs._k3_bound(q, k)[0]
    ins = k5_inputs(gen, *shape)
    cand, tree = k5_caller(lib, *ins), lambda: wkv(*ins)
    (y, sT), (y_ref, s_ref) = cand(), wkv_ref(*ins)
    torch.cuda.synchronize()
    cs.check(not checked or torch.equal(y, y_ref) and torch.equal(sT, s_ref),
             "k5 candidate bitwise equal to its plain version")
    return cand, tree, cs._k5_bound(ins[0], ins[5])[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cand", action="append", required=True,
                    help="kernel:label:source[:flag...], kernel k3 or k5")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build()
    timer = cs.ColdTimer(reps=args.reps)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    results = {}
    for spec in args.cand:
        kernel, label, source, *flags = spec.split(":")
        lib = ctypes.CDLL(compile_candidate(kernel, label, source, flags))
        for shape_name, shape in KERNELS[kernel][2].items():
            cand, tree, bound = compare(kernel, lib, shape, gen,
                                        checked=not label.startswith("diag"))
            c1, t1, t2, c2 = (timer(fn) for fn in (cand, tree, tree, cand))
            row = {"candidate_ms": (c1 + c2) / 2, "tree_ms": (t1 + t2) / 2,
                   "turns_ms": [c1, t1, t2, c2], "bound_ms": bound}
            if kernel == "k5" and shape[1] == 1:
                # a yardstick for the decode step: one copy of the state,
                # the bytes the step must move (s0 in, sT out)
                s0 = torch.empty(shape[0], shape[2], shape[3], shape[3],
                                 device="cuda")
                row["state_copy_ms"] = timer(s0.clone)
            results[f"{kernel}:{label}:{shape_name}"] = row
            print(f"[ab] {kernel} {label} {shape_name} shape={shape} "
                  f"candidate_ms={row['candidate_ms']:.6f} "
                  f"tree_ms={row['tree_ms']:.6f} bound_ms={bound:.6f} "
                  f"state_copy_ms={row.get('state_copy_ms')} "
                  f"turns={','.join(f'{x:.6f}' for x in row['turns_ms'])}",
                  flush=True)
            del cand, tree
    print(json.dumps({"card": smi, "ab": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
