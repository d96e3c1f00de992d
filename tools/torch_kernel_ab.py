#!/usr/bin/env python3
"""Time the port's fused server step (K1), modified AdaGrad (K2), flash
attention (K3), Mamba scan (K4) and WKV (K5) kernels against other builds
of the same C interface, in turns, on one CUDA card.

    python3 tools/torch_kernel_ab.py \\
        --cand k1:parent:OLD_SERVER_STEP.cu \\
        --cand k2:parent:OLD_ADAGRAD.cu \\
        --cand k3:parent:OLD_FLASH_ATTENTION.cu \\
        --cand k4:parent:OLD_MAMBA.cu \\
        --cand k5:parent:OLD_RWKV6.cu \\
        --cand k5:variant:VARIANT.cu:-DNAME=VALUE

A candidate is ``kernel:label:source[:flag...]``.  It is compiled with its
kernel's flags from ``repro_torch.kernels.build`` plus its own into
``build/kernel_ab/``, loaded with ctypes, and held to the plain version on
the timed inputs (K3 within ``chip_smoke.TOL_F32``, K1, K2, K4 and K5
bitwise), unless its label starts with ``diag`` (a diagnostic build that
leaves work out).  Then, at each main-path shape, the candidate and the
kernel of the tree (through its wrapper) are timed by
``chip_smoke.ColdTimer`` in the order candidate, tree, tree, candidate;
each gets the mean of its two medians.  K1's shapes are the fabric's
FIG4 step (n 609,258) at M 4 and M 8 and n 16,777,219 at M 4, each on a
contiguous (M, n) stack and on a pitched one (rows padded to 32 f32, as
``FusedServerStep`` builds it); a K1 candidate whose C entry takes no row
pitch (``repro_server_step``) runs on the contiguous stack in both rows.
K2's shapes are the FIG2 step (8 leaves) and one f32 leaf of 1,000,003; a
K2 candidate with the older C entry (``repro_adagrad_update``, one leaf a
launch) is called once a leaf.  K1 and K2 are set beside one launch of a
1-element ``add_``.  At the
decode shape K4 and K5 are also set beside one copy of their state (the
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
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402

from repro_torch.configs.paper_cnn import FIG2_CNN  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.adagrad import ops as adagrad_ops  # noqa: E402
from repro_torch.kernels.adagrad.ref import adagrad_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.mamba.ops import mamba_scan  # noqa: E402
from repro_torch.kernels.mamba.ref import mamba_scan_ref  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.kernels.rwkv6.ops import wkv  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv_ref  # noqa: E402
from repro_torch.kernels.server_step import ops as server_step_ops  # noqa: E402
from repro_torch.kernels.server_step.ref import server_step_ref  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "kernel_ab")
#: kernel -> (directory in kernels/, C entry, the main path's shapes)
KERNELS = {
    "k1": ("server_step", None,
           {"fig4_m4": (609_258, 4), "fig4_m8": (609_258, 8),
            "n16777219_m4": (16_777_219, 4)}),
    "k2": ("adagrad", None,
           {"fig2_step": None, "n1000003": (1_000_003,)}),
    "k3": ("flash_attention", "repro_flash_attention",
           {"qwen3-4b": (4, 512, 32, 8, 128), "jamba": (4, 512, 64, 8, 128)}),
    "k4": ("mamba", "repro_mamba_scan",
           {"prefill": (4, 512, 16384, 16), "decode": (4, 1, 16384, 16)}),
    "k5": ("rwkv6", "repro_wkv",
           {"prefill": (4, 512, 32, 64), "decode": (4, 1, 32, 64)}),
}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: K2's learning rate and beta (the quickstart's)
K2_KW = dict(lr=0.02, beta=1.0)
#: K1's (the fabric's)
K1_KW = dict(lr=0.05, beta=1.0)


def compile_candidate(kernel: str, label: str, source: str, flags) -> str:
    name = KERNELS[kernel][0]
    os.makedirs(OUT_DIR, exist_ok=True)
    out = os.path.join(OUT_DIR, f"lib{name}-{label}.so")
    cmd = [build._nvcc(), *build.NVCC_FLAGS[name], *flags, "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{label}: nvcc failed\n{proc.stdout}"
                           f"{proc.stderr}")
    # ptxas's registers and spills for each CUDA function, in order
    usage = re.findall(r"(\d+) bytes spill stores.*?Used (\d+) registers",
                       proc.stdout + proc.stderr, re.S)
    print(f"[ab] {kernel} {label} ptxas " + ",".join(
        f"regs={r}:spill_bytes={sp}" for sp, r in usage), flush=True)
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


def k2_inputs(gen, shape):
    """(p, g, acc) leaves, all f32: the FIG2 net's 8 (``shape`` None) or
    one of ``shape``."""
    shapes = ([tuple(x.shape) for x in tree_leaves(cnn.init_cnn(
        torch.Generator().manual_seed(0), FIG2_CNN, "cpu"))]
              if shape is None else [shape])
    return [(torch.randn(s, generator=gen, device="cuda"),
             torch.randn(s, generator=gen, device="cuda"),
             torch.randn(s, generator=gen, device="cuda").abs())
            for s in shapes]


def k4_inputs(gen, b, t, di, ds):
    """chip_smoke's scan inputs (a decode step from a unit-scale state)."""
    def u(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    def n(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    return (0.001 + 0.099 * u(b, t, di), n(b, t, di), n(b, t, ds),
            n(b, t, ds), -(0.5 + 3.5 * u(di, ds)),
            (1.0 if t == 1 else 0.1) * n(b, di, ds))


def k1_inputs(gen, n, members):
    """p, acc, a contiguous (M, n) gradient stack, the same gradients as
    a pitched stack, and the coefficients."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    g = rand(members, n)
    ld = -(-n // 32) * 32
    pitched = torch.empty(members, ld, device="cuda")[:, :n]
    pitched.copy_(g)
    return (rand(n), rand(n).abs(), g, pitched,
            torch.full((members,), 1.0 / members, device="cuda"))


def k1_caller(lib, p, acc, g, coeffs):
    """One launch on the stack ``g``: through the pitched entry, or, for
    an older build, the entry that takes a contiguous stack."""
    p_out, acc_out = torch.empty_like(p), torch.empty_like(acc)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (p.data_ptr(), g.data_ptr(), acc.data_ptr(), coeffs.data_ptr(),
            p_out.data_ptr(), acc_out.data_ptr())
    n, members = p.numel(), g.shape[0]
    lr, beta = K1_KW["lr"], K1_KW["beta"]
    if hasattr(lib, "repro_server_step_pitched"):
        fn = lib.repro_server_step_pitched
        fn.argtypes = server_step_ops._ARGTYPES + [_P]
        args = (*ptrs, n, g.stride(0), members, lr, beta, 0, 0.0, stream)
    else:
        if not g.is_contiguous():
            raise ValueError("the older K1 entry takes a contiguous stack")
        fn = lib.repro_server_step
        fn.argtypes = [_P] * 6 + [ctypes.c_longlong, _I, _F, _F, _I, _F, _P]
        args = (*ptrs, n, members, lr, beta, 0, 0.0, stream)
    fn.restype = _I

    def call():
        code = fn(*args)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return p_out, acc_out
    return call


def k2_caller(lib, leaves):
    """One call over all the leaves with the list entry, or, for an older
    build, one launch a leaf."""
    outs = [(torch.empty_like(p), torch.empty_like(a)) for p, _, a in leaves]
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "repro_adagrad_update_leaves"):
        fn = lib.repro_adagrad_update_leaves
        fn.restype = _I
        fn.argtypes = adagrad_ops._ARGTYPES + [_P]
        ptrs = [(_P * len(leaves))(*(t.data_ptr() for t in ts))
                for ts in (*zip(*leaves), *zip(*outs))]
        ns = (ctypes.c_longlong * len(leaves))(*(p.numel()
                                                 for p, _, _ in leaves))

        def launches():
            yield fn(*ptrs, ns, len(leaves), 0, 0, K2_KW["lr"],
                     K2_KW["beta"], 0, 0.0, stream)
    else:
        fn = lib.repro_adagrad_update
        fn.restype = _I
        fn.argtypes = [_P] * 5 + [ctypes.c_longlong, _I, _I, _F, _F, _I,
                                  _F, _P]

        def launches():
            for (p, g, a), (p1, a1) in zip(leaves, outs):
                yield fn(p.data_ptr(), g.data_ptr(), a.data_ptr(),
                         p1.data_ptr(), a1.data_ptr(), p.numel(), 0, 0,
                         K2_KW["lr"], K2_KW["beta"], 0, 0.0, stream)

    def call():
        for code in launches():
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
        return outs
    return call


def k4_caller(lib, dt, x, b_t, c_t, a, h0):
    fn = lib.repro_mamba_scan
    fn.restype = _I
    fn.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    b, t, di = dt.shape
    y, hT = torch.empty_like(dt), torch.empty_like(h0)

    def call():
        code = fn(dt.data_ptr(), x.data_ptr(), b_t.data_ptr(),
                  c_t.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                  hT.data_ptr(), b, t, di, b_t.shape[2], 0,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return y, hT
    return call


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
    """([(row, candidate's call, the tree's call), ...], the bound, the
    state it carries or None) at ``shape``, after holding the candidate's
    output to the plain version (unless not ``checked``).  Every kernel
    has one row, "", but K1, which has one for each stack."""
    if kernel == "k1":
        p, acc, g, pitched, c = k1_inputs(gen, *shape)
        want = server_step_ref(p, g, acc, c, **K1_KW)
        rows = []
        for row, stack in (("contiguous", g), ("pitched", pitched)):
            cand = (k1_caller(lib, p, acc, stack, c)
                    if hasattr(lib, "repro_server_step_pitched")
                    else k1_caller(lib, p, acc, g, c))
            got = cand()
            torch.cuda.synchronize()
            cs.check(not checked or all(
                torch.equal(x, y) for x, y in zip(got, want)),
                f"k1 candidate bitwise equal to its plain version on the "
                f"{row} stack")
            rows.append((row, cand,
                         lambda s=stack: server_step_ops.server_step_update(
                             p, s, acc, c, **K1_KW)))
        return rows, cs._k1_bound(p.numel(), g.shape[0])[0], None
    if kernel == "k2":
        leaves = k2_inputs(gen, shape)
        cand = k2_caller(lib, leaves)
        ps, gs, accs = (list(z) for z in zip(*leaves))
        got = cand()
        torch.cuda.synchronize()
        cs.check(not checked or all(
            torch.equal(x, y) for leaf, out in zip(leaves, got)
            for x, y in zip(out, adagrad_ref(*leaf, **K2_KW))),
            "k2 candidate bitwise equal to its plain version")
        return ([("", cand, lambda: adagrad_ops.adagrad_update_leaves(
            ps, gs, accs, **K2_KW))], cs._k2_bound(ps, gs)[0], None)
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
        return [("", cand, tree)], cs._k3_bound(q, k)[0], None
    if kernel == "k4":
        ins = k4_inputs(gen, *shape)
        cand, tree, plain = k4_caller(lib, *ins), mamba_scan, mamba_scan_ref
        state, bound = ins[5], cs._k4_bound(ins)[0]
    else:
        ins = k5_inputs(gen, *shape)
        cand, tree, plain = k5_caller(lib, *ins), wkv, wkv_ref
        state, bound = ins[5], cs._k5_bound(ins[0], ins[5])[0]
    got, want = cand(), plain(*ins)
    torch.cuda.synchronize()
    cs.check(not checked or all(torch.equal(x, y) for x, y in zip(got, want)),
             f"{kernel} candidate bitwise equal to its plain version")
    return [("", cand, lambda: tree(*ins))], bound, state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cand", action="append", required=True,
                    help="kernel:label:source[:flag...], kernel k1, k2, "
                         "k3, k4 or k5")
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
            rows, bound, state = compare(kernel, lib, shape, gen,
                                         checked=not label.startswith("diag"))
            for row_name, cand, tree in rows:
                c1, t1, t2, c2 = (timer(fn) for fn in (cand, tree, tree,
                                                       cand))
                row = {"candidate_ms": (c1 + c2) / 2,
                       "tree_ms": (t1 + t2) / 2,
                       "turns_ms": [c1, t1, t2, c2], "bound_ms": bound}
                if state is not None and shape[1] == 1:
                    # a yardstick for the decode step: one copy of the
                    # state, the bytes the step must move (h0 or s0 in,
                    # hT or sT out)
                    copy = torch.empty_like(state)
                    row["state_copy_ms"] = timer(lambda: copy.copy_(state))
                if kernel in ("k1", "k2"):
                    # a yardstick for a small step: one launch that does
                    # nearly nothing
                    one = torch.zeros(1, device="cuda")
                    row["launch_floor_ms"] = timer(lambda: one.add_(1.0))
                key = ":".join(x for x in (kernel, label, shape_name,
                                           row_name) if x)
                results[key] = row
                print(f"[ab] {kernel} {label} {shape_name} {row_name} "
                      f"shape={shape} "
                      f"candidate_ms={row['candidate_ms']:.6f} "
                      f"tree_ms={row['tree_ms']:.6f} bound_ms={bound:.6f} "
                      f"state_copy_ms={row.get('state_copy_ms')} "
                      f"launch_floor_ms={row.get('launch_floor_ms')} "
                      f"turns={','.join(f'{x:.6f}' for x in row['turns_ms'])}",
                      flush=True)
            del rows
    print(json.dumps({"card": smi, "ab": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
