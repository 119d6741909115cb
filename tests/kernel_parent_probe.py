"""Time this tree's tree kernels against earlier builds of the same source,
in one process on one CUDA card (not collected by pytest).

    python3 tests/kernel_parent_probe.py --parent DIR [--older DIR]

Each DIR is an earlier checkout's root (``git archive <commit> | tar -x
-C DIR``): ``--parent`` one whose ``csrc/tree_kernels.cu`` has this
tree's histogram and leaf entry points and the one-matrix
``lo_feature_major(codes, out, n, d, stream)`` (446ac9d), ``--older``
one whose leaf entry points take (R chunks, rows a chunk) in place of
(rows a chunk, blocks, copies) (7b5b9f0). Every source is built with
the port's nvcc flags, all at once. Prints one JSON line a phase:

- ``feature_major``: this tree's kernel and the parent's, in turns
  (parent, this, this, parent), at the HIGGS sweep's 11M × 28, a pod
  rank's 5.5M × 28, the descent cases' widths at their row counts, and
  a two-matrix stack (the parent: a launch a matrix and
  ``torch.stack``), each pair bit-identical;
- ``k1``: the histogram and leaf forms, one slice and 24, float and
  fixed point, through this tree's wrappers on each library: each
  kernel's device time a call (``torch.profiler``), and the bits equal;
- ``leaf_older``: the one-slice leaf form's kernels on ``--older``'s
  library beside this tree's, at 11M and 5.5M rows.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("learningorchestra_tpu_torch", "csrc",
                      "tree_kernels.cu")


def emit(doc) -> None:
    print(json.dumps(doc), flush=True)


def kernel_ms(fn, calls: int) -> dict:
    """Device time a call of each kernel ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0.0)
        if t > 0:
            m = re.search(r"(\w+_kernel)", ev.key)
            name = m.group(1) if m else ev.key
            out[name] = out.get(name, 0.0) + t / 1e3 / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--older")
    ap.add_argument("--rows", type=int, default=11_000_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_parent_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as c
    from learningorchestra_tpu_torch.ops import tree_kernels as tk
    from learningorchestra_tpu_torch.ops._cuda_build import (NVCC_FLAGS,
                                                             _nvcc)

    dev = torch.device("cuda", 0)
    emit({"phase": "card", "nvidia_smi": c.card_line()})
    out_dir = os.path.join(ROOT, "build", "parent_probe")
    os.makedirs(out_dir, exist_ok=True)

    def nvcc(tag, root):
        so = os.path.join(out_dir, f"lib{tag}.so")
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", so,
                        os.path.join(root, SOURCE)], check=True,
                       capture_output=True)
        return so

    olds = {"parent": args.parent, **({"older": args.older} if args.older
                                       else {})}
    t0 = time.time()
    with ThreadPoolExecutor(len(olds) + 1) as pool:
        futs = {k: pool.submit(nvcc, k, v) for k, v in olds.items()}
        tk.build()
        libs = {k: ctypes.CDLL(f.result()) for k, f in futs.items()}
    emit({"phase": "build", "seconds": time.time() - t0})
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    parent = libs["parent"]
    for name, argtypes in tk._LIB._signatures.items():
        if name != "lo_feature_major":
            getattr(parent, name).argtypes = argtypes
            getattr(parent, name).restype = I_
    parent.lo_feature_major.argtypes = [P_, P_, I_, I_, P_]
    parent.lo_feature_major.restype = I_
    this_lib = tk._library

    def on(lib, fn):
        tk._library = (lambda: lib)
        try:
            return fn()
        finally:
            tk._library = this_lib

    def parent_fm(codes):
        n, d = codes.shape
        out = torch.empty((d, n), dtype=torch.uint8, device=dev)
        c.check(parent.lo_feature_major(codes.data_ptr(), out.data_ptr(), n,
                                        d, tk._stream(dev)) == 0,
                "the parent's feature_major launch")
        return out

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    n = args.rows
    rank = -(-n // 2)
    shapes = []
    for P, rows, d in ((1, n, 28), (1, rank, 28), (2, n, 28),
                       (1, 1_000_003, 6), (1, 100_003, 128),
                       (1, 100_003, 300), (1, 100_003, 784)):
        x = torch.randint(0, 32, (P, rows, d), generator=g, device=dev,
                          dtype=torch.uint8)
        x = x[0] if P == 1 else x
        if P == 1:
            def old():
                return parent_fm(x)
        else:
            def old():
                return torch.stack([parent_fm(m) for m in x])

        def new():
            return tk.feature_major(x)

        c.check(torch.equal(old(), new()), f"feature_major {P} {rows} {d}")
        it = 10 if x.numel() > 10**8 else 50
        times = [c.time_ms(f, it) for f in (old, new, new, old)]
        shapes.append({"P": P, "n": rows, "d": d,
                       "parent_ms": [times[0], times[3]],
                       "ms": [times[1], times[2]],
                       "parent_device_ms": c.device_ms(old, it)[0],
                       "device_ms": c.device_ms(new, it)[0],
                       "bound_ms": c.bound(2 * x.numel())[0]})
        del x
    emit({"phase": "feature_major", "shapes": shapes})
    torch.cuda.empty_cache()

    d, nb, S, NL, M = 28, 32, 2, 16, 63
    codes = torch.randint(0, nb, (2, n, d), generator=g, device=dev,
                          dtype=torch.uint8)
    k1 = {}
    for G in (1, 24):
        idx = [k % 2 for k in range(G)]
        rel = torch.randint(0, NL, (G, n), generator=g, device=dev,
                            dtype=torch.int32)
        active = torch.rand((G, n), generator=g, device=dev) < 0.9
        rel = torch.where(active, rel, torch.zeros_like(rel))
        stats = torch.randn((G, S, n), generator=g, device=dev)
        mx = tk.stat_max_abs(stats)
        assign = torch.randint(0, M, (G, n), generator=g, device=dev,
                               dtype=torch.int32)
        forms = {
            "hist": lambda: tk.tree_histogram_slices(
                codes, idx, stats, rel, active, n_nodes=NL, n_bins=nb,
                max_abs=mx),
            "hist_fixed": lambda: tk.tree_histogram_fixed(
                codes, idx, stats, rel, active, n_nodes=NL, n_bins=nb,
                max_abs=mx),
            "leaf": lambda: tk.tree_leaf_stats_slices(
                assign, stats, n_nodes=M, max_abs=mx),
            "leaf_fixed": lambda: tk.tree_leaf_stats_fixed(
                assign, stats, n_nodes=M, max_abs=mx)}
        for name, fn in forms.items():
            it = 20 if G == 1 else 3
            k1[f"{G} {name}"] = {
                "same_bits": bool(torch.equal(on(parent, fn), fn())),
                "parent_kernels": on(parent, lambda: kernel_ms(fn, it)),
                "kernels": kernel_ms(fn, it),
                "parent_kernels_b": on(parent, lambda: kernel_ms(fn, it))}
        del rel, active, stats, assign
    del codes
    emit({"phase": "k1", "forms": k1})
    torch.cuda.empty_cache()

    if "older" in libs:
        older = libs["older"]
        for name in ("lo_tree_leaf_i32", "lo_tree_leaf_i32_fixed"):
            getattr(older, name).argtypes = [P_] * 5 + [I_] * 7 + [P_]
            getattr(older, name).restype = I_
        leaf = {}
        for rows in (n, rank):
            assign = torch.randint(0, M, (1, rows), generator=g, device=dev,
                                   dtype=torch.int32)
            stats = torch.randn((1, S, rows), generator=g, device=dev)
            mx = tk.stat_max_abs(stats)
            plan, grid = tk._hist_layout(rows, 1, M, S, 1, tk._num_sms(dev),
                                         1, None, leaf=True)
            for fixed in (False, True):
                dt = torch.int64 if fixed else torch.float32
                o12 = torch.empty((1, M, S), dtype=dt, device=dev)
                part = torch.empty((plan.R, M * S), dtype=torch.int64,
                                   device=dev)
                entry = (older.lo_tree_leaf_i32_fixed if fixed
                         else older.lo_tree_leaf_i32)

                def old():
                    c.check(entry(assign.data_ptr(), stats.data_ptr(),
                                  mx.data_ptr(), o12.data_ptr(),
                                  part.data_ptr(), rows, M, S, plan.CG,
                                  plan.R, plan.rows, 1,
                                  tk._stream(dev)) == 0, "older leaf")
                    return o12

                def new():
                    if fixed:
                        return tk.tree_leaf_stats_fixed(
                            assign, stats, n_nodes=M, max_abs=mx)
                    return tk.tree_leaf_stats_slices(
                        assign, stats, n_nodes=M, max_abs=mx).transpose(1, 2)

                leaf[f"{rows} {'fixed' if fixed else 'float'}"] = {
                    "same_bits": bool(torch.equal(old().clone(), new())),
                    "older_kernels": kernel_ms(old, 50),
                    "kernels": kernel_ms(new, 50),
                    "older_kernels_b": kernel_ms(old, 50)}
            del assign, stats
        emit({"phase": "leaf_older", "forms": leaf})
    return 0


if __name__ == "__main__":
    sys.exit(main())
