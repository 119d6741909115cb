"""Drive the PyTorch package on one CUDA card and check it end to end.

    python3 chip_smoke.py [--train-rows N]

Phases, one JSON line each (any failure exits non-zero):

1. card: name and power limit (nvidia-smi), the SM's maximum clock,
   torch and CUDA versions;
2. build: compiles ``learningorchestra_tpu_torch/csrc/tree_kernels.cu``
   and ``csrc/tsne_kernels.cu`` with nvcc for sm_90a, one nvcc per
   source, all started together; each timed, ``fresh`` per source; per
   kernel its registers and spill bytes (ptxas -v) and its shared-atomic,
   special-function, shuffle, float-to-int, float FMA/add/multiply,
   shared-load, local (spill) load/store, global load/store, cp.async
   (``LDGSTS``) and byte-permute instructions (cuobjdump); the
   feature-major copy must show no spills, 16-B cp.async loads, 16-B
   stores and no byte-wide shared load;
3. one line per tree kernel at the HIGGS-sweep shapes (n train rows,
   d=28, 32 bins, depth 5): the kernel against its plain PyTorch version
   on the same inputs (bit-identical for node ids and integer-valued
   histograms; rtol 1e-5 with atol 1e-6·Σ|stats| for float stats, which
   the card sums in fixed point), two calls bit-identical, and their
   times beside the card's bound; routing also from the feature-major
   codes and without them, and descent of a 20-tree forest over the test
   and the train rows, each beside the floor the row-major layout forces
   (``layout_floor_ms``), and the rate of a device-to-device copy of the
   codes in the same run; the feature-major copy against ``.t()
   .contiguous()``, bit for bit and twice at rows 1 to 11M (odd counts
   included) × widths 1 to 784 from aligned and unaligned bases, as a
   stack of bin matrices in one launch, and timed at a pod rank's rows,
   a two-matrix stack (beside a launch a matrix and ``torch.stack``) and
   the descent cases' widths; routing and descent also bit for bit at a
   ragged n, d = 6, 256 bins, unaligned inputs, a depth-12 forest in
   several table chunks, rows of 128 and 300 bytes (two rows and one row
   a thread) and a 784-wide row on the direct path; and descent at the
   online tier's request sizes (the 20-tree forest and one tree over 1,
   3, 8, 64 and 256 rows, also from an unaligned view), each call's time
   beside its byte bound and a same-run empty launch; then the slice
   forms of the four tree kernels (``*_slices``) at 24 slices over two
   bin matrices (a tune population's trees at one level), each slice
   ``torch.equal`` to its one-slice launch, each form against its plain
   version on the first 2^20 rows and bit-identical over two calls, its
   time beside its bound (the codes counted once per bin matrix for the
   histogram and the descent); then the histogram and the descent at the
   tune's own shapes (gb's 18 slices over one bin matrix, float stats;
   rf's 24 over two, integer stats): the histogram at each level of a
   depth-6 population (32 node slots, 2^level live), with the time of
   each count of slice copies that fits, the descent one depth-6 tree a
   slice, each checked the same way. Before the kernels, the atomics
   probe: the card's shared ``ATOMS.ADD`` rate, conflict-free and into
   random bins of 32 words; every histogram line has its atomics floor
   (its nonzero fixed-point words' adds at the random-bin rate) beside
   its byte bound; last, concurrent launches: two host threads launch
   the histogram at two shared-memory sizes at once, as concurrent fits
   do, every launch bit-identical to its single-thread result;
4. the t-SNE repulsion kernel at the MNIST-60k shape (60,416 rows, 60,000
   valid), at 60,000 rows with no padding, and with 1% of the rows
   invalid at random positions and parked at 0, each against its plain
   version (Z rtol 1e-4, max|F − F_ref| ≤ 1e-4·max|F_ref|); two calls
   bit-identical; its row form over two halves (Z partials sum to the
   whole Z within rtol 1e-5; F halves match the whole F within the F
   tolerance); the row form at the pod's shape (each of two ranks' 30,720
   query rows against 61,440 rows) against its plain version at the same
   tolerances, two calls bit-identical, both halves timed against the
   bound of the pairs the kernel takes (the own block once a pair) and
   the ordered-pair bound, and a query block that is not a view of Y at
   its offset refused;
5. small-input references: dt and gb fitted on the card and on the CPU
   (the plain versions) from the same data give the same trees; one
   t-SNE step on 2,048 rows agrees (rtol 1e-4, atol 1e-6) and a
   300-iteration embed's KL under exact affinities is within 3% of the
   CPU run's;
6. the sweep: HIGGS-like train/test datasets in the catalog,
   ``ModelBuilder.build`` of all five families (lr, dt, rf, gb, nb) at
   their defaults, then ``ModelBuilder.predict`` with the saved gb model;
   accuracies above the floors, every tree family above lr, and every
   tree kernel launched during the run; then forest_batch: rf (20
   trees) at the sweep's shape and edges fitted as ``fit_rf`` fits it
   (four ``_build_trees`` calls of 5 slices, a slice launch a level a
   batch) and, with the batch width set to 1 from this script, grown
   one tree a call (the draws in the serial order), in turns (batched,
   one tree a call, one tree a call, batched): every tree
   bit-identical, each run's wall ms, launches and allocator peak, with
   the card's name and power limit;
7. streamed: the same catalog built again with ``stream_design`` set
   (the out-of-core path: the design state fitted in streaming passes,
   the design matrix fed to the card block by block through two pinned
   buffers and a side stream): (a) the feed's device tensor equal bit
   for bit to the resident design's device copy; (b) ``ModelBuilder
   .build`` of all five families, lr and nb accuracies equal to the
   sweep's, dt/rf/gb above their floors, within 0.01 of the sweep's
   (their edges come from a strided sample) and above lr; (c) a streamed
   ``ModelBuilder.predict`` of the sweep's gb model, every probability
   equal to the resident predict's; (d) rf (20 trees) and gb (20
   rounds, checkpoints every 5) fitted three times on the resident
   codes with the sweep's edges: uninterrupted, crashed at the second
   checkpoint by the ``fit.ckpt.pre_rename`` failpoint, and resumed,
   every resumed param equal to the uninterrupted one's. Exec
   preprocessing is not driven here: its jail hands user code pandas
   DataFrames, which the card's machine may lack, and its device work is
   the resident build the sweep already runs (the CPU tests hold it
   against the JAX package);
8. the exploration path in the same catalog: projection of the train set
   to 5 fields, its label coerced to string and back (equal to the
   original), histograms equal to ``np.bincount``, a PCA of the 11M × 28
   train set against a float64 numpy PCA (|corr| > 0.9999 per
   component), and a t-SNE of a 60,000 × 784 dataset at the service
   defaults (750 iterations, the repulsion kernel launched once per
   iteration; its 10-NN class agreement above PCA-2's), run twice with
   the same seed: the two embeddings bit-identical (with the count of
   hub-overflow edges, from the descent's span);
9. serve: the package's REST server (``serving.App`` on the same
   catalog, ``serve(background=True)`` on 127.0.0.1:0) driven over HTTP
   with the standard library: ``POST /models`` (async) of all five
   families on the same train/test sets, polled to ``finished`` and
   above the accuracy floors; online requests of 1, 3, 8, 40, 64 and 256
   rows per model, then 8 client threads × 100 mixed-size requests,
   every probability row bit-identical to a one-row call through the
   batch path and to the same row of the model's
   ``POST /trained-models/{name}/predictions`` dataset; ``GET /metrics``
   with every row counted once and none rejected or failed; latency,
   throughput and batch occupancy per family, and the descent kernel's
   launches in the online phase (counts reset just before it);
10. serve_workers: the same catalog and saved models served again with
   ``http_workers = 4`` (front-end worker processes; the host's CPU
   count beside it): the serve phase's request rows as raw records, as
   design rows in field order, and as the binary columnar body, every
   probability row bit-identical to the serve phase's one-row oracle,
   every row counted once and none rejected; p50/p99 at 1 and 64 rows
   and rows/s under the same 8-thread load per family and body kind,
   beside the one-worker phase's rows/s; the descent kernel launched;
11. resources, through the workers: ``GET /resources`` on the CUDA
   allocator's counters (bytes in use above 0, within the card), the
   served sweep job's ``peak_hbm_bytes`` (within the card's memory) and
   per-family ``fit_resources``, the compile counts (kernel builds and
   bucket warm-ups), and a 2 s ``POST /debug/profile`` during a load
   whose trace holds descent-kernel events;
12. observability, through the workers: the Prometheus text parsed
   line by line with ``lo_frontend_*`` series, ``/status`` HTML,
   ``/alerts`` and ``/metrics/history`` with samples, and a
   ``POST /debug/flightrec`` bundle whose manifest names torch, CUDA and
   the card;
13. tune: ``POST /tune`` (async, the winner promoted) through a served
   app on the same catalog: dt, rf (20 trees) and gb populations on the
   11M train rows and lr (Adam) and mlp on a 1M-row set from the same
   generator, 3 folds and 3 halving rungs each; per family its waves,
   halving drops, winner and mean score, seconds, the job's
   ``peak_hbm_bytes``, the allocator's peak beside the modeled wave
   footprint, the slices of each ``_build_trees`` call (dt and rf grow
   a tree batch of as many live members as ``tune_max_population``
   slices hold in one), the kernels' launches (dt, rf and gb through
   every slice form), K1's and K3's device milliseconds (a CUDA-only
   profile of the
   sweep) and the board (every member's fold scores, the same bits
   whichever kernels' design ran them); each winner answers
   ``ModelBuilder.predict`` and an
   online request; ``/metrics`` counts the sweeps; then folds=1 parity
   on the 1M-row set, every member's score its serial fit's
   self-accuracy on the card (gb within 0.02);
14. tx, the sequence classifier (no kernel of its own: PyTorch tensor
   ops, full float32 products): (a) forward, loss and all 24
   gradients at 16/32/4/2/64 on the card against the CPU from the same
   params, causal and not, remat and not (rtol 1e-4, atol 1e-5); (b)
   blockwise attention (1,024-key folds) at T = 8,192, B 1, H 8, D 64
   against full attention on the card, causal and not (rtol 1e-4, atol
   1e-5), each timed; (c) one train step through a one-rank NCCL
   group (``distributed.initialize`` on a free 127.0.0.1 port), every
   all-reduce counted, ``torch.equal`` in loss, params and Adam state to
   the step with no process group; (d) ``POST /models`` of tx at
   bench_transformer.py's ``large`` widths (512/8/8/2048, batch 16, 100
   steps) on 4,096 train and 256 test rows of 1,024 tokens (the
   dominance task of tests/test_sequence.py) through the port's client
   SDK on a served ``App``: accuracy ≥ 0.9, the prediction dataset
   finished, the model re-served through
   ``/trained-models/{name}/predictions`` with the same predictions;
   ``fit_time`` and the allocator's peak; (e) the train step at
   bench_transformer.py's four shapes, ``step_s``, tokens/s, loss and
   the allocator's peak each;
15. pod, the data-parallel pod on the one card: two ranks of
   ``python -m learningorchestra_tpu_torch.serving --device cuda
   --dist-backend gloo`` (NCCL refuses two ranks on one device) under
   ``python -m learningorchestra_tpu_torch.supervisor``, whose pod
   command ``python -m learningorchestra_tpu_torch.launch --ranks 2``
   starts both (each through a small wrapper, written at run time, that
   arms rank 1's failpoint at epoch 0), on the sweep's store: through
   rank 0's REST API
   ``POST /models`` of the five families (dt and gb accuracies the
   sweep's exactly, lr and nb within 1e-4, rf above its floor and lr), a
   batch predict of the pod's gb model (every probability the sweep's
   predict's), a histogram (exact) and the 60,000 × 784 t-SNE image (the
   row-form kernel launched 750 times a rank; 10-NN agreement above
   PCA-2's; stand-in matplotlib/seaborn on the ranks' path write the
   plotted points); then rank 1 dies at the device ops of a second build
   (the ``spmd.worker.pre_device`` failpoint): ``/cluster`` reports the
   pod error, a gated route answers 503 with ``Retry-After``, the
   supervisor restarts the pod under epoch 1, the rescan re-runs the
   build, and it ends with the first build's accuracies (the rank's
   death read from the launcher's ``rank_exit`` log line). The ``pod``
   line has the times, spans, each rank's allocator peak and the
   launches by kernel and rank (read from ``/cluster``). Before the
   paths, the row form and the histogram kernel's fixed-point forms are
   checked at the pod's per-rank shapes against their plain versions;
16. pod_tp, the model axis: two ranks the same way with
   ``LO_TPU_MESH_SHAPE=1,2,1`` (mlp's hidden layer split over the model
   axis, models/mlp.py); ``POST /models`` of mlp at the JAX package's
   width (hidden 256, 300 iterations, lr 1e-2) on the tune phase's
   1M-row set (cut from 11M: two ranks' activations must share the
   card), tested on the 100k test rows, and the same fit stopped at 60
   iterations: ``/cluster``'s mesh ``{"data": 1, "model": 2, "seq":
   1}`` over gloo, the saved W1 (28, 256) and W2 (256, 2), each rank's
   model-axis all-reduces exactly two a step and one all-gather a fit
   (``/cluster``'s per-process collective counts), and against one-card
   fits of the same rows in this process: the accuracy within 0.01 and
   above lr's floor at both lengths, and at 60 iterations the test
   probabilities within atol 2e-2 with argmax agreement ≥ 0.99 (past
   about 150 iterations this fit amplifies any last-bit difference,
   ``POD_TP_SHORT_ITERS``, so at 300 those two are reported, not
   held). Its line has the fits' times, each rank's allocator peak and
   the all-reduces a step, with the card's name and power limit. This
   path reaches no kernel of the port.

Each ``fit`` line of the sweep carries ``mfu`` and ``bw_util``: the
port's FLOP and byte models (``models/flops.py``) over the fit's window,
against the H100's published peaks, with the card's power limit.

Then a ``{"kernels": [...]}`` line and, as the last line,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: Held-out accuracy floors per family (the HIGGS-like workload's gates).
ACC_FLOOR = {"lr": 0.62, "nb": 0.62, "dt": 0.66, "rf": 0.70, "gb": 0.75}
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
PALLAS = "learningorchestra_tpu/ops/pallas_kernels.py"
TREE_SOURCE = "learningorchestra_tpu_torch/csrc/tree_kernels.cu"
TSNE_SOURCE = "learningorchestra_tpu_torch/csrc/tsne_kernels.cu"
#: kernel → (source in the repo, the TPU kernel it replaces; None for a
#: kernel that is part of another's port).
KERNELS = {
    "tree_histogram": (TREE_SOURCE, f"{PALLAS}:208"),
    "tree_leaf_stats": (TREE_SOURCE, f"{PALLAS}:299"),
    "tree_route_level": (TREE_SOURCE, f"{PALLAS}:321"),
    "tree_descend": (TREE_SOURCE, f"{PALLAS}:372"),
    # The layout K2's port reads (the TPU kernel read row-major codes).
    "feature_major": (TREE_SOURCE, None),
    "tsne_repulsion": (TSNE_SOURCE, f"{PALLAS}:51"),
    # The row form (query rows against every row): the pod's path.
    "tsne_repulsion_rows": (TSNE_SOURCE, f"{PALLAS}:104"),
    # The slice-axis launches of K1-K3 (a population's trees, one a
    # slice): the same kernels, timed at SLICES slices.
    "tree_histogram_slices": (TREE_SOURCE, f"{PALLAS}:208"),
    "tree_leaf_stats_slices": (TREE_SOURCE, f"{PALLAS}:299"),
    "tree_route_level_slices": (TREE_SOURCE, f"{PALLAS}:321"),
    "tree_descend_slices": (TREE_SOURCE, f"{PALLAS}:372"),
}
#: The kernels the one-tree paths (sweep, streamed build) launch.
SERIAL_KERNELS = ("tree_histogram", "tree_leaf_stats", "tree_route_level",
                  "tree_descend", "feature_major")
#: The t-SNE workload: MNIST-60k's shape, padded to whole 1024-row tiles.
TSNE_ROWS, TSNE_DIMS, TSNE_PADDED = 60_000, 784, 60_416
#: Float operations per unordered pair of the whole-embedding repulsion
#: kernel, an FMA counted as two (csrc/tsne_kernels.cu: two differences,
#: two FMAs for the distance, the reciprocal, q², the Z sum and four force
#: FMAs).
TSNE_OPS_PER_PAIR = 17
#: Float operations per (valid query row, valid foreign row) pair of the
#: row form: the unordered-pair count less the two force FMAs of the
#: second row. The column flag is applied only to tiles that touch a
#: padded row, so, as in the unordered count, no mask is counted.
TSNE_OPS_PER_FOREIGN_PAIR = 13
#: The ordered-pair count of the direct form (14 a pair with the mask
#: multiply, the bound the first port of the kernel was held to),
#: reported beside it.
TSNE_OPS_PER_ORDERED_PAIR = 14
#: SASS opcodes the build line counts per kernel.
SASS_OPS = ("ATOMS", "MUFU", "SHFL", "F2I", "FFMA", "FADD", "FMUL", "LDS",
            "LDL", "STL", "LDGSTS", "LDG", "STG", "PRMT")
ROOT = os.path.dirname(os.path.abspath(__file__))
#: Held-out rows of the HIGGS-like sweep.
TEST_ROWS = 100_000
#: Batch sizes of the online tier's requests and padding buckets, at
#: which the descent kernel is checked and timed on its own.
REQUEST_ROWS = (1, 3, 8, 64, 256)
#: The serve phase: request sizes, the concurrent load, and the test
#: rows its requests draw from (each row's one-row oracle is computed).
SERVE_SIZES = (1, 3, 8, 40, 64, 256)
SERVE_THREADS, SERVE_REQUESTS, SERVE_POOL = 8, 100, 512
#: Sequential requests per family timed at 1 and at 64 rows.
SERVE_LATENCY_REQUESTS = 60
#: The workers phase: front-end worker processes, and the request body
#: kinds each family is served in (raw records, design rows in field
#: order, the binary columnar body).
SERVE_WORKERS = 4
BODY_KINDS = ("dict", "list", "columnar")
#: Seconds of the on-demand profile captured during a load.
PROFILE_SECONDS = 2.0
#: The slice-axis kernel checks: slices of one launch (a tune wave of 8
#: configs × 3 folds), and the rows of a population scoring block
#: (models/trees.py ``_SCORE_ROWS``).
SLICES = 24
SCORE_ROWS = 1 << 19
#: The tune's own slice shapes (the tune phase's sweeps): a population
#: grows at its deepest member's depth, 6, so every level runs at NL = 32
#: node slots; gb's 18 slices (6 configs × 3 folds, float stats) share one
#: bin matrix, rf's 24 (8 configs × 3 folds, integer stats) two.
TUNE_DEPTH = 6
TUNE_SHAPES = ((18, 1, "float"), (24, 2, "int"))
#: Rounds of the shared-atomic probe (32 adds a thread a round).
ATOMS_ROUNDS = 256
#: Rows and launches a thread of the concurrent-launch check.
CONCURRENT_ROWS = 1 << 16
CONCURRENT_LAUNCHES = 10000
#: The forest_batch check: the sweep's rf (fit_rf's defaults: 20 trees
#: in 4 batches of 5, depth 5, 32 bins), and its tree params.
FOREST_TREES = 20
FOREST_PARAMS = ("feat", "thr", "internal", "leaf")


def check(ok, what) -> None:
    """A failed check ends the run (unlike ``assert``, kept under -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(doc) -> None:
    print(json.dumps(doc), flush=True)


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / FP32_OPS_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def card_line(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


#: An instruction line of cuobjdump -sass: address, predicate, opcode.
_SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)")


def _kernel_label(mangled: str) -> str:
    """A readable kernel name from a mangled one: ``hist_slice_kernel
    <uint8_t, 16>`` from ``_ZN..17hist_slice_kernelIhLi16EEEv...``,
    ``descend_staged_kernel<4>`` from ``..descend_staged_kernelILi4EEEv``."""
    m = re.search(r"\d([a-z][a-z_]*_kernel)(?:I((?:[a-z]|L[ib]\d+E)+)E)?E",
                  mangled)
    if not m:
        return mangled
    targs = [num or {"h": "uint8_t", "i": "int32_t"}.get(ch, ch)
             for num, ch in re.findall(r"L[ib](\d+)E|([a-z])",
                                       m.group(2) or "")]
    return m.group(1) + (f"<{', '.join(targs)}>" if targs else "")


def kernel_report(mod) -> dict:
    """Per kernel of a built library: registers and spill bytes from
    ptxas -v (the build's log) and the counts of the SASS_OPS
    instructions it compiled to (cuobjdump -sass)."""
    from torch.utils.cpp_extension import CUDA_HOME

    report, cur = {}, None
    for line in mod.log_path().read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = report.setdefault(_kernel_label(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    dump = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(dump):
        return report
    sass = subprocess.run([dump, "-sass", str(mod.library_path())],
                          capture_output=True, text=True, check=True).stdout
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = report.setdefault(_kernel_label(m.group(1)), {})
            cur["sass"] = {}
            continue
        m = _SASS_LINE.search(line)
        if m and cur is not None and m.group(1).startswith(SASS_OPS):
            cur["sass"][m.group(1)] = cur["sass"].get(m.group(1), 0) + 1
    return report


def check_atomics_probe(dev) -> dict:
    """The card's shared-atomic rate (``tree_kernels
    .shared_atomics_probe``): 32-bit ``ATOMS.ADD``s from one 1,024-thread
    block an SM, conflict-free (a bank a lane) and into random bins of 32
    words (K1's pattern: a warp's rows land on random bins); adds a
    second, and a SM and cycle at the maximum SM clock. K1's atomics
    floor is its adds over the random-bin rate."""
    import torch

    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(card_line("clocks.max.sm").split()[0])
    doc = {"phase": "atomics_probe", "card": card_line(), "sms": sms,
           "rounds": ATOMS_ROUNDS}
    for key, random_bins in (("conflict_free", False), ("random_bins", True)):
        adds = tk.shared_atomics_probe(dev, ATOMS_ROUNDS, random_bins)
        ms = time_ms(lambda: tk.shared_atomics_probe(dev, ATOMS_ROUNDS,
                                                     random_bins), 5)
        doc[key] = {"ms": ms, "adds": adds, "adds_per_s": adds / ms * 1e3,
                    "adds_per_sm_cycle": adds / (ms * 1e-3) / sms
                    / (mhz * 1e6)}
    emit(doc)
    return doc


def hist_adds(stats_T, max_abs, active, d: int) -> int:
    """The shared adds K1's (G, S, n) stats need: d a row that is active,
    for each of its stats' fixed-point words that is not zero (the kernel
    also adds the zero high words of a stat, which change nothing, so
    its floor counts none)."""
    import torch

    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    total = 0
    for g in range(stats_T.shape[0]):
        x = tk._fixed_rows(stats_T[g], max_abs[g])
        words = (((x >> tk.HIST_LO_BITS) != 0).int()
                 + ((x & ((1 << tk.HIST_LO_BITS) - 1)) != 0).int())
        total += int((words * active[g]).sum())
        del x, words
    torch.cuda.empty_cache()
    return total * d


def atomics_floor_ms(adds: int, atoms: dict) -> float:
    """The least time ``adds`` shared adds take at the probe's random-bin
    rate."""
    return adds / atoms["random_bins"]["adds_per_s"] * 1e3


def check_kernels(n: int, n_test: int, dev, atoms: dict) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    d, nb, depth, S = 28, 32, 5, 2
    NL, M = 2 ** (depth - 1), 2 ** (depth + 1) - 1
    codes = torch.randint(0, nb, (n, d), generator=g, device=dev,
                          dtype=torch.uint8)
    rel = torch.randint(0, NL, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    active = torch.rand((n,), generator=g, device=dev) < 0.9
    rel = torch.where(active, rel, torch.zeros_like(rel))
    counts = torch.poisson(torch.ones((S, n), device=dev), generator=g)
    grads = torch.randn((S, n), generator=g, device=dev)
    assign = torch.randint(0, M, (n,), generator=g, device=dev,
                           dtype=torch.int32)
    results = {}

    def record(name, err, ms, plain_ms, nbytes, ops, library_ms, exact,
               layout_floor_ms=None, **extra):
        b_ms, b_by = bound(nbytes, ops)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": library_ms}
        if layout_floor_ms is not None:
            results[name]["layout_floor_ms"] = layout_floor_ms
        if "atomics_floor_ms" in extra:
            results[name]["atomics_floor_ms"] = extra["atomics_floor_ms"]
        emit({"phase": "kernel", "name": name, "exact": exact,
              **results[name], **extra})

    # K1, histogram form: integer-valued stats must match exactly; float
    # stats to rtol 1e-5 + atol 1e-6·Σ|stats| (summation order).
    kw = dict(n_nodes=NL, n_bins=nb)
    h_int = tk.tree_histogram(codes, counts, rel, active, **kw)
    r_int = tk.tree_histogram_ref(codes, counts, rel, active, **kw)
    check(torch.equal(h_int, r_int), "tree_histogram: integer stats differ")
    # dt's stats: a class one-hot, half of them zero.
    y = torch.randint(0, S, (n,), generator=g, device=dev)
    onehot = torch.nn.functional.one_hot(y, S).T.float().contiguous()
    check(torch.equal(tk.tree_histogram(codes, onehot, rel, active, **kw),
                      tk.tree_histogram_ref(codes, onehot, rel, active,
                                            **kw)),
          "tree_histogram: one-hot stats differ")
    h = tk.tree_histogram(codes, grads, rel, active, **kw)
    r = tk.tree_histogram_ref(codes, grads, rel, active, **kw)
    atol = 1e-6 * float(grads.abs().sum())
    err = float((h - r).abs().max())
    check(torch.allclose(h, r, rtol=1e-5, atol=atol),
          f"tree_histogram: float stats err {err} > atol {atol}")
    check(torch.equal(h, tk.tree_histogram(codes, grads, rel, active, **kw)),
          "tree_histogram: two calls on float stats differ")
    # models/trees.py computes the scales once per tree and passes them
    # to every level: time the kernel as a level calls it, and the scale
    # pass on its own.
    g_max = tk.stat_max_abs(grads)
    oh_max = tk.stat_max_abs(onehot)
    extra = {
        "ms_onehot": time_ms(lambda: tk.tree_histogram(
            codes, onehot, rel, active, max_abs=oh_max, **kw), 10),
        "stat_max_abs_ms": time_ms(lambda: tk.stat_max_abs(grads), 10),
        "atomics_floor_ms": atomics_floor_ms(
            hist_adds(grads[None], g_max[None], active[None], d), atoms)}
    key = (rel.long()[:, None] * (d * nb)
           + torch.arange(d, device=dev) * nb + codes.long())[active]
    src = grads.T[active][:, None, :].expand(-1, d, S).reshape(-1, S)
    flat_key = key.reshape(-1)
    lib_out = torch.zeros((NL * d * nb, S), device=dev)
    n_act = int(active.sum())
    record("tree_histogram", err,
           time_ms(lambda: tk.tree_histogram(codes, grads, rel, active,
                                             max_abs=g_max, **kw), 10),
           time_ms(lambda: tk.tree_histogram_ref(codes, grads, rel, active,
                                                 **kw), 2),
           # Flags and node ids of every row; codes and stats of the
           # active rows; the histogram written once.
           n + 4 * n + n_act * (d + 4 * S) + 4 * NL * d * nb * S,
           n_act * d * S,
           time_ms(lambda: lib_out.index_add_(0, flat_key, src), 5), True,
           **extra)

    # K1, leaf form.
    l_int = tk.tree_leaf_stats(assign, counts, n_nodes=M)
    check(torch.equal(l_int, tk.tree_leaf_stats_ref(assign, counts,
                                                    n_nodes=M)),
          "tree_leaf_stats: integer stats differ")
    lk = tk.tree_leaf_stats(assign, grads, n_nodes=M)
    lr_ = tk.tree_leaf_stats_ref(assign, grads, n_nodes=M)
    err = float((lk - lr_).abs().max())
    check(torch.allclose(lk, lr_, rtol=1e-5, atol=atol),
          f"tree_leaf_stats: err {err}")
    check(torch.equal(lk, tk.tree_leaf_stats(assign, grads, n_nodes=M)),
          "tree_leaf_stats: two calls on float stats differ")
    leaf_out = torch.zeros((M, S), device=dev)
    along = assign.long()
    gT = grads.T
    every = torch.ones((1, n), dtype=torch.bool, device=dev)
    record("tree_leaf_stats", err,
           time_ms(lambda: tk.tree_leaf_stats(assign, grads, n_nodes=M,
                                              max_abs=g_max), 10),
           time_ms(lambda: tk.tree_leaf_stats_ref(assign, grads, n_nodes=M),
                   3),
           4 * n + 4 * S * n + 4 * M * S, n * S,
           time_ms(lambda: leaf_out.index_add_(0, along, gT), 5), True,
           atomics_floor_ms=atomics_floor_ms(
               hist_adds(grads[None], g_max[None], every, 1), atoms),
           # Its two kernels' device time alone: a call is short enough
           # that the wrapper's host time shows in back-to-back calls.
           device_ms=device_ms(lambda: tk.tree_leaf_stats(
               assign, grads, n_nodes=M, max_abs=g_max), 20)[0])
    del every

    # K2: routing at the deepest level's width, from the feature-major
    # codes as every level of a fit calls it, and without them (the
    # wrapper makes its own copy).
    best_f = torch.randint(0, d, (NL,), generator=g, device=dev,
                           dtype=torch.int32)
    best_t = torch.randint(0, nb, (NL,), generator=g, device=dev,
                           dtype=torch.int32)
    split = torch.rand((NL,), generator=g, device=dev) < 0.7
    base = torch.full((n,), NL - 1, dtype=torch.int32, device=dev) + rel
    args = (codes, rel, active, base, best_f, best_t, split)
    codes_T = tk.feature_major(codes)
    plain_T = tk.feature_major_ref(codes)
    check(torch.equal(codes_T, plain_T), "feature_major differs")
    check(torch.equal(tk.feature_major(codes), codes_T),
          "feature_major: two calls differ")
    del plain_T
    # Codes read once, written once.
    record("feature_major", 0.0,
           time_ms(lambda: tk.feature_major(codes), 10),
           time_ms(lambda: tk.feature_major_ref(codes), 10),
           2 * n * d, 0, time_ms(lambda: codes.t().contiguous(), 10), True,
           plan=tk.feature_major_plan(n, d, codes_T.data_ptr())._asdict(),
           cases=feature_major_cases(dev, n),
           shapes=feature_major_shapes(dev, n))
    out = tk.tree_route_level(*args, codes_T=codes_T)
    ref = tk.tree_route_level_ref(*args)
    check(torch.equal(out, ref), "tree_route_level differs")
    check(torch.equal(tk.tree_route_level(*args), ref),
          "tree_route_level differs without codes_T")
    check(torch.equal(tk.tree_route_level(*args, codes_T=codes_T), out),
          "tree_route_level: two calls differ")
    # Needed bytes: flags, node ids, ids in and out for every row, and one
    # code byte for each row that moves to a child. The row-major layout
    # makes a warp fetch its rows' whole spans (d bytes a row); the
    # feature-major one a 32-B sector per distinct (feature, 32-row run)
    # among the rows that move.
    moving = active & split[rel.long()]
    moved = int(moving.sum())
    ids = n + 3 * 4 * n
    run = torch.arange(n, device=dev)[moving] // 32
    sectors = torch.unique(best_f.long()[rel.long()][moving] * -(-n // 32)
                           + run).numel()
    record("tree_route_level", float((out - ref).abs().max()),
           time_ms(lambda: tk.tree_route_level(*args, codes_T=codes_T), 20),
           time_ms(lambda: tk.tree_route_level_ref(*args), 3),
           ids + moved + 4 * 3 * NL, 0, None, True,
           layout_floor_ms=bound(ids + n * d)[0],
           feature_major_floor_ms=bound(ids + 32 * sectors)[0],
           ms_without_codes_T=time_ms(lambda: tk.tree_route_level(*args), 10),
           codes_T_ms=results["feature_major"]["ms"],
           cases=route_cases(dev))
    del codes_T

    # K3: a random full tree; one tree over the train rows (the gb fit's
    # per-round descent), a 20-tree forest over the test rows (a forest
    # predict's single launch) and over all train rows.
    feat = torch.randint(0, d, (20, M), generator=g, device=dev,
                         dtype=torch.int32)
    thr = torch.randint(0, nb, (20, M), generator=g, device=dev,
                        dtype=torch.int32)
    internal = torch.rand((20, M), generator=g, device=dev) < 0.8
    # A root that is a leaf would stop every row at once.
    internal[:, 0] = True
    one = (codes, feat[0], thr[0], internal[0])
    out = tk.tree_descend(*one, max_depth=depth)
    ref = tk.tree_descend_ref(*one, max_depth=depth)
    check(torch.equal(out, ref), "tree_descend differs (one tree)")
    check(torch.equal(tk.tree_descend(*one, max_depth=depth), out),
          "tree_descend: two calls differ")
    forest = (feat, thr, internal)
    test_codes = codes[:n_test]
    out_f = tk.tree_descend(test_codes, *forest, max_depth=depth)
    check(torch.equal(out_f, tk.tree_descend_ref(test_codes, *forest,
                                                 max_depth=depth)),
          "tree_descend differs (forest, test rows)")
    out_f = tk.tree_descend(codes, *forest, max_depth=depth)
    check(torch.equal(out_f, tk.tree_descend_ref(codes, *forest,
                                                 max_depth=depth)),
          "tree_descend differs (forest, train rows)")
    del out_f
    # Needed bytes: one code byte per internal node a row passes through,
    # the tables, and the leaf ids written. The layout forces each row's
    # d bytes once a launch (the staged stream) and the leaf ids.
    visits = descent_visits(codes, *forest, depth)
    T = feat.shape[0]
    plan = tk.descend_plan(n, d, depth, T, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    # What the card's memory gives a plain stream in this run: a
    # device-to-device copy of the codes (read and written once).
    copy = torch.empty_like(codes)
    copy_ms = time_ms(lambda: copy.copy_(codes), 20)
    del copy
    record("tree_descend", float((out - ref).abs().max()),
           time_ms(lambda: tk.tree_descend(*one, max_depth=depth), 20),
           time_ms(lambda: tk.tree_descend_ref(*one, max_depth=depth), 3),
           visits[0] + 4 * 3 * M + 4 * n, 0, None, True,
           layout_floor_ms=bound(n * d + 4 * n)[0],
           forest_test_ms=time_ms(lambda: tk.tree_descend(
               test_codes, *forest, max_depth=depth), 20),
           forest_train_ms=time_ms(lambda: tk.tree_descend(
               codes, *forest, max_depth=depth), 10),
           forest_train_bound_ms=bound(sum(visits) + 4 * 3 * M * T
                                       + 4 * n * T)[0],
           forest_train_layout_floor_ms=bound(n * d + 4 * n * T)[0],
           copy_tb_s=2 * n * d / copy_ms / 1e9,
           plan=plan._asdict(), cases=descend_cases(dev),
           request_sizes=descend_request_cases(dev, forest, depth))
    return results


def check_slice_kernels(n: int, dev, atoms: dict) -> dict:
    """The slice-axis launches (``*_slices``) at the tune phase's shapes:
    SLICES slices over two bin matrices of the HIGGS sweep (n train rows,
    d=28, 32 bins, depth 5), as a population of rf or gb members grows
    one tree each. Each against SLICES one-slice launches (``torch.equal``
    per slice), against its plain version on the first 2^20 rows, two
    calls bit-identical, and its time beside its bound. Then K1 and K3 at
    the tune's own shapes (``check_tune_shapes``)."""
    import torch

    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    g_ = torch.Generator(device=dev)
    g_.manual_seed(1)
    G, P = SLICES, 2
    d, nb, depth, S = 28, 32, 5, 2
    NL, M = 2 ** (depth - 1), 2 ** (depth + 1) - 1
    idx = [g % P for g in range(G)]
    codes = torch.randint(0, nb, (P, n, d), generator=g_, device=dev,
                          dtype=torch.uint8)
    rel = torch.randint(0, NL, (G, n), generator=g_, device=dev,
                        dtype=torch.int32)
    active = torch.rand((G, n), generator=g_, device=dev) < 0.9
    rel = torch.where(active, rel, torch.zeros_like(rel))
    grads = torch.randn((G, S, n), generator=g_, device=dev)
    g_max = tk.stat_max_abs(grads)
    small = 1 << 20
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {}

    def record(name, err, ms, plain_ms, nbytes, ops, library_ms, **extra):
        b_ms, b_by = bound(nbytes, ops)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": library_ms,
                         **{k: v for k, v in extra.items()
                            if k.endswith("floor_ms")}}
        emit({"phase": "kernel", "name": name, "exact": True, "slices": G,
              "bin_matrices": P, **results[name], **extra})

    def per_slice(name, got, one):
        for g in range(G):
            check(torch.equal(got[g], one(g)),
                  f"{name}: slice {g} differs from its one-slice launch")

    def small_inputs(*ts):
        """The first 2^20 rows of each (..., n) tensor, contiguous."""
        return [t[..., :small].contiguous() for t in ts]

    # K1, histogram form.
    kw = dict(n_nodes=NL, n_bins=nb)
    h = tk.tree_histogram_slices(codes, idx, grads, rel, active,
                                 max_abs=g_max, **kw)
    per_slice("tree_histogram_slices", h, lambda g: tk.tree_histogram(
        codes[idx[g]], grads[g], rel[g], active[g], max_abs=g_max[g], **kw))
    check(torch.equal(h, tk.tree_histogram_slices(
        codes, idx, grads, rel, active, max_abs=g_max, **kw)),
        "tree_histogram_slices: two calls differ")
    cs = codes[:, :small].contiguous()
    gs, rs, as_ = small_inputs(grads, rel, active)
    counts = torch.poisson(torch.ones_like(gs), generator=g_)
    check(torch.equal(
        tk.tree_histogram_slices(cs, idx, counts, rs, as_, **kw),
        tk.tree_histogram_slices_ref(cs, idx, counts, rs, as_, **kw)),
        "tree_histogram_slices: integer stats differ from the plain version")
    hk = tk.tree_histogram_slices(cs, idx, gs, rs, as_, **kw)
    hr = tk.tree_histogram_slices_ref(cs, idx, gs, rs, as_, **kw)
    atol = 1e-6 * float(gs.abs().sum(dim=(1, 2)).max())
    err = float((hk - hr).abs().max())
    check(torch.allclose(hk, hr, rtol=1e-5, atol=atol),
          f"tree_histogram_slices: float stats err {err} > atol {atol}")
    n_act = active.sum(dim=1).tolist()
    # Codes once per bin matrix (the rows active in any of its slices),
    # as each input is read once; the kernel reads them once per slice.
    any_act = [int(torch.stack([active[g] for g in range(G)
                                if idx[g] == p]).any(0).sum())
               for p in range(P)]
    hist_bytes = 4 * NL * d * nb * S
    code_bytes = sum(any_act) * d
    per_slice_codes = sum(n_act) * d
    other = G * (n + 4 * n) + sum(n_act) * 4 * S + G * hist_bytes
    record("tree_histogram_slices", err,
           time_ms(lambda: tk.tree_histogram_slices(
               codes, idx, grads, rel, active, max_abs=g_max, **kw), 5),
           time_ms(lambda: tk.tree_histogram_slices_ref(
               codes, idx, grads, rel, active, **kw), 1, warmup=0),
           other + code_bytes, sum(n_act) * d * S, None,
           codes_counted="once per bin matrix",
           atomics_floor_ms=atomics_floor_ms(
               hist_adds(grads, g_max, active, d), atoms),
           bound_codes_per_slice_ms=bound(other + per_slice_codes)[0],
           library_note=("one index_add_ over every slice's (row, feature) "
                         f"keys needs {8 * sum(n_act) * d / 1e9:.1f} GB of "
                         "int64 keys"))
    del h, hk, hr, counts

    # K1, leaf form.
    assign = torch.randint(0, M, (G, n), generator=g_, device=dev,
                           dtype=torch.int32)
    lk = tk.tree_leaf_stats_slices(assign, grads, n_nodes=M, max_abs=g_max)
    per_slice("tree_leaf_stats_slices", lk, lambda g: tk.tree_leaf_stats(
        assign[g], grads[g], n_nodes=M, max_abs=g_max[g]))
    check(torch.equal(lk, tk.tree_leaf_stats_slices(assign, grads,
                                                    n_nodes=M,
                                                    max_abs=g_max)),
          "tree_leaf_stats_slices: two calls differ")
    a_s, = small_inputs(assign)
    lks = tk.tree_leaf_stats_slices(a_s, gs, n_nodes=M)
    lrs = tk.tree_leaf_stats_slices_ref(a_s, gs, n_nodes=M)
    err = float((lks - lrs).abs().max())
    check(torch.allclose(lks, lrs, rtol=1e-5, atol=atol),
          f"tree_leaf_stats_slices: err {err}")
    # The plan's choice of slice copies against the others: the same
    # bits, and each one's time.
    copies = {}
    for r in tk.HIST_REPLICAS:
        launch = functools.partial(tk._leaf_launch, assign, grads, M, g_max,
                                   fixed=False, replicas=r)
        check(torch.equal(launch().transpose(1, 2), lk),
              f"tree_leaf_stats_slices: {r} copies differ")
        copies[r] = time_ms(launch, 3)
    keys = (assign.long() + M * torch.arange(G, device=dev)[:, None]
            ).reshape(-1)
    src = grads.transpose(1, 2).reshape(G * n, S)
    leaf_out = torch.zeros((G * M, S), device=dev)
    record("tree_leaf_stats_slices", err,
           time_ms(lambda: tk.tree_leaf_stats_slices(
               assign, grads, n_nodes=M, max_abs=g_max), 5),
           time_ms(lambda: tk.tree_leaf_stats_slices_ref(
               assign, grads, n_nodes=M), 1, warmup=0),
           G * (4 * n + 4 * S * n + 4 * M * S), G * n * S,
           time_ms(lambda: leaf_out.index_add_(0, keys, src), 3),
           codes_counted="none (node ids are the codes)",
           ms_by_copies=copies,
           grid=tk.hist_grid(n, 1, M, S, 1, sms, G)._asdict(),
           atomics_floor_ms=atomics_floor_ms(hist_adds(
               grads, g_max, torch.ones_like(active), 1), atoms))
    del lk, keys, src, leaf_out

    # K2, from the feature-major stack.
    best_f = torch.randint(0, d, (G, NL), generator=g_, device=dev,
                           dtype=torch.int32)
    best_t = torch.randint(0, nb, (G, NL), generator=g_, device=dev,
                           dtype=torch.int32)
    split = torch.rand((G, NL), generator=g_, device=dev) < 0.7
    base = rel + (NL - 1)
    codes_T = tk.feature_major(codes)
    check(torch.equal(codes_T, torch.stack([tk.feature_major_ref(c)
                                            for c in codes])),
          "feature_major: the stack differs from the plain versions")
    args = (rel, active, base, best_f, best_t, split)
    out = tk.tree_route_level_slices(codes, idx, *args, codes_T=codes_T)
    per_slice("tree_route_level_slices", out, lambda g: tk.tree_route_level(
        codes[idx[g]], *(a[g] for a in args), codes_T=codes_T[idx[g]]))
    check(torch.equal(out, tk.tree_route_level_slices(
        codes, idx, *args, codes_T=codes_T)),
        "tree_route_level_slices: two calls differ")
    sargs = small_inputs(rel, active, base)
    check(torch.equal(
        tk.tree_route_level_slices(cs, idx, *sargs, best_f, best_t, split),
        tk.tree_route_level_slices_ref(cs, idx, *sargs, best_f, best_t,
                                       split)),
        "tree_route_level_slices differs from the plain version")
    moved = int((active & split.gather(1, rel.long())).sum())
    record("tree_route_level_slices", 0.0,
           time_ms(lambda: tk.tree_route_level_slices(
               codes, idx, *args, codes_T=codes_T), 10),
           time_ms(lambda: tk.tree_route_level_slices_ref(
               codes, idx, *args), 1, warmup=0),
           G * (n + 12 * n) + moved + G * 12 * NL, 0, None,
           codes_counted="per slice (one byte per moving row)")
    del out, codes_T, base

    # K3: one tree a slice over its matrix (a gb round's descent of every
    # member), and 20 trees a slice over a scoring block of rows.
    feat = torch.randint(0, d, (G, 20, M), generator=g_, device=dev,
                         dtype=torch.int32)
    thr = torch.randint(0, nb, (G, 20, M), generator=g_, device=dev,
                        dtype=torch.int32)
    internal = torch.rand((G, 20, M), generator=g_, device=dev) < 0.8
    internal[:, :, 0] = True
    one = (feat[:, :1], thr[:, :1], internal[:, :1])
    out = tk.tree_descend_slices(codes, idx, *one, max_depth=depth)
    per_slice("tree_descend_slices", out, lambda g: tk.tree_descend(
        codes[idx[g]], *(t[g] for t in one), max_depth=depth))
    check(torch.equal(out, tk.tree_descend_slices(codes, idx, *one,
                                                  max_depth=depth)),
          "tree_descend_slices: two calls differ")
    check(torch.equal(
        tk.tree_descend_slices(cs, idx, *one, max_depth=depth),
        tk.tree_descend_slices_ref(cs, idx, *one, max_depth=depth)),
        "tree_descend_slices differs from the plain version")
    block = codes[:, :SCORE_ROWS]
    forest = (feat, thr, internal)
    check(torch.equal(
        tk.tree_descend_slices(block, idx, *forest, max_depth=depth),
        tk.tree_descend_slices_ref(block, idx, *forest, max_depth=depth)),
        "tree_descend_slices differs from the plain version (20 trees, a "
        "row block)")
    visits = sum(descent_visits(codes[idx[g]], *(t[g] for t in one),
                                depth)[0] for g in range(G))
    # The code bytes any walk of a matrix's slices touches, once per
    # matrix (the slices of a matrix walk one staged tile), the tables and
    # the leaf ids; the layout floor stages each matrix's rows once.
    touched = descent_touched_bytes(codes, idx, *one, depth)
    record("tree_descend_slices", 0.0,
           time_ms(lambda: tk.tree_descend_slices(codes, idx, *one,
                                                  max_depth=depth), 10),
           time_ms(lambda: tk.tree_descend_slices_ref(
               codes, idx, *one, max_depth=depth), 1, warmup=0),
           touched + G * 12 * M + G * 4 * n, 0, None,
           codes_counted="once per bin matrix (the bytes any walk touches)",
           bound_codes_per_slice_ms=bound(visits + G * 12 * M
                                          + G * 4 * n)[0],
           layout_floor_ms=bound(P * n * d + G * 4 * n)[0],
           forest_block_ms=time_ms(lambda: tk.tree_descend_slices(
               block, idx, *forest, max_depth=depth), 10),
           forest_block_rows=SCORE_ROWS)
    del codes, rel, active, grads, out, block, feat, thr, internal
    torch.cuda.empty_cache()
    hist_levels, descend_groups = check_tune_shapes(n, dev, atoms)
    results["tree_histogram_slices"]["tune_levels"] = hist_levels
    results["tree_descend_slices"]["tune_groups"] = descend_groups
    return results


def check_tune_shapes(n: int, dev, atoms: dict):
    """K1's and K3's slice forms at the tune's own shapes (TUNE_SHAPES:
    gb's 18 slices over one bin matrix, float stats; rf's 24 over two,
    integer stats; n rows, d=28, 32 bins): K1 at each level of a depth-6
    population (NL = 32 node slots, the level's 2^level nodes holding
    rows), K3 one depth-6 tree a slice. Each launch ``torch.equal`` to
    its one-slice launches, against its plain version on the first 2^20
    rows (bit for bit for integer stats and node ids; float stats within
    the K1 tolerance), two calls bit-identical; its time beside its
    bound, K1's atomics floor and K3's layout floor. Returns (K1's rows,
    K3's rows)."""
    import torch

    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    g_ = torch.Generator(device=dev)
    g_.manual_seed(3)
    d, nb, S, depth = 28, 32, 2, TUNE_DEPTH
    NL, M = 2 ** (depth - 1), 2 ** (depth + 1) - 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G_all = max(G for G, _, _ in TUNE_SHAPES)
    P_all = max(P for _, P, _ in TUNE_SHAPES)
    small = 1 << 20
    codes = torch.randint(0, nb, (P_all, n, d), generator=g_, device=dev,
                          dtype=torch.uint8)
    active = torch.rand((G_all, n), generator=g_, device=dev) < 0.9
    # Each row's node at the deepest level; at level l its node is the
    # ancestor, deep >> (depth - 1 - l).
    deep = torch.randint(0, NL, (G_all, n), generator=g_, device=dev,
                         dtype=torch.int32)
    stats_by_kind = {
        "float": torch.randn((G_all, S, n), generator=g_, device=dev),
        "int": torch.poisson(torch.ones((G_all, S, n), device=dev),
                             generator=g_)}
    levels = []
    for G, P, kind in TUNE_SHAPES:
        idx = [g % P for g in range(G)]
        cs = codes[:P]
        stats, act = stats_by_kind[kind][:G], active[:G]
        mx = tk.stat_max_abs(stats)
        adds = hist_adds(stats, mx, act, d)
        n_act = act.sum(dim=1).tolist()
        any_act = [int(act[[g for g in range(G) if idx[g] == p]].any(0)
                       .sum()) for p in range(P)]
        small_cs = cs[:, :small].contiguous()
        small_st = stats[..., :small].contiguous()
        small_act = act[:, :small].contiguous()
        atol = 1e-6 * float(small_st.abs().sum(dim=(1, 2)).max())
        for level in range(depth):
            live = 1 << level
            rel = torch.where(act, deep[:G] >> (depth - 1 - level),
                              torch.zeros_like(deep[:G]))
            kw = dict(n_nodes=NL, n_bins=nb, n_live=live)
            h = tk.tree_histogram_slices(cs, idx, stats, rel, act,
                                         max_abs=mx, **kw)
            for g in range(G):
                check(torch.equal(h[g], tk.tree_histogram(
                    cs[idx[g]], stats[g], rel[g], act[g], max_abs=mx[g],
                    **kw)), f"tree_histogram_slices G={G} level {level}: "
                    f"slice {g} differs from its one-slice launch")
            check(torch.equal(h, tk.tree_histogram_slices(
                cs, idx, stats, rel, act, max_abs=mx, **kw)),
                f"tree_histogram_slices G={G} level {level}: two calls "
                f"differ")
            del h
            small_rel = rel[:, :small].contiguous()
            hk = tk.tree_histogram_slices(small_cs, idx, small_st, small_rel,
                                          small_act, **kw)
            hr = tk.tree_histogram_slices_ref(small_cs, idx, small_st,
                                              small_rel, small_act, **kw)
            err = float((hk - hr).abs().max())
            if kind == "int":
                check(torch.equal(hk, hr), f"tree_histogram_slices G={G} "
                      f"level {level}: integer stats differ from the plain "
                      f"version")
            else:
                check(torch.allclose(hk, hr, rtol=1e-5, atol=atol),
                      f"tree_histogram_slices G={G} level {level}: float "
                      f"stats err {err} > atol {atol}")
            del hk, hr, small_rel
            ms = time_ms(lambda: tk.tree_histogram_slices(
                cs, idx, stats, rel, act, max_abs=mx, **kw), 5)
            # The plan's choice of slice copies against the others that
            # fit: the same bits, and each one's time.
            plan = tk.hist_plan(n, d, nb, S, NL, sms, G, live)
            grid = tk.hist_grid(n, d, nb, S, NL, sms, G, live)
            want = tk.tree_histogram_slices(cs, idx, stats, rel, act,
                                            max_abs=mx, **kw)
            copies = {}
            for r in tk.HIST_REPLICAS:
                if tk.hist_smem_bytes(plan.NG, plan.CG, S, r) > tk.SMEM_BYTES:
                    continue
                launch = functools.partial(
                    tk._hist_launch, cs, idx, stats, rel, act, NL, nb, mx,
                    fixed=False, n_live=live, replicas=r)
                check(torch.equal(launch(), want),
                      f"tree_histogram_slices G={G} level {level}: "
                      f"{r} copies differ")
                copies[r] = time_ms(launch, 3)
            del want
            # Flags and node ids of every row and slice, stats of the
            # active rows, codes once per bin matrix (the rows active in
            # any of its slices), the (G, NL, d, nb, S) histogram once.
            nbytes = (G * 5 * n + sum(n_act) * 4 * S + sum(any_act) * d
                      + G * 4 * NL * d * nb * S)
            b_ms, b_by = bound(nbytes, sum(n_act) * d * S)
            levels.append({"slices": G, "bin_matrices": P, "stats": kind,
                           "level": level, "live_nodes": 1 << level,
                           "ms": ms, "max_abs_err": err, "bound_ms": b_ms,
                           "bound_by": b_by,
                           "atomics_floor_ms": atomics_floor_ms(adds, atoms),
                           "adds": adds, "plan": plan._asdict(),
                           "grid": grid._asdict(),
                           "partial_bytes": 8 * grid.blocks * G * live * d
                           * nb * S, "ms_by_copies": copies})
            emit({"phase": "kernel", "name": "tree_histogram_slices",
                  "shape": f"tune depth {depth}", "exact": True,
                  **levels[-1]})
            del rel
    del stats_by_kind, deep, active
    torch.cuda.empty_cache()

    feat = torch.randint(0, d, (G_all, 1, M), generator=g_, device=dev,
                         dtype=torch.int32)
    thr = torch.randint(0, nb, (G_all, 1, M), generator=g_, device=dev,
                        dtype=torch.int32)
    internal = torch.rand((G_all, 1, M), generator=g_, device=dev) < 0.8
    internal[:, :, 0] = True
    groups = []
    for G, P, _ in TUNE_SHAPES:
        idx = [g % P for g in range(G)]
        cs = codes[:P]
        one = (feat[:G], thr[:G], internal[:G])
        out = tk.tree_descend_slices(cs, idx, *one, max_depth=depth)
        for g in range(G):
            check(torch.equal(out[g], tk.tree_descend(
                cs[idx[g]], *(t[g] for t in one), max_depth=depth)),
                f"tree_descend_slices G={G}: slice {g} differs from its "
                f"one-slice launch")
        check(torch.equal(out, tk.tree_descend_slices(cs, idx, *one,
                                                      max_depth=depth)),
              f"tree_descend_slices G={G}: two calls differ")
        small_cs = cs[:, :small].contiguous()
        check(torch.equal(
            tk.tree_descend_slices(small_cs, idx, *one, max_depth=depth),
            tk.tree_descend_slices_ref(small_cs, idx, *one,
                                       max_depth=depth)),
            f"tree_descend_slices G={G} differs from the plain version")
        del out, small_cs
        ms = time_ms(lambda: tk.tree_descend_slices(cs, idx, *one,
                                                    max_depth=depth), 10)
        # Needed: the code bytes any walk of a matrix's slices touches,
        # once per matrix, the tables, and the leaf ids. The layout
        # floor: each matrix's rows once, and the leaf ids.
        touched = descent_touched_bytes(cs, idx, *one, depth)
        b_ms, b_by = bound(touched + G * 12 * M + G * 4 * n)
        plan = tk.descend_plan(n, d, depth, 1, sms,
                               tk.slice_groups(idx, P, dev).counts)
        groups.append({"slices": G, "bin_matrices": P, "trees": 1,
                       "depth": depth, "ms": ms, "plan": plan._asdict(),
                       "bound_ms": b_ms,
                       "bound_by": b_by, "touched_code_bytes": touched,
                       "layout_floor_ms": bound(P * n * d + G * 4 * n)[0]})
        emit({"phase": "kernel", "name": "tree_descend_slices",
              "shape": f"tune depth {depth}", "exact": True, **groups[-1]})
    return levels, groups


def descent_touched_bytes(codes, code_idx, feat, thr, internal,
                          depth) -> int:
    """The code bytes that any walk of a matrix's slices reads, each
    (row, feature) of a matrix counted once, summed over the matrices."""
    import torch

    P, n, d = codes.shape
    total = 0
    rows = torch.arange(n, device=codes.device) * d
    for p in range(P):
        touched = torch.zeros((n * d,), dtype=torch.bool,
                              device=codes.device)
        for g in (g for g in range(len(code_idx)) if code_idx[g] == p):
            for t in range(feat.shape[1]):
                f, th = feat[g, t].long(), thr[g, t]
                go = internal[g, t]
                a = torch.zeros((n,), dtype=torch.long, device=codes.device)
                for _ in range(depth):
                    on = go[a]
                    touched[(rows + f[a])[on]] = True
                    v = codes[p].gather(1, f[a][:, None])[:, 0]
                    a = torch.where(on, 2 * a + 1 + (v > th[a]).long(), a)
        total += int(touched.sum())
        del touched
    return total


def descent_visits(codes, feat, thr, internal, depth) -> list:
    """Per tree, the internal nodes the rows pass through on their walks:
    the code bytes a descent needs."""
    import torch

    visits = []
    for t in range(feat.shape[0]):
        f, th, go = feat[t].long(), thr[t], internal[t].long()
        a = torch.zeros((codes.shape[0],), dtype=torch.long,
                        device=codes.device)
        count = 0
        for _ in range(depth):
            on = go[a] != 0
            count += int(on.sum())
            v = codes.gather(1, f[a][:, None])[:, 0]
            a = torch.where(on, 2 * a + 1 + (v > th[a]).long(), a)
        visits.append(count)
    return visits


#: The feature-major copy's exactness sweep: row counts (1 to the HIGGS
#: sweep's; odd ones, whose output rows are not 16-B aligned) and widths
#: (the span path up to TRANS_FEATS bytes, strided rows past it, 33: one
#: byte past a tile), each from an aligned base, a one-row view (d bytes
#: in) and a three-byte view.
FM_ROWS = (1, 3, 15, 17, 1_025, 1_000_003)
FM_DIMS = (1, 6, 28, 32, 33, 128, 300, 784)
FM_VIEWS = ("aligned", "row_view", "byte_view")


def feature_major_cases(dev, n_train: int) -> dict:
    """``feature_major`` against its plain version, bit for bit and twice
    the same, at every FM_ROWS (and the train rows) × FM_DIMS shape from
    each FM_VIEWS base, and the stack form (P matrices in one launch)
    against the stacked plain versions. Its own seed."""
    import torch

    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    g = torch.Generator(device=dev)
    g.manual_seed(4)
    count = 0
    for n in FM_ROWS + (n_train,):
        for d in FM_DIMS:
            flat = torch.randint(0, 256, ((n + 1) * d + 16,), generator=g,
                                 device=dev, dtype=torch.uint8)
            views = (flat[:n * d].view(n, d),
                     flat[:(n + 1) * d].view(n + 1, d)[1:],
                     flat[3:3 + n * d].view(n, d))
            for name, v in zip(FM_VIEWS, views):
                got = tk.feature_major(v)
                check(torch.equal(got, tk.feature_major_ref(v)),
                      f"feature_major differs: n={n} d={d} {name}")
                check(torch.equal(got, tk.feature_major(v)),
                      f"feature_major: two calls differ: n={n} d={d} "
                      f"{name}")
                count += 1
                del got
            del flat, views
    torch.cuda.empty_cache()
    stacks = []
    for P, n, d in ((2, n_train, 28), (2, 1_000_003, 6), (3, 17, 33),
                    (2, 100_003, 300)):
        st = torch.randint(0, 256, (P, n, d), generator=g, device=dev,
                           dtype=torch.uint8)
        got = tk.feature_major(st)
        check(torch.equal(got, torch.stack([tk.feature_major_ref(x)
                                            for x in st])),
              f"feature_major stack differs: P={P} n={n} d={d}")
        check(torch.equal(got, tk.feature_major(st)),
              f"feature_major stack: two calls differ: P={P} n={n} d={d}")
        stacks.append([P, n, d])
        del st, got
    torch.cuda.empty_cache()
    return {"shapes": count, "rows": list(FM_ROWS) + [n_train],
            "dims": list(FM_DIMS), "views": list(FM_VIEWS),
            "stacks": stacks, "exact": True}


def feature_major_shapes(dev, n_train: int) -> list:
    """``feature_major``'s time at the shapes its callers give it: a pod
    rank's rows (half the sweep's), a population's two bin matrices in
    one launch (beside two one-matrix launches and the ``torch.stack``
    that made the stack before), and the widths of ``descend_cases`` at
    its row counts; each beside its byte bound and one PyTorch call's
    time (``transpose`` then ``contiguous``)."""
    import torch

    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    g = torch.Generator(device=dev)
    g.manual_seed(6)
    rank = -(-n_train // POD_RANKS)
    out = []
    for P, n, d in ((1, rank, 28), (2, n_train, 28), (1, 1_000_003, 6),
                    (1, 100_003, 128), (1, 100_003, 300),
                    (1, 100_003, 784)):
        x = torch.randint(0, 32, (P, n, d), generator=g, device=dev,
                          dtype=torch.uint8)
        x = x[0] if P == 1 else x
        it = 10 if n * d * P > 10**8 else 50
        doc = {"P": P, "n": n, "d": d,
               "ms": time_ms(lambda: tk.feature_major(x), it),
               "device_ms": device_ms(lambda: tk.feature_major(x), it)[0],
               "bound_ms": bound(2 * P * n * d)[0],
               "library_ms": time_ms(
                   lambda: x.transpose(-1, -2).contiguous(), it),
               "plan": tk.feature_major_plan(n, d, 0)._asdict()}
        if P > 1:
            doc["per_matrix_and_stack_ms"] = time_ms(
                lambda: torch.stack([tk.feature_major(m) for m in x]), it)
        out.append(doc)
        del x
    torch.cuda.empty_cache()
    return out


def route_cases(dev) -> list:
    """K2 against its plain version, with and without codes_T, where the
    HIGGS case does not reach: a ragged n, d = 6, 256 bins, a depth-12
    level's 2,048 nodes, thresholds past the codes' range, and id arrays
    that are unaligned views (the kernel's scalar form). Its own seed, so
    the timed cases' inputs do not depend on these."""
    import torch

    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    cases = []
    for n, d, nb, NL, off in ((1_000_003, 6, 256, 16, 0),
                              (1_000_003, 28, 256, 2048, 1)):
        codes = torch.randint(0, nb, (n, d), generator=g, device=dev,
                              dtype=torch.uint8)
        rel = torch.randint(0, NL, (n + off,), generator=g, device=dev,
                            dtype=torch.int32)
        active = torch.rand((n + off,), generator=g, device=dev) < 0.8
        rel = torch.where(active, rel, torch.zeros_like(rel))
        rel, active, assign = rel[off:], active[off:], (rel + NL - 1)[off:]
        best_f = torch.randint(0, d, (NL,), generator=g, device=dev,
                               dtype=torch.int32)
        picks = torch.tensor([-5, -1, 0, 3, 254, 255, 300], device=dev,
                             dtype=torch.int32)
        best_t = picks[torch.randint(0, len(picks), (NL,), generator=g,
                                     device=dev)]
        split = torch.rand((NL,), generator=g, device=dev) < 0.7
        args = (codes, rel, active, assign, best_f, best_t, split)
        ref = tk.tree_route_level_ref(*args)
        codes_T = tk.feature_major(codes)
        check(torch.equal(codes_T, tk.feature_major_ref(codes)),
              f"feature_major differs: n={n} d={d}")
        for codes_T in (None, codes_T):
            check(torch.equal(tk.tree_route_level(*args, codes_T=codes_T),
                              ref),
                  f"tree_route_level differs: n={n} d={d} bins={nb} "
                  f"NL={NL} offset={off} codes_T={codes_T is not None}")
        cases.append({"n": n, "d": d, "n_bins": nb, "NL": NL,
                      "id_offset": off, "exact": True})
    return cases


def descend_cases(dev) -> list:
    """K3 against its plain version where the HIGGS case does not reach:
    a ragged n with d = 6 and 256 bins, codes starting off a 16-B
    boundary, a depth-12 forest whose tables take several chunks, rows
    of 128 and 300 bytes (the staged kernel with two rows a thread and
    with one), and a 784-wide row on the direct path; each twice, bit for
    bit. Its own seed, so the timed cases' inputs do not depend on
    these."""
    import torch

    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    g = torch.Generator(device=dev)
    g.manual_seed(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = []
    for n, d, nb, depth, T, off in ((1_000_003, 6, 256, 5, 3, 0),
                                    (100_000, 28, 32, 5, 20, 1),
                                    (200_003, 28, 32, 12, 20, 0),
                                    (100_003, 128, 32, 5, 3, 0),
                                    (100_003, 300, 32, 12, 5, 0),
                                    (100_003, 784, 2, 5, 3, 0)):
        M = 2 ** (depth + 1) - 1
        codes = torch.randint(0, nb, (n + off, d), generator=g, device=dev,
                              dtype=torch.uint8)[off:]
        feat = torch.randint(0, d, (T, M), generator=g, device=dev,
                             dtype=torch.int32)
        thr = torch.randint(-1, nb + 1, (T, M), generator=g, device=dev,
                            dtype=torch.int32)
        internal = torch.rand((T, M), generator=g, device=dev) < 0.9
        out = tk.tree_descend(codes, feat, thr, internal, max_depth=depth)
        what = f"n={n} d={d} bins={nb} depth={depth} T={T} offset={off}"
        check(torch.equal(out, tk.tree_descend_ref(codes, feat, thr,
                                                   internal,
                                                   max_depth=depth)),
              f"tree_descend differs: {what}")
        check(torch.equal(out, tk.tree_descend(codes, feat, thr, internal,
                                               max_depth=depth)),
              f"tree_descend: two calls differ: {what}")
        if d > 32:
            check(torch.equal(tk.feature_major(codes),
                              tk.feature_major_ref(codes)),
                  f"feature_major differs: n={n} d={d}")
        plan = tk.descend_plan(n, d, depth, T, sms)
        cases.append({"n": n, "d": d, "n_bins": nb, "depth": depth, "T": T,
                      "byte_offset": off * d, "staged": plan.staged,
                      "rows_per_thread": plan.rows_per_tile
                      // tk.DESCEND_THREADS, "chunks": plan.chunks,
                      "exact": True})
    check(cases[2]["chunks"] > 1 and cases[2]["staged"],
          "the depth-12 forest should take several staged chunks")
    for i, k in ((0, 4), (1, 4), (2, 4), (3, 2), (4, 1)):
        check(cases[i]["staged"] and cases[i]["rows_per_thread"] == k,
              f"descent case {i} should walk {k} rows a thread")
    check(not cases[5]["staged"], "d = 784 should take the direct path")
    return cases


def device_ms(fn, calls: int):
    """Device time per call of ``fn`` (kernels and copies, from
    ``torch.profiler``'s CUDA activity) and the profiled window's wall
    time per call; the device time is None where the profiler records
    no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total_us = 0.0
    for ev in prof.key_averages():
        total_us += getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
    return (total_us / 1e3 / calls if total_us > 0 else None,
            wall * 1e3 / calls)


def descend_request_cases(dev, forest, depth) -> dict:
    """K3 at the online tier's request sizes: the sweep's 20-tree forest
    and one of its trees over REQUEST_ROWS rows, from an aligned and an
    unaligned view (28 bytes in), bit for bit against the plain version
    and twice. Each call's time (back-to-back launches, CUDA events)
    beside its byte bound and, from the same run, the time of an empty
    launch (a one-element PyTorch kernel) and a synchronize round trip:
    at these sizes the launch and the wrapper's Python are the cost."""
    import torch

    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    g = torch.Generator(device=dev)
    g.manual_seed(4)
    d = 28
    pool = torch.randint(0, 32, (2 * max(REQUEST_ROWS) + 1, d),
                         generator=g, device=dev, dtype=torch.uint8)
    tiny = torch.zeros((1,), device=dev)
    empty_ms = time_ms(lambda: tiny.zero_(), 500, warmup=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - t0) * 1e3 / 500
    feat, thr, internal = forest
    cases = []
    for tables in ((feat, thr, internal), (feat[0], thr[0], internal[0])):
        T = 1 if tables[0].dim() == 1 else tables[0].shape[0]
        for n in REQUEST_ROWS:
            for off in (0, 1):
                codes = pool[off:off + n]
                what = f"request descent: T={T} n={n} row offset {off}"
                out = tk.tree_descend(codes, *tables, max_depth=depth)
                check(torch.equal(out, tk.tree_descend_ref(
                    codes, *tables, max_depth=depth)), f"{what} differs")
                check(torch.equal(out, tk.tree_descend(
                    codes, *tables, max_depth=depth)),
                    f"{what}: two calls differ")
            codes = pool[:n]
            M = tables[0].shape[-1]
            visits = descent_visits(
                codes, *(t.reshape(-1, M) for t in tables), depth)
            call = lambda: tk.tree_descend(  # noqa: E731
                codes, *tables, max_depth=depth)
            cases.append({
                "trees": T, "n": n, "exact": True, "unaligned_exact": True,
                "ms": time_ms(call, 500, warmup=10),
                # The kernel's own device time, apart from the wrapper.
                "kernel_device_ms": device_ms(call, 200)[0],
                "bound_ms": bound(sum(visits) + 4 * 3 * M * T
                                  + 4 * n * T)[0]})
    return {"empty_launch_ms": empty_ms, "sync_round_trip_ms": sync_ms,
            "cases": cases}


def check_small_reference(dev) -> None:
    """dt and gb fitted on the card and on the CPU from the same data."""
    import torch

    from benchmarks.workload import higgs_like_xy
    from learningorchestra_tpu_torch.config import Settings
    from learningorchestra_tpu_torch.models import trees
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

    X, y = higgs_like_xy(200_000, 3)
    cfg = Settings()
    gpu, cpu = DeviceRuntime(cfg, device=str(dev)), DeviceRuntime(
        cfg, device="cpu")
    dt_g = trees.fit_dt(gpu, X, y, 2)
    dt_c = trees.fit_dt(cpu, X, y, 2)
    for k in ("feat", "thr", "internal", "leaf"):
        check(torch.equal(dt_g.params[k].cpu(), dt_c.params[k]),
              f"dt {k} differs between the card and the CPU")
    gb_g = trees.fit_gb(gpu, X, y, 2, n_rounds=5)
    gb_c = trees.fit_gb(cpu, X, y, 2, n_rounds=5)
    Xt, _ = higgs_like_xy(20_000, 4)
    p_g = gb_g.predict_proba(gpu, Xt)
    p_c = gb_c.predict_proba(cpu, Xt)
    agree = float((p_g.argmax(1) == p_c.argmax(1)).mean())
    check(np.isfinite(p_g).all() and p_g.shape == (20_000, 2),
          "gb probabilities on the card: finite, (20000, 2)")
    check(agree >= 0.99, f"gb card/CPU class agreement {agree}")
    emit({"phase": "small_reference", "dt_trees_identical": True,
          "gb_class_agreement": agree,
          "gb_max_prob_diff": float(np.abs(p_g - p_c).max())})


def manifold_mix(n, d, rng, n_cls=10):
    """MNIST-60k stand-in (a copy of benchmarks/bench_scale.py's
    ``_manifold_mix``, which also returns the classes): each class a
    curved 10-D manifold embedded in d dims."""
    t = rng.normal(size=(n, 10)).astype(np.float32)
    cls = rng.integers(0, n_cls, n)
    X = np.zeros((n, d), np.float32)
    for c in range(n_cls):
        m = cls == c
        A = rng.normal(size=(10, d)).astype(np.float32) * 0.8
        B = rng.normal(size=(10, d)).astype(np.float32) * 0.4
        off = rng.normal(size=d).astype(np.float32) * 3.0
        X[m] = t[m] @ A + np.tanh(t[m]) @ B + off
    return X + rng.normal(size=(n, d)).astype(np.float32) * 0.2, cls


def check_tsne_kernel(dev) -> dict:
    """The repulsion kernel against its plain version at the 60k embed's
    shape, unpadded, and with invalid rows scattered; twice on the same
    inputs; and as two row halves."""
    import torch

    from learningorchestra_tpu_torch.ops import tsne_kernels as tsk

    n, nv = TSNE_PADDED, TSNE_ROWS
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def against_plain(Y, valid, what):
        Z, F = tsk.tsne_repulsion(Y, valid)
        Zr, Fr = tsk.tsne_repulsion_ref(Y, valid)
        f_tol = 1e-4 * float(Fr.abs().max())
        err = float((F - Fr).abs().max())
        check(abs(float(Z) - float(Zr)) <= 1e-4 * abs(float(Zr)),
              f"tsne_repulsion {what}: Z {float(Z)} vs plain {float(Zr)}")
        check(err <= f_tol, f"tsne_repulsion {what}: F err {err} > {f_tol}")
        return Z, F, Zr, f_tol, err

    # Spread like a late embedding (the explore line's embed_abs_max);
    # padding rows masked.
    Y = torch.randn((n, 2), generator=g, device=dev) * 10.0
    valid = (torch.arange(n, device=dev) < nv).float()
    Z, F, Zr, f_tol, err = against_plain(Y, valid, "60,416 rows")
    Z2, F2 = tsk.tsne_repulsion(Y, valid)
    check(torch.equal(Z, Z2) and torch.equal(F, F2),
          "tsne_repulsion: two calls differ")
    # No padding: a ragged last tile.
    ragged = against_plain(Y[:nv].contiguous(),
                           torch.ones((nv,), device=dev), "60,000 rows")
    # 1% of the rows invalid at random positions, parked at 0 as the
    # descent parks them.
    scattered = (torch.rand((n,), generator=g, device=dev) >= 0.01).float()
    Ys = Y * scattered[:, None]
    sc = against_plain(Ys, scattered, "scattered invalid rows")
    # The row form, over two halves.
    h = n // 2
    Z0, F0 = tsk.tsne_repulsion_rows(Y[:h], valid[:h], Y, valid, 0)
    Z1, F1 = tsk.tsne_repulsion_rows(Y[h:], valid[h:], Y, valid, h)
    split_err = float((torch.cat([F0, F1]) - F).abs().max())
    check(abs(float(Z0 + Z1) - float(Z)) <= 1e-5 * abs(float(Z)),
          f"row halves' Z {float(Z0 + Z1)} vs whole {float(Z)}")
    check(split_err <= f_tol, f"row halves' F err {split_err}")
    # Needed bytes: Y and valid read once, F and Z written once. Needed
    # operations: each unordered pair of valid rows once.
    pairs = nv * (nv - 1) / 2
    b_ms, b_by = bound(20 * n + 4, TSNE_OPS_PER_PAIR * pairs)
    ordered_ms, _ = bound(20 * n + 4,
                          TSNE_OPS_PER_ORDERED_PAIR * 2 * pairs)
    # The row form over every row: all of it is its own block, each
    # unordered pair once, so its bound is the whole form's.
    Zq, Fq = tsk.tsne_repulsion_rows(Y, valid, Y, valid, 0)
    Zqr, Fqr = tsk.tsne_repulsion_rows_ref(Y, valid, Y, valid, 0)
    check(abs(float(Zq) - float(Zqr)) <= 1e-4 * abs(float(Zqr)),
          f"row form over every row: Z {float(Zq)} vs plain {float(Zqr)}")
    rows_form = {
        "rows_form_max_abs_err": float((Fq - Fqr).abs().max()),
        "rows_form_plain_ms": time_ms(lambda: tsk.tsne_repulsion_rows_ref(
            Y, valid, Y, valid, 0), 3),
        "rows_form_bound_ms": b_ms, "rows_form_bound_by": b_by}
    check(rows_form["rows_form_max_abs_err"] <= f_tol,
          f"row form over every row: F err {rows_form}")
    result = {"max_abs_err": err, "ms": time_ms(
        lambda: tsk.tsne_repulsion(Y, valid), 50),
        "plain_ms": time_ms(lambda: tsk.tsne_repulsion_ref(Y, valid), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    emit({"phase": "kernel", "name": "tsne_repulsion", "n": n,
          "n_valid": nv, "Z": float(Z), "Z_plain": float(Zr),
          "f_tol": f_tol, "ragged_max_abs_err": ragged[4],
          "ragged_f_tol": ragged[3], "scattered_invalid": int(
              (scattered == 0).sum()),
          "scattered_max_abs_err": sc[4], "scattered_f_tol": sc[3],
          "halves_Z": float(Z0 + Z1), "halves_max_abs_err": split_err,
          # The direct (row-range) form over the whole embedding, timed
          # in the same run, and the ordered-pair bound it was held to.
          "rows_form_ms": time_ms(
              lambda: tsk.tsne_repulsion_rows(Y, valid, Y, valid, 0), 20),
          "ordered_pair_bound_ms": ordered_ms, **rows_form, **result})
    return result


def check_fixed_forms(n: int, dev) -> dict:
    """The histogram kernel's fixed-point forms (the pod's K1 launches)
    at one rank's shape of the pod sweep (n rows): the int64 totals equal
    the plain version's integers; ``fixed_to_float`` of them is the float
    launch bit for bit, and so is the sum of two row halves' totals (two
    ranks' shards at one scale). Returns the fields the K1 kernel lines
    carry."""
    import torch

    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    d, nb, depth, S = 28, 32, 5, 2
    NL, M = 2 ** (depth - 1), 2 ** (depth + 1) - 1
    codes = torch.randint(0, nb, (n, d), generator=g, device=dev,
                          dtype=torch.uint8)[None]
    rel = torch.randint(0, NL, (1, n), generator=g, device=dev,
                        dtype=torch.int32)
    active = torch.rand((1, n), generator=g, device=dev) < 0.9
    stats = torch.randn((1, S, n), generator=g, device=dev)
    assign = torch.randint(0, M, (1, n), generator=g, device=dev,
                           dtype=torch.int32)
    max_abs = tk.stat_max_abs(stats)
    kw = dict(n_nodes=NL, n_bins=nb, max_abs=max_abs)
    fixed = tk.tree_histogram_fixed(codes, (0,), stats, rel, active, **kw)
    check(torch.equal(fixed, tk.tree_histogram_fixed_ref(
        codes, (0,), stats, rel, active, **kw)),
        "tree_histogram_fixed: totals differ from the plain version's")
    check(torch.equal(tk.fixed_to_float(fixed, max_abs),
                      tk.tree_histogram_slices(codes, (0,), stats, rel,
                                               active, **kw)),
          "tree_histogram_fixed: converted totals differ from the float "
          "launch")
    h = n // 2
    halves = [tk.tree_histogram_fixed(
        codes[:, a:b], (0,), stats[:, :, a:b].contiguous(), rel[:, a:b],
        active[:, a:b], **kw) for a, b in ((0, h), (h, n))]
    check(torch.equal(halves[0] + halves[1], fixed),
          "tree_histogram_fixed: two halves' totals do not add up")
    lfixed = tk.tree_leaf_stats_fixed(assign, stats, n_nodes=M,
                                      max_abs=max_abs)
    check(torch.equal(lfixed, tk.tree_leaf_stats_fixed_ref(
        assign, stats, n_nodes=M, max_abs=max_abs)),
        "tree_leaf_stats_fixed: totals differ from the plain version's")
    check(torch.equal(tk.fixed_to_float(lfixed, max_abs),
                      tk.tree_leaf_stats_slices(assign, stats, n_nodes=M,
                                                max_abs=max_abs)
                      .transpose(1, 2)),
          "tree_leaf_stats_fixed: converted totals differ")
    doc = {"rows": n,
           "hist_fixed_ms": time_ms(lambda: tk.tree_histogram_fixed(
               codes, (0,), stats, rel, active, **kw), 10),
           "hist_float_ms": time_ms(lambda: tk.tree_histogram_slices(
               codes, (0,), stats, rel, active, **kw), 10),
           "leaf_fixed_ms": time_ms(lambda: tk.tree_leaf_stats_fixed(
               assign, stats, n_nodes=M, max_abs=max_abs), 10),
           "leaf_fixed_device_ms": device_ms(
               lambda: tk.tree_leaf_stats_fixed(
                   assign, stats, n_nodes=M, max_abs=max_abs), 20)[0]}
    emit({"phase": "kernel", "name": "tree_histogram_fixed", "exact": True,
          **doc})
    return doc


def check_concurrent_launches(dev) -> None:
    """Two host threads launch the histogram kernel at once, as the
    builder's concurrent fits do, one at 4 live nodes and one at 16 (two
    dynamic shared-memory sizes past the default 48 KiB, one kernel):
    every launch succeeds and equals its single-thread result."""
    import threading

    import torch

    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    g = torch.Generator(device=dev)
    g.manual_seed(3)
    n, d, nb, NL, S = CONCURRENT_ROWS, 28, 32, 32, 2
    codes = torch.randint(0, nb, (1, n, d), generator=g, device=dev,
                          dtype=torch.uint8)
    stats = torch.randn((1, S, n), generator=g, device=dev)
    active = torch.ones((1, n), dtype=torch.bool, device=dev)
    cases = []
    for n_live in (4, 16):
        rel = torch.randint(0, n_live, (1, n), generator=g, device=dev,
                            dtype=torch.int32)
        plan_args = (n, d, nb, S, NL, tk._num_sms(dev))
        plan = tk.hist_plan(*plan_args, n_live=n_live)
        smem = tk.hist_smem_bytes(plan.NG, plan.CG, S, tk.hist_grid(
            *plan_args, n_live=n_live).replicas)
        check(smem > 48 * 1024, f"n_live {n_live}: {smem} B of shared "
              "memory do not need the kernel's raised cap")

        def launch(rel=rel, n_live=n_live):
            return tk.tree_histogram_slices(codes, (0,), stats, rel, active,
                                            n_nodes=NL, n_bins=nb,
                                            n_live=n_live)
        cases.append((launch, launch(), smem))
    errors, bad = [], torch.zeros((), dtype=torch.int64, device=dev)
    lock = threading.Lock()

    def worker(launch, ref):
        try:
            mism = torch.zeros((), dtype=torch.int64, device=dev)
            for _ in range(CONCURRENT_LAUNCHES):
                mism += (launch() != ref).any()
            torch.cuda.synchronize()
            with lock:
                bad.add_(mism)
        except Exception as e:  # reported below, with the other thread's
            errors.append(repr(e))
    t0 = time.time()
    threads = [threading.Thread(target=worker, args=c[:2]) for c in cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.time() - t0
    check(not errors, f"concurrent histogram launches failed: {errors}")
    check(int(bad) == 0, f"{int(bad)} concurrent histogram launches differ "
          "from their single-thread results")
    emit({"phase": "kernel", "name": "tree_histogram_concurrent",
          "threads": len(cases), "launches_a_thread": CONCURRENT_LAUNCHES,
          "rows": n, "smem_bytes": [c[2] for c in cases], "exact": True,
          "seconds": seconds})


def check_rows_kernel(dev) -> dict:
    """The t-SNE row form at the pod's shapes: the 60,000 rows padded to
    whole tiles on every rank (61,440 = 30 × 1,024 × 2, viz/tsne.py),
    each rank's half against all of them, against its plain version,
    twice for the same bits, and timed; a query block that is not a view
    of Y is refused."""
    import torch

    from learningorchestra_tpu_torch.ops import tsne_kernels as tsk

    per = 1024 * POD_RANKS
    n, nv = -(-TSNE_ROWS // per) * per, TSNE_ROWS
    h = n // POD_RANKS
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    Y = torch.randn((n, 2), generator=g, device=dev) * 10.0
    valid = (torch.arange(n, device=dev) < nv).float()
    halves = []
    for off in range(0, n, h):
        Yq, vq = Y[off:off + h], valid[off:off + h]
        Zq, Fq = tsk.tsne_repulsion_rows(Yq, vq, Y, valid, off)
        Zr, Fr = tsk.tsne_repulsion_rows_ref(Yq, vq, Y, valid, off)
        f_tol = 1e-4 * float(Fr.abs().max())
        err = float((Fq - Fr).abs().max())
        check(abs(float(Zq) - float(Zr)) <= 1e-4 * abs(float(Zr)),
              f"tsne_repulsion_rows at {off}: Z {float(Zq)} vs "
              f"{float(Zr)}")
        check(err <= f_tol, f"tsne_repulsion_rows at {off}: F err "
              f"{err} > {f_tol}")
        Z2, F2 = tsk.tsne_repulsion_rows(Yq, vq, Y, valid, off)
        check(torch.equal(Zq, Z2) and torch.equal(Fq, F2),
              f"tsne_repulsion_rows at {off}: two calls differ")
        # Bytes: Y and its flags read once (the query rows are Y's), F and
        # Z written once. Operations: 13 a (valid query row, valid foreign
        # row) pair, 17 a valid unordered pair of the own block, as the
        # kernel takes them; beside it the direct form's ordered-pair
        # count, 14 a (valid query row, valid row) pair.
        q_valid = int(vq.sum())
        pairs_own = q_valid * (q_valid - 1) / 2
        nbytes = 12 * n + 8 * h + 4
        b_ms, b_by = bound(nbytes, TSNE_OPS_PER_FOREIGN_PAIR * q_valid
                           * (nv - q_valid) + TSNE_OPS_PER_PAIR * pairs_own)
        ordered_ms, _ = bound(nbytes,
                              TSNE_OPS_PER_ORDERED_PAIR * q_valid * nv)
        halves.append({
            "offset": off, "valid_query_rows": q_valid, "max_abs_err": err,
            "f_tol": f_tol,
            "ms": time_ms(lambda: tsk.tsne_repulsion_rows(
                Yq, vq, Y, valid, off), 20),
            "plain_ms": time_ms(lambda: tsk.tsne_repulsion_rows_ref(
                Yq, vq, Y, valid, off), 3),
            "bound_ms": b_ms, "bound_by": b_by,
            "ordered_pair_bound_ms": ordered_ms})
    before = tsk.launch_counts()["tsne_repulsion_rows"]
    for what, Yq, vq, off in (
            ("a copy", Y[:h].clone(), valid[:h], 0),
            ("a wrong offset", Y[:h], valid[:h], 1),
            ("a strided block", Y[:2 * h:2], valid[:h], 0)):
        try:
            tsk.tsne_repulsion_rows(Yq, vq, Y, valid, off)
        except ValueError:
            continue
        check(False, f"tsne_repulsion_rows took {what} as its query rows")
    check(tsk.launch_counts()["tsne_repulsion_rows"] == before,
          "a refused row-form call launched")
    # The kernel line's time and bound are rank 0's half (every valid
    # query row); both halves are in "halves".
    result = {k: halves[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "ordered_pair_bound_ms")}
    result.update({"max_abs_err": max(x["max_abs_err"] for x in halves),
                   "library_ms": None, "halves": halves})
    emit({"phase": "kernel", "name": "tsne_repulsion_rows", "rows": h,
          "against": n, "non_views_refused": 3, **result})
    return result


def exact_joint_P(X, perplexity: float):
    """Exact symmetrized t-SNE affinities in float64 on X's device: full
    pairwise distances and a per-row bisection, as tests/test_viz.py's
    numpy yardstick computes them, all rows at once."""
    import torch

    n = X.shape[0]
    sq = (X * X).sum(1)
    D = (sq[:, None] + sq[None, :] - 2.0 * (X @ X.T)).clamp_min(0.0)
    off = 1.0 - torch.eye(n, dtype=X.dtype, device=X.device)
    D = D * off
    target = float(np.log(perplexity))
    lo = torch.zeros(n, dtype=X.dtype, device=X.device)
    hi = torch.full((n,), float("inf"), dtype=X.dtype, device=X.device)
    beta = torch.ones(n, dtype=X.dtype, device=X.device)
    for _ in range(60):
        w = torch.exp(-D * beta[:, None]) * off
        s = w.sum(1)
        h = torch.log(s) + beta * (D * w).sum(1) / s
        high = h > target
        lo = torch.where(high, beta, lo)
        hi = torch.where(high, hi, beta)
        beta = torch.where(high & torch.isinf(hi), beta * 2.0,
                           (lo + hi) / 2.0)
    P = w / s[:, None]
    return ((P + P.T) / (2.0 * n)).clamp_min(1e-12)


def kl_divergence(P, Y):
    """KL(P || Q) of an embedding under affinities P (float64)."""
    import torch

    Y = Y.to(P)
    sq = (Y * Y).sum(1)
    q = 1.0 / (1.0 + (sq[:, None] + sq[None, :] - 2.0 * (Y @ Y.T))
               .clamp_min(0.0))
    q.fill_diagonal_(0.0)
    Q = (q / q.sum()).clamp_min(1e-12)
    return float((P * (torch.log(P) - torch.log(Q))).sum())


def check_tsne_small_reference(dev) -> None:
    """t-SNE on 2,048 rows on the card (kernel) and on the CPU (plain)."""
    import torch

    from learningorchestra_tpu_torch.config import Settings
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
    from learningorchestra_tpu_torch.viz import tsne as tt

    n = 2048
    X, _ = manifold_mix(n, TSNE_DIMS, np.random.default_rng(1))
    cfg = Settings()
    gpu, cpu = DeviceRuntime(cfg, device=str(dev)), DeviceRuntime(
        cfg, device="cpu")
    # One step from the same state and edge table, built on the CPU from
    # the first 50 columns.
    Xc = torch.from_numpy(X[:, :50].copy())
    d2k, idx = tt._knn(Xc, k=90, tile=1024)
    P = tt._calibrate(d2k, 30.0)
    table = [a.numpy() for a in tt._edge_table(idx, P, n, n)]
    rng = np.random.default_rng(2)
    state = [rng.normal(scale=1e-2, size=(n, 2)).astype(np.float32),
             rng.normal(scale=1e-3, size=(n, 2)).astype(np.float32),
             rng.uniform(0.5, 2.0, size=(n, 2)).astype(np.float32)]
    args = [*state, *table]

    def one_step(rt):
        on = [rt.replicate(a) for a in args]
        seg = tt._overflow_segments(on[6]) if len(table[3]) else None
        return [t.cpu().numpy() for t in tt._step(
            *on, n, 12.0, 200.0, 0.5, ov_seg=seg)]

    card, host = one_step(gpu), one_step(cpu)
    step_diff = {}
    for name, a, b in zip(("Y", "vel", "gains"), card, host):
        step_diff[name] = float(np.abs(a - b).max())
        check(np.allclose(a, b, rtol=1e-4, atol=1e-6),
              f"t-SNE step {name}: card vs CPU max diff {step_diff[name]}")
    kw = dict(iters=300, exaggeration_iters=100)
    emb_g = tt.tsne_embed(gpu, X, **kw)
    emb_c = tt.tsne_embed(cpu, X, **kw)
    check(np.isfinite(emb_g).all() and emb_g.shape == (n, 2),
          "t-SNE on the card: finite, (2048, 2)")
    Pe = exact_joint_P(torch.from_numpy(X).to(dev).double(), 30.0)
    kl_g = kl_divergence(Pe, torch.from_numpy(emb_g))
    kl_c = kl_divergence(Pe, torch.from_numpy(emb_c))
    check(abs(kl_g - kl_c) <= 0.03 * kl_c,
          f"t-SNE KL card {kl_g} vs CPU {kl_c}")
    emit({"phase": "tsne_small_reference", "rows": n,
          "step_max_diff": step_diff, "kl_card": kl_g, "kl_cpu": kl_c})


def knn_class_agreement(emb: np.ndarray, cls: np.ndarray, dev,
                        k: int = 10) -> float:
    """Share of each row's k nearest rows (Euclidean, among the rows
    given) that have its class."""
    import torch

    E = torch.from_numpy(np.ascontiguousarray(emb, np.float32)).to(dev)
    d = torch.cdist(E, E)
    d.fill_diagonal_(float("inf"))
    nn = d.topk(k, largest=False).indices.cpu().numpy()
    return float((cls[nn] == cls[:, None]).mean())


def explore_path(store, runtime, dev) -> dict:
    """Projection → coercion → histogram → PCA → t-SNE through the
    package's entry points, in the sweep's catalog. Returns the kernel
    launches of the run."""
    import torch

    from learningorchestra_tpu_torch.ops import tsne_kernels as tsk
    from learningorchestra_tpu_torch.ops.dtypes import convert_fields
    from learningorchestra_tpu_torch.ops.histogram import create_histogram
    from learningorchestra_tpu_torch.ops.preprocess import design_matrix
    from learningorchestra_tpu_torch.ops.projection import create_projection
    from learningorchestra_tpu_torch.utils import tracing
    from learningorchestra_tpu_torch.viz.service import embed_dataset

    Xm, cls = manifold_mix(TSNE_ROWS, TSNE_DIMS, np.random.default_rng(0))
    store.create("mnist_like", columns={
        **{f"p{i}": Xm[:, i] for i in range(TSNE_DIMS)},
        "label": cls.astype(np.int64)}, finished=True)
    del Xm
    train = store.get("train")
    doc = {"phase": "explore"}
    torch.cuda.synchronize()
    tsk.reset_launch_counts()

    fields = ["f10", "f11", "f12", "f13", "label"]
    t0 = time.time()
    create_projection(store, "train", "train_proj", fields)
    doc["projection_s"] = time.time() - t0
    proj = store.get("train_proj")
    check(proj.metadata.finished and proj.metadata.fields == fields
          and proj.metadata.parent == "train", "projection metadata")
    for f in fields:
        check(np.array_equal(proj.columns[f], train.columns[f]),
              f"projected column {f} differs from the parent's")

    t0 = time.time()
    convert_fields(store, "train_proj", {"label": "string"})
    check(proj.columns["label"].dtype == object, "label coerced to string")
    convert_fields(store, "train_proj", {"label": "number"})
    doc["coercion_s"] = time.time() - t0
    back = proj.columns["label"]
    check(back.dtype == np.int64
          and np.array_equal(back, train.columns["label"]),
          "label → string → number is not the original column")

    t0 = time.time()
    create_histogram(store, "train", "hist_train", ["label"])
    create_histogram(store, "pred_gb", "hist_pred", ["label", "prediction"])
    doc["histogram_s"] = time.time() - t0
    for name, parent in (("hist_train", "train"), ("hist_pred", "pred_gb")):
        hist = store.get(name)
        for f, counts in zip(hist.columns["field"], hist.columns["counts"]):
            col = store.get(parent).columns[f]
            want = {int(v): int(c) for v, c in enumerate(np.bincount(col))
                    if c}
            check(counts == want, f"{name} {f}: {counts} != {want}")

    t0 = time.time()
    emb_pca, _ = embed_dataset(store, runtime, "pca", "train", label="label")
    doc["pca_s"] = time.time() - t0
    X, _, _, _ = design_matrix(train, "label")
    X64 = X.astype(np.float64)
    del X
    X64 -= X64.mean(axis=0)
    _, evecs = np.linalg.eigh(X64.T @ X64 / len(X64))
    ref = X64 @ evecs[:, ::-1][:, :2]
    del X64
    corr = [abs(float(np.corrcoef(emb_pca[:, j], ref[:, j])[0, 1]))
            for j in range(2)]
    doc["pca_abs_corr"] = corr
    check(min(corr) > 0.9999, f"PCA vs float64 numpy PCA: |corr| {corr}")
    del emb_pca, ref

    t0 = time.time()
    with tracing.trace("chip_smoke.tsne", sampled=True) as ctx:
        emb, labels = embed_dataset(store, runtime, "tsne", "mnist_like",
                                    label="label")
    doc["embed_s"] = time.time() - t0
    counts = tsk.launch_counts()
    # The same embed again, same seed and catalog: the same bits.
    t0 = time.time()
    emb2, _ = embed_dataset(store, runtime, "tsne", "mnist_like",
                            label="label")
    doc["embed_again_s"] = time.time() - t0
    spans = {}
    overflow = None
    for sp in tracing.spans_for(ctx.trace_id):
        if sp["name"].startswith("viz."):
            spans[sp["name"]] = (spans.get(sp["name"], 0.0)
                                 + sp["duration_ms"] / 1e3)
        if sp["name"] == "viz.descent":
            overflow = sp["attrs"]["overflow_edges"]
    doc["embed_spans_s"] = spans
    repeat = {"equal": bool(np.array_equal(emb, emb2)),
              "overflow_edges": overflow}
    if not repeat["equal"]:
        repeat["max_abs_diff"] = float(np.abs(emb - emb2).max())
    check(repeat["equal"], "two one-card t-SNE embeds of one dataset and "
          f"seed differ: {repeat}")
    again = tsk.launch_counts()
    check(again["tsne_repulsion"] == 1500,
          f"repulsion launches {again} != 750 per embed over two")
    check(emb.shape == (TSNE_ROWS, 2) and np.isfinite(emb).all(),
          "t-SNE embedding: finite, (60000, 2)")
    check(counts["tsne_repulsion"] == 750,
          f"repulsion launches {counts} != one per iteration (750)")
    emb_pca2, _ = embed_dataset(store, runtime, "pca", "mnist_like",
                                label="label")
    rows = np.random.default_rng(3).choice(TSNE_ROWS, min(5000, TSNE_ROWS),
                                           replace=False)
    agree = knn_class_agreement(emb[rows], labels[rows], dev)
    agree_pca = knn_class_agreement(emb_pca2[rows], labels[rows], dev)
    check(agree > agree_pca,
          f"t-SNE 10-NN agreement {agree} <= PCA-2's {agree_pca}")
    # The card's machine has no matplotlib or seaborn, so the PNG step of
    # create_embedding_image is checked by the CPU tests; the embed runs
    # here through the service's own embed_dataset.
    emit({**doc, "embed_abs_max": float(np.abs(emb).max()),
          "knn10_agreement": agree, "knn10_agreement_pca2": agree_pca,
          "tsne_repeat": repeat, "launches": again})
    return again


class JsonHttp:
    """A keep-alive JSON client on the standard library (the card's
    machine may have no ``requests``); one per thread."""

    def __init__(self, port: int):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=600)

    def call(self, method: str, path: str, body=None):
        data = None if body is None else json.dumps(body).encode()
        status, raw, _ = self.call_raw(method, path, data,
                                       "application/json")
        return status, (json.loads(raw) if raw else None)

    def call_raw(self, method: str, path: str, data, content_type: str):
        """One request with a body of bytes; returns the status, the
        body's bytes and its content type."""
        self.conn.request(method, path, body=data,
                          headers={"Content-Type": content_type})
        resp = self.conn.getresponse()
        raw = resp.read()
        return resp.status, raw, resp.getheader("Content-Type") or ""

    def close(self) -> None:
        self.conn.close()


def wait_finished(client: JsonHttp, name: str,
                  timeout_s: float = 900.0) -> dict:
    """Poll ``GET /files/{name}`` until its metadata is ``finished``, as
    the client SDK does; a failed job fails the run."""
    t0 = time.time()
    while True:
        status, docs = client.call("GET", f"/files/{name}?limit=1")
        if status == 200 and docs and docs[0].get("finished"):
            check(not docs[0].get("error"),
                  f"{name} failed: {docs[0].get('error')}")
            return docs[0]
        check(status in (200, 404), f"GET /files/{name}: {status} {docs}")
        check(time.time() - t0 < timeout_s, f"{name} never finished")
        time.sleep(0.25)


def _percentile_ms(seconds, q):
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def serve_path(cfg, store, dev):
    """The REST server on the sweep's catalog: fits through ``POST
    /models``, online requests checked bit for bit, the predictions
    route, and the serving metrics. Returns the kernel launches of the
    phase (fit, online and predictions) and what the workers phase
    reuses: the request rows, their one-row oracle, each family's rows/s
    under the load, and the served sweep's job record."""
    import threading

    import torch

    from learningorchestra_tpu_torch.models.aot import design_from_rows
    from learningorchestra_tpu_torch.ops import tree_kernels as tk
    from learningorchestra_tpu_torch.serving.app import App

    families = ["lr", "dt", "rf", "gb", "nb"]
    t0 = time.time()
    # A queue that holds every client thread's largest request at once:
    # the load is closed-loop, so no request is ever turned away.
    app = App(cfg.replace(host="127.0.0.1", port=0,
                          serve_queue_depth=SERVE_THREADS * max(SERVE_SIZES)),
              device=str(dev))
    recover_s = time.time() - t0
    server = app.serve(background=True)
    phase = {}
    try:
        client = JsonHttp(server.port)
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        t0 = time.time()
        status, body = client.call("POST", "/models", {
            "training_filename": "train", "test_filename": "test",
            "prediction_filename": "srv", "classificators_list": families,
            "label": "label", "sync": False})
        check(status == 201, f"POST /models: {status} {body}")
        acc = {c: wait_finished(client, f"srv_{c}")["accuracy"]
               for c in families}
        fit_s = time.time() - t0
        phase["fit"] = tk.launch_counts()
        for c, floor in ACC_FLOOR.items():
            check(acc[c] > floor, f"served fit {c}: accuracy {acc[c]} "
                  f"<= {floor}")
        # The job's record settles after its datasets finish (its
        # resource window closes last): wait for it.
        while True:
            status, jobs_doc = client.call("GET", "/jobs")
            sweep_job = [j for j in jobs_doc
                         if j["kind"] == "model_builder"]
            check(status == 200 and len(sweep_job) == 1,
                  f"GET /jobs: one model_builder job, got {jobs_doc}")
            if sweep_job[0]["status"] != "running":
                break
            check(time.time() - t0 < 900, "the served sweep job never ended")
            time.sleep(0.1)
        check(sweep_job[0]["status"] == "done", f"sweep job {sweep_job}")
        status, listed = client.call("GET", "/trained-models")
        names = {m["name"] for m in listed}
        check(status == 200 and all(f"srv_{c}" in names for c in families),
              f"GET /trained-models lacks the served fits: {sorted(names)}")

        # The request rows: the first SERVE_POOL test rows as raw
        # records; each row's one-row oracle through the batch path.
        test = store.get("test")
        fields = [f for f in test.metadata.fields if f != "label"]
        pool = [{f: float(test.columns[f][i]) for f in fields}
                for i in range(SERVE_POOL)]
        oracle = {}
        for c in families:
            man, model = app.builder.registry.load(f"srv_{c}")
            X = design_from_rows(pool, man["preprocess"])
            oracle[c] = np.concatenate(
                [model.predict_proba(app.runtime, X[i:i + 1])
                 for i in range(SERVE_POOL)])
        answers = {c: [] for c in families}     # (offset, probs)

        def ask(conn, c, off, size, lat=None):
            t = time.perf_counter()
            status, out = conn.call(
                "POST", f"/trained-models/srv_{c}/predict",
                {"rows": pool[off:off + size]})
            if lat is not None:
                lat.append(time.perf_counter() - t)
            check(status == 200, f"predict srv_{c} ({size} rows): "
                  f"{status} {out}")
            probs = np.asarray(out["probabilities"], np.float32)
            check(probs.shape == (size, oracle[c].shape[1]),
                  f"srv_{c}: {probs.shape} for {size} rows")
            check(out["predictions"] == np.argmax(probs, 1).tolist(),
                  f"srv_{c}: predictions are not the argmax")
            check(np.array_equal(probs, oracle[c][off:off + size]),
                  f"srv_{c}: {size} rows at {off} differ from the one-row "
                  "batch path")
            answers[c].append((off, probs))
            return size

        torch.cuda.synchronize()
        tk.reset_launch_counts()
        sent = {c: 0 for c in families}
        fam_doc = {}
        for c in families:
            t = time.perf_counter()
            sent[c] += ask(client, c, 0, 1)       # loads and warms
            first_s = time.perf_counter() - t
            for size in SERVE_SIZES:
                sent[c] += ask(client, c, SERVE_POOL - size, size)
            lat1, lat64 = [], []
            for i in range(SERVE_LATENCY_REQUESTS):
                sent[c] += ask(client, c, i, 1, lat1)
                sent[c] += ask(client, c, i, 64, lat64)
            _, m0 = client.call("GET", "/metrics")
            before = m0["serving"]["models"][f"srv_{c}"]
            rows_conc = [0] * SERVE_THREADS

            def load(k, c=c, rows_conc=rows_conc):
                rng = np.random.default_rng(100 + k)
                conn = JsonHttp(server.port)
                try:
                    for _ in range(SERVE_REQUESTS):
                        size = int(rng.choice(SERVE_SIZES))
                        off = int(rng.integers(0, SERVE_POOL - size + 1))
                        rows_conc[k] += ask(conn, c, off, size)
                finally:
                    conn.close()

            errors = []

            def guarded(k):
                try:
                    load(k)
                except Exception as exc:  # noqa: BLE001 — reported below
                    errors.append(f"{type(exc).__name__}: {exc}")

            threads = [threading.Thread(target=guarded, args=(k,))
                       for k in range(SERVE_THREADS)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            conc_s = time.perf_counter() - t
            check(not errors and not any(th.is_alive() for th in threads),
                  f"srv_{c} concurrent load: {errors[:3]}")
            sent[c] += sum(rows_conc)
            _, m1 = client.call("GET", "/metrics")
            after = m1["serving"]["models"][f"srv_{c}"]
            batches = after["batches"] - before["batches"]
            # Sequential 64-row requests under the profiler: the device's
            # busy time a request beside the request's wall time.
            busy_ms, wall_ms = device_ms(
                lambda: ask(client, c, 0, 64), SERVE_LATENCY_REQUESTS)
            sent[c] += 64 * SERVE_LATENCY_REQUESTS
            fam_doc[c] = {
                "first_request_s": first_s,
                "p50_ms_1row": _percentile_ms(lat1, 50),
                "p99_ms_1row": _percentile_ms(lat1, 99),
                "p50_ms_64rows": _percentile_ms(lat64, 50),
                "p99_ms_64rows": _percentile_ms(lat64, 99),
                "concurrent_rows_per_s": sum(rows_conc) / conc_s,
                "concurrent_requests_per_s":
                    SERVE_THREADS * SERVE_REQUESTS / conc_s,
                "concurrent_mean_batch_rows":
                    (after["batched_rows"] - before["batched_rows"])
                    / max(batches, 1),
                "concurrent_batches": batches,
                "profiled_64rows": {
                    "device_ms_per_request": busy_ms,
                    "wall_ms_per_request": wall_ms,
                    "device_busy_share": (None if busy_ms is None
                                          else busy_ms / wall_ms)},
                "compile_wall_s": app.predictor.aot.entry(
                    f"srv_{c}").compile_wall_s}
        torch.cuda.synchronize()
        phase["online"] = tk.launch_counts()
        check(phase["online"]["tree_descend"] > 0,
              "tree_descend was not launched by the online phase")

        # The batch predictions route on the whole test set; every
        # online answer is the same bytes as its rows there.
        tk.reset_launch_counts()
        for c in families:
            status, body = client.call(
                "POST", f"/trained-models/srv_{c}/predictions",
                {"dataset_name": "test",
                 "prediction_filename": f"srv_{c}_again"})
            check(status == 201, f"predictions srv_{c}: {status} {body}")
        for c in families:
            wait_finished(client, f"srv_{c}_again")
            ds = app.store.get(f"srv_{c}_again")
            check(ds.num_rows == len(test.columns["label"]),
                  f"srv_{c}_again: {ds.num_rows} rows")
            batch = np.array(list(ds.columns["probability"][:SERVE_POOL]),
                             np.float32)
            for off, probs in answers[c]:
                check(np.array_equal(probs, batch[off:off + len(probs)]),
                      f"srv_{c}: online rows at {off} differ from the "
                      "predictions dataset")
        phase["predictions"] = tk.launch_counts()

        status, metrics = client.call("GET", "/metrics")
        srv = metrics["serving"]
        check(status == 200 and srv["batches"] > 0, "no serving batches")
        for key in ("rejected", "errors", "timeouts", "deadline_exceeded",
                    "dispatcher_restarts"):
            check(srv[key] == 0, f"serving {key} = {srv[key]}")
        for c in families:
            per = srv["models"][f"srv_{c}"]
            check(per["rows"] == sent[c] == per["batched_rows"]
                  == sum(len(p) for _, p in answers[c]),
                  f"srv_{c}: rows {per['rows']} batched "
                  f"{per['batched_rows']} sent {sent[c]}")
        check(srv["rows"] == sum(sent.values()), "serving rows total")
        # Where a request's time goes, per model: the span taxonomy's
        # means (design on the handler thread, queue wait, the device
        # dispatch, the whole coalesced batch, the whole HTTP request).
        attribution = {
            phase_name: {k: v["mean_ms"] for k, v in by_label.items()
                         if k.startswith("srv_") or "predict" in k}
            for phase_name, by_label in metrics["latency_attribution"]
            .items() if phase_name in ("design.build", "queue.wait",
                                       "dispatch.device", "batch.coalesce",
                                       "http.handle")}
        emit({"phase": "serve", "card": card_line(),
              "mean_ms_by_span": attribution,
              "recover_s": recover_s, "fit_s": fit_s, "accuracy": acc,
              "requests": srv["requests"], "rows": srv["rows"],
              "batches": srv["batches"],
              "mean_batch_rows": srv["mean_batch_rows"],
              "aot": srv["aot"], "families": fam_doc,
              "launches_fit": phase["fit"],
              "launches_online": phase["online"],
              "launches_predictions": phase["predictions"]})
        client.close()
    finally:
        try:
            app.drain(timeout_s=60.0)
        finally:
            server.stop()
    context = {"pool": pool, "oracle": oracle, "sweep_job": sweep_job[0],
               "rows_per_s": {c: fam_doc[c]["concurrent_rows_per_s"]
                              for c in families}}
    return ({k: sum(p[k] for p in phase.values()) for k in phase["fit"]},
            context)


def serve_workers_path(cfg, dev, ctx: dict) -> dict:
    """The REST server again on the same catalog and saved ``srv_*``
    models, behind ``SERVE_WORKERS`` front-end worker processes: the
    serve phase's request rows in three body kinds, every probability
    row bit-identical to the serve phase's one-row oracle, every row
    counted once and none rejected; latency and rows/s per family and
    body kind beside the one-worker phase's rows/s. Then, through the
    workers, the resource plane (``/resources`` from the allocator's
    counters, the served sweep's job watermarks, the compile counts, a
    ``POST /debug/profile`` capture during a load holding the descent
    kernel) and the observability planes (Prometheus text, the status
    page, alerts, history, a flight-recorder bundle). Returns the kernel
    launches of the phase."""
    import threading

    import torch

    from learningorchestra_tpu_torch.models.aot import design_from_rows
    from learningorchestra_tpu_torch.ops import tree_kernels as tk
    from learningorchestra_tpu_torch.serving import rowchannel
    from learningorchestra_tpu_torch.serving.app import App
    from learningorchestra_tpu_torch.serving.frontend import FrontendServer

    families = ["lr", "dt", "rf", "gb", "nb"]
    pool, oracle = ctx["pool"], ctx["oracle"]
    app = App(cfg.replace(host="127.0.0.1", port=0,
                          http_workers=SERVE_WORKERS,
                          serve_queue_depth=SERVE_THREADS * max(SERVE_SIZES),
                          debug_profile=True), device=str(dev))
    t0 = time.time()
    server = app.serve(background=True)
    start_s = time.time() - t0
    check(isinstance(server, FrontendServer),
          f"http_workers={SERVE_WORKERS} served by {type(server).__name__}")
    try:
        client = JsonHttp(server.port)
        # Design rows in field order: the list and columnar bodies carry
        # them, the dict body the raw records they come from.
        design = {c: design_from_rows(
            pool, app.builder.registry.manifest(f"srv_{c}")["preprocess"])
            for c in families}

        def body(kind, c, off, size):
            if kind == "dict":
                return (json.dumps({"rows": pool[off:off + size]}).encode(),
                        "application/json")
            if kind == "list":
                return (json.dumps(
                    {"rows": design[c][off:off + size].tolist()}).encode(),
                    "application/json")
            return (rowchannel.encode_columnar(design[c][off:off + size]),
                    rowchannel.COLUMNAR_CONTENT_TYPE)

        sent = {c: 0 for c in families}
        sent_lock = threading.Lock()

        def ask(conn, kind, c, off, size, lat=None):
            data, ctype = body(kind, c, off, size)
            t = time.perf_counter()
            status, raw, _ = conn.call_raw(
                "POST", f"/trained-models/srv_{c}/predict", data, ctype)
            if lat is not None:
                lat.append(time.perf_counter() - t)
            out = json.loads(raw)
            check(status == 200, f"workers predict srv_{c} {kind} "
                  f"({size} rows): {status} {out}")
            probs = np.asarray(out["probabilities"], np.float32)
            check(probs.shape == (size, oracle[c].shape[1]),
                  f"workers srv_{c} {kind}: {probs.shape}")
            check(out["predictions"] == np.argmax(probs, 1).tolist(),
                  f"workers srv_{c} {kind}: predictions are not the argmax")
            check(np.array_equal(probs, oracle[c][off:off + size]),
                  f"workers srv_{c} {kind}: {size} rows at {off} differ "
                  "from the one-row batch path")
            with sent_lock:
                sent[c] += size
            return size

        def load(kind, c, requests_per_thread, stop=None):
            """SERVE_THREADS clients, each a keep-alive connection; returns
            (rows, seconds)."""
            rows = [0] * SERVE_THREADS
            errors = []

            def one(k):
                rng = np.random.default_rng(100 + k)
                conn = JsonHttp(server.port)
                try:
                    i = 0
                    while (i < requests_per_thread if stop is None
                           else not stop.is_set()):
                        size = int(rng.choice(SERVE_SIZES))
                        off = int(rng.integers(0, SERVE_POOL - size + 1))
                        rows[k] += ask(conn, kind, c, off, size)
                        i += 1
                except Exception as exc:  # noqa: BLE001 — reported below
                    errors.append(f"{type(exc).__name__}: {exc}")
                finally:
                    conn.close()

            threads = [threading.Thread(target=one, args=(k,))
                       for k in range(SERVE_THREADS)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            return threads, rows, errors, t

        def join(threads, rows, errors, t, what):
            for th in threads:
                th.join(timeout=600)
            seconds = time.perf_counter() - t
            check(not errors and not any(th.is_alive() for th in threads),
                  f"{what}: {errors[:3]}")
            return sum(rows), seconds

        torch.cuda.synchronize()
        tk.reset_launch_counts()
        fam_doc = {}
        for c in families:
            fam_doc[c] = {}
            for kind in BODY_KINDS:
                ask(client, kind, c, 0, 1)          # loads and warms
                for size in SERVE_SIZES:
                    ask(client, kind, c, SERVE_POOL - size, size)
                lat1, lat64 = [], []
                for i in range(SERVE_LATENCY_REQUESTS):
                    ask(client, kind, c, i, 1, lat1)
                    ask(client, kind, c, i, 64, lat64)
                rows, seconds = join(*load(kind, c, SERVE_REQUESTS),
                                     f"workers srv_{c} {kind} load")
                fam_doc[c][kind] = {
                    "p50_ms_1row": _percentile_ms(lat1, 50),
                    "p99_ms_1row": _percentile_ms(lat1, 99),
                    "p50_ms_64rows": _percentile_ms(lat64, 50),
                    "p99_ms_64rows": _percentile_ms(lat64, 99),
                    "concurrent_rows_per_s": rows / seconds,
                    "concurrent_requests_per_s":
                        SERVE_THREADS * SERVE_REQUESTS / seconds}
        torch.cuda.synchronize()
        launches = tk.launch_counts()
        check(launches["tree_descend"] > 0,
              "tree_descend was not launched by the workers phase")

        status, metrics = client.call("GET", "/metrics")
        srv = metrics["serving"]
        for key in ("rejected", "errors", "timeouts", "deadline_exceeded",
                    "dispatcher_restarts"):
            check(srv[key] == 0, f"workers serving {key} = {srv[key]}")
        for c in families:
            per = srv["models"][f"srv_{c}"]
            check(per["rows"] == sent[c] == per["batched_rows"],
                  f"workers srv_{c}: rows {per['rows']} batched "
                  f"{per['batched_rows']} sent {sent[c]}")
        frontend = metrics["frontend"]
        check(frontend["workers_alive"] == SERVE_WORKERS
              and frontend["respawns_total"] == 0,
              f"front end: {frontend}")
        attribution = {
            phase_name: {k: v["mean_ms"] for k, v in by_label.items()
                         if k.startswith("srv_") or "predict" in k}
            for phase_name, by_label in metrics["latency_attribution"]
            .items() if phase_name in ("design.build", "queue.wait",
                                       "dispatch.device", "batch.coalesce",
                                       "http.handle")}
        emit({"phase": "serve_workers", "card": card_line(),
              "cpu_count": os.cpu_count(), "workers": SERVE_WORKERS,
              "start_s": start_s, "requests": srv["requests"],
              "rows": srv["rows"], "batches": srv["batches"],
              "mean_batch_rows": srv["mean_batch_rows"],
              "families": fam_doc,
              "one_worker_rows_per_s": ctx["rows_per_s"],
              "frontend": frontend, "mean_ms_by_span": attribution,
              "launches": launches})

        # -- the resource plane, through the workers --------------------
        status, res = client.call("GET", "/resources")
        devs = res["devices"]
        check(status == 200 and devs["source"] == "memory_stats",
              f"GET /resources devices: {status} {devs}")
        for d in devs["devices"]:
            if d["id"] == f"cuda:{dev.index}":
                check(0 < d["bytes_in_use"] <= d["bytes_limit"],
                      f"/resources {d}")
        card_bytes = torch.cuda.get_device_properties(dev).total_memory
        prof = ctx["sweep_job"]["profile"]
        check(0 < prof["peak_hbm_bytes"] <= card_bytes,
              f"sweep job peak_hbm_bytes {prof.get('peak_hbm_bytes')}")
        check(set(prof["fit_resources"]) == set(families),
              f"sweep job fit_resources {sorted(prof['fit_resources'])}")
        comp = metrics["compile"]
        # Both apps warmed every family's bucket ladder; the two kernel
        # libraries were built (or found built) at the start.
        warmups = 2 * len(families) * len(app.predictor.aot.buckets)
        check(comp["compiles"] >= warmups and comp["compile_s"] > 0
              and comp["compiles"] + comp["persistent_cache_hits"]
              >= warmups + 2, f"compile section {comp}")

        status, started = client.call("POST", "/debug/profile",
                                      {"seconds": PROFILE_SECONDS})
        check(status == 201, f"POST /debug/profile: {status} {started}")
        stop = threading.Event()
        running = load("dict", "rf", 0, stop)
        t0 = time.time()
        while True:
            _, jobs_doc = client.call("GET", "/jobs")
            (job,) = [j for j in jobs_doc
                      if j["job_id"] == started["job_id"]]
            if job["status"] != "running":
                break
            check(time.time() - t0 < 120, "profile capture never ended")
            time.sleep(0.1)
        stop.set()
        join(*running, "load during the profile")
        check(job["status"] == "done", f"profile job: {job}")
        with open(os.path.join(started["dir"], "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        descend = [k for k in kernels if "descend" in k]
        check(descend, f"the profile's {len(kernels)} kernel events hold "
              "no descent kernel")
        emit({"phase": "resources", "card": card_line(),
              "source": devs["source"],
              "bytes_in_use": devs["total_bytes_in_use"],
              "peak_bytes_in_use": devs["peak_bytes_in_use"],
              "bytes_limit": [d.get("bytes_limit") for d in devs["devices"]],
              "sweep_job_peak_hbm_bytes": prof["peak_hbm_bytes"],
              "sweep_job_compile_s": prof.get("compile_s"),
              "fit_resources": prof["fit_resources"], "compile": comp,
              "profile_seconds": PROFILE_SECONDS,
              "profile_kernel_events": len(kernels),
              "profile_descend_events": len(descend),
              "profile_descend_kernels": sorted(set(
                  re.search(r"\w*descend\w*(?:<[^>]*>)?", k).group(0)
                  for k in descend))})

        # -- the observability planes, through the workers ---------------
        status, raw, ctype = client.call_raw(
            "GET", "/metrics?format=prometheus", None, "text/plain")
        samples = [ln for ln in raw.decode().splitlines()
                   if ln and not ln.startswith("#")]
        sample_re = re.compile(r"^[A-Za-z_:][A-Za-z0-9_:]*(\{.*\})? "
                               r"[-+0-9.eEinfINa]+$")
        bad = [ln for ln in samples if not sample_re.match(ln)]
        check(status == 200 and "text/plain" in ctype and samples
              and not bad, f"Prometheus text: {status} {ctype} {bad[:3]}")
        for ln in samples:
            float(ln.rsplit(" ", 1)[1])
        frontend_series = sorted({ln.split("{")[0].split(" ")[0]
                                  for ln in samples
                                  if ln.startswith("lo_frontend_")})
        check(frontend_series, "no lo_frontend_* series")
        status, raw, ctype = client.call_raw("GET", "/status", None,
                                             "text/html")
        check(status == 200 and "text/html" in ctype
              and b"<html" in raw, f"GET /status: {status} {ctype}")
        status, alerts_doc = client.call("GET", "/alerts")
        check(status == 200 and alerts_doc["rules"],
              f"GET /alerts: {status}")
        status, hist = client.call("GET", "/metrics/history")
        check(status == 200 and hist["samples"] > 0,
              f"GET /metrics/history: {status} {hist.get('samples')}")
        status, bundle = client.call("POST", "/debug/flightrec",
                                     {"reason": "chip_smoke"})
        check(status == 201, f"POST /debug/flightrec: {status} {bundle}")
        with open(os.path.join(bundle["dir"], "manifest.json")) as f:
            versions = json.load(f)["versions"]
        check(versions.get("torch") == torch.__version__
              and versions.get("cuda") == torch.version.cuda
              and versions.get("device") == torch.cuda.get_device_name(0),
              f"flight-recorder manifest versions {versions}")
        emit({"phase": "observability", "prometheus_samples": len(samples),
              "frontend_series": frontend_series,
              "alert_rules": len(alerts_doc["rules"]),
              "alerts_firing": alerts_doc["firing"],
              "history_samples": hist["samples"],
              "flightrec_bundle": bundle["bundle"], "versions": versions})
        client.close()
    finally:
        try:
            app.drain(timeout_s=60.0)
        finally:
            server.stop()
    return launches


#: The tune phase's populations: family → (dataset, configs). dt, rf and
#: gb sweep the HIGGS train set, lr (Adam) and mlp a 1M-row set from the
#: same generator; every sweep at TUNE_FOLDS folds and TUNE_RUNGS rungs.
TUNE_SWEEPS = {
    "dt": ("train", [{"max_depth": k, "n_bins": b}
                     for k, b in ((3, 16), (4, 32), (5, 16), (6, 32))]),
    "rf": ("train", [{"n_trees": 20, "max_depth": k, "n_bins": b, "mtry": m}
                     for k, b, m in ((3, 16, 3), (4, 32, 5), (5, 16, 5),
                                     (6, 32, 3), (3, 32, 5), (4, 16, 3),
                                     (5, 32, 3), (6, 16, 5))]),
    "gb": ("train", [{"n_rounds": r, "max_depth": k, "step_size": st}
                     for r, k, st in ((20, 5, 0.1), (20, 4, 0.3),
                                      (12, 5, 0.3), (16, 3, 0.3),
                                      (20, 2, 0.1), (8, 6, 0.1))]),
    "lr": ("tune_small", [{"solver": "adam", "iters": 100, "lr": r}
                          for r in (0.003, 0.03, 0.1, 0.3)]),
    "mlp": ("tune_small", [{"hidden": h, "iters": 60, "lr": r}
                           for h, r in ((64, 0.01), (128, 0.003),
                                        (128, 0.03))]),
}
TUNE_FOLDS, TUNE_RUNGS = 3, 3
#: Rows of the lr/mlp sweep's dataset, and of the folds=1 parity sweeps.
TUNE_SMALL_ROWS = 1_000_000
#: The parity sweeps (folds=1, one rung): two configs a family, each
#: member's fold score against its serial fit's self-accuracy.
TUNE_PARITY = {
    "dt": [{"max_depth": 4, "n_bins": 16}, {"max_depth": 6, "n_bins": 32}],
    "rf": [{"n_trees": 8, "max_depth": 4, "n_bins": 32},
           {"n_trees": 8, "max_depth": 5, "n_bins": 16, "mtry": 7}],
    "gb": [{"n_rounds": 8, "max_depth": 4}, {"n_rounds": 6, "max_depth": 3,
                                            "step_size": 0.3}],
    "lr": [{"solver": "adam", "iters": 40, "lr": 0.05},
           {"solver": "adam", "iters": 30, "lr": 0.2, "l2": 1e-3}],
    "mlp": [{"hidden": 32, "iters": 25, "lr": 0.01},
            {"hidden": 64, "iters": 20, "lr": 0.003}],
}


#: Kernel names (substrings of the profiler's) of the tree kernels whose
#: device time the tune line reports: K1 with its second pass, and K3.
TUNE_KERNEL_NAMES = {"K1": ("hist_slice_kernel", "sum_partials_kernel"),
                     "K3": ("descend_staged_kernel", "descend_direct_kernel")}


def tune_device_ms(prof) -> dict:
    """Device milliseconds of a profiled window: K1's and K3's kernels
    (TUNE_KERNEL_NAMES) and every kernel and copy together."""
    out = {k: 0.0 for k in TUNE_KERNEL_NAMES}
    out["all"] = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        out["all"] += us / 1e3
        for k, names in TUNE_KERNEL_NAMES.items():
            if any(nm in ev.key for nm in names):
                out[k] += us / 1e3
    return out


def tune_path(cfg, store, dev) -> dict:
    """Device-resident hyperparameter sweeps on the sweep's catalog: (b)
    ``POST /tune`` (async, promote) of dt, rf and gb on the HIGGS train
    set and lr and mlp on a 1M-row set, through the served app; per
    family its waves, halving drops, winner, seconds, the job's
    ``peak_hbm_bytes`` beside the modeled wave footprint, and the
    kernels' launches (dt, rf and gb through the slice forms); each
    promoted winner answers ``ModelBuilder.predict`` and an online
    request; ``/metrics`` counts the sweeps. Then (c) folds=1 parity:
    every member's fold score equals its serial fit's self-accuracy on
    the card (gb within 0.02). The app's train dataset starts from the
    sweep's design matrix (its memo), as a server that already built it
    would. Returns the kernel launches of the phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmarks.workload import higgs_like_columns
    from learningorchestra_tpu_torch.models import trees, tune
    from learningorchestra_tpu_torch.models.registry import get_trainer
    from learningorchestra_tpu_torch.ops import preprocess
    from learningorchestra_tpu_torch.ops import tree_kernels as tk
    from learningorchestra_tpu_torch.serving.app import App

    t0 = time.time()
    store.create("tune_small", columns=higgs_like_columns(TUNE_SMALL_ROWS,
                                                           2),
                 finished=True)
    app = App(cfg.replace(host="127.0.0.1", port=0), device=str(dev))
    key = ("design", "label", json.dumps([]))
    train = store.get("train")
    design = train.memo(key, lambda: preprocess.design_matrix(
        train, "label", ()))
    app.store.get("train").memo(key, lambda: design)
    server = app.serve(background=True)
    doc = {"phase": "tune", "card": card_line(), "setup_s": time.time() - t0,
           "folds": TUNE_FOLDS, "rungs": TUNE_RUNGS, "families": {}}
    total = {k: 0 for k in tk.KERNELS}
    try:
        client = JsonHttp(server.port)
        test = store.get("test")
        fields = [f for f in test.metadata.fields if f != "label"]
        row = {f: float(test.columns[f][0]) for f in fields}
        for fam, (ds, configs) in TUNE_SWEEPS.items():
            name = f"tuned_{fam}"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            tk.reset_launch_counts()
            # The kernels' device time in the sweep: CUDA activity only
            # (every thread's launches), grouped by kernel.
            with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                    build_slices() as slices:
                t0 = time.time()
                status, body = client.call("POST", "/tune", {
                    "training_filename": ds, "tune_filename": name,
                    "classificator": fam, "configs": configs,
                    "label": "label", "folds": TUNE_FOLDS,
                    "rungs": TUNE_RUNGS, "promote": True, "sync": False})
                check(status == 201, f"POST /tune {fam}: {status} {body}")
                meta = wait_finished(client, name)
                torch.cuda.synchronize()
                sweep_s = time.time() - t0
            launches = tk.launch_counts()
            allocator_peak = torch.cuda.max_memory_allocated(dev)
            for k, v in launches.items():
                total[k] += v
            board = meta["tune"]
            check(board["promoted"] == name,
                  f"{fam}: winner not promoted: {board}")
            check(len(board["results"]) == len(configs)
                  and all(np.isfinite(r["mean_score"])
                          for r in board["results"]),
                  f"{fam}: board {board}")
            if fam in ("dt", "rf"):
                # The first tree batch of every member, in _build_trees
                # calls of as many members as tune_max_population holds.
                tb = trees._forest_batch_shape(
                    tune.forest_size(fam, configs))[0]
                per_call = max(1, cfg.tune_max_population // tb) * tb
                total_slices = len(configs) * TUNE_FOLDS * tb
                first = [min(per_call, total_slices - i)
                         for i in range(0, total_slices, per_call)]
                check(slices[:len(first)] == first
                      and max(slices) <= cfg.tune_max_population,
                      f"{fam} sweep's _build_trees slices {slices}")
            if fam in ("dt", "rf", "gb"):
                for k in tk.SLICED:
                    check(launches[f"{k}_slices"] > 0,
                          f"{fam} sweep launched no {k}_slices")
            while True:
                _, jobs_doc = client.call("GET", "/jobs")
                (job,) = [j for j in jobs_doc if j["kind"] == "tune"
                          and j["dataset"] == name]
                if job["status"] != "running":
                    break
                check(time.time() - t0 < 900, f"{fam} tune job never ended")
                time.sleep(0.1)
            check(job["status"] == "done", f"{fam} tune job {job}")
            n_rows = app.store.get(ds).num_rows
            members = len(configs) * TUNE_FOLDS
            peak = job["profile"]["peak_hbm_bytes"]
            check(0 < peak <= torch.cuda.get_device_properties(
                dev).total_memory, f"{fam} peak_hbm_bytes {peak}")
            # The winner as a user reaches it: a batch predict and one
            # online request.
            app.builder.predict(name, "test", f"{name}_pred")
            pred = app.store.get(f"{name}_pred")
            check(pred.metadata.finished and pred.num_rows == test.num_rows,
                  f"{fam} winner predict")
            status, online = client.call(
                "POST", f"/trained-models/{name}/predict", {"rows": [row]})
            check(status == 200 and len(online["predictions"]) == 1
                  and np.isfinite(online["probabilities"]).all(),
                  f"{fam} winner online predict: {status} {online}")
            doc["families"][fam] = {
                "dataset": ds, "rows": n_rows, "configs": len(configs),
                "members": members, "waves": board["waves"],
                "halving_drops": sum(not r["alive"]
                                     for r in board["results"]),
                "winner": board["winner"]["config"],
                "winner_mean_score": board["winner"]["mean_score"],
                "sweep_s": sweep_s,
                "fit_seconds": board["winner"]["fit_seconds"],
                "peak_hbm_bytes": peak,
                "allocator_peak_bytes": allocator_peak,
                "modeled_wave_bytes": members * tune._per_member_bytes(
                    fam, n_rows, 28, 2, tune.forest_size(fam, configs)),
                "build_slices": list(slices),
                "launches": {k: v for k, v in launches.items() if v},
                "device_ms": tune_device_ms(prof),
                # Every member's fold scores: runs of other kernels must
                # give the same board.
                "board": [{"config": r["config"],
                           "fold_scores": r["fold_scores"],
                           "alive": r["alive"]}
                          for r in board["results"]]}
        status, metrics = client.call("GET", "/metrics")
        check(status == 200, f"GET /metrics: {status}")
        doc["metrics_tune"] = metrics["tune"]
        check(metrics["tune"]["populations_fitted"] >= len(TUNE_SWEEPS)
              and metrics["tune"]["candidates_evaluated"]
              >= sum(len(c) for _, c in TUNE_SWEEPS.values())
              and metrics["tune"]["rungs_completed"] > 0
              and metrics["tune"]["halving_drops"] > 0,
              f"/metrics tune section {metrics['tune']}")
        client.close()
    finally:
        server.stop()

    # (c) Parity on the card: folds=1, one rung.
    small = store.get("tune_small")
    X, y, _, _ = small.memo(key, lambda: preprocess.design_matrix(
        small, "label", ()))
    parity = {}
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t0 = time.time()
    for fam, configs in TUNE_PARITY.items():
        board = tune.sweep(app.runtime, X, y, 2, fam, configs, cfg=cfg,
                           folds=1, rungs=1)
        got, want = [], []
        for c in configs:
            (r,) = [r for r in board["results"] if r["config"] == c]
            trainer = get_trainer(fam)
            prep = getattr(trainer, "host_prep", None)
            extra = prep(X, **c) if prep is not None else {}
            model = trainer(app.runtime, X, y, 2, **dict(c, **extra))
            pr = np.argmax(model.predict_proba(app.runtime, X), axis=1)
            got.append(r["fold_scores"][0])
            want.append(round(float((pr == y).mean()), 6))
        if fam == "gb":
            check(all(abs(a - b) <= 0.02 for a, b in zip(got, want)),
                  f"gb population {got} vs serial {want}")
        else:
            check(got == want, f"{fam} population {got} != serial {want}")
        parity[fam] = {"population": got, "serial": want}
    torch.cuda.synchronize()
    launches = tk.launch_counts()
    for k, v in launches.items():
        total[k] += v
    doc["parity"] = parity
    doc["parity_rows"] = int(len(X))
    doc["parity_s"] = time.time() - t0
    doc["parity_launches"] = {k: v for k, v in launches.items() if v}
    doc["launches"] = {k: v for k, v in total.items() if v}
    emit(doc)
    return total


#: The tx phase: (a) the card against the CPU at test_ring_attention.py's
#: widths; (b) blockwise attention at 8,192 tokens; (d) REST at
#: bench_transformer.py's ``large`` widths; (e) its four train steps
#: (widths, batch, seq, timed steps).
TX_SMALL = dict(vocab=16, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                n_classes=3, max_len=64)
TX_LONG_T, TX_LONG_HEADS, TX_LONG_HEAD_DIM = 8192, 8, 64
TX_LARGE = dict(d_model=512, n_heads=8, n_layers=8, d_ff=2048)
TX_REST_T, TX_REST_TRAIN, TX_REST_TEST = 1024, 4096, 256
TX_REST_HPARAMS = dict(TX_LARGE, batch=16, train_steps=100, lr=1e-3)
TX_STEP_SHAPES = (
    (dict(d_model=256, n_heads=8, n_layers=4, d_ff=1024), 32, 1024, 5),
    (TX_LARGE, 16, 2048, 3),
    (TX_LARGE, 4, 8192, 2),
    (dict(TX_LARGE, remat=True), 1, 32768, 1),
)


def _tx_grads(params, tokens, labels, cfg, mesh):
    """Logits, loss and every leaf's gradient of the port's sharded
    program on ``mesh``."""
    import torch

    from learningorchestra_tpu_torch.models import transformer as ttx

    names = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    p = dict(zip(names, leaves))
    with torch.no_grad():
        logits = ttx.forward_shard(p, tokens, cfg=cfg, mesh=mesh)
    loss = ttx.loss_shard(p, tokens, labels, cfg=cfg, mesh=mesh)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    ttx.reduce_grads(grads, mesh)
    return logits, loss.detach(), grads


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dominance_rows(n: int, T: int, seed: int):
    """tests/test_sequence.py's task: label 1 when token 0 fills 60% of
    the sequence, else tokens 1-7 uniformly (label 0)."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) >= 0.5).astype(np.int64)
    X = rng.integers(1, 8, (n, T))
    zero = (rng.random((n, T)) < 0.6) & (y[:, None] == 1)
    X[zero] = 0
    return X, y


def _write_token_csv(path: str, X, y) -> str:
    T = X.shape[1]
    header = ",".join([f"t{j}" for j in range(T)] + ["label"])
    np.savetxt(path, np.concatenate([X, y[:, None]], axis=1), fmt="%d",
               delimiter=",", header=header, comments="")
    return f"file://{path}"


def tx_path(cfg, dev) -> None:
    """The tx sequence classifier on the card: (a) forward, loss and
    gradients against the CPU; (b) blockwise attention at 8,192 tokens
    against full attention; (c) a train step through a one-rank NCCL
    group, bit for bit the step with no process group; (d) ``POST
    /models`` of tx at the ``large`` widths on 1,024-token rows through
    the port's client, re-served through ``/trained-models``; (e) the
    train step at bench_transformer.py's four shapes."""
    import torch
    import torch.distributed as dist

    from learningorchestra_tpu_torch.client import Context, DatabaseApi, Model
    from learningorchestra_tpu_torch.models import transformer as ttx
    from learningorchestra_tpu_torch.parallel import distributed
    from learningorchestra_tpu_torch.parallel.mesh import (
        ProcessMesh, local_mesh)
    from learningorchestra_tpu_torch.parallel.ring_attention import (
        reference_attention, ring_attention)
    from learningorchestra_tpu_torch.serving.app import App

    # Full float32 products on the card, as on the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    t_phase = time.time()
    cpu = torch.device("cpu")
    no_group = ProcessMesh((1, 1, 1))

    # (a) The card against the CPU, from the same params and tokens.
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, TX_SMALL["vocab"], (8, 16))
    labels = rng.integers(0, TX_SMALL["n_classes"], 8)
    doc = {"phase": "tx_card_vs_cpu", "card": card_line(), "cases": []}
    for causal in (False, True):
        for remat in (False, True):
            c = ttx.TxConfig(**TX_SMALL, causal=causal, remat=remat)
            params = ttx.init_params(torch.Generator().manual_seed(0), c)
            (lc, sc, gc), (lg, sg, gg) = (
                _tx_grads({k: v.to(d) for k, v in params.items()},
                          torch.from_numpy(tokens).to(d),
                          torch.from_numpy(labels).to(d), c, no_group)
                for d in (cpu, dev))
            pairs = [("logits", lc, lg), ("loss", sc, sg)] + [
                (k, gc[k], gg[k]) for k in gc]
            worst = 0.0
            for name, a, b in pairs:
                b = b.cpu()
                check(torch.allclose(b, a, rtol=1e-4, atol=1e-5),
                      f"tx card vs CPU ({causal=}, {remat=}): {name} "
                      f"differs by {float((b - a).abs().max())}")
                worst = max(worst, float((b - a).abs().max()))
            doc["cases"].append({"causal": causal, "remat": remat,
                                 "max_abs_diff": worst,
                                 "leaves": len(gc)})
    emit(doc)

    # (b) Blockwise attention at 8,192 tokens against full attention.
    g = torch.Generator(device=dev).manual_seed(1)
    shape = (1, TX_LONG_T, TX_LONG_HEADS, TX_LONG_HEAD_DIM)
    q, k, v = (torch.randn(shape, generator=g, device=dev)
               for _ in range(3))
    B, T, H, D = shape
    doc = {"phase": "tx_blockwise", "card": card_line(), "T": TX_LONG_T,
           "heads": TX_LONG_HEADS, "head_dim": TX_LONG_HEAD_DIM,
           "kv_block": 1024, "cases": []}
    with torch.no_grad():
        for causal in (False, True):
            got = ring_attention(q, k, v, causal=causal, kv_block=1024)
            want = reference_attention(q, k, v, causal=causal)
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=1e-4, atol=1e-5),
                  f"blockwise attention at T={TX_LONG_T} ({causal=}) "
                  f"differs by {err}")
            # The least the card could take: q, k, v read and the output
            # written once; the two products (2·T²·D multiply-adds a head,
            # half of them under a causal mask) at the float32 peak.
            doc["cases"].append({
                "causal": causal, "max_abs_err": err,
                "bound_ms": bound(4 * B * T * H * D * 4,
                                  4 * B * H * T * T * D
                                  * (0.5 if causal else 1.0))[0],
                "blockwise_ms": time_ms(lambda: ring_attention(
                    q, k, v, causal=causal, kv_block=1024), 3),
                "full_ms": time_ms(lambda: reference_attention(
                    q, k, v, causal=causal), 3)})
            del got, want
    emit(doc)
    del q, k, v
    torch.cuda.empty_cache()

    # (c) One train step through a one-rank NCCL group, every collective
    # issued, against the same step with no process group.
    c = ttx.TxConfig(**TX_SMALL)
    params = ttx.init_params(torch.Generator().manual_seed(2), c)
    tok = torch.from_numpy(tokens).to(dev)
    lab = torch.from_numpy(labels).to(dev)

    def one_step(mesh):
        p = {k: v.to(dev) for k, v in params.items()}
        p, state, loss = ttx.train_step(p, ttx.adam_init(p), tok, lab,
                                        cfg=c, mesh=mesh, lr=1e-3)
        torch.cuda.synchronize()
        return p, state, loss

    check(not dist.is_initialized(), "a process group exists already")
    distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    reduces = []
    all_reduce = dist.all_reduce
    try:
        mesh = local_mesh(cfg.replace(mesh_shape="1,1,1"))
        check(all(gr is not None for gr in mesh.groups.values())
              and dist.get_backend() == "nccl",
              "the one-rank mesh has no NCCL groups")

        def counted(*a, **kw):
            reduces.append(1)
            return all_reduce(*a, **kw)

        dist.all_reduce = counted
        grouped = one_step(mesh)
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()
    plain = one_step(no_group)
    same = (torch.equal(grouped[2], plain[2])
            and all(torch.equal(grouped[0][k], plain[0][k])
                    for k in params)
            and all(torch.equal(grouped[1][m][k], plain[1][m][k])
                    for m in ("mu", "nu") for k in params))
    check(same, "the step through a one-rank NCCL group differs from the "
          "step with no process group")
    # psum/pvary: 2 + 2 a layer, the pooled psum, the loss's two psums;
    # the gradients: every leaf over data, all but head_w/head_b over seq.
    want = 4 * c.n_layers + 3 + 2 * len(params) - 2
    check(len(reduces) == want,
          f"{len(reduces)} all-reduces in the grouped step, {want} expected")
    emit({"phase": "tx_nccl_one_rank", "card": card_line(),
          "bit_identical": True, "all_reduces": len(reduces),
          "loss": float(plain[2])})

    # (d) REST at the large widths: POST /models of tx through the port's
    # client, the predictions route on the saved model.
    work = os.path.join(ROOT, "build", "chip_smoke_tx")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    Xtr, ytr = _dominance_rows(TX_REST_TRAIN, TX_REST_T, 3)
    Xte, yte = _dominance_rows(TX_REST_TEST, TX_REST_T, 4)
    train_url = _write_token_csv(os.path.join(work, "train.csv"), Xtr, ytr)
    test_url = _write_token_csv(os.path.join(work, "test.csv"), Xte, yte)
    app = App(cfg.replace(host="127.0.0.1", port=0,
                          store_root=os.path.join(work, "store")),
              recover=False, device=str(dev))
    check(dict(app.runtime.mesh.shape) == {"data": 1, "model": 1, "seq": 1},
          "the App's mesh is not one rank")
    server = app.serve(background=True)
    try:
        ctx = Context(f"http://127.0.0.1:{server.port}", poll_seconds=0.1,
                      timeout=900)
        db, model = DatabaseApi(ctx), Model(ctx)
        t0 = time.time()
        db.create_file("tx_train", train_url, wait=True)
        db.create_file("tx_test", test_url, wait=True)
        ingest_s = time.time() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        out = model.create_model("tx_train", "tx_test", "txpred", ["tx"],
                                 "label", hparams={"tx": TX_REST_HPARAMS})
        build_s = time.time() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        rep = out["result"][0]
        check(rep["classifier"] == "tx" and "error" not in rep,
              f"tx fit: {rep}")
        check(rep["accuracy"] >= 0.9, f"tx accuracy {rep['accuracy']} < 0.9")
        meta = db.read_file("txpred_tx", limit=1)[0]
        check(meta["finished"] and not meta.get("error"), meta)
        man = app.builder.registry.manifest("txpred_tx")
        check(man["kind"] == "tx" and man["hparams"]["max_len"] == TX_REST_T
              and man["hparams"]["d_model"] == TX_REST_HPARAMS["d_model"],
              man["hparams"])
        t0 = time.time()
        model.predict("txpred_tx", "tx_test", "txpred_again", wait=True)
        predict_s = time.time() - t0
        again = db.read_file("txpred_again", limit=1)[0]
        check(again["finished"] and not again.get("error"), again)
        first = app.store.get("txpred_tx").columns["prediction"]
        second = app.store.get("txpred_again").columns["prediction"]
        check(np.array_equal(first, second) and len(second) == TX_REST_TEST,
              "the re-served predictions differ from the fit's")
        emit({"phase": "tx_rest", "card": card_line(),
              "train_rows": TX_REST_TRAIN, "test_rows": TX_REST_TEST,
              "tokens": TX_REST_T, "hparams": TX_REST_HPARAMS,
              "ingest_s": ingest_s, "build_s": build_s,
              "fit_time": rep["fit_time"], "accuracy": rep["accuracy"],
              "f1": rep["f1"], "predict_s": predict_s,
              "peak_allocated_bytes": peak})
    finally:
        server.stop()
        shutil.rmtree(work, ignore_errors=True)
    del app
    torch.cuda.empty_cache()

    # (e) The train step at bench_transformer.py's shapes.
    steps = []
    for widths, batch, seq, iters in TX_STEP_SHAPES:
        c = ttx.TxConfig(max_len=seq, **widths)
        p = {k: v.to(dev) for k, v in ttx.init_params(
            torch.Generator().manual_seed(0), c).items()}
        state = ttx.adam_init(p)
        rng = np.random.default_rng(0)
        tok = torch.from_numpy(rng.integers(0, c.vocab, (batch, seq))).to(dev)
        lab = torch.from_numpy(rng.integers(0, c.n_classes, batch)).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        p, state, loss = ttx.train_step(p, state, tok, lab, cfg=c,
                                        mesh=no_group, lr=1e-3)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(iters):
            p, state, loss = ttx.train_step(p, state, tok, lab, cfg=c,
                                            mesh=no_group, lr=1e-3)
        loss = float(loss)            # waits for the last step
        step_s = (time.time() - t0) / iters
        check(np.isfinite(loss), f"tx step at seq {seq}: loss {loss}")
        steps.append({"d_model": c.d_model, "layers": c.n_layers,
                      "seq": seq, "batch": batch, "remat": c.remat,
                      "steps": iters, "step_s": step_s,
                      "tokens_per_s": batch * seq / step_s, "loss": loss,
                      "peak_allocated_bytes":
                          torch.cuda.max_memory_allocated(dev)})
        del p, state, tok, lab
        torch.cuda.empty_cache()
    emit({"phase": "tx_step", "card": card_line(), "shapes": steps,
          "seconds": time.time() - t_phase})


# ---------------------------------------------------------------------------
# The data-parallel pod: two ranks on the one card over gloo
# ---------------------------------------------------------------------------

#: Ranks of the pod, all on the data axis, sharing the one card.
POD_RANKS = 2
#: The dispatched job of rank 1's at whose device ops it dies, through
#: the ``spmd.worker.pre_device`` failpoint: build, predict, histogram,
#: embed, then the second build (the fifth).
POD_CRASH_JOB = 5
#: Start-up, and each job's, time limit (seconds).
POD_START_S, POD_JOB_S = 300.0, 600.0

#: The command each rank of a pod runs under ``python -m
#: learningorchestra_tpu_torch.launch``, written to the phase's work
#: directory: rank 1 of epoch 0 arms the ``spmd.worker.pre_device``
#: failpoint at the job ``POD_CRASH_JOB`` names (when the environment sets
#: it), then every rank runs the serving module with its arguments.
POD_RANK = r'''
import os, runpy, sys
crash = os.environ.get("POD_CRASH_JOB")
if (crash and os.environ.get("LO_TPU_PROCESS_ID") == "1"
        and os.environ.get("LO_TPU_MESH_EPOCH", "0") == "0"):
    os.environ["LO_TPU_FAILPOINTS"] = "spmd.worker.pre_device=crash:" + crash
sys.argv[0] = "learningorchestra_tpu_torch.serving"
runpy.run_module("learningorchestra_tpu_torch.serving", run_name="__main__",
                 alter_sys=True)
'''

#: Stand-ins for matplotlib and seaborn, first on the pod's path: the
#: card's machine may lack both, and the image route draws its PNG with
#: them. ``savefig`` writes the plotted (n, 2) points as a .npy file at
#: the image's path, where the phase reads the embedding back.
POD_PLOT_STUBS = {
    "matplotlib/__init__.py": "def use(*args, **kwargs):\n    pass\n",
    "matplotlib/pyplot.py": (
        "import numpy as np\n\n\n"
        "class _Fig:\n"
        "    points = None\n\n"
        "    def savefig(self, path, **kwargs):\n"
        "        with open(path, 'wb') as f:\n"
        "            np.save(f, self.points)\n\n\n"
        "class _Ax:\n"
        "    def __init__(self, fig):\n"
        "        self.fig = fig\n\n"
        "    def set_title(self, title):\n"
        "        pass\n\n\n"
        "def subplots(*args, **kwargs):\n"
        "    fig = _Fig()\n"
        "    return fig, _Ax(fig)\n\n\n"
        "def close(fig):\n"
        "    pass\n"),
    "seaborn/__init__.py": (
        "import numpy as np\n\n\n"
        "def scatterplot(x=None, y=None, ax=None, **kwargs):\n"
        "    ax.fig.points = np.stack([np.asarray(x), np.asarray(y)],\n"
        "                             1).astype(np.float32)\n"),
}


def _pod_get(port: int, path: str, timeout: float = 10.0):
    """(status, JSON body, headers) of one request, or (None, None, {})
    while the server is down (a restart in progress)."""
    import http.client

    try:
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=timeout)
        conn.request("GET", path)
        resp = conn.getresponse()
        raw = resp.read()
        conn.close()
        return resp.status, (json.loads(raw) if raw else None), \
            dict(resp.getheaders())
    except (OSError, ValueError):
        return None, None, {}


def _pod_post(port: int, path: str, body: dict):
    """(status, JSON body, headers) of one POST."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", path, body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, (json.loads(raw) if raw else None), \
        dict(resp.getheaders())


def _stored(value):
    """A list or dict cell as read back from disk, where it is its
    Python literal."""
    import ast

    return ast.literal_eval(value) if isinstance(value, str) else value


def _pod_column(reader, name: str, field: str):
    """Column ``field`` of dataset ``name`` as another process wrote it
    to the shared store. The server flips ``finished`` in memory just
    before it saves, so a poller can see it first: wait for the save."""
    t0 = time.time()
    while True:
        ds = reader.load(name)
        if ds.metadata.finished or time.time() - t0 > 60:
            break
        time.sleep(0.1)
    cols = ds.columns
    check(field in cols, f"{name} on disk has no column {field}: fields "
          f"{ds.metadata.fields}, columns {list(cols)}, rows "
          f"{ds.num_rows}, finished {ds.metadata.finished}")
    return cols[field]


def _pod_cluster(port: int, want, timeout_s: float) -> dict:
    """Poll ``GET /cluster`` until ``want(doc)``; the doc."""
    t0 = time.time()
    while True:
        status, doc, _ = _pod_get(port, "/cluster")
        if status == 200 and want(doc):
            return doc
        check(time.time() - t0 < timeout_s,
              f"pod /cluster never reached the wanted state: {doc}")
        time.sleep(0.05)


def _pod_launches(doc: dict) -> dict:
    """{rank: {kernel: launches}} of a /cluster doc."""
    return {int(r): dict(snap.get("launches") or {})
            for r, snap in (doc.get("resources") or {}).items()}


def _pod_wait(port: int, name: str, timeout_s: float = POD_JOB_S,
              retried: bool = False) -> dict:
    """Poll ``GET /files/{name}`` until finished without error (and, with
    ``retried``, re-run by the rescan); the metadata doc. A failure that
    is not a retried pod failure fails the run."""
    t0 = time.time()
    while True:
        status, docs, _ = _pod_get(port, f"/files/{name}?limit=1")
        if status == 200 and docs and docs[0].get("finished"):
            doc = docs[0]
            if not doc.get("error") and (doc.get("retries") or not retried):
                return doc
            check(retried and (doc.get("error") or "").startswith(
                ("pod failure:", "interrupted:")),
                  f"{name} failed: {doc.get('error')}")
        check(time.time() - t0 < timeout_s, f"{name} never finished")
        time.sleep(0.25)


def _pod_start(cfg, work: str, extra_env: dict, path=()):
    """One supervisor whose pod command is ``python -m
    learningorchestra_tpu_torch.launch --ranks POD_RANKS``, each rank the
    ``POD_RANK`` wrapper around ``python -m
    learningorchestra_tpu_torch.serving --device cuda --dist-backend
    gloo`` on the catalog's store; ``path`` goes first on the ranks'
    ``PYTHONPATH``. Logs land in ``work`` (the supervisor's, with the
    launcher's JSON lines, and one a rank and epoch). Returns (the
    supervisor, its log file, the HTTP port)."""
    os.makedirs(work, exist_ok=True)
    wrapper = os.path.join(work, "rank.py")
    with open(wrapper, "w") as f:
        f.write(POD_RANK)
    http_port, coord, job_port = _free_port(), _free_port(), _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LO_TPU_")}
    env.update({
        "PYTHONPATH": os.pathsep.join(
            list(path) + [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                                   if p]),
        "LO_TPU_STORE_ROOT": cfg.store_root,
        "LO_TPU_COORDINATOR": f"127.0.0.1:{coord}",
        "LO_TPU_JOB_PORT": str(job_port), "LO_TPU_LOG_FORMAT": "json",
        "LO_TPU_HEALTH_INTERVAL_S": "3", "LO_TPU_RESTART_BACKOFF_S": "1",
        "LO_TPU_JOB_RETRIES": "1", "LO_TPU_DRAIN_TIMEOUT_S": "2",
        **extra_env})
    rank_cmd = [sys.executable, wrapper, "--device", "cuda",
                "--dist-backend", "gloo", "--host", "127.0.0.1", "--port",
                str(http_port), "--store-root", cfg.store_root]
    sup_log = open(os.path.join(work, "supervisor.log"), "w")
    sup = subprocess.Popen(
        [sys.executable, "-m", "learningorchestra_tpu_torch.supervisor",
         "--health-url", f"http://127.0.0.1:{http_port}/cluster", "--",
         sys.executable, "-m", "learningorchestra_tpu_torch.launch",
         "--ranks", str(POD_RANKS), "--log-dir", work, "--"] + rank_cmd,
        env=env, cwd=ROOT, stdout=sup_log, stderr=subprocess.STDOUT,
        start_new_session=True)
    return sup, sup_log, http_port


def _pod_stop(sup, sup_log) -> None:
    """SIGTERM the supervisor (it stops the launcher, which forwards the
    signal to the ranks) and wait; then SIGKILL whatever is left of its
    process group. A rank dies with its launcher (the launcher's parent
    death signal)."""
    import signal as _signal

    sup.send_signal(_signal.SIGTERM)
    try:
        sup.wait(timeout=60)
    except subprocess.TimeoutExpired:
        sup.kill()
        sup.wait()
    try:
        os.killpg(sup.pid, _signal.SIGKILL)
    except OSError:
        pass
    sup_log.close()


def _launch_exits(work: str) -> list:
    """The launcher's ``rank_exit`` log lines in the supervisor's log."""
    exits = []
    with open(os.path.join(work, "supervisor.log")) as f:
        for line in f:
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if (isinstance(doc, dict) and doc.get("logger") == "lo_tpu.launch"
                    and doc.get("event") == "rank_exit"):
                exits.append(doc)
    return exits


def pod_path(cfg, store, runtime, dev, acc_sweep: dict) -> dict:
    """Phase 15 of the module docstring: two ranks of the serving module
    on the card over gloo under the supervisor, driven through rank 0's
    REST API on the sweep's catalog; then rank 1 dies during a second
    build and the pod recovers. Returns the kernel launches of both
    ranks over both incarnations."""
    import torch

    from learningorchestra_tpu_torch.catalog.store import DatasetStore
    from learningorchestra_tpu_torch.viz.service import embed_dataset

    families = ["lr", "dt", "rf", "gb", "nb"]
    for name in ("train", "test", "mnist_like", "pred_gb_again"):
        store.save(name)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    work = os.path.join(os.path.dirname(cfg.store_root), "pod")
    shutil.rmtree(work, ignore_errors=True)
    stubs = os.path.join(work, "stubs")
    for rel, text in POD_PLOT_STUBS.items():
        os.makedirs(os.path.dirname(os.path.join(stubs, rel)), exist_ok=True)
        with open(os.path.join(stubs, rel), "w") as f:
            f.write(text)
    image_root = os.path.join(work, "images")
    t_start = time.time()
    sup, sup_log, http_port = _pod_start(
        cfg, work, {"LO_TPU_IMAGE_ROOT": image_root,
                    "POD_CRASH_JOB": str(POD_CRASH_JOB)}, path=[stubs])
    doc = {"phase": "pod", "ranks": POD_RANKS, "backend": "gloo"}
    launches = {}
    try:
        info = _pod_cluster(
            http_port, lambda d: (d["process_count"] == POD_RANKS and
                                  str(POD_RANKS - 1) in d["resources"]),
            POD_START_S)
        doc["start_s"] = time.time() - t_start
        check(info["mesh"] == {"data": POD_RANKS, "model": 1, "seq": 1}
              and info["backend"] == "gloo" and info["healthy"],
              f"pod /cluster: {info}")
        reader = DatasetStore(cfg)

        # (a) the five families through POST /models
        t0 = time.time()
        status, body, _ = _pod_post(http_port, "/models", {
            "training_filename": "train", "test_filename": "test",
            "prediction_filename": "pod", "classificators_list": families,
            "label": "label", "sync": False})
        check(status == 201, f"pod POST /models: {status} {body}")
        fits = {c: _pod_wait(http_port, f"pod_{c}") for c in families}
        doc["build_s"] = time.time() - t0
        acc = {c: fits[c]["accuracy"] for c in families}
        doc["fit_time"] = {c: fits[c]["fit_time"] for c in families}
        doc["accuracy"] = acc
        for c in ("dt", "gb"):
            check(acc[c] == acc_sweep[c], f"pod {c} accuracy {acc[c]} != "
                  f"the one-process sweep's {acc_sweep[c]}")
        for c in ("lr", "nb"):
            check(abs(acc[c] - acc_sweep[c]) <= 1e-4,
                  f"pod {c} accuracy {acc[c]} vs {acc_sweep[c]}")
        check(acc["rf"] > ACC_FLOOR["rf"] and acc["rf"] > acc["lr"],
              f"pod rf accuracy {acc['rf']}")
        doc["launches_build"] = _pod_launches(_pod_get(
            http_port, "/cluster")[1])

        # (b) a batch predict of the saved gb model
        t0 = time.time()
        status, body, _ = _pod_post(
            http_port, "/trained-models/pod_gb/predictions",
            {"dataset_name": "test", "prediction_filename": "pod_gb_again"})
        check(status == 201, f"pod predictions: {status} {body}")
        _pod_wait(http_port, "pod_gb_again")
        doc["predict_s"] = time.time() - t0
        probs = [np.array([_stored(p) for p in
                           _pod_column(reader, n, "probability")],
                          np.float64)
                 for n in ("pod_gb_again", "pred_gb_again")]
        check(probs[0].shape == (TEST_ROWS, 2)
              and np.array_equal(probs[0], probs[1]),
              "pod gb predictions differ from the one-process predict's")

        # (c) a histogram
        t0 = time.time()
        status, body, _ = _pod_post(http_port, "/histograms/train", {
            "histogram_filename": "pod_hist", "fields": ["label"]})
        check(status == 201, f"pod histogram: {status} {body}")
        _pod_wait(http_port, "pod_hist")
        doc["histogram_s"] = time.time() - t0
        got = {int(k): int(v) for k, v in _stored(
            _pod_column(reader, "pod_hist", "counts")[0]).items()}
        want = {int(v): int(c) for v, c in enumerate(
            np.bincount(store.get("train").columns["label"])) if c}
        check(got == want, f"pod histogram {got} != {want}")

        # (d) the 60,000 × 784 t-SNE image
        before = _pod_launches(_pod_get(http_port, "/cluster")[1])
        t0 = time.time()
        status, body, _ = _pod_post(http_port, "/tsne/images/mnist_like", {
            "image_name": "pod_tsne", "label_name": "label"})
        check(status == 201, f"pod t-SNE: {status} {body}")
        _pod_wait(http_port, "img.tsne.pod_tsne")
        doc["embed_s"] = time.time() - t0
        after = _pod_launches(_pod_get(http_port, "/cluster")[1])
        rows_launches = {r: after[r].get("tsne_repulsion_rows", 0)
                         - before.get(r, {}).get("tsne_repulsion_rows", 0)
                         for r in after}
        check(all(v == 750 for v in rows_launches.values())
              and len(rows_launches) == POD_RANKS,
              f"pod t-SNE: row-form launches {rows_launches}, not 750 a "
              "rank")
        doc["embed_rows_launches"] = rows_launches
        status, jobs_doc, _ = _pod_get(http_port, "/jobs")
        rec = [j for j in jobs_doc if j["dataset"] == "img.tsne.pod_tsne"]
        spans = {}
        if rec and rec[0].get("trace_id"):
            _, tree, _ = _pod_get(http_port, f"/trace/{rec[0]['trace_id']}")
            for sp in (tree or {}).get("spans", []):
                if sp["name"].startswith(("viz.", "worker.", "dispatch.")):
                    key = f"{sp['name']}@{sp['process']}"
                    spans[key] = spans.get(key, 0.0) + sp["duration_ms"] / 1e3
        doc["embed_spans_s"] = spans
        with open(os.path.join(image_root, "tsne", "pod_tsne.png"),
                  "rb") as f:
            emb = np.load(f)
        labels = store.get("mnist_like").columns["label"]
        check(emb.shape == (TSNE_ROWS, 2) and np.isfinite(emb).all(),
              "pod t-SNE embedding: finite, (60000, 2)")
        emb_pca2, _ = embed_dataset(store, runtime, "pca", "mnist_like",
                                    label="label")
        pick = np.random.default_rng(3).choice(
            TSNE_ROWS, min(5000, TSNE_ROWS), replace=False)
        agree = knn_class_agreement(emb[pick], labels[pick], dev)
        agree_pca = knn_class_agreement(emb_pca2[pick], labels[pick], dev)
        check(agree > agree_pca, f"pod t-SNE 10-NN agreement {agree} <= "
              f"PCA-2's {agree_pca}")
        doc["knn10_agreement"] = agree
        doc["knn10_agreement_pca2"] = agree_pca

        # (e) rank 1 dies during a second build: the chain of recovery
        status, body, _ = _pod_post(http_port, "/models", {
            "training_filename": "train", "test_filename": "test",
            "prediction_filename": "pod2", "classificators_list": families,
            "label": "label", "sync": False})
        check(status == 201, f"pod second POST /models: {status} {body}")
        degraded = _pod_cluster(http_port, lambda d: d["pod_error"],
                                POD_JOB_S)
        launches[0] = _pod_launches(degraded)
        doc["pod_error"] = degraded["pod_error"]
        check(not degraded["healthy"], f"degraded pod: {degraded}")
        status, body, headers = _pod_post(
            http_port, "/histograms/train",
            {"histogram_filename": "pod_refused", "fields": ["label"]})
        check(status == 503 and int(headers.get("Retry-After", 0)) >= 1,
              f"gated route on a degraded pod: {status} {headers} {body}")
        doc["gated_503_retry_after"] = headers["Retry-After"]
        exits = _launch_exits(work)
        killed = [e for e in exits if e["rank"] == 1 and e["epoch"] == 0]
        check(killed and killed[0]["code"] == 41,
              f"rank 1 did not die at its failpoint: {exits}")
        t_kill = killed[0]["t"]
        recovered = _pod_cluster(
            http_port, lambda d: (d["mesh_epoch"] == 1 and d["healthy"]
                                  and d["process_count"] == POD_RANKS),
            POD_JOB_S)
        doc["restarted_s"] = time.time() - t_kill
        again = {c: _pod_wait(http_port, f"pod2_{c}", retried=True)
                 for c in families}
        doc["recovery_s"] = time.time() - t_kill
        for c in families:
            check(again[c]["retries"] == 1
                  and again[c]["accuracy"] == acc[c],
                  f"retried pod2_{c}: {again[c].get('accuracy')} vs "
                  f"{acc[c]}, retries {again[c].get('retries')}")
        final = _pod_get(http_port, "/cluster")[1]
        launches[1] = _pod_launches(final)
        doc["restarts"] = final["restarts"]
        doc["peak_device_bytes"] = {
            r: snap["devices"]["peak_bytes_in_use"]
            for r, snap in final["resources"].items()}
    finally:
        _pod_stop(sup, sup_log)
    doc["supervisor_rc"] = sup.returncode
    by_rank = {}
    for incarnation in launches.values():
        for r, counts in incarnation.items():
            acc_r = by_rank.setdefault(r, {})
            for k, v in counts.items():
                acc_r[k] = acc_r.get(k, 0) + v
    doc["launches_by_rank"] = by_rank
    total = {}
    for counts in by_rank.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    doc["launches"] = total
    for name in SERIAL_KERNELS + ("tsne_repulsion_rows",):
        check(total.get(name, 0) > 0,
              f"kernel {name} was not launched on the pod path")
    doc["seconds"] = time.time() - t_start
    emit(doc)
    return total


#: The model-axis pod: the ranks on a (1, 2) mesh, and mlp at the JAX
#: package's width and defaults on the tune phase's 1M-row set.
POD_TP_MESH = "1,2,1"
POD_TP_HPARAMS = {"hidden": 256, "iters": 300, "lr": 1e-2}
#: The same fit stopped at 60 iterations, where two orders of the same
#: float32 sums still give the same model row by row. Past about 150
#: iterations this fit amplifies any last-bit difference
#: (tests/mlp_divergence_probe.py, 50,000 rows on the CPU): the one-card
#: fit at 1 and 4 threads disagrees on 5.0% of the rows at 300
#: iterations (max |dp| 0.85), the JAX package's (1, 1) and (1, 2) fits
#: on 2.7% (0.50); at 60 iterations on 0.03% and 0.02% (7.8e-3, 7.9e-3).
POD_TP_SHORT_ITERS = 60
#: Model-axis all-reduces of one mlp step (models/mlp.py): the partial
#: logits and the packed standardization sums.
MLP_MODEL_REDUCES_PER_STEP = 2


def _agreement(p_a: np.ndarray, p_b: np.ndarray, y: np.ndarray) -> dict:
    """Two models' test probabilities side by side: the largest
    difference, the share of rows with the same argmax, both
    accuracies."""
    acc = lambda p: float((np.argmax(p, 1) == y).mean())
    return {"max_abs_proba_diff": float(np.abs(p_a - p_b).max()),
            "argmax_agreement": float(
                (np.argmax(p_a, 1) == np.argmax(p_b, 1)).mean()),
            "accuracy": [acc(p_a), acc(p_b)]}


def pod_tp_path(cfg, store, runtime, dev) -> None:
    """Phase 16 of the module docstring: mlp trained tensor-parallel by
    two ranks on a (1, 2) mesh, through rank 0's REST API, against
    one-card fits of the same rows in this process: at 300 iterations
    (accuracy within 0.01) and at 60 (every row: probabilities within
    atol 2e-2, argmax agreement ≥ 0.99, accuracy within 0.01 — the
    tolerances of ``test_torch_mlp.py::test_fit_matches_jax``)."""
    import torch

    from learningorchestra_tpu_torch.catalog.store import DatasetStore
    from learningorchestra_tpu_torch.models.builder import ModelBuilder
    from learningorchestra_tpu_torch.models.persistence import ModelRegistry

    fits = {"podtp": POD_TP_HPARAMS,
            "podtp_short": dict(POD_TP_HPARAMS, iters=POD_TP_SHORT_ITERS)}
    doc = {"phase": "pod_tp", "ranks": POD_RANKS, "backend": "gloo",
           "mesh_shape": POD_TP_MESH, "hparams": fits,
           "train_rows": TUNE_SMALL_ROWS, "test_rows": TEST_ROWS,
           "reduced": {"train_rows": "11,000,000 -> 1,000,000: one (rows, "
                       "256) float32 activation is 11.3 GB at 11M rows, a "
                       "fit holds about four and both ranks share the "
                       "card"},
           "card": card_line()}
    # The one-card fits first, alone on the card.
    mb = ModelBuilder(store, runtime, cfg)
    one, p_one = {}, {}
    for name, hp in fits.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        (rep,) = mb.build("tune_small", "test", f"one_{name}", ["mlp"],
                          "label", hparams={"mlp": hp})
        check("error" not in rep.metrics, f"one-card mlp: {rep.metrics}")
        one[name] = {"fit_time": rep.fit_time,
                     "accuracy": rep.metrics["accuracy"],
                     "peak_device_bytes":
                         torch.cuda.max_memory_allocated(dev)}
        p_one[name] = np.array(list(
            store.get(f"one_{name}_mlp").columns["probability"]), np.float64)
    doc["one_card"] = one
    for name in ("tune_small", "test"):
        store.save(name)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    work = os.path.join(os.path.dirname(cfg.store_root), "pod_tp")
    shutil.rmtree(work, ignore_errors=True)
    t_start = time.time()
    sup, sup_log, http_port = _pod_start(
        cfg, work, {"LO_TPU_MESH_SHAPE": POD_TP_MESH})
    pod = {}
    try:
        info = _pod_cluster(
            http_port, lambda d: (d["process_count"] == POD_RANKS and
                                  str(POD_RANKS - 1) in d["resources"]),
            POD_START_S)
        doc["start_s"] = time.time() - t_start
        check(info["mesh"] == {"data": 1, "model": 2, "seq": 1}
              and info["backend"] == "gloo" and info["healthy"],
              f"pod_tp /cluster: {info}")
        doc["mesh"] = info["mesh"]
        for name, hp in fits.items():
            before = {r: dict(snap.get("collectives") or {})
                      for r, snap in _pod_get(http_port, "/cluster")[1][
                          "resources"].items()}
            t0 = time.time()
            status, body, _ = _pod_post(http_port, "/models", {
                "training_filename": "tune_small", "test_filename": "test",
                "prediction_filename": name, "classificators_list": ["mlp"],
                "label": "label", "hparams": {"mlp": hp}, "sync": False})
            check(status == 201, f"pod_tp POST /models: {status} {body}")
            meta = _pod_wait(http_port, f"{name}_mlp")
            want = MLP_MODEL_REDUCES_PER_STEP * hp["iters"]

            # Rank 1 ships its counts after the job's round: wait for
            # them.
            def moved(d, before=before, want=want):
                return all(
                    (snap.get("collectives") or {}).get(
                        "all_reduce.model", 0)
                    - before.get(r, {}).get("all_reduce.model", 0) >= want
                    for r, snap in d["resources"].items())

            final = _pod_cluster(http_port, moved, 60.0)
            delta = {r: {k: (snap.get("collectives") or {}).get(k, 0)
                         - before[r].get(k, 0)
                         for k in ("all_reduce.model", "all_gather.model")}
                     for r, snap in final["resources"].items()}
            pod[name] = {
                "build_s": time.time() - t0, "fit_time": meta["fit_time"],
                "accuracy": meta["accuracy"],
                "model_collectives": delta,
                "model_all_reduces_per_step": {
                    r: v["all_reduce.model"] / hp["iters"]
                    for r, v in delta.items()},
                "peak_device_bytes": {
                    r: snap["devices"]["peak_bytes_in_use"]
                    for r, snap in final["resources"].items()}}
            check(len(delta) == POD_RANKS and all(
                v == {"all_reduce.model": want, "all_gather.model": 1}
                for v in delta.values()),
                f"pod_tp {name}: model-axis collectives {delta}, want "
                f"{want} all-reduces ({MLP_MODEL_REDUCES_PER_STEP} a "
                "step) and 1 all-gather a rank")
    finally:
        _pod_stop(sup, sup_log)
    doc["supervisor_rc"] = sup.returncode
    doc["pod"] = pod
    _, model = ModelRegistry(cfg).load("podtp_mlp")
    shapes = {k: tuple(model.params[k].shape) for k in ("W1", "W2")}
    doc["saved_shapes"] = shapes
    check(shapes == {"W1": (28, 256), "W2": (256, 2)},
          f"pod_tp saved model shapes {shapes}")
    y = np.asarray(store.get("test").columns["label"])
    reader = DatasetStore(cfg)
    for name in fits:
        p_pod = np.array([_stored(p) for p in _pod_column(
            reader, f"{name}_mlp", "probability")], np.float64)
        check(p_pod.shape == p_one[name].shape == (TEST_ROWS, 2)
              and np.isfinite(p_pod).all(),
              f"pod_tp {name} probabilities {p_pod.shape}, one-card "
              f"{p_one[name].shape}")
        doc[f"{name}_vs_one_card"] = cmp = _agreement(p_pod, p_one[name], y)
        a_pod, a_one = cmp["accuracy"]
        check(a_pod > ACC_FLOOR["lr"] and abs(a_pod - a_one) <= 0.01,
              f"pod_tp {name} against the one-card fit: {cmp}")
    short = doc["podtp_short_vs_one_card"]
    check(short["max_abs_proba_diff"] <= 2e-2
          and short["argmax_agreement"] >= 0.99,
          f"pod_tp at {POD_TP_SHORT_ITERS} iterations against the "
          f"one-card fit: {short}")
    doc["seconds"] = time.time() - t_start
    emit(doc)


def utilization(kind: str, n_train: int, fit_time: float,
                host_prep_s: float) -> dict:
    """A fit's ``mfu`` and ``bw_util``: the port's analytic FLOP and byte
    models (``models/flops.py``, default hyperparameters, 28 features,
    two classes) over the fit's window from its first launch through its
    probability pass's synchronise, which is ``fit_time`` less the host
    prep. (``device_s`` spans only the probability pass: the fit's own
    work completes before it, so a ratio over it would exceed 1.) Under
    overlapped fits the window holds other families' work too, so these
    are lower bounds. Against the card's published peaks, named with the
    card's power limit."""
    from learningorchestra_tpu_torch.models import flops

    window = fit_time - host_prep_s
    f = flops.fit_flops(kind, n_train, 28, 2)
    b = flops.fit_bytes(kind, n_train, 28, 2)
    return {"window_s": window, "fit_flops": f, "fit_bytes": b,
            "mfu": flops.mfu(f, window),
            "bw_util": flops.bw_util(b, window),
            "peak_flops": flops.PEAK_FLOPS, "peak_bw": flops.PEAK_BW,
            "card": card_line()}


@contextlib.contextmanager
def build_slices():
    """The slice count of every ``trees._build_trees`` call made while
    the block runs (from any thread): a list, filled in call order."""
    from learningorchestra_tpu_torch.models import trees

    calls = []
    real = trees._build_trees

    def counted(B, code_idx, *a, **kw):
        calls.append(len(code_idx))
        return real(B, code_idx, *a, **kw)

    trees._build_trees = counted
    try:
        yield calls
    finally:
        trees._build_trees = real


@contextlib.contextmanager
def one_tree_a_call():
    """While the block runs, dt/rf fits grow one tree a ``_build_trees``
    call (a batch width of 1, each tree's draws taken after the last
    tree's, as the batched fit takes them): the forest the batched fit
    must give, bit for bit."""
    from learningorchestra_tpu_torch.models import trees

    real = trees._forest_batch_shape
    trees._forest_batch_shape = lambda n_trees: (1, n_trees)
    try:
        yield
    finally:
        trees._forest_batch_shape = real


def forest_batch_path(store, runtime, dev) -> None:
    """rf at the sweep's shape, batched as ``fit_rf`` grows it against
    one tree a call, in turns: every tree bit-identical, each run's wall
    ms, ``_build_trees`` slices, launches and allocator peak."""
    import torch

    from learningorchestra_tpu_torch.models import trees
    from learningorchestra_tpu_torch.ops import preprocess
    from learningorchestra_tpu_torch.ops import tree_kernels as tk

    train = store.get("train")
    X, y, _, _ = train.memo(("design", "label", json.dumps([])),
                            lambda: preprocess.design_matrix(
                                train, "label", ()))
    edges = trees._edge_prep(X)["edges"]
    tb, nb = trees._forest_batch_shape(FOREST_TREES)

    def batched():
        params = trees.fit_rf(runtime, X, y, 2, n_trees=FOREST_TREES,
                              edges=edges).params
        return {k: params[k] for k in FOREST_PARAMS}

    def one_tree_each():
        with one_tree_a_call():
            return batched()

    runs, forests = [], []
    for path, fn in (("batched", batched), ("one_tree_a_call",
                                            one_tree_each),
                     ("one_tree_a_call", one_tree_each),
                     ("batched", batched)):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        tk.reset_launch_counts()
        with build_slices() as calls:
            t0 = time.time()
            forest = fn()
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
        launches = tk.launch_counts()
        runs.append({"path": path, "wall_ms": wall_ms,
                     "build_calls": list(calls),
                     "launches": {k: v for k, v in launches.items() if v},
                     "allocated_before_bytes": before,
                     "allocator_peak_bytes":
                         torch.cuda.max_memory_allocated(dev)})
        forests.append(forest)
        levels = 5 * (nb if path == "batched" else FOREST_TREES)
        name = "tree_histogram_slices" if path == "batched" else \
            "tree_histogram"
        check(calls == ([tb] * nb if path == "batched"
                        else [1] * FOREST_TREES),
              f"forest_batch {path}: _build_trees slices {calls}")
        check(launches[name] == levels
              and launches[name.replace("histogram", "route_level")]
              == levels,
              f"forest_batch {path}: launches {launches}")
        del forest
    for i, forest in enumerate(forests[1:], 1):
        for k in FOREST_PARAMS:
            check(torch.equal(forest[k], forests[0][k]),
                  f"forest_batch: run {i} ({runs[i]['path']}) param {k} "
                  "differs from the batched fit's")
    emit({"phase": "forest_batch", "card": card_line(), "rows": len(X),
          "trees": FOREST_TREES, "batch": [tb, nb], "runs": runs,
          "trees_equal": True})


def main_path(n_train: int, n_test: int, dev) -> dict:
    """The sweep, then the streamed build, the exploration path and the
    REST server in the same catalog; each path's launch counts are reset
    just before it and read just after. Returns the launches summed over
    the phases."""
    import torch

    from benchmarks.workload import higgs_like_columns
    from learningorchestra_tpu_torch.catalog.store import DatasetStore
    from learningorchestra_tpu_torch.config import Settings
    from learningorchestra_tpu_torch.models.builder import ModelBuilder
    from learningorchestra_tpu_torch.ops import tree_kernels as tk
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
    from learningorchestra_tpu_torch.utils import tracing

    work = os.path.join(ROOT, "build", "chip_smoke_store")
    shutil.rmtree(work, ignore_errors=True)
    cfg = Settings()
    cfg.store_root = os.path.join(work, "store")
    try:
        t0 = time.time()
        store = DatasetStore(cfg)
        store.create("train", columns=higgs_like_columns(n_train, 0),
                     finished=True)
        store.create("test", columns=higgs_like_columns(n_test, 1),
                     finished=True)
        emit({"phase": "datasets", "train_rows": n_train,
              "test_rows": n_test, "seconds": time.time() - t0})
        runtime = DeviceRuntime(cfg, device=str(dev))
        mb = ModelBuilder(store, runtime, cfg)
        families = ["lr", "dt", "rf", "gb", "nb"]
        torch.cuda.synchronize()
        # The sweep's own peak, not the kernel checks' before it.
        torch.cuda.reset_peak_memory_stats(dev)
        tk.reset_launch_counts()
        t0 = time.time()
        with tracing.trace("chip_smoke.build", sampled=True) as ctx:
            reports = mb.build("train", "test", "pred", families, "label")
        build_s = time.time() - t0
        spans = {}
        for sp in tracing.spans_for(ctx.trace_id):
            spans[sp["name"]] = (spans.get(sp["name"], 0.0)
                                 + sp["duration_ms"] / 1e3)
        build_counts = tk.launch_counts()
        t0 = time.time()
        mb.predict("pred_gb", "test", "pred_gb_again")
        torch.cuda.synchronize()
        predict_s = time.time() - t0
        counts = tk.launch_counts()
        acc = {}
        for r in reports:
            check("error" not in r.metrics, f"{r.kind} failed: {r.metrics}")
            doc = store.get(f"pred_{r.kind}").metadata.to_doc()
            check(doc["finished"] and not doc.get("error"), doc)
            for k in ("f1", "accuracy", "fit_time", "device_s"):
                check(k in doc, f"{r.kind} dataset lacks {k}")
            acc[r.kind] = r.metrics["accuracy"]
            emit({"phase": "fit", "family": r.kind,
                  "fit_time": r.fit_time,
                  "device_s": r.metrics["device_s"],
                  "accuracy": r.metrics["accuracy"], "f1": r.metrics["f1"],
                  **utilization(r.kind, n_train, r.fit_time,
                                spans.get(f"fit.{r.kind}.host_prep", 0.0))})
        for kind, floor in ACC_FLOOR.items():
            check(acc[kind] > floor, f"{kind} accuracy {acc[kind]} <= {floor}")
        for kind in ("dt", "rf", "gb"):
            check(acc[kind] > acc["lr"], f"{kind} does not beat lr: {acc}")
        again = store.get("pred_gb_again")
        check(again.metadata.finished and again.num_rows == n_test,
              "predict dataset finished with every test row")
        probs = np.array(list(again.columns["probability"]), np.float64)
        check(probs.shape == (n_test, 2) and np.isfinite(probs).all(),
              "predict probabilities finite, (n_test, 2)")
        check(np.allclose(probs.sum(1), 1.0, atol=1e-5),
              "predict probabilities sum to 1")
        for name in SERIAL_KERNELS:
            check(counts[name] > 0,
                  f"kernel {name} was not launched on the main path")
        emit({"phase": "main_path", "build_s": build_s,
              "predict_s": predict_s, "spans_s": spans,
              "launches_build": build_counts, "launches_total": counts,
              "peak_device_bytes": torch.cuda.max_memory_allocated(dev)})
        forest_batch_path(store, runtime, dev)
        phases = [counts,
                  streamed_path(cfg, store, runtime, dev, acc, spans,
                                build_s),
                  explore_path(store, runtime, dev)]
        serve_counts, serve_ctx = serve_path(cfg, store, dev)
        phases += [serve_counts,
                   serve_workers_path(cfg, dev, serve_ctx),
                   tune_path(cfg, store, dev)]
        tx_path(cfg, dev)
        phases.append(pod_path(cfg, store, runtime, dev, acc))
        pod_tp_path(cfg, store, runtime, dev)
        return {k: sum(p.get(k, 0) for p in phases) for k in KERNELS}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def streamed_path(cfg, store, runtime, dev, acc_resident: dict,
                  resident_spans: dict, resident_build_s: float) -> dict:
    """The streamed (out-of-core) build on the sweep's catalog: the feed
    against the resident design's device copy, the five-family build and
    a predict with ``stream_design`` set, and the rf/gb checkpoint
    resumes. Returns the kernel launches of the phase (the streamed
    build and predict, and the resumed fits)."""
    import torch

    from learningorchestra_tpu_torch.catalog import readpipe
    from learningorchestra_tpu_torch.models import trees
    from learningorchestra_tpu_torch.models.builder import ModelBuilder
    from learningorchestra_tpu_torch.ops import preprocess
    from learningorchestra_tpu_torch.ops import tree_kernels as tk
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
    from learningorchestra_tpu_torch.utils import failpoints, fitckpt, tracing

    train = store.get("train")
    doc = {"phase": "streamed", "card": card_line()}
    # (a) The feed. The sweep's design matrix (memoized on the dataset)
    # and its cached device copy are the resident reference.
    X_res, y_res, _, _ = train.memo(
        ("design", "label", json.dumps([])),
        lambda: preprocess.design_matrix(train, "label", ()))
    dev_res, n = runtime.shard_rows(X_res)
    prof = {}
    t0 = time.time()
    Xs, ys, _, _ = preprocess.design_matrix_streamed(train, "label", (),
                                                     profile=prof)
    doc["state_fit_s"] = time.time() - t0
    doc["fit_passes"] = prof["fit_passes"]
    check(np.array_equal(ys, y_res), "streamed labels differ from resident")
    feed_rt = DeviceRuntime(cfg, device=str(dev))      # an empty cache
    blk = feed_rt.FEED_BLOCK_ROWS
    rp0 = readpipe.snapshot()
    torch.cuda.synchronize()
    t0 = time.time()
    dev_s, n_s = feed_rt.shard_rows(Xs)
    torch.cuda.synchronize()
    feed_s = time.time() - t0
    rp1 = readpipe.snapshot()
    nbytes = dev_s.numel() * dev_s.element_size()
    check(n_s == n and torch.equal(dev_s, dev_res),
          "the streamed feed's tensor differs from the resident device copy")
    blocks = -(-n_s // blk)
    doc["feed"] = {
        "rows": n_s, "block_rows": blk, "blocks": blocks,
        "pinned_bytes": (min(2, blocks) * min(blk, n_s) * dev_s.shape[1]
                         * dev_s.element_size()),
        "prefetch_stalls": rp1["prefetch_stalls"] - rp0["prefetch_stalls"],
        "prefetched_blocks": (rp1["prefetched_chunks"]
                              - rp0["prefetched_chunks"]),
        "seconds": feed_s, "gb_per_s": nbytes / feed_s / 1e9,
        "bytes": nbytes}
    del dev_s, feed_rt, Xs

    # (b) The build, and (c) the predict, with stream_design set.
    families = list(acc_resident)
    mb = ModelBuilder(store, runtime, cfg.replace(stream_design=True))
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t0 = time.time()
    with tracing.trace("chip_smoke.streamed", sampled=True) as ctx:
        reports = mb.build("train", "test", "spred", families, "label")
    doc["build_s"] = time.time() - t0
    spans = {}
    for sp in tracing.spans_for(ctx.trace_id):
        spans[sp["name"]] = (spans.get(sp["name"], 0.0)
                             + sp["duration_ms"] / 1e3)
    doc["design_s"] = spans.get("design.build")
    doc["resident"] = {"build_s": resident_build_s,
                       "design_s": resident_spans.get("design.build")}
    acc = {}
    for r in reports:
        check("error" not in r.metrics, f"streamed {r.kind}: {r.metrics}")
        acc[r.kind] = r.metrics["accuracy"]
    doc["accuracy"] = acc
    for kind in ("lr", "nb"):
        check(acc[kind] == acc_resident[kind],
              f"streamed {kind} accuracy {acc[kind]} != resident "
              f"{acc_resident[kind]}")
    for kind in ("dt", "rf", "gb"):
        check(acc[kind] > ACC_FLOOR[kind]
              and abs(acc[kind] - acc_resident[kind]) <= 0.01
              and acc[kind] > acc["lr"],
              f"streamed {kind} accuracy {acc[kind]} (resident "
              f"{acc_resident[kind]}, floor {ACC_FLOOR[kind]}, lr "
              f"{acc['lr']})")
    t0 = time.time()
    mb.predict("pred_gb", "test", "spred_gb_again")
    torch.cuda.synchronize()
    doc["predict_s"] = time.time() - t0
    counts = tk.launch_counts()
    doc["launches"] = dict(counts)
    for name in SERIAL_KERNELS:
        check(counts[name] > 0,
              f"kernel {name} was not launched by the streamed path")
    got, want = store.get("spred_gb_again"), store.get("pred_gb_again")
    check(got.metadata.finished and got.num_rows == want.num_rows,
          "streamed predict finished with every test row")
    p_s = np.array(list(got.columns["probability"]), np.float64)
    p_r = np.array(list(want.columns["probability"]), np.float64)
    check(np.array_equal(p_s, p_r)
          and np.array_equal(got.columns["prediction"],
                             want.columns["prediction"]),
          "streamed predict differs from the resident predict")

    # (d) Checkpointed rf and gb on the resident codes: uninterrupted,
    # crashed at the second checkpoint, resumed.
    edges = trees._edge_prep(X_res)["edges"]
    ck_cfg = cfg.replace(fit_ckpt_rounds=5)
    resume = {}
    for fam, fit in (("rf", trees.fit_rf), ("gb", trees.fit_gb)):
        oracle = fit(runtime, X_res, y_res, 2, edges=edges)
        ctx = fitckpt.context(ck_cfg, dataset="train", family=fam,
                              config={"chip_smoke": fam},
                              snapshot=f"rows={n}")
        ctx.clear()
        failpoints.configure("fit.ckpt.pre_rename=raise:2")
        try:
            fit(runtime, X_res, y_res, 2, edges=edges, ckpt=ctx)
            crashed = False
        except failpoints.FailpointError:
            crashed = True
        finally:
            failpoints.reset()
        saved = ctx.load()
        check(crashed and saved is not None and saved[0] == 5,
              f"{fam}: the crash at the second checkpoint left "
              f"{saved and saved[0]}")
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        t0 = time.time()
        resumed = fit(runtime, X_res, y_res, 2, edges=edges, ckpt=ctx)
        torch.cuda.synchronize()
        resume[fam] = {"resumed_at": saved[0], "seconds": time.time() - t0,
                       "launches": tk.launch_counts()}
        for k, v in oracle.params.items():
            check(torch.equal(v, resumed.params[k]),
                  f"{fam} resume: param {k} differs from the "
                  "uninterrupted fit")
        ctx.clear()
        for k, v in resume[fam]["launches"].items():
            counts[k] += v
    doc["resume"] = resume
    doc["resume_rows"] = n
    emit(doc)
    return counts


def build_all() -> None:
    """Both kernel sources, one nvcc each, started together."""
    from learningorchestra_tpu_torch.ops import tree_kernels as tk
    from learningorchestra_tpu_torch.ops import tsne_kernels as tsk

    def one(mod):
        # A fresh checkout has no library yet, so this is the whole nvcc
        # build; "fresh" says whether it was.
        fresh = not mod.library_path().exists()
        t0 = time.time()
        mod.build()
        return {"source": os.path.relpath(mod.SOURCE, ROOT),
                "seconds": time.time() - t0, "fresh": fresh,
                "kernels": kernel_report(mod)}

    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        builds = list(pool.map(one, (tk, tsk)))
    emit({"phase": "build", "seconds": time.time() - t0,
          "sources": builds})
    # The feature-major copy moves its bytes 16 at a time and transposes
    # from 32-bit shared words: no spills, 16-B cp.async loads and 16-B
    # stores in its code, no byte-wide shared load.
    fm = builds[0]["kernels"].get("feature_major_kernel", {})
    sass = fm.get("sass")
    check(fm.get("spill_bytes") == 0, f"feature_major_kernel spills: {fm}")
    if sass is not None:
        check(any(k.startswith("LDGSTS") and "128" in k for k in sass)
              and "STG.E.128" in sass and "LDS.U8" not in sass,
              f"feature_major_kernel's loads and stores: {sass}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-rows", type=int, default=11_000_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    t_start = time.time()
    dev = torch.device("cuda", 0)
    emit({"phase": "card", "nvidia_smi": card_line(),
          "clocks_max_sm": card_line("clocks.max.sm"),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    build_all()
    atoms = check_atomics_probe(dev)
    results = check_kernels(args.train_rows, TEST_ROWS, dev, atoms)
    torch.cuda.empty_cache()
    results.update(check_slice_kernels(args.train_rows, dev, atoms))
    torch.cuda.empty_cache()
    results["tsne_repulsion"] = check_tsne_kernel(dev)
    results["tsne_repulsion_rows"] = check_rows_kernel(dev)
    results["tree_histogram"]["fixed_form"] = check_fixed_forms(
        -(-args.train_rows // POD_RANKS), dev)
    check_concurrent_launches(dev)
    torch.cuda.empty_cache()
    check_small_reference(dev)
    check_tsne_small_reference(dev)
    counts = main_path(args.train_rows, TEST_ROWS, dev)
    emit({"phase": "total", "seconds": time.time() - t_start})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **({} if rep else {"part_of": "tree_route_level"}),
         "launches": counts[name], **results[name]}
        for name, (src, rep) in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
