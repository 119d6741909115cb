"""Faults planted underneath a run's timed path, each of which its
cell's correctness check has to catch (``correct`` false). The CPU tests
plant them at small sizes; on a card,

    python3 -m portbench.faults --workload <name> --fault <fault> \\
        --seconds <s> --seeds <n> [<n> ...]

runs the cell at its own size once a seed with the fault planted and
prints one JSON line a seed: ``correct`` and each number compared
beside its limit. The benchmark's own runs never plant one.

A fault is a function of a ``Patch`` (``setattr`` that ``undo``
reverses) and the cell's kind.
"""

from __future__ import annotations

import argparse
import builtins
import json
import sys
import time
from pathlib import Path

import numpy as np


class Patch:
    """``setattr`` that remembers the old values, and ``undo``."""

    def __init__(self):
        self._old = []

    def setattr(self, obj, name: str, value) -> None:
        self._old.append((obj, name, getattr(obj, name, None),
                          hasattr(obj, name)))
        setattr(obj, name, value)

    def undo(self) -> None:
        for obj, name, value, had in reversed(self._old):
            if had:
                setattr(obj, name, value)
            else:
                delattr(obj, name)
        self._old.clear()


def unchanged_state(patch: Patch, kind: str) -> None:
    """A step that returns its state unchanged: gb's margin update, the
    tune's forest segments, every t-SNE step."""
    if kind == "tune":
        from learningorchestra_tpu_torch.models import tune

        def stay(self, k):
            self.done_b += k

        patch.setattr(tune._ForestDriver, "run_segment", stay)
    elif kind == "build":
        from learningorchestra_tpu_torch.models import trees

        patch.setattr(trees, "_margin_step", lambda margin, *a, **k: margin)
    else:
        from learningorchestra_tpu_torch.viz import tsne

        patch.setattr(tsne, "_step",
                      lambda Y, vel, gains, *a, **k: (Y, vel, gains))


def half_batch(patch: Patch, kind: str) -> None:
    """Half of the rows left out: of the folds' training rows, of the
    rows put on the device, of the t-SNE repulsion."""
    if kind == "tune":
        from learningorchestra_tpu_torch.models import tune

        orig = tune._fold_masks

        def half(n, padded, folds):
            fids, tr, ev = orig(n, padded, folds)
            tr = tr.copy()
            tr[:, 1::2] = 0.0
            return fids, tr, ev

        patch.setattr(tune, "_fold_masks", half)
    elif kind == "build":
        from learningorchestra_tpu_torch.parallel.runtime import (
            DeviceRuntime)

        orig = DeviceRuntime.shard_rows

        def half(self, arr):
            t, n = orig(self, arr)
            return t[: n // 2], n // 2

        patch.setattr(DeviceRuntime, "shard_rows", half)
    else:
        from learningorchestra_tpu_torch.ops import tsne_kernels

        orig = tsne_kernels.tsne_repulsion

        def half(Y, valid):
            keep = valid.clone()
            keep[1::2] = 0
            return orig(Y, keep)

        patch.setattr(tsne_kernels, "tsne_repulsion", half)


def altered_answer(patch: Patch, kind: str) -> None:
    """An answer altered where it is produced: the fold scores written,
    one prediction in 50, one row of the embedding."""
    if kind == "tune":
        from learningorchestra_tpu_torch.models import tune

        orig = tune.sweep

        def shifted(*a, **k):
            board = orig(*a, **k)
            for r in board["results"]:
                r["fold_scores"] = [s + 0.01 for s in r["fold_scores"]]
            return board

        patch.setattr(tune, "sweep", shifted)
    elif kind == "build":
        from learningorchestra_tpu_torch.models.builder import ModelBuilder

        orig = ModelBuilder._save_predictions

        def flip(self, name, test_ds, preds, probs, report):
            preds = preds.copy()
            preds[::50] = 1 - preds[::50]
            return orig(self, name, test_ds, preds, probs, report)

        patch.setattr(ModelBuilder, "_save_predictions", flip)
    else:
        from learningorchestra_tpu_torch.viz import service

        orig = service.tsne_embed

        def shift(*a, **k):
            out = np.array(orig(*a, **k))
            out[0] += 1.0
            return out

        patch.setattr(service, "tsne_embed", shift)


def _step_fault(patch: Patch, change) -> None:
    """Wraps ``viz.tsne._step``: ``change(i, args, out)`` gives step i's
    returned state, ``i`` counted from each descent's first step (zero
    velocity, gains of 1)."""
    from learningorchestra_tpu_torch.viz import tsne

    orig = tsne._step
    count = {"i": 0}

    def step(Y, vel, gains, *a, **k):
        if not bool((vel != 0).any()) and bool((gains == 1).all()):
            count["i"] = 0          # a descent's first step
        out = orig(Y, vel, gains, *a, **k)
        res = change(count["i"], (Y, vel, gains) + a, out)
        count["i"] += 1
        return res

    patch.setattr(tsne, "_step", step)


def frozen_after_first(patch: Patch, kind: str) -> None:
    """t-SNE: every step after each descent's first returns its state
    unchanged."""
    _step_fault(patch, lambda i, args, out: out if i == 0 else args[:3])


def late_switch(patch: Patch, kind: str) -> None:
    """t-SNE: the exaggerated phase's schedule (exaggeration 12,
    momentum 0.5) kept for 10 steps past its end."""
    from learningorchestra_tpu_torch.viz import tsne

    orig = tsne._step

    def step(Y, vel, gains, sym_idx, sym_w, ov_src, ov_dst, ov_w, n_valid,
             exaggeration, eta, momentum, *a, **k):
        if exaggeration == 1.0 and step.late > 0:
            exaggeration, momentum = 12.0, 0.5
            step.late -= 1
        elif exaggeration != 1.0:
            step.late = 10
        return orig(Y, vel, gains, sym_idx, sym_w, ov_src, ov_dst, ov_w,
                    n_valid, exaggeration, eta, momentum, *a, **k)

    step.late = 0
    patch.setattr(tsne, "_step", step)


def gains_reset(patch: Patch, kind: str) -> None:
    """t-SNE: every step hands on gains of 1 instead of its own."""
    import torch

    _step_fault(patch, lambda i, args, out: (out[0], out[1],
                                             torch.ones_like(out[2])))


def worst_half(patch: Patch, kind: str) -> None:
    """The tune: successive halving keeps the worst half of each rung."""
    from learningorchestra_tpu_torch.models import tune

    def ordered(seq, key=None, reverse=False):
        out = builtins.sorted(seq, key=key, reverse=reverse)
        return out[::-1] if isinstance(seq, np.ndarray) else out

    patch.setattr(tune, "sorted", ordered)


#: The faults each kind of cell can have.
FAULTS = {
    "build": {"unchanged_state": unchanged_state, "half_batch": half_batch,
              "altered_answer": altered_answer},
    "tsne": {"unchanged_state": unchanged_state, "half_batch": half_batch,
             "altered_answer": altered_answer,
             "frozen_after_first": frozen_after_first,
             "late_switch": late_switch, "gains_reset": gains_reset},
    "tune": {"unchanged_state": unchanged_state, "half_batch": half_batch,
             "altered_answer": altered_answer, "worst_half": worst_half},
}


def run_with(fault: str, spec: dict, seed: int, seconds: float,
             device: str) -> dict:
    """One run of the cell with ``fault`` planted."""
    from portbench import harness

    kind = spec["traffic"]["kind"]
    patch = Patch()
    FAULTS[kind][fault](patch, kind)
    try:
        return harness.run_cell(spec, seed, seconds, False, device=device,
                                t_start=time.monotonic())
    finally:
        patch.undo()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from portbench import harness

    root = Path.cwd()
    spec = harness.cell_spec(harness.load_benchmark(root), root,
                             args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench.faults: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        doc = run_with(args.fault, spec, seed, args.seconds, "cuda")
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": doc["correct"],
                          "failed": doc["failed"],
                          "checks": doc["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
