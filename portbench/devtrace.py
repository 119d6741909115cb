"""What a traced run reads from the card: the profiler's device
activity, the needed work of each call of the port's kernels, and the
host spans that label the device's idle time.

- ``KernelWork`` wraps the port's kernel launch functions for the
  window and counts each call's needed work from its problem shape
  (``counts``). Where the work depends on the data (the rows active at
  a level, the rows that move) the count is a small reduction queued on
  the card beside the call, read once the window has closed, so the
  host never waits for the card inside the window.
- ``DeviceTrace`` runs ``torch.profiler`` over the window with CUDA
  activity only and reduces it to device-busy seconds, the window's
  length, device time by kernel name and idle gaps labelled by the
  innermost program span open across them.
"""

from __future__ import annotations

import heapq
import re
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench import counts

#: A kernel of the port: a ``__global__`` function named ``*_kernel``.
_GLOBAL = re.compile(r"__global__.*?\b(\w+_kernel)\s*\(", re.S)


def port_kernel_names(package_dir: Path) -> List[str]:
    """The names of the port's own CUDA kernels, read from its sources."""
    names = []
    for src in sorted((package_dir / "csrc").glob("*.cu")):
        names += _GLOBAL.findall(src.read_text())
    return sorted(set(names))


class KernelWork:
    """Needed bytes and operations of every call of the port's kernels
    made while installed."""

    def __init__(self):
        self._calls: List[tuple] = []
        self._saved: List[tuple] = []

    def _add(self, nbytes, ops) -> None:
        self._calls.append((nbytes, ops))

    def install(self) -> None:
        from learningorchestra_tpu_torch.ops import tree_kernels as tk
        from learningorchestra_tpu_torch.ops import tsne_kernels as tsk

        def wrap(mod, name, count):
            orig = getattr(mod, name)

            def wrapped(*args, **kw):
                out = orig(*args, **kw)
                if isinstance(out, torch.Tensor) and out.is_cuda:
                    count(out, *args, **kw)
                elif isinstance(out, tuple) and out and out[0].is_cuda:
                    count(out, *args, **kw)
                return out

            self._saved.append((mod, name, orig))
            setattr(mod, name, wrapped)

        def hist(out, codes, code_idx, stats_T, rel, active, n_nodes,
                 n_bins, max_abs, *, fixed, **_):
            G, P = len(code_idx), codes.shape[0]
            n, d = codes.shape[1], codes.shape[2]
            S = stats_T.shape[1]
            act = active.sum(dtype=torch.float64)
            mats = [[g for g in range(G) if int(code_idx[g]) == p]
                    for p in range(P)]
            rows = sum(active[gs].any(0).sum(dtype=torch.float64)
                       for gs in mats if gs)
            nbytes, ops = counts.hist_work(G, n, d, n_bins, S, n_nodes,
                                           act, rows,
                                           8 if fixed else 4)
            self._add(nbytes, ops)

        def leaf(out, assign, stats_T, n_nodes, max_abs, *, fixed, **_):
            G, n = assign.shape
            self._add(*counts.leaf_work(G, n, stats_T.shape[1], n_nodes,
                                        8 if fixed else 4))

        def route(out, codes, code_idx, rel, active, assign, best_f,
                  best_t, split, **_):
            moving = (split.bool().gather(1, rel.long()) & active).sum(
                dtype=torch.float64)
            self._add(*counts.route_work(len(code_idx), codes.shape[1],
                                         best_f.shape[1], moving))

        def transpose(out, codes):
            P = 1 if codes.dim() == 2 else codes.shape[0]
            self._add(*counts.feature_major_work(P, codes.shape[-2],
                                                 codes.shape[-1]))

        def descend(out, codes, code_idx, feat, thr, internal, **_):
            G, T, M = feat.shape
            self._add(*counts.descend_work(G, T, codes.shape[1],
                                           codes.shape[0], M))

        def repulsion(out, Y, valid):
            nv = valid.sum(dtype=torch.float64)
            self._add(*counts.repulsion_work(Y.shape[0], nv))

        wrap(tk, "_hist_launch", hist)
        wrap(tk, "_leaf_launch", leaf)
        wrap(tk, "tree_route_level_slices", route)
        wrap(tk, "feature_major", transpose)
        wrap(tk, "tree_descend_slices", descend)
        wrap(tsk, "tsne_repulsion", repulsion)

    def uninstall(self) -> None:
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved.clear()

    def bound_seconds(self) -> Optional[float]:
        """Summed bound seconds of the calls, or None without a call."""
        if not self._calls:
            return None
        total = 0.0
        for nbytes, ops in self._calls:
            total += counts.bound_s(float(nbytes), float(ops))
        return total


def _event_times(ev):
    if hasattr(ev, "start_ns"):
        return ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
    return ev.start_us() * 1e-6, ev.duration_us() * 1e-6


def _short(name: str) -> str:
    """A kernel's name without its namespace decoration and arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].strip()[:120]


class DeviceTrace:
    """The profiler over one window, reduced after it closes."""

    MARK_CYCLES = 1000

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.mark_wall = None
        self.events: List[tuple] = []

    def start(self) -> None:
        self._prof.__enter__()
        torch.cuda.synchronize()
        # A marker kernel launched at a known host time ties the
        # profiler's clock to the host's.
        self.mark_wall = time.time()
        torch.cuda._sleep(self.MARK_CYCLES)
        torch.cuda.synchronize()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.events = self._read()

    def _read(self) -> List[tuple]:
        out = []
        res = getattr(self._prof.profiler, "kineto_results", None)
        if res is not None:
            for ev in res.events():
                if "CUDA" not in str(ev.device_type()):
                    continue
                start, dur = _event_times(ev)
                out.append((start, start + dur, ev.name()))
        else:
            for ev in self._prof.events():
                if "CUDA" not in str(ev.device_type):
                    continue
                tr = ev.time_range
                out.append((tr.start * 1e-6, tr.end * 1e-6, ev.name))
        out.sort()
        return out

    def summary(self, window_wall: tuple, spans: List[dict],
                port_kernels: List[str]) -> Dict:
        """busy_s and window_s over the window (host wall times
        ``window_wall``), device seconds of the port's kernels, the ten
        longest device operations by name, and idle gaps by the
        innermost span open across them."""
        marks = [e for e in self.events if "spin_kernel" in e[2]
                 or "sleep" in e[2].lower()]
        if marks:
            offset = marks[0][0] - self.mark_wall
            events = [e for e in self.events if e is not marks[0]]
        elif self.events:
            offset = self.events[0][0] - window_wall[0]
            events = self.events
        else:
            return {}
        w0, w1 = window_wall[0] + offset, window_wall[1] + offset
        by_name: Dict[str, float] = {}
        port_s = 0.0
        merged: List[list] = []
        for s, e, name in events:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            key = _short(name)
            by_name[key] = by_name.get(key, 0.0) + (e - s)
            if any(k in name for k in port_kernels):
                port_s += e - s
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged)
        # Host spans on the device clock, for labelling the gaps: a sweep
        # over the gaps in time order, the open spans in a heap by
        # duration (an ended span leaves it when it reaches the top).
        host = sorted((sp["start"] + offset, sp["start"] + offset
                       + sp["duration_ms"] / 1e3, sp["name"])
                      for sp in spans)
        gaps: Dict[str, float] = {}
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        open_: list = []
        nxt = 0
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            while nxt < len(host) and host[nxt][0] <= mid:
                s0, e0, name = host[nxt]
                heapq.heappush(open_, (e0 - s0, e0, name))
                nxt += 1
            while open_ and open_[0][1] < mid:
                heapq.heappop(open_)
            label = open_[0][2] if open_ else "harness"
            gaps[label] = gaps.get(label, 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy, "window_s": w1 - w0, "port_kernel_s": port_s,
                "device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in idle]}
