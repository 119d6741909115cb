"""Device-resident hyperparameter search — config populations on one card.

A sweep fits a POPULATION of same-family configs over one resident
design, as the JAX package's ``models/tune.py`` does:

- **populations**: each config is fitted on each fold, one population
  member per (config, fold). The tree families grow tree t of every live
  member in the same kernel launches — one slice of the histogram,
  routing, leaf and descent kernels a member (``trees._build_trees``) —
  the one-card counterpart of the JAX package's vmapped member axis.
  lr and mlp members run one at a time through the serial fit's step
  (a batched product would tile differently and drift by ulps). Static
  shapes are the population's maxima (max_depth, n_bins); a member's
  smaller depth and bin count ride as masks that reproduce its own fit,
  so per-config results equal serial fits exactly for dt/rf/lr/mlp (gb:
  within 0.02 of the serial fit's accuracy, the JAX package's standard).
- **masked k-fold CV**: fold membership is the index predicate
  ``row % folds == fold`` evaluated into per-member row-weight masks
  over the one resident (n, d) design — never a data copy.
- **successive halving on checkpoint rungs**: the family's natural
  segment boundaries (tree batches, boost rounds, solver iterations)
  are the rungs. After each rung every live candidate's fold scores are
  taken, the bottom half of the surviving configs is dropped (a dropped
  member is simply not advanced — the survivors' arithmetic is
  untouched), and the population state is checkpointed
  (utils/fitckpt.py), so a crashed sweep resumes to identical survivors
  and scores.
- **population sizing**: a member's device footprint is modeled
  analytically and raised to the family's recorded ``peak_hbm_bytes``
  watermark (utils/resources.py); the largest candidate count that fits
  ``tune_hbm_budget_mb`` runs as one wave, extras spill into sequential
  waves (``lo_tune_hbm_spill_waves_total`` on ``/metrics``).

One card holds every row, so a member's rows are the design's n rows
(no padding), and member arrays are placed with ``.to(device)``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from learningorchestra_tpu_torch import jobs
from learningorchestra_tpu_torch.models import logistic, mlp, trees
from learningorchestra_tpu_torch.models.base import as_design
from learningorchestra_tpu_torch.models.registry import validate_hparams
from learningorchestra_tpu_torch.utils import fitckpt, resources, tracing
from learningorchestra_tpu_torch.utils.structlog import get_logger

log = get_logger("tune")

#: Families with a population fit path. nb is a closed-form single pass
#: (nothing to halve).
POP_FAMILIES = ("dt", "rf", "gb", "lr", "mlp")

#: Wave stride for the fitckpt progress integer: progress = wave *
#: stride + units done in the wave stays monotone while no wave exceeds
#: a million units.
_WAVE_STRIDE = 1_000_000

# -- /metrics counters (the ``tune`` section) ---------------------------------

_counter_lock = threading.Lock()
_counters = {
    "populations_fitted": 0,     # waves run to completion
    "candidates_evaluated": 0,   # configs that received a final score
    "rungs_completed": 0,        # segment+score rounds across all waves
    "halving_drops": 0,          # configs dropped before their budget
    "hbm_spill_waves": 0,        # extra waves forced by the memory budget
    "sweeps_resumed": 0,         # sweeps continued from a checkpoint
}


def _bump(key: str, by: int = 1) -> None:
    with _counter_lock:
        _counters[key] += by


def counters_snapshot() -> Dict[str, int]:
    with _counter_lock:
        return dict(_counters)


# -- validation ---------------------------------------------------------------

def validate_population(family: str, configs: Sequence[Dict[str, Any]],
                        num_classes: Optional[int] = None) -> None:
    """Reject sweeps the population programs cannot run faithfully.

    Beyond per-config hparam validation (unknown names / out-of-range
    values → the serving tier's 406), members must agree where their
    programs would otherwise differ: rf members share ``n_trees`` (the
    JAX package's bootstrap keys depend on the tree count, and the two
    packages keep one rule); lr members resolve to one solver; gb's
    population path is the binary booster."""
    if family not in POP_FAMILIES:
        raise ValueError(
            f"classifier {family!r} has no population tune path; "
            f"choose from {sorted(POP_FAMILIES)}")
    if not configs or not isinstance(configs, (list, tuple)):
        raise ValueError("tune needs a non-empty list of configs")
    for c in configs:
        validate_hparams(family, c)
    if family == "rf":
        if len({int(c.get("n_trees", 20)) for c in configs}) != 1:
            raise ValueError(
                "rf tune populations must share n_trees: the bootstrap "
                "draws depend on the tree count, so mixed forest sizes "
                "cannot be faithful to standalone fits — sweep n_trees "
                "across separate tune calls")
    if family == "lr":
        if len({_resolve_solver(c, num_classes) for c in configs}) != 1:
            raise ValueError(
                "lr tune populations must resolve to one solver "
                "(newton and adam are different programs); pin 'solver' "
                "explicitly or split the sweep")
    if family == "gb" and num_classes is not None and num_classes != 2:
        raise ValueError(
            "gb tune populations support the binary reference-parity "
            "booster only (num_classes == 2)")


def _resolve_solver(config: Dict[str, Any],
                    num_classes: Optional[int]) -> str:
    """A config's solver as far as validation can tell: d is unknown
    here, so ``auto`` stays ``auto`` (the driver resolves it per sweep);
    configs agree when all name the same solver or all say auto."""
    return str(config.get("solver", "auto"))


# -- population sizing --------------------------------------------------------

def _per_member_bytes(family: str, n: int, d: int,
                      num_classes: int) -> float:
    """Modeled device bytes of ONE population member: its share of the
    wave's working set. Deliberately coarse — it is raised to the
    family's recorded whole-fit watermark in ``plan_waves``.

    Every member holds its train and eval row weights (8 B a row). A tree
    member growing its tree holds its stats (4 B a row and class, or
    gradient and hessian), node ids, flags and the routing output (17 B
    a row), and its share of the bin matrices and their feature-major
    copies (2·d B a row: counted per member, though members of one n_bins
    share them); rf adds the bootstrap weights, gb the margin and its
    round's probability, gradient and hessian. lr and mlp members run
    one at a time and share one step's transients, but a wave's width
    scales with these bytes, so each member counts them: the design's
    float32 copy (standardized, 4·d B a row), its logits (4 B a row and
    class) and, for mlp, its hidden activations (the JAX package's 2 B a
    row and hidden unit, at the serial default of 256)."""
    C = float(max(num_classes, 2))
    nf = float(n)
    masks = 8.0 * nf
    codes = 2.0 * nf * d
    if family in ("dt", "rf"):
        return masks + codes + 4.0 * nf * (C + 1.0) + 17.0 * nf
    if family == "gb":
        return masks + codes + 8.0 * nf + 16.0 * nf + 17.0 * nf + 4.0 * nf
    step = masks + 4.0 * nf * d + 4.0 * nf * C
    return step if family == "lr" else step + 2.0 * nf * 256.0


def plan_waves(family: str, configs: Sequence[Dict[str, Any]], *, n: int,
               d: int, num_classes: int, folds: int,
               cfg) -> List[List[int]]:
    """Split config indices into sequential population waves.

    Wave width = the largest count whose modeled footprint
    (``_per_member_bytes`` raised to the family's recorded
    ``peak_hbm_bytes`` watermark, × folds members per config) fits
    ``tune_hbm_budget_mb``, capped by ``tune_max_population`` members.
    Budget 0 = one wave (up to the cap)."""
    cap = max(1, int(cfg.tune_max_population) // max(folds, 1))
    budget = float(cfg.tune_hbm_budget_mb) * (1 << 20)
    if budget > 0:
        per = _per_member_bytes(family, n, d, num_classes)
        wm = resources.family_watermarks().get(family, {})
        per = max(per, float(wm.get("peak_hbm_bytes", 0)))
        fit = int(budget // max(per * max(folds, 1), 1.0))
        width = max(1, min(cap, fit))
    else:
        width = cap
    idxs = list(range(len(configs)))
    waves = [idxs[i:i + width] for i in range(0, len(idxs), width)]
    if len(waves) > 1 and budget > 0:
        _bump("hbm_spill_waves", len(waves) - 1)
    return waves


# -- fold masks ---------------------------------------------------------------

def _fold_masks(n: int, padded: int, folds: int
                ) -> Tuple[List[int], np.ndarray, np.ndarray]:
    """(fold_ids, train_masks (F, padded), eval_masks (F, padded)) as
    f32 row weights over the padded global row index. Fold membership is
    ``row % folds == fid``; fid = -1 (folds <= 1) trains AND scores on
    every valid row."""
    idx = np.arange(padded)
    valid = (idx < n).astype(np.float32)
    if folds <= 1:
        return [-1], valid[None, :], valid[None, :]
    fids = list(range(folds))
    ev = np.stack([valid * (idx % folds == f) for f in fids]
                  ).astype(np.float32)
    tr = valid[None, :] - ev
    return fids, tr, ev


# -- family drivers -----------------------------------------------------------
#
# A driver owns one wave's device state. Interface:
#   total_units()            — the wave's unit budget (max over members)
#   run_segment(k)           — advance every live member k units
#   scores()                 — per-MEMBER eval-fold accuracy, (Pm,) np
#                              (live members; dropped ones read 0)
#   set_alive(alive_configs) — (n_cfg,) 0/1; dropped members stop
#   ckpt_arrays()            — host arrays for fitckpt.save
#   restore(units, arrays)   — rebuild device state mid-wave
#
# Members are (config, fold) pairs flattened config-major: member
# m = ci * folds + fi.


class _Population:
    """What every driver holds: the configs, fold count, member row
    weights on the device and the live set."""

    def __init__(self, runtime, X, y, configs, fold_ids, tr_masks,
                 ev_masks):
        self.configs = configs
        self.nf = len(fold_ids)
        self.Pm = len(configs) * self.nf
        self.X = as_design(X)
        self.X_dev, self.n = runtime.shard_rows(self.X)
        self.dev = self.X_dev.device
        self.y_dev, _ = runtime.shard_rows(np.asarray(y, np.int32))
        self.w_base = torch.from_numpy(np.asarray(tr_masks)).to(self.dev)
        self.ew = torch.from_numpy(np.asarray(ev_masks)).to(self.dev)
        self.alive = np.ones(self.Pm, np.float32)

    def rep(self, values) -> np.ndarray:
        """Per-config values repeated to members (config-major)."""
        return np.repeat(np.asarray(values), self.nf, axis=0)

    def live(self) -> List[int]:
        return [m for m in range(self.Pm) if self.alive[m] > 0]

    def set_alive(self, alive_configs: np.ndarray) -> None:
        self.alive = self.rep(alive_configs.astype(np.float32))

    def member_scores(self, live: List[int], scores) -> np.ndarray:
        out = np.zeros(self.Pm, np.float64)
        out[live] = scores
        return out


class _TreePopulation(_Population):
    """dt / rf / gb: per-config quantile edges at the config's own
    n_bins, padded to the population's largest with +inf; one bin matrix
    per distinct n_bins; per-member bin and level masks."""

    _names: Tuple[str, ...] = ()

    def __init__(self, runtime, X, y, configs, fold_ids, tr_masks,
                 ev_masks):
        super().__init__(runtime, X, y, configs, fold_ids, tr_masks,
                         ev_masks)
        d = self.X.shape[1]
        depths = [int(c.get("max_depth", 5)) for c in configs]
        nbins = [int(c.get("n_bins", 32)) for c in configs]
        self.max_depth = max(depths)
        self.n_bins = max(nbins)
        self.M = 2 ** (self.max_depth + 1) - 1
        sample = (self.X if isinstance(self.X, np.ndarray)
                  else self.X.sample_rows(200_000))
        mats = sorted(set(nbins))
        edges = []
        for nb_c in mats:
            e = np.full((d, self.n_bins - 1), np.inf, np.float32)
            if nb_c > 1:
                e[:, :nb_c - 1] = trees.quantile_edges(sample, nb_c)
            edges.append(runtime.replicate(e))
        self.B = trees._bin_features_pop(self.X_dev, edges)
        self.codes_T = trees._pop_codes_T(self.B)
        self.code_idx = list(self.rep([mats.index(b) for b in nbins]))
        bmask = np.zeros((len(configs), self.n_bins), np.float32)
        lallow = np.zeros((len(configs), self.max_depth), bool)
        for i, (nb_c, dep) in enumerate(zip(nbins, depths)):
            # Thresholds ≥ a member's n_bins - 1 and levels ≥ its depth
            # are forbidden (see trees._build_trees).
            bmask[i, max(nb_c - 1, 0):] = trees.NEG
            lallow[i, :dep] = True
        self.bin_mask = torch.from_numpy(self.rep(bmask)).to(self.dev)
        self.level_allow = torch.from_numpy(self.rep(lallow)).to(self.dev)

    def _tables(self, count: int, leaf_shape: Tuple[int, ...]) -> dict:
        z = lambda dt, *s: torch.zeros((self.Pm, count, self.M) + s,
                                       dtype=dt, device=self.dev)
        return {"feat": z(torch.int32), "thr": z(torch.int32),
                "internal": z(torch.bool),
                self._names[3]: z(torch.float32, *leaf_shape)}

    def _idx(self, live: List[int]) -> List[int]:
        return [self.code_idx[m] for m in live]

    def ckpt_arrays(self) -> Dict[str, np.ndarray]:
        return {k: self.t[k].cpu().numpy() for k in self._names}

    def _restore_tables(self, arrays) -> None:
        self.t = {k: torch.from_numpy(np.array(arrays[k])).to(self.dev)
                  for k in self._names}


class _ForestDriver(_TreePopulation):
    """dt / rf: units are the serial fit's tree batches (its checkpoint
    boundaries, ``trees._forest_batch_shape``). Each config draws its
    trees' bootstrap weights and feature subsets from its own generator
    seeded with its seed, in the serial fit's order, so every tree of a
    member is its serial fit's; ``draws(config)`` → (weights (n_trees,
    n), allowed (n_trees, d)) replaces the draws (the parity tests feed
    the JAX package's)."""

    _names = ("feat", "thr", "internal", "leaf")

    def __init__(self, family, runtime, X, y, num_classes, configs,
                 fold_ids, tr_masks, ev_masks, draws=None):
        super().__init__(runtime, X, y, configs, fold_ids, tr_masks,
                         ev_masks)
        self.num_classes = num_classes
        d = self.X.shape[1]
        if family == "dt":
            self.n_trees = 1
            self.mtries = [1] * len(configs)
        else:
            self.n_trees = int(configs[0].get("n_trees", 20))
            self.mtries = [int(c.get("mtry") or max(1, int(np.sqrt(d))))
                           for c in configs]
        self.tb, self.nb = trees._forest_batch_shape(self.n_trees)
        self.draws = ([draws(c) for c in configs]
                      if draws is not None and self.n_trees > 1 else None)
        self.gens = []
        if self.n_trees > 1:
            for c in configs:
                g = torch.Generator(device=self.dev)
                g.manual_seed(int(c.get("seed", 0)))
                self.gens.append(g)
        self.t = self._tables(self.n_trees, (num_classes,))
        self.done_b = 0

    def total_units(self) -> int:
        return self.nb

    def _tree_draws(self, t: int, live: List[int]):
        """Tree t's (bootstrap (L, n), feature mask (L, d)) for the live
        members: one draw per live config, shared by its folds."""
        d = self.X.shape[1]
        if self.n_trees == 1:
            return None, torch.zeros((len(live), d), dtype=torch.float32,
                                     device=self.dev)
        per_cfg = {}
        for ci in sorted({m // self.nf for m in live}):
            w, allowed = trees._tree_draw(self.n, d, self.mtries[ci],
                                          self.gens[ci], self.dev)
            if self.draws is not None:
                w = torch.as_tensor(self.draws[ci][0][t],
                                    dtype=torch.float32, device=self.dev)
                allowed = torch.as_tensor(self.draws[ci][1][t],
                                          device=self.dev).bool()
            per_cfg[ci] = (w, torch.where(allowed, 0.0, trees.NEG).float())
        boot = torch.stack([per_cfg[m // self.nf][0] for m in live])
        fmask = torch.stack([per_cfg[m // self.nf][1] for m in live])
        return boot, fmask

    def run_segment(self, k: int) -> None:
        live = self.live()
        rows = torch.tensor(live, device=self.dev)
        for b in range(self.done_b, self.done_b + k):
            for t in range(b * self.tb, min((b + 1) * self.tb, self.n_trees)):
                out = trees._fit_forest_pop_batch(
                    self.B, self._idx(live), self.y_dev, self.w_base[rows],
                    [self._tree_draws(t, live)], self.bin_mask[rows],
                    self.level_allow[rows], num_classes=self.num_classes,
                    max_depth=self.max_depth, n_bins=self.n_bins,
                    codes_T=self.codes_T)
                for name, v in zip(self._names, out):
                    self.t[name][rows, t] = v[:, 0]
            jobs.heartbeat()
        self.done_b += k

    def scores(self) -> np.ndarray:
        live = self.live()
        rows = torch.tensor(live, device=self.dev)
        return self.member_scores(live, trees._forest_pop_scores(
            self.B, self._idx(live), self.y_dev, self.ew[rows],
            *(self.t[k][rows] for k in self._names),
            max_depth=self.max_depth))

    def ckpt_arrays(self) -> Dict[str, np.ndarray]:
        out = super().ckpt_arrays()
        if self.gens:
            out["gen_state"] = np.stack([g.get_state().numpy()
                                         for g in self.gens])
        return out

    def restore(self, units: int, arrays: Dict[str, np.ndarray]) -> None:
        self._restore_tables(arrays)
        for g, st in zip(self.gens, arrays.get("gen_state", ())):
            g.set_state(torch.from_numpy(np.array(st)))
        self.done_b = units


class _GbDriver(_TreePopulation):
    """gb: units are boost rounds; the margins stay on the device between
    segments and are replayed from the stored (round-activity-scaled)
    leaf values on resume, like the serial checkpointed fit."""

    _names = ("feat", "thr", "internal", "leaf_val")

    def __init__(self, runtime, X, y, num_classes, configs, fold_ids,
                 tr_masks, ev_masks):
        super().__init__(runtime, X, y, configs, fold_ids, tr_masks,
                         ev_masks)
        rounds = [int(c.get("n_rounds", 20)) for c in configs]
        self.r_max = max(rounds)
        self.rounds_m = self.rep(np.asarray(rounds, np.int64))
        self.steps = torch.from_numpy(self.rep(np.asarray(
            [float(c.get("step_size", 0.1)) for c in configs],
            np.float32))).to(self.dev)
        self.margin = torch.zeros((self.Pm, self.n), dtype=torch.float32,
                                  device=self.dev)
        self.t = self._tables(self.r_max, ())
        self.done = 0

    def total_units(self) -> int:
        return self.r_max

    def run_segment(self, k: int) -> None:
        ractive = (((self.done + np.arange(k))[None, :]
                    < self.rounds_m[:, None])
                   & (self.alive[:, None] > 0))
        seg, self.margin = trees._fit_gbt_pop_seg(
            self.B, self.code_idx, self.y_dev, self.w_base, self.margin,
            self.steps, torch.from_numpy(ractive), self.bin_mask,
            self.level_allow, max_depth=self.max_depth, n_bins=self.n_bins,
            n_rounds=k, codes_T=self.codes_T)
        for name, v in zip(self._names, seg):
            self.t[name][:, self.done:self.done + k] = v
        self.done += k
        jobs.heartbeat()

    def scores(self) -> np.ndarray:
        live = self.live()
        rows = torch.tensor(live, device=self.dev)
        return self.member_scores(live, trees._gbt_pop_scores(
            self.B, self._idx(live), self.y_dev, self.ew[rows],
            *(self.t[k][rows] for k in self._names), self.steps[rows],
            max_depth=self.max_depth))

    def restore(self, units: int, arrays: Dict[str, np.ndarray]) -> None:
        self._restore_tables(arrays)
        self.done = units
        self.margin = trees._gbt_pop_replay_margin(
            self.B, self.code_idx,
            *(self.t[k][:, :units] for k in self._names), self.steps,
            max_depth=self.max_depth)


class _LrDriver(_Population):
    """lr: units are solver iterations (newton capped at 20 like the
    serial auto rule); per-member lr/l2 ride as host floats."""

    def __init__(self, runtime, X, y, num_classes, configs, fold_ids,
                 tr_masks, ev_masks):
        super().__init__(runtime, X, y, configs, fold_ids, tr_masks,
                         ev_masks)
        self.num_classes = num_classes
        self.d = self.X.shape[1]
        solvers = {logistic.resolve_solver(str(c.get("solver", "auto")),
                                           num_classes, self.d)
                   for c in configs}
        if len(solvers) != 1:
            raise ValueError(
                "lr tune populations must resolve to one solver; got "
                f"{sorted(solvers)}")
        self.solver = solvers.pop()
        iters = [int(c.get("iters", 300)) for c in configs]
        if self.solver == "newton":
            iters = [min(i, 20) for i in iters]
        self.it_max = max(iters)
        self.iters_vec = self.rep(iters)
        self.lrs = self.rep([float(c.get("lr", 0.1)) for c in configs])
        self.l2s = self.rep([float(c.get("l2", 1e-4)) for c in configs])
        self.mu, self.sigma = logistic._device_stats(self.X_dev)
        self.done = 0
        if self.solver == "adam":
            self.Xs = logistic._standardized(self.X_dev, self.mu, self.sigma)
            self.states = [
                logistic._adam_init(logistic._draw_W0(
                    int(s), self.d, num_classes, self.dev), num_classes)
                for s in self.rep([int(c.get("seed", 0)) for c in configs])]
        else:
            self.Wz = [torch.zeros((self.d + 1, num_classes),
                                   dtype=torch.float32, device=self.dev)
                       for _ in range(self.Pm)]

    def total_units(self) -> int:
        return self.it_max

    def run_segment(self, k: int) -> None:
        if self.solver == "adam":
            logistic._fit_pop_adam(
                self.states, self.Xs, self.y_dev, self.w_base, self.lrs,
                self.l2s, self.iters_vec, self.alive, self.done, iters=k)
        else:
            self.Wz = logistic._fit_pop_newton(
                self.X_dev, self.y_dev, self.w_base, self.mu, self.sigma,
                self.l2s, self.iters_vec, self.alive, self.Wz, self.done,
                num_classes=self.num_classes, iters=k)
        self.done += k
        jobs.heartbeat()

    def _params(self, m: int) -> dict:
        if self.solver == "adam":
            W, b = self.states[m]["W"], self.states[m]["b"]
        else:
            W, b = self.Wz[m][:self.d], self.Wz[m][self.d]
        return {"W": W, "b": b, "mu": self.mu, "sigma": self.sigma}

    def scores(self) -> np.ndarray:
        live = self.live()
        return self.member_scores(live, logistic._pop_lr_scores(
            [self._params(m) for m in live], self.X_dev, self.y_dev,
            self.ew[torch.tensor(live, device=self.dev)]))

    def ckpt_arrays(self) -> Dict[str, np.ndarray]:
        if self.solver == "newton":
            return {"Wz": torch.stack(self.Wz).cpu().numpy()}
        st = self.states
        return {"W": torch.stack([s["W"] for s in st]).cpu().numpy(),
                "b": torch.stack([s["b"] for s in st]).cpu().numpy(),
                **{f"{o}.{k}": torch.stack([s[o][k] for s in st])
                   .cpu().numpy() for o in ("mu", "nu") for k in ("W", "b")},
                "count": np.asarray([s["count"] for s in st], np.int64)}

    def restore(self, units: int, arrays: Dict[str, np.ndarray]) -> None:
        self.done = units
        t = lambda a: torch.from_numpy(np.array(a)).to(self.dev)
        if self.solver == "newton":
            self.Wz = list(t(arrays["Wz"]).unbind(0))
            return
        for m, s in enumerate(self.states):
            s["W"], s["b"] = t(arrays["W"][m]), t(arrays["b"][m])
            for o in ("mu", "nu"):
                s[o] = {k: t(arrays[f"{o}.{k}"][m]) for k in ("W", "b")}
            s["count"] = int(arrays["count"][m])


class _MlpDriver(_Population):
    """mlp: units are Adam iterations; each member at its own hidden
    width, drawn as its serial fit draws it."""

    def __init__(self, runtime, X, y, num_classes, configs, fold_ids,
                 tr_masks, ev_masks):
        super().__init__(runtime, X, y, configs, fold_ids, tr_masks,
                         ev_masks)
        d = self.X.shape[1]
        iters = [int(c.get("iters", 300)) for c in configs]
        self.it_max = max(iters)
        self.iters_vec = self.rep(iters)
        self.lrs = self.rep([float(c.get("lr", 1e-2)) for c in configs])
        self.l2s = self.rep([float(c.get("l2", 1e-4)) for c in configs])
        mu, sigma = mlp.design_stats(runtime, self.X, self.X_dev)
        self.params, self.states = mlp._pop_mlp_init(
            self.rep([int(c.get("seed", 0)) for c in configs]),
            self.rep([int(c.get("hidden", 256)) for c in configs]),
            d, num_classes, mu, sigma, self.dev)
        self.Y1 = torch.nn.functional.one_hot(self.y_dev.long(),
                                              num_classes).float()
        self.done = 0

    def total_units(self) -> int:
        return self.it_max

    def run_segment(self, k: int) -> None:
        mlp._run_pop(self.params, self.states, self.X_dev, self.Y1,
                     self.w_base, self.lrs, self.l2s, self.iters_vec,
                     self.alive, self.done, iters=k)
        self.done += k
        jobs.heartbeat()

    def scores(self) -> np.ndarray:
        live = self.live()
        return self.member_scores(live, mlp._pop_mlp_scores(
            [self.params[m] for m in live], self.X_dev, self.y_dev,
            self.ew[torch.tensor(live, device=self.dev)]))

    def ckpt_arrays(self) -> Dict[str, np.ndarray]:
        return {f"m{m}.{k}": v for m in range(self.Pm)
                for k, v in mlp._ckpt_arrays(self.params[m],
                                             self.states[m]).items()}

    def restore(self, units: int, arrays: Dict[str, np.ndarray]) -> None:
        self.done = units
        for m in range(self.Pm):
            pre = f"m{m}."
            self.params[m], self.states[m] = mlp._ckpt_restore(
                {k[len(pre):]: v for k, v in arrays.items()
                 if k.startswith(pre)}, self.dev)


_DRIVERS = {"dt": _ForestDriver, "rf": _ForestDriver, "gb": _GbDriver,
            "lr": _LrDriver, "mlp": _MlpDriver}


def _make_driver(family, runtime, X, y, num_classes, configs, fold_ids,
                 tr_masks, ev_masks, draws=None):
    cls = _DRIVERS[family]
    if cls is _ForestDriver:
        return cls(family, runtime, X, y, num_classes, configs, fold_ids,
                   tr_masks, ev_masks, draws=draws)
    return cls(runtime, X, y, num_classes, configs, fold_ids, tr_masks,
               ev_masks)


# -- the sweep ----------------------------------------------------------------

def sweep(runtime, X, y, num_classes: int, family: str,
          configs: Sequence[Dict[str, Any]], *, cfg,
          folds: Optional[int] = None, rungs: Optional[int] = None,
          ckpt=None,
          draws: Optional[Callable[[Dict[str, Any]], Tuple]] = None
          ) -> Dict[str, Any]:
    """Run one device-resident sweep; returns the leaderboard document.

    ``ckpt`` is an optional fitckpt context: population state persists
    at every rung boundary, and an interrupted sweep resumes to
    IDENTICAL survivors and scores (each family's segments are bit-stable
    under segmentation, and the alive set / rung history ride in the
    checkpoint meta). ``draws`` replaces rf's bootstrap and feature
    draws per config (``_ForestDriver``)."""
    validate_population(family, configs, num_classes)
    configs = [dict(c) for c in configs]
    folds = int(cfg.tune_folds if folds is None else folds)
    rungs = int(cfg.tune_rungs if rungs is None else rungs)
    if folds < 1 or folds > 64:
        raise ValueError("tune folds must be in [1, 64]")
    if rungs < 1:
        raise ValueError("tune rungs must be >= 1")

    X = as_design(X)
    if not isinstance(X, np.ndarray):
        raise ValueError(
            "tune sweeps need a resident design matrix; materialize the "
            "dataset (streamed designs are fit-only)")
    n = int(len(X))
    fold_ids, tr_all, ev_all = _fold_masks(n, n, folds)
    nf = len(fold_ids)
    d = int(X.shape[1])
    waves = plan_waves(family, configs, n=n, d=d, num_classes=num_classes,
                       folds=nf, cfg=cfg)

    # Resume bookkeeping: the fitckpt meta carries the wave index, the
    # alive set, the rung history and finished waves' results — enough
    # to rebuild the exact orchestration state around the restored
    # device arrays.
    resume = ckpt.load() if ckpt is not None and ckpt.enabled else None
    completed: List[Dict[str, Any]] = []
    resume_wave = -1
    resume_state = None
    if resume is not None:
        progress, arrays, meta = resume
        if meta.get("family") == family and meta.get("waves") == len(
                waves) and meta.get("folds") == folds:
            resume_wave = int(meta.get("wave", 0))
            completed = list(meta.get("completed", []))
            resume_state = (int(progress) % _WAVE_STRIDE, arrays, meta)
            _bump("sweeps_resumed")
            fitckpt.count_resume()
            jobs.record_job_resume(f"tune_{family}", {
                "wave": resume_wave, "units": resume_state[0]})
        else:
            ckpt.clear()

    results: List[Dict[str, Any]] = list(completed)
    for w, wave_idx in enumerate(waves):
        if w < resume_wave:
            continue          # finished wave — its results rode the meta
        wave_cfgs = [configs[i] for i in wave_idx]
        nc = len(wave_cfgs)
        tr = np.tile(tr_all, (nc, 1))
        ev = np.tile(ev_all, (nc, 1))
        driver = _make_driver(family, runtime, X, y, num_classes,
                              wave_cfgs, fold_ids, tr, ev, draws=draws)
        units = driver.total_units()
        R = max(1, min(rungs, units))
        seg = -(-units // R)
        alive = np.ones(nc, np.float64)
        survived = np.zeros(nc, np.int64)
        fold_scores = np.zeros((nc, nf), np.float64)
        done = 0
        rung_i = 0
        fit_s = 0.0
        if w == resume_wave and resume_state is not None:
            done, arrays, meta = resume_state
            if 0 < done < units:
                driver.restore(done, arrays)
                alive = np.asarray(meta.get("alive", alive.tolist()),
                                   np.float64)
                survived = np.asarray(
                    meta.get("survived", survived.tolist()), np.int64)
                fold_scores = np.asarray(
                    meta.get("fold_scores", fold_scores.tolist()),
                    np.float64)
                rung_i = int(meta.get("rung", 0))
                fit_s = float(meta.get("fit_s", 0.0))
                driver.set_alive(alive)
            else:
                done = 0
                ckpt.clear()
        while done < units:
            k = min(seg, units - done)
            with tracing.span("tune.rung", family=family, wave=w,
                              rung=rung_i, alive=int(alive.sum())):
                t0 = time.monotonic()
                driver.run_segment(k)
                member_scores = driver.scores()
                fit_s += time.monotonic() - t0
            done += k
            rung_i += 1
            _bump("rungs_completed")
            ms = np.asarray(member_scores, np.float64).reshape(nc, nf)
            live = alive > 0
            fold_scores[live] = ms[live]
            survived[live] = rung_i
            if done < units and R > 1 and live.sum() > 1:
                means = fold_scores.mean(axis=1)
                keep = math.ceil(int(live.sum()) / 2)
                # Rank live configs by mean score, ties to the lower
                # index (deterministic across resumes).
                order = sorted(np.flatnonzero(live),
                               key=lambda i: (-means[i], i))
                dropped = order[keep:]
                if dropped:
                    alive[dropped] = 0.0
                    driver.set_alive(alive)
                    _bump("halving_drops", len(dropped))
            jobs.heartbeat()
            if done < units and ckpt is not None and ckpt.enabled:
                ckpt.save(
                    w * _WAVE_STRIDE + done, driver.ckpt_arrays(),
                    meta={"family": family, "wave": w,
                          "waves": len(waves), "folds": folds,
                          "rung": rung_i, "fit_s": fit_s,
                          "alive": alive.tolist(),
                          "survived": survived.tolist(),
                          "fold_scores": fold_scores.tolist(),
                          "completed": results})
        means = fold_scores.mean(axis=1)
        for i, ci in enumerate(wave_idx):
            results.append({
                "config": configs[ci],
                "fold_scores": [round(float(s), 6)
                                for s in fold_scores[i]],
                "mean_score": round(float(means[i]), 6),
                "fit_seconds": round(fit_s, 3),
                "rungs_survived": int(survived[i]),
                "alive": bool(alive[i]),
                "wave": w,
            })
        _bump("populations_fitted")
        _bump("candidates_evaluated", nc)
        del driver
        # The next wave's resume anchor: this wave is complete, so its
        # results ride the meta and device state restarts fresh.
        if w + 1 < len(waves) and ckpt is not None and ckpt.enabled:
            ckpt.save((w + 1) * _WAVE_STRIDE, {"anchor": np.zeros(1)},
                      meta={"family": family, "wave": w + 1,
                            "waves": len(waves), "folds": folds,
                            "completed": results})
    if ckpt is not None and ckpt.enabled:
        ckpt.clear()

    finishers = [r for r in results if r["alive"]] or results
    winner = max(finishers, key=lambda r: r["mean_score"])
    board = {
        "family": family, "folds": folds, "rungs": rungs,
        "waves": len(waves), "halving": rungs > 1,
        "results": sorted(results, key=lambda r: -r["mean_score"]),
        "winner": winner,
    }
    log.info("tune %s: %d configs x %d folds in %d wave(s); winner "
             "mean_score=%.4f", family, len(configs), folds, len(waves),
             winner["mean_score"])
    return board
