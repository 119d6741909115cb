"""Arithmetic the per-layer metric readers share. Each reader in
``portbench/metrics/`` returns a number, or None where its run gives it
nothing to read (then the metric is left out of the line)."""

from __future__ import annotations

from typing import Optional

from portbench import counts


def per_step(run, seconds: Optional[float]) -> Optional[float]:
    if seconds is None or not run.steps:
        return None
    return seconds / len(run.steps)


def idle_share(run) -> Optional[float]:
    """Percent of the traced window with no kernel or copy on the card."""
    s = run.trace_summary
    if not s or s.get("window_s", 0.0) <= 0.0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def kernels_roofline(run) -> Optional[float]:
    """Percent: the summed bound seconds of the port's kernel calls over
    their summed device seconds."""
    s = run.trace_summary
    if run.kernel_work is None or not s or s.get("port_kernel_s", 0) <= 0:
        return None
    bound = run.kernel_work.bound_seconds()
    if bound is None:
        return None
    return 100.0 * bound / s["port_kernel_s"]


def step_mfu(run, bound_s_per_step: float) -> Optional[float]:
    """Percent: the window's needed work as roofline seconds over its
    wall seconds."""
    wall = sum(run.step_seconds())
    if wall <= 0.0 or bound_s_per_step <= 0.0:
        return None
    return 100.0 * bound_s_per_step * len(run.steps) / wall


def build_bound_s(run) -> float:
    shape = run.config["data"]
    return counts.build_bound_s(
        run.state["families"], shape["train_rows"], shape["test_rows"],
        shape["features"], shape["classes"],
        run.config["program"]["families"])


def tsne_bound_s(run) -> float:
    """Per image: the repulsion over the valid rows and the attraction
    over the nonzero entries of the last image's table, every step."""
    rec = run.state.get("recorder")
    if rec is None or rec.table is None:
        return 0.0
    sym_idx, sym_w, ov_src, ov_dst, ov_w = rec.table
    edges = int((sym_w != 0).sum()) + int(ov_w.shape[0])
    return counts.tsne_bound_s(run.config["data"]["rows"], edges,
                               run.config["program"]["iters"])


def tune_bound_s(run) -> float:
    """Per sweep, from the last leaderboard: every member's forest on its
    training rows (the trees its configuration survived to grow), and the
    promoted winner's forest on every row."""
    from portbench.reference.tune import trees_per_rung

    boards = run.state.get("boards")
    if not boards:
        return 0.0
    t = run.traffic
    shape = run.config["data"]
    n, d, C = shape["train_rows"], shape["features"], shape["classes"]
    n_fit = n * (t["folds"] - 1) / t["folds"]
    total = 0.0
    for r in boards[-1]["results"]:
        hp = dict(r["config"])
        hp["n_trees"] = min(int(hp["n_trees"]), r["rungs_survived"]
                            * trees_per_rung(int(hp["n_trees"]), t["rungs"]))
        total += t["folds"] * counts.bound_s(
            counts.fit_bytes("rf", n_fit, d, C, hp),
            counts.fit_flops("rf", n_fit, d, C, hp))
    if t["promote"]:
        hp = boards[-1]["winner"]["config"]
        total += counts.bound_s(counts.fit_bytes("rf", n, d, C, hp),
                                counts.fit_flops("rf", n, d, C, hp))
    return total
