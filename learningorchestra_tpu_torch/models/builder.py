"""ModelBuilder — the trainer service core (reference call stack §3.2).

The reference's ``SparkModelBuilder.build_model``: load train/test
collections, preprocess, fit up to 5 classifiers *concurrently*
(ThreadPoolExecutor submitting into one FAIR-scheduled SparkSession,
model_builder.py:95,160-176), time each fit, evaluate F1 + accuracy, and
write one prediction collection per classifier whose metadata carries the
metrics and whose rows are the test set plus ``prediction`` and
``probability`` columns (model_builder.py:179-248).

Here preprocessing is declarative (ops/preprocess; exec only behind the
opt-in flag, in a resource-jailed child process) and each family is
tensor code on one device with the tree families' hot loops in CUDA
kernels. A dataset over its RAM budget (or any build with
``stream_design``) takes the streamed path: the design state is fitted
with streaming passes, the design matrix stays lazy
(``preprocess.ChunkedDesign``) and reaches the device through the
runtime's double-buffered block feed, and prediction datasets are
written in row blocks — nothing consolidates the dataset.

The sweep is PIPELINED: every family runs on its own thread, but only
``max_concurrent_fits`` of them may sit in their *device phase* at a
time (a semaphore, not the pool size, is the concurrency knob) — so
host-side prep of one family (tree quantile edges) and host-side finishing
of another (metrics, prediction datasets, persistence) overlap device work
of a third, while the device working set stays bounded.

Each fit records ``device_s`` — the device phase through synchronised
completion — next to wall-clock. Output contract is the JAX package's:
dataset ``<name>_<classifier>`` per classifier, metrics in its metadata.
With ``fit_ckpt_rounds > 0`` the segmented families (rf, gb, mlp) and
the streamed design state checkpoint their progress (utils/fitckpt.py),
so a retried build resumes them bit-identically.

``tune`` runs a device-resident hyperparameter sweep of one family over
a resident design (models/tune.py) and can refit and persist its winner.
Not yet ported from the JAX package: the multi-process dispatch.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from learningorchestra_tpu_torch import jobs
from learningorchestra_tpu_torch.catalog import readpipe
from learningorchestra_tpu_torch.catalog.store import DatasetStore
from learningorchestra_tpu_torch.config import (
    Settings, settings as global_settings)
from learningorchestra_tpu_torch.models.base import FitReport, Timer
from learningorchestra_tpu_torch.models.metrics import classification_metrics
from learningorchestra_tpu_torch.models.persistence import ModelRegistry
from learningorchestra_tpu_torch.models.registry import get_trainer
from learningorchestra_tpu_torch.ops import preprocess
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.utils import fitckpt, resources, tracing
from learningorchestra_tpu_torch.utils.profiling import (
    device_span, device_trace, op_timer, timed)


class ModelBuilder:
    def __init__(self, store: DatasetStore, runtime: DeviceRuntime,
                 cfg: Optional[Settings] = None):
        self.store = store
        self.runtime = runtime
        self.cfg = cfg or global_settings
        self.registry = ModelRegistry(self.cfg)

    # -- validation (reference model_builder.py:272-292) ---------------------

    def validate(self, train: str, test: str, classifiers: Sequence[str],
                 prediction_name: str) -> None:
        for ds_name in (train, test):
            if not self.store.exists(ds_name):
                raise KeyError(f"dataset not found: {ds_name}")
        for c in classifiers:
            get_trainer(c)  # raises ValueError on unknown name
        for c in classifiers:
            if self.store.exists(f"{prediction_name}_{c}"):
                raise ValueError("prediction dataset already exists: "
                                 f"{prediction_name}_{c}")

    def validate_tune(self, train: str, out_name: str, classifier: str,
                      configs: Sequence[Dict[str, Any]]) -> None:
        """Synchronous admission checks for a tune sweep — everything that
        must 4xx at the route instead of stranding an async job: missing
        dataset (404), duplicate output (ValueError → 406), and the full
        per-config hyperparameter validation (unknown names / out-of-range
        values name the offending key, models/registry.HPARAM_SPECS)."""
        from learningorchestra_tpu_torch.models import tune as tune_mod

        if not self.store.exists(train):
            raise KeyError(f"dataset not found: {train}")
        if self.store.exists(out_name):
            raise ValueError(f"tune dataset already exists: {out_name}")
        tune_mod.validate_population(classifier, configs)

    # -- the main path -------------------------------------------------------

    def build(self, train: str, test: str, prediction_name: str,
              classifiers: Sequence[str], label: str,
              steps: Sequence[Dict[str, Any]] = (),
              preprocessor_code: Optional[str] = None,
              hparams: Optional[Dict[str, Dict[str, Any]]] = None,
              existing: bool = False) -> List[FitReport]:
        """Fit all requested classifiers; returns per-classifier reports.

        ``existing=True`` means the caller already created the prediction
        datasets (metadata-first, so pollers can see them — and their
        failure flags — from the moment of submission).
        """
        train_ds = self.store.get(train)
        test_ds = self.store.get(test)
        hparams = hparams or {}
        ck_on = int(self.cfg.fit_ckpt_rounds) > 0
        rp0 = readpipe.snapshot()

        streamed = False
        design_t0 = time.monotonic()
        if preprocessor_code is not None:
            if not self.cfg.allow_exec_preprocessing:
                raise PermissionError(
                    "exec preprocessing is disabled; enable "
                    "LO_TPU_ALLOW_EXEC or use declarative steps")
            X_train, y_train, X_test, y_test = preprocess.exec_preprocess(
                preprocessor_code, train_ds, test_ds, label, cfg=self.cfg)
            feature_fields = [f"f{i}" for i in range(X_train.shape[1])]
        elif (self.cfg.stream_design or train_ds.over_budget
                or test_ds.over_budget):
            # The streamed path: the design matrix never exists whole on
            # the host — state is fitted with streaming passes and the
            # device tensor fills block by block (ChunkedDesign →
            # DeviceRuntime.shard_rows). No memo: memoization
            # consolidates, which is exactly what this path must never do.
            streamed = True
            fit_prof: Dict[str, Any] = {}
            # Pass-boundary checkpoints for the streamed state fit: a
            # retried build resumes the fitting scans instead of
            # re-reading the dataset from pass zero.
            design_ckpt = fitckpt.context(
                self.cfg, dataset=train, family="design",
                config={"label": label, "steps": list(steps)},
                snapshot="") if ck_on else None
            X_train, y_train, feature_fields, state = \
                preprocess.design_matrix_streamed(train_ds, label, steps,
                                                  profile=fit_prof,
                                                  ckpt=design_ckpt)
            X_test, y_test, _, _ = preprocess.design_matrix_streamed(
                test_ds, label, steps, state=state,
                feature_fields=feature_fields)
            if fit_prof:
                # The streamed fit's scan count on the job record: the
                # fused fitting passes keep it at ~2 for the default
                # pipeline, and a regression shows up here first.
                jobs.record_job_profile(**fit_prof)
        else:
            # Memoized per dataset-snapshot: repeat builds on the same data
            # reuse the identical X arrays, so the runtime's transfer cache
            # keeps the device copies.
            steps_key = json.dumps(list(steps), sort_keys=True, default=str)
            X_train, y_train, feature_fields, state = train_ds.memo(
                ("design", label, steps_key),
                lambda: preprocess.design_matrix(train_ds, label, steps))
            X_test, y_test, _, _ = test_ds.memo(
                ("design_t", label, steps_key, tuple(feature_fields)),
                lambda: preprocess.design_matrix(
                    test_ds, label, steps, state=state,
                    feature_fields=feature_fields),
                token=state)
        # Everything needed to apply the identical pipeline to future
        # datasets when the fitted model is re-served (persistence.py);
        # exec-preprocessed models carry none.
        pp_meta = None if preprocessor_code is not None else {
            "steps": list(steps), "state": state,
            "feature_fields": feature_fields, "label": label}
        tracing.record_span(
            "design.build", time.monotonic() - design_t0,
            attrs={"train": train, "test": test, "streamed": streamed,
                   "rows": int(len(X_train))})
        if y_train is None:
            raise ValueError(f"label field {label!r} not in {train!r}")
        num_classes = int(max(int(y_train.max()) + 1,
                              2 if y_test is None else int(y_test.max()) + 1))

        # Create all output datasets first (metadata-first protocol), so
        # pollers see them immediately with finished=false.
        if not existing:
            for c in classifiers:
                self.store.create(f"{prediction_name}_{c}", parent=test,
                                  extra={"classifier": c, "label": label})

        # Mid-fit checkpoint contexts (utils/fitckpt.py), one per family
        # with natural segment boundaries. Keyed on everything that could
        # change the fit's arithmetic — hparams, label/steps, row
        # snapshot, device type (the card's fixed-point histogram sums
        # differ from the CPU's float sums) — so a resume under ANY
        # changed configuration starts fresh.
        ckpt_ctxs: Dict[str, Any] = {}
        if ck_on:
            for c in classifiers:
                if c not in fitckpt.SEGMENTED_FAMILIES:
                    continue
                ckpt_ctxs[c] = fitckpt.context(
                    self.cfg, dataset=train, family=c,
                    config={"family": c, "hparams": hparams.get(c, {}),
                            "num_classes": num_classes, "label": label,
                            "steps": list(steps), "streamed": streamed,
                            "device": self.runtime.device.type},
                    snapshot=f"rows={int(len(X_train))}")

        def prep_fit(c: str):
            """One family's host-side prep (the trainer's ``host_prep``
            hook — tree quantile edges). Pure host work, runs OUTSIDE the
            device gate. Returns (extra_kwargs, prep_s)."""
            trainer = get_trainer(c)
            hp = hparams.get(c, {})
            with Timer() as tp:
                prep = getattr(trainer, "host_prep", None)
                extra = prep(X_train, **hp) if prep is not None else {}
            return extra, tp.elapsed

        def dispatch_fit(c: str, extra: Dict[str, Any]):
            kw = dict(hparams.get(c, {}), **extra)
            if c in ckpt_ctxs:
                kw["ckpt"] = ckpt_ctxs[c]
            return get_trainer(c)(self.runtime, X_train, y_train,
                                  num_classes, **kw)

        def collect_fit(c: str, model, pre_s: float):
            """The family's probability pass, synchronised to completion.
            ``pre_s`` is everything before this span — host prep plus
            the fit's own wall time (whose kernels may still be running:
            the synchronise at the end of this span bounds them too).
            Returns (probs, device_s)."""
            probs, device_s = device_span(
                lambda: model.predict_proba(self.runtime, X_test),
                name=f"fit.{c}.device", device=self.runtime.device)
            op_timer.record(f"fit.{c}", pre_s + device_s)
            op_timer.record(f"fit.{c}.device", device_s)
            jobs.heartbeat()
            return probs, device_s

        def finish_host(c: str, model, probs, fit_time: float,
                        device_s: float) -> FitReport:
            """Metrics, model persistence, prediction dataset — everything
            host-side after the device work completes."""
            preds = np.argmax(probs, axis=1)
            report = FitReport(kind=c, fit_time=fit_time)
            if y_test is not None and (y_test >= 0).all():
                report.metrics = classification_metrics(
                    y_test, preds, num_classes)
            report.metrics["device_s"] = round(device_s, 6)
            if self.cfg.persist_models:
                # Best-effort: a persistence failure must not discard an
                # otherwise successful fit's predictions; surface it in the
                # persisted metrics instead.
                try:
                    self.registry.save(f"{prediction_name}_{c}", model,
                                       metrics=report.metrics,
                                       preprocess=pp_meta)
                except Exception as exc:  # noqa: BLE001 — isolation boundary
                    report.metrics["persist_error"] = (
                        f"{type(exc).__name__}: {exc}")
            self._save_predictions(f"{prediction_name}_{c}", test_ds,
                                   preds, probs, report)
            # The family reached its terminal outputs: its mid-fit
            # checkpoint stream is superseded (a retry refits only
            # families whose datasets failed), so reclaim the disk.
            if c in ckpt_ctxs:
                ckpt_ctxs[c].clear()
            jobs.heartbeat()
            return report

        def fail_report(c: str, exc: Exception) -> FitReport:
            self.store.fail(f"{prediction_name}_{c}",
                            f"{type(exc).__name__}: {exc}")
            return FitReport(kind=c, fit_time=0.0,
                             metrics={"error": str(exc)})

        reports = self._build_pipelined(classifiers, prep_fit, dispatch_fit,
                                        collect_fit, finish_host,
                                        fail_report)
        device_s = {r.kind: r.metrics["device_s"] for r in reports
                    if "device_s" in r.metrics}
        rp1 = readpipe.snapshot()
        rp_delta = {k: rp1[k] - rp0[k]
                    for k in ("cache_hits", "cache_misses",
                              "prefetch_stalls", "prefetched_chunks")}
        prof: Dict[str, Any] = {}
        if device_s:
            prof["fit_device_s"] = device_s
        if any(rp_delta.values()):
            prof["read_pipeline"] = rp_delta
        if prof:
            jobs.record_job_profile(**prof)
        if streamed and ck_on and all("error" not in r.metrics
                                      for r in reports):
            # Every family completed: the design-state checkpoint has no
            # retry left to serve — reclaim it (a failed family keeps it
            # so the retry skips the fitted passes).
            design_ckpt.clear()
        return reports

    def _build_pipelined(self, classifiers, prep_fit, dispatch_fit,
                         collect_fit, finish_host,
                         fail_report) -> List[FitReport]:
        """Pipelined sweep (reference: 5-way ThreadPoolExecutor + FAIR
        pool, model_builder.py:95,160-176). Every family gets a thread; a
        semaphore caps how many sit in their device phase. One device
        trace spans the whole build."""
        gate = threading.BoundedSemaphore(
            max(1, int(self.cfg.max_concurrent_fits)))
        # Pool threads carry no ambient trace OR job record — re-attach
        # both so each family's spans nest under the job/request span.
        parent_ctx = tracing.current()
        job_rec = jobs.current_job_record()

        def fit_guarded(c: str) -> FitReport:
            with tracing.attach(parent_ctx), \
                    jobs.attach_job_record(job_rec):
                try:
                    # The except sits OUTSIDE the span: a failing family
                    # must escape it so the fit.<c> span records
                    # status=error.
                    with tracing.span(f"fit.{c}", family=c):
                        extra, prep_s = prep_fit(c)   # outside the gate
                        tracing.record_span(f"fit.{c}.host_prep", prep_s)
                        with gate:                    # device phase
                            # The fit's resource window (compile seconds,
                            # device bytes at its end); the probability
                            # pass gets its own through collect_fit's
                            # device_span. Concurrent families' windows
                            # overlap, so utils/resources.device_phase
                            # records their peaks only, never a double-
                            # counted compile_s.
                            with Timer() as td, resources.family_phase(c):
                                model = dispatch_fit(c, extra)
                            pre_s = prep_s + td.elapsed
                            probs, device_s = collect_fit(c, model, pre_s)
                        # fit_time = prep + fit + probability spans, no
                        # scheduler waits: the per-family sum estimates
                        # the serialized sweep.
                        with Timer() as tf:
                            report = finish_host(c, model, probs,
                                                 pre_s + device_s,
                                                 device_s)
                        tracing.record_span(f"fit.{c}.finish", tf.elapsed)
                        return report
                except Exception as exc:  # noqa: BLE001 — per-model bound
                    return fail_report(c, exc)

        with device_trace(self.cfg), ThreadPoolExecutor(
                max_workers=max(len(classifiers), 1)) as pool:
            futures = {c: pool.submit(fit_guarded, c) for c in classifiers}
            return [fut.result() for fut in futures.values()]

    def predict(self, model_name: str, dataset: str, out_name: str,
                existing: bool = False) -> None:
        """Serve a persisted model on a stored dataset: apply its train-time
        preprocessing state, predict, and write a prediction dataset.

        ``existing=True``: the caller already created the output dataset
        metadata-first, so a crash mid-predict is pollable.
        """
        man, model = self.registry.load(model_name)
        pp = man.get("preprocess")
        if pp is None:
            raise ValueError(
                f"model {model_name} carries no reproducible preprocessing "
                "state to apply to new datasets")
        ds = self.store.get(dataset)
        if not existing:
            self.store.create(out_name, parent=dataset,
                              extra={"model": model_name, "kind": man["kind"]})
        streamed = ds.over_budget or self.cfg.stream_design
        with timed("model_predict"), device_trace(self.cfg):
            if streamed:
                X, _, _, _ = preprocess.design_matrix_streamed(
                    ds, pp["label"], pp["steps"], state=pp["state"],
                    feature_fields=pp["feature_fields"], need_y=False)
            else:
                X, _, _, _ = preprocess.design_matrix(
                    ds, pp["label"], pp["steps"], state=pp["state"],
                    feature_fields=pp["feature_fields"])
            probs = model.predict_proba(self.runtime, X)
        preds = np.argmax(probs, axis=1)
        self._save_predictions(out_name, ds, preds, probs,
                               FitReport(kind=man["kind"], fit_time=0.0))

    # -- device-resident hyperparameter search (models/tune.py) --------------

    def tune(self, train: str, out_name: str, classifier: str,
             configs: Sequence[Dict[str, Any]], label: str,
             steps: Sequence[Dict[str, Any]] = (),
             folds: Optional[int] = None, rungs: Optional[int] = None,
             promote: bool = False,
             existing: bool = False) -> Dict[str, Any]:
        """Run one population sweep over ``configs`` of a single family
        against the resident design of ``train``; the leaderboard (per-
        config fold scores, fit seconds, rung survival, winner) lands in
        ``out_name``'s metadata and is returned.

        ``promote=True`` refits the winning config on ALL rows and
        persists it under ``out_name`` in the trained-model registry, so
        the sweep's product is directly servable. ``existing=True`` means
        the async route already created the marker dataset
        metadata-first.
        """
        from learningorchestra_tpu_torch.models import tune as tune_mod

        train_ds = self.store.get(train)
        if self.cfg.stream_design or train_ds.over_budget:
            # The member fold masks weight ONE resident (n, d) design; a
            # streamed design never materializes, so there is nothing to
            # mask.
            raise ValueError(
                "tune sweeps need a resident design matrix; streamed "
                "designs are fit-only")
        steps_key = json.dumps(list(steps), sort_keys=True, default=str)
        with tracing.span("design.build", train=train):
            X_train, y_train, feature_fields, state = train_ds.memo(
                ("design", label, steps_key),
                lambda: preprocess.design_matrix(train_ds, label, steps))
        if y_train is None:
            raise ValueError(f"label field {label!r} not in {train!r}")
        num_classes = max(2, int(y_train.max()) + 1)
        pp_meta = {"steps": list(steps), "state": state,
                   "feature_fields": feature_fields, "label": label}

        if not existing:
            self.store.create(out_name, parent=train,
                              extra={"classifier": classifier,
                                     "label": label, "tune": True})
        ckpt = None
        if int(self.cfg.fit_ckpt_rounds) > 0:
            # Rung-boundary checkpoints: keyed on everything that changes
            # the sweep's arithmetic or orchestration (configs, folds,
            # rungs, device type), so a resume under ANY changed setup
            # starts fresh instead of splicing incompatible state.
            ckpt = fitckpt.context(
                self.cfg, dataset=train, family=f"tune_{classifier}",
                config={"family": classifier, "configs": list(configs),
                        "folds": folds, "rungs": rungs, "label": label,
                        "steps": list(steps), "num_classes": num_classes,
                        "device": self.runtime.device.type},
                snapshot=f"rows={int(len(X_train))}")
        try:
            with device_trace(self.cfg), timed("tune"), \
                    tracing.span("tune.sweep", family=classifier,
                                 configs=len(configs)):
                board = tune_mod.sweep(
                    self.runtime, X_train, y_train, num_classes,
                    classifier, configs, cfg=self.cfg,
                    folds=folds, rungs=rungs, ckpt=ckpt)
        except Exception as exc:
            self.store.fail(out_name, f"{type(exc).__name__}: {exc}")
            raise

        if promote:
            # Winner promotion: one full-data fit of the best config —
            # the same trainer entry point as build, so host_prep hooks
            # (tree quantile edges) and registry manifests match.
            hp = dict(board["winner"]["config"])
            trainer = get_trainer(classifier)
            prep = getattr(trainer, "host_prep", None)
            extra = prep(X_train, **hp) if prep is not None else {}
            with timed("tune.promote"), resources.family_phase(classifier):
                model = trainer(self.runtime, X_train, y_train,
                                num_classes, **dict(hp, **extra))
            if self.cfg.persist_models:
                try:
                    self.registry.save(
                        out_name, model,
                        metrics={"mean_score":
                                 board["winner"]["mean_score"],
                                 "tuned": True},
                        preprocess=pp_meta)
                    board["promoted"] = out_name
                except Exception as exc:  # noqa: BLE001 — best-effort
                    board["promote_error"] = (
                        f"{type(exc).__name__}: {exc}")

        self.store.finish(out_name, tune=board)
        jobs.heartbeat()
        return board

    def _save_predictions(self, name: str, test_ds, preds: np.ndarray,
                          probs: np.ndarray, report: FitReport) -> None:
        """Write the prediction dataset: original test rows + prediction +
        probability list; metrics into metadata (reference
        model_builder.py:191-248 drops 'features'/'rawPrediction' and
        converts the probability vector to a plain list)."""
        ds = self.store.get(name)
        n = len(preds)

        def prob_objcol(block_probs: np.ndarray) -> np.ndarray:
            # Object array of Python lists (np.array(list-of-lists,
            # dtype=object) would build a 2-D array instead).
            out = np.empty(len(block_probs), dtype=object)
            for i, p in enumerate(block_probs.tolist()):
                out[i] = p
            return out

        if test_ds.over_budget or self.cfg.stream_design:
            # Out-of-core test set (or forced streaming): write the
            # prediction dataset in row blocks instead of consolidating
            # the parent — the same predicate as every other
            # streamed/resident decision, so ``stream_design`` never
            # re-introduces the O(dataset) host spike it exists to avoid.
            block = 1 << 18
            for off in range(0, n, block):
                stop = min(off + block, n)
                cols = test_ds.read_rows(None, off, stop)
                cols["prediction"] = preds[off:stop].astype(np.int64)
                cols["probability"] = prob_objcol(probs[off:stop])
                ds.append_columns(cols)
        else:
            cols = {f: test_ds.columns[f] for f in test_ds.metadata.fields}
            cols["prediction"] = preds.astype(np.int64)
            cols["probability"] = prob_objcol(probs)
            ds.append_columns(cols)
        self.store.finish(
            name,
            fit_time=report.fit_time,
            **{k: v for k, v in report.metrics.items()})
