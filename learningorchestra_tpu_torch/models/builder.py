"""ModelBuilder — the trainer service core (reference call stack §3.2).

The reference's ``SparkModelBuilder.build_model``: load train/test
collections, preprocess, fit up to 5 classifiers *concurrently*
(ThreadPoolExecutor submitting into one FAIR-scheduled SparkSession,
model_builder.py:95,160-176), time each fit, evaluate F1 + accuracy, and
write one prediction collection per classifier whose metadata carries the
metrics and whose rows are the test set plus ``prediction`` and
``probability`` columns (model_builder.py:179-248).

Here preprocessing is declarative (ops/preprocess) and each family is
tensor code on one device with the tree families' hot loops in CUDA
kernels. The sweep is PIPELINED: every family runs on its own thread, but
only ``max_concurrent_fits`` of them may sit in their *device phase* at a
time (a semaphore, not the pool size, is the concurrency knob) — so
host-side prep of one family (tree quantile edges) and host-side finishing
of another (metrics, prediction datasets, persistence) overlap device work
of a third, while the device working set stays bounded.

Each fit records ``device_s`` — the device phase through synchronised
completion — next to wall-clock. Output contract is the JAX package's:
dataset ``<name>_<classifier>`` per classifier, metrics in its metadata.

Not yet ported from the JAX package: streamed (out-of-core) designs, exec
preprocessing, mid-fit checkpoints, tune sweeps and the multi-process
dispatch; each raises ``NotImplementedError`` where it would be entered.
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
from learningorchestra_tpu_torch.utils import tracing
from learningorchestra_tpu_torch.utils.profiling import (
    device_span, device_trace, op_timer, timed)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to the PyTorch "
                               "package")


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

    def _check_resident(self, *datasets) -> None:
        if self.cfg.stream_design or any(ds.over_budget for ds in datasets):
            raise _not_ported("the streamed (out-of-core) design matrix")

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
        if preprocessor_code is not None:
            raise _not_ported("exec preprocessing")
        if int(self.cfg.fit_ckpt_rounds) > 0:
            raise _not_ported("mid-fit checkpointing")
        train_ds = self.store.get(train)
        test_ds = self.store.get(test)
        self._check_resident(train_ds, test_ds)
        hparams = hparams or {}
        rp0 = readpipe.snapshot()

        design_t0 = time.monotonic()
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
        # datasets when the fitted model is re-served (persistence.py).
        pp_meta = {"steps": list(steps), "state": state,
                   "feature_fields": feature_fields, "label": label}
        tracing.record_span(
            "design.build", time.monotonic() - design_t0,
            attrs={"train": train, "test": test, "streamed": False,
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
                            with Timer() as td:
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
        self._check_resident(ds)
        if not existing:
            self.store.create(out_name, parent=dataset,
                              extra={"model": model_name, "kind": man["kind"]})
        with timed("model_predict"), device_trace(self.cfg):
            X, _, _, _ = preprocess.design_matrix(
                ds, pp["label"], pp["steps"], state=pp["state"],
                feature_fields=pp["feature_fields"])
            probs = model.predict_proba(self.runtime, X)
        preds = np.argmax(probs, axis=1)
        self._save_predictions(out_name, ds, preds, probs,
                               FitReport(kind=man["kind"], fit_time=0.0))

    def tune(self, *args, **kwargs):
        raise _not_ported("hyperparameter tuning")

    def _save_predictions(self, name: str, test_ds, preds: np.ndarray,
                          probs: np.ndarray, report: FitReport) -> None:
        """Write the prediction dataset: original test rows + prediction +
        probability list; metrics into metadata (reference
        model_builder.py:191-248 drops 'features'/'rawPrediction' and
        converts the probability vector to a plain list)."""
        ds = self.store.get(name)
        # Object array of Python lists (np.array(list-of-lists,
        # dtype=object) would build a 2-D array instead).
        prob_col = np.empty(len(probs), dtype=object)
        for i, p in enumerate(probs.tolist()):
            prob_col[i] = p
        cols = {f: test_ds.columns[f] for f in test_ds.metadata.fields}
        cols["prediction"] = preds.astype(np.int64)
        cols["probability"] = prob_col
        ds.append_columns(cols)
        self.store.finish(
            name,
            fit_time=report.fit_time,
            **{k: v for k, v in report.metrics.items()})
