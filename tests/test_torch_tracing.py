"""The port's spans: one clock, spans that contain their children, the
profiler mirror of sampled spans, and the spans of the host stages
(catalog, design matrix, transfer, tune, model saves, the embed's
design), on the CPU."""

import time

import numpy as np
import pytest
import torch

from learningorchestra_tpu_torch.catalog.store import DatasetStore
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models.builder import ModelBuilder
from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
from learningorchestra_tpu_torch.utils import tracing
from learningorchestra_tpu_torch.utils.profiling import (
    OpTimer, device_span, timed)
from learningorchestra_tpu_torch.viz.service import embed_dataset

FEATURES = 6
TREES = ("dt", "rf", "gb")


@pytest.fixture(autouse=True)
def _fresh_tracing():
    tracing.reset()
    tracing.set_sample(None)
    tracing.set_capacity(1 << 16)
    yield
    tracing.reset()
    tracing.set_capacity(None)


@pytest.fixture
def builder(tmp_path):
    cfg = Settings()
    cfg.store_root = str(tmp_path / "store")
    cfg.image_root = str(tmp_path / "images")
    cfg.persist = False
    store = DatasetStore(cfg)
    return store, ModelBuilder(store, DeviceRuntime(cfg, device="cpu"), cfg)


def _columns(n, seed):
    X = np.random.default_rng(seed).normal(size=(n, FEATURES))
    cols = {f"f{i}": X[:, i].astype(np.float32) for i in range(FEATURES)}
    cols["label"] = (X[:, 0] + X[:, 1] > 0).astype(np.int64)
    return cols


def _end(doc):
    return doc["start"] + doc["duration_ms"] / 1e3


def _tree(trace_id):
    docs = tracing.spans_for(trace_id)
    return docs, {d["span_id"]: d for d in docs}


def _ancestors(doc, by_id):
    out = []
    while doc.get("parent_id") in by_id:
        doc = by_id[doc["parent_id"]]
        out.append(doc["name"])
    return out


def _assert_nested(docs, by_id):
    for d in docs:
        p = by_id.get(d["parent_id"])
        if p is not None:
            # Starts and durations are rounded to the microsecond.
            assert p["start"] - 2e-6 <= d["start"], (d["name"], p["name"])
            assert _end(d) <= _end(p) + 2e-6, (d["name"], p["name"])


def test_now_is_monotonic_and_wall_based():
    reads = [tracing.now() for _ in range(10_000)]
    assert all(b >= a for a, b in zip(reads, reads[1:]))
    assert abs(tracing.now() - time.time()) < 1.0


def test_children_lie_inside_their_parents():
    timer = OpTimer()

    def inner():
        with tracing.span("inner"):
            time.sleep(0.002)
        return 7

    with tracing.trace("root", sampled=True) as ctx:
        with tracing.span("outer"):
            with timed("timed", timer):
                time.sleep(0.002)
                t0 = tracing.now()
                time.sleep(0.002)
                tracing.record_span("recorded", tracing.now() - t0)
            out, seconds = device_span(inner, "device")
    docs, by_id = _tree(ctx.trace_id)
    parent = {d["name"]: by_id[d["parent_id"]]["name"]
              for d in docs if d["parent_id"] in by_id}
    assert parent == {"outer": "root", "timed": "outer",
                      "recorded": "timed", "device": "outer",
                      "inner": "device"}
    _assert_nested(docs, by_id)
    assert out == 7
    dev = next(d for d in docs if d["name"] == "device")
    assert dev["duration_ms"] == round(seconds * 1e3, 3)
    snap = timer.snapshot()["timed"]
    span_ms = next(d for d in docs if d["name"] == "timed")["duration_ms"]
    assert span_ms == round(snap["total_s"] * 1e3, 3)


def test_error_inside_a_span_is_recorded_and_raised():
    timer = OpTimer()
    with tracing.trace("root", sampled=True) as ctx:
        with pytest.raises(ZeroDivisionError):
            with timed("failing", timer):
                1 / 0
    docs, _ = _tree(ctx.trace_id)
    doc = next(d for d in docs if d["name"] == "failing")
    assert doc["status"] == "error" and "ZeroDivisionError" in doc["error"]
    assert timer.snapshot()["failing"]["count"] == 1


def test_unsampled_spans_record_nothing_and_stay_out_of_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("lo.none"):
            torch.ones(8).sum()
        device_span(lambda: torch.ones(8).sum(), "lo.none_device")
        with tracing.trace("lo.unsampled_root", sampled=False):
            with tracing.span("lo.unsampled"), timed("lo.unsampled_timed"):
                torch.ones(8).sum()
        with tracing.trace("lo.sampled_root", sampled=True):
            with tracing.span("lo.sampled"):
                torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert {"lo.sampled_root", "lo.sampled"} <= names
    assert not names & {"lo.none", "lo.none_device", "lo.unsampled_root",
                        "lo.unsampled", "lo.unsampled_timed"}
    assert sorted(d["name"] for d in tracing.recent_span_docs()) == [
        "lo.sampled", "lo.sampled_root"]


def test_sampled_span_without_a_profiler_enters_no_record_function(
        monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    with tracing.trace("root", sampled=True):
        with tracing.span("child"):
            pass
    assert entered == []
    assert len(tracing.recent_span_docs()) == 2


def test_build_spans_nest_and_count_each_copy(builder):
    store, mb = builder
    store.create("train", columns=_columns(1500, 1), finished=True)
    store.create("test", columns=_columns(300, 2), finished=True)
    families = ["lr", "dt", "rf", "gb", "nb"]
    with tracing.trace("build", sampled=True) as ctx:
        mb.build("train", "test", "pred", families, "label")
    docs, by_id = _tree(ctx.trace_id)
    _assert_nested(docs, by_id)
    design = [d for d in docs if d["name"] == "design.build"]
    assert len(design) == 1 and design[0]["attrs"]["rows"] == 1500
    for name in ("catalog.consolidate", "design.steps", "design.stack"):
        found = [d for d in docs if d["name"] == name]
        # One for the train set, one for the test set.
        assert len(found) == 2, name
        assert all(by_id[d["parent_id"]]["name"] == "design.build"
                   for d in found), name
    steps = next(d for d in docs if d["name"] == "design.steps")
    assert steps["attrs"]["steps"] == ["label_encode", "fillna"]
    stack = next(d for d in docs if d["name"] == "design.stack")
    assert stack["attrs"]["cols"] == FEATURES
    for c in TREES:
        edges = [d for d in docs if d["name"] == "tree.edges"
                 and f"fit.{c}" in _ancestors(d, by_id)]
        assert len(edges) == 1, c
        assert edges[0]["attrs"] == {"rows_sampled": 1500, "n_bins": 32}
    for c in families:
        saves = [d for d in docs if d["name"] == "registry.save"
                 and f"fit.{c}" in _ancestors(d, by_id)]
        assert len(saves) == 1, c
        assert saves[0]["attrs"]["name"] == f"pred_{c}"
        assert saves[0]["attrs"]["bytes"] > 0

    X, y, _, state = store.get("train").memo(
        ("design", "label", "[]"), lambda: (None,) * 4)
    X_test = store.get("test").memo(
        ("design_t", "label", "[]", tuple(f"f{i}" for i in range(FEATURES))),
        lambda: (None,) * 4, token=state)[0]
    puts = [d["attrs"]["bytes"] for d in docs if d["name"] == "runtime.put"]
    edge_bytes = FEATURES * 31 * 4
    for arr in (X, y, X_test):
        # The transfer cache: one copy serves every family.
        assert puts.count(arr.nbytes) == 1
    assert sorted(set(puts)) == sorted({X.nbytes, y.nbytes, X_test.nbytes,
                                        edge_bytes})

    # The same datasets again: the design is memoized and every design
    # array hits the transfer cache, so only the edges are copied.
    with tracing.trace("again", sampled=True) as ctx:
        mb.build("train", "test", "pred2", ["dt"], "label")
    docs, _ = _tree(ctx.trace_id)
    assert {d["attrs"]["bytes"] for d in docs
            if d["name"] == "runtime.put"} == {edge_bytes}
    assert not [d for d in docs if d["name"] in (
        "catalog.consolidate", "design.steps", "design.stack")]


def test_a_transfer_cache_hit_records_no_put():
    rt = DeviceRuntime(Settings(), device="cpu")
    arr = np.zeros((6, 4), np.float32)
    with tracing.trace("puts", sampled=True) as ctx:
        rt.shard_rows(arr)
        rt.shard_rows(arr)
        rt.replicate(np.zeros(3, np.int64))
    docs, _ = _tree(ctx.trace_id)
    assert [d["attrs"] for d in docs if d["name"] == "runtime.put"] == [
        {"bytes": 96, "pinned": False}, {"bytes": 24, "pinned": False}]


def test_tune_records_masks_waves_and_the_promotion(builder):
    store, mb = builder
    store.create("train", columns=_columns(1200, 3), finished=True)
    configs = [{"n_trees": 4, "max_depth": 3, "n_bins": 16},
               {"n_trees": 4, "max_depth": 4, "n_bins": 32}]
    with tracing.trace("tune", sampled=True) as ctx:
        board = mb.tune("train", "tuned", "rf", configs, "label", folds=2,
                        rungs=2, promote=True)
    assert board["promoted"] == "tuned"
    docs, by_id = _tree(ctx.trace_id)
    _assert_nested(docs, by_id)
    masks = [d for d in docs if d["name"] == "tune.masks"]
    assert [d["attrs"] for d in masks] == [
        {"rows": 1200, "members": 2}, {"rows": 1200, "members": 4}]
    waves = [d for d in docs if d["name"] == "tune.wave"]
    assert len(waves) == 1 and waves[0]["attrs"] == {"wave": 0,
                                                     "members": 4}
    sweep_masks, wave_masks = masks
    assert "tune.wave" not in _ancestors(sweep_masks, by_id)
    assert "tune.wave" in _ancestors(wave_masks, by_id)

    def puts_under(span):
        return [d["attrs"]["bytes"] for d in docs
                if d["name"] == "runtime.put"
                and span["span_id"] in _ancestor_ids(d, by_id)]

    # Both (folds, rows) float32 fold masks are copied once, under the
    # sweep's ``tune.masks``; the wave tiles them on the device.
    assert puts_under(sweep_masks) == [2 * 1200 * 4] * 2
    assert puts_under(wave_masks) == []
    under_wave = [d for d in docs if "tune.wave" in _ancestors(d, by_id)]
    names = [d["name"] for d in under_wave]
    assert names.count("tree.edges") == 2      # one per distinct n_bins
    puts = puts_under(waves[0])
    assert not {2 * 1200 * 4, 4 * 1200 * 4} & set(puts)
    # The promotion span holds the winner's edges, refit and save; the
    # operator-facing ``tune.promote`` timer holds the refit alone.
    promotion = next(d for d in docs if d["name"] == "tune.promotion")
    under = {d["name"] for d in docs
             if promotion["span_id"] in _ancestor_ids(d, by_id)}
    assert {"tree.edges", "tune.promote", "registry.save"} <= under
    refit = next(d for d in docs if d["name"] == "tune.promote")
    assert not {d["name"] for d in docs
                if refit["span_id"] in _ancestor_ids(d, by_id)} & {
                    "tree.edges", "registry.save"}


def _ancestor_ids(doc, by_id):
    out = []
    while doc.get("parent_id") in by_id:
        out.append(doc["parent_id"])
        doc = by_id[doc["parent_id"]]
    return out


def test_embed_records_its_design(builder):
    store, mb = builder
    cols = _columns(400, 4)
    store.create("points", columns=cols, finished=True)
    with tracing.trace("embed", sampled=True) as ctx:
        emb, labels = embed_dataset(store, mb.runtime, "pca", "points",
                                    label="label")
    assert emb.shape == (400, 2)
    docs, by_id = _tree(ctx.trace_id)
    _assert_nested(docs, by_id)
    design = [d for d in docs if d["name"] == "design.build"]
    assert len(design) == 1
    assert design[0]["attrs"] == {"parent": "points", "rows": 400}
    children = {d["name"] for d in docs
                if d["parent_id"] == design[0]["span_id"]}
    assert {"design.steps", "design.stack"} <= children
