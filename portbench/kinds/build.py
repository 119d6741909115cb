"""The model-builder sweep as the catalog serves it: ``ModelBuilder.build``
of the traffic mix's families, one build at a time (a closed loop).

Set-up makes the train and test columns from the seed on the card
(``data.higgs_like``), copies them to the host once, and warms up with a
small build of the same families. Each build of the window runs on
train and test datasets that the process has not built a design matrix
for: fresh catalog datasets over the set-up's column arrays, with
persistence off; the previous build's datasets are deleted first. The
window's end-to-end value is ``build_s``: its seconds over the builds it
completed.
"""

from __future__ import annotations

import gc

import numpy as np

from portbench import data
from portbench.reference import build as ref_build

LABEL = "label"


def make_columns(run) -> tuple:
    import torch

    shape = run.config["data"]
    gen = data.generator(run.seed, run.device)
    X, y = data.higgs_like(shape["train_rows"], gen, run.device)
    train = data.higgs_columns(X, y)
    del X, y
    X, y = data.higgs_like(shape["test_rows"], gen, run.device)
    test = data.higgs_columns(X, y)
    del X, y
    if run.on_card:
        torch.cuda.empty_cache()
    return train, test


def setup(run) -> None:
    from learningorchestra_tpu_torch.catalog.store import DatasetStore
    from learningorchestra_tpu_torch.models.builder import ModelBuilder
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

    train, test = make_columns(run)
    cfg = run.settings()
    store = DatasetStore(cfg)
    runtime = DeviceRuntime(cfg, device=run.device)
    mb = ModelBuilder(store, runtime, cfg)
    families = list(run.traffic["classifiers"])
    warm = int(run.traffic["warmup_rows"])
    store.create("warm_train", columns={k: v[:warm] for k, v in
                                        train.items()}, finished=True)
    store.create("warm_test", columns={k: v[:warm] for k, v in
                                       test.items()}, finished=True)
    mb.build("warm_train", "warm_test", "warm", families, LABEL)
    for name in ["warm_train", "warm_test"] + [f"warm_{c}"
                                               for c in families]:
        store.delete(name)
    run.state.update(train=train, test=test, store=store, runtime=runtime,
                     mb=mb, families=families, builds=0,
                     preds={c: [] for c in families},
                     metrics={c: [] for c in families})


def _delete_build(run, i: int) -> None:
    store = run.state["store"]
    for name in [f"train{i}", f"test{i}"] + [
            f"pred{i}_{c}" for c in run.state["families"]]:
        if store.exists(name):
            store.delete(name)


def _one_build(run) -> None:
    st = run.state
    store, i = st["store"], st["builds"]
    if i:
        _delete_build(run, i - 1)
    store.create(f"train{i}", columns=dict(st["train"]), finished=True)
    store.create(f"test{i}", columns=dict(st["test"]), finished=True)
    reports = st["mb"].build(f"train{i}", f"test{i}", f"pred{i}",
                             st["families"], LABEL)
    st["builds"] += 1
    run.attempted += 1
    if any("error" in r.metrics for r in reports):
        run.failed += 1
    for c in st["families"]:
        ds = store.get(f"pred{i}_{c}")
        doc = ds.metadata.to_doc()
        preds = (np.asarray(ds.columns["prediction"])
                 if doc.get("finished") and not doc.get("error") else None)
        st["preds"][c].append(preds)
        st["metrics"][c].append((doc.get("accuracy", float("inf")),
                                 doc.get("f1", float("inf"))))


def window(run) -> dict:
    seconds, builds = run.closed_loop("build", lambda: _one_build(run))
    return {"build_s": seconds / builds}


TREE_FAMILIES = ("dt", "rf", "gb")


def release(run) -> None:
    """Keep the last build's design matrices (the timed path's own, from
    the datasets' memo) and the trees it saved for the judgement, then
    free the program."""
    import torch

    from portbench.reference import trees

    st = run.state
    i = st["builds"] - 1
    st["prog_trees"] = {}
    for c in st["families"]:
        name = f"pred{i}_{c}"
        if c in TREE_FAMILIES and st["mb"].registry.exists(name):
            st["prog_trees"][c] = trees.program_trees(
                st["mb"].registry.load(name)[1].params, c)
    key = ("design", LABEL, "[]")
    train_ds = st["store"].get(f"train{i}")
    X, _, fields, state = train_ds.memo(key, lambda: (None,) * 4)
    Xt = None
    if X is not None:
        Xt = st["store"].get(f"test{i}").memo(
            ("design_t", LABEL, "[]", tuple(fields)),
            lambda: (None,) * 4, token=state)[0]
    st["prog_design"] = (X, Xt)
    _delete_build(run, i)
    for k in ("mb", "runtime", "store"):
        st.pop(k)
    gc.collect()
    if run.on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def hparams(config: dict) -> dict:
    return config["program"]["families"]


def judge(run) -> list:
    st = run.state
    X, Xt = st["prog_design"]
    if X is None or Xt is None:
        return [("design_found", 1.0, 0.0)]
    cfg = run.config
    features = [f"f{i}" for i in range(cfg["data"]["features"])]
    ref = ref_build.fit_predict(st["train"], st["test"], features, LABEL,
                                st["families"], hparams(cfg), run.device,
                                follow=st["prog_trees"])
    prog = {"design": (np.asarray(X), np.asarray(Xt)),
            "preds": st["preds"], "metrics": st["metrics"]}
    numbers = ref_build.judge(ref, prog, np.asarray(st["test"][LABEL]),
                              st["families"])
    limits = cfg["limits"]["build"]
    return [(name, value, limits[name]) for name, value in numbers]
