"""The model-builder sweep on a dataset the process has seen:
``ModelBuilder.build`` of the traffic mix's families, one build at a
time (a closed loop), every build on the same train and test datasets.

Set-up makes the columns from the seed on the card (``build.make_columns``),
creates one train and one test dataset over them, and warms up with a
build on those two, so every build of the window finds their design
matrices in the datasets' memo (and their device copies in the runtime's
transfer cache): what is left is the trainers, their probability passes,
metrics, prediction datasets and model saves. Each build writes new
prediction datasets and deletes the previous build's. The window's
end-to-end value is ``build_s``: its seconds over the builds it
completed. It is judged as ``build_cold`` is, with the same limits.
"""

from __future__ import annotations

import gc

import numpy as np

from portbench.kinds import build

LABEL = build.LABEL
TRAIN, TEST = "train", "test"


def setup(run) -> None:
    from learningorchestra_tpu_torch.catalog.store import DatasetStore
    from learningorchestra_tpu_torch.models.builder import ModelBuilder
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

    train, test = build.make_columns(run)
    cfg = run.settings()
    store = DatasetStore(cfg)
    runtime = DeviceRuntime(cfg, device=run.device)
    mb = ModelBuilder(store, runtime, cfg)
    families = list(run.traffic["classifiers"])
    store.create(TRAIN, columns=dict(train), finished=True)
    store.create(TEST, columns=dict(test), finished=True)
    mb.build(TRAIN, TEST, "warm", families, LABEL)
    for c in families:
        store.delete(f"warm_{c}")
    run.state.update(train=train, test=test, store=store, runtime=runtime,
                     mb=mb, families=families, builds=0,
                     preds={c: [] for c in families},
                     metrics={c: [] for c in families})


def _delete_preds(run, i: int) -> None:
    store = run.state["store"]
    for c in run.state["families"]:
        if store.exists(f"pred{i}_{c}"):
            store.delete(f"pred{i}_{c}")


def _one_build(run) -> None:
    st = run.state
    store, i = st["store"], st["builds"]
    if i:
        _delete_preds(run, i - 1)
    reports = st["mb"].build(TRAIN, TEST, f"pred{i}", st["families"], LABEL)
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


def release(run) -> None:
    """Keep the design matrices the builds shared (the datasets' memo)
    and the trees the last build saved, for the judgement; then free the
    program."""
    import torch

    from portbench.reference import trees

    st = run.state
    i = st["builds"] - 1
    st["prog_trees"] = {}
    for c in st["families"]:
        name = f"pred{i}_{c}"
        if c in build.TREE_FAMILIES and st["mb"].registry.exists(name):
            st["prog_trees"][c] = trees.program_trees(
                st["mb"].registry.load(name)[1].params, c)
    X, _, fields, state = st["store"].get(TRAIN).memo(
        ("design", LABEL, "[]"), lambda: (None,) * 4)
    Xt = None
    if X is not None:
        Xt = st["store"].get(TEST).memo(
            ("design_t", LABEL, "[]", tuple(fields)),
            lambda: (None,) * 4, token=state)[0]
    st["prog_design"] = (X, Xt)
    _delete_preds(run, i)
    for k in ("mb", "runtime", "store"):
        st.pop(k)
    gc.collect()
    if run.on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def judge(run) -> list:
    return build.judge(run)
