"""The ``tx`` classifier's build at a public block's widths:
``ModelBuilder.build(..., ["tx"], ...)`` with the configuration's
``program.hparams``, one build at a time (a closed loop).

Set-up makes the token documents and labels from the seed on the card
(``tokens``), copies them to the host once as catalog columns ``t0`` …
``t<T-1>`` and ``label``, and warms up with one build at the window's
shapes. Each build of the window runs on train and test datasets the
process has not built a design matrix for: fresh catalog datasets over
the set-up's columns, with dataset persistence and model saving off (a
saved model would be an 11 GB ``params.npz`` a build); the previous
build's datasets are deleted first. The window's end-to-end value is
``build_s``: its seconds over the builds it completed.

The registry's ``tx`` trainer is wrapped for the run: the wrapper keeps
a reference to the fitted model's parameters (no copy), dropped when the
next fit starts, and a routing observer keeps each expert layer's
choices at the fit's first step. ``judge`` holds what the last build
produced — its step losses, its final parameters, its first step's
routing and its prediction dataset's probabilities — against the plain
reference (``reference/moonlight.py``) repeating the build's steps from
the same initial parameters and batches.
"""

from __future__ import annotations

import gc
import sys

import numpy as np

LABEL = "label"


def tokens(n_docs: int, T: int, perm, s: float, gen, device):
    """(n_docs, T) int32 token ids, Zipf-distributed with exponent ``s``
    over the ranks of ``perm``, rank r the id ``perm[r]``."""
    import torch

    vocab = perm.numel()
    w = torch.arange(1, vocab + 1, dtype=torch.float64,
                     device=device) ** (-float(s))
    cdf = torch.cumsum(w, 0)
    cdf = cdf / cdf[-1]
    u = torch.rand((n_docs, T), generator=gen, dtype=torch.float64,
                   device=device)
    rank = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
    del u
    return perm[rank].to(torch.int32)


def make_data(run) -> dict:
    """Train and test token matrices and labels (host int32), drawn on the
    run's device: the permutation, train ids, train labels, test ids,
    test labels, in that order."""
    import torch

    from portbench import data

    shape = run.config["data"]
    hp = run.config["program"]["hparams"]
    gen = data.generator(run.seed, run.device)
    perm = torch.randperm(hp["vocab"], generator=gen, device=run.device)
    out = {}
    for part, n in (("train", shape["train_docs"]),
                    ("test", shape["test_docs"])):
        X = tokens(n, shape["tokens"], perm, shape["zipf_s"], gen,
                   run.device)
        y = torch.randint(0, shape["classes"], (n,), generator=gen,
                          device=run.device)
        out[part] = (X.cpu().numpy(), y.cpu().numpy().astype(np.int64))
        del X, y
    if run.on_card:
        torch.cuda.empty_cache()
    return out


def columns(X: np.ndarray, y: np.ndarray) -> dict:
    """Catalog columns: ``t<j>`` the j-th token of every document."""
    XT = np.ascontiguousarray(X.T)
    cols = {f"t{j}": XT[j] for j in range(XT.shape[0])}
    cols[LABEL] = y
    return cols


def hparams(config: dict) -> dict:
    return dict(config["program"]["hparams"])


def _install(run) -> None:
    """Wrap the registry's tx trainer and observe the routing."""
    from learningorchestra_tpu_torch.models import moe, registry

    st = run.state
    fit = registry.CLASSIFIERS["tx"]

    def kept_fit(*args, **kw):
        st["kept"] = None
        st["routes"] = {}
        model = fit(*args, **kw)
        st["kept"] = model.params
        return model

    def observe(layer, chosen):
        st["routes"].setdefault(layer, chosen)

    registry.CLASSIFIERS["tx"] = kept_fit
    moe.set_route_observer(observe)
    st["unwrap"] = lambda: (registry.CLASSIFIERS.__setitem__("tx", fit),
                            moe.set_route_observer(None))


def setup(run) -> None:
    # The program's expert layer: a program without it cannot run this
    # cell, and stops here.
    from learningorchestra_tpu_torch.catalog.store import DatasetStore
    from learningorchestra_tpu_torch.models import moe  # noqa: F401
    from learningorchestra_tpu_torch.models.builder import ModelBuilder
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime

    d = make_data(run)
    cfg = run.settings()
    cfg.persist_models = False
    store = DatasetStore(cfg)
    runtime = DeviceRuntime(cfg, device=run.device)
    mb = ModelBuilder(store, runtime, cfg)
    run.state.update(data=d, train=columns(*d["train"]),
                     test=columns(*d["test"]), store=store, runtime=runtime,
                     mb=mb, builds=0, warm=True)
    _install(run)
    _one_build(run)
    run.state["warm"] = False
    _delete_build(run, 0)
    run.state["builds"] = 0


def _delete_build(run, i: int) -> None:
    store = run.state["store"]
    for name in (f"train{i}", f"test{i}", f"pred{i}_tx"):
        if store.exists(name):
            store.delete(name)


def _one_build(run) -> None:
    st = run.state
    store, i = st["store"], st["builds"]
    if i:
        _delete_build(run, i - 1)
    store.create(f"train{i}", columns=dict(st["train"]), finished=True)
    store.create(f"test{i}", columns=dict(st["test"]), finished=True)
    reports = st["mb"].build(f"train{i}", f"test{i}", f"pred{i}", ["tx"],
                             LABEL, hparams={"tx": hparams(run.config)})
    st["builds"] += 1
    err = [r.metrics["error"] for r in reports if "error" in r.metrics]
    if st["warm"] and err:
        raise RuntimeError(f"the warm-up build failed: {err[0]}")
    if not st["warm"]:
        run.attempted += 1
        run.failed += bool(err)
    ds = store.get(f"pred{i}_tx")
    doc = ds.metadata.to_doc()
    st["probs"] = (np.asarray(list(ds.columns["probability"]), np.float64)
                   if doc.get("finished") and not doc.get("error") else None)


def window(run) -> dict:
    seconds, builds = run.closed_loop("build", lambda: _one_build(run))
    return {"build_s": seconds / builds}


def release(run) -> None:
    """Keep the last build's step losses, final parameters, first-step
    routing and probabilities; free the program."""
    import torch

    from learningorchestra_tpu_torch.models import moe, sequence

    st = run.state
    st["losses"] = sequence.fit_losses()
    st["counts"] = moe.counts()
    st["unwrap"]()
    _delete_build(run, st["builds"] - 1)
    for k in ("mb", "runtime", "store"):
        st.pop(k)
    gc.collect()
    if run.on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_config(run):
    from portbench.reference import moonlight as ref

    return ref.config(**hparams(run.config),
                      n_classes=run.config["data"]["classes"])


def batches(run) -> list:
    """Each training step's rows, drawn as the tx fit draws them."""
    hp = hparams(run.config)
    rng = np.random.default_rng(int(hp["seed"]))
    n = run.state["data"]["train"][0].shape[0]
    return [rng.integers(0, n, hp["batch"])
            for _ in range(hp["train_steps"])]


def reference_numbers(run, prog: dict, device) -> list:
    """The four numbers of the comparison, from what the timed path (or a
    control in its place) produced — ``prog``: ``losses``, ``params``,
    ``routes`` ({layer: (B·T, k)}), ``probs`` (test docs, classes) —
    against the float32 reference repeating the build's steps:

    - ``loss_gap``: the relative difference of the first step's loss,
      the one both sides take from the same parameters (at lr 1e-3
      Adam's first step moves nearly every weight by about lr whatever
      its gradient's size, a gradient within rounding of zero either
      way, and the loss jumps from about 1.3 to 10–28: two sound float32
      runs' later losses differ by up to 3.4%, as much as the bfloat16
      control's, so the later steps are held by ``param_gap``);
    - ``param_gap``: the largest over the trained leaves of
      ||P_prog − P_ref|| / ||P_ref − P_init||;
    - ``prob_gap``: the largest log-probability difference on the test
      documents, the reference's forward at the program's final params;
    - ``route_flips``: the share of the first step's (token, layer)
      expert sets that differ."""
    import torch

    from portbench.reference import moonlight as ref

    hp = hparams(run.config)
    cfg = reference_config(run)
    X, y = run.state["data"]["train"]
    Xd = torch.from_numpy(X).to(device)
    yd = torch.from_numpy(y).to(device)
    routes = {}

    def observe(step, layer, chosen):
        if step == 0:
            routes[layer] = chosen

    params = ref.init_params(cfg, hp["seed"], device)
    losses = ref.train(params, Xd, yd, batches(run), cfg, hp["lr"],
                       observe=observe, remat=True)
    del Xd, yd
    print(f"portbench: step losses {prog['losses']} (program), {losses} "
          f"(reference)", file=sys.stderr)
    loss_gap = (abs(prog["losses"][0] - losses[0]) / abs(losses[0])
                if len(prog["losses"]) == len(losses) else float("inf"))
    flips, total = 0, 0
    for layer, ch in routes.items():
        mine = prog["routes"].get(layer)
        if mine is None or mine.shape != ch.shape:
            flips, total = 1, 1
            break
        same = (torch.sort(mine.to(ch.device), -1).values
                == torch.sort(ch, -1).values).all(-1)
        flips += int((~same).sum())
        total += same.numel()
    route_flips = flips / max(total, 1)
    param_gap = 0.0
    for name, p0 in ref.init_leaves(cfg, hp["seed"], device):
        if not ref.trainable(name):
            continue
        mine = prog["params"][name].to(device)
        moved = float(torch.linalg.vector_norm(params[name] - p0))
        off = float(torch.linalg.vector_norm(mine - params[name]))
        del p0, mine
        if off > 0.0:
            param_gap = max(param_gap, off / moved if moved > 0.0
                            else float("inf"))
    del params
    if run.on_card:
        torch.cuda.empty_cache()
    Xt, _ = run.state["data"]["test"]
    logits = ref.forward(prog["params"], torch.from_numpy(Xt).to(device),
                         cfg)
    want = torch.log_softmax(logits.double(), -1).cpu().numpy()
    if prog["probs"] is None or prog["probs"].shape != want.shape:
        prob_gap = float("inf")
    else:
        with np.errstate(divide="ignore"):
            prob_gap = float(np.abs(np.log(prog["probs"]) - want).max())
    return [("loss_gap", loss_gap), ("param_gap", param_gap),
            ("prob_gap", prob_gap), ("route_flips", route_flips)]


def judge(run) -> list:
    st = run.state
    limits = run.config["limits"]["txbuild"]
    checks = [("tokens_dropped", float(st["counts"]["tokens_dropped"]), 0.0)]
    if st.get("kept") is None or not st.get("routes"):
        return checks + [("model_found", 1.0, 0.0)]
    prog = {"losses": st["losses"], "params": st.pop("kept"),
            "routes": st["routes"], "probs": st.get("probs")}
    numbers = reference_numbers(run, prog, run.device)
    return checks + [(k, v, limits[k]) for k, v in numbers]
