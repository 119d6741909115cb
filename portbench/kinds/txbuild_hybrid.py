"""The ``tx`` classifier's build at a hybrid block's widths (Kimi Linear's
``kda_mla_moe``): ``kinds/txbuild.py``'s closed loop of
``ModelBuilder.build(..., ["tx"], ...)`` on fresh datasets, its set-up,
window and release, judged against ``reference/kimi_linear.py``.

Set-up first imports the program's KDA layer: a program without the
block stops there, before any data is made. Beside ``txbuild``'s wrapper
of the registry's ``tx`` trainer, a second one keeps how many (token,
expert) pairs the held experts computed over the fit's training steps
(``moe.counts()``'s ``pairs_held``).

``judge`` holds what the last build produced — its step losses, its
final parameters and correction biases, its first step's routing over
all the router's experts, its held pairs and its prediction dataset's
probabilities —
against the plain reference repeating the build's steps from the same
initial parameters and batches, its recurrence token by token.
"""

from __future__ import annotations

import sys

import numpy as np

from portbench.kinds import txbuild

window = txbuild.window
release = txbuild.release
hparams = txbuild.hparams
batches = txbuild.batches


def setup(run) -> None:
    # The program's KDA layer: a program without it cannot run this cell,
    # and stops here.
    from learningorchestra_tpu_torch.models import kda  # noqa: F401

    txbuild.setup(run)
    _count_pairs(run)


def _count_pairs(run) -> None:
    """Wrap the (already wrapped) tx trainer: the fit's held pairs."""
    from learningorchestra_tpu_torch.models import moe, registry

    st = run.state
    fit = registry.CLASSIFIERS["tx"]

    def counted(*args, **kw):
        before = moe.counts()["pairs_held"]
        model = fit(*args, **kw)
        st["pairs_held"] = moe.counts()["pairs_held"] - before
        return model

    registry.CLASSIFIERS["tx"] = counted
    unwrap = st["unwrap"]
    st["unwrap"] = lambda: (registry.CLASSIFIERS.__setitem__("tx", fit),
                            unwrap())


def reference_config(run):
    from portbench.reference import kimi_linear as ref

    return ref.config(**hparams(run.config),
                      n_classes=run.config["data"]["classes"])


def reference_numbers(run, prog: dict, device) -> list:
    """The numbers of the comparison, from what the timed path (or a
    control in its place) produced — ``prog``: ``losses``, ``params``,
    ``routes`` ({layer: (B·T, k)} at the first step), ``pairs_held``
    (over the training steps), ``probs`` (test docs, classes) — against
    the float32 reference repeating the build's steps:

    - ``loss_gap``: the relative difference of the first step's loss;
    - ``param_gap``: the largest over the trained leaves of
      ||P_prog − P_ref|| / ||P_ref − P_init||;
    - ``prob_gap``: the largest log-probability difference on the test
      documents, the reference's forward at the program's final params;
    - ``route_flips``: the share of the first step's (token, layer)
      expert sets, over all the router's experts, that differ;
    - ``pairs_held_gap``: the relative difference of the (token, expert)
      pairs the held experts took over the training steps: each flip of
      a set between a held expert and another moves it by one;
    - ``bias_gap``: the share of the expert layers' correction-bias
      entries, over all the router's experts, where the final biases
      differ by more than γ/2. A step moves an entry by γ one way or the
      other, or not at all, by the sign of its expert's load against the
      mean: an update skipped or turned moves about every entry, a load
      that a route flip carries past the mean one entry."""
    import torch

    from portbench.reference import kimi_linear as ref

    hp = hparams(run.config)
    cfg = reference_config(run)
    first, held = ref.held_experts(cfg)
    X, y = run.state["data"]["train"]
    Xd = torch.from_numpy(X).to(device)
    yd = torch.from_numpy(y).to(device)
    routes, pairs = {}, [0]

    def observe(step, layer, chosen):
        if step == 0:
            routes[layer] = chosen
        pairs[0] += int(((chosen >= first) & (chosen < first + held)).sum())

    params = ref.init_params(cfg, hp["seed"], device)
    losses = ref.train(params, Xd, yd, batches(run), cfg, hp["lr"],
                       observe=observe, remat=True)
    del Xd, yd
    print(f"portbench: step losses {prog['losses']} (program), {losses} "
          f"(reference); held pairs {prog['pairs_held']} (program), "
          f"{pairs[0]} (reference)", file=sys.stderr)
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
    pairs_held_gap = (abs(prog["pairs_held"] - pairs[0]) / pairs[0]
                      if prog.get("pairs_held") is not None and pairs[0]
                      else float("inf"))
    off, entries = 0, 0
    for name, b in params.items():
        if name.endswith(".e_bias"):
            mine = prog["params"][name].to(device)
            off += int(((mine - b).abs() > cfg.bias_update_speed / 2).sum())
            entries += b.numel()
    bias_gap = off / entries if entries else float("inf")
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
            ("prob_gap", prob_gap), ("route_flips", route_flips),
            ("pairs_held_gap", pairs_held_gap), ("bias_gap", bias_gap)]


def judge(run) -> list:
    st = run.state
    limits = run.config["limits"]["txbuild8k"]
    checks = [("tokens_dropped", float(st["counts"]["tokens_dropped"]), 0.0)]
    if st.get("kept") is None or not st.get("routes"):
        return checks + [("model_found", 1.0, 0.0)]
    prog = {"losses": st["losses"], "params": st.pop("kept"),
            "routes": st["routes"], "pairs_held": st.get("pairs_held"),
            "probs": st.get("probs")}
    numbers = reference_numbers(run, prog, run.device)
    return checks + [(k, v, limits[k]) for k, v in numbers]
