"""The t-SNE image service's embedding: ``viz.service.embed_dataset(...,
"tsne", ...)`` of one catalog dataset, one image at a time (a closed
loop).

Set-up makes the dataset from the seed on the card
(``data.manifold_mix``), copies it to the host once and warms up with a
small embed. The card's machine has no plotting library, so the window
drives the embedding step of ``create_embedding_image`` and not its PNG
render. Its end-to-end value is ``image_s``: its seconds over the
embeddings it completed.

The descent's steps are the program's own state: a recorder around
``viz.tsne._step`` counts every image's steps, checks that each step
starts from the very state (embedding, velocity, gains) the step before
returned, unmodified, keeps the inputs and outputs of the steps it is
told to pick, and keeps the last image's affinity table, so that the
reference can take the picked steps itself and rebuild the affinities:
each embedding the window produced is the last step's output of a chain
of steps whose picked links the reference has taken again.
"""

from __future__ import annotations

import gc
import math

import numpy as np

from portbench import data
from portbench.reference import tsne as ref_tsne

LABEL = "label"


class StepRecorder:
    """Wraps ``viz.tsne._step`` while installed. For each image:
    ``steps``, its count of steps; ``breaks``, the steps whose state is
    not the unmodified state the step before returned; ``picked``, step
    index -> (inputs, outputs) of the steps ``begin`` named; ``out``, the
    embedding it returned; ``last``, its last step's output."""

    def __init__(self):
        self.images = []
        self.table = None
        self._image = None
        self._prev = None
        self._picks = set()
        self._saved = None

    def install(self) -> None:
        from learningorchestra_tpu_torch.viz import tsne

        orig = tsne._step

        def step(Y, vel, gains, sym_idx, sym_w, ov_src, ov_dst, ov_w,
                 n_valid, *args, **kw):
            img = self._image
            state = (Y, vel, gains)
            if img["steps"] == 0:
                self.table = (sym_idx, sym_w, ov_src, ov_dst, ov_w)
            elif self._prev is None or any(
                    a is not b or a._version != v
                    for a, (b, v) in zip(state, self._prev)):
                img["breaks"] += 1
            out = orig(Y, vel, gains, sym_idx, sym_w, ov_src, ov_dst, ov_w,
                       n_valid, *args, **kw)
            if img["steps"] in self._picks:
                img["picked"][img["steps"]] = (state, tuple(out[:3]))
            self._prev = [(t, t._version) for t in out[:3]]
            img["steps"] += 1
            img["last"] = out[0]
            return out

        self._saved = (tsne, orig)
        tsne._step = step

    def uninstall(self) -> None:
        if self._saved is not None:
            mod, orig = self._saved
            mod._step = orig
            self._saved = None

    def begin(self, picks) -> None:
        self.table = None
        self._prev = None
        self._picks = set(picks)
        self._image = {"steps": 0, "breaks": 0, "picked": {}, "last": None}

    def end(self, embedding: np.ndarray) -> None:
        self._image["out"] = embedding
        self.images.append(self._image)
        self._image = self._prev = None


def picks(program: dict, rng: np.random.Generator) -> list:
    """The steps of one image that the reference takes: the first, the
    last two of the exaggerated phase's schedule and the first after it,
    the last, and ``random_picks`` more drawn from ``rng``."""
    iters, e = program["iters"], program["exaggeration_iters"]
    fixed = {0, e - 1, e, iters - 1}
    rest = [i for i in range(1, iters - 1) if i not in fixed]
    drawn = rng.choice(len(rest), program["random_picks"], replace=False)
    return sorted(fixed | {rest[i] for i in drawn})


def make_columns(run) -> dict:
    import torch

    shape = run.config["data"]
    gen = data.generator(run.seed, run.device)
    X, y = data.manifold_mix(shape["rows"], shape["features"],
                             shape["classes"], gen, run.device)
    cols = data.feature_columns(X, y, "p")
    del X, y
    if run.on_card:
        torch.cuda.empty_cache()
    return cols


def setup(run) -> None:
    from learningorchestra_tpu_torch.catalog.store import DatasetStore
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
    from learningorchestra_tpu_torch.viz.service import embed_dataset

    cols = make_columns(run)
    cfg = run.settings()
    store = DatasetStore(cfg)
    runtime = DeviceRuntime(cfg, device=run.device)
    warm = int(run.traffic["warmup_rows"])
    store.create("warm", columns={k: v[:warm] for k, v in cols.items()},
                 finished=True)
    embed_dataset(store, runtime, "tsne", "warm", label=LABEL)
    store.delete("warm")
    store.create("images", columns=cols, finished=True)
    recorder = StepRecorder()
    recorder.install()
    run.state.update(cols=cols, store=store, runtime=runtime,
                     recorder=recorder, embed=embed_dataset,
                     picks=np.random.default_rng(run.seed))


def _one_image(run) -> None:
    st = run.state
    st["recorder"].begin(picks(run.config["program"], st["picks"]))
    emb, _ = st["embed"](st["store"], st["runtime"], "tsne", "images",
                         label=LABEL)
    st["recorder"].end(emb)
    run.attempted += 1
    if emb.shape != (run.config["data"]["rows"], 2):
        run.failed += 1


def window(run) -> dict:
    seconds, images = run.closed_loop("image", lambda: _one_image(run))
    return {"image_s": seconds / images}


def release(run) -> None:
    import torch

    st = run.state
    st["recorder"].uninstall()
    for k in ("store", "runtime", "embed"):
        st.pop(k)
    gc.collect()
    if run.on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def schedule(program: dict, it: int, n_valid: int) -> dict:
    """The descent's documented schedule at step ``it``."""
    early = it < program["exaggeration_iters"]
    return {"exaggeration": program["exaggeration"] if early else 1.0,
            "momentum": (program["early_momentum"] if early
                         else program["momentum"]),
            "eta": max(n_valid / program["eta_divisor"], program["eta_min"])}


def numbers(run, recorder: StepRecorder, X: np.ndarray, *,
            dtype=None, tf32: bool = False) -> list:
    """The program's images against the reference (or, with ``dtype``
    and ``tf32``, against the reference computed at that precision put
    in the program's place):

    - ``affinity_gap``: the last image's affinity table against the
      reference's affinities;
    - ``chain_breaks``: over the images, the steps short of the
      configuration's count, the steps that did not start from the state
      the step before returned, and the embeddings that are not the last
      step's output;
    - ``step_gap.first`` and ``step_gap.rest``: the worst over the
      images of the first picked step's, and of the other picked steps',
      ``ref_tsne.step_gap`` against the reference step at the
      configuration's schedule;
    - ``gain_flips``: the worst over the picked steps of
      ``ref_tsne.gain_flips``."""
    import torch

    prog = run.config["program"]
    n = X.shape[0]
    P_ref = ref_tsne.affinities(X, perplexity=prog["perplexity"],
                                pca_dims=prog["pca_dims"], device=run.device)
    if dtype is None:
        P_prog = ref_tsne.table_affinities(*recorder.table, n_valid=n)
    else:
        P_prog = ref_tsne.affinities(X, perplexity=prog["perplexity"],
                                     pca_dims=prog["pca_dims"],
                                     device=run.device, dtype=torch.float32,
                                     tf32=tf32)
    out = [("affinity_gap", ref_tsne.affinity_gap(P_prog, P_ref))]
    del P_prog
    iters = prog["iters"]
    breaks, flips = 0, 0.0
    worst = {"first": 0.0, "rest": 0.0}
    for img in recorder.images:
        final = torch.as_tensor(np.asarray(img["out"]), device=P_ref.device)
        breaks += abs(iters - img["steps"]) + img["breaks"]
        if img["last"] is None or final.shape != (n, 2) or not torch.equal(
                final, img["last"][:n].to(final.dtype)):
            breaks += 1
        for it, (state, prog_out) in sorted(img["picked"].items()):
            y, v, g = (t[:n] for t in state)
            kw = schedule(prog, it, n)
            ref_out = ref_tsne.step(y, v, g, P_ref, **kw)
            if dtype is not None:
                prog_out = ref_tsne.step(y, v, g, P_ref, dtype=dtype, **kw)
            key = "first" if it == 0 else "rest"
            prog_out = tuple(t[:n] for t in prog_out)
            worst[key] = max(worst[key], ref_tsne.step_gap(
                (y, v, g), prog_out, ref_out))
            flips = max(flips, ref_tsne.gain_flips(prog_out[2], ref_out[2]))
        if 0 not in img["picked"]:
            worst["first"] = math.inf
    out += [("chain_breaks", float(breaks)),
            ("step_gap.first", worst["first"]),
            ("step_gap.rest", worst["rest"]), ("gain_flips", flips)]
    return out


def design(cols: dict, rows: int, features: int) -> np.ndarray:
    return np.stack([np.asarray(cols[f"p{i}"], np.float32)
                     for i in range(features)], axis=1)[:rows]


def judge(run) -> list:
    st = run.state
    shape = run.config["data"]
    X = design(st["cols"], shape["rows"], shape["features"])
    limits = run.config["limits"]["tsne"]
    return [(name, value, limits[name])
            for name, value in numbers(run, st["recorder"], X)]
