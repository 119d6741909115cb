"""The PyTorch package's copied catalog planes against the JAX package's,
on the CPU: ingest resume, replica repair and the failpoint crash sweep.

``catalog/{dataset,store,replicate,ingest}.py`` and
``utils/failpoints.py`` are copies of the JAX package's modules. Here
both packages take the same source and must agree: a cut ingest commits
the same rows and resumes byte-identically; a chunk lost from a store
heals from a peer of either package (one wire protocol); and a child
process crashed at each of the port's data-plane failpoints leaves a
store that both packages recover to the same journaled prefix.

The ingest source is tests/test_resume.py's 5,000-row CSV (83,155
bytes), cut after its first commit (70 KB): both packages commit 852
rows there.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import learningorchestra_tpu.catalog.ingest as jing
import learningorchestra_tpu_torch.catalog.ingest as ting
from learningorchestra_tpu.catalog import replicate as jreplicate
from learningorchestra_tpu.catalog.store import DatasetStore as JaxStore
from learningorchestra_tpu.config import Settings as JaxSettings
from learningorchestra_tpu.utils import failpoints as jfailpoints
from learningorchestra_tpu_torch.catalog import readpipe
from learningorchestra_tpu_torch.catalog import replicate as treplicate
from learningorchestra_tpu_torch.catalog.dataset import ChunkCorrupt
from learningorchestra_tpu_torch.catalog.store import DatasetStore
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.utils import failpoints, fitckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jing, JaxStore, JaxSettings, jreplicate),
        "torch": (ting, DatasetStore, Settings, treplicate)}
N_ROWS = 5000
CUT_BYTES = 70_000
COMMITTED_AT_CUT = 852


@pytest.fixture(autouse=True)
def _clean_globals():
    failpoints.reset()
    jfailpoints.reset()
    readpipe.reset()
    yield
    failpoints.reset()
    jfailpoints.reset()
    readpipe.reset()


def _write_csv(path, n):
    lines = ["a,b,s"]
    for i in range(n):
        lines.append(f"{i},{i * 1.5},tag{i % 5}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _assert_rows_identical(ds, n):
    assert ds.num_rows == n
    assert ds.column("a").tolist() == list(range(n))
    assert ds.column("b").tolist() == [i * 1.5 for i in range(n)]
    assert ds.column("s").tolist() == [f"tag{i % 5}" for i in range(n)]


def _cfg(pkg, root, **kw):
    cfg = PKGS[pkg][2]()
    cfg.store_root = str(root)
    cfg.persist = True
    cfg.ingest_chunk_rows = 200
    cfg.ingest_commit_bytes = 0
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _cut_ingest(pkg, cfg, name, src, cut=CUT_BYTES):
    """Ingest ``src`` with the stream dying after ``cut`` bytes."""
    ing, Store = PKGS[pkg][0], PKGS[pkg][1]
    real_open = ing._open_url_stream

    def dying(url, timeout, offset=0):
        served = 0
        for chunk in real_open(url, timeout, offset=offset):
            for i in range(0, len(chunk), 4 << 10):
                piece = chunk[i:i + (4 << 10)]
                served += len(piece)
                yield piece
                if served > cut:
                    raise ConnectionError("stream died")

    store = Store(cfg)
    store.create(name, url=src)
    ing._open_url_stream = dying
    try:
        with pytest.raises(ConnectionError):
            ing.ingest_csv_url(store, name, src, cfg)
    finally:
        ing._open_url_stream = real_open
    return store.get(name).num_rows


# -- ingest resume ------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_cut_ingest_resumes_byte_identical(tmp_path, pkg):
    src = _write_csv(tmp_path / "d.csv", N_ROWS)
    assert os.path.getsize(src) == 83_155
    cfg = _cfg(pkg, tmp_path / "store")
    assert _cut_ingest(pkg, cfg, "d", src) == COMMITTED_AT_CUT
    ing, Store = PKGS[pkg][0], PKGS[pkg][1]
    store = Store(cfg)
    store.load_all(resume_ingests=True)
    assert store.resumable_ingests == ["d"]
    ds = store.get("d")
    assert ds.metadata.finished is False and ds.metadata.error is None
    assert ds.num_rows == COMMITTED_AT_CUT
    ing.resume_ingest(store, "d", cfg)
    _assert_rows_identical(store.get("d"), N_ROWS)
    assert store.get("d").metadata.finished is True
    # The resumed journal reloads in both packages.
    for other in ("jax", "torch"):
        again = PKGS[other][1](_cfg(other, tmp_path / "store"))
        again.load_all()
        _assert_rows_identical(again.get("d"), N_ROWS)


def test_both_packages_resume_each_others_cut_ingest(tmp_path):
    """The journal a cut ingest leaves is one format: each package
    resumes the other's, and the journaled source offsets agree."""
    src = _write_csv(tmp_path / "d.csv", N_ROWS)
    offsets = {}
    for writer, resumer in (("jax", "torch"), ("torch", "jax")):
        root = tmp_path / f"{writer}_store"
        _cut_ingest(writer, _cfg(writer, root), "d", src)
        with open(root / "d" / "journal.jsonl") as f:
            offsets[writer] = [json.loads(line)["src_off"] for line in f]
        cfg = _cfg(resumer, root)
        store = PKGS[resumer][1](cfg)
        store.load_all(resume_ingests=True)
        assert store.resumable_ingests == ["d"]
        PKGS[resumer][0].resume_ingest(store, "d", cfg)
        _assert_rows_identical(store.get("d"), N_ROWS)
    assert offsets["jax"] == offsets["torch"] and offsets["jax"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_resume_refuses_a_changed_source(tmp_path, pkg):
    src = _write_csv(tmp_path / "d.csv", N_ROWS)
    cfg = _cfg(pkg, tmp_path / "store")
    assert _cut_ingest(pkg, cfg, "d", src) == COMMITTED_AT_CUT
    _write_csv(tmp_path / "d.csv", 1000)          # rewritten, shorter
    store = PKGS[pkg][1](cfg)
    store.load_all(resume_ingests=True)
    with pytest.raises(PKGS[pkg][0].SourceChanged):
        PKGS[pkg][0].resume_ingest(store, "d", cfg)


def test_src_offsets_match_the_jax_journal(tmp_path):
    src = _write_csv(tmp_path / "d.csv", 1000)
    recs = {}
    for pkg in ("jax", "torch"):
        cfg = _cfg(pkg, tmp_path / pkg, ingest_chunk_rows=100)
        store = PKGS[pkg][1](cfg)
        store.create("d", url=src)
        PKGS[pkg][0].ingest_csv_url(store, "d", src, cfg)
        with open(tmp_path / pkg / "d" / "journal.jsonl") as f:
            recs[pkg] = [json.loads(line) for line in f]
        assert store.get("d").resume_offset == os.path.getsize(src)
    key = ("src_off", "rows", "crc32")
    assert ([{k: r.get(k) for k in key} for r in recs["torch"]]
            == [{k: r.get(k) for k in key} for r in recs["jax"]])


# -- replica repair ----------------------------------------------------------

def _seed(store, name="d", n_chunks=3, rows=200):
    ds = store.create(name)
    for i in range(n_chunks):
        ds.append_columns({"x": np.arange(i * rows, (i + 1) * rows,
                                          dtype=np.int64)})
        store.save(name)
    store.finish(name)
    return np.arange(n_chunks * rows, dtype=np.int64)


@pytest.mark.parametrize("store_pkg,peer_pkg", [
    ("torch", "torch"), ("torch", "jax"), ("jax", "torch")])
def test_lost_chunks_heal_from_a_peer_of_either_package(tmp_path, store_pkg,
                                                        peer_pkg):
    peer = PKGS[peer_pkg][3].ReplicaServer(root=str(tmp_path / "peer"),
                                           port=0)
    cfg = _cfg(store_pkg, tmp_path / "store", replica_peers=peer.addr,
               replica_push_retry_s=0.0)
    store = PKGS[store_pkg][1](cfg)
    try:
        want = _seed(store, "d", n_chunks=3)
        assert store.replication_drain(timeout_s=30.0)
        snap = store.replication_snapshot()
        assert snap["max_lag_bytes"] == 0 and not snap["under_replicated"]
        chunks = tmp_path / "store" / "d" / "chunks"
        shutil.rmtree(chunks)                      # a re-imaged host
        store2 = PKGS[store_pkg][1](cfg)
        store2.load("d")
        report = store2.scrub("d")
        assert report["ok"], report
        assert report["missing"] == 3 and report["checked"] == 3
        assert store2.integrity_snapshot()["chunks_repaired"] == 3
        np.testing.assert_array_equal(store2.get("d").column("x"), want)
        store2.stop_replication()
    finally:
        store.stop_replication()
        peer.stop()
    assert peer.snapshot()["counters"]["fetches"] == 3


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_bit_rot_heals_from_the_mirror(tmp_path, pkg):
    fp = failpoints if pkg == "torch" else jfailpoints
    cfg = _cfg(pkg, tmp_path / "store",
               replica_root=str(tmp_path / "replica"))
    store = PKGS[pkg][1](cfg)
    store.create("d", columns={"x": np.arange(50, dtype=np.int64)})
    store.save("d")
    store.finish("d")
    fp.configure("catalog.chunk.pre_read=bitflip")
    store2 = PKGS[pkg][1](cfg)
    np.testing.assert_array_equal(store2.load("d").column("x"),
                                  np.arange(50, dtype=np.int64))
    snap = store2.integrity_snapshot()
    assert snap["chunks_corrupt"] == 1 and snap["chunks_repaired"] == 1
    fp.reset()
    assert store2.scrub("d")["ok"]


def test_unrepairable_loss_is_a_precise_chunk_corrupt(tmp_path):
    peer = treplicate.ReplicaServer(root=str(tmp_path / "peer"), port=0)
    cfg = _cfg("torch", tmp_path / "store", replica_peers=peer.addr)
    store = DatasetStore(cfg)
    try:
        _seed(store, "d", n_chunks=1)
        assert store.replication_drain(timeout_s=30.0)
        chunks = tmp_path / "store" / "d" / "chunks"
        os.remove(chunks / os.listdir(chunks)[0])
        failpoints.configure("replicate.fetch.pre_read=raise")
        store2 = DatasetStore(cfg)
        ds = store2.load("d")
        with pytest.raises(ChunkCorrupt):
            _ = ds.columns
        assert store2.replication_snapshot()["counters"]["errors"] >= 1
        store2.stop_replication()
    finally:
        store.stop_replication()
        peer.stop()


# -- the failpoint crash sweep ------------------------------------------------

#: The sweep's workload, run in a child process of the PyTorch package
#: (tests/failpoint_child.py's, on the port's modules): ingest, a
#: partitioned ingest, appends and a column rewrite, a cold read, two
#: fit checkpoints, and a push to an in-process peer followed by a
#: remote repair. Writes done.json when no failpoint killed it.
CHILD = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, sys.argv[2])
from learningorchestra_tpu_torch.catalog.ingest import ingest_csv_url
from learningorchestra_tpu_torch.catalog.replicate import ReplicaServer
from learningorchestra_tpu_torch.catalog.store import DatasetStore
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.utils import fitckpt

root = sys.argv[1]
cfg = Settings()
cfg.store_root = os.path.join(root, "store")
cfg.replica_root = os.path.join(root, "replica")
cfg.persist = True
cfg.use_native_csv = False
cfg.ingest_chunk_rows = 64
store = DatasetStore(cfg)
src = os.path.join(root, "src.csv")
store.create("ing", url=src)
ingest_csv_url(store, "ing", src, cfg)
pcfg = cfg.replace(ingest_partitions=2, ingest_partition_min_bytes=1)
store.create("pshard", url=src)
ingest_csv_url(store, "pshard", src, pcfg)
ds = store.create("tab", columns={"a": np.arange(100, dtype=np.int64),
                                  "b": np.arange(100, dtype=np.float64)})
store.save("tab")
ds.append_columns({"a": np.arange(100, 200, dtype=np.int64),
                   "b": np.arange(100, 200, dtype=np.float64)})
store.save("tab")
ds.set_column("a", ds.column("a").astype(np.float64))
store.save("tab")
store.finish("tab")
store2 = DatasetStore(cfg)
for name in ("ing", "pshard", "tab"):
    store2.load(name)
n_ing = store2.get("ing").num_rows
fctx = fitckpt.context(cfg, dataset="ck", family="gb", config={"v": 1},
                       snapshot="rows=10", every=1)
fctx.save(1, {"feat": np.arange(4, dtype=np.int32)})
fctx.save(2, {"feat": np.arange(8, dtype=np.int32)})
assert fctx.load()[0] == 2
peer = ReplicaServer(root=os.path.join(root, "peer"), port=0)
rcfg = Settings()
rcfg.store_root = os.path.join(root, "repstore")
rcfg.replica_root = ""
rcfg.persist = True
rcfg.replica_peers = f"{peer.host}:{peer.port}"
rstore = DatasetStore(rcfg)
rstore.create("rep", columns={"x": np.arange(256, dtype=np.int64)})
rstore.save("rep")
rstore.finish("rep")
assert rstore.replication_drain(timeout_s=60.0)
rstore.stop_replication()
rchunks = os.path.join(rcfg.store_root, "rep", "chunks")
os.remove(os.path.join(rchunks, sorted(os.listdir(rchunks))[0]))
rstore2 = DatasetStore(rcfg)
rx = rstore2.load("rep").column("x")
assert rstore2.integrity_snapshot()["chunks_repaired"] >= 1
rstore2.stop_replication()
peer.stop()
with open(os.path.join(root, "done.json"), "w") as f:
    json.dump({"ing_rows": n_ing, "tab_rows": store2.get("tab").num_rows,
               "pshard_rows": store2.get("pshard").num_rows,
               "rep_rows": int(len(rx))}, f)
"""


def _run_child(root, spec=None):
    with open(os.path.join(root, "src.csv"), "w") as f:
        f.write("a,b\n")
        for i in range(2000):
            f.write(f"{i},{i * 0.5}\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LO_TPU_")}
    if spec:
        env[failpoints.ENV_VAR] = spec
    return subprocess.run([sys.executable, "-c", CHILD, root, REPO],
                          capture_output=True, text=True, timeout=120,
                          env=env)


def _sweep_sites():
    import learningorchestra_tpu_torch.catalog.ingest  # noqa: F401
    import learningorchestra_tpu_torch.catalog.replicate  # noqa: F401

    return [s for s in failpoints.sites()
            if s.startswith(("catalog.", "ingest.", "store.", "fit.",
                             "replicate."))]


def _recover(pkg, root):
    """Load a crashed store with one package: every dataset scrubs green,
    reads whole and sits in a terminal (or resumable) state. Returns
    {name: (rows, columns)}."""
    cfg = _cfg(pkg, os.path.join(root, "store"),
               replica_root=os.path.join(root, "replica"),
               scrub_on_load=True)
    store = PKGS[pkg][1](cfg)
    out = {}
    for name in store.load_all():
        ds = store.get(name)
        assert store.scrub(name)["ok"], (pkg, name)
        cols = ds.columns
        n = len(next(iter(cols.values()))) if cols else 0
        assert n == ds.num_rows, (pkg, name)
        assert (ds.metadata.finished or name in store.resumable_ingests
                or ds.metadata.error), (pkg, name)
        assert not (ds.metadata.error or "").startswith(
            "chunk corruption"), (pkg, name)
        out[name] = (ds.num_rows, {f: list(v) for f, v in cols.items()})
    assert out.get("ing", (0,))[0] <= 2000
    assert out.get("pshard", (0,))[0] <= 2000
    assert out.get("tab", (0,))[0] <= 200
    store.create("post", columns={"y": np.arange(5)})
    store.save("post")
    assert store.scrub("post")["ok"]
    return out


def test_control_child_completes(tmp_path):
    proc = _run_child(str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(tmp_path / "done.json") as f:
        done = json.load(f)
    assert done == {"ing_rows": 2000, "tab_rows": 200, "pshard_rows": 2000,
                    "rep_rows": 256}
    assert set(_recover("jax", str(tmp_path))) == {"ing", "pshard", "tab"}


def test_the_sweep_covers_the_jax_packages_sites():
    import learningorchestra_tpu.catalog.ingest  # noqa: F401
    import learningorchestra_tpu.catalog.replicate  # noqa: F401
    import learningorchestra_tpu.utils.fitckpt  # noqa: F401

    want = [s for s in jfailpoints.sites()
            if s.startswith(("catalog.", "ingest.", "store.", "fit.",
                             "replicate."))]
    assert sorted(_sweep_sites()) == sorted(want)


@pytest.mark.parametrize("site", _sweep_sites())
def test_crash_sweep_recovers_the_same_prefix_in_both(tmp_path, site):
    """Crash the port's child at ``site``; copies of what it left recover
    in both packages to the same journaled prefix, and a fit checkpoint
    a resume would trust is a whole pair."""
    root = str(tmp_path / "run")
    os.makedirs(root)
    proc = _run_child(root, f"{site}=crash")
    assert proc.returncode == failpoints.CRASH_EXIT_CODE, (
        f"site {site}: exit {proc.returncode}\n{proc.stderr[-2000:]}")
    assert not os.path.exists(os.path.join(root, "done.json"))
    got = {}
    for pkg in ("jax", "torch"):
        copy = str(tmp_path / pkg)
        shutil.copytree(root, copy)
        got[pkg] = _recover(pkg, copy)
    assert got["torch"] == got["jax"]
    ctx = fitckpt.context(_cfg("torch", os.path.join(root, "store")),
                          dataset="ck", family="gb", config={"v": 1},
                          snapshot="rows=10", every=1)
    loaded = ctx.load()
    if site == "fit.ckpt.pre_read":
        assert loaded is not None and loaded[0] == 2
    if loaded is not None:
        np.testing.assert_array_equal(
            loaded[1]["feat"], np.arange(4 * loaded[0], dtype=np.int32))
