"""The plain references against the port at small sizes on the CPU: a
sound run is correct; the control (the reference at a lower precision in
the program's place) and each fault a cell can have are not."""

import pytest
import torch

from portbench import control, faults
from portbench.tests import small

BUILD = "higgs11m.build_cold"
TSNE = "mnist60k.tsne_image"
TUNE = "higgs11m.tune_rf"
CELLS = [BUILD, TSNE, TUNE]
KIND = {BUILD: "build", TSNE: "tsne", TUNE: "tune"}


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    doc = small.run(workload)
    assert doc["correct"], doc["checks"]
    assert doc["attempted"] >= 1 and doc["failed"] == 0
    assert set(doc["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    out = control.control(small.spec(workload), 5, "cpu")
    assert out["fails"], out["checks"]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in faults.FAULTS[KIND[w]]])
def test_fault_is_not_correct(workload, fault):
    doc = faults.run_with(fault, small.spec(workload), 11,
                          small.spec(workload)["seconds"], "cpu")
    assert not doc["correct"], doc["checks"]


def test_reference_trees_match_the_port_exactly():
    """dt and gb at a small size: the reference's trees are the port's
    (the port on the CPU runs its kernels' plain versions)."""
    from learningorchestra_tpu_torch.config import Settings
    from learningorchestra_tpu_torch.models import trees as pt
    from learningorchestra_tpu_torch.parallel.runtime import DeviceRuntime
    from portbench import data
    from portbench.reference import trees as rt

    X, y = data.higgs_like(6000, data.generator(4, "cpu"), "cpu")
    edges = rt.quantile_edges(X.numpy(), 32)
    runtime = DeviceRuntime(Settings(), device="cpu")
    m = pt.fit_dt(runtime, X.numpy(), y.numpy(), 2, edges=edges)
    B = rt.bin_codes(X, torch.from_numpy(edges))
    ref = rt.fit_forest(B, y, 2, n_trees=1, max_depth=5, n_bins=32,
                        seed=0)[0]
    internal = m.params["internal"][0]
    assert torch.equal(internal, ref["internal"])
    assert torch.equal(m.params["feat"][0].long()[internal],
                       ref["feat"][internal])
    assert torch.equal(m.params["leaf"][0], ref["leaf"])
