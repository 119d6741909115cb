"""The seeded generators: deterministic, and of the published shapes."""

import numpy as np
import torch

from portbench import data


def test_higgs_like_is_seeded_and_has_the_published_shape():
    a = data.higgs_like(5000, data.generator(2**31 + 5, "cpu"), "cpu")
    b = data.higgs_like(5000, data.generator(2**31 + 5, "cpu"), "cpu")
    c = data.higgs_like(5000, data.generator(2**31 + 6, "cpu"), "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    X, y = a
    assert X.shape == (5000, 28) and X.dtype == torch.float32
    assert set(y.unique().tolist()) == {0, 1}
    cols = data.higgs_columns(X, y)
    assert list(cols) == [f"f{i}" for i in range(28)] + ["label"]
    assert all(cols[f"f{i}"].dtype == np.float32 for i in range(28))
    assert cols["label"].dtype == np.int64


def test_higgs_like_class_structure():
    X, y = data.higgs_like(200000, data.generator(3, "cpu"), "cpu")
    pos = y == 1
    # Mean-shift features separate the classes by 2·0.24; the bimodal and
    # pair features keep class 1's marginal mean and variance at N(0, 1).
    gap = X[pos][:, 10].mean() - X[~pos][:, 10].mean()
    assert abs(float(gap) - 0.48) < 0.02
    assert abs(float(X[pos][:, 14].std()) - 1.0) < 0.02
    rho = torch.corrcoef(X[pos][:, [20, 21]].T)[0, 1]
    assert abs(float(rho) - 0.55) < 0.02


def test_manifold_mix_is_seeded_and_has_the_published_shape():
    a = data.manifold_mix(3000, 784, 10, data.generator(9, "cpu"), "cpu")
    b = data.manifold_mix(3000, 784, 10, data.generator(9, "cpu"), "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].shape == (3000, 784) and a[0].dtype == torch.float32
    assert set(a[1].unique().tolist()) == set(range(10))
    cols = data.feature_columns(*a, "p")
    assert len(cols) == 785 and cols["label"].dtype == np.int64

