"""Carry a model fitted by the JAX package across to this package.

``from_jax_params`` takes the JAX model's parameter dict as numpy arrays
(the caller applies ``np.asarray`` to each leaf, so no JAX array ever
reaches this package) and returns a ``TrainedModel`` whose predictor is
this package's, with the same layouts: tree tables (T, M) or (C, R, M),
leaf statistics (T, M, S), gb leaf values and ``step_size``, bin
``edges`` (d, n_bins-1), lr ``W``/``b``/``mu``/``sigma``, nb moments,
mlp ``W1``/``b1``/``W2``/``b2``/``mu``/``sigma``. A tx model's nested
pytree (``embed``, ``pos``, ``head_w``, ``head_b`` and a list of layer
dicts) becomes the flat dict of models/transformer.py
(``layers.<i>.<name>``). Only the encoder block converts: the JAX
package has no ``mla_moe`` block.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from learningorchestra_tpu_torch.models.base import TrainedModel
from learningorchestra_tpu_torch.models.registry import predictor_for
from learningorchestra_tpu_torch.models.transformer import (
    TxConfig, param_names)

#: Parameter keys per family, with the dtype each is held in.
_KEYS = {
    "lr": {"W": np.float32, "b": np.float32, "mu": np.float32,
           "sigma": np.float32},
    "nb": {"mean": np.float32, "var": np.float32, "log_prior": np.float32,
           "theta": np.float32},
    "dt": {"edges": np.float32, "feat": np.int32, "thr": np.int32,
           "internal": np.bool_, "leaf": np.float32},
    "mlp": {"W1": np.float32, "b1": np.float32, "W2": np.float32,
            "b2": np.float32, "mu": np.float32, "sigma": np.float32},
    "gb": {"edges": np.float32, "feat": np.int32, "thr": np.int32,
           "internal": np.bool_, "leaf_val": np.float32,
           "step_size": np.float32},
}
_KEYS["rf"] = _KEYS["dt"]


def _flatten_tx(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    flat = {k: v for k, v in params.items() if k != "layers"}
    for i, layer in enumerate(params.get("layers", ())):
        flat.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return flat


def from_jax_params(kind: str, params: Dict[str, Any],
                    num_classes: int, hparams: Dict[str, Any]) -> TrainedModel:
    if kind == "tx":
        if hparams.get("block", TxConfig.block) != TxConfig.block:
            raise ValueError(
                f"the JAX package has no tx block {hparams['block']!r}: "
                f"only the {TxConfig.block} block converts")
        params = _flatten_tx(params)
        keys = dict.fromkeys(param_names(
            TxConfig(n_layers=int(hparams["n_layers"]))), np.float32)
    elif kind not in _KEYS:
        raise ValueError(f"no conversion for classifier kind {kind!r}")
    else:
        keys = _KEYS[kind]
    unknown = set(params) - set(keys)
    if unknown:
        raise ValueError(f"unexpected {kind} params: {sorted(unknown)}")
    out = {k: torch.from_numpy(np.array(v, dtype=keys[k]))
           for k, v in params.items()}
    return TrainedModel(kind=kind, params=out,
                        predict_proba_fn=predictor_for(kind, hparams),
                        num_classes=int(num_classes), hparams=dict(hparams))
