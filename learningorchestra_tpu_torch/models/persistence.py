"""Model persistence — fitted models saved for re-use on new data.

The reference *discards* every fitted model: only predictions and metrics
survive (reference model_builder.py:227-248). Here every successful fit
saves its parameter dict as one ``params.npz`` plus a JSON manifest
carrying everything needed to serve it again: classifier kind, hparams
(the static args of its predictor), the fitted preprocessing state, and the
training metrics. ``ModelRegistry.load`` rebuilds a ``TrainedModel`` whose
predictor comes from ``registry.predictor_for``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from learningorchestra_tpu_torch.catalog.store import validate_name
from learningorchestra_tpu_torch.config import Settings
from learningorchestra_tpu_torch.models.base import TrainedModel
from learningorchestra_tpu_torch.models.registry import predictor_for


class ModelNotFound(KeyError):
    pass


class ModelRegistry:
    """Disk-backed registry of fitted models under ``store_root/_models``."""

    def __init__(self, cfg: Settings):
        self.cfg = cfg
        self.root = os.path.abspath(os.path.join(cfg.store_root, "_models"))
        self._lock = threading.Lock()
        self._recover_interrupted_saves()

    def _recover_interrupted_saves(self) -> None:
        """A crash between save()'s two swap renames leaves the live dir
        missing with the previous version parked at ``.old.<name>`` —
        promote it back, so a durably-saved model never disappears after a
        restart. Leftover ``.tmp.<name>`` staging is garbage."""
        if not os.path.isdir(self.root):
            return
        for entry in os.listdir(self.root):
            if not entry.startswith(".old."):
                continue
            live = os.path.join(self.root, entry[len(".old."):])
            parked = os.path.join(self.root, entry)
            if os.path.isdir(live):
                shutil.rmtree(parked)       # swap completed; stray aside
            else:
                os.rename(parked, live)
        for entry in os.listdir(self.root):
            if entry.startswith(".tmp."):
                shutil.rmtree(os.path.join(self.root, entry))

    def _dir(self, name: str) -> str:
        validate_name(name)
        return os.path.join(self.root, name)

    # -- write ---------------------------------------------------------------

    def save(self, name: str, model: TrainedModel,
             metrics: Optional[Dict[str, float]] = None,
             preprocess: Optional[Dict[str, Any]] = None) -> None:
        d = self._dir(name)
        params = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                      else np.asarray(v))
                  for k, v in model.params.items()}
        # Stage the whole new version in a sibling temp dir, then swap by
        # rename: a re-save must never leave a window where the model is
        # missing. Leading dot keeps stray dirs (crash mid-save) out of
        # list(), which rejects names not starting with a letter or digit.
        tmp = os.path.join(self.root, f".tmp.{name}")
        old = os.path.join(self.root, f".old.{name}")
        with self._lock:
            for p in (tmp, old):
                if os.path.isdir(p):
                    shutil.rmtree(p)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "params.npz"), **params)
            manifest = {
                "name": name,
                "kind": model.kind,
                "num_classes": model.num_classes,
                "hparams": model.hparams,
                "metrics": metrics or {},
                "preprocess": preprocess,
                "time_created": time.strftime("%Y-%m-%d %H:%M:%S"),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            # The swap itself: readers hold the same lock, so the brief
            # old→aside / tmp→live two-step is invisible to them.
            man_path = os.path.join(d, "manifest.json")
            prev = None
            if os.path.isdir(d):
                try:
                    pst = os.stat(man_path)
                    prev = (pst.st_mtime_ns, pst.st_size)
                except OSError:
                    pass
                os.rename(d, old)
            os.rename(tmp, d)
            if os.path.isdir(old):
                shutil.rmtree(old)
            # version() tokens on (mtime_ns, size); on filesystems with
            # coarse timestamps a fast re-save can land the same token.
            # Enforce strictly-INCREASING mtime across saves (not mere
            # inequality with the previous token — that allows an ABA
            # collision where save3 lands save1's token).
            try:
                st = os.stat(man_path)
                if prev is not None and st.st_mtime_ns <= prev[0]:
                    os.utime(man_path,
                             ns=(st.st_atime_ns, prev[0] + 1))
            except OSError:
                pass

    # -- read ----------------------------------------------------------------

    def version(self, name: str) -> Tuple[int, int]:
        """Cheap staleness token for the persisted model: the manifest
        file's (mtime_ns, size). ``save`` rewrites the manifest, so any
        re-fit under the same name changes the token. Raises
        ModelNotFound when the model is gone."""
        path = os.path.join(self._dir(name), "manifest.json")
        # Lock-free stat; a miss may be a save mid-swap, so wait the swap
        # out and re-check before concluding ModelNotFound.
        try:
            st = os.stat(path)
        except OSError:
            with self._lock:
                try:
                    st = os.stat(path)
                except OSError:
                    raise ModelNotFound(name) from None
        return (st.st_mtime_ns, st.st_size)

    def manifest(self, name: str) -> Dict[str, Any]:
        try:
            return self._read_manifest(name)
        except ModelNotFound:
            with self._lock:
                return self._read_manifest(name)

    def _read_manifest(self, name: str) -> Dict[str, Any]:
        path = os.path.join(self._dir(name), "manifest.json")
        if not os.path.exists(path):
            raise ModelNotFound(name)
        with open(path) as f:
            return json.load(f)

    def load(self, name: str) -> Tuple[Dict[str, Any], TrainedModel]:
        """Manifest + model with its params as CPU tensors (predict moves
        them to the runtime's device)."""
        with self._lock:
            man = self._read_manifest(name)
            with np.load(os.path.join(self._dir(name), "params.npz"),
                         allow_pickle=False) as npz:
                params = {k: torch.from_numpy(np.array(npz[k]))
                          for k in npz.files}
        model = TrainedModel(
            kind=man["kind"], params=params,
            predict_proba_fn=predictor_for(man["kind"], man["hparams"]),
            num_classes=man["num_classes"], hparams=man["hparams"])
        return man, model

    def list(self) -> List[Dict[str, Any]]:
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in sorted(os.listdir(self.root)):
            try:
                out.append(self.manifest(name))
            except (ModelNotFound, json.JSONDecodeError, ValueError):
                # Stray entries (temp files, invalid names) are not models.
                continue
        return out

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self._dir(name), "manifest.json"))

    def delete(self, name: str) -> None:
        d = self._dir(name)
        with self._lock:
            if not os.path.isdir(d):
                raise ModelNotFound(name)
            shutil.rmtree(d)
