"""Evaluation metrics.

The reference evaluates each fitted model with two Spark
``MulticlassClassificationEvaluator`` jobs — metricName "f1" (weighted by
class support) and "accuracy" (reference model_builder.py:206-225). Both are
reproduced here from a single confusion matrix built with one scatter-add.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def confusion_matrix(y_true: torch.Tensor, y_pred: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    idx = (y_true.long() * num_classes + y_pred.long())
    flat = torch.zeros(num_classes * num_classes, dtype=torch.float32,
                       device=idx.device)
    flat.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    return flat.reshape(num_classes, num_classes)


def classification_metrics(y_true: np.ndarray, y_pred: np.ndarray,
                           num_classes: int) -> Dict[str, float]:
    """accuracy + support-weighted F1 (pyspark's default "f1")."""
    cm = confusion_matrix(
        torch.as_tensor(np.asarray(y_true, np.int64)),
        torch.as_tensor(np.asarray(y_pred, np.int64)),
        num_classes).numpy()
    support = cm.sum(axis=1)
    tp = np.diag(cm)
    pred_pos = cm.sum(axis=0)
    precision = np.where(pred_pos > 0, tp / np.maximum(pred_pos, 1), 0.0)
    recall = np.where(support > 0, tp / np.maximum(support, 1), 0.0)
    denom = precision + recall
    f1 = np.where(denom > 0, 2 * precision * recall / np.maximum(denom, 1e-12),
                  0.0)
    total = support.sum()
    weighted_f1 = float((f1 * support).sum() / max(total, 1))
    accuracy = float(tp.sum() / max(total, 1))
    return {"f1": weighted_f1, "accuracy": accuracy}
