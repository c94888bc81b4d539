"""Classification/retrieval metrics in jnp.

Reference semantics reproduced:
  - per-class precision/recall/F1 from TP/FP/FN with divide-by-zero guards
    (CLIP/lab1.py:107-124 uses guards; code/search_image.py:48-54 does NOT
    and can emit NaN — we standardize on the guarded semantics and document
    the difference, per SURVEY.md §4).
  - top-k accuracy with an optional excluded class
    (reference `cls_acc`, code/utils.py:15-39).
  - vectorized macro-F1 via a bincount confusion matrix
    (reference `cls_f1`, code/utils.py:41-76).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import jax.numpy as jnp
import numpy as np


@dataclass
class PRF1:
    precision: float
    recall: float
    f1: float
    tp: int
    fp: int
    fn: int

    def as_dict(self) -> Dict[str, float]:
        return {
            "precision": self.precision,
            "recall": self.recall,
            "f1": self.f1,
            "tp": self.tp,
            "fp": self.fp,
            "fn": self.fn,
        }


def prf1_from_counts(tp: int, fp: int, fn: int) -> PRF1:
    """Guarded precision/recall/F1 (CLIP/lab1.py:114-117 semantics)."""
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if (precision + recall) > 0
        else 0.0
    )
    return PRF1(precision, recall, f1, int(tp), int(fp), int(fn))


def binary_prf1(preds: jnp.ndarray, labels: jnp.ndarray) -> PRF1:
    """P/R/F1 for binary predictions; positive == 1.

    Matches the reference `eval` (code/union_clip_llava2.py:274-291) which
    computes P/R/F1 from binary prediction/label lists.
    """
    preds = jnp.asarray(preds).astype(jnp.bool_)
    labels = jnp.asarray(labels).astype(jnp.bool_)
    tp = int(jnp.sum(preds & labels))
    fp = int(jnp.sum(preds & ~labels))
    fn = int(jnp.sum(~preds & labels))
    return prf1_from_counts(tp, fp, fn)


def topk_accuracy(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    topk: int = 1,
    exclude_class: Optional[int] = None,
) -> float:
    """Top-k accuracy, optionally masking out samples of one class.

    Reference: `cls_acc` (code/utils.py:15-39) — samples whose true label is
    `exclude_class` are dropped from both numerator and denominator.
    """
    logits = jnp.asarray(logits)
    labels = jnp.asarray(labels)
    k = min(topk, logits.shape[-1])
    top = jnp.argsort(-logits, axis=-1)[:, :k]
    correct = jnp.any(top == labels[:, None], axis=-1)
    if exclude_class is not None:
        keep = labels != exclude_class
        denom = jnp.sum(keep)
        return float(jnp.where(denom > 0, jnp.sum(correct & keep) / jnp.maximum(denom, 1), 0.0))
    return float(jnp.mean(correct))


def confusion_matrix(
    preds: jnp.ndarray, labels: jnp.ndarray, num_classes: int
) -> jnp.ndarray:
    """[C, C] confusion matrix (rows = true, cols = predicted) via bincount,
    mirroring the reference's vectorized construction (code/utils.py:41-76)."""
    preds = jnp.asarray(preds).astype(jnp.int32)
    labels = jnp.asarray(labels).astype(jnp.int32)
    idx = labels * num_classes + preds
    counts = jnp.bincount(idx, length=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes)


def macro_f1(
    preds: jnp.ndarray,
    labels: jnp.ndarray,
    num_classes: int,
    exclude_class: Optional[int] = None,
) -> float:
    """Macro-averaged F1 over classes (reference `cls_f1`, code/utils.py:41-76).

    Computed host-side in numpy: the inputs are tiny and this gets called
    eagerly in training loops, where per-op device dispatch would
    dominate."""
    preds_a = np.asarray(preds).astype(np.int64)
    labels_a = np.asarray(labels).astype(np.int64)
    cm = np.bincount(labels_a * num_classes + preds_a,
                     minlength=num_classes * num_classes
                     ).reshape(num_classes, num_classes).astype(np.float64)
    tp = np.diag(cm)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        recall = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall
                      / np.maximum(precision + recall, 1e-12), 0.0)
    if exclude_class is not None:
        mask = np.arange(num_classes) != exclude_class
        return float(np.sum(f1 * mask) / max(int(np.sum(mask)), 1))
    return float(np.mean(f1))


def per_class_report(
    preds: Sequence[int],
    labels: Sequence[int],
    class_names: Sequence[str],
) -> Dict[str, PRF1]:
    """Per-class one-vs-rest P/R/F1 table (CLIP/lab1.py:107-140 output shape)."""
    preds_a = np.asarray(preds)
    labels_a = np.asarray(labels)
    out: Dict[str, PRF1] = {}
    for idx, name in enumerate(class_names):
        tp = int(np.sum((preds_a == idx) & (labels_a == idx)))
        fp = int(np.sum((preds_a == idx) & (labels_a != idx)))
        fn = int(np.sum((preds_a != idx) & (labels_a == idx)))
        out[name] = prf1_from_counts(tp, fp, fn)
    return out
