"""Feature-analysis test APIs.

Reference parity: mmdet/apis/test.py — ``single_gpu_test_feature`` (:187,
per-class feature-similarity confusion matrices accumulated over the
dataset and rendered as matrix plots), ``single_gpu_analyze_feature``
(:49, capture intermediate feature maps for one batch and dump
visualizations). The reference routes these through
``model(..., analysis=...)`` branches inside the detector; here the
shape is a dedicated jitted feature step (GT-RoI embeddings via the RoI
head's contrastive branch) plus ``capture_intermediates`` for the
layer captures — the same channels FeatureHook / WandbLogger consume.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np


def make_feature_step(detector):
    """Jitted: batch (img + GT) -> (normalized per-GT-box embeddings,
    labels, valid). Embeddings come from the RoI head's contrastive
    branch when present (reference ContrastiveHead fc_cont), else from
    mean-pooled RoI features."""

    @jax.jit
    def step(params, batch_stats, batch):
        variables = {"params": params}
        if batch_stats is not None:
            variables["batch_stats"] = batch_stats

        def run(mdl, b):
            feats = mdl.extract_feat(b["img"])
            n, g = b["gt_bboxes"].shape[:2]
            bidx = jnp.repeat(jnp.arange(n, dtype=jnp.float32),
                              g).reshape(n, g)
            rois = jnp.concatenate([bidx[..., None], b["gt_bboxes"]],
                                   axis=-1).reshape(-1, 5)
            rf = mdl.roi.extract(feats, rois)
            if getattr(mdl.roi, "shared_head_m", None) is not None:
                rf = mdl.roi.shared_head_m(rf)
            outs = mdl.roi.head(rf)
            cont = outs[2] if len(outs) > 2 else None
            emb = (cont if cont is not None
                   else rf.mean(axis=(1, 2))).astype(jnp.float32)
            emb = emb / (jnp.linalg.norm(emb, axis=-1, keepdims=True)
                         + 1e-8)
            # degenerate (zero-area) boxes are invalid too
            wh_ok = ((b["gt_bboxes"][..., 2] > b["gt_bboxes"][..., 0])
                     & (b["gt_bboxes"][..., 3] > b["gt_bboxes"][..., 1]))
            return (emb, b["gt_labels"].reshape(-1),
                    (b["gt_valid"] & wh_ok).reshape(-1))

        return detector.apply(variables, batch, method=run,
                              rngs={"sampling": jax.random.PRNGKey(0)})

    return step


def _accumulate_pair_matrix(sum_mat, cnt_mat, emb_a, lab_a, val_a,
                            emb_b=None, lab_b=None, val_b=None):
    """Add per-class-pair cosine-similarity sums/counts. Same-set mode
    excludes self-pairs (reference supcontrast-style masks)."""
    same = emb_b is None
    if same:
        emb_b, lab_b, val_b = emb_a, lab_a, val_a
    k = sum_mat.shape[0]
    sims = emb_a @ emb_b.T                                  # (Ra, Rb)
    oh_a = np.eye(k, dtype=np.float32)[np.clip(lab_a, 0, k - 1)] \
        * val_a[:, None]
    oh_b = np.eye(k, dtype=np.float32)[np.clip(lab_b, 0, k - 1)] \
        * val_b[:, None]
    pair_w = np.outer(val_a, val_b)
    if same:
        np.fill_diagonal(pair_w, 0.0)
    sum_mat += oh_a.T @ (sims * pair_w) @ oh_b
    cnt_mat += oh_a.T @ pair_w @ oh_b
    return sum_mat, cnt_mat


def single_gpu_test_feature(model_state, data_loader, orig_loader=None,
                            show_dir: Optional[str] = None,
                            max_batches: Optional[int] = None
                            ) -> Dict[str, np.ndarray]:
    """Accumulate per-class GT-feature similarity confusion matrices over
    a loader (reference apis/test.py:187). Batches must carry GT
    (gt_bboxes/gt_labels/gt_valid — a train-mode pipeline without OAMix).

    With ``orig_loader`` (a second domain's loader, reference
    multi-domain mode) a cross-domain ``clean_aug`` matrix is also
    accumulated. Returns the ``features_sum`` dict: normalized confusion
    matrices + pair-count matrices; matrices are also saved as .npy (and
    .png heatmaps) under ``show_dir`` when given.
    """
    detector = model_state["detector"]
    params = model_state["params"]
    batch_stats = model_state.get("batch_stats")
    k = int(model_state["num_classes"])
    step = make_feature_step(detector)

    sum_cc = np.zeros((k, k), np.float64)
    cnt_cc = np.zeros((k, k), np.float64)
    sum_ca = np.zeros((k, k), np.float64)
    cnt_ca = np.zeros((k, k), np.float64)
    orig_iter = iter(orig_loader) if orig_loader is not None else None

    for bi, batch in enumerate(data_loader):
        if max_batches is not None and bi >= max_batches:
            break
        if "gt_bboxes" not in batch:
            raise ValueError(
                "single_gpu_test_feature needs GT in the batch "
                "(gt_bboxes/gt_labels/gt_valid): build the loader from a "
                "train-mode pipeline")
        arrs = {kk: jnp.asarray(v) for kk, v in batch.items()
                if kk != "metas"}
        emb, lab, val = (np.asarray(x) for x in
                         step(params, batch_stats, arrs))
        sum_cc, cnt_cc = _accumulate_pair_matrix(sum_cc, cnt_cc,
                                                 emb, lab, val)
        if orig_iter is not None:
            ob = next(orig_iter)
            oarrs = {kk: jnp.asarray(v) for kk, v in ob.items()
                     if kk != "metas"}
            oemb, olab, oval = (np.asarray(x) for x in
                                step(params, batch_stats, oarrs))
            sum_ca, cnt_ca = _accumulate_pair_matrix(
                sum_ca, cnt_ca, emb, lab, val, oemb, olab, oval)

    features_sum: Dict[str, np.ndarray] = {
        "clean_clean_confusion_matrix":
            (sum_cc / (cnt_cc + 1e-6)).astype(np.float32),
        "clean_clean_matrix_sample_number": cnt_cc.astype(np.float32),
    }
    if orig_loader is not None:
        features_sum["clean_aug_confusion_matrix"] = \
            (sum_ca / (cnt_ca + 1e-6)).astype(np.float32)
        features_sum["clean_aug_matrix_sample_number"] = \
            cnt_ca.astype(np.float32)
    if show_dir:
        os.makedirs(show_dir, exist_ok=True)
        for name, mat in features_sum.items():
            np.save(os.path.join(show_dir, name + ".npy"), mat)
            if "confusion_matrix" in name:
                _save_matrix_png(mat,
                                 os.path.join(show_dir, name + ".png"))
    return features_sum


def _save_matrix_png(mat: np.ndarray, path: str, scale: int = 24):
    """Heatmap PNG via cv2 (no matplotlib dependency)."""
    import cv2
    lo, hi = float(np.min(mat)), float(np.max(mat))
    norm = (mat - lo) / (hi - lo + 1e-9)
    img = (norm * 255).astype(np.uint8)
    img = cv2.resize(img, (mat.shape[1] * scale, mat.shape[0] * scale),
                     interpolation=cv2.INTER_NEAREST)
    cv2.imwrite(path, cv2.applyColorMap(img, cv2.COLORMAP_VIRIDIS))


def single_gpu_analyze_feature(model_state, data_loader,
                               layer_list=("backbone", "neck"),
                               show_dir: Optional[str] = None
                               ) -> Dict[str, Any]:
    """Capture intermediate feature maps for ONE batch (reference
    apis/test.py:49 runs a single batch with analysis='feature') via
    capture_intermediates and optionally dump channel-mean heatmaps.

    Returns {layer_path: np.ndarray} of captured activations — the same
    channel FeatureHook/WandbLogger feed from training.
    """
    detector = model_state["detector"]
    variables = {"params": model_state["params"]}
    if model_state.get("batch_stats") is not None:
        variables["batch_stats"] = model_state["batch_stats"]
    batch = next(iter(data_loader))
    arrs = {kk: jnp.asarray(v) for kk, v in batch.items() if kk != "metas"}

    _, state = detector.apply(
        variables, arrs, "test",
        rngs={"sampling": jax.random.PRNGKey(0)},
        capture_intermediates=lambda mdl, name: any(
            key in f"{mdl.name}" for key in layer_list),
        mutable=["intermediates"])

    flat: Dict[str, Any] = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for kk, v in tree.items():
                walk(v, f"{prefix}/{kk}" if prefix else str(kk))
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}.{i}")
        else:
            flat[prefix] = np.asarray(tree)

    walk(state.get("intermediates", {}), "")
    if show_dir:
        import cv2
        os.makedirs(show_dir, exist_ok=True)
        for name, arr in flat.items():
            if arr.ndim != 4:            # (N, H, W, C) maps only
                continue
            fmap = np.mean(np.abs(arr[0].astype(np.float32)), axis=-1)
            fname = name.replace("/", "_").replace("__call__", "out")
            _save_matrix_png(fmap, os.path.join(show_dir, fname + ".png"),
                             scale=1)
    return flat
