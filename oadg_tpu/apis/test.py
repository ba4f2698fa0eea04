"""Test APIs (reference mmdet/apis/test.py:368 single_gpu_test / :541
multi_gpu_test). One jitted test step over padded batches; padded device
outputs convert to the reference's per-image per-class numpy det lists."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.bbox.transforms import bbox2result


def dets_to_results(dets, labels, valid, num_classes: int) -> List[List[np.ndarray]]:
    """(N, K, 5), (N, K), (N, K) -> per image per class (n_i, 5) arrays."""
    dets = np.asarray(dets)
    labels = np.asarray(labels)
    valid = np.asarray(valid)
    out = []
    for i in range(dets.shape[0]):
        v = valid[i]
        out.append(bbox2result(dets[i][v], labels[i][v], num_classes))
    return out


def run_test(test_fn: Callable, params, batch_stats, loader,
             num_classes: int, progress: bool = False,
             detector=None) -> List[List[np.ndarray]]:
    """Run the jitted test step over a loader; returns reference-format
    results (list over images of per-class det arrays).

    Batches carrying ``__tta__views__`` (MultiScaleFlipAug collation,
    data/builder.py StaticBatcher) dispatch to the detector's ``aug_test``
    via a jitted step cached per static flip-metadata tuple; ``detector``
    is required for that path.
    """
    results: List[List[np.ndarray]] = []
    aug_fns: Dict[Any, Callable] = {}
    for bi, batch in enumerate(loader):
        if "__tta_views__" in batch:
            if detector is None:
                raise ValueError(
                    "TTA batch (__tta_views__) needs the detector; pass "
                    "detector= (tools/test.py load_model_state does)")
            metas = tuple(batch["__tta_metas__"])
            if metas not in aug_fns:
                from ..engine.train_step import make_aug_test_step
                aug_fns[metas] = make_aug_test_step(detector, metas)
            views = tuple(
                {k: jnp.asarray(v) for k, v in view.items() if k != "metas"}
                for view in batch["__tta_views__"])
            dets, labels, valid = aug_fns[metas](params, batch_stats, views)
        else:
            arrs = {k: jnp.asarray(v) for k, v in batch.items()
                    if k != "metas"}
            dets, labels, valid = test_fn(params, batch_stats, arrs)
        results.extend(dets_to_results(dets, labels, valid, num_classes))
        if progress:
            print(f"\rtest batch {bi + 1}", end="", flush=True)
    if progress:
        print()
    return results


def single_gpu_test(model_state, data_loader, show=False, out_dir=None,
                    **kwargs):
    """Reference-signature shim: ``model_state`` is a dict with
    test_fn/params/batch_stats/num_classes (built by apis.train or tools)."""
    return run_test(model_state["test_fn"], model_state["params"],
                    model_state.get("batch_stats"), data_loader,
                    model_state["num_classes"], progress=True,
                    detector=model_state.get("detector"))


def collect_results_allgather(results, indices, dataset_len: int,
                              num_classes: int) -> List[List[np.ndarray]]:
    """Cross-process result collection — the JAX replacement for the
    reference's tmpdir pickle exchange (``collect_results_cpu``,
    mmdet/apis/test.py:589):

    1. encode this rank's detections as a flat float32 row table
       ``[ds_index, cls, score, x1, y1, x2, y2]`` plus one presence marker
       row (cls = -1) per processed image;
    2. pad to the global max row count and all-gather across processes
       (``multihost_utils.process_allgather`` — XLA collective, no shared
       filesystem needed);
    3. decode rank-major and restore dataset order; duplicate indices from
       the loader's wraparound padding keep the first (lowest-rank) copy.

    Every process returns the full ordered result list (the reference only
    materializes it on rank 0; here the gather is symmetric and free).
    """
    import jax

    rows = [np.zeros((0, 7), np.float32)]
    for res, ds_i in zip(results, indices):
        rows.append(np.asarray([[float(ds_i), -1, 0, 0, 0, 0, 0]],
                               np.float32))          # presence marker
        for c, arr in enumerate(res):
            if len(arr):
                a = np.asarray(arr, np.float32)      # (k, 5) x1y1x2y2score
                enc = np.concatenate(
                    [np.full((len(a), 1), float(ds_i), np.float32),
                     np.full((len(a), 1), float(c), np.float32),
                     a[:, 4:5], a[:, :4]], axis=1)
                rows.append(enc)
    table = np.concatenate(rows, axis=0)

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        counts = np.asarray(multihost_utils.process_allgather(
            jnp.asarray([table.shape[0]], jnp.int32))).reshape(-1)
        m = int(counts.max())
        pad = np.full((m - table.shape[0], 7), -2.0, np.float32)
        gathered = np.asarray(multihost_utils.process_allgather(
            jnp.asarray(np.concatenate([table, pad], axis=0))))
        blocks = [gathered[p] for p in range(gathered.shape[0])]
    else:
        blocks = [table]

    # Decode per rank block: an image claimed by a lower rank ignores any
    # duplicate copy a higher rank produced via wraparound padding.
    claimed: Dict[int, int] = {}
    per_img: Dict[int, List[List[float]]] = {}
    for p, blk in enumerate(blocks):
        accepting: Dict[int, bool] = {}   # markers precede their det rows
        for row in blk:
            ds_i = int(row[0])
            if row[1] == -2.0 or ds_i < 0 or ds_i >= dataset_len:
                continue                              # padding row
            if row[1] == -1.0:                        # presence marker
                if ds_i not in claimed:               # first copy wins —
                    claimed[ds_i] = p                 # across AND within
                    accepting[ds_i] = True            # ranks
                    per_img[ds_i] = [[] for _ in range(num_classes)]
                else:
                    accepting[ds_i] = False
                continue
            if accepting.get(ds_i):
                per_img[ds_i][int(row[1])].append(
                    [row[3], row[4], row[5], row[6], row[2]])
    final: List[List[np.ndarray]] = []
    for i in range(dataset_len):
        if i not in per_img:
            final.append([np.zeros((0, 5), np.float32)
                          for _ in range(num_classes)])
            continue
        final.append([np.asarray(per_img[i][c], np.float32).reshape(-1, 5)
                      for c in range(num_classes)])
    return final


def multi_gpu_test(model_state, data_loader, tmpdir=None, gpu_collect=False,
                   **kwargs):
    """Distributed evaluation (reference mmdet/apis/test.py:541): each
    process runs its rank-strided slice of the loader, then results are
    all-gathered and restored to dataset order. Single-process calls are
    equivalent to ``single_gpu_test`` plus order restoration for loaders
    whose batch list is permuted."""
    import jax

    results = run_test(model_state["test_fn"], model_state["params"],
                       model_state.get("batch_stats"), data_loader,
                       model_state["num_classes"],
                       progress=jax.process_index() == 0,
                       detector=model_state.get("detector"))
    if hasattr(data_loader, "result_indices"):
        indices = list(np.asarray(data_loader.result_indices())[:len(results)])
    else:
        indices = list(range(len(results)))
    n = (len(data_loader.dataset) if hasattr(data_loader, "dataset")
         else len(results))
    if jax.process_count() == 1 and indices == list(range(len(results))):
        return results
    return collect_results_allgather(results, indices, n,
                                     model_state["num_classes"])
