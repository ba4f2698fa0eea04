"""Dataset/dataloader builders (reference mmdet/datasets/builder.py:58,86).

Loader design: instead of torch DataLoader + DataContainer
collate + per-rank DistributedGroupSampler, a thread-pool prefetcher
assembles STATIC-SHAPE numpy batches (images padded to a fixed bucket, GT
padded to ``max_gt`` with validity masks) that jit directly. Aspect-ratio
group batching (reference datasets/samplers/group_sampler.py:10) is
preserved via the dataset ``flag`` array.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ..utils.registry import DATASETS, build_from_cfg


def build_dataset(cfg, default_args=None):
    return build_from_cfg(dict(cfg), DATASETS, default_args)


def _pad_to(img: np.ndarray, h: int, w: int) -> np.ndarray:
    out = np.zeros((h, w) + img.shape[2:], img.dtype)
    out[: img.shape[0], : img.shape[1]] = img
    return out


class StaticBatcher:
    """Collate pipeline outputs into a static-shape batch dict."""

    def __init__(self, static_hw, max_gt: int = 128, divisor: int = 32):
        self.static_hw = static_hw
        self.max_gt = max_gt
        self.divisor = divisor

    def __call__(self, samples: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        if samples and samples[0].get("__tta__"):
            # MultiScaleFlipAug output: each key holds one entry per
            # (scale, flip) view. Collate each view into its own batch
            # (shapes differ per scale) + static flip metadata for the
            # jitted aug_test step (apis/test.py TTA dispatch).
            nv = len(samples[0]["img"])
            views, metas = [], []
            for vi in range(nv):
                sub = [{k: (s[k][vi] if isinstance(s[k], list) else s[k])
                        for k in s if k != "__tta__"} for s in samples]
                views.append(self(sub))
                m0 = samples[0]["img_metas"][vi]
                metas.append((bool(m0.get("flip", False)),
                              str(m0.get("flip_direction", "horizontal"))))
            return {"__tta_views__": views,
                    "__tta_metas__": tuple(metas),
                    "metas": [s["img_metas"][0] for s in samples]}
        b = len(samples)
        if self.static_hw is not None:
            h, w = self.static_hw
        else:
            h = max(s["img"].shape[0] for s in samples)
            w = max(s["img"].shape[1] for s in samples)
            d = self.divisor
            h = ((h + d - 1) // d) * d
            w = ((w + d - 1) // d) * d
        g = self.max_gt
        # Normalize-on-device path (OAMix on_device: Normalize skipped,
        # img is still raw uint8 and aliases img_raw): ship ONLY the
        # uint8 img_raw — the device preprocess derives the normalized
        # clean view on-chip. 4x less collate memcpy + host->device
        # transfer than the f32 "img" stack, and no duplicate pixels.
        norm_on_device = bool(samples[0].get("norm_on_device")) and \
            "img_raw" in samples[0]
        batch = {
            "img_shape": np.asarray(
                [s["img_metas"]["img_shape"][:2] for s in samples], np.float32),
            "scale_factor": np.stack([
                np.asarray(s["img_metas"].get("scale_factor",
                                              [1, 1, 1, 1]),
                           np.float32).reshape(-1)[:4] for s in samples]),
        }
        if not norm_on_device:
            batch["img"] = np.stack([
                _pad_to(s["img"].astype(np.float32), h, w) for s in samples])
        if "img_raw" in samples[0]:
            batch["img_raw"] = np.stack([
                _pad_to(s["img_raw"], h, w) if norm_on_device
                else _pad_to(s["img_raw"].astype(np.float32), h, w)
                for s in samples])
        if "gt_bboxes" in samples[0]:
            gt = np.zeros((b, g, 4), np.float32)
            lbl = np.zeros((b, g), np.int32)
            valid = np.zeros((b, g), bool)
            for i, s in enumerate(samples):
                n = min(len(s["gt_bboxes"]), g)
                gt[i, :n] = s["gt_bboxes"][:n]
                lbl[i, :n] = s["gt_labels"][:n]
                valid[i, :n] = True
            batch["gt_bboxes"] = gt
            batch["gt_labels"] = lbl
            batch["gt_valid"] = valid
            if "gt_masks" in samples[0]:
                m0 = samples[0]["gt_masks"].shape[-1] if \
                    samples[0]["gt_masks"].size else 56
                gm = np.zeros((b, g, m0, m0), np.float32)
                for i, s in enumerate(samples):
                    n = min(len(s["gt_masks"]), g)
                    if n:
                        gm[i, :n] = s["gt_masks"][:n]
                batch["gt_masks"] = gm
        batch["metas"] = [s["img_metas"] for s in samples]
        return batch


class PrefetchLoader:
    """Thread-pool prefetching iterator over grouped static batches."""

    def __init__(self, dataset, samples_per_gpu: int, num_workers: int = 2,
                 shuffle: bool = True, seed: Optional[int] = None,
                 static_hw=None, max_gt: int = 128, drop_last: bool = True,
                 prefetch: int = 4, rank: int = 0, world_size: int = 1):
        self.dataset = dataset
        self.bs = samples_per_gpu
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.batcher = StaticBatcher(static_hw, max_gt=max_gt)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rank = rank
        self.world_size = max(1, world_size)

    def __len__(self):
        n = len(self.dataset)
        per = n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs
        if self.world_size > 1:
            per = (per + self.world_size - 1) // self.world_size
        return per

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        flag = getattr(self.dataset, "flag", np.zeros(n, np.uint8))
        batches = []
        for group in np.unique(flag):
            idxs = np.where(flag == group)[0]
            if self.shuffle:
                self.rng.shuffle(idxs)
            # round up to full batches within the group (GroupSampler style)
            pad = (-len(idxs)) % self.bs
            if pad and not self.drop_last:
                idxs = np.concatenate([idxs, idxs[:pad]])
            full = len(idxs) // self.bs * self.bs
            batches.extend(np.split(idxs[:full], max(full // self.bs, 1))
                           if full else [])
        if self.shuffle:
            order = self.rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        if self.world_size > 1:
            # Per-process slice (reference DistributedGroupSampler
            # semantics): all ranks build the SAME global batch list from
            # the shared seed, then take a rank-strided slice padded so
            # every rank steps the same number of times.
            pad = (-len(batches)) % self.world_size
            batches = batches + batches[:pad]
            batches = batches[self.rank::self.world_size]
        return batches

    def result_indices(self) -> np.ndarray:
        """Dataset indices this rank's batches cover, in iteration order —
        the key for cross-process result collection (apis/test.py
        collect_results_allgather). RNG state is restored so calling this
        does not perturb the epoch's shuffle."""
        state = self.rng.get_state()
        batches = self._batch_indices()
        self.rng.set_state(state)
        if not batches:
            return np.zeros(0, np.int64)
        return np.concatenate([np.asarray(b, np.int64) for b in batches])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batch_indices()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        it_lock = threading.Lock()
        it = iter(enumerate(batches))

        def worker():
            while not stop.is_set():
                with it_lock:
                    try:
                        bi, idxs = next(it)
                    except StopIteration:
                        break
                samples = [self.dataset[int(i)] for i in idxs]
                q.put((bi, self.batcher(samples)))
            q.put(None)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        # Yield strictly in batch order: workers finish out of order, so
        # buffer early arrivals (evaluation aligns results to dataset
        # indices by position — completion order would permute them).
        done = 0
        buf: Dict[int, Dict[str, np.ndarray]] = {}
        next_bi = 0
        try:
            while done < len(threads) or buf:
                if next_bi in buf:
                    yield buf.pop(next_bi)
                    next_bi += 1
                    continue
                if done >= len(threads):
                    break       # remaining gaps impossible; defensive
                item = q.get()
                if item is None:
                    done += 1
                    continue
                bi, b = item
                buf[bi] = b
        finally:
            stop.set()
            for t in threads:
                while t.is_alive():
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
                t.join(timeout=0.1)


def build_dataloader(dataset, samples_per_gpu: int, workers_per_gpu: int = 2,
                     num_gpus: int = 1, dist: bool = False,
                     shuffle: bool = True, seed: Optional[int] = None,
                     static_hw=None, max_gt: int = 128,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None, **kwargs):
    """Reference signature-compatible builder returning a PrefetchLoader.

    rank/world_size default to the jax process topology so each host of a
    multi-host mesh loads only its slice (reference builder.py:158-164
    DistributedGroupSampler)."""
    if rank is None or world_size is None:
        try:
            import jax
            rank = jax.process_index() if rank is None else rank
            world_size = (jax.process_count() if world_size is None
                          else world_size)
        except Exception:
            rank, world_size = 0, 1
    return PrefetchLoader(dataset, samples_per_gpu,
                          num_workers=workers_per_gpu, shuffle=shuffle,
                          seed=seed, static_hw=static_hw, max_gt=max_gt,
                          drop_last=shuffle, rank=rank,
                          world_size=world_size)
