"""Benchmark the HOST input pipeline end-to-end (disk -> static batch).

Answers whether the host loader (JPEG decode + Resize + Flip + Normalize
+ Pad + static collate) keeps up with the device step.
This tool generates synthetic Cityscapes-resolution JPEGs (2048x1024) +
COCO annotations on disk, builds the flagship train pipeline (with
on-device OA-Mix, so the host does exactly what it does in a real run),
and iterates ``PrefetchLoader`` measuring dataset-samples/s.

Usage::

    python tools/analysis_tools/bench_dataloader.py \
        [--num-images 64] [--batch 4] [--workers 4] [--epochs 2]

Prints one JSON line: ``{"samples_per_sec": ..., "cpus": ..., ...}``.
Reference counterpart: torch DataLoader worker processes running the
FULL OA-Mix on CPU (reference mmdet/datasets/pipelines/oa_mix.py:187 —
~0.5-2 s/sample); here OA-Mix runs on device so the host only decodes,
resizes and collates.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def make_dataset_on_disk(root: str, n: int, hw=(1024, 2048), seed: int = 0):
    """Write n synthetic JPEGs + a COCO annotation json; return paths."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    h, w = hw
    # One textured base per 8 images keeps generation fast while the
    # JPEG decode cost stays realistic (every file decodes fully).
    base = None
    for i in range(n):
        if i % 8 == 0:
            yy, xx = np.mgrid[0:h, 0:w]
            base = ((np.sin(xx / 37.0) + np.cos(yy / 23.0)) * 60 + 128)
            base = np.stack([base, np.roll(base, 17, 0),
                             np.roll(base, 31, 1)], -1)
        img = np.clip(base + rng.randint(-20, 20, (1, 1, 3)), 0,
                      255).astype(np.uint8)
        fname = f"img_{i:05d}.jpg"
        Image.fromarray(img).save(os.path.join(img_dir, fname), quality=90)
        images.append(dict(id=i, file_name=fname, width=w, height=h))
        for _ in range(rng.randint(4, 12)):
            x, y = rng.randint(0, w - 64), rng.randint(0, h - 64)
            bw, bh = rng.randint(16, 256), rng.randint(16, 200)
            annotations.append(dict(
                id=ann_id, image_id=i, category_id=int(rng.randint(1, 9)),
                bbox=[float(x), float(y), float(bw), float(bh)],
                area=float(bw * bh), iscrowd=0, segmentation=[]))
            ann_id += 1
    ann = dict(
        images=images, annotations=annotations,
        categories=[dict(id=c, name=f"c{c}") for c in range(1, 9)])
    ann_path = os.path.join(root, "ann.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return ann_path, img_dir


def flagship_host_pipeline():
    """The flagship train pipeline's HOST portion (OAMix on_device=True)."""
    img_norm_cfg = dict(mean=[123.675, 116.28, 103.53],
                        std=[58.395, 57.12, 57.375], to_rgb=True)
    return [
        dict(type="LoadImageFromFile"),
        dict(type="LoadAnnotations", with_bbox=True),
        dict(type="Resize", img_scale=[(2048, 800), (2048, 1024)],
             keep_ratio=True),
        dict(type="RandomFlip", flip_ratio=0.5),
        dict(type="OAMix", version="augmix", num_views=2, keep_orig=True,
             severity=10, on_device=True),
        dict(type="Normalize", **img_norm_cfg),
        dict(type="Pad", size_divisor=32),
        dict(type="DefaultFormatBundle"),
        dict(type="Collect",
             keys=["img", "gt_bboxes", "gt_labels"]),
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-images", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--root", default=None,
                    help="reuse an existing generated dataset dir")
    args = ap.parse_args()

    from oadg_tpu.data.builder import build_dataloader, build_dataset

    root = args.root or tempfile.mkdtemp(prefix="oadg_loaderbench_")
    ann = os.path.join(root, "ann.json")
    if not os.path.exists(ann):
        t0 = time.time()
        ann, img_dir = make_dataset_on_disk(root, args.num_images)
        print(f"generated {args.num_images} jpegs in {time.time()-t0:.1f}s "
              f"at {root}", file=sys.stderr)
    img_dir = os.path.join(root, "images")

    ds = build_dataset(dict(
        type="CocoDataset", ann_file=ann, img_prefix=img_dir,
        classes=tuple(f"c{c}" for c in range(1, 9)),
        pipeline=flagship_host_pipeline(), filter_empty_gt=False))
    loader = build_dataloader(ds, samples_per_gpu=args.batch,
                              workers_per_gpu=args.workers, dist=False,
                              shuffle=True, seed=0,
                              static_hw=(1024, 2048), max_gt=64,
                              rank=0, world_size=1)

    # warm epoch (page cache, numpy allocator)
    for _ in loader:
        pass
    t0 = time.time()
    n_samples = 0
    for _ in range(args.epochs):
        for batch in loader:
            # norm-on-device collate ships only the uint8 img_raw
            n_samples += batch.get("img", batch["img_raw"]).shape[0]
    dt = time.time() - t0
    out = {
        "metric": "host_loader_samples_per_sec",
        "value": round(n_samples / dt, 3),
        "unit": "samples/s",
        "detail": {
            "samples": n_samples, "seconds": round(dt, 2),
            "batch": args.batch, "workers": args.workers,
            "cpus": os.cpu_count(), "image_hw": [1024, 2048],
            "pipeline": "flagship host portion (OA-Mix on device)",
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
