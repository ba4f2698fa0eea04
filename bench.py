"""Benchmark: OA-DG Faster R-CNN R50-FPN train-step throughput on one chip.

Runs the flagship config's FULL training step (multi-view forward, RPN +
RoI + contrastive losses, backward, SGD update) at the Cityscapes training
resolution (1024x2048) with batch 4 x 2 views (BENCH_BATCH overrides),
bf16 compute, on whatever chip jax exposes, and prints ONE JSON line.

Baseline note: the reference publishes no throughput numbers
(BASELINE.md: "published: {}"). ``vs_baseline`` is measured against an
estimated reference rate of 2.0 dataset-samples/sec — a generous estimate
for mmdet Faster R-CNN R50-FPN at 2048x1024, batch 2/GPU on a V100-class
GPU where the OA-Mix CPU pipeline (reference oa_mix.py, ~0.5-2 s/sample in
dataloader workers) does not bottleneck. The north-star target is 5x that.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

from oadg_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax.numpy as jnp
import numpy as np

BASELINE_SAMPLES_PER_SEC = 2.0     # estimated reference throughput (see above)


def main():
    from __graft_entry__ import _flagship_model_cfg, _train_batch
    from oadg_tpu.engine.optim import build_lr_schedule, build_optimizer
    from oadg_tpu.engine.preprocess import make_oadg_preprocess
    from oadg_tpu.engine.train_step import make_train_step
    from oadg_tpu.models import build_detector

    cfg, model = _flagship_model_cfg(tiny=False)
    num_views = int(cfg.get("num_views", 2))

    # Default per-device batch 4 (clean samples; x2 views = 8 images/step).
    b = int(os.environ.get("BENCH_BATCH", "4"))          # clean samples/step
    h = int(os.environ.get("BENCH_H", "1024"))
    w = int(os.environ.get("BENCH_W", "2048"))
    steps = int(os.environ.get("BENCH_STEPS", "10"))

    det = build_detector(model, num_views=num_views, dtype=jnp.bfloat16)
    # loader-format batch: B clean samples; OA-Mix + view integration run
    # on-device inside the step (engine/preprocess.py). The batch is
    # generated on the device, so the default measures the device step.
    #
    # BENCH_REAL_LOADER=1: end-to-end mode instead — synthetic JPEGs on
    # disk, the REAL PrefetchLoader (decode + Resize + Flip + uint8
    # collate) feeds every step its own batch, and the sustained rate
    # includes host pipeline + host->device transfer.
    real_loader = os.environ.get("BENCH_REAL_LOADER") == "1"
    loader = None
    if real_loader:
        import tempfile
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "analysis_tools"))
        from bench_dataloader import (flagship_host_pipeline,
                                      make_dataset_on_disk)
        from oadg_tpu.data.builder import build_dataloader, build_dataset
        root = os.environ.get("BENCH_LOADER_ROOT") or tempfile.mkdtemp(
            prefix="oadg_benchloader_")
        ann = os.path.join(root, "ann.json")
        if not os.path.exists(ann):
            ann, _ = make_dataset_on_disk(root, max(4 * b, 16), hw=(h, w))
        pipe = flagship_host_pipeline()
        for p in pipe:          # match the bench resolution (flagship
            if p["type"] == "Resize":   # default is 2048x800..1024)
                p["img_scale"] = [(w, int(h * 800 / 1024)), (w, h)]
        ds = build_dataset(dict(
            type="CocoDataset", ann_file=ann,
            img_prefix=os.path.join(root, "images"),
            classes=tuple(f"c{c}" for c in range(1, 9)),
            pipeline=pipe, filter_empty_gt=False))
        loader = build_dataloader(
            ds, samples_per_gpu=b, workers_per_gpu=4, dist=False,
            shuffle=True, seed=0, static_hw=(h, w), max_gt=16,
            rank=0, world_size=1)
        loader_it = iter(loader)

        def next_batch():
            nonlocal loader_it
            try:
                nb = next(loader_it)
            except StopIteration:
                loader_it = iter(loader)
                nb = next(loader_it)
            return {k: jnp.asarray(v) for k, v in nb.items()
                    if k != "metas"}

        batch = next_batch()
    else:
        from __graft_entry__ import _train_batch_device
        batch = _train_batch_device(b, h, w, g=16, raw=True)
    preprocess = make_oadg_preprocess(dict(cfg.oamix_config),
                                      dict(cfg.img_norm_cfg),
                                      out_dtype=jnp.bfloat16)

    # init at a tiny spatial size — params are shape-independent, so the big
    # compile happens once, for the real step only
    init_batch = _train_batch(num_views, 64, 64, g=4)
    variables = jax.jit(lambda rngs, bb: det.init(rngs, bb, "train"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        init_batch)
    params = variables["params"]
    batch_stats = variables.get("batch_stats")

    sched = build_lr_schedule(cfg.get("lr_config"), cfg.optimizer["lr"], 1000)
    tx = build_optimizer(params, cfg.optimizer, sched, model_cfg=model)
    opt_state = tx.init(params)

    # donate=True matches real training (the runner reassigns params/
    # opt_state every step) and saves a second copy of both in memory.
    donate = os.environ.get("BENCH_DONATE", "1") == "1"
    step = make_train_step(det, tx, mesh=None, donate=donate,
                           preprocess=preprocess)
    print("bench: params initialized, compiling step...", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    params, batch_stats, opt_state, log_vars = step(params, batch_stats, opt_state, batch,
                                       jax.random.PRNGKey(2))
    _ = float(log_vars["loss"])
    compile_s = time.perf_counter() - t0
    print(f"bench: compiled in {compile_s:.1f}s", file=sys.stderr, flush=True)

    # Chained-dispatch timing: dispatch all steps back-to-back (each step's
    # params feed the next, so the device executes them sequentially) and
    # sync ONCE at the end by fetching the final loss scalar. Real training
    # overlaps dispatch with device execution and fetches logs every ~50
    # iters.
    t0 = time.perf_counter()
    for i in range(steps):
        if real_loader:
            batch = next_batch()       # fresh host batch every step
        params, batch_stats, opt_state, log_vars = step(params, batch_stats, opt_state,
                                           batch, jax.random.PRNGKey(3 + i))
    _ = float(log_vars["loss"])
    step_s = (time.perf_counter() - t0) / steps
    samples_per_sec = b / step_s
    print(json.dumps({
        "metric": "oadg_frcnn_r50_cityscapes_train_samples_per_sec_per_chip_oamix_on_device",
        "value": round(samples_per_sec, 3),
        "unit": "samples/s",
        "vs_baseline": round(samples_per_sec / BASELINE_SAMPLES_PER_SEC, 3),
        "detail": {
            "step_seconds_median": round(step_s, 4),
            "compile_seconds": round(compile_s, 1),
            "batch_clean": b, "num_views": num_views,
            "image_hw": [h, w], "dtype": "bfloat16",
            "mode": ("real_loader (disk->PrefetchLoader->device, fresh "
                     "batch every step)" if real_loader
                     else "device-resident synthetic batch"),
            "loss": float(log_vars["loss"]),
            "device": str(jax.devices()[0]),
            "baseline_note": "reference publishes no throughput; baseline is "
                             "an estimated 2.0 samples/s (see bench.py docstring)",
        },
    }))


if __name__ == "__main__":
    main()
