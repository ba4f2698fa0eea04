"""Smoke test of OA-DG on NVIDIA GPUs.

    python chip_smoke.py                   # one card
    python chip_smoke.py --data-parallel   # four cards

On one card it runs three phases:

1. the OA-Mix image ops (photometric, histogram, warps, fg maps) and
   RoIAlign, at flagship widths, against their plain references (the same
   functions on the host CPU backend of this process, or JAX autodiff),
   each with its tolerance and the reason for it;
2. the flagship OA-DG training step (Faster R-CNN R50-FPN, on-device
   OA-Mix, 1024x2048, 4 clean images x 2 views, bf16) built through
   ``build_detector`` -> ``make_oadg_preprocess`` -> ``make_train_step``:
   compile time, ``memory_analysis()``, three steps with finite losses,
   peak device memory;
3. the test path (``make_test_step`` on 2 images at 1024x2048 through
   proposal NMS and ``multiclass_nms``).

``--data-parallel`` runs only the flagship step over a 4-card data mesh and
compares its loss and parameter update with the same global batch stepped
on one card.

It refuses to run without a GPU (no CPU fallback), lets every failure
propagate (non-zero exit), and prints as its last line one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

H, W = 1024, 2048           # Cityscapes training resolution
BATCH = 4                   # clean images per step (x2 views)
N_ROIS = 512                # RoIAlign check: rois per image
N_DP = 4                    # cards in the data-parallel phase


def log(msg):
    print(msg, flush=True)


def card_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    lines = [l.strip() for l in out.splitlines() if l.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi named no card")
    return lines[0]


def expect(name, ok, detail, tolerance):
    log(f"  [{'ok' if ok else 'FAIL'}] {name}: {detail}  "
        f"(tolerance: {tolerance})")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


# ------------------------------------------------------- phase 1: ops ----

def _run(dev, fn, *args):
    """``fn`` jitted on ``dev`` with ``args`` placed there, as numpy."""
    import jax
    args = [jax.device_put(np.asarray(a), dev) for a in args]
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


def _ref(fn, *args):
    """The plain reference: ``fn`` on the host CPU backend at full f32
    precision."""
    import jax
    with jax.default_matmul_precision("highest"):
        return _run(jax.devices("cpu")[0], fn, *args)


def _random_rois(rng, n_img, per_img, h, w):
    """Boxes at every FPN level, including extreme aspects and boxes
    wider than 32 cells of their level."""
    n = n_img * per_img
    side = np.exp(rng.uniform(np.log(8), np.log(min(h, w)), n))
    aspect = np.exp(rng.uniform(np.log(1 / 8), np.log(8), n))
    bw = np.minimum(side * np.sqrt(aspect), w)
    bh = np.minimum(side / np.sqrt(aspect), h)
    x1 = rng.uniform(-4, w - bw + 4)
    y1 = rng.uniform(-4, h - bh + 4)
    bidx = np.repeat(np.arange(n_img), per_img)
    return np.stack([bidx, x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)


def check_ops(h=H, w=W, n_img=2 * BATCH, per_img=N_ROIS, channels=256,
              seed=0):
    import jax
    import jax.numpy as jnp
    from oadg_tpu.ops import oamix_device as od
    from oadg_tpu.ops import photometric as ph
    from oadg_tpu.ops.roi_align import (_roi_align_multilevel_impl,
                                        roi_align_multilevel)
    from oadg_tpu.ops.row_warp import shear_rows, warp_rotate

    gpu = jax.devices()[0]
    rng = np.random.RandomState(seed)
    log(f"phase 1: translated ops vs plain references at {h}x{w}")

    # photometric ops + histogram on integer-valued pixels: the same
    # integers as the CPU backend, which the CPU tests pin to Pillow
    img = rng.randint(3, 251, (h, w, 3)).astype(np.float32)
    photo = {
        "histogram": ph.image_hist256,
        "equalize": ph.equalize,
        "autocontrast": ph.autocontrast,
        "posterize": lambda x: ph.posterize(x, 3),
        "solarize": lambda x: ph.solarize(x, 128),
        "sharpness": lambda x: ph.enhance_sharpness(x, 1.6),
        "color": lambda x: ph.enhance_color(x, 1.6),
        "contrast": lambda x: ph.enhance_contrast(x, 1.3),
        "brightness": lambda x: ph.enhance_brightness(x, 0.7),
    }
    for name, fn in photo.items():
        got, want = _run(gpu, fn, img), _ref(fn, img)
        expect(name, np.array_equal(got, want),
               f"{int(np.sum(got != want))} of {want.size} values differ",
               "bit-equal: Pillow's integer and rounding semantics on both "
               "backends")

    # warps: one intensity level (1/255 of full scale) on every pixel; an
    # FMA contraction can move a value across the .5 of a later rounding
    one_level = "1/255 of full scale: FMA contraction may flip a rounding"
    img4 = rng.randint(0, 256, (h, w, 4)).astype(np.float32)
    shifts = rng.randint(-200, 200, (h,)).astype(np.int32)
    fracs = rng.rand(h).astype(np.float32)
    got = _run(gpu, lambda x, s, f: shear_rows(x, s, f, 256), img4, shifts,
               fracs)
    want = _ref(lambda x, s, f: shear_rows(x, s, f, 256), img4, shifts,
                fracs)
    err = float(np.max(np.abs(got - want)))
    expect("shear_rows", err <= 1.0, f"max |diff| {err:.3g}", one_level)

    def bg_rotate(x):
        return warp_rotate(x.astype(jnp.bfloat16), jnp.deg2rad(-21.0),
                           w / 2.0, h / 2.0, int(0.27 * h / 2) + 4,
                           int(0.50 * w / 2) + 4)
    got, want = _run(gpu, bg_rotate, img4), _ref(bg_rotate, img4)
    err = float(np.max(np.abs(got - want)))
    expect("bg rotate (3 row-shift passes)", err <= 1.0,
           f"max |diff| {err:.3g}", one_level)

    # foreground mask maps from the same 1-D profiles on both sides
    boxes = np.zeros((od.MAX_FG, 4), np.float32)
    valid = np.zeros((od.MAX_FG,), bool)
    for i in range(12):
        x1, y1 = rng.uniform(0, w * 0.8), rng.uniform(0, h * 0.8)
        boxes[i] = [x1, y1, x1 + rng.uniform(16, w * 0.2),
                    y1 + rng.uniform(16, h * 0.2)]
        valid[i] = True
    fx, fy = _ref(lambda b, v: od.fg_profiles(b, v, h, w, 0.3), boxes,
                  valid)
    got = _run(gpu, od.fg_maps, fx, fy)
    want = _ref(od.fg_maps, fx, fy)
    expect("fg_maps best_id", np.array_equal(got[0], want[0]),
           f"{int(np.sum(got[0] != want[0]))} pixels differ", "equal")
    for i, name in ((1, "cover"), (2, "union")):
        err = float(np.max(np.abs(got[i].astype(np.float32)
                                  - want[i].astype(np.float32))))
        expect(f"fg_maps {name}", err <= 2.0 ** -8, f"max |diff| {err:.3g}",
               "one bf16 rounding (2^-8) of values in [0, 1]")

    # bbox-only geometric op: the per-pixel affine gather + blend
    mats = _ref(lambda b, v: od._op_matrices(
        jax.random.PRNGKey(seed), 0, b, v, (h, w), 10.0, is_bg=False),
        boxes, valid)
    inv = _ref(lambda m: jax.vmap(od._invert_2x3)(m).reshape(-1, 6), mats)

    def bbox_rotate(x, bid, cover, union, inv):
        fg = od._FgInfo(jnp.asarray(boxes), jnp.asarray(valid),
                        jnp.zeros((od.MAX_FG,)), bid, cover, union)
        return od._apply_geo_bboxes_only(x, fg, inv)
    args = (img, want[0], want[1], want[2], inv)
    got, ref = _run(gpu, bbox_rotate, *args), _ref(bbox_rotate, *args)
    err = float(np.max(np.abs(got - ref)))
    expect("bbox-only rotate (per-pixel affine gather)", err <= 1.0,
           f"max |diff| {err:.3g}", one_level)

    # RoIAlign at the flagship FPN shapes (strides 4..32 of h x w)
    feats = [rng.rand(n_img, h // s, w // s, channels).astype(np.float32)
             for s in (4, 8, 16, 32)]
    rois = _random_rois(rng, n_img, per_img, h, w)

    def fwd(*fs_rois):
        return roi_align_multilevel(list(fs_rois[:-1]), fs_rois[-1])
    got = _run(gpu, fwd, *feats, rois)
    want = _ref(fwd, *feats, rois)
    # The bilinear weights come from f32 sample coordinates of up to
    # max(h, w)/4 cells. A backend that fuses a multiply-add of a
    # coordinate moves it, and a weight with it, by up to one ulp there
    # (6.1e-5 at 512 cells); a bin's two weights per axis move in
    # opposite directions.
    ulp = float(np.spacing(np.float32(max(h, w) / 4)))
    scale = float(np.max(np.abs(want)))
    ok = np.allclose(got, want, rtol=1e-5, atol=2 * ulp * scale)
    expect(f"RoIAlign forward ({rois.shape[0]} rois)", ok,
           f"max |diff| {np.max(np.abs(got - want)):.3g} of max {scale:.3g}",
           f"rtol 1e-5 + 2 ulp of the largest coordinate ({2 * ulp:.3g}) "
           "x the largest output: the coordinate rounding above")

    g = rng.rand(rois.shape[0], 7, 7, channels).astype(np.float32)

    def vjp_custom(*a):
        fs, r, gg = list(a[:-2]), a[-2], a[-1]
        return jax.vjp(lambda f: roi_align_multilevel(f, r), fs)[1](gg)[0]

    def vjp_autodiff(*a):
        fs, r, gg = list(a[:-2]), a[-2], a[-1]
        return jax.vjp(lambda f: _roi_align_multilevel_impl(f, r), fs)[1](
            gg)[0]
    got = _run(gpu, vjp_custom, *feats, rois, g)
    want = _run(gpu, vjp_autodiff, *feats, rois, g)
    for lvl, (a, b) in enumerate(zip(got, want)):
        scale = float(np.max(np.abs(b)))
        ok = np.allclose(a, b, rtol=1e-5, atol=2 * ulp * scale)
        expect(f"RoIAlign backward level {lvl}", ok,
               f"max |diff| {np.max(np.abs(a - b)):.3g} of max {scale:.3g}",
               f"rtol 1e-5 + {2 * ulp:.3g} of the level's largest cell: "
               "the coordinate rounding above, and f32 products added "
               "through atomics in run-dependent order")


# ------------------------------------------------ phase 2: train step ----

def build_flagship_step(h=H, w=W, batch=BATCH, tiny=False, mesh=None,
                        donate=True):
    """The flagship detector, optimizer, OA-Mix preprocess and jitted train
    step, built through the calls ``apis/train.py`` makes, plus a
    device-generated loader-format batch."""
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import (_flagship_model_cfg, _train_batch,
                                 _train_batch_device)
    from oadg_tpu.engine.optim import build_lr_schedule, build_optimizer
    from oadg_tpu.engine.preprocess import make_oadg_preprocess
    from oadg_tpu.engine.train_step import make_train_step
    from oadg_tpu.models import build_detector

    cfg, model = _flagship_model_cfg(tiny=tiny)
    num_views = int(cfg.get("num_views", 2))
    det = build_detector(model, num_views=num_views, dtype=jnp.bfloat16)
    preprocess = make_oadg_preprocess(
        dict(cfg.oamix_config), dict(cfg.img_norm_cfg),
        out_dtype=getattr(det, "dtype", None))
    # parameters do not depend on the image size: initialise small
    variables = jax.jit(lambda rngs, b: det.init(rngs, b, "train"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        _train_batch(num_views, 64, 64, g=4))
    params = variables["params"]
    batch_stats = variables.get("batch_stats")
    sched = build_lr_schedule(cfg.get("lr_config"), cfg.optimizer["lr"],
                              1000)
    tx = build_optimizer(params, cfg.optimizer, sched, model_cfg=model)
    opt_state = tx.init(params)
    step = make_train_step(det, tx, mesh=mesh, donate=donate,
                           preprocess=preprocess)
    data = _train_batch_device(batch, h, w, g=16, raw=True)
    return step, params, batch_stats, opt_state, data


def check_train_step(h=H, w=W, batch=BATCH, steps=3, tiny=False):
    import jax
    log(f"phase 2: flagship train step, {batch} clean x 2 views at "
        f"{h}x{w}, bf16")
    step, params, batch_stats, opt_state, data = build_flagship_step(
        h, w, batch, tiny)
    t0 = time.perf_counter()
    compiled = step.lower(params, batch_stats, opt_state, data,
                          jax.random.PRNGKey(2)).compile()
    log(f"  compile: {time.perf_counter() - t0:.1f} s")
    log(f"  memory_analysis: {compiled.memory_analysis()}")
    for i in range(steps):
        params, batch_stats, opt_state, log_vars = compiled(
            params, batch_stats, opt_state, data, jax.random.PRNGKey(3 + i))
        vals = {k: float(v) for k, v in log_vars.items()}
        expect(f"step {i} losses finite",
               all(np.isfinite(v) for v in vals.values()),
               ", ".join(f"{k}={v:.4f}" for k, v in sorted(vals.items())),
               "finite")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


# -------------------------------------------------- phase 3: test path ----

def check_test_path(h=H, w=W, n=2, tiny=False):
    import jax
    from __graft_entry__ import _flagship_model_cfg, _test_batch
    from oadg_tpu.engine.train_step import make_test_step
    from oadg_tpu.models import build_detector

    log(f"phase 3: test path on {n} images at {h}x{w}")
    _, model = _flagship_model_cfg(tiny=tiny)
    det = build_detector(model, num_views=1)
    variables = jax.jit(lambda rngs, b: det.init(rngs, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        _test_batch(1, 128, 128))
    test_fn = make_test_step(det)
    dets, labels, valid = jax.tree_util.tree_map(np.asarray, test_fn(
        variables["params"], variables.get("batch_stats"),
        _test_batch(n, h, w)))
    max_per_img = dets.shape[1]
    expect("detection shapes",
           dets.shape == (n, max_per_img, 5)
           and labels.shape == (n, max_per_img)
           and valid.shape == (n, max_per_img),
           f"dets {dets.shape}, labels {labels.shape}, valid {valid.shape}",
           "(images, max_per_img, 5)")
    expect("boxes and scores finite", bool(np.all(np.isfinite(dets))),
           f"{int(np.sum(valid))} valid detections", "finite")


# --------------------------------------- phase 4: four-card data mesh ----

def check_data_parallel(n=N_DP, h=H, w=W, batch=BATCH, tiny=False):
    """One step over an n-card data mesh against the same global batch on
    one card: the loss and the parameter update must agree."""
    import jax
    from oadg_tpu.parallel.mesh import make_mesh, replicate, shard_batch

    if len(jax.devices()) < n:
        raise RuntimeError(f"needs {n} devices, found {len(jax.devices())}")
    log(f"data-parallel step: {n} cards, global batch {batch} clean x 2 "
        f"views at {h}x{w}, against one card")
    key = jax.random.PRNGKey(2)
    step1, params, bstats, opt_state, data = build_flagship_step(
        h, w, batch, tiny, donate=False)
    mesh = make_mesh(n_data=n)
    stepn = build_flagship_step(h, w, batch, tiny, mesh=mesh,
                                donate=False)[0]
    args1 = (params, bstats, opt_state, data, key)
    argsn = (replicate(params, mesh),
             replicate(bstats, mesh) if bstats else None,
             replicate(opt_state, mesh), shard_batch(data, mesh), key)
    # the two programs compile side by side
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        c1, cn = [f.result() for f in [
            pool.submit(lambda s=s, a=a: s.lower(*a).compile())
            for s, a in ((step1, args1), (stepn, argsn))]]
    log(f"  compile (both): {time.perf_counter() - t0:.1f} s")
    p1, _, _, log1 = c1(*args1)
    pn, _, _, logn = cn(*argsn)
    l1, ln = float(log1["loss"]), float(logn["loss"])
    expect("loss", abs(l1 - ln) <= 2e-2 * max(abs(l1), 1.0),
           f"1 card {l1:.5f}, {n} cards {ln:.5f}",
           "2% relative: bf16 activations reduced in another order "
           "across shards")
    leaves = jax.tree_util.tree_leaves
    d1 = [np.asarray(a, np.float64) - np.asarray(b, np.float64)
          for a, b in zip(leaves(p1), leaves(params))]
    dn = [np.asarray(a, np.float64) - np.asarray(b, np.float64)
          for a, b in zip(leaves(pn), leaves(params))]
    num = np.sqrt(sum(np.sum((a - b) ** 2) for a, b in zip(d1, dn)))
    den = np.sqrt(sum(np.sum(a ** 2) for a in d1))
    rel = float(num / max(den, 1e-30))
    expect("parameter update", rel <= 5e-2,
           f"|update_n - update_1| / |update_1| = {rel:.3g}",
           "5% of the update's global norm: bf16 gradients summed over "
           "shards in another order")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-parallel", action="store_true",
                    help=f"run only the {N_DP}-card data-parallel step and "
                         "its one-card comparison")
    args = ap.parse_args()

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs an NVIDIA GPU; JAX found "
                 f"{devices[0].platform}")
    log(card_name_and_power_limit())
    log(f"jax {jax.__version__}, devices: {devices}")
    from oadg_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    t0 = time.perf_counter()
    if args.data_parallel:
        check_data_parallel()
    else:
        check_ops()
        check_train_step()
        check_test_path()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
