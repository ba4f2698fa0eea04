"""Microbenchmark model pieces on chip: backbone / backbone+neck /
dense-head loss / roi path, fwd+bwd, at bench shapes. Attribution tool
for the model-step optimization (bench.py measures the whole step).
Env: BENCH_H/W (default 1024x2048), PIECES=csv of pieces."""
import os
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))))

import jax

from oadg_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, n=8):
    out = fn(*args)
    _ = float(jnp.sum(jax.tree_util.tree_leaves(out)[0]))
    ts = []
    for _i in range(n):
        t0 = time.perf_counter()
        out = fn(*args)
        _ = float(jnp.sum(jax.tree_util.tree_leaves(out)[0]))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    from __graft_entry__ import _flagship_model_cfg, _train_batch_device
    from oadg_tpu.models import build_detector

    cfg, model = _flagship_model_cfg(tiny=False)
    h = int(os.environ.get("BENCH_H", "1024"))
    w = int(os.environ.get("BENCH_W", "2048"))
    n = 4                                   # 2 clean x 2 views
    pieces = os.environ.get("PIECES", "backbone,neck,rpn_fwd,full_fwd").split(",")

    det = build_detector(model, num_views=2, dtype=jnp.bfloat16)
    batch = _train_batch_device(n, h, w, g=16)
    variables = jax.jit(lambda rngs, bb: det.init(rngs, bb, "train"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        _train_batch_device(2, 64, 64, g=4))
    params = variables["params"]
    bs = variables.get("batch_stats")

    def apply_sub(method_name):
        def f(img):
            vs = {"params": params}
            if bs is not None:
                vs["batch_stats"] = bs
            return det.apply(vs, img, method=getattr(det, method_name))
        return f

    img = batch["img"].astype(jnp.bfloat16)

    if "backbone" in pieces and hasattr(det, "extract_backbone"):
        pass

    # backbone+neck via extract_feat (standard detector API)
    def feat_fwd(img):
        vs = {"params": params}
        if bs is not None:
            vs["batch_stats"] = bs
        return det.apply(vs, img, method=det.extract_feat)

    def feat_fwd_bwd(img):
        def lossf(im):
            feats = feat_fwd(im)
            return sum(jnp.sum(f.astype(jnp.float32) ** 2) for f in feats)
        return jax.grad(lossf)(img)

    if "neck" in pieces:
        t = timeit(jax.jit(feat_fwd), img)
        print(f"backbone+neck fwd:      {t*1000:8.1f} ms")
    if "backbone" in pieces:
        t = timeit(jax.jit(feat_fwd_bwd), img)
        print(f"backbone+neck fwd+bwd:  {t*1000:8.1f} ms")
    if "full_fwd" in pieces:
        def full_loss(p, batch, key):
            vs = {"params": p}
            if bs is not None:
                vs["batch_stats"] = bs
            losses = det.apply(vs, batch, "train", rngs={"sampling": key})
            return sum(jnp.sum(v) for k, v in losses.items() if "loss" in k)
        g = jax.jit(jax.grad(full_loss))
        t = timeit(g, params, batch, jax.random.PRNGKey(3))
        print(f"full train fwd+bwd:     {t*1000:8.1f} ms")

    feats = None
    if {"rpn", "props", "roi"} & set(pieces):
        feats = jax.jit(feat_fwd)(img)
        feats = jax.tree_util.tree_map(jax.lax.stop_gradient, feats)

    if "rpn" in pieces:
        # fixed features -> rpn_head loss (assign/sample/targets included)
        def rpn_loss(p, feats, key):
            vs = {"params": p}
            if bs is not None:
                vs["batch_stats"] = bs

            def run(d, feats):
                outs = d.rpn(feats)
                return d.rpn.loss(outs[0], outs[1], batch["gt_bboxes"],
                                  batch["gt_valid"], key)
            losses = det.apply(vs, feats, method=run)
            return sum(jnp.sum(v) for v in losses.values())
        g = jax.jit(jax.value_and_grad(rpn_loss))
        t = timeit(g, params, feats, jax.random.PRNGKey(3))
        print(f"rpn loss fwd+bwd:       {t*1000:8.1f} ms")

    if "props" in pieces or "roi" in pieces:
        # fixed features -> rpn forward + get_proposals (NMS path, no grad)
        nv = det.num_views
        b = img.shape[0] // nv

        def props_fn(p, feats):
            vs = {"params": p}
            if bs is not None:
                vs["batch_stats"] = bs

            def run(d, feats):
                cls_scores, bbox_preds = d.rpn(feats)
                pc = dict(d.train_cfg or {}).get(
                    "rpn_proposal", dict(d.test_cfg or {}).get("rpn", {}))
                return d.rpn.get_proposals(
                    [s[:b] for s in cls_scores], [q[:b] for q in bbox_preds],
                    batch["img_shape"][:b], pc)
            return det.apply(vs, feats, method=run)
        props_j = jax.jit(props_fn)
        if "props" in pieces:
            t = timeit(props_j, params, feats)
            print(f"rpn fwd+proposals:      {t*1000:8.1f} ms")
        pb, _, pv = props_j(params, feats)
        pb = jnp.concatenate([pb] * nv, axis=0)
        pv = jnp.concatenate([pv] * nv, axis=0)
        pb = jax.lax.stop_gradient(pb)

    if "roi" in pieces:
        # fixed features + proposals -> roi head loss (assign/sample/
        # RoIAlign/bbox head/OA losses included)
        def roi_loss(p, feats, pb, pv, key):
            vs = {"params": p}
            if bs is not None:
                vs["batch_stats"] = bs

            def run(d, feats):
                rp = rvv = None
                if d.random_proposal_cfg is not None:
                    rp, rvv = d._random_proposals(batch, jax.random.fold_in(key, 1))
                return d.roi.loss(
                    feats, pb, pv, batch["gt_bboxes"], batch["gt_valid"],
                    batch["gt_labels"], key, random_proposals=rp,
                    random_valid=rvv, gt_masks=batch.get("gt_masks"))
            losses = det.apply(vs, feats, method=run)
            return sum(jnp.sum(v) for v in losses.values())
        g = jax.jit(jax.value_and_grad(roi_loss))
        t = timeit(g, params, feats, pb, pv, jax.random.PRNGKey(3))
        print(f"roi loss fwd+bwd:       {t*1000:8.1f} ms")

    trace_dir = os.environ.get("TRACE")
    if trace_dir and "full_fwd" in pieces:
        def full_loss(p, batch, key):
            vs = {"params": p}
            if bs is not None:
                vs["batch_stats"] = bs
            losses = det.apply(vs, batch, "train", rngs={"sampling": key})
            return sum(jnp.sum(v) for k, v in losses.items() if "loss" in k)
        g = jax.jit(jax.grad(full_loss))
        out = g(params, batch, jax.random.PRNGKey(3))
        _ = float(jnp.sum(jax.tree_util.tree_leaves(out)[0]))
        with jax.profiler.trace(trace_dir):
            for _i in range(3):
                out = g(params, batch, jax.random.PRNGKey(3))
                _ = float(jnp.sum(jax.tree_util.tree_leaves(out)[0]))
        print(f"trace written to {trace_dir}")


if __name__ == "__main__":
    main()
