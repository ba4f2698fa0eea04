"""Inference FPS benchmark (reference tools/analysis_tools/benchmark.py)."""
import argparse
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))))

import numpy as np


def parse_args():
    p = argparse.ArgumentParser(description="inference fps benchmark")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--max-iter", type=int, default=100)
    p.add_argument("--log-interval", type=int, default=20)
    p.add_argument("--h", type=int, default=1024)
    p.add_argument("--w", type=int, default=2048)
    return p.parse_args()


def main():
    args = parse_args()
    import jax
    import jax.numpy as jnp
    from oadg_tpu.config import Config
    from oadg_tpu.apis.inference import _num_classes
    from oadg_tpu.engine.train_step import make_test_step
    from oadg_tpu.models import build_detector
    cfg = Config.fromfile(args.config)
    det = build_detector(dict(cfg.model), num_views=1)
    dummy = {"img": jnp.zeros((1, 128, 128, 3), jnp.float32),
             "img_shape": jnp.asarray([[128.0, 128.0]]),
             "scale_factor": jnp.ones((1, 4), jnp.float32)}
    variables = jax.jit(lambda r, b: det.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        dummy)
    if args.checkpoint:
        from oadg_tpu.utils.checkpoint import (load_checkpoint_variables,
                                               merge_variables)
        variables = merge_variables(variables,
                                    load_checkpoint_variables(args.checkpoint))
    fn = make_test_step(det)
    batch = {"img": jnp.asarray(np.random.randn(1, args.h, args.w, 3),
                                jnp.float32),
             "img_shape": jnp.asarray([[args.h, args.w]], jnp.float32),
             "scale_factor": jnp.ones((1, 4), jnp.float32)}
    out = fn(variables["params"], variables.get("batch_stats"), batch)
    _ = float(jnp.sum(out[0]))         # sync: fetch a scalar
    # Chained-dispatch timing: dispatch all iters, sync once at the end
    # (per-iter host syncs would bill a host round-trip to the model).
    t0 = time.perf_counter()
    for i in range(args.max_iter):
        out = fn(variables["params"], variables.get("batch_stats"), batch)
    _ = float(jnp.sum(out[0]))
    mean_t = (time.perf_counter() - t0) / args.max_iter
    print(f"Overall fps: {1.0/mean_t:.1f} img/s ({mean_t*1000:.1f} ms/img)")


if __name__ == "__main__":
    main()
