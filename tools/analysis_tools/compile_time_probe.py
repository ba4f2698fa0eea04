"""Measure cold-compile time of pipeline pieces in isolation (the
flagship step's compile cost is a round-2 verdict item). Usage:
  python tools/analysis_tools/compile_time_probe.py preprocess|model
Env: BENCH_H/W/BATCH as bench.py.
Uses AOT lower().compile() with the persistent cache DISABLED so the
number is a true cold compile."""
import os
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))))

import jax   # NOTE: no compilation-cache config -> cold numbers
import jax.numpy as jnp
import numpy as np


def main():
    what = sys.argv[1] if len(sys.argv) > 1 else "preprocess"
    from __graft_entry__ import _flagship_model_cfg, _train_batch
    cfg, model = _flagship_model_cfg(tiny=False)
    num_views = int(cfg.get("num_views", 2))
    b = int(os.environ.get("BENCH_BATCH", "2"))
    h = int(os.environ.get("BENCH_H", "1024"))
    w = int(os.environ.get("BENCH_W", "2048"))

    if what == "preprocess":
        from oadg_tpu.engine.preprocess import make_oadg_preprocess
        preprocess = make_oadg_preprocess(dict(cfg.oamix_config),
                                          dict(cfg.img_norm_cfg))
        batch = _train_batch(b, h, w, g=16)
        rng0 = np.random.RandomState(1)
        batch["img_raw"] = jnp.asarray(
            rng0.randint(0, 256, (b, h, w, 3)).astype(np.float32))
        fn = jax.jit(preprocess)
        t0 = time.perf_counter()
        lowered = fn.lower(batch, jax.random.PRNGKey(0))
        t1 = time.perf_counter()
        compiled = lowered.compile()
        t2 = time.perf_counter()
        print(f"preprocess: "
              f"trace+lower {t1-t0:.1f}s, compile {t2-t1:.1f}s")
    else:
        from oadg_tpu.engine.optim import build_lr_schedule, build_optimizer
        from oadg_tpu.engine.train_step import make_train_step
        from oadg_tpu.models import build_detector
        det = build_detector(model, num_views=num_views, dtype=jnp.bfloat16)
        batch = _train_batch(b * num_views, h, w, g=16)
        init_batch = _train_batch(num_views, 64, 64, g=4)
        variables = jax.jit(lambda rngs, bb: det.init(rngs, bb, "train"))(
            {"params": jax.random.PRNGKey(0),
             "sampling": jax.random.PRNGKey(1)}, init_batch)
        params = variables["params"]
        batch_stats = variables.get("batch_stats")
        sched = build_lr_schedule(cfg.get("lr_config"), cfg.optimizer["lr"],
                                  1000)
        tx = build_optimizer(params, cfg.optimizer, sched, model_cfg=model)
        opt_state = tx.init(params)
        step = make_train_step(det, tx, mesh=None, donate=False,
                               preprocess=None)
        t0 = time.perf_counter()
        lowered = step.lower(params, batch_stats, opt_state, batch,
                             jax.random.PRNGKey(2))
        t1 = time.perf_counter()
        compiled = lowered.compile()
        t2 = time.perf_counter()
        print(f"model step: trace+lower {t1-t0:.1f}s, compile {t2-t1:.1f}s")


if __name__ == "__main__":
    main()
