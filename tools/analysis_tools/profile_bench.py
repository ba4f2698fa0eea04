"""Profile the flagship bench step: capture a jax.profiler device trace of
a few steady-state train steps (same setup as bench.py) and print the top
XLA ops. Knobs: BENCH_* envs from bench.py, PROF_DIR,
PROF_NO_PREPROCESS=1 to profile the model-only step."""
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


def main():
    from __graft_entry__ import _flagship_model_cfg, _train_batch
    from oadg_tpu.engine.optim import build_lr_schedule, build_optimizer
    from oadg_tpu.engine.preprocess import make_oadg_preprocess
    from oadg_tpu.engine.train_step import make_train_step
    from oadg_tpu.models import build_detector

    cfg, model = _flagship_model_cfg(tiny=False)
    num_views = int(cfg.get("num_views", 2))
    b = int(os.environ.get("BENCH_BATCH", "2"))
    h = int(os.environ.get("BENCH_H", "1024"))
    w = int(os.environ.get("BENCH_W", "2048"))
    prof_dir = os.environ.get("PROF_DIR", "/tmp/jaxprof_bench")

    from __graft_entry__ import _train_batch_device
    det = build_detector(model, num_views=num_views, dtype=jnp.bfloat16)
    preprocess = None
    if os.environ.get("PROF_NO_PREPROCESS"):
        # feed the already-integrated multi-view batch directly
        batch = _train_batch_device(b * num_views, h, w, g=16)
    else:
        batch = _train_batch_device(b, h, w, g=16, raw=True)
        preprocess = make_oadg_preprocess(dict(cfg.oamix_config),
                                          dict(cfg.img_norm_cfg),
                                          out_dtype=jnp.bfloat16)

    init_batch = _train_batch(num_views, 64, 64, g=4)
    variables = jax.jit(lambda rngs, bb: det.init(rngs, bb, "train"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        init_batch)
    params = variables["params"]
    batch_stats = variables.get("batch_stats")
    sched = build_lr_schedule(cfg.get("lr_config"), cfg.optimizer["lr"], 1000)
    tx = build_optimizer(params, cfg.optimizer, sched, model_cfg=model)
    opt_state = tx.init(params)
    step = make_train_step(det, tx, mesh=None, donate=False,
                           preprocess=preprocess)

    t0 = time.perf_counter()
    if os.environ.get("PROF_HLO"):
        # optimized-HLO text dump for parse_trace --hlo source-line joins;
        # execute through the SAME compiled object (a fresh step() call
        # would compile a second time, ~150 s wasted)
        compiled = step.lower(params, batch_stats, opt_state, batch,
                              jax.random.PRNGKey(2)).compile()
        with open(os.environ["PROF_HLO"], "w") as f:
            f.write(compiled.as_text())
        print(f"optimized HLO -> {os.environ['PROF_HLO']}", file=sys.stderr)
        step = compiled
    params, batch_stats, opt_state, log_vars = step(params, batch_stats, opt_state, batch,
                                       jax.random.PRNGKey(2))
    _ = float(log_vars["loss"])
    print(f"compiled in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    with jax.profiler.trace(prof_dir):
        for i in range(3):
            params, batch_stats, opt_state, log_vars = step(
                params, batch_stats, opt_state, batch, jax.random.PRNGKey(9 + i))
            _ = float(log_vars["loss"])
    print(f"trace written to {prof_dir}", file=sys.stderr)

    import parse_trace  # same directory
    sys.argv = ["parse_trace.py", prof_dir, "--top",
                os.environ.get("PROF_TOP", "40")]
    parse_trace.main()


if __name__ == "__main__":
    main()
