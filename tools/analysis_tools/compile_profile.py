"""Break the flagship train-step startup cost into trace / lower / compile.

The driver-visible "compile_seconds" in bench.py covers everything from
dispatch to the first result: Python tracing of the step (module
apply + OA-Mix + losses), jaxpr->StableHLO lowering, XLA compilation, and
the first execution. The persistent compilation cache only helps the XLA
part; trace+lowering are Python and repaid on every process start. This
tool times each phase separately (and can cProfile the trace phase) so
compile-time work targets the real cost.

Usage:
    python tools/analysis_tools/compile_profile.py [--tiny] [--cprofile N]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import jax

from oadg_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--cprofile", type=int, default=0,
                    help="print top-N cumulative entries of the trace phase")
    ap.add_argument("--h", type=int, default=1024)
    ap.add_argument("--w", type=int, default=2048)
    ap.add_argument("--no-preprocess", action="store_true")
    ap.add_argument("--lower-only", action="store_true",
                    help="stop after lowering; print per-op-kind counts")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from __graft_entry__ import _flagship_model_cfg, _train_batch
    from oadg_tpu.engine.optim import build_lr_schedule, build_optimizer
    from oadg_tpu.engine.preprocess import make_oadg_preprocess
    from oadg_tpu.engine.train_step import make_train_step
    from oadg_tpu.models import build_detector
    import jax.numpy as jnp

    cfg, model = _flagship_model_cfg(tiny=args.tiny)
    num_views = int(cfg.get("num_views", 2))
    det = build_detector(model, num_views=num_views, dtype=jnp.bfloat16)
    preprocess = None
    if not args.no_preprocess:
        preprocess = make_oadg_preprocess(dict(cfg.oamix_config),
                                          dict(cfg.img_norm_cfg))

    b = 2
    batch = _train_batch(b, args.h, args.w, g=16)
    if preprocess is not None:
        import numpy as np
        rng = np.random.RandomState(1)
        batch["img_raw"] = jnp.asarray(
            rng.uniform(0, 255, (b, args.h, args.w, 3)).astype(np.float32))

    t0 = time.perf_counter()
    variables = jax.jit(lambda rngs, bb: det.init(rngs, bb, "train"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        _train_batch(num_views, 64, 64, g=4))
    jax.block_until_ready(variables)
    t_init = time.perf_counter() - t0
    params = variables["params"]
    batch_stats = variables.get("batch_stats")

    sched = build_lr_schedule(cfg.get("lr_config"), cfg.optimizer["lr"], 1000)
    tx = build_optimizer(params, cfg.optimizer, sched, model_cfg=model)
    opt_state = tx.init(params)

    step = make_train_step(det, tx, mesh=None, donate=False,
                           preprocess=preprocess)
    step_args = (params, batch_stats, opt_state, batch, jax.random.PRNGKey(2))

    if args.cprofile:
        import cProfile
        import pstats
        prof = cProfile.Profile()
        prof.enable()
        lowered = step.lower(*step_args)
        prof.disable()
        stats = pstats.Stats(prof)
        stats.sort_stats("cumulative")
        stats.print_stats(args.cprofile)
        t_lower = None
    else:
        t0 = time.perf_counter()
        lowered = step.lower(*step_args)
        t_lower = time.perf_counter() - t0

    hlo_text = lowered.as_text()
    hlo_bytes = len(hlo_text)

    if args.lower_only:
        import collections
        import re
        ops = collections.Counter(
            re.findall(r"= \"?([a-z_]+\.[a-z_0-9]+)", hlo_text))
        print(f"trace+lower_seconds     {t_lower:8.1f}" if t_lower else "")
        print(f"stablehlo_text_bytes    {hlo_bytes:8d}")
        print(f"stablehlo_total_ops     {sum(ops.values()):8d}")
        for name, cnt in ops.most_common(25):
            print(f"  {name:40s} {cnt:8d}")
        return

    t0 = time.perf_counter()
    compiled = lowered.compile()
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = compiled(*step_args)
    _ = float(out[2]["loss"])
    t_first = time.perf_counter() - t0

    print(f"init_seconds            {t_init:8.1f}")
    if t_lower is not None:
        print(f"trace+lower_seconds     {t_lower:8.1f}")
    print(f"xla_compile_seconds     {t_compile:8.1f}")
    print(f"first_exec_seconds      {t_first:8.1f}")
    print(f"stablehlo_text_bytes    {hlo_bytes:8d}")
    try:
        cc = compiled.cost_analysis()
        if isinstance(cc, (list, tuple)):
            cc = cc[0]
        print(f"flops_per_step          {cc.get('flops', float('nan')):.3e}")
    except Exception:
        pass
    try:
        ma = compiled.memory_analysis()
        for field in ("argument_size_in_bytes", "output_size_in_bytes",
                      "temp_size_in_bytes", "generated_code_size_in_bytes"):
            v = getattr(ma, field, None)
            if v is not None:
                print(f"{field:30s} {v / 1e9:8.2f} GB")
    except Exception:
        pass


if __name__ == "__main__":
    main()
