"""Test CLI (reference tools/test.py): evaluate a checkpoint on the test
set; supports --eval bbox/mAP, --out pickle, --show-dir."""
import argparse
import os.path as osp
import pickle
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from oadg_tpu.apis.train import _static_hw_from_pipeline
from oadg_tpu.config import Config, DictAction
from oadg_tpu.data import build_dataloader, build_dataset
from oadg_tpu.utils.compile_cache import enable_compile_cache


def parse_args():
    p = argparse.ArgumentParser(description="Test a detector")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--out", help="output result pickle")
    p.add_argument("--eval", nargs="+",
                   help="evaluation metrics, e.g. bbox mAP")
    p.add_argument("--show-dir", help="directory for drawn detections")
    p.add_argument("--show-score-thr", type=float, default=0.3)
    p.add_argument("--cfg-options", nargs="+", action=DictAction)
    p.add_argument("--launcher", default="none")
    p.add_argument("--local_rank", type=int, default=0)
    return p.parse_args()


def load_model_state(cfg, checkpoint):
    """Build detector + jitted test step + weights."""
    import jax
    import jax.numpy as jnp
    from oadg_tpu.apis.inference import _num_classes
    from oadg_tpu.engine.train_step import make_test_step
    from oadg_tpu.models import build_detector
    from oadg_tpu.utils.checkpoint import (load_checkpoint_variables,
                                           merge_variables)

    det = build_detector(dict(cfg.model), num_views=1)
    dummy = {"img": jnp.zeros((1, 128, 128, 3), jnp.float32),
             "img_shape": jnp.asarray([[128.0, 128.0]]),
             "scale_factor": jnp.ones((1, 4), jnp.float32)}
    variables = jax.jit(lambda r, b: det.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        dummy)
    if checkpoint and checkpoint != "none":
        variables = merge_variables(variables,
                                    load_checkpoint_variables(checkpoint))
    return dict(test_fn=make_test_step(det), params=variables["params"],
                batch_stats=variables.get("batch_stats"),
                num_classes=_num_classes(cfg), detector=det)


def build_test_loader(cfg, test_cfg=None):
    tc = dict(test_cfg if test_cfg is not None else cfg.data.test)
    tc["test_mode"] = True
    dataset = build_dataset(tc)
    pipeline = tc.get("pipeline")
    static = None
    for p in pipeline or []:
        if p.get("type") == "MultiScaleFlipAug":
            static = _static_hw_from_pipeline(
                [dict(type="Resize", img_scale=p.get("img_scale"))])
    loader = build_dataloader(dataset, samples_per_gpu=1, workers_per_gpu=2,
                              shuffle=False, static_hw=static)
    return dataset, loader


def main():
    args = parse_args()
    enable_compile_cache()
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)

    from oadg_tpu.apis.test import multi_gpu_test, single_gpu_test
    dataset, loader = build_test_loader(cfg)
    model_state = load_model_state(cfg, args.checkpoint)
    import jax
    if jax.process_count() > 1:
        results = multi_gpu_test(model_state, loader)
    else:
        results = single_gpu_test(model_state, loader)

    metrics = None
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
        print(f"\nwrote {args.out}")
    if args.eval:
        metrics = dataset.evaluate(results, metric=args.eval)
        print(metrics)
    return metrics


if __name__ == "__main__":
    main()
