"""Training CLI (reference tools/train.py, same flags; JAX engine).

Usage: python tools/train.py CONFIG [--work-dir D] [--resume-from CKPT]
       [--auto-resume] [--seed N] [--cfg-options k=v ...]
"""
import argparse
import os
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from oadg_tpu.config import Config, DictAction
from oadg_tpu.data import build_dataset
from oadg_tpu.models import build_detector
from oadg_tpu.apis import init_random_seed, set_random_seed, train_detector
from oadg_tpu.engine.runner import get_root_logger
from oadg_tpu.utils.compile_cache import enable_compile_cache


def parse_args():
    p = argparse.ArgumentParser(description="Train a detector")
    p.add_argument("config")
    p.add_argument("--work-dir")
    p.add_argument("--resume-from")
    p.add_argument("--auto-resume", action="store_true")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--cfg-options", nargs="+", action=DictAction)
    p.add_argument("--launcher", default="none",
                   choices=["none", "pytorch", "slurm", "mpi"],
                   help="accepted for reference-CLI compatibility; the mesh "
                        "replaces process launchers")
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--gpu-id", type=int, default=None,
                   help="train on this one device (default: every device)")
    return p.parse_args()


def main():
    args = parse_args()
    enable_compile_cache()
    # Multi-host bring-up (reference tools/train.py:129 init_dist): when a
    # launcher environment is present the global mesh spans every host.
    from oadg_tpu.parallel.mesh import init_distributed
    if args.launcher != "none" or any(
            k in os.environ for k in ("JAX_COORDINATOR_ADDRESS",
                                      "SLURM_JOB_ID",
                                      "OMPI_COMM_WORLD_SIZE")):
        rank, world = init_distributed()
        if world > 1:
            print(f"initialized jax.distributed: process {rank}/{world}")
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    if args.work_dir:
        cfg["work_dir"] = args.work_dir
    elif not cfg.get("work_dir"):
        cfg["work_dir"] = osp.join(
            "./work_dirs", osp.splitext(osp.basename(args.config))[0])
    os.makedirs(cfg["work_dir"], exist_ok=True)
    cfg["resume_from"] = args.resume_from or cfg.get("resume_from")
    cfg["auto_resume"] = args.auto_resume
    if args.gpu_id is not None:
        cfg["gpu_ids"] = [args.gpu_id]

    logger = get_root_logger(osp.join(cfg["work_dir"],
                                      f"{int(time.time())}.log"))
    seed = init_random_seed(args.seed if args.seed is not None
                            else cfg.get("seed"))
    set_random_seed(seed, deterministic=args.deterministic)
    cfg["seed"] = seed
    logger.info(f"Set random seed to {seed}")
    cfg.dump(osp.join(cfg["work_dir"], osp.basename(args.config)))

    num_views = int(cfg.get("num_views", 1) or 1)
    detector = build_detector(dict(cfg.model), num_views=num_views)
    dataset = build_dataset(dict(cfg.data.train))
    train_detector(detector, dataset, cfg, validate=not args.no_validate,
                   num_views=num_views, work_dir=cfg["work_dir"])


if __name__ == "__main__":
    main()
