"""Epoch-based training runner (replaces mmcv EpochBasedRunner + hooks).

Covers the reference's runner surface that OA-DG configs exercise
(SURVEY.md §2.2 "Runner/optim/ckpt"): epoch loop, per-iteration jitted
train step, step LR with linear warmup (in the optimizer), interval text/
json logging with ``time``/``data_time`` fields (mmcv IterTimerHook parity),
epoch checkpointing + auto-resume (Orbax), NaN loss guard (CheckLossHook),
and per-epoch evaluation (EvalHook).
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel.mesh import replicate, shard_batch
from .optim import build_lr_schedule, build_optimizer
from .train_step import make_test_step, make_train_step


def get_root_logger(log_file: Optional[str] = None, log_level=logging.INFO):
    logger = logging.getLogger("oadg_tpu")
    if logger.handlers:
        return logger
    logger.setLevel(log_level)
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class Checkpointer:
    """Orbax-backed checkpointing (reference: mmcv CheckpointHook +
    runner.resume, SURVEY.md §5.4)."""

    def __init__(self, work_dir: str):
        import orbax.checkpoint as ocp
        self.dir = os.path.abspath(os.path.join(work_dir, "checkpoints"))
        os.makedirs(self.dir, exist_ok=True)
        self._ckptr = ocp.PyTreeCheckpointer()

    def save(self, state: Dict[str, Any], step: int):
        from ..utils.checkpoint import to_state_dict
        path = os.path.join(self.dir, f"epoch_{step}")
        # to_state_dict flattens optax NamedTuples into plain dicts that
        # orbax round-trips losslessly; restore() re-inflates via a template
        self._ckptr.save(path, to_state_dict(state), force=True)
        with open(os.path.join(self.dir, "latest"), "w") as f:
            f.write(f"epoch_{step}")

    def latest_path(self) -> Optional[str]:
        marker = os.path.join(self.dir, "latest")
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            return os.path.join(self.dir, f.read().strip())

    def restore(self, path: Optional[str] = None):
        path = path or self.latest_path()
        if path is None or not os.path.exists(path):
            return None
        from ..utils.checkpoint import orbax_restore
        return orbax_restore(path)


class EpochBasedRunner:
    def __init__(self, detector, cfg, train_loader, work_dir: str,
                 val_dataset=None, val_loader=None, mesh=None,
                 preprocess=None, logger=None, init_variables=None,
                 seed: int = 0):
        self.det = detector
        self.cfg = cfg
        self.loader = train_loader
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.mesh = mesh
        self.logger = logger or get_root_logger(
            os.path.join(work_dir, f"{int(time.time())}.log"))
        self.json_log = open(os.path.join(work_dir, "log.json"), "a")
        self.max_epochs = int(dict(cfg.get("runner", {})).get("max_epochs", 12))
        self.log_interval = int(dict(cfg.get("log_config", {})).get("interval", 50))
        self.ckpt_interval = int(dict(cfg.get("checkpoint_config", {})
                                      ).get("interval", 1))
        self.val_dataset = val_dataset
        self.val_loader = val_loader
        self.seed = seed

        steps_per_epoch = max(len(train_loader), 1)
        sched = build_lr_schedule(cfg.get("lr_config"),
                                  float(cfg.optimizer["lr"]), steps_per_epoch)
        self.lr_fn = sched

        if init_variables is None:
            batch = dict(self._first_batch())
            if "img" not in batch:
                # norm-on-device collate ships only the uint8 img_raw;
                # params are shape-driven, so any f32 view works for init
                batch["img"] = batch["img_raw"].astype(np.float32)
            init_variables = jax.jit(
                lambda rngs, b: detector.init(rngs, b, "train"))(
                {"params": jax.random.PRNGKey(seed),
                 "sampling": jax.random.PRNGKey(seed + 1)},
                jax.tree_util.tree_map(jnp.asarray, batch))
        self.params = init_variables["params"]
        self.batch_stats = init_variables.get("batch_stats")
        self.tx = build_optimizer(self.params, cfg.optimizer, sched,
                                  model_cfg=dict(cfg.model),
                                  grad_clip=dict(cfg.get("optimizer_config",
                                                         {}) or {}).get("grad_clip"))
        self.opt_state = self.tx.init(self.params)
        self.step_fn = make_train_step(detector, self.tx, mesh=mesh,
                                       donate=False, preprocess=preprocess)
        self.test_fn = make_test_step(detector, mesh=None)
        self.ckpt = Checkpointer(work_dir)
        self.epoch = 0
        self.iter = 0
        self._preprocess = preprocess
        self.det = detector
        self.hooks = self._build_hooks(cfg)

    def _build_hooks(self, cfg):
        from ..core.hook import Hook  # noqa: F401  (registers hook classes)
        from ..utils.registry import HOOKS, build_from_cfg
        hooks = []
        for hc in list(cfg.get("custom_hooks") or []):
            try:
                hooks.append(build_from_cfg(dict(hc), HOOKS))
            except KeyError as e:
                self.logger.warning(f"skipping unknown hook {hc}: {e}")
        return hooks

    def call_hooks(self, stage: str, *args):
        for h in self.hooks:
            getattr(h, stage)(self, *args)

    def enable_head_l1(self):
        """YOLOXModeSwitchHook: rebuild the detector + jitted step with
        the head's extra L1 loss enabled (one extra compile)."""
        import copy
        from ..models import build_detector
        mc = copy.deepcopy(dict(self.cfg.model))
        if "bbox_head" in mc:
            mc["bbox_head"] = dict(mc["bbox_head"], use_l1=True)
        self.det = build_detector(mc, num_views=int(
            self.cfg.get("num_views", 1) or 1))
        self.step_fn = make_train_step(self.det, self.tx, mesh=self.mesh,
                                       donate=False,
                                       preprocess=self._preprocess)
        self.test_fn = make_test_step(self.det, mesh=None)

    def _first_batch(self):
        for b in self.loader:
            return self._device_batch(b)
        raise RuntimeError("empty train loader")

    def _device_batch(self, batch):
        clean = {k: v for k, v in batch.items() if k != "metas"}
        arrs = jax.tree_util.tree_map(jnp.asarray, clean)
        if self.mesh is not None:
            arrs = shard_batch(arrs, self.mesh)
        return arrs

    # ---------------- lifecycle ----------------

    def resume(self, path: Optional[str] = None, auto: bool = False):
        state = self.ckpt.restore(path) if (path or auto) else None
        if state is not None:
            from ..utils.checkpoint import from_state_dict
            template = dict(params=self.params, batch_stats=self.batch_stats,
                            opt_state=self.opt_state, epoch=0, iter=0)
            state = from_state_dict(template, state)
            self.params = state["params"]
            self.batch_stats = state.get("batch_stats")
            self.opt_state = state["opt_state"]
            self.epoch = int(state.get("epoch", 0))
            self.iter = int(state.get("iter", 0))
            self.logger.info(f"resumed from epoch {self.epoch}")

    def load_weights(self, variables: Dict[str, Any]):
        """load_from semantics: weights only (no opt state / epoch)."""
        self.params = variables["params"]
        if variables.get("batch_stats") is not None:
            self.batch_stats = variables["batch_stats"]

    def save(self):
        self.ckpt.save(dict(params=self.params, batch_stats=self.batch_stats,
                            opt_state=self.opt_state, epoch=self.epoch,
                            iter=self.iter), self.epoch)

    # ---------------- loops ----------------

    def train_epoch(self):
        t_data = time.perf_counter()
        window: List[Dict[str, float]] = []
        for i, batch in enumerate(self.loader):
            arrs = self._device_batch(batch)
            data_time = time.perf_counter() - t_data
            t0 = time.perf_counter()
            rng = jax.random.fold_in(jax.random.PRNGKey(self.seed), self.iter)
            self.params, self.batch_stats, self.opt_state, log_vars = \
                self.step_fn(self.params, self.batch_stats, self.opt_state,
                             arrs, rng)
            jax.block_until_ready(log_vars["loss"])
            step_time = time.perf_counter() - t0
            self.iter += 1
            scal = {k: float(v) for k, v in log_vars.items()}
            if not np.isfinite(scal["loss"]):
                raise FloatingPointError(
                    f"non-finite loss at iter {self.iter}: {scal}")
            scal["time"] = step_time
            scal["data_time"] = data_time
            window.append(scal)
            self.call_hooks("after_train_iter", scal)
            if (i + 1) % self.log_interval == 0:
                avg = {k: float(np.mean([w[k] for w in window]))
                       for k in window[0]}
                lr = float(self.lr_fn(self.iter))
                msg = (f"Epoch [{self.epoch + 1}][{i + 1}/{len(self.loader)}] "
                       f"lr: {lr:.2e}, " +
                       ", ".join(f"{k}: {v:.4f}" for k, v in avg.items()))
                self.logger.info(msg)
                self.json_log.write(json.dumps(
                    dict(mode="train", epoch=self.epoch + 1, iter=self.iter,
                         lr=lr, **avg)) + "\n")
                self.json_log.flush()
                window.clear()
            t_data = time.perf_counter()

    def run(self):
        self.logger.info(f"Start training: {self.max_epochs} epochs, "
                         f"{len(self.loader)} iters/epoch")
        self.call_hooks("before_run")
        while self.epoch < self.max_epochs:
            self.call_hooks("before_train_epoch")
            self.train_epoch()
            self.call_hooks("after_train_epoch")
            self.epoch += 1
            if self.epoch % self.ckpt_interval == 0:
                self.save()
            if self.val_loader is not None and self.val_dataset is not None:
                metrics = self.evaluate()
                self.logger.info(f"Epoch {self.epoch} eval: {metrics}")
                self.json_log.write(json.dumps(
                    dict(mode="val", epoch=self.epoch, **metrics)) + "\n")
                self.json_log.flush()
                self.call_hooks("after_val_epoch", metrics)
        self.call_hooks("after_run")

    # ---------------- eval ----------------

    def evaluate(self, metric=None):
        from ..apis.test import run_test
        results = run_test(self.test_fn, self.params, self.batch_stats,
                           self.val_loader,
                           num_classes=_num_classes(self.cfg))
        self.last_val_results = results       # consumed by WandbLogger
        kwargs = {}
        ev = dict(self.cfg.get("evaluation", {}) or {})
        if metric or ev.get("metric"):
            kwargs["metric"] = metric or ev["metric"]
        return self.val_dataset.evaluate(results, **kwargs)


def _num_classes(cfg) -> int:
    m = dict(cfg.model)
    rh = dict(m.get("roi_head") or {})
    if rh.get("bbox_head"):
        return int(dict(rh["bbox_head"]).get("num_classes", 80))
    bh = dict(m.get("bbox_head") or {})
    return int(bh.get("num_classes", 80))
