"""Training hooks (reference mmdet/core/hook/): the subset the OA-DG
configs exercise, on the runner's hook protocol.

The runner calls: before_run, before_train_epoch, after_train_iter(runner,
log_vars), after_train_epoch, after_run. ``runner`` exposes params,
batch_stats, opt_state, epoch, iter, logger.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...utils.registry import HOOKS


class Hook:
    def before_run(self, runner):
        pass

    def before_train_epoch(self, runner):
        pass

    def after_train_iter(self, runner, log_vars: Dict[str, float]):
        pass

    def after_train_epoch(self, runner):
        pass

    def after_val_epoch(self, runner, metrics: Dict[str, float]):
        pass

    def after_run(self, runner):
        pass


@HOOKS.register_module()
class CheckLossHook(Hook):
    """NaN/Inf loss guard (reference core/hook/checkloss_hook.py)."""

    def __init__(self, interval: int = 50, **kw):
        self.interval = interval

    def after_train_iter(self, runner, log_vars):
        if runner.iter % self.interval == 0:
            if not np.isfinite(log_vars.get("loss", 0.0)):
                raise FloatingPointError(
                    f"loss became {log_vars['loss']} at iter {runner.iter}")


# reference registers it as CheckInvalidLossHook in some configs
HOOKS.register_module(name="CheckInvalidLossHook", module=CheckLossHook)


@HOOKS.register_module()
class NumClassCheckHook(Hook):
    """Check head num_classes matches dataset CLASSES (reference
    mmdet/datasets/utils.py NumClassCheckHook)."""

    def before_run(self, runner):
        ds = getattr(runner.loader, "dataset", None)
        classes = getattr(ds, "CLASSES", None)
        if classes is None:
            return
        from ...engine.runner import _num_classes
        nc = _num_classes(runner.cfg)
        if nc != len(classes):
            runner.logger.warning(
                f"model num_classes={nc} != len(dataset.CLASSES)="
                f"{len(classes)}")


@HOOKS.register_module()
class EMAHook(Hook):
    """Exponential moving average of params (reference core/hook/ema.py:18).

    Lifecycle matches mmcv: the EMA copy updates every ``interval`` train
    iters; at ``after_train_epoch`` the EMA params are SWAPPED into the
    runner (so checkpointing and the per-epoch eval both see the averaged
    weights), and swapped back at ``before_train_epoch`` so training
    continues from the raw weights.
    """

    def __init__(self, momentum: float = 0.0002, interval: int = 1, **kw):
        self.momentum = momentum
        self.interval = interval
        self.ema_params = None
        self._swapped = False

    def _momentum_at(self, runner):
        return self.momentum

    def after_train_iter(self, runner, log_vars):
        if runner.iter % self.interval:
            return
        if self.ema_params is None:
            self.ema_params = jax.tree_util.tree_map(lambda x: x,
                                                     runner.params)
            return
        m = self._momentum_at(runner)
        self.ema_params = jax.tree_util.tree_map(
            lambda e, p: (1 - m) * e + m * p, self.ema_params, runner.params)

    def swap(self, runner):
        if self.ema_params is not None:
            runner.params, self.ema_params = self.ema_params, runner.params
            self._swapped = not self._swapped

    def after_train_epoch(self, runner):
        self.swap(runner)                   # eval/ckpt on EMA weights

    def before_train_epoch(self, runner):
        if self._swapped:
            self.swap(runner)               # train on raw weights

    def after_run(self, runner):
        if self._swapped:                   # leave EMA weights in place
            self._swapped = False


@HOOKS.register_module()
class ExpMomentumEMAHook(EMAHook):
    """EMA with exponentially decaying momentum (reference
    core/hook/ema.py:104, the YOLOX recipe):
    m_t = (1 - m) * exp(-(1 + t) / gamma) + m."""

    def __init__(self, momentum: float = 0.0002, gamma: int = 2000,
                 interval: int = 1, **kw):
        super().__init__(momentum=momentum, interval=interval)
        self.gamma = float(gamma)

    def _momentum_at(self, runner):
        import math
        t = runner.iter
        return ((1 - self.momentum) * math.exp(-(1 + t) / self.gamma)
                + self.momentum)


@HOOKS.register_module()
class LinearMomentumEMAHook(EMAHook):
    """EMA with linearly warmed momentum (reference core/hook/ema.py:130):
    m_t = min(m, (1 + t) / (gamma + t))."""

    def __init__(self, momentum: float = 0.0002, gamma: int = 100,
                 warm_up: int = 100, interval: int = 1, **kw):
        super().__init__(momentum=momentum, interval=interval)
        self.gamma = float(gamma)

    def _momentum_at(self, runner):
        t = runner.iter
        return min(self.momentum, (1 + t) / (self.gamma + t))


@HOOKS.register_module()
class YOLOXModeSwitchHook(Hook):
    """Reference core/hook/yolox_mode_switch_hook.py: for the final
    ``num_last_epochs`` epochs, strong augmentations (Mosaic/MixUp/
    RandomAffine) are skipped and the head's extra L1 loss turns on. Here
    the hook rebuilds the jitted train step once at the switch epoch
    (one extra compile) with ``bbox_head.use_l1=True``."""

    def __init__(self, num_last_epochs: int = 15,
                 skip_type_keys=("Mosaic", "RandomAffine", "MixUp"), **kw):
        self.num_last_epochs = num_last_epochs
        self.skip_type_keys = tuple(skip_type_keys)
        self._done = False

    def before_train_epoch(self, runner):
        if self._done or runner.epoch < runner.max_epochs - self.num_last_epochs:
            return
        self._done = True
        ds = getattr(runner.loader, "dataset", None)
        if hasattr(ds, "update_skip_type_keys"):
            ds.update_skip_type_keys(self.skip_type_keys)
        runner.logger.info(
            f"YOLOXModeSwitch: skipping {self.skip_type_keys}, adding L1")
        if hasattr(runner, "enable_head_l1"):
            runner.enable_head_l1()


@HOOKS.register_module()
class SyncRandomSizeHook(Hook):
    """Reference core/hook/sync_random_size_hook.py: periodically change
    the train input size, synchronized across ranks. Here:
    sizes come from a static list and all ranks derive the SAME choice
    from the epoch/iter counter (no broadcast needed — the schedule is
    deterministic); each new size compiles once and is then cached."""

    def __init__(self, ratio_range=(14, 26), img_scale=(640, 640),
                 interval: int = 10, **kw):
        self.ratio_range = tuple(ratio_range)
        self.img_scale = tuple(img_scale)
        self.interval = interval

    def after_train_iter(self, runner, log_vars):
        if runner.iter % self.interval:
            return
        lo, hi = self.ratio_range
        # deterministic across ranks: derived from the iteration counter
        rng = np.random.RandomState(runner.iter)
        r = int(rng.randint(lo, hi + 1))
        h = 32 * r
        w = 32 * int(r * self.img_scale[1] / self.img_scale[0])
        batcher = getattr(runner.loader, "batcher", None)
        if batcher is not None:
            batcher.static_hw = (h, w)


@HOOKS.register_module()
class SetEpochInfoHook(Hook):
    def before_train_epoch(self, runner):
        pass  # epoch is runner state; heads read it from the batch if needed


@HOOKS.register_module()
class SyncNormHook(Hook):
    """No-op: BN stats are frozen and params replicated by jit."""
    def __init__(self, **kw):
        pass


@HOOKS.register_module()
class FeatureHook(Hook):
    """Capture named intermediate activations (reference
    core/hook/feature_hook.py:4). Modules have no forward hooks; instead the
    detector is re-applied with ``capture_intermediates`` on demand."""

    def __init__(self, layer_list: Optional[List[str]] = None, **kw):
        self.layer_list = layer_list or []
        self.features: Dict[str, Any] = {}

    def capture(self, runner, batch):
        variables = {"params": runner.params}
        if runner.batch_stats is not None:
            variables["batch_stats"] = runner.batch_stats
        _, state = runner.det.apply(
            variables, batch, "test",
            capture_intermediates=lambda mdl, name: any(
                key in f"{mdl.name}" for key in self.layer_list),
            mutable=["intermediates"])
        self.features = state.get("intermediates", {})
        return self.features


@HOOKS.register_module()
class WandbLogger(Hook):
    """wandb experiment logging (reference core/hook/wandblogger_hook.py:17-678):
    train scalars + lr, config upload, checkpoint artifacts, captured
    feature maps, and a per-epoch evaluation table of predictions drawn
    as wandb box overlays. Degrades to a logged no-op when the wandb
    package is unavailable (tested against an injected fake module)."""

    def __init__(self, init_kwargs=None, interval: int = 50,
                 log_checkpoint: bool = False,
                 log_checkpoint_metadata: bool = False,
                 num_eval_images: int = 100, bbox_score_thr: float = 0.3,
                 **kw):
        self.interval = interval
        self.init_kwargs = init_kwargs or {}
        self.log_checkpoint = log_checkpoint
        self.log_checkpoint_metadata = log_checkpoint_metadata
        self.num_eval_images = num_eval_images
        self.bbox_score_thr = bbox_score_thr
        try:
            import wandb
            self.wandb = wandb
        except ImportError:
            self.wandb = None

    def before_run(self, runner):
        if not self.wandb:
            runner.logger.warning("wandb not available; WandbLogger is a no-op")
            return
        self.wandb.init(**self.init_kwargs)
        cfg = getattr(runner, "cfg", None)
        if cfg is not None:
            try:
                self.wandb.config.update(
                    {k: str(v) for k, v in dict(cfg).items()},
                    allow_val_change=True)
            except Exception:
                pass

    def after_train_iter(self, runner, log_vars):
        if self.wandb and runner.iter % self.interval == 0:
            out = {f"train/{k}": float(v) for k, v in dict(log_vars).items()}
            if hasattr(runner, "lr_fn"):
                out["learning_rate"] = float(runner.lr_fn(runner.iter))
            self.wandb.log(out, step=runner.iter)

    def after_train_epoch(self, runner):
        if not self.wandb:
            return
        # feature maps captured by a FeatureHook sibling (reference logs
        # model.features gathered by forward hooks)
        for h in getattr(runner, "hooks", []):
            feats = getattr(h, "features", None)
            if feats:
                for name, val in _flatten_tree(feats):
                    import numpy as _np
                    arr = _np.asarray(val)
                    self.wandb.log({f"features/{name}":
                                    self.wandb.Histogram(arr.ravel())},
                                   step=runner.iter)
        if self.log_checkpoint:
            path = runner.ckpt.latest_path()
            if path:
                art = self.wandb.Artifact(
                    f"checkpoint-{getattr(self.wandb.run, 'id', 'run')}",
                    type="model",
                    metadata=(dict(epoch=runner.epoch)
                              if self.log_checkpoint_metadata else None))
                art.add_dir(path)
                self.wandb.log_artifact(art)

    def after_val_epoch(self, runner, metrics):
        if not self.wandb:
            return
        self.wandb.log({f"val/{k}": v for k, v in metrics.items()
                        if isinstance(v, (int, float))}, step=runner.iter)
        results = getattr(runner, "last_val_results", None)
        ds = getattr(runner, "val_dataset", None)
        if not results or ds is None or not self.num_eval_images:
            return
        classes = list(getattr(ds, "CLASSES", []) or [])
        class_id_to_label = {i: c for i, c in enumerate(classes)}
        table = self.wandb.Table(columns=["image_name", "prediction"])
        import os.path as _osp

        import numpy as _np
        n = min(self.num_eval_images, len(results), len(ds))
        for i in range(n):
            info = ds.data_infos[i]
            path = _osp.join(getattr(ds, "img_prefix", ""),
                             info.get("filename", info.get("file_name", "")))
            box_data = []
            for cls_id, dets in enumerate(results[i]):
                for det in _np.asarray(dets):
                    if det[4] < self.bbox_score_thr:
                        continue
                    box_data.append(dict(
                        position=dict(minX=float(det[0]), minY=float(det[1]),
                                      maxX=float(det[2]), maxY=float(det[3])),
                        class_id=int(cls_id),
                        scores=dict(score=float(det[4])),
                        domain="pixel"))
            img = self.wandb.Image(
                path, boxes=dict(predictions=dict(
                    box_data=box_data, class_labels=class_id_to_label)))
            table.add_data(info.get("filename", str(i)), img)
        self.wandb.log({"eval/predictions": table}, step=runner.iter)

    def after_run(self, runner):
        if self.wandb:
            self.wandb.finish()


def _flatten_tree(tree, prefix=""):
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.extend(_flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    else:
        out.append((prefix, tree))
    return out


@HOOKS.register_module()
class WandbLoggerMulti(WandbLogger):
    """Multi-domain eval variant (reference wandblogger_multi_hook.py):
    per-domain val metrics get a domain-qualified prefix."""

    def after_val_epoch(self, runner, metrics):
        if not self.wandb:
            return
        domain = getattr(runner, "val_domain", None)
        if domain:
            metrics = {f"{domain}/{k}": v for k, v in metrics.items()}
        super().after_val_epoch(runner, metrics)


# mmcv-name compat: configs reference TextLoggerHook inside log_config; the
# runner implements text/json logging natively, so it is a registered no-op.
@HOOKS.register_module()
class TextLoggerHook(Hook):
    def __init__(self, **kw):
        pass


@HOOKS.register_module()
class ProfilerHook(Hook):
    """Capture a device trace for a window of training iterations
    (the analog of the reference's profile_time / benchmark utilities,
    mmdet/utils/profiling.py:11 — but a full XLA op trace, not wall-clock
    prints). View with tensorboard's profile
    plugin or summarize with tools/analysis_tools/parse_trace.py.

    cfg: dict(type='ProfilerHook', start_iter=10, num_iters=3,
              out_dir='/tmp/jaxprof')
    """

    def __init__(self, start_iter: int = 10, num_iters: int = 3,
                 out_dir: str = "/tmp/jaxprof", **kw):
        self.start_iter = start_iter
        self.num_iters = num_iters
        self.out_dir = out_dir
        self._active = False
        self._done = False

    def after_train_iter(self, runner, log_vars):
        import jax
        it = getattr(runner, "iter", 0)
        if self._done:
            return
        if not self._active and it >= self.start_iter:
            jax.profiler.start_trace(self.out_dir)
            self._active = True
            self._start = it
        elif self._active and it >= self._start + self.num_iters:
            jax.profiler.stop_trace()
            self._active = False
            self._done = True
