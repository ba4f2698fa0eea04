"""Registry / build_from_cfg — the config-driven plugin system.

The reference expresses every component as a registry entry built from a nested
config dict (mmcv ``Registry`` + ``build_from_cfg``; see reference
mmdet/datasets/builder.py:27 and mmdet/models/builder.py). We keep the same
contract — ``dict(type='Name', **kwargs)`` — so OA-DG configs run unchanged,
but the implementation is a small self-contained registry with no torch/mmcv
dependency.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A string -> class/function map with decorator-based registration."""

    def __init__(self, name: str, parent: Optional["Registry"] = None):
        self._name = name
        self._module_dict: Dict[str, Any] = {}
        self._parent = parent
        self._children: Dict[str, "Registry"] = {}
        if parent is not None:
            parent._children[name] = self

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def __len__(self):
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def __repr__(self):
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    def get(self, key: str):
        """Look up ``key`` here, then in parent registries."""
        if key in self._module_dict:
            return self._module_dict[key]
        if self._parent is not None:
            return self._parent.get(key)
        return None

    def _register(self, cls, name=None, force=False):
        if name is None:
            names = [cls.__name__]
        elif isinstance(name, str):
            names = [name]
        else:
            names = list(name)
        for n in names:
            if not force and n in self._module_dict:
                raise KeyError(f"{n} is already registered in {self._name}")
            self._module_dict[n] = cls
        return cls

    def register_module(self, name=None, force=False, module=None):
        """Use as ``@REG.register_module()`` or ``REG.register_module(module=C)``."""
        if module is not None:
            return self._register(module, name=name, force=force)

        def _decorator(cls):
            return self._register(cls, name=name, force=force)

        return _decorator


def build_from_cfg(cfg: dict, registry: Registry, default_args: Optional[dict] = None):
    """Instantiate ``registry[cfg['type']](**cfg_without_type, **default_args)``.

    Mirrors mmcv.build_from_cfg semantics: ``cfg`` keys override
    ``default_args`` keys; ``type`` may also be a class directly.
    """
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with 'type', got {cfg!r}")
    args = dict(cfg)
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not in the {registry.name} registry")
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be str or class, got {type(obj_type)}")
    args = _filter_module_kwargs(obj_cls, args)
    try:
        return obj_cls(**args)
    except Exception as e:  # augment the error with context
        raise type(e)(f"{obj_cls.__name__}: {e}") from e


_warned_dropped = set()

# Keys the REFERENCE itself deprecates/ignores — dropping them is expected
# behavior, not a gap, so no warning (e.g. contrastive_head.py marks
# out_dim_cont deprecated; it appears in the flagship OA-DG config).
# train_cfg/test_cfg/num_views/dtype are injected by the detector builders
# into EVERY submodule; modules that don't consume them (EmbeddingRPNHead,
# ...) drop them silently too — they are infrastructure, not user config.
_SILENT_DROP = {"out_dim_cont", "init_cfg", "pretrained",
                "train_cfg", "test_cfg", "num_views", "dtype"}


def _filter_module_kwargs(obj_cls, args: dict) -> dict:
    """Drop config keys a module doesn't declare.

    The mmdet config schema carries many implementation knobs (init_cfg,
    with_avg_pool, out_dim_cont, ...) that the reference's torch classes
    accept via **kwargs. Modules are dataclasses, so unknown
    keys are filtered here — once per (class, key) with a warning — instead
    of breaking config compatibility.
    """
    try:
        import dataclasses
        from .. import nn
    except Exception:
        return args
    if not (inspect.isclass(obj_cls) and issubclass(obj_cls, nn.Module)):
        return args
    fields = {f.name for f in dataclasses.fields(obj_cls)}
    out = {}
    for k, v in args.items():
        if k in fields:
            out[k] = v
        elif k not in _SILENT_DROP and (obj_cls.__name__,
                                        k) not in _warned_dropped:
            _warned_dropped.add((obj_cls.__name__, k))
            import warnings
            warnings.warn(f"{obj_cls.__name__}: dropping config key {k!r} "
                          f"(not implemented by this module)")
    return out


# Global registries, mirroring the reference's set
# (mmdet/models/builder.py, mmdet/datasets/builder.py).
MODELS = Registry("models")
BACKBONES = Registry("backbones", parent=MODELS)
NECKS = Registry("necks", parent=MODELS)
HEADS = Registry("heads", parent=MODELS)
LOSSES = Registry("losses", parent=MODELS)
DETECTORS = Registry("detectors", parent=MODELS)
ROI_EXTRACTORS = Registry("roi_extractors", parent=MODELS)

DATASETS = Registry("datasets")
PIPELINES = Registry("pipelines")
HOOKS = Registry("hooks")
BBOX_ASSIGNERS = Registry("bbox_assigners")
BBOX_SAMPLERS = Registry("bbox_samplers")
BBOX_CODERS = Registry("bbox_coders")
PRIOR_GENERATORS = Registry("prior_generators")
IOU_CALCULATORS = Registry("iou_calculators")
