"""Checkpoint IO: Orbax trees + torch .pth conversion.

The reference initializes from published torch checkpoints
(``load_from = .../faster_rcnn_r50_fpn_1x_coco...pth``, reference
configs/OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py:57).
``convert_torch_state_dict`` maps an mmdet FasterRCNN state_dict onto this
framework's parameter tree:

- conv ``weight`` OIHW -> HWIO kernels; linear ``weight`` (out,in) -> (in,out);
- BN weight/bias -> FrozenBN scale/bias (params), running stats ->
  batch_stats;
- the first RoI shared FC's input is reordered CHW -> HWC to match NHWC
  RoIAlign output flattening;
- name scheme: backbone.layerI.J.* -> backbone_m/layerI_J/*, fpn
  lateral_convs.N -> neck_m/lateral_N, etc.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np


def _copy_dicts(tree):
    """Copy the dict structure of ``tree``, sharing its leaves."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def to_state_dict(tree):
    """``tree`` as nested dicts that a checkpoint stores losslessly: lists
    and tuples become ``{"0": ..., "1": ...}``, NamedTuples (optax states)
    ``{field: ...}``; :func:`from_state_dict` inverts it with a template."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: to_state_dict(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def from_state_dict(template, state):
    """Rebuild the containers of ``template`` around the leaves of
    ``state`` (the output of :func:`to_state_dict`)."""
    if isinstance(template, dict):
        return {k: from_state_dict(v, state[str(k)])
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(**{f: from_state_dict(getattr(template, f),
                                                    state[f])
                                 for f in template._fields})
    if isinstance(template, (list, tuple)):
        return type(template)(from_state_dict(v, state[str(i)])
                              for i, v in enumerate(template))
    return state


def _set(tree: Dict, path, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))          # OIHW -> HWIO


def convert_torch_state_dict(sd: Dict[str, "np.ndarray"],
                             roi_feat_size: int = 7,
                             roi_channels: int = 256) -> Dict[str, Dict]:
    """mmdet FasterRCNN/R-CNN torch state_dict -> {params, batch_stats}."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def to_np(v):
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                          else v)

    bn_map = {}   # torch bn prefix -> (module path tuple)

    for key, val in sd.items():
        v = to_np(val)
        parts = key.split(".")
        # ---- backbone ----
        if parts[0] == "backbone":
            if parts[1] == "conv1":
                _set(params, ("backbone_m", "conv1", "Conv_0", "kernel"),
                     _conv_kernel(v))
            elif parts[1] == "bn1":
                _bn(params, stats, ("backbone_m", "FrozenBN_0"), parts[2], v)
            elif parts[1].startswith("layer"):
                li = parts[1][5:]
                bj = parts[2]
                mod = f"layer{li}_{bj}"
                sub = parts[3]
                if sub.startswith("conv"):
                    _set(params, ("backbone_m", mod, sub, "Conv_0", "kernel"),
                         _conv_kernel(v))
                elif sub.startswith("bn"):
                    k = int(sub[2:]) - 1
                    _bn(params, stats, ("backbone_m", mod, f"FrozenBN_{k}"),
                        parts[4], v)
                elif sub == "downsample":
                    if parts[4] == "0":      # conv
                        _set(params, ("backbone_m", mod, "downsample_conv",
                                      "Conv_0", "kernel"), _conv_kernel(v))
                    else:                    # bn
                        _bn(params, stats,
                            ("backbone_m", mod, "downsample_bn"), parts[5], v)
        # ---- neck (FPN) ----
        elif parts[0] == "neck":
            m = re.match(r"(lateral_convs|fpn_convs)", parts[1])
            if m:
                idx = parts[2]
                name = ("lateral_" if parts[1] == "lateral_convs"
                        else "fpn_conv_") + idx
                leaf = "kernel" if parts[-1] == "weight" else "bias"
                w = _conv_kernel(v) if parts[-1] == "weight" else v
                _set(params, ("neck_m", name, "Conv_0", leaf), w)
        # ---- rpn ----
        elif parts[0] == "rpn_head":
            name = parts[1]
            leaf = "kernel" if parts[-1] == "weight" else "bias"
            w = _conv_kernel(v) if parts[-1] == "weight" else v
            _set(params, ("rpn", name, "Conv_0", leaf), w)
        # ---- roi head ----
        elif parts[0] == "roi_head" and parts[1] == "bbox_head":
            sub = parts[2]
            leaf = "kernel" if parts[-1] == "weight" else "bias"
            if sub == "shared_fcs":
                idx = int(parts[3])
                if leaf == "kernel":
                    if idx == 0:
                        o, i = v.shape
                        ch = (i // (roi_feat_size * roi_feat_size)
                              if i % (roi_feat_size * roi_feat_size) == 0
                              else roi_channels)
                        v = (v.reshape(o, ch, roi_feat_size, roi_feat_size)
                             .transpose(0, 2, 3, 1).reshape(o, i))
                    v = v.T
                _set(params, ("roi", "head", f"shared_fc{idx}", leaf), v)
            elif sub in ("fc_cls", "fc_reg"):
                if leaf == "kernel":
                    v = v.T
                _set(params, ("roi", "head", sub, leaf), v)
            elif sub == "fc_cont":
                idx = int(parts[3])
                if leaf == "kernel":
                    v = v.T
                _set(params, ("roi", "head", f"fc_cont{idx}", leaf), v)
    return {"params": params, "batch_stats": stats}


def _bn(params, stats, path: Tuple[str, ...], leaf: str, v):
    if leaf == "weight":
        _set(params, path + ("scale",), v)
    elif leaf == "bias":
        _set(params, path + ("bias",), v)
    elif leaf == "running_mean":
        _set(stats, path + ("mean",), v)
    elif leaf == "running_var":
        _set(stats, path + ("var",), v)


def merge_variables(init_variables: Dict, loaded: Dict,
                    logger=None) -> Dict:
    """Graft loaded leaves onto the init tree (load_from semantics:
    missing keys keep init values, unexpected keys warn)."""
    import jax

    out = jax.tree_util.tree_map(lambda x: x, init_variables)   # copy
    stats = dict(loaded_used=0, mismatched=0)

    def walk(dst, src, path=""):
        for k, v in src.items():
            if isinstance(v, dict):
                if k in dst and isinstance(dst[k], dict):
                    walk(dst[k], v, f"{path}/{k}")
                elif logger:
                    logger.warning(f"unexpected checkpoint scope {path}/{k}")
            else:
                if k in dst and tuple(np.shape(dst[k])) == tuple(np.shape(v)):
                    dst[k] = np.asarray(v, dtype=np.asarray(dst[k]).dtype)
                    stats["loaded_used"] += 1
                else:
                    stats["mismatched"] += 1
                    if logger:
                        logger.warning(
                            f"shape mismatch or missing at {path}/{k}: "
                            f"ckpt {np.shape(v)}")

    mutable = _copy_dicts(out)
    for col in ("params", "batch_stats"):
        if col in loaded and col in mutable:
            walk(mutable[col], loaded[col], col)
    if logger:
        logger.info(f"checkpoint merge: {stats}")
    return mutable


# ---------------------------------------------------------------------------
# Torch-free .pth reader.
#
# torch>=1.6 checkpoints (all published mmdet/OA-DG .pth files) are zip
# archives: ``<name>/data.pkl`` pickles the object tree, with each tensor
# serialized as a persistent-id reference ('storage', StorageType, key,
# location, numel) to a raw little-endian buffer at ``<name>/data/<key>``,
# rebuilt by ``torch._utils._rebuild_tensor_v2(storage, offset, size,
# stride, ...)``.  We replay that protocol with zipfile + a restricted
# pickle.Unpickler — no torch import — so the published-checkpoint path
# (reference mmdet/apis/inference.py:17-89 init_detector-from-.pth) works
# in torch-less environments.
# ---------------------------------------------------------------------------

_STORAGE_DTYPES = {
    "FloatStorage": np.dtype("<f4"), "DoubleStorage": np.dtype("<f8"),
    "HalfStorage": np.dtype("<f2"), "LongStorage": np.dtype("<i8"),
    "IntStorage": np.dtype("<i4"), "ShortStorage": np.dtype("<i2"),
    "CharStorage": np.dtype("i1"), "ByteStorage": np.dtype("u1"),
    "BoolStorage": np.dtype("?"),
    # bf16 has no numpy dtype: read raw u2, convert in _rebuild
    "BFloat16Storage": np.dtype("<u2"),
}


class _StorageRef:
    __slots__ = ("dtype_name", "array")

    def __init__(self, dtype_name: str, array: np.ndarray):
        self.dtype_name = dtype_name
        self.array = array


class _StorageType:
    """Stand-in for torch.FloatStorage & co. found inside the pickle."""

    def __init__(self, name: str):
        self.name = name


def _rebuild_tensor_v2(storage: _StorageRef, storage_offset, size, stride,
                       *unused) -> np.ndarray:
    a = storage.array
    itemsize = a.dtype.itemsize
    strides = tuple(int(s) * itemsize for s in stride)
    out = np.lib.stride_tricks.as_strided(
        a[int(storage_offset):], shape=tuple(int(s) for s in size),
        strides=strides).copy()
    if storage.dtype_name == "BFloat16Storage":
        out = (out.astype("<u4") << 16).view("<f4").astype(np.float32)
    return out


class _Opaque:
    """Placeholder for non-tensor classes in checkpoint metadata."""

    def __init__(self, *a, **k):
        self.args, self.kwargs = a, k

    def __setstate__(self, state):
        self.state = state


def _torch_free_unpickler(zf, pkl_file, data_prefix: str):
    import pickle

    class U(pickle.Unpickler):
        def find_class(self, module, name):
            if (module, name) == ("torch._utils", "_rebuild_tensor_v2"):
                return _rebuild_tensor_v2
            if module in ("torch", "torch.storage") and (
                    name in _STORAGE_DTYPES or name == "UntypedStorage"):
                return _StorageType(name)
            if module in ("collections", "builtins", "numpy",
                          "numpy.core.multiarray", "numpy._core.multiarray",
                          "_codecs"):
                return super().find_class(module, name)
            return _Opaque   # metadata classes we don't need

        def persistent_load(self, pid):
            kind, storage_type, key, _location, numel = pid[:5]
            assert kind == "storage", f"unknown persistent id {pid!r}"
            name = (storage_type.name
                    if isinstance(storage_type, _StorageType)
                    else str(storage_type))
            dtype = _STORAGE_DTYPES.get(name, np.dtype("<f4"))
            raw = zf.read(f"{data_prefix}/data/{key}")
            return _StorageRef(name, np.frombuffer(raw, dtype=dtype,
                                                   count=int(numel)))

    return U(pkl_file)


def load_torch_pth(path: str):
    """Read a torch-format .pth (zip) checkpoint without torch."""
    import io
    import zipfile
    with zipfile.ZipFile(path) as zf:
        pkl_names = [n for n in zf.namelist() if n.endswith("/data.pkl")]
        if not pkl_names:
            raise ValueError(
                f"{path} is not a torch>=1.6 zip checkpoint "
                "(legacy tar-format .pth is not supported torch-free)")
        prefix = pkl_names[0][:-len("/data.pkl")]
        with io.BytesIO(zf.read(pkl_names[0])) as f:
            return _torch_free_unpickler(zf, f, prefix).load()


def orbax_restore(path: str):
    """Restore an Orbax PyTree checkpoint as host numpy arrays.

    A plain ``restore(path)`` resolves shardings from the shard metadata
    written at save time, which fails across processes/topologies
    ("sharding ... Got None"); requesting ``np.ndarray`` leaves makes the
    checkpoint portable (the train step re-shards on device anyway).
    """
    import jax.tree_util as jtu
    import orbax.checkpoint as ocp
    ckptr = ocp.PyTreeCheckpointer()
    try:
        tree = ckptr.metadata(path).item_metadata.tree
        ra = jtu.tree_map(lambda m: ocp.RestoreArgs(restore_type=np.ndarray),
                          tree)
        return ckptr.restore(path, restore_args=ra)
    except (AttributeError, TypeError):     # older orbax metadata API
        return ckptr.restore(path)


def load_checkpoint_variables(path: str) -> Dict:
    """Load a checkpoint spec into a {params, batch_stats} tree.

    Accepts Orbax dirs, torch ``.pth`` files, http(s)/file URLs and
    mmcv-style ``open-mmlab://`` / ``torchvision://`` aliases (resolved
    and download-cached via utils/model_zoo.py — reference parity:
    mmcv load_checkpoint, used by e.g. the DWD flagship recipe's
    ``open-mmlab://detectron2/resnet101_caffe`` backbone init).

    Bare classification checkpoints (keys like ``conv1.weight``,
    ``layer1.0.*`` with no detector section prefix) are treated as
    backbone weights, matching mmcv's Pretrained-init semantics.
    """
    from .model_zoo import resolve_checkpoint
    path = resolve_checkpoint(path)
    if os.path.isdir(path):
        state = orbax_restore(path)
        return {"params": state["params"],
                "batch_stats": state.get("batch_stats")}
    ckpt = load_torch_pth(path)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    sections = ("backbone.", "neck.", "rpn_head.", "roi_head.",
                "bbox_head.", "mask_head.")
    if isinstance(sd, dict) and sd and not any(
            str(k).startswith(sections) for k in sd):
        sd = {f"backbone.{k}": v for k, v in sd.items()
              if not str(k).startswith(("fc.", "head."))}
    return convert_torch_state_dict(sd)
