"""Misc utilities (reference mmdet/utils/misc.py)."""
from __future__ import annotations

import glob
import os.path as osp
import warnings


def find_latest_checkpoint(path: str, suffix: str = "pth"):
    """Find the newest checkpoint in ``path`` (reference find_latest_checkpoint;
    here Orbax epoch_N directories are also understood)."""
    if path is None or not osp.exists(path):
        return None
    marker = osp.join(path, "checkpoints", "latest")
    if osp.exists(marker):
        with open(marker) as f:
            return osp.join(path, "checkpoints", f.read().strip())
    cands = glob.glob(osp.join(path, f"*.{suffix}")) + \
        glob.glob(osp.join(path, "checkpoints", "epoch_*"))
    if not cands:
        return None
    return max(cands, key=osp.getmtime)


def collect_env() -> dict:
    """Environment report (reference mmdet/utils/collect_env.py)."""
    import platform
    import sys
    info = {"sys.platform": sys.platform, "Python": sys.version.replace("\n", "")}
    try:
        import jax
        info["JAX"] = jax.__version__
        info["Devices"] = ", ".join(str(d) for d in jax.devices())
    except Exception as e:
        info["JAX"] = f"unavailable ({e})"
    for mod in ("optax", "numpy", "cv2"):
        try:
            m = __import__(mod)
            info[mod] = getattr(m, "__version__", "?")
        except ImportError:
            pass
    return info
