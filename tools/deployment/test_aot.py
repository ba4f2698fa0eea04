"""Evaluate an AOT-exported (StableHLO) model on a dataset — the
Analog of reference tools/deployment/test.py (which scores an
ONNX/TensorRT export with the same metrics as tools/test.py).

The export carries no Python model code: detections come from
``jax.export.deserialize(...).call`` on the serialized bytes written by
tools/deployment/export_aot.py, then flow through the normal evaluate
path, proving the artifact is self-contained.

Usage:
    python tools/deployment/test_aot.py CONFIG model_exported.bin --eval bbox
"""
import argparse
import os.path as osp
import pickle
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))))
sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__)))))

import numpy as np


def main():
    p = argparse.ArgumentParser(description="Test an exported model")
    p.add_argument("config")
    p.add_argument("model", help="serialized export from export_aot.py")
    p.add_argument("--out", help="output result pickle")
    p.add_argument("--eval", nargs="+", default=["bbox"])
    args = p.parse_args()

    import jax.numpy as jnp
    from jax import export as jexport
    from oadg_tpu.config import Config
    from test import build_test_loader       # tools/test.py

    with open(args.model, "rb") as f:
        exported = jexport.deserialize(bytearray(f.read()))
    in_shape = None
    for aval in exported.in_avals:
        d = getattr(aval, "shape", None)
        if d is not None and len(d) == 4:
            in_shape = d
    assert in_shape is not None, "export has no (N, H, W, 3) image input"

    cfg = Config.fromfile(args.config)
    dataset, loader = build_test_loader(cfg)
    results = []
    for batch in loader:
        img = np.asarray(batch["img"])
        n, h, w = img.shape[0], img.shape[1], img.shape[2]
        eh, ew = in_shape[1], in_shape[2]
        pad = np.zeros((n, eh, ew, 3), np.float32)
        pad[:, :min(h, eh), :min(w, ew)] = img[:, :eh, :ew]
        call_batch = {
            "img": jnp.asarray(pad),
            "img_shape": jnp.asarray(batch["img_shape"], jnp.float32),
            "scale_factor": jnp.asarray(batch.get(
                "scale_factor", np.ones((n, 4), np.float32))),
        }
        dets, labels, valid = exported.call(call_batch)
        from oadg_tpu.apis.test import dets_to_results
        results.extend(dets_to_results(dets, labels, valid,
                                       len(dataset.CLASSES)))

    results = results[:len(dataset)]
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
    metrics = dataset.evaluate(results, metric=args.eval)
    print(metrics)


if __name__ == "__main__":
    main()
