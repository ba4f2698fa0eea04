"""Ahead-of-time model export (the analog of the reference's
tools/deployment/pytorch2onnx.py): serializes the jitted inference function
to StableHLO via jax.export, reloadable without the Python model code.
"""
import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))))


def main():
    p = argparse.ArgumentParser(description="export inference fn (StableHLO)")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--out", default="model_exported.bin")
    p.add_argument("--shape", type=int, nargs=2, default=[1024, 2048])
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    from jax import export as jexport
    from oadg_tpu.apis.inference import init_detector

    model = init_detector(args.config, args.checkpoint)
    h, w = args.shape
    batch = {"img": jnp.zeros((1, h, w, 3), jnp.float32),
             "img_shape": jnp.asarray([[float(h), float(w)]]),
             "scale_factor": jnp.ones((1, 4), jnp.float32)}

    def infer(b):
        return model.detector.apply(model.variables, b, "test")

    exported = jexport.export(jax.jit(infer))(batch)
    with open(args.out, "wb") as f:
        f.write(exported.serialize())
    print(f"wrote {args.out} ({osp.getsize(args.out)/1e6:.1f} MB) — reload "
          f"with jax.export.deserialize and .call()")


if __name__ == "__main__":
    main()
