"""Prepare a trained checkpoint for publication (analog of
reference tools/model_converters/publish_model.py:17-34).

Reference behavior: load the .pth, delete the optimizer state, re-save,
and append the first 8 hex chars of the file's sha256 to the filename.
Here the checkpoint is an Orbax directory (engine/runner.py Checkpointer):
the optimizer state (``opt_state``) and any training-only bookkeeping are
dropped, the params(+batch_stats) tree is saved as a fresh Orbax
checkpoint, and the directory is renamed ``<out>-<sha8>``.

Usage:
    python tools/model_converters/publish_model.py work_dir/checkpoints/epoch_2 published/oadg_r50
"""
import argparse
import hashlib
import os
import os.path as osp
import shutil
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..", ".."))

TRAIN_ONLY_KEYS = ("opt_state", "optimizer", "lr", "step", "epoch", "rng")


def content_sha256(path: str) -> str:
    """Deterministic sha256 over every file in the checkpoint dir (sorted
    relative path + content), so the published hash identifies the weights
    like the reference's file-level sha256sum does for a .pth."""
    h = hashlib.sha256()
    if osp.isfile(path):
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()
    for root, _, files in sorted(os.walk(path)):
        for name in sorted(files):
            fp = osp.join(root, name)
            h.update(osp.relpath(fp, path).encode())
            with open(fp, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
    return h.hexdigest()


def process_checkpoint(in_path: str, out_path: str) -> str:
    from oadg_tpu.utils.checkpoint import orbax_restore
    import orbax.checkpoint as ocp

    state = orbax_restore(in_path)
    if not isinstance(state, dict):
        raise SystemExit(f"unsupported checkpoint structure in {in_path}")
    published = {k: v for k, v in state.items()
                 if k not in TRAIN_ONLY_KEYS and v is not None}
    out_path = osp.abspath(out_path)
    if osp.exists(out_path):
        shutil.rmtree(out_path)
    ocp.PyTreeCheckpointer().save(out_path, published, force=True)
    sha = content_sha256(out_path)
    final = f"{out_path}-{sha[:8]}"
    if osp.exists(final):
        shutil.rmtree(final)
    os.rename(out_path, final)
    return final


def main():
    ap = argparse.ArgumentParser(
        description="Process a checkpoint to be published")
    ap.add_argument("in_file", help="input Orbax checkpoint dir")
    ap.add_argument("out_file", help="output checkpoint dir (hash appended)")
    args = ap.parse_args()
    final = process_checkpoint(args.in_file, args.out_file)
    print(f"published: {final}")


if __name__ == "__main__":
    main()
