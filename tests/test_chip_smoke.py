"""chip_smoke.py off the card: it refuses a CPU-only run, its phase-1
comparisons run end to end on the CPU backend at a small size, and the
package it drives imports without OpenCV or Pillow."""
import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_cpu_only_run():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert res.returncode != 0
    assert "needs an NVIDIA GPU" in res.stderr
    last = (res.stdout.strip().splitlines() or [""])[-1]
    try:
        parsed = json.loads(last)
    except ValueError:
        parsed = None
    assert not (isinstance(parsed, dict) and parsed.get("ok")), res.stdout


def test_phase1_checks_run_on_cpu_backend():
    """The phase-1 comparisons (CPU against CPU here) at a small size:
    every check passes and reaches RoIAlign's backward."""
    sys.path.insert(0, REPO)
    import chip_smoke
    chip_smoke.check_ops(h=32, w=64, n_img=2, per_img=6, channels=8)


def test_import_without_cv2_and_pil():
    code = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("cv2", "PIL"):
                    raise ImportError(f"blocked {name}")

        sys.meta_path.insert(0, Block())
        import oadg_tpu
        from oadg_tpu.engine.train_step import make_train_step
        from oadg_tpu.engine.preprocess import make_oadg_preprocess
        from oadg_tpu.data.pipelines.albu import Blur
        op = Blur(blur_limit=3, p=1.0)
        try:
            op.apply(None)
        except ImportError as e:
            assert "cv2" in str(e)
        else:
            raise AssertionError("cv2-backed op ran without cv2")
        assert "cv2" not in sys.modules and "PIL" not in sys.modules
        print("ok")
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")


def test_train_and_test_phases_need_only_the_card_packages():
    """Phases 2 and 3 at a tiny width with flax, orbax, OpenCV and Pillow
    blocked: the GPU machine has none of them."""
    code = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("flax", "orbax", "cv2", "PIL"):
                    raise ImportError(f"blocked {name}")

        sys.meta_path.insert(0, Block())
        import chip_smoke
        chip_smoke.check_train_step(h=64, w=64, batch=1, steps=1, tiny=True)
        chip_smoke.check_test_path(h=64, w=64, n=1, tiny=True)
        print("ok")
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")


def test_data_parallel_phase_on_four_virtual_devices():
    """The --data-parallel phase at a tiny width on 4 of the virtual CPU
    devices: loss and parameter update agree with one device."""
    sys.path.insert(0, REPO)
    import chip_smoke
    chip_smoke.check_data_parallel(n=4, h=128, w=128, batch=4, tiny=True)
