"""On-device OA-Mix tests: mask closed-form fidelity vs the reference's
cv2 quarter-res pipeline, random-box invariants, end-to-end output sanity."""
import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from oadg_tpu.ops.oamix_device import (_blurred_box_mask, _sample_random_boxes,
                                       oamix_batch)


def _reference_mask(box, h, w, spatial_ratio=4, sigma_ratio=0.3):
    """Reference OAMix._get_mask (oa_mix.py:74-93) replicated with cv2."""
    x1, y1, x2, y2 = (np.array(box) // spatial_ratio).astype(np.int32)
    mask = np.zeros((h // spatial_ratio, w // spatial_ratio, 3), np.float32)
    mask[y1:y2, x1:x2, :] = 1.0
    sigma_x = (x2 - x1) * sigma_ratio / 3 * 2
    sigma_y = (y2 - y1) * sigma_ratio / 3 * 2
    if not (sigma_x <= 0 or sigma_y <= 0):
        mask = cv2.GaussianBlur(mask, (0, 0), sigmaX=sigma_x, sigmaY=sigma_y)
    return cv2.resize(mask, (w, h))[..., 0]


@pytest.mark.parametrize("box", [(40, 32, 120, 96), (8, 8, 60, 40)])
def test_closed_form_mask_matches_reference_pipeline(box):
    h, w = 128, 160
    ref = _reference_mask(box, h, w)
    # full-res closed form: quarter-res box (floor-divided) scaled back up,
    # sigma = 4 * quarter-res sigma
    q = np.array(box) // 4
    box_full = q * 4
    ours = np.asarray(_blurred_box_mask(jnp.asarray(box_full, jnp.float32),
                                        h, w, 0.3))
    diff = np.abs(ours - ref)
    assert diff.mean() < 0.02, diff.mean()
    assert diff.max() < 0.25, diff.max()     # discrete vs continuous edges


def test_sample_random_boxes_invariants():
    key = jax.random.PRNGKey(0)
    shape = jnp.asarray([96.0, 128.0])
    for i in range(5):
        boxes, valid = _sample_random_boxes(
            jax.random.fold_in(key, i), shape, (0.01, 0.1), (3, 1 / 3), 2, 1, 3)
        boxes, valid = np.asarray(boxes), np.asarray(valid)
        assert valid.any()
        for bi in np.where(valid)[0]:
            x1, y1, x2, y2 = boxes[bi]
            assert 0 <= x1 < x2 <= 128 and 0 <= y1 < y2 <= 96
        if valid.all():     # no overlap between valid boxes
            a, b = boxes
            ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
            iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
            assert ix * iy <= 1e-6


def test_oamix_batch_end_to_end():
    rng = np.random.RandomState(0)
    b, h, w = 2, 96, 128
    img = rng.randint(0, 255, (b, h, w, 3)).astype(np.float32)
    gt = np.asarray([[[10, 10, 60, 50], [70, 20, 120, 90], [0, 0, 0, 0]]] * b,
                    np.float32)
    gtv = np.asarray([[True, True, False]] * b)
    shape = np.asarray([[h, w]] * b, np.float32)
    cfg = dict(version="augmix", num_views=2, severity=10, mixture_width=3,
               mixture_depth=-1, random_box_scale=(0.01, 0.1),
               random_box_ratio=(3, 1 / 3), oa_random_box_scale=(0.005, 0.1),
               oa_random_box_ratio=(3, 1 / 3), spatial_ratio=4,
               sigma_ratio=0.3)
    out = jax.jit(lambda *a: oamix_batch(*a, cfg))(
        jnp.asarray(img), jnp.asarray(gt), jnp.asarray(gtv),
        jnp.asarray(shape), jax.random.PRNGKey(7))
    aug = np.asarray(out["aug"])
    assert aug.shape == (b, 1, h, w, 3)
    assert aug.min() >= 0 and aug.max() <= 255
    assert np.isfinite(aug).all()
    # augmentation changed the image, but not unrecognizably
    delta = np.abs(aug[:, 0] - img).mean()
    assert 1.0 < delta < 120.0, delta
    ml, mlv = np.asarray(out["multilevel_boxes"]), np.asarray(out["multilevel_valid"])
    assert ml.shape == (b, 2, 4) and mlv.any()
    oa, oav = np.asarray(out["oamix_boxes"]), np.asarray(out["oamix_valid"])
    assert oa.shape == (b, 5, 4)
    # different keys give different augmentations
    out2 = jax.jit(lambda *a: oamix_batch(*a, cfg))(
        jnp.asarray(img), jnp.asarray(gt), jnp.asarray(gtv),
        jnp.asarray(shape), jax.random.PRNGKey(8))
    assert np.abs(np.asarray(out2["aug"]) - aug).mean() > 0.5


def test_oamix_host_oracle_runs():
    """The CPU oracle path (data/pipelines/oa_mix_host.py) produces the
    reference's field contract and sane outputs."""
    from oadg_tpu.data.pipelines.oa_mix import OAMix
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (96, 128, 3)).astype(np.uint8)
    gt = np.asarray([[10, 10, 60, 50], [70, 20, 120, 90]], np.float32)
    op = OAMix(version="augmix", num_views=2, keep_orig=True, severity=10,
               on_device=False)
    np.random.seed(0)
    results = op(dict(img=img, gt_bboxes=gt, img_fields=["img"]))
    assert "img2" in results and results["img2"].shape == img.shape
    assert results["img2"].dtype == np.uint8
    delta = np.abs(results["img2"].astype(int) - img.astype(int)).mean()
    assert 1.0 < delta < 120.0, delta
    np.testing.assert_array_equal(results["img"], img)   # keep_orig
    assert "multilevel_boxes" in results and "oamix_boxes" in results
    assert "gt_bboxes2" in results


def test_oamix_host_vs_device_statistics():
    """Distributional cross-check: host oracle and device kernels should
    perturb the image by comparable magnitudes (quantization-tolerance
    equivalence per the north star; exact RNG replay is impossible across
    numpy and counted PRNG streams)."""
    import jax
    from oadg_tpu.data.pipelines.oa_mix_host import oamix_host
    from oadg_tpu.ops.oamix_device import oamix_batch
    rng = np.random.RandomState(1)
    img = rng.randint(0, 255, (96, 128, 3)).astype(np.uint8)
    gt = np.asarray([[10, 10, 60, 50], [70, 20, 120, 90]], np.float32)
    cfg = dict(version="augmix", num_views=2, severity=10, mixture_width=3,
               spatial_ratio=4, sigma_ratio=0.3)
    np.random.seed(0)
    host_deltas = [np.abs(oamix_host(img, gt, cfg).astype(float)
                          - img).mean() for _ in range(4)]
    dev_deltas = []
    for s in range(4):
        out = oamix_batch(jnp.asarray(img[None].astype(np.float32)),
                          jnp.asarray(gt[None]), jnp.ones((1, 2), bool),
                          jnp.asarray([[96.0, 128.0]]),
                          jax.random.PRNGKey(s), cfg)
        dev_deltas.append(float(np.abs(
            np.asarray(out["aug"][0, 0]) - img.astype(np.float32)).mean()))
    h, d = np.mean(host_deltas), np.mean(dev_deltas)
    assert 0.3 < d / max(h, 1e-6) < 3.0, (h, d)


def test_oamix_many_instances_max_fg_cap():
    """Round-1 verdict: MAX_FG=16 was untested at the margins. With 24 gt
    boxes: (a) the pipeline stays valid; (b) boxes beyond the cap still
    receive the global (non-object-aware) mixing, so their pixels are
    augmented too; (c) raising cfg max_fg covers them object-aware."""
    rng = np.random.RandomState(3)
    b, h, w = 1, 96, 128
    img = rng.randint(0, 255, (b, h, w, 3)).astype(np.float32)
    # 24 small non-overlapping boxes in a 6x4 grid
    boxes = []
    for r in range(4):
        for c in range(6):
            x, y = 4 + 20 * c, 4 + 22 * r
            boxes.append([x, y, x + 14, y + 16])
    gt = np.asarray([boxes], np.float32)
    gtv = np.ones((b, 24), bool)
    shape = np.asarray([[h, w]] * b, np.float32)
    base_cfg = dict(version="augmix", num_views=2, severity=10,
                    mixture_width=3, mixture_depth=-1,
                    random_box_scale=(0.01, 0.1), random_box_ratio=(3, 1 / 3),
                    oa_random_box_scale=(0.005, 0.1),
                    oa_random_box_ratio=(3, 1 / 3), spatial_ratio=4,
                    sigma_ratio=0.3)
    out16 = jax.jit(lambda *a: oamix_batch(*a, base_cfg))(
        jnp.asarray(img), jnp.asarray(gt), jnp.asarray(gtv),
        jnp.asarray(shape), jax.random.PRNGKey(5))
    aug16 = np.asarray(out16["aug"])[0, 0]
    assert np.isfinite(aug16).all() and 0 <= aug16.min() and aug16.max() <= 255
    # pixels of boxes 16..23 (beyond the cap) must still be augmented by
    # the global mix
    tail_delta = []
    for x1, y1, x2, y2 in boxes[16:]:
        tail_delta.append(np.abs(aug16[y1:y2, x1:x2] -
                                 img[0, y1:y2, x1:x2]).mean())
    assert np.mean(tail_delta) > 1.0, tail_delta

    cfg32 = dict(base_cfg, max_fg=32)
    out32 = jax.jit(lambda *a: oamix_batch(*a, cfg32))(
        jnp.asarray(img), jnp.asarray(gt), jnp.asarray(gtv),
        jnp.asarray(shape), jax.random.PRNGKey(5))
    aug32 = np.asarray(out32["aug"])[0, 0]
    assert np.isfinite(aug32).all()
    # with the higher cap the same key produces a different augmentation
    # on the tail-box pixels (they now participate object-aware)
    diff = np.abs(aug32 - aug16).mean()
    assert diff > 0.1, diff


@pytest.mark.parametrize("n_valid", [5, 0])
def test_fg_maps_match_numpy(n_valid):
    """best_id / cover / union against a per-box numpy loop over the
    separable blurred masks; with no valid box every pixel takes the
    identity sentinel id G."""
    from oadg_tpu.ops.oamix_device import BID_EPS, fg_maps, fg_profiles
    h, w, g = 48, 80, 8
    rng = np.random.RandomState(n_valid)
    x1, y1 = rng.uniform(0, w * 0.7, g), rng.uniform(0, h * 0.7, g)
    boxes = np.stack([x1, y1, x1 + rng.uniform(4, w * 0.4, g),
                      y1 + rng.uniform(4, h * 0.4, g)], 1).astype(np.float32)
    valid = np.arange(g) < n_valid
    fx, fy = fg_profiles(jnp.asarray(boxes), jnp.asarray(valid), h, w, 0.3)
    best_id, cover, union = fg_maps(fx, fy)
    m = np.asarray(fy)[:, :, None] * np.asarray(fx)[:, None, :]  # (G, H, W)
    best = m.max(0)
    np.testing.assert_array_equal(
        np.asarray(best_id), np.where(best >= BID_EPS, m.argmax(0), g))
    np.testing.assert_allclose(np.asarray(cover, np.float32),
                               1.0 - np.prod(1.0 - m, 0), atol=2 ** -8)
    np.testing.assert_allclose(np.asarray(union, np.float32), best,
                               atol=2 ** -8)
    if n_valid == 0:
        assert np.all(np.asarray(best_id) == g)
