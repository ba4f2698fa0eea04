"""Training mesh sizing (apis/train.py data_parallel_devices) on the
8 virtual CPU devices: every device takes samples_per_gpu images."""
import numpy as np
import pytest

import jax

from oadg_tpu.apis.train import data_parallel_devices
from oadg_tpu.parallel.mesh import make_mesh, shard_batch


def test_mesh_spans_every_device():
    n = jax.device_count()
    assert n == 8
    devices, local_batch = data_parallel_devices(2)
    assert devices == jax.devices()
    assert local_batch == 2 * n          # one process drives all devices
    mesh = make_mesh(n_data=len(devices), devices=devices)
    assert mesh.devices.size == n
    batch = shard_batch({"img": np.zeros((local_batch, 4, 4, 3),
                                         np.float32)}, mesh)
    shards = batch["img"].addressable_shards
    assert len(shards) == n and all(s.data.shape[0] == 2 for s in shards)


def test_gpu_ids_select_devices():
    devices, local_batch = data_parallel_devices(1, gpu_ids=[0, 1, 2, 3])
    assert devices == jax.devices()[:4]
    assert local_batch == 4


@pytest.mark.parametrize("bad", [0, -2])
def test_rejects_empty_per_device_batch(bad):
    with pytest.raises(ValueError, match="samples_per_gpu"):
        data_parallel_devices(bad)
