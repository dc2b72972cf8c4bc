"""The port's ``sharded_pipeline`` under the variant paths.

tests/test_torch_dist_pipeline.py's cloud and runs, under:

* the block-form ``mxu`` fields (kernels #15 and #16): world 1 and 2
  equal the port's one-device run bit for bit in ``plane_idx``,
  ``num_planes`` and ``plane_count``;
* the single-level fused path (``seg_group=1``): world 2 equals world 1
  bit for bit, plane table included (its seeds come from
  ``window_seeds``, as in JAX's sharded path, where the one-device path
  uses the kNN-graph rule; ROADMAP §C).
"""

import numpy as np
import pytest

from buildingsegment_tpu_torch.dist import ShardGroup, spawn
from test_torch_dist_pipeline import (  # noqa: F401 (the cloud fixture)
    CONFIGS, SPAWN_TIMEOUT_S, _one_device, _run, cloud, same_labels,
)

NAMES = ("mxu", "single_level")


@pytest.fixture(scope="module")
def runs(cloud):
    pos, mask, _ = cloud
    world1 = ShardGroup(None, 0, 1, "gloo", "cpu")
    return {
        1: _run(world1, pos, mask, NAMES),
        2: spawn(_run, 2, device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                 args=(pos, mask, NAMES))[0],
    }


@pytest.fixture(scope="module")
def one_device_mxu(cloud):
    pos, mask, _ = cloud
    return _one_device(pos, mask, CONFIGS["mxu"])


@pytest.mark.parametrize("world", (1, 2))
def test_mxu_sharded_equals_one_device(runs, one_device_mxu, world):
    same_labels(runs[world]["mxu"], one_device_mxu)


def test_single_level_world2_equals_world1(runs):
    a, b = runs[2]["single_level"], runs[1]["single_level"]
    same_labels(a, b)
    assert a["num_planes"] > 0
    np.testing.assert_array_equal(a["plane_normal"], b["plane_normal"])
