"""The port's core API against the JAX package's, on the CPU, bit for bit.

* the four synthetic scenes (``utils/synthetic.py``): the same points and
  truth from the same seed and arguments;
* ``quantize_positions`` and ``dedup_quantized`` (``core/quantize.py``):
  exact integer results, including which duplicate survives;
* ``PointBatch`` (``core/pointset.py``): ``from_numpy``,
  ``from_host_cloud``, ``count``, ``has_colors``, ``with_*``, ``gather``,
  ``dedup_quantized`` and ``to_numpy`` give JAX's arrays, dtypes and
  shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.core.pointset import PointBatch as JaxPointBatch
from buildingsegment_tpu.core.quantize import (
    dedup_quantized as jax_dedup,
    quantize_positions as jax_quantize,
)
from buildingsegment_tpu.io.ply import HostPointCloud as JaxHostPointCloud
from buildingsegment_tpu.utils import synthetic as jax_synthetic
from buildingsegment_tpu_torch.core.pointset import PointBatch
from buildingsegment_tpu_torch.core.quantize import (
    dedup_quantized,
    quantize_positions,
)
from buildingsegment_tpu_torch.io.ply import HostPointCloud
from buildingsegment_tpu_torch.utils import synthetic


@pytest.mark.parametrize("name,kw", [
    ("make_building_cloud", dict(seed=3, spacing_mm=300.0)),
    ("make_building_cloud", dict(seed=1, spacing_mm=250.0, ground=False,
                                 clutter=200)),
    ("make_cylinder_cloud", dict(seed=2, spacing_mm=120.0)),
    ("make_cylinder_cloud", dict(seed=5, spacing_mm=150.0, ground=False)),
    ("make_terrain_cloud", dict(seed=3, extent_mm=6_000.0, spacing_mm=100.0,
                                slope=0.15)),
    ("make_terrain_cloud", dict(seed=3, extent_mm=6_000.0, spacing_mm=100.0,
                                roll_amp_mm=400.0, roll_period_mm=4_000.0)),
    ("make_block_cloud", dict(seed=4, nx=2, ny=1, spacing_mm=300.0)),
    ("make_block_cloud", dict(seed=4, nx=2, ny=2, spacing_mm=400.0,
                              clutter_frac=0.1)),
], ids=lambda v: v if isinstance(v, str) else None)
def test_scene_bit_for_bit(name, kw):
    pts_a, truth_a = getattr(jax_synthetic, name)(**kw)
    pts_b, truth_b = getattr(synthetic, name)(**kw)
    assert pts_b.dtype == pts_a.dtype and truth_b.dtype == truth_a.dtype
    np.testing.assert_array_equal(pts_b, pts_a)
    np.testing.assert_array_equal(truth_b, truth_a)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantize_positions_exact(rng, dtype):
    raw = rng.uniform(-120.0, 120.0, size=(4000, 3)).astype(dtype)
    raw[:8] = [[0.0005, -0.0005, 1.9999], [-1.0, 1.0, 0.0]] * 4
    # JAX without x64 sees float32 either way
    want = np.asarray(jax_quantize(jnp.asarray(raw), 1000.0))
    got = quantize_positions(torch.from_numpy(raw.astype(np.float32)),
                             1000.0).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if dtype == np.float64:  # the port scales float64 in float64
        np.testing.assert_array_equal(
            quantize_positions(torch.from_numpy(raw), 1000.0).numpy(),
            np.trunc(raw * 1000.0).astype(np.int32))


def _dup_cloud(rng, n=3000, far=False):
    """Positions with many exact and low-bit duplicates, in random order;
    ``far`` adds coordinates above 2^20 (they alias in the key)."""
    base = rng.integers(0, 5000, size=(n // 3, 3)).astype(np.int32)
    pos = np.concatenate([base, base + rng.integers(0, 4, size=base.shape),
                          base[rng.permutation(len(base))]])
    if far:
        pos[::7] += np.int32(1 << 20)
    pos = pos[rng.permutation(len(pos))]
    mask = rng.random(len(pos)) > 0.1
    return pos.astype(np.int32), mask


@pytest.mark.parametrize("drop_bits", [0, 1, 3])
@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
def test_dedup_quantized_exact(rng, drop_bits, far):
    pos, mask = _dup_cloud(rng, far=far)
    want = np.asarray(jax_dedup(jnp.asarray(pos), jnp.asarray(mask),
                                drop_bits))
    got = dedup_quantized(torch.from_numpy(pos), torch.from_numpy(mask),
                          drop_bits).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < mask.sum()


def _host_cloud(rng, cls, n=500):
    return cls(
        positions=rng.integers(0, 3000, size=(n, 3)).astype(np.int32),
        colors=rng.integers(0, 256, size=(n, 3)).astype(np.uint16),
        reflectances=rng.integers(0, 1000, size=n).astype(np.uint16),
        frame_idx=rng.integers(0, 7, size=n).astype(np.uint8),
        laser_angles=rng.integers(-90, 90, size=n).astype(np.int32),
    )


def _assert_batch_equal(b, a):
    for name in ("positions", "mask", "colors", "plane_idx", "reflectances",
                 "frame_idx", "laser_angles"):
        va, vb = getattr(a, name), getattr(b, name)
        if va is None:
            assert vb is None, name
            continue
        va = np.asarray(va)
        vb = vb.numpy()
        assert vb.dtype == va.dtype and vb.shape == va.shape, name
        np.testing.assert_array_equal(vb, va, err_msg=name)


def test_pointbatch_methods_match_jax(rng):
    host = _host_cloud(rng, HostPointCloud)
    jhost = JaxHostPointCloud(**{k: getattr(host, k) for k in (
        "positions", "colors", "reflectances", "frame_idx",
        "laser_angles")})
    a = JaxPointBatch.from_host_cloud(jhost, capacity=640)
    b = PointBatch.from_host_cloud(host, capacity=640, device="cpu")
    _assert_batch_equal(b, a)
    assert int(b.count) == int(a.count) == 500
    assert b.has_colors() and a.has_colors() and b.capacity == 640

    order = rng.permutation(640).astype(np.int32)
    _assert_batch_equal(b.gather(torch.from_numpy(order).long()),
                        a.gather(jnp.asarray(order)))
    labels = rng.integers(-1, 9, size=640).astype(np.int32)
    _assert_batch_equal(b.with_plane_idx(torch.from_numpy(labels)),
                        a.with_plane_idx(jnp.asarray(labels)))
    shifted = np.asarray(a.positions) + 7
    _assert_batch_equal(b.with_positions(torch.from_numpy(shifted)),
                        a.with_positions(jnp.asarray(shifted)))
    cols = np.asarray(a.colors)[::-1].copy()
    _assert_batch_equal(b.with_colors(torch.from_numpy(cols)),
                        a.with_colors(jnp.asarray(cols)))

    ta, tb = a.to_numpy(), b.to_numpy()
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert tb[k].dtype == ta[k].dtype, k
        np.testing.assert_array_equal(tb[k], ta[k], err_msg=k)

    plain_a = JaxPointBatch.from_numpy(host.positions)
    plain_b = PointBatch.from_numpy(host.positions, device="cpu")
    _assert_batch_equal(plain_b, plain_a)
    assert not plain_b.has_colors()


@pytest.mark.parametrize("bits", [0, 2, 4])
def test_pointbatch_dedup_matches_jax(rng, bits):
    pos, _mask = _dup_cloud(rng, n=900)
    a = JaxPointBatch.from_numpy(pos, capacity=1024).dedup_quantized(bits)
    b = PointBatch.from_numpy(pos, capacity=1024,
                              device="cpu").dedup_quantized(bits)
    _assert_batch_equal(b, a)
    assert int(b.count) == int(a.count) < len(pos)


def test_pointbatch_upload_pads():
    pts = np.arange(30, dtype=np.int32).reshape(10, 3)
    b = PointBatch.upload(pts, capacity=16, device="cpu")
    assert b.positions.dtype == torch.int32 and b.capacity == 16
    assert int(b.count) == 10 and b.plane_idx is None
    assert bool((b.positions[10:] == 2**24).all())
    with pytest.raises(ValueError, match="capacity 8 < point count 10"):
        PointBatch.from_numpy(pts, capacity=8, device="cpu")
