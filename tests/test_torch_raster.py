"""The port's raster path on the CPU against the JAX package.

Kernel #8's plain version (``plane_sums``) against JAX's Pallas kernel in
interpret mode (the JAX package's CPU default), and against #12
(``plane_sums_t``, the same function transposed): the count column is
exact, the other sums agree within rtol 1e-6 (the one-hot matmul and
the port's fixed block order add in different orders).  The ground
threshold is exact; the splat and the rasters agree within rtol 1e-5
(scatter-add order) at a power-of-two cell, and within an ulp-derived
bound at the production 100 mm cell (XLA rewrites JAX's division, see
``_ulp_bound``); the PNG normalization is byte-equal on equal
rasters; the rendered PNGs agree within 1 per pixel (a last-bit
difference can move a truncated channel by one); the contour overlays
and ``csa.obj`` are identical on the same input PNG.  The PNG codec and
the OBJ writer are byte-equal to the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.config import PipelineConfig as JaxPipelineConfig
from buildingsegment_tpu.io.obj import prism_obj_text as jax_prism_obj_text
from buildingsegment_tpu.io.png import read_png as jax_read_png
from buildingsegment_tpu.io.png import write_png as jax_write_png
from buildingsegment_tpu.io.ply import HostPointCloud as JaxHostPointCloud
from buildingsegment_tpu.ops.scatter import bilinear_splat as jax_splat
from buildingsegment_tpu.ops.segsum import plane_sums as jax_plane_sums
from buildingsegment_tpu.ops.segsum import plane_sums_t as jax_plane_sums_t
from buildingsegment_tpu.pipeline import PipelineOutput as JaxPipelineOutput
from buildingsegment_tpu.raster import contours as jax_contours
from buildingsegment_tpu.raster import ortho as jax_ortho
from buildingsegment_tpu_torch.config import PipelineConfig
from buildingsegment_tpu_torch.io.obj import prism_obj_text
from buildingsegment_tpu_torch.io.ply import HostPointCloud
from buildingsegment_tpu_torch.io.png import encode_png, read_png
from buildingsegment_tpu_torch.ops.scatter import bilinear_splat
from buildingsegment_tpu_torch.ops.segsum import (
    block_order_sums,
    plane_sums,
    plane_sums_reference,
)
from buildingsegment_tpu_torch.pipeline import PipelineOutput
from buildingsegment_tpu_torch.raster import contours, ortho
from buildingsegment_tpu_torch.utils import make_building_cloud

_PAD = 2**24


def _ids_payload(seed, n, cols, table_cap):
    """Ids over the whole table plus dead ones (negative, at the table
    edge), payload column 0 all ones (the count), the rest in [0, 1)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-3, table_cap + 2, n).astype(np.int32)
    ids[: n // 10] = table_cap  # the padding id of the JAX wrapper
    pay = rng.random((n, cols)).astype(np.float32)
    pay[:, 0] = 1.0
    return ids, pay


def _check_sums(got, want, live_rows):
    np.testing.assert_array_equal(got[:, 0], want[:, 0])  # exact counts
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert not got[live_rows:].any()


# n = 5,000 is neither a multiple of the port's 1,024-row blocks nor of
# the Pallas tile; n_live = 130 keeps two live 128-id chunks of three
@pytest.mark.parametrize("cols", [8, 1])
def test_plane_sums_matches_pallas(cols):
    n, cap, n_live = 5000, 300, 130
    ids, pay = _ids_payload(cols, n, cols, cap)
    want = np.asarray(jax_plane_sums(
        jnp.asarray(ids), jnp.asarray(pay), jnp.int32(n_live),
        table_cap=cap, cols=cols, interpret=True))
    got = plane_sums(torch.from_numpy(ids), torch.from_numpy(pay), n_live,
                     table_cap=cap)
    assert got.shape == want.shape == (384, cols)
    _check_sums(got.numpy(), want, 256)
    # the live bound: ids just above n_live inside the last live chunk
    # still count, the chunk above does not
    assert got[129:256, 0].sum() > 0 and not got[256:].any()


def test_plane_sums_transposed_form():
    """#12 (``plane_sums_t``, Pallas in interpret mode) is #8 transposed."""
    n, cap, n_live = 3000, 200, 200
    ids, pay = _ids_payload(12, n, 8, cap)
    want = np.asarray(jax_plane_sums_t(
        jnp.asarray(ids), jnp.asarray(pay.T.copy()), jnp.int32(n_live),
        table_cap=cap, interpret=True)).T
    got = plane_sums_reference(torch.from_numpy(ids), torch.from_numpy(pay),
                               n_live, table_cap=cap)
    _check_sums(got.numpy(), want, 256)


def _row_order_oracle(blk, ids, rows, nblk, size):
    """Each (block, id)'s rows added one after another in row order
    (``np.add.at`` is unbuffered and in index order), then the block
    tables added in block order, all in float32."""
    part = np.zeros((nblk, size, rows.shape[1]), np.float32)
    np.add.at(part, (blk, ids), rows)
    acc = np.zeros((size, rows.shape[1]), np.float32)
    for b in range(nblk):
        acc = acc + part[b]
    return acc


def test_block_order_sums_in_row_order():
    """The plain versions' fixed summation order holds on the CPU, with
    every intra-op thread busy: run to run and against the serial oracle,
    bit for bit (the CPU's accumulating ``index_put_`` adds in parallel
    and broke both)."""
    rng = np.random.default_rng(11)
    m, size = 300_000, 40
    rows = (rng.random((m, 4)) * 1e3).astype(np.float32)
    ids = rng.integers(0, size, m)
    blk = np.arange(m) // 1024
    nblk = int(blk[-1]) + 1
    want = _row_order_oracle(blk, ids, rows, nblk, size)
    for _ in range(3):
        got = block_order_sums(torch.from_numpy(blk), torch.from_numpy(ids),
                               torch.from_numpy(rows), nblk, size)
        np.testing.assert_array_equal(got.numpy(), want)


def test_plane_sums_no_live_id():
    ids = torch.full((10,), 5, dtype=torch.int32)
    out = plane_sums(ids, torch.ones(10, 2), 0, table_cap=64)
    assert out.shape == (128, 2) and not out.any()
    with pytest.raises(ValueError, match="1..128"):
        plane_sums(ids, torch.ones(10, 129), 5, table_cap=64)


def _z_positions(z):
    pos = np.zeros((len(z), 3), np.int32)
    pos[:, 2] = z
    return pos


def _reference_loop(z, mask, num_bins, bin_height=1000):
    """The reference's loop (TMC3.cpp:181-198) written out."""
    num = np.zeros(num_bins, int)
    for v in z[mask]:
        num[v // bin_height] += 1
    half = int(mask.sum()) // 2
    total = 0
    for i in range(num_bins):
        total += num[i]
        if total > half:
            return i * bin_height
    return num_bins * bin_height


@pytest.mark.parametrize("case", ["random", "masked", "none_above",
                                  "z_true"])
def test_ground_threshold_matches_jax(case, rng):
    n, extent, z_true = 500, 20_000, None
    z = rng.integers(0, extent, n)
    mask = np.ones(n, bool)
    if case == "masked":
        mask[rng.random(n) < 0.4] = False
        z[~mask] = _PAD  # padding rows: far away, masked out
    elif case == "none_above":
        mask[:] = False  # no point: the loop falls off the end
    elif case == "z_true":
        mask[:] = False  # falls off the end of a padded extent...
        z_true = 5_000   # ...capped at the true bin count
    pos = _z_positions(z)
    kw = dict(z_true=z_true)
    want = int(jax_ortho.ground_threshold(
        jnp.asarray(pos), jnp.asarray(mask), extent, **kw))
    got = ortho.ground_threshold(torch.from_numpy(pos),
                                 torch.from_numpy(mask), extent, **kw)
    assert got.dtype == torch.int32 and int(got) == want
    if z_true is None:
        assert want == _reference_loop(z, mask, extent // 1000 + 1)
    else:
        assert want == (z_true // 1000 + 1) * 1000


def _ulp_bound(extent, bin_size):
    """What XLA's rewrite of p / bin may move a weight by.  XLA on the CPU
    computes JAX's ``p / bin − cell`` as a reciprocal multiply fused with
    the subtraction, the port as an IEEE division and a subtraction: the
    fractional weights differ by up to an ulp of p / bin, four corners
    and two factors at most 4 ulps.  At a power-of-two bin every form is
    exact and the two packages agree to the scatter's order."""
    return 4 * float(np.spacing(np.float32(extent / bin_size)))


@pytest.mark.parametrize("bin_size", [128, 100])
def test_bilinear_splat_matches_jax(bin_size):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4000, (2000, 3)).astype(np.int32)
    mask = rng.random(2000) < 0.9
    th = 1500
    w = h = 4000 // bin_size + 2
    want = jax_splat(jnp.asarray(pos), jnp.asarray(mask), jnp.int32(th),
                     width=w, height=h, bin_size=bin_size)
    got = bilinear_splat(torch.from_numpy(pos), torch.from_numpy(mask),
                         torch.tensor(th, dtype=torch.int32), width=w,
                         height=h, bin_size=bin_size)
    tol = 0.0 if bin_size == 128 else _ulp_bound(4000, bin_size)
    # per cell a few points: density within a few weight errors, the
    # height sums within those times the largest z
    for g, e, atol in zip(got, want, (2 * tol, 2 * tol * 4000)):
        assert g.shape == (h, w)
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-5,
                                   atol=atol)


@pytest.mark.parametrize("bin_size", [128, 100])
def test_compute_ortho_images_matches_jax(bin_size):
    pts, _ = make_building_cloud(seed=3, spacing_mm=150.0, width_mm=5000.0,
                                 depth_mm=4000.0, wall_h_mm=3000.0,
                                 ridge_h_mm=4000.0)
    pos = (pts - pts.min(0)).astype(np.int32)
    ext = tuple(int(e) for e in pos.max(0))
    mask = np.ones(len(pos), bool)
    want = jax_ortho.compute_ortho_images(
        jnp.asarray(pos), jnp.asarray(mask), ext,
        JaxPipelineConfig(raster_bin=bin_size))
    got = ortho.compute_ortho_images(
        torch.from_numpy(pos), torch.from_numpy(mask), ext,
        PipelineConfig(raster_bin=bin_size))
    mean_h, logd = (np.asarray(x) for x in want[:2])
    assert (got[1] > 20).any() and not got[2].any()
    if bin_size == 128:
        for g, e in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-5)
        return
    # bin 100: log density within the weights' bound; the mean height is
    # a ratio of sums, so it is held where it is used, as PNG pixels
    np.testing.assert_allclose(got[1].numpy(), logd, rtol=1e-5,
                               atol=_ulp_bound(max(ext), bin_size))
    a = jax_ortho.normalize_to_png(mean_h, 0).astype(int)
    b = ortho.normalize_to_png(got[0].numpy(), 0).astype(int)
    assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("chan", [0, 1, 2])
def test_normalize_to_png_byte_equal(chan):
    raster = np.random.default_rng(chan).random((33, 47)).astype(np.float32)
    raster[raster < 0.3] = 0.0
    want = jax_ortho.normalize_to_png(raster, chan)
    got = ortho.normalize_to_png(raster, chan)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    assert not ortho.normalize_to_png(np.zeros((4, 4)), chan).any()


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """A small building rendered by both packages; the port reuses the
    padded positions as the pipeline leaves them on its device."""
    pts, _ = make_building_cloud(seed=4, spacing_mm=120.0, width_mm=6000.0,
                                 depth_mm=5000.0, wall_h_mm=3000.0,
                                 ridge_h_mm=4500.0)
    pos = (pts - pts.min(0)).astype(np.int32)
    n, cap = len(pos), len(pos) + 300
    dpos = np.full((cap, 3), _PAD, np.int32)
    dpos[:n] = pos
    dmask = np.arange(cap) < n
    table = dict(plane_idx=np.zeros(n, np.int32), num_planes=0,
                 plane_normals=np.zeros((0, 3), np.float32),
                 plane_centers=np.zeros((0, 3), np.float32),
                 plane_counts=np.zeros(0, np.int32),
                 bbox_min=np.zeros(3, np.int32), timings={})
    root = tmp_path_factory.mktemp("render")
    jax_out = JaxPipelineOutput(cloud=JaxHostPointCloud(positions=pos),
                                device_shifted=None, device_mask=None,
                                **table)
    torch_out = PipelineOutput(cloud=HostPointCloud(positions=pos),
                               device_shifted=torch.from_numpy(dpos),
                               device_mask=torch.from_numpy(dmask), **table)
    want = jax_ortho.render_ortho_views(jax_out, str(root / "jax"))
    got = ortho.render_ortho_views(torch_out, str(root / "torch"))
    return want, got, root


def test_render_ortho_views_matches_jax(rendered):
    want, got, _ = rendered
    assert sorted(got) == sorted(want) == sorted(
        [ortho.MEAN_HEIGHT_PNG, ortho.DENSITY_PNG, ortho.DENSITY_HEIGHT_PNG])
    for name in want:
        a = jax_read_png(want[name]).astype(int)
        b = read_png(got[name]).astype(int)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, name
    assert read_png(got[ortho.DENSITY_PNG])[:, :, 1].max() == 255
    assert not read_png(got[ortho.DENSITY_HEIGHT_PNG]).any()


def test_extracted_contour_matches_jax(rendered):
    want, _, root = rendered
    src = want[jax_ortho.DENSITY_PNG]
    outs = {}
    for name, fn in (("jax", jax_contours.extracted_contour),
                     ("torch", contours.extracted_contour)):
        d = root / f"contours_{name}"
        d.mkdir()
        fn(src, str(d / "c.png"), str(d / "f.png"), obj_path=str(d / "csa.obj"))
        outs[name] = d
    for f in ("c.png", "f.png", "csa.obj"):
        a = (outs["jax"] / f).read_bytes()
        assert a == (outs["torch"] / f).read_bytes(), f
    assert "\nf " in (outs["torch"] / "csa.obj").read_text()


@pytest.mark.parametrize("shape", [(17, 23, 3), (8, 9), (5, 6, 4)])
def test_png_codec_matches_jax(shape, tmp_path):
    img = np.random.default_rng(len(shape)).integers(
        0, 256, shape).astype(np.uint8)
    p = str(tmp_path / "a.png")
    jax_write_png(p, img)
    with open(p, "rb") as f:
        assert f.read() == encode_png(img)
    got = read_png(p)
    np.testing.assert_array_equal(got, jax_read_png(p))
    np.testing.assert_array_equal(got.reshape(img.shape), img)


def test_png_filtered_rows_decode(tmp_path):
    """A PNG whose rows use filters 1-4 (as other encoders write) decodes
    like the JAX package's reader."""
    import struct
    import zlib

    rng = np.random.default_rng(9)
    h, w, c = 5, 4, 3
    raw = bytearray()
    for y in range(h):  # arbitrary filtered bytes, one filter per row
        raw.append(y % 5)
        raw.extend(rng.integers(0, 256, w * c).astype(np.uint8).tobytes())

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))
    path = str(tmp_path / "filtered.png")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(read_png(path), jax_read_png(path))


def test_prism_obj_text_matches_jax():
    rng = np.random.default_rng(5)
    cs = [rng.integers(0, 300, (k, 2)).astype(np.int32) for k in (1, 4, 9)]
    assert prism_obj_text(cs, 320, 240) == jax_prism_obj_text(cs, 320, 240)
    assert (prism_obj_text(cs, 320, 240, height=2.5)
            == jax_prism_obj_text(cs, 320, 240, height=2.5))
