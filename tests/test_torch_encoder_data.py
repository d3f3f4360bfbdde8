"""The port's encoder datasets against the JAX package's on the same files:
the host loaders and the stacked datasets (``data/preprocess.py``), the
normalisation and collate (``data/modality.py``), and the device
transforms of ``train/encoders.py`` against the host loaders (as point
multisets) and against a numpy twin of the augmentation."""

import os

import numpy as np
import pytest
import torch

from batch3dmot_tpu import geometry as jgeo
from batch3dmot_tpu.data import modality as jmod
from batch3dmot_tpu.data import preprocess as jpre
from batch3dmot_tpu_torch.data import modality as tmod
from batch3dmot_tpu_torch.data import preprocess as tpre
from batch3dmot_tpu_torch.train import encoders as tenc

torch.set_num_threads(1)

CATEGORIES = ("vehicle.car", "human.pedestrian.adult", "vehicle.truck",
              "vehicle.bus.rigid", "vehicle.bicycle", "human.pedestrian.child")


def _write_clouds(tmp_path, rng, n, channels, counts, key):
    """n per-annotation .npy clouds [channels, count] and their entries;
    some fail the point-count or ego-radius filters."""
    entries = []
    for i in range(n):
        k = int(counts[i])
        tok = f"ann{i:03d}"
        np.save(tmp_path / f"{tok}.npy", rng.normal(size=(channels, k)).astype(np.float32))
        entries.append({
            "sample_annotation_token": tok,
            "category_name": CATEGORIES[i % len(CATEGORIES)],
            key: k,
            "ann_ego_radius": 60.0 if i % 9 == 4 else float(rng.uniform(2.0, 40.0)),
        })
    return entries


@pytest.fixture
def lidar_files(tmp_path):
    rng = np.random.default_rng(0)
    counts = rng.integers(3, 80, 24)
    counts[[1, 7]] = (100, 130)  # beyond Kcap = 4 x 16
    (tmp_path / "lidar").mkdir()
    return str(tmp_path / "lidar"), _write_clouds(tmp_path / "lidar", rng, 24, 4, counts,
                                                  "num_lidar_pts")


@pytest.fixture
def radar_files(tmp_path):
    rng = np.random.default_rng(1)
    counts = rng.integers(1, 40, 24)
    counts[[2, 5]] = (50, 70)  # beyond Kcap = 4 x 8
    (tmp_path / "radar").mkdir()
    return str(tmp_path / "radar"), _write_clouds(tmp_path / "radar", rng, 24, 18, counts,
                                                  "num_radar_pts")


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_modality_functions_match_jax():
    rng = np.random.default_rng(2)
    pc = rng.normal(size=(18, 30)).astype(np.float32)
    np.testing.assert_array_equal(tmod.reference_normalize(pc), jmod.reference_normalize(pc))
    np.testing.assert_array_equal(tmod.encoder_dataset_normalize(pc),
                                  jmod.encoder_dataset_normalize(pc))
    for k in (10, 16, 30):
        np.testing.assert_array_equal(
            tmod.collate_fixed_size(pc[:, :k], 16, 4, np.random.default_rng(3)),
            jmod.collate_fixed_size(pc[:, :k], 16, 4, np.random.default_rng(3)))


@pytest.mark.parametrize("augment", [False, True])
def test_lidar_batches_match_jax(lidar_files, augment):
    """The same seed gives the same batches, shuffled, subsampled and (with
    augment) rotated, exactly."""
    npy_dir, entries = lidar_files
    kw = dict(batch_size=4, min_pts=6, num_points=16, augment=augment)
    _assert_batches_equal(
        tpre.lidar_batches(npy_dir, entries, rng=np.random.default_rng(5), **kw),
        jpre.lidar_batches(npy_dir, entries, rng=np.random.default_rng(5), **kw))


def test_radar_batches_match_jax(radar_files):
    npy_dir, entries = radar_files
    kw = dict(batch_size=4, min_pts=2, num_points=8)
    _assert_batches_equal(
        tpre.radar_batches(npy_dir, entries, rng=np.random.default_rng(6), **kw),
        jpre.radar_batches(npy_dir, entries, rng=np.random.default_rng(6), **kw))


def test_materialized_datasets_match_jax(lidar_files, radar_files):
    """The stacked datasets, the clouds beyond Kcap subsampled once by the
    same seeded draw, exactly; the labels are the 0-indexed tracking
    classes."""
    for files, port, ref, kw in (
            (lidar_files, tpre.materialize_lidar_dataset, jpre.materialize_lidar_dataset,
             dict(min_pts=6, num_points=16)),
            (radar_files, tpre.materialize_radar_dataset, jpre.materialize_radar_dataset,
             dict(min_pts=2, num_points=8))):
        got = port(*files, rng=np.random.default_rng(7), **kw)
        want = ref(*files, rng=np.random.default_rng(7), **kw)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[1].max() == 4 * kw["num_points"]  # some clouds were capped
    assert [tpre._entry_label({"category_name": c}) for c in CATEGORIES] == [
        jpre._entry_label({"category_name": c}) for c in CATEGORIES]
    empty = tpre.materialize_lidar_dataset(lidar_files[0], [], num_points=16)
    assert [a.shape for a in empty] == [(0, 4, 64), (0,), (0,)]


def test_image_loaders_match_jax(tmp_path):
    """image_batches and materialize_image_dataset against the JAX package's
    on PNG camera images written with PIL: crops, colour enhancement and
    resize are PIL's, so the arrays are equal."""
    try:
        from PIL import Image
    except ImportError:
        pytest.skip("PIL is not installed: the image loaders decode with it")
    rng = np.random.default_rng(8)
    entries = []
    for i in range(6):
        name = f"cam{i}.png"
        Image.fromarray((rng.random((90, 160, 3)) * 255).astype(np.uint8)).save(tmp_path / name)
        x0, y0 = rng.uniform(0, 60), rng.uniform(0, 40)
        entries.append({"filename": name, "category_name": CATEGORIES[i],
                        "bbox_corners": [x0, y0, x0 + rng.uniform(10, 90),
                                         y0 + rng.uniform(10, 45)]})
    kw = dict(batch_size=2, res_size=32)
    _assert_batches_equal(
        tpre.image_batches(str(tmp_path), entries, rng=np.random.default_rng(9), **kw),
        jpre.image_batches(str(tmp_path), entries, rng=np.random.default_rng(9), **kw))
    got = tpre.materialize_image_dataset(str(tmp_path), entries)
    want = jpre.materialize_image_dataset(str(tmp_path), entries)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the device transform divides as the host loader does, bit for bit
    host = np.concatenate([x for x, _ in tpre.image_batches(
        str(tmp_path), entries, batch_size=6, shuffle=False)])
    dev, _ = tenc.image_transform()(None, (torch.from_numpy(got[0]), torch.from_numpy(got[1])),
                                    True)
    np.testing.assert_array_equal(dev.numpy(), host)


def _multisets_close(got, want):
    """Rows of got [P, C] and want [P, C] equal as multisets of points."""
    g = got[np.lexsort(got.T)]
    w = want[np.lexsort(want.T)]
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def _short_entries(tmp_path, rng, n, channels, key, lo, hi):
    counts = rng.integers(lo, hi, n)
    for i, k in enumerate(counts):
        np.save(tmp_path / f"s{i}.npy", rng.normal(size=(channels, k)).astype(np.float32))
    return [{"sample_annotation_token": f"s{i}", "category_name": "vehicle.car",
             key: int(k), "ann_ego_radius": 10.0} for i, k in enumerate(counts)]


@pytest.mark.parametrize("kind", ["lidar", "radar"])
def test_transform_matches_host_loader(tmp_path, kind):
    """The device transform (eval mode for LiDAR) over the stacked dataset
    equals the host loader's batch as a multiset of points per cloud
    (clouds shorter than num_points: no subsample)."""
    rng = np.random.default_rng(10)
    if kind == "lidar":
        entries = _short_entries(tmp_path, rng, 6, 4, "num_lidar_pts", 8, 16)
        host = list(tpre.lidar_batches(str(tmp_path), entries, 6, num_points=16,
                                       shuffle=False))
        ds = tpre.materialize_lidar_dataset(str(tmp_path), entries, num_points=16)
        transform = tenc.lidar_transform(num_points=16)
    else:
        entries = _short_entries(tmp_path, rng, 6, 18, "num_radar_pts", 3, 8)
        host = list(tpre.radar_batches(str(tmp_path), entries, 6, num_points=8,
                                       shuffle=False))
        ds = tpre.materialize_radar_dataset(str(tmp_path), entries, num_points=8)
        transform = tenc.radar_transform(num_points=8)
    (hx, hy), = host
    pts, labels = transform(torch.Generator().manual_seed(0),
                            tuple(torch.from_numpy(a) for a in ds), False)
    np.testing.assert_array_equal(labels.numpy(), hy)
    for i in range(len(hy)):
        _multisets_close(pts[i].numpy(), hx[i])


def test_lidar_augmentation_matches_numpy_twin():
    """Train mode: the output equals the host loader's rotation about the
    centroid (``geometry.quat_rotation_matrix(yaw_to_quat(yaw))``) and the
    normalisation, in numpy, fed the same yaw draws (from a clone of the
    transform's generator); max_yaw 0 gives the eval output."""
    rng = np.random.default_rng(11)
    clouds = rng.normal(size=(3, 4, 12)).astype(np.float32)
    counts = np.full(3, 12, np.int32)
    batch = (torch.from_numpy(clouds), torch.from_numpy(counts), torch.zeros(3, dtype=torch.int32))
    max_yaw = np.pi / 10
    gen = torch.Generator().manual_seed(4)
    state = gen.get_state()
    out, _ = tenc.lidar_transform(num_points=12, max_yaw=max_yaw)(gen, batch, True)
    yaws = tenc.draw_yaw(torch.Generator().set_state(state), 3, max_yaw, "cpu").numpy()
    for i in range(3):
        pc = clouds[i].copy()
        R = jgeo.quat_rotation_matrix(jgeo.yaw_to_quat(float(yaws[i])))
        centroid = pc[0:3].mean(axis=1, keepdims=True)
        pc[0:3] = R @ (pc[0:3] - centroid) + centroid
        want = jmod.reference_normalize(pc)[0:3].T
        g, w = out[i].numpy(), want
        np.testing.assert_allclose(g[np.lexsort(g.T)], w[np.lexsort(w.T)], rtol=1e-4, atol=1e-5)
    still, _ = tenc.lidar_transform(num_points=12, max_yaw=0.0)(
        torch.Generator().manual_seed(1), batch, True)
    plain, _ = tenc.lidar_transform(num_points=12)(torch.Generator().manual_seed(1), batch, False)
    for i in range(3):
        _multisets_close(still[i].numpy(), plain[i].numpy())


def test_collate_invariants():
    """Each collated cloud holds only its own valid columns, distinct ones
    when the cloud is longer than num_points, and zeros beyond its count;
    padded columns stay zero through the rotation about the centroid."""
    rng = np.random.default_rng(12)
    k, num_points = 40, 16
    counts = torch.tensor([5, 16, 17, 40], dtype=torch.int32)
    pts = torch.zeros(4, 3, k)
    for i, c in enumerate(counts.tolist()):
        pts[i, :, :c] = torch.from_numpy(rng.normal(size=(3, c)).astype(np.float32))
    out = tenc._collate(torch.Generator().manual_seed(0), pts, counts, num_points)
    assert out.shape == (4, 3, num_points)
    for i, c in enumerate(counts.tolist()):
        cols = {tuple(v) for v in pts[i, :, :c].T.tolist()}
        taken = [tuple(v) for v in out[i, :, :min(c, num_points)].T.tolist()]
        assert set(taken) <= cols and len(set(taken)) == len(taken) == min(c, num_points)
        assert bool((out[i, :, min(c, num_points):] == 0).all())
    rotated = tenc._rotate_about_centroid(torch.cat([pts, torch.ones(4, 1, k)], 1) * 1.0,
                                          counts, torch.full((4,), 0.3))
    for i, c in enumerate(counts.tolist()):
        assert bool((rotated[i, 0:3, c:] == 0).all())
    with pytest.raises(ValueError, match="num_points"):
        tenc._collate(None, pts[:, :, :8], counts, num_points)


def test_preprocess_module_needs_no_pil_to_import():
    """The module imports PIL inside the two image functions only."""
    src = open(os.path.join(os.path.dirname(tpre.__file__), "preprocess.py")).read()
    top = [line for line in src.splitlines() if line.startswith(("import ", "from "))]
    assert not any("PIL" in line for line in top)
