"""The port's volume IO, generators and host helpers against the JAX package's.

Exact: MGH/MGZ files written by one package and read by the other, preloaded
arrays through ``load_volfile`` and ``volgen``, ``scan_to_atlas`` with
segmentations, ``load_labels``, ``load_pheno_csv`` and
``affine_shift_to_matrix`` (the same float64 operations in the same order).
"""

import numpy as np
import pytest

from voxelmorph_tpu import generators as jgen
from voxelmorph_tpu.py import io as jio
from voxelmorph_tpu.py import utils as jutils
from voxelmorph_tpu_torch import generators as tgen
from voxelmorph_tpu_torch.py import io as tio
from voxelmorph_tpu_torch.py import utils as tutils


def _vol(seed, dtype):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(0, 50, size=(8, 8, 8)).astype(dtype)
    return rng.normal(size=(8, 8, 8)).astype(dtype)


@pytest.mark.parametrize("ext", [".mgz", ".mgh"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8, np.int16])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_mgh_round_trip_across_packages(tmp_path, ext, dtype, writer):
    """An 8^3 volume saved by one package's save_volfile (default LIA affine)
    reads back in the other's load_volfile to the same array, dtype and
    affine."""
    vol = _vol(3, dtype)
    path = str(tmp_path / f"v{ext}")
    save, load = ((jutils.save_volfile, tutils.load_volfile) if writer == "jax"
                  else (tutils.save_volfile, jutils.load_volfile))
    save(vol, path)
    got, affine = load(path, ret_affine=True)
    ref, ref_affine = (jutils if writer == "jax" else tutils).load_volfile(path, ret_affine=True)
    # both readers return the file's big-endian dtype
    assert got.dtype == ref.dtype and got.dtype.newbyteorder("=") == vol.dtype
    assert np.array_equal(got, vol) and np.array_equal(ref, vol)
    assert affine is not None and np.array_equal(affine, ref_affine)
    # the default affine is the NIfTI path's LIA, centred on the volume
    assert np.array_equal(np.round(affine[:3, :3]), [[-1, 0, 0], [0, 0, 1], [0, -1, 0]])


def test_mgh_4d_and_explicit_affine_equal_jax(tmp_path):
    """A 4-D MGH with an explicit affine: the port's writer produces the
    JAX writer's bytes, and its reader the JAX reader's array and affine."""
    rng = np.random.default_rng(4)
    vol = rng.normal(size=(6, 7, 5, 2)).astype(np.float32)
    affine = np.array([[0.9, 0.1, 0, -3], [0, 1.2, 0.2, 4], [0.1, 0, 0.8, 5], [0, 0, 0, 1]])
    tio.write_mgh(str(tmp_path / "t.mgh"), vol, affine)
    jio.write_mgh(str(tmp_path / "j.mgh"), vol, affine)
    assert (tmp_path / "t.mgh").read_bytes() == (tmp_path / "j.mgh").read_bytes()
    (tv, ta), (jv, ja) = tio.read_mgh(str(tmp_path / "j.mgh")), jio.read_mgh(str(tmp_path / "t.mgh"))
    assert np.array_equal(tv, jv) and np.array_equal(ta, ja) and np.array_equal(tv, vol)


@pytest.mark.parametrize("ret_affine", [False, True])
def test_load_volfile_passes_preloaded_arrays(ret_affine):
    vol = _vol(5, np.float32)
    arg = (vol, np.eye(4)) if ret_affine else vol
    kwargs = dict(add_batch_axis=True, add_feat_axis=True, pad_shape=(10, 10, 10),
                  ret_affine=ret_affine)
    got, ref = tutils.load_volfile(arg, **kwargs), jutils.load_volfile(arg, **kwargs)
    if ret_affine:
        assert np.array_equal(got[1], ref[1])
        got, ref = got[0], ref[0]
    assert got.shape == ref.shape == (1, 10, 10, 10, 1) and np.array_equal(got, ref)


def test_volgen_takes_a_list_of_arrays():
    a, b = _vol(6, np.float32), _vol(7, np.float32)
    jgen.seed_rng(11)
    ref = [next(g) for g in [jgen.volgen([a, b], batch_size=2)] for _ in range(3)]
    gen = tgen.volgen([a, b], batch_size=2, rng=np.random.default_rng(11))
    got = [next(gen) for _ in range(3)]
    for (x,), (y,) in zip(got, ref):
        assert x.shape == (2, 8, 8, 8, 1) and np.array_equal(x, y)
    assert np.array_equal(next(tgen.volgen([a, a], rng=np.random.default_rng(0)))[0][0, ..., 0], a)


@pytest.mark.parametrize("bidir", [False, True])
def test_scan_to_atlas_yields_the_scans_segmentation(tmp_path, bidir):
    """Two npz files with seg 10 and 11 against a zero atlas: the first
    output is the picked scan's segmentation ({10} or {11}), as in JAX."""
    files = []
    for i, lab in enumerate((10, 11)):
        path = str(tmp_path / f"s{i}.npz")
        np.savez(path, vol=_vol(i, np.float32), seg=np.full((8, 8, 8), lab, np.int32))
        files.append(path)
    atlas = np.zeros((1, 8, 8, 8, 1), np.float32)
    jgen.seed_rng(2)
    jg = jgen.scan_to_atlas(files, atlas, bidir=bidir, segs=True)
    tg = tgen.scan_to_atlas(files, atlas, bidir=bidir, segs=True, rng=np.random.default_rng(2))
    seen = set()
    for _ in range(4):
        (jin, jout), (tin, tout) = next(jg), next(tg)
        assert len(jout) == len(tout) == (3 if bidir else 2)
        for x, y in zip(jin + jout, tin + tout):
            assert x.shape == y.shape and np.array_equal(x, y)
        assert set(np.unique(tout[0])) <= {10, 11}
        seen |= set(np.unique(tout[0]).tolist())
    assert seen == {10, 11}


def test_load_labels_equals_jax(tmp_path):
    rng = np.random.default_rng(8)
    for i in range(3):
        np.save(tmp_path / f"lab{i}.npy", rng.choice([0, 2, 5, 7 + i], size=(6, 6, 6)).astype(np.int32))
    tutils.save_volfile(np.full((6, 6, 6), 9, np.int32), str(tmp_path / "lab3.mgz"))
    for arg in (str(tmp_path), [str(tmp_path / "lab0.npy"), str(tmp_path / "lab3.mgz")],
                str(tmp_path / "lab*.npy")):
        (tl, tm), (jl, jm) = tutils.load_labels(arg), jutils.load_labels(arg)
        assert np.array_equal(tl, jl) and len(tm) == len(jm)
        assert all(np.array_equal(a, b) for a, b in zip(tm, jm))
    np.save(tmp_path / "bad.npy", np.zeros((6, 6, 6), np.float32))
    with pytest.raises(ValueError, match="non-integral"):
        tutils.load_labels(str(tmp_path / "bad.npy"))


@pytest.mark.parametrize("training", [None, ["/data/a.npz", "/data/c.npz", "b.npz"]])
def test_load_pheno_csv_equals_jax(tmp_path, training):
    path = tmp_path / "pheno.csv"
    path.write_text("name,age,sex\na.npz,71.5,1\nb.npz,30,0\nc.npz,45.25,1\n")
    (tp, tn), (jp, jn) = tutils.load_pheno_csv(str(path), training), \
        jutils.load_pheno_csv(str(path), training)
    assert tn == jn and sorted(tp) == sorted(jp)
    assert all(np.array_equal(tp[k], jp[k]) for k in tp)


@pytest.mark.parametrize("resize,unshift", [(None, None), (2.0, None), (None, (8, 10, 12)),
                                            (0.5, (16, 16, 16))])
def test_affine_shift_to_matrix_equals_jax(resize, unshift):
    trf = np.random.default_rng(9).normal(scale=0.1, size=12)
    got = tutils.affine_shift_to_matrix(trf, resize=resize, unshift_shape=unshift)
    ref = jutils.affine_shift_to_matrix(trf, resize=resize, unshift_shape=unshift)
    assert np.array_equal(got, ref)
