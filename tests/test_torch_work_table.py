"""``WorkTable``, its PSF validation and ``CompressedMask`` in both
packages: twins of ``tests/test_work_table.py`` (``cpp/test/
test_work_table.cc``: constructor clamping, original and deconvolution
grouping, the ``ValidatePsfs`` failure modes of ``cpp/work_table.cc:46-99``).

None of these needs a package-specific array type, so each test runs on
``radler_tpu``'s classes and on ``radler_tpu_torch``'s alike.  The mesh
test runs each package's own mesh: the JAX package's ``dryrun_step`` on
its 8 virtual devices, the port's mesh ``Radler.perform`` of the same cube
with every shard on the CPU.
"""

import importlib
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(params=["radler_tpu", "radler_tpu_torch"])
def pkg(request):
    """The package's public module and its work-table and compressed-mask
    modules."""
    name = request.param
    return types.SimpleNamespace(
        name=name,
        rd=importlib.import_module(name),
        wt=importlib.import_module(f"{name}.work_table"),
        cm=importlib.import_module(f"{name}.utils.compressed_mask"),
    )


def entry(pkg, channel=0, pol=None, n_psfs=1, psf_shape=(4, 4)):
    e = pkg.wt.WorkTableEntry()
    e.original_channel_index = channel
    e.polarization = pkg.rd.Polarization.STOKES_I if pol is None else pol
    e.image_weight = 1.0
    e.psf_accessors = [
        pkg.wt.LoadOnlyImageAccessor(np.zeros(psf_shape, np.float32))
        for _ in range(n_psfs)
    ]
    return e


class TestConstruction:
    def test_zero_groups_clamped(self, pkg):
        table = pkg.wt.WorkTable([], 0, 0)
        assert len(table.original_groups) == 1
        assert len(table.deconvolution_groups) == 1

    def test_deconvolution_group_mapping(self, pkg):
        table = pkg.wt.WorkTable([], 6, 2)
        assert len(table.deconvolution_groups) == 2
        assert table.deconvolution_groups[0] == [0, 1, 2]
        assert table.deconvolution_groups[1] == [3, 4, 5]

    def test_deconvolution_groups_clamped_to_original(self, pkg):
        table = pkg.wt.WorkTable([], 3, 7)
        assert len(table.deconvolution_groups) == 3

    def test_zero_deconvolution_groups(self, pkg):
        table = pkg.wt.WorkTable([], 4, 0)
        assert len(table.deconvolution_groups) == 4

    def test_channel_index_offset(self, pkg):
        table = pkg.wt.WorkTable([], 2, 1, channel_index_offset=4)
        assert table.channel_index_offset == 4

    def test_add_entry_grouping(self, pkg):
        table = pkg.wt.WorkTable([], 2, 2)
        e0 = entry(pkg, 0)
        e1 = entry(pkg, 1, n_psfs=1)
        e2 = entry(pkg, 0, pol=pkg.rd.Polarization.STOKES_Q, n_psfs=0)
        table.add_entry(e0)
        table.add_entry(e1)
        table.add_entry(e2)
        assert e0.index == 0 and e1.index == 1 and e2.index == 2
        assert table.original_groups[0] == [e0, e2]
        assert table.original_groups[1] == [e1]


class TestValidatePsfs:
    def test_valid(self, pkg):
        table = pkg.wt.WorkTable([], 2, 2)
        table.add_entry(entry(pkg, 0))
        table.add_entry(entry(pkg, 1))
        table.add_entry(entry(pkg, 0, pol=pkg.rd.Polarization.STOKES_Q,
                              n_psfs=0))
        table.validate_psfs()

    def test_wrong_count_in_front(self, pkg):
        table = pkg.wt.WorkTable(
            [pkg.wt.PsfOffset(0, 0), pkg.wt.PsfOffset(1, 1)], 1, 1)
        table.add_entry(entry(pkg, 0, n_psfs=1))
        with pytest.raises(RuntimeError, match="PSF accessors"):
            table.validate_psfs()

    def test_empty_psf_image(self, pkg):
        table = pkg.wt.WorkTable([], 1, 1)
        table.add_entry(entry(pkg, 0, psf_shape=(0, 4)))
        with pytest.raises(RuntimeError, match="empty image"):
            table.validate_psfs()

    def test_mismatched_psf_sizes(self, pkg):
        table = pkg.wt.WorkTable([], 2, 2)
        table.add_entry(entry(pkg, 0, psf_shape=(4, 4)))
        table.add_entry(entry(pkg, 1, psf_shape=(8, 8)))
        with pytest.raises(RuntimeError, match="different size"):
            table.validate_psfs()

    def test_secondary_entry_with_psfs(self, pkg):
        table = pkg.wt.WorkTable([], 1, 1)
        table.add_entry(entry(pkg, 0))
        table.add_entry(entry(pkg, 0, pol=pkg.rd.Polarization.STOKES_Q,
                              n_psfs=1))
        with pytest.raises(RuntimeError, match="first entry"):
            table.validate_psfs()


class TestCompressedMask:
    """The compressed-mask round trip and boxes (``cpp/utils/test/``)."""

    def test_roundtrip(self, pkg):
        rng = np.random.default_rng(1)
        mask = rng.random((37, 53)) > 0.9
        cm = pkg.cm.CompressedMask(53, 37)
        assert not cm.get().any()
        cm.set(mask)
        np.testing.assert_array_equal(cm.get(), mask)

    def test_boxes(self, pkg):
        cm = pkg.cm.CompressedMask(64, 64)
        box = np.ones((8, 12), bool)
        cm.set_box(box, 5, 7, 12, 8)
        full = cm.get()
        assert full[7:15, 5:17].all()
        assert full.sum() == 8 * 12
        got = cm.get_box(5, 7, 12, 8)
        np.testing.assert_array_equal(got, box)

    def test_long_runs(self, pkg):
        n = 300
        mask = np.zeros((n, n), bool)
        mask[150, 200] = True  # forces a > 65536 run
        cm = pkg.cm.CompressedMask(n, n)
        cm.set(mask)
        np.testing.assert_array_equal(cm.get(), mask)


class TestMesh:
    def test_sharded_clean_step(self, pkg):
        """The JAX package's ``dryrun_step`` (a sharded clean step and
        mesh performs); for the port, the mesh ``Radler.perform`` of the
        same 2-channel 64^2 cube, Högbom, on 8 shards (chan 2 x tile 4)."""
        if pkg.name == "radler_tpu":
            import jax
            from radler_tpu.parallel.mesh import dryrun_step

            if len(jax.devices()) < 4:
                pytest.skip("needs multiple virtual devices")
            assert np.isfinite(dryrun_step(8))
            return
        C, H, W = 2, 64, 64
        s = pkg.rd.Settings()
        s.trimmed_image_width, s.trimmed_image_height = W, H
        s.minor_iteration_count = 20
        s.absolute_threshold = 1e-6
        s.generic.use_sub_minor_optimization = False
        s.parallel.use_device_mesh = True
        s.parallel.n_devices = 8
        psf = np.zeros((C, H, W), np.float32)
        psf[:, H // 2, W // 2] = 1.0
        res = np.zeros((C, H, W), np.float32)
        res[:, H // 2, W // 2] = 1.0
        res[:, H // 4, W // 4] = 0.5
        mdl = np.zeros_like(res)
        freqs = np.array([[1.0e8 + c * 1e7, 1.1e8 + c * 1e7]
                          for c in range(C)])
        r = pkg.rd.Radler(s, psf, res, mdl, 0.0, frequencies=freqs,
                          device="cpu")
        r.perform(0)
        mesh = r._parallel.first_algorithm.device_mesh
        assert (mesh.chan, mesh.tile) == (2, 4)
        assert np.isfinite(res).all() and np.isfinite(mdl).all()
        assert np.abs(res).max() < 1.0, "the mesh's minor loop did not clean"
