"""The port's ImageSet against the JAX package's.

The same work tables and NumPy images go through ``radler_tpu.image_set``
and ``radler_tpu_torch.image_set``: polarization normalization (XX, I,
IQUV, QU, XX_XY_YX_YY, linked subsets), channel joins including squared
joins and zero-weight channels, deconvolution-channel averaging, PSF
averaging and the deconvolution frequencies
(``cpp/test/test_image_set.cc:98-622``).

Tolerance: 1e-6 relative (float32 reductions that may sum in another
order); metadata and frequencies exact.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import radler_tpu as jrd
import radler_tpu_torch as rd
from radler_tpu.image_set import ImageSet as JaxImageSet
from radler_tpu.image_set import (
    calculate_deconvolution_frequencies as jax_frequencies,
    linear_integration_coefficients as jax_linear_coefficients,
)
from radler_tpu.work_table import (
    LoadAndStoreImageAccessor as JaxLoadStore,
    LoadOnlyImageAccessor as JaxLoadOnly,
    WorkTable as JaxWorkTable,
    WorkTableEntry as JaxEntry,
)
from radler_tpu_torch.image_set import (
    ImageSet,
    calculate_deconvolution_frequencies,
    linear_integration_coefficients,
)
from radler_tpu_torch.work_table import (
    LoadAndStoreImageAccessor,
    LoadOnlyImageAccessor,
    WorkTable,
    WorkTableEntry,
)

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

P = rd.Polarization
RTOL = 1e-6


def make_tables(pols_per_channel, weights=None, n_deconv=0, images=None,
                psfs=None):
    """The same table for both packages, sharing NumPy images."""
    tables = []
    for mod, table_cls, entry_cls, load_store, load_only in (
        (jrd, JaxWorkTable, JaxEntry, JaxLoadStore, JaxLoadOnly),
        (rd, WorkTable, WorkTableEntry, LoadAndStoreImageAccessor,
         LoadOnlyImageAccessor),
    ):
        n_chan = len(pols_per_channel)
        table = table_cls([], n_chan, n_deconv)
        idx = 0
        for ch, pols in enumerate(pols_per_channel):
            for pi, pol_name in enumerate(pols):
                e = entry_cls()
                e.polarization = getattr(mod.Polarization, pol_name)
                e.original_channel_index = ch
                e.image_weight = 1.0 if weights is None else weights[ch]
                e.band_start_frequency = 100e6 + 10e6 * ch
                e.band_end_frequency = 110e6 + 10e6 * ch
                if images is not None:
                    e.residual_accessor = load_store(images[idx].copy())
                    e.model_accessor = load_store(images[idx].copy())
                if pi == 0:
                    psf = (
                        np.zeros((4, 4), np.float32) if psfs is None
                        else psfs[ch]
                    )
                    e.psf_accessors = [load_only(psf)]
                table.add_entry(e)
                idx += 1
        tables.append(table)
    return tables


def linked_sets(linked):
    return (
        {getattr(jrd.Polarization, p) for p in linked},
        {getattr(rd.Polarization, p) for p in linked},
    )


INTEGRATION_CASES = {
    "single_i": ([["STOKES_I"]], None, False, ()),
    "single_xx": ([["XX"]], None, False, ()),
    "dual_xx_yy": ([["XX", "YY"]], None, False, ()),
    "iquv": ([["STOKES_I", "STOKES_Q", "STOKES_U", "STOKES_V"]], None, False,
             ()),
    "qu_without_i": ([["STOKES_Q", "STOKES_U"]], None, False, ()),
    "full_linear": ([["XX", "XY", "YX", "YY"]], None, False, ()),
    "linked_subset": ([["XX", "YY"]], None, False, ("XX",)),
    "two_channels": ([["STOKES_I"], ["STOKES_I"]], [1.0, 3.0], False, ()),
    "squared_channels": ([["STOKES_I"], ["STOKES_I"]], [1.0, 1.0], True, ()),
    "zero_weight": ([["STOKES_I"], ["STOKES_I"]], [1.0, 0.0], False, ()),
    "iquv_two_channels_squared": (
        [["STOKES_I", "STOKES_Q", "STOKES_U", "STOKES_V"]] * 2, [1.0, 2.0],
        True, (),
    ),
    "iquv_three_channels": (
        [["STOKES_I", "STOKES_Q", "STOKES_U", "STOKES_V"]] * 3,
        [1.0, 0.0, 2.5], False, (),
    ),
    "all_weights_zero": ([["STOKES_I"], ["STOKES_I"]], [0.0, 0.0], False, ()),
}


@pytest.mark.parametrize("name", sorted(INTEGRATION_CASES))
def test_integrations_match_jax(name):
    pols, weights, squared, linked = INTEGRATION_CASES[name]
    n = sum(len(p) for p in pols)
    rng = np.random.default_rng(len(name))
    data = rng.normal(size=(n, 4, 4)).astype(np.float32)
    jax_table, port_table = make_tables(pols, weights)
    jax_linked, port_linked = linked_sets(linked)
    js = JaxImageSet.from_table(jax_table, squared, jax_linked, 4, 4)
    ts = ImageSet.from_table(port_table, squared, port_linked, 4, 4, "cpu")
    assert tuple(ts.meta) == tuple(js.meta)
    js.data = jnp.asarray(data)
    ts.data = torch.as_tensor(data)
    for method in ("get_square_integrated", "get_linear_integrated"):
        np.testing.assert_allclose(
            getattr(ts, method)().numpy(),
            np.asarray(getattr(js, method)()),
            rtol=RTOL,
            atol=1e-7,
        )
    np.testing.assert_array_equal(
        linear_integration_coefficients(ts.meta),
        jax_linear_coefficients(js.meta),
    )


@pytest.mark.parametrize(
    "weights, n_deconv",
    [([1.0, 1.0, 1.0, 1.0], 2), ([1.0, 0.0, 2.0, 0.5], 2), ([0.0, 1.0], 1),
     ([1.0, 2.0, 3.0], 0)],
)
def test_load_and_average_matches_jax(weights, n_deconv):
    n = len(weights)
    rng = np.random.default_rng(n)
    images = rng.normal(size=(n, 4, 4)).astype(np.float32)
    images[np.asarray(weights) == 0.0] = np.nan  # zero weight may be NaN
    psfs = rng.normal(size=(n, 4, 4)).astype(np.float32)
    jax_table, port_table = make_tables(
        [["STOKES_I"]] * n, weights, n_deconv, images, psfs
    )
    js = JaxImageSet.from_table(jax_table, False, set(), 4, 4)
    ts = ImageSet.from_table(port_table, False, set(), 4, 4, "cpu")
    js.load_and_average(True)
    ts.load_and_average(True)
    np.testing.assert_allclose(ts.data.numpy(), np.asarray(js.data),
                               rtol=RTOL)
    for tp, jp in zip(ts.load_and_average_psfs(), js.load_and_average_psfs()):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL,
                                   atol=1e-7)
    # Store back, then compare what each package wrote to its caller.
    ts.data = ts.data * 2.0
    js.data = js.data * 2.0
    ts.assign_and_store_residual()
    js.assign_and_store_residual()
    for te, je in zip(port_table, jax_table):
        np.testing.assert_allclose(
            te.residual_accessor.load(), je.residual_accessor.load(),
            rtol=RTOL,
        )


def test_deconvolution_frequencies_match_jax():
    jax_table, port_table = make_tables(
        [["STOKES_I"]] * 4, [1.0, 1.0, 2.0, 0.0], 2
    )
    freqs, weights = calculate_deconvolution_frequencies(port_table)
    jfreqs, jweights = jax_frequencies(jax_table)
    np.testing.assert_array_equal(freqs, jfreqs)
    np.testing.assert_array_equal(weights, jweights)


def test_tensor_accessor_keeps_the_device():
    """A tensor image stays a tensor through load, average and store."""
    image = torch.full((4, 4), 3.0)
    table = WorkTable([], 1, 0)
    e = WorkTableEntry()
    e.image_weight = 1.0
    e.psf_accessors = [rd.TensorImageAccessor(torch.zeros(4, 4))]
    e.residual_accessor = rd.TensorImageAccessor(image)
    e.model_accessor = rd.TensorImageAccessor(image.clone())
    table.add_entry(e)
    s = ImageSet.from_table(table, False, set(), 4, 4, "cpu")
    s.load_and_average(True)
    s.data = s.data + 1.0
    s.assign_and_store_residual()
    stored = e.residual_accessor.array
    assert isinstance(stored, torch.Tensor)
    np.testing.assert_array_equal(stored.numpy(), 4.0)
    np.testing.assert_array_equal(image.numpy(), 3.0)  # input untouched


@pytest.mark.parametrize("pols", [
    [["STOKES_I"]] * 3,
    [["XX", "YY"]] * 2,
    [["STOKES_I", "STOKES_Q", "STOKES_U", "STOKES_V"]],
], ids=["3ch", "2ch_dual", "iquv"])
def test_surface_matches_jax(pols):
    """``len``, indexing, ``psf_index`` (of the set and of its meta) and
    ``clone_shape`` (``radler_tpu/image_set.py:49,300,326-334``)."""
    n = sum(len(p) for p in pols)
    images = np.random.default_rng(n).normal(size=(n, 4, 4)).astype(
        np.float32)
    jax_table, port_table = make_tables(pols, images=images)
    js = JaxImageSet.from_table(jax_table, False, set(), 4, 4)
    ts = ImageSet.from_table(port_table, False, set(), 4, 4, "cpu")
    js.load_and_average(True)
    ts.load_and_average(True)
    assert len(ts) == len(js) == n
    for i in range(n):
        np.testing.assert_array_equal(ts[i].numpy(), np.asarray(js[i]))
        assert ts.psf_index(i) == ts.meta.psf_index(i) == js.psf_index(i)
    clone = ts.clone_shape(6, 5)
    jclone = js.clone_shape(6, 5)
    assert (clone.width, clone.height) == (jclone.width, jclone.height)
    assert clone.meta == ts.meta and clone.device == ts.device
    assert clone.table is ts.table
    assert not clone.data.any() and len(clone) == n
