"""The field generator: the same seed gives the same pool, the stated
source counts, and with stratified values the same set in every field."""

import copy

import pytest
import torch

from cardbench.harness import fields, spec

SMALL = {"clark_wideband_8k.dense_field": 512,
         "multiscale_wideband_2k.diffuse": 256}


def small(cell_name, size, n_fields=3):
    cell = spec.resolve(cell_name)
    config = copy.deepcopy(cell.config)
    traffic = copy.deepcopy(cell.traffic)
    config["image_size"] = size
    traffic["fields"] = n_fields
    return config, traffic


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_same_seed_same_pool(cell):
    config, traffic = small(cell, SMALL[cell])
    a = fields.make_fields(config, traffic, 2**31 + 7, "cpu")
    b = fields.make_fields(config, traffic, 2**31 + 7, "cpu")
    c = fields.make_fields(config, traffic, 2**31 + 8, "cpu")
    assert torch.equal(a.pool, b.pool) and torch.equal(a.psfs, b.psfs)
    assert not torch.equal(a.pool, c.pool)
    assert torch.equal(a.psfs, c.psfs)
    assert torch.isfinite(a.pool).all()


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_source_counts(cell):
    config, traffic = small(cell, SMALL[cell])
    sky = traffic["sky"]
    f = fields.make_fields(config, traffic, 5, "cpu")
    assert f.sources == fields.source_count(sky, SMALL[cell])
    full = spec.resolve(cell).config["image_size"]
    assert fields.source_count(sky, full) == sky["count"] * (
        full // sky["count_at_size"]) ** 2
    assert f.pool.shape == (3, len(config["channels_mhz"]), SMALL[cell],
                            SMALL[cell])


def test_point_field_holds_its_sources():
    config, traffic = small("clark_wideband_8k.dense_field", 512, 1)
    traffic["psf"]["ring_amplitude"] = 0.0
    traffic["psf"]["sigma_px"] = 0.05  # a delta: the field is the sky
    f = fields.make_fields(config, traffic, 11, "cpu")
    sky = f.pool[0, 0]
    n = int((sky.abs() > 1e-3).sum())
    assert n == f.sources == fields.source_count(traffic["sky"], 512) == 5
    lo, hi = traffic["sky"]["amplitude"]
    assert float(sky.max()) <= hi * 1.5


def test_stratified_values_are_one_set_in_another_order():
    gen = torch.Generator().manual_seed(3)
    a = fields._draw("uniform", (2, 50), gen, "cpu")
    b = fields._draw("uniform", (2, 50), torch.Generator().manual_seed(4),
                     "cpu")
    assert torch.equal(a[0].sort().values, a[1].sort().values)
    assert torch.equal(a[0].sort().values, b[0].sort().values)
    assert not torch.equal(a[0], b[0])
    n = fields._draw("normal", (1, 1000), gen, "cpu")
    assert abs(float(n.mean())) < 1e-9 and abs(float(n.std()) - 1) < 0.01


def test_channel_edges():
    config = spec.resolve("clark_wideband_8k.dense_field").config
    edges = fields.channel_edges(config)
    assert edges.shape == (4, 2)
    assert edges[0].tolist() == [115e6, 125e6]


def test_polarizations_are_channel_major_shares_of_the_sky():
    config, traffic = small("multiscale_wideband_2k.diffuse", 256, 1)
    one = fields.make_fields(config, traffic, 13, "cpu")
    config["polarizations"] = ["STOKES_I", "STOKES_Q"]
    traffic["sky"]["polarization_fraction"]["STOKES_Q"] = 0.25
    two = fields.make_fields(config, traffic, 13, "cpu")
    C = len(config["channels_mhz"])
    assert two.pool.shape == (1, 2 * C, 256, 256)
    assert torch.equal(two.pool[0, 0::2], one.pool[0])
    assert torch.equal(two.pool[0, 1::2], one.pool[0] * 0.25)
