"""Settings parity between the packages, the interop helpers, and the
port's freedom from JAX.

Every ``Settings`` field, default and enum member is equal across
``radler_tpu`` and ``radler_tpu_torch``; ``interop.settings_from_reference``
carries a modified ``radler_tpu.Settings`` across field for field.
"""

import dataclasses
import enum
import subprocess
import sys

import pytest

import radler_tpu as jrd
import radler_tpu_torch as rd
from radler_tpu import settings as jsettings
from radler_tpu_torch import settings as tsettings
from radler_tpu_torch.interop import (
    cube_meta_from_reference,
    settings_from_reference,
)


def plain(value):
    """A settings value with enums replaced by (class name, member name)."""
    if isinstance(value, enum.Enum):
        return (type(value).__name__, value.name, value.value)
    if dataclasses.is_dataclass(value):
        return {
            f.name: plain(getattr(value, f.name))
            for f in dataclasses.fields(value)
        }
    if isinstance(value, (set, frozenset)):
        return sorted(plain(v) for v in value)
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    return value


def test_every_default_equal():
    assert plain(rd.Settings()) == plain(jrd.Settings())


def test_same_public_names():
    jax_names = set(jrd.__all__)
    assert jax_names <= set(rd.__all__)
    assert set(rd.__all__) - jax_names == {"TensorImageAccessor"}


ENUMS = [
    name
    for name, obj in vars(jsettings).items()
    if isinstance(obj, type) and issubclass(obj, enum.Enum)
    and obj is not enum.Enum
]


@pytest.mark.parametrize("name", ENUMS)
def test_enums_equal(name):
    jax_enum, port_enum = getattr(jsettings, name), getattr(tsettings, name)
    assert [(m.name, m.value) for m in port_enum] == [
        (m.name, m.value) for m in jax_enum
    ]


def test_polarization_helpers_equal():
    for pol_j in jrd.Polarization:
        pol_t = rd.Polarization[pol_j.name]
        assert pol_t.is_stokes == pol_j.is_stokes
    for helper in ("has_dual_polarization", "has_full_linear_polarization",
                   "has_full_circular_polarization"):
        for pols in (["XX", "YY"], ["RR", "LL"], ["XX", "XY", "YX", "YY"],
                     ["RR", "RL", "LR", "LL"], ["STOKES_I"]):
            assert getattr(tsettings, helper)(
                {rd.Polarization[p] for p in pols}
            ) == getattr(jsettings, helper)({jrd.Polarization[p] for p in pols})


def test_settings_from_reference_carries_every_field():
    s = jrd.Settings()
    s.trimmed_image_width = 512
    s.minor_loop_gain = 0.25
    s.auto_mask_sigma = 4.0
    s.linked_polarizations = {jrd.Polarization.XX, jrd.Polarization.YY}
    s.spectral_fitting.mode = jrd.SpectralFittingMode.LOG_POLYNOMIAL
    s.spectral_fitting.terms = 3
    s.multiscale.scale_list = [0.0, 4.0, 16.0]
    s.multiscale.shape = jrd.MultiscaleShape.GAUSSIAN
    s.algorithm_type = jrd.AlgorithmType.IUWT
    s.local_rms.method = jrd.LocalRmsMethod.RMS_AND_MINIMUM_WINDOW
    s.generic.use_sub_minor_optimization = False
    s.parallel.grid_width = 3
    t = settings_from_reference(s)
    assert isinstance(t, rd.Settings)
    assert isinstance(t.spectral_fitting.mode, rd.SpectralFittingMode)
    assert plain(t) == plain(s)
    # The copy is independent of the original.
    s.multiscale.scale_list.append(64.0)
    assert t.multiscale.scale_list == [0.0, 4.0, 16.0]


def test_cube_meta_from_reference():
    from radler_tpu.image_set import CubeMeta

    meta = CubeMeta(2, 4, (1.0, 0.5), (True, True, False, True), 0.5, True,
                    (1e8, 1.1e8))
    port = cube_meta_from_reference(meta)
    assert tuple(port) == tuple(meta)
    assert list(port.psf_indices) == list(meta.psf_indices)


def test_independent_instances():
    a = rd.Settings()
    b = rd.Settings()
    a.multiscale.scale_list.append(5.0)
    a.pixel_scale.x = 1.0
    assert b.multiscale.scale_list == []
    assert b.pixel_scale.x == 0.0


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import radler_tpu_torch\n"
        "import radler_tpu_torch.interop, radler_tpu_torch.kernels.hogbom_step\n"
        "import radler_tpu_torch.kernels._build\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'radler_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True)
