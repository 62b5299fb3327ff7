"""``ComponentList`` in both packages: twins of ``tests/test_component_list.py``.

The component list needs no package-specific array type, so each test
runs on ``radler_tpu``'s class and on ``radler_tpu_torch``'s alike.
"""

import importlib

import numpy as np
import pytest


@pytest.fixture(params=["radler_tpu", "radler_tpu_torch"])
def ComponentList(request):
    return importlib.import_module(
        f"{request.param}.component_list").ComponentList


@pytest.fixture
def merged_list(ComponentList):
    cl = ComponentList(512, 512, 4, 3)
    cl.add(256, 256, 1, [1.0, 2.0, 3.0])
    cl.add(256, 256, 1, [5.0, 6.0, 7.0])
    cl.add(511, 511, 0, [8.0, 9.0, 10.0])
    cl.add(13, 42, 3, [11.0, 12.0, 13.0])
    cl.merge_duplicates()
    return cl


def test_adding_values_merges_duplicates(merged_list):
    cl = merged_list
    assert cl.component_count(0) == 1
    assert cl.component_count(1) == 1
    assert cl.component_count(2) == 0
    assert cl.component_count(3) == 1

    x, y, values = cl.get_component(0, 0)
    assert (x, y) == (511, 511)
    np.testing.assert_allclose(values, [8.0, 9.0, 10.0], rtol=1e-5)

    # Duplicate position accumulates per channel.
    x, y, values = cl.get_component(1, 0)
    assert (x, y) == (256, 256)
    np.testing.assert_allclose(values, [6.0, 8.0, 10.0], rtol=1e-5)

    x, y, values = cl.get_component(3, 0)
    assert (x, y) == (13, 42)
    np.testing.assert_allclose(values, [11.0, 12.0, 13.0], rtol=1e-5)


def test_get_positions(merged_list):
    cl = merged_list
    assert len(cl.get_positions(0)) == 1
    assert len(cl.get_positions(1)) == 1
    assert len(cl.get_positions(2)) == 0
    assert len(cl.get_positions(3)) == 1
    assert cl.get_positions(0)[0] == (511, 511)
    assert cl.get_positions(1)[0] == (256, 256)
    assert cl.get_positions(3)[0] == (13, 42)


def test_multiply_scale_component(merged_list):
    cl = merged_list
    for i in range(cl.n_scales):
        if i == 2:
            continue
        for j in range(cl.n_frequencies):
            cl.multiply_scale_component(i, 0, j, float(j + 1))
    _, _, v0 = cl.get_component(0, 0)
    np.testing.assert_allclose(v0, [8.0, 18.0, 30.0], rtol=1e-5)
    _, _, v1 = cl.get_component(1, 0)
    np.testing.assert_allclose(v1, [6.0, 16.0, 30.0], rtol=1e-5)
    _, _, v3 = cl.get_component(3, 0)
    np.testing.assert_allclose(v3, [11.0, 24.0, 39.0], rtol=1e-5)


def test_merge_cancelling_components_removes_position(ComponentList):
    cl = ComponentList(64, 64, 1, 2)
    cl.add(10, 10, 0, [1.0, -2.0])
    cl.add(10, 10, 0, [-1.0, 2.0])
    cl.add(11, 10, 0, [0.5, 0.5])
    cl.merge_duplicates()
    # The exactly-cancelling component vanishes (merge keeps only pixels
    # with any non-zero channel, component_list.cc:251-258).
    assert cl.component_count(0) == 1
    x, y, v = cl.get_component(0, 0)
    assert (x, y) == (11, 10)
    np.testing.assert_allclose(v, [0.5, 0.5])


def test_add_list_applies_subimage_offset(ComponentList):
    parent = ComponentList(128, 128, 2, 1)
    child = ComponentList(32, 32, 2, 1)
    child.add(3, 4, 0, [1.5])
    child.add(5, 6, 1, [2.5])
    parent.add_list(child, 64, 32)
    assert parent.component_count(0) == 1
    assert parent.component_count(1) == 1
    assert parent.get_positions(0)[0] == (67, 36)
    assert parent.get_positions(1)[0] == (69, 38)


def test_auto_merge_threshold(ComponentList, monkeypatch):
    cl = ComponentList(16, 16, 1, 1)
    monkeypatch.setattr(ComponentList, "MAX_COMPONENTS_BEFORE_MERGE", 8)
    for _ in range(8):
        cl.add(2, 2, 0, [1.0])
    # The 8th add triggers an automatic merge back to one component.
    assert cl.component_count(0) == 1
    _, _, v = cl.get_component(0, 0)
    np.testing.assert_allclose(v, [8.0])
