import pytest

import roofline


def test_bytes_from_shapes():
    # panda_arm: N = 7 one-dof joints, one constraint
    per_problem = 4 * ((12 * 7 + 6 + 14 + (84 + 21 + 6)) + (84 + 21 + 6 + 4))
    assert roofline.launch_bytes(7, 7, 1, 16384) == 16384 * per_problem


def test_operations_grow_with_iterations_and_checks():
    nvs, parents = [1] * 7, list(range(-1, 6))
    it, chk = roofline.iteration_ops(nvs, parents, 1)
    assert it > 0 and chk > 0
    t1, _ = roofline.least_ms(nvs, parents, 1, 16384, 2, 16384 * 30, 16384 * 4)
    t2, _ = roofline.least_ms(nvs, parents, 1, 16384, 2, 16384 * 60, 16384 * 8)
    assert t2 > t1


def test_least_time_picks_the_larger_bound():
    nvs, parents = [1] * 7, list(range(-1, 6))
    t, by = roofline.least_ms(nvs, parents, 1, 16384, 1, 0, 0)
    assert by == "bytes"
    assert t == pytest.approx(roofline.launch_bytes(7, 7, 1, 16384) / 3.35e12 * 1e3)
    t, by = roofline.least_ms(nvs, parents, 1, 16384, 1, 16384 * 200, 16384 * 200)
    assert by == "operations"


def test_a_multi_dof_joint_costs_more():
    one = roofline.iteration_ops([1, 1], [-1, 0], 1)
    six = roofline.iteration_ops([6, 1], [-1, 0], 1)
    assert six[0] > one[0] and six[1] > one[1]
