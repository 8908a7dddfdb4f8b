"""The port's native URDF loader (`loik_tpu_torch.model.native`) against
loik_tpu's (`loik_tpu.model.native`: the same C++ parser, so every leaf is
equal bit for bit) and against the port's pure-Python `load_urdf`, case
for case with tests/test_native.py.  The port builds the parser into its
own build directory and never writes loik_tpu's `cpp/liburdf_loik.so`.
"""

import os

import numpy as np
import pytest
import torch

from loik_tpu.model.native import load_urdf_native as jload_native
from loik_tpu_torch.model import load_urdf
from loik_tpu_torch.model import native
from loik_tpu_torch.model.native import load_urdf_native, native_available
from loik_tpu_torch.model.robots import _ASSETS
from loik_tpu_torch.model.tree import HELICAL, MIMIC_PAIR, SPHERICAL, SPHERICAL_ZYX

from tests.test_mimic import URDF_COUPLED_FINGER
from tests.test_native import HELICAL_ZYX, MIMIC_GRIPPER

PANDA = os.path.join(_ASSETS, "panda.urdf")
TALOS = os.path.join(_ASSETS, "talos.urdf")
SPHERICAL_URDF = (
    '<robot name="s"><link name="a"/><link name="b"/><link name="c"/>'
    '<joint name="ball" type="spherical">'
    '<origin xyz="0 0 0.5"/><parent link="a"/><child link="b"/></joint>'
    '<joint name="hinge" type="revolute">'
    '<origin xyz="0 0 0.2"/><parent link="b"/><child link="c"/>'
    '<axis xyz="0 1 0"/><limit effort="1" velocity="2.5"/></joint>'
    "</robot>"
)
LEAVES = ("placement_R", "placement_p", "axis", "velocity_limit", "axis2",
          "placement2_R", "placement2_p")
META = ("parents", "jtypes", "idx_v", "idx_q", "joint_names", "pitches", "mimic")


def _np(x):
    return None if x is None else np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def assert_same_tree(got, want, atol=0.0):
    """Metadata equal and every tensor leaf equal (within atol; 0: bit for
    bit, infinities in the same places)."""
    for name in META:
        assert getattr(got, name) == getattr(want, name), name
    for name in LEAVES:
        a, b = _np(getattr(got, name)), _np(getattr(want, name))
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


def _port(source, **kw):
    return load_urdf_native(source, device="cpu", **kw)


CASES = {
    "panda": (PANDA, {}),
    "panda_floating": (PANDA, dict(floating_base=True)),
    "talos_floating": (TALOS, dict(floating_base=True)),
    "spherical": (SPHERICAL_URDF, {}),
    "helical_spherical_zyx": (HELICAL_ZYX, {}),
    "mimic_reduce": (URDF_COUPLED_FINGER, dict(mimic="reduce")),
}


def test_available():
    assert native_available()


@pytest.mark.parametrize("case", list(CASES))
def test_native_matches_reference_native(case):
    source, kw = CASES[case]
    assert_same_tree(_port(source, **kw), jload_native(source, **kw))


@pytest.mark.parametrize("case", list(CASES))
def test_native_matches_python_loader(case):
    source, kw = CASES[case]
    got, want = _port(source, **kw), load_urdf(source, device="cpu", **kw)
    assert_same_tree(got, want, atol=1e-14)
    assert got.device == torch.device("cpu") and got.dtype == torch.float64


def test_talos_bit_for_bit_and_shapes():
    got = _port(TALOS, floating_base=True)
    assert got.njoints == 33 and got.nv == 38
    assert_same_tree(got, load_urdf(TALOS, floating_base=True, device="cpu"))


def test_extension_types():
    s = _port(SPHERICAL_URDF)
    assert s.jtypes == (SPHERICAL, 0) and s.nq == 5 and s.nv == 4
    h = _port(HELICAL_ZYX)
    assert h.jtypes == (HELICAL, SPHERICAL_ZYX) and h.pitches == (0.02, 0.0)
    m = _port(URDF_COUPLED_FINGER, mimic="reduce")
    assert m.jtypes[0] == MIMIC_PAIR


def test_dtype():
    t = _port(PANDA, dtype=torch.float32)
    assert t.placement_R.dtype == torch.float32
    np.testing.assert_array_equal(_np(t.placement_R),
                                  _np(load_urdf(PANDA, dtype=torch.float32,
                                                device="cpu").placement_R))


@pytest.mark.parametrize("case", ["panda", "helical_spherical_zyx", "mimic_reduce"])
def test_native_fk_equivalence(case):
    """End to end: FK through the natively-parsed tree equals the Python
    loader's."""
    source, kw = CASES[case]
    t_py, t_cc = load_urdf(source, device="cpu", **kw), _port(source, **kw)
    q = t_py.random_configuration((4,), generator=torch.Generator().manual_seed(0))
    for a, b in zip(t_cc.fwd_kinematics(q), t_py.fwd_kinematics(q)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-13)


def test_mimic_rejected_and_policy():
    with pytest.raises(ValueError, match="mimic"):
        _port(MIMIC_GRIPPER)
    with pytest.raises(ValueError, match="serial-adjacent"):
        _port(MIMIC_GRIPPER, mimic="reduce")
    with pytest.raises(ValueError, match="mimic must be"):
        _port(PANDA, mimic="fold")


def test_mimic_reduce_edge_cases():
    """Leaf fixed siblings allowed; dof-carrying branches block (named)."""
    with_frames = URDF_COUPLED_FINGER.replace(
        "</robot>",
        '<link name="pv"/><joint name="pvj" type="fixed">'
        '<origin xyz="0 0 0.01"/><parent link="prox"/>'
        '<child link="pv"/></joint></robot>')
    assert _port(with_frames, mimic="reduce").jtypes == \
        _port(URDF_COUPLED_FINGER, mimic="reduce").jtypes
    blocked = URDF_COUPLED_FINGER.replace(
        "</robot>",
        '<link name="m"/><link name="s"/>'
        '<joint name="mf" type="fixed"><parent link="prox"/>'
        '<child link="m"/></joint>'
        '<joint name="sj" type="revolute"><parent link="m"/>'
        '<child link="s"/><axis xyz="0 0 1"/></joint></robot>')
    with pytest.raises(ValueError, match="mf"):
        _port(blocked, mimic="reduce")


def test_error_reporting():
    with pytest.raises(ValueError, match="native URDF parse failed"):
        _port('<robot name="x"><link name="a"/><link name="b"/>'
              '<joint name="j" type="gearbox"><parent link="a"/>'
              '<child link="b"/></joint></robot>')
    with pytest.raises(ValueError, match="root"):
        _port('<robot name="x"><link name="a"/><link name="b"/><link name="c"/>'
              '<joint name="j" type="revolute"><parent link="a"/>'
              '<child link="b"/></joint></robot>')


def test_builds_into_its_own_directory(tmp_path, monkeypatch):
    """A fresh build goes to the port's build directory (here a temporary
    one) and leaves loik_tpu's library in cpp/ as it was."""
    theirs = os.path.join(os.path.dirname(native.SRC_PATH), "liburdf_loik.so")

    def stamp():
        return os.stat(theirs).st_mtime_ns if os.path.exists(theirs) else None

    before = stamp()
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    tree = _port(PANDA)
    assert native.library_path().startswith(str(tmp_path))
    assert os.listdir(tmp_path) == [os.path.basename(native.library_path())]
    assert stamp() == before
    assert tree.njoints == 9
