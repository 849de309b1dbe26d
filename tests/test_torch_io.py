"""The port's structure and trajectory files (`emdee_tpu_torch.io`, the
native parsers of `emdee_tpu_torch.native.chemio`) against the JAX
package's, on the CPU.

- The cases of tests/test_io_velocities.py:20,31,40,55 on the port:
  velocity columns, their absence, the native reader against the Python
  one, velocities threaded through `System` into `make_state`.
- XYZ and PDB round trips; a file written by either package reads the
  same through the other's reader (positions exact: both write and parse
  the same text); `write_pdb` writes the same bytes as the reference's,
  serials wrapped at 99,999 and resids at 10,000.
- The native PDB reader against the Python one on the port's side
  (CONECT bonds, HETATM records, the CRYST1 cell).
- The 98,304-atom water box as a PDB: its 32,768 resids wrap, and
  `residue_spans` still separates every water."""

import io

import numpy as np
import pytest

from emdee_tpu.io import pdb as jpdb
from emdee_tpu.io import xyz as jxyz
from emdee_tpu_torch.io import pdb as tpdb
from emdee_tpu_torch.io import xyz as txyz
from emdee_tpu_torch.native import chemio
from emdee_tpu_torch.tools import water


def _sample(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 10, (n, 3)).round(6), rng.normal(0, 1, (n, 3)).round(6)


def test_xyz_velocity_roundtrip_python():
    pos, vel = _sample()
    buf = io.StringIO()
    txyz.write_xyz(buf, "Ar", pos, comment="with velocities", velocities=vel)
    buf.seek(0)
    frame = txyz._read_xyz_stream(buf)
    assert frame.velocities is not None and frame.comment == "with velocities"
    np.testing.assert_allclose(frame.positions, pos)
    np.testing.assert_allclose(frame.velocities, vel)


def test_xyz_without_velocities_gives_none():
    pos, _ = _sample()
    buf = io.StringIO()
    txyz.write_xyz(buf, "Ar", pos)
    buf.seek(0)
    assert txyz._read_xyz_stream(buf).velocities is None


def test_native_xyz_velocities_match_python(tmp_path):
    if not chemio.available():
        pytest.skip("native library unavailable")
    pos, vel = _sample(n=8, seed=3)
    path = tmp_path / "v.xyz"
    txyz.write_xyz(str(path), ["Ar", "Kr"] * 4, pos, comment="c", velocities=vel)
    names_c, pos_c, vel_c, comment_c = chemio.read_xyz(str(path))
    frame_py = txyz.read_xyz_frame(io.StringIO(path.read_text()))
    assert names_c == frame_py.names and comment_c == frame_py.comment
    np.testing.assert_array_equal(pos_c, frame_py.positions)
    np.testing.assert_array_equal(vel_c, frame_py.velocities)


def test_system_threads_xyz_velocities(tmp_path):
    from emdee_tpu_torch.modelling.system import System

    pos, vel = _sample(n=4, seed=1)
    path = tmp_path / "sys.xyz"
    txyz.write_xyz(str(path), ["C", "C", "O", "H"], pos, velocities=vel)
    system = System.from_file(str(path))
    np.testing.assert_allclose(system.velocities, vel)
    system.box_lengths = np.array([20.0, 20.0, 20.0])
    state = system.make_state(device="cpu")
    assert state.velocities.device.type == "cpu"
    np.testing.assert_allclose(state.velocities.numpy(), vel, rtol=1e-6)
    np.testing.assert_allclose(state.masses.numpy(), [12.011, 12.011, 15.999, 1.008], rtol=1e-6)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_xyz_crosses_packages(tmp_path, writer):
    """A multi-frame trajectory written by one package: each package's
    reader gives the other's frame (first frame), velocities included in a
    single-frame file; the bytes written are the same."""
    pos, vel = _sample(n=6, seed=4)
    names = ["O", "H", "H"] * 2
    paths = {}
    for name, mod in (("port", txyz), ("reference", jxyz)):
        paths[name] = tmp_path / f"{name}.xyz"
        with mod.XYZTrajectoryWriter(str(paths[name]), names) as w:
            w.write_frame(pos, comment="step 0")
            w.write_frame(pos + 1.0, comment="step 1")
        mod.write_xyz(str(tmp_path / f"{name}_v.xyz"), names, pos, velocities=vel)
    assert paths["port"].read_bytes() == paths["reference"].read_bytes()
    port, ref = (m.read_xyz_frame(str(tmp_path / f"{writer}_v.xyz")) for m in (txyz, jxyz))
    assert port.names == ref.names == names
    np.testing.assert_array_equal(port.positions, ref.positions)
    np.testing.assert_array_equal(port.velocities, ref.velocities)
    np.testing.assert_allclose(port.velocities, vel)
    port, ref = (m.read_xyz(str(paths[writer])) for m in (txyz, jxyz))
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_allclose(port[1], pos)
    assert port[2] == ref[2] == "step 0"


def _frame(mod, n_res=4, seed=0):
    """A small PDB frame of `mod`'s PDBFrame: waters and a HETATM ligand with
    CONECT bonds, a chain break, and a CRYST1 cell."""
    rng = np.random.default_rng(seed)
    names = ["O", "H1", "H2"] * n_res + ["C1", "CL", "N"]
    n = len(names)
    return mod.PDBFrame(
        names=names,
        resnames=["HOH"] * (3 * n_res) + ["LIG"] * 3,
        resids=np.concatenate([np.repeat(np.arange(1, n_res + 1), 3), [n_res + 1] * 3]),
        chainids=["A"] * (3 * n_res - 3) + ["B"] * 3 + ["C"] * 3,
        is_hetatm=np.array([False] * (3 * n_res) + [True] * 3),
        elements=["O", "H", "H"] * n_res + ["C", "CL", "N"],
        positions=rng.uniform(0, 30, (n, 3)).round(3),
        box_lengths=np.array([30.0, 31.5, 32.25]),
        box_angles=np.array([90.0, 90.0, 90.0]),
        bonds=[(n - 3, n - 2), (n - 3, n - 1)],
    )


def _assert_frames_equal(a, b):
    assert a.names == b.names and a.resnames == b.resnames and a.chainids == b.chainids
    assert a.elements == b.elements and a.bonds == b.bonds
    np.testing.assert_array_equal(a.resids, b.resids)
    np.testing.assert_array_equal(a.is_hetatm, b.is_hetatm)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.box_lengths, b.box_lengths)
    np.testing.assert_array_equal(a.box_angles, b.box_angles)
    assert a.residue_spans() == b.residue_spans()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_pdb_crosses_packages(tmp_path, writer):
    """The same frame written by both packages gives the same bytes; the
    file of `writer` reads back through both packages' readers (native and
    Python) into the same frame, equal to the one written."""
    paths = {}
    for name, mod in (("port", tpdb), ("reference", jpdb)):
        paths[name] = tmp_path / f"{name}.pdb"
        mod.write_pdb(str(paths[name]), _frame(mod))
    assert paths["port"].read_bytes() == paths["reference"].read_bytes()
    path = str(paths[writer])
    port = tpdb.read_pdb(path)
    with open(path) as fh:
        port_py = tpdb._read_pdb_stream(fh)
    _assert_frames_equal(port, jpdb.read_pdb(path))
    _assert_frames_equal(port, port_py)
    _assert_frames_equal(port, _frame(tpdb))
    assert port.residue_spans() == [(0, 3), (3, 6), (6, 9), (9, 12), (12, 15)]


def test_native_pdb_matches_python(tmp_path):
    if not chemio.available():
        pytest.skip("native library unavailable")
    path = tmp_path / "f.pdb"
    tpdb.write_pdb(str(path), _frame(tpdb, n_res=40, seed=2))
    native = chemio.read_pdb(str(path))
    with open(path) as fh:
        _assert_frames_equal(native, tpdb._read_pdb_stream(fh))


def test_write_pdb_wraps_serials_and_resids_as_the_reference(tmp_path):
    """100,002 atoms in 33,334 residues: serials wrap at 99,999 and resids at
    10,000, byte for byte as the reference writes them."""
    n = 100_002
    frames = {
        name: mod.PDBFrame(
            names=["O", "H1", "H2"] * (n // 3), resnames=["HOH"] * n, resids=np.repeat(np.arange(1, n // 3 + 1), 3),
            chainids=["A"] * n, is_hetatm=np.zeros(n, bool), elements=["O", "H", "H"] * (n // 3),
            positions=np.zeros((n, 3)),
        )
        for name, mod in (("port", tpdb), ("reference", jpdb))
    }
    for name, mod in (("port", tpdb), ("reference", jpdb)):
        mod.write_pdb(str(tmp_path / f"{name}.pdb"), frames[name])
    text = (tmp_path / "port.pdb").read_bytes()
    assert text == (tmp_path / "reference.pdb").read_bytes()
    lines = text.decode().splitlines()
    assert lines[99_998][6:11] == "99999" and lines[99_999][6:11] == "    1"
    assert lines[3 * 9_998][22:26] == "9999" and lines[3 * 9_999][22:26] == "   0"


def test_water_box_pdb_residues_survive_the_resid_wrap(tmp_path):
    """The 98,304-atom box written by `tools/water.py`: 32,768 HOH residues
    whose resids wrap at 10,000; `residue_spans` splits on any change
    between consecutive atoms, so every water stays its own residue."""
    box = water.water_box()
    path = tmp_path / "box.pdb"
    water.write_box_pdb(path, box)
    frame = tpdb.read_pdb(str(path))
    assert frame.num_atoms == 98_304 and not frame.bonds
    assert frame.resids.max() == 9_999 and frame.resids.min() == 0
    assert frame.residue_spans() == [(3 * i, 3 * i + 3) for i in range(32_768)]
    np.testing.assert_allclose(frame.box_lengths, [box["box"]] * 3, atol=5e-4)
    assert np.abs(frame.positions - box["positions"]).max() <= 5e-4
