"""The port's checkpoints, runner and guards (`emdee_tpu_torch.utils`)
against the JAX package's, on the CPU.

- A checkpoint written by the reference from a JAX `CellDenseState` (charges
  set and box None, or a dynamic box and no charges) loads into the port,
  and the port's loads into the reference, equal leaf for leaf: the file
  format is the contract (`leaf_i` in field order, None fields dropped,
  `__meta__`).
- The validation errors of tests/test_io_velocities.py:69 and their
  counterparts on tensors, the `.npz` suffix normalised.
- The port's form of tests/test_verlet.py:106 `test_checkpoint_roundtrip`
  on the portable engine (resume equals an uninterrupted run, bit for bit),
  and of tests/test_runner.py:17,51 on the dense engine's plain path
  (chunks, frames, checkpoint, energy within 5%; rollout records).
- A thermostatted `run_dense_simulation` resumed from its checkpoint, the
  generator restored from it, equals the uninterrupted run bit for bit.
- `check_finite` names the NaN leaf by its field path as
  `jax.tree_util.keystr` does; `guard_energy`; `profile_trace` writes a
  Chrome trace."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emdee_tpu.neighbors import cell_dense as jcd
from emdee_tpu.utils import checkpoint as jck
from emdee_tpu.utils import observability as jobs
from emdee_tpu_torch.core.types import make_state
from emdee_tpu_torch.dynamics.verlet import nve_rollout
from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.neighbors.api import NonbondedConfig, make_force_fn
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel, lennard_jones_atom
from emdee_tpu_torch.utils import checkpoint as tck
from emdee_tpu_torch.utils.lattice import cubic_lattice, maxwell_boltzmann
from emdee_tpu_torch.utils.observability import check_finite, guard_energy, profile_trace
from emdee_tpu_torch.utils.runner import RunnerConfig, run_dense_simulation
from torch_port_utils import bits, lj_setup, to_jax, to_port

torch.set_num_threads(2)


def _jax_state(kind):
    """A JAX CellDenseState of 512 atoms: with charges (box None), or with a
    dynamic box (charges None)."""
    pos, vel, params, config, _ = lj_setup(512, 0.5, seed=3)
    q = np.random.default_rng(3).uniform(-1, 1, 512) if kind == "charges" else None
    st = jcd.cell_dense_init(pos, vel, np.ones(512), params, config, charges=q)
    if kind == "box":
        st = st._replace(box=jnp.asarray(np.float32(config.box)))
    return st


def _assert_leaves_equal(port_state, jax_state):
    port = tck._leaves(port_state)
    ref = jax.tree_util.tree_leaves(jax_state)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("kind", ["charges", "box"])
def test_reference_checkpoint_loads_into_the_port(tmp_path, kind):
    js = _jax_state(kind)
    jck.save_state(str(tmp_path / "ref"), js, step=5)
    like = to_port(js)._replace(positions=torch.zeros_like(to_port(js).positions))
    got, meta = tck.load_state(str(tmp_path / "ref"), like)
    assert meta == {"step": 5} and isinstance(got, tcd.CellDenseState)
    assert (got.charges is None) == (kind == "box") and (got.box is None) == (kind == "charges")
    _assert_leaves_equal(got, js)


@pytest.mark.parametrize("kind", ["charges", "box"])
def test_port_checkpoint_loads_into_the_reference(tmp_path, kind):
    js = _jax_state(kind)
    ts = to_port(js)
    tck.save_state(str(tmp_path / "port.npz"), ts, step=7, dt=0.002)
    got, meta = jck.load_state(str(tmp_path / "port.npz"), js)
    assert meta == {"step": 7, "dt": 0.002}
    _assert_leaves_equal(ts, got)
    with np.load(tmp_path / "port.npz") as data:
        assert json.loads(bytes(data["__meta__"]).decode())["num_leaves"] == 11
        assert "__rng__" not in data.files


def test_checkpoint_suffix_and_validation(tmp_path):
    """tests/test_io_velocities.py:69 on the port (numpy leaves), and its
    counterparts on tensor leaves and on the generator."""
    state = {"a": np.arange(6, dtype=np.float32), "b": np.ones((2, 3))}
    base = str(tmp_path / "ckpt")  # extension-less: np.savez appends .npz
    tck.save_state(base, state, step=7)
    loaded, meta = tck.load_state(base, state)
    assert meta["step"] == 7 and isinstance(loaded["a"], np.ndarray)
    np.testing.assert_array_equal(loaded["a"], state["a"])
    with pytest.raises(ValueError, match="shape/dtype"):
        tck.load_state(base, {"a": np.arange(5, dtype=np.float32), "b": np.ones((2, 3))})
    with pytest.raises(ValueError, match="leaves"):
        tck.load_state(base, {"a": np.arange(6, dtype=np.float32)})
    with pytest.raises(ValueError, match="generator"):
        tck.load_state(base, state, rng=torch.Generator())
    tensors = {"a": torch.arange(6, dtype=torch.float32), "b": torch.ones(2, 3, dtype=torch.float64)}
    loaded, _ = tck.load_state(base, tensors)
    assert loaded["a"].dtype == torch.float32 and torch.equal(loaded["a"], tensors["a"])
    with pytest.raises(ValueError, match="shape/dtype"):
        tck.load_state(base, {**tensors, "a": torch.arange(6, dtype=torch.float64)})
    with pytest.raises(TypeError, match=r"\['g'\].*rng="):
        tck.save_state(base, {"g": torch.Generator()})


def _lj_system(n, density):
    pos, box = cubic_lattice(n, density, jitter=0.05, seed=4)
    state = make_state(pos, maxwell_boltzmann(n, 1.0, seed=5), box=box, device="cpu")
    nb = make_force_fn(NonbondedConfig(cutoff=2.5, switch=2.0, method="allpairs"),
                       lennard_jones_atom(np.ones(n), np.ones(n), device="cpu"), box, n, device="cpu")
    return state, nb


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_verlet.py:106 on the portable engine: resuming from the
    checkpoint continues as the uninterrupted run, bit for bit."""
    state, nb = _lj_system(64, 0.4)
    aux = nb.init(state.positions)
    mid, aux, _ = nve_rollout(state, aux, nb.force_fn, 0.002, 20)
    path = str(tmp_path / "ckpt.npz")
    tck.save_state(path, mid, dt=0.002)
    restored, meta = tck.load_state(path, mid)
    assert meta["dt"] == 0.002 and restored.rng is None and int(restored.step) == 20
    assert torch.equal(restored.positions, mid.positions)
    cont, _, _ = nve_rollout(restored, aux, nb.force_fn, 0.002, 20)
    full, _, _ = nve_rollout(state, nb.init(state.positions), nb.force_fn, 0.002, 40)
    assert torch.equal(cont.positions, full.positions) and torch.equal(cont.velocities, full.velocities)


def _dense(thermostat=None):
    n = 512
    pos, box = cubic_lattice(n, 0.5, jitter=0.05, seed=3)
    cfg = tcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.4)
    st = tcd.cell_dense_init(pos, maxwell_boltzmann(n, 0.8, seed=4), np.ones(n),
                             lennard_jones_atom(np.ones(n), np.ones(n), device="cpu"), cfg, device="cpu")
    model = LennardJonesModel.create(2.5, 2.0, device="cpu")
    return st, tcd.make_cell_dense_sim(cfg, model, dt=0.002, backend="torch", thermostat=thermostat), n


def test_runner_end_to_end(tmp_path):
    """tests/test_runner.py:17 on the port: 3 chunks of 20 steps, 3 frames
    of n atoms, the checkpoint loads back, energy within 5% across chunks."""
    st, (rollout, energy), n = _dense()
    traj, ckpt = str(tmp_path / "traj.xyz"), str(tmp_path / "ckpt.npz")
    final, history = run_dense_simulation(
        st, rollout, energy,
        RunnerConfig(total_steps=60, chunk_steps=20, trajectory_path=traj, checkpoint_path=ckpt, log=False),
        num_atoms=n, rebin_every=5,
    )
    assert int(final.step) == 60 and len(history) == 3
    assert open(traj).read().splitlines().count(str(n)) == 3
    restored, meta = tck.load_state(ckpt, final)
    assert meta["step"] == 60 and torch.equal(restored.positions, final.positions)
    totals = [h["total"] for h in history]
    assert abs(totals[-1] - totals[0]) / abs(totals[0]) < 0.05
    _, logged = run_dense_simulation(final, rollout, energy, RunnerConfig(total_steps=10, chunk_steps=10),
                                     num_atoms=n, rebin_every=5)
    assert logged[0]["steps"] == 10 and logged[0]["steps_per_s"] > 0


def test_rollout_records():
    """tests/test_runner.py:51 on the port."""
    st, (rollout, _), _ = _dense()
    _, (steps, pe, vir, ke) = rollout(st, num_steps=40, rebin_every=10, record=True)
    assert steps.shape == (4,) and int(steps[-1]) == 40
    totals = (pe + ke).numpy()
    assert np.all(np.isfinite(totals)) and abs(totals[-1] - totals[0]) / abs(totals[0]) < 0.05


def test_thermostatted_resume_is_bitwise(tmp_path):
    """CSVR through the runner: 2 chunks with a checkpoint, then one chunk
    from the loaded state and the generator restored from the file, equals
    the third chunk of the uninterrupted run bit for bit; without the
    generator's state the resumed run differs."""
    st, (rollout, energy), n = _dense(tcd.CSVRConfig(0.8, tau=0.05))
    ckpt = str(tmp_path / "ckpt")
    run = lambda s, steps, g, path=None: run_dense_simulation(  # noqa: E731
        s, rollout, energy, RunnerConfig(total_steps=steps, chunk_steps=10, checkpoint_path=path, log=False),
        num_atoms=n, rebin_every=5, rng=g)[0]
    g = torch.Generator().manual_seed(3)
    mid = run(st, 20, g, ckpt)
    full = run(mid, 10, g)
    g2 = torch.Generator().manual_seed(99)
    loaded, meta = tck.load_state(ckpt, mid, rng=g2)
    assert meta["step"] == 20
    resumed = run(loaded, 10, g2)
    for name, a in tcd.state_to_numpy(full).items():
        np.testing.assert_array_equal(bits(a), bits(tcd.state_to_numpy(resumed)[name]), err_msg=name)
    fresh = run(tck.load_state(ckpt, mid)[0], 10, torch.Generator().manual_seed(99))
    assert not torch.equal(fresh.velocities, full.velocities)


def test_check_finite_names_the_leaf():
    """The NaN leaf is named by its field path, as the reference names it."""
    st = to_port(_jax_state("charges"))
    bad = st._replace(velocities=st.velocities.clone())
    bad.velocities[3, 1, 2] = float("nan")
    check_finite(st)
    with pytest.raises(FloatingPointError, match=r"non-finite values in state\.velocities \(NaNs: 1, Infs: 0\)"):
        check_finite(bad)
    nest = {"e": (1.0, np.float32(np.inf)), "a": [torch.ones(2)]}
    with pytest.raises(FloatingPointError) as port_err:
        check_finite(nest, where="energies")
    with pytest.raises(FloatingPointError) as ref_err:
        jobs.check_finite({"e": (1.0, np.float32(np.inf)), "a": [np.ones(2)]}, where="energies")
    assert str(port_err.value) == str(ref_err.value) == "non-finite values in energies['e'][1] (NaNs: 0, Infs: 1)"
    with pytest.raises(FloatingPointError) as ref_err:
        jobs.check_finite(to_jax(bad))
    with pytest.raises(FloatingPointError) as port_err:
        check_finite(bad)
    assert str(port_err.value) == str(ref_err.value)


def test_guard_energy():
    assert guard_energy(None, -10.0) == -10.0
    assert guard_energy(-10.0, -10.4) == -10.4
    with pytest.raises(FloatingPointError, match="energy jumped"):
        guard_energy(-10.0, -3.0)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path)) as prof:
        torch.ones(64).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"] and len(prof.key_averages()) > 0
