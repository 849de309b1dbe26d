"""The port's spans (`emdee_tpu_torch.utils.observability.span`) through the
production runner, on the CPU at tiny sizes.

Three runs through `run_dense_simulation` (2 chunks, a trajectory dump and a
checkpoint each): a 500-atom LJ melt on the stacked leapfrog with the sort
rebin, the same melt on the component carry with the shift rebin, and a
1,536-atom flexible-water box under CSVR.  For each:

- with no profiler running, the whole run never enters `record_function`;
- under `torch.profiler.profile`, every ATen op inside a chunk's
  `emdee.runner.rollout` lies in exactly one of the rollout's leaf spans, an
  `emdee.rebin` opens once a rebin block, and each runner span once a chunk;
- the end state is the same bit for bit with and without the profiler."""

import numpy as np
import pytest
import torch

from emdee_tpu_torch.neighbors import cell_dense as tcd
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel, lennard_jones_atom
from emdee_tpu_torch.tools import water
from emdee_tpu_torch.utils.lattice import cubic_lattice, maxwell_boltzmann
from emdee_tpu_torch.utils.runner import RunnerConfig, run_dense_simulation

torch.set_num_threads(2)

LEAVES = {"emdee.rebin", "emdee.aux", "emdee.force", "emdee.integrate", "emdee.thermostat", "emdee.barostat",
          "emdee.energy"}
RUNNER = ("rollout", "energy", "wait", "guard", "dump", "checkpoint")
CHUNKS = 2
CASES = {  # name: (steps a chunk, rebin every)
    "lj-stacked-sort": (6, 2),
    "lj-component-shift": (6, 3),
    "water-csvr": (4, 2),
}


def _melt(rebin):
    n = 500
    pos, box = cubic_lattice(n, 0.6, jitter=0.05, seed=5)
    cfg = tcd.suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.4)
    params = lennard_jones_atom(np.ones(n), np.ones(n), device="cpu")
    st = tcd.cell_dense_init(pos, maxwell_boltzmann(n, 1.0, seed=6), np.ones(n), params, cfg, device="cpu")
    model = LennardJonesModel.create(2.5, 2.0, device="cpu")
    sim = tcd.make_cell_dense_sim(cfg, model, dt=0.004, backend="torch",
                                  uniform_params=tcd.detect_uniform_params(params), uniform_mass=1.0, rebin=rebin)
    return st, sim, n, None


def _water():
    box, config, model, coulomb, params = water.water_setup("cpu", n_side=8, spill=False)
    n = len(box["masses"])
    st = tcd.cell_dense_init(box["positions"], box["velocities"], box["masses"], params, config,
                             charges=box["charges"], device="cpu")
    sim = water.molecular_sim(box, config, model, coulomb, params, backend="torch", device="cpu",
                              thermostat=water.csvr())
    return st, sim, n, torch.Generator().manual_seed(11)


def _setup(case):
    if case == "water-csvr":
        return _water()
    return _melt("sort" if case == "lj-stacked-sort" else "shift")


def _run(case, tmp_path):
    """The run's end state, through the runner with a dump and a checkpoint."""
    state, (rollout, energy), n, rng = _setup(case)
    steps, every = CASES[case]
    config = RunnerConfig(total_steps=CHUNKS * steps, chunk_steps=steps, trajectory_path=str(tmp_path / "t.xyz"),
                          checkpoint_path=str(tmp_path / "c.npz"))
    return run_dense_simulation(state, rollout, energy, config, n, rebin_every=every, rng=rng)[0]


@pytest.fixture(scope="module", params=sorted(CASES))
def traced(request, tmp_path_factory):
    """(case, end state, [(start ns, end ns, name, thread)] of the run's CPU
    events) of a run under `torch.profiler.profile`."""
    case = request.param
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        final = _run(case, tmp_path_factory.mktemp(case))
    events = [(e.start_ns(), e.end_ns(), e.name(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events()]
    return case, final, sorted(events)


def _named(events, name):
    return [e for e in events if e[2] == name]


def _inside(outer, events):
    """The events of `events` that lie within one of `outer` on its thread."""
    return [e for e in events if any(o[0] <= e[0] and e[1] <= o[1] and o[3] == e[3] for o in outer)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_profiler_never_enters_record_function(case, tmp_path, monkeypatch):
    class Refused:
        def __init__(self, *args, **kwargs):
            raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    assert not torch.autograd._profiler_enabled()
    assert int(_run(case, tmp_path).step) == CHUNKS * CASES[case][0]


def test_every_rollout_op_lies_in_exactly_one_leaf_span(traced):
    _, _, events = traced
    leaves = [e for e in events if e[2] in LEAVES]
    ops = [e for e in _inside(_named(events, "emdee.runner.rollout"), events) if e[2].startswith("aten::")]
    assert len(ops) > 100
    counts = {}
    for op in ops:
        k = sum(1 for s in leaves if s[0] <= op[0] and op[1] <= s[1] and s[3] == op[3])
        counts.setdefault(k, []).append(op[2])
    assert set(counts) == {1}, {k: sorted(set(v))[:10] for k, v in counts.items()}


def test_one_rebin_span_a_block(traced):
    case, _, events = traced
    steps, every = CASES[case]
    assert len(_named(events, "emdee.rebin")) == CHUNKS * -(-steps // every)
    assert len(_inside(_named(events, "emdee.runner.rollout"), _named(events, "emdee.force"))) >= CHUNKS * steps


def test_runner_spans_once_a_chunk(traced):
    _, _, events = traced
    for part in RUNNER:
        assert len(_named(events, f"emdee.runner.{part}")) == CHUNKS, part
    rollouts = _named(events, "emdee.runner.rollout")
    assert all(a[1] <= b[0] for a, b in zip(rollouts, rollouts[1:]))


def test_end_state_is_the_same_with_and_without_the_profiler(traced, tmp_path):
    case, final, _ = traced
    plain = _run(case, tmp_path)
    for name, a in tcd.state_to_numpy(plain).items():
        b = tcd.state_to_numpy(final)[name]
        assert (a is None) == (b is None), name
        if a is not None:
            bits = lambda x: np.ascontiguousarray(np.atleast_1d(x)).view(np.uint8)  # noqa: E731
            np.testing.assert_array_equal(bits(a), bits(b), err_msg=name)
