"""Molecular systems on the dense-cell engine (counterpart of
emdee_tpu/neighbors/cell_dense_molecular.py): charges with DSF Coulomb,
exclusions and 1-4 scales, and bonded terms, on the slot grid.

A molecular force evaluation is
1. the pair pass in slot space — LJ and DSF over the charge field, with
   the exclusions as per-pair tag comparisons (`exclusion_mode="kernel"`):
   every slot carries its atom's E exclusion partners (`aux_fn`, one
   gather per rebin), and on the kernel backend ('cuda', K2c) the harmonic
   bonds ride the first E_b tags as well;
2. slot-space corrections: the bonded terms that the pair pass does not
   absorb, and the exclusion pairs beyond the tag band, each term's atom
   indices remapped to slots once per rebin (`extra_aux_fn`).  Terms whose
   atoms appear in no other force row are written with a scatter-set; all
   others are folded by the fixed-order add of `core/scatter.py`, never by
   a float-atomic `index_add_`.

The host-side table builders are numpy, as in the reference.
`exclusion_mode="correction"` (the atom-space correction pass) needs the
portable neighbor engine's `apply_exclusion_corrections` (ROADMAP item 3)
and raises; `dense_sim_from_system` needs the modelling layer and its
fixture files (ROADMAP item 9) and raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from emdee_tpu_torch.core.scatter import add_plan, fixed_add
from emdee_tpu_torch.neighbors.cell_dense import (
    CellDenseConfig,
    CellDenseState,
    _numpy,
    _state_box,
    make_cell_dense_sim,
    resolve_dense_backend,
)
from emdee_tpu_torch.neighbors.cell_kernel import MAX_TAGS
from emdee_tpu_torch.potentials.bonded import (
    AngleTable,
    BondTable,
    BondedSystem,
    TorsionTable,
    bonded_force_rows,
)
from emdee_tpu_torch.potentials.lennard_jones import LennardJonesModel, pair_interaction

_FAMILIES = ("bonds", "angles", "torsions", "impropers")
# The atom columns of each family's force rows, in `bonded_force_rows`' order.
_ROW_COLUMNS = {BondTable: (0, 1), AngleTable: (0, 2, 1), TorsionTable: (0, 1, 2, 3)}


def build_exclusion_tables(
    num_atoms, pairs, lj_scales, coulomb_scales=None, pad_e=None, band_e=None, bonds=None,
):
    """(N+1, E) atom-indexed exclusion tag tables (numpy float32).

    Row i lists atom i's exclusion partners as float ids (−1 pad) with the
    1 − scale weights the pair pass subtracts per matching pair; row N is
    the all-pad row that empty slots index.  E = the most partners of any
    atom (`pad_e` forces a wider width).

    band_e: cap the tag width; a pair stays in band only if both atoms'
    rows have room, the rest is returned as leftover (pairs, lj_scales,
    coulomb_scales) for the slot-space correction, and the return is
    ((ids, mlj, mcs), leftover).

    bonds = (bond_pairs (B, 2), k (B,), r0 (B,)): harmonic bonds to ride the
    tags — a bond's (i, j) is a 1-2 exclusion pair, so its weights (k,
    k·r0, k·r0²) sit at the matching tag slot.  Bonded pairs are inserted
    first (they take the E_b-wide tag prefix), and the return is (tabs,
    leftover, (kb, kr0, kr02) or None, absorbed (B,) bool); a bond is
    absorbed when its exclusion pair is in band."""
    pairs = np.asarray(pairs)
    lj_scales = np.asarray(lj_scales, np.float32)
    cs = None if coulomb_scales is None else np.asarray(coulomb_scales, np.float32)
    n = num_atoms
    partners = [[] for _ in range(n)]
    leftover = []
    counts = np.zeros(n, np.int64)
    order = range(len(pairs))
    bond_of = {}
    absorbed = None
    if bonds is not None:
        bond_pairs, bond_k, bond_r0 = (np.asarray(b) for b in bonds)
        bond_k = bond_k.astype(np.float32)
        bond_r0 = bond_r0.astype(np.float32)
        absorbed = np.zeros(len(bond_pairs), bool)
        for b in range(len(bond_pairs)):
            bi, bj = int(bond_pairs[b, 0]), int(bond_pairs[b, 1])
            bond_of[(min(bi, bj), max(bi, bj))] = b
        is_bond = np.array(
            [(min(int(p[0]), int(p[1])), max(int(p[0]), int(p[1]))) in bond_of for p in pairs], bool,
        ) if len(pairs) else np.zeros(0, bool)
        order = list(np.flatnonzero(is_bond)) + list(np.flatnonzero(~is_bond))
    for k in order:
        i, j = int(pairs[k, 0]), int(pairs[k, 1])
        if i >= n or j >= n:
            continue  # padding rows
        s_c = None if cs is None else cs[k]
        if band_e is not None and (counts[i] >= band_e or counts[j] >= band_e):
            leftover.append((i, j, lj_scales[k], 0.0 if s_c is None else s_c))
            continue
        b = bond_of.get((min(i, j), max(i, j)))
        kb = r0b = 0.0
        if b is not None:
            absorbed[b] = True
            kb, r0b = float(bond_k[b]), float(bond_r0[b])
        partners[i].append((j, lj_scales[k], s_c, kb, r0b))
        partners[j].append((i, lj_scales[k], s_c, kb, r0b))
        counts[i] += 1
        counts[j] += 1
    e_n = max(max((len(p) for p in partners), default=0), 1)
    if pad_e is not None:
        if pad_e < e_n:
            raise ValueError(f"pad_e {pad_e} < max partners per atom {e_n}")
        e_n = pad_e
    ids = np.full((n + 1, e_n), -1.0, np.float32)
    mlj = np.zeros((n + 1, e_n), np.float32)
    mcs = np.zeros((n + 1, e_n), np.float32) if cs is not None else None
    kb_t, kr0_t, kr02_t = (np.zeros((n + 1, e_n), np.float32) for _ in range(3))
    e_b = 0
    for i, plist in enumerate(partners):
        for e, (j, s_lj, s_c, kb, r0b) in enumerate(plist):
            ids[i, e] = float(j)
            mlj[i, e] = 1.0 - s_lj
            if mcs is not None:
                mcs[i, e] = 1.0 - s_c
            if kb:
                kb_t[i, e] = kb
                kr0_t[i, e] = kb * r0b
                kr02_t[i, e] = kb * r0b * r0b
                e_b = max(e_b, e + 1)
    tabs = (ids, mlj, mcs)
    bond_tabs = (kb_t[:, :e_b], kr0_t[:, :e_b], kr02_t[:, :e_b]) if e_b else None
    if leftover:
        lo = np.asarray([(i, j) for i, j, _, _ in leftover], np.int32)
        lo_lj = np.asarray([s for _, _, s, _ in leftover], np.float32)
        lo_cs = None if cs is None else np.asarray([s for _, _, _, s in leftover], np.float32)
    else:
        lo, lo_lj = np.zeros((0, 2), np.int32), np.zeros(0, np.float32)
        lo_cs = None if cs is None else np.zeros(0, np.float32)
    if bonds is not None:
        return tabs, (lo, lo_lj, lo_cs), bond_tabs, absorbed
    if band_e is None:
        return tabs
    return tabs, (lo, lo_lj, lo_cs)


def _subtable(t, sel: np.ndarray, pad_atom: int):
    """The rows `sel` (bool over all rows) of a term table, padded with
    invalid rows to a multiple of 8 (atoms `pad_atom`, parameters 0); None
    if none is selected."""
    nkeep = int(sel.sum())
    if nkeep == 0:
        return None
    cap = -(-nkeep // 8) * 8
    out = {}
    for field, arr in t._asdict().items():
        a = _numpy(arr)
        if field == "valid":
            a = np.arange(cap) < nkeep
        else:
            a = a[sel]
            pad = np.full((cap - nkeep,) + a.shape[1:], pad_atom if field == "atoms" else 0, a.dtype)
            a = np.concatenate([a, pad])
        out[field] = torch.from_numpy(a).to(arr.device)
    return type(t)(**out)


def _without_absorbed_bonds(bonded: BondedSystem, absorbed) -> BondedSystem:
    """The system without the bonds that the pair pass absorbed as tags
    (`absorbed` indexes the valid bonds in table order); angles and
    torsions shared."""
    bvalid = _numpy(bonded.bonds.valid)
    keep = np.zeros(len(bvalid), bool)
    keep[np.flatnonzero(bvalid)[~np.asarray(absorbed)]] = True
    return bonded._replace(bonds=_subtable(bonded.bonds, keep, int(_numpy(bonded.bonds.atoms).max())))


def _split_exclusive_terms(bonded: Optional[BondedSystem], leftover_pairs, num_atoms):
    """Partition a system's terms into (exclusive, shared) systems.

    A term is exclusive when each of its atoms appears in exactly one force
    row across every slot-space scatter source (all bonded families and the
    leftover correction pairs): its rows have globally unique targets and
    can be written with a scatter-set.  The multiplicity is invariant under
    the per-rebin atom → slot remap (a bijection), so the split is made
    once, here.  Returns (exclusive or None, shared or None)."""
    if bonded is None:
        return None, None
    counts = np.zeros(num_atoms + 1, np.int64)
    per_table = {}
    for name in _FAMILIES:
        t = getattr(bonded, name)
        if t is None:
            continue
        atoms, valid = _numpy(t.atoms), _numpy(t.valid).astype(bool)
        np.add.at(counts, np.clip(atoms[valid].ravel(), 0, num_atoms), 1)
        per_table[name] = (atoms, valid)
    if leftover_pairs is not None and len(leftover_pairs):
        np.add.at(counts, np.clip(np.asarray(leftover_pairs).ravel(), 0, num_atoms), 1)
    counts[num_atoms] = 2  # pad row: never exclusive

    excl_kw, shared_kw = {}, {}
    for name in _FAMILIES:
        if name not in per_table:
            excl_kw[name] = shared_kw[name] = None
            continue
        atoms, valid = per_table[name]
        is_excl = (counts[np.clip(atoms[valid], 0, num_atoms)] == 1).all(axis=1)
        rows = np.flatnonzero(valid)
        for kw, pick in ((excl_kw, is_excl), (shared_kw, ~is_excl)):
            sel = np.zeros(len(valid), bool)
            sel[rows[pick]] = True
            kw[name] = _subtable(getattr(bonded, name), sel, num_atoms)
    if all(excl_kw[f] is None for f in _FAMILIES):
        return None, bonded
    shared = None if all(shared_kw[f] is None for f in _FAMILIES) else bonded._replace(**shared_kw)
    return bonded._replace(**excl_kw), shared


def _merged_slot_binder(excl_sys, shared_sys, corr_pairs, num_atoms):
    """One atom → slot gather for every per-rebin table binding: the atom
    indices of every table are concatenated once, here, and `bind(atom_slot)`
    maps them in one gather and cuts the result back into the table shapes.
    Returns bind → (exclusive system, shared system, correction slot pairs),
    any of them None when absent; None if there is nothing to bind."""
    chunks, plan = [], {}

    def add(arr):
        a = np.minimum(_numpy(arr).astype(np.int64).ravel(), num_atoms)
        start = sum(c.size for c in chunks)
        chunks.append(a)
        return start, start + a.size

    for label, sys_ in (("bx", excl_sys), ("bs", shared_sys)):
        if sys_ is None:
            continue
        tplan = {name: (add(t.atoms), tuple(t.atoms.shape))
                 for name in _FAMILIES if (t := getattr(sys_, name)) is not None}
        if tplan:
            plan[label] = tplan
    corr_span = None
    if corr_pairs is not None and len(corr_pairs):
        corr_span = (add(corr_pairs), tuple(np.asarray(corr_pairs).shape))
    if not chunks:
        return None
    flat = torch.from_numpy(np.concatenate(chunks))
    on = {}

    def bind(atom_slot):
        dev = atom_slot.device
        if dev not in on:
            on[dev] = flat.to(dev)
        mapped = atom_slot[on[dev]]

        def cut(span_shape):
            (a, b), shape = span_shape
            return mapped[a:b].reshape(shape)

        def rebind(sys_, tplan):
            return sys_._replace(**{name: getattr(sys_, name)._replace(atoms=cut(s)) for name, s in tplan.items()})

        bx = rebind(excl_sys, plan["bx"]) if "bx" in plan else None
        bs = rebind(shared_sys, plan["bs"]) if "bs" in plan else None
        return bx, bs, cut(corr_span) if corr_span is not None else None

    return bind


def make_exclusion_aux_fn(num_atoms, ids_tab, mlj_tab, mcs_tab, bond_tabs=None):
    """aux_fn(state) → slot-space (ids, mlj, mcs[, (kb, kr0, kr02)]) tags.

    One (M³·C)-row gather from a single column-packed atom-indexed table,
    run after every rebin (the slot ↔ atom binding changes only there);
    empty slots index the all-pad row N.  Each returned tag table is
    contiguous, as the force kernel takes it.  bond_tabs: the harmonic-bond
    weights aligned with the tag slots (`build_exclusion_tables(bonds=…)`),
    returned as a fourth element."""
    cols = [ids_tab, mlj_tab] + ([mcs_tab] if mcs_tab is not None else []) + list(bond_tabs or ())
    widths = [int(_numpy(t).shape[-1]) for t in cols]
    packed = torch.from_numpy(np.concatenate([_numpy(t).astype(np.float32) for t in cols], axis=-1))
    on = {}

    def aux_fn(state: CellDenseState):
        dev = state.atom_id.device
        if dev not in on:
            on[dev] = packed.to(dev)
        g = on[dev][torch.clamp(state.atom_id, max=num_atoms).to(torch.int64)]
        parts = iter(t.contiguous() for t in torch.split(g, widths, dim=-1))
        out = (next(parts), next(parts), next(parts) if mcs_tab is not None else None)
        if bond_tabs is not None:
            out += ((next(parts), next(parts), next(parts)),)
        return out

    return aux_fn


def _min_image(d, box):
    return d - torch.round(d / box) * box


def make_slot_pair_correction(num_atoms, pairs, lj_scales, coulomb_scales, model, params, coulomb, charges):
    """Slot-space −(1 − s)·(LJ [+ DSF]) correction for the exclusion pairs
    beyond the tag band.  Per-pair LJ parameters and charge products are
    fixed here; the pairs' atom indices are remapped to slots once per
    rebin.  Returns (bind, force, energy_virial):
      bind(atom_slot) → (P, 2) slot indices;
      force(pos_ext, slot_ij, box) → (ns+1, 3) forces, with `force.rows`
      giving the (idx, rows) for a merged scatter;
      energy_virial(pos_ext, slot_ij, box) → (pe, vir)."""
    dev = model.rc2.device
    pairs_np = np.asarray(_numpy(pairs), np.int64)
    pi, pj = pairs_np[:, 0], pairs_np[:, 1]
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    hs, tse = _numpy(params.half_sigma).astype(np.float32), _numpy(params.twice_sqrt_eps).astype(np.float32)
    hs_i, tse_i, hs_j, tse_j = on(hs[pi]), on(tse[pi]), on(hs[pj]), on(tse[pj])
    w_lj = on(1.0 - np.asarray(_numpy(lj_scales), np.float32))
    pairs_t = torch.from_numpy(pairs_np).to(dev)
    has_q = coulomb is not None and charges is not None
    if has_q:
        q = _numpy(charges).astype(np.float32)
        qi, qj = on(q[pi]), on(q[pj])
        cs = _numpy(coulomb_scales if coulomb_scales is not None else lj_scales)
        w_c = on(1.0 - np.asarray(cs, np.float32))

    def bind(atom_slot):
        return atom_slot[pairs_t]

    def _terms(pos_ext, slot_ij, box):
        from emdee_tpu_torch.potentials.coulomb import coulomb_interaction

        i, j = slot_ij[:, 0], slot_ij[:, 1]
        dv = _min_image(pos_ext[i] - pos_ext[j], box)
        r2 = torch.sum(dv * dv, dim=-1)
        e, mre = pair_interaction(r2, model, hs_i, tse_i, hs_j, tse_j)
        e, mre = w_lj * e, w_lj * mre
        if has_q:
            e_c, mre_c = coulomb_interaction(r2, coulomb, qi, qj)
            e = e + w_c * e_c
            mre = mre + w_c * mre_c
        return i, j, dv, r2, e, mre

    def force_rows(pos_ext, slot_ij, box):
        i, j, dv, r2, _, mre = _terms(pos_ext, slot_ij, box)
        f_ij = (mre / torch.clamp(r2, min=1e-30))[:, None] * dv
        return torch.cat([i, j]), torch.cat([-f_ij, f_ij])

    def force(pos_ext, slot_ij, box):
        idx, rows = force_rows(pos_ext, slot_ij, box)
        return fixed_add(torch.zeros_like(pos_ext), add_plan(idx, pos_ext.shape[0]), rows)

    force.rows = force_rows

    def energy_virial(pos_ext, slot_ij, box):
        *_, e, mre = _terms(pos_ext, slot_ij, box)
        return -torch.sum(e), -torch.sum(mre)

    return bind, force, energy_virial


def slots_to_atoms(state: CellDenseState, num_atoms: int):
    """Slot-layout positions → (N, 3) in atom order (on the device), and
    each slot's atom row (N for empty slots, a trash row that is cut off)."""
    ids = torch.where(state.valid, state.atom_id, num_atoms).reshape(-1).to(torch.int64)
    flat = state.positions.reshape(-1, 3)
    pos = torch.zeros((num_atoms + 1, 3), dtype=flat.dtype, device=flat.device).index_put((ids,), flat)
    return pos[:num_atoms], ids


def _row_targets(system: Optional[BondedSystem], n: int):
    """The target rows of `bonded_force_rows` on positions of n rows,
    without the positions: (R,) int64, or None."""
    if system is None:
        return None
    parts = [torch.clamp(t.atoms[:, col], max=n - 1) for name in _FAMILIES
             if (t := getattr(system, name)) is not None for col in _ROW_COLUMNS[type(t)]]
    return torch.cat(parts) if parts else None


def _any_terms(system) -> bool:
    return system is not None and any(getattr(system, f) is not None for f in _FAMILIES)


def make_molecular_dense_sim(
    config: CellDenseConfig,
    model: LennardJonesModel,
    dt: float,
    num_atoms: int,
    *,
    params=None,
    charges=None,
    coulomb=None,
    exclusion_pairs=None,
    exclusion_scales=None,
    exclusion_scales_coulomb=None,
    bonded: Optional[BondedSystem] = None,
    backend: str = "auto",
    rebin: str = "shift",
    exclusion_mode: str = "kernel",
    exclusion_band: Optional[int] = None,
    thermostat=None,
    barostat=None,
):
    """(rollout, energy) closures for a molecular system in slot space: the
    contract of `make_cell_dense_sim`, with the molecular hooks.  The state
    must come from `cell_dense_init(..., charges=...)` when `coulomb` is
    given; thermostat and barostat forward to `make_cell_dense_sim`.

    params: LJParams in atom order (for the leftover corrections); charges
    (N,) in atom order; coulomb: a `DSFCoulomb` model; exclusion_pairs (P,
    2) atom ids with their LJ and Coulomb scales (missing Coulomb scales
    default to the LJ scales); bonded: a `BondedSystem` in atom order on
    the model's device.

    exclusion_mode: 'kernel' — exclusions as per-pair tag comparisons in
    the pair pass; 'correction' (the atom-space correction pass) raises
    NotImplementedError (ROADMAP item 3).  exclusion_band caps the tag
    width E; pairs beyond it go through the slot-space pair correction.  On
    'cuda' a band wider than the kernel's MAX_TAGS = 8 (or none, with some
    atom past 8 partners) becomes 8 (`kernel_band`).

    The backend is resolved here, against the model's device, as the
    engine resolves it per call: on 'cuda' (the resident kernel, K2c) the
    harmonic bonds ride the exclusion tags, as the reference absorbs them
    on its Pallas backends; 'torch' keeps them on the slot-space gather
    path, as the reference's 'xla' does.  The virial covers pair,
    exclusion and bonded terms."""
    if exclusion_mode not in ("kernel", "correction"):
        raise ValueError(f"unknown exclusion_mode {exclusion_mode!r}")
    pairs = None if exclusion_pairs is None else np.asarray(_numpy(exclusion_pairs))
    has_excl = pairs is not None and pairs.shape[0] > 0
    if has_excl and exclusion_mode == "correction":
        raise NotImplementedError(
            "exclusion_mode='correction' needs apply_exclusion_corrections of the portable neighbor "
            "engine, which is not ported yet (ROADMAP item 3); use exclusion_mode='kernel'")
    if has_excl and exclusion_scales is None:
        exclusion_scales = np.zeros(pairs.shape[0], np.float32)
    if has_excl and params is None:
        raise ValueError("exclusion corrections need atom-ordered LJ params")
    ns = config.num_slots
    resolved = resolve_dense_backend(
        config, backend, device=model.rc2.device, with_coulomb=coulomb is not None, with_excl=has_excl,
    )

    def atom_slot_of(state):
        # Empty slots write into a dump row past the pad row N, so N maps to
        # slot ns (the zero row of the extended positions), deterministically.
        ids = torch.where(state.valid, state.atom_id, num_atoms + 1).reshape(-1).to(torch.int64)
        full = torch.full((num_atoms + 2,), ns, dtype=torch.int64, device=ids.device)
        return full.index_put((ids,), torch.arange(ns, device=ids.device))[: num_atoms + 1]

    def pos_ext(state):
        flat = state.positions.reshape(-1, 3)
        return torch.cat([flat, flat.new_zeros((1, 3))])

    if not has_excl:
        return _bonded_only_sim(config, model, dt, num_atoms, bonded, coulomb, resolved, rebin, thermostat,
                                barostat, atom_slot_of, pos_ext)

    if resolved == "cuda":
        exclusion_band = kernel_band(num_atoms, pairs, exclusion_band)
    cs_for_tables = None
    if coulomb is not None:
        cs_for_tables = exclusion_scales_coulomb if exclusion_scales_coulomb is not None else exclusion_scales
    scales = _numpy(exclusion_scales)
    cs_for_tables = None if cs_for_tables is None else _numpy(cs_for_tables)
    absorb_bonds = bonded is not None and bonded.bonds is not None and resolved == "cuda"
    bonded_force_sys, bond_tabs, leftover = bonded, None, None
    if absorb_bonds:
        bt = bonded.bonds
        bvalid = _numpy(bt.valid).astype(bool)
        bond_arg = (_numpy(bt.atoms)[bvalid], _numpy(bt.k)[bvalid], _numpy(bt.length)[bvalid])
        tabs, leftover, bond_tabs, absorbed = build_exclusion_tables(
            num_atoms, pairs, scales, cs_for_tables, band_e=exclusion_band, bonds=bond_arg,
        )
        bonded_force_sys = _without_absorbed_bonds(bonded, absorbed)
    elif exclusion_band is not None:
        tabs, leftover = build_exclusion_tables(num_atoms, pairs, scales, cs_for_tables, band_e=exclusion_band)
    else:
        tabs = build_exclusion_tables(num_atoms, pairs, scales, cs_for_tables)
    if leftover is not None and leftover[0].shape[0] == 0:
        leftover = None
    aux_fn = make_exclusion_aux_fn(num_atoms, *tabs, bond_tabs=bond_tabs)
    corr = None
    if leftover is not None:
        corr = make_slot_pair_correction(num_atoms, *leftover, model, params, coulomb, charges)

    excl_sys, shared_sys = _split_exclusive_terms(
        bonded_force_sys if _any_terms(bonded_force_sys) else None,
        leftover[0] if leftover is not None else None, num_atoms,
    )
    if bonded is None and corr is None:
        return make_cell_dense_sim(config, model, dt, backend=resolved, rebin=rebin, coulomb=coulomb,
                                   aux_fn=aux_fn, thermostat=thermostat, barostat=barostat)
    binder = _merged_slot_binder(excl_sys, shared_sys if _any_terms(shared_sys) else None,
                                 leftover[0] if corr is not None else None, num_atoms)

    def extra_aux_fn(state):
        """(exclusive system, shared system, correction slot pairs, the
        fixed-order plan of the shared and correction rows, atom → slot)."""
        atom_slot = atom_slot_of(state)
        if binder is None:
            return None, None, None, None, atom_slot
        bx, bs, cbind = binder(atom_slot)
        targets = [t for t in (_row_targets(bs, ns + 1), cbind.t().reshape(-1) if cbind is not None else None)
                   if t is not None]
        plan = add_plan(torch.cat(targets), ns + 1) if targets else None
        return bx, bs, cbind, plan, atom_slot

    def extra_forces(state, eaux):
        bx, bs, cbind, plan, _ = eaux
        if bx is None and plan is None:  # every bond absorbed in the pair pass, nothing else
            return torch.zeros_like(state.positions)
        pos = pos_ext(state)
        box = _state_box(state, config)
        f = torch.zeros_like(pos)
        if bx is not None:
            # Globally unique targets: a scatter-set (the pad row, where
            # every row is 0, is cut off).
            idx, rows = bonded_force_rows(pos, box, bx)
            f = f.index_put((idx,), rows)
        if plan is not None:
            rows = []
            if bs is not None:
                rows.append(bonded_force_rows(pos, box, bs)[1])
            if cbind is not None:
                rows.append(corr[1].rows(pos, cbind, box)[1])
            f = fixed_add(f, plan, torch.cat(rows))
        return f[:-1].reshape(state.positions.shape)

    def extra_energy(state, eaux):
        *_, cbind, _, atom_slot = eaux
        pos = pos_ext(state)
        box = _state_box(state, config)
        pe = torch.zeros((), dtype=pos.dtype, device=pos.device)
        vir = torch.zeros_like(pe)
        if bonded is not None:
            # The full system, absorbed bonds included: the energy closure's
            # pair pass runs without bond tags.
            full = bonded.remap(atom_slot)
            pe = pe + full.energy(pos, box)
            vir = vir + full.virial(pos, box)
        if cbind is not None:
            pe_c, vir_c = corr[2](pos, cbind, box)
            pe = pe + pe_c
            vir = vir + vir_c
        return pe, vir

    return make_cell_dense_sim(
        config, model, dt, backend=resolved, rebin=rebin, coulomb=coulomb, extra_forces=extra_forces,
        extra_energy=extra_energy, aux_fn=aux_fn, extra_aux_fn=extra_aux_fn, thermostat=thermostat,
        barostat=barostat,
    )


def kernel_band(num_atoms: int, pairs, band: Optional[int]) -> Optional[int]:
    """The tag band on the kernel backend: K2c holds at most
    `cell_kernel.MAX_TAGS` tags a slot, so when some atom has more exclusion
    partners than that (and the band does not already cap them), the band
    becomes MAX_TAGS and the rest goes through the slot-pair correction —
    as the reference's `dense_sim_from_system` caps its band when E > 8."""
    pairs = np.asarray(pairs)
    real = pairs[(pairs < num_atoms).all(axis=1)]
    widest = int(np.bincount(real.ravel(), minlength=num_atoms).max()) if len(real) else 0
    if widest > MAX_TAGS and (band is None or band > MAX_TAGS):
        return MAX_TAGS
    return band


def _bonded_only_sim(config, model, dt, num_atoms, bonded, coulomb, backend, rebin, thermostat, barostat,
                     atom_slot_of, pos_ext):
    """A molecular system without exclusions: the pair pass with DSF, and
    the bonded terms in slot space through the fixed-order add."""
    if bonded is None:
        return make_cell_dense_sim(config, model, dt, backend=backend, rebin=rebin, coulomb=coulomb,
                                   thermostat=thermostat, barostat=barostat)
    ns = config.num_slots

    def extra_aux_fn(state):
        atom_slot = atom_slot_of(state)
        bound = bonded.remap(atom_slot)
        return bound, add_plan(_row_targets(bound, ns + 1), ns + 1)

    def extra_forces(state, eaux):
        bound, plan = eaux
        pos = pos_ext(state)
        rows = bonded_force_rows(pos, _state_box(state, config), bound)[1]
        return fixed_add(torch.zeros_like(pos), plan, rows)[:-1].reshape(state.positions.shape)

    def extra_energy(state, eaux):
        bound, _ = eaux
        pos, box = pos_ext(state), _state_box(state, config)
        return bound.energy(pos, box), bound.virial(pos, box)

    return make_cell_dense_sim(config, model, dt, backend=backend, rebin=rebin, coulomb=coulomb,
                               extra_forces=extra_forces, extra_energy=extra_energy, extra_aux_fn=extra_aux_fn,
                               thermostat=thermostat, barostat=barostat)


def dense_sim_from_system(system, **kwargs):
    """The one-call System → dense-engine simulation needs the modelling
    layer (`System`, `ForceField`, `build_bonded_system`) and its fixture
    files, which are not ported yet (ROADMAP item 9)."""
    raise NotImplementedError(
        "dense_sim_from_system needs the modelling layer and its fixture files (ROADMAP item 9); "
        "build the tables and call make_molecular_dense_sim")
