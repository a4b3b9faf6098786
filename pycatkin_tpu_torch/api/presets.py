"""Preset batch workflows over a loaded :class:`System` (port of
``pycatkin_tpu/api/presets.py``).

``run``, temperature and parameter sweeps with an optional steady-state
solve and degree of rate control, energy-span sweeps, reaction and state
energy exports and the transient's CSV export. A sweep runs as lane
batches of the port's engine: one ``batch_transient``, one
``batch_steady_state`` and one DRC call over all its points, on the
System's device.

The CSV files have the JAX package's names, columns and bytes: they are
written with the ``csv`` module in the form pandas' ``to_csv(index=False)``
gives (a column of integers as integers, a column of numbers as
float64 in shortest round-trip form, NaN as an empty field, ``\\n`` line
ends), so this module needs no pandas.

The sweep's steady solve runs under the degradation ladder
(``robustness/ladder.run_chunk_with_ladder``, label ``preset:steady``)
with the JAX package's validator: a solve that fails on every rung
degrades to the transient finals with a ``transient-fallback``
degradation event and a warning instead of killing the sweep.
"""

from __future__ import annotations

import csv
import numbers
import os
import sys

import numpy as np
import torch

from .. import engine
from ..parallel.batch import (batch_steady_state, batch_transient,
                              stack_conditions)
from ..robustness.ladder import run_chunk_with_ladder
from ..solvers.ode import log_time_grid
from .system import _host


def _ensure_dir(path):
    if path and not os.path.isdir(path):
        os.makedirs(path, exist_ok=True)


def _column_text(values) -> list:
    """One column's fields as pandas writes them: integers as integers,
    other numbers as float64 (shortest round trip, NaN empty), anything
    else by ``str``."""
    def is_int(v):
        return isinstance(v, (numbers.Integral, np.integer)) and \
            not isinstance(v, (bool, np.bool_))
    if all(is_int(v) for v in values):
        return [str(int(v)) for v in values]
    if all(isinstance(v, (numbers.Real, np.number)) for v in values):
        return ["" if np.isnan(v) else repr(float(v))
                for v in np.asarray(values, dtype=np.float64)]
    return [str(v) for v in values]


def write_csv(path, columns, rows) -> None:
    """Write ``rows`` (a list of rows or a 2-D array) under the header
    ``columns`` byte for byte as ``pandas.DataFrame(rows,
    columns=columns).to_csv(path, index=False)`` does."""
    rows = [list(r) for r in rows]
    cols = [_column_text([r[j] for r in rows]) for j in range(len(columns))]
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(columns)
        w.writerows(zip(*cols) if rows else [])


def run(sim_system, steady_state_solve=False, plot_results=False,
        save_results=False, fig_path=None, csv_path=""):
    """Transient solve, then optional plots, CSV export and steady
    state."""
    sim_system.solve_odes()
    if plot_results:
        from .plotting import plot_transient
        plot_transient(sim_system, path=fig_path)
    if save_results:
        write_results(sim_system, path=csv_path)
    if steady_state_solve:
        sim_system.find_steady(store_steady=True)


def _sweep(sim_system, values, set_value, steady_state_solve, tof_terms,
           eps, drc_mode):
    """The machinery shared by run_temperatures / run_parameters: one
    lane per value; the transient, then (optionally) the steady solve
    from its finals and the DRC from the finals, each one batched call.
    Returns numpy ``(finals [L, n_s], rates [L, n_r], drcs)``."""
    spec = sim_system.spec
    conds = []
    for v in values:
        set_value(v)
        conds.append(sim_system.conditions())
    batched = stack_conditions(conds)
    dev = sim_system.device

    times = sim_system.params["times"]
    grid = log_time_grid(times[0], times[-1],
                         sim_system.params.get("n_out", 300))
    ys, ok = batch_transient(spec, batched, grid, sim_system._ode_options(),
                             device=dev)
    ok = _host(ok)
    if not bool(np.all(ok)):
        idx = np.flatnonzero(~ok)
        bad = [values[i] for i in idx]
        print(f"Warning: transient integration incomplete for lanes "
              f"{idx.tolist()} (sweep values {bad}); downstream results "
              "for those lanes are unreliable", file=sys.stderr)
    finals = ys[:, -1, :]

    sopts = sim_system.solver_options()
    if steady_state_solve:
        def run_steady(device=None):
            x0 = finals[:, spec.dynamic_indices]
            return batch_steady_state(
                spec, batched, x0=x0 if device is None else x0.to(device),
                opts=sopts, device=dev if device is None else device)

        def reject_poisoned(res):
            bad = _host(res.success) & ~np.all(np.isfinite(_host(res.x)),
                                               axis=-1)
            return (f"{int(bad.sum())} converged lane(s) with non-finite "
                    "state" if bad.any() else None)

        res, _ = run_chunk_with_ladder(run_steady, label="preset:steady",
                                       validate=reject_poisoned, device=dev)
        if res is None:
            from ..utils import profiling
            lanes = list(range(len(values)))
            detail = (f"steady solve failed on every degradation rung; "
                      f"lanes {lanes} (sweep values {list(values)}) "
                      f"degraded to transient finals")
            profiling.record_event("degradation", label="preset:steady",
                                   rung="transient-fallback",
                                   detail=detail, lanes=lanes)
            print(f"Warning: {detail} (see diagnostics events)",
                  file=sys.stderr)
        else:
            finals = res.x.to(finals.device)
            success = _host(res.success)
            if not bool(np.all(success)):
                idx = np.flatnonzero(~success)
                bad = [values[i] for i in idx]
                print(f"Warning: steady solve unconverged for lanes "
                      f"{idx.tolist()} (sweep values {bad})",
                      file=sys.stderr)

    ds = sim_system.device_spec()
    cd = engine.conditions_to(batched, dev)
    fwd, rev = engine.reaction_rates_at(ds, cd, finals)
    rates = _host(fwd - rev)

    drcs = {}
    if tof_terms is not None:
        x0s = finals[:, ds.dyn]
        if drc_mode == "fd":
            # Not sopts: drc_fd's tightened defaults are what make the
            # difference quotient meaningful.
            xis, drc_ok = engine.drc_fd(ds, cd, list(tof_terms), eps=eps,
                                        x0=x0s)
            drc_ok = _host(drc_ok)
        else:
            xis = engine.drc(ds, cd, list(tof_terms), opts=sopts, x0=x0s)
            drc_ok = np.ones(len(values), dtype=bool)
        xis = _host(xis)
        if not drc_ok.all():
            idx = np.flatnonzero(~drc_ok)
            bad = [values[i] for i in idx]
            print(f"Warning: DRC perturbed steady solves unconverged for "
                  f"lanes {idx.tolist()} (sweep values {bad}); xi for "
                  "those lanes is unreliable (prefer "
                  "drc_mode='implicit')", file=sys.stderr)
        for i, v in enumerate(values):
            drcs[v] = dict(zip(spec.rnames, xis[i]))
    return _host(finals), rates, drcs


def run_temperatures(sim_system, temperatures, steady_state_solve=False,
                     tof_terms=None, eps=5.0e-2, plot_results=False,
                     save_results=False, fig_path=None, csv_path="",
                     drc_mode="implicit"):
    """Temperature sweep with an optional steady solve and DRC
    (``drc_mode`` ``"implicit"`` or ``"fd"``); returns ``(finals, rates,
    drcs)``."""
    T0 = sim_system.params["temperature"]

    def set_T(T):
        sim_system.params["temperature"] = T

    finals, rates, drcs = _sweep(sim_system, list(temperatures), set_T,
                                 steady_state_solve, tof_terms, eps,
                                 drc_mode)
    sim_system.params["temperature"] = T0

    if save_results:
        _save_sweep(sim_system, "temperature", "Temperature (K)",
                    list(temperatures), finals, rates, drcs, tof_terms,
                    csv_path)
    if plot_results:
        from .plotting import plot_sweep
        plot_sweep(sim_system, "temperature", list(temperatures), finals,
                   rates, drcs, tof_terms, fig_path)
    return finals, rates, drcs


def run_parameters(sim_system, parameters, params_name,
                   steady_state_solve=False, tof_terms=None, eps=5.0e-2,
                   plot_results=False, save_results=False, fig_path=None,
                   csv_path="", drc_mode="implicit"):
    """Sweep over any params key, including start_state_X /
    inflow_state_X entries."""

    def set_param(v):
        if "start_state" in params_name:
            key = params_name.split("start_state_")[1]
            sim_system.params["start_state"][key] = v
        elif "inflow_state" in params_name:
            key = params_name.split("inflow_state_")[1]
            sim_system.params["inflow_state"][key] = v
        else:
            sim_system.params[params_name] = v

    finals, rates, drcs = _sweep(sim_system, list(parameters), set_param,
                                 steady_state_solve, tof_terms, eps,
                                 drc_mode)
    if save_results:
        _save_sweep(sim_system, params_name, params_name, list(parameters),
                    finals, rates, drcs, tof_terms, csv_path)
    if plot_results:
        from .plotting import plot_sweep
        plot_sweep(sim_system, params_name, list(parameters), finals, rates,
                   drcs, tof_terms, fig_path)
    return finals, rates, drcs


def _save_sweep(sim_system, tag, header0, values, finals, rates, drcs,
                tof_terms, csv_path):
    _ensure_dir(csv_path)
    spec = sim_system.spec
    vcol = np.reshape(values, (len(values), 1))

    write_csv(os.path.join(csv_path, f"rates_vs_{tag}.csv"),
              [header0] + list(spec.rnames),
              np.concatenate((vcol, rates), axis=1))

    ads = spec.adsorbate_indices
    write_csv(os.path.join(csv_path, f"coverages_vs_{tag}.csv"),
              [header0] + [spec.snames[i] for i in ads],
              np.concatenate((vcol, finals[:, ads]), axis=1))

    gas = spec.gas_indices
    write_csv(os.path.join(csv_path, f"pressures_vs_{tag}.csv"),
              [header0] + [f"p{spec.snames[i]} (bar)" for i in gas],
              np.concatenate((vcol, finals[:, gas]), axis=1))

    if tof_terms is not None:
        vals = np.zeros((len(values), spec.n_reactions + 1))
        vals[:, 0] = values
        for i, v in enumerate(values):
            vals[i, 1:] = np.array(list(drcs[v].values()))
        write_csv(os.path.join(csv_path, f"drcs_vs_{tag}.csv"),
                  [header0] + list(spec.rnames), vals)


def run_energy_span_temperatures(sim_system, temperatures, etype="free",
                                 save_results=False, csv_path=""):
    """Energy-span model over a temperature range; writes
    energy_span_summary_<k>.csv plus the xTDTS / xTDI tables."""
    _ensure_dir(csv_path)
    out = {}
    for k, landscape in sim_system.energy_landscapes.items():
        esm = {}
        for T in temperatures:
            esm[T] = landscape.evaluate_energy_span_model(
                T=T, p=sim_system.params["pressure"],
                verbose=sim_system.params["verbose"], etype=etype)
        out[k] = esm
        if save_results:
            write_csv(os.path.join(csv_path, f"energy_span_summary_{k}.csv"),
                      ["Temperature (K)", "TOF (1/s)", "Espan (eV)", "TDTS",
                       "TDI"],
                      [[T] + list(esm[T][0:4]) for T in temperatures])
            write_csv(os.path.join(csv_path, f"energy_span_xTDTS_{k}.csv"),
                      ["Temperature (K)"] + esm[temperatures[0]][6],
                      [[T] + esm[T][4] for T in temperatures])
            write_csv(os.path.join(csv_path, f"energy_span_xTDI_{k}.csv"),
                      ["Temperature (K)"] + esm[temperatures[0]][7],
                      [[T] + esm[T][5] for T in temperatures])
    return out


_ENERGY_COLUMNS = ["dEr (J/mol)", "dGr (J/mol)", "dEa (J/mol)",
                   "dGa (J/mol)"]


def _energy_row(re, j):
    return [float(re.dErxn[j]), float(re.dGrxn[j]), float(re.dEa_fwd[j]),
            float(re.dGa_fwd[j])]


def save_energies(sim_system, csv_path=""):
    """Reaction energies and barriers at the current (T, p); returns the
    rows written (header first)."""
    _ensure_dir(csv_path)
    T = sim_system.params["temperature"]
    p = sim_system.params["pressure"]
    re = sim_system.reaction_energy_table()
    columns = ["Reaction"] + _ENERGY_COLUMNS
    rows = [[r] + _energy_row(re, j)
            for j, r in enumerate(sim_system.spec.rnames)]
    fname = f"reaction_energies_and_barriers_{T:.1f}K_{p / 1e5:.1f}bar.csv"
    write_csv(os.path.join(csv_path, fname), columns, rows)
    return [columns] + rows


def save_energies_temperatures(sim_system, temperatures, csv_path=""):
    """One reaction-energy table over T per reaction."""
    _ensure_dir(csv_path)
    spec = sim_system.spec
    rows = {r: [] for r in spec.rnames}
    for T in temperatures:
        re = sim_system.reaction_energy_table(T=T)
        for j, r in enumerate(spec.rnames):
            rows[r].append([T] + _energy_row(re, j))
    for r in spec.rnames:
        write_csv(os.path.join(csv_path,
                               f"reaction_energies_and_barriers_{r}.csv"),
                  ["Temperature (K)"] + _ENERGY_COLUMNS, rows[r])


def save_state_energies(sim_system, csv_path=""):
    """State energies at the current (T, p), with the JAX package's
    column labels (upstream PyCatKin swaps 'Translational' and
    'Rotational'); returns the rows written (header first)."""
    _ensure_dir(csv_path)
    T = sim_system.params["temperature"]
    p = sim_system.params["pressure"]
    fe = sim_system.free_energy_table()
    columns = ["State", "Free (eV)", "Electronic (eV)", "Vibrational (eV)",
               "Translational (eV)", "Rotational (eV)"]
    rows = [[s, float(fe.gfree[i]), float(fe.gelec[i]), float(fe.gvibr[i]),
             float(fe.gtran[i]), float(fe.grota[i])]
            for i, s in enumerate(sim_system.spec.snames)]
    fname = f"state_energies_{T:.1f}K_{p / 1e5:.1f}bar.csv"
    write_csv(os.path.join(csv_path, fname), columns, rows)
    return [columns] + rows


def save_pes_energies(sim_system, csv_path=""):
    """Relative landscape energies of each energy landscape."""
    _ensure_dir(csv_path)
    T = sim_system.params["temperature"]
    p = sim_system.params["pressure"]
    for k, landscape in sim_system.energy_landscapes.items():
        landscape.construct_energy_landscape(T=T, p=p)
        rows = [[landscape.labels[s],
                 landscape.energy_landscape["free"][s],
                 landscape.energy_landscape["electronic"][s]]
                for s in range(len(landscape.minima))]
        fname = f"{k}_energy_landscape_{T:.1f}K_{p / 1e5:.1f}bar.csv"
        write_csv(os.path.join(csv_path, fname),
                  ["State", "Free (eV)", "Electronic (eV)"], rows)


def write_results(sim_system, path=""):
    """The transient's rates, coverages and pressures as CSV files."""
    _ensure_dir(path)
    spec = sim_system.spec
    T = sim_system.params["temperature"]
    p = sim_system.params["pressure"]
    tag = f"{T:.1f}K_{p / 1e5:.1f}bar"
    times = sim_system.times.reshape(-1, 1)

    ds = sim_system.device_spec()
    cond = sim_system.lane()
    kf, kr, _ = engine.rate_constants(ds, cond)
    y = torch.as_tensor(sim_system.solution, dtype=torch.float64,
                        device=ds.device)
    n = y.shape[0]
    fwd, rev = engine.reaction_rates_at(ds, cond, y, kf.expand(n, -1),
                                        kr.expand(n, -1))
    rmat = _host(torch.stack([fwd, rev], dim=-1)).reshape(len(times), -1)
    write_csv(os.path.join(path, f"rates_{tag}.csv"),
              ["Time (s)"] + [c for r in spec.rnames
                              for c in (f"{r}_fwd", f"{r}_rev")],
              np.concatenate((times, rmat), axis=1))

    ads = spec.adsorbate_indices
    write_csv(os.path.join(path, f"coverages_{tag}.csv"),
              ["Time (s)"] + [spec.snames[i] for i in ads],
              np.concatenate((times, sim_system.solution[:, ads]), axis=1))

    gas = spec.gas_indices
    write_csv(os.path.join(path, f"pressures_{tag}.csv"),
              ["Time (s)"] + [spec.snames[i] for i in gas],
              np.concatenate((times, sim_system.solution[:, gas]), axis=1))


def save_structures(sim_system, fig_path="", types_to_skip=("TS",),
                    render_png=True):
    """Every state's structure as a .pdb file plus a headless .png
    render; returns ``{name: pdb_path}`` for the states that had
    structure data."""
    written = {}
    for name, st in sim_system.states.items():
        if st.state_type in types_to_skip:
            continue
        fname = st.save_pdb(path=fig_path)
        if fname:
            written[name] = fname
            if render_png:
                st.save_png(path=fig_path)
    return written


def get_tof_for_given_reactions(sim_system, tof_terms):
    """Summed net rates of the named steps at the last transient point."""
    mask = torch.as_tensor(engine.tof_mask_for(sim_system.spec, tof_terms),
                           dtype=torch.float64, device=sim_system.device)
    y = torch.as_tensor(sim_system.solution[-1], dtype=torch.float64,
                        device=sim_system.device)[None]
    return float(engine.tof(sim_system.device_spec(), sim_system.lane(), y,
                            mask)[0])
