"""Plotting: transient traces, sweep figures, energy landscape drawings
(port of ``pycatkin_tpu/api/plotting.py``, the same figures and file
names).

matplotlib is imported by each function when it is called
(:func:`_pyplot`), so that no module of the port needs it at import
time: a machine without matplotlib runs everything but the plots.
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import eVtoJmol, eVtokJ, eVtokcal

FONT = {"family": "sans-serif", "weight": "normal", "size": 8}

_UNIT_CONV = {"eV": 1.0, "kcal/mol": eVtokcal, "kJ/mol": eVtokJ,
              "J/mol": eVtoJmol}


def _pyplot():
    """``matplotlib.pyplot`` on the headless Agg backend, with the
    package's font and line settings."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.rc("font", **FONT)
    matplotlib.rcParams["lines.markersize"] = 6
    matplotlib.rcParams["lines.linewidth"] = 1.5
    return plt


def _ensure_dir(path):
    if path and not os.path.isdir(path):
        os.makedirs(path, exist_ok=True)


def plot_transient(sim_system, path=None):
    """Coverage / pressure / rate transients (reference
    old_system.py:570-639)."""
    plt = _pyplot()
    _ensure_dir(path)
    spec = sim_system.spec
    T = sim_system.params["temperature"]
    p = sim_system.params["pressure"]
    tag = f"{T:.1f}K_{p / 1e5:.1f}bar"
    times = sim_system.times

    ads = spec.adsorbate_indices
    cmap = plt.get_cmap("tab20", max(len(ads), 1))
    fig, ax = plt.subplots(figsize=(3.2, 3.2))
    for k, i in enumerate(ads):
        if sim_system.solution[:, i].max() > 0.01:
            ax.plot(times / 3600, sim_system.solution[:, i],
                    label=spec.snames[i], color=cmap(k))
    ax.legend(loc="best", frameon=False)
    ax.set(xlabel="Time (hr)", xscale="log", ylabel="Coverage",
           ylim=(-0.1, 1.1), title=f"$T={T:.1f}$ K")
    fig.tight_layout()
    if path is not None:
        fig.savefig(os.path.join(path, f"coverages_{tag}.png"), dpi=300)

    gas = spec.gas_indices
    if len(gas):
        cmap = plt.get_cmap("tab20", len(gas))
        fig, ax = plt.subplots(figsize=(3.2, 3.2))
        for k, i in enumerate(gas):
            ax.plot(times / 3600, sim_system.solution[:, i],
                    label=spec.snames[i], color=cmap(k))
        ax.legend(loc="center right", frameon=False)
        ax.set(xlabel="Time (hr)", xscale="log", ylabel="Pressure (bar)",
               title=f"T = {T:.1f} K")
        fig.tight_layout()
        if path is not None:
            fig.savefig(os.path.join(path, f"pressures_{tag}.png"), dpi=300)
    plt.close("all")


def plot_sweep(sim_system, tag, values, finals, rates, drcs, tof_terms,
               fig_path=None):
    """Sweep result figures (reference presets.py:66-131): coverages,
    pressures, rates, DRCs and TOF vs the swept value."""
    plt = _pyplot()
    _ensure_dir(fig_path)
    spec = sim_system.spec
    values = np.asarray(values)

    ads = spec.adsorbate_indices
    cmap = plt.get_cmap("tab20", max(len(ads), 1))
    fig, ax = plt.subplots(figsize=(3.2, 3.2))
    for k, i in enumerate(ads):
        if finals[:, i].max() > 0.01:
            ax.plot(values, finals[:, i], label=spec.snames[i], color=cmap(k))
    ax.legend(loc="best", frameon=False)
    ax.set(xlabel=tag, ylabel="Coverage", ylim=(-0.1, 1.1))
    fig.tight_layout()
    if fig_path is not None:
        fig.savefig(os.path.join(fig_path, f"coverages_vs_{tag}.png"),
                    dpi=300)

    gas = spec.gas_indices
    if len(gas):
        cmap = plt.get_cmap("tab20", len(gas))
        fig, ax = plt.subplots(figsize=(3.2, 3.2))
        for k, i in enumerate(gas):
            ax.plot(values, finals[:, i], label=spec.snames[i], color=cmap(k))
        ax.legend(loc="best", frameon=False)
        ax.set(xlabel=tag, ylabel="Pressure (bar)")
        fig.tight_layout()
        if fig_path is not None:
            fig.savefig(os.path.join(fig_path, f"pressures_vs_{tag}.png"),
                        dpi=300)

    cmap = plt.get_cmap("tab20", spec.n_reactions)
    fig, ax = plt.subplots(figsize=(3.2, 3.2))
    for j, r in enumerate(spec.rnames):
        ax.plot(values, rates[:, j], label=r, color=cmap(j))
    ax.legend(loc="best", frameon=False)
    yv = ax.get_ylim()
    ax.set(xlabel=tag, ylabel="Rate (1/s)", yscale="log",
           ylim=(max(1e-10, yv[0]), yv[1]))
    fig.tight_layout()
    if fig_path is not None:
        fig.savefig(os.path.join(fig_path, f"surfrates_vs_{tag}.png"),
                    dpi=300)

    if tof_terms is not None and drcs:
        fig, ax = plt.subplots(figsize=(3.2, 3.2))
        for j, r in enumerate(spec.rnames):
            drc = [drcs[v][r] for v in values]
            if max(abs(d) for d in drc) > 0.01:
                ax.plot(values, drc, label=r, color=cmap(j))
        ax.set(xlabel=tag, ylabel="Degree of rate control")
        ax.legend(loc="best", frameon=False)
        fig.tight_layout()
        if fig_path is not None:
            fig.savefig(os.path.join(fig_path, f"drc_vs_{tag}.png"), dpi=300)

        tof_idx = [spec.rindex(t) for t in tof_terms]
        fig, ax = plt.subplots(figsize=(3.2, 3.2))
        ax.plot(values, rates[:, tof_idx].sum(axis=1), color="k")
        ax.set(xlabel=tag, ylabel="TOF (1/s)", yscale="log")
        fig.tight_layout()
        if fig_path is not None:
            fig.savefig(os.path.join(fig_path, f"tof_vs_{tag}.png"), dpi=300)
    plt.close("all")


def _landscape_points(landscape, etype, conv):
    """Polyline through minima with cubic TS arcs (reference
    energy.py:95-121); clamped cubic Hermite between plateau edges."""
    energies = landscape.energy_landscape[etype]
    is_ts = landscape.energy_landscape["isTS"]
    n = len(energies)
    xs, ys = [], []

    def hermite(x0, y0, x1, y1, num=100):
        # clamped cubic: zero slope at both ends (CubicSpline bc 'clamped')
        t = np.linspace(0.0, 1.0, num)
        h = 3 * t**2 - 2 * t**3
        return x0 + (x1 - x0) * t, y0 + (y1 - y0) * h

    for i in range(n):
        d = 0.25
        if not is_ts[i]:
            xs += [i - d, i + d]
            ys += [energies[i] * conv, energies[i] * conv]
        else:
            x, y = hermite(i - 1 + d, energies[i - 1], i, energies[i])
            xs += list(x)
            ys += [v * conv for v in y]
            x, y = hermite(i, energies[i], i + 1 - d, energies[i + 1])
            xs += list(x)
            ys += [v * conv for v in y]
    return xs, ys


def draw_energy_landscape(landscape, T, p, etype="free", eunits="eV",
                          legend_location="upper right", path=None,
                          show_labels=False, figtitle=None, verbose=False):
    """Single-landscape drawing (reference energy.py:62-156)."""
    plt = _pyplot()
    landscape._landscape_vector(T, p, etype, verbose)
    conv = _UNIT_CONV.get(eunits, 1.0)
    fig, ax = plt.subplots(figsize=(10, 4))
    xs, ys = _landscape_points(landscape, etype, conv)
    ax.plot(xs, ys, "-", color="black")
    energies = landscape.energy_landscape[etype]
    is_ts = landscape.energy_landscape["isTS"]
    seen_ts = seen_i = False
    for k in range(len(energies)):
        if is_ts[k]:
            ax.plot(k, energies[k] * conv, "s", color="tomato",
                    label=("Transition state" if not seen_ts else ""))
            seen_ts = True
        else:
            ax.plot(k, energies[k] * conv, "s", color="darkturquoise",
                    label=("Intermediate" if not seen_i else ""))
            seen_i = True
        ax.text(k, energies[k] * conv + 0.2 * conv,
                f"{energies[k] * conv:.3g}", ha="center")
        if show_labels:
            ax.text(k, energies[k] * conv - 0.2 * conv,
                    landscape.labels[k], ha="center", va="top")
    ax.legend(loc=legend_location)
    ax.set(xlabel="Reaction coordinate",
           ylabel=f"Relative {etype} energy ({eunits})")
    plt.tick_params(axis="x", which="both", bottom=False, top=False,
                    labelbottom=False)
    if figtitle:
        ax.set(title=figtitle)
    fig.tight_layout()
    if path is not None:
        _ensure_dir(path)
        fig.savefig(os.path.join(
            path, f"{etype}_energy_{landscape.name}.png"), dpi=300)
    return fig, ax


def draw_energy_landscapes(sim_system, etype="free", eunits="eV",
                           legend_location="upper right", show_labels=False,
                           fig_path=None):
    """All landscapes of a system (reference presets.py:323-340)."""
    plt = _pyplot()
    for landscape in sim_system.energy_landscapes.values():
        draw_energy_landscape(landscape, T=sim_system.params["temperature"],
                              p=sim_system.params["pressure"], etype=etype,
                              eunits=eunits,
                              legend_location=legend_location,
                              path=fig_path, show_labels=show_labels)
    plt.close("all")


def compare_energy_landscapes(sim_systems, landscapes=None, etype="free",
                              eunits="eV", legend_location=None,
                              show_labels=False, fig_path=None, cmap=None):
    """Overlay landscapes from multiple systems (reference
    presets.py:501-556)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    conv = _UNIT_CONV.get(eunits, 1.0)
    # Accept one system, a list of systems, or a name->system dict
    # (the reference examples use all three call styles).
    if isinstance(sim_systems, dict):
        sys_items = list(sim_systems.items())
    elif isinstance(sim_systems, (list, tuple)):
        sys_items = [(getattr(s, "name", f"system{i}"), s)
                     for i, s in enumerate(sim_systems)]
    else:
        sys_items = [(getattr(sim_systems, "name", "system"), sim_systems)]
    items = []
    for sname, sim in sys_items:
        for lname, landscape in sim.energy_landscapes.items():
            if landscapes is None or lname in landscapes:
                label = lname if len(sys_items) == 1 else f"{sname}:{lname}"
                items.append((label, sim, landscape))
    if cmap is None:
        cmap = plt.get_cmap("tab20", len(items))
    for idx, (label, sim, landscape) in enumerate(items):
        landscape._landscape_vector(sim.params["temperature"],
                                    sim.params["pressure"], etype)
        xs, ys = _landscape_points(landscape, etype, conv)
        ax.plot(xs, ys, "-", color=cmap(idx), label=label)
    if legend_location is not None:
        ax.legend(loc=legend_location)
    ax.set(xlabel="Reaction coordinate",
           ylabel=f"Relative {etype} energy ({eunits})")
    plt.tick_params(axis="x", which="both", bottom=False, top=False,
                    labelbottom=False)
    fig.tight_layout()
    if fig_path is not None:
        _ensure_dir(fig_path)
        fig.savefig(os.path.join(fig_path, f"{etype}_energy_landscapes.png"),
                    dpi=300)
    return fig, ax


def plot_data_simple(fig=None, ax=None, xdata=None, ydata=None, label=None,
                     linestyle="-", color="k", xlabel=None, ylabel=None,
                     title=None, addlegend=False, legendloc="best",
                     fig_path=None, fig_name="figure"):
    """Generic data plot helper (reference presets.py:559-582)."""
    plt = _pyplot()
    if fig is None or ax is None:
        fig, ax = plt.subplots(figsize=(3.2, 3.2))
    ax.plot(xdata, ydata, linestyle, color=color, label=label)
    ax.set(xlabel=xlabel, ylabel=ylabel, title=title)
    if addlegend:
        ax.legend(loc=legendloc, frameon=False)
    fig.tight_layout()
    if fig_path is not None:
        _ensure_dir(fig_path)
        fig.savefig(os.path.join(fig_path, f"{fig_name}.png"), dpi=300)
    return fig, ax
