"""Serialization: the wire form of a mechanism, result checkpoints and
JSON-lines files (port of the parts of ``pycatkin_tpu/utils/io.py`` the
serving path calls).

:func:`system_to_dict` serializes a System (with all resolved energies
and frequencies inlined) back into the reference input schema: the form
in which clients send a mechanism to the sweep server, and which
:func:`..frontend.loader.read_from_input_file` reads back. The JAX
package's ``system_to_dict`` writes the same schema, so a mechanism sent
by either package loads into the same spec. Sweep results checkpoint as
``.npz`` bundles (:func:`save_results`, :func:`atomic_save_results`);
:func:`append_json_line` / :func:`read_json_lines` keep the coalescer's
``events.jsonl``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..frontend.reactions import (ReactionDerivedReaction,
                                  UserDefinedReaction)
from ..frontend.states import GAS, ScalingState
from ..models.reactor import CSTReactor


def _state_cfg(st, sname=None) -> dict:
    """Serialize one state. ``sname`` maps gasdata partner State ->
    checkpoint name (needed for inlined donor states that were renamed
    on collision)."""
    if sname is None:
        sname = lambda s: s.name  # noqa: E731
    st.load()
    cfg = {"state_type": st.state_type}
    if st.sigma is not None:
        cfg["sigma"] = st.sigma
    if st.mass is not None:
        cfg["mass"] = st.mass
    if st.inertia is not None:
        cfg["inertia"] = list(np.asarray(st.inertia, dtype=float).ravel())
    if st.freq is not None and np.asarray(st.freq).size:
        cfg["freq"] = list(np.asarray(st.freq, dtype=float).ravel())
        if st.i_freq is not None and np.asarray(st.i_freq).size:
            cfg["i_freq"] = list(np.asarray(st.i_freq, dtype=float).ravel())
    for key in ("Gelec", "Gzpe", "Gvibr", "Gtran", "Grota", "Gfree"):
        val = getattr(st, key)
        if val is not None:
            cfg[key] = val
    if st.add_to_energy:
        cfg["add_to_energy"] = st.add_to_energy
    if not st.truncate_freq:
        cfg["truncate_freq"] = False
    if st.gasdata is not None:
        cfg["gasdata"] = {
            "fraction": list(st.gasdata["fraction"]),
            "state": [sname(s) if hasattr(s, "name") else s
                      for s in st.gasdata["state"]],
        }
    if isinstance(st, ScalingState):
        cfg["scaling_coeffs"] = st.scaling_coeffs
        cfg["scaling_reactions"] = {
            key: {"reaction": (e["reaction"].name
                               if hasattr(e["reaction"], "name")
                               else e["reaction"]),
                  **({"multiplicity": e["multiplicity"]}
                     if "multiplicity" in e else {})}
            for key, e in st.scaling_reactions.items()}
        if st.dereference:
            cfg["dereference"] = True
        if st.use_descriptor_as_reactant:
            cfg["use_descriptor_as_reactant"] = True
    return cfg


def _reaction_cfg(rx, sname=None, base_names=None) -> dict:
    """Serialize one reaction. ``sname`` maps State -> checkpoint name
    (defaults to the state's own name); ``base_names`` maps id(base
    reaction) -> checkpoint name for foreign donor bases."""
    if sname is None:
        sname = lambda s: s.name  # noqa: E731
    cfg = {"reac_type": rx.reac_type,
           "area": rx.area,
           "reactants": [sname(s) for s in rx.reactants],
           "products": [sname(s) for s in rx.products],
           "TS": [sname(s) for s in rx.TS] if rx.TS else None}
    if not rx.reversible:
        cfg["reversible"] = False
    if rx.scaling != 1.0:
        cfg["scaling"] = rx.scaling
    if isinstance(rx, ReactionDerivedReaction):
        base = rx.base_reaction
        cfg["base_reaction"] = ((base_names or {}).get(id(base))
                                or base.name)
    if isinstance(rx, UserDefinedReaction):
        for key in ("dErxn_user", "dGrxn_user", "dEa_fwd_user",
                    "dGa_fwd_user", "dEa_rev_user", "dGa_rev_user"):
            val = getattr(rx, key)
            if val is not None:
                cfg[key] = val
    return cfg


def _collect_foreign_bases(sim):
    """Foreign donor base reactions/states of ReactionDerivedReactions
    (Butadiene-style MKM: bases live in a donor DFT system). Returns
    (base_states {ckpt name -> State}, base_rx {ckpt name -> Reaction},
    sname mapper, base_names {id(rx) -> ckpt name}) so the checkpoint can
    inline the donor energetics and reload WITHOUT re-supplying
    base_system."""
    base_states, base_rx = {}, {}
    state_names, base_names = {}, {}
    taken_states = set(sim.states)
    taken_rx = set(sim.reactions)

    def fresh(name, taken, extra):
        out, k = name, 1
        while out in taken or out in extra:
            out = f"{name}@base{k}"
            k += 1
        return out

    # Transitive worklist: a donor base may itself be derived from yet
    # another donor reaction.
    work = [rx.base_reaction for rx in sim.reactions.values()
            if isinstance(rx, ReactionDerivedReaction)]
    while work:
        b = work.pop()
        if sim.reactions.get(b.name) is b or id(b) in base_names:
            continue
        bname = fresh(b.name, taken_rx, base_rx)
        base_names[id(b)] = bname
        base_rx[bname] = b
        if isinstance(b, ReactionDerivedReaction):
            work.append(b.base_reaction)
        for s in list(b.reactants) + list(b.products) + list(b.TS or []):
            if id(s) in state_names or sim.states.get(s.name) is s:
                continue
            if s.is_scaling:
                raise NotImplementedError(
                    f"donor base state {s.name} is a ScalingState; "
                    "scaling relations must resolve within one system "
                    "(build_spec enforces the same)")
            nm = fresh(s.name, taken_states, base_states)
            state_names[id(s)] = nm
            base_states[nm] = s
            # Inline gasdata partners of donor states too, so the
            # checkpoint's gas-mixture corrections resolve on reload.
            for g in (s.gasdata or {}).get("state", []):
                if (hasattr(g, "name") and id(g) not in state_names
                        and sim.states.get(g.name) is not g):
                    gn = fresh(g.name, taken_states, base_states)
                    state_names[id(g)] = gn
                    base_states[gn] = g

    def sname(s):
        return state_names.get(id(s), s.name)

    return base_states, base_rx, sname, base_names


def system_to_dict(sim) -> dict:
    """Serialize a System into the reference input-file schema with all
    resolved data inlined -- the pickle-replacement checkpoint. Foreign
    donor base reactions (and their states) are inlined under the
    'base reactions' / 'base states' extension sections, which the loader
    reads back as energy-only donors."""
    p = sim.params["pressure"]
    states, scaling = {}, {}
    for name, st in sim.states.items():
        (scaling if isinstance(st, ScalingState) else states)[name] = \
            _state_cfg(st)

    base_states, base_rx, sname, base_names = _collect_foreign_bases(sim)

    plain, manual, derived = {}, {}, {}
    for name, rx in sim.reactions.items():
        cfg = _reaction_cfg(rx, base_names=base_names)
        if isinstance(rx, ReactionDerivedReaction):
            derived[name] = cfg
        elif isinstance(rx, UserDefinedReaction):
            manual[name] = cfg
        else:
            plain[name] = cfg

    def _unscale_gas(entries):
        # Stored in bar; the schema holds fractions of total pressure
        # (loader multiplies by p/1e5, reference load_input.py:50).
        out = {}
        for name, val in (entries or {}).items():
            if sim.states[name].state_type == GAS:
                out[name] = val / (p / 1.0e5)
            else:
                out[name] = val
        return out

    sys_cfg = {
        "times": list(sim.params["times"]) if sim.params["times"] else None,
        "T": sim.params["temperature"],
        "p": p,
        "start_state": _unscale_gas(sim.params.get("start_state")),
        "verbose": sim.params["verbose"],
        "use_jacobian": sim.params["jacobian"],
        "rtol": sim.params["rtol"],
        "atol": sim.params["atol"],
    }
    if sim.params.get("inflow_state"):
        sys_cfg["inflow_state"] = _unscale_gas(sim.params["inflow_state"])
    if getattr(sim, "desorption_model", "detailed_balance") != \
            "detailed_balance":
        sys_cfg["desorption_model"] = sim.desorption_model

    cfg = {"states": states}
    if scaling:
        cfg["scaling relation states"] = scaling
    if base_states:
        cfg["base states"] = {n: _state_cfg(s, sname=sname)
                              for n, s in base_states.items()}
    cfg["system"] = sys_cfg
    if plain:
        cfg["reactions"] = plain
    if manual:
        cfg["manual reactions"] = manual
    if base_rx:
        cfg["base reactions"] = {
            n: _reaction_cfg(r, sname=sname, base_names=base_names)
            for n, r in base_rx.items()}
    if derived:
        cfg["reaction derived reactions"] = derived
    if sim.reactor is not None:
        if isinstance(sim.reactor, CSTReactor):
            params = {k: v for k, v in sim.reactor.params().items()
                      if v is not None}
            cfg["reactor"] = {"CSTReactor": params}
        else:
            cfg["reactor"] = "InfiniteDilutionReactor"
    if sim.energy_landscapes:
        cfg["energy landscapes"] = {
            name: {"minima": [[s.name for s in entry]
                              for entry in lsc.minima],
                   "labels": list(lsc.labels)}
            for name, lsc in sim.energy_landscapes.items()}
    return cfg


def save_system_json(sim, path: str):
    """Checkpoint a System as a reference-schema JSON input file (tmp +
    ``os.replace``: a reader never parses a torn file)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(system_to_dict(sim), fh, indent=1)
    os.replace(tmp, path)


def save_results(path: str, **arrays):
    """Checkpoint sweep/grid result arrays as a compressed ``.npz``
    (replaces the reference's per-run pickle dumps for results)."""
    np.savez_compressed(path, **{k: np.asarray(v)
                                 for k, v in arrays.items()})


def load_results(path: str) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def atomic_save_results(path: str, arrays: dict,
                        fsync: bool = False) -> None:
    """Atomically checkpoint result arrays as a compressed ``.npz``:
    the payload is written to a temp name in the same directory and
    ``os.replace``d into place, so a reader (journal replay, elastic
    merge, a lease thief) either sees the complete file or no file --
    never a torn one, even when the writer is SIGKILLed mid-write.

    ``fsync`` also fsyncs the payload before the rename and the
    directory after it, extending the guarantee from "kill-safe" to
    "power-loss-safe".
    Writing to an open file object (not a path) keeps ``np.savez``
    from appending its own ``.npz`` suffix and breaking the rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **{k: np.asarray(v)
                                   for k, v in arrays.items()})
        fh.flush()
        if fsync:
            os.fsync(fh.fileno())
    os.replace(tmp, path)
    if fsync:
        dfd = os.open(os.path.dirname(os.path.abspath(path)),
                      os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)


def _truncate_torn_tail(path: str) -> None:
    """Repair a ``.jsonl`` file whose FINAL line was torn by a kill
    mid-append: if the file does not end in a newline, truncate back to
    the byte after the last ``\\n`` (or to empty when no newline
    exists). Complete records are never touched; this keeps a
    subsequent append from gluing a new record onto the torn fragment
    and producing a corrupt NON-final line that
    :func:`read_json_lines` refuses."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size == 0:
        return
    with open(path, "rb+") as fh:
        fh.seek(-1, os.SEEK_END)
        if fh.read(1) == b"\n":
            return
        # Scan backwards in chunks for the last newline.
        pos = size
        chunk = 4096
        keep = 0
        while pos > 0:
            step = min(chunk, pos)
            fh.seek(pos - step)
            buf = fh.read(step)
            nl = buf.rfind(b"\n")
            if nl >= 0:
                keep = pos - step + nl + 1
                break
            pos -= step
        fh.truncate(keep)
        fh.flush()
        os.fsync(fh.fileno())


def append_json_line(path: str, record: dict) -> None:
    """Durably append one JSON object as a line to a ``.jsonl`` file
    (the coalescer's ``events.jsonl``): the line is flushed AND fsynced
    before returning, so a record that this function reported written
    survives a process kill. A torn final line left by a previous kill
    is truncated away first, so appending after a crash never corrupts
    the file."""
    _truncate_torn_tail(path)
    line = json.dumps(record, sort_keys=True)
    with open(path, "a") as fh:
        fh.write(line + "\n")
        fh.flush()
        os.fsync(fh.fileno())


def read_json_lines(path: str, *, tolerate_torn_tail: bool = True) -> list:
    """Read a ``.jsonl`` file written by :func:`append_json_line`.

    With ``tolerate_torn_tail=True`` (crash-replay mode) a truncated
    FINAL line is dropped: a
    kill mid-append leaves at most one partial record, which by the
    fsync discipline of :func:`append_json_line` was never acknowledged
    to anyone. With ``tolerate_torn_tail=False`` a torn tail raises
    like any other corruption -- use it when the file is expected to be
    complete (e.g. an atomically-published artifact). A corrupt
    NON-final line always raises -- that is damage, not a crash
    artifact."""
    records = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1 and tolerate_torn_tail:
                break
            raise
    return records
