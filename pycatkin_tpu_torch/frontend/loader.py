"""JSON input loader: the upstream input schema -> System facade (port of
``pycatkin_tpu/frontend/loader.py``).

Reads upstream PyCatKin's input schema: top-level sections ``states``, ``scaling relation states``, ``system``,
``reactions``, ``manual reactions``, ``reaction derived reactions``,
``reactor`` and ``energy landscapes``, including the unit fixup that
multiplies gas start/inflow entries by p/1e5 (bar) and the name->object
resolution passes for reaction members, gasdata and scaling reactions.
"""

from __future__ import annotations

import json
import os

from ..analysis.energy_span import Energy
from ..constants import bartoPa
from ..models.reactor import CSTReactor, InfiniteDilutionReactor
from .reactions import Reaction, ReactionDerivedReaction, UserDefinedReaction
from .states import ADSORBATE, GAS, SURFACE, ScalingState, State


def read_from_input_file(input_path="input.json", base_system=None,
                         base_path=None, verbose=False, device=None):
    """Build a System from a JSON input file.

    base_system: donor System for 'reaction derived reactions' whose
    base_reaction names resolve there.
    base_path: directory against which relative state paths are resolved
    (defaults to the input file's directory).
    device: the System's device (None: the CUDA card, resolved when a
    computation first runs; ``"cpu"`` for the CPU).

    Every schema error names the input file and the offending JSON key
    (JSON-pointer style, e.g. ``/reactions/CO_ox/reactants``). After
    wiring, the loaded system runs through the input-validation gate
    (frontend/validate.py) under the ``PYCATKIN_VALIDATE`` mode
    (strict|warn|off; default warn).
    """
    from ..api.system import System
    from .validate import validate_system, validation_mode

    if verbose:
        print(f"Loading input file: {input_path}.")
    with open(input_path) as fh:
        cfg = json.load(fh)

    if base_path is None:
        base_path = os.path.dirname(os.path.abspath(input_path))

    def _resolve_path(p):
        if p is None or os.path.isabs(p):
            return p
        return os.path.join(base_path, p)

    if "states" not in cfg:
        raise RuntimeError(
            f"{input_path}: /states: input file contains no states.")

    def _lookup(pool, sname, location, kind="state"):
        """Name -> object resolution with schema context on failure."""
        try:
            return pool[sname]
        except KeyError:
            raise KeyError(
                f"{input_path}: {location}: references unknown {kind} "
                f"{sname!r}") from None

    states: dict[str, State] = {}
    for name, scfg in cfg["states"].items():
        scfg = dict(scfg)
        for key in ("path", "vibs_path"):
            if key in scfg:
                scfg[key] = _resolve_path(scfg[key])
        states[name] = State(name=name, **scfg)

    for name, scfg in cfg.get("scaling relation states", {}).items():
        if name in states:
            raise ValueError(
                f"{input_path}: /scaling relation states/{name}: name "
                f"collides with an entry of /states")
        scfg = dict(scfg)
        for key in ("path", "vibs_path"):
            if key in scfg:
                scfg[key] = _resolve_path(scfg[key])
        states[name] = ScalingState(name=name, **scfg)

    # Checkpoint extension: energy-only donor states for 'base reactions'
    # (written by the JAX package's utils.io.system_to_dict for
    # derived-reaction systems whose bases live in a donor system). NOT
    # added to the system -- they only carry the borrowed energetics.
    base_states: dict[str, State] = {}
    for name, scfg in cfg.get("base states", {}).items():
        scfg = dict(scfg)
        for key in ("path", "vibs_path"):
            if key in scfg:
                scfg[key] = _resolve_path(scfg[key])
        base_states[name] = State(name=name, **scfg)

    if "system" not in cfg:
        raise RuntimeError(
            f"{input_path}: /system: input file contains no system "
            f"details.")
    sys_params = dict(cfg["system"])
    if "p" not in sys_params:
        raise KeyError(
            f"{input_path}: /system/p: total pressure is required to "
            f"convert gas fractions to partial pressures")
    p = sys_params["p"]
    # Gas start/inflow entries arrive as fractions of total pressure and
    # are stored in bar.
    startsites = 0.0
    for name, val in sys_params.get("start_state", {}).items():
        st = _lookup(states, name, "/system/start_state")
        if st.state_type == GAS:
            sys_params["start_state"][name] = val * p / bartoPa
        elif st.state_type in (SURFACE, ADSORBATE):
            startsites += val
    if "start_state" in sys_params and startsites == 0.0:
        raise ValueError(
            f"{input_path}: /system/start_state: initial surface "
            f"coverage cannot be zero for all states")
    for name, val in sys_params.get("inflow_state", {}).items():
        st = _lookup(states, name, "/system/inflow_state")
        if st.state_type != GAS:
            raise TypeError(
                f"{input_path}: /system/inflow_state/{name}: only gas "
                f"states can comprise the inflow (state {name!r} is "
                f"{st.state_type!r})")
        sys_params["inflow_state"][name] = val * p / bartoPa

    sim = System(**sys_params, device=device)
    for name, st in states.items():
        if st.gasdata is not None:
            st.gasdata["state"] = [states[s] for s in st.gasdata["state"]]
        sim.add_state(st)
    for st in base_states.values():
        if st.gasdata is not None:
            st.gasdata["state"] = [base_states.get(s) or states[s]
                                   for s in st.gasdata["state"]]

    reactions: dict[str, Reaction] = {}

    def _wire(rx_cfg, pool=states, where="/reactions/?"):
        rx_cfg = dict(rx_cfg)
        for member in ("reactants", "products"):
            if member not in rx_cfg:
                raise KeyError(
                    f"{input_path}: {where}: reaction is missing its "
                    f"{member!r} list") from None
            rx_cfg[member] = [_lookup(pool, s, f"{where}/{member}")
                              for s in rx_cfg[member]]
        if rx_cfg.get("TS") is not None:
            rx_cfg["TS"] = [_lookup(pool, s, f"{where}/TS")
                            for s in rx_cfg["TS"]]
        return rx_cfg

    for name, rcfg in cfg.get("reactions", {}).items():
        reactions[name] = Reaction(
            name=name, **_wire(rcfg, where=f"/reactions/{name}"))
    for name, rcfg in cfg.get("manual reactions", {}).items():
        reactions[name] = UserDefinedReaction(
            name=name, **_wire(rcfg, where=f"/manual reactions/{name}"))

    # Checkpoint extension: donor reactions resolved against base states
    # first; kept out of the system's kinetics (energy donors only).
    # A donor may itself be user-defined (user-energy keys in its cfg) or
    # derived from another donor ('base_reaction' key; second pass).
    donor_reactions: dict[str, Reaction] = {}
    if cfg.get("base reactions"):
        pool = {**states, **base_states}
        deferred = {}
        for name, rcfg in cfg["base reactions"].items():
            if "base_reaction" in rcfg:
                deferred[name] = rcfg
            elif any(k.endswith("_user") for k in rcfg):
                donor_reactions[name] = UserDefinedReaction(
                    name=name,
                    **_wire(rcfg, pool, f"/base reactions/{name}"))
            else:
                donor_reactions[name] = Reaction(
                    name=name,
                    **_wire(rcfg, pool, f"/base reactions/{name}"))
        while deferred:
            # A donor may be derived from another donor OR from one of
            # the system's own reactions (both sections parsed above).
            donors = {**reactions, **donor_reactions}
            resolvable = [n for n, rc in deferred.items()
                          if rc["base_reaction"] in donors]
            if not resolvable:
                raise KeyError(
                    f"{input_path}: /base reactions: entries "
                    f"{sorted(deferred)} reference base_reaction donors "
                    f"absent from the checkpoint")
            for name in resolvable:
                rcfg = _wire(deferred.pop(name), pool,
                             f"/base reactions/{name}")
                bname = rcfg.pop("base_reaction")
                donor_reactions[name] = ReactionDerivedReaction(
                    name=name, base_reaction=donors[bname], **rcfg)

    if "reaction derived reactions" in cfg:
        if base_system is not None:
            donor = base_system.reactions
        else:
            donor = {**reactions, **donor_reactions}
        for name, rcfg in cfg["reaction derived reactions"].items():
            rcfg = _wire(rcfg,
                         where=f"/reaction derived reactions/{name}")
            base_name = rcfg.pop("base_reaction")
            if base_name not in donor:
                raise KeyError(
                    f"{input_path}: /reaction derived reactions/{name}: "
                    f"base reaction {base_name!r} not found -- supply "
                    f"base_system= or load a checkpoint with inlined "
                    f"'base reactions'")
            reactions[name] = ReactionDerivedReaction(
                name=name, base_reaction=donor[base_name], **rcfg)

    # Resolve scaling-reaction name references now that reactions exist.
    for st in states.values():
        if isinstance(st, ScalingState):
            for key, entry in st.scaling_reactions.items():
                if isinstance(entry["reaction"], str):
                    entry["reaction"] = _lookup(
                        reactions, entry["reaction"],
                        f"/scaling relation states/{st.name}"
                        f"/scaling_reactions/{key}", kind="reaction")

    for rx in reactions.values():
        sim.add_reaction(rx)

    if "reactor" in cfg:
        rcfg = cfg["reactor"]
        if not isinstance(rcfg, dict):
            if rcfg == "InfiniteDilutionReactor":
                sim.add_reactor(InfiniteDilutionReactor())
            else:
                raise TypeError(
                    f"{input_path}: /reactor: only "
                    f"InfiniteDilutionReactor can be specified without "
                    f"reactor parameters, got {rcfg!r}")
        elif "InfiniteDilutionReactor" in rcfg:
            sim.add_reactor(InfiniteDilutionReactor())
        elif "CSTReactor" in rcfg:
            sim.add_reactor(CSTReactor(**rcfg["CSTReactor"]))
        else:
            raise TypeError(
                f"{input_path}: /reactor: unknown reactor option(s) "
                f"{sorted(rcfg)}, please choose InfiniteDilutionReactor "
                f"or CSTReactor")
    elif reactions:
        raise RuntimeError(
            f"{input_path}: /reactor: cannot consider reactions without "
            f"a reactor. To use constant boundary conditions, specify "
            f"InfiniteDilutionReactor.")

    for pes, lcfg in cfg.get("energy landscapes", {}).items():
        minima = [[_lookup(states, s,
                           f"/energy landscapes/{pes}/minima/{i}")
                   for s in entry]
                  for i, entry in enumerate(lcfg["minima"])]
        labels = lcfg.get("labels") or [e[0].name for e in minima]
        sim.add_energy_landscape(Energy(name=pes, minima=minima,
                                        labels=labels))

    # Validation gate: run the host-side checks over the freshly wired
    # system. PYCATKIN_VALIDATE picks strict|warn|off (default warn).
    mode = validation_mode()
    if mode != "off":
        validate_system(sim, source=str(input_path)).emit(mode)

    return sim
