"""The port's ``read_from_input_file`` against the JAX package's: a small
input JSON with every kind of data source the parsers read -- VASP
OUTCAR excerpts (energy, geometry, the THz frequency table with an
imaginary mode), an ASE ``log.vib``, ``*_energy.dat`` and
``*_frequencies.dat`` files -- plus inline energies, a scaling-relation
state, a reactor and an energy landscape, written into ``tmp_path`` from
this file's own strings. Both packages load it; the compiled specs must
agree field for field, the conditions bitwise, and the validation
reports issue for issue, also under the strict gate."""

import dataclasses
import json
import os

import numpy as np
import pytest

from pycatkin_tpu.frontend import validate as jvalidate
from pycatkin_tpu.frontend.loader import read_from_input_file as jread
from pycatkin_tpu_torch.frontend import parsers, validate
from pycatkin_tpu_torch.frontend.loader import read_from_input_file

BAR = "-" * 75


def _outcar(symbols, counts, positions, energy, modes=()):
    lines = [f" POTCAR:    PAW_PBE {s} 08Apr2002" for s in symbols] * 2
    lines.append("   ions per type =   " + "  ".join(map(str, counts)))
    lines.append(f"  free  energy   TOTEN  =       {energy:.8f} eV")
    lines += [" POSITION                                       TOTAL-FORCE "
              "(eV/Angst)", " " + BAR]
    lines += [f"   {x:11.5f}  {y:11.5f}  {z:11.5f}      0.0  0.0  0.0"
              for x, y, z in positions]
    lines.append(" " + BAR)
    for i, (thz, imag) in enumerate(modes, start=1):
        tag = "f/i=" if imag else "f  ="
        lines.append(f"   {i} {tag}  {thz:10.6f} THz  {thz * 6.283:10.6f} "
                     f"2PiTHz  {thz * 33.356:10.4f} cm-1  {thz * 4.1357:9.5f}"
                     f" meV")
    return "\n".join(lines) + "\n"


LOG_VIB = """---------------------
  #    meV     cm^-1
---------------------
  0    3.1i     25.0i
  1    8.0      64.5
  2  265.5    2141.7
---------------------
Zero-point energy: 0.137 eV
"""

FILES = {
    "CO/OUTCAR": _outcar(["C", "O"], [1, 1],
                         [(5.0, 5.0, 5.0), (5.0, 5.0, 6.143)], -14.801,
                         modes=[(64.2, False), (0.9, True)]),
    "CO/log.vib": LOG_VIB,
    "O2/OUTCAR": _outcar(["O"], [2], [(5.0, 5.0, 5.0), (5.0, 5.0, 6.23)],
                         -9.862, modes=[(46.6, False)]),
    "TS1/OUTCAR": _outcar(["C", "O", "Pt"], [1, 1, 1],
                          [(0.0, 0.0, 1.9), (0.6, 0.0, 3.0), (0.0, 0.0, 0.0)],
                          -21.25, modes=[(41.0, False), (12.5, False),
                                         (8.8, False), (11.2, True)]),
    "sCO_energy.dat": "-16.02 eV\n",
    "sCO_frequencies.dat": "0 f = 6.07e13 Hz\n1 f = 1.02e13 Hz\n"
                           "2 f = 7.1e12 Hz\n3 f/i = 9.0e11 Hz\n",
}

INPUT = {
    "states": {
        "s": {"state_type": "surface", "Gelec": 0.0, "freq": []},
        "CO": {"state_type": "gas", "path": "CO", "sigma": 1},
        "O2": {"state_type": "gas", "path": "O2", "sigma": 2},
        "sCO": {"state_type": "adsorbate", "path": "sCO_energy.dat",
                "energy_source": "datafile", "freq_source": "datafile",
                "vibs_path": "sCO_frequencies.dat"},
        "sC": {"state_type": "adsorbate", "Gelec": -7.9,
               "freq": [5.5e13, 1.1e13, 8.0e12]},
        "TS1": {"state_type": "TS", "path": "TS1"},
    },
    "scaling relation states": {
        "sO": {"state_type": "adsorbate", "freq": [1.2e13, 9.0e12],
               "scaling_coeffs": {"gradient": 0.5, "intercept": -4.1},
               "scaling_reactions": {"CO": {"reaction": "CO_ads",
                                            "multiplicity": 1.0}}},
    },
    "system": {"p": 1.0e5, "T": 500.0, "times": [0.0, 1.0e3],
               "start_state": {"s": 1.0, "CO": 0.4, "O2": 0.2},
               "verbose": False},
    "reactions": {
        "CO_ads": {"reac_type": "adsorption", "reversible": True,
                   "reactants": ["CO", "s"], "products": ["sCO"],
                   "area": 1.0e-19},
        "CO_diss": {"reac_type": "arrhenius", "reversible": True,
                    "reactants": ["sCO", "s"], "products": ["sC", "sO"],
                    "TS": ["TS1"], "area": 1.0e-19},
    },
    "reactor": "InfiniteDilutionReactor",
    "energy landscapes": {
        "pes": {"minima": [["CO", "s", "s"], ["sCO", "s"], ["TS1"],
                           ["sC", "sO"]],
                "labels": ["CO + 2*", "CO*", "TS1", "C* + O*"]},
    },
}


@pytest.fixture
def input_file(tmp_path):
    for rel, text in FILES.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    path = tmp_path / "input.json"
    path.write_text(json.dumps(INPUT))
    return str(path)


def _issues(report):
    return [(i.severity, i.location, i.message) for i in report.issues]


def test_loaded_spec_matches_jax(input_file):
    p = read_from_input_file(input_file, device="cpu")
    j = jread(input_file)
    for f in dataclasses.fields(j.spec):
        a, b = getattr(p.spec, f.name), getattr(j.spec, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif isinstance(b, (list, tuple)):
            assert tuple(a) == tuple(b), f.name
        else:
            assert a == b, f.name
    for name, a, b in zip(j.conditions()._fields, p.conditions(),
                          j.conditions()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    assert p.params == j.params
    assert list(p.energy_landscapes) == ["pes"]
    assert p.energy_landscapes["pes"].labels == \
        j.energy_landscapes["pes"].labels
    # Every source was read: OUTCAR geometry and frequencies, log.vib,
    # the .dat files.
    co, ts, sco = p.states["CO"], p.states["TS1"], p.states["sCO"]
    assert co.Gelec == -14.801 and co.mass == pytest.approx(28.01)
    assert len(co.i_freq) == 1 and len(ts.i_freq) == 1
    assert sco.Gelec == -16.02 and len(sco.i_freq) == 1
    assert _issues(validate.validate_system(p)) == \
        _issues(jvalidate.validate_system(j))


def test_parsers_match_jax(input_file):
    from pycatkin_tpu.frontend import parsers as jparsers
    base = os.path.dirname(input_file)
    for name, args in (("read_outcar", ("CO/OUTCAR",)),
                       ("read_outcar_frequencies", ("TS1/OUTCAR",)),
                       ("read_log_vib", ("CO/log.vib",)),
                       ("read_energy_dat", ("sCO_energy.dat",)),
                       ("read_frequency_dat", ("sCO_frequencies.dat",))):
        paths = [os.path.join(base, a) for a in args]
        got = getattr(parsers, name)(*paths)
        want = getattr(jparsers, name)(*paths)
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(want[k]), err_msg=k)
        elif isinstance(want, tuple):
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
                assert len(b) > 0, name
        else:
            assert got == want, name


def test_strict_gate_matches_jax(input_file, monkeypatch):
    """A non-finite energy and a negative temperature: the strict
    gate (``PYCATKIN_VALIDATE=strict``) rejects the input in both
    packages with the same issues."""
    cfg = json.loads(open(input_file).read())
    cfg["states"]["sC"]["Gelec"] = float("nan")
    cfg["system"]["T"] = -5.0
    with open(input_file, "w") as fh:
        json.dump(cfg, fh)
    monkeypatch.setenv(validate.VALIDATE_ENV, "strict")
    with pytest.raises(validate.ValidationError) as got:
        read_from_input_file(input_file, device="cpu")
    with pytest.raises(jvalidate.ValidationError) as want:
        jread(input_file)
    assert _issues(got.value.report) == _issues(want.value.report)
    assert got.value.report.errors
