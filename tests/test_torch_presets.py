"""The port's presets (``api/presets.py``) against the JAX package's, on
the toy mechanism of ``tests/torch_toy.py``: ``run_temperatures`` with
the steady solve and DRC in both modes, ``run_energy_span_temperatures``,
the energy exports and ``write_results``. The CSV files have the JAX
package's names and headers and their numbers within the envelopes of
``tests/test_torch_facade.py``, and the port's writer is byte for byte
pandas' ``to_csv``: the JAX package's own writer, given the port's
numbers, writes the same bytes."""

import os

import numpy as np
import pytest

from pycatkin_tpu.api import presets as jpresets
from pycatkin_tpu_torch.api import presets
from torch_toy import TOF, toy

ENV = dict(rtol=1e-5, atol=1e-12)
DRC = dict(rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module")
def pair():
    """(JAX system, port system), each after its own solve_odes."""
    j, p = toy("pycatkin_tpu"), toy("pycatkin_tpu_torch", device="cpu")
    j.solve_odes()
    p.solve_odes()
    return j, p


def _close(a, b, name, rtol, atol):
    np.testing.assert_allclose(np.asarray(a, dtype=float),
                               np.asarray(b, dtype=float), rtol=rtol,
                               atol=atol, err_msg=name)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _assert_same_csv(a, b, rtol, atol):
    """Same header; the numeric fields within the envelope."""
    la, lb = _read(a).decode().splitlines(), _read(b).decode().splitlines()
    assert la[0] == lb[0] and len(la) == len(lb), (a, la[0], lb[0])
    num = lambda ls: np.array([[float(v) for v in line.split(",")]
                               for line in ls[1:]])
    _close(num(la), num(lb), os.path.basename(a), rtol, atol)


@pytest.mark.parametrize("mode", ["implicit", "fd"])
def test_run_temperatures_matches_jax(pair, mode, tmp_path, monkeypatch):
    j, p = pair
    Ts = [480.0, 520.0]
    kw = dict(steady_state_solve=True, tof_terms=TOF, drc_mode=mode,
              save_results=True)
    fp, rp, dp = presets.run_temperatures(p, Ts, csv_path=str(tmp_path / "p"),
                                          **kw)
    fj, rj, dj = jpresets.run_temperatures(j, Ts, csv_path=str(tmp_path / "j"),
                                           **kw)
    assert p.params["temperature"] == 500.0
    _close(fp, fj, "finals", **ENV)
    _close(rp, rj, "rates", 1e-5, 1e-10)
    assert list(dp) == Ts
    for T in Ts:
        _close(list(dp[T].values()), list(dj[T].values()), f"drc {T}",
               **DRC)
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(f"{k}_vs_temperature.csv" for k in
                           ("rates", "coverages", "pressures", "drcs"))
    for n in names:
        _assert_same_csv(tmp_path / "p" / n, tmp_path / "j" / n, 1e-5, 1e-10)
    # The JAX package's writer (pandas) on the port's numbers.
    jpresets._save_sweep(j, "temperature", "Temperature (K)", Ts, fp, rp,
                         dp, TOF, str(tmp_path / "jw"))
    for n in names:
        assert _read(tmp_path / "p" / n) == _read(tmp_path / "jw" / n), n


def test_run_energy_span_temperatures_matches_jax(pair, tmp_path,
                                                  monkeypatch):
    j, p = pair
    Ts = [450, 550.0]
    op = presets.run_energy_span_temperatures(p, Ts, save_results=True,
                                              csv_path=str(tmp_path / "p"))
    oj = jpresets.run_energy_span_temperatures(j, Ts)
    for T in Ts:
        a, b = op["pes"][T], oj["pes"][T]
        assert a[2:4] == b[2:4] and a[6:] == b[6:]
        _close(a[:2], b[:2], f"espan {T}", 1e-12, 0.0)
        _close(a[4] + a[5], b[4] + b[5], f"x {T}", 1e-12, 1e-300)
    land = j.energy_landscapes["pes"]
    monkeypatch.setattr(land, "evaluate_energy_span_model",
                        lambda T, **kw: op["pes"][T])
    jpresets.run_energy_span_temperatures(j, Ts, save_results=True,
                                          csv_path=str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == 3
    for n in names:
        assert _read(tmp_path / "p" / n) == _read(tmp_path / "j" / n), n


def test_energy_exports_match_jax(pair, tmp_path, monkeypatch):
    """``save_energies``, ``save_state_energies``, ``save_pes_energies``
    and ``save_energies_temperatures`` write the JAX package's bytes from
    the same tables; ``write_results`` its headers and, within the
    envelope, its numbers."""
    j, p = pair
    p.solve_odes()
    for fn, tables in (("save_energies", ("reaction_energy_table",)),
                       ("save_state_energies", ("free_energy_table",)),
                       ("save_pes_energies", ("free_energy_table",))):
        getattr(presets, fn)(p, csv_path=str(tmp_path / "p"))
        with monkeypatch.context() as m:
            for t in tables:
                m.setattr(j, t, getattr(p, t))
            getattr(jpresets, fn)(j, csv_path=str(tmp_path / "j"))
    presets.save_energies_temperatures(p, [450, 550.0],
                                       csv_path=str(tmp_path / "p"))
    with monkeypatch.context() as m:
        m.setattr(j, "reaction_energy_table", p.reaction_energy_table)
        jpresets.save_energies_temperatures(j, [450, 550.0],
                                            csv_path=str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == 6
    for n in names:
        assert _read(tmp_path / "p" / n) == _read(tmp_path / "j" / n), n
    presets.write_results(p, path=str(tmp_path / "pr"))
    jpresets.write_results(j, path=str(tmp_path / "jr"))
    names = sorted(os.listdir(tmp_path / "pr"))
    assert names == sorted(os.listdir(tmp_path / "jr")) and len(names) == 3
    for n in names:
        _assert_same_csv(tmp_path / "pr" / n, tmp_path / "jr" / n, **ENV)


def test_csv_writer_is_pandas_to_csv(tmp_path):
    """Integers, floats, NaN, inf, strings needing quotes, a lone empty
    field: the bytes of ``DataFrame(rows, columns).to_csv(index=False)``."""
    pd = pytest.importorskip("pandas")
    rows = [[400, 0.1, 1e-05, "a,b", np.nan],
            [500, np.inf, -0.0, "x", 2.0 ** 60],
            [600, 1 / 3, 5e-324, 'q"', 123456789.123]]
    cols = ["T", "f", "g", "s", "h"]
    presets.write_csv(tmp_path / "p.csv", cols, rows)
    pd.DataFrame(rows, columns=cols).to_csv(tmp_path / "j.csv", index=False)
    assert _read(tmp_path / "p.csv") == _read(tmp_path / "j.csv")
    presets.write_csv(tmp_path / "p1.csv", ["a"], [[np.nan], [1.5]])
    pd.DataFrame([[np.nan], [1.5]], columns=["a"]).to_csv(
        tmp_path / "j1.csv", index=False)
    assert _read(tmp_path / "p1.csv") == _read(tmp_path / "j1.csv")
