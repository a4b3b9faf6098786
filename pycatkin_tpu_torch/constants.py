"""Physical constants and unit conversions.

A verbatim copy of ``pycatkin_tpu/constants.py`` (the PyTorch port keeps
its own copy and imports nothing of the JAX package). Values mirror the
upstream PyCatKin constant set actually in use (the "Butadiene paper"
set), because every golden regression number depends on these exact
values.

Internal unit conventions (identical to the reference):
- energies per species: eV
- reaction energies / barriers at the rate-constant boundary: J/mol
- gas-phase solution entries: bar (multiply by ``bartoPa`` to get Pa)
- rate constants: 1/s (Arrhenius, desorption) or 1/(s Pa) (adsorption)
"""

NA = 6.02214076e23
bartoPa = 1.0e5
atmtoPa = 1.01325e5

kB = 1.380662e-23          # [J/K]
h = 6.626176e-34           # [J s]
JtoeV = 6.242e18
eVtokJ = 96.485
eVtokcal = 23.06
kcaltoJ = 4184
amutokg = 1.66053886e-27
amuA2tokgm2 = 1.66053907e-47
R = 8.31446262             # [J/(K mol)]

# Derived, used by the thermo kernels.
eVtoJmol = eVtokJ * 1.0e3  # eV -> J/mol

# --- TPU-safe precomputed combinations --------------------------------
# XLA:TPU emulates float64 as double-float32 pairs whose EXPONENT RANGE
# is float32's (~1e-38..1e38): raw SI combinations like h**2 (~4.4e-67)
# or m_kg*kB (~6e-49) underflow to zero ON DEVICE even under x64. Every
# device kernel therefore uses these host-precomputed, in-range
# combinations (plain Python floats evaluate in true f64), and assembles
# wide-range expressions in log space.
import math as _math

LOG_TRANS_CONST = _math.log(2.0 * _math.pi * amutokg * kB / h**2)
#   ln(2*pi*amu*kB/h^2); translational q = (kBT/p)*(C*m_amu*T)^1.5
LOG_ROT_CONST = _math.log(8.0 * _math.pi**2 * kB * amuA2tokgm2 / h**2)
#   ln(8*pi^2*kB*amuA2/h^2); rotational q_lin = C*T*I_amu/sigma
ROT_THETA_AMU = h**2 / (8.0 * _math.pi**2 * kB * amuA2tokgm2)
#   rotational temperature theta = C/I[amu*A^2], in K
SQRT_2PI_AMU_KB = _math.sqrt(2.0 * _math.pi * amutokg * kB)
#   adsorption k = area/(C*sqrt(m_amu*T))
LOG_DES_POLY = _math.log(kB**2 * 2.0 * _math.pi**1.5 * amutokg) \
    - 3.0 * _math.log(h)
#   ln(kB^2*2*pi^1.5*amu/h^3), polyatomic desorption coefficient
LOG_DES_LIN = _math.log(kB**2 * 2.0 * _math.pi * amutokg) \
    - 3.0 * _math.log(h)
#   ln(kB^2*2*pi*amu/h^3), linear-molecule desorption coefficient
LOG_H_OVER_KB = _math.log(h / kB)
#   activity: ln(h*TOF/kBT) = ln(TOF) + C - ln(T)

# 12.4 meV frequency floor used when parsing DFT vibration output
# (reference state.py:184-203). Expressed in Hz.
FREQ_FLOOR_HZ = 12.4e-3 / (h * JtoeV)
