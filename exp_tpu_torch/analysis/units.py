"""Unit metadata for coefficient files (the reference's UnitValidator,
expui/UnitValidator.{H,cc}, and the Units dataset read/written by Coefs,
Coefficients.cc:142-180): canonical unit-type and unit-name validation via
alias tables, plus helpers to attach a (type, unit, value) set to a
coefficient HDF5 file and recover the gravitational constant.

A host-side NumPy copy of exp_tpu/analysis/units.py (the port imports
nothing of exp_tpu).
"""

from __future__ import annotations

import numpy as np

# alias -> canonical type (UnitValidator::createAllowedUnitTypes)
_TYPES = {}
for canon, aliases in {
    "length": ("length", "Length", "Len", "len", "l", "L"),
    "mass": ("mass", "Mass", "m", "M"),
    "time": ("time", "Time", "t", "T"),
    "velocity": ("velocity", "vel", "Vel", "Velocity", "v", "V"),
    "G": ("G", "Grav", "grav", "grav_constant", "Grav_constant",
          "gravitational_constant", "Gravitational_constant"),
}.items():
    for a in aliases:
        _TYPES[a] = canon

# canonical type -> alias -> canonical unit (createAllowedUnitNames)
_UNITS = {
    "length": {"m": "m", "cm": "cm", "km": "km", "um": "um", "nm": "nm",
               "Angstrom": "Angstrom", "AU": "AU", "ly": "ly", "pc": "pc",
               "kpc": "kpc", "Mpc": "Mpc",
               "meter": "m", "centimeter": "cm", "kilometer": "km",
               "nanometer": "nm", "micrometer": "um", "micron": "um",
               "angstrom": "Angstrom", "AA": "Angstrom",
               "astronomical_unit": "AU", "au": "AU",
               "light_year": "ly", "lyr": "ly", "parsec": "pc",
               "kiloparsec": "kpc", "megaparsec": "Mpc",
               "none": "none", "None": "none"},
    "mass": {"Msun": "Msun", "Mearth": "Mearth", "g": "g", "kg": "kg",
             "solar_mass": "Msun", "earth_mass": "Mearth", "gram": "g",
             "kilograms": "kg", "none": "none", "None": "none"},
    "time": {"s": "s", "min": "min", "hr": "hr", "day": "day", "yr": "yr",
             "Myr": "Myr", "Gyr": "Gyr", "second": "s", "minute": "min",
             "hour": "hr", "year": "yr", "none": "none", "None": "none"},
    "velocity": {"cm/s": "cm/s", "m/s": "m/s", "km/s": "km/s",
                 "km/hr": "km/hr", "km/min": "km/min", "c": "c",
                 "none": "none", "None": "none"},
    "G": {"": "none", "mixed": "mixed", "none": "none",
          "unitless": "none"},
}


class UnitValidator:
    """Validate (type, unit) strings against the alias tables.

    Calling an instance returns (is_valid, canonical_type, canonical_unit)
    — (False, "unknown", "unknown") for anything unrecognized
    (UnitValidator::operator(), UnitValidator.cc:44-75)."""

    def __call__(self, type_: str, unit: str):
        canon_t = _TYPES.get(type_)
        if canon_t is not None:
            canon_u = _UNITS[canon_t].get(unit)
            if canon_u is not None:
                return True, canon_t, canon_u
        return False, "unknown", "unknown"

    def allowed_types(self):
        return sorted(set(_TYPES.values()))

    def type_aliases(self, type_: str):
        canon = _TYPES.get(type_, type_)
        return sorted(a for a, c in _TYPES.items() if c == canon)

    def allowed_units(self, type_: str):
        canon = _TYPES.get(type_)
        if canon is None:
            return []
        return sorted(set(_UNITS[canon].values()))


_UNIT_DTYPE = np.dtype([("type", "S16"), ("name", "S16"), ("value", "f8")])


def write_units(h5file, units, validate: bool = True):
    """Attach a Units dataset to an open h5py.File: `units` is a list of
    (type, unit_name, value) tuples (Coefs::WriteH5Units; a full set is
    4 entries — length, mass, time-or-velocity, G)."""
    v = UnitValidator()
    rows = []
    for t, name, value in units:
        if validate:
            ok, ct, cu = v(t, name)
            if not ok:
                raise ValueError(f"unknown unit {t!r}:{name!r}")
            t, name = ct, cu
        rows.append((t.encode(), name.encode(), float(value)))
    if "Units" in h5file:
        del h5file["Units"]
    h5file.create_dataset("Units", data=np.array(rows, _UNIT_DTYPE))


def read_units(h5file):
    """Read the Units dataset -> list of (type, unit_name, value)."""
    if "Units" not in h5file:
        return []
    raw = np.asarray(h5file["Units"])
    return [(r["type"].decode(), r["name"].decode(), float(r["value"]))
            for r in raw]


def grav_constant(units) -> float:
    """The gravitational constant from a unit set, defaulting to 1
    (Coefs::getGravConstant, Coefficients.cc:142-150)."""
    for t, _, value in units:
        if t == "G":
            return value
    return 1.0
