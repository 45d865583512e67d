"""crush_ln: 2^44 * log2(x + 1) in CRUSH's fixed point, on torch tensors.

A frozen copy of the tables and the integer algorithm of the reference
(src/crush/mapper.c:247-290, src/crush/crush_ln_table.h), so that the
benchmark's plain reference computes straw2 draws without the program.
RH_LH_TBL[2k] = ceil(2^48 / (1 + k/128)), RH_LH_TBL[2k+1] =
floor(2^48 * log2(1 + k/128)) (entry 257 capped as the reference caps
it); LL_TBL's 256 values ship as packed little-endian data.
"""

from __future__ import annotations

import base64
import decimal

import numpy as np
import torch


def _build_rh_lh() -> np.ndarray:
    tbl = np.zeros(258, dtype=np.int64)
    for k in range(129):
        num = (1 << 48) * 128
        den = 128 + k
        tbl[2 * k] = -((-num) // den)  # ceil division, exact
        if k == 0:
            lh = 0
        else:
            # floor(2^48*log2(1+k/128)); float64 is ~1 ulp short of exact at
            # this magnitude, so compute at 60 decimal digits.  The checksum
            # assert below catches any platform drift.
            with decimal.localcontext() as ctx:
                ctx.prec = 60
                v = (
                    decimal.Decimal(128 + k).ln() - decimal.Decimal(128).ln()
                ) / decimal.Decimal(2).ln() * (1 << 48)
                lh = int(v.to_integral_value(rounding=decimal.ROUND_FLOOR))
        tbl[2 * k + 1] = lh
    tbl[257] = 0x0000FFFF00000000  # reference quirk: capped, not 2^48
    return tbl


# reference src/crush/crush_ln_table.h:97-162, packed <q little-endian.
_LL_B64 = (
    "AAAAAAAAAAAACqbiAgAAAMVOtgwHAAAAZ85Q7wkAAAD9iOXRDAAAAJx+dLQPAAAAXq/9lhIAAABY"
    "G4F5FQAAAKHC/lsYAAAAUqV2PhsAAACAw+ggHgAAAEMdVQMhAAAAsrK75SMAAADkgxzIJgAAAPCQ"
    "d6opAAAA7dnMjCwAAADyXhxvLwAAABcgZlEyAAAAcR2qMzUAAAAaV+gVOAAAACbNIPg6AAAArn9T"
    "2j0AAADIboC8QAAAAIyap55DAAAAEAPJgEYAAABsqORiSQAAALaK+kRMAAAABqoKJ08AAAByBhUJ"
    "UgAAABOgGetUAAAA/XYYzVcAAABKixGvWgAAAA/dBJFdAAAAZGzycmAAAABgOdpUYwAAABpEvDZm"
    "AAAAqIyYGGkAAAAiE2/6awAAAJ/XP9xuAAAANdoKvnEAAAD9GtCfdAAAAAyaj4F3AAAAeldJY3oA"
    "AABeU/1EfQAAAM6NqyaAAAAA4wZUCIMAAACyvvbphQAAAFK1k8uIAAAA3OoqrYsAAABlX7yOjgAA"
    "AAUTSHCRAAAA0wXOUZQAAADlN04zlwAAAFOpyBSaAAAAM1o99pwAAACdSqzXnwAAAFg0f7CiAAAA"
    "aup4mqUAAAD7mdZ7qAAAAHCJLl2rAAAA47iAPq4AAABpKM0fsQAAABjYEwG0AAAACshU4rYAAABT"
    "+I/DuQAAAAxpxaS8AAAAShr1hb8AAAAmDB9nwgAAALY+Q0jFAAAAEbJhKcgAAABNZnoKywAAAIJb"
    "jevNAAAAyJGazNAAAAAzCaKt0wAAAN3Bo47WAAAA27ufb9kAAABE95VQ3AAAADB0hjHfAAAAtTJx"
    "EuIAAADqMlbz5AAAAOZ0NdTnAAAAwfgOteoAAACQvuKV7QAAAGzGsHbwAAAAahB5V/MAAACinDs4"
    "9gAAACpr+Bj5AAAAGnyv+fsAAACIz2Da/gAAAIxlDLsBAQAAPD6ymwQBAACvWVJ8BwEAAPy37FwK"
    "AQAAOlmBPQ0BAAB/PRAeEAEAAORkmf4SAQAAfs8c3xUBAABkfZq/GAEAAK1uEqAbAQAAcaOEgB4B"
    "AADGG/FgIQEAAMPXV0EkAQAAf9e4IScBAAAQGxQCKgEAAI6iaeIsAQAAD265wi8BAACqfQOjMgEA"
    "AHfRR4M1AQAAjGmGYzgBAAD/Rb9DOwEAAOlm8iM+AQAAXswfBEEBAAB4dkfkQwEAAEtlacRGAQAA"
    "8JiFpEkBAAB8EZyETAEAAAjPrGRPAQAAqdG3RFIBAAB2Gb0kVQEAAIemvARYAQAA8ni25FoBAADO"
    "kKrEXQEAADHumKRgAQAANJGBhGMBAADseWRkZgEAAHCoQURpAQAA1xwZJGwBAAC9Gcr2bQEAAKrX"
    "tuNxAQAARB59w3QBAAAcqz2jdwEAAEl++IJ6AQAA4petYn0BAAD+91xCgAEAAFg0f7CCAQAAGYyq"
    "AYYBAABGwEjhiAEAAFI74cCLAQAAUv1zoI4BAABdBgGAkQEAAItWiF+UAQAA8u0JP5cBAACqzIUe"
    "mgEAAMjy+/2cAQAAY2Bs3Z8BAACTFde8ogEAAG4SPJylAQAAC1ebe6gBAACA4/RaqwEAAOW3SDqu"
    "AQAAUNSWGbEBAADZON/4swEAAJXlIdi2AQAAm9pet7kBAAADGJaWvAEAAOOdx3W/AQAAUWzzVMIB"
    "AABlgxk0xQEAADbjORPIAQAA2YtU8soBAABnfWnRzQEAAPW3eLDQAQAAmjuCj9MBAABtCIZu1gEA"
    "AIYehE3ZAQAA+X18LNwBAADfJm8L3wEAAE4ZXOrhAQAAXVVDyeQBAAAj2ySo5wEAALWqAIfqAQAA"
    "K8TWZe0BAACdJ6dE8AEAAB/VcSPzAQAAysw2AvYBAACzDvbg+AEAAPOar7/7AQAAnnFjnv4BAADM"
    "khF9AQIAAJT+uVsEAgAADbVcOgcCAAASYm7ACQIAAGoCkfcMAgAAfJki1g8CAABYNH+wEgIAANio"
    "NJMVAgAAUCG1cRgCAAAX5S9QGwIAAI+nc2odAgAA7k4UDSECAAAs9X3rIwIAABPn4ckmAgAAuyRA"
    "qCkCAABOm2cjLAIAAKiD62QvAgAAG6U4QzICAACpEoAhNQIAAGnMwf83AgAApA47LDoCAABbgO4T"
    "PQIAAB8i6TVAAgAAJa+PeEMCAAA157RWRgIAAP5rZO1HAgAAmD3uEkwCAAAaXALxTgIAAJnHEM9R"
    "AgAAZU1kklQCAADuhRyLVwIAAPDYGWlaAgAAW4DuE10CAAAWZwMlYAIAAII4RZZiAgAAUyvW4GUC"
    "AADzAbe+aAIAAF4mkpxrAgAAqZj3Mm0CAADrWDdYcQIAADtnATZ0AgAAsMPFE3cCAABfboTxeQIA"
    "AGFnPc98AgAAy66AZX4CAACzRJ6KggIAADIpRmiFAgAAVVK/vYcCAABK3oQjiwIAAFuA7hONAgAA"
    "HyLpNZACAACCOEWWkgIAAGH7vZmWAgAAq3qjApkCAADJZLhUnAIAAIMQveqdAgAAtQucD6ICAABh"
    "XWDHpAIAAFVSv72nAgAA/NpWYKkCAADvFK89rAIAAMqeARuvAgAAgjhFlrICAAAP2CLQtQIAALMc"
    "R/q4AgAAE+cSkLoCAADMAUltvQIAAPZseUrAAgAApiikJ8MCAABMj14axgIAAPaR6OHIAgAAwj8C"
    "v8sCAABuPhaczgIAABOOJHnRAgAAxi4tVtQCAACdIDAz1wIAALBjLRDaAgAAFPgk7dwCAAA="
)

RH_LH_TBL = _build_rh_lh()
RH_LH_TBL.setflags(write=False)
# guard against platform/libm rounding drift in the floor-snap above: the
# reference table's exact content sum (verified against crush_ln_table.h)
assert int(RH_LH_TBL.sum()) & 0xFFFFFFFFFFFF == 0x4ED10B7A2217, hex(
    int(RH_LH_TBL.sum()) & 0xFFFFFFFFFFFF
)
LL_TBL = np.frombuffer(base64.b64decode(_LL_B64), dtype="<i8").astype(np.int64)
LL_TBL.setflags(write=False)
assert LL_TBL.shape == (256,) and int(LL_TBL.sum()) & 0xFFFFFFFF == 1238488602


def _mulhi48(x: torch.Tensor, rh: torch.Tensor) -> torch.Tensor:
    """floor(x * rh / 2^48) for 0 <= x <= 2^16, 0 <= rh <= 2^48, in int64
    without overflow: rh splits into 24-bit halves."""
    t = x * (rh & 0xFFFFFF)
    s = x * (rh >> 24)
    return (s + (t >> 24)) >> 24


_TABLES: dict = {}


def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = (torch.from_numpy(RH_LH_TBL.copy()).to(device),
                        torch.from_numpy(LL_TBL.copy()).to(device))
    return _TABLES[key]


def crush_ln(u: torch.Tensor) -> torch.Tensor:
    """crush_ln of u <= 0xffff (any integer dtype and device), int64."""
    rh_lh, ll = _tables(u.device)
    x = u.long() + 1
    fl = torch.zeros_like(x)
    m = x
    for s in (16, 8, 4, 2, 1):
        g = m >= (1 << s)
        fl = fl + g * s
        m = torch.where(g, m >> s, m)
    bits = torch.where((x & 0x18000) == 0, 15 - fl, torch.zeros_like(fl))
    x = x << bits
    k = (x >> 8) - 128
    rh = rh_lh[2 * k]
    lh = rh_lh[2 * k + 1]
    lo = ll[_mulhi48(x, rh) & 0xFF]
    return ((15 - bits) << 44) + ((lh + lo) >> 4)
