"""Config/option system — declared options with layered overrides.

The port of `ceph_tpu/utils/config.py`: `Option`, `Config` and
`global_config` with the same layering and observers.

Mirrors the reference's shape (reference src/common/options/global.yaml.in
declares options with type/level/default/min-max/enum, code-generated into
Option tables by y2c.py; md_config_t in src/common/config.cc layers
defaults < conf file < env < CLI overrides and notifies observers):

- options are declared in OPTIONS below (the ones the port reads;
  none yet),
- Config resolves defaults < config file (ini-ish "key = value") <
  environment (CEPH_TPU_<KEY>) < programmatic set_val,
- observers get (name, new_value) callbacks on live updates.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class Option:
    name: str
    type: type
    default: Any
    level: str = "advanced"
    desc: str = ""
    min: float | None = None
    max: float | None = None
    enum: tuple | None = None


# Only the options the port reads are declared, and nothing in the port
# reads one yet: the runtime slice (runtime/ladder.py, preflight.py)
# brings the first readers and declares their options here, with the
# JAX table's fields.
OPTIONS: dict[str, Option] = {}

ENV_PREFIX = "CEPH_TPU_"


class ConfigError(ValueError):
    pass


def _coerce(opt: Option, raw: Any) -> Any:
    if isinstance(raw, str):
        if opt.type is bool:
            v: Any = raw.strip().lower() in ("1", "true", "yes", "on")
        elif opt.type is int:
            v = int(raw)
        elif opt.type is float:
            v = float(raw)
        else:
            v = raw
    else:
        v = opt.type(raw)
    if opt.enum is not None and v not in opt.enum:
        raise ConfigError(
            f"{opt.name}={v!r} not in {opt.enum}"
        )
    if opt.min is not None and v < opt.min:
        raise ConfigError(f"{opt.name}={v} < min {opt.min}")
    if opt.max is not None and v > opt.max:
        raise ConfigError(f"{opt.name}={v} > max {opt.max}")
    return v


class Config:
    """Layered option resolution + observers."""

    def __init__(self, conf_file: str | None = None, env: bool = True):
        self._values: dict[str, Any] = {}
        self._observers: list[Callable[[str, Any], None]] = []
        if conf_file:
            self.load_file(conf_file)
        if env:
            self._load_env()

    def _load_env(self) -> None:
        for name, opt in OPTIONS.items():
            # the CEPH_TPU_<OPTION> family is documented by the OPTIONS
            # table above, not the knob registry (one entry per Option)
            raw = os.environ.get(ENV_PREFIX + name.upper())
            if raw is not None:
                self._values[name] = _coerce(opt, raw)

    def load_file(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line or "=" not in line:
                    continue
                k, _, v = line.partition("=")
                k = k.strip().replace(" ", "_")
                if k in OPTIONS:
                    self._values[k] = _coerce(OPTIONS[k], v.strip())

    def get(self, name: str) -> Any:
        opt = OPTIONS.get(name)
        if opt is None:
            raise ConfigError(f"unknown option {name!r}")
        return self._values.get(name, opt.default)

    def set_val(self, name: str, value: Any) -> None:
        opt = OPTIONS.get(name)
        if opt is None:
            raise ConfigError(f"unknown option {name!r}")
        v = _coerce(opt, value)
        self._values[name] = v
        for cb in self._observers:
            cb(name, v)

    def add_observer(self, cb: Callable[[str, Any], None]) -> None:
        self._observers.append(cb)

    def show_config(self) -> dict[str, Any]:
        return {name: self.get(name) for name in sorted(OPTIONS)}


_global: Config | None = None


def global_config() -> Config:
    global _global
    if _global is None:
        _global = Config()
    return _global
