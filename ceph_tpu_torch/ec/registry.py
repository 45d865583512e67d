"""Plugin registry: name -> factory, profile-driven.

Port of `ceph_tpu/ec/registry.py`.  `create_erasure_code` plays the
reference's `ErasureCodePluginRegistry::factory`: pick the plugin by
profile["plugin"], build it, init(profile).

Plugins:
  jerasure  -> reed_sol_van / reed_sol_r6_op / cauchy_orig / cauchy_good
  isa       -> reed_sol_van (isa Vandermonde) / cauchy
  jax       -> reed_sol_van matrices on the device engine by default
  example   -> toy XOR(k, m=1) code
  clay / shec / lrc -> the layered codes (ec.clay / ec.shec / ec.lrc)

profile["backend"] picks the per-stripe engine: `torch` (the device
engine, every plugin's default; `jax` is accepted as an alias, so the JAX
package's profiles carry over), or a host engine asked for by name:
`numpy`, or `native` (the C++ SIMD engine, native/gf.cpp).  For the
device engine profile["strategy"] picks one of
ec.torch_backend.STRATEGIES (CEPH_TPU_EC_STRATEGY overrides it).  The
device engine runs on `device`: the card unless the caller passes "cpu",
and without a card `create_erasure_code` raises.  lrc passes its backend,
strategy and device on to its layers.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeProfileError

# the plugins' modules are imported when a profile first names them, as
# in the JAX registry: a process's `ec` perf group then holds the keys
# of the codes it built


def _make_jerasure(profile: dict) -> ErasureCode:
    from ceph_tpu_torch.ec.rs import RSErasureCode

    return RSErasureCode(profile.get("technique", "reed_sol_van"))


def _make_isa(profile: dict) -> ErasureCode:
    from ceph_tpu_torch.ec.rs import RSErasureCode

    tech = profile.get("technique", "reed_sol_van")
    mapped = {
        "reed_sol_van": "isa_reed_sol_van",
        "cauchy": "isa_cauchy",
    }.get(tech)
    if mapped is None:
        raise ErasureCodeProfileError(f"isa: unknown technique {tech!r}")
    return RSErasureCode(mapped)


def _make_jax(profile: dict) -> ErasureCode:
    from ceph_tpu_torch.ec.rs import RSErasureCode

    profile.setdefault("backend", "torch")
    return RSErasureCode(profile.get("technique", "reed_sol_van"))


class XorExample(ErasureCode):
    """k data chunks + 1 XOR parity (the reference's example/test code).
    Host numpy only."""

    def parse(self, profile: dict) -> None:
        super().parse(profile)
        if self.m != 1:
            raise ErasureCodeProfileError("example code requires m=1")

    def encode_chunks(self, data: np.ndarray) -> np.ndarray:
        parity = np.bitwise_xor.reduce(data, axis=0)[None, :]
        return np.concatenate([data, parity], axis=0)

    def decode_chunks(self, want_to_read, chunks, chunk_size):
        out = dict(chunks)
        missing = sorted(set(want_to_read) - set(chunks))
        if not missing:
            return out
        if len(missing) > 1 or len(chunks) < self.k:
            raise ValueError("XOR code can rebuild at most one chunk")
        acc = np.zeros(chunk_size, np.uint8)
        for v in chunks.values():
            acc ^= np.asarray(v, np.uint8)
        out[missing[0]] = acc
        return out


def _make_clay(profile: dict) -> ErasureCode:
    from ceph_tpu_torch.ec.clay import ClayCode

    return ClayCode()


def _make_shec(profile: dict) -> ErasureCode:
    from ceph_tpu_torch.ec.shec import ShecCode

    return ShecCode()


def _make_lrc(profile: dict) -> ErasureCode:
    from ceph_tpu_torch.ec.lrc import LrcCode

    return LrcCode()


_PLUGINS = {
    "jerasure": _make_jerasure,
    "isa": _make_isa,
    "jax": _make_jax,
    "example": lambda p: XorExample(),
    "clay": _make_clay,
    "shec": _make_shec,
    "lrc": _make_lrc,
}


def register_plugin(name: str, factory) -> None:
    """Add (or replace) plugin `name`: factory(profile) -> an
    ErasureCode, which create_erasure_code then places and inits."""
    _PLUGINS[name] = factory


def list_plugins() -> list[str]:
    """The plugin names a profile may give, sorted (`jax` among them, the
    device engine's RS plugin under the JAX package's name)."""
    return sorted(_PLUGINS)


def create_erasure_code(profile: dict, device=None) -> ErasureCode:
    """ErasureCodePluginRegistry::factory equivalent.  `device` (default
    `cuda`; raises without a card unless `"cpu"` is asked for) is where
    the device engine runs."""
    device = resolve_device(device)
    profile = dict(profile)
    name = profile.get("plugin", "jerasure")
    try:
        factory = _PLUGINS[name]
    except KeyError:
        raise ErasureCodeProfileError(f"unknown plugin {name!r}")
    code = factory(profile)
    code.device = device
    code.init(profile)
    return code
