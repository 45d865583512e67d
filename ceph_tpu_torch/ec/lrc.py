"""LRC: locally repairable layered code.

Port of `ceph_tpu/ec/lrc.py` (the reference's lrc plugin,
src/erasure-code/lrc/ErasureCodeLrc.{h,cc}): the profile describes a
global `mapping` string plus a JSON list of layers `[[chunks_map,
profile], ...]`; each layer runs an inner code (default jerasure
reed_sol_van) over its 'D' (data) and 'c' (coding) positions.  Decode
sweeps the layers in reverse to a fixpoint, repairing erasures with
whichever layer has few enough of them: a local layer fixes a single loss
by reading only its group (reference decode_chunks :777-860).

The k/m/l shorthand (profile k, m, l without mapping/layers) generates the
one-global + per-group-local layout (reference parse_kml :293-395).

The layers are RS codes made through the port's registry on the outer
code's device, with the outer profile's `backend` and `strategy` unless a
layer sets its own.  Numpy in gives numpy out; tensors stay on their device.
"""

from __future__ import annotations

import json

import numpy as np

from ceph_tpu_torch.ec.interface import (
    ErasureCode,
    ErasureCodeProfileError,
    _as_u8,
    _is_tensor,
    _stack,
)


class _Layer:
    def __init__(self, chunks_map: str, profile: dict, parent: dict,
                 device):
        self.chunks_map = chunks_map
        self.data = [i for i, ch in enumerate(chunks_map) if ch == "D"]
        self.coding = [i for i, ch in enumerate(chunks_map) if ch == "c"]
        self.chunks = self.data + self.coding
        self.chunks_set = set(self.chunks)
        prof = dict(profile)
        prof.setdefault("k", len(self.data))
        prof.setdefault("m", len(self.coding))
        prof.setdefault("plugin", "jerasure")
        prof.setdefault("technique", "reed_sol_van")
        # the engine knobs inherit from the outer profile: a backend=torch
        # lrc runs every layer's products on the device engine (with the
        # outer strategy) unless a layer profile overrides them
        for knob in ("backend", "strategy"):
            if parent.get(knob) is not None:
                prof.setdefault(knob, parent[knob])
        from ceph_tpu_torch.ec.registry import create_erasure_code

        self.code = create_erasure_code(prof, device)


def generate_kml(k: int, m: int, l: int) -> tuple[str, list]:
    """reference parse_kml: mapping + layers for the k/m/l shorthand."""
    if l == 0 or (k + m) % l:
        raise ErasureCodeProfileError("k + m must be a multiple of l")
    groups = (k + m) // l
    if k % groups or m % groups:
        raise ErasureCodeProfileError(
            "k and m must be multiples of (k + m) / l"
        )
    kg, mg = k // groups, m // groups
    mapping = ("D" * kg + "_" * mg + "_") * groups
    layers = []
    glob = ("D" * kg + "c" * mg + "_") * groups
    layers.append([glob, ""])
    for i in range(groups):
        row = ""
        for j in range(groups):
            row += ("D" * l + "c") if i == j else "_" * (l + 1)
        layers.append([row, ""])
    return mapping, layers


class LrcCode(ErasureCode):
    """plugin=lrc; profile: mapping+layers JSON, or k/m/l shorthand."""

    def __init__(self):
        super().__init__()
        self.layers: list[_Layer] = []
        self.mapping = ""
        self.chunk_mapping: list[int] = []

    def parse(self, profile: dict) -> None:
        self.w = 8
        mapping = profile.get("mapping")
        layers_desc = profile.get("layers")
        if mapping is None and layers_desc is None:
            k = profile.get("k")
            m = profile.get("m")
            l = profile.get("l")
            if k is None or m is None or l is None:
                raise ErasureCodeProfileError(
                    "lrc: need mapping+layers or all of k, m, l"
                )
            mapping, layers = generate_kml(int(k), int(m), int(l))
        else:
            if mapping is None or layers_desc is None:
                raise ErasureCodeProfileError(
                    "lrc: mapping and layers must both be set"
                )
            if isinstance(layers_desc, str):
                try:
                    layers = json.loads(layers_desc)
                except json.JSONDecodeError as e:
                    raise ErasureCodeProfileError(
                        f"lrc: layers is not valid JSON: {e}"
                    )
            else:
                layers = layers_desc
        self.mapping = mapping
        self.k = mapping.count("D")
        self.m = len(mapping) - self.k
        self.layers = []
        for entry in layers:
            if not isinstance(entry, (list, tuple)) or not entry:
                raise ErasureCodeProfileError(
                    "lrc: each layer must be [chunks_map, profile]"
                )
            cm = entry[0]
            if len(cm) != len(mapping):
                raise ErasureCodeProfileError(
                    f"lrc: layer map {cm!r} length != mapping length "
                    f"{len(mapping)}"
                )
            lp = entry[1] if len(entry) > 1 else ""
            if isinstance(lp, str):
                lpd: dict = {}
                for tok in lp.split():
                    key, _, v = tok.partition("=")
                    lpd[key] = v
            else:
                lpd = dict(lp)
            self.layers.append(_Layer(cm, lpd, profile, self.device))
        if not self.layers:
            raise ErasureCodeProfileError("lrc: at least one layer needed")
        # chunk_mapping from the global mapping: D positions then the rest
        self.chunk_mapping = [
            i for i, ch in enumerate(mapping) if ch == "D"
        ] + [i for i, ch in enumerate(mapping) if ch != "D"]

    def get_chunk_count(self) -> int:
        return len(self.mapping)

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.k

    def get_alignment(self) -> int:
        return self.k * self.w * 4

    def _data_positions(self) -> list[int]:
        return [i for i, ch in enumerate(self.mapping) if ch == "D"]

    # -- encode ------------------------------------------------------------
    def encode_chunks(self, data):
        """data rows are the k 'D' positions in mapping order; returns all
        chunk positions [chunk_count, cs] (the caller reads data chunks
        through chunk_mapping)."""
        data = _as_u8(data)
        zeros = np.zeros(data.shape[1], np.uint8)  # a position not written
        buf = dict(zip(self._data_positions(), data))
        for layer in self.layers:
            sub = _stack([buf.get(c, zeros) for c in layer.data], 0)
            enc = layer.code.encode_chunks(sub)
            for j, c in enumerate(layer.chunks):
                buf[c] = enc[j]
        return _stack(
            [buf.get(i, zeros) for i in range(self.get_chunk_count())], 0)

    # -- decode ------------------------------------------------------------
    def decode_chunks(self, want_to_read: set[int], chunks: dict,
                      chunk_size: int) -> dict:
        n = self.get_chunk_count()
        erasures = {i for i in range(n) if i not in chunks}
        decoded = {i: _as_u8(chunks[i]) for i in chunks}
        want_missing = want_to_read & erasures
        # sweep the layers to a fixpoint: a later sweep can use chunks an
        # earlier layer just recovered (the reference single-passes and
        # can miss recoverable chunks; minimum_to_decode's peeling
        # analysis assumes the fixpoint)
        progress = True
        while want_missing and progress:
            progress = False
            for layer in reversed(self.layers):
                layer_erasures = layer.chunks_set & erasures
                if not layer_erasures:
                    continue
                if len(layer_erasures) > len(layer.coding):
                    continue  # too many for this layer
                sub_chunks = {
                    j: decoded[c]
                    for j, c in enumerate(layer.chunks)
                    if c not in erasures
                }
                try:
                    sub = layer.code.decode_chunks(
                        set(range(len(layer.chunks))), sub_chunks,
                        chunk_size,
                    )
                except (ValueError, np.linalg.LinAlgError):
                    continue
                for j, c in enumerate(layer.chunks):
                    decoded[c] = _as_u8(sub[j])
                    erasures.discard(c)
                progress = True
                want_missing = want_to_read & erasures
                if not want_missing:
                    break
        if want_missing:
            raise ValueError(
                f"lrc: unable to read {sorted(want_missing)} from "
                f"{sorted(chunks)}"
            )
        # a chunk no layer recovered (and not wanted) reads as zeros
        like = next(iter(decoded.values()))
        zeros = (like.new_zeros(chunk_size) if _is_tensor(like)
                 else np.zeros(chunk_size, np.uint8))
        return {i: decoded.get(i, zeros) for i in range(n)}

    def _peel_recoverable(self, available: set[int]) -> set[int]:
        """Fixpoint of layer-by-layer repair over chunk *sets* (no data):
        which chunks decode_chunks would eventually recover."""
        have = set(available)
        changed = True
        while changed:
            changed = False
            for layer in self.layers:
                missing = layer.chunks_set - have
                if missing and len(missing) <= len(layer.coding):
                    have |= layer.chunks_set
                    changed = True
        return have

    def minimum_to_decode(self, want_to_read: set[int],
                          available: set[int]) -> set[int]:
        """reference minimum_to_decode: prefer the single layer that can
        repair the erasures locally (reference ErasureCodeLrc.cc:560-730,
        condensed: smallest covering layer wins)."""
        if want_to_read <= available:
            return set(want_to_read)
        erasures = want_to_read - available
        best: set[int] | None = None
        for layer in self.layers:
            if not (erasures <= layer.chunks_set):
                continue
            layer_av = layer.chunks_set & available
            layer_er = layer.chunks_set - available
            if len(layer_er) > len(layer.coding):
                continue
            if best is None or len(layer_av) < len(best):
                best = set(layer_av)
        if best is None:
            # multi-layer decode: only claim sufficiency if the peeling
            # fixpoint actually reaches the wanted chunks
            if not (want_to_read <= self._peel_recoverable(available)):
                raise ValueError(
                    f"lrc: want {sorted(want_to_read)} unrecoverable "
                    f"from {sorted(available)}"
                )
            return set(available)
        return best | (want_to_read & available)

    def decode_concat(self, chunks: dict) -> bytes:
        dpos = self._data_positions()
        first = next(iter(chunks.values()))
        cs = first.numel() if _is_tensor(first) else np.asarray(first).size
        out = self.decode(set(dpos), chunks, cs)
        return b"".join(
            (out[i].cpu().numpy() if _is_tensor(out[i])
             else np.asarray(out[i], np.uint8)).tobytes()
            for i in dpos
        )
