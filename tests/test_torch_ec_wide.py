"""Profiles past the GF(2^8) kernel's 32 x 64 limits, held against the
JAX package.

The kernel takes an M of at most 32 rows and 64 columns;
`TorchEngine` runs a larger M as one launch per block
(`torch_backend.gf_matmul_tiled`), XORing a row block's partial products.
Here, on the CPU:

- the tiling itself, driven through the plain version with the limits
  asserted on every block it hands out, byte-equal to the untiled
  product, with one product call per block, and exactly one for an M
  inside the limits;
- RS(70,4) (a [4, 70] coding matrix) and Clay(2,33,19) (an inner MDS
  code of 33 parity rows) encode, decode and repair bytes from
  `create_erasure_code(..., device="cpu")`, equal to the JAX package's
  and to tests/data/ec_wide.json, whose SHA-256s `chip_smoke.py`'s
  `ec_wide` phase holds the card to.

tests/data/ec_wide.json holds each profile's inputs (profile, payload
size, erasure patterns) beside its SHA-256s; `python
tests/test_torch_ec_wide.py` rewrites the SHA-256s from the JAX package
(a few seconds).
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch.ec import create_erasure_code  # noqa: E402
from ceph_tpu_torch.ec import torch_backend as tb  # noqa: E402

CORPUS = ROOT / "tests" / "data" / "ec_wide.json"

# name -> {"profile", "size" (payload bytes), "patterns" (erasures
# decoded), "sha256" (the JAX package's chunks)}; chip_smoke.py's ec_wide
# phase reads the same inputs from this file
WIDE = json.loads(CORPUS.read_text())


def _sha(chunks: dict) -> dict:
    return {str(i): hashlib.sha256(np.asarray(c, np.uint8).tobytes())
            .hexdigest() for i, c in sorted(chunks.items())}


def run_wide(create, name: str) -> dict:
    """Encode, decode each pattern and (Clay) repair chunk 0 through
    `create(profile)`; the SHA-256 of every chunk out."""
    case = WIDE[name]
    prof, size, patterns = case["profile"], case["size"], case["patterns"]
    code = create(dict(prof))
    n = code.get_chunk_count()
    payload = np.random.default_rng(n).integers(0, 256, size, np.uint8)
    enc = code.encode(set(range(n)), payload.tobytes())
    out = {"encode": _sha(enc), "decode": {}}
    for erased in patterns:
        have = {i: c for i, c in enc.items() if i not in erased}
        dec = code.decode(set(erased), have)
        out["decode"][",".join(map(str, erased))] = _sha(
            {i: dec[i] for i in erased})
    if prof["plugin"] == "clay":
        cs = len(enc[0])
        need = code.minimum_to_repair({0}, set(range(1, n)))
        helpers = {}
        for h, runs in need.items():
            planes = [z for ind, cnt in runs for z in range(ind, ind + cnt)]
            helpers[h] = np.asarray(enc[h], np.uint8).reshape(
                code.get_sub_chunk_count(), -1)[planes].reshape(-1)
        out["repair0"] = _sha(code.repair({0}, helpers, cs))
    return out


def _jax_create(prof):
    from ceph_tpu.ec import create_erasure_code as jax_create

    return jax_create(prof)


def _port_create(prof):
    return create_erasure_code(prof, device="cpu")


def _checked_plain(calls: list):
    def product(Mb, db):
        assert Mb.shape[0] <= tb.MAX_ROWS and Mb.shape[1] <= tb.MAX_COLS
        assert db.shape[1] == Mb.shape[1]
        calls.append(Mb.shape)
        return tb.gf_matmul_plain(Mb, db)
    return product


@pytest.mark.parametrize("R, S", [(4, 70), (33, 3), (33, 33), (40, 130),
                                  (64, 128), (65, 129), (1, 200)])
def test_tiled_equals_untiled(R, S):
    rng = np.random.default_rng(R * 1000 + S)
    M = rng.integers(0, 256, (R, S), np.uint8)
    data = torch.from_numpy(rng.integers(0, 256, (3, S, 40), np.uint8))
    calls = []
    got = tb.gf_matmul_tiled(M, data, _checked_plain(calls))
    assert torch.equal(got, tb.gf_matmul_plain(M, data))
    assert len(calls) == -(-R // tb.MAX_ROWS) * -(-S // tb.MAX_COLS)
    assert sum(r for r, s in calls) == R * -(-S // tb.MAX_COLS)


@pytest.mark.parametrize("R, S", [(32, 64), (4, 8), (1, 1)])
def test_inside_the_limits_is_one_product(R, S):
    rng = np.random.default_rng(R + S)
    M = rng.integers(0, 256, (R, S), np.uint8)
    data = torch.from_numpy(rng.integers(0, 256, (2, S, 16), np.uint8))
    seen = []

    def product(Mb, db):
        seen.append((Mb, db))
        return tb.gf_matmul_plain(Mb, db)

    got = tb.gf_matmul_tiled(M, data, product)
    assert len(seen) == 1 and seen[0][0] is M and seen[0][1] is data
    assert torch.equal(got, tb.gf_matmul_plain(M, data))


def test_matrix_blocks_cover_the_matrix():
    M = np.arange(70 * 130, dtype=np.int64).reshape(70, 130).astype(
        np.uint8)
    blocks = tb.matrix_blocks(M)
    assert [r0 for r0, _ in blocks] == [0, 32, 64]
    back = np.zeros_like(M)
    for r0, cols in blocks:
        assert [c0 for c0, _ in cols] == [0, 64, 128]
        for c0, Mb in cols:
            assert Mb.shape[0] <= 32 and Mb.shape[1] <= 64
            back[r0:r0 + Mb.shape[0], c0:c0 + Mb.shape[1]] = Mb
    assert np.array_equal(back, M)


@pytest.mark.parametrize("name", sorted(WIDE))
def test_wide_profile_bytes_equal_jax(name):
    want = run_wide(_jax_create, name)
    assert want == WIDE[name]["sha256"], \
        "the JAX package drifted from the corpus"
    assert run_wide(_port_create, name) == want


def test_wide_profiles_exceed_the_kernel_limits():
    """The corpus profiles really are past the limits: RS(70,4)'s coding
    matrix has 70 columns, Clay(2,33,19)'s inner code 33 parity rows."""
    rs = _port_create(dict(WIDE["rs_k70m4"]["profile"]))
    assert rs.C.shape == (4, 70) and rs.C.shape[1] > tb.MAX_COLS
    clay = _port_create(dict(WIDE["clay_k2m33_d19"]["profile"]))
    assert clay.m > tb.MAX_ROWS and clay.get_sub_chunk_count() == 324


if __name__ == "__main__":
    for name in sorted(WIDE):
        WIDE[name]["sha256"] = run_wide(_jax_create, name)
    CORPUS.write_text(json.dumps(WIDE, indent=1, sort_keys=True) + "\n")
    print(f"wrote {CORPUS}")
