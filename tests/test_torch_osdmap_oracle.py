"""The port's OSDMap host oracle (`OSDMap.pg_to_up_acting_osds` and the
stages below it, over the port's `crush/mapper_ref.py`) against the JAX
package's, and against the port's batched `PoolMapper` on the CPU.

The maps are those of tests/test_torch_pipeline.py: each of its cases
builds a `ceph_tpu` map and hands it to `check_pool`; here `check_pool`
is swapped for one that carries the map across and compares the three,
PG by PG.
"""

import inspect
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import test_torch_pipeline  # noqa: E402
from ceph_tpu.crush.types import ITEM_NONE  # noqa: E402
from ceph_tpu.osd.types import PgId as JaxPgId  # noqa: E402
from ceph_tpu_torch.osd.carry import osdmap_from_reference  # noqa: E402
from ceph_tpu_torch.osd.pipeline import PoolMapper  # noqa: E402
from ceph_tpu_torch.osd.types import PgId  # noqa: E402

# the cases of tests/test_torch_pipeline.py that map a pool
CASES = sorted(
    name for name, fn in vars(test_torch_pipeline).items()
    if name.startswith("test_") and "check_pool(" in inspect.getsource(fn))


def oracle_check(m, pool_id: int):
    pm = osdmap_from_reference(test_torch_pipeline.osdmap_dict(m))
    n = m.pools[pool_id].pg_num
    got = [pm.pg_to_up_acting_osds(PgId(pool_id, ps)) for ps in range(n)]
    want = [m.pg_to_up_acting_osds(JaxPgId(pool_id, ps)) for ps in range(n)]
    assert got == want
    assert [pm.pg_to_raw_up(PgId(pool_id, ps)) for ps in range(0, n, 7)] \
        == [m.pg_to_raw_up(JaxPgId(pool_id, ps)) for ps in range(0, n, 7)]
    mapper = PoolMapper(pm, pool_id, device="cpu")
    up, upp, acting, actp = mapper.map_all()
    W = up.shape[1]
    pad = lambda v: (list(v) + [ITEM_NONE] * W)[:W]  # noqa: E731
    for ps, (u, u_p, a, a_p) in enumerate(got):
        assert list(up[ps]) == pad(u) and upp[ps] == u_p, ps
        assert list(acting[ps]) == pad(a) and actp[ps] == a_p, ps
    return mapper  # as check_pool does


@pytest.mark.parametrize("name", CASES)
def test_host_oracle_equals_jax_package(name, monkeypatch):
    monkeypatch.setattr(test_torch_pipeline, "check_pool", oracle_check)
    fn = getattr(test_torch_pipeline, name)
    args = {"rng": np.random.default_rng(0xC3A5)}
    fn(**{p: args[p] for p in inspect.signature(fn).parameters})


def test_cases_found():
    assert len(CASES) >= 15
