"""`crush/explain.py` and `crushtool explain` / `--locate-divergence`
held against the JAX package: TestExplainReplay, TestFirstDivergence and
TestCrushtoolCLI of tests/test_explain.py, on the port.

- recorder purity: `mapper_ref.do_rule(recorder=...)` gives the rows it
  gives without one;
- the event logs and `render_text` equal the JAX package's, byte for byte;
- `first_divergence` records equal the JAX package's: none on the map the
  kernel was built from, the first differing step against a
  perturbed-tunables map and against a reweighted map;
- the CLI verbs print what the JAX CLI prints, with its exit codes.

The JAX package's outputs are stored in tests/data/explain_corpus.json;
`python tests/test_torch_explain.py` rewrites the file (this file's
sections and tests/test_torch_diag.py's, about 2 min on the CPU), and the
`test_stored_*` tests hold the JAX package to what is stored.  The map
files of the CLI cases ride in the corpus (base64 of the wire format), so
chip_smoke.py can run the same commands on the card.
"""

import base64
import contextlib
import copy
import functools
import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu.crush.types import Tunables  # noqa: E402
from ceph_tpu_torch.crush import explain, mapper_ref, soa  # noqa: E402
from ceph_tpu_torch.crush.codec import decode_crushmap  # noqa: E402
from util_maps import build_flat, build_tree, ec_rule, replicated_rule  # noqa: E402,E501

CORPUS = ROOT / "tests" / "data" / "explain_corpus.json"
N_X = 128
W32 = [0x10000] * 32


# -- the maps (ceph_tpu CrushMaps) -----------------------------------------

def jax_maps() -> dict:
    """name -> (ceph_tpu CrushMap, ruleno, result_max, weights)."""
    hier, root = build_tree(np.random.default_rng(7), n_host=8,
                            osd_per_host=4)
    r = replicated_rule(hier, root, fd_type=1, numrep=3)
    pert, proot = build_tree(
        np.random.default_rng(7), n_host=8, osd_per_host=4,
        tunables=Tunables(chooseleaf_vary_r=0, chooseleaf_stable=0))
    replicated_rule(pert, proot, fd_type=1, numrep=3)
    rew = copy.deepcopy(hier)
    b = rew.buckets[min(rew.buckets)]
    rew.adjust_item_weight(b.items[0], b.weights[0] * 4)
    ec, eroot = build_tree(np.random.default_rng(3), n_host=8,
                           osd_per_host=4)
    er = ec_rule(ec, eroot, fd_type=1, k_m=6)
    flat, froot = build_flat(16)
    fr = replicated_rule(flat, froot, fd_type=0, numrep=3)
    half = [0x10000 if i % 2 else 0 for i in range(16)]
    return {"hier": (hier, r, 3, W32), "hier_perturbed": (pert, r, 3, W32),
            "hier_reweighted": (rew, r, 3, W32), "ec": (ec, er, 6, W32),
            "flat_half_out": (flat, fr, 3, half)}


EXPLAIN_SEEDS = {"hier": [7, 42, 1234], "ec": [5, 99],
                 "flat_half_out": [3, 17]}


def map_bytes(name: str) -> bytes:
    from ceph_tpu.crush.codec import encode_crushmap

    return encode_crushmap(jax_maps()[name][0])


@functools.cache
def corpus() -> dict:
    return json.loads(CORPUS.read_text())


@functools.cache
def port_map(name: str):
    return decode_crushmap(base64.b64decode(corpus()["maps"][name]))


def canonical(obj):
    """JSON's view of a record (tuples become lists)."""
    return json.loads(json.dumps(obj))


# -- explain replay -----------------------------------------------------------

def jax_explain_entries() -> dict:
    from ceph_tpu.crush import explain as jexp
    from ceph_tpu.osd.osdmap import build_hierarchical
    from ceph_tpu.osd.types import PgPool

    maps = jax_maps()
    out = {}
    for name, seeds in EXPLAIN_SEEDS.items():
        m, r, rmax, w = maps[name]
        for x in seeds:
            ex = jexp.explain_seed(m, r, x, rmax, w)
            out[f"{name}/{x}"] = {"record": canonical(ex),
                                  "text": jexp.render_text(ex,
                                                           m.item_names)}
    om = build_hierarchical(4, 4, pool=PgPool(pg_num=64, size=3))
    for seed in (5, 63):
        ex = jexp.explain_pool_pg(om, 0, seed)
        out[f"pool0/{seed}"] = {"record": canonical(ex),
                                "text": jexp.render_text(ex)}
    out["errors"] = [jexp.explain_pool_pg(om, 9, 0),
                     jexp.explain_pool_pg(om, 0, 10_000)]
    return out


def test_recorder_never_perturbs():
    m = port_map("hier")
    for x in range(32):
        want = mapper_ref.do_rule(m, 0, x, 3, W32)
        rec = explain.ExplainRecorder()
        assert mapper_ref.do_rule(m, 0, x, 3, W32, recorder=rec) == want
        assert rec.events and rec.steps[-1] == want


def test_recorder_leaves_the_histogram_alone():
    m = port_map("hier")
    hists = []
    for rec in (None, explain.ExplainRecorder()):
        m.choose_tries_histogram = None
        for x in range(64):
            mapper_ref.do_rule(m, 0, x, 3, W32, collect_choose_tries=True,
                               recorder=rec)
        hists.append(list(m.choose_tries_histogram))
    m.choose_tries_histogram = None
    assert hists[0] == hists[1]


@pytest.mark.parametrize("key", [f"{n}/{x}" for n, xs in
                                 EXPLAIN_SEEDS.items() for x in xs])
def test_explain_seed_equals_jax(key):
    name, x = key.split("/")
    _, r, rmax, w = jax_maps()[name]
    m = port_map(name)
    ex = explain.explain_seed(m, r, int(x), rmax, w)
    want = corpus()["explain"][key]
    assert canonical(ex) == want["record"]
    assert explain.render_text(ex, m.item_names) == want["text"]


def _pool_map():
    from ceph_tpu_torch.osd.carry import osdmap_from_reference
    from ceph_tpu.osd.osdmap import build_hierarchical
    from ceph_tpu.osd.types import PgPool
    from test_torch_pipeline import osdmap_dict

    return osdmap_from_reference(osdmap_dict(
        build_hierarchical(4, 4, pool=PgPool(pg_num=64, size=3))))


@pytest.mark.parametrize("seed", [5, 63])
def test_explain_pool_pg_equals_jax(seed):
    ex = explain.explain_pool_pg(_pool_map(), 0, seed)
    want = corpus()["explain"][f"pool0/{seed}"]
    assert canonical(ex) == want["record"]
    assert explain.render_text(ex) == want["text"]


def test_explain_pool_pg_errors_equal_jax():
    om = _pool_map()
    assert [explain.explain_pool_pg(om, 9, 0),
            explain.explain_pool_pg(om, 0, 10_000)] == \
        corpus()["explain"]["errors"]


def test_stored_explain_is_the_jax_packages():
    assert canonical(jax_explain_entries()) == corpus()["explain"]


def test_event_log_shape():
    m = port_map("hier")
    ex = explain.explain_seed(m, 0, 1234, 3, W32)
    kinds = [ev["ev"] for ev in ex["events"]]
    assert kinds[0] == "take" and "choose" in kinds and "emit" in kinds
    assert len(ex["steps"]) == 1 and ex["steps"][0] == ex["result"]
    # chooseleaf: outer + leaf recursion placements
    assert sum(k == "place" for k in kinds) == 3 * 2
    for ev in ex["events"]:
        if ev["ev"] == "straw2":
            assert max(ev["draws"], key=lambda d: d[1])[0] == ev["winner"]


# -- first divergence ----------------------------------------------------------

DIVERGENCE = {"same": "hier", "perturbed": "hier_perturbed",
              "reweighted": "hier_reweighted"}


def jax_divergence_entries() -> dict:
    from ceph_tpu.crush import explain as jexp
    from ceph_tpu.crush.soa import build_arrays

    maps = jax_maps()
    m, r, rmax, w = maps["hier"]
    A = build_arrays(m)
    xs = np.arange(N_X, dtype=np.uint32)
    return {key: canonical(jexp.first_divergence(maps[host][0], A, r, xs,
                                                 rmax, w))
            for key, host in DIVERGENCE.items()}


@pytest.mark.parametrize("key", sorted(DIVERGENCE))
def test_first_divergence_equals_jax(key):
    A = soa.build_arrays(port_map("hier"))
    d = explain.first_divergence(port_map(DIVERGENCE[key]), A, 0,
                                 np.arange(N_X, dtype=np.uint32), 3, W32,
                                 device="cpu")
    want = corpus()["divergence"][key]
    assert canonical(d) == want
    assert (want is None) == (key == "same")


def test_perturbed_divergence_is_the_first_differing_host_step():
    """Independent of the stored record: the earliest step where two host
    walks (the kernel's map, the perturbed map) differ over the batch."""
    m, m2 = port_map("hier"), port_map("hier_perturbed")
    A = soa.build_arrays(m)
    xs = np.arange(N_X, dtype=np.uint32)
    d = explain.first_divergence(m2, A, 0, xs, 3, W32, device="cpu")
    expect = None
    for x in xs:
        s1 = explain.explain_seed(m, 0, int(x), 3, W32, detail=False)
        s2 = explain.explain_seed(m2, 0, int(x), 3, W32, detail=False)
        for s in range(max(len(s1["steps"]), len(s2["steps"]))):
            a = (s1["steps"][s] if s < len(s1["steps"]) else []) + [0] * 3
            b = (s2["steps"][s] if s < len(s2["steps"]) else []) + [0] * 3
            if a[:3] != b[:3]:
                if expect is None or s < expect[0]:
                    expect = (s, int(x))
                break
    assert expect is not None and d["step"] == expect[0]
    assert d["jax"] != d["host"] and d["host_log"]["x"] == d["x"]
    assert d["n_checked"] + d["n_unresolved_skipped"] == N_X


def test_stored_divergence_is_the_jax_packages():
    assert jax_divergence_entries() == corpus()["divergence"]


def test_device_choose_tries_equals_the_host():
    m = port_map("hier")
    A = soa.build_arrays(m)
    xs = np.arange(N_X, dtype=np.uint32)
    hist, unres = explain.device_choose_tries(A, 0, 3, xs, W32, 51,
                                              device="cpu")
    m.choose_tries_histogram = [0] * 51
    for x in xs:
        mapper_ref.do_rule(m, 0, int(x), 3, W32, collect_choose_tries=True)
    assert hist.tolist() == m.choose_tries_histogram and len(unres) == 0
    m.choose_tries_histogram = None


# -- the CLI -------------------------------------------------------------------

# name -> (argv after "-i <map>", maps the command reads)
CLI_CASES = {
    "explain_x": (["explain", "42", "--num-rep", "3"], ["hier"]),
    "explain_pool_seed": (["explain", "1.7", "--num-rep", "3"], ["hier"]),
    "explain_ec": (["explain", "5", "--num-rep", "6"], ["ec"]),
    "divergence_clean": (["--locate-divergence", "--max-x", "63",
                          "--num-rep", "3"], ["hier"]),
    "divergence_against": (["--locate-divergence", "--against",
                            "hier_perturbed", "--max-x", "63",
                            "--num-rep", "3"], ["hier", "hier_perturbed"]),
}


def cli_run(pkg: str, name: str, where: Path) -> tuple[int, str]:
    """(rc, stdout) of one CLI case, its map files written to `where`
    (the command runs there)."""
    if pkg == "jax":
        from ceph_tpu.cli.crushtool import main
    else:
        from ceph_tpu_torch.cli.crushtool import main
    argv, files = CLI_CASES[name]
    for f in files:
        (where / f).write_bytes(base64.b64decode(corpus()["maps"][f])
                                if pkg == "port" else map_bytes(f))
    argv = ["-i", str(where / files[0])] + [
        str(where / a) if a in files else a for a in argv]
    if pkg == "port" and "--locate-divergence" in argv:
        argv += ["--device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    # the paths of the map files are the caller's
    return rc, out.getvalue().replace(str(where) + "/", "")


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_crushtool_equals_jax_cli(name, tmp_path):
    rc, out = cli_run("port", name, tmp_path)
    want = corpus()["cli"][name]
    assert rc == want["rc"]
    assert out == want["stdout"]
    assert hashlib.sha256(out.encode()).hexdigest() == want["sha256"]


def test_stored_cli_is_the_jax_clis(tmp_path):
    for name in ("explain_x", "divergence_against"):
        d = tmp_path / name
        d.mkdir()
        rc, out = cli_run("jax", name, d)
        assert (rc, out) == (corpus()["cli"][name]["rc"],
                             corpus()["cli"][name]["stdout"])


def test_locate_divergence_without_a_card_raises(tmp_path, monkeypatch):
    import torch

    from ceph_tpu_torch.cli.crushtool import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (tmp_path / "m").write_bytes(base64.b64decode(corpus()["maps"]["hier"]))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-i", "m", "--locate-divergence", "--max-x", "3"])


# -- the corpus ----------------------------------------------------------------

def write_corpus() -> None:
    """Rewrite tests/data/explain_corpus.json from the JAX package."""
    import tempfile

    import test_torch_diag

    maps = {n: base64.b64encode(map_bytes(n)).decode() for n in jax_maps()}
    data = {
        "about": "the JAX package's outputs for tests/test_torch_explain.py "
                 "and tests/test_torch_diag.py (python "
                 "tests/test_torch_explain.py rewrites it)",
        "maps": maps,
        "explain": canonical(jax_explain_entries()),
        "divergence": jax_divergence_entries(),
    }
    CORPUS.write_text(json.dumps(data))  # cli_run reads the maps from it
    corpus.cache_clear()
    cli = {}
    for name in CLI_CASES:
        with tempfile.TemporaryDirectory() as d:
            rc, out = cli_run("jax", name, Path(d))
        cli[name] = {"argv": CLI_CASES[name][0], "maps": CLI_CASES[name][1],
                     "rc": rc, "stdout": out,
                     "sha256": hashlib.sha256(out.encode()).hexdigest()}
    data["cli"] = cli
    data.update(test_torch_diag.write_corpus_sections())
    CORPUS.write_text(json.dumps(data))


if __name__ == "__main__":
    write_corpus()
