"""The port's placement CLIs against the JAX package's, byte for byte.

Each case is a list of steps, each one `crushtool` or `osdmaptool` argv.
The steps run in-process through `ceph_tpu.cli.*.main` in one empty
directory and through `ceph_tpu_torch.cli.*.main` (with `--device cpu`
where a step maps) in another; an ("inc", map, file, fn) step writes the
Incremental fn(map) with `ceph_tpu`'s encoder, for `--apply-incremental`.  Every step's stdout, stderr and exit code,
and at the end every file either directory holds, must be identical.  The
cases follow tests/test_cli.py.  `--createsimple` stamps the wall clock
into the map, so both tools' clocks are pinned.

tests/data/cli_corpus.json holds the sha256 of the JAX CLIs' stdout for
the commands `chip_smoke.py` runs on the card (BASELINE.json configs 1 and
2, config 1's test on a map of straw hosts, a test of
tests/data/legacy_crushmap.txt, `osdmaptool --upmap` on config 2, with
the upmap file it writes, and `osdmaptool --health` on config 2 with all
OSDs up and with 8 of them down); `python tests/test_torch_cli.py`
rewrites it,
and the tests here check that the JAX CLIs still print what it holds.
"""

import contextlib
import hashlib
import io
import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ceph_tpu.cli import crushtool as jax_crushtool  # noqa: E402
from ceph_tpu.cli import osdmaptool as jax_osdmaptool  # noqa: E402
from ceph_tpu.osd.incremental import (  # noqa: E402
    Incremental,
    encode_incremental,
)
from ceph_tpu.osd.io import load_osdmap as jax_load_osdmap  # noqa: E402
from ceph_tpu.osd.types import PgId  # noqa: E402
from ceph_tpu_torch.cli import crushtool, osdmaptool  # noqa: E402

CORPUS = ROOT / "tests" / "data" / "cli_corpus.json"
CLOCK = (1700000000, 123456789)  # the pinned wall clock of --createsimple

TOOLS = {"jax": {"crushtool": jax_crushtool, "osdmaptool": jax_osdmaptool},
         "port": {"crushtool": crushtool, "osdmaptool": osdmaptool}}

# a map of uniform, list and tree hosts of unequal weights under a straw
# root, with a replicated and an erasure rule (chip_smoke.py runs it on
# the card too)
LEGACY_MAP = ROOT / "tests" / "data" / "legacy_crushmap.txt"
TEXT_MAP = LEGACY_MAP.read_text()

CONF = """[global]
\tosd pool default size = 3
[osd.0]
\thost = a
\track = r0
[osd.1]
\thost = a
\track = r0
[osd.2]
\thost = b
\track = r1
[osd.3]
\thost = c
\track = r1
"""

# (tool, argv, maps): `maps` steps get --device cpu in front on the port
C, O = "crushtool", "osdmaptool"
BUILD8 = (C, ["--build", "--num_osds", "8", "host", "straw2", "2", "root",
              "straw2", "0", "-o", "m"], False)
CREATE16 = (O, ["om", "--createsimple", "16", "--pg-bits", "4",
                "--with-default-pool"], False)
# CREATE16 with 4 hosts of 4 OSDs (crushtool --build) imported
HOSTS16 = [CREATE16,
           (C, ["--build", "--num_osds", "16", "host", "straw2", "4",
                "root", "straw2", "0", "-o", "h16"], False),
           (O, ["om", "--import-crush", "h16", "--mark-up-in", "--save"],
            False)]


def stale_upmaps(m):
    """An Incremental that leaves pool 1 with upmap entries
    `clean_pg_upmaps` must drop or simplify: a pair whose `from` is not
    in the raw row, a full remap equal to the raw row, a valid pair with
    a stale one after it, and an OSD marked out under a pair."""
    raw = {ps: m.pg_to_raw_osds(PgId(1, ps))[0] for ps in range(4)}
    free = [o for o in range(m.max_osd) if o not in raw[2]]
    inc = Incremental(epoch=m.epoch + 1)
    inc.new_pg_upmap_items = {
        PgId(1, 0): [(99, 5)],
        PgId(1, 2): [(raw[2][0], free[0]), (77, free[1])],
        PgId(1, 3): [(raw[3][1], 15)],
    }
    inc.new_pg_upmap = {PgId(1, 1): list(raw[1])}
    inc.new_weight = {15: 0}
    return inc


def reweight_and_temp(m):
    """An Incremental with a reweight, a down OSD, a pg_temp and an
    upmap pair."""
    inc = Incremental(epoch=m.epoch + 1)
    inc.new_weight = {3: 0x8000, 6: 0}
    inc.new_state = {9: 2}  # XOR of OSD_UP: osd.9 goes down
    inc.new_pg_temp = {PgId(1, 4): [1, 2, 3]}
    inc.new_primary_temp = {PgId(1, 4): 2}
    raw = m.pg_to_raw_osds(PgId(1, 5))[0]
    inc.new_pg_upmap_items = {PgId(1, 5): [(raw[0], 12)]}
    return inc

CASES = {
    "crushtool_help": [(C, ["--help"], False)],
    "crushtool_missing_argument": [(C, ["-i"], False)],
    "crushtool_no_input": [(C, [], False)],
    "crushtool_unknown_alg": [(C, ["--build", "--num_osds", "4", "host",
                                   "bogus", "2"], False)],
    "build_tree_text": [(C, ["--build", "--num_osds", "8", "host", "straw2",
                             "2", "root", "straw2", "0", "-o",
                             "built.txt"], False),
                        (C, ["-i", "built.txt", "--tree"], False)],
    "build_print_tree": [(C, ["--build", "--num_osds", "6", "host", "list",
                              "3", "root", "straw", "0"], False)],
    "compile_decompile_round_trip": [
        BUILD8, (C, ["-d", "m", "-o", "m.txt"], False),
        (C, ["-c", "m.txt", "-o", "m2"], False), (C, ["-d", "m2"], False)],
    "compile_legacy_text": [
        ("write", "legacy.txt", TEXT_MAP),
        (C, ["-c", "legacy.txt", "-o", "legacy"], False),
        (C, ["-d", "legacy"], False),
        (C, ["-i", "legacy", "--test", "--show-mappings", "--max-x", "40",
             "--num-rep", "3"], True),
        (C, ["-i", "legacy", "--test", "--rule", "1", "--num-rep", "4",
             "--max-x", "60", "--show-mappings", "--show-bad-mappings"],
         True)],
    "test_statistics_utilization": [
        BUILD8, (C, ["-i", "m", "--test", "--num-rep", "3", "--min-x", "0",
                     "--max-x", "255", "--show-statistics",
                     "--show-utilization"], True)],
    "test_mappings_pool_id": [
        BUILD8, (C, ["-i", "m", "--test", "--num-rep", "2", "--max-x", "31",
                     "--pool-id", "7", "--show-mappings"], True)],
    "test_bad_mappings": [
        (C, ["--build", "--num_osds", "4", "host", "straw2", "2", "root",
             "straw2", "0", "-o", "m"], False),
        (C, ["-i", "m", "--test", "--num-rep", "3", "--max-x", "63",
             "--show-bad-mappings"], True)],
    "test_simulate": [
        (C, ["--build", "--num_osds", "4", "root", "straw2", "0", "-o", "m"],
         False),
        (C, ["-i", "m", "--test", "--num-rep", "2", "--max-x", "31",
             "--simulate", "--show-mappings", "--show-statistics"], True)],
    "test_weight_utilization_all": [
        BUILD8, (C, ["-i", "m", "--test", "--num-rep", "3", "--max-x", "127",
                     "-w", "3", "0.5", "-w", "5", "0", "--show-statistics",
                     "--show-utilization-all"], True)],
    "test_choose_tries": [
        BUILD8, (C, ["-i", "m", "--test", "--num-rep", "3", "--max-x", "63",
                     "-w", "2", "0", "--show-choose-tries"], True)],
    "test_backend_ref": [
        BUILD8, (C, ["-i", "m", "--test", "--num-rep", "3", "--max-x", "63",
                     "--backend", "ref", "--show-mappings"], False)],
    "straw_host_map": [
        (C, ["--build", "--num_osds", "32", "host", "straw", "4", "root",
             "straw2", "0", "-o", "m"], False),
        (C, ["-i", "m", "--test", "--num-rep", "3", "--max-x", "255",
             "--show-statistics", "--show-utilization"], True)],
    "uniform_tree_list_hosts": [
        (C, ["--build", "--num_osds", "24", "host", "uniform", "4", "rack",
             "tree", "3", "root", "list", "0", "-o", "m"], False),
        (C, ["-i", "m", "--test", "--num-rep", "3", "--max-x", "127",
             "--show-mappings", "--show-statistics"], True)],
    "reweight_item": [
        BUILD8, (C, ["-i", "m", "--reweight-item", "osd.3", "2.5", "-o",
                     "m3.txt"], False),
        (C, ["-i", "m3.txt", "--tree"], False)],
    "osdmaptool_no_args": [(O, [], False)],
    "osdmaptool_help": [(O, ["--help"], False)],
    "osdmaptool_no_filename": [(O, ["--print"], False)],
    "osdmaptool_missing_file": [(O, ["nope", "--print"], False)],
    "createsimple_print_tree": [
        CREATE16, (O, ["om", "--print"], False), (O, ["om", "--tree"], False),
        (O, ["om", "--dump", "json"], False),
        (O, ["om", "--createsimple", "4"], False)],
    "test_map_pgs": [CREATE16, (O, ["om", "--mark-up-in", "--test-map-pgs"],
                                True)],
    "test_map_pgs_dump": [
        (O, ["om", "--createsimple", "8", "--pg-bits", "3",
             "--with-default-pool"], False),
        (O, ["om", "--mark-up-in", "--test-map-pgs-dump"], True),
        (O, ["om", "--mark-up-in", "--mark-out", "3",
             "--test-map-pgs-dump-all"], True)],
    "test_map_pg_and_object": [
        CREATE16, (O, ["om", "--test-map-pg", "1.5"], False),
        (O, ["om", "--test-map-object", "foo", "--pool", "1"], False),
        (O, ["om", "--test-map-object", "bar"], False)],
    "import_crush_then_map": [
        CREATE16,
        (C, ["--build", "--num_osds", "16", "node", "straw2", "4", "root",
             "straw2", "0", "-o", "cf.txt"], False),
        (O, ["om", "--import-crush", "cf.txt"], False),
        (O, ["om", "--mark-up-in", "--test-map-pgs", "--pool", "1"], True),
        (O, ["om", "--export-crush", "cm"], False),
        (C, ["-d", "cm"], False)],
    "adjust_crush_weight_save": [
        CREATE16, (O, ["om", "--adjust-crush-weight", "0:2.5,3:0", "--save"],
                   False),
        (O, ["om", "--mark-up-in", "--test-map-pgs"], True)],
    "upmap_save": HOSTS16 + [
        (O, ["om", "--upmap", "out", "--upmap-deviation", "1",
             "--upmap-max", "20", "--save"], True),
        (O, ["om", "--test-map-pgs"], True)],
    "upmap_flat_ref_stdout": [
        (O, ["om", "--createsimple", "8", "--pg-bits", "3",
             "--with-default-pool"], False),
        (O, ["om", "--mark-up-in", "--upmap", "-", "--upmap-deviation",
             "1", "--upmap-max", "8", "--backend", "ref"], True),
        (O, ["om", "--mark-up-in", "--upmap", "-", "--upmap-deviation",
             "1", "--osd_calc_pg_upmaps_aggressively=false"], True)],
    "upmap_pool": HOSTS16 + [
        (O, ["om", "--upmap", "out", "--upmap-pool", "rbd",
             "--upmap-deviation", "1", "--upmap-max", "8"], True),
        (O, ["om", "--upmap", "out2", "--upmap-pool", "nope"], True),
        (O, ["om", "--upmap", "out3", "--upmap-deviation", "0"], True)],
    "upmap_cleanup_after_incremental": HOSTS16 + [
        ("inc", "om", "inc", stale_upmaps),
        (O, ["om", "--apply-incremental", "inc"], False),
        (O, ["om", "--upmap-cleanup", "-"], True),
        (O, ["om", "--upmap-cleanup", "clean.txt", "--print"], True)],
    "apply_incremental_then_map": HOSTS16 + [
        ("inc", "om", "inc", reweight_and_temp),
        (O, ["om", "--apply-incremental", "inc", "--print"], False),
        (O, ["om", "--test-map-pgs-dump-all"], True),
        (O, ["om", "--test-map-pg", "1.4"], False)],
    "adjust_crush_weight_then_upmap": HOSTS16 + [
        (O, ["om", "--adjust-crush-weight", "0:2", "--save"], False),
        (O, ["om", "--upmap", "out", "--upmap-deviation", "1",
             "--upmap-max", "12", "--save"], True),
        (O, ["om", "--print"], False)],
    "health_up_then_down": HOSTS16 + [
        (O, ["om", "--health"], True),
        ("inc", "om", "inc", reweight_and_temp),
        (O, ["om", "--apply-incremental", "inc", "--save"], False),
        (O, ["om", "--health"], True),
        (O, ["om", "--health", "--backend", "ref"], True)],
    "create_from_conf": [
        ("write", "ceph.conf", CONF),
        (O, ["om", "--create-from-conf", "-c", "ceph.conf",
             "--with-default-pool"], False),
        (O, ["om", "--tree"], False),
        (O, ["om", "--mark-up-in", "--test-map-pgs"], True)],
}


def run_step(pkg: str, tool: str, argv: list[str], maps: bool):
    """(rc, stdout, stderr) of one step of `pkg`'s tool, in the cwd."""
    if pkg == "port" and maps:
        argv = ["--device", "cpu"] + argv
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = TOOLS[pkg][tool].main(list(argv))
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def run_case(pkg: str, steps, where: Path, monkeypatch) -> list:
    monkeypatch.chdir(where)
    monkeypatch.setattr(TOOLS[pkg]["osdmaptool"], "_now_utime",
                        lambda: CLOCK)
    got = []
    for step in steps:
        if step[0] == "write":
            (where / step[1]).write_text(step[2])
            continue
        if step[0] == "inc":
            m = jax_load_osdmap(str(where / step[1]))
            (where / step[2]).write_bytes(encode_incremental(step[3](m)))
            continue
        got.append(run_step(pkg, *step))
    return got


def files(where: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(where.iterdir())}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_cli_equals_jax_cli(name, tmp_path, monkeypatch):
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    pd.mkdir()
    want = run_case("jax", CASES[name], jd, monkeypatch)
    got = run_case("port", CASES[name], pd, monkeypatch)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, f"step {i}"
    assert files(pd) == files(jd)


@pytest.mark.parametrize("argv, flag", [
    (["om", "--health"], "--health"),
])
def test_osdmaptool_refuses_what_waits(argv, flag, tmp_path, monkeypatch):
    """The flag that waited for obs/health.py (it exited 1, "not yet
    ported") now runs: the port's stdout, stderr and exit code equal the
    JAX CLI's on the same map (the `health_*` cases hold more)."""
    monkeypatch.chdir(tmp_path)
    for step in HOSTS16:
        run_step("port", *step)
    got = run_step("port", "osdmaptool", argv, True)
    assert got == run_step("jax", "osdmaptool", argv, False)
    assert got[0] == 0 and f"{flag}: not yet ported" not in got[2]
    assert json.loads(got[1])["status"] == "HEALTH_OK"


@pytest.mark.parametrize("argv", [["-i", "m", "explain", "3"],
                                  ["-i", "m", "--locate-divergence",
                                   "--max-x", "31", "--num-rep", "3"]])
def test_crushtool_refuses_what_waits(argv, tmp_path, monkeypatch):
    """The verbs that waited for crush/explain.py (they exited 1, "not
    yet ported") now run: the port's stdout, stderr and exit code equal
    the JAX CLI's on the same map (tests/test_torch_explain.py holds
    more of their cases)."""
    monkeypatch.chdir(tmp_path)
    run_step("port", *BUILD8)
    got = run_step("port", "crushtool", argv,
                   "--locate-divergence" in argv)
    assert got == run_step("jax", "crushtool", argv, False)
    assert got[0] == 0 and "not yet ported" not in got[2]


def test_crushtool_cpu_device_is_the_plain_version(tmp_path, monkeypatch):
    """Without a card the torch backend needs --device cpu: the default
    is the card, and a missing one is an error, not a move to the host."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    run_step("port", *BUILD8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_step("port", "crushtool", ["-i", "m", "--test", "--max-x", "3"],
                 False)


# -- the corpus of chip_smoke.py's CLI commands ---------------------------

def corpus_commands() -> dict:
    """name -> steps: setup steps, then the step whose stdout is hashed.
    A ("config2", path) step saves BASELINE config 2's map."""
    test1 = ["-i", "m", "--test", "--num-rep", "3", "--min-x", "0",
             "--max-x", "1023", "--show-statistics", "--show-utilization"]
    return {
        "config1": [(C, ["--build", "--num_osds", "32", "host", "straw2",
                         "4", "root", "straw2", "0", "-o", "m"]),
                    (C, test1)],
        "config1_straw_hosts": [(C, ["--build", "--num_osds", "32", "host",
                                     "straw", "4", "root", "straw2", "0",
                                     "-o", "m"]),
                                (C, test1)],
        "config2": [("config2", "m"),
                    (O, ["m", "--test-map-pgs", "--pool", "0"])],
        "config2_upmap": [("config2", "m"),
                          (O, ["m", "--upmap", "upmap.txt",
                               "--upmap-deviation", "5", "--upmap-max",
                               "10"])],
        "config2_health": [("config2", "m"), (O, ["m", "--health"])],
        "config2_health_down": [("config2_down", "m"),
                                (O, ["m", "--health"])],
        "legacy_text": [(C, ["-c", str(LEGACY_MAP), "-o", "legacy"]),
                        (C, ["-i", "legacy", "--test", "--num-rep", "3",
                             "--max-x", "1023", "--show-mappings",
                             "--show-statistics"])],
    }


# the files a corpus command writes whose sha256 the corpus holds too
CORPUS_FILES = {"config2_upmap": ["upmap.txt"]}
# corpus commands whose last step exits non-zero (HEALTH_WARN)
CORPUS_RC = {"config2_health_down": 1}
CONFIG2_DOWN = range(8)  # the OSDs ("config2_down", path) marks down


def save_config2(pkg: str, path: str, down=()) -> None:
    """BASELINE config 2 (bench.py::build_map(100000, 1024)): 128 hosts of
    8 OSDs under 8 racks, one size-3 pool of 100k PGs; OSDs `down`
    marked down."""
    if pkg == "jax":
        from ceph_tpu.osd.io import save_osdmap
        from ceph_tpu.osd.osdmap import build_hierarchical
        from ceph_tpu.osd.types import PgPool, PoolType
    else:
        from ceph_tpu_torch.osd.io import save_osdmap
        from ceph_tpu_torch.osd.osdmap import build_hierarchical
        from ceph_tpu_torch.osd.types import PgPool, PoolType
    pool = PgPool(type=PoolType.REPLICATED, size=3, crush_rule=0,
                  pg_num=100000, pgp_num=100000)
    m = build_hierarchical(128, 8, n_rack=8, pool=pool)
    for o in down:
        m.mark_down(o)
    save_osdmap(m, path)


def corpus_stdout(pkg: str, steps, maps: bool = False, rc: int = 0) -> str:
    """The last step's stdout, in the cwd; every step but the last exits
    0, the last `rc`."""
    for i, step in enumerate(steps):
        if step[0] in ("config2", "config2_down"):
            save_config2(pkg, step[1],
                         CONFIG2_DOWN if step[0] == "config2_down" else ())
            continue
        got, out, err = run_step(pkg, step[0], step[1], maps)
        assert got == (rc if i == len(steps) - 1 else 0), err
    return out


def sha(text: str | bytes) -> str:
    if isinstance(text, str):
        text = text.encode()
    return hashlib.sha256(text).hexdigest()


def file_hashes(name: str) -> dict:
    """sha256 of the files corpus command `name` wrote, in the cwd."""
    return {f: sha(Path(f).read_bytes()) for f in CORPUS_FILES.get(name, [])}


def _stored() -> dict:
    return json.loads(CORPUS.read_text())["stdout_sha256"]


def _stored_files() -> dict:
    return json.loads(CORPUS.read_text())["file_sha256"]


def test_corpus_holds_every_command():
    assert sorted(_stored()) == sorted(corpus_commands())
    assert sorted(_stored_files()) == sorted(CORPUS_FILES)


@pytest.mark.parametrize("name", sorted(corpus_commands()))
def test_corpus_is_the_jax_clis(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert sha(corpus_stdout("jax", corpus_commands()[name],
                             rc=CORPUS_RC.get(name, 0))) == _stored()[name]
    assert file_hashes(name) == _stored_files().get(name, {})


@pytest.mark.parametrize("name", sorted(corpus_commands()))
def test_port_cli_prints_the_corpus(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = corpus_stdout("port", corpus_commands()[name], maps=True,
                        rc=CORPUS_RC.get(name, 0))
    assert sha(got) == _stored()[name]
    assert file_hashes(name) == _stored_files().get(name, {})


def write_corpus() -> None:
    """Rewrite tests/data/cli_corpus.json from the JAX CLIs."""
    import tempfile

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    hashes, files = {}, {}
    for name, steps in corpus_commands().items():
        with tempfile.TemporaryDirectory() as d:
            cwd = os.getcwd()
            os.chdir(d)
            try:
                hashes[name] = sha(corpus_stdout(
                    "jax", steps, rc=CORPUS_RC.get(name, 0)))
                if name in CORPUS_FILES:
                    files[name] = file_hashes(name)
            finally:
                os.chdir(cwd)
        print(name, hashes[name], files.get(name, ""))
    CORPUS.write_text(json.dumps({
        "about": "sha256 of the JAX CLIs' stdout for chip_smoke.py's CLI "
                 "commands (tests/test_torch_cli.py::corpus_commands), and "
                 "of the files they write (CORPUS_FILES); written by "
                 "`python tests/test_torch_cli.py`",
        "stdout_sha256": hashes, "file_sha256": files}, indent=1) + "\n")


if __name__ == "__main__":
    write_corpus()
