"""`tests/test_torch_cli.py`'s corpus cases on BASELINE config 2, part
b: the port's `osdmaptool` on 100k PGs prints the JAX CLIs' stdout
(tests/data/cli_corpus.json).  A file of their own, so the test run
spreads them over its workers.
"""

import pytest
from test_torch_cli import CONFIG2_FILES, port_cli_prints_the_corpus


@pytest.mark.parametrize("name", CONFIG2_FILES["b"])
def test_port_cli_prints_the_corpus(name, tmp_path, monkeypatch):
    port_cli_prints_the_corpus(name, tmp_path, monkeypatch)
