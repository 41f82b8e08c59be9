"""Port parity: the scaling-report tool (tools/scaling_report.py).

The two cases of tests/test_scaling_report.py run on the port with
``--platform cpu`` (device lists of ``["cpu"] * n``); added: the
multi-process rung over gloo with two workers, and the rows' keys held
to the JAX tool's at the same arguments.
"""

import json
import os

import pytest
import torch

from avxwindowfmindex_tpu.tools import scaling_report as jax_report
from avxwindowfmindex_tpu_torch.tools import scaling_report

TINY = ["--bases", "4096", "--queries", "64", "--kmer-len", "12", "--seed-k", "4",
        "--devices", "1,2", "--hosts", "2", "--repeats", "1"]


def test_scaling_report_single_host(tmp_path, capsys):
    out = tmp_path / "scaling.json"
    rc = scaling_report.main([
        "--platform", "cpu",
        "--bases", "65536", "--queries", "256", "--kmer-len", "15",
        "--seed-k", "6", "--devices", "1,2", "--hosts", "0",
        "--repeats", "1", "--json", str(out),
    ])
    assert rc == 0
    rows = json.loads(out.read_text())["rows"]
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert r["count_qps"] > 0
        assert r["count_allgather_qps"] > 0
        assert r["locate_qps"] > 0
    assert "| rung |" in capsys.readouterr().out


def test_scaling_report_weak_mode(tmp_path):
    out = tmp_path / "scaling.json"
    rc = scaling_report.main([
        "--platform", "cpu",
        "--bases", "65536", "--queries", "128", "--kmer-len", "12",
        "--seed-k", "6", "--devices", "2", "--mode", "weak",
        "--hosts", "0", "--repeats", "1", "--json", str(out),
    ])
    assert rc == 0
    rows = json.loads(out.read_text())["rows"]
    assert rows[0]["queries"] == 256  # 128 per device x 2


@pytest.fixture(scope="module")
def port_rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling") / "port.json"
    assert scaling_report.main(["--platform", "cpu", *TINY, "--json", str(out)]) == 0
    return json.loads(out.read_text())["rows"]


@pytest.mark.skipif(
    os.environ.get("AWFM_SKIP_MULTIHOST") == "1",
    reason="multi-process test disabled",
)
def test_scaling_report_multi_process_rung(port_rows):
    assert [r["hosts"] for r in port_rows] == [1, 1, 2]
    row = port_rows[-1]
    assert "gloo" in row["rung"] and row["devices"] == 2
    assert row["queries"] == 64 and row["count_allgather_qps"] > 0


@pytest.mark.skipif(
    os.environ.get("AWFM_SKIP_MULTIHOST") == "1",
    reason="multi-process test disabled",
)
def test_row_keys_equal_the_jax_tools(tmp_path, port_rows):
    out = tmp_path / "jax.json"
    assert jax_report.main(["--platform", "cpu", *TINY, "--json", str(out)]) == 0
    jax_rows = json.loads(out.read_text())["rows"]
    assert [sorted(r) for r in port_rows] == [sorted(r) for r in jax_rows]
    assert [r["queries"] for r in port_rows] == [r["queries"] for r in jax_rows]


def test_cuda_is_the_default_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    assert scaling_report._parse_args([]).platform == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        scaling_report.main(["--bases", "4096", "--hosts", "0"])
