"""The port's examples, each run as a script in a subprocess with a time limit.

The host-only ones (quickstart, federated_server, replication_drill,
failover_drill) must print what the reference's example prints, line for
line once loopback URLs and temporary paths are set aside; the one line
allowed to differ is the failover drill's f32 sharded solve against its
f64 oracle, where each package rounds its own f32 sums (both under the
drill's bar). The two with a backbone run it on the CPU (``--device
cpu``): the AFL column of the non-IID sweep is one accuracy across every
partition (the AA law), and the serve demo decodes every request.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 240


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script), *args],
                         capture_output=True, text=True, timeout=LIMIT_S, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _normal(text):
    text = re.sub(r"https?://127\.0\.0\.1:\d+", "URL", text)
    text = re.sub(r"at /\S+", "at PATH", text)
    return [line for line in text.splitlines() if line.strip()]


@pytest.mark.parametrize("name", ["quickstart", "federated_server", "replication_drill",
                                  "failover_drill"])
def test_host_example_prints_the_reference_numbers(name):
    args = ("--device", "cpu") if name == "failover_drill" else ()
    got = _normal(_run(f"torch_{name}.py", *args))
    want = _normal(_run(f"{name}.py"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g == w:
            continue
        assert name == "failover_drill" and g.startswith("t4  max|ΔW| vs never-crashed oracle"), (
            g, w)
        assert w.startswith("t4  max|ΔW| vs never-crashed oracle")
        assert float(g.rsplit(" ", 1)[1]) < 1e-4 and float(w.rsplit(" ", 1)[1]) < 1e-4


def test_federated_niid_afl_column_is_constant():
    out = _run("torch_federated_niid.py", "--device", "cpu")
    rows = [line.split() for line in out.splitlines()
            if re.match(r"^(IID|NIID-\d)", line)]
    assert len(rows) == 4
    afl = {r[-1] for r in rows}
    assert len(afl) == 1, rows
    assert float(afl.pop()) > 1 / 16             # above chance: 16 classes
    assert "device cpu" in out


def test_serve_demo_decodes_every_request():
    out = _run("torch_serve_demo.py", "--device", "cpu")
    lines = [line for line in out.splitlines() if "prefill" in line]
    assert len(lines) == 3
    for line in lines:
        sample = re.search(r"sample: \.\.\.\[(.*)\]", line).group(1)
        assert len(sample.split(",")) == 6
