"""A run without the cell's card fails with no result line, and a run in
a directory that holds only the benchmark fails too."""
import os
import shutil
import subprocess
import sys


from conftest import PORTBENCH

ROOT = os.path.dirname(PORTBENCH)


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dog.volume",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "CUDA" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_verdict_needs_every_number_within_its_limit():
    from harness import bench

    ok, compared = bench.judge({"a": 0.1, "b": 0.0}, {"a": 0.1, "b": 0},
                               failed=0)
    assert ok and compared["a"] == {"value": 0.1, "limit": 0.1}
    assert not bench.judge({"a": 0.2}, {"a": 0.1}, failed=0)[0]
    assert not bench.judge({"a": 0.0}, {"a": 0.1}, failed=1)[0]
