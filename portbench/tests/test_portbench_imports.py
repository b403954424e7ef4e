"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import shutil
import subprocess
import sys
import textwrap

from portbench import harness

ROOT = harness.HERE.parent


def _imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_no_jax():
    for path in harness.HERE.rglob("*.py"):
        assert not _imported_tops(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_port():
    for path in (harness.HERE / "reference").glob("*.py"):
        assert "multiplanarunet_tpu_torch" not in _imported_tops(path), path


def _run(code, cwd):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=600)


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
    import sys, tempfile
    from portbench import harness, run
    from portbench.tests.tiny import write_tiny
    bench, data = write_tiny(tempfile.mkdtemp(dir={str(tmp_path)!r}))
    for cell in ("predict2d-256-v6", "train2d-256-b16"):
        code, _ = run.main(["--workload", cell, "--seed", "5",
                            "--seconds", "0.3", "--trace", "0"],
                           bench_path=bench, data_dir=data, device="cpu",
                           require_card=False)
        assert code == 0
    tops = {{m.split(".")[0] for m in sys.modules}}
    assert "multiplanarunet_tpu_torch" in tops
    print("FOUND", sorted(tops & set(harness.FORBIDDEN)))
    """
    out = _run(code, ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def test_the_reference_loads_nothing_of_the_port():
    out = _run("""
    import sys
    from portbench.reference import compare, predict, unet
    tops = {m.split(".")[0] for m in sys.modules}
    print("FOUND", sorted(tops & {"multiplanarunet_tpu_torch", "jax",
                                  "multiplanarunet_tpu"}))
    """, ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def test_fails_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files prints no result and exits with another code than 0."""
    shutil.copyfile(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run("""
    from portbench import run
    run.main(["--workload", "predict2d-256-v6", "--seed", "1",
              "--seconds", "1", "--trace", "0"], device="cpu",
             require_card=False)
    """, tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    no_card = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "predict2d-256-v6", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert no_card.returncode != 0 and '"correct"' not in no_card.stdout
