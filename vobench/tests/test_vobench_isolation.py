"""The benchmark stands apart: nothing under vobench/ imports JAX or the
JAX package (compared by whole top-level names: the port's name begins
with the JAX package's), the yardstick (generator, reference, metric
arithmetic, trace reduction, checks) imports nothing of the program,
and a run without a card or without the program prints no result."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "vobench"
FORBIDDEN = {"jax", "jaxlib", "flax", "rebvo_tpu"}
PROGRAM = "rebvo_tpu_torch"
# the files that drive the program; everything else is the yardstick
DRIVING = {"run.py", "control.py"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def sources():
    return sorted(BENCH.rglob("*.py"))


def test_no_jax_anywhere():
    bad = {str(p.relative_to(ROOT)): sorted(set(imported_tops(p)) & FORBIDDEN)
           for p in sources()}
    assert not {k: v for k, v in bad.items() if v}


def test_yardstick_imports_nothing_of_the_program():
    yard = [p for p in sources()
            if "runners" not in p.parts and "tests" not in p.parts
            and p.name not in DRIVING]
    assert any("reference" in p.parts for p in yard)
    bad = [str(p.relative_to(ROOT)) for p in yard
           if PROGRAM in set(imported_tops(p))]
    assert not bad


def test_a_run_loads_no_jax():
    code = ("import sys, vobench.run, vobench.control, vobench.check, "
            "vobench.scene, vobench.trace, vobench.reference.frontend.step, "
            "vobench.reference.kernels.detect_plain, rebvo_tpu_torch.system, "
            "rebvo_tpu_torch.parallel.mesh\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & set("
            f"{sorted(FORBIDDEN)!r}))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run(cwd, timeout=120):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "vobench.run", "--workload",
         "euroc_mono.replay", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=timeout, env=env)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        return              # the card's own runs are the check there
    out = _run(ROOT)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
