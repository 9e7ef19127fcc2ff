"""Nothing on the card's path imports jax, jaxlib, flax or the JAX package
(top-level module names compared whole: ``repro_torch`` is not
``repro``)."""
import ast
import subprocess
import sys
from pathlib import Path

from plexbench import harness

PB = harness.PB


def _imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def test_no_harness_source_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        if "tests" in path.relative_to(PB).parts:
            continue
        bad = set(_imported_tops(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro.fake" in harness.forbidden_modules()


def test_a_whole_run_loads_no_jax(tmp_path):
    """A tiny run on the CPU through the harness and the port, in a fresh
    interpreter, then the modules it loaded."""
    code = f"""
import sys, json
sys.path[:0] = [{str(harness.REPO / 'src')!r}, {str(harness.REPO)!r}]
from pathlib import Path
from plexbench import harness
from repro_torch.launch.mesh import DevicePlane
data = Path({str(PB / 'tests' / 'data')!r})
bench = json.loads((data / 'bench.json').read_text())
for name in ('tiny.train_mux', 'tiny.rollout_mux'):
    cell = harness.Cell(name, bench, data=data)
    run = harness.Run(cell, 3, 0.5, False, device='cpu', cluster_kwargs={{
        'device_plane': DevicePlane(devices=['cpu'])}})
    run.execute()
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_a_host_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        return   # on a card host the command runs; this checks the CPU host
    out = subprocess.run([sys.executable, str(PB / "run.py"), "--workload",
                          "qwen2-0.5b.train_solo", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=harness.REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
