"""What the benchmark loads: after everything it runs, no module whose
top-level name, compared whole, is jax, jaxlib, flax or faid_tpu (the
port's name begins with the JAX package's); and the reference loads
nothing of the port."""

import ast
import json
import subprocess
import sys

from benchmark import harness
from benchmark.registry import HERE, ROOT

LOADED = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.partition('.')[0] for m in sys.modules}})))
"""


def _tops(body: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", LOADED.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, check=True, cwd=ROOT, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A traced rehearsal in one process, every metric reader with it."""
    tops = _tops("from benchmark import harness\n"
                 "o = harness.Options('16qam.codewords-7.5dB', 5, 0.3, True, rehearse=True)\n"
                 "rc, line, _ = harness.lead_main(o, 0.0)\n"
                 "assert rc == 0 and line['correct'], line\n"
                 "import benchmark.control, benchmark.spread")
    assert "faid_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN_MODULES)


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "faid_tpu_torch_extra", sys)
    assert "faid_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "faid_tpu.sim", sys)
    assert "faid_tpu" in harness.forbidden_loaded()


def test_a_rank_that_loads_jax_gives_no_line(tmp_path, monkeypatch):
    """Rank 0 prints nothing where another rank loaded a forbidden module:
    here each child process imports a stub ``jax`` as Python starts."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    (tmp_path / "sitecustomize.py").write_text("import jax  # noqa: F401\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    opts = harness.Options("qpsk.zero-word-4.0dB", 19, 0.3, False, world=2,
                           rehearse=True)
    rc, line, gaps = harness.lead_main(opts, 0.0)
    assert (rc, line, gaps) == (3, None, None)
    assert "jax" not in sys.modules


def test_the_command_refuses_a_machine_without_the_card():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "qpsk.zero-word-4.0dB", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    import torch

    if not torch.cuda.is_available():
        assert p.returncode == 2 and p.stdout == ""


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((HERE / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module]
            else:
                continue
            for n in names:
                assert n.partition(".")[0] in ("__future__", "dataclasses", "enum",
                                               "functools", "math", "pathlib",
                                               "numpy", "torch"), (path, n)
    mods = [p.stem for p in (HERE / "reference").glob("*.py") if p.stem != "__init__"]
    tops = _tops("\n".join(f"import benchmark.reference.{m}" for m in mods))
    assert not tops & {"faid_tpu_torch", *harness.FORBIDDEN_MODULES}
