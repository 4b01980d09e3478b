"""Nothing the benchmark runs loads JAX or the JAX package (``repro``),
comparing top-level module names whole (``repro_torch`` is the port), and
the reference loads nothing of the program either.  Without a card the
benchmark prints no result and exits with another code than 0."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from chipbench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py") if "__pycache__" not in p.parts)
NEVER = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(harness.HERE).as_posix())
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & NEVER


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "configs").glob("*.py"):
        assert "repro_torch" not in top_level_imports(path)
        assert not top_level_imports(path) - {"__future__", "math", "torch", "chipbench"}


def test_the_whole_name_is_compared():
    assert harness.forbidden_loaded(["repro_torch", "repro_torch.models", "torch", "jaxtyping"]) == []
    assert harness.forbidden_loaded(["repro.api.spec", "jax.numpy", "flax"]) == ["flax", "jax", "repro"]


def test_every_config_names_a_reference_beside_it():
    for entry in harness.manifest()["configs"]:
        ref = harness.config_file(entry["name"])["reference"]
        assert (harness.HERE / "configs" / f"{ref}.py").is_file()


def test_without_a_card_no_result_and_a_failing_exit(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                          harness.manifest()["workloads"][0]["name"], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
