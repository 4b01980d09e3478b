"""The port stands alone: no file of ``src/repro_torch`` nor ``chip_smoke.py``
imports jax or the JAX package; its entry points default to the CUDA device
and raise where there is none (the simulator's measurements on the card
included); a kernel wrapper given a CPU tensor takes the plain version and
launches nothing."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_the_slice_has_its_modules():
    have = {str(p.relative_to(PKG)) for p in FILES[:-1]}
    for want in ("kernels/ref.py", "kernels/_build.py", "kernels/rmsnorm.py",
                 "kernels/flash_attention.py", "kernels/decode_attention.py", "kernels/ops.py",
                 "configs/base.py", "configs/phi4_mini_3_8b.py", "configs/gemma_7b.py",
                 "configs/qwen2_5_32b.py", "configs/yi_34b.py", "models/params.py",
                 "models/layers.py", "models/kvcache.py", "models/model.py",
                 "serving/engine.py", "launch/serve.py", "convert.py",
                 "api/__init__.py", "api/spec.py", "core/__init__.py", "core/ir.py",
                 "core/tracer.py", "core/stubs.py", "core/model_ingest.py", "core/simulator.py",
                 "core/scheduler.py", "core/overlap.py", "core/memory.py", "core/simcache.py",
                 "core/backend/__init__.py", "core/backend/hardware.py",
                 "core/backend/analytical.py", "core/backend/collectives.py",
                 "core/backend/engine.py", "core/backend/prediction.py",
                 "core/backend/profiling.py", "core/passes/__init__.py", "core/passes/base.py",
                 "core/passes/analysis.py", "core/passes/parallelism.py",
                 "core/passes/data_parallel.py", "core/passes/fusion.py",
                 "core/passes/quantize.py", "core/passes/recompute.py",
                 "core/passes/pipeline.py", "core/timeline.py",
                 "obs/__init__.py", "obs/clock.py", "obs/recorder.py", "obs/metrics.py",
                 "obs/explain.py", "serving/__init__.py", "serving/sp_planner.py",
                 "serving/sim/__init__.py", "serving/sim/events.py", "serving/sim/workload.py",
                 "serving/sim/policies.py", "serving/sim/report.py", "serving/sim/oracle.py",
                 "serving/sim/router.py", "serving/sim/sim.py", "resilience/__init__.py",
                 "resilience/faults.py", "resilience/report.py", "resilience/timeline.py",
                 "resilience/sim.py", "core/explorer.py", "api/pool.py", "api/sweep.py",
                 "analysis/__init__.py", "analysis/chaos.py", "analysis/sanitize.py",
                 "analysis/lint/__init__.py", "analysis/lint/__main__.py",
                 "analysis/lint/engine.py", "analysis/lint/report.py", "analysis/lint/rules.py",
                 "training/__init__.py", "training/optimizer.py", "training/train_step.py",
                 "training/data.py", "training/checkpoint.py", "training/fault_tolerance.py",
                 "launch/train.py"):
        assert want in have, want
    for cu in ("rmsnorm.cu", "flash_attention.cu", "flash_attention_bwd.cu",
               "decode_attention.cu", "common.cuh"):
        assert (PKG / "kernels" / "csrc" / cu).exists(), cu


def test_kernel_sources_include_no_torch_header():
    for src in (PKG / "kernels" / "csrc").iterdir():
        text = src.read_text()
        assert "torch/" not in text and "ATen" not in text, src


def test_import_leaves_jax_and_repro_out_of_sys_modules():
    mods = [".".join(p.relative_to(REPO / "src").with_suffix("").parts)
            for p in FILES[:-1] if p.name != "__init__.py"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _no_cuda(monkeypatch):
    """This file's CPU-only expectations hold wherever the tests run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_model_without_a_device_argument_raises_without_a_card(monkeypatch):
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine
    _no_cuda(monkeypatch)
    cfg = get_tiny_config("phi4-mini-3.8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, {}, slots=1, cache_len=8)
    assert Model(cfg, "cpu").device.type == "cpu"       # asked for: fine


def test_launch_serve_without_a_device_argument_raises_without_a_card(monkeypatch):
    from repro_torch.launch import serve
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1"])


def test_launch_train_without_a_device_argument_raises_without_a_card(monkeypatch, tmp_path):
    from repro_torch.launch import train
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--tiny", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--tiny", "--steps", "1", "--device", "cuda", "--ckpt-dir", str(tmp_path)])


def test_simulator_measures_on_the_card_only_and_raises_without_one(monkeypatch):
    from repro_torch.core import Simulator
    from repro_torch.core.backend import profiling
    from repro_torch.core.ir import OpNode
    _no_cuda(monkeypatch)
    node = OpNode("m", "matmul", dtype="bf16", attrs={"mm_dims": (8, 8, 8)})
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulator("h100_sxm", engine="profiling", measure_on_miss=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.synthesize_and_measure(node)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.dispatch_overhead_us()
    assert profiling.synthesize_and_measure(node, device="cpu") > 0     # asked for: fine


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_wrappers_take_the_plain_version_for_cpu_tensors_and_launch_nothing():
    from repro_torch import kernels as K
    K.reset_launch_counts()
    x, w = torch.randn(5, 64), torch.ones(64)
    q, k = torch.randn(1, 4, 8, 64), torch.randn(1, 2, 8, 64)
    assert torch.equal(K.rmsnorm(x, w), K.rmsnorm_plain(x, w))
    assert torch.equal(K.flash_attention(q, k, k), K.flash_attention_plain(q, k, k))
    assert torch.equal(K.decode_attention(q[:, :, 0], k, k),
                       K.decode_attention_plain(q[:, :, 0], k, k))
    assert K.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "decode_attention": 0,
                                "rmsnorm_bwd": 0, "flash_attention_bwd": 0, "adamw": 0,
                                "adafactor": 0}


def test_build_is_keyed_by_source_and_needs_a_compiler(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    src, out = _build._target("rmsnorm")
    assert src.name == "rmsnorm.cu" and out.parent == tmp_path and out.suffix == ".so"
    assert _build._target("flash_attention")[1].name != out.name
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR")
    assert _build.build_dir() == REPO / "build" / "repro_torch_kernels"
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("NVCC", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("rmsnorm")                      # no compiler here: raises, no carry-on
    with pytest.raises(RuntimeError, match="error code 7"):
        _build.check(7, "x")


def test_build_key_follows_every_header_under_csrc(tmp_path, monkeypatch):
    """An edit to any header (not only common.cuh) changes every library's
    name, so the next load rebuilds."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.source_hash(n) for n in _build.SOURCES}
    assert len(set(before.values())) == len(_build.SOURCES)
    (csrc / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text() + "\n// edited\n")
    after = {n: _build.source_hash(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
