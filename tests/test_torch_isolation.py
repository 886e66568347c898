"""paddle_tpu_torch stands alone and never falls back.

  * importing the package and every submodule pulls in neither `jax`
    nor `paddle_tpu` (checked in a fresh interpreter);
  * the device rule: with no CUDA device, an entry point given no
    `device=` raises instead of running on the CPU (init_parallel_env
    and build_mesh too);
  * the kernel wrappers have no fallback: a tensor that is not on the
    CPU goes to the kernel or raises, and no `try` in ops/ can swallow
    a launch or build error, nor one in the trainer a collective;
  * a build with no nvcc raises with the reason;
  * the card scripts (chip_smoke.py, serve_ab.py, tools/*_ab.py,
    tools/zero_ranks.py, tools/zero3_host.py) import nothing of the
    reference and, with no CUDA device, exit 2 without a result.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import ops
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.inference import ContinuousBatcher, generate
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.distributed import build_mesh, init_parallel_env
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import ShardedTrainStep

PKG = pathlib.Path(paddle_tpu_torch.__file__).resolve().parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import paddle_tpu_torch, paddle_tpu_torch.inference.serving
import paddle_tpu_torch.inference.generation
import paddle_tpu_torch.distributed.fault, paddle_tpu_torch.distributed.guard
import paddle_tpu_torch.distributed.watchdog
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n in ("jax", "jaxlib", "paddle_tpu")
             or n.startswith(("jax.", "jaxlib.", "paddle_tpu.")))
print("LEAKED", bad)
"""


def test_import_pulls_in_no_jax_and_no_reference():
    root = str(PKG.parent)
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode == 0, res.stderr
    assert "LEAKED []" in res.stdout, res.stdout


def test_sources_never_import_the_reference():
    for f in PKG.rglob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "paddle_tpu"), (f, n)


@pytest.mark.parametrize("script", ["chip_smoke.py", "serve_ab.py",
                                    "tools/quant_matmul_ab.py",
                                    "tools/norm_rope_ab.py",
                                    "tools/ce_rows_ab.py",
                                    "tools/zero_ranks.py",
                                    "tools/zero3_host.py"])
def test_card_scripts_stand_alone_and_refuse_without_cuda(script, tmp_path):
    """The card scripts import nothing of the reference, and with no CUDA
    device (as here) exit 2 and print no result."""
    path = PKG.parent / script
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else [node.module or ""]
            assert not any(n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")
                           for n in names), (script, names)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(path)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2, (res.stdout, res.stderr)
    assert '"ok"' not in res.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_constructor_without_device_raises(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(llama_tiny_config())
    with pytest.raises(RuntimeError, match="no CUDA"):
        LlamaForCausalLM(llama_tiny_config(), device="cuda")


def test_parallel_env_and_mesh_without_device_raise(no_cuda):
    """No process group and no mesh on the CPU unless it is asked for;
    a ShardedTrainStep runs where its model and mesh are."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_parallel_env()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_mesh()
    assert not torch.distributed.is_initialized()
    m = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    mesh = build_mesh(devices=[torch.device("cpu")])
    assert ShardedTrainStep(m, AdamW(1e-3, parameters=m.parameters()),
                            mesh).device.type == "cpu"


def test_batcher_and_generate_without_device_raise(no_cuda):
    m = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(m, np.ones((1, 3), np.int32), 2)
    ContinuousBatcher(m, device="cpu")          # explicit CPU is fine


@pytest.mark.parametrize("call", [
    lambda t: ops.rms_norm(t(2, 8), t(8)),
    lambda t: ops.apply_rope(t(1, 2, 2, 4), t(1, 2, 2, 4), t(2, 4), t(2, 4)),
    lambda t: ops.paged_attention(t(1, 1, 2, 4), t(3, 2, 1, 2, 4),
                                  t(3, 2, 1, 2, 4),
                                  t(1, 2, dtype=torch.int32),
                                  t(1, dtype=torch.int32), 0),
    lambda t: ops.paged_attention(t(1, 1, 2, 4),
                                  t(3, 2, 1, 2, 4, dtype=torch.int8),
                                  t(3, 2, 1, 2, 4, dtype=torch.int8),
                                  t(1, 2, dtype=torch.int32),
                                  t(1, dtype=torch.int32), 0, t(3, 1, 2),
                                  t(3, 1, 2)),
    lambda t: ops.quant_matmul(t(2, 32), t(32, 16, dtype=torch.int8),
                               t(16), "int8"),
    lambda t: ops.quant_matmul(t(2, 32), t(16, 16, dtype=torch.int8),
                               t(2, 16), "int4", 8),
], ids=["rms_norm", "rope", "paged_attention", "paged_attention_int8",
        "quant_matmul_int8", "quant_matmul_int4"])
def test_non_cpu_tensor_never_takes_the_plain_version(call, monkeypatch):
    """A tensor off the CPU goes to the kernel path, which refuses
    anything that is not a CUDA tensor — it never computes a result
    with the plain version."""
    def never(*a, **k):
        raise AssertionError("a plain version ran for a non-CPU tensor")
    for mod, fn in (("paged_attention", "plain_paged_attention"),
                    ("quant_matmul", "plain_quant_matmul")):
        monkeypatch.setattr(ops.kernel_module(mod), fn, never)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype,
                                                         device="meta"))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("call", [
    lambda t: ops.fused_adamw(t(4), t(4), t(4), t(4), 1e-3, 1,
                              out_dtype=torch.float32),
    lambda t: ops.fused_adamw(t(4), t(4), t(4), t(4), 1e-3, 1,
                              out_dtype=torch.bfloat16, ef=t(4)),
    lambda t: ops.ce_rows(t(2, 8), t(2, dtype=torch.int32), t(1),
                          torch.bfloat16),
    lambda t: ops.fused_linear_cross_entropy(
        t(3, 4).requires_grad_(), t(4, 8), t(3, dtype=torch.int32)),
], ids=["fused_adamw", "fused_adamw_master_ef", "ce_rows",
        "fused_linear_cross_entropy"])
def test_non_cpu_tensor_never_takes_the_training_plain_versions(
        call, monkeypatch):
    """The fused AdamW and cross-entropy rows on a tensor off the CPU
    go to their kernels, which refuse anything that is not a CUDA
    tensor; the plain versions are never reached."""
    def never(*a, **k):
        raise AssertionError("a plain version ran for a non-CPU tensor")
    for mod, fn in (("fused_adamw", "plain_fused_adamw"),
                    ("fused_cross_entropy", "plain_ce_rows")):
        monkeypatch.setattr(ops.kernel_module(mod), fn, never)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(lambda *s, dtype=torch.float32: torch.zeros(
            s, dtype=dtype, device="meta"))
    assert ops.launch_counts() == before


def test_training_flags_match_reference_defaults():
    import paddle_tpu.optimizer.jit_update  # noqa: F401 (defines two)
    from paddle_tpu.framework import flags as jflags
    for name in ("use_fused_adamw", "multi_tensor_adamw", "fused_ce",
                 "bf16_adamw_moments"):
        assert tflags.get_flag(name) == jflags.get_flag(name), name
        assert tflags._registry[name]["default"] \
            == jflags._registry[name]["default"], name
    assert tflags.get_flag("fused_adamw_interpret") is None


def _tries(f):
    return [n.lineno for n in ast.walk(ast.parse(f.read_text()))
            if isinstance(n, (ast.Try, ast.ExceptHandler))
            or type(n).__name__ == "TryStar"]


def test_ops_have_no_try():
    for f in sorted((PKG / "ops").glob("*.py")):
        tries = _tries(f)
        assert not tries, f"{f.name}: try/except at lines {tries}"


def test_trainer_and_distributed_have_no_try():
    """No `try` can swallow a failed collective or a kernel launch in
    the trainer, its update or the distributed environment."""
    files = sorted((PKG / "parallel").glob("*.py")) \
        + sorted((PKG / "distributed").rglob("*.py")) \
        + [PKG / "optimizer" / "jit_update.py",
           PKG / "framework" / "data_parallel.py"]
    for f in files:
        tries = _tries(f)
        assert not tries, f"{f}: try/except at lines {tries}"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


_FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: '-c SRC -o OBJ' writes OBJ, '-shared -o LIB ...'
# writes LIB; FAKE_NVCC_FAIL=<name> fails the compile of that source
out=""; src=""; prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  [ "$prev" = "-c" ] && src="$a"
  prev="$a"
done
case "$src" in *"$FAKE_NVCC_FAIL"*)
  if [ -n "$FAKE_NVCC_FAIL" ]; then echo "error: bad kernel in $src"; exit 2; fi;;
esac
echo "ptxas info    : Used 32 registers ($src)"
echo built > "$out"
"""


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda _name: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path / "build"


def test_build_compiles_each_source_then_links(fake_nvcc, monkeypatch):
    monkeypatch.delenv("FAKE_NVCC_FAIL", raising=False)
    lib = _build.build()
    assert lib.parent == fake_nvcc and lib.exists()
    assert _build.build_info["built"]
    for name in ("rms_norm.cu", "rope.cu", "paged_attention.cu",
                 "flash_attention.cu", "fused_adamw.cu", "cross_entropy.cu",
                 "quant_matmul.cu"):
        assert f"== {name} (rc 0)" in _build.build_info["log"]
    assert not list(fake_nvcc.glob("work_*"))      # scratch cleaned up
    _build.build_info["built"] = False
    assert _build.build() == lib                    # cached: no rebuild
    assert not _build.build_info["built"]


def test_build_failure_raises_with_compiler_output(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "rope.cu")
    with pytest.raises(RuntimeError, match="bad kernel in .*rope.cu"):
        _build.build()
    assert not list(fake_nvcc.glob("*.so"))


def test_build_key_follows_the_sources():
    srcs, headers = _build._sources()
    assert {s.name for s in srcs} == {"rms_norm.cu", "rope.cu",
                                      "paged_attention.cu",
                                      "flash_attention.cu", "fused_adamw.cu",
                                      "cross_entropy.cu", "quant_matmul.cu"}
    assert _build._digest(srcs + headers) == _build._digest(srcs + headers)
    assert _build._digest(srcs + headers) != _build._digest(srcs)


def test_kv_flags_match_reference_defaults():
    from paddle_tpu.framework import flags as jflags
    for name in ("kv_cache_dtype", "kv_page_size", "kv_pool_pages"):
        assert tflags.get_flag(name) == jflags.get_flag(name), name
    tflags.set_flags({"FLAGS_kv_page_size": 4})
    try:
        assert tflags.get_flag("FLAGS_kv_page_size") == 4
    finally:
        tflags.set_flags({"FLAGS_kv_page_size": 16})
