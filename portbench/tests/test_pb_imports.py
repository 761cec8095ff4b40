"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's); the
reference imports nothing of the program; without a card, or without the
program beside it, the command prints no result."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap
import types

import pytest

from portbench import run, spec

ROOT = spec.ROOT


def _python(code, cwd=ROOT, pythonpath=ROOT, timeout=300):
    env = {"PYTHONPATH": str(pythonpath), "PATH": "/usr/bin:/bin"}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("module,flagged", [
    ("jax", ["jax"]), ("jax.numpy", ["jax"]), ("jaxlib.xla_client", ["jaxlib"]),
    ("flax.linen", ["flax"]), ("frenetix_tpu.ops", ["frenetix_tpu"]),
    ("frenetix_tpu_torch.ops", []), ("jaxtyping", []), ("frenetix_tpu_x", []),
])
def test_top_level_names_are_compared_whole(module, flagged, monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, module, types.ModuleType(module))
    assert run.forbidden_modules() == flagged


def test_a_run_loads_no_jax():
    out = _python("""
        import json, sys, torch
        from portbench import run
        from portbench.tests.conftest import tiny
        torch.set_num_threads(2)
        for cell in ("ego_dense.sweep", "convoy8_risk.open"):
            config, mix = tiny(cell)
            result, _, _ = run.run_cell(cell, 3, 0.2, False, torch.device("cpu"),
                                        config=config, mix=mix, setup_from=lambda: 0.0)
            assert result["correct"]
        top = sorted({m.split(".")[0] for m in sys.modules})
        print(json.dumps({"bad": run.forbidden_modules(), "top": top}))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["bad"] == []
    assert "frenetix_tpu_torch" in seen["top"] and "frenetix_tpu" not in seen["top"]


def test_the_reference_imports_nothing_of_the_program():
    out = _python("""
        import json, sys
        import portbench.reference, portbench.judge, portbench.generate
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    top = json.loads(out.stdout.strip().splitlines()[-1])
    assert not {"frenetix_tpu_torch", "frenetix_tpu", "jax", "jaxlib"} & set(top)


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "ego_dense.sweep", "--seed", str(2 ** 40), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
                                           "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _python("""
        import torch
        from portbench import run
        run.run_cell("ego_dense.sweep", 1, 0.2, False, torch.device("cpu"))
    """, cwd=tmp_path, pythonpath=tmp_path)
    assert out.returncode != 0
    assert "frenetix_tpu_torch" in out.stderr
