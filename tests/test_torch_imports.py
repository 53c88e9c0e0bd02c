"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or the reference package ``repro``.

``repro_torch`` starts with ``repro``, so the reference package is matched
exactly (``repro``) or by its prefix ``repro.``.
"""
import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _forbidden(name: str) -> bool:
    """JAX, or the reference package: ``repro`` itself or ``repro.*``."""
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_forbidden_name_matching():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("jaxlib") and _forbidden("repro")
    assert _forbidden("repro.kernels.ops")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.x")
    assert not _forbidden("torch") and not _forbidden("jaxtyping")


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    mods = list(_port_modules())
    assert {"repro_torch.serving.engine", "repro_torch.core.comm",
            "repro_torch.core.parallel",
            "repro_torch.kernels.onesided_a2a",
            "repro_torch.models.lm", "repro_torch.models.decode",
            "repro_torch.kernels.flash_attention"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_ast_scan_finds_no_jax_or_repro_import():
    files = sorted(PORT.rglob("*.py")) + [SMOKE]
    assert SMOKE.exists() and len(files) > 10
    bad = [(str(p.relative_to(ROOT)), line, name)
           for p in files for line, name in _imports(p)
           if _forbidden(name)]
    assert bad == []


def test_every_cuda_source_is_plain_c_bound_and_smoked():
    """Each ``csrc/*.cu`` is a plain-C library (no PyTorch headers, an
    ``extern "C"`` launcher), loaded by a kernel module of the package,
    and built by ``chip_smoke.py``."""
    sources = sorted((PORT / "csrc").glob("*.cu"))
    assert {p.stem for p in sources} >= {"tbe_gather_pool",
                                         "onesided_a2a", "flash_attention",
                                         "flash_attention_wgmma"}
    loaders = "".join(p.read_text()
                      for p in (PORT / "kernels").glob("*.py"))
    smoke = SMOKE.read_text()
    for src in sources:
        text = src.read_text()
        includes = [ln for ln in text.splitlines()
                    if ln.startswith("#include")]
        assert not any("torch" in ln or "ATen" in ln for ln in includes)
        assert 'extern "C"' in text, src.name
        assert f'_build.load("{src.stem}")' in loaders, src.name
        assert f"src/repro_torch/csrc/{src.name}" in smoke, src.name


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """Here (no CUDA) the smoke run exits non-zero with no result line; so
    does a copy standing alone, without the port beside it."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    for script, cwd in ((SMOKE, ROOT), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
