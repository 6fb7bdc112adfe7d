"""yolosomi_tpu_torch and chip_smoke.py stand alone: no jax, jaxlib, flax,
msgpack (the card has no such package; the port has its own codec),
yolosomi_tpu, tools/ or root-CLI import (the JAX package's detect.py,
serve.py, export.py, ...), checked in the source and in a fresh
interpreter, for every module of the port and for its `-m` entry points
run as scripts."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "yolosomi_tpu", "tools", "detect", "serve", "hubconf", "wbf", "val",
             "train", "export", "bench")
# the port's CLIs that a user runs as `python -m <module>`
ENTRY_POINTS = ("yolosomi_tpu_torch.convert_torch", "yolosomi_tpu_torch.export", "yolosomi_tpu_torch.detect",
                "yolosomi_tpu_torch.val", "yolosomi_tpu_torch.train", "yolosomi_tpu_torch.serve",
                "yolosomi_tpu_torch.wbf")


def _port_sources():
    return sorted((ROOT / "yolosomi_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_nothing_of_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 10 and all(p.exists() for p in sources)
    bad = [
        (str(p.relative_to(ROOT)), mod)
        for p in sources
        for mod in _imported_modules(p)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "yolosomi_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_entry_points_run_as_scripts_load_no_jax():
    """Each `python -m` entry point, run as __main__ with --help, imports
    nothing forbidden (a module run as a script is a fresh import of it)."""
    code = (
        "import runpy, sys\n"
        f"for m in {ENTRY_POINTS!r}:\n"
        "    sys.argv = [m, '--help']\n"
        "    try:\n"
        "        runpy.run_module(m, run_name='__main__', alter_sys=True)\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (m, e.code)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.rstrip().endswith("ok")
