"""Hygiene of the PyTorch port: what it imports, where it runs, what it rejects.

* no module of `src/repro_torch/`, nor `chip_smoke.py`, imports `jax` or the
  JAX package `repro` (the port keeps its own copies of what it needs);
* the entry points run on the card unless the caller asks for the CPU, and
  raise on a host without one;
* every kernel op rejects a backend pin it does not know, including a pin
  to the kernel (a CUDA tensor always goes to its kernel);
* `chip_smoke.py` fails without a card, and outside a checkout.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.adaln_modulate import ops as adaln_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.quant_matmul import ops as qmm_ops
from repro_torch.kernels.unipc_update import ops as uni_ops
from repro_torch.launch import sample as launch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "ablate_kernels.py",
    ROOT / "step_walls.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_files_were_found():
    assert len(PORT_FILES) > 20
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"src/repro_torch/models/quant.py",
            "src/repro_torch/kernels/quant_matmul/ops.py",
            "src/repro_torch/kernels/quant_matmul/kernel.py",
            "src/repro_torch/kernels/quant_matmul/ref.py"} <= names


def test_serving_obs_and_tuning_subpackages_are_scanned():
    """The subpackages ported with serving, observability and the tuner are
    in the import scan above."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for sub, mods in (("serving", ("__init__", "scheduler", "server",
                                   "resilience", "faults")),
                      ("obs", ("__init__", "metrics", "trace", "report",
                               "probe")),
                      ("tuning", ("__init__", "plans", "objective",
                                  "search")),
                      ("launch", ("serve", "obsreport", "tune"))):
        for mod in mods:
            assert f"src/repro_torch/{sub}/{mod}.py" in names


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")


def test_sample_defaults_to_the_card_and_raises_without_one():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.sample("dit-cifar", nfe=2, batch=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "dit-cifar", "--nfe", "2", "--batch", "1"])


def test_serve_defaults_to_the_card_and_raises_without_one():
    _no_card()
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_diffusion("dit-cifar", nfe=2, batch=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "dit-cifar", "--nfe", "2", "--batch", "1"])


def test_tune_defaults_to_the_card_and_raises_without_one():
    _no_card()
    from repro_torch.launch import tune

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.tune("dit-cifar", nfe=2, batch=1, train_steps=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.main(["--nfe", "2", "--batch", "1", "--train-steps", "0"])


def test_train_defaults_to_the_card_and_raises_without_one():
    _no_card()
    from repro_torch.launch import train, tune

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train("dit-cifar", objective="diffusion", steps=1, batch=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "dit-cifar", "--objective", "diffusion",
                    "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.main(["--nfe", "2", "--batch", "1", "--train-steps", "1"])


def test_host_mesh_defaults_to_the_card_and_raises_without_one():
    """make_host_mesh() is the card's 1x1 mesh and raises without a card;
    importing launch.mesh and parallel.sharding, or building an abstract or
    a CPU mesh, touches no CUDA (checked in a fresh process)."""
    from repro_torch.launch import mesh

    code = ("import torch\n"
            "def no_cuda(*a, **k):\n"
            "    raise AssertionError('CUDA initialised')\n"
            "torch.cuda._lazy_init = torch.cuda.init = no_cuda\n"
            "from repro_torch.launch import mesh\n"
            "from repro_torch.parallel import sharding\n"
            "assert mesh.make_production_mesh(multi_pod=True).size == 512\n"
            "assert mesh.make_host_mesh('cpu').size == 1\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_host_mesh()


def test_mesh_modules_are_scanned():
    """The modules ported with the mesh layer are in the import scan."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for mod in ("parallel/__init__", "parallel/sharding", "launch/mesh"):
        assert f"src/repro_torch/{mod}.py" in names


def test_training_subpackages_are_scanned():
    """The modules ported with training are in the import scan above."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for mod in ("data/__init__", "data/synthetic", "optim/__init__",
                "optim/adamw", "optim/schedule", "checkpoint/__init__",
                "checkpoint/ckpt", "launch/train"):
        assert f"src/repro_torch/{mod}.py" in names


def test_analysis_subpackages_are_scanned():
    """The modules ported with the analysis layer are in the import scan
    above."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for mod in ("analysis/__init__", "analysis/roofline", "analysis/opcount",
                "launch/specs", "launch/dryrun"):
        assert f"src/repro_torch/{mod}.py" in names


def test_dryrun_is_a_meta_only_entry_point(monkeypatch, tmp_path, capsys):
    """launch.dryrun never initialises CUDA, on any host: it builds and
    counts on the meta device, as the reference's dry run lowers on host
    CPU devices and never on the TPU."""
    from repro_torch.launch import dryrun

    def no_cuda(*a, **k):
        raise AssertionError("launch.dryrun initialised CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(torch.cuda, "init", no_cuda)
    dryrun.main(["--arch", "dit-cifar", "--shape", "train_4k",
                 "--objective", "diffusion", "--out", str(tmp_path)])
    dryrun.main(["--sample", "--arch", "dit-cifar", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[ok] dit-cifar x train_4k x h100x1" in out
    assert "[ok] dit-cifar x sample_nfe10 x h100x1" in out
    assert len(list(tmp_path.glob("*.json"))) == 2


def test_chip_smoke_takes_every_bound_from_the_analysis_layer():
    """chip_smoke.py holds no bound formula and no hardware constant of its
    own: a kernel case's bound is its op's cost on `analysis/roofline.py`,
    a path's the roofline of its operation count."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assigned = {t.id for n in tree.body if isinstance(n, ast.Assign)
                for t in n.targets if isinstance(t, ast.Name)}
    assert not defined & {"token_bounds", "ssm_bounds", "cond_bounds",
                          "attention_pairs"}
    assert not assigned & {"HBM_BYTES_PER_S", "PEAK_FLOPS"}
    imported = {(n.module, a.name) for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) for a in n.names}
    assert ("repro_torch.analysis.roofline", "kernel_bound") in imported


def test_cli_runs_on_the_cpu_when_asked(capsys):
    x0 = launch.main(["--arch", "dit-cifar", "--nfe", "2", "--batch", "1",
                      "--device", "cpu"])
    assert x0.shape == (1, 64, 32)   # reduced(): latent_dim min(48, 32)
    assert "finite=True" in capsys.readouterr().out


_OPS = {
    "unipc_update": lambda b: uni_ops.weighted_combine(
        torch.zeros(3, 2, 4), torch.zeros(3), backend=b),
    "unipc_row_predict": lambda b: uni_ops.unipc_row_predict(
        torch.zeros(2, 4), torch.zeros(3, 2, 4), torch.zeros(5, 11),
        torch.tensor(1), 1.0, backend=b),
    "unipc_row_correct": lambda b: uni_ops.unipc_row_correct(
        torch.zeros(2, 4), torch.zeros(3, 2, 4), torch.zeros(2, 4),
        torch.zeros(2, 4), torch.zeros(5, 11), torch.tensor([1, 0]), 1.0,
        backend=b)[1],
    "adaln_modulate": lambda b: adaln_ops.modulate(
        torch.zeros(2, 3, 4), torch.zeros(2, 4), torch.zeros(2, 4), backend=b),
    "gate_residual": lambda b: adaln_ops.gate_residual(
        torch.zeros(2, 3, 4), torch.zeros(2, 4), torch.zeros(2, 3, 4),
        backend=b),
    "flash_attention": lambda b: fa_ops.attention(
        *(torch.zeros(1, 2, 3, 4) for _ in range(3)), backend=b),
    "quant_matmul": lambda b: qmm_ops.quant_matmul(
        torch.zeros(2, 3, 4), torch.zeros(4, 5, dtype=torch.int8),
        torch.ones(5), backend=b),
    "quant_matmul w8a8": lambda b: qmm_ops.quant_matmul(
        torch.zeros(2, 3, 4), torch.zeros(4, 5, dtype=torch.int8),
        torch.ones(5), sa=0.5, backend=b),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_ops_reject_unknown_backends_and_kernel_pins_on_the_cpu(op):
    for pin in ("pallas", "kernel"):
        with pytest.raises(ValueError, match="backend must be"):
            _OPS[op](pin)
    assert _OPS[op]("plain").shape == _OPS[op](None).shape


def test_kernel_builds_land_in_an_ignored_directory():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "quant_matmul" in build.SOURCES
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
        rel = build.target(name).relative_to(ROOT)
        assert f"{rel.parts[0]}/" in ignored
        assert build.target(name).suffix == ".so"


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    _no_card()
    res = _run_smoke(ROOT)
    assert res.returncode != 0 and '"ok": true' not in res.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0 and '"ok": true' not in res.stdout


def test_ablations_match_the_kernel_sources():
    """Every edit of ablate_kernels.py still finds its anchor in the CUDA
    source it ablates (the script refuses to run otherwise)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import ablate_kernels

    for name, (src, edits) in ablate_kernels.ABLATIONS.items():
        text = (build.CSRC / f"{src}.cu").read_text()
        for anchor, _ in edits:
            assert text.count(anchor) == 1, (name, anchor)
