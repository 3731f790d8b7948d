"""The port stands alone: it imports torch and never JAX or the JAX package,
and its CLI keeps the JAX CLI's serving flags (every flag and default:
``test_torch_cli.py``).

The import check runs in a subprocess, because this test process (its
conftest) has already imported jax.
"""

import ast
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = "pytorch_distributed_training_example_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_distributed_training_example_tpu")


def _port_modules():
    for path in sorted((REPO / PORT).rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


#: Modules of the training slice; each must be among those checked below.
TRAINING_SLICE = ("core.optim", "core.precision", "core.train_loop",
                  "core.train_state", "core.trainer", "data.datasets",
                  "data.loader", "data.prefetch", "data.sampler",
                  "models.gpt2", "utils.logging", "utils.metrics")
#: Modules of the MoE training slice, likewise.
MOE_SLICE = ("ops.fused_router", "ops.grouped_matmul", "parallel.moe",
             "bench.grouped_matmul_bench")
#: Modules of the ViT training slice, likewise.
VIT_SLICE = ("models.vit", "ops.attention", "ops.flash_attention",
             "bridge")
#: Modules of the ResNet and fused BN-stats matmul slice, likewise.
RESNET_SLICE = ("models.resnet", "ops.fused_bn_matmul", "bench",
                "bench.fused_bn_bench")


def test_importing_the_port_loads_no_jax():
    names = [name for _, name in _port_modules()]
    assert {f"{PORT}.{m}" for m in TRAINING_SLICE + MOE_SLICE + VIT_SLICE
            + RESNET_SLICE} <= set(names)
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "torch" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_no_jax_import_in_port_sources_or_chip_smoke():
    files = [path for path, _ in _port_modules()] + [REPO / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert bad == []


def _root_parser():
    spec = importlib.util.spec_from_file_location("root_main",
                                                  REPO / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_parser()


def test_port_cli_keeps_every_serve_flag_and_default():
    from pytorch_distributed_training_example_tpu_torch import main

    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.const,
                         tuple(a.choices or ()), a.type, a.nargs)
                for a in parser._actions}

    ref, port = flags(_root_parser()), flags(main.build_parser())
    shared = [d for d in ref if d.startswith("serve")] + [
        "model", "precision", "seed", "seq_len", "config", "resume",
        "checkpoint_dir", "metrics_port"]
    assert len([d for d in shared if d.startswith("serve")]) == 25
    for dest in shared:
        assert port.get(dest) == ref[dest], dest
    assert port["device"][1] == "cuda"
    with pytest.raises(SystemExit, match="--device"):
        main.main(["--device", "cpu", "--platform", "cpu"])
