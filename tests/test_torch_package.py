"""Package contracts of the PyTorch port: it stands alone (no JAX, nothing
of the JAX package), mirrors the JAX package's module paths, runs on the
card by default and never hands back CPU state in its place."""
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import scenarios as TS
from repro_torch.configs import firefly_snn
from repro_torch.core import snn
from repro_torch.launch import serve
from repro_torch.models import factory

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
            "       or m.startswith(('jax.', 'repro.'))]\n"
            "assert all(sys.modules[m] is None for m in bad), bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr


def _mirrored(rel: Path) -> bool:
    """repro has ``rel`` as a module or a package; a port package may also
    mirror a directory of repro without ``__init__.py`` that holds one of
    the port package's own modules."""
    there = SRC / "repro" / rel
    if there.with_suffix(".py").exists() or (there / "__init__.py").exists():
        return True
    here = SRC / "repro_torch" / rel
    return any((there / p.name).exists() for p in here.glob("*.py")
               if p.name != "__init__.py")


def test_modules_mirror_the_jax_package():
    """Each port module has its counterpart at the same path in repro
    (the build helper and the converter are the port's own)."""
    own = {"repro_torch.kernels._build", "repro_torch.convert"}
    for name in _modules():
        if name in own:
            continue
        assert _mirrored(Path(*name.split(".")[1:])), name


def test_lm_stack_is_walked():
    """The LM stack's modules are among those held to the two tests
    above."""
    assert {"repro_torch.models.transformer", "repro_torch.models.plastic",
            "repro_torch.models.ssm", "repro_torch.kernels.attention.kernel",
            "repro_torch.kernels.ssd.kernel",
            "repro_torch.launch.serve"} <= set(_modules())


def test_kernel_sources_ship_with_the_package():
    csrc = Path(repro_torch.__file__).parent / "csrc"
    assert {p.name for p in csrc.iterdir()} >= {
        "fleet_step.cu", "rollout.cu", "shared_step.cu",
        "rollout_shared.cu", "lif_forward.cu", "flash_attention.cu",
        "ssd.cu", "recorder.cu", "plasticity.cuh", "hopper.cuh",
        "fleet.cuh"}


@pytest.mark.parametrize("entry", ("init_state", "run", "reset", "serve",
                                   "init_cache"))
def test_default_device_is_the_card(entry, monkeypatch):
    """With CUDA unavailable, an entry point without ``device=`` raises
    instead of returning CPU tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = TS.SCENARIOS["stabilizer-wind"]
    env = spec.make_env()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "init_state":
            snn.init_state(firefly_snn.CONFIG, batch=4, fleet=True)
        elif entry == "run":
            scfg = TS.controller_config(env)
            TS.make_closed_loop(env, scfg, batch=2, steps=3).run(
                TS.reference_rule(spec.env_name, scfg), 0)
        elif entry == "serve":
            serve.main(["--smoke", "--plastic", "--gen", "1"])
        elif entry == "init_cache":
            factory.build("qwen3-4b", smoke=True).init_cache(1, 8)
        else:
            TS.VectorEnv(env, 2).reset(0)
    st = snn.init_state(firefly_snn.CONFIG, batch=4, fleet=True,
                        device="cpu")
    assert st.w[0].shape == (4, 8, 128) and st.w[0].device.type == "cpu"


@pytest.mark.parametrize("where", ("checkout", "alone"))
def test_chip_smoke_refuses_without_card_or_checkout(where, tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where there
    is no CUDA card, and when it stands alone without the package."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, cwd=script.parent, env=env, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
