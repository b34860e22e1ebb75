"""The port stands alone: no JAX, no ``paddle_tpu``, no quiet CPU runs.

- An AST scan of every module of ``paddle_tpu_torch`` finds no import of
  ``jax`` or of ``paddle_tpu`` (``paddle_tpu_torch`` itself is allowed).
- A fresh interpreter whose ``PYTHONPATH`` is the repo root only (so no
  site hook can preload anything) imports the whole package and finds
  neither ``jax`` nor ``paddle_tpu`` in ``sys.modules``.
- Entry points (``to_tensor`` and the ``incubate`` ops among them)
  default to the card and raise where there is none;
  ``chip_smoke.py`` exits non-zero and prints no result without one.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import resolve_device, to_tensor
from paddle_tpu_torch.entry import entry
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import train as tt

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "paddle_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "paddle_tpu" or top == "jaxlib"


def test_no_jax_or_paddle_tpu_import_in_the_port():
    bad = []
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.inference, "
        "paddle_tpu_torch.models, paddle_tpu_torch.serving, "
        "paddle_tpu_torch.ops.kernels, paddle_tpu_torch.models.train, "
        "paddle_tpu_torch.entry, paddle_tpu_torch.incubate.nn.functional"
        "\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.rope_tables(8, 16, 10000.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.init_train_state(tl.LlamaConfig.tiny(), torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_tensor([1.0, 2.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IF.block_multihead_attention(
            np.zeros((1, 48), np.float32), np.zeros((1, 2, 4, 8), np.float32),
            np.zeros((1, 2, 4, 8), np.float32), [0], [0], [1],
            block_tables=[[0]], block_size=4)
    assert resolve_device("cpu") == torch.device("cpu")
    assert to_tensor([1.0], place="cpu").place == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=str(REPO), env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
