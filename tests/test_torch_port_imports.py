"""The PyTorch port runs where JAX is absent: importing every module of
``vit_grid_model_tpu_torch`` (and ``chip_smoke.py``) in a fresh interpreter
loads no ``jax`` and no Triton, and builds no kernel."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import importlib, pkgutil, sys
import vit_grid_model_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
assert len(names) >= 15, names
for name in names:
    importlib.import_module(name)
import chip_smoke
from vit_grid_model_tpu_torch.ops.cuda import attention
bad = [m for m in ('jax', 'jaxlib', 'triton') if m in sys.modules]
assert not bad, bad
assert attention._lib is None and attention.launches == 0
print(len(names))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", _CODE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
