"""The PyTorch port stands alone: importing every module of
``vit_grid_model_tpu_torch`` (among them the inference entry points:
serving, generation and station evaluation with their CLIs, the int8
convs of ``ops/quantize.py``, the class heads, the legacy station and grid
models, SimVP with its conv blocks, and the utilities) and
``chip_smoke.py`` in a fresh interpreter
loads no ``jax``, no Triton, nothing of the JAX package
(``vit_grid_model_tpu``) and nothing of ``benchmarks``, and builds no
kernel."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import importlib, pkgutil, sys
import vit_grid_model_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
assert len(names) >= 79, names
new = {'vit_grid_model_tpu_torch.' + m for m in (
    'evaluation.serving', 'evaluation.generate', 'evaluation.station_eval',
    'cli.generate_reanalysis', 'cli.station_eval', 'parallel.mesh',
    'models.classification', 'ops.quantize', 'ops.recurrent',
    'ops.convblocks', 'models.normalizers', 'models.legacy',
    'models.legacy.station', 'models.legacy.grid', 'models.simvp', 'utils',
    'utils.hbm', 'utils.profiling', 'utils.debug')}
assert new <= set(names), new - set(names)
for name in names:
    importlib.import_module(name)
import chip_smoke
from vit_grid_model_tpu_torch.ops.cuda import (attention, attention_variants,
                                               library, mbconv)
from vit_grid_model_tpu_torch.ops import quantize
bad = [m for m in sys.modules
       if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'vit_grid_model_tpu',
                              'benchmarks')]
assert not bad, bad
assert library._lib is None
from vit_grid_model_tpu_torch.data.assembly import (assign_class_masked,
                                                    host_stage_dtype)
from vit_grid_model_tpu_torch.data.datasets import (
    Air_Simulation_Reanalysis_Dataset_by_stn)
from vit_grid_model_tpu_torch.data.pipeline import device_prefetch
from vit_grid_model_tpu_torch.evaluation.serving import Forecaster
from vit_grid_model_tpu_torch.parallel.mesh import pad_to_multiple
assert attention.launches == attention.bwd_launches == mbconv.launches == 0
assert attention.wgrad_launches == 0
assert quantize.launches == 0
assert attention_variants.layer_launches == 0
assert (attention_variants.headmajor_launches
        == attention_variants.stacked_launches
        == attention_variants.perhead_weight_launches
        == attention_variants.staged_core_launches
        == attention_variants.crosshead_launches == 0)
assert attention_variants.perhead_launches[8] == 0
assert attention_variants.perhead_launches[16] == 0
assert sum(attention_variants.perhead_route_launches.values()) == 0
assert sum(attention_variants.outproj_launches.values()) == 0
assert sum(attention_variants.headpack_launches.values()) == 0
print(len(names))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", _CODE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
