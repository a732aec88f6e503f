"""The PyTorch port stands alone: importing every module of
``vit_grid_model_tpu_torch`` (among them the inference entry points:
serving, generation and station evaluation with their CLIs, the int8
convs of ``ops/quantize.py``, the class heads, the legacy station and grid
models, SimVP with its conv blocks, the utilities, and the eleven datasets
with their host helpers) and ``chip_smoke.py`` in a fresh interpreter
loads no ``jax``, no Triton, nothing of the JAX package
(``vit_grid_model_tpu``) and nothing of ``benchmarks``, and builds no
kernel.  Their sources hold no import of ``jax`` or of the JAX package
either, not even inside a function, where importing a module runs none."""

import os
import re
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
from vit_grid_model_tpu_torch.data.assembly import (
    assemble_output_only_simulation, assign_class_masked, host_stage_dtype,
    model_input_to_nhwc)
from vit_grid_model_tpu_torch.data.datasets import (
    Air_Simulation_Reanalysis_Dataset,
    Air_Simulation_Reanalysis_Dataset_by_stn,
    Air_Simulation_Reanalysis_Dataset_only,
    Air_Simulation_Reanalysis_Dataset_v2,
    Air_Simulation_Reanalysis_Dataset_v3,
    Air_Simulation_Reanalysis_Dataset_w_curr,
    Air_Simulation_Reanalysis_Dataset_with_station_imgs, Air_only_Dataset,
    Air_with_Simulation_Dataset, Air_with_Simulation_Dataset_v2,
    Air_with_fixed_Sat_Dataset, AirOnlyDataset,
    AirSimulationReanalysisDataset, AirSimulationReanalysisDatasetV2,
    AirSimulationReanalysisDatasetWithCurr,
    AirSimulationReanalysisDatasetWithStationImgs, AirWithFixedSatDataset,
    AirWithSimulationDataset, AirWithSimulationDatasetV2)
from vit_grid_model_tpu_torch.data.native import (load_cycle_files_native,
                                                  reset_unsupported_count,
                                                  unsupported_count)
from vit_grid_model_tpu_torch.data.readers import set_fault_injection
from vit_grid_model_tpu_torch.data.synthetic import write_station_images
from vit_grid_model_tpu_torch.data.timeutil import raw_time_rows
from vit_grid_model_tpu_torch.data.pipeline import device_prefetch
from vit_grid_model_tpu_torch.evaluation.serving import Forecaster
from vit_grid_model_tpu_torch.parallel.mesh import pad_to_multiple
assert attention.launches == attention.bwd_launches == mbconv.launches == 0
assert attention.wgrad_launches == 0
assert sum(attention.fwd_route_launches.values()) == 0
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


# an import statement of jax, jaxlib or the JAX package (not of the port,
# whose name only begins with the JAX package's), at any indentation
_JAX_IMPORT = re.compile(
    r"^[ \t]*(?:from[ \t]+(?:jax|jaxlib|vit_grid_model_tpu)\b"
    r"|import[ \t]+(?:[\w.]+(?:[ \t]+as[ \t]+\w+)?[ \t]*,[ \t]*)*"
    r"(?:jax|jaxlib|vit_grid_model_tpu)\b)", re.M)


def _sources():
    pkg = os.path.join(ROOT, "vit_grid_model_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        paths += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return paths


def test_port_sources_import_no_jax():
    """Every import statement of the port's sources and ``chip_smoke.py``,
    top-level or inside a function, names neither ``jax`` nor the JAX
    package."""
    paths = _sources()
    assert len(paths) >= 80, paths
    hits = []
    for path in paths:
        with open(path) as f:
            text = f.read()
        hits += [f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}"
                 for m in _JAX_IMPORT.finditer(text)]
    assert not hits, hits
    for line in ("    from vit_grid_model_tpu.data import native",
                 "import jax.numpy as jnp", "from jax import lax",
                 "import numpy as np, jax", "\tfrom jaxlib import xla_client"):
        assert _JAX_IMPORT.search(line), line
    for line in ("from vit_grid_model_tpu_torch.data import native",
                 "import vit_grid_model_tpu_torch", "import jaxtyping",
                 "# the JAX package (vit_grid_model_tpu) is not imported"):
        assert not _JAX_IMPORT.search(line), line
