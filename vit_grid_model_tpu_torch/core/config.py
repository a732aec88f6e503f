"""Frozen configuration dataclasses of the port.

The port's own copy of ``vit_grid_model_tpu/core/config.py``: the same
classes with the same fields, defaults and validation, so that a config
built for one package describes the same model in the other
(``tests/test_torch_port_host.py`` holds them equal).  The execution knobs
of the JAX package (the Pallas flags, the shard axis) are kept as fields,
which the port's GPU path, running its own kernels, does not read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """The CMAQ grid geometry (reference: ``evaluation_vit.py:89``)."""

    height: int = 82
    width: int = 67

    @property
    def cells(self) -> int:
        return self.height * self.width


@dataclasses.dataclass(frozen=True)
class MetNet3Config:
    """Architecture config of the MaxViT MetNet3 grid model.

    Field defaults mirror the reference constructor defaults
    (``metnet3.py:192-219``) with the shipped 12hr run's values for the
    required fields (``logs/test_simulation_vit_model_12hr.log:1``).
    """

    # (window_size, n_variables, height, width) == input_size_sample
    window_size: int = 25          # input_dim + output_dim (13 + 12)
    n_variables: int = 24          # 6 species x 4 daily init cycles
    input_height: int = 82
    input_width: int = 67

    n_start_channels: int = 128    # hidden_dim
    end_lead_time: int = 12        # output_dim

    lead_time_emb_dim: int = 2
    model_time_emb_dim: int = 1
    concat_time_to_input: bool = True

    pm25: bool = True
    pm10: bool = False
    pm25_boundaries: Tuple[float, ...] = (15.0, 35.0, 75.0)
    pm10_boundaries: Tuple[float, ...] = (15.0, 35.0, 75.0)
    pm25_mean: float = 0.0
    pm25_std: float = 1.0

    resnet_block_depth: int = 2
    direct_regional: bool = False
    ignore_backbone: bool = False
    # class-logits PM2.5 head instead of the 1-channel regression head
    pm25_class_head: bool = False

    # MaxViT backbone
    vit_block_depth: Tuple[int, ...] = (1,)
    n_heads: int = 32
    dim_head: int = 32
    vit_window_size: int = 7
    mbconv_expansion_rate: int = 4
    mbconv_shrinkage_rate: float = 0.25
    dropout: float = 0.1
    num_register_tokens: int = 4
    normalization_method: str = "Standard"

    # Channel indices of the four daily-cycle PM2.5 planes that get
    # standardized inside forward (reference quirk, ``metnet3.py:362``).
    pm25_channel_indices: Tuple[int, ...] = (4, 10, 16, 22)

    # Extra station-observation image channel (``metnet3.py:701``).
    stn_img_channel: Optional[int] = None

    # Execution knobs (no reference equivalent).
    pad_multiple: int = 14         # pad() target multiple (``metnet3.py:324``)
    compute_dtype: str = "float32"  # "bfloat16" for throughput mode
    # compute the lead-independent part of the stem conv once per sample
    fuse_lead_stem: bool = False
    # the JAX package's Pallas attention forward / backward and the mesh
    # axis it shards them over; the port's GPU path always runs its own
    # kernels
    use_pallas_attention: bool = False
    use_pallas_attention_bwd: bool = False
    pallas_shard_axis: Optional[str] = None
    # inference only: fold MBConv's three BatchNorms into the adjacent conv
    # weights (``ops/nn.py::fold_bn_into_conv``); equivalent up to one float
    # re-association per channel
    fold_bn_eval: bool = False
    # input arrives host-prepared as (B, Hp, Wp, T*C), zero-padded to
    # pad_multiple, PM channels still raw
    nhwc_input: bool = False
    # inference only: int8 resnet convs (``ops/quantize.py``)
    int8_convs: bool = False

    def __post_init__(self):
        if self.use_pallas_attention_bwd and not self.use_pallas_attention:
            raise ValueError(
                "use_pallas_attention_bwd=True requires "
                "use_pallas_attention=True (the backward kernel rides the "
                "forward kernel's custom VJP; alone it has no effect)")

    @property
    def n_input_channels(self) -> int:
        return self.window_size * self.n_variables

    @property
    def cond_dim(self) -> int:
        return self.lead_time_emb_dim

    @property
    def depth_tuple(self) -> Tuple[int, ...]:
        d = self.vit_block_depth
        return (d,) if isinstance(d, int) else tuple(d)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset assembly parameters (reference: ``dataset.py`` ctor args and
    ``evaluation_vit.py:694-721`` argparse surface)."""

    input_dim: int = 13
    output_dim: int = 12
    prev_len: int = 13
    feat_dim: int = 12             # station feature dim; feat_dim//2 = 6 species
    grid: GridConfig = GridConfig()

    data_path: str = "../preprocessed_data_from_2016"
    sim_data_path: str = "../../short_term/nier_preprocessed/CMAQ"
    analysis_data_path: str = "../analysis/CMAQ"

    @property
    def species_per_cycle(self) -> int:
        return self.feat_dim // 2

    @property
    def block_channels(self) -> int:
        """Channels per timestep in the stacked CMAQ tensor:
        6 species x 4 cycles + 4 lead-time scalars (``dataset.py:734``)."""
        return self.species_per_cycle * 4 + 4

    @property
    def total_steps(self) -> int:
        return self.input_dim + self.output_dim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters; Focal-R is the documented objective."""

    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    warmup_steps: int = 500
    total_steps: int = 100_000
    batch_size: int = 4
    grad_clip_norm: float = 1.0
    focal_gamma: float = 1.0       # Focal-R activation exponent
    focal_beta: float = 0.2        # scaling of |error| inside the focal weight
    focal_focusing: str = "canonical"  # canonical (2*sigma-1)^g | sigmoid
    loss: str = "focal_r"          # focal_r | mse | mae | huber
    ema_decay: float = 0.0         # >0: keep an EMA copy of the weights
    seed: int = 0
    remat: bool = False            # recompute the backbone in the backward


def shipped_12hr_model_config(pm25_mean: float, pm25_std: float) -> MetNet3Config:
    """Config of the shipped ``simulation_vit_model_12hr.pkt`` run
    (``logs/test_simulation_vit_model_12hr.log:1``)."""
    return MetNet3Config(
        window_size=25,
        n_variables=24,
        n_start_channels=128,
        end_lead_time=12,
        pm25_mean=pm25_mean,
        pm25_std=pm25_std,
    )
