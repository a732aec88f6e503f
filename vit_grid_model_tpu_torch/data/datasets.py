"""The eleven datasets of the reference, as the port's own copy of
``vit_grid_model_tpu/data/datasets.py``.

Each is a map-style dataset returning numpy arrays in the reference's
per-class tuple order, plus a ``collate`` that stacks samples.  Six hold
their arrays in memory (``AirWithFixedSatDataset`` to
``AirSimulationReanalysisDatasetWithCurr``); five load CMAQ cycle files
and reanalysis days on the fly (``_LazyCmaqDataset``): the train sample
``AirSimulationReanalysisDatasetV3``, the shipped eval sample
``AirSimulationReanalysisDatasetOnly``, the station evaluation's
``AirSimulationReanalysisDatasetByStn``, the output-window-only
``AirSimulationReanalysisDatasetV2`` and the station-image
``AirSimulationReanalysisDatasetWithStationImgs``.  The reference's class
names are aliases at the end.

Windowing contract (``dataset.py:1089-1100``):
``mod_idx = idx + prev_len - 1``; inputs ``[mod_idx-input_dim+1, mod_idx]``;
targets ``[mod_idx+1, mod_idx+output_dim]``;
``len = len(times) - (prev_len-1) - output_dim``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from vit_grid_model_tpu_torch.data import assembly, native
from vit_grid_model_tpu_torch.data.bufferpool import POOL
from vit_grid_model_tpu_torch.data.timeutil import raw_time_rows


def _stack(samples):
    return tuple(np.stack(field, axis=0) for field in zip(*samples))


class _WindowedDataset:
    """Windowing and station features (``dataset.py:44-83``); ``feats`` and
    ``masks`` may be None for a class that reads neither."""

    collate = staticmethod(_stack)
    collate_fn = staticmethod(_stack)

    def __init__(self, times, feats, masks, input_dim, output_dim, prev_len,
                 korea_stn_num, china_stn_num):
        self.times = times
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.prev_len = prev_len
        self.korea_stn_num = korea_stn_num
        self.china_stn_num = china_stn_num
        self.total_stn_num = korea_stn_num + china_stn_num
        self.feats = (np.asarray(feats, dtype=np.float32)
                      if feats is not None else None)
        self.masks = np.asarray(masks) if masks is not None else None

    def __len__(self) -> int:
        return len(self.times) - (self.prev_len - 1) - self.output_dim

    def _mod_idx(self, idx: int) -> int:
        return idx + (self.prev_len - 1)

    def load_feats(self, idx: int) -> np.ndarray:
        m = self._mod_idx(idx)
        return self.feats[m - self.input_dim + 1: m + 1]

    def load_masks(self, idx: int) -> np.ndarray:
        m = self._mod_idx(idx)
        return self.masks[m - self.input_dim + 1:
                          m + self.output_dim + 1].astype(bool)

    def raw_times(self, idx: int) -> np.ndarray:
        return np.asarray(raw_time_rows(
            self.times, self._mod_idx(idx), self.input_dim,
            self.input_dim + self.output_dim), dtype=np.float32)

    def station_targets(self, idx: int):
        """(pred_vals, pred_mask, pred_class) for the Korean stations over
        the output window.  The reference inverts the validity flag
        (column 6) before use (``dataset.py:66-69``); ``ByStn`` does
        not."""
        m = self._mod_idx(idx)
        vals = self.feats[m + 1:m + 1 + self.output_dim,
                          :self.korea_stn_num, 0]
        mask = ~self.feats[m + 1:m + 1 + self.output_dim,
                           :self.korea_stn_num, 6].astype(bool)
        cls = assembly.assign_class_masked(vals, mask).astype(np.int32)
        return (np.asarray(vals, dtype=np.float32), mask, cls)

    def prev_station_pm25(self, idx: int) -> np.ndarray:
        m = self._mod_idx(idx)
        return np.asarray(
            self.feats[m - self.prev_len + 1:m + 1, :, 0], dtype=np.float32)


class AirWithFixedSatDataset(_WindowedDataset):
    """Station feats + precomputed satellite in/out tensors
    (``dataset.py:16-96``)."""

    def __init__(self, times, sat_outputs, sat_inputs, feats, masks,
                 input_dim, output_dim, prev_len, korea_stn_num,
                 china_stn_num):
        super().__init__(times, feats, masks, input_dim, output_dim,
                         prev_len, korea_stn_num, china_stn_num)
        self.sat_outputs = np.asarray(sat_outputs, dtype=np.float32)
        self.sat_inputs = np.asarray(sat_inputs, dtype=np.float32)

    def __getitem__(self, idx):
        m = self._mod_idx(idx)
        vals, mask, cls = self.station_targets(idx)
        return (self.load_feats(idx), self.load_masks(idx),
                self.sat_outputs[m], self.sat_inputs[m], cls, vals, mask,
                self.raw_times(idx), self.prev_station_pm25(idx))


class AirWithSimulationDataset(_WindowedDataset):
    """Station feats + in-memory station-sampled CMAQ tensor
    (``dataset.py:98-175``)."""

    def __init__(self, times, feats, masks, simulation, input_dim,
                 output_dim, prev_len, korea_stn_num, china_stn_num):
        super().__init__(times, feats, masks, input_dim, output_dim,
                         prev_len, korea_stn_num, china_stn_num)
        self.simulation = np.asarray(simulation, dtype=np.float32)

    def __getitem__(self, idx):
        m = self._mod_idx(idx)
        vals, mask, cls = self.station_targets(idx)
        return (self.load_feats(idx), self.load_masks(idx),
                self.simulation[m], cls, vals, mask, self.raw_times(idx),
                self.prev_station_pm25(idx))


class AirOnlyDataset(_WindowedDataset):
    """Station feats only (``dataset.py:177-251``)."""

    def __getitem__(self, idx):
        vals, mask, cls = self.station_targets(idx)
        return (self.load_feats(idx), self.load_masks(idx), cls, vals, mask,
                self.raw_times(idx), self.prev_station_pm25(idx))


class AirWithSimulationDatasetV2(_WindowedDataset):
    """Adds a separate ``simulation_pm`` tensor (``dataset.py:253-333``)."""

    def __init__(self, times, feats, masks, simulation, simulation_pm,
                 input_dim, output_dim, prev_len, korea_stn_num,
                 china_stn_num):
        super().__init__(times, feats, masks, input_dim, output_dim,
                         prev_len, korea_stn_num, china_stn_num)
        self.simulation = np.asarray(simulation, dtype=np.float32)
        self.simulation_pm = np.asarray(simulation_pm, dtype=np.float32)

    def __getitem__(self, idx):
        m = self._mod_idx(idx)
        vals, mask, cls = self.station_targets(idx)
        return (self.load_feats(idx), self.load_masks(idx),
                self.simulation[m], self.simulation_pm[m], cls, vals, mask,
                self.raw_times(idx), self.prev_station_pm25(idx))


class AirSimulationReanalysisDataset(_WindowedDataset):
    """In-memory simulation + reanalysis targets (``dataset.py:335-408``)."""

    def __init__(self, times, feats, masks, simulation, reanalysis,
                 input_dim, output_dim, prev_len, korea_stn_num,
                 china_stn_num):
        super().__init__(times, feats, masks, input_dim, output_dim,
                         prev_len, korea_stn_num, china_stn_num)
        self.simulation = np.asarray(simulation, dtype=np.float32)
        self.reanalysis = np.asarray(reanalysis, dtype=np.float32)

    def __getitem__(self, idx):
        m = self._mod_idx(idx)
        re = self.reanalysis[m + 1:m + 1 + self.output_dim]
        cls = assembly.assign_class(re).astype(np.int32)
        return (self.load_feats(idx), self.load_masks(idx),
                self.simulation[m], re, cls, self.raw_times(idx),
                self.prev_station_pm25(idx))


class AirSimulationReanalysisDatasetWithCurr(AirSimulationReanalysisDataset):
    """Also returns reanalysis at t0, the persistence-baseline input
    (``dataset.py:410-486``)."""

    def __getitem__(self, idx):
        m = self._mod_idx(idx)
        re = self.reanalysis[m + 1:m + 1 + self.output_dim]
        cls = assembly.assign_class(re).astype(np.int32)
        return (self.load_feats(idx), self.load_masks(idx),
                self.simulation[m], self.reanalysis[m], re, cls,
                self.raw_times(idx), self.prev_station_pm25(idx))


class _LazyCmaqDataset(_WindowedDataset):
    """On-the-fly CMAQ/NetCDF loading, per sample or a batch at a time."""

    #: class-level switch: None = auto (use the C++ plane when available)
    use_native: Optional[bool] = None

    #: subclasses whose __getitem__ reads _simulation_and_prev (all but
    #: V2) gain from get_batch's union assembly
    _uses_full_sim = True

    #: (sim_position, prev_position) in the sample tuple, for subclasses
    #: that take the fully-collated native batch path
    #: (``get_batch_collated``); None = per-sample assembly + np.stack
    _sim_slots: Optional[Tuple[int, int]] = None

    def __init__(self, times, feats, masks, input_dim, output_dim, prev_len,
                 korea_stn_num, china_stn_num, cmaq_size, sim_data_path,
                 reanalysis_data_path, feat_infos):
        super().__init__(times, feats, masks, input_dim, output_dim,
                         prev_len, korea_stn_num, china_stn_num)
        self.cmaq_size = tuple(cmaq_size)
        self.sim_data_path = sim_data_path
        self.reanalysis_data_path = reanalysis_data_path
        self.feat_infos = feat_infos
        # batch-level sim assembly parks per-index results here for
        # _simulation_and_prev to pop; cleared after every batch
        self._sim_cache = {}

    @property
    def prefers_single_dispatch(self) -> bool:
        """True when __getitem__ runs the internally-threaded native
        assembler: BatchLoader then uses one dispatcher thread instead of a
        Python worker pool, which would contend with the native pool."""
        return self.use_native is not False and native.available()

    @property
    def n_species(self) -> int:
        return self.feats.shape[-1] // 2

    def get_batch_collated(self, indices):
        """Assemble a consecutive batch DIRECTLY into its final batched
        arrays, or return None when the fast path does not apply.  The
        native ``vg_assemble_batch`` pass writes the batched (B, H, W, C)
        layout straight from the files; only the small per-sample fields go
        through ``np.stack``.  Byte-identical to
        ``collate([self[i] for i in indices])``."""
        indices = [int(i) for i in indices]
        consecutive = all(b - a == 1 for a, b in zip(indices, indices[1:]))
        if (self._sim_slots is None or not consecutive or len(indices) < 2
                or self.use_native is False or not native.available()):
            return None
        n_steps = self.prev_len + self.output_dim
        hist = self.prev_len - self.input_dim
        steps = self.times[indices[0]: indices[-1] + n_steps]
        out = native.assemble_batch_native(
            steps, len(indices), hist, n_steps, self.sim_data_path,
            self.feat_infos, self.n_species, self.cmaq_size)
        if out is None:
            return None
        sims, pm25 = out
        sim_pos, prev_pos = self._sim_slots
        prevs = np.stack([pm25[b: b + self.prev_len].mean(axis=1)
                          for b in range(len(indices))])
        # park views so _simulation_and_prev is not re-entered; the
        # per-sample tuples carry them only until the fields swap below
        try:
            for b, idx in enumerate(indices):
                self._sim_cache[idx] = (sims[b], prevs[b])
            samples = [self[i] for i in indices]
        finally:
            self._sim_cache.clear()
        if (samples[0][sim_pos].base is not sims
                or samples[0][prev_pos].base is not prevs):
            raise RuntimeError(f"{type(self).__name__}: bad _sim_slots")
        fields = []
        for j, field in enumerate(zip(*samples)):
            if j == sim_pos:
                fields.append(sims)
            elif j == prev_pos:
                fields.append(prevs)
            else:
                fields.append(np.stack(field, axis=0))
        return tuple(fields)

    def get_batch(self, indices):
        """Assemble a whole batch: for a CONSECUTIVE index run the stacked
        tensors are slices of ONE union assembly over ``B - 1 + n_steps``
        steps; other runs take per-sample assembly.  Byte-identical either
        way."""
        indices = [int(i) for i in indices]
        consecutive = all(b - a == 1 for a, b in zip(indices, indices[1:]))
        if (consecutive and len(indices) > 1 and self._uses_full_sim
                and self.use_native is not False and native.available()):
            self._prime_sim_batch(indices)
        try:
            return [self[i] for i in indices]
        finally:
            self._sim_cache.clear()

    def _prime_sim_batch(self, indices):
        n_steps = self.prev_len + self.output_dim
        steps = self.times[indices[0]: indices[-1] + n_steps]
        out = native.assemble_steps_native(
            steps, self.sim_data_path, self.feat_infos, self.n_species,
            self.cmaq_size)
        if out is None:
            return
        stack, pm25 = out
        bc = 4 * self.n_species + 4
        hist = self.prev_len - self.input_dim
        for b, idx in enumerate(indices):
            # channel-slice VIEWS of the union stack: collate makes the one
            # contiguous copy
            sim = stack[:, :, (b + hist) * bc: (b + n_steps) * bc]
            prev = pm25[b: b + self.prev_len].mean(axis=1)
            self._sim_cache[idx] = (sim, prev)

    def _simulation_and_prev(self, idx):
        if self._sim_cache:
            cached = self._sim_cache.pop(idx, None)
            if cached is not None:
                return cached
        use_native = self.use_native
        if use_native is None or use_native:
            if native.available():
                # one GIL-free native pass over the sample's contiguous
                # [history | input | output] step run
                steps = self.times[idx: idx + self.prev_len
                                   + self.output_dim]
                out = native.assemble_steps_native(
                    steps, self.sim_data_path, self.feat_infos,
                    self.n_species, self.cmaq_size)
                if out is not None:
                    stack, pm25 = out
                    bc = 4 * self.n_species + 4
                    hist = self.prev_len - self.input_dim
                    sim = stack[:, :, hist * bc:]
                    prev_pm25 = pm25[:self.prev_len].mean(axis=1)
                    sim_c = POOL.get(sim.shape, sim.dtype)
                    np.copyto(sim_c, sim)
                    return sim_c, np.ascontiguousarray(prev_pm25)
            elif use_native:
                raise RuntimeError("native data plane requested but "
                                   "libcmaq_loader.so unavailable")
        return assembly.assemble_simulation(
            self.times, self._mod_idx(idx), idx,
            input_dim=self.input_dim, output_dim=self.output_dim,
            prev_len=self.prev_len, sim_data_path=self.sim_data_path,
            feat_infos=self.feat_infos, n_species=self.n_species,
            grid_shape=self.cmaq_size)

    def _reanalysis_window(self, idx):
        return assembly.read_reanalysis_window(
            self.times, self._mod_idx(idx), output_dim=self.output_dim,
            reanalysis_data_path=self.reanalysis_data_path,
            grid_shape=self.cmaq_size)


class AirSimulationReanalysisDatasetV2(_LazyCmaqDataset):
    """Output-window-only on-the-fly loading (``dataset.py:488-674``)."""

    _uses_full_sim = False     # assembles its own output-only window

    def __getitem__(self, idx):
        sim = assembly.assemble_output_only_simulation(
            self.times, self._mod_idx(idx), input_dim=self.input_dim,
            output_dim=self.output_dim, sim_data_path=self.sim_data_path,
            feat_infos=self.feat_infos, n_species=self.n_species,
            grid_shape=self.cmaq_size)
        _, re = self._reanalysis_window(idx)
        cls = assembly.assign_class(re).astype(np.int32)
        return (self.load_feats(idx), self.load_masks(idx), sim, re, cls,
                self.raw_times(idx), self.prev_station_pm25(idx))


class AirSimulationReanalysisDatasetV3(_LazyCmaqDataset):
    """Full train-style sample: station feats/masks + CMAQ stack + current
    and future reanalysis + classes + grid PM history
    (``dataset.py:676-1045``)."""

    _sim_slots = (2, 7)        # (feats, masks, SIM, curr, re, cls, t, PREV)

    def __getitem__(self, idx):
        sim, prev_pm25 = self._simulation_and_prev(idx)
        curr, re = self._reanalysis_window(idx)
        cls = assembly.assign_class(re).astype(np.int32)
        return (self.load_feats(idx), self.load_masks(idx), sim, curr, re,
                cls, self.raw_times(idx), prev_pm25)


class AirSimulationReanalysisDatasetOnly(_LazyCmaqDataset):
    """The shipped eval dataset: v3 without the station tensors in the
    return (``dataset.py:1058-1428``)."""

    _sim_slots = (0, 5)        # (SIM, curr, re, cls, t, PREV)

    def __getitem__(self, idx):
        sim, prev_pm25 = self._simulation_and_prev(idx)
        curr, re = self._reanalysis_window(idx)
        cls = assembly.assign_class(re).astype(np.int32)
        return (sim, curr, re, cls, self.raw_times(idx), prev_pm25)


class AirSimulationReanalysisDatasetWithStationImgs(_LazyCmaqDataset):
    """v3 + kriged ground-observation input images and MultiAir kriged
    prediction images (``dataset.py:1440-1826``).  The image files have no
    zero-fill fallback in the reference: a missing file raises, here too."""

    def __init__(self, times, feats, masks, input_dim, output_dim, prev_len,
                 korea_stn_num, china_stn_num, cmaq_size, sim_data_path,
                 reanalysis_data_path, data_path, feat_infos):
        super().__init__(times, feats, masks, input_dim, output_dim,
                         prev_len, korea_stn_num, china_stn_num, cmaq_size,
                         sim_data_path, reanalysis_data_path, feat_infos)
        self.data_path = data_path

    def _image(self, sub: str, t, suffix: str) -> np.ndarray:
        return np.load(f"{self.data_path}/{sub}/{t.strftime('%Y')}/"
                       f"{int(t.strftime('%m'))}/{t.strftime('%d%H')}"
                       f"{suffix}.npy")

    def _krig_input(self, t) -> np.ndarray:
        # the plain ground-obs image is loaded but unused in the reference
        # (``dataset.py:1591-1595``); only the kriged image is returned
        self._image("ground_obs_imgs", t, "_img")
        return self._image("ground_obs_krig_imgs", t, "_krige_img")

    def _multiair_outputs(self, t) -> np.ndarray:
        self._image("multiair_img", t, "_multiair_img")
        krig = self._image("multiair_krig_img", t, "_multiair_krige_img")
        return np.asarray(krig[:self.output_dim], dtype=np.float32)

    def __getitem__(self, idx):
        m = self._mod_idx(idx)
        sim, prev_pm25 = self._simulation_and_prev(idx)
        curr, re = self._reanalysis_window(idx)
        cls = assembly.assign_class(re).astype(np.int32)
        h, w = self.cmaq_size
        stn_inputs = np.zeros((self.input_dim, 2, h, w), dtype=np.float32)
        for t_idx in range(self.input_dim):
            t = self.times[m - self.input_dim + 1 + t_idx]
            stn_inputs[t_idx] = self._krig_input(t)
        multiair_out = self._multiair_outputs(self.times[m])
        return (sim, curr, re, cls, self.raw_times(idx), prev_pm25,
                stn_inputs, multiair_out)


class AirSimulationReanalysisDatasetByStn(_LazyCmaqDataset):
    """v3 + station-level prediction targets/masks/classes for station-wise
    scoring (``dataset.py:1833-2213``).  NOTE: unlike the other station
    datasets the validity flag is NOT inverted here (``dataset.py:1889``),
    so ``stn_cls`` is -1 at exactly the VALID stations; both quirks are
    the reference's, kept."""

    # (feats, masks, SIM, curr, re, cls, t, PREV, vals, mask, stn_cls)
    _sim_slots = (2, 7)

    def __getitem__(self, idx):
        m = self._mod_idx(idx)
        sim, prev_pm25 = self._simulation_and_prev(idx)
        curr, re = self._reanalysis_window(idx)
        cls = assembly.assign_class(re).astype(np.int32)
        vals = np.asarray(
            self.feats[m + 1:m + 1 + self.output_dim, :self.korea_stn_num, 0],
            dtype=np.float32)
        mask = self.feats[m + 1:m + 1 + self.output_dim,
                          :self.korea_stn_num, 6].astype(bool)
        stn_cls = assembly.assign_class_masked(vals, mask).astype(np.int32)
        return (self.load_feats(idx), self.load_masks(idx), sim, curr, re,
                cls, self.raw_times(idx), prev_pm25, vals, mask, stn_cls)


# the reference's class names
Air_with_fixed_Sat_Dataset = AirWithFixedSatDataset
Air_with_Simulation_Dataset = AirWithSimulationDataset
Air_only_Dataset = AirOnlyDataset
Air_with_Simulation_Dataset_v2 = AirWithSimulationDatasetV2
Air_Simulation_Reanalysis_Dataset = AirSimulationReanalysisDataset
Air_Simulation_Reanalysis_Dataset_w_curr = AirSimulationReanalysisDatasetWithCurr
Air_Simulation_Reanalysis_Dataset_v2 = AirSimulationReanalysisDatasetV2
Air_Simulation_Reanalysis_Dataset_v3 = AirSimulationReanalysisDatasetV3
Air_Simulation_Reanalysis_Dataset_only = AirSimulationReanalysisDatasetOnly
Air_Simulation_Reanalysis_Dataset_with_station_imgs = (
    AirSimulationReanalysisDatasetWithStationImgs)
Air_Simulation_Reanalysis_Dataset_by_stn = AirSimulationReanalysisDatasetByStn
