"""Batched picket fence (MLC positional QA) analysis on the card.

Port of the batched session API of ``pylinac_tpu/picketfence.py``:
``Orientation`` ``:39``, ``MLCArrangement`` ``:46``, ``MLC`` ``:68``,
``PFResult`` ``:80``, ``PicketFenceBatch`` ``:909-1292`` (without its
``mesh`` option) and ``analyze_batch`` ``:1295``. The host loads and orients
the frames and builds the results with numpy, as the JAX class does; the
analysis runs in :func:`pylinac_tpu_torch.ops.picket_pipeline.picket_fence_batch`
on the device given to :meth:`PicketFenceBatch.analyze`.
"""

from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Sequence

import numpy as np
import torch

from .core import image
from .core.utilities import ResultBase, convert_to_enum, resolve_device
from .ops import peaks
from .ops.picket_pipeline import PFLeafConfig, PFParams, picket_fence_batch

LEFT_MLC_PREFIX = "A"
RIGHT_MLC_PREFIX = "B"


class Orientation(enum.Enum):
    """Picket orientations."""

    UP_DOWN = "Up-Down"  #:
    LEFT_RIGHT = "Left-Right"  #:


class MLCArrangement:
    """An MLC leaf arrangement: list of (num_leaves, width_mm) groups."""

    def __init__(self, leaf_arrangement: list[tuple[int, float]], offset: float = 0):
        self.centers: list[float] = []
        self.widths: list[float] = []
        rolling_edge = 0.0
        for leaf_num, width in leaf_arrangement:
            self.centers += np.arange(
                start=rolling_edge + width / 2,
                stop=leaf_num * width + rolling_edge + width / 2,
                step=width).tolist()
            rolling_edge = self.centers[-1] + width / 2
            self.widths += [width] * leaf_num
        mean_c = np.mean(self.centers)
        self.centers = [c - mean_c + offset for c in self.centers]

    @property
    def leaves(self) -> list[int]:
        return np.arange(1, len(self.centers) + 1, dtype=int)[::-1].tolist()


class MLC(enum.Enum):
    """Pre-built MLC models."""

    MILLENNIUM = {"name": "Millennium", "arrangement": MLCArrangement([(10, 10), (40, 5), (10, 10)])}  #:
    HD_MILLENNIUM = {"name": "HD Millennium", "arrangement": MLCArrangement([(14, 5), (32, 2.5), (14, 5)])}  #:
    BMOD = {"name": "B Mod", "arrangement": MLCArrangement([(40, 4)])}  #:
    AGILITY = {"name": "Agility", "arrangement": MLCArrangement([(80, 5)])}  #:
    MLCI = {"name": "MLCi", "arrangement": MLCArrangement([(40, 10)])}  #:
    HALCYON_DISTAL = {"name": "Halcyon distal", "arrangement": MLCArrangement([(28, 10)])}  #:
    HALCYON_PROXIMAL = {"name": "Halcyon proximal", "arrangement": MLCArrangement([(29, 10)])}  #:


def _get_mlc_arrangement(value) -> MLCArrangement:
    """An arrangement from an ``MLC`` member, an arrangement, or a model name
    (``PicketFence._get_mlc_arrangement``, ``picketfence.py:415``)."""
    if isinstance(value, MLC):
        return value.value["arrangement"]
    if isinstance(value, MLCArrangement):
        return value
    if isinstance(value, str):
        return [member.value["arrangement"] for member in MLC
                if member.value["name"] == value][0]
    raise ValueError(f"Invalid MLC arrangement {value}")


@dataclasses.dataclass(kw_only=True)
class PFResult(ResultBase):
    """Typed results of one picket fence image, with the JAX model's fields
    in its order."""

    tolerance_mm: float
    action_tolerance_mm: float | None
    percent_leaves_passing: float
    number_of_pickets: int
    absolute_median_error_mm: float
    max_error_mm: float
    max_error_picket: int
    max_error_leaf: str | int
    mean_picket_spacing_mm: float
    offsets_from_cax_mm: list[float]
    passed: bool
    failed_leaves: list[str] | list[int]
    mlc_skew: float
    picket_widths: dict[str, dict[str, float]]
    mlc_positions_by_leaf: dict[str, list[float]]
    mlc_errors_by_leaf: dict[str, list[float]]
    cax: dict


class PicketFenceBatch:
    """Analyse a batch of same-geometry picket fence images in one batched
    pipeline on the card.

    All images must share shape, dpmm and MLC model; heterogeneous sessions
    should be bucketed by the caller.
    """

    def __init__(self, images: Sequence, mlc: MLC | MLCArrangement | str = MLC.MILLENNIUM,
                 crop_mm: int = 3, filter: int | None = None,
                 image_kwargs: dict | None = None):
        # the host only LOADS pixels (DICOM decode + crop, numpy views);
        # de-spiking, inversion, extra filtering, ground and normalise run in
        # the device pipeline
        self.images: list[image.BaseImage] = []
        for item in images:
            if isinstance(item, image.BaseImage):
                img = item
            else:
                img = image.LinacDicomImage(item, **(image_kwargs or {}))
                crop_px = int(round(crop_mm * img.dpmm))
                if crop_px:
                    img.crop(pixels=crop_px)
            self.images.append(img)
        if not self.images:
            raise ValueError("No images were provided")
        self._extra_filter = filter if isinstance(filter, int) else 0
        self.mlc = _get_mlc_arrangement(mlc)
        self._is_analyzed = False

    @staticmethod
    def _host_inversion_hint(arr: np.ndarray) -> bool:
        """Corner-sample inversion test on the raw array (the pipeline redoes
        it on the card; this one only conditions orientation detection and
        the picket-spacing estimate). The whole-image mean is subsampled."""
        H, W = arr.shape
        rp, cp, b = max(int(0.01 * H), 1), max(int(0.01 * W), 1), 10
        corners = np.stack([
            arr[rp:rp + b, cp:cp + b], arr[rp:rp + b, W - cp - b:W - cp],
            arr[H - rp - b:H - rp, cp:cp + b],
            arr[H - rp - b:H - rp, W - cp - b:W - cp]])
        return bool(corners.mean() > arr[::4, ::4].mean())

    @staticmethod
    def _detect_orientation(arr: np.ndarray) -> Orientation:
        temp = arr.copy()
        med = np.median(temp)
        temp[temp < med] = med
        row_sum = np.sum(temp, 0)
        col_sum = np.sum(temp, 1)
        row80, row90 = np.percentile(row_sum, [85, 99])
        col80, col90 = np.percentile(col_sum, [85, 99])
        return (Orientation.LEFT_RIGHT if (row90 - row80) < (col90 - col80)
                else Orientation.UP_DOWN)

    def _leaf_config(self, H: int, dpmm: float, analysis_ratio: float, device):
        """Leaf row windows in canonical UP-DOWN orientation. Returns
        (config, leaf numbers, tallest window)."""
        pixel_range = H / 2
        pixel_range -= max(self.mlc.widths[0] * analysis_ratio,
                           self.mlc.widths[-1] * analysis_ratio) * dpmm
        leaves, tops, heights, centers, widths = [], [], [], [], []
        for leaf_num, center, width in zip(self.mlc.leaves, self.mlc.centers,
                                           self.mlc.widths):
            if abs(center) >= pixel_range / dpmm:
                continue
            c_px = center * dpmm + H / 2
            w_px = width * dpmm
            top = max(int(c_px - w_px / 2), 0)
            bottom = min(int(c_px + w_px / 2), H)
            leaves.append(leaf_num)
            tops.append(top)
            heights.append(bottom - top)
            centers.append(c_px)
            widths.append(w_px)
        cfg = PFLeafConfig(
            tops=torch.tensor(tops, dtype=torch.long, device=device),
            heights=torch.tensor(heights, dtype=torch.long, device=device),
            centers_px=torch.tensor(centers, dtype=torch.float32, device=device),
            widths_px=torch.tensor(widths, dtype=torch.float32, device=device))
        return cfg, np.asarray(leaves), max(heights)

    def analyze(self, tolerance: float = 0.5, action_tolerance: float | None = None,
                num_pickets: int | None = None, invert: bool = False,
                leaf_analysis_width_ratio: float = 0.4,
                height_threshold: float = 0.5, edge_threshold: float = 1.5,
                peak_sort: str = "peak_heights", required_prominence: float = 0.2,
                fwxm: int = 50, separate_leaves: bool = False,
                nominal_gap_mm: float = 3,
                orientation: Orientation | str | None = None,
                w_max: int | None = None, chunk: int = 32,
                device: str | torch.device | None = None) -> None:
        """Analyse the batch on ``device`` (``None`` means ``"cuda"``, and
        raises when no CUDA device exists). Arguments as
        ``pylinac_tpu.picketfence.PicketFenceBatch.analyze``."""
        device = resolve_device(device, "PicketFenceBatch.analyze")
        if action_tolerance is not None and tolerance < action_tolerance:
            raise ValueError("Tolerance cannot be lower than the action tolerance")
        self.tolerance = tolerance
        self.action_tolerance = action_tolerance
        self.separate_leaves = separate_leaves

        # orientation is a pure function of the loaded pixels, which stay
        # fixed for the batch's lifetime: repeat analyses reuse it
        okey = (orientation, bool(invert), len(self.images))
        ocached = getattr(self, "_orient_cache", None)
        if ocached is not None and ocached[0] == okey:
            self._orientations = ocached[1]
        else:
            self._orientations = []
            for img in self.images:
                raw = np.asarray(img.array)
                if orientation:
                    orient = convert_to_enum(orientation, Orientation)
                else:
                    # a coarse binary decision: detect on a 4x-subsampled,
                    # inversion-conditioned copy
                    sub = raw[::4, ::4]
                    if self._host_inversion_hint(raw) ^ invert:
                        sub = sub.max() + sub.min() - sub.astype(np.float32)
                    orient = self._detect_orientation(sub)
                self._orientations.append(orient)
            self._orient_cache = (okey, self._orientations)
        arrays = [np.asarray(img.array) if orient == Orientation.UP_DOWN
                  else np.asarray(img.array).T
                  for img, orient in zip(self.images, self._orientations)]
        shapes = {a.shape for a in arrays}
        if len(shapes) != 1:
            raise ValueError(
                f"All images in a batch must share one canonical shape; got {shapes}")
        dpmms = {round(float(img.dpmm), 6) for img in self.images}
        if len(dpmms) != 1:
            raise ValueError(f"All images in a batch must share dpmm; got {dpmms}")
        dpmm = self.images[0].dpmm
        H, W = arrays[0].shape

        cfg, self._leaf_nums, h_max = self._leaf_config(
            H, dpmm, leaf_analysis_width_ratio, device)
        H_MAX = -(-h_max // 8) * 8
        if w_max is None:
            wkey = (bool(invert), height_threshold, required_prominence, W)
            wcached = getattr(self, "_wmax_cache", None)
            if wcached is not None and wcached[0] == wkey:
                w_max = wcached[1]
            else:
                # picket spacing from the first image's host-conditioned mean
                # profile (inversion hint + ground)
                a0 = arrays[0].astype(np.float32)
                if self._host_inversion_hint(arrays[0]) ^ invert:
                    a0 = a0.max() + a0.min() - a0
                prof = a0.mean(axis=0)
                prof -= prof.min()
                idxs, _ = peaks.find_peaks(
                    prof / prof.max(), threshold=height_threshold,
                    peak_separation=0.02, required_prominence=required_prominence)
                spacing_est = (float(np.median(np.diff(np.sort(idxs))))
                               if len(idxs) > 1 else W)
                w_max = int(min(-(-int(spacing_est + 2) // 64) * 64, W))
                self._wmax_cache = (wkey, w_max)
        # stage the RAW batch in its stored dtype (uint16 frames widen on the
        # card); the loaded pixels stay fixed for the batch's lifetime, so
        # the device copy is reused by repeat analyses
        stage_key = (tuple(self._orientations), len(arrays), str(device))
        staged = getattr(self, "_stage_cache", None)
        if staged is None or staged[0] != stage_key:
            stacked = np.stack(arrays)
            if stacked.dtype.kind == "f" and stacked.dtype.itemsize > 4:
                stacked = stacked.astype(np.float32)
            staged = (stage_key, torch.from_numpy(stacked).to(device))
            self._stage_cache = staged
        batch = staged[1]

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        params = PFParams(
            height_threshold=f32(height_threshold),
            edge_threshold=f32(edge_threshold),
            required_prominence=f32(required_prominence),
            fwxm=f32(fwxm),
            dpmm=f32(dpmm),
            cax_col=f32(W / 2 - 0.5),
            analysis_ratio=f32(leaf_analysis_width_ratio),
            nominal_gap_px=f32(nominal_gap_mm / 2 * dpmm),
            invert=bool(invert))
        out = picket_fence_batch(
            batch, cfg, params, K_P=16, W_MAX=w_max, H_MAX=H_MAX,
            num_pickets=num_pickets, peak_sort=peak_sort,
            separate_leaves=separate_leaves, chunk=min(chunk, len(arrays)),
            extra_filter=self._extra_filter)
        self._out = {k: v.cpu().numpy() for k, v in out.items()}
        if not self._out["kiss_valid"].any():
            raise ValueError(
                "No MLC measurements were found in the batch. This may be due to "
                "an incorrect inversion (try invert=True) or orientation.")
        self._dpmm = float(dpmm)
        self._is_analyzed = True

    # -- result construction -------------------------------------------------
    def results_data(self, as_dict: bool = False, as_json: bool = False):
        """Per-image :class:`PFResult` list built from the fetched arrays."""
        if not self._is_analyzed:
            raise ValueError("The batch has not been analyzed. Use .analyze() first.")
        results = [self._image_result(i) for i in range(len(self.images))]
        if as_dict:
            return [r.model_dump() for r in results]
        if as_json:
            return [r.model_dump_json() for r in results]
        return results

    def _image_result(self, i: int) -> PFResult:
        o = self._out
        valid = o["kiss_valid"][i]                      # (L, K_P)
        picket_valid = o["picket_valid"][i]             # (K_P,)
        if not picket_valid.any():
            raise ValueError(
                f"No pickets were found in image {i}. Try passing the correct "
                "orientation or invert=True.")
        errors = o["errors_mm"][i]                      # (L, K_P, n)
        pos_px = o["positions_px"][i]
        widths_mm = o["width_px"][i] / self._dpmm
        dist2cax = o["dist2cax_mm"][i]
        fits = o["fits"][i]
        picket_slots = np.nonzero(picket_valid)[0]      # found order = index order
        n_lines = errors.shape[-1]

        line_valid = np.repeat(valid[..., None], n_lines, axis=-1)
        abs_err = np.abs(errors)
        flat_err = abs_err[line_valid]
        passed_lines = abs_err[line_valid] < self.tolerance
        percent_passing = float(100 * passed_lines.sum() / passed_lines.size)
        max_error = float(flat_err.max())
        l_i, p_i, s_i = np.unravel_index(
            np.argmax(np.where(line_valid, abs_err, -1.0)), abs_err.shape)
        max_error_picket = int(np.searchsorted(picket_slots, p_i))
        leaf_num = int(self._leaf_nums[l_i])
        if self.separate_leaves:
            max_error_leaf = f"{(LEFT_MLC_PREFIX, RIGHT_MLC_PREFIX)[s_i]}{leaf_num}"
        else:
            max_error_leaf = leaf_num

        offsets = [float(dist2cax[p]) for p in picket_slots]
        sorted_off = np.sort(offsets)
        mean_spacing = (float(np.mean(np.abs(np.diff(sorted_off))))
                        if len(offsets) > 1 else 0.0)
        skew = float(np.mean([np.rad2deg(fits[p, 0]) for p in picket_slots]))

        # per-picket width stats over the valid kisses
        w_masked = np.where(valid, widths_mm, np.nan)[:, picket_slots]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slots
            w_max = np.nanmax(w_masked, axis=0)
            w_mean = np.nanmean(w_masked, axis=0)
            w_min = np.nanmin(w_masked, axis=0)
        # np.sort puts NaNs last, so the median of the valid entries is the
        # mean of the two middle order statistics
        w_sorted = np.sort(w_masked, axis=0)
        cnt = valid[:, picket_slots].sum(axis=0)
        safe = np.maximum(cnt, 1)
        cols = np.arange(w_sorted.shape[1])
        w_med = (w_sorted[(safe - 1) // 2, cols] + w_sorted[safe // 2, cols]) / 2
        picket_widths = {
            f"picket_{rank}": {"max": float(w_max[rank]), "mean": float(w_mean[rank]),
                               "median": float(w_med[rank]), "min": float(w_min[rank])}
            for rank in range(len(picket_slots))}

        cax_physical = (self.images[i].shape[1 if self._orientations[i] == Orientation.UP_DOWN else 0] / 2 - 0.5) / self._dpmm
        pos_mm = cax_physical - pos_px[:, picket_slots, :] / self._dpmm  # (L,P,S)
        err_sel = errors[:, picket_slots, :]
        vsel = valid[:, picket_slots]                                    # (L,P)
        leaf_any = vsel.any(axis=1)
        fail_ls = ((np.abs(err_sel) >= self.tolerance)
                   & vsel[:, :, None]).any(axis=1)                       # (L,S)
        positions_by_leaf: dict[str, list[float]] = {}
        errors_by_leaf: dict[str, list[float]] = {}
        failed: list = []
        for li in np.nonzero(leaf_any)[0]:
            leaf = self._leaf_nums[li]
            names = ([f"{LEFT_MLC_PREFIX}{leaf}", f"{RIGHT_MLC_PREFIX}{leaf}"]
                     if self.separate_leaves else [int(leaf)])
            sel = vsel[li]
            for s, name in enumerate(names):
                positions_by_leaf[str(name)] = pos_mm[li, sel, s].tolist()
                errors_by_leaf[str(name)] = err_sel[li, sel, s].astype(
                    np.float64).tolist()
                if fail_ls[li, s]:
                    failed.append(name)

        return PFResult(
            tolerance_mm=self.tolerance,
            action_tolerance_mm=self.action_tolerance,
            percent_leaves_passing=percent_passing,
            number_of_pickets=len(picket_slots),
            absolute_median_error_mm=float(np.median(flat_err)),
            max_error_mm=max_error,
            max_error_picket=max_error_picket,
            max_error_leaf=max_error_leaf,
            mean_picket_spacing_mm=mean_spacing,
            offsets_from_cax_mm=offsets,
            passed=bool(max_error < self.tolerance),
            failed_leaves=failed,
            mlc_skew=skew,
            picket_widths=picket_widths,
            mlc_positions_by_leaf=dict(sorted(positions_by_leaf.items())),
            mlc_errors_by_leaf=dict(sorted(errors_by_leaf.items())),
            cax=self.images[i].center.dict(),
        )


def analyze_batch(images: Sequence, mlc: MLC | MLCArrangement | str = MLC.MILLENNIUM,
                  **analyze_kwargs) -> list[PFResult]:
    """Load, analyse and return per-image :class:`PFResult` in one call."""
    init_keys = ("crop_mm", "filter", "image_kwargs")
    init_kwargs = {k: analyze_kwargs.pop(k) for k in init_keys if k in analyze_kwargs}
    batch = PicketFenceBatch(images, mlc=mlc, **init_kwargs)
    batch.analyze(**analyze_kwargs)
    return batch.results_data()
