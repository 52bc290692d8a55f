"""CT-RATE datasets: reports CSV + metadata CSV (+ labels CSV) + NIfTI
folders.

Copy of ct_clip_tpu/data/datasets.py: `CTReportDataset`, the training split
(reference scripts/data.py:36-174, the first `percent`% of the samples, HU
clipped after the resample), and its subclass `CTReportDatasetInfer`
(scripts/data_inference_nii.py:38-176: every sample with labels, HU clipped
before the resample).  The host only reads and decodes; the voxel math runs
on the device (ops/resample.py).  The text kept is Findings_EN with quotes
and parentheses stripped (data.py:73-83, 165-173).
"""
from __future__ import annotations

import csv
import glob
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import PATHOLOGIES
from .nifti import read_volume


def _clean_text(text: str) -> str:
    for ch in ('"', "'", "(", ")"):
        text = text.replace(ch, "")
    return text


def _read_csv(path: str | Path) -> List[Dict[str, str]]:
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


def parse_xy_spacing(raw: str) -> float:
    """Reference parse: row['XYSpacing'][1:][:-2].split(',')[0]
    (data.py:102) — e.g. "[0.75, 0.75]" -> 0.75."""
    return float(raw[1:][:-2].split(",")[0])


@dataclass
class VolumeMeta:
    path: str
    text: str
    slope: float
    intercept: float
    spacing_zxy: Tuple[float, float, float]
    labels: Optional[np.ndarray] = None  # (18,) one-hot, when a labels CSV is given

    @property
    def accession(self) -> str:
        return os.path.basename(self.path).replace(".nii.gz", "").replace(".nii", "")


def _labels(path: str | Path) -> Dict[str, np.ndarray]:
    return {r["VolumeName"]: np.asarray([float(r.get(p, 0) or 0) for p in PATHOLOGIES],
                                        np.float32)
            for r in _read_csv(path)}


class CTReportDataset:
    """Training dataset: walks data_folder/patient/accession/*.nii.gz, joins
    the reports and metadata CSVs (and a labels CSV when given), keeps the
    first `percent`% of the samples (the reference keeps 80%, data.py:43-46).
    HU are clipped after the resample (data.py:122)."""

    clip_before_resample = False

    def __init__(self, data_folder: str, reports_file: str, meta_file: str,
                 percent: int = 80, labels_file: Optional[str] = None):
        reports = {r["VolumeName"]: r.get("Findings_EN", "")
                   for r in _read_csv(reports_file)}
        meta = {r["VolumeName"]: r for r in _read_csv(meta_file)}
        onehot = _labels(labels_file) if labels_file is not None else {}

        self.samples: List[VolumeMeta] = []
        pattern = os.path.join(data_folder, "*", "*", "*.nii.gz")
        for nii_file in sorted(glob.glob(pattern)):
            name = os.path.basename(nii_file)
            if name not in reports or name not in meta:
                continue
            row = meta[name]
            try:
                xy = parse_xy_spacing(row["XYSpacing"])
                z = float(row["ZSpacing"])
                slope = float(row["RescaleSlope"])
                intercept = float(row["RescaleIntercept"])
            except (KeyError, ValueError):
                continue
            self.samples.append(VolumeMeta(
                path=nii_file, text=_clean_text(str(reports[name])),
                slope=slope, intercept=intercept, spacing_zxy=(z, xy, xy),
                labels=onehot.get(name)))
        if percent < 100:
            self.samples = self.samples[: int(len(self.samples) * percent / 100)]

    def __len__(self) -> int:
        return len(self.samples)

    def read_raw(self, index: int) -> Tuple[np.ndarray, VolumeMeta]:
        """((Z, Y, X) voxels, meta).  NIfTI data is (X, Y, Z) in Fortran
        order, so (Z, Y, X) is its C-order view; the device transposes the
        in-plane axes.  The stored ints come back as int16 (no copy when they
        are int16): the CSV slope and intercept are applied on the device.  A
        header that carries its own scaling gets it applied here, in f32."""
        meta = self.samples[index]
        vol, hdr = read_volume(meta.path, apply_scaling=False, dtype=np.int16,
                               layout="zyx")
        if hdr.scl_slope not in (0.0, 1.0) or hdr.scl_inter != 0.0:
            vol, _ = read_volume(meta.path, layout="zyx")
        return vol, meta


class CTReportDatasetInfer(CTReportDataset):
    """Validation / inference dataset: every sample that has labels; HU
    clipped before the resample (data_inference_nii.py:115-117)."""

    clip_before_resample = True

    def __init__(self, data_folder: str, reports_file: str, meta_file: str,
                 labels: str):
        super().__init__(data_folder, reports_file, meta_file, percent=100,
                         labels_file=labels)
        self.samples = [s for s in self.samples if s.labels is not None]
