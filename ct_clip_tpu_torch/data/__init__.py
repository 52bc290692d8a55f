from .datasets import CTReportDatasetInfer, VolumeMeta
from .loader import RawSample, VolumeLoader
from .nifti import read_volume, write_volume
from .tokenizer import WordPieceTokenizer

__all__ = ["CTReportDatasetInfer", "RawSample", "VolumeLoader", "VolumeMeta",
           "WordPieceTokenizer", "read_volume", "write_volume"]
