"""alacnet_tpu_torch — the batched ALAC decode path in PyTorch and CUDA.

A port of ``alacnet_tpu``'s main path (``decode_files`` ->
``decode_streams`` -> ``decode_blob`` -> ``dispatch_frame_batch`` ->
``decode_frames_packed``) to PyTorch, with hand-written CUDA kernels for
Hopper (sm_90a) in place of the JAX package's Pallas kernels
(``pack_rows``, ``rice_lpc``, ``bulk_bits``).  It imports torch and
NumPy, never JAX; its output is bit-identical to the JAX package's.
Decoding runs on ``DecodeConfig.device`` (default ``"cuda"``); pass
``device="cpu"`` to run the kernels' plain torch versions on the CPU.
"""

from .batch import DecodedAudio, decode_file, decode_files, decode_streams
from .config import DecodeConfig
from .errors import (
    AlacError,
    BitstreamError,
    HeaderError,
    MdatPosStatus,
    SampleReadError,
    UnsupportedFormatError,
)

__version__ = "0.1.0"

__all__ = [
    "AlacError",
    "BitstreamError",
    "DecodeConfig",
    "DecodedAudio",
    "HeaderError",
    "MdatPosStatus",
    "SampleReadError",
    "UnsupportedFormatError",
    "decode_file",
    "decode_files",
    "decode_streams",
    "__version__",
]
