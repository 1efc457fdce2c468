"""alacnet_tpu_torch — batched ALAC decode and encode in PyTorch and CUDA.

A port of ``alacnet_tpu``'s decode path (``decode_files`` ->
``decode_streams`` -> ``decode_blob`` -> ``dispatch_frame_batch`` ->
``decode_frames_packed``) and its device encode path (``encode_files``
-> ``encode_frames_device`` -> ``encode_stages_pcm``) to PyTorch, with
hand-written CUDA kernels for Hopper (sm_90a) in place of the JAX
package's Pallas kernels (``pack_rows``, ``rice_lpc``, ``bulk_bits``;
``enc_pred``, ``enc_rice``).  It imports torch and NumPy, never JAX;
its output is bit-identical to the JAX package's.  Over ``decode_blob``
it has the JAX package's session and streaming API (``AlacContext``,
``ALACFileReader``), the resumable decode (``DecodeCursor``,
``decode_resumable``) and the CLI (``python -m alacnet_tpu_torch.cli``).
Decoding runs on ``DecodeConfig.device`` and batch encoding on
``encode_files(device=)`` (both default ``"cuda"``, which raises without
a card); pass ``device="cpu"`` to run the kernels' plain torch versions
on the CPU.  ``mesh=`` (``parallel/mesh.py``) spreads the frames of a
decode or an encode over several devices or streams, and
``parallel/distributed.py`` over processes.
"""

from .batch import (
    DecodeCursor,
    DecodedAudio,
    decode_file,
    decode_files,
    decode_resumable,
    decode_streams,
)
from .codec.cookie import CodecParams, default_cookie
from .codec.encoder import AlacEncoder, EncoderConfig, encode_files, encode_m4a
from .codec.encoder_device import encode_frames_device
from .config import DecodeConfig
from .container.demux import StreamInfo, parse
from .context import AlacContext
from .pcm import format_pcm_bytes, read_wav, write_wav
from .reader import ALACFileReader, WaveFormat
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
    "ALACFileReader",
    "AlacContext",
    "AlacEncoder",
    "AlacError",
    "BitstreamError",
    "CodecParams",
    "DecodeConfig",
    "DecodeCursor",
    "DecodedAudio",
    "EncoderConfig",
    "HeaderError",
    "MdatPosStatus",
    "SampleReadError",
    "StreamInfo",
    "UnsupportedFormatError",
    "WaveFormat",
    "decode_file",
    "decode_files",
    "decode_resumable",
    "decode_streams",
    "default_cookie",
    "encode_files",
    "encode_frames_device",
    "encode_m4a",
    "format_pcm_bytes",
    "parse",
    "read_wav",
    "write_wav",
    "__version__",
]
