"""ALAC magic-cookie (ALACSpecificConfig) parsing and synthesis.

Reference semantics: ``AlacFile.SetInfo``
(/root/reference/ALACDecoder/AlacFile.cs:63-93) consumes the cookie as an
int-per-byte array with a synthetic 12-byte prefix installed by the demuxer
(QTMovieT.cs:487-490), then skips 24 bytes of atom headers before the
24-byte parameter block.  We parse the raw stsd 'alac' extension payload
directly: 12 bytes of inner-atom header (size, 'alac', version/flags)
followed by the parameter block, i.e. the same bytes that land at
CodecData[12..] in the reference, so all reference offsets (29 = bits per
sample, 33 = channels, 44 = sample rate; QTMovieT.cs:508-513) line up with
payload offsets 17, 21 and 32 here.
"""

from __future__ import annotations

import dataclasses
import struct

_PARAMS = struct.Struct(">IBBBBBBHIII")
_PARAM_BLOCK_LEN = _PARAMS.size  # 24
_INNER_HEADER_LEN = 12  # u32 size + 'alac' + u32 version/flags

#: Unary run length cap before escape coding (AlacFile.cs:61).
RICE_THRESHOLD = 8


@dataclasses.dataclass(frozen=True)
class CodecParams:
    """Decoded magic-cookie parameters (AlacFile.cs:38-57).

    Field names follow the ALACSpecificConfig layout; comments carry the
    reference's field labels.
    """

    max_samples_per_frame: int  # setinfo_max_samples_per_frame (typ. 4096)
    compatible_version: int  # setinfo_7a
    sample_size: int  # setinfo_sample_size (bits per sample)
    rice_history_mult: int  # setinfo_rice_historymult
    rice_initial_history: int  # setinfo_rice_initialhistory
    rice_kmodifier: int  # setinfo_rice_kmodifier
    num_channels_cookie: int  # setinfo_7f (channels per the cookie)
    max_run: int  # setinfo_80
    max_frame_bytes: int  # setinfo_82 (max coded frame size)
    avg_bitrate: int  # setinfo_86
    sample_rate: int  # setinfo_8a_rate

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_stsd_payload(cls, payload: bytes) -> "CodecParams":
        """Parse the stsd 'alac' extension payload (inner header + params).

        Accepts either the 36-byte form (12-byte inner atom header +
        24-byte parameter block, the layout the reference demuxer feeds to
        SetInfo) or a bare 24-byte parameter block.
        """
        if len(payload) >= _INNER_HEADER_LEN + _PARAM_BLOCK_LEN:
            block = payload[_INNER_HEADER_LEN : _INNER_HEADER_LEN + _PARAM_BLOCK_LEN]
        elif len(payload) >= _PARAM_BLOCK_LEN:
            block = payload[:_PARAM_BLOCK_LEN]
        else:
            raise ValueError(
                f"ALAC cookie payload too short: {len(payload)} bytes"
            )
        (
            max_samples_per_frame,
            compatible_version,
            sample_size,
            rice_history_mult,
            rice_initial_history,
            rice_kmodifier,
            num_channels,
            max_run,
            max_frame_bytes,
            avg_bitrate,
            sample_rate,
        ) = _PARAMS.unpack(block)
        return cls(
            max_samples_per_frame=max_samples_per_frame,
            compatible_version=compatible_version,
            sample_size=sample_size,
            rice_history_mult=rice_history_mult,
            rice_initial_history=rice_initial_history,
            rice_kmodifier=rice_kmodifier,
            num_channels_cookie=num_channels,
            max_run=max_run,
            max_frame_bytes=max_frame_bytes,
            avg_bitrate=avg_bitrate,
            sample_rate=sample_rate,
        )

    # -- serialization -----------------------------------------------------

    def to_param_block(self) -> bytes:
        """24-byte ALACSpecificConfig parameter block."""
        return _PARAMS.pack(
            self.max_samples_per_frame,
            self.compatible_version,
            self.sample_size,
            self.rice_history_mult,
            self.rice_initial_history,
            self.rice_kmodifier,
            self.num_channels_cookie,
            self.max_run,
            self.max_frame_bytes,
            self.avg_bitrate,
            self.sample_rate,
        )

    def to_stsd_payload(self) -> bytes:
        """Inner 'alac' extension atom as stored inside stsd (36 bytes)."""
        block = self.to_param_block()
        size = _INNER_HEADER_LEN + len(block)
        return struct.pack(">I4sI", size, b"alac", 0) + block

    # -- derived -----------------------------------------------------------

    @property
    def bytes_per_sample(self) -> int:
        """ceil(sample_size / 8) (AlacContext.cs:101)."""
        return (self.sample_size + 7) // 8

    def rice_history_mult_for(self, rice_modifier: int) -> int:
        """Per-channel history multiplier (AlacFile.cs:483,643,653)."""
        return rice_modifier * (self.rice_history_mult // 4)

    @property
    def rice_kmodifier_mask(self) -> int:
        """(1 << kmodifier) - 1 (AlacFile.cs:483)."""
        return (1 << self.rice_kmodifier) - 1


def default_cookie(
    sample_rate: int = 44100,
    sample_size: int = 16,
    num_channels: int = 2,
    max_samples_per_frame: int = 4096,
    max_frame_bytes: int = 0,
    avg_bitrate: int = 0,
) -> CodecParams:
    """Cookie with Apple's standard tuning constants.

    history_mult=0x28, initial_history=0x0a, kmodifier=0x0e match the
    annotated expectations in the reference (AlacFile.cs:43-45).
    """
    if max_frame_bytes == 0:
        # Worst case: escape-coded samples, + headers and slack.
        max_frame_bytes = (
            (sample_size + 8) * num_channels * max_samples_per_frame
        ) // 8 + 256
    return CodecParams(
        max_samples_per_frame=max_samples_per_frame,
        compatible_version=0,
        sample_size=sample_size,
        rice_history_mult=0x28,
        rice_initial_history=0x0A,
        rice_kmodifier=0x0E,
        num_channels_cookie=num_channels,
        max_run=0x00FF,
        max_frame_bytes=max_frame_bytes,
        avg_bitrate=avg_bitrate,
        sample_rate=sample_rate,
    )
