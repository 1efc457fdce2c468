"""Error types and status codes for the alacnet_tpu framework.

Mirrors the failure surface of the reference decoder:
  - ``MdatPosStatus`` <- /root/reference/ALACDecoder/QTMovieT.cs:755-761
  - ctor IOException on bad headers <- /root/reference/ALACDecoder/AlacContext.cs:46-51
  - unsupported-shape throws <- /root/reference/ALACDecoder/AlacFile.cs:574,650,660,715
  - SampleReadException <- /root/reference/ALACDecoder/AlacContext.cs:332-337
"""

from __future__ import annotations

import enum


class MdatPosStatus(enum.IntEnum):
    """Result of the container header parse.

    Reference: QTMovieT.cs:755-761 (None/Ok/NoValidSaveMdatPosition/
    CannotSeekToMdatPosition).
    """

    NONE = 0
    OK = 1
    NO_VALID_SAVED_MDAT_POSITION = 2
    CANNOT_SEEK_TO_MDAT_POSITION = 3


class AlacError(Exception):
    """Base class for all alacnet_tpu errors."""


class HeaderError(AlacError, IOError):
    """Raised when the QuickTime movie headers cannot be parsed.

    The reference raises ``IOException("Error while loading the QuickTime
    movie headers.")`` from the AlacContext constructor
    (AlacContext.cs:46-51); we subclass IOError for drop-in parity.
    """


class SampleReadError(AlacError):
    """A sample's size/duration could not be resolved from the sample tables.

    Reference: AlacContext.SampleReadException (AlacContext.cs:332-337).
    """


class UnsupportedFormatError(AlacError):
    """Stream uses an ALAC feature outside the supported envelope.

    The reference throws for sample sizes other than 16/24
    (AlacFile.cs:570-574,713-715), for stereo frames with
    ``predictionType != 0`` (AlacFile.cs:650,660) and implicitly for
    channel tags other than 0/1 (AlacFile.cs:435-437,577).
    """


class BitstreamError(AlacError):
    """Malformed ALAC frame payload (overlong reads, bad field values)."""
