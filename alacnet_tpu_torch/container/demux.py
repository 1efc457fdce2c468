"""MP4/QuickTime container demuxer for `.m4a` ALAC files.

Host-side replacement for the reference's ``QtMovieT`` atom walker
(/root/reference/ALACDecoder/QTMovieT.cs:51-751): walks
``ftyp/moov/trak/mdia/minf/stbl/{stsd,stts,stsz,stsc,stco}``, extracts the
ALAC magic cookie from stsd, fills a :class:`StreamInfo` (the immutable
analog of ``DemuxResT``), and resolves the ``mdat`` payload position —
including the mdat-before-moov case handled via a saved position + seek
back (QTMovieT.cs:78-93,724-751).

Deliberate deviations from the reference (all strictly more permissive or
strictly better-defined; each is flagged inline):
  * table arrays are NumPy (vectorized downstream math, tables.py);
  * stts is not capped at 16 entries (DemuxResT.cs:27 fixed array would
    throw on entry 17);
  * atom sizes are validated as unsigned.
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO

import numpy as np

from ..codec.cookie import CodecParams, channel_layout
from ..errors import HeaderError, MdatPosStatus
from .bytestream import ByteCursor, fourcc
from .tables import SampleTables

_FTYP = fourcc("ftyp")
_MOOV = fourcc("moov")
_MDAT = fourcc("mdat")
_FREE = fourcc("free")
_JUNK = fourcc("junk")
_M4A = fourcc("M4A ")
_MVHD = fourcc("mvhd")
_TRAK = fourcc("trak")
_UDTA = fourcc("udta")
_ELST = fourcc("elst")
_IODS = fourcc("iods")
_TKHD = fourcc("tkhd")
_MDIA = fourcc("mdia")
_EDTS = fourcc("edts")
_MDHD = fourcc("mdhd")
_HDLR = fourcc("hdlr")
_MINF = fourcc("minf")
_SMHD = fourcc("smhd")
_DINF = fourcc("dinf")
_STBL = fourcc("stbl")
_STSD = fourcc("stsd")
_STTS = fourcc("stts")
_STSZ = fourcc("stsz")
_STSC = fourcc("stsc")
_STCO = fourcc("stco")
_ALAC = fourcc("alac")


@dataclasses.dataclass(frozen=True)
class StreamInfo:
    """Demux result: everything needed to decode without re-parsing.

    Immutable analog of ``DemuxResT`` (DemuxResT.cs:16-35) plus the decoded
    cookie and the resolved mdat payload offset (the reference instead
    leaves the stream cursor parked there, AlacContext.cs:43-44).
    """

    format: int  # fourcc from stsd ('alac')
    num_channels: int  # from cookie byte 33 (QTMovieT.cs:511)
    sample_size: int  # bits per sample, cookie byte 29 (QTMovieT.cs:509)
    sample_rate: int  # cookie bytes 44-47 (QTMovieT.cs:512-513)
    codec_data: bytes  # raw stsd 'alac' extension payload
    params: CodecParams  # parsed cookie (AlacFile.SetInfo equivalent)
    tables: SampleTables
    mdat_offset: int  # absolute file offset of the mdat payload
    mdat_len: int  # payload length (QTMovieT.cs:728)
    status: MdatPosStatus

    # Defaulted getters, parity with AlacContext.cs:83-101.
    def sample_rate_or_default(self) -> int:
        return self.sample_rate if self.sample_rate != 0 else 44100

    def num_channels_or_default(self) -> int:
        return self.num_channels if self.num_channels != 0 else 2

    def bits_per_sample_or_default(self) -> int:
        return self.sample_size if self.sample_size != 0 else 16

    def bytes_per_sample_or_default(self) -> int:
        return -(-self.sample_size // 8) if self.sample_size != 0 else 2


class _Parser:
    """One-shot atom-tree walk; mirrors QtMovieT's control flow."""

    def __init__(self, cursor: ByteCursor):
        self.s = cursor
        self.format = 0
        self.num_channels = 0
        self.sample_size = 0
        self.sample_rate = 0
        self.codec_data = b""
        self.frame_byte_sizes = np.zeros(0, dtype=np.int64)
        self.stts: list[tuple[int, int]] = []
        self.stsc: list[tuple[int, int, int]] = []
        self.stco = np.zeros(0, dtype=np.int64)
        self.mdat_len = 0
        self.mdat_offset = -1
        self._saved_mdat_pos = -1

    # -- top level (QTMovieT.cs:51-108) -----------------------------------

    def read_header(self) -> MdatPosStatus:
        found_moov = False
        found_mdat = False
        while True:
            chunk_len = self.s.read_u32()
            if self.s.eof:
                return MdatPosStatus.NONE
            chunk_id = self.s.read_u32()
            if chunk_id == _FTYP:
                self._read_ftyp(chunk_len)
            elif chunk_id == _MOOV:
                if not self._read_moov(chunk_len):
                    return MdatPosStatus.NONE
                if found_mdat:
                    return self._set_saved_mdat()
                found_moov = True
            elif chunk_id == _MDAT:
                self._read_mdat(chunk_len, skip_payload=not found_moov)
                if found_moov:
                    return MdatPosStatus.OK
                found_mdat = True
            elif chunk_id in (_FREE, _JUNK):
                self.s.skip(chunk_len - 8)
            else:
                # Unknown top-level atom: reference aborts (QTMovieT.cs:103-106).
                return MdatPosStatus.NONE

    def _read_ftyp(self, chunk_len: int) -> None:
        """QTMovieT.cs:111-132 — brand check, then skip compat brands."""
        size_remaining = chunk_len - 8
        brand = self.s.read_u32()
        size_remaining -= 4
        if brand != _M4A:
            # Reference logs and *returns*, leaving the compat brands
            # unconsumed — which then desyncs the top-level walk into the
            # unknown-atom abort. We abort explicitly with the same outcome.
            raise HeaderError("not an M4A file (ftyp major brand)")
        self.s.read_u32()  # minor version
        size_remaining -= 4
        while size_remaining > 0:
            if self.s.eof:
                # A lying ftyp size (fuzz: first atom size 2^31) would
                # otherwise spin this walk for ~size/4 zero-extended
                # reads; the reference loops the same way but its EOF
                # reads return stale garbage until the count runs out.
                raise HeaderError("truncated ftyp atom")
            self.s.read_u32()  # compatible brand, unused
            size_remaining -= 4

    # -- moov/trak/mdia (QTMovieT.cs:135-177,333-375,668-722) --------------

    def _read_moov(self, chunk_len: int) -> bool:
        size_remaining = chunk_len - 8
        while size_remaining != 0:
            sub_len = self.s.read_u32()
            if sub_len <= 1 or sub_len > size_remaining:
                return False
            sub_id = self.s.read_u32()
            if sub_id == _MVHD or sub_id in (_UDTA, _ELST, _IODS):
                self.s.skip(sub_len - 8)
            elif sub_id == _TRAK:
                if not self._read_trak(sub_len):
                    return False
            elif sub_id == _FREE:
                self.s.skip(sub_len - 8)
            else:
                return False
            size_remaining -= sub_len
        return True

    def _read_trak(self, chunk_len: int) -> bool:
        size_remaining = chunk_len - 8
        while size_remaining != 0:
            sub_len = self.s.read_u32()
            if sub_len <= 1 or sub_len > size_remaining:
                return False
            sub_id = self.s.read_u32()
            if sub_id in (_TKHD, _EDTS):
                self.s.skip(sub_len - 8)
            elif sub_id == _MDIA:
                if not self._read_media(sub_len):
                    return False
            else:
                return False
            size_remaining -= sub_len
        return True

    def _read_media(self, chunk_len: int) -> bool:
        size_remaining = chunk_len - 8
        while size_remaining != 0:
            sub_len = self.s.read_u32()
            if sub_len <= 1 or sub_len > size_remaining:
                return False
            sub_id = self.s.read_u32()
            if sub_id == _MDHD:
                self.s.skip(sub_len - 8)
            elif sub_id == _HDLR:
                self._read_hdlr(sub_len)
            elif sub_id == _MINF:
                if not self._read_media_info(sub_len):
                    return False
            else:
                return False
            size_remaining -= sub_len
        return True

    def _read_hdlr(self, chunk_len: int) -> None:
        """QTMovieT.cs:377-410 — consume and discard."""
        size_remaining = chunk_len - 8
        self.s.skip(4)  # version + flags
        size_remaining -= 4
        self.s.read_u32()  # component type
        self.s.read_u32()  # component subtype
        size_remaining -= 8
        self.s.read_u32()  # manufacturer
        size_remaining -= 4
        self.s.skip(8)  # flags
        size_remaining -= 8
        self.s.read_u8()  # name length
        size_remaining -= 1
        self.s.skip(size_remaining)

    def _read_media_info(self, chunk_len: int) -> bool:
        """QTMovieT.cs:258-331 — requires smhd(16) then dinf then stbl."""
        size_remaining = chunk_len - 8
        media_info_size = self.s.read_u32()
        if media_info_size != 16:
            return False
        if self.s.read_u32() != _SMHD:
            return False
        self.s.skip(16 - 8)
        size_remaining -= 16
        dinf_size = self.s.read_u32()
        if self.s.read_u32() != _DINF:
            return False
        self.s.skip(dinf_size - 8)
        size_remaining -= dinf_size
        stbl_size = self.s.read_u32()
        if self.s.read_u32() != _STBL:
            return False
        if not self._read_stbl(stbl_size):
            return False
        size_remaining -= stbl_size
        if size_remaining != 0:
            self.s.skip(size_remaining)
        return True

    # -- stbl and leaves (QTMovieT.cs:179-256,412-613) ----------------------

    def _read_stbl(self, chunk_len: int) -> bool:
        size_remaining = chunk_len - 8
        while size_remaining != 0:
            sub_len = self.s.read_u32()
            if sub_len <= 1 or sub_len > size_remaining:
                return False
            sub_id = self.s.read_u32()
            if sub_id == _STSD:
                if not self._read_stsd():
                    return False
            elif sub_id == _STTS:
                self._read_stts(sub_len)
            elif sub_id == _STSZ:
                self._read_stsz(sub_len)
            elif sub_id == _STSC:
                self._read_stsc(sub_len)
            elif sub_id == _STCO:
                self._read_stco()
            else:
                return False
            size_remaining -= sub_len
        return True

    def _read_stsd(self) -> bool:
        """QTMovieT.cs:412-523 — sound description + cookie extraction."""
        self.s.skip(4)  # version + flags
        numentries = self.s.read_u32()
        if numentries != 1:
            return False
        entry_size = self.s.read_u32()
        self.format = self.s.read_u32()
        entry_remaining = entry_size - 8
        if self.format != _ALAC:
            return False
        self.s.skip(6)  # reserved
        entry_remaining -= 6
        self.s.read_u16()  # version (1 expected; reference only warns)
        entry_remaining -= 2
        self.s.read_u16()  # revision level
        self.s.read_u32()  # vendor
        entry_remaining -= 6
        self.s.read_u16()  # undocumented extra 16 bits (QTMovieT.cs:460-462)
        entry_remaining -= 2
        self.s.skip(4)  # top-level channels + bits per sample
        entry_remaining -= 4
        self.s.read_u16()  # compression id
        self.s.read_u16()  # packet size
        entry_remaining -= 4
        self.s.skip(4)  # top-level sample rate
        entry_remaining -= 4
        # Remainder is the 'alac' extension payload the reference copies to
        # CodecData[12..] (QTMovieT.cs:476-490).
        self.codec_data = self.s.read_exact(entry_remaining)
        # Metadata extracted at the reference's CodecData offsets 29/33/44,
        # i.e. payload offsets 17/21/32 (QTMovieT.cs:508-513).
        if len(self.codec_data) < 36:
            return False
        self.sample_size = self.codec_data[17]
        self.num_channels = self.codec_data[21]
        self.sample_rate = int.from_bytes(self.codec_data[32:36], "big")
        return True

    def _read_stts(self, chunk_len: int) -> None:
        """QTMovieT.cs:525-559."""
        size_remaining = chunk_len - 8
        self.s.skip(4)  # version + flags
        size_remaining -= 4
        numentries = self.s.read_u32()
        size_remaining -= 4
        # Bound by BOTH the atom's claimed body and the physical bytes
        # left in the stream: a lying atom-size *chain* (stbl and stts
        # sizes inflated together) passes the claimed-size check alone
        # and still drives a multi-minute zero-extended-EOF loop.  The
        # reference would overrun its fixed 16-entry array instead
        # (DemuxResT.cs:27) — we reject.
        body = min(size_remaining, self.s.length - self.s.stream_position)
        if numentries * 8 > max(0, body):
            raise HeaderError("stts entry count exceeds atom/stream size")
        for _ in range(numentries):
            count = self.s.read_u32()
            duration = self.s.read_u32()
            self.stts.append((count, duration))
            size_remaining -= 8
        if size_remaining != 0:
            self.s.skip(size_remaining)

    def _read_stsz(self, chunk_len: int) -> None:
        """QTMovieT.cs:561-613 — handles the uniform-size fast path."""
        size_remaining = chunk_len - 8
        self.s.skip(4)  # version + flags
        size_remaining -= 4
        uniform_size = self.s.read_u32()
        if uniform_size != 0:
            uniform_num = self.s.read_u32()
            # A lying uniform count must not drive a multi-GB table
            # allocation from a few header bytes: the claimed total
            # coded bytes can't exceed the physical stream (frames live
            # in mdat, which lives in this file), and the count itself
            # is capped at ~270M frames (= weeks of audio).
            if uniform_num > 1 << 28 or (
                uniform_num * max(1, uniform_size) > self.s.length
            ):
                raise HeaderError("implausible stsz uniform sample count")
            self.frame_byte_sizes = np.full(
                uniform_num, uniform_size, dtype=np.int64
            )
            return
        size_remaining -= 4
        numentries = self.s.read_u32()
        size_remaining -= 4
        raw = self.s.read_exact(4 * numentries)
        self.frame_byte_sizes = np.frombuffer(raw, dtype=">u4").astype(np.int64)
        size_remaining -= 4 * numentries
        if size_remaining != 0:
            self.s.skip(size_remaining)

    def _read_stsc(self, chunk_len: int) -> None:
        """QTMovieT.cs:245-256."""
        self.s.skip(4)
        numentries = self.s.read_u32()
        # Claimed atom body AND physical stream bytes (see _read_stts).
        body = min(
            chunk_len - 16, self.s.length - self.s.stream_position
        )
        if numentries * 12 > max(0, body):
            raise HeaderError("stsc entry count exceeds atom/stream size")
        for _ in range(numentries):
            first_chunk = self.s.read_u32()
            samples_per_chunk = self.s.read_u32()
            desc_index = self.s.read_u32()
            self.stsc.append((first_chunk, samples_per_chunk, desc_index))

    def _read_stco(self) -> None:
        """QTMovieT.cs:232-242."""
        self.s.skip(4)
        numentries = self.s.read_u32()
        raw = self.s.read_exact(4 * numentries)
        self.stco = np.frombuffer(raw, dtype=">u4").astype(np.int64)

    # -- mdat (QTMovieT.cs:724-751) -----------------------------------------

    def _read_mdat(self, chunk_len: int, skip_payload: bool) -> None:
        size_remaining = chunk_len - 8
        if size_remaining == 0:
            return
        self.mdat_len = size_remaining
        self.mdat_offset = self.s.stream_position
        if skip_payload:
            self._saved_mdat_pos = self.s.stream_position
            self.s.skip(size_remaining)

    def _set_saved_mdat(self) -> MdatPosStatus:
        if self._saved_mdat_pos == -1:
            return MdatPosStatus.NO_VALID_SAVED_MDAT_POSITION
        if self.s.seek(self._saved_mdat_pos) != self._saved_mdat_pos:
            return MdatPosStatus.CANNOT_SEEK_TO_MDAT_POSITION
        return MdatPosStatus.OK


def parse(stream: BinaryIO) -> StreamInfo:
    """Parse an .m4a container and return a :class:`StreamInfo`.

    Raises :class:`HeaderError` on failure, matching the reference's
    constructor contract (AlacContext.cs:46-51: status None or
    CannotSeekToMdatPosition -> IOException).
    """
    cursor = ByteCursor(stream)
    parser = _Parser(cursor)
    try:
        status = parser.read_header()
    except (EOFError, HeaderError, ValueError, OSError) as exc:
        # ValueError/OSError: malformed atom sizes can drive the walk
        # into backwards skips or absurd seeks (the reference surfaces
        # these as raw ApplicationException/IOException from MyStream,
        # QTMovieT passing garbage lengths down — we normalize every
        # parse-time failure to the constructor contract).
        raise HeaderError(
            f"Error while loading the QuickTime movie headers. ({exc})"
        ) from exc
    if status in (
        MdatPosStatus.NONE,
        MdatPosStatus.CANNOT_SEEK_TO_MDAT_POSITION,
    ):
        raise HeaderError("Error while loading the QuickTime movie headers.")
    if parser.mdat_len > 0 and parser.frame_byte_sizes.size:
        # A single coded frame cannot exceed the whole mdat payload: a
        # corrupt stsz entry would otherwise size device buffers (and
        # XLA executables) from a lying u32 — a ~100 s compile per
        # malformed file.  The reference fails such files too (its read
        # into the 80 KB frame buffer throws, AlacContext.cs:64,195).
        if int(parser.frame_byte_sizes.max()) > parser.mdat_len:
            raise HeaderError("stsz frame size exceeds mdat payload")
    counts = np.array([c for c, _ in parser.stts], dtype=np.int64)
    durations = np.array([d for _, d in parser.stts], dtype=np.int64)
    stsc_first = np.array([f for f, _, _ in parser.stsc], dtype=np.int64)
    stsc_spc = np.array([s for _, s, _ in parser.stsc], dtype=np.int64)
    tables = SampleTables(
        frame_byte_sizes=parser.frame_byte_sizes,
        stts_counts=counts,
        stts_durations=durations,
        stsc_first_chunk=stsc_first,
        stsc_samples_per_chunk=stsc_spc,
        chunk_offsets=parser.stco,
    )
    try:
        params = CodecParams.from_stsd_payload(parser.codec_data)
    except ValueError as exc:  # short/absent cookie
        raise HeaderError(f"bad ALAC magic cookie ({exc})") from exc
    layout = channel_layout(parser.codec_data)
    if layout is not None and parser.num_channels and (layout[0] & 0xFFFF) not in (
            0, parser.num_channels):
        # a layout tag's low 16 bits are its channel count (0 for a
        # layout given by its descriptions or bitmap)
        raise HeaderError(
            f"chan layout of {layout[0] & 0xFFFF} channels for a cookie of "
            f"{parser.num_channels}")
    if not 1 <= params.max_samples_per_frame <= 1 << 20:
        # A lying cookie frame size would dimension every decode buffer
        # (and XLA executable) from an arbitrary u32; the reference's
        # fixed 16384-int buffers crash on such streams instead
        # (AlacFile.cs:28-36).
        raise HeaderError(
            f"implausible max_samples_per_frame {params.max_samples_per_frame}"
        )
    return StreamInfo(
        format=parser.format,
        num_channels=parser.num_channels,
        sample_size=parser.sample_size,
        sample_rate=parser.sample_rate,
        codec_data=parser.codec_data,
        params=params,
        tables=tables,
        mdat_offset=parser.mdat_offset,
        mdat_len=parser.mdat_len,
        status=status,
    )
