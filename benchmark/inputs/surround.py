"""A 5.1 surround library: multichannel ALAC frames, frozen for the benchmark.

Apple's encoder (github.com/macosforge/alac, ``ALACEncoder.cpp``) codes a
frame of more than two channels as a chain of elements in the order of its
``sChannelMaps``: for 5.1, an SCE (C), a CPE (L R), a CPE (Ls Rs) and an
SCE (LFE), each element's instance tag counting its kind (SCE 0 and 1,
CPE 0 and 1), then the END tag and the byte alignment.  An element is
coded exactly as a one- or two-channel frame of its own channels is, so
each element here is coded by the frozen frame encoder
(``alac.encode_frames``, each channel at the cheaper of the
configuration's orders) and the elements' bits are spliced: each
element's bit length follows from its header, its extra bits and its Rice
sections (``Coded.rice_bits``).  The `.m4a` carries the cookie with six
channels and the ``chan`` layout record after it
(``ALACMagicCookieDescription.txt``; ``kALACChannelLayoutTag_MPEG_5_1_D``).

The library is the stereo library's plan (``library.make_library``: the
same track lengths, silences and pool for the seed) with six channels of
seeded music (:func:`surround_frames`).  It imports nothing of the port.
"""

from __future__ import annotations

import struct

import numpy as np

from . import alac, library, m4a

#: The elements of a frame of each channel count (channels each element
#: holds), ``sChannelMaps``.
CHANNEL_ELEMENTS = {3: (1, 2), 4: (1, 2, 1), 5: (1, 2, 2), 6: (1, 2, 2, 1),
                    7: (1, 2, 2, 1, 1), 8: (1, 2, 2, 2, 1)}
#: Core Audio's layout tag of each count (high 16 bits the tag, low the count).
LAYOUT_TAGS = {3: (113 << 16) | 3, 4: (116 << 16) | 4, 5: (120 << 16) | 5,
               6: (124 << 16) | 6, 7: (142 << 16) | 7, 8: (127 << 16) | 8}
#: The END element's tag.
ID_END = 7


def surround_frames(count: int, frame_samples: int, bits: int, channels: int, rng,
                    dither: int = 0) -> np.ndarray:
    """(count, frame_samples, channels) int32 PCM, each frame a seeded
    excerpt: every channel but the last as ``pcm.music_frames`` draws
    one (three partials and noise, the channel's phase its own); the last
    (the LFE of 5.1) band-limited: the lowest partial and the noise only."""
    lim = 1 << (bits - 1)
    t = rng.uniform(0, 1 << 24, (count, 1)) + np.arange(frame_samples)[None, :]
    level = lim * rng.uniform(0.06, 0.18, (count, 1))
    pitch = rng.uniform(0.7, 1.4, (count, 1))
    noise = rng.uniform(0.005, 0.015, (count, 1))
    chans = []
    for c in range(channels):
        sig = level * np.sin(t * 0.013 * pitch + c)
        if c < channels - 1:
            sig = sig + 0.5 * level * np.sin(t * 0.0913 * pitch + 2.7 * c)
            sig = sig + 0.1 * level * np.sin(t * 0.537 * pitch)
        chans.append(sig + rng.normal(0.0, 1.0, t.shape) * level * noise)
    pcm = np.stack(chans, axis=2)
    if dither:
        pcm = pcm + rng.integers(-dither, dither, pcm.shape)
    return np.clip(pcm, -lim, lim - 1).astype(np.int32)


def make_library(config: dict, seed: int) -> library.Library:
    """The library of ``config`` for ``seed``: ``library.make_library``'s
    plan, its music frames drawn by :func:`surround_frames`."""
    rng = np.random.default_rng([seed % (1 << 64), 0])
    lib = library.make_library(config, seed)
    M = int(config["pool_frames"])
    # the plan draws three permutations of the tracks, then the music:
    # the music is drawn again from the same point of the same stream
    for _ in range(3):
        rng.permutation(int(config["tracks"]))
    lib.pool_pcm[:M] = surround_frames(
        M, int(config["frame_samples"]), int(config["bits_per_sample"]),
        int(config["channels"]), rng, dither=int(config.get("dither", 0)))
    return lib


def element_bits(coded: alac.Coded, n: np.ndarray, frame_samples: int, ub: int) -> np.ndarray:
    """(P,) bits of each frame that ``alac.encode_frames`` coded: its
    header (23 bits, 32 more for a partial frame, 16 of shift and weight,
    16 a channel and 16 a coefficient), its extra bits and its Rice
    sections."""
    C = coded.orders.shape[1]
    count = np.where(coded.orders == 31, 31, coded.orders)
    head = 23 + 32 * (n != frame_samples) + 16 + (16 + 16 * count).sum(axis=1)
    return head + n * C * 8 * ub + coded.rice_bits.sum(axis=1)


def _bits(payload: bytes, nbits: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(payload, np.uint8))[:nbits]


def code(lib: library.Library, orders=None) -> alac.Coded:
    """Every pool entry coded as Apple's encoder codes a frame of its
    channel count: each element by the frozen encoder, each channel at
    the cheaper of the configuration's orders (``orders``: at these),
    the elements spliced in the map's order with their instance tags,
    then END and the byte alignment.  ``Coded.rice_bits`` and
    ``Coded.orders`` are (P, C), one column a channel in output order."""
    c = lib.config
    P, S, C = lib.pool_pcm.shape
    kinds = CHANNEL_ELEMENTS[C]
    coding = lib.coding()
    orders = tuple(c["orders"]) if orders is None else orders
    first = np.cumsum((0,) + kinds)[:-1]
    # the elements of one kind coded in one call: (P x elements) frames
    coded = {}
    for kind in (1, 2):
        which = [e for e, k in enumerate(kinds) if k == kind]
        pcm = np.concatenate([lib.pool_pcm[:, :, first[e]:first[e] + kind] for e in which])
        out = alac.encode_frames(pcm, np.tile(lib.pool_n, len(which)), orders, coding)
        bits = element_bits(out, np.tile(lib.pool_n, len(which)), S, coding.uncompressed_bytes)
        for j, e in enumerate(which):
            sl = slice(j * P, (j + 1) * P)
            coded[e] = (out.payloads[sl], bits[sl], out.rice_bits[sl], out.orders[sl])
    payloads = []
    instance = {1: 0, 2: 0}
    tags = []
    for e, kind in enumerate(kinds):
        tags.append(np.unpackbits(np.array([instance[kind] << 4], np.uint8))[:4])
        instance[kind] += 1
    end = np.unpackbits(np.array([ID_END << 5], np.uint8))[:3]
    for p in range(P):
        parts = []
        for e in range(len(kinds)):
            b = _bits(coded[e][0][p], int(coded[e][1][p])).copy()
            b[3:7] = tags[e]  # the element's instance tag
            parts.append(b)
        parts.append(end)
        payloads.append(np.packbits(np.concatenate(parts)).tobytes())
    rice_bits = np.concatenate([coded[e][2] for e in range(len(kinds))], axis=1)
    lane_orders = np.concatenate([coded[e][3] for e in range(len(kinds))], axis=1)
    return alac.Coded(payloads, rice_bits, lane_orders)


def write_m4a(sample_rate: int, sample_size: int, channels: int, frame_samples: int,
              frames: list, durations) -> bytes:
    """``m4a.write_m4a`` with the ``chan`` layout record after the cookie:
    the record's 24 bytes go at the end of the sample entry, and each
    atom that holds it, and each chunk offset, moves by as much."""
    data = m4a.write_m4a(sample_rate, sample_size, channels, frame_samples, frames, durations)
    chan = struct.pack(">I4sIIII", 24, b"chan", 0, LAYOUT_TAGS[channels], 0, 0)
    moov = data.index(b"moov") - 4
    path = [moov]
    for name in (b"trak", b"mdia", b"minf", b"stbl", b"stsd"):
        path.append(data.index(name, path[-1]) - 4)
    entry = path[-1] + 16  # stsd: size, type, version/flags, entry count
    path.append(entry)
    end = entry + struct.unpack_from(">I", data, entry)[0]
    out = bytearray(data[:end] + chan + data[end:])
    for at in path:
        struct.pack_into(">I", out, at, struct.unpack_from(">I", out, at)[0] + len(chan))
    stco = out.index(b"stco") + 4
    count = struct.unpack_from(">I", out, stco + 4)[0]
    offs = np.frombuffer(bytes(out[stco + 8:stco + 8 + 4 * count]), ">u4") + len(chan)
    out[stco + 8:stco + 8 + 4 * count] = offs.astype(">u4").tobytes()
    return bytes(out)


def m4a_of(lib: library.Library, coded: alac.Coded, t: int) -> bytes:
    """Track ``t`` as a whole `.m4a` file of ``coded``'s frames."""
    c = lib.config
    f = lib.tracks[t]
    return write_m4a(c["sample_rate"], c["bits_per_sample"], c["channels"], c["frame_samples"],
                     [coded.payloads[i] for i in f], lib.pool_n[f].tolist())

