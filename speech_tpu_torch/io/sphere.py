"""NIST SPHERE audio decoding, including embedded "shorten" compression.

A from-scratch decoder for the SPHERE container (NIST_1A header) and the
shorten v1/v2 lossless bitstream as used by LDC corpora, bit-exact against
sph2pipe output (the reference implementation ports sph2pipe to Python;
reference: src/pydrobert/speech/_sphere.py — decode-only, same capability
here).  u-law and A-law decode tables are generated from the G.711 formulas;
the sph2pipe-specific ``ULAW_OUTWARD`` bitshift-fixup table is embedded as
format data in ``_ulaw_outward.py``.

A C++ implementation of the shorten bitstream decoder is used when available
(see ``speech_tpu_torch/csrc``); this module is the always-available fallback and
the correctness oracle for it.
"""

import io
import struct
import warnings

import numpy as np

from ._ulaw_outward import ULAW_OUTWARD

__all__ = ["read_sphere_header", "sphere_read_signal", "ULAW2PCM", "ALAW2PCM"]


def _make_ulaw2pcm() -> np.ndarray:
    # G.711 mu-law expansion
    u = ~np.arange(256) & 0xFF
    sign = (u & 0x80) != 0
    exp = (u >> 4) & 7
    mant = u & 0x0F
    mag = (((mant << 3) + 0x84) << exp) - 0x84
    return np.where(sign, -mag, mag).astype(np.int16)


def _make_alaw2pcm() -> np.ndarray:
    # G.711 A-law expansion; sph2pipe negates relative to sox's convention
    a = np.arange(256) ^ 0x55
    sign = (a & 0x80) != 0
    seg = (a & 0x70) >> 4
    t = (a & 0x0F) << 4
    mag = np.where(
        seg == 0, t + 8, np.where(seg == 1, t + 0x108, 0)
    )
    shifted = (t + 0x108) << np.maximum(seg - 1, 0)
    mag = np.where(seg >= 2, shifted, mag)
    return np.where(sign, mag, -mag).astype(np.int16)


ULAW2PCM = _make_ulaw2pcm()
ALAW2PCM = _make_alaw2pcm()

NEGATIVE_ULAW_ZERO = 0x7F

# shorten format constants (bitstream spec values)
_MAGIC = b"ajkg"
_FN_DIFF0, _FN_DIFF1, _FN_DIFF2, _FN_DIFF3 = 0, 1, 2, 3
_FN_QUIT, _FN_BLOCKSIZE, _FN_BITSHIFT, _FN_QLPC, _FN_ZERO = 4, 5, 6, 7, 8
_TYPE_AU1, _TYPE_S8, _TYPE_U8, _TYPE_S16HL, _TYPE_U16HL = 0, 1, 2, 3, 4
_TYPE_S16LH, _TYPE_U16LH, _TYPE_ULAW, _TYPE_AU2 = 5, 6, 7, 8
_ULONGSIZE = 2
_FNSIZE = 2
_ENERGYSIZE = 3
_BITSHIFTSIZE = 2
_LPCQSIZE = 2
_LPCQUANT = 5
_XBYTESIZE = 7
_NWRAP = 3
_DEFAULT_V0NMEAN = 0
_DEFAULT_V2NMEAN = 4
_MAX_SUPPORTED_VERSION = 2


def _trunc_div(a: int, b: int) -> int:
    """C-style integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def read_sphere_header(file_):
    """Parse a NIST_1A header from an open binary file.

    Returns ``(samptype, sampsize, sampcount, samprate, chancount,
    inporder)``.  Raises :class:`IOError` on malformed headers.
    """
    head = file_.read(1024)
    if len(head) != 1024 or not head.startswith(b"NIST_1A"):
        raise IOError("not a NIST SPHERE file")
    try:
        hdrsize = int(head.split(b"\n")[1])
    except (IndexError, ValueError):
        raise IOError("bad SPHERE header size")
    if hdrsize < 1024:
        raise IOError("bad SPHERE header size")
    head += file_.read(hdrsize - len(head))
    samptype = sampsize = sampcount = samprate = chancount = inporder = None
    saw_end = False
    for field in head.split(b"\n")[2:]:
        if field == b"end_head":
            saw_end = True
            break
        parts = field.decode(errors="replace").split()
        if len(parts) < 2:
            continue
        key, fmt = parts[0], parts[1]
        value = " ".join(parts[2:])
        if fmt == "-i":
            value = int(value)
        if key == "channel_count":
            chancount = value
        elif key == "sample_count":
            sampcount = value
        elif key == "sample_rate":
            samprate = value
        elif key == "sample_n_bytes":
            sampsize = value
        elif key == "sample_byte_format":
            inporder = value
        elif key == "sample_coding":
            for prefix in ("alaw", "ulaw", "pcm"):
                if str(value).startswith(prefix):
                    samptype = prefix
    if not saw_end:
        raise IOError("SPHERE header missing end_head")
    if not samptype and (sampsize == 2 or (inporder and len(inporder) == 2)):
        samptype = "pcm"
    if (
        not samptype
        or not sampcount
        or not samprate
        or not chancount
        or (samptype == "pcm" and not inporder)
    ):
        raise IOError("incomplete SPHERE header")
    return samptype, sampsize, sampcount, samprate, chancount, inporder


class _BitReader:
    """MSB-first bit reader over big-endian 32-bit words."""

    __slots__ = ("_file", "_buf", "_pos", "_word", "_avail")

    def __init__(self, preread: bytes, file_):
        self._file = file_
        self._buf = preread
        self._pos = 0
        self._word = 0
        self._avail = 0

    def _next_word(self) -> None:
        if self._pos + 4 > len(self._buf):
            more = self._file.read(65536)
            self._buf = self._buf[self._pos :] + more
            self._pos = 0
            if len(self._buf) < 4:
                raise IOError("unexpected end of shorten bitstream")
        (self._word,) = struct.unpack_from(">I", self._buf, self._pos)
        self._pos += 4
        self._avail = 32

    def uvar(self, nbits: int) -> int:
        """Rice-style code: unary high part, ``nbits`` literal low bits."""
        # unary part: number of zero bits before the first one bit
        result = 0
        while True:
            if not self._avail:
                self._next_word()
            self._avail -= 1
            if self._word & (1 << self._avail):
                break
            result += 1
        low = 0
        n = nbits
        while n:
            if not self._avail:
                self._next_word()
            take = min(n, self._avail)
            self._avail -= take
            low = (low << take) | ((self._word >> self._avail) & ((1 << take) - 1))
            n -= take
        return (result << nbits) | low

    def ulong(self) -> int:
        nbit = self.uvar(_ULONGSIZE)
        return self.uvar(nbit)

    def var(self, nbits: int) -> int:
        u = self.uvar(nbits + 1)
        return ~(u >> 1) if (u & 1) else (u >> 1)


def _fix_bitshift(block: np.ndarray, bitshift: int, ftype: int) -> np.ndarray:
    if ftype == _TYPE_AU1:
        return ULAW_OUTWARD[bitshift][block + 128].astype(np.int32)
    if ftype == _TYPE_AU2:
        # np.where evaluates BOTH branches: the negative-side index must
        # be clipped for non-negative blocks too, or any sample >= 127
        # indexes past the table and crashes on a perfectly valid stream
        # (caught by the valid-bitstream differential fuzz)
        out = np.where(
            block >= 0,
            ULAW_OUTWARD[bitshift][np.minimum(block, 127) + 128],
            np.where(
                block == -1,
                NEGATIVE_ULAW_ZERO,
                ULAW_OUTWARD[bitshift][np.clip(block, -129, 126) + 129],
            ),
        )
        return out.astype(np.int32)
    if bitshift:
        return block << bitshift
    return block


def _decode_shortened(preread: bytes, file_, data: np.ndarray) -> int:
    """Decode a shorten v1/v2 bitstream into ``data`` (interleaved samples).

    Returns the number of per-channel samples decoded.
    """
    assert preread[:4] == _MAGIC
    version = preread[4]
    if version > _MAX_SUPPORTED_VERSION:
        raise IOError(f"unsupported shorten version {version}")
    bits = _BitReader(preread[5:], file_)

    ftype = bits.ulong()
    if ftype >= 9:
        raise IOError(f"bad shorten file type {ftype}")
    convert = data.dtype.itemsize > 1 and ftype in (_TYPE_AU1, _TYPE_AU2)
    nchan = bits.ulong()
    blocksize = bits.ulong()
    maxnlpc = bits.ulong()
    nmean = bits.ulong()
    nskip = bits.ulong()
    for _ in range(nskip):
        bits.uvar(_XBYTESIZE)

    nwrap = max(maxnlpc, _NWRAP)
    history = np.zeros((nchan, nwrap), dtype=np.int64)

    if ftype == _TYPE_U8:
        mean = 0x8  # sph2pipe quirk (not 0x80)
    elif ftype in (_TYPE_U16HL, _TYPE_U16LH):
        mean = 0x8000
    elif ftype in (
        _TYPE_AU1,
        _TYPE_S8,
        _TYPE_S16HL,
        _TYPE_S16LH,
        _TYPE_ULAW,
        _TYPE_AU2,
    ):
        mean = 0
    else:
        raise IOError(f"bad shorten file type {ftype}")
    nblock = max(1, nmean)
    offsets = np.full((nchan, nblock), mean, dtype=np.int64)

    bitshift = 0
    lpcqoffset = (1 << _LPCQUANT) if version > 1 else 0
    sampsdone = 0
    write_pos = 0
    chan = 0
    pending = np.zeros((nchan, blocksize), dtype=np.int64)

    while True:
        cmd = bits.uvar(_FNSIZE)
        if cmd == _FN_QUIT:
            break
        if cmd == _FN_BLOCKSIZE:
            blocksize = bits.ulong()
            if pending.shape[1] != blocksize:
                pending = np.zeros((nchan, blocksize), dtype=np.int64)
            continue
        if cmd == _FN_BITSHIFT:
            bitshift = bits.uvar(_BITSHIFTSIZE)
            continue
        if cmd not in (
            _FN_ZERO,
            _FN_DIFF0,
            _FN_DIFF1,
            _FN_DIFF2,
            _FN_DIFF3,
            _FN_QLPC,
        ):
            raise IOError(f"bad shorten command {cmd}")

        if cmd != _FN_ZERO:
            resn = bits.uvar(_ENERGYSIZE)

        if nmean:
            total = 0 if version < 2 else nmean // 2
            total += int(offsets[chan, :nmean].sum())
            coffset = _trunc_div(total, nmean)
            if version >= 2:
                coffset >>= bitshift
        else:
            coffset = int(offsets[chan, 0])

        block = pending[chan]
        hist = history[chan]
        if cmd == _FN_ZERO:
            block[:] = 0
        elif cmd == _FN_DIFF0:
            for i in range(blocksize):
                block[i] = bits.var(resn) + coffset
        elif cmd == _FN_DIFF1:
            prev = hist[-1]
            for i in range(blocksize):
                prev = bits.var(resn) + prev
                block[i] = prev
        elif cmd == _FN_DIFF2:
            p1, p2 = hist[-1], hist[-2]
            for i in range(blocksize):
                cur = bits.var(resn) + 2 * p1 - p2
                block[i] = cur
                p2, p1 = p1, cur
        elif cmd == _FN_DIFF3:
            p1, p2, p3 = hist[-1], hist[-2], hist[-3]
            for i in range(blocksize):
                cur = bits.var(resn) + 3 * (p1 - p2) + p3
                block[i] = cur
                p3, p2, p1 = p2, p1, cur
        else:  # FN_QLPC
            nlpc = bits.uvar(_LPCQSIZE)
            qlpc = [bits.var(_LPCQUANT) for _ in range(nlpc)]
            ext = np.concatenate([hist[nwrap - nlpc :] - coffset, block])
            for i in range(blocksize):
                acc = lpcqoffset
                for j in range(nlpc):
                    acc += qlpc[j] * int(ext[nlpc + i - j - 1])
                ext[nlpc + i] = bits.var(resn) + (acc >> _LPCQUANT)
            block[:] = ext[nlpc:]
            if coffset:
                block += coffset

        if nmean > 0:
            total = 0 if version < 2 else blocksize // 2
            total += int(block.sum())
            offsets[chan, : nmean - 1] = offsets[chan, 1:nmean]
            offsets[chan, nmean - 1] = _trunc_div(total, blocksize)
            if version >= 2:
                offsets[chan, nmean - 1] = int(offsets[chan, nmean - 1]) << bitshift

        # wrap history for the next block's predictors
        if nwrap <= blocksize:
            history[chan] = block[blocksize - nwrap :]
        else:
            history[chan] = np.concatenate(
                [hist[blocksize:], block]
            )

        pending[chan] = _fix_bitshift(block, bitshift, ftype)

        if chan == nchan - 1:
            nitem = blocksize * nchan
            out = pending[:, :blocksize].T.reshape(-1)
            if write_pos + nitem > len(data):
                out = out[: max(0, len(data) - write_pos)]
                nitem = len(out)
            if convert:
                data[write_pos : write_pos + nitem] = ULAW2PCM[out]
            else:
                data[write_pos : write_pos + nitem] = out
            write_pos += nitem
            sampsdone += blocksize
        chan = (chan + 1) % nchan
    return sampsdone


def _try_decode_shortened_native(
    preread: bytes, file_, data: np.ndarray, chancount: int
):
    """Decode via the C++ library (speech_tpu_torch/csrc/shorten.cpp); None if it
    is unavailable, before anything past ``preread`` is read.  Bit-identical
    to :func:`_decode_shortened`, which decodes the payload where the
    library declines its header."""
    try:
        from ._native import decode_shorten_native, get_shorten_lib
    except Exception:
        return None
    if get_shorten_lib() is None:
        return None
    payload = preread + file_.read()
    result = decode_shorten_native(payload, len(data), ULAW_OUTWARD)
    if result is None:
        # the file is read to its end: the Python decoder takes the payload
        return _decode_shortened(payload, io.BytesIO(), data)
    out, sampsdone, ftype = result
    convert = data.dtype.itemsize > 1 and ftype in (_TYPE_AU1, _TYPE_AU2)
    n = min(len(data), sampsdone * chancount)
    if convert:
        data[:n] = ULAW2PCM[out[:n]]
    else:
        data[:n] = out[:n]
    return sampsdone


def _read_samples(file_, header, dtype):
    samptype, sampsize, sampcount, samprate, chancount, inporder = header
    if sampsize == 1:
        in_type = np.uint8
    elif sampsize == 2:
        in_type = np.int16
    elif sampsize == 4:
        in_type = np.int32
    else:
        raise IOError(f"bad SPHERE sample size {sampsize}")
    if dtype is None:
        if samptype in ("alaw", "ulaw"):
            dtype = np.int16  # decompress by default
        else:
            dtype = in_type
    dtype = np.dtype(dtype)
    in_type = np.dtype(in_type).newbyteorder(">" if inporder == "10" else "<")
    convert = sampsize < dtype.itemsize and samptype in ("alaw", "ulaw")
    data = np.zeros(sampcount * chancount, dtype=dtype)
    sampsdone = 0
    first = True
    while sampsdone < sampcount:
        buf = file_.read(16384)
        if not buf:
            break
        if first and buf[:4] == _MAGIC:
            native = _try_decode_shortened_native(buf, file_, data, chancount)
            if native is not None:
                sampsdone = native
            else:
                sampsdone = _decode_shortened(buf, file_, data)
            break
        first = False
        ns = len(buf) // (chancount * sampsize)
        if sampsdone + ns > sampcount:
            ns = sampcount - sampsdone
        samples = np.frombuffer(buf, dtype=in_type, count=ns * chancount)
        if convert and samptype == "alaw":
            samples = ALAW2PCM[samples]
        elif convert:
            samples = ULAW2PCM[samples]
        data[sampsdone * chancount : (sampsdone + ns) * chancount] = samples
        sampsdone += ns
    if sampsdone != sampcount:
        warnings.warn(
            "{} samples read, {} samples expected".format(sampsdone, sampcount)
        )
    if chancount > 1:
        data = data[: sampsdone * chancount].reshape(
            (sampsdone, chancount), order="C"
        )
    return data


def sphere_read_signal(rfilename, dtype=None, key=None):
    """Read a NIST SPHERE file (pcm, u-law, A-law, or shorten-compressed).

    Parameters
    ----------
    rfilename
        Path or open binary file.
    dtype
        Output dtype; defaults to int16 for u-law/A-law (decompressed) and
        the native width otherwise.
    key
        Unused (dispatch API compatibility).
    """
    if isinstance(rfilename, str):
        with open(rfilename, "rb") as file_:
            return sphere_read_signal(file_, dtype, key)
    header = read_sphere_header(rfilename)
    return _read_samples(rfilename, header, dtype)
