"""Native (pure-Python) Kaldi table I/O: ark/scp archives without bindings.

The reference delegates all Kaldi-table access to the optional
``pydrobert-kaldi`` C++ bindings (reference: util.py:189-204, 293-300;
command_line.py:245-359).  Those bindings are heavyweight and frequently
unavailable; this module implements the on-disk formats directly so
``read_signal`` table access and ``compute-feats-from-kaldi-tables`` work
standalone.  When ``pydrobert-kaldi`` IS importable it still wins (see
``speech_tpu_torch.io._kaldi_table_read`` and the CLI) — this is the fallback.

Formats implemented (the Kaldi table format is public and stable):

- binary archives (``ark``): ``<key><space>\\0B<value>`` entries, where the
  value is a typed token — ``FM``/``DM`` float/double matrices,
  ``FV``/``DV`` vectors, ``CM``/``CM2``/``CM3`` compressed matrices, or a
  raw RIFF blob for wave data — followed by ``\\4``-prefixed int32 dims and
  little-endian payload.
- text archives (``ark,t``): ``<key>  [\\n  row\\n ... ]`` matrices and
  ``<key>  [ v0 v1 ... ]`` vectors.
- script files (``scp``): ``<key> <path>:<offset>`` pointers into archives,
  plain audio paths, or ``command |`` pipes (wave tables).
- specifiers: ``ark:-``, ``scp,p:...``, ``ark,scp:a.ark,a.scp`` (write both),
  read/write pipes (``cmd |`` / ``| cmd``).

Compressed-matrix support covers all three Kaldi methods: per-column
percentile uint8 (``CM``), global uint16 (``CM2``), and global uint8
(``CM3``), both read and write; the encoder follows Kaldi's column-header
percentile scheme so round-trip error is bounded by the format's
quantization step.

Everything here was written from the format specification; no code is
shared with Kaldi or pydrobert-kaldi.
"""

import logging
import struct
import subprocess
import sys

from typing import (
    Any,
    BinaryIO,
    Iterator,
    NamedTuple,
    Optional,
    Tuple,
    Union,
)

import numpy as np

__all__ = [
    "KaldiRandomReader",
    "KaldiTableWriter",
    "WaveData",
    "compress_matrix",
    "iter_table",
    "open_wave_reader",
    "parse_rspecifier",
    "parse_wspecifier",
    "read_table_entry",
    "read_value",
    "table_read",
    "write_value",
    "write_wave",
]

logger = logging.getLogger(__name__)

_BINARY_MAGIC = b"\x00B"


class WaveData(NamedTuple):
    """Kaldi-convention wave value: float32 samples at int16 scale.

    ``data`` has shape ``(channels, samples)`` (Kaldi's WaveData layout —
    the reference CLI indexes channels on axis 0: command_line.py:332-344).
    """

    data: np.ndarray
    samp_freq: float

    @property
    def duration(self) -> float:
        return self.data.shape[1] / self.samp_freq


# --------------------------------------------------------------------------
# specifier parsing
# --------------------------------------------------------------------------


def parse_rspecifier(rspecifier: str) -> Tuple[str, set, str]:
    """Split ``ark,s,cs:path`` into ``("ark", {"s","cs"}, "path")``."""
    head, sep, path = rspecifier.partition(":")
    if not sep:
        raise IOError(f"invalid rspecifier (no colon): {rspecifier!r}")
    parts = head.split(",")
    kind = parts[0].lower()
    if kind not in ("ark", "scp"):
        raise IOError(f"invalid rspecifier kind {kind!r} in {rspecifier!r}")
    return kind, set(p.lower() for p in parts[1:]), path


def parse_wspecifier(wspecifier: str) -> Tuple[Optional[str], Optional[str], set]:
    """Split a wspecifier into ``(ark_path, scp_path, options)``.

    Handles ``ark:...``, ``scp:...`` (invalid for writing alone, mirrored
    Kaldi error), and ``ark,scp:arkpath,scppath``.
    """
    head, sep, path = wspecifier.partition(":")
    if not sep:
        raise IOError(f"invalid wspecifier (no colon): {wspecifier!r}")
    parts = [p.lower() for p in head.split(",")]
    opts = set(p for p in parts if p not in ("ark", "scp"))
    kinds = [p for p in parts if p in ("ark", "scp")]
    if kinds == ["ark"]:
        return path, None, opts
    if kinds == ["ark", "scp"]:
        ark_path, comma, scp_path = path.partition(",")
        if not comma:
            raise IOError(
                f"ark,scp wspecifier needs two comma-separated paths: "
                f"{wspecifier!r}"
            )
        return ark_path, scp_path, opts
    raise IOError(
        f"unsupported wspecifier {wspecifier!r} (use ark:..., ark,t:..., "
        f"or ark,scp:...,...)"
    )


class _PipeReader:
    """Streaming binary read pipe ("cmd |") — lazy, O(1) memory.

    Closing reaps the subprocess; an early close (a partial table read)
    lets the command die on SIGPIPE without raising.
    """

    def __init__(self, command: str):
        self._proc = subprocess.Popen(
            command, shell=True, stdout=subprocess.PIPE
        )
        self._stdout = self._proc.stdout
        self._eof = False

    def read(self, n: int = -1) -> bytes:
        data = self._stdout.read(n)
        if n is None or n < 0 or not data or len(data) < n:
            self._eof = True  # read-all, empty, or short read: stream ended
        return data

    def close(self) -> None:
        self._stdout.close()
        ret = self._proc.wait()
        # a nonzero exit only matters if we believed the stream was whole
        if ret and self._eof:
            raise IOError(f"read pipe exited with status {ret}")


def _open_read(path: str):
    if path == "-" or path == "":
        return sys.stdin.buffer
    if path.endswith("|"):
        return _PipeReader(path[:-1])
    return open(path, "rb")


class _PipeWriter:
    """Binary write pipe ("| cmd") that closes the subprocess on close."""

    def __init__(self, command: str):
        self._proc = subprocess.Popen(
            command, shell=True, stdin=subprocess.PIPE
        )
        self.stdin = self._proc.stdin

    def write(self, data: bytes) -> int:
        return self.stdin.write(data)

    def flush(self) -> None:
        self.stdin.flush()

    def tell(self) -> int:  # pragma: no cover - pipes aren't scp targets
        raise IOError("cannot record scp offsets into a pipe")

    def close(self) -> None:
        self.stdin.close()
        ret = self._proc.wait()
        if ret:
            raise IOError(f"write pipe exited with status {ret}")


def _open_write(path: str):
    if path == "-" or path == "":
        return sys.stdout.buffer
    if path.startswith("|"):
        return _PipeWriter(path[1:].strip())
    return open(path, "wb")


# --------------------------------------------------------------------------
# binary primitives
# --------------------------------------------------------------------------


def _read_int32(f: BinaryIO) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise IOError(f"expected int32 size byte, got {size!r}")
    return struct.unpack("<i", _read_exact(f, 4))[0]


def _write_int32(f, value: int) -> None:
    f.write(b"\x04" + struct.pack("<i", value))


def _read_token(f: BinaryIO) -> str:
    chars = []
    while True:
        c = f.read(1)
        if not c:
            raise EOFError("EOF while reading token")
        if c == b" ":
            break
        chars.append(c)
    return b"".join(chars).decode("utf-8")


def _read_exact(f: BinaryIO, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise IOError(f"short read: wanted {n} bytes, got {len(data)}")
    return data


# --------------------------------------------------------------------------
# compressed matrices (CM / CM2 / CM3)
# --------------------------------------------------------------------------


def _uint16_to_float(u: np.ndarray, min_value: float, range_: float):
    return np.float32(min_value) + np.float32(range_) * (
        u.astype(np.float32) / np.float32(65535.0)
    )


def _float_to_uint16(x: np.ndarray, min_value: float, range_: float):
    f = (x.astype(np.float64) - min_value) / range_
    return np.clip(np.floor(f * 65535.0 + 0.499), 0, 65535).astype(np.uint16)


def _chars_to_floats(chars: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Per-column piecewise-linear uint8 decode (Kaldi CM format 1).

    ``chars``: (rows, cols) uint8; ``p``: (4, cols) float32 percentiles.
    Segments: [0,64] -> [p0,p25], [64,192] -> [p25,p75], [192,255] ->
    [p75,p100].
    """
    c = chars.astype(np.float32)
    p0, p25, p75, p100 = (row[None, :] for row in p.astype(np.float32))
    lo = p0 + (p25 - p0) * (c * np.float32(1.0 / 64.0))
    mid = p25 + (p75 - p25) * ((c - 64.0) * np.float32(1.0 / 128.0))
    hi = p75 + (p100 - p75) * ((c - 192.0) * np.float32(1.0 / 63.0))
    return np.where(c <= 64, lo, np.where(c <= 192, mid, hi))


def _floats_to_chars(x: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_chars_to_floats` with round-to-nearest."""
    v = x.astype(np.float64)
    p0, p25, p75, p100 = (row[None, :].astype(np.float64) for row in p)
    lo = np.clip(np.round((v - p0) / (p25 - p0) * 64.0), 0, 64)
    mid = np.clip(64.0 + np.round((v - p25) / (p75 - p25) * 128.0), 64, 192)
    hi = np.clip(192.0 + np.round((v - p75) / (p100 - p75) * 63.0), 192, 255)
    return np.where(v < p25, lo, np.where(v < p75, mid, hi)).astype(np.uint8)


def _read_compressed(f: BinaryIO, fmt: int) -> np.ndarray:
    min_value, range_, rows, cols = struct.unpack("<ffii", _read_exact(f, 16))
    if rows < 0 or cols < 0:
        raise IOError(f"bad compressed-matrix dims ({rows}, {cols})")
    if rows == 0 or cols == 0:
        return np.zeros((rows, cols), np.float32)
    if fmt == 1:
        headers = np.frombuffer(
            _read_exact(f, 8 * cols), dtype="<u2"
        ).reshape(cols, 4)
        p = _uint16_to_float(headers.T, min_value, range_)  # (4, cols)
        chars = np.frombuffer(_read_exact(f, rows * cols), dtype=np.uint8)
        chars = chars.reshape(cols, rows).T  # stored column-major
        return _chars_to_floats(chars, p).astype(np.float32)
    if fmt == 2:
        u = np.frombuffer(_read_exact(f, 2 * rows * cols), dtype="<u2")
        return _uint16_to_float(u, min_value, range_).reshape(rows, cols)
    if fmt == 3:
        u = np.frombuffer(_read_exact(f, rows * cols), dtype=np.uint8)
        return (
            np.float32(min_value)
            + np.float32(range_) * (u.astype(np.float32) / np.float32(255.0))
        ).reshape(rows, cols)
    raise IOError(f"unknown compressed-matrix format {fmt}")


def _column_headers(mat: np.ndarray, min_value: float, range_: float):
    """Kaldi-style per-column percentile headers, as uint16 (4, cols)."""
    rows = mat.shape[0]
    sdata = np.sort(mat, axis=0)
    quarter = rows // 4
    idx = [0, min(quarter, rows - 1), min(3 * quarter, rows - 1), rows - 1]
    q = _float_to_uint16(sdata[idx, :], min_value, range_).astype(np.int64)
    # enforce strictly increasing quantized percentiles (decode divides by
    # their differences); clamp from the top if a column is constant
    for i in (1, 2, 3):
        q[i] = np.maximum(q[i], q[i - 1] + 1)
    q[3] = np.minimum(q[3], 65535)
    q[2] = np.minimum(q[2], q[3] - 1)
    q[1] = np.minimum(q[1], q[2] - 1)
    q[0] = np.minimum(q[0], q[1] - 1)
    return np.maximum(q, 0).astype(np.uint16)


def compress_matrix(mat: np.ndarray, method: Union[str, int] = "auto"):
    """Encode a matrix as Kaldi compressed bytes ``(token, payload)``.

    ``method``: 1 (per-column uint8, "CM"), 2 (uint16, "CM2"), 3 (uint8,
    "CM3"), or "auto" (Kaldi's default: format 1 when ``rows > 8``, else
    format 2 — tall speech-feature matrices get the percentile treatment).
    """
    mat = np.asarray(mat, np.float32)
    if mat.ndim != 2:
        raise ValueError("compress_matrix needs a 2-D matrix")
    rows, cols = mat.shape
    if method == "auto":
        method = 1 if rows > 8 else 2
    min_value = float(mat.min()) if mat.size else 0.0
    range_ = (float(mat.max()) - min_value) if mat.size else 1.0
    if range_ <= 0.0:
        range_ = 1.0e-5
    header = struct.pack("<ffii", min_value, range_, rows, cols)
    if method == 1:
        q = _column_headers(mat, min_value, range_)
        p = _uint16_to_float(q, min_value, range_)
        chars = _floats_to_chars(mat, p)
        payload = header + q.T.astype("<u2").tobytes() + chars.T.tobytes()
        return "CM", payload
    if method == 2:
        u = _float_to_uint16(mat, min_value, range_)
        return "CM2", header + u.astype("<u2").tobytes()
    if method == 3:
        f = (mat.astype(np.float64) - min_value) / range_
        u = np.clip(np.floor(f * 255.0 + 0.499), 0, 255).astype(np.uint8)
        return "CM3", header + u.tobytes()
    raise ValueError(f"unknown compression method {method!r}")


# --------------------------------------------------------------------------
# wave (RIFF) values
# --------------------------------------------------------------------------


def _parse_riff(blob: bytes) -> WaveData:
    if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise IOError("wave table value is not RIFF/WAVE data")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(blob):
        chunk_id = blob[pos : pos + 4]
        (chunk_size,) = struct.unpack("<I", blob[pos + 4 : pos + 8])
        body = blob[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            if len(body) < 16:
                raise IOError(
                    f"truncated RIFF fmt chunk ({len(body)} bytes)"
                )
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            if chunk_size == 0 or pos + 8 + chunk_size > len(blob):
                body = blob[pos + 8 :]  # streamed size: rest of blob
            data = body
            break
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or data is None:
        raise IOError("RIFF data missing fmt/data chunks")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 3 and bits == 32:  # IEEE float
        samples = np.frombuffer(data, dtype="<f4").astype(np.float32)
        samples = samples * np.float32(32768.0)  # to Kaldi int16 scale
    elif audio_format == 1 and bits == 16:
        samples = np.frombuffer(data, dtype="<i2").astype(np.float32)
    elif audio_format == 1 and bits == 32:
        samples = np.frombuffer(data, dtype="<i4").astype(np.float32) / 65536.0
    elif audio_format == 1 and bits == 8:
        samples = (
            np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0
        ) * 256.0
    else:
        raise IOError(
            f"unsupported wave encoding (format={audio_format}, bits={bits})"
        )
    if channels < 1:
        raise IOError("wave data declares zero channels")
    samples = samples[: (samples.size // channels) * channels]
    return WaveData(samples.reshape(-1, channels).T.copy(), float(rate))


def _riff_total_size(header: bytes) -> int:
    (riff_size,) = struct.unpack("<I", header[4:8])
    return riff_size + 8


def _read_wave_binary(f: BinaryIO) -> WaveData:
    header = _read_exact(f, 12)
    if header[:4] != b"RIFF":
        raise IOError("expected RIFF wave data in table")
    total = _riff_total_size(header)
    if total <= 12 or total > (1 << 34):
        rest = f.read()  # bogus / streamed size: take everything available
    else:
        rest = _read_exact(f, total - 12)
    return _parse_riff(header + rest)


def write_wave(
    f, wave: Union[WaveData, Tuple[np.ndarray, float]]
) -> None:
    """Write a (channels, samples) Kaldi-scale wave as PCM16 RIFF bytes."""
    if not isinstance(wave, WaveData):
        wave = WaveData(np.atleast_2d(np.asarray(wave[0])), float(wave[1]))
    channels, _ = wave.data.shape
    pcm = (
        np.clip(np.round(wave.data.T), -32768, 32767)
        .astype("<i2")
        .tobytes()
    )
    rate = int(round(wave.samp_freq))
    block = channels * 2
    f.write(
        b"RIFF"
        + struct.pack("<I", 36 + len(pcm))
        + b"WAVEfmt "
        + struct.pack("<IHHIIHH", 16, 1, channels, rate, rate * block, block, 16)
        + b"data"
        + struct.pack("<I", len(pcm))
        + pcm
    )


# --------------------------------------------------------------------------
# generic value read/write
# --------------------------------------------------------------------------

_MATRIX_TOKENS = {"FM": "<f4", "DM": "<f8"}
_VECTOR_TOKENS = {"FV": "<f4", "DV": "<f8"}
_COMPRESSED_TOKENS = {"CM": 1, "CM2": 2, "CM3": 3}


def read_value(f: BinaryIO) -> Union[np.ndarray, WaveData]:
    """Read one value (matrix/vector/compressed/wave), binary or text.

    The caller is positioned at the first byte after ``<key><space>``.
    """
    first = f.read(1)
    if not first:
        raise EOFError("EOF where a table value was expected")
    if first == b"\x00":
        magic = f.read(1)
        if magic != b"B":
            raise IOError(f"bad binary marker \\x00{magic!r}")
        peek = f.read(1)
        if peek == b"R":  # RIFF wave data follows (no type token)
            rest = _read_exact(f, 11)
            header = b"R" + rest
            if header[:4] != b"RIFF":
                raise IOError("expected RIFF wave data in table")
            total = _riff_total_size(header)
            if total <= 12 or total > (1 << 34):
                body = f.read()
            else:
                body = _read_exact(f, total - 12)
            return _parse_riff(header + body)
        token = peek.decode("utf-8") + _read_token(f)
        if token in _MATRIX_TOKENS:
            rows = _read_int32(f)
            cols = _read_int32(f)
            if rows < 0 or cols < 0:
                raise IOError(f"bad matrix dims ({rows}, {cols})")
            dt = np.dtype(_MATRIX_TOKENS[token])
            data = np.frombuffer(
                _read_exact(f, rows * cols * dt.itemsize), dtype=dt
            )
            return data.reshape(rows, cols).copy()
        if token in _VECTOR_TOKENS:
            size = _read_int32(f)
            if size < 0:
                raise IOError(f"bad vector size {size}")
            dt = np.dtype(_VECTOR_TOKENS[token])
            return np.frombuffer(
                _read_exact(f, size * dt.itemsize), dtype=dt
            ).copy()
        if token in _COMPRESSED_TOKENS:
            return _read_compressed(f, _COMPRESSED_TOKENS[token])
        raise IOError(f"unsupported Kaldi value token {token!r}")
    # text value: skip whitespace to '[', collect tokens until ']'
    buf = [first]
    # NB ``b"" in b" \t"`` is True — the explicit emptiness check keeps
    # EOF-after-whitespace from looping forever (caught by the parser
    # fuzz in tests/test_kaldi_interop.py)
    while buf[-1] and buf[-1] in b" \t":
        buf[-1:] = [f.read(1)]
    if not buf[-1]:
        raise EOFError("EOF where a table value was expected")
    if buf[-1] != b"[":
        raise IOError(f"expected '[' opening a text value, got {buf[-1]!r}")
    rows = []
    row = []
    cur = []
    is_matrix = False
    while True:
        c = f.read(1)
        if not c:
            raise EOFError("EOF inside a text table value")
        if c == b"]":
            break
        if c == b"\n":
            is_matrix = True
            if cur:
                row.append(float(b"".join(cur)))
                cur = []
            if row:
                rows.append(row)
                row = []
        elif c in b" \t\r":
            if cur:
                row.append(float(b"".join(cur)))
                cur = []
        else:
            cur.append(c)
    if cur:
        row.append(float(b"".join(cur)))
    if row:
        rows.append(row)
    # trailing newline (if any) is consumed as leading whitespace by the
    # next _read_key call; don't read past the ']' here
    # text carries full decimal precision but no width token; decode at
    # float64 so double values (e.g. CMVN statistics) round-trip losslessly
    if is_matrix:
        return np.array(rows if rows else [[]], dtype=np.float64)
    return np.array(rows[0] if rows else [], dtype=np.float64)


def write_value(
    f,
    value: Union[np.ndarray, WaveData, Tuple[np.ndarray, float]],
    binary: bool = True,
    compress: Union[bool, int, str] = False,
) -> None:
    """Write one value after ``<key><space>`` (binary marker included)."""
    if isinstance(value, WaveData) or (
        isinstance(value, tuple) and len(value) == 2
    ):
        if not binary:
            raise IOError("wave tables are binary-only")
        f.write(_BINARY_MAGIC)
        write_wave(f, value)
        return
    arr = np.asarray(value)
    if not binary:
        if arr.ndim == 1:
            body = " ".join(repr(float(x)) for x in arr)
            f.write(f" [ {body} ]\n".encode("utf-8"))
        elif arr.ndim == 2:
            lines = "\n".join(
                "  " + " ".join(repr(float(x)) for x in row) for row in arr
            )
            f.write(f" [\n{lines} ]\n".encode("utf-8"))
        else:
            raise ValueError("Kaldi tables hold 1-D or 2-D arrays")
        return
    f.write(_BINARY_MAGIC)
    if arr.ndim == 2 and compress:
        token, payload = compress_matrix(
            arr, "auto" if compress is True else compress
        )
        f.write(token.encode("utf-8") + b" " + payload)
        return
    if arr.ndim == 2:
        if arr.dtype == np.float64:
            token, dt = "DM", "<f8"
        else:
            token, dt = "FM", "<f4"
            arr = arr.astype(np.float32, copy=False)
        f.write(token.encode("utf-8") + b" ")
        _write_int32(f, arr.shape[0])
        _write_int32(f, arr.shape[1])
        f.write(np.ascontiguousarray(arr, dtype=dt).tobytes())
    elif arr.ndim == 1:
        if arr.dtype == np.float64:
            token, dt = "DV", "<f8"
        else:
            token, dt = "FV", "<f4"
        f.write(token.encode("utf-8") + b" ")
        _write_int32(f, arr.shape[0])
        f.write(np.ascontiguousarray(arr, dtype=dt).tobytes())
    else:
        raise ValueError("Kaldi tables hold 1-D or 2-D arrays")


def _read_key(f: BinaryIO) -> Optional[str]:
    """Read ``<key><space>``; returns None on clean EOF."""
    chars = []
    while True:
        c = f.read(1)
        if not c:
            if chars:
                raise EOFError("EOF inside a table key")
            return None
        if c in b" \t":
            if chars:
                return b"".join(chars).decode("utf-8")
            continue  # leading whitespace
        if c in b"\r\n" and not chars:
            continue  # line endings between entries (incl. CRLF archives)
        chars.append(c)


def read_table_entry(f: BinaryIO) -> Optional[Tuple[str, Any]]:
    """Read one ``(key, value)`` archive entry; None at EOF."""
    key = _read_key(f)
    if key is None:
        return None
    return key, read_value(f)


# --------------------------------------------------------------------------
# table iteration / random access
# --------------------------------------------------------------------------


def _scp_lines(path: str):
    if path == "-":
        lines = sys.stdin
    else:
        lines = open(path, "r", encoding="utf-8")
    try:
        for line in lines:
            line = line.strip()
            if not line:
                continue
            parts = line.split(None, 1)  # any whitespace separator (Kaldi)
            if len(parts) != 2:
                raise IOError(f"bad scp line (no target): {line!r}")
            yield parts[0], parts[1].strip()
    finally:
        if lines is not sys.stdin:
            lines.close()


def _read_scp_target(target: str, wave: bool):
    """Resolve one scp target: ark offset, audio path, or pipe command."""
    if target.endswith("|"):
        blob = subprocess.run(
            target[:-1], shell=True, stdout=subprocess.PIPE, check=True
        ).stdout
        if wave:
            return _parse_riff(blob)
        import io as _io

        f = _io.BytesIO(blob)
        return read_value(f)
    path, colon, offset = target.rpartition(":")
    if colon and offset.isdigit():
        with open(path, "rb") as f:
            f.seek(int(offset))
            return read_value(f)
    if wave:
        if target.endswith(".sph"):
            # our native SPHERE decoder handles Kaldi-style sph scp entries
            from .sphere import read_sphere_header, sphere_read_signal

            with open(target, "rb") as sf:
                samprate = read_sphere_header(sf)[3]
            data = sphere_read_signal(target, np.float32)
            data = data.T if data.ndim == 2 else data[None, :]
            return WaveData(np.ascontiguousarray(data), float(samprate))
        with open(target, "rb") as f:
            return _read_wave_binary(f)
    with open(target, "rb") as f:
        return read_value(f)


def iter_table(
    rspecifier: str, wave: bool = False
) -> Iterator[Tuple[str, Any]]:
    """Sequentially iterate ``(key, value)`` over an ark/scp rspecifier."""
    kind, opts, path = parse_rspecifier(rspecifier)
    permissive = "p" in opts
    if kind == "ark":
        f = _open_read(path)
        try:
            while True:
                entry = read_table_entry(f)
                if entry is None:
                    return
                yield entry
        finally:
            if f is not sys.stdin.buffer:
                f.close()
    else:
        for key, target in _scp_lines(path):
            try:
                yield key, _read_scp_target(target, wave)
            except Exception:
                if not permissive:
                    raise
                logger.warning("scp entry %s unreadable; skipping", key)


def table_read(
    rspecifier: str, dtype, key: Union[str, int, None]
) -> np.ndarray:
    """Random/sequential single-entry read, ``read_signal`` semantics.

    ``dtype`` is a pydrobert-kaldi-style type hint ('bm'/'fm'/'dm'/'bv'/
    'fv'/'dv'/'wm' or None) or a numpy dtype; the stored value
    self-describes, the hint only selects the wave interpretation and the
    output cast.
    """
    wave = dtype == "wm"
    if key is None:
        key = 0
    found = None
    if isinstance(key, str):
        for k, v in iter_table(rspecifier, wave=wave):
            if k == key:
                found = v
                break
        if found is None:
            raise KeyError(f"key {key!r} not in table {rspecifier!r}")
    else:
        it = iter_table(rspecifier, wave=wave)
        for _ in range(key + 1):
            try:
                _, found = next(it)
            except StopIteration:
                raise IndexError("table index out of range") from None
        it.close()
    return _cast_value(found, dtype)


def _cast_value(found, dtype) -> np.ndarray:
    if isinstance(found, WaveData):
        found = found.data
        if dtype == "wm":
            return found
    if dtype is None or isinstance(dtype, str):
        if dtype in ("dm", "dv"):
            return np.asarray(found, np.float64)
        if dtype in ("fm", "fv"):
            return np.asarray(found, np.float32)
        return np.asarray(found)
    # a numpy dtype: honor it as the output cast (read_signal callers,
    # e.g. Standardize's float64-first stats probing, pass real dtypes)
    return np.asarray(found, dtype)


def stream_read(rfilename: str, dtype=None) -> np.ndarray:
    """Read ONE value from a Kaldi input stream (file, '-', or 'cmd |').

    Kaldi input streams carry a bare value with no key (reference:
    util.py:293-300 reads them via the bindings' stream mode).  Raw RIFF
    output (the classic ``sph2pipe -f wav x.sph |`` idiom) is sniffed and
    returned as samples — ``(samples,)`` mono, ``(samples, channels)``
    otherwise, matching the wav reader's layout — with or without a
    leading archive ``\\0B`` marker.
    """
    import io as _io

    f = _open_read(rfilename)
    try:
        blob = f.read()  # streams hold a single value; read it whole
    finally:
        if f is not sys.stdin.buffer:
            f.close()
    if blob[:2] == _BINARY_MAGIC and blob[2:6] == b"RIFF":
        blob = blob[2:]
    if blob[:4] == b"RIFF" or dtype == "wm":
        wave = _parse_riff(blob)
        if dtype == "wm":
            return _cast_value(wave, dtype)
        data = wave.data[0] if wave.data.shape[0] == 1 else wave.data.T
        return _cast_value(data, dtype)
    return _cast_value(read_value(_io.BytesIO(blob)), dtype)


class _NativeWaveReader:
    """pydrobert-kaldi-shaped wave reader (``items()`` yields bsd tuples)."""

    def __init__(self, rspecifier: str):
        self._rspecifier = rspecifier
        # validate eagerly so callers get IOError at open time, like the
        # bindings (scp/ark file must exist; pipes defer to first read)
        kind, _, path = parse_rspecifier(rspecifier)
        if path not in ("", "-") and not path.endswith("|"):
            open(path, "rb").close()

    def items(self):
        for key, value in iter_table(self._rspecifier, wave=True):
            if not isinstance(value, WaveData):
                raise IOError(f"table entry {key!r} is not wave data")
            yield key, (value.data, value.samp_freq, value.duration)

    def close(self):
        pass


def open_wave_reader(rspecifier: str) -> _NativeWaveReader:
    """Open a wave table for sequential ``items()`` iteration."""
    return _NativeWaveReader(rspecifier)


class KaldiRandomReader:
    """Random-access table reader (the bindings' ``mode="r+"`` analog).

    ``scp``: targets load into a dict up front; each ``[key]`` opens and
    reads just that entry.  ``ark``: the archive is scanned forward on
    demand, memoizing each key's value offset, so earlier keys never
    re-scan (requires a seekable file — not ``-``/pipes).
    """

    def __init__(self, rspecifier: str, wave: bool = False):
        self._kind, _, self._path = parse_rspecifier(rspecifier)
        self._wave = wave
        if self._kind == "scp":
            self._targets = dict(_scp_lines(self._path))
            self._f = None
        else:
            if self._path in ("", "-") or self._path.endswith("|"):
                raise IOError(
                    "random access needs a seekable ark file, not a stream"
                )
            self._targets = {}  # key -> value offset (memoized scan)
            self._f = open(self._path, "rb")
            self._scanned_to = 0

    def _scan_until(self, key: str) -> bool:
        self._f.seek(self._scanned_to)
        while True:
            k = _read_key(self._f)
            if k is None:
                self._scanned_to = self._f.tell()
                return False
            self._targets.setdefault(k, self._f.tell())
            read_value(self._f)  # skip over the value
            self._scanned_to = self._f.tell()
            if k == key:
                return True

    def __contains__(self, key: str) -> bool:
        if key in self._targets:
            return True
        return self._kind == "ark" and self._scan_until(key)

    def __getitem__(self, key: str):
        if key not in self:
            raise KeyError(key)
        if self._kind == "scp":
            return _read_scp_target(self._targets[key], self._wave)
        self._f.seek(self._targets[key])
        return read_value(self._f)

    def keys(self):
        if self._kind == "ark":
            self._scan_until("\x00never matches\x00")  # scan to EOF
        return self._targets.keys()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class KaldiTableWriter:
    """Write a Kaldi table: ``ark:``, ``ark,t:``, or ``ark,scp:``.

    ``compress`` mirrors Kaldi's ``--compress`` feature-writing flag
    (True = method auto; or an explicit method 1/2/3).
    """

    def __init__(self, wspecifier: str, compress: Union[bool, int] = False):
        ark_path, scp_path, opts = parse_wspecifier(wspecifier)
        self._binary = "t" not in opts
        self._compress = compress
        self._ark = _open_write(ark_path)
        self._scp = (
            open(scp_path, "w", encoding="utf-8") if scp_path else None
        )
        self._ark_name = ark_path
        self._closed = False

    def write(self, key: str, value) -> None:
        if self._closed:
            raise IOError("writer is closed")
        if not key or any(c in key for c in " \t\n"):
            raise IOError(f"invalid table key {key!r}")
        self._ark.write(key.encode("utf-8") + b" ")
        if self._scp is not None:
            self._scp.write(f"{key} {self._ark_name}:{self._ark.tell()}\n")
        write_value(
            self._ark, value, binary=self._binary, compress=self._compress
        )

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._ark is not sys.stdout.buffer:
            self._ark.close()
        else:
            self._ark.flush()
        if self._scp is not None:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
