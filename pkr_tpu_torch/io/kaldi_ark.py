"""Kaldi ark/scp binary-format codecs, pure numpy.

A copy of ``pkr_tpu/io/kaldi_ark.py`` for the port, which imports nothing
of ``pkr_tpu``.  One change: an output pipe whose command exits before it
has read everything raises IOError with the command's exit code, also when
the flush at close loses the race to the exit (_PipeWriter).


Reimplements (from format semantics, not code) everything the reference stack
needs from Kaldi table I/O:

- rxspecifier resolution: ``ark:``/``scp:`` prefixes, ``path:offset`` seeks,
  ``cmd |`` input pipes and ``| cmd`` output pipes, gzip
  (reference behaviour: kaldi_io.py:41-107 of the reference stack)
- int32 vectors, float32/float64 vectors, ascii + binary
  (reference: kaldi_io.py:131-331)
- float matrices FM/DM, ascii + binary (reference: kaldi_io.py:333-424,464-499)
- the 'CM ' CompressedMatrix codec — BOTH directions.  The reference ships only
  a decoder (kaldi_io.py:427-460); the encoder here matches Kaldi's
  ``CompressedMatrix`` (format 1) so ``copy-feats --compress=true`` pipelines
  can be reproduced without any Kaldi C++ binary.
- text-format embedding "arks" (``utt  [ v1 v2 ... ]`` lines) as written by
  scripts/decode.py:202-206 and consumed by every scoring script.

Everything is vectorized; no per-element python loops on the hot paths.
"""

from __future__ import annotations

import gzip
import io
import os
import struct
import subprocess
from typing import BinaryIO, Dict, Iterator, Optional, Tuple

import numpy as np

_UINT16_SCALE = np.float32(1.0 / 65535.0)


# ---------------------------------------------------------------------------
# rxspecifier / wxspecifier handling
# ---------------------------------------------------------------------------


class _PipeReader(io.RawIOBase):
    """Wraps a subprocess stdout so closing it also reaps the process.

    A nonzero exit raises at close — a failed pipe command ('gunzip -c
    missing.gz |') must not look like an empty-but-valid archive (Kaldi's
    kaldi-io raises the same way)."""

    def __init__(self, cmd: str):
        self._cmd = cmd
        self._proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE)
        self._fd = self._proc.stdout
        self._eof = False

    def read(self, n: int = -1) -> bytes:
        out = self._fd.read(n)
        if not out:
            self._eof = True
        return out

    def readline(self) -> bytes:
        out = self._fd.readline()
        if not out:
            self._eof = True
        return out

    def readable(self) -> bool:
        return True

    def close(self) -> None:
        if not self.closed:
            self._fd.close()
            rc = self._proc.wait()
            super().close()
            # Raise only when WE consumed the stream to EOF: then a nonzero
            # exit means truncated/failed output (a failed command's empty
            # stdout hits EOF immediately).  A deliberately abandoned pipe
            # (partial ark read) must stay silent regardless of how the
            # producer reacts to the broken pipe (SIGPIPE, EPIPE rc=1, ...).
            if self._eof and rc not in (0, 141, -13):
                raise IOError(
                    f"input pipe command failed (rc={rc}): {self._cmd!r}")
        super().close()


class _PipeWriter(io.RawIOBase):
    def __init__(self, cmd: str):
        self._cmd = cmd
        self._proc = subprocess.Popen(cmd, shell=True, stdin=subprocess.PIPE)
        self._fd = self._proc.stdin
        self.mode = "wb"

    def write(self, b) -> int:
        try:
            return self._fd.write(b)
        except BrokenPipeError:
            self._fail()

    def writable(self) -> bool:
        return True

    def _fail(self) -> None:
        """The command stopped reading (it exited, or closed its input):
        reap it and raise with its exit code.  A command that exits 0
        without reading all of its input lost data all the same."""
        try:
            self._fd.close()  # closes the pipe even when its flush fails
        except BrokenPipeError:
            pass
        rc = self._proc.wait()
        super().close()
        raise IOError(f"output pipe command failed (rc={rc}, stopped reading its "
                      f"input): {self._cmd!r}")

    def close(self) -> None:
        if not self.closed:
            # the flush may find the command already gone: that race must
            # give the command's exit code, not a bare BrokenPipeError
            try:
                self._fd.close()
            except BrokenPipeError:
                self._fail()
            rc = self._proc.wait()
            super().close()
            if rc != 0:
                raise IOError(
                    f"output pipe command failed (rc={rc}): {self._cmd!r}")
        super().close()


def open_or_fd(file_or_fd, mode: str = "rb"):
    """Open an rx/wx-specifier: plain path, ``path:offset``, gzip, or pipe.

    Accepts an already-open file object and returns it unchanged (caller keeps
    ownership).  Understands the Kaldi conventions:

    - ``ark:...`` / ``scp:...`` prefixes (with optional ``o,``/``s,``/``cs,``
      / ``t,``/``b,`` option letters) are stripped;
    - trailing ``|`` → input pipe, leading ``|`` → output pipe;
    - ``file.ark:12345`` → open and seek to byte offset 12345;
    - ``*.gz`` → gzip stream.
    """
    if not isinstance(file_or_fd, str):
        return file_or_fd
    spec = file_or_fd
    # strip "ark"/"scp" (+ option letters) prefix, e.g. "ark,t:" "scp,o,cs:"
    head, sep, rest = spec.partition(":")
    if sep and head.split(",")[0] in ("ark", "scp"):
        spec = rest
    if mode.startswith("r"):
        if spec.endswith("|"):
            return _PipeReader(spec[:-1].strip())
        path, offset = _split_offset(spec)
        if path.endswith(".gz"):
            fd = gzip.open(path, "rb")
        else:
            fd = open(path, "rb")
        if offset is not None:
            fd.seek(offset)
        return fd
    else:
        if spec.startswith("|"):
            return _PipeWriter(spec[1:].strip())
        if spec.endswith(".gz"):
            return gzip.open(spec, mode)
        return open(spec, mode)


def _split_offset(spec: str) -> Tuple[str, Optional[int]]:
    # "file.ark:12345" → ("file.ark", 12345); robust to ':' in dir names.
    head, sep, tail = spec.rpartition(":")
    if sep and tail.isdigit() and head:
        return head, int(tail)
    return spec, None


def read_key(fd: BinaryIO) -> str:
    """Read a whitespace-terminated utterance key; '' at EOF."""
    chars = []
    while True:
        c = fd.read(1)
        if c in (b"", b" ", b"\t", b"\n"):
            break
        chars.append(c)
    key = b"".join(chars).decode("latin1").strip()
    return key


# ---------------------------------------------------------------------------
# int32 vectors
# ---------------------------------------------------------------------------


def read_vec_int(file_or_fd) -> np.ndarray:
    fd = open_or_fd(file_or_fd)
    try:
        head = fd.read(2)
        if head == b"\x00B":
            assert fd.read(1) == b"\x04"
            (n,) = struct.unpack("<i", fd.read(4))
            if n == 0:
                return np.empty(0, dtype=np.int32)
            # each element is stored as (int8 size-tag=4, int32 value)
            raw = np.frombuffer(fd.read(5 * n), dtype=[("t", "i1"), ("v", "<i4")])
            assert (raw["t"] == 4).all(), "corrupt int-vector"
            return raw["v"].astype(np.int32)
        # ascii
        line = (head + fd.readline()).decode()
        toks = [t for t in line.split() if t not in ("[", "]")]
        return np.array(toks, dtype=np.int32)
    finally:
        if fd is not file_or_fd:
            fd.close()


def write_vec_int(file_or_fd, v: np.ndarray, key: str = "") -> None:
    """Write one int vector.

    Open-mode contract (shared by write_vec_flt/write_mat/write_post):
    a KEYED write to a path APPENDS — the ark-building idiom is repeated
    calls against one growing file, so callers that rerun a script over the
    same output path must remove/truncate the file first (or pass an fd they
    opened themselves, which is used as-is); a keyless write to a path
    TRUNCATES, since a single-object file accumulating stale copies would be
    read back as the FIRST (stale) object forever.
    """
    fd = open_or_fd(file_or_fd, "ab" if key else "wb")
    try:
        if key:
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\x00B\x04")
        fd.write(struct.pack("<i", len(v)))
        out = np.empty(len(v), dtype=[("t", "i1"), ("v", "<i4")])
        out["t"] = 4
        out["v"] = np.asarray(v, dtype=np.int32)
        fd.write(out.tobytes())
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_vec_int_ark(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = read_key(fd)
            if not key:
                return
            yield key, read_vec_int(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


# ---------------------------------------------------------------------------
# float vectors
# ---------------------------------------------------------------------------


def read_vec_flt(file_or_fd) -> np.ndarray:
    fd = open_or_fd(file_or_fd)
    try:
        head = fd.read(2)
        if head == b"\x00B":
            token = fd.read(3)
            if token == b"FV ":
                dtype, size = np.float32, 4
            elif token == b"DV ":
                dtype, size = np.float64, 8
            else:
                raise ValueError(f"unknown vector header {token!r}")
            assert fd.read(1) == b"\x04"
            (n,) = struct.unpack("<i", fd.read(4))
            return np.frombuffer(fd.read(n * size), dtype=dtype).copy()
        line = (head + fd.readline()).decode()
        toks = [t for t in line.split() if t not in ("[", "]")]
        return np.array(toks, dtype=np.float32)
    finally:
        if fd is not file_or_fd:
            fd.close()


def write_vec_flt(file_or_fd, v: np.ndarray, key: str = "") -> None:
    v = np.asarray(v)
    if v.dtype == np.float64:
        token = b"DV "
    else:
        v = v.astype(np.float32)
        token = b"FV "
    fd = open_or_fd(file_or_fd, "ab" if key else "wb")  # see write_vec_int
    try:
        if key:
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\x00B" + token + b"\x04")
        fd.write(struct.pack("<i", v.shape[0]))
        fd.write(v.tobytes())
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_vec_flt_ark(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = read_key(fd)
            if not key:
                return
            yield key, read_vec_flt(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_vec_flt_scp(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        for line in fd:
            key, rx = line.decode().strip().split(None, 1)
            yield key, read_vec_flt(rx)
    finally:
        if fd is not file_or_fd:
            fd.close()


# ---------------------------------------------------------------------------
# float matrices (FM / DM / CM)
# ---------------------------------------------------------------------------


def read_mat(file_or_fd) -> np.ndarray:
    fd = open_or_fd(file_or_fd)
    try:
        head = fd.read(2)
        if head == b"\x00B":
            return _read_mat_binary(fd)
        assert head == b" [", f"bad matrix start {head!r}"
        return _read_mat_ascii(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_mat_dims(file_or_fd) -> Tuple[int, int]:
    """(rows, cols) from the header only — no payload decode.  Binary FM/DM/
    CM read ~20 bytes; ascii matrices fall back to a full read (rare: the
    feature plane writes binary)."""
    fd = open_or_fd(file_or_fd)
    try:
        head = fd.read(2)
        if head != b"\x00B":
            assert head == b" [", f"bad matrix start {head!r}"
            m = _read_mat_ascii(fd)
            return m.shape
        token = fd.read(3)
        if token.startswith(b"CM"):
            if token in (b"CM2", b"CM3"):
                sp = fd.read(1)  # not inside assert: the read must survive -O
                if sp != b" ":
                    raise ValueError(f"malformed {token!r} token")
            elif token != b"CM ":
                raise ValueError(f"unsupported compression {token!r}")
            _, _, rows, cols = struct.unpack("<ffii", fd.read(16))
            return rows, cols
        if token in (b"FM ", b"DM "):
            t1, rows, t2, cols = struct.unpack("<bibi", fd.read(10))
            assert t1 == 4 and t2 == 4
            return rows, cols
        raise ValueError(f"unknown matrix header {token!r}")
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_mat_codes(file_or_fd):
    """Raw CompressedMatrix format-1 payload WITHOUT dequantizing:
    (codes (rows, cols) uint8 row-major, pct (4, cols) float32), or None if
    the entry is not binary 'CM ' format 1 (FM/DM/CM2/CM3/ascii).

    This is the quantized-transport read for embedding extraction: shipping
    the uint8 codes + tiny percentile tables to the device and running
    ``data.device_cache.dequantize`` there (the same 3-piece f32 formula as
    ``_chars_to_floats``, so values are bit-identical to read_mat) moves
    4× fewer feature bytes across the host↔device link than float32 and
    2× fewer than the bf16 transfer cast.  The reference has no analog —
    its decode.py reads fully-decoded float tensors (kaldi_io.py:427-460).
    """
    fd = open_or_fd(file_or_fd)
    try:
        head = fd.read(2)
        if head != b"\x00B":
            return None
        token = fd.read(3)
        if token != b"CM ":
            return None
        data, pct = _read_cm1_payload(fd)
        return np.ascontiguousarray(data.T), np.ascontiguousarray(pct.T)
    finally:
        if fd is not file_or_fd:
            fd.close()


def _read_cm1_payload(fd: BinaryIO) -> Tuple[np.ndarray, np.ndarray]:
    """Format-1 payload after the 'CM ' token: (data (cols, rows) uint8,
    pct (cols, 4) f32).  The ONLY format-1 header/percentile parser —
    shared by decompress_matrix and read_mat_codes so the bit-identical
    guarantee between the float and quantized-transport reads can never
    drift (same factoring rationale as cm_quantize_columns)."""
    gmin, grange, rows, cols = struct.unpack("<ffii", fd.read(16))
    headers = np.frombuffer(fd.read(8 * cols), dtype="<u2").reshape(cols, 4)
    pct = gmin + grange * _UINT16_SCALE * headers.astype(np.float32)
    data = np.frombuffer(fd.read(rows * cols),
                         dtype=np.uint8).reshape(cols, rows)
    return data, pct


def _read_mat_binary(fd: BinaryIO) -> np.ndarray:
    token = fd.read(3)
    if token.startswith(b"CM"):
        return decompress_matrix(fd, token)
    if token == b"FM ":
        dtype, size = np.float32, 4
    elif token == b"DM ":
        dtype, size = np.float64, 8
    else:
        raise ValueError(f"unknown matrix header {token!r}")
    t1, rows, t2, cols = struct.unpack("<bibi", fd.read(10))
    assert t1 == 4 and t2 == 4
    buf = fd.read(rows * cols * size)
    return np.frombuffer(buf, dtype=dtype).reshape(rows, cols).copy()


def _read_mat_ascii(fd: BinaryIO) -> np.ndarray:
    rows = []
    while True:
        line = fd.readline().decode()
        if not line:
            raise EOFError("unterminated ascii matrix")
        toks = line.split()
        if not toks:
            continue
        if toks[-1] == "]":
            rows.append(np.array(toks[:-1], dtype=np.float32))
            return np.vstack(rows)
        rows.append(np.array(toks, dtype=np.float32))


def write_mat(file_or_fd, m: np.ndarray, key: str = "", compress: bool = False,
              text: bool = False) -> None:
    """Write a Kaldi matrix; ``compress=True`` emits 'CM ' format (the
    on-disk format produced by ``copy-feats --compress=true``,
    make_fbank.sh:107); ``text=True`` writes the ascii 'ark,t' form."""
    m = np.asarray(m)
    assert m.ndim == 2
    # keyed → append (ark building by repeated calls); bare → truncate, or
    # re-running a script that writes one matrix to a fixed path would read
    # back the FIRST (stale) copy forever
    fd = open_or_fd(file_or_fd, "ab" if key else "wb")
    try:
        if text:
            lines = [f"{key}  [" if key else " ["]
            for row in m:
                lines.append("  " + " ".join(repr(float(v)) for v in row))
            lines[-1] += " ]"
            fd.write(("\n".join(lines) + "\n").encode())
            return
        if key:
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\x00B")
        if compress:
            fd.write(compress_matrix(m.astype(np.float32)))
            return
        if m.dtype == np.float64:
            fd.write(b"DM ")
        else:
            m = m.astype(np.float32)
            fd.write(b"FM ")
        fd.write(struct.pack("<bibi", 4, m.shape[0], 4, m.shape[1]))
        fd.write(m.tobytes())
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_mat_ark(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = read_key(fd)
            if not key:
                return
            yield key, read_mat(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_mat_scp(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        for line in fd:
            key, rx = line.decode().strip().split(None, 1)
            yield key, read_mat(rx)
    finally:
        if fd is not file_or_fd:
            fd.close()


class ArkScpWriter:
    """Paired ark+scp writer, the ``ark,scp:feat.ark,feat.scp`` idiom used by
    every Kaldi feature job (make_fbank.sh:120-124)."""

    def __init__(self, ark_path: str, scp_path: Optional[str] = None, compress: bool = False):
        self.ark_path = os.path.abspath(ark_path)
        self._ark = open(ark_path, "wb")
        self._scp = open(scp_path, "w") if scp_path else None
        self._compress = compress

    def write(self, key: str, array: np.ndarray) -> None:
        self._ark.write((key + " ").encode("latin1"))
        offset = self._ark.tell()
        self._ark.write(b"\x00B")
        arr = np.asarray(array)
        if arr.ndim == 2:
            if self._compress:
                self._ark.write(compress_matrix(arr.astype(np.float32)))
            else:
                arr = arr.astype(np.float32)
                self._ark.write(b"FM ")
                self._ark.write(struct.pack("<bibi", 4, arr.shape[0], 4, arr.shape[1]))
                self._ark.write(arr.tobytes())
        elif arr.ndim == 1:
            arr = arr.astype(np.float32)
            self._ark.write(b"FV \x04")
            self._ark.write(struct.pack("<i", arr.shape[0]))
            self._ark.write(arr.tobytes())
        else:
            raise ValueError("only 1-D/2-D arrays")
        if self._scp is not None:
            self._scp.write(f"{key} {self.ark_path}:{offset}\n")

    def close(self) -> None:
        self._ark.close()
        if self._scp is not None:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_ark_scp(ark_path: str, scp_path: Optional[str] = None, compress: bool = False) -> ArkScpWriter:
    return ArkScpWriter(ark_path, scp_path, compress=compress)


# ---------------------------------------------------------------------------
# CompressedMatrix ('CM ') codec
# ---------------------------------------------------------------------------


def decompress_matrix(fd: BinaryIO, token: bytes = b"CM ") -> np.ndarray:
    """Decode Kaldi CompressedMatrix formats 1 ('CM '), 2 ('CM2 ') and
    3 ('CM3 ').

    Format 1 (compressed-matrix.h kOneByteWithColHeaders): global header
    {min float32, range float32, rows int32, cols int32}, then per-COLUMN
    headers of 4 uint16 percentile codes, then uint8 data stored
    column-major; dequantization is a 3-piece linear map through the
    0/25/75/100 percentiles.  (decoder parity target:
    the reference stack's kaldi_io.py:427-460)

    Formats 2/3 (kTwoByte*/kOneByte*): same global header, then ROW-major
    elementwise uint16 (2) or uint8 (3) codes with a single linear map
    min + range·code/65535 (resp. /255).  Kaldi's kAutomaticMethod emits
    format 2 for matrices with ≤ 8 rows, so short segments in foreign arks
    hit this path (the reference's reader lacked it and hard-failed).
    """
    if token in (b"CM2", b"CM3"):
        # tokens on disk are 'CM2 '/'CM3 ' (WriteToken appends the space);
        # the read stays outside the check so python -O cannot strip it
        sp = fd.read(1)
        if sp != b" ":
            raise ValueError(f"malformed {token!r} token")
        gmin, grange, rows, cols = struct.unpack("<ffii", fd.read(16))
        if token == b"CM2":
            data = np.frombuffer(fd.read(2 * rows * cols),
                                 dtype="<u2").reshape(rows, cols)
            return (np.float32(gmin)
                    + np.float32(grange) * _UINT16_SCALE
                    * data.astype(np.float32))
        data = np.frombuffer(fd.read(rows * cols),
                             dtype=np.uint8).reshape(rows, cols)
        return (np.float32(gmin)
                + np.float32(grange) * np.float32(1.0 / 255.0)
                * data.astype(np.float32))
    if token != b"CM ":
        raise ValueError(f"unsupported compressed format {token!r}")
    data, pct = _read_cm1_payload(fd)
    return _chars_to_floats(data, pct).T.copy()


def _chars_to_floats(data: np.ndarray, pct: np.ndarray) -> np.ndarray:
    """uint8 (cols, rows) + per-col percentiles (cols, 4) → float32 (cols, rows)."""
    p0 = pct[:, 0:1]
    p25 = pct[:, 1:2]
    p75 = pct[:, 2:3]
    p100 = pct[:, 3:4]
    d = data.astype(np.float32)
    low = p0 + (p25 - p0) * (d * np.float32(1.0 / 64.0))
    mid = p25 + (p75 - p25) * ((d - 64.0) * np.float32(1.0 / 128.0))
    high = p75 + (p100 - p75) * ((d - 192.0) * np.float32(1.0 / 63.0))
    out = np.where(data <= 64, low, np.where(data <= 192, mid, high))
    return out.astype(np.float32)


def _float_to_uint16(values: np.ndarray, gmin: float, grange: float) -> np.ndarray:
    f = (values - gmin) / grange
    f = np.clip(f, 0.0, 1.0)
    return np.floor(f * 65535.0 + 0.499).astype(np.uint16)


def cm_quantize_columns(colmaj: np.ndarray, gmin: float, grange: float
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The CompressedMatrix format-1 per-column quantizer, shared by the
    on-disk codec and the card-resident feature cache (data/device_cache) so the two
    can never diverge.

    colmaj: (cols, rows) float32.  Returns (codes_u16 (cols, 4) '<u2',
    pct (cols, 4) f32 percentile values, data (cols, rows) uint8).

    Anchor selection mirrors CompressedMatrix::ComputeColHeader: with n
    rows and q = n//4 the order statistics at ranks 0, q, 3q, n-1 (n >= 5),
    monotonicity enforced between the four uint16 codes; uint8 quantization
    is the 3-piece inverse of ``_chars_to_floats`` with round-half-up."""
    cols, rows = colmaj.shape
    srt = np.sort(colmaj, axis=1)
    if rows >= 5:
        q = rows // 4
        anchors = srt[:, [0, q, 3 * q, rows - 1]]
    else:
        anchors = (srt[:, [0, 0, rows - 1, rows - 1]] if rows > 0
                   else np.zeros((cols, 4), np.float32))
    codes = _float_to_uint16(anchors, gmin, grange).astype(np.int64)
    # enforce strictly increasing codes with headroom, as Kaldi does
    codes[:, 0] = np.minimum(codes[:, 0], 65532)
    codes[:, 1] = np.clip(codes[:, 1], codes[:, 0] + 1, 65533)
    codes[:, 2] = np.clip(codes[:, 2], codes[:, 1] + 1, 65534)
    codes[:, 3] = np.maximum(codes[:, 3], codes[:, 2] + 1)
    codes_u16 = codes.astype("<u2")
    pct = gmin + grange * _UINT16_SCALE * codes_u16.astype(np.float32)

    p0 = pct[:, 0:1]
    p25 = pct[:, 1:2]
    p75 = pct[:, 2:3]
    p100 = pct[:, 3:4]
    v = colmaj
    low = np.clip(np.floor((v - p0) / np.maximum(p25 - p0, 1e-20) * 64.0 + 0.5), 0, 64)
    mid = np.clip(np.floor((v - p25) / np.maximum(p75 - p25, 1e-20) * 128.0 + 64.5), 64, 192)
    high = np.clip(np.floor((v - p75) / np.maximum(p100 - p75, 1e-20) * 63.0 + 192.5), 192, 255)
    data = np.where(v < p25, low, np.where(v < p75, mid, high)).astype(np.uint8)
    return codes_u16, pct.astype(np.float32), data


def compress_matrix(mat: np.ndarray, method: Optional[int] = None,
                    use_native: bool = False) -> bytes:
    """Encode float32 matrix as Kaldi CompressedMatrix bytes (including the
    'CM '/'CM2 '/'CM3 ' token, excluding the '\\0B' binary flag).

    method: 1 = kOneByteWithColHeaders (the copy-feats --compress choice
    for tall matrices), 2 = kTwoByte, 3 = kOneByte; None follows Kaldi's
    kAutomaticMethod — format 2 for ≤ 8-row matrices (whose percentile
    headers would dominate / degenerate), format 1 otherwise.  Codes follow
    Kaldi's FloatToUint16/FloatToUint8: floor(f·N + 0.499) on the clipped
    [0,1] normalized value.

    A bit-identical native encoder exists (native/pkr_ark.cpp
    pkr_compress_matrix, cross-validated in tests/test_native.py) but the
    numpy path below is the DEFAULT: measured head-to-head on this host
    (600×40 f32, quiet window) numpy encodes in 0.53 ms vs 0.76 ms for the
    C++ path — numpy 2.x's SIMD column sort and vectorized 3-piece select
    beat a scalar loop, and matching them in C++ would need hand-written
    AVX for no pipeline-level win (stage-1 is dispatch-bound, not
    encode-bound; docs/architecture.md).  use_native=True opts in, e.g. on
    hosts whose numpy lacks SIMD sorts."""
    mat = np.asarray(mat, dtype=np.float32)
    rows, cols = mat.shape
    if mat.size and not np.isfinite(mat).all():
        # Non-finite degradation contract (the native encoder refuses such
        # input with -6 and lands here): quantization needs a finite range,
        # so clamp ±inf to the finite min/max and map NaN to the finite min
        # (code 0).  Without this, gmin/grange go NaN and every downstream
        # subtract/cast is a RuntimeWarning with platform-defined output.
        finite = mat[np.isfinite(mat)]
        lo = float(finite.min()) if finite.size else 0.0
        hi = float(finite.max()) if finite.size else 0.0
        mat = np.nan_to_num(mat, nan=lo, posinf=hi, neginf=lo)
    if method is None:
        method = 2 if rows <= 8 else 1
    if use_native:
        from pkr_tpu_torch.io.native import native_compress

        enc = native_compress(mat, method)
        if enc is not None:
            return enc
    gmin = float(mat.min()) if mat.size else 0.0
    grange = float(mat.max()) - gmin if mat.size else 1.0
    if grange <= 0.0:
        grange = 1.0

    out = bytearray()
    if method == 2:
        out += b"CM2 "
        out += struct.pack("<ffii", gmin, grange, rows, cols)
        out += _float_to_uint16(mat, gmin, grange).astype("<u2").tobytes()
        return bytes(out)
    if method == 3:
        out += b"CM3 "
        out += struct.pack("<ffii", gmin, grange, rows, cols)
        f = np.clip((mat - gmin) / grange, 0.0, 1.0)
        out += np.floor(f * 255.0 + 0.499).astype(np.uint8).tobytes()
        return bytes(out)

    colmaj = np.ascontiguousarray(mat.T)  # (cols, rows)
    codes_u16, _, data = cm_quantize_columns(colmaj, gmin, grange)

    out += b"CM "
    out += struct.pack("<ffii", gmin, grange, rows, cols)
    out += codes_u16.tobytes()
    out += data.tobytes()
    return bytes(out)


# ---------------------------------------------------------------------------
# text-format embedding "arks"  (utt  [ v1 v2 ... ])
# ---------------------------------------------------------------------------


def read_text_vec_ark(path) -> Iterator[Tuple[str, np.ndarray]]:
    """Read ``utt  [ v1 ... vn ]`` lines (extractor output format,
    decode.py:202-206)."""
    fd = open_or_fd(path)
    opened = fd is not path
    try:
        for raw in fd:
            line = raw.decode() if isinstance(raw, bytes) else raw
            toks = line.split()
            if not toks:
                continue
            key = toks[0]
            vals = [t for t in toks[1:] if t not in ("[", "]")]
            yield key, np.array(vals, dtype=np.float32)
    finally:
        if opened:
            fd.close()


def write_text_vec_ark(path, items: Dict[str, np.ndarray] | Iterator[Tuple[str, np.ndarray]]) -> None:
    it = items.items() if isinstance(items, dict) else items
    with open(path, "w") as f:
        for key, vec in it:
            body = " ".join(str(float(x)) for x in np.asarray(vec).ravel())
            f.write(f"{key}  [ {body} ]\n")


def load_text_vec_ark(path) -> Dict[str, np.ndarray]:
    """Load a text embedding ark; a base path whose file is absent but has
    per-process shards '<path>.0', '<path>.1', ... (multi-host run_extract
    output) loads and merges the shards."""
    if isinstance(path, str) and not os.path.exists(path):
        out: Dict[str, np.ndarray] = {}
        i = 0
        while os.path.exists(f"{path}.{i}"):
            out.update(read_text_vec_ark(f"{path}.{i}"))
            i += 1
        if i:
            return out
    return {k: v for k, v in read_text_vec_ark(path)}


# ---------------------------------------------------------------------------
# 'Posterior' type: vector<vector<pair<int32, float>>> (time-major), plus the
# confusion-network-time variant and segments→frame-mask conversion
# (reference surface: kaldi_io.py:510-679; ASR-side utilities kept for full
# kaldi_io API coverage)
# ---------------------------------------------------------------------------


def read_post(file_or_fd) -> list:
    """Read one binary Kaldi Posterior: [[(id, weight), ...] per frame]."""
    fd = open_or_fd(file_or_fd)
    try:
        flag = fd.read(2)
        assert flag == b"\x00B", f"bad posterior start {flag!r}"
        assert fd.read(1) == b"\x04"
        (n_frames,) = struct.unpack("<i", fd.read(4))
        out = []
        for _ in range(n_frames):
            assert fd.read(1) == b"\x04"
            (n_rec,) = struct.unpack("<i", fd.read(4))
            if n_rec == 0:
                out.append([])
                continue
            raw = np.frombuffer(fd.read(10 * n_rec),
                                dtype=[("ti", "i1"), ("id", "<i4"),
                                       ("tf", "i1"), ("w", "<f4")])
            assert (raw["ti"] == 4).all() and (raw["tf"] == 4).all()
            out.append(list(zip(raw["id"].tolist(), raw["w"].tolist())))
        return out
    finally:
        if fd is not file_or_fd:
            fd.close()


def write_post(file_or_fd, post: list, key: str = "") -> None:
    """Write a binary Kaldi Posterior (inverse of read_post)."""
    fd = open_or_fd(file_or_fd, "ab" if key else "wb")  # see write_vec_int
    try:
        if key:
            fd.write((key + " ").encode("latin1"))
        fd.write(b"\x00B\x04")
        fd.write(struct.pack("<i", len(post)))
        for frame in post:
            fd.write(b"\x04")
            fd.write(struct.pack("<i", len(frame)))
            for idx, w in frame:
                fd.write(b"\x04" + struct.pack("<i", int(idx)))
                fd.write(b"\x04" + struct.pack("<f", float(w)))
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_post_ark(file_or_fd) -> Iterator[Tuple[str, list]]:
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = read_key(fd)
            if not key:
                return
            yield key, read_post(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_cnet_ark(file_or_fd) -> Iterator[Tuple[str, list]]:
    """Confusion networks with times: [[(time, [(id, w), ...])...]] — the
    cntime format (kaldi_io.py:605-659 surface)."""
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = read_key(fd)
            if not key:
                return
            flag = fd.read(2)
            assert flag == b"\x00B"
            assert fd.read(1) == b"\x04"
            (n_bins,) = struct.unpack("<i", fd.read(4))
            cnet = []
            for _ in range(n_bins):
                assert fd.read(1) == b"\x04"
                (t,) = struct.unpack("<i", fd.read(4))
                assert fd.read(1) == b"\x04"
                (n_rec,) = struct.unpack("<i", fd.read(4))
                recs = []
                for _ in range(n_rec):
                    assert fd.read(1) == b"\x04"
                    (idx,) = struct.unpack("<i", fd.read(4))
                    assert fd.read(1) == b"\x04"
                    (w,) = struct.unpack("<f", fd.read(4))
                    recs.append((idx, w))
                cnet.append((t, recs))
            yield key, cnet
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_segments_as_bool_vec(segments_path: str, frame_shift: float = 0.01
                              ) -> np.ndarray:
    """Segments file (one recording) → per-frame bool voiced mask
    (kaldi_io.py:661-679 semantics: all lines must share the recording)."""
    segs = []
    rec = None
    for line in open(segments_path):
        parts = line.split()
        if len(parts) != 4:
            continue
        _, r, start, end = parts
        if rec is None:
            rec = r
        assert r == rec, "segments file spans multiple recordings"
        segs.append((float(start), float(end)))
    if not segs:
        return np.zeros(0, dtype=bool)
    n = int(round(max(e for _, e in segs) / frame_shift))
    out = np.zeros(n, dtype=bool)
    for s, e in segs:
        out[int(round(s / frame_shift)):int(round(e / frame_shift))] = True
    return out
