"""Chunk-blob compression: pluggable codecs + byte-shuffle for part files.

The paper's headline claim is *space* efficiency of tensor storage in Delta
Lake, yet until this module every chunk blob landed as raw bytes. Following
TStore (tensor-centric compression for model hubs) and Deep Lake (chunked,
compressed lakehouse layout), compression here is **per part file** with a
tensor-aware filter in front of a general-purpose codec:

* a **codec registry** — stdlib-first (``zlib``, ``lzma``, ``none``) with
  ``zstd`` / ``lz4`` registered automatically when their packages are
  importable (the container does not bake them in, so they are optional);
* a **byte-shuffle filter** for fixed-width dtypes: the bytes of a float32
  stream are transposed from ``[b0 b1 b2 b3][b0 b1 b2 b3]...`` to
  ``[b0 b0 ...][b1 b1 ...]...`` so the low-entropy exponent/sign bytes of
  neighboring values become long runs a byte-level codec crushes (the HDF5
  shuffle filter / Blosc trick). Shuffle is a pure permutation — applying
  it with any itemsize is always reversible, so correctness never depends
  on guessing the dtype right;
* a tiny **frame format** wrapping compressed part files:

      frame := magic "PQZ1" | u32 header_len | header JSON | payload

  The header records ``codec``, ``shuffle``, ``itemsize`` and ``raw_size``,
  so a reader needs nothing but the bytes themselves to decode. Files that
  do not start with the magic are passed through untouched — which is the
  whole back-compat story: pre-compression tables (parq-lite ``PQL1``
  files) and JSON metadata read back byte-identically with zero probes.

Where it hooks in: ``DeltaTable.append(compression=...)`` frames data files
at write time (recording codec + raw/encoded sizes in the add-action), the
shared :class:`~repro_torch.lake.io.ReadExecutor` unframes on fetch (so the block
cache stores *decoded* blocks and repeat reads never pay decode twice), and
``DeltaTable.compact(recompress=...)`` rewrites existing files under a new
codec — the migration path for old tables (``repro.launch.gc
--recompress``). Bytes-over-wire are charged by the object store at the
*stored* (compressed) size, so the modeled
:class:`~repro_torch.lake.object_store.LatencyModel` shows the bandwidth win
honestly.

Spec strings name a codec, an optional per-codec level, and the optional
filter: ``"zlib"``, ``"zlib:9+shuffle"``, ``"lzma+shuffle"``, ``"none"``.
Parse with :func:`parse_compression`; list what this process supports with
:func:`available_codecs`.

Frames can additionally be **delta frames** (the TStore variant-storage
trick): :func:`encode_frame` accepts a :class:`DeltaBase` — the decoded
bytes of an already-stored base object — and XORs the new bytes against it
*before* shuffle + codec, recording ``delta_base`` (the base's absolute
object key) and ``delta_base_hash`` in the header. A fine-tuned variant
that perturbs a few percent of a base tensor XORs to long zero runs that
any byte codec crushes. :func:`decode_frame` reverses this given a
``base_fetch`` callback supplying the base's decoded bytes.
"""

from __future__ import annotations

import json
import lzma
import struct
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

# Byte buffers on the decode path are bytes on the wire but memoryviews once
# zero-copy filters have run; every consumer accepts either.
Buffer = Union[bytes, bytearray, memoryview]

FRAME_MAGIC = b"PQZ1"

SHUFFLE_SUFFIX = "+shuffle"


class UnknownCodecError(KeyError):
    """Raised for a compression spec naming a codec this process lacks."""


@dataclass(frozen=True)
class Compressor:
    """One registered blob codec: a name and its (de)compress callables.

    ``compress_level`` (optional) compresses at an explicit effort level —
    codecs without it reject ``"<codec>:<level>"`` specs at parse time.
    ``levels`` is the inclusive ``(lo, hi)`` range ``compress_level``
    accepts. Levels only affect *encode* effort; ``decompress`` reads any
    level's output, which is what keeps ``recompress`` idempotent across
    levels of the same codec.
    """

    name: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]
    compress_level: Optional[Callable[[bytes, int], bytes]] = None
    levels: Optional[Tuple[int, int]] = None


_COMPRESSORS: Dict[str, Compressor] = {}


def register_compressor(name: str, compress: Callable[[bytes], bytes],
                        decompress: Callable[[bytes], bytes], *,
                        compress_level: Optional[
                            Callable[[bytes, int], bytes]] = None,
                        levels: Optional[Tuple[int, int]] = None) -> Compressor:
    """Register a blob codec under ``name`` (later wins; returns it).

    Codecs must be bijective on bytes: ``decompress(compress(b)) == b``
    for every input (at every supported level). Registration is
    process-wide.
    """
    comp = Compressor(name=name, compress=compress, decompress=decompress,
                      compress_level=compress_level, levels=levels)
    _COMPRESSORS[name] = comp
    return comp


def get_compressor(name: str) -> Compressor:
    """The registered codec for ``name``; raises :class:`UnknownCodecError`.

    The error message lists what IS available, so a table compressed with
    an optional codec (e.g. zstd) read by a process without that package
    fails with an actionable message instead of a bare KeyError.
    """
    try:
        return _COMPRESSORS[name]
    except KeyError:
        raise UnknownCodecError(
            f"unknown compression codec {name!r}; this process has "
            f"{sorted(_COMPRESSORS)}") from None


def available_codecs() -> List[str]:
    """Sorted codec names usable in this process (optional deps included
    only when importable)."""
    return sorted(_COMPRESSORS)


# -- builtin codecs ----------------------------------------------------------
# zlib level 3 is the measured sweet spot on shuffled float chunks (within
# ~3% of level 6's ratio at half the encode cost); lzma preset 1 trades
# ~4x slower encode for archival-grade ratios.

register_compressor("none", lambda b: b, lambda b: b)
register_compressor("zlib", lambda b: zlib.compress(b, 3), zlib.decompress,
                    compress_level=lambda b, lv: zlib.compress(b, lv),
                    levels=(0, 9))
register_compressor("lzma", lambda b: lzma.compress(b, preset=1),
                    lzma.decompress,
                    compress_level=lambda b, lv: lzma.compress(b, preset=lv),
                    levels=(0, 9))

try:  # optional: python-zstandard
    import zstandard as _zstd

    register_compressor(
        "zstd",
        lambda b: _zstd.ZstdCompressor(level=3).compress(b),
        lambda b: _zstd.ZstdDecompressor().decompress(b),
        compress_level=lambda b, lv: _zstd.ZstdCompressor(level=lv).compress(b),
        levels=(1, 22))
except ImportError:  # pragma: no cover - container lacks zstandard
    pass

try:  # optional: lz4
    import lz4.frame as _lz4f

    register_compressor(
        "lz4", _lz4f.compress, _lz4f.decompress,
        compress_level=lambda b, lv: _lz4f.compress(b, compression_level=lv),
        levels=(0, 16))
except ImportError:  # pragma: no cover - container lacks lz4
    pass


# -- byte shuffle ------------------------------------------------------------

# Optional accelerator for the unshuffle transpose (decode hot path). The
# hook takes the (itemsize, n) uint8 plane matrix and returns the
# (n, itemsize) item matrix as anything np.asarray accepts — installed by a
# DeltaTensorStore built for a CUDA device (repro_torch.kernels.unshuffle),
# absent everywhere else so the lake never imports torch just to decode.
_UNSHUFFLE_KERNEL: Optional[Callable[[np.ndarray], np.ndarray]] = None


def set_unshuffle_kernel(fn: Optional[Callable[[np.ndarray], np.ndarray]]) -> None:
    """Install (or clear, with None) the unshuffle plane-transpose kernel."""
    global _UNSHUFFLE_KERNEL
    _UNSHUFFLE_KERNEL = fn


def get_unshuffle_kernel() -> Optional[Callable[[np.ndarray], np.ndarray]]:
    return _UNSHUFFLE_KERNEL


def byte_shuffle(raw: Buffer, itemsize: int) -> Buffer:
    """Transpose ``raw`` viewed as ``(n, itemsize)`` bytes to group the
    i-th byte of every item together (HDF5/Blosc shuffle filter).

    A trailing remainder shorter than ``itemsize`` is appended unshuffled,
    so any buffer length round-trips. ``itemsize <= 1`` is the identity.
    Returns a memoryview over a single freshly-written buffer — one copy
    total, no intermediate ``bytes`` materialization.
    """
    itemsize = int(itemsize)
    if itemsize <= 1 or len(raw) < 2 * itemsize:
        return raw
    a = np.frombuffer(raw, dtype=np.uint8)
    n = (len(a) // itemsize) * itemsize
    out = np.empty(len(a), dtype=np.uint8)
    out[:n].reshape(itemsize, -1)[...] = a[:n].reshape(-1, itemsize).T
    out[n:] = a[n:]
    return out.data


def byte_unshuffle(raw: Buffer, itemsize: int) -> Buffer:
    """Exact inverse of :func:`byte_shuffle` for the same ``itemsize``.

    Decode hot path: the plane transpose lands directly in one output
    buffer (returned as a memoryview — zero-copy for downstream
    ``np.frombuffer`` consumers). When an accelerator kernel is installed
    via :func:`set_unshuffle_kernel` the transpose runs there instead of
    numpy.
    """
    itemsize = int(itemsize)
    if itemsize <= 1 or len(raw) < 2 * itemsize:
        return raw
    a = np.frombuffer(raw, dtype=np.uint8)
    n = (len(a) // itemsize) * itemsize
    out = np.empty(len(a), dtype=np.uint8)
    planes = a[:n].reshape(itemsize, -1)
    kern = _UNSHUFFLE_KERNEL
    if kern is not None:
        out[:n] = np.asarray(kern(planes), dtype=np.uint8).reshape(-1)
    else:
        out[:n].reshape(-1, itemsize)[...] = planes.T
    out[n:] = a[n:]
    return out.data


# -- variant byte-delta ------------------------------------------------------


def byte_delta(new: Buffer, base: Buffer) -> Buffer:
    """XOR ``new`` against ``base`` byte-for-byte (TStore's variant trick).

    The output has ``len(new)`` exactly: the common prefix is XORed, any
    tail of ``new`` past ``len(base)`` is appended verbatim (written into
    the same single output buffer, returned as a memoryview). Because XOR
    is an involution, :func:`byte_undelta` is this same operation — and a
    variant that differs from its base in a few percent of values deltas
    to mostly zero bytes, which any codec then crushes.
    """
    n = min(len(new), len(base))
    if n == 0:
        return new
    a = np.frombuffer(new, dtype=np.uint8)
    b = np.frombuffer(base, dtype=np.uint8)
    out = np.empty(len(a), dtype=np.uint8)
    np.bitwise_xor(a[:n], b[:n], out=out[:n])
    out[n:] = a[n:]
    return out.data


def byte_undelta(delta: Buffer, base: Buffer) -> Buffer:
    """Exact inverse of :func:`byte_delta` given the same ``base``."""
    return byte_delta(delta, base)


@dataclass(frozen=True)
class DeltaBase:
    """The base object a delta frame diffs against.

    ``key`` is the base's *absolute* object-store key (self-describing:
    any reader of the frame can fetch it without catalog context);
    ``data`` its decoded bytes; ``content_hash`` the content address of
    those bytes (recorded so reconstruction can share the content cache
    and verify it got the right base).
    """

    key: str
    data: bytes
    content_hash: Optional[str] = None


# -- spec --------------------------------------------------------------------


@dataclass(frozen=True)
class CompressionSpec:
    """A parsed compression request: codec, optional level, shuffle flag.

    ``spec.id`` round-trips to the string form recorded in add-actions,
    store manifests, and frame headers (e.g. ``"zlib+shuffle"``,
    ``"zlib:9+shuffle"``). ``level=None`` means the codec's registered
    default effort.
    """

    codec: str = "none"
    shuffle: bool = False
    level: Optional[int] = None

    @property
    def id(self) -> str:
        """Canonical string form (``"<codec>[:<level>][+shuffle]"``)."""
        s = self.codec
        if self.level is not None:
            s += f":{self.level}"
        return s + (SHUFFLE_SUFFIX if self.shuffle else "")

    @property
    def active(self) -> bool:
        """Whether this spec asks for real encoding work.

        Requires a real codec: shuffle alone is never active — it cannot
        shrink anything by itself, while activating it would disable the
        legacy per-block compression and *grow* the store.
        """
        return self.codec != "none"


def _check_level(comp: Compressor, level: Optional[int]) -> None:
    """Validate an explicit level against the codec's registration."""
    if level is None:
        return
    if comp.name == "none" or comp.compress_level is None:
        raise ValueError(
            f"codec {comp.name!r} does not support compression levels")
    if comp.levels is not None and not (comp.levels[0] <= level
                                        <= comp.levels[1]):
        raise ValueError(
            f"level {level} outside {comp.name}'s supported range "
            f"{comp.levels[0]}..{comp.levels[1]}")


def parse_compression(
        spec: Union[None, str, CompressionSpec]) -> Optional[CompressionSpec]:
    """Normalize a user-facing ``compression=`` argument.

    Accepts ``None`` (no preference — caller falls back to its default),
    a :class:`CompressionSpec`, or a spec string like ``"zlib+shuffle"``
    or ``"zlib:9+shuffle"`` (``:<level>`` selects per-codec encode
    effort). Raises :class:`UnknownCodecError` for codecs this process
    lacks and ``ValueError`` for malformed strings or out-of-range
    levels.
    """
    if spec is None:
        return None
    if isinstance(spec, CompressionSpec):
        _check_level(get_compressor(spec.codec), spec.level)
        return spec
    if not isinstance(spec, str):
        raise ValueError(f"bad compression spec {spec!r}")
    s = spec.strip().lower()
    shuffle = s.endswith(SHUFFLE_SUFFIX)
    if shuffle:
        s = s[: -len(SHUFFLE_SUFFIX)]
    if not s or "+" in s:
        raise ValueError(f"bad compression spec {spec!r} "
                         f"(want '<codec>[:<level>]' or "
                         f"'<codec>[:<level>]+shuffle')")
    level: Optional[int] = None
    if ":" in s:
        s, _, lv = s.partition(":")
        if not s or not lv:
            raise ValueError(f"bad compression spec {spec!r} "
                             f"(want '<codec>[:<level>]')")
        try:
            level = int(lv)
        except ValueError:
            raise ValueError(f"bad compression level {lv!r} in spec "
                             f"{spec!r}") from None
    if s == "none" and shuffle:
        # shuffle without a codec can never shrink anything, but would
        # switch off the legacy per-block compression — a silent space
        # REGRESSION; refuse loudly rather than store it as a default
        raise ValueError("shuffle requires a real codec "
                         "(\"none+shuffle\" would only grow the store)")
    comp = get_compressor(s)  # fail fast on unknown codecs
    _check_level(comp, level)
    return CompressionSpec(codec=s, shuffle=shuffle, level=level)


# -- frame format ------------------------------------------------------------


def is_framed(data: Buffer) -> bool:
    """True when ``data`` starts with the compression frame magic."""
    return data[:4] == FRAME_MAGIC


def frame_info(data: Buffer) -> Optional[Dict[str, Any]]:
    """The frame header dict (codec/shuffle/itemsize/raw_size) or None
    for unframed bytes — cheap introspection without decompressing."""
    if not is_framed(data):
        return None
    (hlen,) = struct.unpack_from("<I", data, 4)
    return json.loads(bytes(data[8:8 + hlen]))


def encode_frame(raw: bytes, spec: CompressionSpec, *, itemsize: int = 1,
                 delta_base: Optional[DeltaBase] = None) -> Tuple[bytes, str]:
    """Compress ``raw`` under ``spec`` into a self-describing frame.

    ``itemsize`` drives the shuffle filter (the stored tensor's dtype
    width; 1 disables shuffling regardless of the spec). ``delta_base``
    turns this into a delta frame: ``raw`` is XORed against the base's
    decoded bytes *before* shuffle + codec, and the header records the
    base's object key (+ content hash) so decode can reconstruct.

    Returns ``(stored_bytes, codec_id)`` where ``codec_id`` is what
    actually happened: when the codec fails to shrink the payload the raw
    bytes are returned **unframed** under ``"none"`` — zero storage
    overhead, exact accounting (decode is uniform either way, since
    unframed bytes pass straight through :func:`decode_frame`). Delta
    frames never take the unframed fallback — the XORed payload is
    meaningless without the header pointing at its base.
    """
    shuffle = spec.shuffle and itemsize > 1
    body = raw
    doc: Dict[str, Any] = {"codec": spec.codec, "shuffle": shuffle,
                           "itemsize": int(itemsize) if shuffle else 1,
                           "raw_size": len(raw)}
    if spec.level is not None:
        doc["level"] = int(spec.level)
    if delta_base is not None:
        body = byte_delta(body, delta_base.data)
        doc["delta_base"] = delta_base.key
        if delta_base.content_hash:
            doc["delta_base_hash"] = delta_base.content_hash
    if shuffle:
        body = byte_shuffle(body, itemsize)
    comp = get_compressor(spec.codec)
    if spec.level is not None and comp.compress_level is not None:
        payload = comp.compress_level(body, int(spec.level))
    else:
        payload = comp.compress(body)
    header = json.dumps(doc, separators=(",", ":")).encode("utf-8")
    if delta_base is None and 8 + len(header) + len(payload) >= len(raw):
        return raw, "none"  # incompressible: store raw, unframed
    frame = b"".join([FRAME_MAGIC, struct.pack("<I", len(header)), header,
                      payload])
    return frame, CompressionSpec(codec=spec.codec, shuffle=shuffle,
                                  level=spec.level).id


def decode_frame(data: bytes, *,
                 base_fetch: Optional[Callable[[str, Optional[str]],
                                               bytes]] = None) -> bytes:
    """Undo :func:`encode_frame`; unframed bytes pass through untouched.

    This passthrough IS the back-compat contract: every pre-compression
    file (parq-lite ``PQL1``, JSON logs, spilled indexes) flows through
    the same read path unchanged, byte for byte.

    Delta frames need ``base_fetch(base_key, base_hash) -> bytes``
    supplying the base object's *decoded* bytes; decoding a delta frame
    without one raises ``ValueError`` (the payload alone is an XOR
    residue, not data).
    """
    info = frame_info(data)
    if info is None:
        return data
    (hlen,) = struct.unpack_from("<I", data, 4)
    payload = data[8 + hlen:]
    body = get_compressor(info["codec"]).decompress(payload)
    if info.get("shuffle"):
        body = byte_unshuffle(body, int(info.get("itemsize", 1)))
    if len(body) != int(info["raw_size"]):
        raise ValueError(
            f"frame decode size mismatch: got {len(body)} bytes, header "
            f"says {info['raw_size']}")
    base_key = info.get("delta_base")
    if base_key is not None:
        if base_fetch is None:
            raise ValueError(
                f"delta frame references base {base_key!r}; decoding "
                f"requires a base_fetch callback")
        body = byte_undelta(body, base_fetch(base_key,
                                             info.get("delta_base_hash")))
    return body
