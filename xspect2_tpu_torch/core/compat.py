"""XXH3 hash-family compatibility path (genus Bloom filter).

XspecT's genus model inserts the ASCII string of each canonical k-mer
into a Bloom filter keyed by ``xxh3_64_intdigest``.  This module is the
port's own copy of ``xspect2_tpu/core/compat.py`` and the caller of the
pinned XXH3-64 in :mod:`xspect2_tpu_torch.core.xxh3`:

1. :func:`ascii_from_packed` reconstructs the exact ASCII byte stream of
   each canonical k-mer from its packed 2-bit ``(hi, lo)`` words.
2. :func:`kmer_digests` hashes those byte rows with the vectorized
   XXH3-64.
3. :func:`derive_probe_positions` maps a digest to Bloom bit positions
   by Kirsch-Mitzenmacher double hashing over the 64-bit digest.

:class:`XXH3BloomFilter` packages these into a filter with host-side
insert (index build is a host job) and two device-side membership
counts: :meth:`XXH3BloomFilter.count_hits_batch`, the genus model's
path, hashes and tests on the card, per record of a prepared batch
(kernel K7, :func:`xspect2_tpu_torch.ops.bloom.xxh3_records_count`);
:meth:`XXH3BloomFilter.count_hits_device` keeps the JAX package's API:
the host hashes, :func:`xspect2_tpu_torch.ops.bloom.bloom_count` tests
the bits.  This is a verification and parity mode, not the throughput
path: the blocked bit-sliced index stays the default.

Ambiguous bases ('N'): the filter packs k-mers 2-bit and therefore
skips windows holding a non-ACGT base on BOTH insert and query, while
the denominator of a score still counts all windows, so a sequence with
an N scores below 1.0 against a filter trained on it.
"""

import json
import math
from pathlib import Path

import numpy as np
import torch

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.core.xxh3 import xxh3_64_batch
from xspect2_tpu_torch.ops.bloom import bloom_count, xxh3_records_count
from xspect2_tpu_torch.ops.query import PreparedBatch, restore_batch

# k-mer windows hashed per pass of insert_sequence: bounds the host
# memory of a whole-genome insert (the OR into the filter is order-free)
_INSERT_WINDOWS = 1 << 20

_U64 = np.uint64
_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def ascii_from_packed(hi: np.ndarray, lo: np.ndarray, k: int) -> np.ndarray:
    """ASCII bytes ``[n, k]`` of packed big-endian 2-bit k-mers.

    Inverts :func:`xspect2_tpu_torch.core.dna.pack_kmers`'s layout: ``lo``
    holds the last ``min(k, 16)`` bases, ``hi`` the leading ones.
    """
    if not 1 <= k <= 32:
        raise ValueError("k must be in [1, 32]")
    hi = np.asarray(hi, dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32)
    lo_bases = min(k, 16)
    hi_bases = k - lo_bases
    out = np.empty((len(hi), k), dtype=np.uint8)
    for j in range(hi_bases):
        shift = np.uint32(2 * (hi_bases - 1 - j))
        out[:, j] = dna.DECODE_LUT[(hi >> shift) & np.uint32(3)]
    for j in range(lo_bases):
        shift = np.uint32(2 * (lo_bases - 1 - j))
        out[:, hi_bases + j] = dna.DECODE_LUT[(lo >> shift) & np.uint32(3)]
    return out


def kmer_digests(hi: np.ndarray, lo: np.ndarray, k: int) -> np.ndarray:
    """XXH3-64 digests (uint64 ``[n]``) of the ASCII canonical k-mers.

    The bytes hashed are those of ``xxh3_64_intdigest(str(kmer))``.
    """
    return xxh3_64_batch(ascii_from_packed(hi, lo, k))


def derive_probe_positions(
    digests: np.ndarray, num_bits: int, num_hashes: int
) -> np.ndarray:
    """Bloom bit positions ``[n, num_hashes]`` from 64-bit digests.

    Kirsch-Mitzenmacher double hashing: ``pos_i = (h1 + i*h2) % m`` with
    ``h1`` the digest and ``h2`` an odd value mixed from its high bits.
    Self-consistent between insert and query.
    """
    d = np.asarray(digests, dtype=np.uint64)
    old = np.seterr(over="ignore")
    try:
        h2 = ((d >> _U64(33)) ^ (d << _U64(29))) | _U64(1)
        i = np.arange(num_hashes, dtype=np.uint64)
        pos = (d[:, None] + i[None, :] * h2[:, None]) % _U64(num_bits)
    finally:
        np.seterr(**old)
    return pos


def rbloom_geometry(num_items: int, fpr: float) -> tuple[int, int]:
    """(num_bits, num_hashes) the way ``Bloom(n, fpr)`` sizes itself.

    The classic optimum: ``m = -n ln p / (ln 2)^2`` bits and
    ``k = round(m/n * ln 2)`` probes (the genus model's own
    ``num_hashes=1`` attribute is metadata only).
    """
    n = max(1, int(num_items))
    m = max(64, int(math.ceil(-n * math.log(fpr) / (math.log(2.0) ** 2))))
    h = max(1, round(m / n * math.log(2.0)))
    return m, h


class XXH3BloomFilter:
    """Flat Bloom filter over XXH3-64 of ASCII canonical k-mers.

    Host insert + device membership count.  Words are uint32 so the
    device side tests bits with one read per probe.  ``device`` is where
    :meth:`count_hits_device` runs (``None`` means CUDA, resolved at the
    first count: building and saving a filter needs no device).
    """

    def __init__(self, num_bits: int, num_hashes: int, k: int, device=None) -> None:
        if num_bits <= 0 or num_hashes <= 0:
            raise ValueError("num_bits and num_hashes must be positive")
        if not 4 <= int(k) <= 32:
            # the vectorized XXH3 batch path covers input lengths 4..240
            # and the 2-bit packing tops out at 32 bases; fail at
            # construction with the k constraint, not at first insert
            # with an unrelated-sounding length error
            raise ValueError(
                f"XXH3BloomFilter supports 4 <= k <= 32, got k={k}"
            )
        self.num_bits = int(num_bits)
        self.num_hashes = int(num_hashes)
        self.k = int(k)
        self.words = np.zeros((self.num_bits + 31) // 32, dtype=np.uint32)
        self.device = device
        self._device_words = None  # the words on the device, as int32

    @classmethod
    def for_items(cls, num_items: int, fpr: float, k: int, device=None) -> "XXH3BloomFilter":
        bits, hashes = rbloom_geometry(num_items, fpr)
        return cls(bits, hashes, k, device)

    # ------------------------------------------------------------- build
    def insert_packed(
        self, hi: np.ndarray, lo: np.ndarray, valid: np.ndarray
    ) -> None:
        """Insert packed canonical k-mers (host side; invalid rows skipped)."""
        valid = np.asarray(valid, dtype=bool)
        if not valid.any():
            return
        pos = derive_probe_positions(
            kmer_digests(hi[valid], lo[valid], self.k),
            self.num_bits,
            self.num_hashes,
        ).ravel()
        np.bitwise_or.at(
            self.words,
            (pos >> _U64(5)).astype(np.int64),
            np.uint32(1) << (pos & _U64(31)).astype(np.uint32),
        )
        self._device_words = None

    def insert_sequence(self, seq: str | bytes) -> None:
        """Insert every canonical k-mer of ``seq``, a pass of at most
        ``_INSERT_WINDOWS`` windows at a time."""
        codes = dna.encode(seq)
        for start in range(0, max(1, len(codes) - self.k + 1), _INSERT_WINDOWS):
            part = codes[start : start + _INSERT_WINDOWS + self.k - 1]
            self.insert_packed(*dna.canonical_kmers(part, self.k))

    # ------------------------------------------------------------- query
    def _positions(self, hi, lo, valid):
        pos = np.zeros((len(hi), self.num_hashes), dtype=np.uint64)
        valid = np.asarray(valid, dtype=bool)
        if valid.any():
            pos[valid] = derive_probe_positions(
                kmer_digests(hi[valid], lo[valid], self.k),
                self.num_bits,
                self.num_hashes,
            )
        return pos

    def count_hits_host(self, hi, lo, valid) -> int:
        """Number of valid k-mers whose probe bits are all set (numpy)."""
        pos = self._positions(hi, lo, valid)
        bits = (
            self.words[(pos >> _U64(5)).astype(np.int64)]
            >> (pos & _U64(31)).astype(np.uint32)
        ) & np.uint32(1)
        return int(np.sum(bits.all(axis=1) & np.asarray(valid, dtype=bool)))

    def device_words(self) -> torch.Tensor:
        """The filter's words on its device as int32 (uint32 bits), copied
        once and kept until the next insert."""
        if self.num_bits > 0xFFFFFFFF:
            raise NotImplementedError("filters beyond 2^32 bits: shard first")
        device = resolve_device(self.device)
        if self._device_words is None or self._device_words.device != device:
            self._device_words = torch.from_numpy(self.words.view(np.int32)).to(device)
        return self._device_words

    def count_hits_device(self, hi, lo, valid) -> int:
        """Same count with the bit tests on the device (kernel K7's
        :func:`~xspect2_tpu_torch.ops.bloom.bloom_count`).

        Hashing stays on the host, as in the JAX package's method of the
        same name; the device reads the filter words and ANDs the probe
        bits.  Positions travel as the bit patterns of uint32.
        """
        words = self.device_words()
        pos = self._positions(hi, lo, valid).astype(np.uint32).view(np.int32)
        mask = np.ascontiguousarray(valid, dtype=bool)
        count = bloom_count(
            words, torch.from_numpy(pos).to(words.device), torch.from_numpy(mask).to(words.device)
        )
        return int(count.item())

    def count_hits_batch(self, batch: PreparedBatch) -> np.ndarray:
        """Hits of every record of a prepared batch
        (:func:`~xspect2_tpu_torch.ops.query.prepare_batch` at this
        filter's k): int64 [batch.num_records], one count per record as
        :meth:`count_hits_host` gives it on the record's canonical k-mers
        at the batch's step.

        Everything runs on the device: K4 restores the batch
        (:func:`~xspect2_tpu_torch.ops.query.restore_batch`), one launch
        of K7 (:func:`~xspect2_tpu_torch.ops.bloom.xxh3_records_count`)
        hashes and tests every valid window, and one fetch brings the
        counts back.
        """
        words = self.device_words()
        codes, rec_ids, valid = restore_batch(batch, words.device)
        counts = xxh3_records_count(
            words, codes, rec_ids, valid, max_records=batch.max_records, k=self.k,
            num_bits=self.num_bits, num_hashes=self.num_hashes,
            min_record_len=batch.min_record_len,
        )
        return counts[: batch.num_records].cpu().numpy().astype(np.int64)

    def count_hits_sequence(self, seq: str | bytes, device: bool = True) -> int:
        hi, lo, valid = dna.canonical_kmers(dna.encode(seq), self.k)
        if device:
            return self.count_hits_device(hi, lo, valid)
        return self.count_hits_host(hi, lo, valid)

    # ------------------------------------------------------- persistence
    def save(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path,
            words=self.words,
            meta=np.frombuffer(
                json.dumps(
                    {
                        "format": "xxh3-bloom-v1",
                        "num_bits": self.num_bits,
                        "num_hashes": self.num_hashes,
                        "k": self.k,
                    }
                ).encode("utf-8"),
                dtype=np.uint8,
            ),
        )

    @classmethod
    def load(cls, path: Path, device=None) -> "XXH3BloomFilter":
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode("utf-8"))
            if meta.get("format") != "xxh3-bloom-v1":
                raise ValueError(f"not an xxh3 compat filter: {path}")
            f = cls(meta["num_bits"], meta["num_hashes"], meta["k"], device)
            f.words = z["words"].astype(np.uint32)
        return f
