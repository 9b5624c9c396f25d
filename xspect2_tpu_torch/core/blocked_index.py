"""Blocked bit-sliced signature index (host side).

A copy of the JAX package's index class with the same layout, sizing
and on-disk format, so a ``.bbsi`` directory written by either package
loads in the other.

Layout
------
A dense bit matrix of ``[num_blocks * rows_per_block * fields_per_word]``
signature rows x ``C`` class-bit columns, stored as uint32 words
``[num_blocks, rows_per_block * class_words]``:

- With ``C > 16`` (``fields_per_word == 1``) one word per row per 32
  classes (``class_words = ceil(C / 32)``), COBS's bit-sliced layout
  grouped into fixed-size blocks.
- With ``C <= 16``, ``fields_per_word = 32 // field_bits`` signature
  rows pack into each word (``field_bits`` = smallest power of two
  >= C).

All ``num_hashes`` probes of a k-mer live in one block.  Probe ``i``
sits in word ``(b + i*c) & (rows_per_block-1)`` at field
``(g + i) & (P-1)`` (see :func:`core.hashing.block_words_fieldbase`).

Semantics: per class, the hit count of a query sequence is the number
of its k-mers whose probe bits are all set in that class's column;
k-mers are canonicalized before hashing; there are no false negatives.

Sizing uses the COBS signature-size formula per class (for the largest
class) with an oversizing factor that compensates for the slightly
higher false-positive rate of blocked addressing.  ``num_hashes=None``
picks the probe count with the JAX package's cost model, so both
packages build the same geometry from the same inputs.
"""

import json
import math
import os
from pathlib import Path

import numpy as np

from xspect2_tpu_torch.core import hashing

# table bytes below which the JAX package's probe-count picker assumes
# the fast gather regime; kept so both packages pick the same geometry.
# ``XSPECT_FAST_TABLE_BYTES`` overrides it, read at every call, as there.
FAST_TABLE_BYTES = 108_000_000


def cobs_signature_bits(num_kmers: int, fpr: float, num_hashes: int) -> int:
    """COBS/Bloom signature size in bits for ``num_kmers`` items.

    m = ceil(-h * n / ln(1 - fpr^(1/h)))  (arXiv:1905.09624, §COBS Index).
    """
    if num_kmers <= 0:
        return 1
    return int(
        math.ceil(
            -num_hashes * num_kmers / math.log(1.0 - fpr ** (1.0 / num_hashes))
        )
    )


def default_rows_per_block(class_words: int, target_block_bytes: int = 512) -> int:
    """Words per block per class-word so one block is ~target_block_bytes."""
    rows = target_block_bytes // (class_words * 4)
    rows = max(8, rows)
    # round down to power of two
    return 1 << (rows.bit_length() - 1)


def default_fields_per_word(num_classes: int) -> int:
    """Signature rows per uint32 word: 32 // (smallest pow2 >= C), min 1."""
    if num_classes > 16:
        return 1
    fb = 1
    while fb < num_classes:
        fb *= 2
    return 32 // fb


def pick_num_hashes(
    num_kmers: int,
    fpr: float,
    num_classes: int,
    target_block_bytes: int = 512,
    size_factor: float = 1.3,
    budget_bytes: int | None = None,
    fields_per_word: int | None = None,
) -> int:
    """The JAX package's probe-count choice, reproduced exactly.

    Minimizes a per-k-mer cost model whose constants were fitted on the
    JAX package's accelerator; it is kept unchanged so that an index
    built here has the geometry the JAX package would build (the
    8-class 4 Mbp species geometry picks h=2).  The constants say
    nothing about this port's kernels.  ``budget_bytes=None`` reads
    ``XSPECT_FAST_TABLE_BYTES`` at call time (default
    :data:`FAST_TABLE_BYTES`), as the JAX package does.
    """
    if budget_bytes is None:
        budget_bytes = int(os.environ.get("XSPECT_FAST_TABLE_BYTES", FAST_TABLE_BYTES))
    class_words = max(1, (num_classes + 31) // 32)
    if fields_per_word is None:
        fields_per_word = (
            default_fields_per_word(num_classes) if class_words == 1 else 1
        )
    P = fields_per_word
    rpb = default_rows_per_block(class_words, target_block_bytes)
    best = None  # (cost, nbytes, h): bytes break cost ties
    for h in (2, 3, 4, 5, 7):
        bits = int(math.ceil(cobs_signature_bits(num_kmers, fpr, h) * size_factor))
        num_blocks = max(16, -(-bits // (rpb * P)))
        nbytes = num_blocks * rpb * class_words * 4
        if nbytes <= budget_bytes:
            passes = h + min(h, P)
            cost = 0.42 * passes + 3.4
        else:
            cost = 12.3
        if best is None or (cost, nbytes) < (best[0], best[1]):
            best = (cost, nbytes, h)
    return best[2]


class BlockedBitSlicedIndex:
    """Dense blocked bit-sliced signature index over C classes."""

    FORMAT_VERSION = 2

    def __init__(
        self,
        k: int,
        class_names: list[str],
        num_blocks: int,
        rows_per_block: int,
        num_hashes: int,
        fpr: float,
        table: np.ndarray | None = None,
        fields_per_word: int = 1,
    ):
        if rows_per_block & (rows_per_block - 1):
            raise ValueError("rows_per_block must be a power of two")
        if fields_per_word & (fields_per_word - 1):
            raise ValueError("fields_per_word must be a power of two")
        self.k = k
        self.class_names = list(class_names)
        self.num_classes = len(self.class_names)
        self.class_words = max(1, (self.num_classes + 31) // 32)
        if fields_per_word > 1:
            if self.class_words != 1:
                raise ValueError("fields_per_word > 1 requires <= 32 classes")
            if self.num_classes * fields_per_word > 32:
                raise ValueError(
                    "fields_per_word * num_classes must fit one uint32 word"
                )
        self.fields_per_word = int(fields_per_word)
        self.field_bits = 32 // self.fields_per_word
        self.num_blocks = int(num_blocks)
        self.rows_per_block = int(rows_per_block)
        self.num_hashes = int(num_hashes)
        self.fpr = float(fpr)
        words = self.num_blocks * self.rows_per_block * self.class_words
        if table is None:
            self.table = np.zeros(words, dtype=np.uint32)
        else:
            if table.size != words:
                raise ValueError("table size mismatch")
            self.table = table.reshape(-1).astype(np.uint32, copy=False)

    # ------------------------------------------------------------------ build

    @classmethod
    def create(
        cls,
        k: int,
        class_names: list[str],
        max_kmers_per_class: int,
        fpr: float = 0.01,
        num_hashes: int | None = 7,
        size_factor: float | None = None,
        target_block_bytes: int = 512,
        fields_per_word: int | None = None,
    ) -> "BlockedBitSlicedIndex":
        """Allocate an empty index sized for ``max_kmers_per_class`` items/class.

        ``num_hashes=None`` picks the probe count automatically (see
        :func:`pick_num_hashes`); ``fields_per_word=None`` packs as many
        signature rows per word as the class count allows.
        """
        num_classes = len(class_names)
        class_words = max(1, (num_classes + 31) // 32)
        if fields_per_word is None:
            fields_per_word = (
                default_fields_per_word(num_classes) if class_words == 1 else 1
            )
        if num_hashes is None:
            num_hashes = pick_num_hashes(
                max_kmers_per_class,
                fpr,
                num_classes,
                target_block_bytes=target_block_bytes,
                size_factor=1.3 if size_factor is None else size_factor,
                fields_per_word=fields_per_word,
            )
        if size_factor is None:
            size_factor = 1.0 if num_hashes == 1 else 1.3
        rows_per_block = default_rows_per_block(class_words, target_block_bytes)
        bits = cobs_signature_bits(max_kmers_per_class, fpr, num_hashes)
        bits = int(math.ceil(bits * size_factor))
        num_blocks = max(16, -(-bits // (rows_per_block * fields_per_word)))
        return cls(
            k,
            class_names,
            num_blocks,
            rows_per_block,
            num_hashes,
            fpr,
            fields_per_word=fields_per_word,
        )

    def _probe_words_bits(self, hi: np.ndarray, lo: np.ndarray, class_idx: int):
        """Flat word indices [n, h] and per-probe bit masks for one class."""
        block, words, g = hashing.block_words_fieldbase(
            hi,
            lo,
            self.num_blocks,
            self.rows_per_block,
            self.num_hashes,
            self.fields_per_word,
        )
        base = block.astype(np.int64) * self.rows_per_block
        if self.fields_per_word == 1:
            word_of_class = class_idx // 32
            flat = (
                (base[:, None] + words.astype(np.int64)) * self.class_words
                + word_of_class
            )
            bits = np.broadcast_to(
                np.uint32(1) << np.uint32(class_idx % 32), flat.shape
            )
            return flat, bits
        i = np.arange(self.num_hashes, dtype=np.uint32)
        fields = (g[:, None] + i) & np.uint32(self.fields_per_word - 1)
        flat = base[:, None] + words.astype(np.int64)  # class_words == 1
        bits = np.uint32(1) << (
            fields * np.uint32(self.field_bits) + np.uint32(class_idx)
        )
        return flat, bits

    def insert_kmers(
        self,
        class_idx: int,
        hi: np.ndarray,
        lo: np.ndarray,
        valid: np.ndarray | None = None,
    ) -> None:
        """Set the probe bits of the given packed canonical k-mers for one class."""
        if valid is not None:
            hi = hi[valid]
            lo = lo[valid]
        if hi.size == 0:
            return
        flat, bits = self._probe_words_bits(hi, lo, class_idx)
        np.bitwise_or.at(self.table, flat.reshape(-1), bits.reshape(-1))

    # ------------------------------------------------------------------ query (host reference)

    def membership_host(self, hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
        """Reference (numpy) membership query: [n, C] uint8 bit matrix."""
        if hi.size == 0:
            return np.zeros((0, self.num_classes), dtype=np.uint8)
        block, words, g = hashing.block_words_fieldbase(
            hi,
            lo,
            self.num_blocks,
            self.rows_per_block,
            self.num_hashes,
            self.fields_per_word,
        )
        base_row = block.astype(np.int64) * self.rows_per_block
        if self.fields_per_word == 1:
            # gather words for each (kmer, hash) probe: [n, h, class_words]
            word_idx = (
                (base_row[:, None] + words.astype(np.int64))[:, :, None]
                * self.class_words
                + np.arange(self.class_words, dtype=np.int64)[None, None, :]
            )
            probes = self.table[word_idx]
            anded = probes[:, 0, :]
            for h in range(1, self.num_hashes):
                anded = anded & probes[:, h, :]
            cls = np.arange(self.num_classes)
            bits = (anded[:, cls // 32] >> (cls % 32).astype(np.uint32)) & np.uint32(1)
            return bits.astype(np.uint8)
        # field-packed: align each probe's field before the AND
        i = np.arange(self.num_hashes, dtype=np.uint32)
        fields = (g[:, None] + i) & np.uint32(self.fields_per_word - 1)
        probes = self.table[base_row[:, None] + words.astype(np.int64)]  # [n, h]
        field_mask = np.uint32((1 << self.field_bits) - 1)
        aligned = (probes >> (fields * np.uint32(self.field_bits))) & field_mask
        anded = aligned[:, 0]
        for h in range(1, self.num_hashes):
            anded = anded & aligned[:, h]
        cls = np.arange(self.num_classes, dtype=np.uint32)
        bits = (anded[:, None] >> cls[None, :]) & np.uint32(1)
        return bits.astype(np.uint8)

    def count_hits_host(
        self, hi: np.ndarray, lo: np.ndarray, valid: np.ndarray | None = None
    ) -> np.ndarray:
        """Reference hit counts per class for one sequence's packed k-mers."""
        if valid is not None:
            hi = hi[valid]
            lo = lo[valid]
        bits = self.membership_host(hi, lo)
        return bits.sum(axis=0, dtype=np.int64)

    # ------------------------------------------------------------------ persistence

    def meta_dict(self) -> dict:
        return {
            "format_version": self.FORMAT_VERSION,
            "k": self.k,
            "class_names": self.class_names,
            "num_blocks": self.num_blocks,
            "rows_per_block": self.rows_per_block,
            "class_words": self.class_words,
            "num_hashes": self.num_hashes,
            "fpr": self.fpr,
            "fields_per_word": self.fields_per_word,
        }

    @classmethod
    def from_meta(cls, meta: dict, table: np.ndarray) -> "BlockedBitSlicedIndex":
        """An index from a ``meta_dict()`` (format v1 or v2) and its table."""
        return cls(
            meta["k"],
            meta["class_names"],
            meta["num_blocks"],
            meta["rows_per_block"],
            meta["num_hashes"],
            meta["fpr"],
            table=table,
            # format v1 predates field packing
            fields_per_word=meta.get("fields_per_word", 1),
        )

    def save(self, dir_path: Path) -> None:
        dir_path = Path(dir_path)
        dir_path.mkdir(parents=True, exist_ok=True)
        np.save(dir_path / "table.npy", self.table)
        (dir_path / "index_meta.json").write_text(
            json.dumps(self.meta_dict(), indent=2), encoding="utf-8"
        )

    @classmethod
    def load(cls, dir_path: Path, mmap: bool = False) -> "BlockedBitSlicedIndex":
        dir_path = Path(dir_path)
        meta = json.loads((dir_path / "index_meta.json").read_text(encoding="utf-8"))
        table = np.load(dir_path / "table.npy", mmap_mode="r" if mmap else None)
        return cls.from_meta(meta, table)

    # ------------------------------------------------------------------ info

    @property
    def nbytes(self) -> int:
        return self.table.nbytes

    def device_table(self) -> np.ndarray:
        """The table in the JAX package's device layout: [num_blocks,
        class_words * R] uint32.

        Class-word-major within a block (word w's rows are contiguous),
        unlike the row-major on-disk layout, so one class word's probe
        rows of a block sit in one 4*R-byte run.  With class_words == 1
        (always the case when fields_per_word > 1) the transpose is the
        identity.  The port's kernels read the row-major ``table`` itself
        (``ops.query.table_tensor``), where one probe row is one run of
        class_words words; this method mirrors the JAX API.
        """
        t3 = self.table.reshape(
            self.num_blocks, self.rows_per_block, self.class_words
        )
        return np.ascontiguousarray(t3.transpose(0, 2, 1)).reshape(
            self.num_blocks, self.class_words * self.rows_per_block
        )
