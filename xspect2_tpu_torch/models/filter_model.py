"""Multi-class probabilistic filter model.

The JAX package's ``ProbabilisticFilterModel``: ``fit`` from one
sequence file per class, ``calculate_hits``, ``predict`` over a file, a
``SeqRecord``, a record list or an iterator, ``save`` and ``load``, with
hit counts from :class:`~xspect2_tpu_torch.ops.query.DeviceQueryEngine`.

``predict`` on a file takes one of two routes, as the JAX package does:
a file of at least 512 records of one length (a FASTQ run) goes through
the uniform-reads route; every other input (assemblies, small files,
record lists) through the records route.  ``validation=True`` always
takes the records route and keeps every record it counted for the
alignment post-filter (:meth:`detecting_misclassification`).

A file is parsed natively once (phase ``wire.parse``).  The records
route of a FASTA file cuts its batches from that parse, as flat arrays,
unless a scan of the file's bytes finds something on which the parse
could differ from the line reader (``io/fasta.py``), which defines the
records; every other input goes through the line reader and encodes
each record on its own.  Both make the same batches.  In the phases,
``wire.read`` is a batch pulled from the reader or the parse (and the
scan before the parse's first), ``wire.encode`` a batch's codes and
``wire.prepare`` the rest of its :class:`PreparedBatch`; the counters
``wire.records_from_parse`` and ``wire.records_from_reader`` count the
files each served.
"""

import json
import math
from pathlib import Path
from typing import Any, Iterable, Iterator

import numpy as np

from xspect2_tpu_torch import native, profiling, resolve_device
from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.definitions import fasta_endings, fastq_endings, slugify
from xspect2_tpu_torch.io.fasta import SeqRecord, get_record_iterator
from xspect2_tpu_torch.models.result import ModelResult
from xspect2_tpu_torch.ops.query import (
    DeviceQueryEngine,
    PreparedBatch,
    batch_from_flat,
    pad_codes,
    prepare_batch,
)

# a file of at least this many records of one length takes the reads
# route; anything else takes the records route (the JAX package's rule)
_MIN_FAST_READS = 512
# reads per padding unit, and bases per device batch: a large FASTQ
# streams through the device in slices of at most this many bases
_READS_PER_CHUNK = 4096
_MAX_BATCH_BASES = 1 << 28
# records route: bases and records per device batch
_MAX_RECORD_BATCH_BASES = 1 << 23
_MAX_RECORD_BATCH_RECORDS = 65536
# device batches in flight at once: the next slice's host packing
# overlaps the previous slice's device work, and no more than this many
# result buffers stay resident
_IN_FLIGHT = 3


class ProbabilisticFilterModel:
    """Multi-class k-mer filter model over one blocked bit-sliced index."""

    def __init__(
        self,
        k: int,
        model_display_name: str,
        author: str | None,
        author_email: str | None,
        model_type: str,
        base_path: Path,
        fpr: float = 0.01,
        num_hashes: int | None = None,
        training_accessions: dict[str, list[str]] | None = None,
        device=None,
    ) -> None:
        if k < 1:
            raise ValueError("Invalid k value, must be greater than 0")
        if not model_display_name:
            raise ValueError("Invalid filter display name, must be a non-empty string")
        if not model_type:
            raise ValueError("Invalid filter type, must be a non-empty string")
        if not isinstance(base_path, Path):
            raise ValueError("Invalid base path, must be a pathlib.Path object")
        self.k = k
        self.model_display_name = model_display_name
        self.author = author
        self.author_email = author_email
        self.model_type = model_type
        self.base_path = base_path
        self.display_names: dict[str, str] = {}
        self.fpr = fpr
        self.num_hashes = num_hashes
        self.index: BlockedBitSlicedIndex | None = None
        self.training_accessions = training_accessions
        self.device = resolve_device(device)
        self._engine: DeviceQueryEngine | None = None

    # ------------------------------------------------------------------ paths / meta

    def slug(self) -> str:
        return slugify(self.model_display_name + "-" + str(self.model_type))

    def get_index_path(self) -> Path:
        """Directory holding the index artifacts for this model."""
        return self.base_path / self.slug() / "index.bbsi"

    def to_dict(self) -> dict:
        return {
            "model_slug": self.slug(),
            "k": self.k,
            "model_display_name": self.model_display_name,
            "author": self.author,
            "author_email": self.author_email,
            "model_type": self.model_type,
            "model_class": self.__class__.__name__,
            "display_names": self.display_names,
            "fpr": self.fpr,
            "num_hashes": (
                self.index.num_hashes if self.index is not None else self.num_hashes
            ),
            "training_accessions": self.training_accessions,
        }

    # ------------------------------------------------------------------ training

    def _training_files(self, dir_path: Path) -> list[Path]:
        return [
            f
            for f in sorted(dir_path.iterdir())
            if f.is_file() and f.suffix[1:] in fasta_endings + fastq_endings
        ]

    def fit(
        self,
        dir_path: Path,
        display_names: dict | None = None,
        training_accessions: dict[str, list[str]] | None = None,
    ) -> None:
        """Build the index from one sequence file per class in ``dir_path``.

        The class name is the file name up to its first "."; the index
        is sized for the class with the most k-mers and saved under
        :meth:`get_index_path`.
        """
        if display_names is None:
            display_names = {}
        if not isinstance(dir_path, Path):
            raise ValueError("Invalid directory path, must be a pathlib.Path object")
        if not dir_path.exists():
            raise ValueError("Directory path does not exist")
        if not dir_path.is_dir():
            raise ValueError("Directory path must be a directory")
        self.training_accessions = training_accessions
        files = self._training_files(dir_path)
        if not files:
            raise ValueError("No valid files found in directory. Must be fasta or fastq")

        class_names = []
        for file in files:
            doc_name = file.name.split(".")[0]
            class_names.append(doc_name)
            self.display_names[doc_name] = display_names.get(file.stem, file.stem)

        parsed = [native.parse_file(file)[:2] for file in files]
        kmer_counts = [
            int(np.maximum(0, np.diff(offsets) - self.k + 1).sum()) for _, offsets in parsed
        ]
        index = BlockedBitSlicedIndex.create(
            self.k, class_names, max(kmer_counts), fpr=self.fpr, num_hashes=self.num_hashes
        )
        self.num_hashes = index.num_hashes
        for ci, (codes, offsets) in enumerate(parsed):
            for r in range(len(offsets) - 1):
                native.insert_kmers(index, ci, codes[offsets[r] : offsets[r + 1]])
        self.index = index
        self._engine = None
        index.save(self.get_index_path())

    # ------------------------------------------------------------------ inference

    @property
    def engine(self) -> DeviceQueryEngine:
        if self._engine is None:
            if self.index is None:
                raise ValueError("The model has not been trained yet")
            self._engine = DeviceQueryEngine(self.index, device=self.device)
        return self._engine

    def _class_names(self) -> list[str]:
        """The classes of the columns :meth:`_count_batch` counts."""
        return self.index.class_names

    def _batch_chunk(self) -> int:
        """The chunk the records route pads its batches to."""
        return self.engine.chunk

    def _count_batch(self, batch: PreparedBatch) -> np.ndarray:
        """The records route's hits: int64 [batch.num_records, len(self._class_names())]."""
        return self.engine.count_hits(batch)

    def _hits_dict_from_counts(
        self, counts: np.ndarray, exclude_ids: list[str] | None
    ) -> dict[str, int]:
        """One record's {class: hits} dict, ranked like a COBS search
        result (descending count, ties by name)."""
        names = self._class_names()
        order = sorted(range(len(names)), key=lambda i: (-int(counts[i]), names[i]))
        excluded = set(exclude_ids) if exclude_ids else ()
        return {names[i]: int(counts[i]) for i in order if names[i] not in excluded}

    def _record_hits(
        self, counts: np.ndarray, exclude_ids: list[str] | None, display_name: bool
    ) -> dict[str, int]:
        rec_hits = self._hits_dict_from_counts(counts, exclude_ids)
        if not display_name:
            return rec_hits
        return {
            f"{key} -{self.display_names.get(key, 'Unknown').replace(self.model_display_name, '', 1)}": v
            for key, v in rec_hits.items()
        }

    def calculate_hits(
        self, sequence, exclude_ids: list[str] | None = None, step: int = 1
    ) -> dict:
        """Hit counts of one sequence (a string or a ``SeqRecord``) per class."""
        seq = sequence.seq if isinstance(sequence, SeqRecord) else sequence
        if not isinstance(seq, str):
            raise ValueError("Invalid sequence, must be a string or SeqRecord")
        if not len(seq) > self.k:
            raise ValueError("Invalid sequence, must be longer than k")
        counts = self.engine.count_hits_records([("seq", dna.encode(seq))], step=step)[0]
        return self._hits_dict_from_counts(counts, exclude_ids)

    @profiling.phase("engine.reads")
    def _count_reads(self, mat: np.ndarray, step: int) -> np.ndarray:
        """Hit counts of an [n, L] read matrix, streamed in bounded slices."""
        n, length = mat.shape
        rpc = _READS_PER_CHUNK
        cap = max(rpc, (_MAX_BATCH_BASES // length) // rpc * rpc)
        pending = []
        parts = []
        for s0 in range(0, n, cap):
            sl = mat[s0 : s0 + cap]
            m = len(sl)
            out = self.engine.count_hits_reads(
                sl, step=step, reads_per_chunk=rpc, block=False
            )
            pending.append((out, m))
            while len(pending) >= _IN_FLIGHT:
                out, m = pending.pop(0)
                with profiling.phase("engine.reads.fetch"):
                    parts.append(out[:m].cpu().numpy())
        with profiling.phase("engine.reads.fetch"):
            parts.extend(out[:m].cpu().numpy() for out, m in pending)
        return np.concatenate(parts).astype(np.int64)

    def _predict_reads_file(
        self, path: Path, exclude_ids: list[str] | None, step: int, display_name: bool
    ) -> ModelResult | tuple | None:
        """The uniform-reads route: a file of at least 512 records of one
        length, parsed natively into one [N, L] matrix.  Any other file
        takes the records route: then the parse ``(codes, offsets, ids)``
        is returned for it, or None when the native library is not
        available (as the JAX package does), and for every file of a
        model without a blocked index (the xxh3 genus filter)."""
        if not native.available():
            return None
        codes, offsets, ids = parsed = native.parse_file(path)
        n = len(ids)
        if n < _MIN_FAST_READS or self.index is None:
            return parsed
        lengths = np.diff(offsets)
        if not (lengths == lengths[0]).all():
            return parsed
        length = int(lengths[0])
        if not length > self.k:
            raise ValueError("Invalid sequence, must be longer than k")

        counts = self._count_reads(codes.reshape(n, length), step)
        nk = math.ceil((length - self.k + 1) / step)
        with profiling.phase("model.hits"):
            hits = {rid: self._record_hits(counts[i], exclude_ids, display_name) for i, rid in enumerate(ids)}
        num_kmers = {rid: nk for rid in ids}
        return ModelResult(self.slug(), hits, num_kmers, sparse_sampling_step=step)

    def _iter_record_batches(
        self, records: Iterable[SeqRecord], max_bases: int | None = None
    ) -> Iterator[list[SeqRecord]]:
        if max_bases is None:
            max_bases = _MAX_RECORD_BATCH_BASES
        batch: list[SeqRecord] = []
        bases = 0
        for rec in records:
            batch.append(rec)
            bases += len(rec.seq)
            if bases >= max_bases or len(batch) >= _MAX_RECORD_BATCH_RECORDS:
                yield batch
                batch, bases = [], 0
        if batch:
            yield batch

    def _read_batches(
        self, sequence_input, step: int, kept: list[SeqRecord] | None
    ) -> Iterator[PreparedBatch]:
        """The records route's batches through the line reader, each
        record encoded on its own; every record read goes into ``kept``
        when it is a list."""
        rec_batches = self._iter_record_batches(self._as_record_iterable(sequence_input))
        while True:
            with profiling.phase("wire.read"):
                rec_batch = next(rec_batches, None)
            if rec_batch is None:
                return
            with profiling.phase("wire.encode"):
                encoded = [(rec.id, dna.encode(rec.seq)) for rec in rec_batch]
            with profiling.phase("wire.prepare"):
                batch = prepare_batch(encoded, self.k, step=step, chunk=self._batch_chunk())
            if kept is not None:
                kept.extend(rec_batch)
            yield batch

    def _parsed_batches(
        self, path: Path, parsed: tuple, step: int
    ) -> Iterator[PreparedBatch] | None:
        """The records route's batches cut from a FASTA file's native
        parse, at the records where :meth:`_iter_record_batches` would
        end them; None for any other file, or one on which the parse
        could differ from the line reader
        (:func:`~xspect2_tpu_torch.native.fasta_parse_matches_reader`)."""
        codes, offsets, ids = parsed
        if path.suffix[1:] not in fasta_endings:
            return None
        with profiling.phase("wire.read"):
            if not native.fasta_parse_matches_reader(path, offsets, ids):
                return None
        profiling.add("wire.records_from_parse", 0.0)
        return self._cut_batches(codes, offsets, ids, step)

    def _cut_batches(self, codes, offsets, ids, step: int) -> Iterator[PreparedBatch]:
        n = len(ids)
        start = 0
        while start < n:
            with profiling.phase("wire.read"):
                # a batch ends at the record that brings its bases to the
                # limit, or at the limit of records
                end = int(np.searchsorted(offsets, offsets[start] + _MAX_RECORD_BATCH_BASES))
                end = max(start + 1, min(end, start + _MAX_RECORD_BATCH_RECORDS, n))
                lo, hi = offsets[start], offsets[end]
                rec_offsets = offsets[start : end + 1] - lo
            with profiling.phase("wire.encode"):
                padded = pad_codes(codes[lo:hi], self.k, self._batch_chunk())
            with profiling.phase("wire.prepare"):
                batch = batch_from_flat(padded, rec_offsets, ids[start:end], self.k, step)
            start = end
            yield batch

    def predict(
        self,
        sequence_input: SeqRecord | list | Iterator | Path,
        exclude_ids: list[str] | None = None,
        step: int = 1,
        display_name: bool = False,
        validation: bool = False,
    ) -> ModelResult:
        """Classify a file, a ``SeqRecord``, a record list or an iterator.

        With ``validation``, records whose group maps in a spatial
        cluster onto its class's reference genome move under
        ``misclassified``.  Results equal the JAX package's on the same
        model and input.
        """
        batches = None
        if isinstance(sequence_input, Path) and not validation:
            routed = self._predict_reads_file(sequence_input, exclude_ids, step, display_name)
            if isinstance(routed, ModelResult):
                return routed
            if routed is not None:
                batches = self._parsed_batches(sequence_input, routed, step)
        kept_records: list[SeqRecord] = []
        if batches is None:
            if isinstance(sequence_input, Path):
                profiling.add("wire.records_from_reader", 0.0)
            batches = self._read_batches(sequence_input, step, kept_records if validation else None)

        hits: dict[str, dict[str, int]] = {}
        num_kmers: dict[str, int] = {}
        for batch in batches:
            counts = self._count_batch(batch)
            with profiling.phase("model.hits"):
                for i, rid in enumerate(batch.record_names):
                    hits[rid] = self._record_hits(counts[i], exclude_ids, display_name)
                    num_kmers[rid] = batch.num_kmers[i]
        if not hits:
            raise ValueError("No sequences found in input")
        if validation:
            hits = self.detecting_misclassification(hits, kept_records)
        return ModelResult(self.slug(), hits, num_kmers, sparse_sampling_step=step)

    def _as_record_iterable(self, sequence_input) -> Iterable[SeqRecord]:
        if isinstance(sequence_input, SeqRecord):
            return [sequence_input]
        if isinstance(sequence_input, Path):
            return get_record_iterator(sequence_input)
        if isinstance(sequence_input, (list, tuple)):
            if not all(isinstance(r, SeqRecord) for r in sequence_input):
                raise ValueError("Invalid sequence input, must be SeqRecord objects")
            return sequence_input
        if hasattr(sequence_input, "__iter__") or hasattr(sequence_input, "__next__"):
            return sequence_input
        raise ValueError(
            "Invalid sequence input, must be a SeqRecord, a list of SeqRecords, "
            "a record iterator, or a Path object to a fasta/fastq file"
        )

    def _count_kmers(self, sequence_input: Any, step: int = 1) -> int:
        """ceil((len - k + 1) / step) summed over the input sequences."""
        if isinstance(sequence_input, str):
            return math.ceil((len(sequence_input) - self.k + 1) / step)
        if isinstance(sequence_input, SeqRecord):
            return self._count_kmers(sequence_input.seq, step=step)
        return sum(self._count_kmers(seq, step=step) for seq in sequence_input)

    # ------------------------------------------------------------------ persistence

    def save(self) -> None:
        """Write the metadata JSON and the index directory."""
        filter_path = self.base_path / self.slug()
        filter_path.mkdir(exist_ok=True, parents=True)
        (self.base_path / f"{self.slug()}.json").write_text(
            json.dumps(self.to_dict(), indent=4), encoding="utf-8"
        )
        if self.index is not None:
            self.index.save(self.get_index_path())

    @classmethod
    def _from_metadata(cls, model_json: dict, base_path: Path, device):
        return cls(
            model_json["k"],
            model_json["model_display_name"],
            model_json["author"],
            model_json["author_email"],
            model_json["model_type"],
            base_path,
            model_json["fpr"],
            model_json["num_hashes"],
            model_json["training_accessions"],
            device=device,
        )

    @classmethod
    def load(cls, path: Path, device=None) -> "ProbabilisticFilterModel":
        model_json = json.loads(Path(path).read_text(encoding="utf-8"))
        model = cls._from_metadata(model_json, Path(path).parent, device)
        model.display_names = model_json["display_names"]
        index_path = model.get_index_path()
        if not index_path.exists():
            raise FileNotFoundError(f"Index file not found at {index_path}")
        model.index = BlockedBitSlicedIndex.load(index_path)
        return model

    # ------------------------------------------------------------------ validation post-filter

    def detecting_misclassification(
        self,
        hits: dict[str, dict[str, int]],
        seq_records: list[SeqRecord],
        min_reads: int = 10,
    ) -> dict[str, dict[str, int]]:
        """Alignment-based misclassification post-filter.

        Groups reads by unique-argmax class, maps suspect groups onto the
        class's reference genome and removes spatially clustered groups
        (:mod:`xspect2_tpu_torch.misclassification_detection`, on the host).
        """
        from xspect2_tpu_torch.misclassification_detection import detect_misclassification

        return detect_misclassification(hits, seq_records, min_reads=min_reads)
