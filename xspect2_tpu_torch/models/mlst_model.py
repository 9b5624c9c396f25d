"""MLST (multi-locus sequence typing) scheme model.

One blocked bit-sliced index per locus, one class (column) per allele
FASTA (class name = file name up to the first ".", e.g.
``Allele_ID_4``).  The JAX package's
``ProbabilisticFilterMlstSchemeModel``, with the same files and results:

- defaults fpr=0.001, num_hashes=1, k=31;
- sequences >= 10,000 bp are split into overlapping pieces (overlap
  k-1; piece length = avg allele length x1/x10/x100 by total length),
  per-piece counts > 50 are summed; shorter sequences are queried whole;
- per locus the argmax allele is kept; a strain type is reliable if at
  least one locus score >= 0.5 x that locus's average allele length;
  reliable types are resolved to an ST name via PubMLST, or to an
  ``"N/A (PubMLST lookup failed: ...)"`` string without a network.

Its phases (:mod:`xspect2_tpu_torch.profiling`), under
``classify.predict``: ``mlst.read`` (each step of the record iterator),
``mlst.split`` (each record's one ``dna.encode``, in the first length
group, and each group's piece layout, :func:`piece_layout`),
``mlst.prepare`` (``batch_from_flat``), ``mlst.query`` (the wire's upload,
with ``query.pack`` under it, and the fused K4 + K5 + K6 launch),
``mlst.fetch`` (the counts' one copy back), ``mlst.rank`` (the ranked
allele dictionaries and the sufficiency rule) and ``mlst.lookup`` (the
ST-name lookup); the counters ``mlst.length_group`` (a K5 dispatch: one
group of loci of one allele length), ``mlst.genome_group`` (a group
of genomes flushed by ``predict``) and ``mlst.genome_encode`` (a record
encoded).

On the device, the loci whose pieces coincide (equal average allele
length and engine chunk) share one prepared batch and one packed wire,
ALL of them are queried by one call of the multi-index kernel, one
launch for each probe path among them
(:func:`~xspect2_tpu_torch.ops.query.make_multi_packed_query`), and the
piece-score reduction runs on the device, so the fetch is [C] or
[genomes, C] per locus, not [pieces, C].
"""

import json
import os
from pathlib import Path

import numpy as np
import torch

from xspect2_tpu_torch import native, profiling
from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.core.dna import INVALID
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.definitions import slugify
from xspect2_tpu_torch.io.fasta import SeqRecord, get_record_iterator
from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel
from xspect2_tpu_torch.models.result import MlstResult
from xspect2_tpu_torch.ops.query import (
    DEFAULT_CHUNK,
    DeviceQueryEngine,
    batch_from_flat,
    make_multi_packed_query,
    padded_positions,
)

CHUNK_SCORE_THRESHOLD = 50
SPLIT_MIN_LENGTH = 10_000


class ProbabilisticFilterMlstSchemeModel(ProbabilisticFilterModel):
    """Per-locus allele filter bank for MLST strain typing."""

    def __init__(
        self,
        k: int,
        model_display_name: str,
        base_path: Path,
        scheme_url: str,
        organism: str,
        fpr: float = 0.001,
        num_hashes: int = 1,
        author: str | None = None,
        author_email: str | None = None,
        model_type: str = "MLST",
        device=None,
    ) -> None:
        super().__init__(
            k, model_display_name, author, author_email, model_type, base_path,
            fpr, num_hashes, None, device=device,
        )
        self.organism = organism
        self.scheme_url = scheme_url
        self.loci: dict[str, int] = {}
        self.avg_locus_bp_size: list[int] = []
        self.indices: list[BlockedBitSlicedIndex] = []
        self._engines: list[DeviceQueryEngine] | None = None

    def to_dict(self) -> dict:
        return super().to_dict() | {
            "organism": self.organism,
            "scheme_url": self.scheme_url,
            "loci": self.loci,
            "average_locus_base_pair_size": self.avg_locus_bp_size,
        }

    def slug(self) -> str:
        return slugify(self.organism + "-" + self.model_display_name + "-" + self.model_type)

    def get_locus_index_path(self, locus: str) -> Path:
        return self.base_path / self.slug() / f"{locus}.bbsi"

    # ------------------------------------------------------------------ training

    def fit(self, scheme_path: Path) -> None:
        """Build one index per locus from per-allele FASTA files."""
        if not scheme_path.exists():
            raise ValueError("Scheme not found. Please make sure to download the schemes prior!")

        for locus_path in sorted(scheme_path.iterdir()):
            if not locus_path.is_dir():
                continue
            locus = locus_path.name
            allele_files = sorted(p for p in locus_path.iterdir() if p.suffix == ".fasta")
            self.loci[locus] = len(allele_files)

            first_record = next(get_record_iterator(allele_files[0]))
            self.avg_locus_bp_size.append(len(first_record.seq))

            class_names = [p.name.split(".")[0] for p in allele_files]
            max_kmers = 1
            allele_codes = []
            for p in allele_files:
                codes_parts = [dna.encode(rec.seq) for rec in get_record_iterator(p)]
                n = sum(max(0, len(c) - self.k + 1) for c in codes_parts)
                max_kmers = max(max_kmers, n)
                allele_codes.append(codes_parts)

            index = BlockedBitSlicedIndex.create(
                self.k, class_names, max_kmers, fpr=self.fpr, num_hashes=self.num_hashes
            )
            for ci, codes_parts in enumerate(allele_codes):
                for codes in codes_parts:
                    native.insert_kmers(index, ci, codes)
            index.save(self.get_locus_index_path(locus))
            self.indices.append(index)
        self._engines = None

    # ------------------------------------------------------------------ persistence

    def save(self) -> None:
        json_path = self.base_path / f"{self.slug()}.json"
        json_path.write_text(json.dumps(self.to_dict(), indent=4), encoding="utf-8")

    @classmethod
    def load(cls, path: Path, device=None) -> "ProbabilisticFilterMlstSchemeModel":
        if not Path(path).exists():
            raise FileNotFoundError(f"Model JSON not found at {path}")
        model_json = json.loads(Path(path).read_text(encoding="utf-8"))
        model = cls(
            model_json["k"],
            model_json["model_display_name"],
            Path(path).parent,
            model_json["scheme_url"],
            model_json["organism"],
            model_json["fpr"],
            model_json["num_hashes"],
            model_json.get("author"),
            model_json.get("author_email"),
            model_json.get("model_type"),
            device=device,
        )
        model.avg_locus_bp_size = model_json.get("average_locus_base_pair_size", [])
        model.loci = model_json.get("loci", {})
        for locus in model.loci:
            index_path = model.get_locus_index_path(locus)
            if not index_path.exists():
                raise FileNotFoundError(f"Index file not found at {index_path}")
            model.indices.append(BlockedBitSlicedIndex.load(index_path))
        return model

    # ------------------------------------------------------------------ inference

    @property
    def engines(self) -> list[DeviceQueryEngine]:
        if self._engines is None:
            if not self.indices:
                raise ValueError("The model has not been trained yet")
            self._engines = [DeviceQueryEngine(idx, device=self.device) for idx in self.indices]
        return self._engines

    def _check_sequences(self, seqs: list[str]) -> None:
        for s in seqs:
            if not isinstance(s, str):
                raise ValueError("Invalid sequence, must be a string")
            if not len(s) > self.k:
                raise ValueError("Invalid sequence, must be longer than k")
        if not self.indices:
            raise ValueError("The model has not been trained yet")

    def _dispatch_groups(self, seqs, step, reduce_mode, threshold, num_segments, n_out):
        """Query every locus for the pieces of ``seqs`` WITHOUT syncing.

        Loci whose pieces coincide (equal average allele length, so the
        splitter gives the same pieces; equal engine chunk) share ONE
        prepared batch, whose packed wire is uploaded once, and ONE
        multi-index query with the reduction on the device.  Returns
        ``[(device_out, n_out), ...]`` per locus for
        :meth:`_fetch_counts`.  A sequence longer than k always gives a
        piece, so no batch is empty.  Each record is encoded once, and
        every group's pieces are cut from its codes (:func:`piece_layout`).
        """
        use_split = len(seqs[0]) >= SPLIT_MIN_LENGTH
        codes = None  # each record's codes, encoded once for every length group
        groups: dict[tuple, dict] = {}
        for li, engine in enumerate(self.engines):
            size = self.avg_locus_bp_size[li] if use_split else None
            key = (size, engine.chunk)
            if key not in groups:
                with profiling.phase("mlst.split"):
                    if codes is None:
                        codes = [dna.encode(s) for s in seqs]
                        for _ in seqs:
                            profiling.add("mlst.genome_encode", 0.0)
                    padded, offsets, names, seg = piece_layout(codes, size, self.k, engine.chunk)
                with profiling.phase("mlst.prepare"):
                    batch = batch_from_flat(padded, offsets, names, self.k, step)
                groups[key] = {"batch": batch, "seg": seg, "loci": []}
            groups[key]["loci"].append(li)

        dispatched: list[tuple | None] = [None] * len(self.engines)
        for group in groups.values():
            batch, seg, loci = group["batch"], group["seg"], group["loci"]
            engines = [self.engines[li] for li in loci]
            profiling.add("mlst.length_group", 0.0)
            with profiling.phase("mlst.query"):
                fused = make_multi_packed_query(
                    [e.geometry() for e in engines],
                    step,
                    batch.num_positions,
                    reduce_mode=reduce_mode,
                    threshold=threshold,
                    num_segments=num_segments,
                    # the typical piece sizes the kernel's thread blocks
                    min_record_len=int(np.median(np.diff(batch.offsets))),
                )
                seg_ids = None
                if num_segments is not None:
                    # padded record slots count no hit, so the segment they
                    # map to is unaffected
                    seg_pad = np.zeros(batch.max_records, dtype=np.int32)
                    seg_pad[: len(seg)] = seg
                    seg_ids = torch.from_numpy(seg_pad).to(self.device)
                wire = engines[0].upload_records_wire(batch, batch.max_records)
                outs = fused([e.table for e in engines], *wire, seg_ids)
            for li, out in zip(loci, outs):
                dispatched[li] = (out, n_out)
        return dispatched

    def _dispatch_loci(self, sequence: str, step: int) -> list[tuple]:
        """Dispatch every locus query for one sequence: per locus the
        thresholded totals over its pieces ([C]), or the raw counts of a
        sequence too short to split ([C])."""
        self._check_sequences([sequence])
        use_split = len(sequence) >= SPLIT_MIN_LENGTH
        return self._dispatch_groups(
            [sequence], step,
            "thresholded_totals" if use_split else "first_record",
            CHUNK_SCORE_THRESHOLD, None, 1,
        )

    def _dispatch_loci_group(self, seqs: list[str], step: int) -> list[tuple]:
        """Dispatch every locus query for a GROUP of genomes at once.

        All genomes' pieces go into ONE prepared batch per locus group
        and are reduced per genome on the device
        (``thresholded_segment_totals``): one query and one [B, C] fetch
        per locus type B genomes.  All genomes of the group must share
        the >= 10 kb split status (the caller buffers accordingly);
        short genomes keep their raw counts (``threshold=-1``).
        """
        self._check_sequences(seqs)
        use_split = len(seqs[0]) >= SPLIT_MIN_LENGTH
        if any((len(s) >= SPLIT_MIN_LENGTH) != use_split for s in seqs):
            raise ValueError("group must share the split status")
        return self._dispatch_groups(
            seqs, step, "thresholded_segment_totals",
            CHUNK_SCORE_THRESHOLD if use_split else -1, len(seqs), len(seqs),
        )

    @staticmethod
    def _fetch_counts(dispatched: list[tuple]) -> list[np.ndarray]:
        """ONE device-to-host copy for any number of dispatched outputs."""
        with profiling.phase("mlst.fetch"):
            flat = torch.cat([o.reshape(-1) for o, _ in dispatched]).cpu().numpy()
        out, at = [], 0
        for o, n_rows in dispatched:
            c = flat[at : at + o.numel()].reshape(tuple(o.shape))
            at += o.numel()
            if c.ndim == 2:
                c = c[:n_rows]
            out.append(c.astype(np.int64))
        return out

    def calculate_hits(
        self,
        sequence: str,
        step: int = 1,
        limit: bool = False,
        limit_number: int = 5,
    ) -> list[dict]:
        """Per-locus allele scores and the argmax strain type."""
        if isinstance(sequence, SeqRecord):
            sequence = sequence.seq
        dispatched = self._dispatch_loci(sequence, step)
        counts_per_locus = self._fetch_counts(dispatched)
        return self._assemble_hits(sequence, counts_per_locus, limit, limit_number)

    def _assemble_hits(
        self,
        sequence: str,
        counts_per_locus: list[np.ndarray],
        limit: bool = False,
        limit_number: int = 5,
    ) -> list[dict]:
        """Host post-processing of the fetched per-locus counts ([C] each)."""
        with profiling.phase("mlst.rank"):
            highest_results, result_dict, is_valid = self._rank_alleles(
                sequence, counts_per_locus, limit, limit_number
            )
        if not is_valid:
            highest_results["Attention:"] = (
                "This strain type is not reliable due to low kmer hit rates!"
            )
        else:
            with profiling.phase("mlst.lookup"):
                highest_results["ST_Name"] = self._resolve_strain_type(highest_results)
        return [{"Strain type": highest_results}, {"All results": result_dict}]

    def _rank_alleles(self, sequence, counts_per_locus, limit, limit_number):
        """Each locus's alleles ranked (descending count, then name), its
        argmax, and whether the strain type is reliable."""
        loci_names = list(self.loci.keys())
        result_dict: dict | str = {}
        highest_results: dict = {}
        any_locus_empty = False
        use_split = len(sequence) >= SPLIT_MIN_LENGTH

        for li in range(len(self.indices)):
            names = self.indices[li].class_names
            counts = counts_per_locus[li]
            if use_split:
                # thresholded totals: alleles without a hit are left out
                order = sorted(
                    (i for i in range(len(names)) if counts[i] > 0),
                    key=lambda i: (-int(counts[i]), names[i]),
                )
            else:
                order = sorted(range(len(names)), key=lambda i: (-int(counts[i]), names[i]))
            result = {names[i]: int(counts[i]) for i in order}
            if limit:
                result = dict(list(result.items())[:limit_number])
            if not result:
                any_locus_empty = True
                highest_results[loci_names[li]] = {"N/A": 0}
                continue
            first_key = next(iter(result))
            result_dict[loci_names[li]] = result
            highest_results[loci_names[li]] = {first_key: result[first_key]}

        if any_locus_empty and not result_dict:
            result_dict = "A Strain type could not be detected because of no kmer matches!"

        is_valid = self.has_sufficient_score(highest_results, self.avg_locus_bp_size)
        return highest_results, result_dict, is_valid

    def _resolve_strain_type(self, highest_results: dict) -> str:
        """Resolve the ST name via PubMLST (network); without a network
        or without ``requests`` the lookup's failure becomes the name."""
        try:
            from xspect2_tpu_torch.handlers.pubmlst import PubMLSTHandler

            flattened = {
                locus: int(next(iter(allele_id)).split("_")[-1])
                for locus, allele_id in highest_results.items()
                if isinstance(allele_id, dict)
            }
            return PubMLSTHandler().get_strain_type_name(flattened, self.scheme_url)
        except Exception as exc:  # noqa: BLE001 - network/availability errors
            return f"N/A (PubMLST lookup failed: {exc})"

    def predict(
        self,
        sequence_input,
        step: int = 1,
        limit: bool = False,
        batch_genomes: int | None = None,
    ) -> MlstResult:
        """Type a ``SeqRecord``, a record iterator or a FASTA/FASTQ file.

        Records of an iterator or a file are typed ``batch_genomes`` at
        a time (default ``XSPECT_MLST_BATCH_GENOMES``, else 4) through
        one query per locus group; a group is flushed early when the
        >= 10 kb split status changes, so every group shares one piece
        geometry.  At most two groups are in flight: group N's device
        work and fetch overlap group N+1's host-side split and pack.
        """
        if isinstance(sequence_input, SeqRecord):
            if sequence_input.id == "<unknown id>":
                sequence_input.id = "test"
            hits = {sequence_input.id: self.calculate_hits(sequence_input.seq, step, limit)}
            return MlstResult(self.model_display_name, step, hits, None)

        if isinstance(sequence_input, Path):
            return self.predict(
                get_record_iterator(sequence_input),
                step=step, limit=limit, batch_genomes=batch_genomes,
            )

        if not hasattr(sequence_input, "__iter__"):
            raise ValueError(
                "Invalid sequence input, must be a SeqRecord, a record iterator, "
                "or a Path object to a fasta/fastq file"
            )
        if batch_genomes is None:
            batch_genomes = int(os.environ.get("XSPECT_MLST_BATCH_GENOMES", "4"))
        batch_genomes = max(1, batch_genomes)
        hits = {}
        inflight: list[tuple] = []
        buffer: list[tuple[str, str]] = []  # (record id, sequence)

        def drain_one():
            group, dispatched = inflight.pop(0)
            counts = self._fetch_counts(dispatched)
            for b, (rid, seq) in enumerate(group):
                hits[rid] = self._assemble_hits(seq, [c[b] for c in counts], limit)

        def flush():
            if not buffer:
                return
            group = list(buffer)
            buffer.clear()
            profiling.add("mlst.genome_group", 0.0)
            dispatched = self._dispatch_loci_group([seq for _, seq in group], step)
            inflight.append((group, dispatched))
            while len(inflight) >= 2:
                drain_one()

        for record in _timed_steps(sequence_input):
            seq = record.seq
            if buffer and (
                (len(seq) >= SPLIT_MIN_LENGTH) != (len(buffer[0][1]) >= SPLIT_MIN_LENGTH)
            ):
                flush()
            buffer.append((record.id, seq))
            if len(buffer) >= batch_genomes:
                flush()
        flush()
        while inflight:
            drain_one()
        return MlstResult(self.model_display_name, step, hits, None)

    # ------------------------------------------------------------------ helpers

    def sequence_splitter(self, input_sequence: str, allele_len: int) -> list[str]:
        """Split a long sequence into k-1-overlapping pieces sized by allele length."""
        sequence_len = len(input_sequence)
        if sequence_len < 1_000_000:
            substring_length = allele_len
        elif sequence_len < 10_000_000:
            substring_length = allele_len * 10
        else:
            substring_length = allele_len * 100

        substring_list = []
        start = 0
        while start + substring_length <= sequence_len:
            substring_list.append(input_sequence[start : start + substring_length])
            start += substring_length - self.k + 1
        if start < sequence_len:
            remaining = input_sequence[start:]
            if len(remaining) < self.k:
                substring_list[-1] += remaining
            else:
                substring_list.append(remaining)
        return substring_list

    def has_sufficient_score(self, highest_results: dict, locus_size: list[int]) -> bool:
        """True if any locus argmax score >= 0.5 x its average allele length."""
        for i, allele_score_dict in enumerate(highest_results.values()):
            if not allele_score_dict:
                continue
            score = next(iter(allele_score_dict.values()))
            if score >= 0.5 * locus_size[i]:
                return True
        return False


def piece_layout(codes: list[np.ndarray], allele_len: int | None, k: int,
                 chunk: int = DEFAULT_CHUNK):
    """The pieces of each encoded record, laid end to end as
    :func:`~xspect2_tpu_torch.ops.query.prepare_batch` lays them out.

    Returns ``(padded, offsets, names, seg)``: the flat code tensor as
    :func:`~xspect2_tpu_torch.ops.query.pad_codes` sizes it, the pieces'
    int64 offsets, their names (``g<record>p<piece>``) and each piece's
    record; :func:`~xspect2_tpu_torch.ops.query.batch_from_flat` makes
    them the batch that ``prepare_batch`` makes of the splitter's pieces,
    each through ``dna.encode``.  With ``allele_len`` None each record is
    one piece.

    The splitter's full pieces start every ``length - k + 1`` bases; they
    are copied in one strided view of the record's codes, and the bases
    after the last of them follow it in the buffer: as a piece of their
    own if there are k or more, else appended to the last piece (as the
    splitter appends them).
    """
    cuts = []  # a record's full pieces, piece length, stride and the bases after its full pieces
    for c in codes:
        n = len(c)
        if allele_len is None:
            length = n + 1
        else:  # the splitter's piece length: x1, x10 from 1 Mbp, x100 from 10 Mbp
            length = allele_len * (1 if n < 1_000_000 else 10 if n < 10_000_000 else 100)
        stride = length - k + 1
        if stride <= 0:
            raise ValueError("pieces must be longer than k - 1")
        n_full = (n - length) // stride + 1 if n >= length else 0
        cuts.append((n_full, length, stride, n - n_full * stride))
    n_pos = sum(n_full * length + tail for n_full, length, _, tail in cuts)
    padded = np.full(padded_positions(n_pos, chunk) + k - 1, INVALID, dtype=np.uint8)

    starts, names, seg = [], [], []
    at = 0
    for b, (c, (n_full, length, stride, tail)) in enumerate(zip(codes, cuts)):
        if n_full:
            view = np.lib.stride_tricks.as_strided(
                c, shape=(n_full, length), strides=(stride * c.strides[0], c.strides[0]),
                writeable=False)
            padded[at : at + n_full * length].reshape(n_full, length)[:] = view
        record_starts = at + length * np.arange(n_full, dtype=np.int64)
        at += n_full * length
        padded[at : at + tail] = c[n_full * stride :]
        if tail >= k or not n_full:
            record_starts = np.append(record_starts, at)
        at += tail
        starts.append(record_starts)
        names += [f"g{b}p{i}" for i in range(len(record_starts))]
        seg.append(np.full(len(record_starts), b, dtype=np.int32))
    return padded, np.append(np.concatenate(starts), at), names, np.concatenate(seg)


def _timed_steps(records):
    """The items of ``records``, each step of its iterator timed as the
    phase ``mlst.read``."""
    it = iter(records)
    while True:
        with profiling.phase("mlst.read"):
            try:
                record = next(it)
            except StopIteration:
                return
        yield record
