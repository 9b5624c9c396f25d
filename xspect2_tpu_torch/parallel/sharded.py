"""Sharded classification step.

The species-classification step over a (data x cls) mesh of ranks, one
process and one device per rank:

1. each (data, cls) rank hit-counts the read positions of its data
   shard against its class word-columns of the index (the single-device
   kernels on a table that holds fewer class words),
2. per-record hit vectors are completed with ``all_gather`` over the
   cls axis,
3. file-level totals are reduced with ``all_reduce`` over the data axis,
4. the SVM head scores the total score vector on the device.

Every rank runs the same program and passes the same global inputs; a
rank computes on the shard its mesh coordinates name.  The device work
of a rank (``_local_reads_step``, ``_local_step``) is a plain function
of those coordinates and the collectives are a thin layer over it
(``_complete_reads``, ``_complete_step``), so one process can evaluate
every shard of a mesh in turn.  The counterpart of the JAX package's
``xspect2_tpu/parallel/sharded.py``.

One deliberate divergence: the head.  The JAX step evaluates its SVM
head in float32 (``xspect2_tpu/parallel/sharded.py:220``, whose head
casts its parameters and inputs to float32 in
``models/svm_head.py:53-55,83``).  That answer depends on the batch
shape it is given and, on a TPU, on XLA's matmul precision, so a
decision within ~2e-5 of zero can take either sign.  The port's step
keeps the float64 :class:`SVMHead`, whose answer is sklearn's float64
``SVC.predict``: the one both packages' unsharded ``svm_model.predict``
returns.
"""

import math
import warnings

import numpy as np
import torch

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.models.svm_head import SVMHead
from xspect2_tpu_torch.ops.query import (
    DEFAULT_CHUNK,
    PreparedBatch,
    pack_reads_wire,
    prepare_batch,
    reads_query,
    records_query,
    restore_batch,
    unpack_2bit,
    wire_to_device,
)
from xspect2_tpu_torch.parallel.mesh import CLS_AXIS, DATA_AXIS


def _round2(x: torch.Tensor) -> torch.Tensor:
    """round-half-even to 2 decimals (matches the reference's Python round).

    The hundredths are scaled back with a multiplication by float32
    0.01, not a division by 100: XLA compiles the JAX step's
    ``jnp.round(x * 100.0) / 100.0`` into that product, so these are the
    float32 bits the JAX package's step returns (up to one ulp from the
    quotient's).
    """
    return torch.round(x * 100.0) * 0.01


def cls_table_shard(index: BlockedBitSlicedIndex, n_cls: int, coord: int) -> np.ndarray:
    """The class-word shard ``coord`` of ``n_cls`` of the index's table:
    uint32 [num_blocks, rows_per_block * cw_local], the slice of class
    words ``[coord * cw_local, (coord + 1) * cw_local)`` of every row of
    the row-major table.  The class words are padded to a multiple of
    ``n_cls`` with all-zero word columns (their classes never hit)."""
    cw = index.class_words
    cw_local = math.ceil(cw / n_cls)
    w0 = coord * cw_local
    t3 = index.table.reshape(index.num_blocks, index.rows_per_block, cw)
    out = np.zeros((index.num_blocks, index.rows_per_block, cw_local), dtype=np.uint32)
    w1 = min(cw, w0 + cw_local)
    if w1 > w0:
        out[:, :, : w1 - w0] = t3[:, :, w0:w1]
    return out.reshape(index.num_blocks, index.rows_per_block * cw_local)


class ShardedClassifier:
    """Runs the classification step over a (data, cls) mesh."""

    model_axis = CLS_AXIS

    def __init__(
        self,
        index: BlockedBitSlicedIndex,
        mesh,
        svm_head: SVMHead | None = None,
        chunk: int = DEFAULT_CHUNK,
        replicate_out: bool | None = None,
    ):
        if self.model_axis not in mesh.shape:
            maker = "make_mesh" if self.model_axis == CLS_AXIS else "make_block_mesh"
            raise ValueError(f"mesh has no '{self.model_axis}' axis: use {maker}")
        self.index = index
        self.mesh = mesh
        self.device = resolve_device(mesh.device)
        self.svm_head = None if svm_head is None else svm_head.to(self.device)
        self.chunk = chunk
        self.n_data = mesh.shape[DATA_AXIS]
        self.n_model = mesh.shape[self.model_axis]
        self._plan_shards()
        if mesh.coords is None:
            raise RuntimeError("this rank lies outside the mesh and holds no shard")
        # multi-process runs replicate outputs by default (all_gather over
        # the data axis) so every process holds the full result;
        # replicate_out=False switches count_hits_reads to return only
        # this rank's data-shard rows, for host-local result handling
        self._replicate_out = mesh.size > 1 if replicate_out is None else replicate_out
        self._tables: dict = {}  # model coordinate -> table shard on the device
        self.table = self.table_shard(mesh.coords[1])  # this rank's own

    # ------------------------------------------------------------------ shards

    def _plan_shards(self) -> None:
        index = self.index
        self.n_cls = self.n_model
        if index.fields_per_word > 1 and self.n_cls > 1:
            raise ValueError(
                "field-packed indices (<= 16 classes) interleave several "
                "signature rows per word, so there is no class-word axis to "
                "shard: use n_cls=1 and give every device to the data axis"
            )
        # pad class words to a multiple of the cls-axis size; padding
        # word-columns are all-zero (their classes never hit)
        cw = index.class_words
        self.cw_pad = math.ceil(cw / self.n_cls) * self.n_cls
        self.cw_local = self.cw_pad // self.n_cls
        if self.n_cls > cw:
            warnings.warn(
                f"cls axis ({self.n_cls}) exceeds index class_words ({cw}): "
                f"{self.n_cls - cw} shard(s) query all-zero padding words and "
                "duplicate the probe work. Use n_cls <= class_words (one word "
                "per 32 classes) and give the spare devices to the data axis.",
                stacklevel=3,
            )

    def host_table_shard(self, coord: int) -> np.ndarray:
        """The table shard of model coordinate ``coord`` on the host."""
        return cls_table_shard(self.index, self.n_cls, coord)

    def table_shard(self, coord: int) -> torch.Tensor:
        """The table shard of model coordinate ``coord`` on the device, as
        the query kernels take it.  A rank uploads its own at
        construction; another coordinate's is cut and uploaded when first
        asked for."""
        if coord not in self._tables:
            host = self.host_table_shard(coord)
            self._tables[coord] = torch.from_numpy(host.view(np.int32)).to(self.device)
        return self._tables[coord]

    def shard_geometry(self, coord: int) -> dict:
        """The geometry of model coordinate ``coord``'s table shard, as
        :func:`reads_query` and :func:`records_query` take it."""
        idx = self.index
        return dict(
            k=idx.k,
            num_blocks=int(idx.num_blocks),
            rows_per_block=idx.rows_per_block,
            class_words=self.cw_local,
            num_hashes=idx.num_hashes,
            fields_per_word=idx.fields_per_word,
            num_classes=idx.num_classes if idx.fields_per_word > 1 else 32 * self.cw_local,
        )

    def _merge_model(self, hits_local: torch.Tensor) -> torch.Tensor:
        """Complete the class axis across the cls shards (all_gather)."""
        return self.mesh.all_gather(hits_local, CLS_AXIS, dim=hits_local.dim() - 1)

    # ------------------------------------------------------------------ host-side batching

    def _shard_batches(self, records, step: int):
        """Split (name, codes) records across data shards: one
        :class:`PreparedBatch` per shard and the common record capacity.

        Records are assigned round-robin by cumulative length so shards
        are base-balanced.
        """
        shards: list[list] = [[] for _ in range(self.n_data)]
        loads = [0] * self.n_data
        for rec in records:
            target = loads.index(min(loads))
            shards[target].append(rec)
            loads[target] += len(rec[1])

        # an empty shard is one chunk of padding
        batches = [prepare_batch(shard, self.index.k, step, self.chunk) for shard in shards]
        return batches, max(b.max_records for b in batches)

    def prepare_shard_batches(self, records, step: int = 1):
        """Split (name, codes) records across data shards; returns stacked
        arrays [D, ...] plus per-shard record names, all shards padded to
        common shapes (:meth:`_shard_batches` as arrays)."""
        batches, max_records = self._shard_batches(records, step)
        n_pos = max(b.num_positions for b in batches)
        k = self.index.k

        codes = np.full((self.n_data, n_pos + k - 1), 255, dtype=np.uint8)
        rec_ids = np.zeros((self.n_data, n_pos), dtype=np.int32)
        valid = np.zeros((self.n_data, n_pos), dtype=bool)
        num_kmers = np.zeros((self.n_data, max_records), dtype=np.int32)
        for d, b in enumerate(batches):
            codes[d, : len(b.codes)] = b.codes
            rec_ids[d, : b.num_positions] = b.rec_ids
            valid[d, : b.num_positions] = b.valid
            num_kmers[d, : len(b.num_kmers)] = b.num_kmers
        names = [b.record_names for b in batches]
        return codes, rec_ids, valid, num_kmers, names

    # ------------------------------------------------------------------ records step

    def _local_step(self, coords, batch: PreparedBatch, max_records: int) -> torch.Tensor:
        """The device work of the rank at ``coords`` on its data shard's
        batch: int32 [max_records, C_local] hits against its table shard
        (the compact wire restored by K4, then K3)."""
        geom = self.shard_geometry(coords[1])
        if batch.num_records == 0:
            return torch.zeros((max_records, geom["num_classes"]), dtype=torch.int32, device=self.device)
        codes, rec_ids, valid = restore_batch(batch, self.device)
        return records_query(
            codes, rec_ids, valid, self.table_shard(coords[1]), max_records=max_records,
            min_record_len=batch.min_record_len, **geom,
        )

    def score(self, total_hits: torch.Tensor, total_kmers: torch.Tensor):
        """File-level scores and the prediction from the hits summed over
        every record and the k-mer count: ``(float32 [C_pad], index)``.
        The scores are computed in float32 and fed to the SVM head (or to
        ``argmax`` without one) over the index's real classes.  The head
        decides in float64, as sklearn's ``SVC.predict`` and the
        unsharded models do; the JAX step's float32 head can differ from
        it on a decision within ~2e-5 of zero (see the module docstring)."""
        total_scores = _round2(total_hits.float() / total_kmers.clamp(min=1).float())
        num_classes = self.index.num_classes
        if self.svm_head is not None:
            pred = self.svm_head.predict_indices(total_scores[None, :num_classes])[0]
        else:
            pred = torch.argmax(total_scores[:num_classes])
        return total_scores, pred

    def _complete_step(self, hits_local: torch.Tensor, num_kmers_local: int):
        """The collectives of the records step around one rank's hits:
        ``(hits [D or 1, max_records, C_pad], total_scores, pred)``."""
        hits_full = self._merge_model(hits_local)
        total_hits = self.mesh.all_reduce(hits_full.sum(dim=0, dtype=torch.int32), DATA_AXIS)
        total_kmers = self.mesh.all_reduce(
            torch.tensor(num_kmers_local, dtype=torch.int32, device=self.device), DATA_AXIS
        )
        total_scores, pred = self.score(total_hits, total_kmers)
        hits_full = hits_full[None]
        if self._replicate_out:
            hits_full = self.mesh.all_gather(hits_full, DATA_AXIS, dim=0)
        return hits_full, total_scores, pred

    # ------------------------------------------------------------------ reads step

    def _query_reads(self, coord: int, reads: np.ndarray, n_rows: int, step: int) -> torch.Tensor:
        """int32 [n_rows, C_local] hits of ``reads`` ([n, L] codes, n <=
        n_rows; the rows past n are padding and count nothing) against
        the table shard of model coordinate ``coord``: the packed wire,
        K1, then K2."""
        geom = self.shard_geometry(coord)
        if not len(reads):
            return torch.zeros((n_rows, geom["num_classes"]), dtype=torch.int32, device=self.device)
        wire = pack_reads_wire(np.ascontiguousarray(reads), self.index.k, n_rows)
        codes = unpack_2bit(*wire_to_device(wire, self.device), reads.shape[1])
        hits = reads_query(codes, self.table_shard(coord), step=step, **geom)
        return hits.to(torch.int32)

    def _local_reads_step(self, coords, reads: np.ndarray, step: int, reads_per_chunk: int):
        """The device work of the rank at ``coords`` on the global
        ``reads`` [N, L]: ``(hits int32 [rows, C_local], row_start)`` of
        its data shard's rows.  The rows are padded to a multiple of
        ``n_data * reads_per_chunk``, so every shard holds equally many."""
        n = reads.shape[0]
        unit = self.n_data * reads_per_chunk
        rows = unit * max(1, -(-n // unit)) // self.n_data
        row_start = coords[0] * rows
        mine = reads[row_start : min(n, row_start + rows)]
        return self._query_reads(coords[1], mine, rows, step), row_start

    def _complete_reads(self, hits_local: torch.Tensor) -> torch.Tensor:
        """The collectives of the reads step around one rank's hits."""
        hits = self._merge_model(hits_local)
        if self._replicate_out:
            hits = self.mesh.all_gather(hits, DATA_AXIS, dim=0)
        return hits

    def _fetch(self, hits: torch.Tensor, n: int) -> np.ndarray:
        return hits[:n, : self.index.num_classes].cpu().numpy().astype(np.int64)

    def count_hits_reads(self, reads: np.ndarray, step: int = 1, reads_per_chunk: int = 1024):
        """Sharded uniform-read fast path: [N, L] codes -> [N, C] hits.

        Every rank passes the same ``reads``.  They are data-parallel
        over the data axis; the index table is sharded over the model
        axis; per-read class vectors are completed with a collective
        over it.  The multi-device analogue of
        :meth:`~xspect2_tpu_torch.ops.query.DeviceQueryEngine.count_hits_reads`
        (matches it exactly).

        In local-rows mode (``replicate_out=False`` on a mesh of more
        than one rank) the return value is ``(local_hits, row_start)``:
        this rank's contiguous slice of the global [N, C] result (padding
        rows trimmed) plus the global row index of its first row, so
        callers can map rows back to input reads.
        """
        n = reads.shape[0]
        hits_local, row_start = self._local_reads_step(self.mesh.coords, reads, step, reads_per_chunk)
        hits = self._complete_reads(hits_local)
        if not self._replicate_out and self.mesh.size > 1:
            n_valid = max(0, min(n, row_start + hits.shape[0]) - row_start)
            return self._fetch(hits, n_valid), row_start
        return self._fetch(hits, n)

    def count_hits_reads_local(
        self, reads: np.ndarray, step: int = 1, reads_per_chunk: int = 1024
    ) -> np.ndarray:
        """Host-sharded input: each rank passes ONLY its data shard's reads.

        The multi-process data-loading path: every process reads its own
        slice of the input (its own FASTQ shard) and pads it locally, so
        no process materializes, pads or copies the global read set the
        way :meth:`count_hits_reads` does.  Ranks of one data shard pass
        the same reads, and all ranks the SAME number of rows (pad the
        tail shard's input if uneven).  Returns this rank's [n_local, C]
        hit counts (row i = local read i).
        """
        n_local = reads.shape[0]
        rows = reads_per_chunk * max(1, -(-n_local // reads_per_chunk))
        d, m = self.mesh.coords
        hits = self._complete_reads(self._query_reads(m, reads, rows, step))
        if self._replicate_out and self.mesh.size > 1:
            hits = hits[d * rows : (d + 1) * rows]
        return self._fetch(hits, n_local)

    # ------------------------------------------------------------------ classify

    def classify(self, records, step: int = 1):
        """Full sharded classification of (name, codes) records.

        Returns (per_record_hits dict-of-dicts, total_scores dict,
        prediction-or-None).  Every rank passes the same records and
        gets the same result; with more than one data shard that takes
        ``replicate_out=True`` (the default on a mesh of several ranks).
        """
        if self.n_data > 1 and not self._replicate_out:
            raise RuntimeError(
                "classify assembles every data shard's records: it needs "
                "replicate_out=True on a mesh with more than one data shard"
            )
        batches, max_records = self._shard_batches(records, step)
        d = self.mesh.coords[0]
        hits_local = self._local_step(self.mesh.coords, batches[d], max_records)
        hits, total_scores, pred = self._complete_step(hits_local, sum(batches[d].num_kmers))
        return self.assemble(
            hits.cpu().numpy(), total_scores.cpu().numpy(), int(pred),
            [b.record_names for b in batches],
        )

    def assemble(self, hits: np.ndarray, total_scores: np.ndarray, pred: int, names):
        """The result of :meth:`classify` from the step's outputs: hits
        [D, max_records, C_pad], float32 scores, the predicted index and
        each data shard's record names."""
        class_names = self.index.class_names
        per_record = {}
        for d, shard_names in enumerate(names):
            for i, name in enumerate(shard_names):
                per_record[name] = {
                    class_names[c]: int(hits[d, i, c]) for c in range(len(class_names))
                }
        totals = {class_names[c]: float(total_scores[c]) for c in range(len(class_names))}
        prediction = None
        if self.svm_head is not None:
            prediction = self.svm_head.classes[pred]
        return per_record, totals, prediction
