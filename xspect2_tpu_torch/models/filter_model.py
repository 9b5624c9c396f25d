"""Multi-class probabilistic filter model, read-classification path.

The JAX package's ``ProbabilisticFilterModel`` as far as classifying a
file of equal-length reads goes: ``load``, ``predict(Path)`` and the
per-record hit dictionaries, with hit counts from
:class:`~xspect2_tpu_torch.ops.query.DeviceQueryEngine`.  Training,
ragged records (assemblies) and the validation post-filter belong to
the records slice of the port and raise ``NotImplementedError``.
"""

import json
import math
from pathlib import Path

import numpy as np

from xspect2_tpu_torch import native, resolve_device
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.definitions import slugify
from xspect2_tpu_torch.models.result import ModelResult
from xspect2_tpu_torch.ops.query import DeviceQueryEngine

RECORDS_SLICE = (
    "the records slice of the PyTorch port (ragged records, training and "
    "validation) is not ported yet; use xspect2_tpu"
)

# reads per padding unit, and bases per device batch: a large FASTQ
# streams through the device in slices of at most this many bases
_READS_PER_CHUNK = 4096
_MAX_BATCH_BASES = 1 << 28
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

    def fit(self, *args, **kwargs) -> None:
        raise NotImplementedError(f"fit: {RECORDS_SLICE}")

    # ------------------------------------------------------------------ inference

    @property
    def engine(self) -> DeviceQueryEngine:
        if self._engine is None:
            if self.index is None:
                raise ValueError("The model has not been trained yet")
            self._engine = DeviceQueryEngine(self.index, device=self.device)
        return self._engine

    def _hits_dict_from_counts(
        self, counts: np.ndarray, exclude_ids: list[str] | None
    ) -> dict[str, int]:
        """One record's {class: hits} dict, ranked like a COBS search
        result (descending count, ties by name)."""
        names = self.index.class_names
        order = sorted(range(len(names)), key=lambda i: (-int(counts[i]), names[i]))
        excluded = set(exclude_ids) if exclude_ids else ()
        return {names[i]: int(counts[i]) for i in order if names[i] not in excluded}

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
                parts.append(out[:m].cpu().numpy())
        parts.extend(out[:m].cpu().numpy() for out, m in pending)
        return np.concatenate(parts).astype(np.int64)

    def predict(
        self,
        sequence_input: Path,
        exclude_ids: list[str] | None = None,
        step: int = 1,
        display_name: bool = False,
        validation: bool = False,
    ) -> ModelResult:
        """Classify a FASTA/FASTQ file of equal-length records.

        Results equal the JAX package's on the same model and file.
        """
        if validation:
            raise NotImplementedError(f"validation: {RECORDS_SLICE}")
        if not isinstance(sequence_input, Path):
            raise NotImplementedError(
                f"predict takes a file path here; record lists need {RECORDS_SLICE}"
            )
        codes, offsets, ids = native.parse_file(sequence_input)
        n = len(ids)
        if n == 0:
            raise ValueError("No sequences found in input")
        lengths = np.diff(offsets)
        if not (lengths == lengths[0]).all():
            raise NotImplementedError(
                f"{sequence_input} holds records of several lengths: {RECORDS_SLICE}"
            )
        length = int(lengths[0])
        if not length > self.k:
            raise ValueError("Invalid sequence, must be longer than k")

        counts = self._count_reads(codes.reshape(n, length), step)
        nk = math.ceil((length - self.k + 1) / step)
        hits: dict[str, dict[str, int]] = {}
        num_kmers: dict[str, int] = {}
        for i, rid in enumerate(ids):
            rec_hits = self._hits_dict_from_counts(counts[i], exclude_ids)
            if display_name:
                rec_hits = {
                    f"{key} -{self.display_names.get(key, 'Unknown').replace(self.model_display_name, '', 1)}": v
                    for key, v in rec_hits.items()
                }
            hits[rid] = rec_hits
            num_kmers[rid] = nk
        return ModelResult(self.slug(), hits, num_kmers, sparse_sampling_step=step)

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
