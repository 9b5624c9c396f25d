"""Single-filter (genus) model.

One Bloom-filter column holding the canonical k-mers of a whole genus.
``hash_family`` selects the filter:

- ``"blocked"`` (default, the throughput path): one class column of the
  blocked bit-sliced index, queried by the same device engine as the
  species model.
- ``"xxh3"``: the compat mode (:mod:`xspect2_tpu_torch.core.compat`):
  XXH3-64 over the ASCII canonical k-mer string; a parity and
  verification mode.  Every query takes the filter model's records
  route with this filter's counter, class name and padding chunk: K4
  restores each batch and K7 hashes, tests and counts every record's
  windows on the device, one launch per batch.
"""

import json
from pathlib import Path

from xspect2_tpu_torch import native
from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.core.compat import XXH3BloomFilter
from xspect2_tpu_torch.io.fasta import get_record_iterator
from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel
from xspect2_tpu_torch.ops.query import DEFAULT_CHUNK, prepare_batch


class ProbabilisticSingleFilterModel(ProbabilisticFilterModel):
    """Genus-level single Bloom-filter model."""

    def __init__(
        self,
        k: int,
        model_display_name: str,
        author: str | None,
        author_email: str | None,
        model_type: str,
        base_path: Path,
        fpr: float = 0.01,
        training_accessions: list[str] | None = None,
        hash_family: str = "blocked",
        device=None,
    ) -> None:
        if hash_family not in ("blocked", "xxh3"):
            raise ValueError(f"unknown hash_family: {hash_family!r}")
        super().__init__(
            k=k,
            model_display_name=model_display_name,
            author=author,
            author_email=author_email,
            model_type=model_type,
            base_path=base_path,
            fpr=fpr,
            num_hashes=1,  # metadata-schema parity with the JAX package
            training_accessions=training_accessions,
            device=device,
        )
        self.hash_family = hash_family
        self.compat_filter: XXH3BloomFilter | None = None

    def get_index_path(self) -> Path:
        if self.hash_family == "xxh3":
            return self.base_path / self.slug() / "filter.xxh3.npz"
        return self.base_path / self.slug() / "filter.bbsi"

    def to_dict(self) -> dict:
        d = super().to_dict()
        if self.hash_family != "blocked":
            d["hash_family"] = self.hash_family
        return d

    def fit(
        self,
        file_path: Path,
        display_name: str,
        training_accessions: list[str] | None = None,
    ) -> None:
        """Insert every canonical k-mer of the genus file into the filter.

        The one class is the file's stem; the probe count is picked
        automatically, as the JAX package does.
        """
        self.training_accessions = training_accessions
        total_length = sum(len(record.seq) for record in get_record_iterator(file_path))
        num_kmers = max(1, total_length - self.k + 1)
        if self.hash_family == "xxh3":
            # the compat filter, sized like Bloom(n, fpr)
            filt = XXH3BloomFilter.for_items(num_kmers, self.fpr, self.k, self.device)
            for record in get_record_iterator(file_path):
                filt.insert_sequence(str(record.seq))
            self.compat_filter = filt
            self.display_names[file_path.stem] = display_name
            filt.save(self.get_index_path())
            return
        index = BlockedBitSlicedIndex.create(
            self.k, [file_path.stem], num_kmers, fpr=self.fpr, num_hashes=None,
        )
        codes, offsets, _ids = native.parse_file(file_path)
        for r in range(len(offsets) - 1):
            native.insert_kmers(index, 0, codes[offsets[r] : offsets[r + 1]])
        self.index = index
        self._engine = None
        self.display_names[file_path.stem] = display_name
        index.save(self.get_index_path())

    # ------------------------------------------------- xxh3 compat mode

    def _class_names(self) -> list[str]:
        if self.compat_filter is None:
            return super()._class_names()
        # single-class model: the one trained genus file's stem
        return [next(iter(self.display_names), "metagenome")]

    def _batch_chunk(self) -> int:
        if self.compat_filter is None:
            return super()._batch_chunk()
        return DEFAULT_CHUNK  # prepare_batch's own, so K7 launches at its shapes

    def _count_batch(self, batch):
        if self.compat_filter is None:
            return super()._count_batch(batch)
        return self.compat_filter.count_hits_batch(batch)[:, None]

    def calculate_hits(self, sequence, exclude_ids: list[str] | None = None, step: int = 1) -> dict:
        if self.compat_filter is None:
            return super().calculate_hits(sequence, exclude_ids, step=step)
        seq = sequence.seq if hasattr(sequence, "seq") else sequence
        if not isinstance(seq, str):
            seq = str(seq)
        if not len(seq) > self.k:
            raise ValueError("Invalid sequence, must be longer than k")
        (name,) = self._class_names()
        if exclude_ids and name in exclude_ids:
            return {}
        batch = prepare_batch([("seq", dna.encode(seq))], self.k, step=step)
        return {name: int(self.compat_filter.count_hits_batch(batch)[0])}

    # ------------------------------------------------------- persistence

    @classmethod
    def _from_metadata(cls, model_json: dict, base_path: Path, device):
        return cls(
            model_json["k"],
            model_json["model_display_name"],
            model_json["author"],
            model_json["author_email"],
            model_json["model_type"],
            base_path,
            fpr=model_json["fpr"],
            training_accessions=model_json["training_accessions"],
            hash_family=model_json.get("hash_family", "blocked"),
            device=device,
        )

    @classmethod
    def load(cls, path: Path, device=None) -> "ProbabilisticSingleFilterModel":
        model_json = json.loads(Path(path).read_text(encoding="utf-8"))
        if model_json.get("hash_family", "blocked") != "xxh3":
            return super().load(path, device=device)
        model = cls._from_metadata(model_json, Path(path).parent, device)
        model.display_names = model_json["display_names"]
        index_path = model.get_index_path()
        if not index_path.exists():
            raise FileNotFoundError(f"Filter file not found at {index_path}")
        model.compat_filter = XXH3BloomFilter.load(index_path, model.device)
        return model
