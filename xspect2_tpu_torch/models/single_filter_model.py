"""Single-filter (genus) model, blocked hash family.

One class column of the blocked bit-sliced index holding the canonical
k-mers of a whole genus, queried by the same device engine as the
species model.  The xxh3 compat family belongs to a later slice of the
port and raises ``NotImplementedError``.
"""

from pathlib import Path

from xspect2_tpu_torch import native
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.io.fasta import get_record_iterator
from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel


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
        if hash_family == "xxh3":
            raise NotImplementedError(
                "the xxh3 compat genus filter is not ported to PyTorch yet; "
                "use xspect2_tpu"
            )
        if hash_family != "blocked":
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

    def get_index_path(self) -> Path:
        return self.base_path / self.slug() / "filter.bbsi"

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
        index = BlockedBitSlicedIndex.create(
            self.k, [file_path.stem], max(1, total_length - self.k + 1),
            fpr=self.fpr, num_hashes=None,
        )
        codes, offsets, _ids = native.parse_file(file_path)
        for r in range(len(offsets) - 1):
            native.insert_kmers(index, 0, codes[offsets[r] : offsets[r + 1]])
        self.index = index
        self._engine = None
        self.display_names[file_path.stem] = display_name
        index.save(self.get_index_path())

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
