"""Alignment-based misclassification detection.

The port's own copy of ``xspect2_tpu/misclassification_detection/``, the
post-filter of ``predict(..., validation=True)``; numpy on the host.
Pipeline: group reads by unique-argmax species, keep groups with > min_reads,
skip the largest group; map each suspect group onto the species'
reference genome, extract primary-alignment start coordinates, run an
edge-corrected 1-D Ripley's K test; spatially clustered groups are
moved from ``hits`` into ``hits["misclassified"][tax_id]``.
"""

from collections import defaultdict

from xspect2_tpu_torch.definitions import get_xspect_misclassification_path


def detect_misclassification(
    hits: dict[str, dict[str, int]],
    seq_records,
    min_reads: int = 10,
) -> dict[str, dict[str, int]]:
    """Remove spatially-clustered suspect read groups from ``hits``."""
    from xspect2_tpu_torch.io.fasta import write_fasta
    from xspect2_tpu_torch.misclassification_detection.mapping import MappingHandler
    from xspect2_tpu_torch.misclassification_detection.point_pattern_analysis import (
        PointPatternAnalysis,
    )

    rec_by_id = {record.id: record for record in seq_records}
    grouped = defaultdict(list)
    misclassified: dict = {}

    # group reads by unique-argmax species
    for record, score_dict in hits.items():
        if record == "misclassified":
            continue
        sorted_hits = sorted(score_dict.items(), key=lambda e: e[1], reverse=True)
        if len(sorted_hits) > 1 and sorted_hits[0][1] > sorted_hits[1][1]:
            highest_tax_id = int(sorted_hits[0][0])
            if record in rec_by_id:
                grouped[highest_tax_id].append(rec_by_id[record])

    filtered_grouped = {
        tax_id: seqs for tax_id, seqs in grouped.items() if len(seqs) > min_reads
    }
    largest_group = max(
        filtered_grouped,
        key=lambda tax_id: len(filtered_grouped[tax_id]),
        default=None,
    )

    out_dir = get_xspect_misclassification_path()
    out_dir.mkdir(parents=True, exist_ok=True)

    for tax_id, reads in filtered_grouped.items():
        if tax_id == largest_group:
            continue

        tax_dir = out_dir / str(tax_id)
        tax_dir.mkdir(parents=True, exist_ok=True)
        fasta_path = tax_dir / f"{tax_id}.fasta"
        write_fasta(reads, fasta_path)
        reference_path = tax_dir / f"{tax_id}.fna"

        # download the reference genome once per taxon; a missing or
        # undownloadable reference skips the group (the JAX package's rule)
        if not (reference_path.exists() and reference_path.stat().st_size > 0):
            try:
                from xspect2_tpu_torch.handlers.ncbi import NCBIHandler

                NCBIHandler().download_reference_genome(tax_id, tax_dir)
            except Exception:  # noqa: BLE001 - network failure -> skip group
                pass
        if not reference_path.exists():
            continue

        mapping_handler = MappingHandler(str(reference_path), str(fasta_path))
        mapping_handler.map_reads_onto_reference()
        mapping_handler.extract_starting_coordinates()
        genome_length = mapping_handler.get_total_genome_length()
        start_coordinates = mapping_handler.get_start_coordinates()

        if len(start_coordinates) < min_reads:
            continue

        analysis = PointPatternAnalysis(start_coordinates, genome_length)
        clustered = analysis.ripleys_k_edge_corrected()
        if clustered[0]:
            bucket = misclassified.setdefault(tax_id, {})
            for read in reads:
                data = hits.pop(read.id, None)
                if data is not None:
                    bucket[read.id] = data

    if misclassified:
        hits["misclassified"] = misclassified
    return hits
